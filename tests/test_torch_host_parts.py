"""The device read's host phase split where its time goes
(``obs.HostPhaseStats``), the ``chunk`` spans inside ``prepare``, and the
clock anchor that puts the tracer's spans on the device trace's clock.

Reads run on the CPU (``device="cpu"``) over a small lineitem-shaped
SNAPPY file with page CRCs: dictionary and PLAIN fixed-width columns, PLAIN
strings (the snappy tag walk) and dictionary strings.  Times are never
compared with fixed numbers; the parts are compared with the host phase
they split, and the process-wide totals with the readers' counters.
"""

import importlib.util
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import native, obs
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.reader import FileReader

ROWS, GROUP = 24_000, 8_000
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("page_parse_s_per_Mrow", "snappy_walk_s_per_Mrow",
           "decompress_s_per_Mrow", "host_python_s_per_Mrow",
           "host_offcpu_share", "snappy_walk_wasted_share",
           "level_walk_s_per_Mrow")


def _required(cols: dict) -> pa.Table:
    """TPC-H's columns are REQUIRED: no level streams in the pages."""
    arrays = {k: pa.array(v) for k, v in cols.items()}
    return pa.Table.from_arrays(
        list(arrays.values()),
        schema=pa.schema([pa.field(k, a.type, nullable=False)
                          for k, a in arrays.items()]))


def _lineitem_table(rows: int) -> pa.Table:
    rng = np.random.default_rng(19)
    words = np.array([f"w{i:03d} pack{i % 7} slyly" for i in range(300)])
    return _required({
        "l_orderkey": np.cumsum(rng.integers(1, 5, rows)).astype(np.int64),
        "l_partkey": rng.integers(1, 200_000, rows).astype(np.int64),
        "l_quantity": rng.integers(1, 51, rows).astype(np.int64),
        "l_extendedprice": rng.integers(90_000, 10_500_000, rows) / 100.0,
        "l_shipdate": rng.integers(8036, 10562, rows).astype(np.int32),
        "l_returnflag": np.array(["A", "N", "R"])[rng.integers(0, 3, rows)],
        "l_comment": words[rng.integers(0, 300, rows)],
    })


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    """SNAPPY, page CRCs, 2,000-row pages; dictionaries on every column but
    the two PLAIN keys and ``l_comment`` (PLAIN strings)."""
    path = str(tmp_path_factory.mktemp("host_parts") / "lineitem.parquet")
    pq.write_table(_lineitem_table(ROWS), path, row_group_size=GROUP,
                   compression="snappy", write_page_checksum=True,
                   data_page_size=16 << 10,
                   use_dictionary=["l_quantity", "l_shipdate",
                                   "l_returnflag"])
    return path


@pytest.fixture(scope="module")
def dense(tmp_path_factory):
    """One PLAIN INT64 column repeating a two-value pattern: its snappy
    stream is one op per few bytes, past the tag walk's first capacity
    guess (one op per 32 bytes)."""
    path = str(tmp_path_factory.mktemp("host_parts") / "dense.parquet")
    vals = np.tile(np.array([7, -3], np.int64), 65_536)
    pq.write_table(_required({"v": vals}), path, compression="snappy",
                   use_dictionary=False, write_page_checksum=True,
                   data_page_size=1 << 20)
    return path


def _scan(path, **kw):
    r = DeviceFileReader(path, device="cpu", **kw)
    try:
        out = [g for g in r.iter_row_groups()]
        r.finalize()
    finally:
        r.close()
    return r, out


def _parts_sum(d) -> float:
    return sum(d["parts"].values())


@pytest.mark.parametrize("prefetch", [0, 2])
def test_parts_sum_to_the_host_phase(lineitem, prefetch):
    r, _ = _scan(lineitem, prefetch=prefetch)
    st = r.stats()
    d = st.host_parts()
    assert set(d["parts"]) == set(obs.HOST_PARTS)
    assert _parts_sum(d) == pytest.approx(d["host_seconds"], rel=0.01)
    assert all(v >= -1e-9 for v in d["parts"].values()), d["parts"]
    assert d["rows"] == st.rows == ROWS
    if prefetch == 0:
        # the host phase is host_seconds itself
        assert d["host_seconds"] == st.host_seconds
    else:
        # host_seconds on the consumer, and each chunk's collection
        assert d["host_seconds"] > st.host_seconds
    for part in ("crc", "decompress", "page_parse", "run_walk", "python"):
        assert d["parts"][part] > 0, part
    assert d["parts"]["read"] > 0
    # REQUIRED leaves: no level stream to walk
    assert d["parts"]["level_walk"] == 0
    assert 0 < d["host_cpu_seconds"] <= d["host_seconds"] * 1.05 + 0.01
    assert d["stage_cpu_seconds"] > 0


def test_plain_strings_are_walked_and_the_walks_counted(lineitem):
    r, _ = _scan(lineitem)
    d = r.stats().host_parts()
    walk = d["snappy_walk"]
    assert d["parts"]["snappy_walk"] > 0
    assert walk["walks"] >= ROWS // GROUP  # l_comment's pages, each group
    # every walk's plan is staged; the restarts on the op cap are wasted
    assert walk["declined"] == 0
    assert 0 <= walk["wasted_seconds"] <= d["parts"]["snappy_walk"]
    assert (walk["wasted_seconds"] > 0) == (walk["retries"] > 0)


def test_the_process_totals_equal_the_readers_with_four_at_once(lineitem):
    before = obs.host_phase_totals()
    readers, errors = [], []

    def one(prefetch):
        try:
            readers.append(_scan(lineitem, prefetch=prefetch)[0])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(k,)) for k in (0, 2, 0, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(readers) == 4
    after = obs.host_phase_totals()
    mine = [r.stats().host_parts() for r in readers]
    assert after["rows"] - before["rows"] == sum(d["rows"] for d in mine)
    for k in ("walks", "retries", "declined"):
        assert (after["snappy_walk"][k] - before["snappy_walk"][k]
                == sum(d["snappy_walk"][k] for d in mine))
    for k in ("host_seconds", "host_cpu_seconds", "stage_cpu_seconds"):
        assert after[k] - before[k] == pytest.approx(
            sum(d[k] for d in mine), rel=1e-9, abs=1e-12)
    for p in obs.HOST_PARTS:
        assert after["parts"][p] - before["parts"][p] == pytest.approx(
            sum(d["parts"][p] for d in mine), rel=1e-9, abs=1e-12)


def test_no_fold_is_lost_with_more_threads_than_cores():
    """Units folded from many threads at once, the interpreter switching
    threads every microsecond: the reader's counts and the process totals
    each get every unit."""
    import sys

    threads_n = min(2 * (os.cpu_count() or 4), 64)
    units, stats = 200, obs.HostPhaseStats()
    before = obs.host_phase_totals()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(units):
            u = stats.begin()
            u.walks += 1
            obs.timed_part(obs.PART_CRC, int)
            stats.end(u, 1e-6, rows=3)

    try:
        threads = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    n = threads_n * units
    d, after = stats.as_dict(), obs.host_phase_totals()
    assert d["rows"] == 3 * n and d["snappy_walk"]["walks"] == n
    assert after["rows"] - before["rows"] == 3 * n
    assert after["snappy_walk"]["walks"] - before["snappy_walk"]["walks"] == n
    assert d["host_seconds"] == pytest.approx(n * 1e-6)


def test_a_restart_on_the_op_cap_counts_as_a_retry(dense, monkeypatch):
    monkeypatch.setenv("TPQ_FORCE_ROUTE", "device_snappy")
    r, out = _scan(dense)
    d = r.stats().host_parts()
    assert r.stats().route_streams.get("device_snappy")
    walk = d["snappy_walk"]
    assert walk["retries"] >= 1 and walk["walks"] >= 1
    assert 0 < walk["wasted_seconds"] < d["parts"]["snappy_walk"]
    assert walk["declined"] == 0
    vals = out[0]["v"].values[: out[0]["v"].num_values].numpy()
    assert (vals == np.tile(np.array([7, -3]), len(vals) // 2)).all()


def test_a_stream_over_the_op_table_cap_counts_as_declined(lineitem,
                                                           monkeypatch):
    monkeypatch.setattr(DR, "_SNAPPY_MAX_OPS", 1)
    r, out = _scan(lineitem)
    d = r.stats().host_parts()
    walk = d["snappy_walk"]
    # l_comment's pages are walked in every group, then shipped plain
    assert walk["declined"] >= ROWS // GROUP
    assert walk["declined"] <= walk["walks"]
    assert walk["wasted_seconds"] == pytest.approx(
        d["parts"]["snappy_walk"], rel=0.05)
    want = _lineitem_table(ROWS).column("l_comment").to_pylist()
    got = [bytes(b).decode() for g in out
           for b in g["l_comment"].to_host().to_list()]
    assert got == want


def test_a_write_and_a_host_read_leave_the_totals_alone(lineitem, tmp_path):
    from tpu_parquet_torch.column import ColumnData
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    before = obs.host_phase_totals()
    path = str(tmp_path / "w.parquet")
    schema = build_schema([data_column("k", Type.INT64, FRT.REQUIRED)])
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    use_dictionary=True, write_crc=True) as w:
        w.write_columns({"k": ColumnData(
            values=np.arange(50_000, dtype=np.int64) % 97)})
        w.flush_row_group()
    with FileReader(lineitem, prefetch=2) as hr:
        for _ in hr.iter_row_groups():
            pass
    assert obs.host_phase_totals() == before


def test_a_leaf_outside_a_host_phase_adds_nothing():
    before = obs.host_phase_totals()
    payload = native.snappy_compress(np.zeros(1 << 16, np.uint8))
    assert native.snappy_plan(payload, 1 << 16) is not None
    assert obs.host_unit() is None
    assert obs.host_phase_totals() == before


def test_parts_are_self_time():
    """A part timed inside another leaves the outer part's self time; the
    unit's python remainder is the rest."""
    stats = obs.HostPhaseStats()
    t0 = time.perf_counter()
    u = stats.begin()

    def inner():
        time.sleep(0.01)

    def outer():
        time.sleep(0.01)
        obs.timed_part(obs.PART_CRC, inner)

    obs.timed_part(obs.PART_PAGE_PARSE, outer)
    stats.end(u, time.perf_counter() - t0, rows=5)
    d = stats.as_dict()
    assert obs.host_unit() is None
    assert d["parts"]["crc"] >= 0.009
    assert 0.009 <= d["parts"]["page_parse"] < 0.009 + d["parts"]["crc"]
    assert _parts_sum(d) == pytest.approx(d["host_seconds"])
    assert d["parts"]["python"] >= 0 and d["rows"] == 5


def _events(path):
    import json

    with open(path) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_each_chunk_is_a_span_inside_prepare(lineitem, tmp_path, prefetch):
    pt = str(tmp_path / "t.json")
    r, _ = _scan(lineitem, prefetch=prefetch, trace=pt)
    ev = [e for e in _events(pt) if e["ph"] == "X"]
    chunks = [e for e in ev if e["name"] == "chunk"]
    n = r.stats().chunks
    assert len(chunks) == n == 7 * (ROWS // GROUP)
    assert {e["args"]["column"] for e in chunks} == set(
        _lineitem_table(1).column_names)
    assert all(e["args"]["pages"] > 0 and e["args"]["route"]
               for e in chunks)
    for name in ("collect", "preship", "finish"):
        assert len([e for e in ev if e["name"] == name]) == n, name
    prepares = [e for e in ev if e["name"] == "prepare"]
    consumer = {(e["pid"], e["tid"]) for e in prepares}

    def inside(child, parents, slack=2):
        return any(p["tid"] == child["tid"] and p["ts"] <= child["ts"] + slack
                   and child["ts"] + child["dur"] <= p["ts"] + p["dur"]
                   + slack for p in parents)

    assert all(inside(c, prepares) for c in chunks)
    assert all(inside(e, chunks) for e in ev if e["name"] == "finish")
    fed = [e for e in ev if e["name"] in ("collect", "preship")]
    if prefetch == 0:
        assert all(inside(e, chunks) for e in fed)
    else:
        # collected on the pool's workers
        assert not {(e["pid"], e["tid"]) for e in fed} & consumer


def test_the_sampler_track_carries_the_parts(lineitem, tmp_path):
    pt = str(tmp_path / "s.json")
    _scan(lineitem, trace=pt, sample_ms=1)
    tracks = [e["args"] for e in _events(pt)
              if e["ph"] == "C" and e["name"] == "reader_progress"]
    assert tracks
    last = tracks[-1]
    assert last["host_seconds"] > 0 and "python_s" in last
    assert "snappy_walks" in last and "stage_cpu_seconds" in last


def test_a_span_maps_onto_the_wall_clock_between_two_reads(tmp_path):
    tr = obs.Tracer(path=str(tmp_path / "c.json"))
    u0 = time.time_ns()
    with tr.span("x"):
        time.sleep(0.002)
    u1 = time.time_ns()
    (x,) = [e for e in tr.events() if e["ph"] == "X"]
    ms = 1_000_000
    for t in (x["ts"] / 1e6, (x["ts"] + x["dur"]) / 1e6):
        assert u0 - ms <= obs.unix_ns(t) <= u1 + ms
    doc = tr.export()
    (sync,) = [e for e in doc["traceEvents"] if e["name"] == "clock_sync"]
    assert sync["ph"] == "M"
    created, exported = sync["args"]["created"], sync["args"]["exported"]
    assert exported["perf_counter_s"] > created["perf_counter_s"]
    for anchor in (created, exported):
        got = obs.unix_ns(x["ts"] / 1e6, anchor)
        assert u0 - ms <= got <= u1 + ms
    dump = obs.FlightRecorder(capacity=8).snapshot()
    assert set(dump["clock_sync"]) == {"perf_counter_s", "unix_ns"}


def test_a_disabled_tracer_hands_out_the_null_span():
    tr = obs.Tracer(enabled=False, ring=None)
    assert not tr.active
    assert tr.span("chunk", column="c") is obs._NULL_SPAN
    # with the flight ring it records, still without an event list
    ringed = obs.Tracer(enabled=False, ring=obs.FlightRecorder(capacity=4))
    with ringed.span("chunk"):
        pass
    assert ringed.events() == []


def _metric(name):
    path = os.path.join(ROOT, "pqbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


RUN = {"layer": {"reader": {"rows": 2_000_000, "host_seconds": 0.2,
                            "stage_seconds": 0.01, "dispatch_seconds": 0.03}},
       "device": None, "window_s": 10.0, "peak_bytes_per_s": 3.35e12}
TOTALS = {"host_seconds": 4.0, "host_cpu_seconds": 3.0,
          "stage_cpu_seconds": 0.5, "rows": 40_000_000,
          "parts": {"read": 0.2, "crc": 0.2, "decompress": 0.4,
                    "page_parse": 0.6, "run_walk": 0.2, "snappy_walk": 0.5,
                    "transcode": 0.1, "host_copy": 0.3, "python": 1.5,
                    "level_walk": 0.25},
          "snappy_walk": {"walks": 10, "retries": 2, "declined": 1,
                          "wasted_seconds": 0.125}}
# the window's host_s_per_Mrow is 0.1; each part's share of it
WANT = {"page_parse_s_per_Mrow": 0.02, "snappy_walk_s_per_Mrow": 0.0125,
        "decompress_s_per_Mrow": 0.01, "host_python_s_per_Mrow": 0.0375,
        "host_offcpu_share": 25.0, "snappy_walk_wasted_share": 25.0,
        "level_walk_s_per_Mrow": 0.00625}


@pytest.mark.parametrize("name", METRICS)
def test_each_new_metric_reads_its_number(name):
    mod = _metric(name)
    assert mod.read(RUN, TOTALS) == pytest.approx(WANT[name])
    empty = {"layer": {}, "device": None, "window_s": 10.0,
             "peak_bytes_per_s": 3.35e12}
    assert mod.read(empty, TOTALS) is None
    assert mod.read(RUN, {**TOTALS, "host_seconds": 0.0}) is None
    none_walked = {**TOTALS, "parts": {**TOTALS["parts"],
                                       "snappy_walk": 0.0}}
    if name == "snappy_walk_wasted_share":
        assert mod.read(RUN, none_walked) is None


def test_the_metrics_read_the_process_totals(lineitem):
    _scan(lineitem)
    totals = obs.host_phase_totals()
    for name in METRICS:
        got = _metric(name).read(RUN)
        assert got == pytest.approx(_metric(name).read(RUN, totals))
    share = _metric("host_python_s_per_Mrow").read(RUN)
    assert 0 < share < 0.1
