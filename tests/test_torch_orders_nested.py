"""TPC-H ORDERS with each order's LINEITEMs nested in it, read by the port's
device reader, and the host phase's account of its def and rep levels.

The table is the benchmark's own (``pqbench.tables.orders_nested_full``:
ORDERS' nine flat columns and an OPTIONAL LIST of LINEITEM's fifteen other
leaves, ``max_def`` 2, ``max_rep`` 1), drawn small from a seed and written by the program's writer
in the port writer's layout (SNAPPY, dictionary on, page CRCs).  The draw
is the plain reference: NumPy arrays of every leaf's defined values and its
def and rep levels, made without the program.  The file is read through
``DeviceFileReader(path, device="cpu")`` (the kernels' plain PyTorch
versions) and compared exactly, leaf by leaf.

Then the tracing of the levels path: the ``level_walk`` part of the host
phase (every def and rep stream's run walk; 0 on a flat file), the
process-wide level counters by kind and by route (``obs.level_totals``),
the chunk walk's ``levels`` fallback, and the ``chunk`` and ``levels``
spans in a trace file and in the flight ring.
"""

import json

import numpy as np
import pytest

from pqbench import tables, write
from tpu_parquet_torch import obs
from tpu_parquet_torch.device_reader import DeviceFileReader

TABLE = tables.load("orders_nested_full")
LINEITEMS = 40_000
ORDERS_PER_GROUP = 2_500
SEED = 2_147_483_917
CONFIG = {"table": "orders_nested_full", "lineitems": LINEITEMS,
          "rows_per_group": ORDERS_PER_GROUP, "layout": "port_writer"}
FLAT = TABLE.ORDER_COLUMNS
NESTED = [c for c in TABLE.LEAVES if c not in FLAT]


@pytest.fixture(scope="module")
def drawn(tmp_path_factory):
    """The draw and its file."""
    groups = TABLE.draw(SEED, CONFIG)
    path = str(tmp_path_factory.mktemp("orders_nested") / "orders.parquet")
    write.write_file(CONFIG, groups, path)
    return groups, path


def _read(path, **kw):
    r = DeviceFileReader(path, device="cpu", **kw)
    try:
        out = list(r.iter_row_groups())
        r.finalize()
    finally:
        r.close()
    return r, out


@pytest.fixture(scope="module")
def read(drawn, tmp_path_factory):
    """One traced read of the file: the reader, its row groups, the level
    counters it added to the process's, and its trace file's events."""
    _, path = drawn
    trace = str(tmp_path_factory.mktemp("orders_trace") / "trace.json")
    before = obs.level_totals()
    r, out = _read(path, trace=trace)
    after = obs.level_totals()
    added = {k: {g: {n: after[k][g][n] - before[k][g][n]
                     for n in after[k][g]} for g in after[k]}
             for k in after}
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    return r, out, added, events


def _host(col) -> np.ndarray:
    """A read column's defined values on the host: a fixed-width leaf its
    array, a string leaf its values as a list of bytes."""
    got = col.to_host()
    if hasattr(got, "offsets"):
        return got.to_list()
    return np.asarray(got)


def _want(v):
    if isinstance(v, tuple):
        pool, idx = v
        return [pool[i] for i in idx]
    return v


@pytest.mark.parametrize("leaf", TABLE.LEAVES)
def test_every_leaf_reads_back_exactly(drawn, read, leaf):
    groups, _ = drawn
    _, out, _, _ = read
    assert len(out) == len(groups)
    for g, got in zip(groups, out):
        col, want = got[leaf], g[leaf]
        if leaf in FLAT:
            assert col.max_def == col.max_rep == 0
            if isinstance(want, tuple):
                assert [bytes(b) for b in _host(col)] == _want(want)
            else:
                np.testing.assert_array_equal(_host(col), want)
            continue
        assert (col.max_def, col.max_rep) == (2, 1)
        assert col.num_leaf_slots == len(want.def_levels)
        vals = _host(col)
        if isinstance(want.values, tuple):
            assert [bytes(b) for b in vals] == _want(want.values)
        else:
            np.testing.assert_array_equal(vals, want.values)
        d, r = col.levels_to_host()
        np.testing.assert_array_equal(d, want.def_levels)
        np.testing.assert_array_equal(r, want.rep_levels)


def test_the_level_walks_are_a_part_of_their_own(read):
    r, _, _, _ = read
    d = r.stats().host_parts()
    assert set(d["parts"]) == set(obs.HOST_PARTS)
    assert d["parts"]["level_walk"] > 0
    assert sum(d["parts"].values()) == pytest.approx(d["host_seconds"],
                                                     rel=1e-9)
    assert all(v >= -1e-9 for v in d["parts"].values()), d["parts"]


def test_a_flat_file_walks_no_level(tmp_path):
    cfg = {"table": "lineitem", "rows": 20_000, "rows_per_group": 10_000,
           "layout": "port_writer"}
    path = str(tmp_path / "flat.parquet")
    write.write_file(cfg, tables.load("lineitem").draw(SEED, cfg), path)
    before = obs.level_totals()
    r, _ = _read(path)
    d = r.stats().host_parts()
    assert d["parts"]["level_walk"] == 0.0
    assert d["parts"]["run_walk"] > 0
    assert obs.level_totals() == before
    assert "levels" not in d["chunk_walk_fallbacks"]


def test_level_slots_by_kind_are_the_slots_of_every_nested_leaf(drawn,
                                                                 read):
    groups, _ = drawn
    _, _, added, _ = read
    slots = sum(len(g[NESTED[0]].def_levels) for g in groups)
    assert slots == LINEITEMS
    assert added["slots"]["by_kind"] == {"def": len(NESTED) * slots,
                                         "rep": len(NESTED) * slots}
    assert sum(added["slots"]["by_route"].values()) == 2 * len(NESTED) * slots


def test_level_streams_by_route_are_the_pages_level_streams(read):
    r, _, added, events = read
    pages = sum(e["args"]["pages"] for e in events
                if e["name"] == "chunk" and e["args"]["max_rep"] > 0)
    assert pages > 0
    by_route = added["streams"]["by_route"]
    # the batched reader expands every level stream on the device
    assert by_route["host"] == 0
    assert by_route["k1"] + by_route["run_table"] == 2 * pages
    assert added["streams"]["by_kind"] == {"def": pages, "rep": pages}


def test_every_nested_chunk_falls_back_for_its_levels(drawn, read):
    groups, _ = drawn
    r, _, _, _ = read
    d = r.stats().host_parts()
    assert d["chunk_walk_fallbacks"] == {"levels": len(NESTED) * len(groups)}
    # ORDERS' flat columns, walked natively
    assert d["chunk_walks"] == len(FLAT) * len(groups)


def test_the_chunk_and_levels_spans(drawn, read):
    groups, _ = drawn
    _, _, _, events = read
    chunks = [e for e in events if e["name"] == "chunk"]
    assert len(chunks) == len(TABLE.LEAVES) * len(groups)
    for e in chunks:
        a = e["args"]
        if a["column"] in FLAT:
            assert (a["max_def"], a["max_rep"], a["walk"]) == (0, 0,
                                                               "native")
        else:
            assert (a["max_def"], a["max_rep"], a["walk"]) == (2, 1,
                                                               "levels")
    levels = [e for e in events if e["name"] == "levels"]
    assert len(levels) == 2 * len(NESTED) * len(groups)
    assert {e["args"]["kind"] for e in levels} == {"def", "rep"}
    assert {e["args"]["route"] for e in levels} <= {"k1", "run_table"}
    assert sum(e["args"]["slots"] for e in levels) == 2 * len(NESTED) \
        * LINEITEMS
    finishes = [e for e in events if e["name"] == "finish"]

    def inside(child):
        return any(p["tid"] == child["tid"]
                   and p["ts"] <= child["ts"] + 2
                   and child["ts"] + child["dur"] <= p["ts"] + p["dur"] + 2
                   for p in finishes)

    assert all(inside(e) for e in levels)


def test_the_spans_reach_the_flight_ring(drawn):
    _, path = drawn
    _read(path)
    dump = obs.flight_recorder().snapshot(reason="orders-nested")
    ev = [e for t in dump["threads"].values() for e in t["events"]]
    chunks = [e for e in ev if e["name"] == "chunk"
              and e.get("args", {}).get("max_rep") == 1]
    assert chunks and all(e["args"]["walk"] == "levels" for e in chunks)
    levels = [e for e in ev if e["name"] == "levels"]
    assert levels
    assert set(levels[0]["args"]) == {"column", "kind", "slots", "streams",
                                      "route"}


def test_the_host_decode_path_counts_its_levels(drawn):
    from tpu_parquet_torch.footer import read_file_metadata
    from tpu_parquet_torch.torch_decode import read_chunk_device

    groups, path = drawn
    with open(path, "rb") as f:
        meta = read_file_metadata(f)
    r = DeviceFileReader(path, device="cpu")
    try:
        leaf = next(lf for lf in r.schema.leaves
                    if ".".join(lf.path) == NESTED[0])
    finally:
        r.close()
    chunk = next(c for c in meta.row_groups[0].columns
                 if ".".join(c.meta_data.path_in_schema) == NESTED[0])
    before = obs.level_totals()
    with open(path, "rb") as f:
        col = read_chunk_device(f, chunk, leaf, device="cpu")
    after = obs.level_totals()
    slots = len(groups[0][NESTED[0]].def_levels)
    assert col.num_leaf_slots == slots
    d, rp = col.levels_to_host()
    np.testing.assert_array_equal(d, groups[0][NESTED[0]].def_levels)
    np.testing.assert_array_equal(rp, groups[0][NESTED[0]].rep_levels)
    for k in ("def", "rep"):
        assert (after["slots"]["by_kind"][k]
                - before["slots"]["by_kind"][k]) == slots
    assert (after["slots"]["by_route"]["host"]
            - before["slots"]["by_route"]["host"]) == 2 * slots
    assert (after["streams"]["by_route"]["k1"]
            == before["streams"]["by_route"]["k1"])
