"""The port's ``obs`` against the JAX package's (mirroring
``tests/test_obs.py``).

Both packages' readers read the same files with ``trace=`` a path; their
trace files hold the same span and instant names, the same number of each,
and well-nested spans.  ``trace_summary``, ``render_openmetrics``,
``diff_registry_trees`` and ``doctor_registry`` of the two packages give
the same output for the same input; ``MetricsDumper``, the ``Sampler``,
the tracer, the histograms and ``StatsRegistry`` behave the same in both.
Everything is compared exactly; times are never compared.
"""

import collections
import json
import threading
import time

import numpy as np
import pytest

import bench
from tpu_parquet import device_reader as RDR
from tpu_parquet import obs as RO
from tpu_parquet import reader as RR
from tpu_parquet_torch import obs as PO
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.pipeline import STAGES, PipelineStats
from tpu_parquet_torch.reader import FileReader
from tests.test_torch_ref_native import (  # noqa: F401 — the fixture
    ensure_reference_native, reference_env_warnings)

ensure_reference_native()


@pytest.fixture(autouse=True)
def _restore_reference_env_warnings(reference_env_warnings):
    """The once-per-value env warnings the reference half spends (its
    resolvers read malformed values here) leave with the test."""
    yield

ROWS, GROUP = 6_000, 2_000
BOTH = pytest.mark.parametrize("mod", [RO, PO], ids=["ref", "port"])


@pytest.fixture(scope="module")
def l16(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("obs") / "l16.parquet")
    bench.gen_lineitem16(path, ROWS, GROUP)
    return path


@pytest.fixture
def reference_env(monkeypatch):
    # the reference runs its Pallas kernels in interpret mode
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    monkeypatch.delenv("TPQ_TRACE", raising=False)


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _names(events):
    return collections.Counter((e["ph"], e["name"]) for e in events
                               if e["ph"] in ("X", "i"))


# the device reader's spans inside ``prepare`` that the reference lacks
PORT_CHUNK_SPANS = ("chunk", "collect", "preship", "finish")


def _assert_nesting(events):
    """On one thread two spans are disjoint or one holds the other (2 µs
    for the integer-microsecond floor)."""
    by_tid = collections.defaultdict(list)
    for ev in events:
        if ev["ph"] == "X":
            by_tid[(ev["pid"], ev["tid"])].append(
                (ev["ts"], ev["ts"] + ev["dur"]))
    for spans in by_tid.values():
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack = []
        for lo, hi in spans:
            while stack and stack[-1] <= lo:
                stack.pop()
            if stack:
                assert hi <= stack[-1] + 2, (lo, hi, stack[-1])
            stack.append(hi)


def _read(reader):
    for _ in reader.iter_row_groups():
        pass
    if hasattr(reader, "finalize"):
        reader.finalize()
    reader.close()


READERS = {
    "device": (lambda p, k, t: DeviceFileReader(p, device="cpu", prefetch=k,
                                                trace=t),
               lambda p, k, t: RDR.DeviceFileReader(p, prefetch=k, trace=t)),
    "host": (lambda p, k, t: FileReader(p, prefetch=k, trace=t),
             lambda p, k, t: RR.FileReader(p, prefetch=k, trace=t)),
}


@pytest.mark.parametrize("kind", sorted(READERS))
@pytest.mark.parametrize("prefetch", [0, 4])
def test_trace_files_hold_the_reference_spans(l16, tmp_path, reference_env,
                                              kind, prefetch):
    port, ref = READERS[kind]
    pt, rt = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    reader = port(l16, prefetch, pt)
    _read(reader)
    _read(ref(l16, prefetch, rt))
    got, want = _events(pt), _events(rt)
    names = _names(got)
    # the port's device reader adds one span of each of its own names per
    # chunk (the host phase's split); every other name and count is the
    # reference's
    own = {("X", n): names.pop(("X", n), 0) for n in PORT_CHUNK_SPANS}
    assert names == _names(want)
    if kind == "device":
        assert set(own.values()) == {reader.stats().chunks}
    else:
        assert set(own.values()) == {0}
    _assert_nesting(got)
    # the registry tree rides the trace file, as the reference's
    with open(pt) as f:
        reg = json.load(f)["otherData"]["registry"]
    assert reg["obs_version"] == RO.OBS_VERSION == PO.OBS_VERSION
    assert reg["pipeline"]["prefetch"] == prefetch


def test_trace_summary_equal_on_the_same_trace(l16, tmp_path, reference_env):
    pt = str(tmp_path / "port.json")
    _read(DeviceFileReader(l16, device="cpu", prefetch=4, trace=pt))
    with open(pt) as f:
        doc = json.load(f)
    got, want = PO.trace_summary(doc), RO.trace_summary(doc)
    assert got == want
    assert got["stages"]["dispatch"]["count"] == ROWS // GROUP


def _tree(l16):
    r = DeviceFileReader(l16, device="cpu", prefetch=4)
    _read(r)
    return r.obs_registry().as_dict()


def test_render_openmetrics_same_text(l16, reference_env):
    tree = _tree(l16)
    text = PO.render_openmetrics(tree)
    assert text == RO.render_openmetrics(tree)
    assert text.endswith("# EOF\n")
    assert "tpq_device_routes" in text


def test_diff_and_doctor_equal_on_the_same_trees(l16, reference_env):
    old = _tree(l16)
    r = DeviceFileReader(l16, device="cpu", prefetch=0)
    _read(r)
    new = r.obs_registry().as_dict()
    assert PO.diff_registry_trees(old, new) == RO.diff_registry_trees(
        old, new)
    assert PO.doctor_registry(new) == RO.doctor_registry(new)
    assert PO.doctor_registry(new)["verdict"] is not None


@BOTH
def test_metrics_dumper_writes_periodically_and_at_stop(tmp_path, mod):
    reg = mod.StatsRegistry()
    reg.histogram("x").record(0.002)
    path = str(tmp_path / "m" / "snap.json")
    d = mod.MetricsDumper(lambda: reg, spec=f"{path}:0.02")
    assert d.enabled
    with d:
        deadline = time.monotonic() + 5
        while d.written < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
    assert d.written >= 3 and d.dropped == 0
    with open(path) as f:
        assert json.load(f)["histograms"]["x"]["count"] == 1
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-metricsdump")]
    assert mod.MetricsDumper(lambda: reg, spec="nocolon").enabled is False


def test_metrics_dumper_parse_forms_equal():
    for spec in ("a:1", "a:0", "a:-1", "a:x", ":1", "b/c.json:0.5"):
        assert PO.resolve_metrics_dump(spec) == RO.resolve_metrics_dump(spec)


def test_disabled_tracer_records_nothing():
    tr = PO.Tracer(enabled=False, ring=None)  # no flight tee either
    assert tr.span("a", x=1) is tr.span("b")  # the shared no-op
    with tr.span("x", a=1):
        tr.instant("i")
        tr.counter("c", v=1)
    assert tr.events() == [] and not tr.active
    # the default disabled tracer still tees into the flight recorder
    tr2 = PO.Tracer(enabled=False)
    assert tr2.active and not tr2.enabled
    tr2.complete("x", 0.0, 1.0)
    assert tr2.events() == []


@BOTH
def test_span_nesting_and_export_fields(mod):
    tr = mod.Tracer()
    with tr.span("outer", rg=0):
        with tr.span("inner"):
            time.sleep(0.002)
        with tr.span("inner"):
            pass
    tr.instant("mark", k="v")
    tr.counter("gauge", rows=7)
    events = tr.events()
    _assert_nesting(events)
    xs = [e for e in events if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["inner", "inner", "outer"]
    assert xs[-1]["args"] == {"rg": 0}
    doc = tr.export()
    assert set(doc) == {"traceEvents", "displayTimeUnit", "otherData"}


def test_resolve_forms_equal(monkeypatch, tmp_path):
    for raw in ("", "25", "abc", "-3"):
        monkeypatch.setenv("TPQ_SAMPLE_MS", raw)
        monkeypatch.setenv("TPQ_HANG_S", raw)
        assert PO.resolve_sample_ms() == RO.resolve_sample_ms()
        assert PO.resolve_hang_s() == RO.resolve_hang_s()
    tr, owned = PO.resolve_tracer(str(tmp_path / "a.json"))
    assert owned and tr.enabled
    assert PO.resolve_tracer(tr) == (tr, False)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_dict_round_trip_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    got, want = PO.LatencyHistogram(), RO.LatencyHistogram()
    for d in rng.exponential(0.01, 500):
        got.record(float(d), exemplar="t1" if d > 0.02 else None)
        want.record(float(d), exemplar="t1" if d > 0.02 else None)
    assert got.as_dict() == want.as_dict()
    back = PO.LatencyHistogram.from_dict(got.as_dict())
    assert back.as_dict() == got.as_dict()
    merged = PO.LatencyHistogram()
    merged.merge_from(got)
    merged.merge_dict(want.as_dict())
    assert merged.count == 1000


def test_pipeline_stage_histograms_match_the_reference():
    from tpu_parquet.pipeline import PipelineStats as RefStats

    got, want = PipelineStats(), RefStats()
    for i, stage in enumerate(STAGES * 5):
        for st in (got, want):
            st.add(stage, 1e-4 * (i + 1))
    gh = got.as_dict()["stage_histograms"]
    wh = want.as_dict()["stage_histograms"]
    assert gh == wh
    assert got.sample().keys() == want.sample().keys()


def test_registry_tree_keys_equal_the_reference(l16, reference_env):
    """The reader's tree, rebuilt by each package's registry from the same
    sections, has the same keys and values."""
    tree = _tree(l16)
    for mod in (RO, PO):
        reg = mod.StatsRegistry()
        reg.merge_dict(tree)
        rebuilt = reg.as_dict()
        assert set(rebuilt) == set(tree)
    a, b = PO.StatsRegistry(), RO.StatsRegistry()
    a.merge_dict(tree)
    b.merge_dict(tree)
    assert a.as_dict() == b.as_dict()


@BOTH
def test_sampler_ticks_counters_and_joins(mod):
    tr = mod.Tracer()
    n = {"v": 0}

    def src():
        n["v"] += 1
        return {"v": n["v"]}

    s = mod.Sampler(tr, 5.0, track_id=7)
    s.add_source("probe", src)
    s.start()
    time.sleep(0.06)
    s.stop()
    counters = [e for e in tr.events() if e["ph"] == "C"]
    assert len(counters) >= 3
    assert {e["name"] for e in counters} == {"probe"}
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-sampler")]


def test_device_reader_sampler_tracks(l16, tmp_path, reference_env):
    pt = str(tmp_path / "s.json")
    r = DeviceFileReader(l16, device="cpu", prefetch=2, trace=pt,
                         sample_ms=1)
    _read(r)
    names = {e["name"] for e in _events(pt) if e["ph"] == "C"}
    assert {"pipeline_lanes", "reader_progress", "alloc_bytes",
            "device"} <= names
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("tpq-sampler", "tpq-devtimer"))]


def test_tpq_trace_env_reaches_the_readers(l16, tmp_path, monkeypatch):
    p = str(tmp_path / "env.json")
    monkeypatch.setenv("TPQ_TRACE", p)
    tr = PO.current_tracer()
    assert tr.enabled
    r = DeviceFileReader(l16, device="cpu")
    assert r._tracer is tr and not r._owns_tracer
    _read(r)
    assert any(e["name"] == "dispatch" for e in tr.events())
    monkeypatch.delenv("TPQ_TRACE")


def test_doctor_recalibrates_through_the_ports_ship(l16, reference_env):
    """Off the error band, the doctor hands back the measured device and
    link rates through ``ship.recalibrate_device_mbps`` /
    ``recalibrate_link_mbps`` of the port (whose planner constants are the
    reference's): the same numbers from both packages' doctors."""
    from tpu_parquet_torch import ship

    tree = _tree(l16)
    rep = PO.doctor_registry(tree)
    assert rep == RO.doctor_registry(tree)
    dev = rep["device"]
    assert dev["dominant_route"] in tree["device"]["routes"]
    route = tree["device"]["routes"][dev["dominant_route"]]
    bps = route["bytes_in"] / route["device_seconds"]
    if "recalibrate_device_mbps" in rep:
        assert rep["recalibrate_device_mbps"] == \
            ship.recalibrate_device_mbps(bps)
    # a tree whose device lane ran 100x its prediction is off the band
    slow = json.loads(json.dumps(tree))
    routes = slow["device"]["routes"]
    top = max(routes, key=lambda r: routes[r]["bytes_in"])
    for r, c in routes.items():
        c["device_seconds"] = 1.0 if r == top else 1e-6
    slow["reader"]["ship_routes"][top]["predicted_device_s"] = 0.01
    rep = PO.doctor_registry(slow)
    assert rep == RO.doctor_registry(slow)
    assert rep["device"]["dominant_route"] == top
    assert rep["device"]["error_ratio"] == 100.0
    assert rep["recalibrate_device_mbps"] == ship.recalibrate_device_mbps(
        routes[top]["bytes_in"] / 1.0)
