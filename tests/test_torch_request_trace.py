"""The request trace riding ``resilience.CancelToken.trace`` through the
port's readers and stores, against the JAX package's (mirroring
``tests/test_request_trace.py``).

- ``RequestTrace`` / ``TailSampler`` / exemplars behave the same in both
  packages (the units, run against each);
- a read whose cancel token carries a ``RequestTrace`` records the same
  spans as the reference's on the same file and faults: one ``fetch`` per
  store read (threaded ``GenericRangeStore.read_range``, or the fetch
  engine's after-the-fact span) with its retry annotations, one ``decode``
  per unit of the prefetch pool, one ``device`` per dispatched group, and
  the well-nested tree closes with no open span;
- tracing never changes a byte of the output.

Counts and names are compared exactly; durations never.
"""

import collections
import json
import threading

import numpy as np
import pytest

from tpu_parquet import device_reader as RDR
from tpu_parquet import iostore as RS
from tpu_parquet import obs as RO
from tpu_parquet import reader as RR
from tpu_parquet import resilience as RRES
from tpu_parquet.iostore_async import \
    shutdown_default_engine as ref_shutdown_engine
from tpu_parquet_torch import obs as PO
from tpu_parquet_torch import resilience as PRES
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                       IOConfig, LocalStore)
from tpu_parquet_torch.iostore_async import shutdown_default_engine
from tpu_parquet_torch.reader import FileReader
from tests.test_torch_ref_native import ensure_reference_native
from tests.test_torch_watchdog import _write_file

ensure_reference_native()

BOTH = pytest.mark.parametrize("mod", [RO, PO], ids=["ref", "port"])


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    yield monkeypatch
    shutdown_default_engine()
    ref_shutdown_engine()


# ---------------------------------------------------------------------------
# the units, against both packages
# ---------------------------------------------------------------------------

@BOTH
def test_trace_well_nested_and_closed(mod):
    tr = mod.RequestTrace()
    with tr.span("root", kind="request"):
        with tr.span("child"):
            tr.annotate(bytes=7)
        tr.add_timed("timed", 0.0, 0.001, n=3)
    assert tr.finish() >= 0.0
    assert [s[0] for s in tr.spans] == ["root", "child", "timed"]
    assert [s[3] for s in tr.spans] == [-1, 0, 0]
    assert tr.spans[1][4] == {"bytes": 7}
    doc = tr.as_dict()
    assert doc["trace_id"] == tr.trace_id and doc["dropped"] == 0


@BOTH
def test_trace_error_flags_and_span_cap(mod):
    tr = mod.RequestTrace(max_spans=4)
    with pytest.raises(ValueError):
        with tr.span("fetch", offset=0):
            raise ValueError("boom")
    tr.mark_error(ValueError("boom"))
    tr.set_flag("deadline")
    for i in range(8):
        with tr.span(f"s{i}"):
            pass
    tr.finish()
    assert tr.spans[0][4]["error"] == "ValueError"
    assert tr.error == {"type": "ValueError", "message": "boom"}
    assert tr.flags == {"deadline"}
    assert len(tr.spans) == 4 and tr.dropped == 5


@BOTH
def test_trace_cross_thread_nesting_and_orphan_close(mod):
    tr = mod.RequestTrace()
    started, release = threading.Event(), threading.Event()

    def helper():
        tr.span("worker").__enter__()  # left open: finish closes it
        with tr.span("inner"):
            started.set()
            release.wait(5.0)

    with tr.span("request"):
        t = threading.Thread(target=helper)
        t.start()
        started.wait(5.0)
        with tr.span("main_child"):
            pass
        release.set()
        t.join()
    tr.finish()
    by_name = {s[0]: s for s in tr.spans}
    assert by_name["worker"][3] == -1
    assert by_name["inner"][3] == tr.spans.index(by_name["worker"])
    assert by_name["main_child"][3] == tr.spans.index(by_name["request"])
    assert all(s[2] is not None for s in tr.spans)


@BOTH
def test_current_request_trace_install_restore(mod):
    assert mod.current_request_trace() is None
    tr = mod.RequestTrace()
    prev = mod.set_request_trace(tr)
    assert prev is None and mod.current_request_trace() is tr
    mod.set_request_trace(prev)
    assert mod.current_request_trace() is None


def _finished(mod, nspans=3):
    tr = mod.RequestTrace()
    for i in range(nspans):
        with tr.span(f"s{i}"):
            pass
    tr.finish()
    return tr


@BOTH
def test_tail_sampler_policy_ring_and_dump(mod, tmp_path):
    s = mod.TailSampler(one_in_n=100, ring_bytes=1 << 20)
    assert not s.offer(_finished(mod), duration_s=0.001)
    err = _finished(mod)
    assert s.offer(err, duration_s=0.001, error=True)
    flagged = _finished(mod)
    flagged.set_flag("shed")
    assert s.offer(flagged, duration_s=0.001)
    c = s.counters()
    assert c["offered"] == 3 and c["retained"] == 2
    small = mod.TailSampler(one_in_n=1, ring_bytes=4096)
    for _ in range(64):
        small.offer(_finished(mod, nspans=8), duration_s=0.001)
        c = small.counters()
        assert c["retained_bytes"] <= c["ring_capacity_bytes"]
    assert small.counters()["evicted"] > 0
    path = str(tmp_path / "traces.json")
    assert s.dump(path) == path
    with open(path) as f:
        doc = json.load(f)
    assert doc["trace_dump_version"] == 1
    assert {t["trace_id"] for t in doc["traces"]} == {err.trace_id,
                                                      flagged.trace_id}


def test_exemplars_render_the_same_text():
    trees = []
    for mod in (RO, PO):
        h = mod.LatencyHistogram()
        h.record(0.001)
        h.record(0.004, exemplar="tpq-aaaa")
        h.record(0.2, exemplar="tpq-bbbb")
        for idx, (_tid, val) in h.exemplars.items():
            assert mod.LatencyHistogram.bucket_index(val) == idx
        trees.append({"serve": {"requests": 3},
                      "histograms": {"serve.request": h.as_dict()}})
    assert trees[0] == trees[1]
    text = PO.render_openmetrics(trees[1])
    assert text == RO.render_openmetrics(trees[0])
    assert 'trace_id="tpq-bbbb"' in text and text.endswith("# EOF\n")


# ---------------------------------------------------------------------------
# the trace riding the cancel token through the readers and stores
# ---------------------------------------------------------------------------

def _port_store(f):
    return FaultInjectingStore(LocalStore(f), FaultSpec(fail_first=1),
                               config=IOConfig(retries=3, backoff_ms=1.0,
                                               retry_budget=0))


def _ref_store(f):
    return RS.FaultInjectingStore(RS.LocalStore(f), RS.FaultSpec(fail_first=1),
                                  config=RS.IOConfig(retries=3,
                                                     backoff_ms=1.0,
                                                     retry_budget=0))


def _traced_read(make, res, obs_mod):
    tok = res.CancelToken()
    tok.trace = obs_mod.RequestTrace(max_spans=4096)
    r = make(tok)
    cols = []
    for g in r.iter_row_groups():
        cols.append(g)
    if hasattr(r, "finalize"):
        r.finalize()
    r.close()
    tok.trace.finish()
    return tok.trace, cols


def _span_names(tr):
    return collections.Counter(s[0] for s in tr.spans)


def _fetch_notes(tr):
    return sorted((s[4].get("offset"), s[4].get("size"), s[4].get("retries"),
                   s[4].get("engine", False))
                  for s in tr.spans if s[0] == "fetch")


READERS = {
    "device": (lambda p, k, tok, st: DeviceFileReader(
                   p, device="cpu", prefetch=k, cancel=tok, store=st),
               lambda p, k, tok, st: RDR.DeviceFileReader(
                   p, prefetch=k, cancel=tok, store=st)),
    "host": (lambda p, k, tok, st: FileReader(p, prefetch=k, cancel=tok,
                                              store=st),
             lambda p, k, tok, st: RR.FileReader(p, prefetch=k, cancel=tok,
                                                 store=st)),
}


@pytest.mark.parametrize("engine", ["0", "1"])
@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("kind", sorted(READERS))
def test_request_trace_spans_equal_the_reference(tmp_path, env, kind,
                                                 prefetch, engine):
    env.setenv("TPQ_IO_ASYNC", engine)
    path = _write_file(str(tmp_path / "rt.parquet"), groups=4)
    port, ref = READERS[kind]
    got, _ = _traced_read(
        lambda tok: port(path, prefetch, tok, _port_store), PRES, PO)
    want, _ = _traced_read(
        lambda tok: ref(path, prefetch, tok, _ref_store), RRES, RO)
    assert _span_names(got) == _span_names(want)
    assert _fetch_notes(got) == _fetch_notes(want)
    names = _span_names(got)
    # two chunks per group, four groups: one read each, or one coalesced
    # span per group on the prefetch path
    assert names["fetch"] == (4 if prefetch else 8)
    if prefetch:
        assert names["decode"] > 0
    if kind == "device":
        assert names["device"] == 4
    # every fetch retried once: the first attempt of each range fails
    assert {n[2] for n in _fetch_notes(got)} == {1}
    doc = got.as_dict()
    assert all(s["parent"] < i for i, s in enumerate(doc["spans"]))
    assert all(s["dur_s"] is not None for s in doc["spans"])


@pytest.mark.parametrize("prefetch", [0, 4])
def test_tracing_never_changes_the_output(tmp_path, env, prefetch):
    path = _write_file(str(tmp_path / "same.parquet"), groups=3)
    _, traced = _traced_read(
        lambda tok: DeviceFileReader(path, device="cpu", prefetch=prefetch,
                                     cancel=tok, store=_port_store),
        PRES, PO)
    plain = list(DeviceFileReader(path, device="cpu", prefetch=prefetch,
                                  store=_port_store).iter_row_groups())
    assert len(traced) == len(plain) == 3
    for a, b in zip(traced, plain):
        assert set(a) == set(b)
        for name in a:
            assert np.array_equal(a[name].to_host(), b[name].to_host())


def test_current_request_trace_reaches_the_result_probe(tmp_path, env):
    """Without a cancel token, the thread's current trace gets the device
    spans and the result cache's probe spans."""
    from tpu_parquet_torch.serve import PlanCache

    path = _write_file(str(tmp_path / "probe.parquet"), groups=2)
    cache = PlanCache(result_cache_mb=64, result_cache_hbm_mb=64)
    tr = PO.RequestTrace()
    prev = PO.set_request_trace(tr)
    try:
        for _ in range(2):
            kw = cache.reader_kwargs(path, device="cpu")
            r = DeviceFileReader(path, device="cpu", **kw)
            for _g in r.iter_row_groups():
                pass
            r.finalize()
            r.close()
    finally:
        PO.set_request_trace(prev)
    tr.finish()
    names = _span_names(tr)
    assert names["result_probe"] == 4
    assert names["device"] == 2  # the warm read dispatches nothing
    hits = [s[4]["hit"] for s in tr.spans if s[0] == "result_probe"]
    assert hits == [False, False, True, True]
