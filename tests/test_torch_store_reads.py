"""The device reader and ``scan_files`` reading through byte stores.

``DeviceFileReader(device="cpu", store=..., cancel=...)`` over four files
made from numpy seeds: a REQUIRED SNAPPY file and the K3 file in GZIP
(``tests/test_torch_compressed``'s columns), ``bench.gen_lineitem16``'s 16
columns, and a page-pruned read (``tests/test_torch_pruning``'s plain file
under its window filter, whose filter chunks the pruning planner reads
first).  Held exactly:

- a ``FaultInjectingStore`` read under every recoverable fault, at
  prefetch 0 and 4, threaded and through the fetch engine, equals the
  ``LocalStore`` read: every output, every route and ship counter,
  ``staged_bytes`` and ``compressed_bytes`` (coalescing changes requests,
  never what is staged);
- its ``IOStats`` and ``compressed_bytes`` equal the reference device
  reader's under the same store (``TPQ_PALLAS=1 TPQ_FUSE=1``);
- no chunk range is fetched twice on a clean store, and chunks the
  pruning planner read never join a span;
- a cancel or a deadline mid-scan raises its typed verdict and leaves the
  device ledger empty, no budget charge, no ``tpq-prefetch`` or
  ``tpq-stage`` thread, and a new reader reads bit-equal; quarantine never
  contains an exhausted retry or a cancel;
- ``corrupt=`` bytes through the store are data: one quarantine record
  under ``skip_unit``, equal to the reference's;
- ``scan_files`` under a ``ChaosSchedule`` equals its clean read;
- the port's one deliberate difference: the sequential device path checks
  the cancel token at each row group even over a ``LocalStore``.
"""

import asyncio
import gc
import threading
import time

import numpy as np
import pytest
import torch

import bench
from tests.test_torch_compressed import _write as write_k3
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_pruning import I32, I64, DBL, _filter, _port_file
from tpu_parquet import device_reader as RDR
from tpu_parquet import iostore as RS
from tpu_parquet import predicate as RP
from tpu_parquet import quarantine as RQ
from tpu_parquet import resilience as RR
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch import predicate as P
from tpu_parquet_torch import quarantine as Q
from tpu_parquet_torch import resilience as R
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.errors import (CancelledError, DeadlineExceededError,
                                      RetryExhaustedError)
from tpu_parquet_torch.format import CompressionCodec
from tpu_parquet_torch.iostore_async import (default_engine_if_running,
                                             shutdown_default_engine)
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


SN, GZ, U = (CompressionCodec.SNAPPY, CompressionCodec.GZIP,
             CompressionCodec.UNCOMPRESSED)
FILES = {
    "required": lambda p: write_k3(p, rows=40_000, group=20_000, codec=SN),
    "k3": lambda p: write_k3(p, rows=40_000, group=20_000, codec=GZ),
    "lineitem16": lambda p: bench.gen_lineitem16(p, 12_000, 6_000),
    "pruned": lambda p: _port_file(p, {"v": I64, "f": DBL, "w": I32}, U),
}
SPECS = {
    "clean": {},
    "fail_first": {"fail_first": 2},
    "torn_first": {"torn_first": 1},
    "fail_and_torn": {"fail_first": 2, "torn_first": 1},
}
MODES = {"threaded": "0", "engine": "1"}
KEYS = ("row_groups", "chunks", "pages", "pages_pruned", "rows",
        "compressed_bytes", "staged_bytes", "link_bytes_logical",
        "link_bytes_shipped", "fused_fallbacks", "pages_device_expanded")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_store_reads")
    out = {}
    for name, make in FILES.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


def _kw(name, M_pred):
    return ({"row_filter": _filter(M_pred, "plain")} if name == "pruned"
            else {})


def _host(col):
    v = col.to_host()
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        v = (np.asarray(v.offsets), np.asarray(v.heap))
    else:
        v = (np.asarray(v),)
    lv = col.levels_to_host()
    return (type(col).__name__,
            tuple(x.view(np.uint8).tobytes() for x in v),
            tuple(None if x is None else np.asarray(x).tobytes()
                  for x in lv))


def _counters(st):
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in st["ship_routes"].items()}
    return routes, {k: st[k] for k in KEYS}


def _read(reader):
    with reader as r:
        outs = [{k: _host(v) for k, v in g.items()}
                for g in r.iter_row_groups()]
        assert r.alloc.device_snapshot()[0] == 0
        return outs, _counters(r.stats().as_dict())


def _factory(M, spec, stores, **cfg):
    """A ``store=`` factory over ``M``'s ``FaultInjectingStore``: 1 ms
    backoffs and no per-scan retry cap (lineitem16's 32 chunks at three
    faults each would pass the default 64)."""
    cfg.setdefault("backoff_ms", 1.0)
    cfg.setdefault("retry_budget", 0)

    def make(f):
        st = M.FaultInjectingStore(M.LocalStore(f), M.FaultSpec(**spec),
                                   config=M.IOConfig(**cfg))
        stores.append(st)
        return st

    return make


def _io(stores):
    out: dict = {}
    for st in stores:
        for k, v in st.stats.as_dict().items():
            if k != "backoff_seconds":
                out[k] = out.get(k, 0) + v
    return out


_LOCAL: dict = {}


def _local(files, name, k):
    """The ``LocalStore`` read of ``files[name]`` at depth ``k`` (made
    once per module)."""
    if (name, k) not in _LOCAL:
        _LOCAL[name, k] = _read(DR.DeviceFileReader(
            files[name], device="cpu", prefetch=k, **_kw(name, P)))
    return _LOCAL[name, k]


def _tpq_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("tpq-prefetch", "tpq-stage"))]


# ---------------------------------------------------------------------------
# every recoverable fault reads as the local file, and as the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("name", list(FILES))
def test_store_read_equals_the_local_read(files, io_env, name, spec, k,
                                          mode):
    io_env.setenv("TPQ_IO_ASYNC", MODES[mode])
    want_outs, want_counters = _local(files, name, k)
    stores = []
    outs, counters = _read(DR.DeviceFileReader(
        files[name], device="cpu", prefetch=k,
        store=_factory(S, SPECS[spec], stores), **_kw(name, P)))
    assert outs == want_outs
    assert counters == want_counters
    d = _io(stores)
    assert d["exhausted"] == 0
    if spec == "clean" and name != "pruned":
        # no range fetched twice: a span or a chunk, each once (the
        # pruning planner's header walks read inside chunks: see below)
        assert set(stores[0]._attempts.values()) == {1}
    if k and name != "pruned":
        # a row group's chunk reads coalesce
        assert d["coalesced_spans"] > 0
    eng = default_engine_if_running()
    assert (eng is not None and eng.stats.submitted > 0) == (
        mode == "engine" and k > 0)
    assert not _tpq_threads()


@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("spec", ["fail_first", "fail_and_torn"])
@pytest.mark.parametrize("name", list(FILES))
def test_store_counters_equal_the_reference(files, io_env, name, spec, k):
    got, want = [], []
    for M, mod, pred, out in ((S, DR, P, got), (RS, RDR, RP, want)):
        stores = []
        kw = {"device": "cpu"} if mod is DR else {}
        with mod.DeviceFileReader(files[name], prefetch=k,
                                  store=_factory(M, SPECS[spec], stores),
                                  **_kw(name, pred), **kw) as r:
            outs = [{c: _host(v) for c, v in g.items()}
                    for g in r.iter_row_groups()]
            st = r.stats().as_dict()
        out.append((outs, _io(stores), st["compressed_bytes"],
                     st["chunks"], st["pages_pruned"]))
    assert got == want


@pytest.mark.parametrize("k", [0, 4])
def test_planned_filter_chunks_never_join_a_span(files, io_env, k):
    """The pruning planner reads the filter chunks whole and walks the
    other chunks' page headers; every selected chunk is then covered by
    exactly one whole read (its own, or a span's), never twice."""
    calls = []

    class Recording(S.LocalStore):
        def read_range(self, offset, size, deadline=None, scan=None):
            calls.append((offset, size))
            return super().read_range(offset, size)

    def make(f):
        return S.FaultInjectingStore(Recording(f), S.FaultSpec(),
                                     config=S.IOConfig(backoff_ms=1))

    with DR.DeviceFileReader(files["pruned"], device="cpu", prefetch=k,
                             store=make,
                             row_filter=_filter(P, "plain")) as r:
        outs = [{c: _host(v) for c, v in g.items()}
                for g in r.iter_row_groups()]
        st = r.stats().as_dict()
        kept = [i for i in range(r.num_row_groups)
                if r.row_group_selected(i)]
        chunks = [(c.meta_data.data_page_offset,
                   c.meta_data.total_compressed_size)
                  for i in kept for c in r.metadata.row_groups[i].columns]
    assert outs == _local(files, "pruned", k)[0]
    assert st["pages_pruned"] > 0 and chunks
    for off, size in chunks:
        whole = [c for c in calls
                 if c[0] <= off and c[0] + c[1] >= off + size]
        assert len(whole) == 1, (off, size, whole)


# ---------------------------------------------------------------------------
# unrecoverable: exhausted retries, cancel, deadline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [0, 4])
def test_exhausted_retries_end_the_scan_and_leave_nothing(files, io_env, k,
                                                          mode):
    io_env.setenv("TPQ_IO_ASYNC", MODES[mode])
    errs = []
    for M, mod, out in ((S, DR, errs), (RS, RDR, errs)):
        kw = {"device": "cpu"} if mod is DR else {}
        r = mod.DeviceFileReader(
            files["k3"], prefetch=k, on_data_error="skip_unit",
            store=_factory(M, {"fail_first": 99}, [], retries=2), **kw)
        try:
            with pytest.raises(Exception) as ei:
                for _ in r.iter_row_groups():
                    pass
            e = ei.value
            out.append((type(e).__name__, str(e),
                        [a["error"] for a in e.attempts], e.offset, e.size))
            # never contained: the quarantine saw nothing
            assert r.quarantine.log.snapshot() == []
            if mod is DR:
                assert r.alloc.device_snapshot()[0] == 0
                assert r._live_budget is None
                assert not _tpq_threads()
        finally:
            r.close()
    assert errs[0] == errs[1]
    assert errs[0][0] == "RetryExhaustedError"
    # a clean re-read afterwards is bit-equal
    assert _read(DR.DeviceFileReader(files["k3"], device="cpu",
                                     prefetch=k)) == _local(files, "k3", k)


def _cancel_mid_scan(files, k, make_token, fire=None, latency=0.3):
    """A device read of the K3 file through a slow store (every fetch
    outlasts the cancel or the deadline, at any depth), ended by its token
    mid-scan: (the error, seconds to it, the reader's ledger)."""
    stores = []
    tok = make_token()
    if fire is not None:
        threading.Timer(fire, tok.cancel).start()
    r = DR.DeviceFileReader(files["k3"], device="cpu", prefetch=k,
                            max_memory=1 << 24, on_data_error="skip_unit",
                            store=_factory(S, {"latency_s": latency},
                                           stores),
                            cancel=tok)
    t0 = time.perf_counter()
    try:
        with pytest.raises(Exception) as ei:
            for _ in r.iter_row_groups():
                pass
        took = time.perf_counter() - t0
        assert r.quarantine.log.snapshot() == []
        left = (r.alloc.device_snapshot()[0], r._live_budget,
                r._device_staged_pending, r._device_outstanding)
    finally:
        r.close()
    for st in stores:
        assert "inflight_offset" not in st.stats.sample()
    return ei.value, took, left


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [0, 4])
def test_cancel_mid_scan_leaves_nothing(files, io_env, k, mode):
    io_env.setenv("TPQ_IO_ASYNC", MODES[mode])
    err, took, left = _cancel_mid_scan(files, k, R.CancelToken, fire=0.15)
    assert type(err) is CancelledError
    assert str(err) == "request cancelled by caller"
    assert took < 5.0
    assert left == (0, None, 0, 0)
    assert not _tpq_threads()
    assert _read(DR.DeviceFileReader(files["k3"], device="cpu",
                                     prefetch=k)) == _local(files, "k3", k)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [0, 4])
def test_deadline_mid_scan_leaves_nothing(files, io_env, k, mode):
    io_env.setenv("TPQ_IO_ASYNC", MODES[mode])
    T = 0.2
    err, took, left = _cancel_mid_scan(
        files, k, lambda: R.CancelToken.with_timeout(T))
    assert type(err) is DeadlineExceededError
    assert err.deadline_s == T
    # within the deadline plus one unit (a row group's reads)
    assert took < T + 1.0
    assert left == (0, None, 0, 0)
    assert not _tpq_threads()


@pytest.mark.parametrize("k", [0, 4])
def test_cancel_before_start_matches_the_reference(files, io_env, k):
    """Through a fault-injecting store both packages end with the typed
    verdict before any byte is read."""
    got = []
    for M, mod, RM in ((S, DR, R), (RS, RDR, RR)):
        stores = []
        tok = RM.CancelToken()
        tok.cancel()
        kw = {"device": "cpu"} if mod is DR else {}
        with mod.DeviceFileReader(files["k3"], prefetch=k,
                                  store=_factory(M, {}, stores),
                                  cancel=tok, **kw) as r:
            with pytest.raises(Exception) as ei:
                for _ in r.iter_row_groups():
                    pass
        got.append((type(ei.value).__name__, str(ei.value),
                    stores[0].stats.reads))
    assert got[0] == got[1] == ("CancelledError",
                                "request cancelled by caller", 0)


def test_sequential_path_checks_cancel_over_a_local_store(files):
    """The port's deliberate difference: at prefetch 0 over a
    ``LocalStore`` the reference's device reader never looks at the token
    (its store has no retry loop), the port checks it at each row
    group."""
    tok = R.CancelToken()
    tok.cancel()
    with DR.DeviceFileReader(files["k3"], device="cpu", cancel=tok) as r:
        with pytest.raises(CancelledError):
            for _ in r.iter_row_groups():
                pass
        assert r.stats().as_dict()["chunks"] == 0
    ref_tok = RR.CancelToken()
    ref_tok.cancel()
    with RDR.DeviceFileReader(files["k3"], cancel=ref_tok) as r:
        n = sum(1 for _ in r.iter_row_groups())
    assert n == 2


# ---------------------------------------------------------------------------
# corrupt data through the store; chaos over scan_files; the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [0, 4])
def test_corrupt_store_bytes_are_quarantined_as_the_reference(files,
                                                              io_env, k):
    from tpu_parquet_torch.reader import FileReader

    with FileReader(files["k3"]) as h:
        md = h.metadata.row_groups[1].columns[0].meta_data
        victim = md.data_page_offset
    got = []
    for M, mod, QM in ((S, DR, Q), (RS, RDR, RQ)):
        kw = {"device": "cpu"} if mod is DR else {}
        stores = []
        q = QM.Quarantine("skip_unit")
        # the victim chunk alone: no coalescing merges it with another
        with mod.DeviceFileReader(
                files["k3"], prefetch=k, quarantine=q,
                store=_factory(M, {"corrupt": "bitflip", "corrupt_seed": 3,
                                   "match": lambda o, s: o == victim},
                               stores, coalesce_gap=0), **kw) as r:
            outs = [{c: _host(v) for c, v in g.items()}
                    for g in r.iter_row_groups()]
        got.append((outs, q.log.snapshot(), q.units_skipped,
                    _io(stores)))
    assert got[0] == got[1]
    outs, records, skipped, _d = got[0]
    assert len(records) == 1 and skipped == 1
    assert records[0]["row_group"] == 1
    assert outs == _local(files, "k3", k)[0][:1]


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("k", [0, 4])
def test_a_skipped_unit_leaves_no_tensor_in_a_cycle(files, io_env, k, mode):
    """A contained data error is recorded and its unit skipped without its
    traceback: no frame of the failed prepare (on the card, its staged
    bytes) waits in a reference cycle for the garbage collector.  The
    reference keeps the traceback; its records are held equal above."""
    io_env.setenv("TPQ_IO_ASYNC", MODES[mode])
    from tpu_parquet_torch.reader import FileReader

    with FileReader(files["k3"]) as h:
        victim = h.metadata.row_groups[1].columns[0].meta_data.data_page_offset
    gc.collect()
    gc.disable()
    try:
        with DR.DeviceFileReader(
                files["k3"], device="cpu", prefetch=k,
                on_data_error="skip_unit",
                store=_factory(S, {"corrupt": "bitflip", "corrupt_seed": 3,
                                   "match": lambda o, s: o == victim},
                               [], coalesce_gap=0)) as r:
            kept = sum(1 for _ in r.iter_row_groups())
            skipped = r.quarantine.units_skipped
        del r
        shutdown_default_engine()
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [type(o).__name__ for o in gc.garbage
                  if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
        gc.collect()
    assert (kept, skipped) == (1, 1)
    assert cyclic == []


@pytest.mark.parametrize("k", [0, 4])
def test_scan_files_under_a_chaos_schedule(files, io_env, k):
    paths = [files["required"], files["k3"], files["lineitem16"]]
    clean = [{c: _host(v) for c, v in g.items()}
             for g in DR.scan_files(paths, device="cpu", prefetch=k)]
    got = []
    for M, mod, RM in ((S, DR, R), (RS, RDR, RR)):
        schedule = RM.ChaosSchedule([
            RM.ChaosPhase(0, 6, "transient", intensity=2),
            RM.ChaosPhase(6, 12, "torn", intensity=1),
            RM.ChaosPhase(20, 30, "transient", intensity=1),
        ], seed=5)
        factory = schedule.store_factory(
            paths, config=M.IOConfig(retries=3, backoff_ms=1.0))
        kw = {"device": "cpu"} if mod is DR else {}
        outs = [{c: _host(v) for c, v in g.items()}
                for g in mod.scan_files(paths, prefetch=k, store=factory,
                                        **kw)]
        got.append(outs)
        d = _io(factory.stores)
        assert d["exhausted"] == 0 and d["transient_errors"] > 0
    assert got[0] == got[1] == clean


class _OverlapStore(S.FaultInjectingStore):
    """A ``FaultInjectingStore`` whose first async fetch waits, on the
    engine's loop and for at most 5 s, until a second fetch has started:
    the engine then has both row groups' spans in flight at once however
    the threads are scheduled (without it a loaded worker could finish the
    first span before the feed submits the second)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.started = 0  # touched on the engine's loop thread only

    async def _fetch_once_async(self, offset, size, timeout):
        self.started += 1
        if self.started == 1:
            deadline = time.monotonic() + 5.0
            while self.started < 2 and time.monotonic() < deadline:
                await asyncio.sleep(0.001)
        return await super()._fetch_once_async(offset, size, timeout)


def test_engine_scan_then_shutdown_leaks_nothing(files, io_env):
    io_env.setenv("TPQ_IO_ASYNC", "1")
    want = _local(files, "lineitem16", 4)
    got = _read(DR.DeviceFileReader(
        files["lineitem16"], device="cpu", prefetch=4,
        store=lambda f: _OverlapStore(
            S.LocalStore(f), S.FaultSpec(latency_s=0.002),
            config=S.IOConfig(backoff_ms=1.0, retry_budget=0))))
    assert got == want
    eng = default_engine_if_running()
    assert eng is not None and eng.stats.inflight_peak >= 2
    shutdown_default_engine()
    gc.collect()
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-fetch")]
    assert _read(DR.DeviceFileReader(
        files["lineitem16"], device="cpu", prefetch=4,
        store=_factory(S, {}, []))) == want
    assert default_engine_if_running() is not eng
