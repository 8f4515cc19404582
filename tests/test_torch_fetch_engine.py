"""The port's async fetch engine (``tpu_parquet_torch.iostore_async``)
against the JAX package's, case for case with
``tests/test_fetch_engine.py``.

The fault matrix through both packages' host ``FileReader`` on the
threaded path (``TPQ_IO_ASYNC=0``) and through the engine, at prefetch 0
and 4: the rows, every ``IOStats`` counter but ``backoff_seconds``, and an
exhausted read's attempt log equal across the two paths and the two
packages.  Then the engine itself: 256 ranges in flight on one thread, the
in-flight cap, ``close()`` settling every future and leaking no thread, a
cancel waking fetches in flight with the typed verdict, the default engine
replaced after shutdown, and a hedge won on the async path.

Left out of the reference's cases: the serve tier's tenant deadlines and
the ``doctor`` verdicts and registry section (neither is ported yet).
"""

import contextlib
import threading
import time

import numpy as np
import pytest

from tests.test_torch_iostore import (RECOVERABLE, _cfg, _error,
                                      _fault_factory, _io, _write_file,
                                      io_env)  # noqa: F401 — the fixture
from tpu_parquet import iostore as RS
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch.errors import CancelledError
from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                       GenericRangeStore, LocalStore,
                                       RetryBudget, ScanToken)
from tpu_parquet_torch.iostore_async import (FetchEngine,
                                             default_engine_if_running,
                                             engine_enabled,
                                             engine_for_store,
                                             get_default_engine,
                                             shutdown_default_engine)
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.resilience import CancelToken
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


@pytest.fixture(scope="module")
def pq_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_fetch_engine")
               / "faulty.parquet")
    _write_file(path)
    with FileReader(path) as r:
        base = r.read_pylist()
    return path, base


def _engine_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("tpq-fetch")]


# ---------------------------------------------------------------------------
# bit-identity: fault matrix x {threaded, async} x prefetch depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("fault", sorted(RECOVERABLE))
def test_fault_matrix_threaded_vs_async_bit_identical(
        pq_file, fault, prefetch, io_env):
    """The same faulted file decodes to the same rows on both IO paths of
    both packages, with the same recovery counters."""
    path, base = pq_file
    trees = {}
    for mode, env in (("threaded", "0"), ("async", "1")):
        io_env.setenv("TPQ_IO_ASYNC", env)
        for M, Reader in ((S, FileReader), (RS, RefReader)):
            stores = []
            with Reader(path, prefetch=prefetch,
                        store=_fault_factory(RECOVERABLE[fault],
                                             stores=stores, M=M)) as r:
                assert r.read_pylist() == base, f"{mode} path diverged"
            trees[mode, M.__name__] = _io(stores)
            if M is S:
                assert ((engine_for_store(stores[0]) is not None)
                        == (mode == "async"))
    assert len({tuple(sorted(d.items())) for d in trees.values()}) == 1
    d = trees["async", S.__name__]
    assert d["exhausted"] == 0
    if "transient" in fault or "error" in fault:
        assert d["retries"] > 0 and d["transient_errors"] > 0
    if fault.startswith("torn"):
        assert d["short_reads"] > 0
    # with a prefetch window the engine carried the ranges; prefetch 0
    # keeps the sequential blocking path
    eng = default_engine_if_running()
    if prefetch > 0:
        st = eng.stats.as_dict()
        assert st["submitted"] > 0
        assert st["completed"] + st["failed"] == st["submitted"]
        assert st["inflight"] == 0
    else:
        assert eng.stats.submitted == 0


@pytest.mark.parametrize("prefetch", [0, 4])
def test_exhaustion_identical_on_async_path(pq_file, prefetch, io_env):
    """Terminal verdicts match too: the same error type, attempt log and
    attempt messages on either path of either package."""
    path, _base = pq_file
    out = []
    for env in ("0", "1"):
        io_env.setenv("TPQ_IO_ASYNC", env)
        for M, Reader in ((S, FileReader), (RS, RefReader)):
            def run():
                with Reader(path, prefetch=prefetch,
                            store=_fault_factory({"fail_first": 99},
                                                 {"retries": 2}, M=M)) as r:
                    r.read_all()
            out.append(_error(run))
    assert all(e == out[0] for e in out)
    assert out[0][0] == "RetryExhaustedError" and len(out[0][2]) == 3


def test_kill_switch_and_inflight_zero_disable_routing(io_env):
    io_env.setenv("TPQ_IO_ASYNC", "0")
    assert not engine_enabled()
    io_env.setenv("TPQ_IO_ASYNC", "1")
    assert engine_enabled()
    io_env.setenv("TPQ_IO_INFLIGHT", "0")
    assert not engine_enabled()
    io_env.delenv("TPQ_IO_INFLIGHT")
    # LocalStore keeps its pread path: never routed
    with open(__file__, "rb") as f:
        assert engine_for_store(LocalStore(f)) is None
        assert engine_for_store(FaultInjectingStore(LocalStore(f))) \
            is get_default_engine()


# ---------------------------------------------------------------------------
# the concurrency claim: hundreds in flight, one thread
# ---------------------------------------------------------------------------

def test_stall_storm_256_ranges_one_thread(tmp_path):
    """256 ranges through a 50 ms-latency store complete in about one
    latency (not 256 x 50 ms), the in-flight peak at the cap, one engine
    thread doing it."""
    blob = np.random.default_rng(7).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(blob)
    with open(path, "rb") as f:
        st = FaultInjectingStore(LocalStore(f), FaultSpec(latency_s=0.05),
                                 config=_cfg())
        eng = FetchEngine(max_inflight=256, name="tpq-fetch-test")
        try:
            ranges = [((i * 3571) % ((1 << 20) - 4096), 4096)
                      for i in range(256)]
            t0 = time.perf_counter()
            futs = [eng.submit(st, o, s) for o, s in ranges]
            got = [bytes(fu.result(timeout=60)) for fu in futs]
            wall = time.perf_counter() - t0
        finally:
            eng.close()
            st.close()
    assert got == [blob[o:o + s] for o, s in ranges]
    # serial would be 12.8 s; 4 s still proves the overlap
    assert wall < 4.0, f"storm took {wall:.2f}s: ranges did not overlap"
    assert eng.stats.inflight_peak == 256
    assert eng.stats.completed == 256 and eng.stats.failed == 0
    assert not _engine_threads()


def test_inflight_capped_below_submission_depth(tmp_path):
    """A cap of 4 with 32 submissions: the gauge never passes 4, every
    range completes, the queue wait is counted."""
    path = tmp_path / "blob.bin"
    path.write_bytes(bytes(range(256)) * 64)
    with open(path, "rb") as f:
        st = FaultInjectingStore(LocalStore(f), FaultSpec(latency_s=0.01),
                                 config=_cfg())
        eng = FetchEngine(max_inflight=4, name="tpq-fetch-test")
        try:
            futs = [eng.submit(st, 64 * i, 64) for i in range(32)]
            for fu in futs:
                fu.result(timeout=60)
        finally:
            eng.close()
            st.close()
    assert eng.stats.inflight_peak <= 4
    assert eng.stats.completed == 32
    assert eng.stats.queue_wait_seconds > 0  # 28 ranges waited for a slot
    assert eng.stats.queue_wait_hist.count == 32


# ---------------------------------------------------------------------------
# lifecycle: close() and cancel wake every waiter, leak nothing
# ---------------------------------------------------------------------------

def test_close_settles_inflight_futures_and_leaks_nothing(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"\xAB" * 4096)
    with open(path, "rb") as f:
        st = FaultInjectingStore(LocalStore(f), FaultSpec(latency_s=30.0),
                                 config=_cfg(retries=0))
        eng = FetchEngine(max_inflight=2, name="tpq-fetch-test")
        futs = [eng.submit(st, 0, 64) for _ in range(4)]
        time.sleep(0.05)  # the first two enter their latency
        t0 = time.perf_counter()
        eng.close(timeout=10)
        assert time.perf_counter() - t0 < 5.0
        for fu in futs:
            with contextlib.suppress(BaseException):
                fu.result(timeout=5)
            assert fu.done(), "close() left a waiter parked"
        st.close()
    assert not _engine_threads()
    s_ = eng.stats
    assert s_.completed + s_.failed == s_.submitted
    assert s_.inflight == 0
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(st, 0, 64)


def test_cancel_wakes_inflight_fetches_promptly(tmp_path):
    """``CancelToken.cancel()`` from another thread lands the typed
    verdict well within the injected latency: the engine's cancel event
    interrupts the await."""
    path = tmp_path / "blob.bin"
    path.write_bytes(b"\xCD" * 4096)
    with open(path, "rb") as f:
        st = FaultInjectingStore(LocalStore(f), FaultSpec(latency_s=30.0),
                                 config=_cfg(retries=0))
        tok = CancelToken()
        scan = ScanToken(budget=RetryBudget(0), cancel=tok)
        eng = FetchEngine(max_inflight=8, name="tpq-fetch-test")
        try:
            futs = [eng.submit(st, 0, 64, scan=scan) for _ in range(6)]
            time.sleep(0.05)
            t0 = time.perf_counter()
            threading.Timer(0.0, tok.cancel).start()
            for fu in futs:
                with pytest.raises(CancelledError):
                    fu.result(timeout=10)
            assert time.perf_counter() - t0 < 5.0
        finally:
            eng.close()
            st.close()
    assert not _engine_threads()
    assert eng.stats.failed == 6 and eng.stats.inflight == 0


def test_default_engine_replaced_after_shutdown(pq_file, io_env):
    """An engine-mode scan starts the default engine; shutting it down
    leaves no ``tpq-fetch`` thread, and a fresh default starts after it
    (``chip_smoke.py`` phase 13 does the same with the scan's CUDA
    tensors alive)."""
    io_env.setenv("TPQ_IO_ASYNC", "1")
    path, base = pq_file
    with FileReader(path, prefetch=4,
                    store=_fault_factory({"latency_s": 0.001})) as r:
        assert r.read_pylist() == base
    eng = default_engine_if_running()
    assert eng is not None and get_default_engine() is eng
    shutdown_default_engine()
    assert default_engine_if_running() is None
    assert not _engine_threads()
    eng2 = get_default_engine()
    assert eng2 is not eng and not eng2.closed
    shutdown_default_engine()
    assert not _engine_threads()


# ---------------------------------------------------------------------------
# hedging on the async path
# ---------------------------------------------------------------------------

def test_hedge_win_preserved_on_async_path():
    """A store whose first attempt per range is slow and whose duplicate
    is fast: with hedging on, the engine's race wins long before the slow
    attempt ends, and the hedge counters say so."""
    import asyncio

    calls = {"n": 0}
    lock = threading.Lock()

    class SlowFirst(GenericRangeStore):
        def size(self):
            return 1 << 20

        async def _fetch_once_async(self, offset, size, timeout):
            with lock:
                calls["n"] += 1
                first = calls["n"] == 1
            if first:
                await asyncio.sleep(0.5)
            return b"\x5A" * size

    st = SlowFirst(config=_cfg(retries=0, hedge_ms=20.0, deadline_s=10.0))
    assert st.supports_async
    eng = FetchEngine(max_inflight=8, name="tpq-fetch-test")
    try:
        t0 = time.perf_counter()
        buf = eng.submit(st, 0, 512).result(timeout=10)
        wall = time.perf_counter() - t0
    finally:
        eng.close()
    assert bytes(buf) == b"\x5A" * 512
    assert wall < 0.4, f"hedge never raced: {wall:.3f}s"
    d = st.stats.as_dict()
    assert d["hedges_issued"] >= 1 and d["hedges_won"] >= 1
    assert st._hedges_outstanding == 0  # the loser reaped
    assert not _engine_threads()


def test_engine_stats_after_a_reader_scan(pq_file, io_env):
    """The engine's ledger after an engine-mode scan reconciles: every
    submission finished, none in flight, the cap reported."""
    path, base = pq_file
    io_env.setenv("TPQ_IO_ASYNC", "1")
    with FileReader(path, prefetch=4,
                    store=_fault_factory({"latency_s": 0.001})) as r:
        assert r.read_pylist() == base
    st = default_engine_if_running().stats.as_dict()
    assert st["submitted"] > 0 and st["inflight_cap"] >= 1
    assert st["completed"] == st["submitted"] and st["inflight"] == 0
    assert st["inflight_peak"] >= 1
    assert default_engine_if_running().stats.sample()["inflight"] == 0
