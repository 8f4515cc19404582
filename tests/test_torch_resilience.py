"""The port's request-lifecycle primitives (``tpu_parquet_torch.resilience``)
against the JAX package's, case for case with ``tests/test_resilience.py``.

The reference drives most of its cases through the serve tier's
``ScanService``, which is not ported yet; the port drives the same
contracts through the readers that the service would call:

- **Deadlines** (``CancelToken.with_timeout``) reach every store read and
  unit boundary: an expired request raises ``DeadlineExceededError``
  quickly, stops reading, and leaves no range in flight;
- **Cancellation** (``CancelToken.cancel()``): the same contract with
  ``CancelledError``, before the start and in flight, at prefetch 0 and 4;
- **Per-scan retry budgets**: two scans sharing one store spend their own;
- **Hedged reads**: first success wins, the loser is accounted and
  verified, no racer thread outlives the store;
- **Circuit breakers**: ``CircuitBreaker`` / ``BreakerBoard`` in the same
  states as the reference's under the same calls (an injected clock);
- **Chaos**: a ``ChaosSchedule``'s blob round-trips, loads in the other
  package, and its ``store_factory`` drives a stall storm and a blackout.

Each case runs the port beside the reference and compares the error
classes and texts and the counters.  Left out of the reference's cases:
the serve tier (queueing, brownout, tenants, the service's own budget and
stats) and the ``doctor`` / ``autopsy`` / registry surfaces.
"""

import random
import threading
import time

import numpy as np
import pytest

from tests.test_torch_iostore import _error, io_env  # noqa: F401 — fixture
from tpu_parquet import errors as RE
from tpu_parquet import iostore as RS
from tpu_parquet import resilience as RR
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import errors as E
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch import resilience as R
from tpu_parquet_torch.alloc import InFlightBudget
from tpu_parquet_torch.column import ByteArrayData, ColumnData
from tpu_parquet_torch.errors import (CancelledError, CircuitOpenError,
                                      DeadlineExceededError, ParquetError,
                                      RetryExhaustedError)
from tpu_parquet_torch.format import (CompressionCodec,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                       GenericRangeStore, IOConfig,
                                       LocalStore)
from tpu_parquet_torch.pipeline import prefetch_map
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.resilience import (BreakerBoard, CancelToken,
                                          ChaosPhase, ChaosSchedule)
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield

PAIRS = ((S, R, FileReader), (RS, RR, RefReader))


def _strings(vals):
    return ColumnData(values=ByteArrayData(
        offsets=np.cumsum([0] + [len(v) for v in vals]),
        heap=np.frombuffer(b"".join(vals), np.uint8).copy(),
    ))


def _write_file(path, seed=0, groups=3, rows=500):
    """``tests/test_resilience.py``'s file: an INT64 and a string column,
    SNAPPY, three row groups."""
    rng = np.random.default_rng(seed)
    schema = build_schema([
        data_column("a", Type.INT64, FRT.REQUIRED),
        data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED),
    ])
    pool = [b"alpha", b"beta", b"gamma", b"delta", b""]
    with open(path, "wb") as fh:
        with FileWriter(fh, schema, codec=CompressionCodec.SNAPPY) as w:
            for _g in range(groups):
                svals = [pool[i] for i in rng.integers(0, len(pool), rows)]
                w.write_columns({
                    "a": rng.integers(-(1 << 40), 1 << 40, rows),
                    "s": _strings(svals),
                })
                w.flush_row_group()
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_resilience")
    return [_write_file(str(d / f"f{i}.parquet"), seed=i) for i in range(3)]


def _factory(M, spec, stores, **cfg):
    cfg.setdefault("backoff_ms", 0)

    def make(f):
        st = M.FaultInjectingStore(M.LocalStore(f), M.FaultSpec(**spec),
                                   config=M.IOConfig(**cfg))
        stores.append(st)
        return st

    return make


def _no_orphans(stores):
    """No store still names a range in flight (settled within 5 s)."""
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all("inflight_offset" not in st.stats.sample() for st in stores):
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# deadline propagation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
def test_deadline_expired_typed_fast_and_budget_released(files, prefetch):
    # 6 chunks x 120 ms of injected latency = a 720 ms sequential floor
    # (and one latency past the deadline when the reads overlap); a 100 ms
    # deadline fails long before it, typed, with the transport idle
    # afterwards (no read after the verdict)
    errs = []
    for M, RM, Reader in PAIRS:
        stores = []
        t0 = time.perf_counter()

        def run():
            with Reader(files[0], prefetch=prefetch, max_memory=1 << 24,
                        store=_factory(M, {"latency_s": 0.12}, stores),
                        cancel=RM.CancelToken.with_timeout(0.1)) as r:
                r.read_all()
        errs.append(_error(run))
        elapsed = time.perf_counter() - t0
        assert elapsed < 2.0, f"expiry took {elapsed:.2f}s: not a fast fail"
        reads_after = [s.stats.progress() for s in stores]
        time.sleep(0.25)
        assert [s.stats.progress() for s in stores] == reads_after, \
            "reads continued after the deadline verdict"
        assert _no_orphans(stores)
    assert errs[0][:2] == errs[1][:2]
    assert errs[0][:2] == ("DeadlineExceededError",
                           "request deadline of 0.1s exceeded")


@pytest.mark.parametrize("prefetch", [0, 4])
def test_deadline_expired_in_queue_never_reads(files, prefetch):
    # a request whose deadline passed before its scan began reads nothing
    for M, RM, Reader in PAIRS:
        stores = []
        tok = RM.CancelToken.with_timeout(0.0)
        with Reader(files[1], prefetch=prefetch,
                    store=_factory(M, {"latency_s": 0.08}, stores),
                    cancel=tok) as r:
            with pytest.raises(Exception) as ei:
                r.read_all()
        assert type(ei.value).__name__ == "DeadlineExceededError"
        assert stores[0].stats.progress()["reads"] == 0


def test_deadline_reaches_store_reads(files):
    # the deadline binds inside read_range too: a stalled fetch longer
    # than the whole deadline ends at about the deadline, not stall_s
    for M, RM, _Reader in PAIRS:
        with open(files[0], "rb") as f:
            store = M.FaultInjectingStore(
                M.LocalStore(f), M.FaultSpec(stall_first=1, stall_s=5.0),
                config=M.IOConfig(backoff_ms=0, retries=0))
            tok = store.begin_scan(cancel=RM.CancelToken.with_timeout(0.15))
            t0 = time.perf_counter()
            with pytest.raises(Exception) as ei:
                store.read_range(4, 1000, scan=tok)
            assert type(ei.value).__name__ == "DeadlineExceededError"
            assert time.perf_counter() - t0 < 2.0
            store.close()


# ---------------------------------------------------------------------------
# cancellation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
def test_cancel_mid_flight_typed_and_no_orphans(files, prefetch):
    for M, RM, Reader in PAIRS:
        stores = []
        tok = RM.CancelToken()
        out = {}

        def run():
            try:
                with Reader(files[0], prefetch=prefetch, max_memory=1 << 24,
                            store=_factory(M, {"stall_first": 1,
                                               "stall_s": 10.0}, stores,
                                           retries=2),
                            cancel=tok) as r:
                    r.read_all()
            except BaseException as e:  # noqa: BLE001
                out["exc"] = e

        t = threading.Thread(target=run)
        t.start()
        time.sleep(0.1)  # let it reach the injected stall
        tok.cancel()
        for st in stores:
            st.release()  # unblock the stall so the attempt sees the cancel
        t.join(30)
        assert not t.is_alive()
        assert type(out["exc"]).__name__ == "CancelledError"
        assert str(out["exc"]) == "request cancelled by caller"
        assert _no_orphans(stores)
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("tpq-prefetch", "tpq-hedge"))]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_cancel_before_start_is_typed(files, prefetch):
    for M, RM, Reader in PAIRS:
        stores = []
        tok = RM.CancelToken()
        tok.cancel()
        with Reader(files[1], prefetch=prefetch,
                    store=_factory(M, {"latency_s": 0.1}, stores),
                    cancel=tok) as r:
            with pytest.raises(Exception) as ei:
                r.read_all()
        assert type(ei.value).__name__ == "CancelledError"
        assert stores[0].stats.progress()["reads"] == 0


def test_prefetch_map_cancel_releases_budget():
    budget = InFlightBudget(1 << 20)
    token = CancelToken()
    out = []
    gen = prefetch_map(range(100), lambda x: x * 2, prefetch=2,
                       budget=budget, cost=lambda x: 1024, cancel=token)
    out.append(next(gen))
    token.cancel()
    with pytest.raises(CancelledError):
        for v in gen:
            out.append(v)
    assert budget.held == 0, "the cancelled map left budget bytes charged"
    assert out[0] == 0


@pytest.mark.parametrize("verdict", ["cancel", "deadline"])
def test_blocked_budget_wait_raises_the_verdict(verdict):
    """A submitter blocked in ``InFlightBudget.acquire(cancel=)`` wakes
    with its request's typed verdict, not after someone else's drain."""
    budget = InFlightBudget(100)
    assert budget.try_acquire(80)
    tok = (CancelToken() if verdict == "cancel"
           else CancelToken.with_timeout(0.1))
    if verdict == "cancel":
        threading.Timer(0.1, tok.cancel).start()
    t0 = time.perf_counter()
    want = CancelledError if verdict == "cancel" else DeadlineExceededError
    with pytest.raises(want):
        budget.acquire(50, cancel=tok)
    assert time.perf_counter() - t0 < 2.0
    assert budget.held == 80 and budget.snapshot()["waiters"] == 0


# ---------------------------------------------------------------------------
# per-scan retry budgets
# ---------------------------------------------------------------------------

def test_scan_tokens_isolate_retry_budgets(files):
    with open(files[0], "rb") as f:
        st = FaultInjectingStore(LocalStore(f),
                                 config=IOConfig(retry_budget=3))
        t1 = st.begin_scan()
        t2 = st.begin_scan()
        assert t1.budget is not t2.budget
        assert t1.budget.spend() and t1.budget.spend()
        assert t2.budget.spent == 0, "budgets shared across scan tokens"
        st.close()


def test_concurrent_requests_one_store_budget_isolation(files):
    # ONE store shared by two concurrent scans of one file: A reads the
    # big 'a' chunks (every attempt faults; its budget of 2 exhausts), B
    # the small 's' chunks (healthy; its scans never see A's spends)
    big = FaultSpec(fail_first=1 << 30, match=lambda o, s: s > 2000)
    with open(files[0], "rb") as f:
        store = FaultInjectingStore(
            LocalStore(f), big,
            config=IOConfig(retries=20, backoff_ms=0.1, retry_budget=2,
                            coalesce_gap=0))
        results = {"a": None, "b_ok": 0}

        def client_a():
            try:
                with FileReader(files[0], columns=["a"], store=store,
                                prefetch=2) as r:
                    r.read_all()
                results["a"] = "completed"
            except RetryExhaustedError as e:
                results["a"] = str(e)
            except Exception as e:  # noqa: BLE001
                results["a"] = f"WRONG: {e!r}"

        def client_b():
            for _ in range(4):
                with FileReader(files[0], columns=["s"], store=store,
                                prefetch=0) as r:
                    r.read_all()
                results["b_ok"] += 1

        ta = threading.Thread(target=client_a)
        tb = threading.Thread(target=client_b)
        ta.start()
        tb.start()
        ta.join(60)
        tb.join(60)
        store.close()
    assert results["a"] is not None and "retry budget" in results["a"], \
        results["a"]
    assert results["b_ok"] == 4, "healthy concurrent scans were hit"


# ---------------------------------------------------------------------------
# hedged reads
# ---------------------------------------------------------------------------

def _slow_first_store(M, data, config, slow_s=0.4, payload_fn=None):
    """First attempt at any offset is slow, duplicates fast; ``payload_fn``
    lets a duplicate return other bytes."""

    class SlowFirst(M.GenericRangeStore):
        def __init__(self):
            super().__init__(config=config)
            self.slow_s = slow_s
            self.calls = {}
            self._calls_lock = threading.Lock()

        def size(self):
            return len(data)

        def _fetch_once(self, offset, size, timeout):
            with self._calls_lock:
                n = self.calls.get(offset, 0)
                self.calls[offset] = n + 1
            if n == 0:
                time.sleep(self.slow_s)
            buf = data[offset: offset + size]
            if payload_fn is not None:
                buf = payload_fn(buf, n)
            return buf

    return SlowFirst()


def test_hedged_read_first_wins_and_loser_accounted():
    data = bytes(range(256)) * 64
    st = _slow_first_store(S, data, IOConfig(hedge_ms=20, backoff_ms=0))
    t0 = time.perf_counter()
    buf = st.read_range(512, 1024)
    fast = time.perf_counter() - t0
    assert buf == data[512:1536]
    assert fast < st.slow_s, f"the hedge did not cut the stall: {fast:.3f}s"
    d = st.stats.as_dict()
    assert d["hedges_issued"] == 1 and d["hedges_won"] == 1
    st.close()  # joins the slow primary racer
    d = st.stats.as_dict()
    assert d["hedges_wasted_bytes"] == 1024  # the loser paid, accounted
    assert d["hedge_mismatches"] == 0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-hedge")]


def test_hedged_read_mismatch_detected():
    data = b"x" * 4096
    for M in (S, RS):
        # the duplicate (attempt 1) returns other bytes of the same length
        st = _slow_first_store(
            M, data, M.IOConfig(hedge_ms=10, backoff_ms=0), slow_s=0.3,
            payload_fn=lambda buf, n: buf if n == 0 else b"y" * len(buf))
        st.read_range(0, 100)
        st.close()
        assert st.stats.as_dict()["hedge_mismatches"] == 1


def test_hedge_auto_learns_p90_delay():
    data = bytes(range(256)) * 512
    st = _slow_first_store(S, data, IOConfig(hedge_ms=-1.0, backoff_ms=0),
                           slow_s=0.5)
    st.slow_s = 0.0  # warm-up: fast everywhere, fills the histogram
    for i in range(20):
        st.read_range(i * 128, 64)
    # auto hedges the slowest decile by definition, so a warm-up read may
    # race itself; a genuinely slow fetch must lose to its duplicate
    st.slow_s = 0.5
    won_before = st.stats.as_dict()["hedges_won"]
    t0 = time.perf_counter()
    buf = st.read_range(100_000, 256)
    assert buf == data[100_000:100_256]
    assert time.perf_counter() - t0 < 0.5
    assert st.stats.as_dict()["hedges_won"] == won_before + 1
    st.close()


def test_hedging_off_by_default():
    assert IOConfig.from_env().hedge_ms == 0.0 == RS.IOConfig.from_env(
        ).hedge_ms
    st = _slow_first_store(S, b"z" * 1024, IOConfig(backoff_ms=0),
                           slow_s=0.01)
    st.read_range(0, 64)
    assert st.stats.as_dict()["hedges_issued"] == 0
    st.close()


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------

def _blackout_factory(M, victim_path):
    """Per-file store factory: the victim always fails, others clean."""
    import os

    cfg = M.IOConfig(retries=1, backoff_ms=0, retry_budget=8)

    def factory(f):
        name = os.path.abspath(getattr(f, "name", "") or "")
        spec = (M.FaultSpec(fail_first=1 << 30)
                if name == os.path.abspath(victim_path) else M.FaultSpec())
        return M.FaultInjectingStore(M.LocalStore(f), spec, config=cfg)

    return factory


def _guarded_read(board, Reader, path, factory, **kw):
    """What a scan service does per request: admit at the file's breaker,
    read, note the classified outcome."""
    board.admit(path, path)
    try:
        with Reader(path, store=factory, **kw) as r:
            out = r.read_all()
    except Exception as e:  # noqa: BLE001 — either package's IO error
        if type(e).__name__ == "RetryExhaustedError":
            board.note(path, path, ok=False)
        raise
    board.note(path, path, ok=True)
    return out


def test_circuit_trips_within_n_failures_and_names_file(files):
    victim, healthy = files[2], files[0]
    seen = []
    for M, RM, Reader in PAIRS:
        board = RM.BreakerBoard(fails=2, window_s=60, cooldown_s=60)
        fac = _blackout_factory(M, victim)
        outcome = []
        for _ in range(3):  # exactly N=2 classified failures trip it
            try:
                _guarded_read(board, Reader, victim, fac)
                outcome.append("ok")
            except Exception as e:  # noqa: BLE001
                outcome.append(type(e).__name__)
                if outcome[-1] == "CircuitOpenError":
                    assert e.file == str(victim)
                    assert e.retry_after_s is not None
        # a healthy file still reads clean
        out = _guarded_read(board, Reader, healthy, fac, columns=["a"])
        assert out["a"].num_leaf_slots == 1500
        c = board.counters()
        seen.append((outcome, c["open_now"], c["open_files"], c["opened"],
                     c["fast_fails"]))
    assert seen[0] == seen[1]
    assert seen[0] == (["RetryExhaustedError", "RetryExhaustedError",
                        "CircuitOpenError"], 1, [str(victim)], 1, 1)


def test_circuit_half_open_probe_closes():
    states = []
    for RM in (R, RR):
        clk = [0.0]
        board = RM.BreakerBoard(fails=2, window_s=60, cooldown_s=5,
                                clock=lambda: clk[0])
        key, name = ("file", "k", 1, 2), "/data/x.parquet"
        trail = []
        board.note(key, name, ok=False)
        board.note(key, name, ok=False)
        with pytest.raises(Exception) as ei:
            board.admit(key, name)
        trail.append(str(ei.value))
        clk[0] = 6.0  # cooldown passed: ONE half-open probe admits
        board.admit(key, name)
        with pytest.raises(Exception) as ei:
            board.admit(key, name)  # the second caller is held
        trail.append(str(ei.value))
        board.note(key, name, ok=True)  # the probe succeeded
        board.admit(key, name)
        c = board.counters()
        assert c["open_now"] == 0 and c["closed"] == 1
        # and a failing probe re-opens with a fresh cooldown
        board.note(key, name, ok=False)
        board.note(key, name, ok=False)
        clk[0] = 12.0
        board.admit(key, name)           # the probe
        board.note(key, name, ok=False)  # the probe failed
        assert board.counters()["reopened"] == 1
        with pytest.raises(Exception) as ei:
            board.admit(key, name)
        assert type(ei.value).__name__ == "CircuitOpenError"
        trail.append(str(ei.value))
        states.append((trail, board.counters(), board.open_files()))
    assert states[0] == states[1]


def test_abandoned_probe_never_wedges_breaker_open():
    # a probe that dies with an unclassified error never calls note();
    # after a further cooldown of silence the probe slot is forfeit
    clk = [0.0]
    board = BreakerBoard(fails=1, window_s=60, cooldown_s=5,
                         clock=lambda: clk[0])
    key, name = ("file", "k", 1, 2), "/data/x.parquet"
    board.note(key, name, ok=False)  # opens
    clk[0] = 6.0
    board.admit(key, name)  # the probe, which silently vanishes
    clk[0] = 8.0
    with pytest.raises(CircuitOpenError):
        board.admit(key, name)  # the probe is still nominally out
    clk[0] = 12.0  # a full cooldown after the probe went quiet
    board.admit(key, name)  # forfeit: this caller is the new probe
    board.note(key, name, ok=True)
    assert board.counters()["open_now"] == 0


@pytest.mark.parametrize("seed", range(6))
def test_breaker_board_state_matches_the_reference(seed):
    """Random admit / note sequences over three files and a stepping
    clock: after every call both boards agree on the outcome, the
    counters and the open files."""
    rng = random.Random(seed)
    clk = [0.0]
    fails = rng.randint(1, 3)
    boards = [RM.BreakerBoard(fails=fails, window_s=10, cooldown_s=3,
                              clock=lambda: clk[0])
              for RM in (R, RR)]
    for _ in range(200):
        clk[0] += rng.choice([0.0, 0.5, 1.0, 4.0])
        key = rng.randrange(3)
        op = rng.random()
        got = []
        for b in boards:
            if op < 0.4:
                try:
                    b.admit(key, f"f{key}")
                    got.append("admitted")
                except Exception as e:  # noqa: BLE001
                    got.append((type(e).__name__, str(e), e.retry_after_s))
            else:
                b.note(key, f"f{key}", ok=op < 0.6)
                got.append(None)
            got.append((b.counters(), b.open_files(),
                        {k: (v[0].state, v[0].probing, len(v[0].failures))
                         for k, v in b._breakers.items()}))
        assert got[:2] == got[2:]


def test_default_scan_token_never_inherits_request_verdict(files):
    # a shared store's scan-less reads never inherit a request's verdict
    with open(files[0], "rb") as f:
        st = FaultInjectingStore(LocalStore(f),
                                 config=IOConfig(backoff_ms=0))
        expired = CancelToken.with_timeout(0.0)
        tok = st.begin_scan(cancel=expired)
        with pytest.raises(DeadlineExceededError):
            st.read_range(4, 100, scan=tok)  # the request itself: typed
        st.read_range(4, 100)  # a scan-less caller: unaffected
        st.close()


def test_breaker_board_drops_recovered_entries():
    board = BreakerBoard(fails=5, window_s=60, cooldown_s=5)
    key = ("file", "k", 1, 2)
    board.note(key, "f", ok=False)  # one blip: entry made, still closed
    assert len(board._breakers) == 1
    board.note(key, "f", ok=True)   # recovered: the entry goes
    assert len(board._breakers) == 0


# ---------------------------------------------------------------------------
# the cancel token itself
# ---------------------------------------------------------------------------

def test_cancel_token_contract_matches_the_reference():
    out = []
    for RM in (R, RR):
        trail = []
        tok = RM.CancelToken()
        tok.check()  # live: no-op
        assert tok.remaining() is None and not tok.cancelled
        fired = []
        tok.on_cancel(lambda e: fired.append(("a", str(e))))
        tok.on_cancel(lambda e: 1 / 0)  # a raising observer is swallowed
        tok.cancel()
        tok.cancel(RuntimeError("second"))  # the first cause wins
        with pytest.raises(Exception) as ei:
            tok.check()
        trail.append((type(ei.value).__name__, str(ei.value)))
        tok.on_cancel(lambda e: fired.append(("late", str(e))))  # at once
        trail.append(fired)
        dl = RM.CancelToken.with_timeout(0.0)
        assert dl.expired() and dl.remaining() == 0.0
        with pytest.raises(Exception) as e1:
            dl.check()
        with pytest.raises(Exception) as e2:
            dl.check()
        assert e1.value is e2.value  # latched: one request, one cause
        dl.cancel()  # never rewrites the verdict
        with pytest.raises(Exception) as e3:
            dl.check()
        assert e3.value is e1.value
        trail.append((type(e1.value).__name__, str(e1.value),
                      e1.value.deadline_s))
        out.append(trail)
    assert out[0] == out[1]


def test_error_types_match_the_reference():
    fields = {
        "TransientIOError": ((), {}),
        "RetryExhaustedError": (("attempts", "offset", "size"),
                                {"attempts": [{"error": "x"}], "offset": 3,
                                 "size": 9}),
        "DeadlineExceededError": (("deadline_s",), {"deadline_s": 0.5}),
        "CancelledError": ((), {}),
        "CircuitOpenError": (("file", "retry_after_s"),
                             {"file": "f", "retry_after_s": 1.5}),
    }
    for name, (attrs, kw) in fields.items():
        mine, ref = getattr(E, name), getattr(RE, name)
        assert [b.__name__ for b in mine.__mro__[1:]] == \
            [b.__name__ for b in ref.__mro__[1:]]
        assert not issubclass(mine, ParquetError)
        a, b = mine("msg", **kw), ref("msg", **kw)
        assert str(a) == str(b) == "msg"
        for at in attrs:
            assert getattr(a, at) == getattr(b, at)


# ---------------------------------------------------------------------------
# the chaos harness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [42, 7, 0])
def test_chaos_schedule_roundtrip_and_invariants(seed):
    s = ChaosSchedule.generate(seed=seed, n_phases=6, horizon=400, files=3)
    assert ChaosSchedule.from_blob(s.to_blob()) == s
    assert ChaosSchedule.generate(seed=seed, n_phases=6, horizon=400,
                                  files=3) == s
    # the blob is the reference's, byte for byte, and loads either way
    ref = RR.ChaosSchedule.generate(seed=seed, n_phases=6, horizon=400,
                                    files=3)
    assert s.to_blob() == ref.to_blob()
    assert RR.ChaosSchedule.from_blob(s.to_blob()) == ref
    assert ChaosSchedule.from_blob(ref.to_blob()) == s
    prev_end = 0
    for p in s.phases:
        assert p.end > p.start >= prev_end
        prev_end = p.end
    bad = [
        lambda M: M.ChaosSchedule([M.ChaosPhase(0, 10, "stall",
                                                stall_s=60.0)]),
        lambda M: M.ChaosSchedule([M.ChaosPhase(0, 10, "stall"),
                                   M.ChaosPhase(5, 15, "transient")]),
        lambda M: M.ChaosSchedule.from_blob(b"TPQC\x01junk"),
        lambda M: M.ChaosSchedule.from_blob(s.to_blob()[:-1]),
    ]
    for make in bad:
        with pytest.raises(ParquetError) as got:
            make(R)
        with pytest.raises(Exception) as want:
            make(RR)
        assert str(got.value) == str(want.value)


def test_chaos_matrix_blackout_trips_circuit_healthy_files_clean(files):
    # a stall storm over the first reads, then a blackout pinned to
    # files[2] for the rest of the run
    seen = []
    for M, RM, Reader in PAIRS:
        schedule = RM.ChaosSchedule([
            RM.ChaosPhase(0, 8, "stall", intensity=1, stall_s=0.05),
            RM.ChaosPhase(8, 1 << 20, "blackout", file_index=2),
        ], seed=11)
        factory = schedule.store_factory(
            files, config=M.IOConfig(retries=1, backoff_ms=1.0,
                                     retry_budget=32))
        board = RM.BreakerBoard(fails=2, window_s=60, cooldown_s=60)
        expect = {}
        for p in files[:2]:
            with Reader(p, columns=["a"]) as r:
                expect[p] = r.read_all()["a"].values.copy()
        # healthy files ride through the stall storm bit-equal, and their
        # reads advance the shared ordinal clock into the blackout
        for p in files[:2]:
            got = _guarded_read(board, Reader, p, factory, columns=["a"])
            np.testing.assert_array_equal(got["a"].values, expect[p])
        outcome = []
        for _ in range(4):
            try:
                _guarded_read(board, Reader, files[2], factory,
                              columns=["a"])
                outcome.append("ok")
            except Exception as e:  # noqa: BLE001
                outcome.append(type(e).__name__)
        for p in files[:2]:  # still clean mid-blackout
            got = _guarded_read(board, Reader, p, factory, columns=["a"])
            np.testing.assert_array_equal(got["a"].values, expect[p])
        factory.release()
        seen.append((outcome, board.counters()["open_files"],
                     sum(s.stats.short_reads + s.stats.transient_errors
                         for s in factory.stores)))
    assert seen[0] == seen[1]
    assert seen[0][0] == ["RetryExhaustedError", "RetryExhaustedError",
                          "CircuitOpenError", "CircuitOpenError"]
    assert seen[0][1] == [str(files[2])]


def test_no_leaked_threads_after_everything(files):
    time.sleep(0.1)
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith(("tpq-hedge", "tpq-prefetch"))]
    assert not leaked, leaked
