"""Fault-tolerant range-read IO backend: the byte layer under ``SharedReader``.

The counterpart of ``tpu_parquet.iostore``.  Every chunk byte either reader
decodes (and every byte the card's kernels then read) enters through a
:class:`ByteStore`:

- :class:`LocalStore` — ``os.pread`` on real files (a lock around
  seek+read for sources without a descriptor): the zero-overhead default.
  No retries, no deadlines, no coalescing: a local descriptor does not fail
  transiently.
- :class:`GenericRangeStore` — the robustness core a GCS or S3 adapter
  inherits: per-request deadlines (``TPQ_IO_DEADLINE_S``), bounded retries
  with exponential backoff and decorrelated jitter (``TPQ_IO_RETRIES``,
  ``TPQ_IO_BACKOFF_MS``) under a per-scan retry budget
  (``TPQ_IO_RETRY_BUDGET``), short and torn reads detected and re-read with
  verification, hedged duplicates for slow fetches (``TPQ_IO_HEDGE_MS``),
  and a fallback from coalesced to single-range fetches when coalesced
  reads keep failing.  Subclasses implement one method,
  :meth:`GenericRangeStore._fetch_once` (and, for the async fetch engine,
  :meth:`GenericRangeStore._fetch_once_async`).
- :class:`FaultInjectingStore` — seeded, deterministic injection of
  latency, transient errors, torn reads, stalls and corrupt payloads over
  any inner store, so the CPU tests reach every failure path without a
  network.

On top, :func:`plan_coalesced` merges adjacent column-chunk ranges (gap
threshold ``TPQ_IO_COALESCE_GAP``) and :class:`CoalescedFetcher` serves a
row group's chunks from the merged spans.  The ladder on failure:
coalesced span, then each member alone, then the error
(:class:`~tpu_parquet_torch.errors.RetryExhaustedError` with the attempt
log).  :class:`IOStats` counts requests, retries, torn re-reads and spans.

Observability: :class:`IOStats` folds into ``obs.StatsRegistry`` (the
``io`` section), its ``progress()`` feeds the sampler's ``io_retries``
track and a watchdog lane, every :class:`GenericRangeStore` registers its
stats as a flight source (a stalled fetch's dump names the range in
flight: the autopsy's ``network-stall``), ``abort`` is the watchdog's hook,
and a request trace riding the scan's cancel token gets a ``fetch`` span
per ``read_range`` with its retries and hedges.
"""

from __future__ import annotations

import asyncio
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from .errors import ParquetError, RetryExhaustedError, TransientIOError
from .obs import (LatencyHistogram, env_float, env_int,
                  register_flight_source)

__all__ = [
    "ByteStore", "CoalescedFetcher", "FaultInjectingStore", "FaultSpec",
    "GenericRangeStore", "IOConfig", "IOStats", "LocalStore", "RetryBudget",
    "ScanToken", "plan_coalesced", "require_full", "resolve_store",
]

# ceiling on one coalesced span: bounds the extra bytes a merged fetch can
# hold beyond its members
MAX_COALESCED_SPAN = 64 << 20
# a coalesced span failing this many times in one scan disables coalescing
# for the rest of the scan
COALESCE_DISABLE_AFTER = 2
# successful fetches before the learned (auto) hedge delay trusts the
# latency histogram's p90
HEDGE_MIN_SAMPLES = 16


def require_full(buf: bytes, offset: int, size: int,
                 context: str = "") -> bytes:
    """Raise a clear ``ParquetError`` when a range read came back short: a
    truncated file is named as such, with offset, got and want, before a
    short buffer reaches the decoder as a confusing CRC or structure
    error."""
    if len(buf) != size:
        where = f" reading {context}" if context else ""
        raise ParquetError(
            f"truncated file{where}: wanted {size} bytes at offset "
            f"{offset}, got {len(buf)} — the file is shorter than its "
            f"metadata claims")
    return buf


# ---------------------------------------------------------------------------
# config + stats + retry budget
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class IOConfig:
    """Robustness knobs for :class:`GenericRangeStore` (resolved from the
    environment once per store).

    - ``deadline_s``     per-request wall ceiling across all of a read's
      attempts (0 = none).
    - ``retries``        re-attempts per range after the first try.
    - ``backoff_ms``     base backoff; sleeps use decorrelated jitter
      (``uniform(base, prev * 3)``, capped at 64x base).
    - ``retry_budget``   per-scan cap on total retries (0 = unlimited).
    - ``coalesce_gap``   merge adjacent ranges whose hole is at most this
      many bytes (0 disables coalescing).
    - ``hedge_ms``       a fetch still out after this many milliseconds
      gets a duplicate, first success wins (0 = off, the default; negative
      = auto: the store's own fetch-latency p90).
    - ``hedge_max``      cap on outstanding hedge duplicates per store.
    """

    deadline_s: float = 0.0
    retries: int = 4
    backoff_ms: float = 25.0
    retry_budget: int = 64
    coalesce_gap: int = 1 << 16
    hedge_ms: float = 0.0
    hedge_max: int = 4

    @classmethod
    def from_env(cls) -> "IOConfig":
        raw_hedge = os.environ.get("TPQ_IO_HEDGE_MS", "")
        hedge_ms = (-1.0 if raw_hedge.strip().lower() == "auto"
                    else env_float("TPQ_IO_HEDGE_MS", 0.0))
        return cls(
            deadline_s=env_float("TPQ_IO_DEADLINE_S", 0.0, lo=0.0),
            retries=env_int("TPQ_IO_RETRIES", 4, lo=0),
            backoff_ms=env_float("TPQ_IO_BACKOFF_MS", 25.0, lo=0.0),
            retry_budget=env_int("TPQ_IO_RETRY_BUDGET", 64, lo=0),
            coalesce_gap=env_int("TPQ_IO_COALESCE_GAP", 1 << 16, lo=0),
            hedge_ms=hedge_ms,
            hedge_max=env_int("TPQ_IO_HEDGE_MAX", 4, lo=1),
        )


class RetryBudget:
    """Per-scan cap on total retries (thread-safe; 0 = unlimited)."""

    def __init__(self, max_retries: int = 0):
        self.max_retries = int(max_retries)
        self.spent = 0
        self._lock = threading.Lock()

    def spend(self) -> bool:
        """Take one retry from the budget; False when it is exhausted."""
        with self._lock:
            if 0 < self.max_retries <= self.spent:
                return False
            self.spent += 1
            return True


class ScanToken:
    """One scan's state on a store: its own retry budget, its coalescing
    ladder, the request deadline and cancel token.

    Every scan holds its token and passes it down
    (``read_range(scan=...)``, :class:`CoalescedFetcher`), so two scans
    sharing one store never drain or refresh each other's budget; the
    store keeps a default token only for direct single-scan callers.
    ``deadline`` is an absolute ``time.monotonic()`` point the retry loop
    folds into every attempt's timeout; ``cancel`` is the request's
    :class:`~tpu_parquet_torch.resilience.CancelToken`, checked between
    attempts so a cancelled or expired request raises its typed verdict."""

    __slots__ = ("budget", "deadline", "cancel", "coalesce_failures",
                 "coalesce_disabled", "_lock")

    def __init__(self, budget: "RetryBudget | None" = None,
                 deadline: "float | None" = None, cancel=None,
                 coalesce_disabled: bool = False):
        self.budget = budget if budget is not None else RetryBudget(0)
        self.deadline = deadline
        self.cancel = cancel
        self.coalesce_failures = 0
        self.coalesce_disabled = coalesce_disabled
        self._lock = threading.Lock()

    def note_coalesce_failure(self) -> bool:
        """Count one failed coalesced span; True when this scan should stop
        planning coalesced fetches."""
        with self._lock:
            self.coalesce_failures += 1
            if self.coalesce_failures >= COALESCE_DISABLE_AFTER:
                self.coalesce_disabled = True
            return self.coalesce_disabled


class IOStats:
    """Retry, backoff, hedging and coalescing counters of one store
    (thread-safe).  ``as_dict()`` holds flows only, so several stores'
    counters compose by addition; ``sample()`` adds the range in flight
    now (the oldest one)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reads = 0
        self.bytes_read = 0
        self.retries = 0
        self.backoff_seconds = 0.0
        self.transient_errors = 0
        self.short_reads = 0
        self.deadline_hits = 0
        self.exhausted = 0
        self.coalesced_spans = 0
        self.coalesced_bytes = 0
        self.coalesce_fallbacks = 0
        # hedging: duplicates issued, races the duplicate won, the loser's
        # bytes (paid, unused) and verified-identity violations
        self.hedges_issued = 0
        self.hedges_won = 0
        self.hedges_wasted_bytes = 0
        self.hedge_mismatches = 0
        # successful-fetch latency (the learned hedge delay's p90)
        self.fetch_hist = LatencyHistogram()
        # thread ident -> (offset, size, started) of the fetch in flight
        self._inflight: dict[int, tuple[int, int, float]] = {}

    def add(self, field: str, n=1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def enter(self, offset: int, size: int) -> None:
        with self._lock:
            self._inflight[threading.get_ident()] = (
                offset, size, time.monotonic())

    def exit(self) -> None:
        with self._lock:
            self._inflight.pop(threading.get_ident(), None)

    def progress(self) -> dict:
        """Monotonic counters only: they freeze while a fetch is stalled
        and advance while the store retries."""
        with self._lock:
            return {
                "reads": self.reads,
                "bytes_read": self.bytes_read,
                "retries": self.retries,
                "transient_errors": self.transient_errors,
                "short_reads": self.short_reads,
            }

    def sample(self) -> dict:
        out = self.progress()
        with self._lock:
            if self._inflight:
                now = time.monotonic()
                off, size, t0 = max(self._inflight.values(),
                                    key=lambda v: now - v[2])
                out["inflight_offset"] = off
                out["inflight_size"] = size
                out["inflight_age_s"] = round(now - t0, 3)
        return out

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "reads": self.reads,
                "bytes_read": self.bytes_read,
                "retries": self.retries,
                "backoff_seconds": round(self.backoff_seconds, 6),
                "transient_errors": self.transient_errors,
                "short_reads": self.short_reads,
                "deadline_hits": self.deadline_hits,
                "exhausted": self.exhausted,
                "coalesced_spans": self.coalesced_spans,
                "coalesced_bytes": self.coalesced_bytes,
                "coalesce_fallbacks": self.coalesce_fallbacks,
                "hedges_issued": self.hedges_issued,
                "hedges_won": self.hedges_won,
                "hedges_wasted_bytes": self.hedges_wasted_bytes,
                "hedge_mismatches": self.hedge_mismatches,
            }


# ---------------------------------------------------------------------------
# the store interface + the zero-overhead local default
# ---------------------------------------------------------------------------

class ByteStore:
    """Positioned byte source under
    :class:`~tpu_parquet_torch.pipeline.SharedReader`: ``read_range`` and
    ``size`` plus capability flags.

    ``read_range`` returns up to ``size`` bytes, short only when the object
    really ends early (callers name that with :func:`require_full`).
    ``parallel`` says concurrent reads are safe; ``prefers_coalescing``
    opts into the range-merging planner (local descriptors say no: the page
    cache does it better); ``supports_async`` says the store has the
    non-blocking attempt the fetch engine drives.  ``identity_token`` names
    the remote object (URL and generation) for read-through caches; None =
    not cacheable across re-opened stores."""

    parallel = True
    prefers_coalescing = False
    coalesce_gap = 0
    supports_async = False
    stats: "IOStats | None" = None
    identity_token: "str | None" = None

    def read_range(self, offset: int, size: int,
                   deadline: "float | None" = None,
                   scan: "ScanToken | None" = None) -> bytes:
        raise NotImplementedError

    def size(self) -> int:
        """Total object size (consulted on the read path to tell EOF from a
        torn read: implementations cache it)."""
        raise NotImplementedError

    def begin_scan(self, deadline: "float | None" = None,
                   cancel=None) -> "ScanToken | None":
        """Scan boundary: mint this scan's :class:`ScanToken`, which the
        scan passes back on every ``read_range(scan=...)``.  Plain stores
        return None: a local descriptor has no retry state to scope."""
        return None

    def abort(self, exc: BaseException) -> None:
        """Poison the store: in-flight and future reads raise ``exc``.
        No-op for plain local stores (their reads cannot stall)."""

    def close(self) -> None:
        pass


class LocalStore(ByteStore):
    """``os.pread`` on real files (fully parallel, never touches the shared
    descriptor's position), a lock around seek+read for sources without a
    usable descriptor (``BytesIO``, wrapped streams, pipes).  Does not own
    the file object."""

    def __init__(self, f):
        self._f = f
        self._lock = threading.Lock()
        self._size: "int | None" = None
        self._fd: Optional[int] = None
        try:
            self._fd = f.fileno()
        except Exception:  # noqa: BLE001 — io.UnsupportedOperation et al.
            self._fd = None
        if self._fd is not None:
            # a descriptor pread cannot serve (a pipe), or no os.pread:
            # probe once and stay on the locked path
            try:
                os.pread(self._fd, 0, 0)
            except (OSError, AttributeError):
                self._fd = None

    @property
    def parallel(self) -> bool:
        return self._fd is not None

    def read_range(self, offset: int, size: int,
                   deadline: "float | None" = None,
                   scan: "ScanToken | None" = None) -> bytes:
        if self._fd is not None:
            parts = []
            pos = offset
            remaining = size
            while remaining > 0:
                b = os.pread(self._fd, remaining, pos)
                if not b:
                    break
                parts.append(b)
                pos += len(b)
                remaining -= len(b)
            return b"".join(parts) if len(parts) != 1 else parts[0]
        with self._lock:
            self._f.seek(offset)
            return self._f.read(size)

    def size(self) -> int:
        if self._size is None:
            if self._fd is not None:
                self._size = os.fstat(self._fd).st_size
            else:
                with self._lock:
                    pos = self._f.tell()
                    self._f.seek(0, os.SEEK_END)
                    self._size = self._f.tell()
                    self._f.seek(pos)
        return self._size


# ---------------------------------------------------------------------------
# the robustness core
# ---------------------------------------------------------------------------

class _FetchRace:
    """First-success-wins rendezvous between a primary fetch and its hedge.

    ``settle`` is called by each racer once; the first success wakes the
    waiter, the loser drains in the background with its bytes accounted
    (``hedges_wasted_bytes``) and compared with the winner's
    (``hedge_mismatches``).  If every racer fails, the waiter wakes with
    the first error."""

    __slots__ = ("lock", "event", "launched", "resolved", "winner_role",
                 "winner_buf", "errors")

    def __init__(self):
        self.lock = threading.Lock()
        self.event = threading.Event()
        self.launched = 0
        self.resolved = 0
        self.winner_role: "str | None" = None
        self.winner_buf: "bytes | None" = None
        self.errors: list = []

    def settle(self, role: str, buf: "bytes | None",
               err: "BaseException | None", stats: "IOStats") -> None:
        with self.lock:
            self.resolved += 1
            if err is not None:
                self.errors.append(err)
            elif self.winner_buf is None:
                self.winner_role = role
                self.winner_buf = buf
                self.event.set()
            else:
                # a loser's success: paid, unused, accounted and verified
                stats.add("hedges_wasted_bytes", len(buf))
                if buf != self.winner_buf:
                    stats.add("hedge_mismatches")
            if self.resolved >= self.launched and self.winner_buf is None:
                self.event.set()


# flight-source labels: iostore[1], iostore[2], ...
_store_seq = iter(range(1, 1 << 62))


class GenericRangeStore(ByteStore):
    """Retry, backoff and deadline core for unreliable range transports.

    Subclasses implement :meth:`_fetch_once`: one attempt, which may return
    short or torn bytes or raise
    :class:`~tpu_parquet_torch.errors.TransientIOError` (or ``OSError`` /
    ``TimeoutError``) for a retryable fault.  ``read_range`` wraps it with
    a per-request deadline spanning all attempts, bounded retries with
    decorrelated-jitter backoff spending the scan's :class:`RetryBudget`,
    torn-read detection with a verified re-read (the re-read must start
    with the torn attempt's bytes), and an attempt log on the terminal
    :class:`~tpu_parquet_torch.errors.RetryExhaustedError`.  A genuine EOF
    returns the short buffer as is: truncation is the caller's diagnosis
    (:func:`require_full`)."""

    prefers_coalescing = True

    def __init__(self, config: "IOConfig | None" = None, seed: int = 0,
                 identity_token: "str | None" = None):
        self.config = config if config is not None else IOConfig.from_env()
        self.identity_token = identity_token
        self.coalesce_gap = self.config.coalesce_gap
        self.stats = IOStats()
        self._rng = random.Random(seed)
        self._rng_lock = threading.Lock()
        # the default scan token: scan-less callers ride it; real scans
        # mint their own with begin_scan()
        self._default_scan = ScanToken(
            RetryBudget(self.config.retry_budget),
            coalesce_disabled=self.coalesce_gap <= 0)
        # hedging: the semaphore caps outstanding duplicates, the thread
        # set lets close() reap racers still out
        self._hedge_sem = threading.BoundedSemaphore(
            max(int(self.config.hedge_max), 1))
        self._hedges_outstanding = 0  # mirror of the semaphore's deficit
        self._hedge_threads: "set[threading.Thread]" = set()
        self._hedge_lock = threading.Lock()
        # abort poison (see ByteStore.abort): checked between attempts
        self._abort_exc: "BaseException | None" = None
        self._abort_event = threading.Event()
        # a flight source (weakly held): a hang dump names the range in
        # flight at the moment of the wedge
        register_flight_source(f"iostore[{next(_store_seq)}]", self.stats,
                               "sample")

    # -- the methods subclasses provide ---------------------------------------

    def _fetch_once(self, offset: int, size: int,
                    timeout: "float | None") -> bytes:
        """One fetch attempt.  ``timeout`` is the seconds left under the
        request's deadline (None = unbounded)."""
        raise NotImplementedError

    async def _fetch_once_async(self, offset: int, size: int,
                                timeout: "float | None") -> bytes:
        """The non-blocking twin of :meth:`_fetch_once`, a coroutine on the
        fetch engine's event loop: waits are awaited, not slept, so hundreds
        of attempts overlap on one thread.  A subclass that provides it
        flips :attr:`supports_async`; the retry loop around it lives in
        ``iostore_async.FetchEngine`` and mirrors :meth:`read_range`."""
        raise NotImplementedError(
            f"{type(self).__name__} has no async fetch primitive")

    @property
    def supports_async(self) -> bool:  # type: ignore[override]
        return (type(self)._fetch_once_async
                is not GenericRangeStore._fetch_once_async)

    # -- scan lifecycle -------------------------------------------------------

    def begin_scan(self, deadline: "float | None" = None,
                   cancel=None) -> ScanToken:
        """Mint a fresh :class:`ScanToken` for one scan.  The store's
        default token is refreshed to a sibling sharing the new budget but
        carrying no deadline or cancel: a scan-less read on a shared store
        never inherits another request's verdict.  Clears the abort
        poison."""
        if deadline is None and cancel is not None:
            deadline = getattr(cancel, "deadline", None)
        token = ScanToken(RetryBudget(self.config.retry_budget),
                          deadline=deadline, cancel=cancel,
                          coalesce_disabled=self.coalesce_gap <= 0)
        self._default_scan = ScanToken(
            token.budget, coalesce_disabled=self.coalesce_gap <= 0)
        self._abort_exc = None
        self._abort_event.clear()
        return token

    @property
    def coalesce_disabled(self) -> bool:
        """The default token's view of the coalescing ladder."""
        return self._default_scan.coalesce_disabled

    def abort(self, exc: BaseException) -> None:
        self._abort_exc = exc
        self._abort_event.set()

    def note_coalesce_failure(self, scan: "ScanToken | None" = None) -> None:
        """A coalesced span failed: after ``COALESCE_DISABLE_AFTER`` of
        these in one scan, that scan stops planning coalesced fetches.
        The default token mirrors the note for the store-level view."""
        self.stats.add("coalesce_fallbacks")
        if scan is not None and scan is not self._default_scan:
            scan.note_coalesce_failure()
        self._default_scan.note_coalesce_failure()

    def close(self) -> None:
        """Join every hedge racer still out."""
        with self._hedge_lock:
            racers = list(self._hedge_threads)
        for t in racers:
            t.join(timeout=30)

    # -- tail-latency hedging -------------------------------------------------

    def _hedge_delay_s(self) -> "float | None":
        """The delay after which a slow fetch earns a duplicate: None =
        hedging off, ``hedge_ms`` when fixed, or the store's own
        successful-fetch p90 once enough samples exist (auto)."""
        ms = self.config.hedge_ms
        if ms == 0:
            return None
        if ms > 0:
            return ms / 1e3
        hist = self.stats.fetch_hist
        if hist.count < HEDGE_MIN_SAMPLES:
            return None
        p90 = hist.quantile(0.9)
        return p90 if p90 > 0 else None

    def _spawn_racer(self, race: "_FetchRace", role: str, offset: int,
                     size: int, timeout: "float | None",
                     release_sem: bool = False) -> None:
        with race.lock:
            race.launched += 1

        def run():
            stats = self.stats
            stats.enter(offset, size)
            t0 = time.monotonic()
            try:
                try:
                    buf = self._fetch_once(offset, size, timeout)
                    err = None
                except BaseException as e:  # noqa: BLE001 — settled below
                    buf, err = None, e
            finally:
                stats.exit()
            if err is None:
                stats.fetch_hist.record(time.monotonic() - t0)
            race.settle(role, buf, err, stats)
            if release_sem:
                with self._hedge_lock:
                    self._hedges_outstanding -= 1
                self._hedge_sem.release()
            with self._hedge_lock:
                self._hedge_threads.discard(threading.current_thread())

        t = threading.Thread(target=run, name="tpq-hedge", daemon=True)
        with self._hedge_lock:
            self._hedge_threads.add(t)
        t.start()

    def _hedged_fetch(self, offset: int, size: int,
                      timeout: "float | None", delay: float) -> bytes:
        """One hedged attempt: the primary runs on a racer thread; still
        out after ``delay`` (and the cap has room), a duplicate is issued.
        First success wins; the loser is reaped by :meth:`close`."""
        race = _FetchRace()
        self._spawn_racer(race, "primary", offset, size, timeout)
        if not race.event.wait(delay):
            if self._hedge_sem.acquire(blocking=False):
                with self._hedge_lock:
                    self._hedges_outstanding += 1
                self.stats.add("hedges_issued")
                self._spawn_racer(race, "hedge", offset, size, timeout,
                                  release_sem=True)
        race.event.wait()  # first success, or every racer failed
        with race.lock:
            if race.winner_buf is not None:
                if race.winner_role == "hedge":
                    self.stats.add("hedges_won")
                return race.winner_buf
            raise race.errors[0]

    # -- the retry loop -------------------------------------------------------

    def _fetch(self, offset: int, size: int,
               timeout: "float | None") -> bytes:
        """One attempt: hedged when the store has a hedge delay and the
        hedge cap has room, the plain call otherwise."""
        delay = self._hedge_delay_s()
        if delay is None or \
                self._hedges_outstanding >= self.config.hedge_max:
            t0 = time.monotonic()
            buf = self._fetch_once(offset, size, timeout)
            self.stats.fetch_hist.record(time.monotonic() - t0)
            return buf
        return self._hedged_fetch(offset, size, timeout, delay)

    def read_range(self, offset: int, size: int,
                   deadline: "float | None" = None,
                   scan: "ScanToken | None" = None) -> bytes:
        if scan is None:
            scan = self._default_scan
        cancel = scan.cancel
        trace = getattr(cancel, "trace", None) if cancel is not None else None
        if trace is None:
            # no request trace: the retry loop runs bare
            return self._read_range_retry(offset, size, deadline, scan)
        attempts: list[dict] = []
        h0, w0 = self.stats.hedges_issued, self.stats.hedges_won
        with trace.span("fetch", offset=offset, size=size):
            try:
                buf = self._read_range_retry(offset, size, deadline, scan,
                                             attempts_out=attempts)
            finally:
                # retry and hedge notes on the span the `with` opened
                if attempts:
                    trace.annotate(retries=len(attempts),
                                   last_error=attempts[-1]["error"])
                hi = self.stats.hedges_issued - h0
                if hi > 0:
                    trace.annotate(
                        hedged=hi, hedge_won=self.stats.hedges_won > w0)
        return buf

    def _read_range_retry(self, offset: int, size: int,
                          deadline: "float | None" = None,
                          scan: "ScanToken | None" = None,
                          attempts_out: "list | None" = None) -> bytes:
        cfg = self.config
        if scan is None:
            scan = self._default_scan
        # the binding deadline is the tightest of the caller's point, the
        # scan token's request deadline and the store's per-request ceiling
        if cfg.deadline_s > 0:
            cfg_deadline = time.monotonic() + cfg.deadline_s
            deadline = (cfg_deadline if deadline is None
                        else min(deadline, cfg_deadline))
        if scan.deadline is not None:
            deadline = (scan.deadline if deadline is None
                        else min(deadline, scan.deadline))
        cancel = scan.cancel
        attempts: list[dict] = [] if attempts_out is None else attempts_out
        torn_prefix: "bytes | None" = None
        backoff = cfg.backoff_ms / 1e3
        stats = self.stats
        stats.enter(offset, size)
        try:
            for attempt in range(cfg.retries + 1):
                if self._abort_exc is not None:
                    raise self._abort_exc
                if cancel is not None:
                    # a cancelled or expired request stops issuing
                    # transport attempts here, with its typed verdict
                    cancel.check()
                t0 = time.monotonic()
                try:
                    timeout = None
                    if deadline is not None:
                        timeout = deadline - t0
                        if timeout <= 0:
                            raise TransientIOError(
                                f"deadline exceeded before attempt "
                                f"{attempt} of range [{offset}, "
                                f"{offset + size})")
                    buf = self._fetch(offset, size, timeout)
                    if len(buf) == size and offset + size > self.size():
                        # a full-length answer for a range past EOF is
                        # fabricated bytes: never serve them
                        raise TransientIOError(
                            f"full-length read for range [{offset}, "
                            f"{offset + size}) past EOF at {self.size()}")
                    if len(buf) == size:
                        if torn_prefix is not None and not buf.startswith(
                                torn_prefix):
                            # the verified re-read failed: the transport
                            # returns different bytes for the same range
                            torn_prefix = None
                            raise TransientIOError(
                                f"re-read of range [{offset}, "
                                f"{offset + size}) does not match the torn "
                                f"attempt's prefix")
                        stats.add("reads")
                        stats.add("bytes_read", size)
                        return buf
                    if len(buf) > size:
                        raise TransientIOError(
                            f"overlong read: got {len(buf)} bytes for a "
                            f"{size}-byte range at {offset}")
                    if offset + len(buf) >= self.size():
                        # genuine EOF: short, the caller names it
                        stats.add("reads")
                        stats.add("bytes_read", len(buf))
                        return buf
                    stats.add("short_reads")
                    if len(buf) > (len(torn_prefix or b"")):
                        torn_prefix = bytes(buf)
                    raise TransientIOError(
                        f"short read: got {len(buf)} of {size} bytes at "
                        f"{offset} (torn read, not EOF)")
                except RetryExhaustedError:
                    raise
                except (TransientIOError, TimeoutError, OSError) as e:
                    if self._abort_exc is not None:
                        raise self._abort_exc from e
                    if cancel is not None:
                        # the request's verdict outranks the transport
                        # error its expiry caused
                        cancel.check()
                    stats.add("transient_errors")
                    attempts.append({
                        "attempt": attempt,
                        "error": f"{type(e).__name__}: {e}",
                        "elapsed_ms": round(
                            (time.monotonic() - t0) * 1e3, 3),
                    })
                    # the deadline before the retry cap, so one expiry
                    # counts once whichever branch noticed it
                    if deadline is not None and time.monotonic() >= deadline:
                        stats.add("deadline_hits")
                        stats.add("exhausted")
                        raise RetryExhaustedError(
                            f"range [{offset}, {offset + size}) deadline "
                            f"exceeded after {attempt + 1} attempt(s)",
                            attempts=attempts, offset=offset, size=size,
                        ) from e
                    if attempt >= cfg.retries:
                        stats.add("exhausted")
                        raise RetryExhaustedError(
                            f"range [{offset}, {offset + size}) failed "
                            f"after {attempt + 1} attempt(s): {e}",
                            attempts=attempts, offset=offset, size=size,
                        ) from e
                    if not scan.budget.spend():
                        stats.add("exhausted")
                        raise RetryExhaustedError(
                            f"range [{offset}, {offset + size}): per-scan "
                            f"retry budget "
                            f"({scan.budget.max_retries}) exhausted",
                            attempts=attempts, offset=offset, size=size,
                        ) from e
                    # decorrelated jitter: sleep ~U(base, prev*3), capped
                    if backoff > 0:
                        with self._rng_lock:
                            backoff = min(
                                self._rng.uniform(cfg.backoff_ms / 1e3,
                                                  backoff * 3),
                                cfg.backoff_ms / 1e3 * 64)
                        if deadline is not None:
                            backoff = min(
                                backoff,
                                max(deadline - time.monotonic(), 0.0))
                        attempts[-1]["backoff_ms"] = round(backoff * 1e3, 3)
                        stats.add("retries")
                        stats.add("backoff_seconds", backoff)
                        time.sleep(backoff)
                    else:
                        stats.add("retries")
            raise AssertionError("unreachable: the retry loop always "
                                 "returns or raises")  # pragma: no cover
        finally:
            stats.exit()


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultSpec:
    """What :class:`FaultInjectingStore` injects, per matched range.

    Attempt-indexed (the i-th attempt at a given offset), so ``fail_first=2``
    means the first two attempts fail and the third succeeds, whatever the
    threads' order: the decision keys on ``(offset, attempt)``.

    - ``latency_s``   fixed extra latency per matched fetch;
    - ``fail_first``  the first N attempts raise a TransientIOError;
    - ``torn_first``  the N attempts after the failures return a torn
      (half-length) prefix: errors, then torn reads, then healthy;
    - ``stall_first`` the first N attempts block for ``stall_s`` (or until
      :meth:`FaultInjectingStore.release`);
    - ``corrupt``     ``bitflip`` | ``zero`` | ``truncate`` (see
      :func:`tpu_parquet_torch.quarantine.corrupt_bytes`): matched ranges
      return length-preserving corrupted bytes, the same on every attempt
      (keyed by ``corrupt_seed ^ offset``): corruption is a property of the
      stored object, and retries never heal it;
    - ``match``       ``(offset, size) -> bool`` choosing the faulty ranges
      (None = all).
    """

    latency_s: float = 0.0
    fail_first: int = 0
    torn_first: int = 0
    stall_first: int = 0
    stall_s: float = 30.0
    corrupt: "str | None" = None
    corrupt_seed: int = 0
    match: "Callable[[int, int], bool] | None" = None


class FaultInjectingStore(GenericRangeStore):
    """Seeded, deterministic fault injection over any inner store.

    Every injected transient fault must recover to bit-equal output;
    exhausted retries raise ``RetryExhaustedError`` with the attempt log.
    ``release()`` unblocks injected stalls (tests call it in teardown)."""

    def __init__(self, inner: ByteStore, spec: "FaultSpec | None" = None,
                 config: "IOConfig | None" = None, seed: int = 0,
                 identity_token: "str | None" = None):
        super().__init__(config=config, seed=seed,
                         identity_token=(identity_token
                                         if identity_token is not None
                                         else inner.identity_token))
        self.inner = inner
        self.spec = spec if spec is not None else FaultSpec()
        self._attempts: dict[int, int] = {}  # offset -> attempts so far
        self._attempts_lock = threading.Lock()
        self._unstall = threading.Event()

    def release(self) -> None:
        """Unblock every current and future injected stall."""
        self._unstall.set()

    def close(self) -> None:
        # stalls die with the store: close() never waits out a stall_s
        self.release()
        super().close()

    def size(self) -> int:
        return self.inner.size()

    def _spec_for(self, offset: int, size: int, attempt: int) -> FaultSpec:
        """The spec governing one attempt: static here;
        :class:`~tpu_parquet_torch.resilience.ChaosSchedule`'s stores
        override it to drive phases off a shared read-ordinal clock."""
        return self.spec

    def _attempt_spec(self, offset: int, size: int):
        """``(attempt number, spec)`` of a matched range, or None for a
        range the spec does not match (a clean passthrough)."""
        if (self.spec.match is not None
                and not self.spec.match(offset, size)):
            return None
        with self._attempts_lock:
            n = self._attempts.get(offset, 0)
            self._attempts[offset] = n + 1
        return n, self._spec_for(offset, size, n)

    def _payload(self, offset: int, size: int, n: int,
                 spec: FaultSpec) -> bytes:
        """The inner read, torn or corrupted as ``spec`` says for attempt
        ``n`` (after its latency, stall and failure were injected)."""
        if n < spec.fail_first:
            raise TransientIOError(
                f"injected transient error #{n} at range "
                f"[{offset}, {offset + size})")
        buf = self.inner.read_range(offset, size)
        if n < spec.fail_first + spec.torn_first and len(buf) > 1:
            return buf[: max(len(buf) // 2, 1)]
        if spec.corrupt is not None:
            from .quarantine import corrupt_bytes

            # keyed per range, never per attempt: the same bytes on every
            # retry, because the corruption lives in the object
            buf = corrupt_bytes(bytes(buf), spec.corrupt,
                                spec.corrupt_seed ^ offset)
        return buf

    def _stall_deadline(self, spec: FaultSpec, timeout) -> float:
        return time.monotonic() + (spec.stall_s if timeout is None
                                   else min(spec.stall_s, timeout))

    def _fetch_once(self, offset: int, size: int,
                    timeout: "float | None") -> bytes:
        got = self._attempt_spec(offset, size)
        if got is None:
            return self.inner.read_range(offset, size)
        n, spec = got
        if spec.latency_s > 0:
            wait = spec.latency_s
            if timeout is not None and wait > timeout:
                time.sleep(max(timeout, 0.0))
                raise TransientIOError(
                    f"injected latency {spec.latency_s:g}s exceeded the "
                    f"deadline for range [{offset}, {offset + size})")
            time.sleep(wait)
        if n < spec.stall_first:
            deadline = self._stall_deadline(spec, timeout)
            # sliced wait: wakes promptly on release() and on an abort
            while not self._unstall.is_set() and self._abort_exc is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._unstall.wait(min(left, 0.05))
            raise TransientIOError(
                f"injected stall at range [{offset}, {offset + size}) "
                f"(attempt {n})")
        return self._payload(offset, size, n, spec)

    async def _fetch_once_async(self, offset: int, size: int,
                                timeout: "float | None") -> bytes:
        """The async twin of :meth:`_fetch_once`, decision for decision
        (the same per-offset attempt counter and ``_spec_for`` hook), with
        every injected wait awaited instead of slept: an injected 50 ms
        latency on 256 ranges costs about 50 ms of wall time.  The inner
        read stays a blocking call on the loop (a local descriptor)."""
        got = self._attempt_spec(offset, size)
        if got is None:
            return self.inner.read_range(offset, size)
        n, spec = got
        if spec.latency_s > 0:
            wait = spec.latency_s
            if timeout is not None and wait > timeout:
                await asyncio.sleep(max(timeout, 0.0))
                raise TransientIOError(
                    f"injected latency {spec.latency_s:g}s exceeded the "
                    f"deadline for range [{offset}, {offset + size})")
            await asyncio.sleep(wait)
        if n < spec.stall_first:
            deadline = self._stall_deadline(spec, timeout)
            # the events are set off the loop: poll them (the engine's
            # cancel race bounds a cancelled scan)
            while not self._unstall.is_set() and self._abort_exc is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                await asyncio.sleep(min(left, 0.05))
            raise TransientIOError(
                f"injected stall at range [{offset}, {offset + size}) "
                f"(attempt {n})")
        return self._payload(offset, size, n, spec)


# ---------------------------------------------------------------------------
# range coalescing
# ---------------------------------------------------------------------------

class _Group:
    """One planned coalesced span: ``[offset, offset+size)`` covering
    ``members`` (a multiset of the input ``(offset, size)`` ranges)."""

    __slots__ = ("offset", "size", "members", "buf", "remaining",
                 "degraded", "lock")

    def __init__(self, offset: int, size: int, members: dict):
        self.offset = offset
        self.size = size
        self.members = members          # (offset, size) -> count
        self.remaining = sum(members.values())
        self.buf: "bytes | None" = None
        self.degraded = False
        self.lock = threading.Lock()

    def key(self) -> tuple:
        return (self.offset, self.size, tuple(sorted(self.members.items())))


def plan_coalesced(ranges, gap: int,
                   max_span: int = MAX_COALESCED_SPAN) -> "list[_Group]":
    """Merge ``(offset, size)`` ranges whose holes are at most ``gap``.

    Deterministic (a function of the multiset of inputs), covering (every
    nonzero range lands in exactly one group, with multiplicity) and
    bounded: groups are sorted and disjoint (a range overlapping the
    current group always joins it), no group bridges a hole wider than
    ``gap``, and a group merged across holes never exceeds ``max_span`` (a
    lone range larger than that is its own group).  Zero and negative
    sizes are dropped."""
    items = sorted((int(o), int(s)) for o, s in ranges if int(s) > 0)
    groups: list[_Group] = []
    cur: "dict | None" = None
    cur_off = cur_end = 0
    for off, size in items:
        end = off + size
        if cur is not None and (off < cur_end or (
                off - cur_end <= gap
                and max(end, cur_end) - cur_off <= max_span)):
            cur[(off, size)] = cur.get((off, size), 0) + 1
            cur_end = max(cur_end, end)
            continue
        if cur is not None:
            groups.append(_Group(cur_off, cur_end - cur_off, cur))
        cur = {(off, size): 1}
        cur_off, cur_end = off, end
    if cur is not None:
        groups.append(_Group(cur_off, cur_end - cur_off, cur))
    return groups


class CoalescedFetcher:
    """Serve the member ranges of one coalescing plan from merged fetches.

    Built per row group on the consumer thread; the first worker to touch
    a group pays its one big ``read_range`` on its own pool thread, every
    other member slices the held buffer, and the buffer drops when its last
    member is taken.  A span whose fetch exhausts its retries (or comes
    back the wrong length) degrades the group: its members fall back to
    single-range reads, and repeated span failures disable coalescing for
    the rest of the scan (``GenericRangeStore.note_coalesce_failure``).

    **Engine mode** (``engine=`` an ``iostore_async.FetchEngine``):
    construction submits every planned fetch, merged spans and lone ranges
    alike, so a row group's IO is in flight as soon as the pipeline pulls
    its first item; ``read`` waits on the matching future.  With
    ``coalesce=False`` (the ladder said stop merging) it submits single
    ranges only."""

    def __init__(self, store: ByteStore, ranges,
                 gap: "int | None" = None,
                 max_span: int = MAX_COALESCED_SPAN,
                 scan: "ScanToken | None" = None,
                 engine=None, coalesce: bool = True):
        self.store = store
        self.scan = scan  # the owning scan's token: budget + ladder scope
        self._engine = engine
        g = (store.coalesce_gap if gap is None else gap) if coalesce else 0
        self._by_member: dict[tuple, _Group] = {}
        # engine mode: one future per merged span (keyed by group
        # identity) and a queue per lone (offset, size)
        self._span_futs: dict[int, object] = {}
        self._single_futs: dict[tuple, list] = {}
        for grp in plan_coalesced(ranges, g, max_span):
            if len(grp.members) <= 1:
                # a lone range: nothing to merge, but the engine wants it
                # in flight now
                if engine is not None:
                    for (o, s), cnt in grp.members.items():
                        futs = self._single_futs.setdefault((o, s), [])
                        for _ in range(cnt):
                            futs.append(engine.submit(store, o, s,
                                                      scan=scan))
                continue
            for m in grp.members:
                self._by_member[m] = grp
            if engine is not None:
                self._span_futs[id(grp)] = engine.submit(
                    store, grp.offset, grp.size, scan=scan)
        self.groups = len({id(g) for g in self._by_member.values()})

    def _fetch_single(self, offset: int, size: int) -> bytes:
        """One single-range read: a pre-submitted engine future for this
        range, a fresh engine submission, or the blocking read."""
        if self._engine is not None:
            futs = self._single_futs.get((offset, size))
            if futs:
                return futs.pop(0).result()
            return self._engine.submit(self.store, offset, size,
                                       scan=self.scan).result()
        return self.store.read_range(offset, size, scan=self.scan)

    def read(self, offset: int, size: int) -> bytes:
        grp = self._by_member.get((offset, size))
        if grp is None:
            return self._fetch_single(offset, size)
        with grp.lock:
            if grp.buf is None and not grp.degraded:
                try:
                    fut = self._span_futs.pop(id(grp), None)
                    if fut is not None:
                        buf = fut.result()
                    elif self._engine is not None:
                        buf = self._engine.submit(
                            self.store, grp.offset, grp.size,
                            scan=self.scan).result()
                    else:
                        buf = self.store.read_range(grp.offset, grp.size,
                                                    scan=self.scan)
                    if len(buf) != grp.size:
                        # a short span (EOF mid-group, or a store lying):
                        # per-member reads diagnose precisely
                        raise TransientIOError(
                            f"coalesced span [{grp.offset}, "
                            f"{grp.offset + grp.size}) returned "
                            f"{len(buf)} bytes")
                    grp.buf = buf
                    st = self.store.stats
                    if st is not None:
                        st.add("coalesced_spans")
                        st.add("coalesced_bytes", grp.size)
                except (RetryExhaustedError, TransientIOError, OSError):
                    grp.degraded = True
                    note = getattr(self.store, "note_coalesce_failure",
                                   None)
                    if note is not None:
                        note(self.scan)
            if grp.buf is not None:
                lo = offset - grp.offset
                out = grp.buf[lo: lo + size]
                grp.remaining -= 1
                if grp.remaining <= 0:
                    grp.buf = None  # the last member taken: drop the span
                return out
        # degraded: a single-range fetch outside the group lock (members
        # recover in parallel); its failure is the ladder's last rung
        return self._fetch_single(offset, size)


# ---------------------------------------------------------------------------
# store selection
# ---------------------------------------------------------------------------

def resolve_store(f, store: "ByteStore | Callable | None") -> ByteStore:
    """Resolve a reader's ``store=`` option against its open file.

    ``None`` gives a :class:`LocalStore` over ``f``; a :class:`ByteStore`
    is used as is (single-file use; the caller owns it); a callable gives
    ``store(f)``, the factory form multi-file scans need (each file its own
    store, e.g. ``lambda f: FaultInjectingStore(LocalStore(f), spec)``)."""
    if store is None:
        return LocalStore(f)
    if isinstance(store, ByteStore):
        return store
    if callable(store):
        st = store(f)
        if not isinstance(st, ByteStore):
            raise TypeError(
                f"store factory returned {type(st).__name__}, "
                f"not a ByteStore")
        return st
    raise TypeError(f"store must be None, a ByteStore, or a factory "
                    f"callable; got {type(store).__name__}")
