"""Async fetch engine: hundreds of ranges in flight on one thread.

The counterpart of ``tpu_parquet.iostore_async``.  The prefetch pool costs
one OS thread per range in flight and is capped at the machine's cores, so
a scan over a high-latency object store that wants hundreds of overlapped
fetches gets a handful.  This module multiplexes them on one event loop:

- :class:`FetchEngine` — a daemon thread (``tpq-fetch``) running an asyncio
  loop.  ``submit(store, offset, size, scan=...)`` returns a
  ``concurrent.futures.Future`` at once; the loop drives up to
  ``TPQ_IO_INFLIGHT`` (default 256) fetches, each the whole
  ``GenericRangeStore.read_range`` discipline as a coroutine (deadlines,
  retries with jittered backoff under the scan's retry budget, torn-read
  checks with verified re-reads, EOF classification, hedging), with the
  same counters and error texts.
- Stores opt in with one coroutine,
  ``GenericRangeStore._fetch_once_async``; ``LocalStore`` never routes
  here.
- ``CoalescedFetcher``'s engine mode puts a row group's spans in flight
  when the group is planned, and ``pipeline.prefetch_map(feed=)`` keeps
  pulling work while the engine has free slots: ``prefetch=K`` bounds the
  decode window, the engine cap bounds the IO in flight.
- A cancel wakes fetches in flight: each submitted range races its scan's
  :class:`~tpu_parquet_torch.resilience.CancelToken` (``on_cancel`` posts
  to the loop), so its future resolves with the request's typed verdict.

``TPQ_IO_ASYNC=0`` turns routing off (every store takes the threaded
path); ``TPQ_IO_INFLIGHT`` sizes the cap.

Observability: the engine registers :class:`EngineStats` as a flight
source (``iostore.engine[<n>]``: a hang dump names the oldest range in
flight), a request trace riding the scan's cancel token gets one ``fetch``
span per range (recorded after the fact: coroutines interleave on the one
engine thread), and :func:`fold_engine_stats` lands the ``io.engine``
registry subtree and the ``io.queue_wait`` histogram.
"""

from __future__ import annotations

import asyncio
import itertools
import os
import threading
import time
import weakref

from .errors import CancelledError, RetryExhaustedError, TransientIOError
from .obs import LatencyHistogram, env_int, register_flight_source

__all__ = [
    "DEFAULT_INFLIGHT", "EngineStats", "FetchEngine",
    "default_engine_if_running", "engine_enabled", "engine_for_store",
    "fold_engine_stats", "get_default_engine", "shutdown_default_engine",
]

# flight-source labels: iostore.engine[1], iostore.engine[2], ...
_engine_seq = itertools.count(1)

DEFAULT_INFLIGHT = 256


def engine_enabled() -> bool:
    """``TPQ_IO_ASYNC=0`` turns the engine off, and so does
    ``TPQ_IO_INFLIGHT<=0``.  Read per call, so the env may change per
    scan."""
    if os.environ.get("TPQ_IO_ASYNC", "1") == "0":
        return False
    return env_int("TPQ_IO_INFLIGHT", DEFAULT_INFLIGHT, lo=0) > 0


def engine_for_store(store) -> "FetchEngine | None":
    """The shared default engine when ``store`` has the async primitive and
    the engine is enabled; None keeps the caller on the threaded path
    (always for ``LocalStore``)."""
    if store is None or not getattr(store, "supports_async", False):
        return None
    if not engine_enabled():
        return None
    return get_default_engine()


class EngineStats:
    """The engine's counters (thread-safe): submissions and completions,
    the in-flight gauge and its peak against the cap, the queue wait
    (submit to slot) and in-slot fetch seconds, and the table of ranges in
    flight (``sample()`` names the oldest)."""

    def __init__(self, inflight_cap: int):
        self._lock = threading.Lock()
        self.inflight_cap = int(inflight_cap)
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.inflight = 0
        self.inflight_peak = 0
        self.queue_wait_seconds = 0.0
        self.fetch_seconds = 0.0
        self.queue_wait_hist = LatencyHistogram()
        self._ranges: "dict[int, tuple[int, int, float]]" = {}
        self._seq = itertools.count(1)

    def note_submitted(self) -> None:
        with self._lock:
            self.submitted += 1

    def slot_acquired(self, wait_s: float) -> None:
        with self._lock:
            self.queue_wait_seconds += wait_s
            self.inflight += 1
            self.inflight_peak = max(self.inflight_peak, self.inflight)
        self.queue_wait_hist.record(wait_s)

    def note_done(self, ok: bool, had_slot: bool, fetch_s: float) -> None:
        with self._lock:
            if ok:
                self.completed += 1
            else:
                self.failed += 1
            if had_slot:
                self.inflight -= 1
                self.fetch_seconds += fetch_s

    def enter(self, offset: int, size: int) -> int:
        with self._lock:
            tok = next(self._seq)
            self._ranges[tok] = (offset, size, time.monotonic())
        return tok

    def exit(self, tok: int) -> None:
        with self._lock:
            self._ranges.pop(tok, None)

    def pending(self) -> int:
        """Submitted fetches not yet finished (queued and in flight): the
        feed gate's backlog."""
        with self._lock:
            return self.submitted - self.completed - self.failed

    def progress(self) -> dict:
        """Monotonic counters only."""
        with self._lock:
            return {
                "submitted": self.submitted,
                "finished": self.completed + self.failed,
            }

    def sample(self) -> dict:
        out = self.progress()
        with self._lock:
            out["inflight"] = self.inflight
            if self._ranges:
                now = time.monotonic()
                off, size, t0 = max(self._ranges.values(),
                                    key=lambda v: now - v[2])
                out["inflight_offset"] = off
                out["inflight_size"] = size
                out["inflight_age_s"] = round(now - t0, 3)
        return out

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "inflight": self.inflight,
                "inflight_peak": self.inflight_peak,
                "inflight_cap": self.inflight_cap,
                "queue_wait_seconds": round(self.queue_wait_seconds, 6),
                "fetch_seconds": round(self.fetch_seconds, 6),
            }


class FetchEngine:
    """One event-loop thread multiplexing up to ``max_inflight`` range
    fetches.  ``submit`` is non-blocking and thread-safe; its future
    resolves with the bytes, the typed error the threaded ``read_range``
    would raise, or ``concurrent.futures.CancelledError`` when the engine
    closes under it.  ``close()`` stops the loop, cancels what is in
    flight (blocked waiters wake) and joins the thread."""

    def __init__(self, max_inflight: "int | None" = None, *,
                 name: str = "tpq-fetch"):
        if max_inflight is None:
            max_inflight = env_int("TPQ_IO_INFLIGHT", DEFAULT_INFLIGHT, lo=1)
        self.max_inflight = max(int(max_inflight), 1)
        self.stats = EngineStats(self.max_inflight)
        self._name = name
        self._lock = threading.Lock()
        self._loop: "asyncio.AbstractEventLoop | None" = None
        self._thread: "threading.Thread | None" = None
        self._ready = threading.Event()
        self._closed = False
        self._sem: "asyncio.Semaphore | None" = None
        # the "iostore" label prefix matters: the autopsy scans iostore*
        # samples for the oldest range in flight, and on the engine path
        # this table is where it lives
        register_flight_source(f"iostore.engine[{next(_engine_seq)}]",
                               self.stats, "sample")

    # -- lifecycle ------------------------------------------------------------

    @property
    def closed(self) -> bool:
        return self._closed

    def _ensure_started(self) -> asyncio.AbstractEventLoop:
        with self._lock:
            if self._closed:
                raise RuntimeError("FetchEngine is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=self._name, daemon=True)
                self._thread.start()
        self._ready.wait()
        loop = self._loop
        if loop is None:  # pragma: no cover — loop thread died at startup
            raise RuntimeError("FetchEngine loop failed to start")
        return loop

    def _run(self) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        # made on the loop thread: asyncio primitives bind their loop on
        # first await, and every await happens here
        self._sem = asyncio.Semaphore(self.max_inflight)
        self._loop = loop
        self._ready.set()
        try:
            loop.run_forever()
            # close() stopped the loop: cancel what is still in flight so
            # every blocked Future.result() waiter wakes
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
            # done-callbacks of tasks that settled as the loop stopped
            # (hedge reaping, loser accounting) are queued: two beats run
            # them and the callbacks they schedule
            loop.run_until_complete(asyncio.sleep(0))
            loop.run_until_complete(asyncio.sleep(0))
        finally:
            asyncio.set_event_loop(None)
            loop.close()

    def close(self, timeout: float = 30.0) -> None:
        """Stop the loop, reap the fetches in flight, join the thread
        (idempotent)."""
        with self._lock:
            thread = self._thread
            if not self._closed:
                self._closed = True
                loop = self._loop
                if loop is not None:
                    try:
                        loop.call_soon_threadsafe(loop.stop)
                    except RuntimeError:  # pragma: no cover — already dead
                        pass
        if thread is not None:
            thread.join(timeout)

    def want_more(self) -> bool:
        """Feed gate for ``pipeline.prefetch_map``: keep pulling work while
        the engine has free fetch slots."""
        return not self._closed and self.stats.pending() < self.max_inflight

    # -- submission -----------------------------------------------------------

    def submit(self, store, offset: int, size: int, scan=None,
               deadline: "float | None" = None):
        """Queue one range fetch; returns a ``concurrent.futures.Future``.
        ``scan`` / ``deadline`` are what ``read_range`` takes."""
        loop = self._ensure_started()
        self.stats.note_submitted()
        try:
            return asyncio.run_coroutine_threadsafe(
                self._fetch(store, int(offset), int(size), scan, deadline),
                loop)
        except RuntimeError:
            # lost the race with close(): the submission counts as failed
            # so pending() reconciles
            self.stats.note_done(False, False, 0.0)
            raise

    # -- the fetch coroutine --------------------------------------------------

    def _cancel_event(self, cancel) -> "asyncio.Event | None":
        """An ``asyncio.Event`` set when the scan's CancelToken flips: the
        bridge that lets a ``cancel()`` on another thread wake this fetch
        mid-await."""
        if cancel is None:
            return None
        ev = asyncio.Event()
        loop = self._loop
        evref = weakref.ref(ev)

        def _wake(_exc, _loop=loop, _evref=evref):
            e = _evref()
            if e is None:
                return
            try:
                _loop.call_soon_threadsafe(e.set)
            except RuntimeError:  # the loop is closed: nothing to wake
                pass

        cancel.on_cancel(_wake)
        return ev

    async def _race(self, awaitable, ev, cancel):
        """Await ``awaitable`` unless the scan's cancel event fires first:
        then the work in flight is cancelled (reaped) and the request's
        typed verdict raises."""
        if ev is None:
            return await awaitable
        task = asyncio.ensure_future(awaitable)
        waiter = asyncio.ensure_future(ev.wait())
        try:
            await asyncio.wait({task, waiter},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            waiter.cancel()
        if task.done():
            return task.result()
        task.cancel()
        try:
            await task
        except BaseException:  # noqa: BLE001 — the verdict outranks it
            pass
        cancel.check()
        raise CancelledError("scan cancelled")  # pragma: no cover

    async def _fetch(self, store, offset, size, scan, deadline):
        estats = self.stats
        if scan is None:
            scan = getattr(store, "_default_scan", None)
        cancel = scan.cancel if scan is not None else None
        trace = getattr(cancel, "trace", None) if cancel is not None else None
        # the request-trace span is recorded after the fact: an open span
        # here would nest unrelated ranges in flight on this one thread
        attempts: "list[dict] | None" = [] if trace is not None else None
        tr0 = time.perf_counter() if trace is not None else 0.0
        err_name = None
        ev = self._cancel_event(cancel)
        t0 = time.monotonic()
        ok = had_slot = False
        t_slot = t0
        try:
            await self._race(self._sem.acquire(), ev, cancel)
            t_slot = time.monotonic()
            estats.slot_acquired(t_slot - t0)
            had_slot = True
            try:
                buf = await self._read_range_async(
                    store, offset, size, scan, deadline, ev, cancel,
                    attempts_out=attempts)
                ok = True
                return buf
            finally:
                self._sem.release()
        except BaseException as e:
            err_name = type(e).__name__
            raise
        finally:
            estats.note_done(ok, had_slot, time.monotonic() - t_slot)
            if trace is not None:
                args = {"offset": offset, "size": size, "engine": True,
                        "queue_wait_ms": round(
                            max(t_slot - t0, 0.0) * 1e3, 3)}
                if attempts:
                    args["retries"] = len(attempts)
                    args["last_error"] = attempts[-1]["error"]
                if err_name is not None:
                    args["error"] = err_name
                trace.add_timed("fetch", tr0, time.perf_counter(), **args)

    async def _read_range_async(self, store, offset, size, scan, deadline,
                                ev, cancel, attempts_out=None):
        """``GenericRangeStore.read_range``'s retry, deadline and backoff
        loop as a coroutine: every branch, counter and error text mirrors
        the threaded loop (the CPU tests hold the two together)."""
        cfg = store.config
        if cfg.deadline_s > 0:
            cfg_deadline = time.monotonic() + cfg.deadline_s
            deadline = (cfg_deadline if deadline is None
                        else min(deadline, cfg_deadline))
        if scan is not None and scan.deadline is not None:
            deadline = (scan.deadline if deadline is None
                        else min(deadline, scan.deadline))
        attempts: list[dict] = [] if attempts_out is None else attempts_out
        torn_prefix: "bytes | None" = None
        backoff = cfg.backoff_ms / 1e3
        stats = store.stats
        budget = scan.budget if scan is not None else None
        tok = self.stats.enter(offset, size)
        try:
            for attempt in range(cfg.retries + 1):
                if store._abort_exc is not None:
                    raise store._abort_exc
                if cancel is not None:
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
                    buf = await self._attempt(store, offset, size, timeout,
                                              ev, cancel)
                    if len(buf) == size and offset + size > store.size():
                        raise TransientIOError(
                            f"full-length read for range [{offset}, "
                            f"{offset + size}) past EOF at {store.size()}")
                    if len(buf) == size:
                        if torn_prefix is not None and not buf.startswith(
                                torn_prefix):
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
                    if offset + len(buf) >= store.size():
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
                    if store._abort_exc is not None:
                        raise store._abort_exc from e
                    if cancel is not None:
                        cancel.check()
                    stats.add("transient_errors")
                    attempts.append({
                        "attempt": attempt,
                        "error": f"{type(e).__name__}: {e}",
                        "elapsed_ms": round(
                            (time.monotonic() - t0) * 1e3, 3),
                    })
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
                    if budget is not None and not budget.spend():
                        stats.add("exhausted")
                        raise RetryExhaustedError(
                            f"range [{offset}, {offset + size}): per-scan "
                            f"retry budget "
                            f"({budget.max_retries}) exhausted",
                            attempts=attempts, offset=offset, size=size,
                        ) from e
                    if backoff > 0:
                        with store._rng_lock:
                            backoff = min(
                                store._rng.uniform(cfg.backoff_ms / 1e3,
                                                   backoff * 3),
                                cfg.backoff_ms / 1e3 * 64)
                        if deadline is not None:
                            backoff = min(
                                backoff,
                                max(deadline - time.monotonic(), 0.0))
                        attempts[-1]["backoff_ms"] = round(backoff * 1e3, 3)
                        stats.add("retries")
                        stats.add("backoff_seconds", backoff)
                        await self._race(asyncio.sleep(backoff), ev, cancel)
                    else:
                        stats.add("retries")
            raise AssertionError("unreachable: the retry loop always "
                                 "returns or raises")  # pragma: no cover
        finally:
            self.stats.exit(tok)

    async def _attempt(self, store, offset, size, timeout, ev, cancel):
        """One attempt, hedged when the store has a hedge delay (the async
        twin of ``GenericRangeStore._fetch``).  Hedge duplicates are tasks,
        not threads, but spend the same store-side cap and counters as the
        threaded racers."""
        delay = store._hedge_delay_s()
        if delay is None or \
                store._hedges_outstanding >= store.config.hedge_max:
            t0 = time.monotonic()
            buf = await self._race(
                store._fetch_once_async(offset, size, timeout), ev, cancel)
            store.stats.fetch_hist.record(time.monotonic() - t0)
            return buf
        return await self._hedged(store, offset, size, timeout, delay,
                                  ev, cancel)

    async def _hedged(self, store, offset, size, timeout, delay, ev, cancel):
        stats = store.stats
        loop = asyncio.get_running_loop()

        async def one():
            t0 = time.monotonic()
            buf = await store._fetch_once_async(offset, size, timeout)
            stats.fetch_hist.record(time.monotonic() - t0)
            return buf

        racers: "list[tuple[str, asyncio.Task]]" = [
            ("primary", loop.create_task(one()))]
        done, _ = await asyncio.wait({racers[0][1]}, timeout=delay)
        if not done and store._hedge_sem.acquire(blocking=False):
            with store._hedge_lock:
                store._hedges_outstanding += 1
            stats.add("hedges_issued")
            hedge = loop.create_task(one())

            def _hedge_done(_t):
                # the duplicate's cap slot frees when it finishes, win or
                # lose, as the threaded racer's does
                with store._hedge_lock:
                    store._hedges_outstanding -= 1
                store._hedge_sem.release()

            hedge.add_done_callback(_hedge_done)
            racers.append(("hedge", hedge))
        pending = {t for _r, t in racers}
        errors: list = []
        while pending:
            wait_for = set(pending)
            waiter = None
            if ev is not None:
                waiter = asyncio.ensure_future(ev.wait())
                wait_for.add(waiter)
            done, _ = await asyncio.wait(
                wait_for, return_when=asyncio.FIRST_COMPLETED)
            if waiter is not None:
                waiter.cancel()
                if waiter in done and not (done & pending):
                    # cancelled mid-race: reap both racers, then the
                    # request's typed verdict
                    for t in pending:
                        t.cancel()
                    await asyncio.gather(*pending, return_exceptions=True)
                    cancel.check()
                    raise CancelledError("scan cancelled")  # pragma: no cover
            for role, t in racers:
                if t not in pending or not t.done():
                    continue
                pending.discard(t)
                try:
                    buf = t.result()
                except BaseException as e:  # noqa: BLE001 — settled below
                    errors.append(e)
                    continue
                # first success wins; the loser drains in the background,
                # accounted and verified (_FetchRace.settle's contract)
                if role == "hedge":
                    stats.add("hedges_won")
                for _r2, t2 in racers:
                    if t2 in pending:
                        self._reap_loser(t2, buf, stats)
                return buf
        raise errors[0]

    @staticmethod
    def _reap_loser(task, winner_buf, stats) -> None:
        def _done(t):
            if t.cancelled():
                return
            if t.exception() is not None:
                return  # a loser's failure: the winner settled the race
            buf = t.result()
            stats.add("hedges_wasted_bytes", len(buf))
            if buf != winner_buf:
                stats.add("hedge_mismatches")

        task.add_done_callback(_done)


# ---------------------------------------------------------------------------
# the shared default engine
# ---------------------------------------------------------------------------

_default_lock = threading.Lock()
_default_engine: "FetchEngine | None" = None


def get_default_engine() -> FetchEngine:
    """The process-wide engine every routed store shares, started lazily; a
    closed default is replaced."""
    global _default_engine
    with _default_lock:
        if _default_engine is None or _default_engine.closed:
            _default_engine = FetchEngine()
        return _default_engine


def default_engine_if_running() -> "FetchEngine | None":
    """The default engine only if one is live (never starts one)."""
    eng = _default_engine
    if eng is None or eng.closed:
        return None
    return eng


def shutdown_default_engine(timeout: float = 30.0) -> None:
    """Close and drop the default engine; the next routed store starts a
    fresh one."""
    global _default_engine
    with _default_lock:
        eng, _default_engine = _default_engine, None
    if eng is not None:
        eng.close(timeout)


def fold_engine_stats(reg) -> None:
    """Fold the live default engine into a
    :class:`~tpu_parquet_torch.obs.StatsRegistry`: the ``io.engine``
    subtree and the ``io.queue_wait`` histogram.  A no-op when no engine
    ran (local scans carry no engine keys)."""
    eng = default_engine_if_running()
    if eng is None or eng.stats.submitted == 0:
        return
    reg.add_io({"engine": eng.stats.as_dict()})
    reg.histogram("io.queue_wait").merge_from(eng.stats.queue_wait_hist)
