"""Overlapped chunk pipeline: threaded IO + decompress prefetch.

The counterpart of ``tpu_parquet.pipeline``, shared by the host
``FileReader`` and the ``DeviceFileReader``:

- :func:`prefetch_map` — an ordered overlapped map: up to ``prefetch``
  items run on a bounded thread pool ahead of the consumer, results are
  yielded in submission order, and an error surfaces at the failing item's
  position.  Decompression releases the GIL (zlib, zstandard, the native
  snappy codec through ctypes) and chunk IO is blocking reads, so host
  threads overlap.  The item stream is pulled lazily in the consumer
  thread, so work generation keeps its sequential semantics;
- :class:`PipelineStats` — per-stage wall-time counters (io / decompress /
  recompress / stage / dispatch / finalize), stall time and the in-flight
  high-water mark, surfaced by both readers' ``pipeline_stats()``;
- :class:`SharedReader` — thread-safe positioned reads over one byte
  source, through a ``iostore.ByteStore`` (``LocalStore``'s ``os.pread``
  by default).

Memory is bounded by :class:`alloc.InFlightBudget`: the submitter acquires
each item's estimated bytes before handing it to the pool and releases
them when the consumer takes the result.  The budget is only awaited in the
consumer thread while nothing is in flight, else the window head is drained
first, so it cannot deadlock against itself.

``prefetch_map`` takes a ``cancel`` token (checked at unit boundaries)
and a ``feed`` (the async fetch engine's look-ahead gate).

Observability (``obs``): each stage feeds a latency histogram
(``as_dict()["stage_histograms"]``) and a span on the tracer; each
``PipelineStats`` is a flight source (``pipeline[<id>]``); a worker that
raises notes itself in the flight recorder before its future carries the
error back; a request trace riding ``cancel.trace`` gets one ``decode``
span per unit.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from .alloc import InFlightBudget
from .obs import (LatencyHistogram, current_tracer, note_worker_crash,
                  register_flight_source)

T = TypeVar("T")
R = TypeVar("R")

STAGES = ("io", "decompress", "recompress", "stage", "dispatch", "finalize")

# per-PipelineStats token on the pipeline_wall trace counter: one trace often
# carries several stats objects (one per file of a scan), and the summary
# sums each pipeline's own wall
_pstats_ids = itertools.count(1)


class PipelineStats:
    """Per-stage timing of the overlapped decode pipeline.

    - ``io``          chunk byte reads from the source
    - ``decompress``  page decompress + CRC + structure parse + host decode
    - ``recompress``  link recompression (snappy over hot streams, on the
                      worker that collected the chunk when prefetching)
    - ``stage``       host->device staging (buffer fill + copy enqueue)
    - ``dispatch``    enqueue of the decode launches
    - ``finalize``    the deferred range checks' device read

    ``busy_seconds`` is the sum over stages; ``overlap_efficiency =
    busy_seconds / wall_seconds`` reads 1.0 for a serial run and more when
    stages overlap.  ``stall_seconds`` counts submitter time blocked on the
    memory budget.  Thread-safe: workers and the consumer add at once.

    Each ``add`` / ``timed`` also feeds a per-stage
    :class:`~tpu_parquet_torch.obs.LatencyHistogram`, and ``timed`` emits a
    span on ``tracer`` (the ``TPQ_TRACE`` process tracer by default; a
    disabled tracer costs one ``if``)."""

    def __init__(self, prefetch: int = 0, budget_bytes: int = 0,
                 tracer=None):
        self.prefetch = int(prefetch)
        self.budget_bytes = int(budget_bytes)
        self.chunks = 0
        self.row_groups = 0
        self.stall_seconds = 0.0
        self.wall_seconds = 0.0
        self.peak_in_flight_bytes = 0
        # live prefetch backlog (items submitted, not yet consumed): a
        # point-in-time gauge, not in as_dict() (it ends at 0)
        self.queue_depth = 0
        self._stage_seconds = {s: 0.0 for s in STAGES}
        self._stage_hist = {s: LatencyHistogram() for s in STAGES}
        self.tracer = tracer if tracer is not None else current_tracer()
        self._obs_id = next(_pstats_ids)
        self._lock = threading.Lock()
        self._t0: Optional[float] = None
        # a flight dump shows every live pipeline's lanes (weakly held)
        register_flight_source(f"pipeline[{self._obs_id}]", self, "sample")

    def add(self, stage: str, seconds: float) -> None:
        if stage not in self._stage_seconds:
            raise ValueError(
                f"unknown pipeline stage {stage!r}; valid stages: "
                f"{', '.join(STAGES)}")
        with self._lock:
            self._stage_seconds[stage] += seconds
        self._stage_hist[stage].record(seconds)

    @contextmanager
    def timed(self, stage: str, **span_args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.add(stage, t1 - t0)
            tr = self.tracer
            if tr is not None and tr.active:
                tr.complete(stage, t0, t1, **span_args)

    def add_stall(self, seconds: float, t0: Optional[float] = None) -> None:
        with self._lock:
            self.stall_seconds += seconds
        tr = self.tracer
        if tr is not None and tr.active and t0 is not None:
            tr.complete("stall", t0, t0 + seconds)

    def count_chunk(self) -> None:
        with self._lock:
            self.chunks += 1

    def count_row_group(self) -> None:
        with self._lock:
            self.row_groups += 1

    def touch_wall(self) -> None:
        """Extend the wall clock to now (the first call starts it)."""
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.wall_seconds = now - self._t0
            wall = self.wall_seconds
        tr = self.tracer
        if tr is not None and tr.active and wall:
            # the pipeline's own wall rides the trace as a counter, so the
            # trace summary reports this object's overlap efficiency
            tr.counter("pipeline_wall", seconds=round(wall, 6),
                       pipe=self._obs_id)

    def set_queue_depth(self, n: int) -> None:
        with self._lock:
            self.queue_depth = int(n)

    def sample(self) -> dict:
        """Counter snapshot for :class:`~tpu_parquet_torch.obs.Sampler`
        and the watchdog: the cumulative per-stage seconds, the stall
        total, chunks and the live queue depth."""
        with self._lock:
            out = {s: round(v, 6) for s, v in self._stage_seconds.items()}
            out["stall"] = round(self.stall_seconds, 6)
            out["chunks"] = self.chunks
            out["queue_depth"] = self.queue_depth
        return out

    def note_peak(self, budget: InFlightBudget) -> None:
        with self._lock:
            self.peak_in_flight_bytes = max(self.peak_in_flight_bytes,
                                            budget.peak)

    def merge_from(self, other: "PipelineStats") -> None:
        """Fold another pipeline's counters into this one: stage and stall
        seconds and item counts add, peaks take the max, the wall clock
        stays this object's own."""
        with other._lock:
            stages = dict(other._stage_seconds)
            chunks, row_groups = other.chunks, other.row_groups
            stall = other.stall_seconds
            peak = other.peak_in_flight_bytes
        with self._lock:
            for s, v in stages.items():
                self._stage_seconds[s] += v
            self.chunks += chunks
            self.row_groups += row_groups
            self.stall_seconds += stall
            self.peak_in_flight_bytes = max(self.peak_in_flight_bytes, peak)
        for s in STAGES:
            self._stage_hist[s].merge_from(other._stage_hist[s])

    def stage_seconds(self, stage: str) -> float:
        with self._lock:
            return self._stage_seconds[stage]

    @property
    def busy_seconds(self) -> float:
        with self._lock:
            return sum(self._stage_seconds.values())

    @property
    def overlap_efficiency(self) -> float:
        return (self.busy_seconds / self.wall_seconds
                if self.wall_seconds else 0.0)

    def as_dict(self) -> dict:
        with self._lock:
            stages = {f"{s}_seconds": round(v, 6)
                      for s, v in self._stage_seconds.items()}
        busy = self.busy_seconds
        return {
            "prefetch": self.prefetch,
            "budget_bytes": self.budget_bytes,
            "chunks": self.chunks,
            "row_groups": self.row_groups,
            **stages,
            "busy_seconds": round(busy, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "stall_seconds": round(self.stall_seconds, 6),
            "peak_in_flight_bytes": self.peak_in_flight_bytes,
            "overlap_efficiency": round(self.overlap_efficiency, 3),
            # only the stages that saw work
            "stage_histograms": {s: h.as_dict()
                                 for s, h in self._stage_hist.items()
                                 if h.count},
        }


class SharedReader:
    """Thread-safe positioned reads over one byte source, through a
    :class:`~tpu_parquet_torch.iostore.ByteStore`.

    ``LocalStore`` by default (``os.pread`` on real files: fully parallel,
    the shared descriptor's position is never touched; a lock around
    seek+read for sources without one).  A ``GenericRangeStore`` puts the
    retry, backoff and deadline core under the same readers and pipeline:
    no decode layer sees the difference.  ``parallel`` is False on the
    locked path."""

    def __init__(self, f, store=None):
        self._f = f
        if store is None:
            from .iostore import LocalStore

            store = LocalStore(f)
        self.store = store
        # the current scan's iostore.ScanToken (set by the reader at each
        # scan's start): rides every pread, so a store shared between
        # scans charges this scan's retry budget and honours this
        # request's deadline and cancel
        self._scan = None

    def set_scan(self, token) -> None:
        self._scan = token

    @property
    def parallel(self) -> bool:
        return self.store.parallel

    def as_file(self) -> "_PReadFile":
        """A minimal file-like (seek/read pairs) whose every read goes
        through :meth:`pread`."""
        return _PReadFile(self)

    def pread(self, offset: int, size: int) -> bytes:
        if self._scan is not None:
            return self.store.read_range(offset, size, scan=self._scan)
        return self.store.read_range(offset, size)


class _PReadFile:
    """File-like adapter over :class:`SharedReader` that tracks its own
    position, so concurrent holders never fight over the shared one."""

    def __init__(self, sr: SharedReader):
        self._sr = sr
        self._pos = 0

    def seek(self, pos: int) -> int:
        self._pos = int(pos)
        return self._pos

    def read(self, size: int) -> bytes:
        b = self._sr.pread(self._pos, size)
        self._pos += len(b)
        return b


def prefetch_map(
    items: Iterable[T],
    fn: Callable[[T], R],
    prefetch: int,
    budget: Optional[InFlightBudget] = None,
    cost: Optional[Callable[[T], int]] = None,
    stats: Optional[PipelineStats] = None,
    cancel=None,
    feed=None,
) -> Iterator[R]:
    """Ordered overlapped map: run ``fn`` over ``items`` on a bounded pool.

    Up to ``prefetch`` items are in flight ahead of the consumer; results
    yield strictly in item order; an item whose ``fn`` raises re-raises at
    its ordered position, after which the remaining work is cancelled and
    the pool joined — no leaked threads, also when the consumer abandons
    the generator early (``close()`` runs the same cleanup).

    ``cost(item)`` bytes are acquired from ``budget`` before submission and
    released when the consumer receives the result.  Backpressure never
    blocks while results are poppable: when the next item's bytes do not
    fit, the window head is drained first; a blocking wait happens only
    with nothing in flight (the oversize item, which the budget admits
    alone).  ``stats`` takes the stall time, the budget's peak and the
    queue depth.

    ``cancel`` (a :class:`~tpu_parquet_torch.resilience.CancelToken`) is
    checked at every unit boundary (before each submission and each yield)
    and handed to the budget's blocking wait: a cancelled or expired
    request stops issuing work and raises its typed verdict at the
    consumer, after the same cleanup (window drained, budget released, pool
    joined).

    ``feed`` (an ``iostore_async.FetchEngine``, or any object with
    ``want_more()`` and ``max_inflight``) decouples IO depth from decode
    depth: pulling an item is what submits its IO (an engine-mode
    ``CoalescedFetcher`` puts its ranges in flight when it is built), so
    while the feed reports free fetch slots, items are pulled ahead of the
    ``prefetch``-deep window into a ready queue.  Those pulls charge
    ``budget`` without blocking and stop at its first refusal.

    Workers are named ``tpq-prefetch`` and capped at the machine's cores:
    queued-but-not-running items keep the lookahead without convoying on
    the GIL.  ``prefetch <= 0`` is a plain sequential map with no threads.
    """
    trace = getattr(cancel, "trace", None) if cancel is not None else None
    if prefetch <= 0:
        for item in items:
            if cancel is not None:
                cancel.check()
            if trace is None:
                yield fn(item)
            else:
                with trace.span("decode"):
                    res = fn(item)
                yield res
        return

    def run(item):
        # a dying worker notes itself in the flight recorder (and dumps
        # under TPQ_FLIGHT) before its future carries the error back
        try:
            if trace is None:
                return fn(item)
            # one request-trace span per unit, on the worker thread
            with trace.span("decode"):
                return fn(item)
        except BaseException as e:
            note_worker_crash(e)
            raise

    it = iter(items)
    pending: deque = deque()  # (future, charged cost)
    ready: deque = deque()  # (item, cost): charged, IO submitted, no slot
    carried: Optional[tuple] = None  # (item, cost) awaiting budget headroom
    exhausted = False
    workers = max(1, min(prefetch, os.cpu_count() or 1))
    ex = ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="tpq-prefetch")

    def pull(block_ok: bool) -> bool:
        """Move ONE item from the generator through its budget charge to
        the ready queue; False when the generator is dry or the budget
        said not now.  A blocking wait only with nothing in flight."""
        nonlocal carried, exhausted
        if carried is None:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                return False
            carried = (item, int(cost(item)) if cost is not None else 0)
        item, c = carried
        if budget is not None and c:
            if not budget.try_acquire(c):
                if not block_ok or pending:
                    return False  # drain the head; its release frees room
                t0 = time.perf_counter()
                budget.acquire(c, cancel=cancel)
                if stats is not None:
                    stats.add_stall(time.perf_counter() - t0, t0)
            if stats is not None:
                stats.note_peak(budget)
        carried = None
        ready.append((item, c))
        return True

    try:
        while True:
            if cancel is not None:
                # the unit-boundary gate; the finally below still drains
                # the window and releases every charged byte
                cancel.check()
            while len(pending) < prefetch:
                if not ready and (exhausted or not pull(block_ok=True)):
                    break
                item, c = ready.popleft()
                pending.append((ex.submit(run, item), c))
                if stats is not None:
                    stats.set_queue_depth(len(pending))
            if feed is not None:
                # the engine-backed lookahead: pulling submits IO, so keep
                # pulling while the engine has free slots; never block
                while (not exhausted and len(ready) < feed.max_inflight
                       and feed.want_more() and pull(block_ok=False)):
                    pass
            if not pending:
                if exhausted and carried is None and not ready:
                    break
                continue  # a carried item with an empty window: block
            fut, c = pending.popleft()
            if stats is not None:
                stats.set_queue_depth(len(pending))
            try:
                res = fut.result()
            finally:
                if budget is not None and c:
                    budget.release(c)
            yield res
    finally:
        if stats is not None:
            stats.set_queue_depth(0)
        for fut, _c in pending:
            fut.cancel()
        ex.shutdown(wait=True)
        for fut, c in pending:
            if budget is not None and c:
                budget.release(c)
            if not fut.cancelled():
                fut.exception()  # retrieve, so failures are not lost
        for _item, c in ready:
            # pulled ahead, never submitted: refund the charge
            if budget is not None and c:
                budget.release(c)
