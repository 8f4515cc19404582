"""Memory-budget enforcement for adversarial files, and the pipeline's
in-flight budget.

The counterpart of ``tpu_parquet.alloc``, cut to what the port runs:

- :class:`AllocTracker`, the host ledger: decoders register the sizes of
  buffers they are about to materialize (chunk bytes, decompressed pages,
  link-recompression copies), and passing the configured budget raises
  instead of running out of memory on a decompression bomb.  Tracking is
  scoped to one read operation and reset per row group.  Beside it, a
  device ledger (staged buffers on the card), which only counts;
- :class:`InFlightBudget`, the prefetch pipeline's backpressure
  (``pipeline.prefetch_map``), which the hang watchdog can ``abort``;
- the live-instance registries the flight recorder reads
  (:func:`budget_snapshots`, :func:`tracker_snapshots`).
"""

from __future__ import annotations

import threading
import time
import weakref

# live instances for the flight recorder (obs.FlightRecorder): a hang dump
# shows every budget's waiters and every tracker's watermark without the
# dumping thread knowing who made them.  Weak sets: registering never
# extends a lifetime (per-chunk trackers are made by the thousand).
_LIVE_BUDGETS: "weakref.WeakSet[InFlightBudget]" = weakref.WeakSet()
_LIVE_TRACKERS: "weakref.WeakSet[AllocTracker]" = weakref.WeakSet()


def budget_snapshots() -> "list[dict]":
    """Snapshots of every live :class:`InFlightBudget`."""
    return [b.snapshot() for b in list(_LIVE_BUDGETS)]


def tracker_snapshots() -> "list[dict]":
    """``{in_use, peak, max_size, device_in_use, device_peak}`` of every
    live :class:`AllocTracker` with a nonzero watermark (idle per-chunk
    trackers carry no signal)."""
    out = []
    for t in list(_LIVE_TRACKERS):
        in_use, peak = t.snapshot()
        dev_in_use, dev_peak = t.device_snapshot()
        if in_use or peak or dev_in_use or dev_peak:
            out.append({"in_use": in_use, "peak": peak,
                        "max_size": t.max_size,
                        "device_in_use": dev_in_use,
                        "device_peak": dev_peak})
    return out


class MemoryBudgetExceeded(MemoryError):
    def __init__(self, requested: int, total: int, budget: int):
        super().__init__(
            f"memory budget exceeded: allocating {requested} bytes would bring the "
            f"total to {total} of a {budget}-byte budget (suspected corrupt or "
            f"malicious file)"
        )
        self.requested = requested
        self.total = total
        self.budget = budget


class AllocTracker:
    """Running byte counter with a hard cap (0 = unlimited) and its
    high-water mark.

    The device ledger (``register_device`` / ``release_device``) counts the
    staged buffers on the card from staging until a finalize proves the
    kernels that read them have completed.  It never raises against
    ``max_size``: the budget models host memory, and running out of device
    memory is PyTorch's error to report."""

    def __init__(self, max_size: int = 0):
        self.max_size = int(max_size)
        self.total = 0
        self.peak = 0
        self.device_total = 0
        self.device_peak = 0
        self._lock = threading.Lock()
        _LIVE_TRACKERS.add(self)

    def register(self, nbytes: int) -> None:
        with self._lock:
            self.total += int(nbytes)
            if self.total > self.peak:
                self.peak = self.total
            if 0 < self.max_size < self.total:
                raise MemoryBudgetExceeded(int(nbytes), self.total,
                                           self.max_size)

    def register_transient(self, nbytes: int) -> None:
        """Account a short-lived buffer against the cap without holding it:
        a link-recompression copy must fit the budget at its peak, and is
        released as the originals are."""
        self.register(nbytes)
        self.release(nbytes)

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.total -= int(nbytes)

    def reset(self) -> None:
        with self._lock:
            self.total = 0

    def register_device(self, nbytes: int) -> None:
        with self._lock:
            self.device_total += int(nbytes)
            if self.device_total > self.device_peak:
                self.device_peak = self.device_total

    def release_device(self, nbytes: int) -> None:
        with self._lock:
            self.device_total -= int(nbytes)

    def snapshot(self) -> "tuple[int, int]":
        """A consistent ``(in_use, peak)`` pair."""
        with self._lock:
            return self.total, self.peak

    def device_snapshot(self) -> "tuple[int, int]":
        """A consistent ``(device_in_use, device_peak)`` pair."""
        with self._lock:
            return self.device_total, self.device_peak


class InFlightBudget:
    """Bounded in-flight bytes with backpressure instead of an exception.

    The prefetch pipeline holds several chunks' decompressed bytes at once;
    raising would turn a legal file into an error because the pipeline ran
    ahead.  ``acquire`` blocks the submitting thread until enough bytes
    drain.  One item larger than the whole budget is admitted alone
    (charged at the cap, once nothing else is held): the per-chunk
    decompression-bomb guard stays :class:`AllocTracker`'s job.
    ``max_bytes <= 0`` disables all gating.  ``peak`` is the high-water
    mark of bytes held at once."""

    def __init__(self, max_bytes: int = 0):
        self.max_bytes = int(max_bytes)
        self.held = 0
        self.peak = 0
        self._cv = threading.Condition()
        # thread ident -> wait start: who is blocked in acquire() now, and
        # since when (the flight recorder's and the watchdog's signal)
        self._waiting: dict[int, float] = {}
        self._abort: "BaseException | None" = None
        _LIVE_BUDGETS.add(self)

    def _charge(self, nbytes: int) -> int:
        n = int(nbytes)
        if self.max_bytes > 0:
            n = min(n, self.max_bytes)
        return max(n, 0)

    def _fits(self, n: int) -> bool:
        return self.held == 0 or self.held + n <= self.max_bytes

    def try_acquire(self, nbytes: int) -> bool:
        """Non-blocking acquire; False when the bytes must wait their
        turn."""
        if self.max_bytes <= 0:
            return True
        n = self._charge(nbytes)
        with self._cv:
            if not self._fits(n):
                return False
            self.held += n
            self.peak = max(self.peak, self.held)
            return True

    def acquire(self, nbytes: int, cancel=None) -> None:
        """Block until ``nbytes`` fit under the cap, then take them.

        While blocked, the waiter shows in :meth:`snapshot` (count and
        longest wait).  An :meth:`abort` wakes every waiter and raises its
        exception here.  ``cancel`` (a
        :class:`~tpu_parquet_torch.resilience.CancelToken`) slices the
        wait, so a cancelled or expired request raises its typed verdict
        instead of waiting out another item's drain."""
        if self.max_bytes <= 0:
            return
        n = self._charge(nbytes)
        tid = threading.get_ident()
        with self._cv:
            started = None
            try:
                while not self._fits(n):
                    if self._abort is not None:
                        raise self._abort
                    if cancel is not None:
                        cancel.check()
                    if started is None:
                        started = time.monotonic()
                        self._waiting[tid] = started
                    self._cv.wait(0.05 if cancel is not None else None)
            finally:
                if started is not None:
                    self._waiting.pop(tid, None)
            self.held += n
            self.peak = max(self.peak, self.held)

    def abort(self, exc: BaseException) -> None:
        """Poison the budget: every current and future blocking
        :meth:`acquire` raises ``exc``.  The watchdog's raise policy calls
        it, so a submitter wedged on backpressure raises
        :class:`~tpu_parquet_torch.errors.HangError` instead of hanging."""
        with self._cv:
            self._abort = exc
            self._cv.notify_all()

    def release(self, nbytes: int) -> None:
        if self.max_bytes <= 0:
            return
        n = self._charge(nbytes)
        with self._cv:
            self.held -= n
            self._cv.notify_all()

    def snapshot(self) -> dict:
        """Held and peak bytes, the cap, the threads blocked in
        :meth:`acquire` now and the oldest one's wait (a growing wait with
        a frozen ``held`` is a wedge)."""
        with self._cv:
            now = time.monotonic()
            waits = [now - t0 for t0 in self._waiting.values()]
            return {
                "held": self.held,
                "peak": self.peak,
                "max_bytes": self.max_bytes,
                "waiters": len(waits),
                "longest_wait_s": round(max(waits), 6) if waits else 0.0,
            }
