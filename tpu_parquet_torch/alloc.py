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
  (``pipeline.prefetch_map``).

Left out: the live-instance registries of the flight recorder and the
watchdog's ``abort`` (Queue 1 item 5.5).
"""

from __future__ import annotations

import threading


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
        self._waiters = 0

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

        ``cancel`` (a :class:`~tpu_parquet_torch.resilience.CancelToken`)
        slices the wait, so a cancelled or expired request raises its
        typed verdict instead of waiting out another item's drain."""
        if self.max_bytes <= 0:
            return
        n = self._charge(nbytes)
        with self._cv:
            self._waiters += 1
            try:
                while not self._fits(n):
                    if cancel is not None:
                        cancel.check()
                    self._cv.wait(0.05 if cancel is not None else None)
            finally:
                self._waiters -= 1
            self.held += n
            self.peak = max(self.peak, self.held)

    def release(self, nbytes: int) -> None:
        if self.max_bytes <= 0:
            return
        n = self._charge(nbytes)
        with self._cv:
            self.held -= n
            self._cv.notify_all()

    def snapshot(self) -> dict:
        """Held and peak bytes, the cap, and the threads blocked in
        :meth:`acquire` now."""
        with self._cv:
            return {"held": self.held, "peak": self.peak,
                    "max_bytes": self.max_bytes, "waiters": self._waiters}
