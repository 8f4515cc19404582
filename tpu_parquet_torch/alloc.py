"""Memory-budget enforcement for adversarial files (the host ledger).

The counterpart of ``tpu_parquet.alloc``, cut to the host ledger of
:class:`AllocTracker`: decoders register the sizes of buffers they are about
to materialize (chunk bytes, decompressed pages), and passing the configured
budget raises instead of running out of memory on a decompression bomb.
Tracking is scoped to one read operation and reset per row group.
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
    high-water mark."""

    def __init__(self, max_size: int = 0):
        self.max_size = int(max_size)
        self.total = 0
        self.peak = 0
        self._lock = threading.Lock()

    def register(self, nbytes: int) -> None:
        with self._lock:
            self.total += int(nbytes)
            if self.total > self.peak:
                self.peak = self.total
            if 0 < self.max_size < self.total:
                raise MemoryBudgetExceeded(int(nbytes), self.total,
                                           self.max_size)

    def reset(self) -> None:
        with self._lock:
            self.total = 0
