"""Deterministic shuffle planning for the training-input loader.

Every serious accelerator input stack (tf.data, Grain) defines its shuffle as
a *pure function of (seed, epoch, position)* rather than as mutable RNG state
threaded through the pipeline — that is what makes the order reproducible
bit-for-bit across runs, across prefetch depths (prefetch only reorders WORK,
never OUTPUT — pipeline.prefetch_map is an ordered map), and across
save/restore at arbitrary cursors.  This module is that pure function,
factored into two composable stages over metadata only (no row data is ever
materialized to shuffle it):

- **epoch unit permutation** (:func:`epoch_unit_order`): a seeded permutation
  of the shard's (file, row_group) units, fresh per epoch — the global
  component of the shuffle, at the granularity the IO path can actually
  randomize without rereading bytes.
- **window (block) shuffle** (:func:`block_permutation`): the decoded row
  stream is cut into consecutive ``shuffle_window``-row blocks and each block
  is permuted with its own seeded permutation — the local component, bounding
  shuffle memory to one window while decorrelating rows within and across
  unit boundaries.  Keyed by (seed, epoch, shard, block), so any block can be
  reconstructed in isolation: restore decodes only the units the current
  block overlaps.

Randomness comes from numpy's Philox bit generator (a counter-based,
algorithm-pinned stream) keyed through a splitmix64 hash of the id tuple;
permutations are realized as a stable argsort of raw 64-bit draws, so they
depend only on the pinned bit stream — not on ``Generator.permutation``'s
(potentially version-drifting) internals.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "epoch_unit_order",
    "block_permutation",
    "plan_epoch",
    "EpochPlan",
]

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a full-avalanche 64-bit hash step."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _philox(seed: int, *stream: int) -> np.random.Generator:
    """A Philox generator keyed by hash-chaining (seed, *stream) — distinct
    id tuples get statistically independent, reproducible streams."""
    h = _mix64((int(seed) & _M64) ^ 0x5851F42D4C957F2D)
    for s in stream:
        h = _mix64(h ^ _mix64(int(s) & _M64))
    key = np.array([h, _mix64(h ^ 0xDA942042E4DD58B5)], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def _draw_permutation(g: np.random.Generator, n: int) -> np.ndarray:
    """Permutation of range(n) as an argsort of raw 64-bit draws.

    The low ⌈log2 n⌉ bits of each key are overwritten with the element's own
    index, making keys UNIQUE by construction — so the argsort result is
    independent of the sort algorithm (no tie-break to pin down), and the
    default introsort can be used (~4x the stable merge sort on this
    shape, 0.65s → 0.15s of an epoch's consumer time at window=64Ki).
    The index stamp biases only bits that random high bits already dominate.
    """
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    keys = g.integers(0, 1 << 64, size=n, dtype=np.uint64)
    bits = np.uint64(max(int(n - 1).bit_length(), 1))
    keys = (keys >> bits << bits) | np.arange(n, dtype=np.uint64)
    return np.argsort(keys).astype(np.int64)


def epoch_unit_order(seed: int, epoch: int, shard_index: int,
                     n_units: int) -> np.ndarray:
    """The epoch's permutation over a shard's unit list (stream id 1)."""
    return _draw_permutation(_philox(seed, 1, epoch, shard_index), n_units)


def block_permutation(seed: int, epoch: int, shard_index: int,
                      block_index: int, n_rows: int) -> np.ndarray:
    """The in-window row permutation for one shuffle block (stream id 2).

    Self-contained per (seed, epoch, shard, block): a resumed loader
    reconstructs exactly the block its cursor sits in, nothing earlier.
    """
    return _draw_permutation(
        _philox(seed, 2, epoch, shard_index, block_index), n_rows
    )


@dataclass(frozen=True)
class EpochPlan:
    """One shard-epoch's decode order, derived from footers alone.

    ``order`` permutes the shard's local unit ordinals; ``unit_rows`` and the
    cumulative ``starts`` are in PERMUTED order, so a row cursor maps to a
    (unit ordinal, row-within-unit) pair with one searchsorted — the whole
    restore path is this index math plus decoding the units it names.
    """

    epoch: int
    order: np.ndarray       # int64[n]: permuted shard-local unit ordinals
    unit_rows: np.ndarray   # int64[n]: rows per unit, permuted order
    starts: np.ndarray      # int64[n+1]: cumulative rows, permuted order

    @property
    def total_rows(self) -> int:
        return int(self.starts[-1])

    def locate(self, row: int) -> tuple[int, int]:
        """(permuted unit ordinal, row offset within it) holding ``row``.

        Zero-row units never claim a position: searchsorted('right') lands on
        the last unit whose start is ≤ row, then empty units are stepped past
        (their start equals their end, so they can alias the boundary).
        """
        if not 0 <= row < self.total_rows:
            raise IndexError(f"row {row} of {self.total_rows}")
        k = int(np.searchsorted(self.starts, row, side="right")) - 1
        while self.unit_rows[k] == 0:  # boundary-aliased empty unit
            k += 1
        return k, row - int(self.starts[k])


def plan_epoch(seed: int, epoch: int, shard_index: int,
               unit_rows, shuffle: bool) -> EpochPlan:
    """Build the shard-epoch plan over ``unit_rows`` (shard-local order)."""
    rows = np.asarray(unit_rows, dtype=np.int64)
    order = (epoch_unit_order(seed, epoch, shard_index, len(rows))
             if shuffle else np.arange(len(rows), dtype=np.int64))
    permuted = rows[order]
    starts = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(permuted, out=starts[1:])
    return EpochPlan(epoch=int(epoch), order=order, unit_rows=permuted,
                     starts=starts)
