"""The plain reference: what each cell's answers must be, from the
generator's arrays alone.

NumPy only; it imports neither JAX nor anything of the program, and reads
nothing the program made.  It computes the digests :mod:`pqbench.digest`
takes of the program's outputs (same definitions, wrapping ``int64``):

- a scan's row groups, every leaf, strings and levels included.  A table
  (``pqbench/tables/<name>.py``) draws each row group as a dict from the
  leaf's dotted path to its values: a flat REQUIRED leaf's array, or
  ``(pool, indices)`` for a STRING leaf (its values are ``pool[indices]``),
  or a :class:`Leaf` for one that carries def or rep levels;
- a training loader's batches.  The loader's order is a pure function of
  (seed, epoch, position), specified by its sampler: Philox keyed through a
  splitmix64 chain, permutations as an argsort of raw 64-bit draws with the
  index stamped into the low bits.  :class:`LoaderOrder` is a copy of that
  specification.

``control=True`` is the control: the same reference computed with every
DOUBLE column in float32, the nearest precision below the one the schema
states.  It has to come out as not correct.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

STRING_CODE = 3000
# per leaf, after its five value numbers: the def levels' count, sum and
# position-weighted sum, then the rep levels' (zeros for a stream it lacks)
LEVEL_WIDTH = 6
_CODES = {np.dtype(np.int64): 1008, np.dtype(np.int32): 1004,
          np.dtype(np.float64): 2008, np.dtype(np.float32): 2004}


class Leaf(NamedTuple):
    """A leaf that carries levels: its defined values (an array, or
    ``(pool, indices)``), its def levels, one per leaf slot, and its rep
    levels (``None`` where ``max_rep`` is 0)."""

    values: object
    def_levels: np.ndarray
    rep_levels: "np.ndarray | None"
    max_def: int
    max_rep: int


def words(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize == 8:
        return a.view(np.int64)
    return a.view({4: np.int32, 2: np.int16, 1: np.int8}[a.dtype.itemsize]
                  ).astype(np.int64)


def _wsum(a: np.ndarray) -> int:
    return int(np.sum(a, dtype=np.int64))


def fixed_digest(a: np.ndarray) -> list:
    w = words(a)
    pos = np.arange(1, len(w) + 1, dtype=np.int64)
    return [_CODES.get(a.dtype, 9999), len(w), _wsum(w), _wsum(w * pos), 0]


def string_digest(pool, indices: np.ndarray) -> list:
    """The digest of ``pool[indices]`` laid end to end."""
    lens = np.array([len(s) for s in pool], dtype=np.int64)
    s0 = np.array([sum(b + 1 for b in s) for s in pool], dtype=np.int64)
    t = np.array([sum((b + 1) * (j + 1) for j, b in enumerate(s))
                  for s in pool], dtype=np.int64)
    idx = np.asarray(indices, dtype=np.int64)
    lr, s0r, tr = lens[idx], s0[idx], t[idx]
    out_off = np.cumsum(lr) - lr
    pos = np.arange(1, len(idx) + 1, dtype=np.int64)
    return [STRING_CODE, len(idx), _wsum(lr * pos), _wsum(s0r),
            _wsum(out_off * s0r + tr)]


def controlled(a: np.ndarray, control: bool) -> np.ndarray:
    if control and a.dtype == np.float64:
        return a.astype(np.float32).astype(np.float64)
    return a


def value_digest(v, control: bool = False) -> list:
    return (string_digest(*v) if isinstance(v, tuple)
            else fixed_digest(controlled(v, control)))


def level_digest(levels) -> list:
    """A level stream's count, sum and position-weighted sum (zeros for
    none)."""
    if levels is None:
        return [0, 0, 0]
    w = np.asarray(levels, dtype=np.int64)
    pos = np.arange(1, len(w) + 1, dtype=np.int64)
    return [len(w), _wsum(w), _wsum(w * pos)]


def leaf_digest(v, control: bool = False) -> list:
    """A leaf's five value numbers and :data:`LEVEL_WIDTH` level numbers."""
    if not isinstance(v, Leaf):
        return value_digest(v, control) + [0] * LEVEL_WIDTH
    return (value_digest(v.values, control)
            + level_digest(v.def_levels if v.max_def else None)
            + level_digest(v.rep_levels if v.max_rep else None))


def group_digests(groups: list, names, control: bool = False) -> np.ndarray:
    """``[groups, len(names), 5 + LEVEL_WIDTH]``: every leaf of every row
    group."""
    out = np.zeros((len(groups), len(names), 5 + LEVEL_WIDTH),
                   dtype=np.int64)
    for gi, g in enumerate(groups):
        for ci, c in enumerate(names):
            out[gi, ci] = leaf_digest(g[c], control)
    return out


def _value_bytes(v) -> int:
    if isinstance(v, tuple):
        pool, idx = v
        lens = np.array([len(s) for s in pool], dtype=np.int64)
        return (len(idx) + 1) * 8 + int(lens[idx].sum())
    return int(v.nbytes)


def leaf_bytes(v) -> int:
    """The bytes a decode has to write for a leaf: a fixed-width leaf's
    values, a STRING leaf's ``int64`` offsets and heap (the work a decode
    has to write, whatever implements it); a leaf with levels adds one
    byte a slot for each level stream it has, the least any decode
    writes."""
    if not isinstance(v, Leaf):
        return _value_bytes(v)
    streams = (v.max_def > 0) + (v.max_rep > 0)
    return _value_bytes(v.values) + streams * len(v.def_levels)


def decoded_bytes(groups: list) -> list:
    """Per row group and leaf, :func:`leaf_bytes`."""
    return [{c: leaf_bytes(v) for c, v in g.items()} for g in groups]


# ---------------------------------------------------------------------------
# the training loader's order (its sampler's specification)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _philox(seed: int, *stream: int) -> np.random.Generator:
    h = _mix64((int(seed) & _M64) ^ 0x5851F42D4C957F2D)
    for s in stream:
        h = _mix64(h ^ _mix64(int(s) & _M64))
    key = np.array([h, _mix64(h ^ 0xDA942042E4DD58B5)], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def _permutation(g: np.random.Generator, n: int) -> np.ndarray:
    if n <= 1:
        return np.arange(n, dtype=np.int64)
    keys = g.integers(0, 1 << 64, size=n, dtype=np.uint64)
    bits = np.uint64(max(int(n - 1).bit_length(), 1))
    keys = (keys >> bits << bits) | np.arange(n, dtype=np.uint64)
    return np.argsort(keys).astype(np.int64)


@dataclass
class LoaderOrder:
    """Which table rows each batch of each epoch holds: units (row groups)
    in a seeded order per epoch, the row stream cut into ``window``-row
    blocks each permuted by its own seeded permutation, batches cut from
    the permuted stream, the remainder dropped."""

    seed: int
    unit_rows: list
    window: int
    batch: int

    def __post_init__(self):
        self.unit_starts = np.concatenate(
            [[0], np.cumsum(self.unit_rows)]).astype(np.int64)
        self.total = int(self.unit_starts[-1])
        self.batches = self.total // self.batch
        self._stream: dict = {}

    def _stream_rows(self, epoch: int) -> np.ndarray:
        """Table row of each position of the epoch's unpermuted stream."""
        if epoch not in self._stream:
            order = _permutation(_philox(self.seed, 1, epoch, 0),
                                 len(self.unit_rows))
            self._stream = {epoch: np.concatenate(
                [np.arange(self.unit_starts[u], self.unit_starts[u + 1],
                           dtype=np.int64) for u in order])}
        return self._stream[epoch]

    def _block(self, epoch: int, k: int) -> np.ndarray:
        stream = self._stream_rows(epoch)
        rows = stream[k * self.window : (k + 1) * self.window]
        perm = _permutation(_philox(self.seed, 2, epoch, 0, k), len(rows))
        return rows[perm]

    def batch_rows(self, epoch: int, j: int) -> np.ndarray:
        lo, hi = j * self.batch, (j + 1) * self.batch
        blocks = range(lo // self.window, (hi - 1) // self.window + 1)
        permuted = np.concatenate([self._block(epoch, k) for k in blocks])
        base = blocks[0] * self.window
        return permuted[lo - base : hi - base]

    def dropped_rows(self, epoch: int) -> np.ndarray:
        """The rows of the epoch's remainder, which no batch holds."""
        lo = self.batches * self.batch
        if lo == self.total:
            return np.zeros(0, dtype=np.int64)
        blocks = range(lo // self.window, (self.total - 1) // self.window + 1)
        permuted = np.concatenate([self._block(epoch, k) for k in blocks])
        return permuted[lo - blocks[0] * self.window:]


class LoaderAnswers:
    def __init__(self, groups: list, names, order: LoaderOrder,
                 control: bool = False):
        self.names = list(names)
        self.order = order
        self.cols = {c: controlled(np.concatenate([g[c] for g in groups]),
                                   control) for c in names}
        self.words = {c: words(self.cols[c]) for c in names}
        self.totals = np.array([_wsum(self.words[c]) for c in names],
                               dtype=np.int64)

    def batch(self, epoch: int, j: int) -> np.ndarray:
        rows = self.order.batch_rows(epoch, j)
        return np.stack([fixed_digest(self.cols[c][rows])
                         for c in self.names])

    def epoch_sums(self, epoch: int) -> np.ndarray:
        """Per column, the wrapping sum of every delivered value's bits."""
        drop = self.order.dropped_rows(epoch)
        return np.array([wrap(int(t) - _wsum(self.words[c][drop]))
                         for t, c in zip(self.totals, self.names)],
                        dtype=np.int64)


def wrap(x: int) -> int:
    """``x`` as a wrapping ``int64``."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x
