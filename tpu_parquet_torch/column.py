"""Columnar data containers.

The reference is row-oriented and boxes every value (`[]interface{}`, data_store.go);
this framework keeps decoded data columnar: fixed-width columns are flat numpy/jax
arrays, variable-length BYTE_ARRAY columns are an (offsets, heap) pair — the
ragged-on-TPU representation SURVEY.md §7.4.2 calls for.  Nulls and nesting are
carried as definition/repetition level arrays next to the dense values.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class ByteArrayData:
    """Ragged bytes: value i is heap[offsets[i]:offsets[i+1]].

    ``offsets`` has length n+1, dtype int64; ``heap`` is a flat uint8 buffer.
    """

    offsets: np.ndarray
    heap: np.ndarray

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> bytes:
        return self.heap[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def to_list(self) -> list:
        off = self.offsets
        heap = self.heap.tobytes()
        return [heap[off[i] : off[i + 1]] for i in range(len(self))]

    @classmethod
    def from_list(cls, items: list) -> "ByteArrayData":
        lens = np.fromiter((len(x) for x in items), dtype=np.int64, count=len(items))
        offsets = np.zeros(len(items) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        heap = np.frombuffer(b"".join(bytes(x) for x in items), dtype=np.uint8)
        return cls(offsets=offsets, heap=heap)

    def take(self, indices: np.ndarray) -> "ByteArrayData":
        """Gather rows by index (dictionary expansion)."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        lens = self.offsets[1:] - self.offsets[:-1]
        sel_lens = lens[idx]
        new_off = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(sel_lens, out=new_off[1:])
        total = int(new_off[-1])
        starts = self.offsets[idx]
        if total == 0:
            return ByteArrayData(new_off, np.zeros(0, dtype=np.uint8))
        # native memcpy-per-row gather: the single hottest host-decode
        # transform on dictionary-string files, and — unlike the numpy
        # repeat+arange formulation below — it releases the GIL, so the
        # prefetch pipeline's worker threads overlap through it
        from . import native

        if int(idx.min()) >= 0:  # negative (python-wrap) indices: numpy path
            off = np.ascontiguousarray(self.offsets, dtype=np.int64)
            heap = np.ascontiguousarray(self.heap)
            out_heap = np.empty(total, dtype=np.uint8)
            if native.ragged_take(off, heap, idx, new_off, out_heap):
                return ByteArrayData(new_off, out_heap)
        # numpy fallback: position j in output belongs to row
        # r = searchsorted(new_off, j, 'right')-1, via repeat + arange
        reps = sel_lens
        row_of = np.repeat(np.arange(len(idx), dtype=np.int64), reps)
        within = np.arange(total, dtype=np.int64) - np.repeat(new_off[:-1], reps)
        src = starts[row_of] + within
        return ByteArrayData(new_off, self.heap[src])

    def __eq__(self, other):
        if not isinstance(other, ByteArrayData):
            return NotImplemented
        return np.array_equal(self.offsets, other.offsets) and np.array_equal(
            self.heap, other.heap
        )


@dataclass
class ColumnData:
    """One column chunk's decoded leaf data (dense values + levels).

    ``values`` holds only the *defined* leaf values (len = number of slots whose
    def level == max_def); ``def_levels``/``rep_levels`` have one entry per leaf
    slot (len = num_values from the page headers).  For flat required columns the
    level arrays are None and values are one-per-row.
    """

    values: "np.ndarray | ByteArrayData"
    def_levels: Optional[np.ndarray] = None
    rep_levels: Optional[np.ndarray] = None
    max_def: int = 0
    max_rep: int = 0
    num_leaf_slots: int = 0  # total slots including nulls/empties

    def __post_init__(self):
        if self.num_leaf_slots == 0:
            self.num_leaf_slots = (
                len(self.def_levels) if self.def_levels is not None else len(self.values)
            )

    @property
    def num_defined(self) -> int:
        return len(self.values)

    def validity(self) -> np.ndarray:
        """Boolean mask over leaf slots: slot holds a real value."""
        if self.def_levels is None:
            return np.ones(self.num_leaf_slots, dtype=bool)
        return self.def_levels == self.max_def
