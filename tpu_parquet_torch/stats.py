"""Column statistics (min/max/null_count/distinct_count).

Equivalent of the reference's stats.go:9-224: per-physical-type min/max trackers
serialized as little-endian bytes (or raw bytes for BYTE_ARRAY).  Batch-oriented:
stats are computed over whole value arrays with numpy reductions, not per value.
Booleans get no min/max (nilStats parity); byte arrays use unsigned lexicographic
order (the reference's byte-wise compare).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from .column import ByteArrayData
from .format import Statistics, Type


def _le_bytes(v, fmt: str) -> bytes:
    return struct.pack(fmt, v)


def _int_minmax(arr: "np.ndarray", width: int) -> tuple:
    """(min, max) in ONE pass via the native vectorized scan when available
    (numpy needs two reduces; the writer computes stats per chunk AND per
    page)."""
    from . import native

    a = np.ascontiguousarray(arr)
    if (a.dtype.itemsize == width and a.dtype.kind == "i"
            and a.dtype.isnative):  # the C scan reads little-endian
        mm = native.int_minmax(a, 0, len(a), width)
        if mm is not None:
            return mm
    return int(arr.min()), int(arr.max())


def _lex_minmax(ba) -> tuple[bytes, bytes]:
    """Lexicographic (min, max) over a ragged byte column, vectorized.

    Candidate filtering one byte position at a time: every survivor shares
    the same prefix, so a candidate exhausted at position k IS the min (and
    loses the max unless all are exhausted, i.e. identical).  Candidate sets
    shrink geometrically on real data (2-4 rounds typical); the worst case —
    all values identical — is one vector pass per byte of the value, still
    O(total bytes).  Replaces a to_list() + Python min/max that materialized
    every value as a bytes object (the writer's hottest path after uniquing
    on string columns; byte-wise unsigned order matches stats.go).
    """
    off = np.asarray(ba.offsets)
    heap = np.asarray(ba.heap)
    lens = np.diff(off)

    def pick(want_max: bool) -> int:
        cands = np.arange(len(ba))
        k = 0
        while len(cands) > 1:
            exhausted = lens[cands] == k
            if want_max:
                alive = cands[~exhausted]
                if len(alive) == 0:
                    return int(cands[0])  # all identical
                cands = alive
            elif exhausted.any():
                return int(cands[exhausted][0])  # a prefix beats extensions
            b = heap[off[cands] + k]
            target = b.max() if want_max else b.min()
            cands = cands[b == target]
            k += 1
        return int(cands[0])

    i_mn, i_mx = pick(False), pick(True)
    return (bytes(heap[off[i_mn] : off[i_mn] + lens[i_mn]]),
            bytes(heap[off[i_mx] : off[i_mx] + lens[i_mx]]))


def compute_statistics(
    values, ptype: Type, null_count: int, distinct_count: Optional[int] = None
) -> Statistics:
    """Stats over the defined values of one page/chunk."""
    st = Statistics(null_count=null_count)
    if distinct_count is not None:
        st.distinct_count = distinct_count
    n = len(values)
    if n == 0:
        return st
    if ptype == Type.BOOLEAN:
        return st  # nilStats: no min/max for booleans (stats.go:9-24)
    if ptype in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        if isinstance(values, ByteArrayData):
            mn, mx = _lex_minmax(values)
        else:
            items = [bytes(v) for v in values]
            mn, mx = min(items), max(items)
        st.min, st.max = mn, mx
        st.min_value, st.max_value = mn, mx
        return st
    if ptype == Type.INT96:
        return st  # no meaningful order; reference tracks none for int96 pages
    arr = np.asarray(values)
    if ptype in (Type.INT32, Type.INT64):
        mn, mx = _int_minmax(arr, 4 if ptype == Type.INT32 else 8)
        fmt = "<i" if ptype == Type.INT32 else "<q"
        st.min = st.min_value = _le_bytes(mn, fmt)
        st.max = st.max_value = _le_bytes(mx, fmt)
    elif ptype == Type.FLOAT:
        finite = arr[~np.isnan(arr)]
        if len(finite) == 0:
            return st
        st.min = st.min_value = _le_bytes(float(finite.min()), "<f")
        st.max = st.max_value = _le_bytes(float(finite.max()), "<f")
    elif ptype == Type.DOUBLE:
        finite = arr[~np.isnan(arr)]
        if len(finite) == 0:
            return st
        st.min = st.min_value = _le_bytes(float(finite.min()), "<d")
        st.max = st.max_value = _le_bytes(float(finite.max()), "<d")
    return st
