"""Delta byte-array codecs: DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY.

DELTA_LENGTH_BYTE_ARRAY (type_bytearray.go:98-187 semantics): a DELTA_BINARY_PACKED
stream of value lengths, then all value bytes concatenated.  Decode is a cumsum of
lengths — offsets fall straight out.

DELTA_BYTE_ARRAY (type_bytearray.go:189-292): two delta streams — shared-prefix
lengths and suffix lengths — then concatenated suffix bytes.  Each value reuses a
prefix of its *predecessor*, which is inherently sequential; the stitch runs on the
host with numpy (SURVEY.md §7.4.4 hard-part ranking).
"""

from __future__ import annotations

from ..errors import ParquetError

import numpy as np

from ..column import ByteArrayData
from . import delta

__all__ = [
    "decode_delta_length",
    "encode_delta_length",
    "decode_delta",
    "encode_delta",
]


class ByteArrayError(ParquetError):
    pass


def decode_delta_length(buf: bytes, count: int) -> ByteArrayData:
    lens, consumed = delta.decode(buf, bits=64)
    if len(lens) < count:
        raise ByteArrayError(
            f"DELTA_LENGTH_BYTE_ARRAY: {len(lens)} lengths for {count} values"
        )
    lens = lens[:count]
    if np.any(lens < 0):
        raise ByteArrayError("negative value length")
    offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    if consumed + total > len(buf):
        raise ByteArrayError(
            f"DELTA_LENGTH_BYTE_ARRAY: needs {total} payload bytes, have {len(buf) - consumed}"
        )
    heap = np.frombuffer(buf, np.uint8, total, consumed).copy()
    return ByteArrayData(offsets=offsets, heap=heap)


def encode_delta_length(ba: ByteArrayData) -> bytes:
    lens = (ba.offsets[1:] - ba.offsets[:-1]).astype(np.int64)
    return delta.encode(lens, bits=64) + ba.heap.tobytes()


def decode_delta(buf: bytes, count: int) -> ByteArrayData:
    """DELTA_BYTE_ARRAY: prefix lengths + suffix stream with incremental reuse."""
    prefix_lens, consumed = delta.decode(buf, bits=64)
    if len(prefix_lens) < count:
        raise ByteArrayError("DELTA_BYTE_ARRAY: short prefix-length stream")
    prefix_lens = prefix_lens[:count]
    if np.any(prefix_lens < 0):
        raise ByteArrayError("negative prefix length")
    suffixes = decode_delta_length(buf[consumed:], count)
    if count == 0:
        return suffixes
    if int(prefix_lens[0]) != 0:
        raise ByteArrayError("first value cannot have a prefix")

    suf_lens = suffixes.offsets[1:] - suffixes.offsets[:-1]
    out_lens = prefix_lens + suf_lens
    out_offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(out_lens, out=out_offsets[1:])
    heap = np.empty(int(out_offsets[-1]), dtype=np.uint8)
    prev_start = 0
    prev_len = 0
    s_off = suffixes.offsets
    s_heap = suffixes.heap
    from .. import native

    rc = native.delta_ba_stitch(
        np.ascontiguousarray(prefix_lens, dtype=np.int64),
        np.ascontiguousarray(s_off, dtype=np.int64),
        np.ascontiguousarray(s_heap, dtype=np.uint8),
        out_offsets,
        heap,
    )
    if rc == 0:
        return ByteArrayData(offsets=out_offsets, heap=heap)
    if rc == -30:
        raise ByteArrayError("prefix longer than previous value")
    # native unavailable: reference Python chain below
    for i in range(count):
        p = int(prefix_lens[i])
        if p > prev_len:
            raise ByteArrayError(
                f"value {i}: prefix {p} longer than previous value {prev_len}"
            )
        start = int(out_offsets[i])
        if p:
            heap[start : start + p] = heap[prev_start : prev_start + p]
        sl = int(suf_lens[i])
        if sl:
            heap[start + p : start + p + sl] = s_heap[s_off[i] : s_off[i] + sl]
        prev_start = start
        prev_len = p + sl
    return ByteArrayData(offsets=out_offsets, heap=heap)


def encode_delta(ba: ByteArrayData) -> bytes:
    """Compute shared prefixes vs the previous value, emit the two delta streams."""
    n = len(ba)
    prefix_lens = np.zeros(n, dtype=np.int64)
    heap = ba.heap
    off = ba.offsets
    for i in range(1, n):
        a0, a1 = int(off[i - 1]), int(off[i])
        b0, b1 = int(off[i]), int(off[i + 1])
        max_p = min(a1 - a0, b1 - b0)
        if max_p:
            av = heap[a0 : a0 + max_p]
            bv = heap[b0 : b0 + max_p]
            neq = np.flatnonzero(av != bv)
            prefix_lens[i] = int(neq[0]) if len(neq) else max_p
    # suffixes
    suf_parts = []
    suf_lens = np.empty(n, dtype=np.int64)
    for i in range(n):
        s0 = int(off[i]) + int(prefix_lens[i])
        s1 = int(off[i + 1])
        suf_lens[i] = s1 - s0
        suf_parts.append(heap[s0:s1])
    suf_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(suf_lens, out=suf_offsets[1:])
    suf_heap = (
        np.concatenate(suf_parts) if suf_parts else np.zeros(0, dtype=np.uint8)
    )
    suffixes = ByteArrayData(offsets=suf_offsets, heap=suf_heap)
    return delta.encode(prefix_lens, bits=64) + encode_delta_length(suffixes)
