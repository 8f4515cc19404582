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
    """Compute shared prefixes vs the previous value, emit the two delta
    streams.  Vectorized: one pass per shared-prefix byte position over the
    values still matching, then one masked gather for the suffix heap."""
    n = len(ba)
    heap = np.asarray(ba.heap)
    off = np.asarray(ba.offsets, dtype=np.int64)
    lens = off[1:] - off[:-1]
    prefix_lens = np.zeros(n, dtype=np.int64)
    if n > 1:
        max_p = np.minimum(lens[:-1], lens[1:])  # value i vs value i - 1
        a0, b0 = off[:-2], off[1:-1]
        shared = np.zeros(n - 1, dtype=np.int64)
        cand = np.flatnonzero(max_p > 0)
        k = 0
        while cand.size:
            cand = cand[heap[a0[cand] + k] == heap[b0[cand] + k]]
            k += 1
            shared[cand] = k
            cand = cand[max_p[cand] > k]
        prefix_lens[1:] = shared
    # suffixes: every heap byte past its value's shared prefix
    suf_lens = lens - prefix_lens
    suf_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(suf_lens, out=suf_offsets[1:])
    total = int(off[-1] - off[0]) if n else 0
    if total:
        vid = np.repeat(np.arange(n), lens)
        within = np.arange(total, dtype=np.int64) - (off[vid] - off[0])
        suf_heap = heap[off[0] : off[-1]][within >= prefix_lens[vid]]
    else:
        suf_heap = np.zeros(0, dtype=np.uint8)
    suffixes = ByteArrayData(offsets=suf_offsets, heap=suf_heap)
    return delta.encode(prefix_lens, bits=64) + encode_delta_length(suffixes)
