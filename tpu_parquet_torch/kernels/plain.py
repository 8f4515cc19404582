"""PLAIN encoding codecs for all 8 physical types.

Replaces the reference's per-type value-at-a-time plain decoders
(type_int32.go:11-53, type_int64.go, type_int96.go:15-66, type_float.go,
type_double.go, type_boolean.go:10-98, type_bytearray.go:13-96) with bulk
numpy bitcasts — PLAIN decode of fixed-width types is a zero-copy view.

INT96 is decoded as a (n, 3) uint32 little-endian matrix (12 bytes per value);
int96_time helpers convert to timestamps.  BYTE_ARRAY decodes to
(offsets, heap) — the length-prefix walk is the only sequential part and has a
vectorized two-pass implementation below.
"""

from __future__ import annotations

from ..errors import ParquetError

import numpy as np

from ..column import ByteArrayData
from ..format import Type

__all__ = ["decode", "encode", "decode_byte_array", "encode_byte_array"]


class PlainError(ParquetError):
    pass


_FIXED = {
    Type.INT32: np.dtype("<i4"),
    Type.INT64: np.dtype("<i8"),
    Type.FLOAT: np.dtype("<f4"),
    Type.DOUBLE: np.dtype("<f8"),
}


def decode(
    buf: bytes, ptype: int, count: int, type_length: int = 0
) -> "np.ndarray | ByteArrayData":
    """Decode ``count`` PLAIN values of physical type ``ptype`` from ``buf``."""
    ptype = Type(ptype)
    if ptype in _FIXED:
        dt = _FIXED[ptype]
        need = count * dt.itemsize
        if len(buf) < need:
            raise PlainError(
                f"plain {ptype.name}: need {need} bytes for {count} values, have {len(buf)}"
            )
        return np.frombuffer(buf, dt, count).copy()
    if ptype == Type.INT96:
        need = count * 12
        if len(buf) < need:
            raise PlainError(f"plain INT96: need {need} bytes, have {len(buf)}")
        return np.frombuffer(buf, "<u4", count * 3).reshape(count, 3).copy()
    if ptype == Type.BOOLEAN:
        need = (count + 7) // 8
        if len(buf) < need:
            raise PlainError(f"plain BOOLEAN: need {need} bytes, have {len(buf)}")
        bits = np.unpackbits(
            np.frombuffer(buf, np.uint8, need), bitorder="little"
        )
        return bits[:count].astype(bool)
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        if type_length <= 0:
            raise PlainError(f"FIXED_LEN_BYTE_ARRAY needs positive type_length")
        need = count * type_length
        if len(buf) < need:
            raise PlainError(f"plain FIXED: need {need} bytes, have {len(buf)}")
        heap = np.frombuffer(buf, np.uint8, need).copy()
        offsets = np.arange(count + 1, dtype=np.int64) * type_length
        return ByteArrayData(offsets=offsets, heap=heap)
    if ptype == Type.BYTE_ARRAY:
        return decode_byte_array(buf, count)
    raise PlainError(f"unsupported physical type {ptype}")


def decode_byte_array(buf: bytes, count: int) -> ByteArrayData:
    """Decode length-prefixed BYTE_ARRAY values (uint32 LE length + bytes each).

    The prefix walk is inherently sequential (each length tells where the next
    one is), but only over ``count`` header positions — two passes over a small
    int array, no per-byte Python loop.  Runs in C when the native library is
    available (native/meta_parse.cpp tpq_bytearray_walk, identical semantics);
    the Python walk below is the reference and no-toolchain fallback.
    """
    if count > 0:
        from .. import native

        # no bytes() copy: the native wrapper takes any contiguous buffer
        res = native.bytearray_walk(buf, count)
        if isinstance(res, tuple):
            offsets, heap = res
            return ByteArrayData(offsets=offsets, heap=heap)
        if isinstance(res, int):
            if res == -20:
                raise PlainError("byte array: truncated length prefix")
            raise PlainError("byte array: length exceeds buffer")
    data = np.frombuffer(buf, dtype=np.uint8)
    n = len(data)
    starts = np.empty(count, dtype=np.int64)
    lens = np.empty(count, dtype=np.int64)
    pos = 0
    # Pass 1: walk headers. A Python loop over `count` items; replaced by the
    # native C++ walker when available (kept as clear fallback).
    buf_mv = memoryview(buf)
    for i in range(count):
        if pos + 4 > n:
            raise PlainError(f"byte array {i}: truncated length prefix")
        ln = int.from_bytes(buf_mv[pos : pos + 4], "little")
        if pos + 4 + ln > n:
            raise PlainError(f"byte array {i}: length {ln} exceeds buffer")
        starts[i] = pos + 4
        lens[i] = ln
        pos += 4 + ln
    offsets = np.zeros(count + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    if total == 0:
        return ByteArrayData(offsets=offsets, heap=np.zeros(0, dtype=np.uint8))
    row_of = np.repeat(np.arange(count, dtype=np.int64), lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets[:-1], lens)
    heap = data[starts[row_of] + within]
    return ByteArrayData(offsets=offsets, heap=heap)


def encode(values, ptype: int, type_length: int = 0) -> bytes:
    """PLAIN-encode values (inverse of :func:`decode`)."""
    out = encode_view(values, ptype, type_length)
    return out if isinstance(out, bytes) else out.tobytes()


def encode_view(values, ptype: int, type_length: int = 0):
    """PLAIN-encode; fixed-width types return a zero-copy uint8 VIEW of the
    (contiguous) value array instead of bytes — the writer compresses the
    buffer directly, and the per-page tobytes copy was ~25% of a plain
    int64 chunk write."""
    ptype = Type(ptype)
    if ptype in _FIXED:
        arr = np.ascontiguousarray(values, dtype=_FIXED[ptype])
        return arr.view(np.uint8).reshape(-1)
    if ptype == Type.INT96:
        arr = np.ascontiguousarray(values, dtype="<u4")
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise PlainError("INT96 values must be (n, 3) uint32")
        return arr.tobytes()
    if ptype == Type.BOOLEAN:
        bits = np.asarray(values, dtype=bool).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        ba = values if isinstance(values, ByteArrayData) else ByteArrayData.from_list(values)
        lens = ba.offsets[1:] - ba.offsets[:-1]
        if type_length > 0 and not np.all(lens == type_length):
            raise PlainError(
                f"FIXED_LEN_BYTE_ARRAY({type_length}): got lengths {set(lens.tolist())}"
            )
        return ba.heap.tobytes()
    if ptype == Type.BYTE_ARRAY:
        ba = values if isinstance(values, ByteArrayData) else ByteArrayData.from_list(values)
        return encode_byte_array(ba)
    raise PlainError(f"unsupported physical type {ptype}")


def encode_byte_array(ba: ByteArrayData) -> bytes:
    """Interleave uint32 LE length prefixes with value bytes, vectorized."""
    n = len(ba)
    lens = (ba.offsets[1:] - ba.offsets[:-1]).astype(np.int64)
    total = int(ba.offsets[-1]) + 4 * n
    out = np.empty(total, dtype=np.uint8)
    # output start of each record = old offset + 4*i
    rec_starts = ba.offsets[:-1] + 4 * np.arange(n, dtype=np.int64)
    # write length prefixes
    len32 = lens.astype("<u4").view(np.uint8).reshape(n, 4)
    idx = rec_starts[:, None] + np.arange(4, dtype=np.int64)[None, :]
    out[idx.reshape(-1)] = len32.reshape(-1)
    # write payloads
    if int(ba.offsets[-1]) > 0:
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        within = np.arange(int(ba.offsets[-1]), dtype=np.int64) - np.repeat(
            ba.offsets[:-1], lens
        )
        out[rec_starts[row_of] + 4 + within] = ba.heap
    return out.tobytes()
