"""DELTA_BINARY_PACKED codec (parquet delta encoding for INT32/INT64).

Wire format (deltabp_decoder.go:13-333 semantics, parquet-format Encodings.md):

    header     := uvarint block_size, uvarint miniblocks_per_block,
                  uvarint total_value_count, zigzag-varint first_value
    block      := zigzag-varint min_delta,
                  byte[miniblocks_per_block] bit_widths,
                  miniblock* (each: values_per_miniblock deltas, bit-packed LSB-first)
    value[i]   := value[i-1] + min_delta + unpacked_delta[i]

The reference decodes one value at a time through two near-identical int32/int64
decoders; here header+bitwidth metadata is parsed on the host and the value
reconstruction is a single vectorized cumulative sum — the exact transform that
runs on-device in jax_kernels.py (prefix scan on the MXU-adjacent VPU).

Writer geometry matches the reference defaults: block_size=128,
miniblocks_per_block=4 (chunk_writer.go:53-57).
"""

from __future__ import annotations

from ..errors import ParquetError

import numpy as np

from . import bitpack

__all__ = ["decode", "encode", "parse_headers", "native_headers", "python_headers"]


class DeltaError(ParquetError):
    pass


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise DeltaError("truncated varint in delta header")
        b = int(buf[pos])  # int(): numpy uint8 would wrap under << shift
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise DeltaError("varint too long in delta header")


def _read_zigzag(buf: bytes, pos: int) -> tuple[int, int]:
    v, pos = _read_uvarint(buf, pos)
    return (v >> 1) ^ -(v & 1), pos


def native_headers(buf: bytes, pos: int = 0):
    """Native (C) header walk; None when the library is unavailable.

    Returns (first, starts int64[M] bit positions, widths int32[M],
    mins uint64[M] per-miniblock min_delta, values_per_mini, total, consumed)
    or raises DeltaError on malformed streams.
    """
    from .. import native

    # one miniblock costs >= its width-vector byte, so len(buf) bounds the
    # miniblock count even for hostile headers; +4 covers tiny streams
    got = native.delta_meta(buf, pos, len(buf) - pos + 4)
    if got is None:
        return None
    if isinstance(got, int):
        if got == -10:  # cap retry exhausted: let the Python walk diagnose
            return None
        from ..native import NATIVE_ERRORS

        raise DeltaError(NATIVE_ERRORS.get(got, f"delta parse error {got}"))
    header, starts, widths, mins = got
    block_size, minis_per_block, total, first, consumed, _ = (
        int(x) for x in header
    )
    return (first, starts, widths, mins, block_size // minis_per_block,
            total, consumed)


def parse_headers(buf: bytes, pos: int = 0):
    """Walk the stream's block/miniblock headers (native C when available).

    Same return shape as :func:`native_headers`.  The single source of truth
    for delta-stream structure: this host decoder and the device path
    (jax_decode.parse_delta_meta) both build on it, and the fuzzer replays
    both walks for parity (fuzz.py).
    """
    got = native_headers(buf, pos)
    if got is not None:
        return got
    return python_headers(buf, pos)


def python_headers(buf: bytes, pos: int = 0):
    """Python reference walk (no-toolchain fallback; fuzz parity oracle)."""
    block_size, pos = _read_uvarint(buf, pos)
    minis_per_block, pos = _read_uvarint(buf, pos)
    total, pos = _read_uvarint(buf, pos)
    first, pos = _read_zigzag(buf, pos)
    if block_size == 0 or block_size % 128 != 0:
        raise DeltaError(f"invalid delta block size {block_size}")
    if block_size > 1 << 30:  # decompression-bomb guard (parity: meta_parse.cpp)
        raise DeltaError(f"implausible delta block size {block_size}")
    if minis_per_block == 0 or block_size % minis_per_block != 0:
        raise DeltaError(f"invalid miniblock count {minis_per_block}")
    values_per_mini = block_size // minis_per_block
    if values_per_mini % 32 != 0:
        raise DeltaError(f"miniblock size {values_per_mini} not multiple of 32")
    if total > 1 << 40:
        raise DeltaError(f"implausible delta value count {total}")
    starts, widths, mins = [], [], []
    got_d = 0
    n_deltas = max(total - 1, 0)
    while got_d < n_deltas:
        min_delta, pos = _read_zigzag(buf, pos)
        if pos + minis_per_block > len(buf):
            raise DeltaError("truncated miniblock bit widths")
        wvec = buf[pos : pos + minis_per_block]
        pos += minis_per_block
        for m in range(minis_per_block):
            if got_d >= n_deltas:
                break  # trailing miniblocks of a partial block may be absent
            w = wvec[m]
            if w > 64:
                raise DeltaError(f"invalid miniblock bit width {w}")
            nbytes = (values_per_mini * w + 7) // 8
            if pos + nbytes > len(buf):
                raise DeltaError("truncated miniblock data")
            starts.append(pos * 8)
            widths.append(w)
            mins.append(min_delta & 0xFFFFFFFFFFFFFFFF)
            pos += nbytes
            got_d += min(values_per_mini, n_deltas - got_d)
    return (
        first,
        np.asarray(starts, dtype=np.int64),
        np.asarray(widths, dtype=np.int32),
        np.asarray(mins, dtype=np.uint64),
        values_per_mini, total, pos,
    )


def decode(buf: bytes, bits: int = 64) -> tuple[np.ndarray, int]:
    """Decode a DELTA_BINARY_PACKED stream.

    Returns (values, bytes_consumed).  ``bits`` selects int32 vs int64 output
    (the two decoder copies in deltabp_decoder.go).  Arithmetic wraps modulo
    2^bits, matching the reference's Go integer overflow semantics on the
    min-delta edge cases its encoder exercises (deltabp_encoder.go:57-76).

    One vectorized pass over all deltas (the host twin of
    jax_kernels.delta_reconstruct): headers are walked in C, then every
    delta's bits are gathered with byte-indexed numpy arithmetic — no
    per-miniblock Python loop (which cost ~10x the whole decode).
    """
    first, starts, widths, mins, values_per_mini, total, pos = parse_headers(buf)

    out_dtype = np.int32 if bits == 32 else np.int64
    if total == 0:
        return np.zeros(0, dtype=out_dtype), pos
    if total == 1:
        return np.array([first], dtype=np.int64).astype(out_dtype), pos

    n_deltas = total - 1
    # padded copy of the packed bytes so the widest gather stays in bounds
    arr = np.empty(len(buf) + 9, dtype=np.uint8)
    arr[: len(buf)] = np.frombuffer(buf, dtype=np.uint8)
    arr[len(buf):] = 0

    i = np.arange(n_deltas, dtype=np.int64)
    m = i // values_per_mini
    within = i % values_per_mini
    w = widths[m].astype(np.int64)
    bit_pos = starts[m] + within * w
    byte0 = bit_pos >> 3
    shift = (bit_pos & 7).astype(np.uint64)
    max_w = int(widths.max(initial=0))
    acc = np.zeros(n_deltas, dtype=np.uint64)
    for k in range((min(max_w, 57) + 7 + 7) // 8):
        acc |= arr[byte0 + k].astype(np.uint64) << np.uint64(8 * k)
    out = acc >> shift
    if max_w > 57:  # field may span 9 bytes: OR the straggler above 64-shift
        b8 = arr[byte0 + 8].astype(np.uint64)
        out |= np.where(shift > 0, b8 << (np.uint64(64) - shift), np.uint64(0))
    wu = w.astype(np.uint64)
    mask = np.where(
        wu >= 64, np.uint64(0xFFFFFFFFFFFFFFFF),
        (np.uint64(1) << wu) - np.uint64(1),
    )
    deltas = (out & mask) + mins[m]
    # wrap-around cumulative sum in unsigned target-width arithmetic
    acc2 = np.empty(total, dtype=np.uint64)
    acc2[0] = np.uint64(first & 0xFFFFFFFFFFFFFFFF)
    np.cumsum(deltas, out=acc2[1:])
    acc2[1:] += acc2[0]
    if bits == 32:
        return acc2.astype(np.uint32).astype(np.int32), pos
    return acc2.astype(np.int64), pos


def encode(
    values: np.ndarray,
    bits: int = 64,
    block_size: int = 128,
    minis_per_block: int = 4,
) -> bytes:
    """Encode int values as DELTA_BINARY_PACKED (reference writer geometry)."""
    vals = np.asarray(values)
    total = len(vals)
    out = bytearray()

    def put_uvarint(v: int) -> None:
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)

    def put_zigzag(v: int) -> None:
        if bits == 32:
            put_uvarint(((v << 1) ^ (v >> 31)) & 0xFFFFFFFF)
        else:
            put_uvarint(((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF)

    put_uvarint(block_size)
    put_uvarint(minis_per_block)
    put_uvarint(total)
    first = int(vals[0]) if total else 0
    put_zigzag(first)
    if total <= 1:
        return bytes(out)

    mask = np.uint64(0xFFFFFFFF if bits == 32 else 0xFFFFFFFFFFFFFFFF)
    u = vals.astype(np.uint64) & mask
    deltas = (u[1:] - u[:-1]) & mask  # wrapping diff in target width
    # interpret as signed target-width for min-delta selection
    if bits == 32:
        sdeltas = deltas.astype(np.uint32).astype(np.int32).astype(np.int64)
    else:
        sdeltas = deltas.astype(np.int64)

    values_per_mini = block_size // minis_per_block
    n = len(deltas)
    for b0 in range(0, n, block_size):
        block = sdeltas[b0 : b0 + block_size]
        min_delta = int(block.min())
        put_zigzag(min_delta)
        # adjusted deltas are guaranteed non-negative in target-width arithmetic
        adj = (block.astype(np.uint64) - np.uint64(min_delta & int(mask))) & mask
        nminis = (len(block) + values_per_mini - 1) // values_per_mini
        widths = []
        chunks = []
        for m in range(minis_per_block):
            lo = m * values_per_mini
            if m < nminis:
                chunk = adj[lo : lo + values_per_mini]
                w = int(chunk.max()).bit_length() if len(chunk) else 0
                widths.append(w)
                chunks.append(chunk)
            else:
                widths.append(0)
                chunks.append(None)
        out.extend(bytes(widths))
        for m in range(nminis):
            chunk = chunks[m]
            if chunk is None or widths[m] == 0:
                continue
            if len(chunk) < values_per_mini:
                chunk = np.concatenate(
                    [chunk, np.zeros(values_per_mini - len(chunk), dtype=np.uint64)]
                )
            out.extend(bitpack.pack(chunk, widths[m]))
    return bytes(out)
