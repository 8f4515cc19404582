"""RLE / bit-packed hybrid codec (parquet `RLE` encoding).

Used for definition/repetition levels, dictionary indices, and boolean RLE.
Wire format (hybrid_decoder.go:29-165 semantics):

    stream      := [uint32 little-endian length prefix]? run*
    run header  := uvarint h
    h & 1 == 1  : bit-packed run of (h >> 1) groups of 8 values, ``width`` bits each
    h & 1 == 0  : RLE run — one value stored in ceil(width/8) LE bytes, repeated
                  (h >> 1) times

The reference decodes value-at-a-time through interface calls; here the run
structure is parsed on the host (cheap, metadata-sized) and runs are expanded with
vectorized repeat/unpack — the decomposition SURVEY.md §7.2-P2 prescribes so the
bulky expansion can also run on device with static shapes.
"""

from __future__ import annotations

from ..errors import ParquetError

import io
from dataclasses import dataclass

import numpy as np

from . import bitpack

__all__ = ["decode", "encode", "decode_prefixed", "parse_runs", "RunList"]


class RLEError(ParquetError):
    pass


@dataclass
class RunList:
    """Parsed run structure of a hybrid stream (host-side metadata)."""

    # Per run: kind 0=RLE, 1=bit-packed
    kinds: list
    # RLE: the repeated value and count; BP: numpy array of unpacked values
    payloads: list
    total: int


def _read_uvarint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise RLEError("truncated run header varint")
        b = int(buf[pos])  # int(): numpy uint8 would wrap under << shift
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise RLEError("run header varint too long")


def parse_runs(buf: bytes, width: int, count: int) -> RunList:
    """Parse run headers and expand per-run payloads until ``count`` values."""
    if width < 0 or width > 64:
        raise RLEError(f"invalid bit width {width}")
    kinds: list = []
    payloads: list = []
    total = 0
    pos = 0
    value_bytes = (width + 7) // 8
    n = len(buf)
    while total < count:
        if pos >= n:
            raise RLEError(
                f"hybrid stream exhausted: wanted {count} values, got {total}"
            )
        h, pos = _read_uvarint(buf, pos)
        if h & 1:  # bit-packed run: (h>>1) groups of 8
            groups = h >> 1
            nvals = groups * 8
            if nvals == 0:
                continue
            nbytes = groups * width
            if pos + nbytes > n:
                raise RLEError("truncated bit-packed run")
            # don't unpack groups beyond what the caller needs (bounded blowup:
            # a huge group count already failed the buffer check above, but a
            # stream can still legitimately hold trailing groups we don't want)
            need_groups = (count - total + 7) // 8
            nvals = min(nvals, need_groups * 8)
            vals = bitpack.unpack(
                np.frombuffer(buf, np.uint8, min(nbytes, need_groups * width), pos),
                width,
                nvals,
            )
            pos += nbytes
            kinds.append(1)
            payloads.append(vals)
            total += nvals
        else:  # RLE run
            repeats = h >> 1
            if repeats == 0:
                continue
            # clamp to what the caller asked for: a malicious header can claim
            # 2^50 repeats from a few bytes of input — never materialize more
            # than `count` values from it
            repeats = min(repeats, count - total)
            if pos + value_bytes > n:
                raise RLEError("truncated RLE run value")
            v = int.from_bytes(buf[pos : pos + value_bytes], "little") if value_bytes else 0
            pos += value_bytes
            kinds.append(0)
            payloads.append((v, repeats))
            total += repeats
    return RunList(kinds=kinds, payloads=payloads, total=total)


def _decode_native(buf: bytes, width: int, count: int) -> "np.ndarray | None":
    """Whole-stream vectorized decode: native C run walk + one numpy pass.

    The per-run loop in :func:`decode` is the host hot spot on level-heavy
    nested files (pyarrow emits one bit-packed run per ~504 values, so a 1M-row
    page costs ~2000 Python iterations + unpack calls).  This path mirrors the
    device kernel instead: the C walker emits (ends, is_rle, values,
    bit_starts) run tables, then every output position gathers its field in one
    vectorized sweep — searchsorted for the run, byte-window gather + shift +
    mask for bit-packed positions.  Returns None when the native library is
    unavailable or the width needs >32 bits (the loop handles those).
    """
    if width > 32 or count == 0:
        return None
    from .. import native

    if not isinstance(buf, bytes):
        buf = bytes(buf)
    res = native.hybrid_meta_retry(buf, len(buf), 0, width, count)
    if res is None:
        return None
    if isinstance(res, int):
        if res == -10:
            return None
        raise RLEError(
            native.NATIVE_ERRORS.get(res, f"hybrid parse error {res}")
        )
    n_runs, _consumed, ends, kinds, vals, starts = res[:6]
    if width == 0:
        return np.zeros(count, dtype=np.uint32)
    # C expansion first: same run-table contract, one pass, GIL released
    # (the numpy sweep below is the fallback and the fuzz-parity oracle)
    expanded = native.hybrid_expand(buf, ends[:n_runs], kinds[:n_runs],
                                    vals[:n_runs], starts[:n_runs],
                                    width, count)
    if expanded is not None:
        return expanded
    i = np.arange(count, dtype=np.int64)
    r = np.searchsorted(ends, i, side="right")
    r = np.minimum(r, n_runs - 1)
    is_bp = kinds[r] == 0
    bit = starts[r] + i * width  # starts are pre-normalized by -run_start*width
    bit = np.where(is_bp, bit, 0)  # RLE rows: don't let fake offsets run OOB
    byte0 = bit >> 3
    shift = (bit & 7).astype(np.uint64)
    nbytes = (width + 7 + 7) // 8  # field + worst-case shift, <= 5 for w<=32
    data = np.frombuffer(buf, dtype=np.uint8)
    padded = np.zeros(len(data) + 8, dtype=np.uint8)
    padded[: len(data)] = data
    acc = np.zeros(count, dtype=np.uint64)
    for k in range(nbytes):
        acc |= padded[byte0 + k].astype(np.uint64) << np.uint64(8 * k)
    mask = np.uint64((1 << width) - 1)
    extracted = ((acc >> shift) & mask).astype(np.uint32)
    return np.where(is_bp, extracted, vals[r].astype(np.uint32))


def decode(buf: bytes, width: int, count: int) -> np.ndarray:
    """Decode exactly ``count`` values from a hybrid stream (no length prefix)."""
    out_dtype = np.uint32 if width <= 32 else np.uint64
    if count == 0:
        return np.zeros(0, dtype=out_dtype)
    fast = _decode_native(buf, width, count)
    if fast is not None:
        return fast
    runs = parse_runs(buf, width, count)
    parts = []
    for kind, payload in zip(runs.kinds, runs.payloads):
        if kind == 0:
            v, repeats = payload
            parts.append(np.full(repeats, v, dtype=out_dtype))
        else:
            parts.append(payload.astype(out_dtype, copy=False))
    out = parts[0] if len(parts) == 1 else np.concatenate(parts)
    # bit-packed runs pad to 8; trim any trailing padding
    return out[:count]


def decode_prefixed(buf: bytes, width: int, count: int) -> tuple[np.ndarray, int]:
    """Decode a v1-style stream with a uint32 LE length prefix.

    Returns (values, bytes_consumed_including_prefix) — the level-stream layout of
    data page v1 (page_v1.go:113-119 `initSize` path).
    """
    if len(buf) < 4:
        raise RLEError("truncated level stream: missing length prefix")
    size = int.from_bytes(buf[:4], "little")
    if 4 + size > len(buf):
        raise RLEError(f"level stream length {size} exceeds buffer {len(buf) - 4}")
    return decode(buf[4 : 4 + size], width, count), 4 + size


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def encode(
    values: np.ndarray, width: int, *, use_rle_runs: bool = True, min_rle_run: int = 8
) -> bytes:
    """Encode values as a hybrid stream.

    Unlike the reference writer — which only ever emits bit-packed runs
    (hybrid_encoder.go:9-109, README.md:42) — long constant stretches are emitted
    as true RLE runs when ``use_rle_runs`` (both forms are spec-valid; RLE runs are
    strictly smaller for constant data such as all-defined def levels).  Setting
    ``use_rle_runs=False`` reproduces the reference's bit-packed-only behaviour.
    """
    vals = np.asarray(values, dtype=np.uint64)
    n = len(vals)
    out = bytearray()
    value_bytes = (width + 7) // 8

    def put_uvarint(v: int) -> None:
        while v >= 0x80:
            out.append((v & 0x7F) | 0x80)
            v >>= 7
        out.append(v)

    def put_bitpacked(chunk: np.ndarray) -> None:
        pad = (-len(chunk)) % 8
        if pad:
            chunk = np.concatenate([chunk, np.zeros(pad, dtype=np.uint64)])
        groups = len(chunk) // 8
        put_uvarint((groups << 1) | 1)
        out.extend(bitpack.pack(chunk, width))

    def put_rle(value: int, repeats: int) -> None:
        put_uvarint(repeats << 1)
        out.extend(int(value).to_bytes(value_bytes, "little"))

    if n == 0:
        return bytes(out)
    if width == 0:
        # all values are zero-width: a single RLE run carries the count
        put_uvarint(n << 1)
        return bytes(out)

    if not use_rle_runs:
        put_bitpacked(vals)
        return bytes(out)

    # Segment into constant runs; emit RLE for long runs, bit-packed spans between.
    # A mid-stream bit-packed run always decodes to exactly 8*groups values, so any
    # span we bit-pack before an RLE run must hold a multiple of 8 real values —
    # we borrow leading repeats from the constant run to reach alignment (they are
    # constant, so moving them into the bit-packed span is value-preserving).
    # Only the final bit-packed run may be zero-padded (decoder trims by count).
    change = np.flatnonzero(np.diff(vals)) + 1
    bounds = np.concatenate([[0], change, [n]])
    run_starts = bounds[:-1]
    run_lens = np.diff(bounds)
    min_rle = max(min_rle_run, 8)
    # only constant runs >= min_rle can become RLE; everything else stays in
    # the buffered bit-packed span — iterating candidates (few) instead of
    # every segment (~n for high-cardinality data) keeps this O(runs_emitted)
    pending_start = 0  # start of accumulated not-yet-emitted span
    for ci in np.flatnonzero(run_lens >= min_rle):
        start = int(run_starts[ci])
        run_len = int(run_lens[ci])
        pend = start - pending_start
        borrow = (-pend) % 8
        if run_len - borrow < min_rle:
            continue  # borrowing for alignment would gut the run; keep buffering
        if pend + borrow:
            put_bitpacked(vals[pending_start : start + borrow])
        put_rle(int(vals[start]), run_len - borrow)
        pending_start = start + run_len
    if n > pending_start:
        put_bitpacked(vals[pending_start:])
    return bytes(out)


def encode_prefixed(values: np.ndarray, width: int, **kw) -> bytes:
    """Hybrid stream with the uint32 length prefix used by v1 level streams."""
    body = encode(values, width, **kw)
    return len(body).to_bytes(4, "little") + body
