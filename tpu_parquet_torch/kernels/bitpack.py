"""Bit-packing primitives (LSB-first, parquet RLE/bit-packed hybrid layout).

The reference generates 98 width-specialized unrolled Go functions
(bitpack_gen.go:48-165 → bitbacking32.go / bitpacking64.go, 4.5k LoC).  Here a single
vectorized transform handles every width 0–64: unpack the byte stream to a bit matrix
(LSB-first within each byte, matching the parquet spec) and reduce against powers of
two.  The same math runs under NumPy (host) and jnp (device, jax_kernels.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["unpack", "pack", "bit_width"]


def bit_width(v: int) -> int:
    """Number of bits required to represent v (0 → 0). Mirrors bits.Len semantics."""
    return int(v).bit_length()


def unpack(data: bytes | np.ndarray, width: int, count: int) -> np.ndarray:
    """Unpack ``count`` unsigned values of ``width`` bits from an LSB-first stream.

    Returns uint32 for width<=32, uint64 otherwise.  Input may be longer than
    needed; excess bits/bytes are ignored.
    """
    out_dtype = np.uint32 if width <= 32 else np.uint64
    if width == 0:
        return np.zeros(count, dtype=out_dtype)
    if count == 0:
        return np.zeros(0, dtype=out_dtype)
    buf = np.frombuffer(data, dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    need_bytes = (count * width + 7) // 8
    if len(buf) < need_bytes:
        raise ValueError(
            f"bitpack underflow: need {need_bytes} bytes for {count}x{width}b, have {len(buf)}"
        )
    bits = np.unpackbits(buf[:need_bytes], bitorder="little")
    total = count * width
    bits = bits[:total].reshape(count, width)
    weights = (np.uint64(1) << np.arange(width, dtype=np.uint64))
    vals = bits.astype(np.uint64) @ weights
    return vals.astype(out_dtype, copy=False)


def pack(values: np.ndarray, width: int) -> bytes:
    """Pack unsigned values into an LSB-first bit stream, padded to whole bytes.

    Inverse of :func:`unpack`.  Values must already fit in ``width`` bits.
    Runs in C when the native library is available (~25x: the numpy form
    expands an (n, width) bit matrix — it was the dict-string writer's
    hottest cost); the numpy path is the reference and fallback.
    """
    if width == 0 or len(values) == 0:
        return b""
    from .. import native

    out = native.bp_pack(values, width)
    if out is not None:
        return out.tobytes()
    vals = np.asarray(values, dtype=np.uint64)
    shifts = np.arange(width, dtype=np.uint64)
    bits = ((vals[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.reshape(-1), bitorder="little").tobytes()
