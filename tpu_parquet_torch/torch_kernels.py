"""Device decode transforms in plain PyTorch — the tensor half of the decode.

The counterpart of ``tpu_parquet.jax_kernels`` for the flat-column slice.
None of these is a hand-written kernel: they are tensor code, as XLA ran
their JAX counterparts, and run on whatever device their inputs live on.
The hand-written CUDA kernels (the Pallas kernels' counterparts) are in
``cuda_kernels``.

Conventions that differ from the JAX counterparts, and why:

- **Unsigned words.** On this PyTorch, ``uint32`` tensors have no shifts,
  ``+``, ``where`` or gathers.  The arithmetic runs in ``int64`` and masks;
  results that the reference returns as ``uint32`` come back as ``int32``
  tensors holding the same 32 bits (``.numpy().view(np.uint32)`` on the
  host restores the reference's dtype bit for bit).  Run values passed in
  are ``int64`` in ``[0, 2**32)``.
- **Gather indices.** JAX clamps out-of-range gather indices silently;
  PyTorch raises on the CPU and asserts on the device.  Every index that the
  reference leaves to JAX's clamp is clamped here explicitly.
- **DOUBLE** stays ``float64`` (the reference's ``uint32[n, 2]`` word
  pairs work around the TPU's emulated f64).
"""

from __future__ import annotations

import torch

__all__ = [
    "u32_bits",
    "extract_bits",
    "expand_rle_hybrid",
    "expand_rle_hybrid_vw",
    "dict_gather",
    "levels_to_validity",
    "plain_decode_fixed",
]

_TORCH_DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2**32)`` -> ``int32`` holding the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _extract_bits64(buf: torch.Tensor, bit_pos: torch.Tensor, width,
                    max_width: int) -> torch.Tensor:
    """``extract_bits`` as ``int64`` values (the shared body)."""
    if not 0 <= max_width <= 32:
        raise ValueError(f"extract_bits supports widths up to 32, "
                         f"got {max_width}")
    bit_pos = bit_pos.to(torch.int64)
    byte0 = bit_pos >> 3
    shift = bit_pos & 7
    nbytes = (max_width + 7 + 7) // 8  # widest field + worst-case 7-bit shift
    n = buf.shape[0]
    # bucketed decode shapes may carry tail positions past the real stream;
    # clamp the gather base (and each byte, which JAX's gather clamps
    # implicitly) so every lane stays in bounds
    byte0 = torch.clamp(byte0, max=max(n - 9, 0))
    last = max(n - 1, 0)
    acc = torch.zeros_like(bit_pos)
    for k in range(nbytes):
        b = buf[torch.clamp(byte0 + k, max=last)].to(torch.int64)
        acc = acc | (b << (8 * k))
    out = acc >> shift
    if isinstance(width, torch.Tensor):
        w = width.to(torch.int64).clamp(max=32)
        mask = torch.bitwise_left_shift(torch.ones_like(w), w) - 1
    else:
        mask = (1 << int(width)) - 1 if width < 32 else (1 << 32) - 1
    return out & mask


def extract_bits(buf: torch.Tensor, bit_pos: torch.Tensor, width,
                 max_width: int) -> torch.Tensor:
    """Extract unsigned bit fields (width <= 32) from an LSB-first byte
    stream.

    ``buf``       uint8[n]
    ``bit_pos``   integer[count] — starting bit of each field.
    ``width``     int or per-value tensor — field width in bits (<= max_width).
    ``max_width`` upper bound on width; selects the gather footprint.

    Returns ``int32[count]`` holding the reference's ``uint32`` bits.
    """
    return u32_bits(_extract_bits64(buf, bit_pos, width, max_width))


def _tail_zero(out: torch.Tensor, pos: torch.Tensor, n_valid) -> torch.Tensor:
    if n_valid is None:
        return out
    return torch.where(pos < n_valid, out, torch.zeros_like(out))


def expand_rle_hybrid(buf, run_ends, run_is_rle, run_values, run_bit_starts,
                      width: int, count: int, n_valid=None):
    """Expand a parsed RLE/bit-packed hybrid stream to ``count`` values.

    Host-walked per-run tables (padded to a bucketed run count):
    ``run_ends`` int64[R] cumulative value counts (padding repeats the
    final end), ``run_is_rle`` bool[R], ``run_values`` int64[R] (the RLE
    value, 0 for bit-packed runs), ``run_bit_starts`` int64[R] payload bit
    offset minus run_start*width.  Every output position finds its run with
    one searchsorted, then broadcasts the RLE value or extracts its element.
    Lanes at or past ``n_valid`` come back zero.  Returns ``int32[count]``
    (``uint32`` bits).
    """
    dev = buf.device
    pos = torch.arange(count, dtype=torch.int64, device=dev)
    if width == 0:
        return torch.zeros(count, dtype=torch.int32, device=dev)
    r = torch.searchsorted(run_ends, pos, right=True)
    r = torch.clamp(r, max=run_ends.shape[0] - 1)
    is_rle = run_is_rle[r]
    rle_val = run_values[r]
    bit_pos = run_bit_starts[r] + pos * width
    # clamp BP gathers for RLE positions to 0 so they stay in bounds
    bit_pos = torch.where(is_rle, torch.zeros_like(bit_pos), bit_pos)
    bp_val = _extract_bits64(buf, bit_pos, width, width)
    out = torch.where(is_rle, rle_val, bp_val)
    return u32_bits(_tail_zero(out, pos, n_valid))


def expand_rle_hybrid_vw(buf, run_ends, run_is_rle, run_values,
                         run_bit_starts, run_widths, max_width: int,
                         count: int, n_valid=None):
    """Variable-width :func:`expand_rle_hybrid`: each run carries its own bit
    width (``run_widths`` int64[R], 0 for RLE runs) — a dictionary chunk
    whose index width grows page to page decodes as one merged run table."""
    dev = buf.device
    pos = torch.arange(count, dtype=torch.int64, device=dev)
    r = torch.searchsorted(run_ends, pos, right=True)
    r = torch.clamp(r, max=run_ends.shape[0] - 1)
    is_rle = run_is_rle[r]
    rle_val = run_values[r]
    w = run_widths[r].to(torch.int64)
    bit_pos = run_bit_starts[r] + pos * w
    bit_pos = torch.where(is_rle, torch.zeros_like(bit_pos), bit_pos)
    bp_val = _extract_bits64(buf, bit_pos, w, max_width)
    out = torch.where(is_rle, rle_val, bp_val)
    return u32_bits(_tail_zero(out, pos, n_valid))


def dict_gather(dictionary: torch.Tensor, indices: torch.Tensor):
    """Fixed-width dictionary expansion: ``dictionary[indices]``.

    ``indices`` hold ``uint32`` bits (``int32`` or ``int64``); they are
    clamped into the dictionary, as JAX clamps the reference's gather.
    Float dictionaries gather bit for bit (a gather moves bits; NaN
    payloads and -0.0 survive)."""
    idx = indices.to(torch.int64) & 0xFFFFFFFF
    idx = torch.clamp(idx, max=max(dictionary.shape[0] - 1, 0))
    return torch.index_select(dictionary, 0, idx)


def levels_to_validity(def_levels: torch.Tensor, max_def: int):
    """validity[i] = slot i holds a real leaf value (def == max_def)."""
    return def_levels == max_def


def plain_decode_fixed(buf: torch.Tensor, dtype: str, count: int):
    """PLAIN decode of a fixed-width type: the first ``count`` values of the
    little-endian byte stream ``buf``, as a new tensor of ``dtype``
    (``int32``, ``int64``, ``float32`` or ``float64``)."""
    dt = _TORCH_DTYPES[dtype]
    nbytes = torch.empty((), dtype=dt).element_size()
    raw = buf[: count * nbytes]
    if raw.storage_offset() % nbytes:
        raw = raw.clone()  # a dtype view needs an aligned start
    return raw.view(dt).clone()
