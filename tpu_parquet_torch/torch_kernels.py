"""Device decode transforms in plain PyTorch — the tensor half of the decode.

The counterpart of ``tpu_parquet.jax_kernels`` for the port's flat-column slices.
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
    "extract_bits64",
    "expand_rle_hybrid",
    "expand_rle_hybrid_vw",
    "delta_reconstruct",
    "dict_gather_bytes",
    "ragged_take",
    "levels_to_validity",
    "scatter_defined",
    "row_starts_from_rep",
    "plain_decode_fixed",
    "byte_stream_split_decode",
    "snappy_resolve",
    "narrow_widen_words",
]

_TORCH_DTYPES = {
    "int32": torch.int32,
    "int64": torch.int64,
    # INT96 words: uint32 bits in int32 lanes
    "uint32": torch.int32,
    "float32": torch.float32,
    "float64": torch.float64,
}


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """``int64`` values in ``[0, 2**32)`` -> ``int32`` holding the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _low_mask(width, cap: int = 64):
    """All ones in the low ``min(width, cap)`` bits (all 64 bits at 64 and
    over), as ``int64`` lanes; ``width`` is an int or an integer tensor."""
    if not isinstance(width, torch.Tensor):
        w = min(int(width), cap)
        return -1 if w >= 64 else (1 << w) - 1
    w = width.to(torch.int64)
    if cap < 64:
        return torch.bitwise_left_shift(torch.ones_like(w),
                                        w.clamp(max=cap)) - 1
    m = ~torch.bitwise_left_shift(torch.full_like(w, -1), w.clamp(0, 63))
    return torch.where(w >= 64, torch.full_like(m, -1), m)


def _lsr(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Logical right shift of ``int64`` lanes holding ``uint64`` bits by
    ``s`` in ``[0, 63]`` (torch's ``>>`` on ``int64`` is arithmetic)."""
    return (x >> s) & _low_mask(64 - s)


def extract_bits64(buf: torch.Tensor, bit_pos: torch.Tensor, width,
                   max_width: int) -> torch.Tensor:
    """Extract unsigned bit fields of up to 64 bits from an LSB-first byte
    stream: the reference's ``extract_bits`` at every width.

    ``buf``       uint8[n]
    ``bit_pos``   integer[count] — starting bit of each field.
    ``width``     int or per-value tensor — field width in bits (<= max_width).
    ``max_width`` upper bound on width (0..64); selects the gather footprint
                  and, as in the reference, one of three regimes: <= 25 bits
                  (one 32-bit accumulation), <= 57 (one 64-bit accumulation
                  of up to 8 bytes), 58..64 (8 bytes plus a 9th straggler
                  byte shifted up by ``64 - shift``).

    Returns ``int64[count]`` holding the reference's result bits: its
    ``uint32`` values when ``max_width <= 32``, else its ``uint64`` bits
    (``.numpy().view(np.uint64)`` on the host restores them)."""
    if not 0 <= max_width <= 64:
        raise ValueError(f"extract_bits supports widths up to 64, "
                         f"got {max_width}")
    bit_pos = bit_pos.to(torch.int64)
    shift = bit_pos & 7
    n = buf.shape[0]
    # bucketed decode shapes may carry tail positions past the real stream;
    # clamp the gather base (and each byte, which JAX's gather clamps
    # implicitly) so every lane stays in bounds
    byte0 = torch.clamp(bit_pos >> 3, max=max(n - 9, 0))
    last = max(n - 1, 0)

    def byte(k):
        return buf[torch.clamp(byte0 + k, max=last)].to(torch.int64)

    if max_width <= 57:
        nbytes = (max_width + 7 + 7) // 8  # + worst-case 7-bit shift
        acc = torch.zeros_like(bit_pos)
        for k in range(nbytes):
            acc = acc | (byte(k) << (8 * k))
        if nbytes < 8:
            # acc < 2**56: the arithmetic shift is the logical one, and a
            # mask past 56 bits (past 32: the reference's uint32 result)
            # clears nothing more
            cap = 32 if max_width <= 32 else 56
            return (acc >> shift) & _low_mask(width, cap)
        return _lsr(acc, shift) & _low_mask(width)
    mask = _low_mask(width)
    acc = torch.zeros_like(bit_pos)
    for k in range(8):
        acc = acc | (byte(k) << (8 * k))
    # the field may span 9 bytes: the straggler's bits go above 64 - shift
    # (nothing when shift == 0, where that shift would be 64)
    high = torch.bitwise_left_shift(byte(8), (64 - shift).clamp(max=63))
    high = torch.where(shift > 0, high, torch.zeros_like(high))
    return (_lsr(acc, shift) | high) & mask


def extract_bits(buf: torch.Tensor, bit_pos: torch.Tensor, width,
                 max_width: int) -> torch.Tensor:
    """Extract unsigned bit fields (width <= 32) from an LSB-first byte
    stream.

    ``buf``       uint8[n]
    ``bit_pos``   integer[count] — starting bit of each field.
    ``width``     int or per-value tensor — field width in bits (<= max_width).
    ``max_width`` upper bound on width; selects the gather footprint.

    Returns ``int32[count]`` holding the reference's ``uint32`` bits (wider
    fields: :func:`extract_bits64`).
    """
    if not 0 <= max_width <= 32:
        raise ValueError(f"extract_bits supports widths up to 32, "
                         f"got {max_width}; use extract_bits64")
    return u32_bits(extract_bits64(buf, bit_pos, width, max_width))


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
    bp_val = extract_bits64(buf, bit_pos, width, width)
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
    bp_val = extract_bits64(buf, bit_pos, w, max_width)
    out = torch.where(is_rle, rle_val, bp_val)
    return u32_bits(_tail_zero(out, pos, n_valid))


def delta_reconstruct(buf, first_value, mini_bit_starts, mini_widths,
                      mini_min_delta, values_per_mini: int, count: int,
                      bits: int, max_width: "int | None" = None):
    """Reconstruct DELTA_BINARY_PACKED values from packed miniblock bytes.

    The host walked the block headers (``torch_decode.parse_delta_meta``)
    into per-miniblock tables: ``mini_bit_starts`` int64[M] bit offset of
    each miniblock's packed deltas, ``mini_widths`` integer[M] their bit
    widths (<= 64), ``mini_min_delta`` int64[M] the block's min delta
    (``uint64`` bits), ``first_value`` the stream's first value.  Every
    table may carry a leading page axis (``first_value`` [P], tables
    [P, M]): the pages decode in one batched expression, the reference's
    ``vmap``.  Per delta: extract its bits, add the min delta, then a
    cumulative sum seeded with the first value.  ``count`` values per page
    (the bucketed count; lanes past a page's real count are garbage).

    Arithmetic wraps modulo ``2**bits`` as in the reference's unsigned
    lanes: ``int64`` sums wrap modulo 2**64, and for ``bits == 32`` the low
    32 bits are folded back into ``int32`` explicitly.  Returns ``int32``
    or ``int64`` ``[..., count]``."""
    first = torch.as_tensor(first_value, dtype=torch.int64,
                            device=buf.device)
    batched = first.dim() > 0
    if not batched:
        first = first[None]
        mini_bit_starts, mini_widths, mini_min_delta = (
            t[None] for t in (mini_bit_starts, mini_widths, mini_min_delta))
    n_deltas = count - 1
    if n_deltas <= 0:
        vals = first[:, None].expand(-1, max(count, 0))
    else:
        i = torch.arange(n_deltas, dtype=torch.int64, device=buf.device)
        # bucketed counts run past the real miniblocks: JAX clamps the
        # table gathers, so do the same
        m = torch.clamp(i // values_per_mini, max=mini_widths.shape[-1] - 1)
        within = i % values_per_mini
        w = mini_widths[:, m].to(torch.int64)
        bit_pos = mini_bit_starts[:, m] + within * w
        mw = bits if max_width is None else max(int(max_width), 1)
        raw = extract_bits64(buf, bit_pos.reshape(-1), w.reshape(-1),
                             mw).reshape(w.shape)
        deltas = raw + mini_min_delta[:, m].to(torch.int64)
        vals = torch.cat([first[:, None],
                          first[:, None] + torch.cumsum(deltas, dim=1)], 1)
    if bits == 32:
        vals = u32_bits(vals & 0xFFFFFFFF)
    return vals if batched else vals[0]


def dict_gather_bytes(dict_u8_rows: torch.Tensor, indices: torch.Tensor,
                      dtype: str):
    """Gather dictionary rows as raw bytes, then reinterpret them as
    ``dtype``.

    ``dict_u8_rows`` uint8[K, itemsize]; ``indices`` hold ``uint32`` bits.
    An index past the table reads a row of ``0xFF`` bytes, as the
    reference's ``jnp.take`` fills it (only the deferred range check's path
    can see one, and it raises at finalize).  The byte gather moves bits
    verbatim (NaN payloads, -0.0 and subnormals survive).
    ``float64`` comes back as ``float64[n]`` (the reference's ``uint32[n,
    2]`` word pairs hold the same bytes); a row wider than one ``dtype``
    item keeps a trailing word axis: INT96 (``dtype`` ``"uint32"``) is
    ``int32[n, 3]`` holding the reference's ``uint32`` words."""
    idx = indices.to(torch.int64) & 0xFFFFFFFF
    k, total = dict_u8_rows.shape
    n = idx.shape[0]
    if k:
        rows = torch.index_select(dict_u8_rows, 0, torch.clamp(idx, max=k - 1))
        rows = torch.where((idx < k)[:, None], rows,
                           torch.full_like(rows, 0xFF))
    else:
        rows = torch.full((n, total), 0xFF, dtype=torch.uint8,
                          device=dict_u8_rows.device)
    dt = _TORCH_DTYPES[dtype]
    itemsize = torch.empty((), dtype=dt).element_size()
    words = rows.view(dt)
    return words.reshape(n) if total == itemsize else words.reshape(
        n, total // itemsize)


def ragged_take(offsets: torch.Tensor, heap: torch.Tensor,
                indices: torch.Tensor, out_heap_size: int):
    """Gather rows of a ragged (offsets, heap) byte column (string
    dictionary decode).

    ``out_heap_size`` is the host's sum of the selected lengths (or a
    bucket over it).  Returns (new_offsets int64[m+1], new_heap
    uint8[out_heap_size]).  Output byte j maps to output row
    r = searchsorted(new_offsets, j) and source byte
    src_start[r] + (j - new_start[r]): two gathers, no per-row loop.  Row
    and source indices are clipped as in the reference; every other gather
    is clamped where JAX clamps."""
    dev = offsets.device
    idx = indices.to(torch.int64) & 0xFFFFFFFF
    last = max(offsets.shape[0] - 1, 0)
    lens = (offsets[torch.clamp(idx + 1, max=last)]
            - offsets[torch.clamp(idx, max=last)])
    new_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(lens, 0)])
    if idx.shape[0] == 0 or heap.shape[0] == 0:
        return new_off, torch.zeros(out_heap_size if heap.shape[0] else 0,
                                    dtype=torch.uint8, device=dev)
    j = torch.arange(out_heap_size, dtype=torch.int64, device=dev)
    r = torch.searchsorted(new_off, j, right=True) - 1
    r = torch.clamp(r, 0, idx.shape[0] - 1)
    src = offsets[torch.clamp(idx[r], max=last)] + (j - new_off[r])
    src = torch.clamp(src, 0, heap.shape[0] - 1)
    return new_off, heap[src]


def levels_to_validity(def_levels: torch.Tensor, max_def: int):
    """validity[i] = slot i holds a real leaf value (def == max_def)."""
    return def_levels == max_def


def scatter_defined(values: torch.Tensor, validity: torch.Tensor, fill):
    """Dense defined values -> one per slot, ``fill`` at the null slots.

    Slot i reads ``values`` at the exclusive prefix count of validity: one
    scan and one (clamped) gather.  2-D values keep their trailing axis, the
    validity broadcast over it; empty ``values`` give ``fill`` at every slot
    (shaped like ``validity``, as in the reference)."""
    if values.shape[0] == 0:
        return torch.full(validity.shape, fill, dtype=values.dtype,
                          device=validity.device)
    vidx = torch.cumsum(validity.to(torch.int32), 0) - 1
    vidx = torch.clamp(vidx, 0, values.shape[0] - 1)
    expanded = values.index_select(0, vidx)
    mask = validity.reshape(validity.shape + (1,) * (values.dim() - 1))
    return torch.where(mask, expanded,
                       torch.tensor(fill, dtype=values.dtype,
                                    device=values.device))


def row_starts_from_rep(rep_levels: torch.Tensor):
    """Row boundaries from repetition levels: a slot with rep == 0 starts a
    row; ``row_index`` is the inclusive int64 prefix count of starts - 1
    (the slot's row)."""
    starts = rep_levels == 0
    row_index = torch.cumsum(starts.to(torch.int64), 0) - 1
    return starts, row_index


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


def byte_stream_split_decode(buf: torch.Tensor, dtype: str, count: int):
    """BYTE_STREAM_SPLIT: de-interleave the ``itemsize`` byte streams of
    ``count`` values, then reinterpret as ``dtype`` (``float64`` stays
    ``float64``; see :func:`plain_decode_fixed`)."""
    dt = _TORCH_DTYPES[dtype]
    nbytes = torch.empty((), dtype=dt).element_size()
    # a fresh row-major [count, itemsize] tensor: aligned for the dtype view
    mat = torch.empty((count, nbytes), dtype=torch.uint8, device=buf.device)
    mat.copy_(buf[: count * nbytes].reshape(nbytes, count).t())
    return mat.view(dt).reshape(count)


def snappy_resolve(ends, asrc, offs, islit, *, out_pad: int, iters: int):
    """Resolve snappy op tables into a per-output-byte SOURCE MAP.

    The shared device half of the compressed-shipping routes (``ship.py``):
    the host's tag walk (``native.snappy_plan``, packed by
    ``device_reader._plan_snappy_ops``) describes each op's output extent;
    this maps every position of the decompressed OUTPUT SPACE to the staged
    buffer index holding its byte, without materializing the output:

    1. per output byte, find its op (one searchsorted over ``ends``) and
       compute a source: literal bytes point into the staged compressed
       stream (>= 0); copy bytes encode their output-space source as
       ``-(pos)-1`` using the periodic form
       ``dst_start - offset + (i mod offset)``, which maps overlapping
       (RLE-style) copies straight past their own op;
    2. resolve copy chains by pointer doubling: ``iters`` rounds of
       ``S = where(S >= 0, S, S[-S-1])`` (``iters`` comes from the host's
       exact max chain depth, so no device read decides it).

    All math is int32, like the reference's (planners enforce the arena
    ceiling); every gather index is clamped where the reference clips.
    Positions past the real output resolve through padded literal ops.
    Returns ``int32[out_pad]`` of staged-buffer byte indices.
    """
    n_ops = ends.shape[0]
    j = torch.arange(out_pad, dtype=torch.int32, device=ends.device)
    op = torch.clamp(torch.searchsorted(ends, j, right=True), 0, n_ops - 1)
    prev = ends[torch.clamp(op - 1, min=0)]
    start = torch.where(op > 0, prev, torch.zeros_like(prev))
    within = j - start
    a = asrc[op]
    S = torch.where(
        islit[op] != 0,
        a + within,
        -(a + torch.remainder(within, torch.clamp(offs[op], min=1))) - 1,
    )
    for _ in range(iters):
        t = torch.clamp(-S - 1, 0, out_pad - 1)
        S = torch.where(S >= 0, S, S[t.long()])
    return S


def narrow_widen_words(raw: torch.Tensor, bias: int, *, width: int):
    """Widen ``k``-byte little-endian rows and re-bias them to finished
    words: ``v = bias + zero_extend(bytes)`` modulo ``2**(8*width)``.

    ``raw`` uint8[count, k] (1 <= k <= width), ``bias`` a Python int (taken
    modulo 2**64), ``width`` 4 or 8.  Returns ``int32[count, width // 4]``
    holding the little-endian ``uint32`` words.  The add runs as the
    reference's u32 word pair with carry, in ``int64`` lanes that never
    overflow, so any bias and any k give the modular result."""
    k = raw.shape[1]
    r = raw.to(torch.int64)
    bu = int(bias) % (1 << 64)
    mask = (1 << 32) - 1
    lo = torch.zeros(raw.shape[0], dtype=torch.int64, device=raw.device)
    for i in range(min(k, 4)):
        lo = lo | (r[:, i] << (8 * i))
    lo_sum = lo + (bu & mask)
    if width == 4:
        return u32_bits(lo_sum & mask)[:, None]
    hi = torch.zeros_like(lo)
    for i in range(4, k):
        hi = hi | (r[:, i] << (8 * (i - 4)))
    hi_sum = (hi + (bu >> 32) + (lo_sum >> 32)) & mask
    return u32_bits(torch.stack([lo_sum & mask, hi_sum], dim=1))
