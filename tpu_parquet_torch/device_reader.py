"""Batched device reader: one staged buffer per row group, decoded on the card.

The counterpart of ``tpu_parquet.device_reader`` for fixed-width flat
columns.  Per row group:

1. the host walks the footer and each chunk's page headers and walks the
   RLE/bit-packed run headers (``_collect_chunk``).  PLAIN pages of a SNAPPY
   chunk stay compressed until a route needs their host bytes (lazy pages,
   ``ParsedDataPage.comp``); every other page is decompressed here;
2. per chunk, ``_ChunkAssembler.preship`` ranks the seven ship routes
   (``ship.py``) and does the host half of the first feasible one (narrow
   transcode, link recompression); ``finish`` registers the bytes its
   device half reads with ONE ``_RowGroupStager`` and returns a ``_Plan``;
3. the stager fills one pinned host buffer and copies it to the device in
   one ``non_blocking`` transfer;
4. ``_run_plans`` runs every chunk's decode over that one buffer: the
   hand-written CUDA kernels of ``cuda_kernels`` (the fused K1 unpack +
   run-table combine for dictionary indices and def levels, K2 for
   ``fused_plain``, K3 for ``fused_narrow_snappy``)
   and the tensor code of ``torch_kernels`` (the snappy resolve of the
   staged chains, gathers, widening, the delta reconstruction, the
   byte-array heap compaction);
5. the output is one :class:`DeviceColumnData` per column, or a
   :class:`DeviceDictColumn` (``uint32`` indices plus the dictionary:
   fixed-width byte rows, or the ragged offsets and heap) for a
   dictionary-encoded chunk, as the reference returns them.

The slice: every flat column (REQUIRED or OPTIONAL, no repetition) the
reference reads — BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY
and FIXED_LEN_BYTE_ARRAY; UNCOMPRESSED, SNAPPY, GZIP and ZSTD; data pages
v1 and v2; page CRCs.  Batched on the row group's buffer: PLAIN,
dictionary and DELTA_BINARY_PACKED chunks, PLAIN BOOLEAN, INT96 and FLBA,
and the dictionary fallback (a dictionary-encoded prefix of pages, then
PLAIN pages) of a fixed-width column.  Every other chunk (BYTE_STREAM_SPLIT,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, boolean RLE, other mixes of
encodings) takes the host-decode path, ``_finish_host``: page by page
through ``torch_decode.DeviceChunkDecoder``, staged per page.  A repeated
leaf raises ``NotImplementedError`` naming the slice.

Every raise of the chunk walk carries the decode site
(``errors.error_context``: file, column, row group, page, byte offset).

Nothing on the decode path waits for the device: the dictionary-index range
check runs on the host (``_check_dict_range``).  Only when the native run
walk is unavailable is the check deferred to one device read in
``finalize()``, as the reference defers it.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import native
from . import torch_kernels as K
from .chunk_decode import _check_crc, validate_chunk_meta, walk_pages
from .errors import error_context
from .column import ByteArrayData
from .compress import decompress_block
from .cuda_kernels import (FUSED_MAX_DEPTH, FUSED_MAX_OPS, FUSED_MAX_PAYLOAD,
                           SNAPPY_OPS_BYTES, bp_groups_pad, fused_count_pad,
                           fused_narrow_count_pad, fused_narrow_words,
                           fused_plain_words, hybrid_unpack_combine)
from .footer import ParquetError, read_file_metadata
from .format import CompressionCodec, Encoding, PageType, Type, parse_encoding
from .kernels import bitpack
from .kernels.delta import _read_uvarint
from .schema.core import Schema, SchemaNode
from .ship import (
    ChunkFacts, FUSED_ROUTES, ROUTE_DEVICE_SNAPPY, ROUTE_FUSED_NARROW_SNAPPY,
    ROUTE_FUSED_PLAIN, ROUTE_NARROW, ROUTE_NARROW_SNAPPY, ROUTE_PLAIN,
    ROUTE_RECOMPRESS, SNAPPY_WORTH_RATIO, ShipPlanner,
)
from .torch_decode import (
    DeviceColumnData, ParsedDataPage, _bucket, _bucket_bytes, _bucket_count,
    _SLACK, _PTYPE_TO_NAME, _concat_ragged, _hybrid, _hybrid_vw,
    _max_index, _plain, _plain_flba, _plain_rows,
    _resolve_device, host_decode_dictionary, parse_data_page,
    parse_delta_meta, parse_hybrid_meta,
)

__all__ = ["DeviceDictColumn", "DeviceFileReader", "ReaderStats"]

SLICE = ("flat columns of every physical type (BYTE_ARRAY and "
         "FIXED_LEN_BYTE_ARRAY included) with PLAIN, dictionary, "
         "DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, delta byte-array or boolean "
         "RLE pages (the tpu_parquet_torch flat-column slice)")

_I32_MAX = np.iinfo(np.int32).max

_TORCH_DTYPES = K._TORCH_DTYPES


def _out_of_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not supported by {SLICE}")


# pointer-doubling round buckets; 24 covers chains of 2^24 ops
_SNAPPY_ITER_BUCKETS = (2, 4, 8, 16, 24)
# op-table cap: a stream shattered into more ops than this ships decompressed
_SNAPPY_MAX_OPS = 1 << 20
# ratio~1 chunks larger than this take the host-decompress path
_SNAPPY_SMALL_OUT = 8 << 20
# transcode only when it saves >= 3 bytes/value
_NARROW_SAVE_BYTES = 3
# probe the first page's head before scanning the whole chunk: full-range
# data must not pay a full min/max pass just to bail
_NARROW_PROBE = 65536


def _check_plain_sizes(pages, width: int) -> None:
    """Reject PLAIN pages whose value stream is shorter than defined*width
    (a lazy page is measured by its declared decompressed size)."""
    for p in pages:
        nbytes = (p.comp[2] if p.comp is not None
                  else len(p.raw) - p.value_pos)
        if nbytes < p.defined * width:
            raise ParquetError(
                f"PLAIN data truncated: {nbytes} < {p.defined * width}"
            )


def _span_bytes(lo: int, hi: int) -> int:
    """Bytes needed for the unsigned span hi - lo (>= 1)."""
    return max((int(hi) - int(lo)).bit_length() + 7, 8) // 8


def _narrow_max_k(width: int) -> int:
    """Largest transcoded byte width still worth the host pass (shared by
    the stats hint and the narrow plan function, which must agree)."""
    return width - (_NARROW_SAVE_BYTES if width == 8 else 2)


def _int_stats_span(statistics, leaf) -> "tuple[int, int] | None":
    """Chunk Statistics min/max as an int span hint, if plausible.

    Returns (min, max) for INT32/INT64 leaves whose stats carry well-formed
    PLAIN-encoded bounds, else None.  A planning INPUT only (it routes the
    narrow transcode), never trusted for correctness."""
    if (statistics is None
            or leaf.physical_type not in (Type.INT32, Type.INT64)):
        return None
    width = 8 if leaf.physical_type == Type.INT64 else 4
    dt = "<i8" if width == 8 else "<i4"
    lo = (statistics.min_value if statistics.min_value is not None
          else statistics.min)
    hi = (statistics.max_value if statistics.max_value is not None
          else statistics.max)
    if (not isinstance(lo, (bytes, bytearray)) or len(lo) != width
            or not isinstance(hi, (bytes, bytearray)) or len(hi) != width):
        return None
    lo_v = int(np.frombuffer(lo, dt)[0])
    hi_v = int(np.frombuffer(hi, dt)[0])
    if lo_v > hi_v:
        return None
    return lo_v, hi_v


@dataclass
class DeviceDictColumn(DeviceColumnData):
    """A dictionary-encoded column on the device: the values stay as
    (dictionary, indices), like an Arrow DictionaryArray.

    ``indices`` ``int32`` holding the ``uint32`` index bits (bucket-padded;
    the tail is zero).  The dictionary is either fixed-width byte rows,
    ``dict_u8`` (``uint8[K_pad, itemsize]``, rows past the dictionary's
    real size are padding) with ``dict_dtype`` the values' dtype name
    (``"uint32"`` for INT96's 12-byte rows), or ragged: ``dict_offsets``
    ``int64`` and ``dict_heap`` ``uint8``, both padded past the real rows
    (no valid index reads the padding).  ``materialize()`` gathers on the
    device for a fixed-width dictionary and on the host for a ragged one;
    ``to_host()`` gathers on the host — as the reference's do."""

    indices: Optional[torch.Tensor] = None
    dict_u8: Optional[torch.Tensor] = None
    dict_dtype: Optional[str] = None
    dict_offsets: Optional[torch.Tensor] = None
    dict_heap: Optional[torch.Tensor] = None

    @property
    def num_values(self) -> int:
        if self.n_values is not None:
            return self.n_values
        return int(self.indices.shape[0]) if self.indices is not None else 0

    def validity(self) -> torch.Tensor:
        if self.def_levels is None:
            return torch.ones(self.num_leaf_slots, dtype=torch.bool,
                              device=self.indices.device)
        return super().validity()

    def _take(self) -> ByteArrayData:
        # the padded tables, as the reference's take reads them
        idx = (self.indices[: self.num_values].to(torch.int64)
               & 0xFFFFFFFF).cpu().numpy()
        return ByteArrayData(offsets=self.dict_offsets.cpu().numpy(),
                             heap=self.dict_heap.cpu().numpy()).take(idx)

    def materialize(self) -> DeviceColumnData:
        """The gathered column on the indices' device: a device gather of
        the byte rows (``dict_gather_bytes``) for a fixed-width dictionary,
        the host's ragged gather shipped back for a ragged one."""
        if self.dict_u8 is not None:
            # padded tail indices are zeros, so the gather stays in bounds;
            # n_values carries the real count
            vals = K.dict_gather_bytes(self.dict_u8, self.indices,
                                       self.dict_dtype)
            return DeviceColumnData(
                values=vals, def_levels=self.def_levels,
                rep_levels=self.rep_levels, max_def=self.max_def,
                max_rep=self.max_rep, num_leaf_slots=self.num_leaf_slots,
                value_dtype=self.value_dtype, n_values=self.n_values,
            )
        host = self._take()
        dev = self.indices.device
        return DeviceColumnData(
            offsets=torch.from_numpy(host.offsets).to(dev),
            heap=torch.from_numpy(host.heap).to(dev),
            def_levels=self.def_levels, rep_levels=self.rep_levels,
            max_def=self.max_def, max_rep=self.max_rep,
            num_leaf_slots=self.num_leaf_slots,
        )

    def to_host(self) -> "ByteArrayData | np.ndarray":
        if self.dict_u8 is None:
            return self._take()
        idx = (self.indices[: self.num_values].to(torch.int64)
               & 0xFFFFFFFF).cpu().numpy()
        rows = self.dict_u8.cpu().numpy()
        n, _ = rows.shape
        if self.dict_dtype == "uint32":  # INT96
            return rows.view("<u4").reshape(n, -1)[idx]
        return rows[idx].copy().view(
            f"<{np.dtype(self.dict_dtype).str[1:]}").reshape(len(idx))


# ---------------------------------------------------------------------------
# staging
# ---------------------------------------------------------------------------

class _PinnedPool:
    """Pinned host buffers for staging, reused across row groups.

    A buffer handed to a ``non_blocking`` copy must stay alive and untouched
    until the copy has completed: each returned buffer carries the event
    recorded after its copy, and ``take`` waits on that event before the
    buffer is filled again.  Two buffers let the host fill row group N+1
    while the copy of N is in flight."""

    KEEP = 2

    def __init__(self):
        self._free: list = []  # [(pinned uint8 tensor, cuda event)]

    def take(self, nbytes: int) -> torch.Tensor:
        for i, (buf, ev) in enumerate(self._free):
            if buf.numel() >= nbytes:
                del self._free[i]
                ev.synchronize()  # the previous copy out of it is done
                return buf
        room = max(_bucket_bytes(nbytes, 1 << 20), nbytes)
        return torch.empty(room, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, event) -> None:
        self._free.append((buf, event))
        if len(self._free) > self.KEEP:
            self._free.sort(key=lambda e: e[0].numel())
            del self._free[0]


class _RowGroupStager:
    """One staged host->device transfer for a whole row group.

    Every chunk registers its host byte regions here (value streams, level
    streams, packed run tables, dictionaries); ``stage()`` ships ONE buffer
    and each chunk's kernels address into it by base offset.  Regions start
    on 64-byte boundaries."""

    def __init__(self):
        # ("arr", u8, base, nbytes) | ("segs", segments, base, nbytes)
        self._parts: list[tuple] = []
        self.total = 0
        self._max_read_end = 0

    def _reserve(self, nbytes: int, reserve: int | None) -> int:
        base = self.total
        room = max(reserve or 0, nbytes)
        self.total = base + room + (-(base + room)) % 64
        return base

    def add(self, arr: np.ndarray, reserve: int | None = None) -> int:
        """Register a host array; returns its byte offset in the staged
        buffer.  ``reserve`` rounds the region up (tail zero-filled)."""
        u8 = (arr.reshape(-1).view(np.uint8) if arr.dtype != np.uint8
              else arr.reshape(-1))
        base = self._reserve(u8.nbytes, reserve)
        self._parts.append(("arr", u8, base, u8.nbytes))
        return base

    def add_segments(self, segments: list[tuple[bytes, int, int]]) -> np.ndarray:
        """Register byte slices (buf, offset, size) laid back to back;
        returns each slice's absolute byte base."""
        bases = np.empty(len(segments), dtype=np.int64)
        nbytes = 0
        for i, (_, _, size) in enumerate(segments):
            bases[i] = nbytes
            nbytes += size
        base = self._reserve(nbytes, None)
        self._parts.append(("segs", segments, base, nbytes))
        return bases + base

    def note_read_extent(self, base: int, nbytes: int) -> None:
        """Declare that a kernel reads ``nbytes`` from ``base`` — possibly
        past the registered region.  ``stage()`` sizes the buffer to the
        largest declared extent: the card does not clamp a read past the
        end of a buffer."""
        self._max_read_end = max(self._max_read_end, base + nbytes)

    def size(self) -> int:
        need = max(self.total, self._max_read_end)
        return _bucket_bytes(need + _SLACK, 64)

    def fill(self, buf: np.ndarray) -> None:
        pos = 0
        for kind, payload, base, nbytes in self._parts:
            if base > pos:
                buf[pos:base] = 0
            if kind == "arr":
                buf[base : base + nbytes] = payload
            else:
                off = base
                for raw, start, size in payload:
                    buf[off : off + size] = np.frombuffer(raw, np.uint8,
                                                          size, start)
                    off += size
            pos = base + nbytes
        buf[pos:] = 0

    def stage(self, device: torch.device,
              pool: "_PinnedPool | None" = None) -> torch.Tensor:
        size = self.size()
        if device.type != "cuda":
            host = torch.empty(size, dtype=torch.uint8)
            self.fill(host.numpy())
            return host if device.type == "cpu" else host.to(device)
        pool = pool if pool is not None else _PinnedPool()
        host = pool.take(size)
        self.fill(host.numpy()[:size])
        dev = torch.empty(size, dtype=torch.uint8, device=device)
        dev.copy_(host[:size], non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        pool.give(host, ev)
        return dev


def _pack_tables(stager: _RowGroupStager, arrays) -> int:
    """Pack np arrays back to back into ONE staged region; returns its base.
    The run tables ride the row group's one transfer."""
    cat = np.concatenate([np.ascontiguousarray(a).reshape(-1).view(np.uint8)
                          for a in arrays])
    return stager.add(cat)


def _tslice(buf: torch.Tensor, base: int, off: int, n: int, dtype):
    """A packed table back out of the staged buffer (aligned by layout)."""
    nbytes = torch.empty((), dtype=dtype).element_size()
    raw = buf[base + off : base + off + n * nbytes]
    return raw if dtype == torch.uint8 else raw.view(dtype)


def _stage_array(stager: _RowGroupStager, arr: np.ndarray):
    """Register one table on its own 64-byte-aligned region; returns
    ``(base, n, torch dtype)`` for :func:`_tslice`."""
    arr = np.ascontiguousarray(arr)
    dt = torch.from_numpy(arr[:0]).dtype
    return stager.add(arr), arr.shape[0], dt


def _staged(buf: torch.Tensor, spec) -> torch.Tensor:
    base, n, dt = spec
    return _tslice(buf, base, 0, n, dt)


def _clamped(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` with the index clamped into ``t``, where the reference
    clips (a torch gather past the end raises or faults)."""
    return t[torch.clamp(idx, 0, t.shape[0] - 1).long()]


# ---------------------------------------------------------------------------
# staged device halves of the compressed-shipping routes (ship.py)
# ---------------------------------------------------------------------------

def _narrow_widen(raw, bias: int, *, dtype: str):
    """Widen ``k``-byte little-endian rows and re-bias: ``v = min +
    zero_extend(bytes)`` (the shared back half of both narrow routes).  All
    arithmetic is modular, so the reconstruction is exact for any int range
    whose *span* fits ``k`` bytes, including negative minima."""
    words = K.narrow_widen_words(raw, bias,
                                 width=4 if dtype == "int32" else 8)
    return words.view(_TORCH_DTYPES[dtype]).reshape(-1)


def _plain_narrow(buf, base: int, bias: int, *, k: int, dtype: str,
                  count: int):
    """Reconstruct a narrow-transcoded PLAIN INT column: the host shipped
    ``(v - min)`` truncated to ``k`` little-endian bytes per value."""
    raw = buf[base : base + count * k].reshape(count, k)
    return _narrow_widen(raw, bias, dtype=dtype)


def _resolve_snappy_staged(buf, tbase: int, *, n_ops: int, out_pad: int,
                           iters: int):
    """Slice the packed op tables at ``tbase`` back out of the staged buffer
    and resolve the output-space source map (``torch_kernels.
    snappy_resolve``, the shared device half of the staged chains)."""
    ends = _tslice(buf, tbase, 0, n_ops, torch.int32)
    asrc = _tslice(buf, tbase, 4 * n_ops, n_ops, torch.int32)
    offs = _tslice(buf, tbase, 8 * n_ops, n_ops, torch.int32)
    islit = _tslice(buf, tbase, 12 * n_ops, n_ops, torch.uint8)
    return K.snappy_resolve(ends, asrc, offs, islit, out_pad=out_pad,
                            iters=iters)


def _snappy_plain_staged(buf, tbase: int, *, n_ops: int, out_pad: int,
                         iters: int, dtype: str, count: int, n_pages: int):
    """Decompress snappy PLAIN pages on the device and decode their values.

    The host shipped the COMPRESSED page payloads plus tag-walk op tables;
    the source map resolves every output byte, then each value's bytes are
    gathered through it: a per-page searchsorted over ``vstart`` gives the
    value's page, ``vbase`` its output-space byte base.  Output positions
    past the real total resolve through padded literal ops and are never
    selected by a real value."""
    S = _resolve_snappy_staged(buf, tbase, n_ops=n_ops, out_pad=out_pad,
                               iters=iters)
    o = SNAPPY_OPS_BYTES * n_ops
    vbase = _tslice(buf, tbase, o, n_pages, torch.int32)
    vstart = _tslice(buf, tbase, o + 4 * n_pages, n_pages + 1, torch.int32)
    width = 8 if dtype in ("int64", "float64") else 4
    i = torch.arange(count, dtype=torch.int32, device=buf.device)
    p = torch.clamp(torch.searchsorted(vstart, i, right=True) - 1,
                    0, n_pages - 1)
    vpos = vbase[p] + (i - vstart[p]) * width
    byte_idx = (vpos[:, None] + torch.arange(
        width, dtype=torch.int32, device=buf.device)[None, :]).reshape(-1)
    bts = _clamped(buf, _clamped(S, byte_idx))
    return K.plain_decode_fixed(bts, dtype, count)


def _snappy_narrow_staged(buf, tbase: int, bias: int, *, n_ops: int,
                          out_pad: int, iters: int, k: int, dtype: str,
                          count: int):
    """The unfused narrow+snappy chain: resolve the stream's output space,
    gather the ``k``-byte rows, widen and re-bias.  Rows past the real
    count resolve through padded ops — callers slice by ``n_values``."""
    S = _resolve_snappy_staged(buf, tbase, n_ops=n_ops, out_pad=out_pad,
                               iters=iters)
    idx = torch.arange(count * k, dtype=torch.int32, device=buf.device)
    raw = _clamped(buf, _clamped(S, idx)).reshape(count, k)
    return _narrow_widen(raw, bias, dtype=dtype)


def _snappy_gather_staged(buf, tbase: int, *, n_ops: int, out_pad: int,
                          iters: int, nbytes: int):
    """Materialize the first ``nbytes`` of a snappy stream's output space
    (a dictionary's value table).  Positions past the real output resolve
    through padded literal ops; consumers never index them."""
    S = _resolve_snappy_staged(buf, tbase, n_ops=n_ops, out_pad=out_pad,
                               iters=iters)
    idx = torch.arange(nbytes, dtype=torch.int32, device=buf.device)
    return _clamped(buf, _clamped(S, idx))


def _bool_pages(buf, page_byte_base, page_val_start, *, count: int):
    """PLAIN booleans across pages: the bit position restarts at each
    page's staged byte base.  Lanes past the real count are garbage that
    callers slice off by ``n_values``."""
    i = torch.arange(count, dtype=torch.int64, device=buf.device)
    p = torch.searchsorted(page_val_start, i, right=True) - 1
    p = torch.clamp(p, 0, page_val_start.shape[0] - 1)
    bit_pos = page_byte_base[p] * 8 + (i - page_val_start[p])
    return K.extract_bits(buf, bit_pos, 1, 1) != 0


# ---------------------------------------------------------------------------
# DELTA_BINARY_PACKED pages
# ---------------------------------------------------------------------------

def _delta_pages_staged(buf, tbase: int, *, values_per_mini: int, mb: int,
                        count: int, bits: int, max_width: int, total: int,
                        n_pages: int, n_real: int, m_max: int):
    """Decode a chunk's DELTA pages from COMPACT tables staged at ``tbase``.

    The format carries one min delta and one payload position per BLOCK of
    ``mb`` miniblocks, and a block's miniblock payloads are contiguous, so
    the tables hold per-block starts and mins plus one width byte per
    miniblock (layout: firsts i64[P] | block_starts i32[P, B] | widths
    u8[P, M] | block_mins i64[P, B] (``uint64`` bits) | page_starts
    i64[P + 1], B = M / mb).  The per-miniblock starts and mins expand here:
    a within-block exclusive cumsum of the widths, and a repeat.  Only the
    ``n_real`` real pages of the ``P`` padded rows are decoded."""
    P, M = n_pages, m_max
    B = M // mb
    o = 0
    firsts = _tslice(buf, tbase, o, P, torch.int64)
    o += P * 8
    bstarts = _tslice(buf, tbase, o, P * B, torch.int32).reshape(P, B)
    o += P * B * 4
    widths = _tslice(buf, tbase, o, P * M, torch.uint8).reshape(P, M)
    o += P * M
    bmins = _tslice(buf, tbase, o, P * B, torch.int64).reshape(P, B)
    o += P * B * 8
    page_starts = _tslice(buf, tbase, o, P + 1, torch.int64)
    R = n_real
    w = widths[:R].to(torch.int64)
    bpm = (w * (values_per_mini // 8)).reshape(R, B, mb)
    excl = torch.cumsum(bpm, dim=-1) - bpm  # within-block byte offsets
    # bit starts (miniblocks are byte-aligned)
    starts = (bstarts[:R].to(torch.int64)[:, :, None] + excl).reshape(R, M) * 8
    mins = torch.repeat_interleave(bmins[:R], mb, dim=1)
    return _delta_pages(buf, firsts[:R], starts, w, mins, page_starts,
                        values_per_mini=values_per_mini, count=count,
                        bits=bits, max_width=max_width, total=total)


def _delta_pages(buf, firsts, starts, widths, mins, page_starts, *,
                 values_per_mini: int, count: int, bits: int, max_width: int,
                 total: int):
    """Decode R delta pages in one batched expression ([R, count], the
    reference's ``vmap``) and flatten them to the real per-page extents:
    ``page_starts`` holds the cumulative defined counts (the last real entry
    is the real total).  Lanes past the real total are garbage that callers
    slice off by ``n_values``."""
    vals = K.delta_reconstruct(buf, firsts, starts, widths, mins,
                               values_per_mini, count, bits, max_width)
    i = torch.arange(total, dtype=torch.int64, device=buf.device)
    p = torch.searchsorted(page_starts, i, right=True) - 1
    p = torch.clamp(p, 0, vals.shape[0] - 1)
    within = torch.clamp(i - page_starts[p], 0, count - 1)
    return vals[p, within]


# ---------------------------------------------------------------------------
# BYTE_ARRAY value streams: lengths -> offsets -> heap compaction
# ---------------------------------------------------------------------------

def _bytes_heap_src(buf, lens_base: int, page_base, page_val_start, *,
                    count_pad: int, heap_pad: int):
    """Shared front half of the BYTE_ARRAY routes: the staged ``uint32``
    lengths -> offsets, and each heap byte's source position in PAGE-STREAM
    coordinates:

      offsets  = cumsum(lens)                               (int64[count+1])
      value r of heap byte j by a scatter of value ends + cumsum
      src[j]   = page_base[p] + (data bytes before r in its page)
                 + 4 * (prefixes up to and including r) + (byte j within r)

    which is ``page_base[p] - offsets[first value of p] + 4 * (r - first +
    1) + j``: a per-value constant plus ``j``, so each heap byte costs one
    gather.  ``page_base`` is in staged-buffer coordinates on the plain
    route and in OUTPUT-SPACE coordinates on the compressed routes (the
    caller picks the last indirection).  Gathers are clamped where the
    reference clamps.  Returns (offsets, src)."""
    dev = buf.device
    lens = buf[lens_base : lens_base + count_pad * 4].view(torch.int32)
    offsets = torch.cat([
        torch.zeros(1, dtype=torch.int64, device=dev),
        torch.cumsum(lens.to(torch.int64) & 0xFFFFFFFF, 0)])
    ends = torch.clamp(offsets[1:], 0, heap_pad)
    # several values end on one byte when lengths are zero: an add, not a set
    marks = torch.zeros(heap_pad + 1, dtype=torch.int32, device=dev)
    marks.index_add_(0, ends, torch.ones(count_pad, dtype=torch.int32,
                                         device=dev))
    r = torch.cumsum(marks[:heap_pad], 0).clamp_(0, count_pad - 1)
    del marks
    v = torch.arange(count_pad, dtype=torch.int64, device=dev)
    pvs_all = page_val_start.to(torch.int64)
    p = torch.searchsorted(pvs_all, v, right=True) - 1
    p = torch.clamp(p, 0, page_base.shape[0] - 1)
    pvs = pvs_all[p]
    per_value = page_base[p] - offsets[pvs] + 4 * (v - pvs + 1)
    src = per_value[r]
    del r
    src += torch.arange(heap_pad, dtype=torch.int64, device=dev)
    return offsets, src


def _plain_bytes_pages(buf, lens_base: int, page_byte_base, page_val_start,
                       *, count_pad: int, heap_pad: int):
    """PLAIN BYTE_ARRAY decode on the device: lengths -> offsets -> heap.

    The host walked only the ``u32`` length prefixes (native
    ``bytearray_lengths``, no copies) and staged the RAW value streams plus
    the lengths (zero past the real count, so pad values are empty); here
    the offsets are one cumsum and the heap compaction one gather
    (:func:`_bytes_heap_src`).  ``page_val_start`` int32[P+1] cumulative
    value counts, ``page_byte_base`` int64[P] each page stream's staged
    base.  Returns (offsets int64[count_pad+1], heap uint8[heap_pad]);
    callers slice by the real counts."""
    offsets, src = _bytes_heap_src(
        buf, lens_base, page_byte_base, page_val_start,
        count_pad=count_pad, heap_pad=heap_pad)
    return offsets, buf[src.clamp_(0, buf.shape[0] - 1)]


def _plain_bytes_staged(buf, lens_base: int, tbase: int, *, count_pad: int,
                        heap_pad: int, n_pages: int):
    """:func:`_plain_bytes_pages` with the page tables read from the staged
    buffer (layout: page_byte_base i64[P] | page_val_start i32[P+1])."""
    page_byte_base = _tslice(buf, tbase, 0, n_pages, torch.int64)
    page_val_start = _tslice(buf, tbase, n_pages * 8, n_pages + 1,
                             torch.int32)
    return _plain_bytes_pages(buf, lens_base, page_byte_base, page_val_start,
                              count_pad=count_pad, heap_pad=heap_pad)


def _snappy_bytes_staged(buf, lens_base: int, tbase: int, *, count_pad: int,
                         heap_pad: int, n_ops: int, out_pad: int, iters: int,
                         n_pages: int):
    """BYTE_ARRAY heap compaction with the value streams shipped COMPRESSED
    (``device_snappy`` / ``recompress``): as :func:`_plain_bytes_pages`,
    except that each heap byte's page-stream position is an OUTPUT-SPACE
    coordinate resolved through the snappy source map — one more gather.

    Layout at ``tbase``: op tables (``SNAPPY_OPS_BYTES * n_ops``) |
    page_out_base i64[P] | page_val_start i32[P+1]."""
    S = _resolve_snappy_staged(buf, tbase, n_ops=n_ops, out_pad=out_pad,
                               iters=iters)
    o = SNAPPY_OPS_BYTES * n_ops
    page_out = _tslice(buf, tbase, o, n_pages, torch.int64)
    pvs = _tslice(buf, tbase, o + 8 * n_pages, n_pages + 1, torch.int32)
    offsets, src = _bytes_heap_src(buf, lens_base, page_out, pvs,
                                   count_pad=count_pad, heap_pad=heap_pad)
    return offsets, _clamped(buf, S[src.clamp_(0, out_pad - 1)])


# ---------------------------------------------------------------------------
# the hybrid (RLE/bit-packed) path through K1
# ---------------------------------------------------------------------------

# BP payloads are staged as one host-side segment copy per bit-packed run;
# streams shattered into very many tiny runs keep the run-table expand path,
# whose staging is one segment per page (the reference's decline).
_PALLAS_MAX_SEGS = 4096


def _plan_hybrid_pallas(stager: _RowGroupStager, pages_info, width: int,
                        total: int, count_pad: int):
    """Plan a hybrid expansion through the fused K1 (unpack + run-table
    combine, ``cuda_kernels.hybrid_unpack_combine``).

    ``pages_info``: [(HybridMeta, source_buffer, page_value_count)] in
    stream order.  Registers each bit-packed run's payload with the stager
    so the staged buffer holds ALL BP groups contiguously (RLE values never
    ship — they live in the run table), then returns a ``_Plan`` producing
    ``int32[count_pad]`` (uint32 bits).  Returns None when the stream has no
    K1-eligible shape (width 0, no BP groups, a pathological run count, or
    an int32 overflow of the combine's index math) — callers then take the
    run-table expand path, exactly as the reference declines."""
    if width <= 0 or width > 32 or total > _I32_MAX:
        return None
    ks = np.array([m.n_runs for m, _, _ in pages_info], dtype=np.int64)
    nr = int(ks.sum())
    if nr == 0:
        return None
    ends_c = np.concatenate([m.run_ends[: m.n_runs] for m, _, _ in pages_info])
    isr = np.concatenate([m.run_is_rle[: m.n_runs] for m, _, _ in pages_info])
    rvals = np.concatenate([m.run_values[: m.n_runs] for m, _, _ in pages_info])
    bst = np.concatenate(
        [m.run_bit_starts[: m.n_runs] for m, _, _ in pages_info]
    )
    run_page_start = np.repeat(np.cumsum(ks) - ks, ks)  # first run idx of page
    page_of = np.repeat(np.arange(len(ks)), ks)
    pcounts = np.array([c for _, _, c in pages_info], dtype=np.int64)
    prefix = np.concatenate([[0], np.cumsum(pcounts)[:-1]])
    # within-page run start = previous run's end (0 for a page's first run)
    rstart = np.empty(nr, np.int64)
    rstart[0] = 0
    rstart[1:] = ends_c[:-1]
    first = np.arange(nr) == run_page_start
    rstart[first] = 0
    # payload byte position in src coords: run_bit_starts stores
    # pos*8 - run_start*width (see parse_hybrid_meta)
    pay = (bst + rstart * width) >> 3
    groups = np.where(isr, 0, -(-(ends_c - rstart) // 8))
    sel = np.flatnonzero(groups > 0)
    if len(sel) > _PALLAS_MAX_SEGS or not len(sel):
        return None
    cumg = int(groups.sum())
    gbase = np.cumsum(groups) - groups  # exclusive prefix (global group base)
    ends = (ends_c + prefix[page_of]).astype(np.int32)
    bib = np.where(isr, 0,
                   gbase * 8 - (rstart + prefix[page_of])).astype(np.int32)
    srcs = [s for _, s, _ in pages_info]
    segs = [(srcs[p], int(b), int(g) * width)
            for p, b, g in zip(page_of[sel], pay[sel], groups[sel])]
    rp = _bucket(max(nr, 1))
    if rp > nr:
        pad = rp - nr
        ends = np.concatenate([ends, np.full(pad, total, np.int32)])
        isr = np.concatenate([isr, np.zeros(pad, bool)])
        rvals = np.concatenate([rvals, np.zeros(pad, np.uint32)])
        bib = np.concatenate([bib, np.zeros(pad, np.int32)])
    gpad = bp_groups_pad(cumg)
    if stager.total + gpad * width > _I32_MAX:
        # the reference's kernel addresses the arena with int32; declined
        # the same way so route choices match (checked before ANY stager
        # mutation so the fallback leaves no dead bytes)
        return None
    tbase = _pack_tables(stager, [ends, isr.astype(np.uint8), rvals, bib])
    bases = stager.add_segments(segs)
    bp_base = int(bases[0])
    # K1 may read gpad*width bytes from bp_base: past the real payload it
    # sees later regions' bytes — values the combine never selects
    stager.note_read_extent(bp_base, gpad * width)
    fn = functools.partial(hybrid_unpack_combine, width=width, gpad=gpad,
                           count=count_pad, rp=rp)
    return _Plan(fn, (bp_base, tbase, total), None)


def _merge_run_tables(ends_l, rle_l, vals_l, starts_l, fill_end,
                      widths_l=None):
    """Pad per-page hybrid run lists into one bucketed chunk-global table.

    Padding slots get ``run_ends = fill_end`` (so searchsorted clamps past
    the real runs) and zeros elsewhere.  Values and widths come back as
    int64 (the tensor code's word type)."""
    rp = _bucket(max(sum(len(e) for e in ends_l), 1))
    ends = np.full(rp, fill_end, dtype=np.int64)
    is_rle = np.zeros(rp, dtype=bool)
    rvals = np.zeros(rp, dtype=np.int64)
    starts = np.zeros(rp, dtype=np.int64)
    rwidths = np.zeros(rp, dtype=np.int64) if widths_l is not None else None
    k = 0
    for i, e in enumerate(ends_l):
        ends[k : k + len(e)] = e
        is_rle[k : k + len(e)] = rle_l[i]
        rvals[k : k + len(e)] = vals_l[i]
        starts[k : k + len(e)] = starts_l[i]
        if rwidths is not None:
            rwidths[k : k + len(e)] = widths_l[i]
        k += len(e)
    if rwidths is not None:
        return ends, is_rle, rvals, starts, rwidths
    return ends, is_rle, rvals, starts


# ---------------------------------------------------------------------------
# compressed shipping: the host half shared by the snappy routes
# ---------------------------------------------------------------------------

class _SnappyShipInfo:
    """Padded shapes + staged table base of one planned compressed
    shipment."""

    __slots__ = ("tbase", "n_ops", "out_pad", "iters", "shipped")

    def __init__(self, tbase, n_ops, out_pad, iters, shipped):
        self.tbase = tbase
        self.n_ops = n_ops
        self.out_pad = out_pad
        self.iters = iters
        self.shipped = shipped


def _plan_snappy_ops(stager: _RowGroupStager, specs, extra_tables=()):
    """Register snappy/raw payloads and pack the op tables the device
    resolver (``torch_kernels.snappy_resolve``) consumes — the shared host
    half of the staged compressed-shipping routes.

    ``specs``: per stream, ``('comp', payload, out_len[, plan])`` — a
    raw-snappy payload whose uncompressed length is ``out_len`` (``plan``
    optionally carries a pre-run ``native.snappy_plan`` result) — or
    ``('raw', buf, pos, out_len)`` — host bytes shipped as one synthetic
    literal op.  Output spaces concatenate in spec order.  ``extra_tables``
    pack behind the op tables at the same ``tbase`` (consumers slice them at
    ``SNAPPY_OPS_BYTES * n_ops_pad``).

    Returns ``_SnappyShipInfo`` or None when infeasible (native library
    absent, stream rejected by the tag walk, op-table cap, i32 arena
    ceiling).  Infeasibility leaves the stager UNTOUCHED, so callers fall
    through to another route with no dead staged bytes."""
    if not native.available():
        return None
    plans = []
    n_ops_total = 0
    total_out = 0
    for spec in specs:
        if spec[0] == "comp":
            payload, out_len = spec[1], spec[2]
            r = spec[3] if len(spec) > 3 and spec[3] is not None else (
                native.snappy_plan(payload, out_len))
            if r is None or isinstance(r, int):
                return None
            plans.append((spec, r, out_len))
            n_ops_total += len(r[0])
        else:
            out_len = spec[3]
            plans.append((spec, None, out_len))
            n_ops_total += 1
        total_out += out_len
    if n_ops_total == 0 or n_ops_total > _SNAPPY_MAX_OPS:
        return None
    out_pad = _bucket_bytes(total_out + 8, 8)
    segs = [
        (spec[1], 0, len(spec[1])) if r is not None
        else (spec[1], spec[2], out_len)
        for spec, r, out_len in plans
    ]
    shipped = sum(s[2] for s in segs)
    n_ops_pad = _bucket(n_ops_total)
    extra_bytes = sum(np.ascontiguousarray(t).nbytes for t in extra_tables)
    if (stager.total + shipped + SNAPPY_OPS_BYTES * n_ops_pad + extra_bytes
            + out_pad > (_I32_MAX >> 1)):
        return None  # i32 source/table math would overflow
    bases = stager.add_segments(segs)
    ends = np.empty(n_ops_total, np.int64)
    asrc = np.empty(n_ops_total, np.int64)
    offs = np.zeros(n_ops_total, np.int32)
    islit = np.empty(n_ops_total, np.uint8)
    at = 0
    out_base = 0
    max_depth = 0
    for (spec, r, out_len), base in zip(plans, bases):
        if r is None:
            ends[at] = out_base + out_len
            asrc[at] = base
            islit[at] = 1
            at += 1
        else:
            dst_end, op_src, is_lit_p, depth = r
            n = len(dst_end)
            if n:
                ends[at : at + n] = dst_end + out_base
                # literal: absolute staged position of the run's payload;
                # copy: output-space source base  dst_start - offset
                starts = np.empty(n, np.int64)
                starts[0] = 0
                starts[1:] = dst_end[:-1]
                asrc[at : at + n] = np.where(
                    is_lit_p != 0, op_src + base,
                    out_base + starts - op_src,
                )
                offs[at : at + n] = np.where(is_lit_p != 0, 1, op_src)
                islit[at : at + n] = is_lit_p
                at += n
                max_depth = max(max_depth, depth)
        out_base += out_len
    assert at == n_ops_total, (at, n_ops_total)
    iters = next(
        (b for b in _SNAPPY_ITER_BUCKETS
         if (1 << b) >= max_depth + 1), _SNAPPY_ITER_BUCKETS[-1]
    ) if max_depth > 0 else 0
    ends_t = np.full(n_ops_pad, out_pad, np.int32)
    ends_t[:n_ops_total] = ends
    asrc_t = np.zeros(n_ops_pad, np.int32)
    asrc_t[:n_ops_total] = asrc
    offs_t = np.ones(n_ops_pad, np.int32)
    offs_t[:n_ops_total] = offs
    islit_t = np.ones(n_ops_pad, np.uint8)
    islit_t[:n_ops_total] = islit
    tbase = _pack_tables(
        stager, [ends_t, asrc_t, offs_t, islit_t, *extra_tables]
    )
    return _SnappyShipInfo(tbase, n_ops_pad, out_pad, iters, shipped)


def _fixed_value_tables(sizes, counts):
    """Bucket-padded (vbase, vstart) page tables for the fixed-width snappy
    routes: per-page OUT-SPACE byte bases (exclusive cumsum of ``sizes``)
    and cumulative defined ``counts``.  Layout twin of what
    ``_snappy_plain_staged`` slices back out.  Returns
    (vbase_t, vstart_t, pages_pad, defined)."""
    out_bases = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    vstart = np.concatenate([[0], np.cumsum(counts)])
    pages_pad = _bucket(len(sizes))
    vbase_t = np.zeros(pages_pad, np.int32)
    vbase_t[: len(sizes)] = out_bases
    vstart_t = np.full(pages_pad + 1, vstart[-1], np.int32)
    vstart_t[: len(sizes) + 1] = vstart
    return vbase_t, vstart_t, pages_pad, int(vstart[-1])


def _fused_narrow_tables(comp, out_len: int):
    """K3's op tables for one snappy stream of ``out_len`` output bytes:
    ``([ends, asrc, offs, islit], depth, n_ops_pad, out_pad, ppad)``, the
    tables padded to ``n_ops_pad`` rows with literal sources
    PAYLOAD-relative (the staged chain's are absolute).  None when the
    stream is over one of K3's caps (FUSED_MAX_PAYLOAD, FUSED_MAX_DEPTH,
    FUSED_MAX_OPS) or the tag walk rejects it — the reference's declines."""
    if len(comp) > FUSED_MAX_PAYLOAD:
        return None
    r = native.snappy_plan(comp, out_len)
    if r is None or isinstance(r, int):
        return None
    dst_end, op_src, is_lit, depth = r
    n_ops = len(dst_end)
    if n_ops == 0 or depth > FUSED_MAX_DEPTH:
        return None
    n_ops_pad = _bucket(n_ops)
    if n_ops_pad > FUSED_MAX_OPS:
        return None
    out_pad = _bucket_bytes(out_len + 8, 8)
    ppad = _bucket_bytes(max(len(comp), 1), 64)
    ends_t = np.full(n_ops_pad, out_pad, np.int32)
    ends_t[:n_ops] = dst_end
    starts = np.empty(n_ops, np.int64)
    starts[0] = 0
    starts[1:] = dst_end[:-1]
    asrc_t = np.zeros(n_ops_pad, np.int32)
    asrc_t[:n_ops] = np.where(is_lit != 0, op_src, starts - op_src)
    offs_t = np.ones(n_ops_pad, np.int32)
    offs_t[:n_ops] = np.where(is_lit != 0, 1, op_src)
    islit_t = np.ones(n_ops_pad, np.uint8)
    islit_t[:n_ops] = is_lit
    return ([ends_t, asrc_t, offs_t, islit_t], int(depth), n_ops_pad,
            out_pad, ppad)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

class _Plan:
    """A planned device computation: ``fn(buf_dev, *dyn)`` launches the
    chunk's decode over the staged buffer (``dyn`` holds its byte bases and
    counts), then ``build(result)`` makes the column on the host side.
    Sub-plans that a column's plan composes (index and level streams)
    carry ``build=None``."""

    __slots__ = ("fn", "dyn", "build")

    def __init__(self, fn, dyn, build):
        self.fn = fn
        self.dyn = tuple(dyn)
        self.build = build


def _run_plans(plans, buf_dev):
    """Execute ``[(name, _Plan)]`` against the staged buffer; every launch
    is asynchronous on the current stream."""
    return {name: p.build(p.fn(buf_dev, *p.dyn)) for name, p in plans}


def _compose_column(value_plan: "_Plan", d_plan) -> "_Plan":
    """Fuse a chunk's value plan with its def-level plan into one _Plan
    producing the finished DeviceColumnData."""
    if d_plan is None:
        return value_plan
    nv = len(value_plan.dyn)
    v_fn, d_fn = value_plan.fn, d_plan.fn

    def fn(buf, *dyn):
        return (v_fn(buf, *dyn[:nv]), d_fn(buf, *dyn[nv:]))

    def build(res):
        vres, dres = res
        col = value_plan.build(vres)
        col.def_levels = dres
        return col

    return _Plan(fn, value_plan.dyn + d_plan.dyn, build)


def _fused_words_cast(words: torch.Tensor, dtype: str) -> torch.Tensor:
    """Finished little-endian u32 words from K2 -> the value tensor (a view;
    DOUBLE becomes float64)."""
    return words.view(_TORCH_DTYPES[dtype]).reshape(-1)


class _ChunkAssembler:
    """Collects a chunk's pages, then emits one device decode plan."""

    def __init__(self, leaf: SchemaNode, deferred_checks: list,
                 device: "torch.device | None" = None):
        self.leaf = leaf
        # where the host-decode path (_finish_host) puts its tensors; the
        # batched plans run on the staged buffer's device
        self.device = torch.device("cpu") if device is None else device
        self.pages: list[ParsedDataPage] = []
        self.dict_u8: Optional[np.ndarray] = None
        self.dict_dtype: Optional[str] = None
        self.dict_ragged: Optional[ByteArrayData] = None
        self.dict_len = 0
        self._deferred = deferred_checks  # (device max, dict_len, path)
        # the dictionary page's snappy payload: (payload, ulen)
        self.dict_comp: "tuple | None" = None
        # chunk Statistics (min, max) of an INT column: the narrow hint
        self.stats_span: "tuple | None" = None
        self._ship_pref: "list | None" = None
        # host artifacts preship built, by route family; failed host work
        # is memoized as None so no plan function repeats it
        self._ship: dict = {}
        self._dict_ship: "tuple | None" = None  # (route, payload, out_len)
        # PLAIN BYTE_ARRAY length walk from preship: (lens_l, span_l)
        self._bytes_walk: "tuple | None" = None
        # pages whose compressed payload shipped (device-side expansion)
        self.pages_kept_compressed = 0
        # fused routes that degraded to their unfused twin (kernel caps,
        # level lanes, i32 ceilings) — a counter, never a crash
        self.fused_fallbacks = 0
        self.ship_records: list = []

    def _record_ship(self, route: str, logical: int, shipped: int) -> None:
        self.ship_records.append((route, int(logical), int(shipped)))

    def _route_enabled(self, route: str) -> bool:
        """Whether the planner ranked ``route`` ahead of the plain tail
        (True when preship planned nothing)."""
        if self._ship_pref is None:
            return True
        for r in self._ship_pref:
            if r == route:
                return True
            if r == ROUTE_PLAIN:
                return False
        return False

    # -- dictionary ----------------------------------------------------------

    def set_dictionary(self, raw: bytes, encoding: int, count: int) -> None:
        decoded = host_decode_dictionary(raw, self.leaf, encoding, count)
        if isinstance(decoded, ByteArrayData):
            self.dict_ragged = decoded
            self.dict_len = len(decoded)
        else:
            self.dict_u8, self.dict_dtype, self.dict_len = decoded

    # -- ship planning (host half; see ship.py) -------------------------------

    def _try_snappy(self, stream):
        """snappy over one host stream; returns the payload only when it
        beats SNAPPY_WORTH_RATIO — thin wins lose to the op tables and the
        device resolve."""
        if not native.available():
            return None
        nbytes = len(stream) if isinstance(stream, (bytes, bytearray)) \
            else stream.nbytes
        if nbytes == 0:
            return None
        comp = native.snappy_compress(stream)
        if len(comp) > SNAPPY_WORTH_RATIO * nbytes:
            return None
        return comp

    def _recompress_streams(self, streams):
        """Link recompression (ROUTE_RECOMPRESS): snappy over each page's
        value stream.  ``streams``: [(buf, pos, size)].  Returns the
        per-page payloads, or None when the whole chunk didn't compress
        past SNAPPY_WORTH_RATIO."""
        if not native.available():
            return None
        total = sum(s[2] for s in streams)
        if total == 0:
            return None
        payloads = [native.snappy_compress(np.frombuffer(buf, np.uint8,
                                                         size, pos))
                    for buf, pos, size in streams]
        if sum(len(c) for c in payloads) > SNAPPY_WORTH_RATIO * total:
            return None
        return payloads

    def _narrow_host_transcode(self, width: int):
        """Host half of the narrow routes: span probe, exact min/max, and
        the k-byte truncating transcode into one dense buffer.  Returns
        (k, min, uint8 buffer) or None when the span is too wide (full-range
        data pays only a 64k-value probe).  Pages are peeked, not
        materialized, so a later route can still ship the file's compressed
        payload."""
        if not native.available():
            return None
        max_k = _narrow_max_k(width)
        defined = sum(p.defined for p in self.pages)
        if defined == 0:
            return None
        for p in self.pages:
            p.peek()
        if any(len(p.raw) - p.value_pos < p.defined * width
               for p in self.pages):
            return None  # truncated: the plain path raises with diagnostics
        probe = next(p for p in self.pages if p.defined)
        head = native.int_minmax(
            probe.raw, probe.value_pos, min(probe.defined, _NARROW_PROBE),
            width,
        )
        if _span_bytes(*head) > max_k:
            return None
        mms = [native.int_minmax(p.raw, p.value_pos, p.defined, width)
               for p in self.pages if p.defined]
        mn = min(m[0] for m in mms)
        mx = max(m[1] for m in mms)
        k = _span_bytes(mn, mx)
        if k > max_k:
            return None
        # one truncating pass per page into a single dense buffer:
        # (v - min) mod 2^width fits k bytes by construction
        out = np.empty(defined * k, dtype=np.uint8)
        at = 0
        for p in self.pages:
            native.int_truncate(p.raw, p.value_pos, p.defined, width, mn, k,
                                out[at:])
            at += p.defined * k
        return k, mn, out

    def preship(self, planner: ShipPlanner) -> None:
        """Route choice + link-byte host work for this chunk (ship.py):
        stores the ordered route preference plus any host-built artifacts;
        ``finish`` executes the routes in order, falling through on
        infeasibility."""
        self._preship_dict(planner)
        if not self.pages:
            return
        if {parse_encoding(p.encoding) for p in self.pages} != {Encoding.PLAIN}:
            return
        if self.leaf.physical_type in _PTYPE_TO_NAME:
            self._preship_fixed(planner)
        elif self.leaf.physical_type == Type.BYTE_ARRAY:
            self._preship_bytes(planner)

    def _preship_fixed(self, planner: ShipPlanner) -> None:
        leaf = self.leaf
        name = _PTYPE_TO_NAME[leaf.physical_type]
        width = np.dtype(name).itemsize
        defined = sum(p.defined for p in self.pages)
        comp_bytes = sum(len(p.comp[0]) for p in self.pages
                         if p.comp is not None)
        is_int = leaf.physical_type in (Type.INT32, Type.INT64)
        narrow_k = 0
        if is_int and self.stats_span is not None:
            k = _span_bytes(*self.stats_span)
            if k <= _narrow_max_k(width):
                narrow_k = k
        facts = ChunkFacts(
            logical=defined * width, width=width, narrow_k=narrow_k,
            narrow_possible=is_int and native.available(),
            comp_bytes=comp_bytes, native=native.available(),
            flat=leaf.max_def == 0 and leaf.max_rep == 0,
        )
        self._ship_pref = planner.routes(facts)
        for route in self._ship_pref:
            if route in (ROUTE_NARROW, ROUTE_NARROW_SNAPPY,
                         ROUTE_FUSED_NARROW_SNAPPY):
                if not is_int or defined == 0:
                    continue
                if "narrow" in self._ship:  # an earlier entry failed
                    continue
                art = self._narrow_host_transcode(width)
                if art is None:
                    self._ship["narrow"] = None
                    continue
                k, mn, out = art
                comp = (self._try_snappy(out)
                        if route in (ROUTE_NARROW_SNAPPY,
                                     ROUTE_FUSED_NARROW_SNAPPY) else None)
                self._ship["narrow"] = (k, mn, out, comp)
                return
            if route == ROUTE_DEVICE_SNAPPY:
                if comp_bytes:
                    return  # planned at finish (needs the stager)
                continue
            if route == ROUTE_RECOMPRESS:
                if comp_bytes or defined == 0:
                    continue
                if any(len(p.raw) - p.value_pos < p.defined * width
                       for p in self.pages):
                    continue  # truncated: plain path raises diagnostics
                payloads = self._recompress_streams(
                    [(p.raw, p.value_pos, p.defined * width)
                     for p in self.pages])
                self._ship["recompress"] = payloads
                if payloads is None:
                    continue
                return
            if route in (ROUTE_PLAIN, ROUTE_FUSED_PLAIN):
                return  # no host artifacts to prepare for either

    def _preship_bytes(self, planner: ShipPlanner) -> None:
        """PLAIN BYTE_ARRAY: walk the length prefixes (native, no copies),
        rank the routes on the walked span, and snappy-compress the spans
        when ``recompress`` leads.  Returns without a plan when a walk
        fails: ``finish`` walks again and raises (or takes the host path)
        with the diagnostics."""
        if not native.available():
            return
        lens_l, span_l = [], []
        for p in self.pages:
            p.peek()
            res = native.bytearray_lengths(p.raw, p.defined, pos=p.value_pos)
            if res is None or isinstance(res, int):
                return
            lens, end = res
            lens_l.append(lens)
            span_l.append(end - p.value_pos)
        self._bytes_walk = (lens_l, span_l)
        logical = sum(span_l)
        comp_bytes = sum(len(p.comp[0]) for p in self.pages
                         if p.comp is not None)
        facts = ChunkFacts(logical=logical, width=0, comp_bytes=comp_bytes,
                           native=True)
        self._ship_pref = planner.routes(facts)
        for route in self._ship_pref:
            if route == ROUTE_DEVICE_SNAPPY:
                if comp_bytes:
                    return  # planned at finish
                continue
            if route == ROUTE_RECOMPRESS:
                if comp_bytes or logical == 0:
                    continue
                payloads = self._recompress_streams(
                    [(p.raw, p.value_pos, s)
                     for p, s in zip(self.pages, span_l)])
                # a failure is memoized (None): finish does not compress
                # again
                self._ship["recompress_bytes"] = payloads
                if payloads is None:
                    continue
                return
            if route == ROUTE_PLAIN:
                return

    def _preship_dict(self, planner: ShipPlanner) -> None:
        """Dictionary VALUE TABLE shipping: a fixed-width dictionary whose
        snappy page payload is exactly the rows keeps that payload;
        otherwise the table (for a ragged dictionary, its heap) may
        recompress.  Only the link bytes change."""
        if self.dict_len == 0:
            return
        if self.dict_u8 is not None:
            src = self.dict_u8
        elif self.dict_ragged is not None:
            src = self.dict_ragged.heap
        else:
            return
        nbytes = src.nbytes
        # the snappy page payload covers the rows only for fixed-width
        # dictionaries (a ragged payload interleaves u32 length prefixes)
        comp0 = None
        if (self.dict_u8 is not None and self.dict_comp is not None
                and self.dict_comp[1] >= nbytes):
            comp0 = self.dict_comp
        facts = ChunkFacts(
            logical=nbytes, width=0,
            comp_bytes=len(comp0[0]) if comp0 is not None else 0,
            native=native.available(),
            host_bytes_ready=True,  # dict pages always decompress on host
        )
        for route in planner.routes(facts):
            if route == ROUTE_DEVICE_SNAPPY and comp0 is not None:
                self._dict_ship = (route, comp0[0], comp0[1])
                return
            if route == ROUTE_RECOMPRESS and comp0 is None:
                # as in the reference, a fixed-width table goes to
                # snappy_compress 2-D, which takes len() — the row count —
                # as its byte count; the payload then fails the tag walk at
                # finish and the table ships plain, unrecorded (kept for
                # route parity; ROADMAP)
                comp = self._try_snappy(np.ascontiguousarray(src))
                if comp is None:
                    continue
                self._dict_ship = (route, comp, nbytes)
                return
            if route == ROUTE_PLAIN:
                return

    # -- finish: the device plan ----------------------------------------------

    def finish(self, stager: _RowGroupStager) -> _Plan:
        """Host phase: parse structure, register bytes with the stager, and
        return the chunk's ``_Plan``."""
        leaf = self.leaf
        slots = sum(p.num_values for p in self.pages)
        encs = {parse_encoding(p.encoding) for p in self.pages}
        encs = {
            Encoding.RLE_DICTIONARY if e == Encoding.PLAIN_DICTIONARY else e
            for e in encs
        }
        # lazily-compressed pages are consumed only by the PLAIN routes of
        # fixed-width numbers and BYTE_ARRAY; every other path (BOOLEAN,
        # INT96 and FLBA rows included) gets host bytes
        lazy_ok = encs == {Encoding.PLAIN} and (
            leaf.physical_type in _PTYPE_TO_NAME
            or leaf.physical_type == Type.BYTE_ARRAY
        )
        if any(p.comp is not None for p in self.pages) and not lazy_ok:
            for p in self.pages:
                p.materialize()
        slots_pad = _bucket_count(slots)
        d_plan = None
        if leaf.max_def > 0:
            d_plan = self._plan_levels(
                stager, [p.def_stream for p in self.pages],
                bitpack.bit_width(leaf.max_def), slots, slots_pad,
                metas=[p.def_meta for p in self.pages],
            )
        common = dict(
            max_def=leaf.max_def, max_rep=leaf.max_rep, num_leaf_slots=slots,
            value_dtype=(
                "float64" if leaf.physical_type == Type.DOUBLE else None
            ),
        )
        ptype = leaf.physical_type
        if len(encs) == 1:
            enc = next(iter(encs))
            if enc == Encoding.RLE_DICTIONARY:
                value_plan = self._finish_dict(common, stager)
            elif enc == Encoding.PLAIN and ptype in _PTYPE_TO_NAME:
                value_plan = self._finish_plain_fixed(common, stager)
            elif enc == Encoding.PLAIN and ptype == Type.BOOLEAN:
                value_plan = self._finish_plain_bool(common, stager)
            elif enc == Encoding.PLAIN and ptype == Type.BYTE_ARRAY:
                value_plan = self._finish_plain_bytes(common, stager)
            elif enc == Encoding.PLAIN and ptype == Type.INT96:
                value_plan = self._finish_plain_rows(common, stager, 12)
            elif (enc == Encoding.PLAIN
                  and ptype == Type.FIXED_LEN_BYTE_ARRAY
                  and (leaf.type_length or 0) > 0):
                value_plan = self._finish_plain_rows(
                    common, stager, leaf.type_length, flba=True)
            elif enc == Encoding.DELTA_BINARY_PACKED:
                value_plan = self._finish_delta(common, stager)
            else:
                value_plan = self._finish_host(common)
        elif (encs == {Encoding.RLE_DICTIONARY, Encoding.PLAIN}
              and ptype in _PTYPE_TO_NAME and self.dict_u8 is not None):
            # the dictionary fallback: a dictionary-encoded prefix of
            # pages, then PLAIN pages once the dictionary outgrew its limit
            value_plan = self._finish_mixed_dict_plain(common, stager)
        else:
            # other mixes, BSS, delta byte arrays, boolean RLE: host decode
            # page by page
            value_plan = self._finish_host(common)
        # every plan has captured what it needs: drop the parsed pages
        self.pages = []
        return _compose_column(value_plan, d_plan)

    def _plan_levels(self, stager: _RowGroupStager, streams, width: int,
                     slots: int, slots_pad: int, metas=None):
        """Stage the pages' raw RLE level streams and expand them on the
        device: through the fused K1 where the stream has bit-packed runs,
        else the run-table expand.  The plan yields ``int32[slots_pad]``
        (tail past ``slots`` zeroed)."""
        if metas is None:
            metas = [None] * len(self.pages)
        if any(s is None for s in streams):
            raise ParquetError(
                "internal: level stream span missing on the batched path"
            )
        metas = [
            m if m is not None else parse_hybrid_meta(
                src, width, p.num_values, pos=start, end=start + size
            )
            for (src, start, size), p, m in zip(streams, self.pages, metas)
        ]
        plan = _plan_hybrid_pallas(
            stager,
            [(m, src, p.num_values)
             for (src, _, _), p, m in zip(streams, self.pages, metas)],
            width, slots, slots_pad,
        )
        if plan is not None:
            return plan
        bases = stager.add_segments(list(streams))
        ends_l, rle_l, vals_l, starts_l = [], [], [], []
        prefix = 0
        for (src, start, size), base, p, meta in zip(streams, bases,
                                                     self.pages, metas):
            n = meta.n_runs
            ends_l.append(meta.run_ends[:n] + prefix)
            rle_l.append(meta.run_is_rle[:n])
            vals_l.append(meta.run_values[:n])
            # source byte b lands at staged (b - start + base); rebase bit
            # starts for the copy and for the global value position
            starts_l.append(
                meta.run_bit_starts[:n] + (int(base) - start) * 8
                - prefix * width
            )
            prefix += p.num_values
        tables = [_stage_array(stager, t) for t in _merge_run_tables(
            ends_l, rle_l, vals_l, starts_l, fill_end=slots)]

        def fn(buf, *specs):
            e, r, v, s = (_staged(buf, t) for t in specs)
            return _hybrid(buf, e, r != 0, v, s, slots, width=width,
                           count=slots_pad)

        return _Plan(fn, tables, None)

    def _stage_fixed_width(self, stager, width: int):
        """Register exactly the pages' value bytes back-to-back for a
        ``width``-bytes-per-value PLAIN stream.  Returns (base, defined,
        count): the decode reads the bucketed ``count`` values, past the
        segments into whatever follows (covered by note_read_extent)."""
        defined = sum(p.defined for p in self.pages)
        _check_plain_sizes(self.pages, width)
        segs = [(p.raw, p.value_pos, p.defined * width) for p in self.pages]
        base = (int(stager.add_segments(segs)[0]) if segs
                else stager._reserve(0, None))
        count = _bucket_count(defined)
        stager.note_read_extent(base, count * width)
        return base, defined, count

    def _finish_plain_fixed(self, common, stager):
        """PLAIN fixed-width: execute the ship planner's route preference in
        order (ship.py), falling through on infeasibility; the ``plain``
        tail cannot fail."""
        name = _PTYPE_TO_NAME[self.leaf.physical_type]
        for route in self._ship_pref:
            plan = None
            if route == ROUTE_PLAIN:
                break  # the infallible tail below; later entries are dead
            if route == ROUTE_DEVICE_SNAPPY:
                if any(p.comp is not None for p in self.pages):
                    plan = self._plan_device_snappy(common, stager, name)
            elif route == ROUTE_FUSED_PLAIN:
                plan = self._plan_fused_plain(common, stager, name)
            elif route in (ROUTE_NARROW, ROUTE_NARROW_SNAPPY,
                           ROUTE_FUSED_NARROW_SNAPPY):
                if name in ("int32", "int64"):
                    plan = self._plan_narrow_ints(
                        common, stager, name,
                        compress=route != ROUTE_NARROW,
                        fused=route == ROUTE_FUSED_NARROW_SNAPPY)
            elif route == ROUTE_RECOMPRESS:
                plan = self._plan_recompress_fixed(common, stager, name)
            if plan is None and route in FUSED_ROUTES:
                # a fused route the kernel cannot claim (levels, op/depth/
                # payload caps, i32 ceilings) degrades with a counter
                self.fused_fallbacks += 1
            if plan is not None:
                return plan
        for p in self.pages:
            p.materialize()
        width = np.dtype(name).itemsize
        base, defined, count = self._stage_fixed_width(stager, width)
        logical = defined * width
        self._record_ship(ROUTE_PLAIN, logical, logical)
        return _Plan(
            lambda buf, base_d: _plain(buf, base_d, dtype=name, count=count),
            (base,),
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

    def _snappy_plain_plan(self, common, info, name: str, defined: int,
                           pages_pad: int) -> _Plan:
        """The device half shared by ``recompress`` and ``device_snappy``:
        resolve, gather and decode the staged compressed pages."""
        count = _bucket_count(defined)
        n_ops, out_pad, iters = info.n_ops, info.out_pad, info.iters
        return _Plan(
            lambda buf, tbase_d: _snappy_plain_staged(
                buf, tbase_d, n_ops=n_ops, out_pad=out_pad, iters=iters,
                dtype=name, count=count, n_pages=pages_pad),
            (info.tbase,),
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

    def _plan_recompress_fixed(self, common, stager, name: str):
        """Link recompression for PLAIN fixed-width chunks stored GZIP or
        uncompressed (ROUTE_RECOMPRESS): one more snappy pass on the host
        trades host cycles for link bytes; the device expands through the
        same resolver as native snappy files."""
        width = np.dtype(name).itemsize
        if any(p.comp is not None for p in self.pages):
            return None  # the file's own payload is the better ship
        defined = sum(p.defined for p in self.pages)
        if defined == 0:
            return None
        _check_plain_sizes(self.pages, width)
        if "recompress" in self._ship:
            payloads = self._ship["recompress"]  # None: preship declined
        else:
            payloads = self._recompress_streams(
                [(p.raw, p.value_pos, p.defined * width) for p in self.pages])
        if payloads is None:
            return None
        sizes = [p.defined * width for p in self.pages]
        specs = [("comp", c, n, None) for c, n in zip(payloads, sizes)]
        vbase_t, vstart_t, pages_pad, _ = _fixed_value_tables(
            sizes, [p.defined for p in self.pages])
        info = _plan_snappy_ops(stager, specs,
                                extra_tables=[vbase_t, vstart_t])
        if info is None:
            return None
        self.pages_kept_compressed = len(specs)
        self._record_ship(ROUTE_RECOMPRESS, defined * width, info.shipped)
        return self._snappy_plain_plan(common, info, name, defined,
                                       pages_pad)

    def _plan_device_snappy(self, common, stager, name: str):
        """Ship COMPRESSED snappy PLAIN pages; decompress + decode on the
        device.  Host work per page is the native tag walk — no
        decompression, no value copies.  Returns None when the chunk should
        fall back (shattered op tables, the i32 ceiling, the worth-it gate,
        native library absent)."""
        width = np.dtype(name).itemsize
        _check_plain_sizes(self.pages, width)
        specs = []
        sizes = []
        lazy_out = comp_bytes = 0
        for p in self.pages:
            if p.comp is not None:
                payload, _codec, ulen = p.comp
                r = native.snappy_plan(payload, ulen)
                if r is None:
                    return None
                if isinstance(r, int):
                    # malformed stream: materialize so the codec's
                    # diagnostics raise
                    p.materialize()
                    return None
                specs.append(("comp", payload, ulen, r))
                sizes.append(ulen)
                lazy_out += ulen
                comp_bytes += len(payload)
            else:
                nbytes = len(p.raw) - p.value_pos
                # an already-materialized page: its raw value bytes as one
                # synthetic literal op
                specs.append(("raw", p.raw, p.value_pos, nbytes))
                sizes.append(nbytes)
        # worth-it gate: at ratio ~1 the only win is the skipped host
        # decompress, which loses to the device resolve on large chunks
        if (lazy_out > 0 and comp_bytes > SNAPPY_WORTH_RATIO * lazy_out
                and lazy_out > _SNAPPY_SMALL_OUT):
            return None
        vbase_t, vstart_t, pages_pad, defined = _fixed_value_tables(
            sizes, [p.defined for p in self.pages])
        info = _plan_snappy_ops(stager, specs,
                                extra_tables=[vbase_t, vstart_t])
        if info is None:
            return None
        self.pages_kept_compressed = len(
            [1 for s in specs if s[0] == "comp"])
        self._record_ship(ROUTE_DEVICE_SNAPPY, defined * width, info.shipped)
        return self._snappy_plain_plan(common, info, name, defined,
                                       pages_pad)

    def _plan_narrow_ints(self, common, stager, name: str, *,
                          compress: bool, fused: bool):
        """Narrow transcode for PLAIN INT columns: ship ``v - min``
        truncated to the minimal byte width, widened and re-biased on the
        device.  Under ROUTE_NARROW_SNAPPY the truncated buffer is also
        snappy-compressed (resolved by the staged chain, or by K3 under
        ROUTE_FUSED_NARROW_SNAPPY).  Returns None when the span saves fewer
        than _NARROW_SAVE_BYTES per value."""
        width = np.dtype(name).itemsize
        _check_plain_sizes(self.pages, width)
        defined = sum(p.defined for p in self.pages)
        if defined == 0 or not native.available():
            return None
        if "narrow" in self._ship:
            art = self._ship["narrow"]
            if art is None:
                return None  # preship already scanned and declined
            k, mn, out, comp = art
        else:
            trans = self._narrow_host_transcode(width)
            if trans is None:
                return None
            k, mn, out = trans
            comp = self._try_snappy(out) if compress else None
        if fused:
            plan = (self._plan_fused_narrow(common, stager, name, k, mn,
                                            out, comp)
                    if comp is not None else None)
            if plan is not None:
                return plan
            # K3 cannot claim it (no compressed payload, or the op/depth/
            # payload caps): the unfused chain, same bytes, with a counter
            self.fused_fallbacks += 1
        count = _bucket_count(defined)
        bias = int(mn)

        def build(v):
            return DeviceColumnData(values=v, n_values=defined, **common)

        if comp is not None:
            info = _plan_snappy_ops(
                stager, [("comp", comp, out.nbytes, None)])
            if info is not None:
                self.pages_kept_compressed = len(self.pages)
                self._record_ship(ROUTE_NARROW_SNAPPY, defined * width,
                                  info.shipped)
                n_ops, out_pad, iters = info.n_ops, info.out_pad, info.iters
                return _Plan(
                    lambda buf, tb_d, bias_d: _snappy_narrow_staged(
                        buf, tb_d, bias_d, n_ops=n_ops, out_pad=out_pad,
                        iters=iters, k=k, dtype=name, count=count),
                    (info.tbase, bias), build)
            # op planning fell through: ship the narrow bytes uncompressed
        base = stager.add(out)
        stager.note_read_extent(base, count * k)
        self._record_ship(ROUTE_NARROW, defined * width, out.nbytes)
        return _Plan(
            lambda buf, base_d, bias_d: _plain_narrow(
                buf, base_d, bias_d, k=k, dtype=name, count=count),
            (base, bias), build)

    def _plan_fused_plain(self, common, stager, name: str):
        """ONE K2 pass for a PLAIN fixed-width chunk (route ``fused_plain``):
        word assembly of the staged value stream plus the validity tail.
        Returns None (degrade to the next route, counted by the caller) when
        the column carries level lanes or the staged arena exceeds the
        reference kernel's int32 addressing."""
        leaf = self.leaf
        if leaf.max_def > 0 or leaf.max_rep > 0:
            return None  # fused claims flat streams only (ship.fused_eligible)
        width = np.dtype(name).itemsize
        if width not in (4, 8):
            return None
        _check_plain_sizes(self.pages, width)
        defined = sum(p.defined for p in self.pages)
        count = fused_count_pad(defined)
        if stager.total + count * width > _I32_MAX:
            return None
        for p in self.pages:
            p.materialize()
        segs = [(p.raw, p.value_pos, p.defined * width) for p in self.pages]
        base = (int(stager.add_segments(segs)[0]) if segs
                else stager._reserve(0, None))
        stager.note_read_extent(base, count * width)
        logical = defined * width
        self._record_ship(ROUTE_FUSED_PLAIN, logical, logical)

        def fn(buf, base_d, nv_d):
            words = fused_plain_words(buf, base_d, nv_d, width=width,
                                      count_pad=count)
            return _fused_words_cast(words, name)

        return _Plan(
            fn, (base, defined),
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

    def _plan_fused_narrow(self, common, stager, name: str, k: int, mn,
                           out: np.ndarray, comp):
        """ONE K3 pass for the narrow+snappy composition (route
        ``fused_narrow_snappy``): resolve, gather, widen, re-bias and the
        validity tail fused — the staged chain's source map never exists.
        The kernel's caps (FUSED_MAX_OPS / FUSED_MAX_DEPTH /
        FUSED_MAX_PAYLOAD) bound eligibility exactly as the reference's do;
        beyond them the caller degrades to the staged chain.  Literal op
        sources are packed PAYLOAD-RELATIVE."""
        leaf = self.leaf
        if leaf.max_def > 0 or leaf.max_rep > 0:
            return None
        width = np.dtype(name).itemsize
        defined = sum(p.defined for p in self.pages)
        if defined == 0:
            return None
        fz = _fused_narrow_tables(comp, out.nbytes)
        if fz is None:
            return None
        tables, depth, n_ops_pad, out_pad, ppad = fz
        count = fused_narrow_count_pad(defined)
        if (stager.total + len(comp) + SNAPPY_OPS_BYTES * n_ops_pad + ppad
                + out_pad > (_I32_MAX >> 1)):
            return None  # i32 table/source math (checked before mutation)
        tbase = _pack_tables(stager, tables)
        pbase = stager.add(np.frombuffer(comp, np.uint8))
        # K3 reads ppad payload bytes from pbase
        stager.note_read_extent(pbase, ppad)
        self.pages_kept_compressed = len(self.pages)
        self._record_ship(ROUTE_FUSED_NARROW_SNAPPY, defined * width,
                          len(comp))

        def fn(buf, tb_d, pb_d, bias_d, nv_d):
            words = fused_narrow_words(
                buf, tb_d, pb_d, bias_d, nv_d, k=k, width=width, depth=depth,
                count_pad=count, out_pad=out_pad, n_ops_pad=n_ops_pad,
                ppad=ppad)
            return _fused_words_cast(words, name)

        return _Plan(
            fn, (tbase, pbase, int(mn), defined),
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

    def _finish_plain_bytes(self, common, stager):
        """PLAIN BYTE_ARRAY chunk: the host walks only the length prefixes
        (native, no copies); the value streams and the lengths are staged,
        and the offsets and the heap compaction run on the device.

        The streams ship by the planner's route (``ship.py``): the file's own
        snappy payloads (``device_snappy``), a host snappy recompression of
        the walked spans (``recompress``, prepared by preship), or the raw
        spans (``plain``).  Without the native length walk, the chunk takes
        :meth:`_finish_plain_bytes_host`."""
        if self._bytes_walk is not None:
            lens_l, span_l = self._bytes_walk
        else:
            lens_l, span_l = [], []
            for p in self.pages:
                # whole page buffer + offset: no host copy of the stream
                p.peek()
                res = native.bytearray_lengths(p.raw, p.defined,
                                               pos=p.value_pos)
                if res is None:
                    return self._finish_plain_bytes_host(common, stager)
                if isinstance(res, int):
                    if res == -20:
                        raise ParquetError(
                            "byte array: truncated length prefix")
                    raise ParquetError("byte array: length exceeds buffer")
                lens, end = res
                lens_l.append(lens)
                span_l.append(end - p.value_pos)
        n = sum(p.defined for p in self.pages)
        logical = sum(span_l)
        count_pad = _bucket_count(n)
        lens_all = (np.concatenate(lens_l) if lens_l
                    else np.zeros(0, np.uint32))
        total_heap = int(lens_all.astype(np.int64).sum())
        heap_pad = _bucket_bytes(max(total_heap, 1), 64)
        n_pages = _bucket(len(self.pages))
        pvs = np.full(n_pages + 1, n, dtype=np.int32)
        pvs[0] = 0
        np.cumsum([p.defined for p in self.pages],
                  out=pvs[1 : len(self.pages) + 1])

        def build(res):
            offsets, heap = res
            return DeviceColumnData(offsets=offsets, heap=heap, n_values=n,
                                    **common)

        plan = self._plan_snappy_bytes(
            stager, span_l, pvs, count_pad, heap_pad, n_pages, lens_all,
            logical, build)
        if plan is not None:
            return plan
        # plain route: stage exactly the walked stream spans, back to back
        for p in self.pages:
            p.materialize()
        bases = stager.add_segments([
            (p.raw, p.value_pos, c) for p, c in zip(self.pages, span_l)
        ])
        # zero-filled reserve: pad values past n must read length 0
        lens_base = stager.add(lens_all, reserve=count_pad * 4)
        page_base = np.zeros(n_pages, dtype=np.int64)
        page_base[: len(bases)] = bases
        tbase = _pack_tables(stager, [page_base, pvs])
        self._record_ship(ROUTE_PLAIN, logical, logical)
        return _Plan(
            lambda buf, lb_d, tb_d: _plain_bytes_staged(
                buf, lb_d, tb_d, count_pad=count_pad, heap_pad=heap_pad,
                n_pages=n_pages),
            (lens_base, tbase), build)

    def _plan_snappy_bytes(self, stager, span_l, pvs, count_pad, heap_pad,
                           n_pages, lens_all, logical, build):
        """The compressed half of :meth:`_finish_plain_bytes`: op tables for
        whichever compressed payloads exist (the file's own, or preship's
        recompression) and the staged chain over them.  Returns None when
        no compressed route applies or planning falls through — the caller
        stages the raw spans."""
        route = specs = None
        if (any(p.comp is not None for p in self.pages)
                and self._route_enabled(ROUTE_DEVICE_SNAPPY)):
            comp_total = sum(len(p.comp[0]) for p in self.pages
                             if p.comp is not None)
            # ratio ~1: the op tables + resolve buy nothing — ship raw
            if comp_total <= SNAPPY_WORTH_RATIO * max(logical, 1):
                route = ROUTE_DEVICE_SNAPPY
                specs = [
                    ("comp", p.comp[0], p.comp[2], None)
                    if p.comp is not None
                    else ("raw", p.raw, p.value_pos, span)
                    for p, span in zip(self.pages, span_l)
                ]
        elif self._ship.get("recompress_bytes") is not None:
            route = ROUTE_RECOMPRESS
            specs = [("comp", c, span, None)
                     for c, span in zip(self._ship["recompress_bytes"],
                                        span_l)]
        if specs is None:
            return None
        out_lens = [s[2] if s[0] == "comp" else s[3] for s in specs]
        page_out = np.zeros(n_pages, dtype=np.int64)
        page_out[: len(specs)] = np.concatenate(
            [[0], np.cumsum(out_lens)[:-1]])
        info = _plan_snappy_ops(stager, specs, extra_tables=[page_out, pvs])
        if info is None:
            return None
        # zero-filled reserve: pad values past n must read length 0
        lens_base = stager.add(lens_all, reserve=count_pad * 4)
        self.pages_kept_compressed = len([1 for s in specs if s[0] == "comp"])
        self._record_ship(route, logical, info.shipped)
        n_ops, out_pad, iters = info.n_ops, info.out_pad, info.iters
        return _Plan(
            lambda buf, lb_d, tb_d: _snappy_bytes_staged(
                buf, lb_d, tb_d, count_pad=count_pad, heap_pad=heap_pad,
                n_ops=n_ops, out_pad=out_pad, iters=iters, n_pages=n_pages),
            (lens_base, info.tbase), build)

    def _finish_plain_bytes_host(self, common, stager):
        """PLAIN BYTE_ARRAY without the native length walk: the host
        decodes each page (``kernels.plain``), the merged offsets and heap
        ride the row group's buffer, and the device only slices them."""
        from .kernels import plain as plain_host

        offs_parts, heap_parts = [], []
        for p in self.pages:
            # host bytes even for a page a lazy route kept compressed
            raw = p.materialize()
            ba = plain_host.decode_byte_array(raw[p.value_pos :], p.defined)
            offs_parts.append(ba.offsets)
            heap_parts.append(ba.heap)
        n = sum(len(o) - 1 for o in offs_parts)
        offsets = np.empty(n + 1, dtype=np.int64)
        offsets[0] = 0
        pos = hbase = 0
        for o, h in zip(offs_parts, heap_parts):
            k = len(o) - 1
            offsets[pos + 1 : pos + 1 + k] = o[1:] + hbase
            pos += k
            hbase += h.nbytes
        heap = (np.concatenate(heap_parts) if len(heap_parts) > 1
                else heap_parts[0])
        heap_room = _bucket_bytes(max(heap.nbytes, 1), 64)
        heap_base = stager.add(heap, reserve=heap_room)
        off_base = stager.add(offsets)
        n_off = _bucket_count(n + 1)
        stager.note_read_extent(off_base, n_off * 8)

        def fn(buf, off_d, heap_d):
            # bucketed offset count (tail garbage past n + 1) and heap room
            # (zero padding past offsets[n]), both trimmed by to_host
            return (_plain(buf, off_d, dtype="int64", count=n_off),
                    buf[heap_d : heap_d + heap_room].clone())

        def build(res):
            offsets_d, heap_d = res
            return DeviceColumnData(offsets=offsets_d, heap=heap_d,
                                    n_values=n, **common)

        return _Plan(fn, (off_base, heap_base), build)

    def _parse_dict_index_page(self, p, host_max):
        """Parse one RLE_DICTIONARY page's index stream; folds the host-side
        max (None = unknown, defer the check to the device).

        When the dictionary covers the index stream's whole bit-width value
        range (dict_len >= 2^width), no bit-packed index can be out of
        range, so the exact-max request is skipped and only RLE run values
        are folded."""
        stream = p.raw[p.value_pos :]
        if len(stream) < 1:
            raise ParquetError("dictionary page data truncated (missing width)")
        width = int(stream[0])
        if width > 32:
            raise ParquetError(f"dictionary index width {width} invalid")
        covered = width < 31 and self.dict_len >= (1 << width)
        meta = parse_hybrid_meta(stream, width, p.defined, pos=1,
                                 compute_max=not covered)
        if p.defined == 0:
            pass  # no indices: nothing to fold into the max
        elif covered:
            # RLE run values are RAW unmasked bytes and can exceed the
            # width's range, so fold them from the run table — O(runs)
            n = meta.n_runs
            rle_mask = meta.run_is_rle[:n]
            if host_max is not None and rle_mask.any():
                host_max = max(host_max,
                               int(meta.run_values[:n][rle_mask].max()))
        elif host_max is not None and meta.max_value is not None:
            host_max = max(host_max, meta.max_value)
        else:
            host_max = None  # Python fallback walk: defer check to device
        return meta, width, stream, host_max

    def _check_dict_range(self, prefix, host_max):
        if prefix and self.dict_len == 0:
            raise ParquetError("dictionary indices with empty dictionary")
        if prefix and host_max is not None and host_max >= self.dict_len:
            raise ParquetError(
                f"dictionary index {host_max} out of range ({self.dict_len}) "
                f"in column {'.'.join(self.leaf.path)}"
            )

    def _finish_dict(self, common, stager):
        """Dictionary-encoded chunk: the index stream through the fused K1
        (unpack + run-table combine; one uniform index width), or the
        run-table expand (per-page widths, or too many runs); the indices
        and the dictionary (fixed-width byte rows, or ragged) stay a
        :class:`DeviceDictColumn`, gathered only by ``materialize()``."""
        if self.dict_u8 is None and self.dict_ragged is None:
            raise ParquetError("dictionary-encoded page but no dictionary page seen")
        parsed = []  # (page, stream, meta)
        page_widths = []
        host_max = 0 if self.pages else None
        for p in self.pages:
            meta, pw, stream, host_max = self._parse_dict_index_page(p, host_max)
            parsed.append((p, stream, meta))
            page_widths.append(pw)
        uniform = len(set(page_widths)) <= 1
        width = page_widths[0] if page_widths else 0
        prefix = sum(p.defined for p in self.pages)
        cp = _bucket_count(prefix)
        plan = None
        if uniform and prefix:
            plan = _plan_hybrid_pallas(
                stager, [(m, s, p.defined) for p, s, m in parsed],
                width, prefix, cp,
            )
        if plan is not None:
            idx_fn, idx_dyn = plan.fn, plan.dyn
        else:
            bases = stager.add_segments([
                (p.raw, p.value_pos, len(p.raw) - p.value_pos)
                for p in self.pages])
            ends_l, rle_l, vals_l, starts_l, widths_l = [], [], [], [], []
            pos0 = 0
            for (p, stream, meta), base, pw in zip(parsed, bases, page_widths):
                n = meta.n_runs
                ends_l.append(meta.run_ends[:n] + pos0)
                rle_l.append(meta.run_is_rle[:n])
                vals_l.append(meta.run_values[:n])
                # global bit base: page byte base within buf, re-zeroed for
                # the global value position
                starts_l.append(
                    meta.run_bit_starts[:n] + base * 8 - pos0 * pw
                )
                widths_l.append(np.full(n, pw, dtype=np.int64))
                pos0 += p.defined
            tables = _merge_run_tables(ends_l, rle_l, vals_l, starts_l,
                                       fill_end=prefix, widths_l=widths_l)
            if uniform:
                tables = tables[:4]  # one width: no per-run width table
            idx_dyn = tuple(_stage_array(stager, t) for t in tables)
            if uniform:
                def idx_fn(buf, *specs):
                    e, r, v, s = (_staged(buf, t) for t in specs)
                    return _hybrid(buf, e, r != 0, v, s, prefix, width=width,
                                   count=cp)
            else:
                # per-page index widths differ (dictionary grew page to
                # page): the same expansion with per-run widths
                mw = min(max(8, (max(page_widths) + 7) // 8 * 8), 32)

                def idx_fn(buf, *specs):
                    e, r, v, s, w = (_staged(buf, t) for t in specs)
                    return _hybrid_vw(buf, e, r != 0, v, s, w, prefix,
                                      max_width=mw, count=cp)
        self._check_dict_range(prefix, host_max)
        # no native walk: deferred device-side range check (one read of all
        # maxima at finalize); tail lanes are zeroed, so the max reflects
        # only real indices
        need_max = bool(prefix) and host_max is None
        if self.dict_ragged is not None:
            return self._finish_dict_ragged(common, stager, idx_fn, idx_dyn,
                                            prefix, need_max)
        # the dictionary rides the row-group buffer, its row count bucketed
        dict_kp = _bucket(max(self.dict_len, 1))
        itemsize = int(self.dict_u8.shape[1])
        table_fn = None
        ship = self._dict_ship  # (route, payload, out_len) or None: ship.py
        if ship is not None:
            info = _plan_snappy_ops(stager, [("comp", ship[1], ship[2], None)])
            if info is not None:
                # value table shipped compressed; the device gathers the
                # bucketed rows out of the stream's output space.  Rows past
                # dict_len resolve through padded ops — garbage no valid
                # index selects (the range check rejects the others)
                self._record_ship(ship[0], self.dict_u8.nbytes, info.shipped)
                table_dyn = info.tbase

                def table_fn(buf, tb):
                    return _snappy_gather_staged(
                        buf, tb, n_ops=info.n_ops, out_pad=info.out_pad,
                        iters=info.iters, nbytes=dict_kp * itemsize,
                    ).reshape(dict_kp, itemsize)
        if table_fn is None:
            # zero-filled past dict_len so clamped tail gathers read zeros
            table_dyn = stager.add(np.ascontiguousarray(self.dict_u8),
                                   reserve=dict_kp * itemsize)

            def table_fn(buf, tb):
                # a copy: a view would keep the whole staged buffer alive
                return buf[tb : tb + dict_kp * itemsize].reshape(
                    dict_kp, itemsize).clone()
        n_idx = len(idx_dyn)
        deferred = self._deferred
        dict_len = self.dict_len
        dict_dtype = self.dict_dtype
        path_name = ".".join(self.leaf.path)

        def fn(buf, *d):
            idx = idx_fn(buf, *d[:n_idx])
            return (idx, table_fn(buf, d[n_idx]),
                    _max_index(idx) if need_max else None)

        def build(res):
            idx, table, mx = res
            if mx is not None:
                deferred.append((mx, dict_len, path_name))
            return DeviceDictColumn(indices=idx, dict_u8=table,
                                    dict_dtype=dict_dtype, n_values=prefix,
                                    **common)

        return _Plan(fn, tuple(idx_dyn) + (table_dyn,), build)

    def _finish_dict_ragged(self, common, stager, idx_fn, idx_dyn,
                            prefix: int, need_max: bool):
        """The ragged (string) dictionary rides the row group's buffer: its
        offsets plain (tiny), its heap plain or, when preship recompressed
        it, resolved on the device through the snappy source map.  Bytes
        past the real heap are padding or resolve through padded ops —
        garbage that no valid index reads."""
        roff = np.ascontiguousarray(self.dict_ragged.offsets, dtype=np.int64)
        roff_n = _bucket_count(len(roff))
        roff_base = stager.add(roff, reserve=roff_n * 8)
        rheap = np.ascontiguousarray(self.dict_ragged.heap)
        rheap_room = _bucket_bytes(max(rheap.nbytes, 1), 64)
        heap_fn = None
        ship = self._dict_ship  # (route, payload, out_len) or None: ship.py
        if ship is not None:
            info = _plan_snappy_ops(stager, [("comp", ship[1], ship[2], None)])
            if info is not None:
                self._record_ship(ship[0], rheap.nbytes, info.shipped)
                heap_dyn = info.tbase

                def heap_fn(buf, hb):
                    return _snappy_gather_staged(
                        buf, hb, n_ops=info.n_ops, out_pad=info.out_pad,
                        iters=info.iters, nbytes=rheap_room)
        if heap_fn is None:
            heap_dyn = stager.add(rheap, reserve=rheap_room)

            def heap_fn(buf, hb):
                return buf[hb : hb + rheap_room].clone()
        n_idx = len(idx_dyn)
        deferred = self._deferred
        dict_len = self.dict_len
        path_name = ".".join(self.leaf.path)

        def fn(buf, *d):
            idx = idx_fn(buf, *d[:n_idx])
            doff = _plain(buf, d[n_idx], dtype="int64", count=roff_n)
            dheap = heap_fn(buf, d[n_idx + 1])
            return idx, doff, dheap, _max_index(idx) if need_max else None

        def build(res):
            idx, doff, dheap, mx = res
            if mx is not None:
                deferred.append((mx, dict_len, path_name))
            return DeviceDictColumn(indices=idx, dict_offsets=doff,
                                    dict_heap=dheap, n_values=prefix,
                                    **common)

        return _Plan(fn, tuple(idx_dyn) + (roff_base, heap_dyn), build)

    def _value_segments(self, stager: _RowGroupStager) -> np.ndarray:
        """Register all pages' value streams back to back; returns their
        absolute byte bases in the staged buffer, int64[P]."""
        return stager.add_segments([
            (p.raw, p.value_pos, len(p.raw) - p.value_pos) for p in self.pages
        ])

    def _finish_plain_rows(self, common, stager, k: int, flba: bool = False):
        """PLAIN fixed-length rows: exactly the value bytes back to back,
        one bucketed slice — INT96 as ``int32[n, 3]`` words (the reference's
        ``uint32[n, 3]``), FLBA as the uniform (offsets, heap) ragged form
        (the host decoder's)."""
        base, defined, count = self._stage_fixed_width(stager, k)

        def fn(buf, base_d):
            if flba:
                return _plain_flba(buf, base_d, k=k, count=count)
            return _plain_rows(buf, base_d, k=k, count=count)

        def build(res):
            col = DeviceColumnData(n_values=defined, **common)
            if flba:
                col.offsets, col.heap = res
            else:
                col.values = res
            return col

        return _Plan(fn, (base,), build)

    def _finish_plain_bool(self, common, stager):
        """PLAIN BOOLEAN: the pages' bit streams staged back to back; one
        bit extraction whose position restarts at each page's base."""
        defined = sum(p.defined for p in self.pages)
        for p in self.pages:
            need = (p.defined + 7) // 8
            if len(p.raw) - p.value_pos < need:
                raise ParquetError(
                    f"PLAIN BOOLEAN truncated: {len(p.raw) - p.value_pos} "
                    f"< {need}"
                )
        bases = self._value_segments(stager)
        n_pages = _bucket(len(self.pages))
        byte_base = np.zeros(n_pages, dtype=np.int64)
        byte_base[: len(self.pages)] = bases
        byte_base[len(self.pages):] = bases[-1] if len(self.pages) else 0
        starts = np.full(n_pages, defined, dtype=np.int64)
        starts[: len(self.pages)] = np.cumsum(
            [0] + [p.defined for p in self.pages])[:-1]
        count = _bucket_count(defined)
        tables = (_stage_array(stager, byte_base), _stage_array(stager, starts))
        return _Plan(
            lambda buf, bb, st: _bool_pages(buf, _staged(buf, bb),
                                            _staged(buf, st), count=count),
            tables,
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

    def _finish_mixed_dict_plain(self, common, stager):
        """Fixed-width chunk whose pages mix RLE_DICTIONARY and PLAIN.

        The writer's dictionary fallback always gives a dictionary-encoded
        PREFIX of pages followed by a PLAIN suffix.  The prefix's index
        width grows page to page as the dictionary fills, so its pages go
        in groups of consecutive pages of one width: each group through the
        fused K1 (``_plan_hybrid_pallas``), or, where that planner declines
        the group by shape, the run-table expand page by page.  Then one
        concat, one device gather (``dict_gather_bytes``), and the suffix:
        one view when its staged segments are exactly the value bytes, else
        one per page.  Dictionary pages after PLAIN pages are not the
        fallback shape and take ``_finish_host``."""
        name = _PTYPE_TO_NAME[self.leaf.physical_type]
        itemsize = np.dtype(name).itemsize
        kinds = []
        for p in self.pages:
            enc = Encoding(p.encoding)
            kinds.append(Encoding.RLE_DICTIONARY
                         if enc == Encoding.PLAIN_DICTIONARY else enc)
        n_dict = 0
        for k in kinds:
            if k != Encoding.RLE_DICTIONARY:
                break
            n_dict += 1
        if any(k == Encoding.RLE_DICTIONARY for k in kinds[n_dict:]):
            return self._finish_host(common)
        dict_pages = self.pages[:n_dict]
        plain_pages = self.pages[n_dict:]

        # dictionary prefix: parse every page (folding the host max), then
        # group consecutive live pages of one width
        parsed = []  # (page, stream, meta, width)
        prefix = 0
        host_max = 0
        for p in dict_pages:
            meta, width, stream, host_max = self._parse_dict_index_page(
                p, host_max)
            parsed.append((p, stream, meta, width))
            prefix += p.defined
        self._check_dict_range(prefix, host_max)
        _check_plain_sizes(plain_pages, itemsize)
        groups: list[list] = []
        for entry in parsed:
            if not entry[0].defined:
                continue
            if groups and groups[-1][-1][3] == entry[3]:
                groups[-1].append(entry)
            else:
                groups.append([entry])
        idx_calls = []  # (fn, dyn, real count)
        for group in groups:
            width = group[0][3]
            total = sum(p.defined for p, _, _, _ in group)
            plan = _plan_hybrid_pallas(
                stager, [(m, st, p.defined) for p, st, m, _ in group],
                width, total, _bucket_count(total))
            if plan is not None:
                idx_calls.append((plan.fn, plan.dyn, total))
                continue
            for p, _, meta, _ in group:
                base = int(stager.add_segments(
                    [(p.raw, p.value_pos, len(p.raw) - p.value_pos)])[0])
                tables = tuple(_stage_array(stager, t) for t in (
                    meta.run_ends, meta.run_is_rle, meta.run_values.astype(
                        np.int64), meta.run_bit_starts + base * 8))

                def run_fn(buf, *specs, _w=width, _c=p.defined):
                    e, r, v, st = (_staged(buf, t) for t in specs)
                    return _hybrid(buf, e, r != 0, v, st, _c, width=_w,
                                   count=_c)

                idx_calls.append((run_fn, tables, p.defined))

        # PLAIN suffix: one view when the segments are exactly the values
        plain_total = sum(p.defined for p in plain_pages)
        bases = stager.add_segments([
            (p.raw, p.value_pos, len(p.raw) - p.value_pos)
            for p in plain_pages])
        contiguous = all(
            len(p.raw) - p.value_pos == p.defined * itemsize
            for p in plain_pages)
        plain_calls = ([(int(bases[0]), plain_total)] if contiguous
                       and plain_pages else
                       [(int(b), p.defined)
                        for b, p in zip(bases, plain_pages)])
        dict_len = self.dict_len
        table_base = None
        if prefix:
            table_base = stager.add(np.ascontiguousarray(self.dict_u8))
        dict_dtype = self.dict_dtype
        need_max = bool(prefix) and host_max is None
        deferred = self._deferred
        path_name = ".".join(self.leaf.path)
        dyn = [table_base, *(b for b, _ in plain_calls)]
        for _, d, _ in idx_calls:
            dyn.extend(d)
        n_plain = len(plain_calls)
        arities = [len(d) for _, d, _ in idx_calls]

        def fn(buf, *d):
            parts = []
            mx = None
            if prefix:
                j = 1 + n_plain
                idx_parts = []
                for (call, _, real), a in zip(idx_calls, arities):
                    idx_parts.append(call(buf, *d[j : j + a])[:real])
                    j += a
                idx = (idx_parts[0] if len(idx_parts) == 1
                       else torch.cat(idx_parts))
                if need_max:
                    mx = _max_index(idx)
                table = buf[d[0] : d[0] + dict_len * itemsize].reshape(
                    dict_len, itemsize)
                parts.append(K.dict_gather_bytes(table, idx, dict_dtype))
            for (_, c), b in zip(plain_calls, d[1 : 1 + n_plain]):
                if c:
                    parts.append(_plain(buf, b, dtype=name, count=c))
            if not parts:
                return torch.zeros(0, dtype=_TORCH_DTYPES[name],
                                   device=buf.device), mx
            return (parts[0] if len(parts) == 1 else torch.cat(parts)), mx

        def build(res):
            vals, mx = res
            if mx is not None:
                deferred.append((mx, dict_len, path_name))
            return DeviceColumnData(values=vals, **common)

        return _Plan(fn, tuple(dyn), build)

    def _finish_host(self, common):
        """Host decode page by page (BYTE_STREAM_SPLIT, delta byte arrays,
        boolean RLE, the mixes the batched plans do not take) through
        ``torch_decode.DeviceChunkDecoder``, each page staged on its own,
        independent of the row group's buffer.  The decode runs here, in
        the host phase; its deferred index maxima join the reader's."""
        from .torch_decode import DeviceChunkDecoder

        helper = DeviceChunkDecoder(self.leaf, device=self.device)
        dev = self.device
        if self.dict_u8 is not None:
            helper.dict_u8 = torch.from_numpy(
                np.ascontiguousarray(self.dict_u8)).to(dev)
        helper.dict_dtype = self.dict_dtype
        helper.dict_len = self.dict_len
        if self.dict_ragged is not None:
            helper._dict_host_offsets = self.dict_ragged.offsets
            helper.dict_offsets = torch.from_numpy(np.ascontiguousarray(
                self.dict_ragged.offsets, dtype=np.int64)).to(dev)
            helper.dict_heap = torch.from_numpy(
                np.ascontiguousarray(self.dict_ragged.heap)).to(dev)
        vals_parts, off_parts, heap_parts = [], [], []
        for p in self.pages:
            v, off, heap = helper._decode_values_device(
                p.encoding, p.raw, p.value_pos, p.defined
            )
            if v is not None:
                vals_parts.append(v)
            else:
                off_parts.append(off)
                heap_parts.append(heap)
        for mx in helper._idx_maxima:
            self._deferred.append((mx, self.dict_len,
                                   ".".join(self.leaf.path)))
        out = DeviceColumnData(**common)
        if off_parts:
            if len(off_parts) == 1:
                out.offsets, out.heap = off_parts[0], heap_parts[0]
            else:
                out.offsets, out.heap = _concat_ragged(off_parts, heap_parts)
        elif vals_parts:
            out.values = (vals_parts[0] if len(vals_parts) == 1
                          else torch.cat(vals_parts))
        else:
            out.values = torch.zeros(0, dtype=torch.int64, device=dev)
        # decoded already: the plan only hands the column over
        return _Plan(lambda buf: None, (), lambda _res: out)

    def _finish_delta(self, common, stager):
        """DELTA_BINARY_PACKED chunk: the host walks the block headers only;
        the page payloads and compact per-block tables are staged, and the
        device extracts, offsets and prefix-sums the deltas of every page in
        one batched pass (:func:`_delta_pages_staged`)."""
        ptype = self.leaf.physical_type
        if ptype not in (Type.INT32, Type.INT64):
            raise ParquetError(f"DELTA_BINARY_PACKED invalid for {ptype!r}")
        bits = 32 if ptype == Type.INT32 else 64
        metas = []
        for p in self.pages:
            m = parse_delta_meta(p.raw[p.value_pos :], bits)
            if m.count < p.defined:
                raise ParquetError(
                    f"delta stream yielded {m.count} of {p.defined} values"
                )
            metas.append(m)
        if any(m.values_per_mini != metas[0].values_per_mini for m in metas):
            # spec-legal but rare: block geometry differs across pages
            return self._finish_host(common)
        # miniblocks per block from the streams' own header varints
        mbs = set()
        for p in self.pages:
            _, p2 = _read_uvarint(p.raw, p.value_pos)
            mpb, _ = _read_uvarint(p.raw, p2)
            mbs.add(mpb)
        if len(mbs) != 1:
            return self._finish_host(common)
        mb = mbs.pop()
        if any((m.mini_bit_starts & 7).any() for m in metas):
            # miniblocks are byte-aligned by construction; anything else is
            # a walker this compact layout no longer matches
            return self._finish_host(common)
        if (stager.total + sum(len(p.raw) - p.value_pos for p in self.pages)
                > _I32_MAX):
            # block byte starts are staged as int32, as in the reference
            # (checked before any stager mutation)
            return self._finish_host(common)
        bases = stager.add_segments([
            (p.raw, p.value_pos, len(p.raw) - p.value_pos)
            for p in self.pages])
        # every shape bucketed; the real geometry rides the staged tables
        n_pages = _bucket(len(metas))
        count = _bucket_count(max(m.count for m in metas))
        m_max = _bucket(max(m.mini_bit_starts.shape[0] for m in metas))
        m_max = -(-m_max // mb) * mb  # a multiple of mb for the block reshape
        n_blocks = m_max // mb
        bstarts = np.zeros((n_pages, n_blocks), dtype=np.int32)
        widths = np.zeros((n_pages, m_max), dtype=np.uint8)
        bmins = np.zeros((n_pages, n_blocks), dtype=np.uint64)
        firsts = np.zeros(n_pages, dtype=np.int64)
        for i, (m, base) in enumerate(zip(metas, bases)):
            kk = m.mini_bit_starts.shape[0]
            kb = -(-kk // mb)
            bs = (m.mini_bit_starts[::mb] >> 3) + base
            bstarts[i, :kb] = bs
            bstarts[i, kb:] = bs[-1] if kb else 0
            widths[i, :kk] = m.mini_widths
            bmins[i, :kb] = m.mini_min_delta[::mb]
            firsts[i] = m.first_value
        total_real = sum(p.defined for p in self.pages)
        page_starts = np.full(n_pages + 1, total_real, dtype=np.int64)
        page_starts[0] = 0
        np.cumsum([p.defined for p in self.pages],
                  out=page_starts[1 : len(metas) + 1])
        max_width = max(1, int(widths.max(initial=0)))
        max_width = min((max_width + 7) // 8 * 8, 64)  # byte-rounded
        tbase = _pack_tables(stager, [firsts, bstarts, widths, bmins,
                                      page_starts])
        vpm = metas[0].values_per_mini
        total_b = _bucket_count(total_real)
        n_real = len(metas)
        return _Plan(
            lambda buf, tb_d: _delta_pages_staged(
                buf, tb_d, values_per_mini=vpm, mb=mb, count=count,
                bits=bits, max_width=max_width, total=total_b,
                n_pages=n_pages, n_real=n_real, m_max=m_max),
            (tbase,),
            lambda v: DeviceColumnData(values=v, n_values=total_real,
                                       **common),
        )


def _collect_chunk(buf: bytes, codec: int, total_values: int,
                   leaf: SchemaNode, deferred_checks: list,
                   validate_crc: bool = False,
                   statistics=None, context=None,
                   device=None) -> _ChunkAssembler:
    """Walk a chunk's pages into an assembler (host phase): CRC checks,
    the dictionary page, and each data page's level and index structure.
    PLAIN pages of a SNAPPY chunk stay compressed (lazy pages) for the
    compressed-shipping routes; every other page is decompressed here.

    ``context`` ({file, column, row_group, chunk_offset}) is stamped onto
    every raise (``errors.error_context``), with the failing page's ordinal
    and absolute byte offset."""
    ctx = dict(context or {})
    if "column" not in ctx and leaf.path:
        ctx["column"] = ".".join(leaf.path)
    chunk_offset = ctx.pop("chunk_offset", 0) or 0
    asm = _ChunkAssembler(leaf, deferred_checks, device)
    asm.stats_span = _int_stats_span(statistics, leaf)
    # parse_data_page applies the per-page conditions (PLAIN encoding,
    # levels outside the compressed region)
    lazy = (codec == CompressionCodec.SNAPPY
            and (leaf.physical_type in _PTYPE_TO_NAME
                 or leaf.physical_type == Type.BYTE_ARRAY)
            and native.available())
    with error_context(**ctx):
        pages = walk_pages(buf, total_values)
    data_ordinal = 0
    for ps in pages:
        header = ps.header
        pt = header.type
        if pt == PageType.DICTIONARY_PAGE:
            with error_context(offset=chunk_offset + ps.payload_start, **ctx):
                payload = buf[ps.payload_start : ps.payload_end]
                _check_crc(header, payload, validate_crc)
                raw = decompress_block(payload, codec,
                                       header.uncompressed_page_size)
                dh = header.dictionary_page_header
                asm.set_dictionary(raw, dh.encoding, dh.num_values or 0)
            if codec == CompressionCodec.SNAPPY:
                # kept: the planner may ship the dictionary VALUE TABLE
                # compressed (_preship_dict / _finish_dict)
                asm.dict_comp = (payload,
                                 max(header.uncompressed_page_size or 0, 0))
            continue
        if pt in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
            with error_context(page=data_ordinal,
                               offset=chunk_offset + ps.payload_start, **ctx):
                asm.pages.append(
                    parse_data_page(ps, buf, codec, leaf,
                                    validate_crc=validate_crc,
                                    decode_levels=False,
                                    lazy_decompress=lazy)
                )
            data_ordinal += 1
        # index/unknown pages: skip
    return asm


@dataclass
class ReaderStats:
    """Decode counters, accumulated per DeviceFileReader (the reference's
    ``ReaderStats`` cut to this slice).  Per route in ``ship_routes``:
    streams, ``logical`` bytes (what plain shipping would move) and
    ``shipped`` bytes (what the route registered for transfer);
    ``link_bytes_logical``/``link_bytes_shipped`` are their sums."""

    row_groups: int = 0
    chunks: int = 0
    pages: int = 0
    pages_device_expanded: int = 0  # pages shipped compressed
    rows: int = 0
    compressed_bytes: int = 0      # chunk bytes read from the file
    staged_bytes: int = 0          # bytes registered for the device buffers
    host_seconds: float = 0.0      # read + decompress + parse + planning
    stage_seconds: float = 0.0     # fill + enqueue of the host->device copy
    dispatch_seconds: float = 0.0  # enqueue of the decode launches
    wall_seconds: float = 0.0
    route_streams: dict = field(default_factory=dict)
    route_bytes_logical: dict = field(default_factory=dict)
    route_bytes_shipped: dict = field(default_factory=dict)
    # fused routes that degraded to their unfused twin (kernel caps, level
    # lanes, i32 ceilings) — forced-fused on an ineligible stream counts here
    fused_fallbacks: int = 0
    # the link rate the planner assumed (TPQ_LINK_MBPS or its default)
    planner_link_mbps: float = 0.0

    def count_route(self, route: str, logical: int, shipped: int) -> None:
        self.route_streams[route] = self.route_streams.get(route, 0) + 1
        self.route_bytes_logical[route] = (
            self.route_bytes_logical.get(route, 0) + logical)
        self.route_bytes_shipped[route] = (
            self.route_bytes_shipped.get(route, 0) + shipped)

    @property
    def link_bytes_logical(self) -> int:
        return sum(self.route_bytes_logical.values())

    @property
    def link_bytes_shipped(self) -> int:
        return sum(self.route_bytes_shipped.values())

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.wall_seconds if self.wall_seconds else 0.0

    def as_dict(self) -> dict:
        return {
            "row_groups": self.row_groups, "chunks": self.chunks,
            "pages": self.pages,
            "pages_device_expanded": self.pages_device_expanded,
            "rows": self.rows,
            "compressed_bytes": self.compressed_bytes,
            "staged_bytes": self.staged_bytes,
            "link_bytes_logical": self.link_bytes_logical,
            "link_bytes_shipped": self.link_bytes_shipped,
            "ship_routes": {
                r: {"streams": self.route_streams[r],
                    "logical": self.route_bytes_logical.get(r, 0),
                    "shipped": self.route_bytes_shipped.get(r, 0)}
                for r in sorted(self.route_streams)
            },
            "fused_fallbacks": self.fused_fallbacks,
            "planner_link_mbps": round(self.planner_link_mbps, 1),
            "host_seconds": round(self.host_seconds, 6),
            "stage_seconds": round(self.stage_seconds, 6),
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "rows_per_sec": round(self.rows_per_sec, 1),
        }


_VALIDATE_ON = ("1", "on", "true", "crc", "yes")
_VALIDATE_OFF = ("0", "off", "false", "no")


def _resolve_validate(validate_crc=None) -> bool:
    """``validate_crc`` as the reference resolves it: ``None`` reads
    ``TPQ_VALIDATE`` (default ``crc``: page CRCs are verified when
    present)."""
    if validate_crc is None:
        raw = os.environ.get("TPQ_VALIDATE", "crc").lower()
        return raw not in _VALIDATE_OFF
    if isinstance(validate_crc, bool):
        return validate_crc
    v = str(validate_crc).lower()
    if v in _VALIDATE_ON:
        return True
    if v in _VALIDATE_OFF:
        return False
    raise ValueError(f"validate_crc must be a bool, 'crc', or 'off'; "
                     f"got {validate_crc!r}")


def _check_leaf(leaf: SchemaNode) -> None:
    """Every flat leaf is in the slice; a repeated one is not yet."""
    if leaf.max_rep > 0:
        raise _out_of_slice(f"repeated column {'.'.join(leaf.path)}")


class DeviceFileReader:
    """Columnar file reader decoding straight to device tensors.

    ``source`` is a path, a binary file object or bytes; ``columns`` a
    projection (dotted names or paths); ``validate_crc`` resolves like the
    reference's (``None`` reads ``TPQ_VALIDATE``, default on).  ``device``
    defaults to ``cuda``: without a CUDA device the constructor raises —
    pass ``device="cpu"`` to decode with the kernels' plain versions.

    Nothing blocks until ``finalize()`` (called by ``read_row_group``;
    ``finalize=False`` defers it): staging and every kernel launch are
    asynchronous on the current stream."""

    def __init__(self, source, columns=None, validate_crc=None, device=None):
        self.device = _resolve_device(device)
        if isinstance(source, (str, os.PathLike)):
            self._f = open(source, "rb")
            self._owns_file = True
            self._source_name = os.fspath(source)
        elif isinstance(source, (bytes, bytearray, memoryview)):
            import io

            self._f = io.BytesIO(bytes(source))
            self._owns_file = False
            self._source_name = "<memory>"
        else:
            self._f = source
            self._owns_file = False
            self._source_name = getattr(source, "name", None) or "<stream>"
        try:
            self.validate_crc = _resolve_validate(validate_crc)
            self.metadata = read_file_metadata(self._f)
            self.schema = Schema.from_file_metadata(self.metadata)
            self.set_selected_columns(columns)
        except BaseException:
            if self._owns_file:
                self._f.close()
            raise
        self._deferred: list = []
        self._stats = ReaderStats()
        self._t0: "float | None" = None
        self._ship_planner = ShipPlanner()
        self._stats.planner_link_mbps = self._ship_planner.link_mbps
        self._pinned = _PinnedPool() if self.device.type == "cuda" else None

    def set_selected_columns(self, columns) -> None:
        """Project to ``columns`` (None = all); every selected leaf must be
        in the slice, or this raises ``NotImplementedError``."""
        if columns is None:
            self.schema.set_selected(None)
        else:
            paths = [tuple(c.split(".")) if isinstance(c, str) else tuple(c)
                     for c in columns]
            if not self.schema.selection_matches(paths):
                known = [".".join(l.path) for l in self.schema.leaves]
                raise ParquetError(
                    f"selected columns {['.'.join(p) for p in paths]} "
                    f"match no schema columns; available: {known}"
                )
            self.schema.set_selected(paths)
        for leaf in self.schema.selected_leaves():
            _check_leaf(leaf)

    def close(self) -> None:
        if self._owns_file:
            self._f.close()
            self._owns_file = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups or [])

    def stats(self) -> ReaderStats:
        return self._stats

    def _prepare_row_group(self, index: int):
        """Host phase: read, decompress and parse every selected chunk of the
        row group, registering all byte regions with ONE stager."""
        rg = self.metadata.row_groups[index]
        t0 = time.perf_counter()
        if self._t0 is None:
            self._t0 = t0
        leaves = {l.path: l for l in self.schema.selected_leaves()}
        out: dict[str, DeviceColumnData] = {}
        stager = _RowGroupStager()
        plans: list[tuple[str, _Plan]] = []
        for chunk in rg.columns or []:
            md = chunk.meta_data
            if md is None or md.path_in_schema is None:
                raise ParquetError("column chunk missing metadata/path")
            path = tuple(md.path_in_schema)
            leaf = leaves.get(path)
            if leaf is None:
                continue  # unselected: never read its bytes
            md, offset = validate_chunk_meta(chunk, leaf)
            self._f.seek(offset)
            buf = self._f.read(md.total_compressed_size)
            if len(buf) != md.total_compressed_size:
                raise ParquetError(
                    f"truncated file reading column {'.'.join(path)}: wanted "
                    f"{md.total_compressed_size} bytes at offset {offset}, "
                    f"got {len(buf)} — the file is shorter than its "
                    f"metadata claims")
            self._stats.chunks += 1
            self._stats.compressed_bytes += md.total_compressed_size
            ctx = {"file": self._source_name, "row_group": index,
                   "column": ".".join(path), "chunk_offset": offset}
            asm = _collect_chunk(buf, md.codec, md.num_values, leaf,
                                 self._deferred,
                                 validate_crc=self.validate_crc,
                                 statistics=md.statistics, context=ctx,
                                 device=self.device)
            asm.preship(self._ship_planner)
            self._stats.pages += len(asm.pages)
            name = ".".join(path)
            if not asm.pages:
                out[name] = DeviceColumnData(
                    values=torch.zeros(
                        0, dtype=_TORCH_DTYPES[_PTYPE_TO_NAME.get(
                            leaf.physical_type, "int64")],
                        device=self.device),
                    max_def=leaf.max_def, max_rep=leaf.max_rep,
                    num_leaf_slots=0,
                )
                continue
            plans.append((name, asm.finish(stager)))
            self._stats.pages_device_expanded += asm.pages_kept_compressed
            self._stats.fused_fallbacks += asm.fused_fallbacks
            for rec in asm.ship_records:
                self._stats.count_route(*rec)
        seen = set(out) | {name for name, _ in plans}
        missing = {".".join(p) for p in leaves} - seen
        if missing:
            raise ParquetError(
                f"row group {index} missing columns {sorted(missing)}"
            )
        self._stats.row_groups += 1
        self._stats.rows += rg.num_rows or 0
        self._stats.staged_bytes += stager.total
        now = time.perf_counter()
        self._stats.host_seconds += now - t0
        self._stats.wall_seconds = now - self._t0
        return out, plans, stager

    def _dispatch_row_group(self, prepared):
        out, plans, stager = prepared
        if plans:
            t0 = time.perf_counter()
            buf_dev = stager.stage(self.device, self._pinned)
            t1 = time.perf_counter()
            self._stats.stage_seconds += t1 - t0
            out.update(_run_plans(plans, buf_dev))
            self._stats.dispatch_seconds += time.perf_counter() - t1
        if self._t0 is not None:
            self._stats.wall_seconds = time.perf_counter() - self._t0
        return out

    def read_row_group(self, index: int, finalize: bool = True) -> dict:
        """Decode row group ``index``: ``{column name: DeviceColumnData}``."""
        out = self._dispatch_row_group(self._prepare_row_group(index))
        if finalize:
            self.finalize()
        return out

    def finalize(self) -> None:
        """Run the deferred dictionary-range checks (one device read for
        all chunks; there are none when the native run walk is built)."""
        deferred, self._deferred[:] = list(self._deferred), []
        if not deferred:
            return
        host_max = torch.stack([m for m, _, _ in deferred]).cpu().numpy()
        for mx, (_, dict_len, path) in zip(host_max, deferred):
            if int(mx) >= dict_len:
                raise ParquetError(
                    f"dictionary index {int(mx)} out of range ({dict_len}) "
                    f"in column {path}"
                )

    def iter_row_groups(self, finalize_each: bool = False):
        """Yield each row group's ``{column name: DeviceColumnData}``.  The
        host parses row group N+1 while the card still copies and decodes
        N (every launch is asynchronous)."""
        for i in range(self.num_row_groups):
            yield self.read_row_group(i, finalize=finalize_each)
        self.finalize()

    def iter_batches(self, batch_size: int, columns=None):
        """Yield fixed-size device batches ``{column: tensor[batch_size]}``.

        Rows flow across row-group boundaries; the final short remainder is
        NOT yielded (drop_remainder semantics).  Fixed-width, null-free
        columns only: a ragged BYTE_ARRAY column has no fixed row shape and
        raises ``TypeError``; a string dictionary column is materialized
        first, and raises too."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        want = None if columns is None else set(columns)
        carry: dict[str, torch.Tensor] = {}
        for cols in self.iter_row_groups():
            arrays = {}
            for name, col in cols.items():
                if want is not None and name not in want:
                    continue
                if isinstance(col, DeviceDictColumn):
                    col = col.materialize()
                if col.values is None:
                    raise TypeError(
                        f"iter_batches needs fixed-width columns; "
                        f"{name!r} is ragged (offsets/heap)"
                    )
                if col.num_values != col.num_leaf_slots:
                    raise TypeError(
                        f"iter_batches needs null-free columns; {name!r} has "
                        f"{col.num_leaf_slots - col.num_values} nulls"
                    )
                arrays[name] = col.values[: col.num_values]
            if want is not None:
                missing = want - set(arrays)
                if missing:
                    raise KeyError(
                        f"iter_batches: no such column(s) {sorted(missing)}"
                    )
            if not arrays:
                continue
            ns = {int(v.shape[0]) for v in arrays.values()}
            if len(ns) != 1:
                raise ParquetError(
                    f"iter_batches: column row counts differ: {sorted(ns)}"
                )
            if ns.pop() == 0:
                continue
            carry = {k: (torch.cat([carry[k], v]) if k in carry else v)
                     for k, v in arrays.items()}
            n = int(next(iter(carry.values())).shape[0])
            start = 0
            while n - start >= batch_size:
                yield {k: v[start : start + batch_size]
                       for k, v in carry.items()}
                start += batch_size
            carry = {k: v[start:] for k, v in carry.items()}
