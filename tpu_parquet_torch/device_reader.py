"""Batched device reader: one staged buffer per row group, decoded on the card.

The counterpart of ``tpu_parquet.device_reader`` for the flat-column slice.
Per row group:

1. the host walks the footer and each chunk's page headers, decompresses the
   pages and walks the RLE/bit-packed run headers (``_collect_chunk``);
2. per chunk, ``_ChunkAssembler`` picks the ship route (``ship.py``) and
   registers the bytes its kernels read with ONE ``_RowGroupStager``,
   returning a ``_Plan``;
3. the stager fills one pinned host buffer and copies it to the device in
   one ``non_blocking`` transfer;
4. ``_run_plans`` runs every chunk's decode over that one buffer: the
   hand-written CUDA kernels of ``cuda_kernels`` (K1 for dictionary indices
   and def levels, K2 for ``fused_plain`` PLAIN columns) and the tensor code
   of ``torch_kernels``;
5. the output is one :class:`DeviceColumnData` per column.

The slice: flat columns (REQUIRED or OPTIONAL, no repetition) of physical
type INT32, INT64, FLOAT and DOUBLE; PLAIN and RLE_DICTIONARY /
PLAIN_DICTIONARY pages; UNCOMPRESSED, SNAPPY and GZIP (decompressed on the
host); data pages v1 and v2; page CRCs.  Anything else raises
``NotImplementedError`` naming the slice — there is no host-decode fallback.

Nothing on the decode path waits for the device: the dictionary-index range
check runs on the host (``_check_dict_range``).  Only when the native run
walk is unavailable is the check deferred to one device read in
``finalize()``, as the reference defers it.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from . import torch_kernels as K
from .chunk_decode import _check_crc, validate_chunk_meta, walk_pages
from .compress import decompress_block
from .cuda_kernels import (bp_groups_pad, fused_count_pad, fused_plain_words,
                           unpack_bp_groups)
from .footer import ParquetError, read_file_metadata
from .format import Encoding, PageType, Type, parse_encoding
from .kernels import bitpack
from .schema.core import Schema, SchemaNode
from .ship import (ChunkFacts, FUSED_ROUTES, ROUTE_FUSED_PLAIN, ROUTE_PLAIN,
                   ShipPlanner)
from .torch_decode import (
    DeviceColumnData, ParsedDataPage, _bucket, _bucket_bytes, _bucket_count,
    _SLACK, _PTYPE_TO_NAME, _hybrid, _hybrid_vw, host_decode_dictionary,
    parse_data_page, parse_hybrid_meta,
)

__all__ = ["DeviceFileReader", "ReaderStats"]

SLICE = ("flat INT32/INT64/FLOAT/DOUBLE columns with PLAIN or dictionary "
         "pages (the tpu_parquet_torch flat-column slice)")

_I32_MAX = np.iinfo(np.int32).max

_TORCH_DTYPES = K._TORCH_DTYPES
# same-width integer view used to move float bits through gathers
_INT_OF = {"int32": torch.int32, "int64": torch.int64,
           "float32": torch.int32, "float64": torch.int64}


def _out_of_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not supported by {SLICE}")


def _check_plain_sizes(pages, width: int) -> None:
    """Reject PLAIN pages whose value stream is shorter than defined*width."""
    for p in pages:
        nbytes = len(p.raw) - p.value_pos
        if nbytes < p.defined * width:
            raise ParquetError(
                f"PLAIN data truncated: {nbytes} < {p.defined * width}"
            )


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


# ---------------------------------------------------------------------------
# the hybrid (RLE/bit-packed) path through K1
# ---------------------------------------------------------------------------

# BP payloads are staged as one host-side segment copy per bit-packed run;
# streams shattered into very many tiny runs keep the run-table expand path,
# whose staging is one segment per page (the reference's decline).
_PALLAS_MAX_SEGS = 4096


def _hybrid_combine_staged(vals, buf, tbase: int, n_valid: int, *,
                           count: int, rp: int):
    """Combine K1-unpacked BP values with RLE runs into stream order.

    Every output position finds its run with one searchsorted, then either
    broadcasts the RLE value or picks its BP element at
    ``bp_idx_base[run] + pos``.  Run tables ride the staged buffer at
    ``tbase`` (layout [ends i32 | is_rle u8 | values u32 | bp_idx_base i32]
    x rp); the index math is int32 like the reference's.  Lanes at or past
    ``n_valid`` are zeroed."""
    ends = _tslice(buf, tbase, 0, rp, torch.int32)
    isr = _tslice(buf, tbase, rp * 4, rp, torch.uint8) != 0
    rvals = _tslice(buf, tbase, rp * 5, rp, torch.int32)
    bib = _tslice(buf, tbase, rp * 9, rp, torch.int32)
    pos = torch.arange(count, dtype=torch.int32, device=buf.device)
    r = torch.searchsorted(ends, pos, right=True)
    r = torch.clamp(r, max=rp - 1)
    bp_idx = torch.clamp(bib[r] + pos, 0, vals.shape[0] - 1)
    out = torch.where(isr[r], rvals[r], vals[bp_idx.long()])
    return torch.where(pos < n_valid, out, torch.zeros_like(out))


def _plan_hybrid_pallas(stager: _RowGroupStager, pages_info, width: int,
                        total: int, count_pad: int):
    """Plan a hybrid expansion through K1 plus the run-table combine.

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
    # K1 reads gpad*width bytes from bp_base: past the real payload it sees
    # later regions' bytes — values the combine never selects
    stager.note_read_extent(bp_base, gpad * width)

    def fn(buf, bp_base_d, tbase_d, total_d):
        vals = unpack_bp_groups(buf, bp_base_d, width, gpad)
        return _hybrid_combine_staged(vals, buf, tbase_d, total_d,
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


def _plain(buf: torch.Tensor, off: int, *, dtype: str, count: int):
    nbytes = 8 if dtype in ("int64", "float64") else 4
    return K.plain_decode_fixed(buf[off : off + count * nbytes], dtype, count)


class _ChunkAssembler:
    """Collects a chunk's pages, then emits one device decode plan."""

    def __init__(self, leaf: SchemaNode, deferred_checks: list):
        self.leaf = leaf
        self.pages: list[ParsedDataPage] = []
        self.dict_u8: Optional[np.ndarray] = None
        self.dict_dtype: Optional[str] = None
        self.dict_len = 0
        self._deferred = deferred_checks  # (device max, dict_len, path)
        self._ship_pref: "list | None" = None
        # fused routes that degraded to their unfused twin (level lanes,
        # i32 ceilings) — a counter, never a crash
        self.fused_fallbacks = 0
        self.ship_records: list = []

    def _record_ship(self, route: str, logical: int, shipped: int) -> None:
        self.ship_records.append((route, int(logical), int(shipped)))

    # -- dictionary ----------------------------------------------------------

    def set_dictionary(self, raw: bytes, encoding: int, count: int) -> None:
        decoded = host_decode_dictionary(raw, self.leaf, encoding, count)
        if not isinstance(decoded, tuple):
            raise _out_of_slice("byte-array dictionary")
        self.dict_u8, self.dict_dtype, self.dict_len = decoded

    # -- ship planning -------------------------------------------------------

    def preship(self, planner: ShipPlanner) -> None:
        """Route choice for a PLAIN fixed-width chunk (``ship.py``)."""
        if not self.pages:
            return
        if {parse_encoding(p.encoding) for p in self.pages} != {Encoding.PLAIN}:
            return
        leaf = self.leaf
        width = np.dtype(_PTYPE_TO_NAME[leaf.physical_type]).itemsize
        defined = sum(p.defined for p in self.pages)
        self._ship_pref = planner.routes(ChunkFacts(
            logical=defined * width, width=width,
            flat=leaf.max_def == 0 and leaf.max_rep == 0))

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
        if encs == {Encoding.RLE_DICTIONARY}:
            value_plan = self._finish_dict(common, stager)
        elif encs == {Encoding.PLAIN}:
            value_plan = self._finish_plain_fixed(common, stager)
        else:
            names = sorted(e.name for e in encs)
            raise _out_of_slice(
                f"column {'.'.join(leaf.path)} with encodings {names}")
        # every plan has captured what it needs: drop the parsed pages
        self.pages = []
        return _compose_column(value_plan, d_plan)

    def _plan_levels(self, stager: _RowGroupStager, streams, width: int,
                     slots: int, slots_pad: int, metas=None):
        """Stage the pages' raw RLE level streams and expand them on the
        device: through K1 where the stream has bit-packed runs, else the
        run-table expand.  The plan yields ``int32[slots_pad]`` (tail past
        ``slots`` zeroed)."""
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
        order, falling through on infeasibility; ``plain`` cannot fail."""
        name = _PTYPE_TO_NAME[self.leaf.physical_type]
        for route in self._ship_pref or [ROUTE_PLAIN]:
            if route == ROUTE_PLAIN:
                break
            plan = None
            if route == ROUTE_FUSED_PLAIN:
                plan = self._plan_fused_plain(common, stager, name)
            if plan is None and route in FUSED_ROUTES:
                self.fused_fallbacks += 1
            if plan is not None:
                return plan
        width = np.dtype(name).itemsize
        base, defined, count = self._stage_fixed_width(stager, width)
        logical = defined * width
        self._record_ship(ROUTE_PLAIN, logical, logical)
        return _Plan(
            lambda buf, base_d: _plain(buf, base_d, dtype=name, count=count),
            (base,),
            lambda v: DeviceColumnData(values=v, n_values=defined, **common),
        )

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
        """Dictionary-encoded chunk: the index stream through K1 and the
        staged run-table combine (one uniform index width), or the run-table
        expand (per-page widths, or too many runs); then a dictionary
        gather on the device."""
        if self.dict_u8 is None:
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
        name = self.dict_dtype
        if name not in _TORCH_DTYPES:
            raise _out_of_slice(f"dictionary of {name} values")
        # the dictionary rides the row-group buffer, bucketed and zero-filled
        # past dict_len so clamped tail gathers read zeros
        dict_kp = _bucket(max(self.dict_len, 1))
        itemsize = int(self.dict_u8.shape[1])
        dict_base = stager.add(np.ascontiguousarray(self.dict_u8),
                               reserve=dict_kp * itemsize)
        n_idx = len(idx_dyn)
        deferred = self._deferred
        dict_len = self.dict_len
        path_name = ".".join(self.leaf.path)
        int_dt, val_dt = _INT_OF[name], _TORCH_DTYPES[name]

        def fn(buf, *d):
            idx = idx_fn(buf, *d[:n_idx])
            table = _tslice(buf, d[n_idx], 0, dict_kp, int_dt)
            vals = K.dict_gather(table, idx).view(val_dt)
            mx = (idx.to(torch.int64) & 0xFFFFFFFF).max() if need_max else None
            return vals, mx

        def build(res):
            vals, mx = res
            if mx is not None:
                deferred.append((mx, dict_len, path_name))
            return DeviceColumnData(values=vals, n_values=prefix, **common)

        return _Plan(fn, tuple(idx_dyn) + (dict_base,), build)


def _collect_chunk(buf: bytes, codec: int, total_values: int,
                   leaf: SchemaNode, deferred_checks: list,
                   validate_crc: bool = False) -> _ChunkAssembler:
    """Walk a chunk's pages into an assembler (host phase): CRC checks,
    host decompression, the dictionary page, and each data page's level
    and index structure."""
    asm = _ChunkAssembler(leaf, deferred_checks)
    for ps in walk_pages(buf, total_values):
        header = ps.header
        pt = header.type
        if pt == PageType.DICTIONARY_PAGE:
            payload = buf[ps.payload_start : ps.payload_end]
            _check_crc(header, payload, validate_crc)
            raw = decompress_block(payload, codec,
                                   header.uncompressed_page_size)
            dh = header.dictionary_page_header
            asm.set_dictionary(raw, dh.encoding, dh.num_values or 0)
            continue
        if pt in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
            asm.pages.append(
                parse_data_page(ps, buf, codec, leaf,
                                validate_crc=validate_crc,
                                decode_levels=False)
            )
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
    # fused routes that degraded to their unfused twin (level lanes, i32
    # ceilings) — forced-fused on an ineligible stream counts here
    fused_fallbacks: int = 0

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
            "pages": self.pages, "rows": self.rows,
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


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DeviceFileReader decodes on the CUDA device by default and no "
            "CUDA device is available; pass device='cpu' to decode with the "
            "kernels' plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_leaf(leaf: SchemaNode) -> None:
    path = ".".join(leaf.path)
    if leaf.max_rep > 0:
        raise _out_of_slice(f"repeated column {path}")
    if leaf.physical_type not in _PTYPE_TO_NAME:
        raise _out_of_slice(
            f"column {path} of physical type {leaf.physical_type!r}")


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
        elif isinstance(source, (bytes, bytearray, memoryview)):
            import io

            self._f = io.BytesIO(bytes(source))
            self._owns_file = False
        else:
            self._f = source
            self._owns_file = False
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
                    f"got {len(buf)}")
            self._stats.chunks += 1
            self._stats.compressed_bytes += md.total_compressed_size
            asm = _collect_chunk(buf, md.codec, md.num_values, leaf,
                                 self._deferred,
                                 validate_crc=self.validate_crc)
            asm.preship(self._ship_planner)
            self._stats.pages += len(asm.pages)
            name = ".".join(path)
            if not asm.pages:
                out[name] = DeviceColumnData(
                    values=torch.zeros(
                        0, dtype=_TORCH_DTYPES[_PTYPE_TO_NAME[
                            leaf.physical_type]], device=self.device),
                    max_def=leaf.max_def, max_rep=leaf.max_rep,
                    num_leaf_slots=0,
                )
                continue
            plans.append((name, asm.finish(stager)))
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
        NOT yielded (drop_remainder semantics).  Null-free columns only."""
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        want = None if columns is None else set(columns)
        carry: dict[str, torch.Tensor] = {}
        for cols in self.iter_row_groups():
            arrays = {}
            for name, col in cols.items():
                if want is not None and name not in want:
                    continue
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
