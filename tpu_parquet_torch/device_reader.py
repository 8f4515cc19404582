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
3. the stager fills pinned host buffers and copies them to the device with
   ``non_blocking`` transfers: one buffer, or 16 MiB strips streamed while
   the group is still parsed;
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

The slice: every column the reference reads, flat or nested (REQUIRED,
OPTIONAL and repeated leaves: LIST, MAP, nested groups, legacy two-level
lists) — BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY and
FIXED_LEN_BYTE_ARRAY; UNCOMPRESSED, SNAPPY, GZIP and ZSTD; data pages v1
and v2; page CRCs.  Def and rep levels are planned alike: each page's RLE
level stream goes through the fused K1 where it has bit-packed runs.
Batched on the row group's buffer: PLAIN,
dictionary and DELTA_BINARY_PACKED chunks, PLAIN BOOLEAN, INT96 and FLBA,
and the dictionary fallback (a dictionary-encoded prefix of pages, then
PLAIN pages) of a fixed-width column.  Every other chunk (BYTE_STREAM_SPLIT,
DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY, boolean RLE, other mixes of
encodings) takes the host-decode path, ``_finish_host``: page by page
through ``torch_decode.DeviceChunkDecoder``, staged per page.
``decode_chunk_batched`` decodes one chunk without a reader.

Every raise of the chunk walk carries the decode site
(``errors.error_context``: file, column, row group, page, byte offset).

Nothing on the decode path waits for the device: the dictionary-index range
check runs on the host (``_check_dict_range``).  Only when the native run
walk is unavailable is the check deferred to one device read in
``finalize()``, as the reference defers it.

The host pipeline (``iter_row_groups``, ``scan_files``): a one-thread
staging worker stages row group N while the consumer thread runs steps 1-2
for N+1, and with ``prefetch=K`` a pool runs steps 1 and the host half of
2 for upcoming chunks (``_chunk_feed``, across row groups and files);
``finish``, the launches and the deferred checks stay on the consumer
thread; the staging copies run on the worker, on the consumer's stream.

The scan options: ``row_filter`` prunes row groups (footer statistics) and
page runs (page-header statistics, ``scanplan.plan_page_pruning``; skipped
pages are never decompressed, staged or decoded); a ``scanplan.ScanPlan``
memoizes each group's pruning and each chunk's ship route and kernel
family, and ``plan=`` replays it; ``on_data_error`` / ``quarantine``
contain a row group's data error (``ParquetError``) in the iteration APIs
and ``scan_files`` (``quarantine.Quarantine``).

The read caches (``serve``): ``dict_cache`` reads decoded dictionary pages
through a shared cache (``_collect_chunk``); ``result_cache`` serves a row
group whose every column its device tier holds without IO, staging or a
launch, and publishes a decoded group after the finalize that checks it,
once an event recorded behind its launches has completed (the range check
runs on the host, so the finalize alone need not wait for the device).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import logging
import os
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Optional

import numpy as np
import torch

from . import cuda_kernels as _CK
from . import chunk_walk, native
from . import torch_kernels as K
from .alloc import AllocTracker, InFlightBudget
from .chunk_decode import _check_crc, walk_pages
from .errors import (CancelledError, DataIntegrityError,
                     DeadlineExceededError, HangError, annotate_data_error,
                     error_context)
from .column import ByteArrayData
from .compress import decompress_block
from .cuda_kernels import (FUSED_MAX_DEPTH, FUSED_MAX_OPS, FUSED_MAX_PAYLOAD,
                           SNAPPY_OPS_BYTES, bp_groups_pad, fused_count_pad,
                           fused_narrow_count_pad, fused_narrow_words,
                           fused_plain_words, hybrid_unpack_combine)
from .footer import ParquetError
from .format import CompressionCodec, Encoding, PageType, Type, parse_encoding
from .iostore import CoalescedFetcher, require_full
from .iostore_async import engine_for_store
from .kernels import bitpack
from .kernels.delta import _read_uvarint
from .obs import (PART_READ, HostPhaseStats, Sampler, StatsRegistry,
                  Watchdog, current_request_trace, env_float, env_int,
                  note_chunk_walk, note_levels, register_flight_registry,
                  resolve_hang_s,
                  resolve_sample_ms, resolve_tracer, snappy_walks_settle,
                  timed_part, warn_env_once)
from .pipeline import PipelineStats, prefetch_map
from .quarantine import Quarantine
# a chunk's data error riding the ordered chunk feed: ``_prepare_row_group``
# raises it, so the scan pipeline contains both paths alike
from .reader import FileReader, _ChunkFailed as _FailedChunk
from .scanplan import (int_stats_span as _int_stats_span, plan_page_pruning,
                       predicate_fingerprint, row_group_chunks)
from .schema.core import SchemaNode
from .serve.result_cache import (DEVICE_TENSOR_ATTRS, device_column_nbytes,
                                 device_tag)
from .ship import (
    ChunkFacts, FUSED_ROUTES, ROUTE_DEVICE_SNAPPY, ROUTE_FUSED_NARROW_SNAPPY,
    ROUTE_FUSED_PLAIN, ROUTE_NARROW, ROUTE_NARROW_SNAPPY, ROUTE_PLAIN,
    ROUTE_RECOMPRESS, SNAPPY_WORTH_RATIO, ShipPlanner, default_planner,
)
from .torch_decode import (
    DeviceColumnData, ParsedDataPage, _bucket, _bucket_bytes, _bucket_count,
    _SLACK, _PTYPE_TO_NAME, _concat_ragged, _h2d, _hybrid, _hybrid_vw,
    _max_index, _plain, _plain_flba, _plain_rows,
    _resolve_device, host_decode_dictionary, parse_data_page,
    parse_delta_meta, parse_hybrid_meta, parse_level_meta,
)

__all__ = ["DeviceDictColumn", "DeviceFileReader", "DeviceStats",
           "ReaderStats", "decode_chunk_batched", "scan_files"]

SLICE = ("flat and nested columns (repeated leaves: LIST, MAP, nested "
         "groups) of every physical type (BYTE_ARRAY and "
         "FIXED_LEN_BYTE_ARRAY included) with PLAIN, dictionary, "
         "DELTA_BINARY_PACKED, BYTE_STREAM_SPLIT, delta byte-array or boolean "
         "RLE pages")

_I32_MAX = np.iinfo(np.int32).max

_TORCH_DTYPES = K._TORCH_DTYPES


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
    """Pinned host buffers for staging, reused across row groups and shared
    between the staging worker and the consumer thread (a lock guards the
    free list).

    A buffer handed to a ``non_blocking`` copy must stay untouched until
    the copy has completed: each returned buffer carries the event recorded
    after its copy, and ``take`` reuses only a buffer whose event has
    completed, else pins a new one.  With strip streaming one row group
    holds a buffer per in-flight strip, so the pool keeps up to ``KEEP``
    free buffers: the strips of a large row group, its tail and the next
    group's first strip.  A dropped buffer goes back to PyTorch's pinned
    allocator, which itself waits for the copies recorded against it.
    ``held_bytes`` (and its peak) counts the pinned bytes the pool owns:
    free, or out with a copy not yet given back (``out_bytes``)."""

    KEEP = 12

    def __init__(self):
        self._free: list = []  # [(pinned uint8 tensor, cuda event)]
        self._lock = threading.Lock()
        self.held_bytes = 0
        self.peak_held_bytes = 0
        # bytes of the buffers taken and not yet given back
        self.out_bytes = 0

    def take(self, nbytes: int) -> torch.Tensor:
        with self._lock:
            best = None
            for i, (buf, ev) in enumerate(self._free):
                if buf.numel() >= nbytes and ev.query() and (
                        best is None
                        or buf.numel() < self._free[best][0].numel()):
                    best = i
            if best is not None:
                buf = self._free.pop(best)[0]
                self.out_bytes += buf.numel()
                return buf
            room = max(_bucket_bytes(nbytes, 1 << 20), nbytes)
            self.held_bytes += room
            self.out_bytes += room
            self.peak_held_bytes = max(self.peak_held_bytes,
                                       self.held_bytes)
        return torch.empty(room, dtype=torch.uint8, pin_memory=True)

    def give(self, buf: torch.Tensor, event) -> None:
        with self._lock:
            self.out_bytes -= buf.numel()
            self._free.append((buf, event))
            if len(self._free) > self.KEEP:
                self._free.sort(key=lambda e: e[0].numel())
                self.held_bytes -= self._free.pop(0)[0].numel()


class _RowGroupStager:
    """One staged host->device transfer for a whole row group.

    Every chunk registers its host byte regions here (value streams, level
    streams, packed run tables, dictionaries); ``stage()`` ships ONE buffer
    and each chunk's kernels address into it by base offset.  Regions start
    on 64-byte boundaries.

    With an ``executor`` (the reader's staging worker), registration also
    streams: each time the arena grows past a ``STRIP`` boundary, the
    completed strip is filled and copied to the card on the worker while
    the consumer thread still parses the row group's later chunks, and
    ``stage()`` ships the tail and joins the strips on the card.  A row
    group under one strip, or a stager without an executor, takes the
    single-buffer path.  The streamed buffer is ``flushed + bucket(tail)``
    bytes where the single one is ``bucket(need + _SLACK)``: both are at
    least ``need + _SLACK`` long and equal in their first ``need`` bytes.

    Every copy of the stager runs on the stream that was current on the
    thread that made it (the consumer's: PyTorch's current stream is per
    thread, so a worker would otherwise enqueue on the default stream), on
    ``device``, with host buffers from ``pool``.  ``ready`` is the event
    recorded after the last copy.  A ``timed`` stager on the card brackets
    each copy with timing events (``copy_marks``: the device lane's
    ``h2d``).  ``host_phase`` (the reader's ``HostPhaseStats``) takes the
    strip jobs' CPU seconds on the worker."""

    STRIP = 16 << 20

    def __init__(self, executor=None, device: "torch.device | None" = None,
                 pool: "_PinnedPool | None" = None, timed: bool = False,
                 host_phase: "HostPhaseStats | None" = None):
        # ("arr", u8, base, nbytes) | ("segs", segments, base, nbytes)
        self._parts: list[tuple] = []
        self.total = 0
        self._max_read_end = 0
        self._ex = executor
        self._device = torch.device("cpu") if device is None else device
        self._pool = pool
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        self._strip_futs: list = []
        self._flushed = 0  # arena bytes handed to strip jobs
        self.ready = None
        self._timed = bool(timed) and self._stream is not None
        self.copy_marks: list = []  # (start, end) timing events per copy
        self._host_phase = host_phase

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
        self._flush_ready()
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
        self._flush_ready()
        return bases + base

    def note_read_extent(self, base: int, nbytes: int) -> None:
        """Declare that a kernel reads ``nbytes`` from ``base`` — possibly
        past the registered region.  ``stage()`` sizes the buffer to the
        largest declared extent: the card does not clamp a read past the
        end of a buffer."""
        self._max_read_end = max(self._max_read_end, base + nbytes)

    def size(self) -> int:
        """The single-buffer path's size."""
        need = max(self.total, self._max_read_end)
        return _bucket_bytes(need + _SLACK, 64)

    def fill(self, buf: np.ndarray) -> None:
        """The arena into ``buf`` from byte 0, the rest zeroed."""
        self._copy_range(buf, 0, len(buf))

    def _copy_range(self, buf: np.ndarray, lo: int, hi: int) -> None:
        """Copy every registered byte in [lo, hi) into ``buf``, zeroing
        only the gaps (alignment and zero-filled reserves).  Parts are
        appended in ascending base order and never changed, so the worker
        may scan the list while the consumer appends."""
        pos = lo
        for kind, payload, base, nbytes in self._parts:
            if base >= hi:
                break
            if base + nbytes <= lo:
                continue
            s = max(lo, base)
            if s > pos:
                buf[pos - lo : s - lo] = 0
            if kind == "arr":
                e = min(hi, base + nbytes)
                buf[s - lo : e - lo] = payload[s - base : e - base]
                pos = e
            else:
                off = base
                for raw, start, size in payload:
                    if off >= hi:
                        break
                    if off + size > lo:
                        s = max(lo, off)
                        e = min(hi, off + size)
                        buf[s - lo : e - lo] = np.frombuffer(
                            raw, np.uint8, e - s, start + (s - off))
                        pos = e
                    off += size
        if pos < hi:
            buf[pos - lo :] = 0

    def _ship(self, lo: int, nbytes: int) -> torch.Tensor:
        """Fill arena bytes [lo, lo + nbytes) and put them on the device:
        through a pinned buffer and one ``non_blocking`` copy on the
        stager's stream on the card (``ready`` its event), a plain tensor
        elsewhere."""
        dev = self._device
        if dev.type != "cuda":
            host = torch.empty(nbytes, dtype=torch.uint8)
            self._copy_range(host.numpy(), lo, lo + nbytes)
            return host if dev.type == "cpu" else host.to(dev)
        pool = self._pool if self._pool is not None else _PinnedPool()
        host = pool.take(nbytes)
        self._copy_range(host.numpy()[:nbytes], lo, lo + nbytes)
        with torch.cuda.stream(self._stream):
            start = self._mark()
            out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
            out.copy_(host[:nbytes], non_blocking=True)
            ev = torch.cuda.Event(enable_timing=self._timed)
            ev.record(self._stream)
        if start is not None:
            self.copy_marks.append((start, ev))
        pool.give(host, ev)
        self.ready = ev
        return out

    def _mark(self):
        """A timing event recorded on the stager's stream (timed stagers)."""
        if not self._timed:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def _flush_ready(self) -> None:
        """Hand every newly completed strip to the worker."""
        if self._ex is None:
            return
        while self.total - self._flushed >= self.STRIP:
            lo = self._flushed
            self._flushed += self.STRIP
            self._strip_futs.append(
                self._ex.submit(self._ship_strip, lo, self.STRIP))

    def _ship_strip(self, lo: int, nbytes: int) -> torch.Tensor:
        """A strip job on the worker: ``_ship``, its CPU seconds to the
        reader's ``stage_cpu_seconds``."""
        c0 = time.thread_time()
        try:
            return self._ship(lo, nbytes)
        finally:
            if self._host_phase is not None:
                self._host_phase.add_stage_cpu(time.thread_time() - c0)

    def abandon(self) -> None:
        """Drop a row group whose host phase failed: join the strips in
        flight (their pinned buffers go back to the pool as each copy is
        enqueued) and free their device halves.  A strip's own failure
        (a CUDA error) is raised, never swallowed."""
        futs, self._strip_futs = self._strip_futs, []
        for fut in futs:
            fut.result()

    def stage(self, device: "torch.device | None" = None,
              pool: "_PinnedPool | None" = None) -> torch.Tensor:
        """Ship the arena and return it on the device.  ``device`` and
        ``pool`` stand in for the constructor's on a stager without an
        executor (no strip has shipped yet)."""
        if device is not None and torch.device(device) != self._device:
            if self._ex is not None:
                raise ValueError("a streaming stager stages on the device "
                                 "it was made for")
            self._device = torch.device(device)
            self._stream = (torch.cuda.current_stream(self._device)
                            if self._device.type == "cuda" else None)
        if pool is not None:
            self._pool = pool
        if not self._strip_futs:
            return self._ship(0, self.size())
        # streaming: the strips are in flight; ship the tail, then join
        # them on the card
        need = max(self.total, self._max_read_end)
        tail_len = _bucket_bytes(need + _SLACK - self._flushed, 64)
        parts = [f.result() for f in self._strip_futs]
        parts.append(self._ship(self._flushed, tail_len))
        self._strip_futs.clear()
        if self._device.type != "cuda":
            return torch.cat(parts)
        with torch.cuda.stream(self._stream):
            start = self._mark()
            buf = torch.cat(parts)
            self.ready = torch.cuda.Event(enable_timing=self._timed)
            self.ready.record(self._stream)
        if start is not None:
            self.copy_marks.append((start, self.ready))
        return buf


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
    stream order, or the same pages' runs already concatenated (a
    ``chunk_walk.RunTables``, whose bit-packed payloads come packed back to
    back).  Registers each bit-packed run's payload with the stager
    so the staged buffer holds ALL BP groups contiguously (RLE values never
    ship — they live in the run table), then returns a ``_Plan`` producing
    ``int32[count_pad]`` (uint32 bits).  Returns None when the stream has no
    K1-eligible shape (width 0, no BP groups, a pathological run count, or
    an int32 overflow of the combine's index math) — callers then take the
    run-table expand path, exactly as the reference declines."""
    if width <= 0 or width > 32 or total > _I32_MAX:
        return None
    runs = pages_info if isinstance(pages_info, chunk_walk.RunTables) else None
    if runs is not None:
        ks = runs.ks
    else:
        ks = np.array([m.n_runs for m, _, _ in pages_info], dtype=np.int64)
    nr = int(ks.sum())
    if nr == 0:
        return None
    if runs is not None:
        ends_c, isr, rvals, bst = runs.ends, runs.kinds, runs.vals, runs.starts
        pcounts = runs.counts
    else:
        ends_c = np.concatenate(
            [m.run_ends[: m.n_runs] for m, _, _ in pages_info])
        isr = np.concatenate(
            [m.run_is_rle[: m.n_runs] for m, _, _ in pages_info])
        rvals = np.concatenate(
            [m.run_values[: m.n_runs] for m, _, _ in pages_info])
        bst = np.concatenate(
            [m.run_bit_starts[: m.n_runs] for m, _, _ in pages_info])
        pcounts = np.array([c for _, _, c in pages_info], dtype=np.int64)
    run_page_start = np.repeat(np.cumsum(ks) - ks, ks)  # first run idx of page
    page_of = np.repeat(np.arange(len(ks)), ks)
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
    if runs is not None:
        # the same bytes as the segments below, already back to back
        bp_base = stager.add(runs.packed_bytes())
    else:
        srcs = [s for _, s, _ in pages_info]
        bp_base = int(stager.add_segments([
            (srcs[p], int(b), int(g) * width)
            for p, b, g in zip(page_of[sel], pay[sel], groups[sel])])[0])
    # K1 may read gpad*width bytes from bp_base: past the real payload it
    # sees later regions' bytes — values the combine never selects
    stager.note_read_extent(bp_base, gpad * width)
    fn = functools.partial(hybrid_unpack_combine, width=width, gpad=gpad,
                           count=count_pad, rp=rp)
    # the unpack and the run-table combine: two passes in the reference
    return _Plan(fn, (bp_base, tbase, total), None, stages=2)


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
                snappy_walks_settle(False)
                return None
            plans.append((spec, r, out_len))
            n_ops_total += len(r[0])
        else:
            out_len = spec[3]
            plans.append((spec, None, out_len))
            n_ops_total += 1
        total_out += out_len
    if n_ops_total == 0 or n_ops_total > _SNAPPY_MAX_OPS:
        # every stream walked for this shipment is thrown away
        snappy_walks_settle(False)
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
        snappy_walks_settle(False)
        return None  # i32 source/table math would overflow
    snappy_walks_settle(True)
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
        snappy_walks_settle(False)
        return None
    n_ops_pad = _bucket(n_ops)
    if n_ops_pad > FUSED_MAX_OPS:
        snappy_walks_settle(False)
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
    carry ``build=None``; ``fn=None`` is a pass-through whose column was
    made at prepare time (``build(None)`` returns it).  ``family`` names
    the plan's kernel family (``plain``, ``snappy_resolve``, ``narrow``,
    ``fused``, ``gather``, ``unpack``; a composed column takes its value
    plan's).

    ``stages`` is the reference's structural count of separate device
    passes for the same plan (3 by default, a pass-through 0, a fused
    kernel 1, the snappy chains 3 plus their pointer-doubling rounds): the
    device lane reports it as ``device_passes``, so the registry trees of
    both packages hold the same numbers.  ``route``, ``bytes_in`` and
    ``bytes_staged`` are set at prepare from the chunk's ship records (its
    dominant route, logical and shipped bytes): the device lane's keys."""

    __slots__ = ("fn", "dyn", "build", "family", "stages", "route",
                 "bytes_in", "bytes_staged")

    def __init__(self, fn, dyn, build, family: str = "plain",
                 stages: "int | None" = None):
        self.fn = fn
        self.dyn = tuple(dyn)
        self.build = build
        # the kernel family the reference names for this plan's key
        # (its _KERNEL_FAMILIES): the ScanPlan route memo records it
        self.family = family
        self.stages = (stages if stages is not None
                       else (3 if fn is not None else 0))
        self.route = None
        self.bytes_in = 0
        self.bytes_staged = 0


def _run_plans(plans, buf_dev, timer: "_DeviceTimer | None" = None):
    """Execute ``[(name, _Plan)]`` against the staged buffer; every launch
    is asynchronous on the current stream.  A pass-through plan
    (``fn=None``) only builds.

    With a ``timer`` (the reader's device lane) each launched plan is
    bracketed by the timer's marks (timing events on the card) and handed
    to its worker under the plan's route and kernel family, with the CUDA
    kernel launches counted inside it."""
    out = {}
    timing = timer is not None and timer.enabled
    for name, p in plans:
        if p.fn is None:
            out[name] = p.build(None)
            continue
        if not timing:
            out[name] = p.build(p.fn(buf_dev, *p.dyn))
            continue
        before = dict(_CK.launches)
        t0 = timer.mark()
        res = p.fn(buf_dev, *p.dyn)
        timer.submit("dispatch", p.route or ROUTE_PLAIN, p.family, t0,
                     bytes_in=p.bytes_in, bytes_staged=p.bytes_staged,
                     passes=p.stages,
                     cuda={k: n - before.get(k, 0)
                           for k, n in _CK.launches.items()
                           if n != before.get(k, 0)} or None)
        out[name] = p.build(res)
    return out


def _compose_column(value_plan: "_Plan", d_plan, r_plan) -> "_Plan":
    """Fuse a chunk's value plan with its def- and rep-level plans into one
    _Plan producing the finished DeviceColumnData (a pass-through value
    plan contributes no launch)."""
    if d_plan is None and r_plan is None:
        return value_plan
    nv = len(value_plan.dyn)
    nd = len(d_plan.dyn) if d_plan is not None else 0
    v_fn = value_plan.fn
    d_fn = d_plan.fn if d_plan is not None else None
    r_fn = r_plan.fn if r_plan is not None else None

    def fn(buf, *dyn):
        return (v_fn(buf, *dyn[:nv]) if v_fn is not None else None,
                d_fn(buf, *dyn[nv : nv + nd]) if d_fn is not None else None,
                r_fn(buf, *dyn[nv + nd :]) if r_fn is not None else None)

    def build(res):
        vres, dres, rres = res
        col = value_plan.build(vres)
        if d_plan is not None:
            col.def_levels = dres
        if r_plan is not None:
            col.rep_levels = rres
        return col

    dyn = (value_plan.dyn + (d_plan.dyn if d_plan is not None else ())
           + (r_plan.dyn if r_plan is not None else ()))
    stages = (value_plan.stages
              + (d_plan.stages if d_plan is not None else 0)
              + (r_plan.stages if r_plan is not None else 0))
    return _Plan(fn, dyn, build, family=value_plan.family, stages=stages)


def _fused_words_cast(words: torch.Tensor, dtype: str) -> torch.Tensor:
    """Finished little-endian u32 words from K2 -> the value tensor (a view;
    DOUBLE becomes float64)."""
    return words.view(_TORCH_DTYPES[dtype]).reshape(-1)


def _page_encodings(pages) -> set:
    """The pages' value encodings, each distinct one parsed once, in page
    order (the first unknown one raises)."""
    return {parse_encoding(e)
            for e in dict.fromkeys(p.encoding for p in pages)}


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
        self.pages_pruned = 0  # data pages page-level pushdown skipped
        # fused routes that degraded to their unfused twin (kernel caps,
        # level lanes, i32 ceilings) — a counter, never a crash
        self.fused_fallbacks = 0
        self.ship_records: list = []
        # how the pages were collected: "native" (the chunk walk) or the
        # walk's fallback reason; None on the page loop alone
        self.walk: "str | None" = None
        # each level plan of finish: (kind, slots, streams, route, t0, t1),
        # the ``levels`` spans of the chunk; a list only while spans are
        # recorded
        self.level_plans: "list | None" = None
        # AllocTracker: the link-recompression copies count against the
        # budget too (set by _collect_chunk)
        self.alloc = None
        # the planner's modelled seconds per feasible route (preship): the
        # bottleneck lane's, the device lane's, and for fused routes the
        # unfused chain's device seconds (obs.StatsRegistry.ship_feedback
        # sets them beside the measured lanes)
        self._ship_costs: dict = {}
        self._ship_dev_costs: dict = {}
        self._ship_unfused_dev: dict = {}
        # the same for the dictionary value table
        self._dict_costs: dict = {}
        self._dict_dev_costs: dict = {}
        # a replayed ScanPlan's memoized route: preship puts it first
        self._route_hint: "str | None" = None

    def _record_ship(self, route: str, logical: int, shipped: int,
                     predicted: "float | None" = None,
                     predicted_device: "float | None" = None) -> None:
        """One shipped stream: route, logical and shipped bytes, and the
        planner's predictions for it (a value stream's from the preship
        cost tables, a dictionary table's passed in)."""
        if predicted is None:
            predicted = self._ship_costs.get(route, 0.0)
        if predicted_device is None:
            predicted_device = self._ship_dev_costs.get(route, 0.0)
        self.ship_records.append(
            (route, int(logical), int(shipped), float(predicted),
             float(predicted_device),
             float(self._ship_unfused_dev.get(route, 0.0))))

    def _apply_route_hint(self) -> None:
        """Move a replayed route memo to the head of the preference order.

        Only a route the model priced feasible for this chunk moves up (a
        hint recorded for other data never forces an impossible build); the
        rest of the ranked order stays behind it as the fallback."""
        h = self._route_hint
        if (h and self._ship_pref and h in self._ship_costs
                and self._ship_pref[0] != h):
            self._ship_pref = [h] + [r for r in self._ship_pref if r != h]

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

    def dict_cache_entry(self) -> "dict | None":
        """This chunk's decoded dictionary as a read-through cache entry
        (``serve.PlanCache``): the host table (``dict_u8`` numpy rows or
        the ragged ``ByteArrayData``; the assembler stages it with its row
        group), the dictionary page's snappy payload when it has one, and
        the byte size.  None when the chunk has no dictionary."""
        if self.dict_len == 0:
            return None
        if self.dict_u8 is not None:
            nbytes = int(self.dict_u8.nbytes)
        elif self.dict_ragged is not None:
            nbytes = int(self.dict_ragged.offsets.nbytes
                         + self.dict_ragged.heap.nbytes)
        else:
            return None
        if self.dict_comp is not None:
            nbytes += len(self.dict_comp[0])
        return {
            "u8": self.dict_u8, "dtype": self.dict_dtype,
            "ragged": self.dict_ragged, "len": self.dict_len,
            "comp": self.dict_comp, "nbytes": nbytes,
        }

    def adopt_dictionary(self, entry: dict) -> None:
        """Adopt a cached decoded dictionary (the inverse of
        :meth:`dict_cache_entry`).  The tables are shared read-only across
        assemblers: every consumer stages or gathers from them, never
        writes them."""
        self.dict_u8 = entry.get("u8")
        self.dict_dtype = entry.get("dtype")
        self.dict_ragged = entry.get("ragged")
        self.dict_len = int(entry.get("len") or 0)
        self.dict_comp = entry.get("comp")

    # -- ship planning (host half; see ship.py) -------------------------------

    def _try_snappy(self, stream, pipe_stats=None):
        """snappy over one host stream; returns the payload only when it
        beats SNAPPY_WORTH_RATIO — thin wins lose to the op tables and the
        device resolve."""
        if not native.available():
            return None
        nbytes = len(stream) if isinstance(stream, (bytes, bytearray)) \
            else stream.nbytes
        if nbytes == 0:
            return None
        if self.alloc is not None:
            # the worst-case compressed size, registered BEFORE it exists
            self.alloc.register_transient(nbytes + nbytes // 6 + 32)
        with _timed(pipe_stats, "recompress"):
            comp = native.snappy_compress(stream)
        if len(comp) > SNAPPY_WORTH_RATIO * nbytes:
            return None
        return comp

    def _recompress_streams(self, streams, pipe_stats=None):
        """Link recompression (ROUTE_RECOMPRESS): snappy over each page's
        value stream.  ``streams``: [(buf, pos, size)].  Returns the
        per-page payloads, or None when the whole chunk didn't compress
        past SNAPPY_WORTH_RATIO."""
        if not native.available():
            return None
        total = sum(s[2] for s in streams)
        if total == 0:
            return None
        if self.alloc is not None:
            # the copies coexist with the decompressed originals at their
            # peak: the per-stream snappy worst case (n + n/6 + 32),
            # registered before the copies exist
            self.alloc.register_transient(
                total + total // 6 + 32 * len(streams))
        with _timed(pipe_stats, "recompress"):
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

    def preship(self, planner: ShipPlanner, pipe_stats=None,
                route_hint: "str | None" = None) -> None:
        """Route choice + link-byte host work for this chunk (ship.py):
        stores the ordered route preference plus any host-built artifacts;
        ``finish`` executes the routes in order, falling through on
        infeasibility.  Host-only: with prefetch it runs on the worker that
        collected the chunk, and its compression seconds land in
        ``pipe_stats``' ``recompress`` stage.

        ``route_hint`` (a replayed ScanPlan's memoized route) leads the
        order when the model still prices it feasible; a forced route
        (``TPQ_FORCE_ROUTE``) wins over any memo."""
        self._route_hint = route_hint if planner.force is None else None
        self._preship_dict(planner, pipe_stats)
        if not self.pages:
            return
        if _page_encodings(self.pages) != {Encoding.PLAIN}:
            return
        if self.leaf.physical_type in _PTYPE_TO_NAME:
            self._preship_fixed(planner, pipe_stats)
        elif self.leaf.physical_type == Type.BYTE_ARRAY:
            self._preship_bytes(planner, pipe_stats)

    def _preship_fixed(self, planner: ShipPlanner, pipe_stats) -> None:
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
        self._ship_pref, self._ship_costs = planner.plan(facts)
        self._ship_dev_costs = planner.device_costs(
            facts, routes=self._ship_costs)
        self._ship_unfused_dev = planner.unfused_device_costs(
            facts, routes=self._ship_costs)
        self._apply_route_hint()
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
                comp = (self._try_snappy(out, pipe_stats)
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
                     for p in self.pages], pipe_stats)
                self._ship["recompress"] = payloads
                if payloads is None:
                    continue
                return
            if route in (ROUTE_PLAIN, ROUTE_FUSED_PLAIN):
                return  # no host artifacts to prepare for either

    def _preship_bytes(self, planner: ShipPlanner, pipe_stats) -> None:
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
        self._ship_pref, self._ship_costs = planner.plan(facts)
        self._ship_dev_costs = planner.device_costs(
            facts, routes=self._ship_costs)
        self._apply_route_hint()
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
                     for p, s in zip(self.pages, span_l)], pipe_stats)
                # a failure is memoized (None): finish does not compress
                # again
                self._ship["recompress_bytes"] = payloads
                if payloads is None:
                    continue
                return
            if route == ROUTE_PLAIN:
                return

    def _preship_dict(self, planner: ShipPlanner, pipe_stats) -> None:
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
        dict_routes, self._dict_costs = planner.plan(facts)
        self._dict_dev_costs = planner.device_costs(
            facts, routes=self._dict_costs)
        for route in dict_routes:
            if route == ROUTE_DEVICE_SNAPPY and comp0 is not None:
                self._dict_ship = (route, comp0[0], comp0[1])
                return
            if route == ROUTE_RECOMPRESS and comp0 is None:
                # as in the reference, a fixed-width table goes to
                # snappy_compress 2-D, which takes len() — the row count —
                # as its byte count; the payload then fails the tag walk at
                # finish and the table ships plain, unrecorded (kept for
                # route parity; ROADMAP)
                comp = self._try_snappy(np.ascontiguousarray(src),
                                        pipe_stats)
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
        encs = _page_encodings(self.pages)
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
            chunk_walk.materialize_pages(self.pages)
        slots_pad = _bucket_count(slots)
        d_plan = r_plan = None
        if leaf.max_def > 0:
            d_plan = self._plan_levels(
                stager, "def", [p.def_stream for p in self.pages],
                bitpack.bit_width(leaf.max_def), slots, slots_pad,
                metas=[p.def_meta for p in self.pages],
            )
        if leaf.max_rep > 0:
            # no metas, as in the reference: the page parse walked only the
            # def stream, so each rep stream's runs are walked here
            r_plan = self._plan_levels(
                stager, "rep", [p.rep_stream for p in self.pages],
                bitpack.bit_width(leaf.max_rep), slots, slots_pad,
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
        return _compose_column(value_plan, d_plan, r_plan)

    def _plan_levels(self, stager: _RowGroupStager, kind: str, streams,
                     width: int, slots: int, slots_pad: int, metas=None):
        """Stage the pages' raw RLE ``kind`` (``def`` or ``rep``) level
        streams and expand them on the device: through the fused K1 where
        the stream has bit-packed runs, else the run-table expand.  The plan
        yields ``int32[slots_pad]`` (tail past ``slots`` zeroed).  The
        streams and slots are counted by kind and route
        (``obs.note_levels``), and the plan kept for the chunk's ``levels``
        span while spans are recorded."""
        spans = self.level_plans is not None
        t0 = time.perf_counter() if spans else 0.0
        plan, route = self._plan_level_streams(stager, streams, width,
                                               slots, slots_pad, metas)
        note_levels(kind, route, len(streams), slots)
        if spans:
            self.level_plans.append((kind, slots, len(streams), route, t0,
                                     time.perf_counter()))
        return plan

    def _plan_level_streams(self, stager, streams, width, slots, slots_pad,
                            metas):
        """:meth:`_plan_levels`' plan and its route (``k1`` or
        ``run_table``)."""
        if metas is None:
            metas = [None] * len(self.pages)
        if any(s is None for s in streams):
            raise ParquetError(
                "internal: level stream span missing on the batched path"
            )
        metas = [
            m if m is not None else parse_level_meta(
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
            return plan, "k1"
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

        # run-table expand + tail mask: two passes in the reference
        return _Plan(fn, tables, None, stages=2), "run_table"

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
            family="snappy_resolve", stages=3 + iters,
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
                    snappy_walks_settle(False)
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
            snappy_walks_settle(False)
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
                    (info.tbase, bias), build, family="narrow",
                    stages=3 + iters)
            # op planning fell through: ship the narrow bytes uncompressed
        base = stager.add(out)
        stager.note_read_extent(base, count * k)
        self._record_ship(ROUTE_NARROW, defined * width, out.nbytes)
        return _Plan(
            lambda buf, base_d, bias_d: _plain_narrow(
                buf, base_d, bias_d, k=k, dtype=name, count=count),
            (base, bias), build, family="narrow")

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
            family="fused", stages=1,
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
            snappy_walks_settle(False)
            return None  # i32 table/source math (checked before mutation)
        snappy_walks_settle(True)
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
            family="fused", stages=1,
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
            (lens_base, info.tbase), build, family="snappy_resolve",
            stages=3 + iters)

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

    def _walked_index_runs(self, pages):
        """The chunk walk's run tables of the dictionary-index ``pages`` and
        their folded range max (``chunk_walk.ChunkWalk.index_runs``: one
        native call, the pages' parse errors raised in page order), or None
        when the pages came through the page loop or the walk is
        unavailable."""
        walk = getattr(pages[0], "walk", None) if pages else None
        if walk is None:
            return None
        return walk.index_runs(pages, self.dict_len)

    def _expand_index_runs(self, stager, runs, prefix: int, cp: int,
                           uniform: bool):
        """The run-table expand of a walked chunk's index streams (the
        fused K1 declined them, or their widths differ): the same staged
        segments and tables as the page loop's, from one set of run
        tables."""
        pages = runs.pages
        bases = stager.add_segments([
            (p.raw, p.value_pos, len(p.raw) - p.value_pos) for p in pages])
        ks, widths = runs.ks, runs.widths
        page_of = np.repeat(np.arange(len(ks)), ks)
        pos0 = np.cumsum(runs.counts) - runs.counts
        # global bit base: page byte base within buf, re-zeroed for the
        # global value position
        tables = _merge_run_tables(
            [runs.ends + pos0[page_of]], [runs.kinds], [runs.vals],
            [runs.starts + (bases * 8 - pos0 * widths)[page_of]],
            fill_end=prefix, widths_l=[widths[page_of]])
        if uniform:
            width = int(widths[0]) if len(widths) else 0
            tables = tables[:4]  # one width: no per-run width table
            idx_dyn = tuple(_stage_array(stager, t) for t in tables)

            def idx_fn(buf, *specs):
                e, r, v, s = (_staged(buf, t) for t in specs)
                return _hybrid(buf, e, r != 0, v, s, prefix, width=width,
                               count=cp)

            return idx_fn, idx_dyn
        idx_dyn = tuple(_stage_array(stager, t) for t in tables)
        mw = min(max(8, (int(widths.max()) + 7) // 8 * 8), 32)

        def idx_fn(buf, *specs):
            e, r, v, s, w = (_staged(buf, t) for t in specs)
            return _hybrid_vw(buf, e, r != 0, v, s, w, prefix,
                              max_width=mw, count=cp)

        return idx_fn, idx_dyn

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
        walked = self._walked_index_runs(self.pages)
        if walked is not None:
            runs, host_max = walked
            widths = runs.widths
            uniform = bool((widths == widths[0]).all())
            width = int(widths[0])
            prefix = int(runs.counts.sum())
            pages_info = runs
        else:
            parsed = []  # (page, stream, meta)
            page_widths = []
            host_max = 0 if self.pages else None
            for p in self.pages:
                meta, pw, stream, host_max = self._parse_dict_index_page(
                    p, host_max)
                parsed.append((p, stream, meta))
                page_widths.append(pw)
            uniform = len(set(page_widths)) <= 1
            width = page_widths[0] if page_widths else 0
            prefix = sum(p.defined for p in self.pages)
            pages_info = [(m, s, p.defined) for p, s, m in parsed]
        cp = _bucket_count(prefix)
        plan = None
        if uniform and prefix:
            plan = _plan_hybrid_pallas(stager, pages_info, width, prefix, cp)
        if plan is not None:
            idx_fn, idx_dyn = plan.fn, plan.dyn
        elif walked is not None:
            idx_fn, idx_dyn = self._expand_index_runs(stager, runs, prefix,
                                                      cp, uniform)
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
                self._record_ship(
                    ship[0], self.dict_u8.nbytes, info.shipped,
                    predicted=self._dict_costs.get(ship[0], 0.0),
                    predicted_device=self._dict_dev_costs.get(ship[0], 0.0))
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

        return _Plan(fn, tuple(idx_dyn) + (table_dyn,), build, family="gather")

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
                self._record_ship(
                    ship[0], rheap.nbytes, info.shipped,
                    predicted=self._dict_costs.get(ship[0], 0.0),
                    predicted_device=self._dict_dev_costs.get(ship[0], 0.0))
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

        return _Plan(fn, tuple(idx_dyn) + (roff_base, heap_dyn), build,
                     family="gather")

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
        walked = self._walked_index_runs(dict_pages)
        if walked is not None:
            runs, host_max = walked
            parsed = [(p, None, j, w) for j, (p, w) in enumerate(
                zip(dict_pages, runs.widths.tolist()))]
            prefix = int(runs.counts.sum())
        else:
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
            if walked is not None:
                # the group's pages as one run table (a page left out of
                # the group holds no index, and no run)
                pages_info = runs.sub(group[0][2], group[-1][2] + 1)
            else:
                pages_info = [(m, st, p.defined) for p, st, m, _ in group]
            plan = _plan_hybrid_pallas(stager, pages_info, width, total,
                                       _bucket_count(total))
            if plan is not None:
                idx_calls.append((plan.fn, plan.dyn, total))
                continue
            for p, _, meta, _ in group:
                if walked is not None:
                    meta = runs.meta(meta)  # the page's position in runs
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

        return _Plan(fn, tuple(dyn), build, family="gather")

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
            helper.dict_u8 = _h2d(np.ascontiguousarray(self.dict_u8), dev)
        helper.dict_dtype = self.dict_dtype
        helper.dict_len = self.dict_len
        if self.dict_ragged is not None:
            helper._dict_host_offsets = self.dict_ragged.offsets
            helper.dict_offsets = _h2d(np.ascontiguousarray(
                self.dict_ragged.offsets, dtype=np.int64), dev)
            helper.dict_heap = _h2d(
                np.ascontiguousarray(self.dict_ragged.heap), dev)
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
        # no device work left: a pass-through, never timed
        return _Plan(None, (), lambda _res: out)

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
            family="unpack",
        )


def _collect_chunk(buf: bytes, codec: int, total_values: int,
                   leaf: SchemaNode, deferred_checks: list,
                   validate_crc: bool = False, alloc=None,
                   statistics=None, skip_pages=None, context=None,
                   device=None, dict_cache=None) -> _ChunkAssembler:
    """Walk a chunk's pages into an assembler (host phase): CRC checks,
    the dictionary page, and each data page's level and index structure.
    PLAIN pages of a SNAPPY chunk stay compressed (lazy pages) for the
    compressed-shipping routes; every other page is decompressed here.

    A flat leaf's chunk of v1 pages, UNCOMPRESSED or SNAPPY, is walked in a
    few native calls (``chunk_walk``); any other chunk, or any run without
    the native library, takes the page loop (:func:`_collect_pages`).  Both
    give the same assembler and raise the same errors; the host phase
    counts which one ran (``obs.note_chunk_walk``).

    ``context`` ({file, column, row_group, chunk_offset}) is stamped onto
    every raise (``errors.error_context``), with the failing page's ordinal
    and absolute byte offset.  ``alloc`` (an ``AllocTracker``) registers
    each page's decompressed size before the page is decompressed, and the
    assembler's link-recompression copies.  ``skip_pages``: the data-page
    ordinals (the dictionary page not counted) page-level pushdown pruned;
    they are counted in ``pages_pruned`` and never decompressed, parsed or
    staged, and a chunk with no page left is still returned.  Host-only:
    with prefetch this runs on a worker thread.

    ``dict_cache`` (a ``serve.BoundDictCache``) reads decoded dictionaries
    through, keyed by the context's (row group, column) and the CRC tier:
    a hit adopts the table and its snappy payload without decompressing or
    parsing the dictionary page again."""
    return _collect_chunk_as(True, buf, codec, total_values, leaf,
                             deferred_checks, validate_crc, alloc,
                             statistics, skip_pages, context, device,
                             dict_cache)


def _collect_chunk_as(walk: bool, buf, codec, total_values, leaf,
                      deferred_checks, validate_crc=False, alloc=None,
                      statistics=None, skip_pages=None, context=None,
                      device=None, dict_cache=None) -> _ChunkAssembler:
    """:func:`_collect_chunk`, through the native chunk walk where it
    engages (``walk``), else through the page loop alone (the walk's
    reference: the tests and the fuzz harness compare the two)."""
    ctx = dict(context or {})
    if "column" not in ctx and leaf.path:
        ctx["column"] = ".".join(leaf.path)
    chunk_offset = ctx.pop("chunk_offset", 0) or 0
    asm = _ChunkAssembler(leaf, deferred_checks, device)
    asm.stats_span = _int_stats_span(statistics, leaf)
    asm.alloc = alloc
    args = (buf, codec, leaf, asm, ctx, chunk_offset, validate_crc, alloc,
            skip_pages, dict_cache)
    if not walk:
        _collect_pages(total_values, *args)
        return asm
    reason = chunk_walk.declines(codec, leaf)
    if reason is None:
        with error_context(**ctx):
            cw = chunk_walk.ChunkWalk.headers(buf, total_values, codec)
        if cw.has_v2:
            reason = "page_v2"
        elif (alloc is not None and alloc.max_size > 0
              and alloc.total + cw.upper_bytes() > alloc.max_size):
            # the budget may run out mid-chunk: the page loop registers
            # page by page, so the failing page is the loop's
            reason = "budget"
        else:
            asm.walk = "native"
            note_chunk_walk(None)
            _collect_walked(cw, *args)
            return asm
    asm.walk = reason
    note_chunk_walk(reason)
    _collect_pages(total_values, *args)
    return asm


def _collect_dictionary(ps, buf, codec, asm, ctx, chunk_offset,
                        validate_crc, alloc, dict_cache) -> None:
    """The chunk's dictionary page (``ps``, a ``PageSlice``) into ``asm``:
    adopted from the dictionary cache, or CRC-checked, registered,
    decompressed and decoded (and put in the cache)."""
    # the CRC tier is in the key: a validating read never adopts an
    # unvalidated decode
    dk = (ctx.get("row_group"), ctx.get("column"),
          f"dev:v{1 if validate_crc else 0}")
    cacheable = (dict_cache is not None and dk[0] is not None
                 and dk[1] is not None)
    if cacheable:
        hit = dict_cache.get(*dk)
        if hit is not None:
            asm.adopt_dictionary(hit)
            return
    header = ps.header
    with error_context(offset=chunk_offset + ps.payload_start, **ctx):
        payload = buf[ps.payload_start : ps.payload_end]
        _check_crc(header, payload, validate_crc)
        if alloc is not None:
            alloc.register(max(header.uncompressed_page_size or 0, 0))
        raw = decompress_block(payload, codec, header.uncompressed_page_size)
        dh = header.dictionary_page_header
        asm.set_dictionary(raw, dh.encoding, dh.num_values or 0)
    if codec == CompressionCodec.SNAPPY:
        # kept: the planner may ship the dictionary VALUE TABLE
        # compressed (_preship_dict / _finish_dict)
        asm.dict_comp = (payload,
                         max(header.uncompressed_page_size or 0, 0))
    if cacheable:
        entry = asm.dict_cache_entry()
        if entry is not None:
            dict_cache.put(*dk, entry, entry["nbytes"])


def _lazy_chunk(codec, leaf) -> bool:
    """Whether the chunk's PLAIN pages may stay compressed (lazy pages;
    ``parse_data_page`` applies the per-page conditions)."""
    return (codec == CompressionCodec.SNAPPY
            and (leaf.physical_type in _PTYPE_TO_NAME
                 or leaf.physical_type == Type.BYTE_ARRAY)
            and native.available())


def _collect_pages(total_values, buf, codec, leaf, asm, ctx, chunk_offset,
                   validate_crc, alloc, skip_pages, dict_cache) -> None:
    """The page loop: ``walk_pages``, then the dictionary page and each
    data page through ``parse_data_page``."""
    lazy = _lazy_chunk(codec, leaf)
    with error_context(**ctx):
        pages = walk_pages(buf, total_values)
    data_ordinal = 0
    for ps in pages:
        header = ps.header
        pt = header.type
        if pt == PageType.DICTIONARY_PAGE:
            _collect_dictionary(ps, buf, codec, asm, ctx, chunk_offset,
                                validate_crc, alloc, dict_cache)
            continue
        if pt in (PageType.DATA_PAGE, PageType.DATA_PAGE_V2):
            if skip_pages and data_ordinal in skip_pages:
                asm.pages_pruned += 1
                data_ordinal += 1
                continue
            with error_context(page=data_ordinal,
                               offset=chunk_offset + ps.payload_start, **ctx):
                asm.pages.append(
                    parse_data_page(ps, buf, codec, leaf,
                                    validate_crc=validate_crc, alloc=alloc,
                                    decode_levels=False,
                                    lazy_decompress=lazy)
                )
            data_ordinal += 1
        # index/unknown pages: skip


def _collect_walked(cw, buf, codec, leaf, asm, ctx, chunk_offset,
                    validate_crc, alloc, skip_pages, dict_cache) -> None:
    """The chunk walk's collection (one flat leaf, v1 pages): the
    dictionary page as the page loop does it, then every data page left
    after pruning registered at once and CRC-checked and decompressed in one
    native call.  A failing page raises what ``parse_data_page`` raises for
    it, with its ordinal and offset; the registrations of the pages after it
    are released."""
    ps = cw.dictionary_page()
    if ps is not None:
        _collect_dictionary(ps, buf, codec, asm, ctx, chunk_offset,
                            validate_crc, alloc, dict_cache)
    ix = cw.data_pages()
    ords = np.arange(len(ix))
    if skip_pages:
        pruned = np.isin(ords, np.fromiter(skip_pages, np.int64))
        asm.pages_pruned += int(pruned.sum())
        ix, ords = ix[~pruned], ords[~pruned]
    if not len(ix):
        return
    sizes = cw.pt[ix, native.PT_USIZE]
    if alloc is not None:
        alloc.register(int(sizes.sum()))
    pages, failed = cw.materialise(ix, validate_crc, _lazy_chunk(codec, leaf))
    asm.pages = pages
    if failed is not None:
        j, code, exc = failed
        if alloc is not None:
            # the page loop registers a page after its CRC check
            crc = code == chunk_walk.W_CRC
            alloc.release(int(sizes[j if crc else j + 1:].sum()))
        with error_context(page=int(ords[j]),
                           offset=chunk_offset
                           + int(cw.pt[ix[j], native.PT_START]), **ctx):
            raise exc


def decode_chunk_batched(buf: bytes, codec: int, total_values: int,
                         leaf: SchemaNode, deferred_checks: list,
                         validate_crc: bool = False,
                         device=None) -> DeviceColumnData:
    """Decode one column chunk without a reader: the same walk, ship plan
    (``ship.default_planner()``) and device plan as a row group's chunk, on
    a stager of its own.  ``device`` is ``cuda`` unless the caller names
    another.

    The dictionary-index range checks that could not run on the host land
    in ``deferred_checks`` as ``(device max, dict_len, column)``: the
    caller must drain them (``DeviceFileReader.finalize`` does the same),
    or a corrupt index reads the clamped row."""
    dev = _resolve_device(device, "decode_chunk_batched")
    asm = _collect_chunk(buf, codec, total_values, leaf, deferred_checks,
                         validate_crc, device=dev)
    if not asm.pages:
        return DeviceColumnData(
            values=torch.zeros(0, dtype=torch.int64, device=dev),
            max_def=leaf.max_def, max_rep=leaf.max_rep, num_leaf_slots=0)
    asm.preship(default_planner())
    stager = _RowGroupStager(device=dev)
    plan = asm.finish(stager)
    return _run_plans([("c", plan)], stager.stage())["c"]


@dataclass
class ReaderStats:
    """Decode counters, accumulated per DeviceFileReader (the reference's
    ``ReaderStats`` cut to this slice).  Per route in ``ship_routes``:
    streams, ``logical`` bytes (what plain shipping would move) and
    ``shipped`` bytes (what the route registered for transfer);
    ``link_bytes_logical``/``link_bytes_shipped`` are their sums.

    :meth:`host_parts` is the port's split of the host phase
    (``obs.HostPhaseStats``); it stays out of :meth:`as_dict`, whose keys
    are the reference's."""

    row_groups: int = 0
    chunks: int = 0
    pages: int = 0
    pages_device_expanded: int = 0  # pages shipped compressed
    pages_pruned: int = 0           # pages skipped by page-level pushdown
    rows: int = 0
    compressed_bytes: int = 0      # chunk bytes read from the file
    staged_bytes: int = 0          # bytes registered for the device buffers
    host_seconds: float = 0.0      # read + decompress + parse + planning
    # page-pruning planning (header walks, filter-chunk reads); within
    # host_seconds on the sequential path, on the feed's consumer otherwise
    prune_seconds: float = 0.0
    stage_seconds: float = 0.0     # fill + enqueue of the host->device copy
    dispatch_seconds: float = 0.0  # enqueue of the decode launches
    wall_seconds: float = 0.0
    route_streams: dict = field(default_factory=dict)
    route_bytes_logical: dict = field(default_factory=dict)
    route_bytes_shipped: dict = field(default_factory=dict)
    # the planner's modelled seconds for the routes that ran, summed per
    # route: the bottleneck lane, the device lane, and (fused routes) the
    # unfused chain's device lane — ship_feedback's predictions
    route_pred_seconds: dict = field(default_factory=dict)
    route_pred_device_seconds: dict = field(default_factory=dict)
    route_pred_unfused_device_seconds: dict = field(default_factory=dict)
    # fused routes that degraded to their unfused twin (kernel caps, level
    # lanes, i32 ceilings) — forced-fused on an ineligible stream counts here
    fused_fallbacks: int = 0
    # the link rate the planner assumed (TPQ_LINK_MBPS or its default)
    planner_link_mbps: float = 0.0
    host_phase: HostPhaseStats = field(default_factory=HostPhaseStats,
                                       repr=False, compare=False)

    def host_parts(self) -> dict:
        """The host phase's self-time split: seconds per part (``read``,
        ``crc``, ``decompress``, ``page_parse``, ``run_walk``,
        ``snappy_walk``, ``transcode``, ``host_copy``, ``level_walk``, and
        ``python``, the remainder: they sum to ``host_seconds``), the host
        phase's and the staging thread's CPU seconds, and the snappy tag
        walk's counts.
        The host phase is ``host_seconds`` at prefetch 0; with the chunk
        feed it adds each chunk's collection on the pool."""
        return self.host_phase.as_dict()

    def count_route(self, route: str, logical: int, shipped: int,
                    predicted: float = 0.0, predicted_device: float = 0.0,
                    predicted_unfused_device: float = 0.0) -> None:
        self.route_streams[route] = self.route_streams.get(route, 0) + 1
        self.route_bytes_logical[route] = (
            self.route_bytes_logical.get(route, 0) + logical)
        self.route_bytes_shipped[route] = (
            self.route_bytes_shipped.get(route, 0) + shipped)
        self.route_pred_seconds[route] = (
            self.route_pred_seconds.get(route, 0.0) + predicted)
        self.route_pred_device_seconds[route] = (
            self.route_pred_device_seconds.get(route, 0.0) + predicted_device)
        if predicted_unfused_device:
            self.route_pred_unfused_device_seconds[route] = (
                self.route_pred_unfused_device_seconds.get(route, 0.0)
                + predicted_unfused_device)

    @property
    def link_bytes_logical(self) -> int:
        return sum(self.route_bytes_logical.values())

    @property
    def link_bytes_shipped(self) -> int:
        return sum(self.route_bytes_shipped.values())

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def bytes_per_sec(self) -> float:
        return (self.compressed_bytes / self.wall_seconds
                if self.wall_seconds else 0.0)

    @property
    def pages_per_chunk(self) -> float:
        return self.pages / self.chunks if self.chunks else 0.0

    def as_dict(self) -> dict:
        return {
            "row_groups": self.row_groups, "chunks": self.chunks,
            "pages": self.pages,
            "pages_device_expanded": self.pages_device_expanded,
            "pages_pruned": self.pages_pruned,
            "rows": self.rows,
            "compressed_bytes": self.compressed_bytes,
            "staged_bytes": self.staged_bytes,
            "link_bytes_logical": self.link_bytes_logical,
            "link_bytes_shipped": self.link_bytes_shipped,
            "ship_routes": {
                r: {"streams": self.route_streams[r],
                    "logical": self.route_bytes_logical.get(r, 0),
                    "shipped": self.route_bytes_shipped.get(r, 0),
                    # 9 decimals: a tiny stream's prediction must not round
                    # to a 0.0 that ship_feedback reads as "none"
                    "predicted_s": round(
                        self.route_pred_seconds.get(r, 0.0), 9),
                    "predicted_device_s": round(
                        self.route_pred_device_seconds.get(r, 0.0), 9),
                    "predicted_unfused_device_s": round(
                        self.route_pred_unfused_device_seconds.get(r, 0.0),
                        9)}
                for r in sorted(self.route_streams)
            },
            "fused_fallbacks": self.fused_fallbacks,
            "planner_link_mbps": round(self.planner_link_mbps, 1),
            "host_seconds": round(self.host_seconds, 6),
            "prune_seconds": round(self.prune_seconds, 6),
            "stage_seconds": round(self.stage_seconds, 6),
            "dispatch_seconds": round(self.dispatch_seconds, 6),
            "wall_seconds": round(self.wall_seconds, 6),
            "rows_per_sec": round(self.rows_per_sec, 1),
            "bytes_per_sec": round(self.bytes_per_sec, 1),
            "pages_per_chunk": round(self.pages_per_chunk, 3),
        }


# ---------------------------------------------------------------------------
# the device lane: per-route completion timing on CUDA events
# ---------------------------------------------------------------------------

def _device_timing_enabled(device: torch.device) -> bool:
    """``TPQ_DEVICE_TIMING`` (default on).  A CUDA reader needs a CUDA
    runtime to time against; a CPU reader's clock is the host's (its
    kernels' plain versions run synchronously)."""
    if env_int("TPQ_DEVICE_TIMING", 1, lo=0) == 0:
        return False
    if device.type == "cuda" and not torch.cuda.is_available():
        warn_env_once("TPQ_DEVICE_TIMING", "<no cuda device>",
                      "disabled (no device clock)")
        return False
    return True


# the device lane's name for a plan that launches no CUDA kernel (its
# device work is PyTorch tensor code)
_TENSOR_FAMILY = "tensor_code"


class DeviceStats:
    """Per-route / per-kernel-family device timing counters: the reference's
    ``DeviceStats``, keys and all, plus the port's view by CUDA kernel.

    Per route: ``dispatches`` (column dispatches timed), ``device_seconds``,
    ``bytes_in`` (the logical bytes the kernels produce), ``bytes_staged``
    (link bytes staged for the route's columns) and ``device_passes`` (the
    reference's structural pass count, :attr:`_Plan.stages`).  ``kernels``
    keys the same by the reference's kernel family; ``h2d`` times the staged
    row-group copies.  The seconds partition one serialized device timeline
    (see ``_devtimer_worker``), so their sum never exceeds the stream's
    busy window.

    :meth:`cuda_kernels` keys the lane by the CUDA kernel a plan launched
    (``hybrid_unpack_combine``, ``fused_plain_words``,
    ``fused_narrow_words``) or ``tensor_code`` for a plan that launched
    none: per name, the plans, the launches counted inside timed plans and
    their device seconds.  It is not part of the registry tree, whose keys
    stay the reference's.  Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # route -> [dispatches, s, b_in, b_staged, device_passes]
        self._routes: dict = {}
        self._kernels: dict = {}  # family -> [dispatches, s]
        self._cuda: dict = {}     # CUDA kernel name -> [plans, launches, s]
        self._h2d = [0, 0.0, 0]   # transfers, seconds, bytes

    def note_dispatch(self, route: str, family: str, seconds: float,
                      bytes_in: int = 0, bytes_staged: int = 0,
                      passes: int = 1, cuda: "dict | None" = None) -> None:
        with self._lock:
            r = self._routes.setdefault(route, [0, 0.0, 0, 0, 0])
            r[0] += 1
            r[1] += seconds
            r[2] += int(bytes_in)
            r[3] += int(bytes_staged)
            r[4] += int(passes)
            k = self._kernels.setdefault(family, [0, 0.0])
            k[0] += 1
            k[1] += seconds
            for name, n in (cuda or {_TENSOR_FAMILY: 0}).items():
                c = self._cuda.setdefault(name, [0, 0, 0.0])
                c[0] += 1
                c[1] += int(n)
                c[2] += seconds

    def note_h2d(self, seconds: float, nbytes: int = 0,
                 transfers: int = 1) -> None:
        """One staged group's copies (a streamed group times each strip as
        its own piece: ``transfers`` 1 on the last piece, 0 before it)."""
        with self._lock:
            self._h2d[0] += int(transfers)
            self._h2d[1] += seconds
            self._h2d[2] += int(nbytes)

    def progress(self) -> dict:
        """Cumulative counters for the sampler's ``device`` track."""
        with self._lock:
            return {
                "dispatches": sum(r[0] for r in self._routes.values()),
                "device_seconds": round(
                    sum(r[1] for r in self._routes.values()), 6),
                "h2d_transfers": self._h2d[0],
                "h2d_seconds": round(self._h2d[1], 6),
            }

    def cuda_kernels(self) -> dict:
        """``{kernel name: {plans, launches, device_seconds}}``."""
        with self._lock:
            return {name: {"plans": c[0], "launches": c[1],
                           "device_seconds": round(c[2], 9)}
                    for name, c in sorted(self._cuda.items())}

    def as_dict(self) -> dict:
        # 9 decimals: a sub-µs dispatch must not round to a 0.0 that
        # ship_feedback would read as unmeasured
        with self._lock:
            return {
                "dispatches": sum(r[0] for r in self._routes.values()),
                "device_seconds": round(
                    sum(r[1] for r in self._routes.values()), 9),
                "routes": {
                    route: {"dispatches": r[0],
                            "device_seconds": round(r[1], 9),
                            "bytes_in": r[2], "bytes_staged": r[3],
                            "device_passes": r[4]}
                    for route, r in sorted(self._routes.items())
                },
                "kernels": {
                    fam: {"dispatches": k[0],
                          "device_seconds": round(k[1], 9)}
                    for fam, k in sorted(self._kernels.items())
                },
                "h2d": {"transfers": self._h2d[0],
                        "device_seconds": round(self._h2d[1], 9),
                        "bytes": self._h2d[2]},
            }


class _DeviceTimer:
    """The device lane's completion worker.

    On the card each timed unit (a plan's launches, a row group's staged
    copies) is bracketed by a pair of timing events recorded on the stream
    it runs on; ``submit`` hands the pair to one daemon worker
    (``tpq-devtimer``) that waits on the end event and folds the interval
    into :class:`DeviceStats`.  Nothing blocks the dispatching thread, and
    the queue holds events, never tensors.  On a CPU reader the unit ran
    synchronously, so ``submit`` takes its host-clock interval, as the
    reference's worker measures its CPU backend.

    Disabled (``TPQ_DEVICE_TIMING=0``, or a CUDA reader without a CUDA
    runtime): ``submit`` is one attribute check and ``_run_plans`` records
    no event.  The worker starts on the first submit; ``settle()`` drains
    and joins it at the end of a read (the next submit starts another), so
    no thread outlives a scan; ``stop()`` does the same for good
    (idempotent; a submit after it is dropped)."""

    def __init__(self, stats: DeviceStats, tracer=None,
                 device: "torch.device | None" = None,
                 enabled: "bool | None" = None):
        self.stats = stats
        self.tracer = tracer
        self.device = torch.device("cpu") if device is None else device
        self.cuda = self.device.type == "cuda"
        self.enabled = (_device_timing_enabled(self.device) if enabled is None
                        else bool(enabled))
        self._lock = threading.Lock()
        self._q = None
        self._thread = None
        self._closed = False

    def mark(self):
        """The start of a timed unit: a recorded timing event on the
        current stream on the card, the host clock elsewhere."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            return ev
        return time.perf_counter()

    def submit(self, kind: str, route: str, family: str, start,
               bytes_in: int = 0, bytes_staged: int = 0, passes: int = 1,
               cuda: "dict | None" = None, end=None) -> None:
        """Time the unit begun at ``start`` (a :meth:`mark`) and ending
        now (or at ``end``, a mark)."""
        if not self.enabled:
            return
        if end is None:
            end = self.mark()
        q = self._q
        if q is None:
            q = self._start()
            if q is None:
                return  # closed
        q.put((kind, route, family, start, end, bytes_in, bytes_staged,
               passes, cuda))

    def _start(self):
        import queue
        import weakref

        with self._lock:
            if self._closed:
                return None
            if self._q is None:
                self._q = queue.Queue()
                base = None
                if self.cuda:
                    # the lane's clock origin: every event's device time is
                    # read as its offset from this one
                    base = torch.cuda.Event(enable_timing=True)
                    base.record(torch.cuda.current_stream(self.device))
                # the worker holds the queue, the stats and the tracer,
                # never the timer: an abandoned reader's timer is collected
                # and its finalizer sends the shutdown sentinel
                self._thread = threading.Thread(
                    target=_devtimer_worker,
                    args=(self._q, self.stats, self.tracer, base),
                    name="tpq-devtimer", daemon=True)
                self._thread.start()
                weakref.finalize(self, self._q.put, None)
            return self._q

    def drain(self, timeout: float = 2.0) -> None:
        """Wait (bounded) until every submitted unit is timed: a stats read
        mid-scan must not miss units still queued."""
        q = self._q
        if q is None or not self.enabled:
            return
        deadline = time.monotonic() + timeout
        while q.unfinished_tasks and time.monotonic() < deadline:
            time.sleep(0.002)

    def settle(self) -> None:
        """Drain and join the worker; a later submit starts a new one.  On
        the card this waits for the last timed unit to complete."""
        with self._lock:
            q, t = self._q, self._thread
            self._q = self._thread = None
        if t is None:
            return
        q.put(None)
        t.join(timeout=10.0)

    def stop(self) -> None:
        """Drain and join the worker for good (idempotent)."""
        with self._lock:
            self._closed = True
        self.settle()


def _devtimer_worker(q, stats: DeviceStats, tracer, base) -> None:
    """The completion worker's loop (module level: it must not hold the
    :class:`_DeviceTimer`, or the timer's shutdown finalizer never fires).

    Intervals are serialized against the previous one, as the reference
    serializes its completions: an interval starts at the later of its own
    start and the previous end, so the per-route sums partition one device
    timeline and never exceed the stream's busy window, even where the
    staging worker's copies and the consumer's launches interleave on the
    stream.  On the card the times are each event's offset from ``base``
    on the device clock."""
    prev_end = None
    while True:
        item = q.get()
        if item is None:
            return
        try:
            (kind, route, family, start, end, b_in, b_staged, passes,
             cuda) = item
            if base is not None:
                try:
                    end.synchronize()
                    s = base.elapsed_time(start) / 1e3
                    e = base.elapsed_time(end) / 1e3
                except Exception:  # noqa: BLE001 — a failed launch
                    continue       # reports through the consumer
                t1 = time.perf_counter()
            else:
                s, e = start, end
                t1 = e
            if prev_end is not None and s < prev_end:
                s = prev_end
            dt = max(e - s, 0.0)
            prev_end = e if prev_end is None else max(prev_end, e)
            if kind == "h2d":
                stats.note_h2d(dt, b_staged, transfers=passes)
                name = "device.h2d"
            else:
                stats.note_dispatch(route, family, dt, b_in, b_staged,
                                    passes, cuda)
                name = f"device.{route}"
            if tracer is not None and tracer.active:
                tracer.complete(name, t1 - dt, t1, kernel=family,
                                bytes=int(b_staged or b_in))
        finally:
            q.task_done()


# ---------------------------------------------------------------------------
# profiles through torch.profiler: ``profile_dir=`` and one bounded window
# per process (TPQ_XPROF), with record_function spans named as the span
# tracer's stages (stage, dispatch, finalize)
# ---------------------------------------------------------------------------

_XPROF_LOCK = threading.Lock()
_XPROF_DONE = False   # one TPQ_XPROF window per process: traces are heavy
_PROFILING = 0        # live captures (the hot path's one check)


def _xprof_annotation(name: str):
    """A ``torch.profiler.record_function`` span named as the tracer's
    stage while a capture runs; a no-op context otherwise."""
    if not _PROFILING:
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)


def _profile_start(device: "torch.device | None"):
    """Start a ``torch.profiler`` capture (CPU and, on the card, CUDA
    activity); None if the profiler refuses."""
    global _PROFILING
    acts = [torch.profiler.ProfilerActivity.CPU]
    if (device is None or device.type == "cuda") and torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    kw = {}
    try:
        # the staging worker's spans too (the profiler's state is per
        # thread otherwise); a PyTorch without the option profiles the
        # consumer thread alone
        kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)
    except (AttributeError, TypeError):
        pass
    try:
        prof = torch.profiler.profile(activities=acts, **kw)
        prof.start()
    except Exception:  # noqa: BLE001 — profiling never takes the read down
        return None
    with _XPROF_LOCK:
        _PROFILING += 1
    return prof


def _profile_stop(prof, out_dir: str) -> "str | None":
    """Stop ``prof`` and write its Chrome trace under ``out_dir``
    (``tpq_profile_<pid>_<n>.json``); the path, or None."""
    global _PROFILING
    with _XPROF_LOCK:
        _PROFILING -= 1
    try:
        prof.stop()
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"tpq_profile_{os.getpid()}_{next(_profile_seq)}.json")
        prof.export_chrome_trace(path)
        return path
    except Exception:  # noqa: BLE001
        return None


_profile_seq = itertools.count(1)


class _XprofWindow:
    """A bounded profile window (``TPQ_XPROF=<dir>``): a ``torch.profiler``
    capture from the scan's start until ``TPQ_XPROF_S`` seconds (default 10;
    checked at row-group granularity) or the scan's end, whichever comes
    first.  One window per process; later scans are no-ops."""

    def __init__(self, device: "torch.device | None" = None):
        self.dir = os.environ.get("TPQ_XPROF", "")
        self.window_s = env_float("TPQ_XPROF_S", 10.0, lo=0.1)
        self.device = device
        self._t0 = None
        self._prof = None

    def start(self) -> None:
        global _XPROF_DONE
        if not self.dir:
            return
        with _XPROF_LOCK:
            if _XPROF_DONE:
                return
            _XPROF_DONE = True
        self._prof = _profile_start(self.device)
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        """Row-group boundary: close the window once it has run
        ``window_s``."""
        if (self._prof is not None
                and time.perf_counter() - self._t0 >= self.window_s):
            self.stop()

    def stop(self) -> None:
        prof, self._prof = self._prof, None
        if prof is not None:
            _profile_stop(prof, self.dir)


class DeviceFileReader:
    """Columnar file reader decoding straight to device tensors.

    ``source`` is a path, a binary file object or bytes; ``columns`` a
    projection (dotted names or paths); ``validate_crc`` resolves like the
    reference's (``None`` reads ``TPQ_VALIDATE``, default on).  ``device``
    defaults to ``cuda``: without a CUDA device the constructor raises —
    pass ``device="cpu"`` to decode with the kernels' plain versions.

    ``max_memory`` caps the host bytes one row group's decode may register
    (chunk bytes, each page's decompressed size, link-recompression copies;
    0 = no cap): a decompression bomb raises
    ``alloc.MemoryBudgetExceeded``.  With ``prefetch`` it also bounds the
    bytes in flight on the chunk pool (backpressure).  ``prefetch=K`` runs
    the chunk reads, CRCs, decompression, page parse and ship planning of
    upcoming chunks K-deep on a thread pool (``_chunk_feed``), across row
    groups; 0 keeps that host phase on the consumer thread.

    Nothing blocks until ``finalize()`` (called by ``read_row_group``;
    ``finalize=False`` defers it): staging and every kernel launch are
    asynchronous on the current stream.  ``iter_row_groups`` stages each
    row group on a one-thread staging worker while the consumer prepares
    the next (``_scan_pipeline``).

    With ``row_filter`` (a ``predicate`` expression) pruning is two-level:
    row groups whose chunk statistics prove no match are skipped whole,
    and inside a surviving FLAT row group the page headers' statistics
    drop maximal provably-false row runs aligned to page edges of every
    selected column (``scanplan.plan_page_pruning``): those pages are never
    decompressed, staged or decoded (``ReaderStats.pages_pruned``).  The
    yielded rows are a superset of the matching rows, the same rows in
    every column; columns whose page grids share no interior edge are not
    page-pruned.  ``plan`` replays a ``scanplan.ScanPlan`` (group pruning,
    page-pruning skip sets, ship routes); ``metadata`` skips the footer
    read.  ``on_data_error`` / ``quarantine`` contain data errors
    (``ParquetError``) to their row group in the iteration APIs.

    ``store`` picks the byte store every chunk byte enters through, the
    sequential path's and the pruning planner's header walks included
    (``iostore.resolve_store``; the footer is read from the file); a
    ``GenericRangeStore`` coalesces each row group's chunk reads and, at
    ``prefetch`` > 0, routes them through the async fetch engine.
    ``cancel`` (a ``resilience.CancelToken``) rides every store read and
    is checked at every row group (and, with the chunk pool, every chunk):
    its ``CancelledError`` / ``DeadlineExceededError``, like an exhausted
    retry's ``RetryExhaustedError``, ends the scan and is never contained;
    the staging worker is joined and the scan's staged bytes leave the
    device ledger before it propagates.

    ``dict_cache`` (a ``serve.BoundDictCache``) reads decoded dictionary
    pages through a shared cache.  ``result_cache`` (a
    ``serve.BoundResultCache`` bound to this reader's device decode
    signature: CRC tier, filter fingerprint, device) serves whole row
    groups: a group whose every selected column is cached reads, stages
    and launches nothing, and its columns are the cached tensors, shared
    read-only.  A cold group's columns are published after the finalize
    that checks them, once the kernels that wrote them have completed; a
    column that is a view of a larger buffer is published as a copy, so
    the tier's byte count is what it pins.  An adapter signed for another
    shape, CRC tier, filter or device is dropped.
    ``serve.PlanCache.reader_kwargs(..., device=True)`` builds both.

    The footer, schema, filter, plan, store and containment engine live in
    a host ``reader.FileReader`` this reader holds, as the reference's do.

    Observability (``obs``): ``trace`` picks the span tracer (None: the
    ``TPQ_TRACE`` process tracer; a path: this reader's, written with its
    registry tree at ``close()``); ``sample_ms`` (``TPQ_SAMPLE_MS``) runs a
    sampler of live counter tracks on an enabled tracer; ``hang_s``
    (``TPQ_HANG_S``) arms a watchdog over the pipeline, reader, store and
    fetch-engine heartbeats that writes a flight dump when none advances
    while the consumer waits on the reader, and under ``hang_policy="raise"``
    aborts the chunk feed's budget and the store so the scan raises
    ``errors.HangError``; ``profile_dir`` captures each scan with
    ``torch.profiler`` (a Chrome trace under the directory, with
    ``record_function`` spans ``stage`` / ``dispatch`` / ``finalize``), and
    ``TPQ_XPROF`` one bounded window per process.  The device lane
    (``TPQ_DEVICE_TIMING``, default on) times every plan's launches and
    every staged copy with CUDA events on the stream they run on
    (:class:`DeviceStats`).  ``obs_registry()`` is the reader's metrics
    tree, the reference's keys, with ``ship_feedback``: the planner's
    predictions beside the measured link and device lanes.

    Where the port differs from the reference on purpose: an explicit
    ``device`` (part of the result cache's signature), a pool of pinned
    host buffers (``_PinnedPool``) under the copies, the cancel check per
    row group on the sequential path, and a scan ended by a cancel, a
    deadline or a hang drops its staged buffers and pending outputs on the
    way out (``_drop_scan_frames``) instead of leaving them to the garbage
    collector."""

    def __init__(self, source, columns=None, validate_crc=None, device=None,
                 max_memory: int = 0, prefetch: int = 0, row_filter=None,
                 metadata=None, plan=None, on_data_error=None,
                 quarantine=None, store=None, cancel=None, dict_cache=None,
                 result_cache=None, trace=None, sample_ms=None, hang_s=None,
                 hang_policy=None, profile_dir: "str | None" = None):
        self.device = _resolve_device(device)
        self._tracer, self._owns_tracer = resolve_tracer(trace)
        # the result cache is not passed to the host half: host ColumnData
        # and device tensors are different decode shapes
        self._host = FileReader(source, columns=columns,
                                validate_crc=validate_crc,
                                max_memory=max_memory,
                                row_filter=row_filter, metadata=metadata,
                                plan=plan, on_data_error=on_data_error,
                                quarantine=quarantine, store=store,
                                cancel=cancel, dict_cache=dict_cache,
                                trace=self._tracer)
        h = self._host
        self.metadata, self.schema = h.metadata, h.schema
        self.validate_crc = h.validate_crc
        self._dict_cache = dict_cache
        if result_cache is not None:
            sig = getattr(result_cache, "sig", None) or ()
            want = ("dev", "v1" if self.validate_crc else "v0",
                    predicate_fingerprint(h.row_filter))
            if (tuple(sig[:3]) != want
                    or sig[-1] != device_tag(self.device)):
                result_cache = None
        self._result_cache = result_cache
        # groups decoded under a result cache, waiting for the finalize
        # that publishes them: id(out) -> [index, out, dispatched, nbytes,
        # CUDA event recorded after the group's launches]
        self._rc_pending: dict = {}
        self._rc_pending_bytes = 0
        # the containment engine, shared with the host half
        self.quarantine = h.quarantine
        # one ledger with the host reader: chunk bytes, each page's
        # decompressed size, link-recompression copies, device buffers
        self.alloc = h.alloc
        # the host reader's store-backed positioned reads: the chunk
        # pool's workers and the consumer share the source without sharing
        # a position, and every byte goes through the one store
        self._f, self._sr, self._source_name = h._f, h._sr, h._source_name
        self._store = h._store
        self._prefetch = int(prefetch)
        self._pipe_stats = PipelineStats(prefetch=self._prefetch,
                                         budget_bytes=int(max_memory),
                                         tracer=self._tracer)
        self.profile_dir = profile_dir
        self.profile_path: "str | None" = None  # the last scan's trace
        # the chunk feed's in-flight budget while a scan runs (the
        # sampler's budget_waiters track reads it)
        self._live_budget = None
        self._deferred: list = []
        self._stats = ReaderStats()
        # the staging worker and the consumer both write the stats
        self._stats_lock = threading.Lock()
        self._t0: "float | None" = None
        # HBM ledger: a staged buffer is pending until its group is
        # dispatched, then outstanding until a finalize proves the kernels
        # reading it complete (the pipeline stages N+1 before N finalizes)
        self._device_staged_pending = 0
        self._device_outstanding = 0
        self._ship_planner = ShipPlanner()
        self._stats.planner_link_mbps = self._ship_planner.link_mbps
        self._pinned = _PinnedPool() if self.device.type == "cuda" else None
        self._device_stats = DeviceStats()
        self._device_timer = _DeviceTimer(self._device_stats, self._tracer,
                                          self.device)
        self._xprof = _XprofWindow(self.device)
        self._arm_obs(sample_ms, hang_s, hang_policy)

    def _arm_obs(self, sample_ms, hang_s, hang_policy) -> None:
        """The sampler, the watchdog and the flight registry, as the
        reference's constructor wires them.  The lambdas late-bind
        ``_pipe_stats``: each scan replaces it."""
        # live counter tracks; no thread unless the tracer is enabled and
        # an interval is set.  track_id keeps each reader's curves apart on
        # scan_files' shared tracer
        self._sampler = Sampler(self._tracer, resolve_sample_ms(sample_ms),
                                track_id=self._pipe_stats._obs_id)
        if self._sampler.enabled:
            self._sampler.add_source(
                "reader_progress",
                lambda: {**self._sample_progress(),
                         **self._stats.host_phase.progress()})
            self._sampler.add_source("pipeline_lanes",
                                     lambda: self._pipe_stats.sample())
            self._sampler.add_source("alloc_bytes", self._sample_alloc)
            self._sampler.add_source("budget_waiters", self._sample_budget)
            if self._store.stats is not None:
                self._sampler.add_source("io_retries",
                                         self._store.stats.progress)
            self._sampler.add_source("data_errors", self.quarantine.progress)
            if self._result_cache is not None:
                self._sampler.add_source("result_cache",
                                         self._result_cache.cache.progress)
            if self._device_timer.enabled:
                self._sampler.add_source("device",
                                         self._device_stats.progress)
            self._sampler.start()
        self._watchdog = Watchdog(resolve_hang_s(hang_s), policy=hang_policy)
        if self._watchdog.enabled:
            self._watchdog.watch("pipeline",
                                 lambda: self._pipe_stats.sample())
            self._watchdog.watch("reader", self._sample_progress)
            if self._store.stats is not None:
                # the store's counters freeze while a fetch is stalled (a
                # retrying store keeps advancing): a network stall fires
                # the dog and the dump names the range in flight
                self._watchdog.watch("iostore", self._store.stats.progress)
            eng = engine_for_store(self._store)
            if eng is not None:
                self._watchdog.watch("fetch_engine", eng.stats.progress)
            # the raise policy's exit from a stalled fetch: the poisoned
            # store wakes the worker pinned in the transport
            self._watchdog.add_abort_hook(self._store.abort)
            # the idle consumer gate until the first scan replaces it: a
            # reader built long before its first iteration is no hang
            self._watchdog.watch_consumer()
            self._watchdog.start()
        # a wedged process's dump embeds this reader's registry tree
        register_flight_registry(self, "obs_registry")

    def _sample_progress(self) -> dict:
        st = self._stats
        return {"rows": st.rows, "chunks": st.chunks,
                "staged_bytes": st.staged_bytes,
                "compressed_bytes": st.compressed_bytes}

    def _sample_alloc(self) -> dict:
        in_use, peak = self.alloc.snapshot()
        dev_in_use, dev_peak = self.alloc.device_snapshot()
        return {"in_use": in_use, "peak": peak,
                "device_in_use": dev_in_use, "device_peak": dev_peak}

    def _sample_budget(self) -> dict:
        b = self._live_budget
        return b.snapshot() if b is not None else {}

    def obs_registry(self) -> StatsRegistry:
        """This reader's metrics tree (``obs.StatsRegistry``): the decode
        counters with the planner's per-route predictions, the pipeline's
        stage sums and histograms, the alloc peaks, the device lane (absent
        when it is off: ``n/a``, never zeros), the store's counters and the
        data-error counters."""
        reg = StatsRegistry()
        reg.add_reader(self._stats)
        reg.add_pipeline(self._pipe_stats)
        reg.note_alloc_peak(self.alloc)
        if self._device_timer.enabled:
            self._device_timer.drain()
            reg.add_device(self._device_stats)
        if self._store.stats is not None:
            reg.add_io(self._store.stats)
        if len(self.quarantine.log) or self.quarantine.units_skipped:
            reg.add_data_errors(self.quarantine)
        return reg

    def device_stats(self) -> DeviceStats:
        """The device lane's counters (drained of queued units)."""
        self._device_timer.drain()
        return self._device_stats

    @property
    def _plan(self):
        """The scan plan IR (footer slice, pruning verdicts, route memo):
        the host reader's, rebuilt by ``set_selected_columns``."""
        return self._host._plan

    @property
    def row_filter(self):
        return self._host.row_filter

    def row_group_selected(self, index: int) -> bool:
        """False when ``row_filter`` proves row group ``index`` cannot
        match (its bytes are never read)."""
        return self._host.row_group_selected(index)

    def set_selected_columns(self, columns) -> None:
        """Project to ``columns`` (None = all); the plan is rebuilt."""
        self._host.set_selected_columns(columns)

    def close(self) -> None:
        self._watchdog.stop()  # before the sampler: no dump mid-teardown
        # every unit in flight lands in the device section before the
        # sampler's last tick and the trace write
        self._device_timer.stop()
        self._xprof.stop()
        # deferred-finalize scans (scan_files) release the ledger here
        self._release_device_outstanding(all_bytes=True)
        self._sampler.stop()  # its final tick lands before the write
        self._host.close()
        if self._owns_tracer:
            self._tracer.write(registry=self.obs_registry())
            self._owns_tracer = False  # scan_files closes readers twice

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups or [])

    def stats(self) -> ReaderStats:
        return self._stats

    def pipeline_stats(self) -> PipelineStats:
        """Per-stage pipeline timing (io / decompress / recompress / stage /
        dispatch / finalize), stall time and the in-flight high-water mark
        of the current or last scan.  io and decompress fill only when
        ``prefetch`` > 0 routes the host phase through the chunk pool."""
        return self._pipe_stats

    def _plan_page_pruning(self, rg, leaves, f=None, index=None):
        """Page-level pushdown planning through the plan IR
        (``scanplan.plan_page_pruning``) with its per-row-group memo: a
        replayed plan skips the header walks and adopts the recorded skip
        sets, and returns no filter-chunk buffers (the decode loop reads
        those chunks itself, as without a filter).  Returns ``(skip sets
        by column path, rows dropped, filter-chunk buffers by path)``.
        ``f``: a positioned-read file view (the chunk feed passes its
        own); the header walks never seek the shared file object."""
        pred = self._host.row_filter
        if pred is None:
            return None, 0, {}
        t0 = time.perf_counter()
        plan = self._plan
        memo_ok = (plan is not None and index is not None
                   and plan.filter_fp is not None
                   and plan.filter_fp == predicate_fingerprint(pred))
        hint = plan.pruning_hint(index) if memo_ok else None
        if hint is not None:
            (skip, rows_dropped), bufs = hint, {}
        else:
            if f is None:
                f = self._sr.as_file()
            skip, rows_dropped, bufs = plan_page_pruning(
                rg, leaves, self.schema, pred, f)
            if memo_ok:
                plan.note_pruning(index, skip, rows_dropped)
        with self._stats_lock:
            self._stats.prune_seconds += time.perf_counter() - t0
        return skip, rows_dropped, bufs

    def _prepare_row_group(self, index: int, executor=None, collected=None):
        """Host phase: read, decompress and parse every selected chunk of the
        row group, registering all byte regions with ONE stager.

        With ``executor`` (the staging worker) the stager streams completed
        strips to the device while this thread still parses later chunks.
        With ``collected`` (the chunk feed's output: page pruning, IO, CRC,
        decompression, page parse and ship planning already done on the
        pool) this collapses to stager registration and plan construction.
        Only the host-decode path (``_finish_host``) touches the device
        here, on this thread's current stream.

        A raise (a data error the scan may contain) abandons the stager:
        its in-flight strips are joined and their pinned buffers returned
        before the error leaves."""
        rg = self.metadata.row_groups[index]
        if self._result_cache is not None:
            fed_cached = collected is not None and collected.get("cached")
            if fed_cached or collected is None:
                hit = self._cached_group(index)
                if hit is not None:
                    # a warm group: no IO, no staging, no launch
                    return hit, [], None
                if fed_cached:
                    # evicted since the feed's probe (the feed read
                    # nothing): decode it here on the sequential path
                    collected = None
        t0 = time.perf_counter()
        if self._t0 is None:
            self._t0 = t0
        phase = self._stats.host_phase
        unit = phase.begin()
        try:
            leaves = {l.path: l for l in self.schema.selected_leaves()}
            out: dict[str, DeviceColumnData] = {}
            f = self._sr.as_file()
            self.alloc.reset()
            if collected is None:
                skip_pages, rows_dropped, planned_bufs = (
                    self._plan_page_pruning(rg, leaves, index=index))
            else:
                skip_pages, planned_bufs = None, {}
                rows_dropped = collected["rows_dropped"]
            stager = _RowGroupStager(executor, self.device, self._pinned,
                                     timed=self._device_timer.enabled,
                                     host_phase=phase)
            try:
                plans = self._plan_chunks(index, rg, leaves, f, collected,
                                          skip_pages, planned_bufs, stager,
                                          out)
            except BaseException:
                stager.abandon()
                raise
        except BaseException:
            phase.drop(unit)
            raise
        rows = (rg.num_rows or 0) - rows_dropped
        self._stats.row_groups += 1
        self._stats.rows += rows
        self._stats.staged_bytes += stager.total
        now = time.perf_counter()
        self._stats.host_seconds += now - t0
        phase.end(unit, now - t0, rows)
        self._stats.wall_seconds = now - self._t0
        tr = self._pipe_stats.tracer
        if tr is not None and tr.active:
            tr.complete("prepare", t0, now, rg=index, bytes=stager.total)
        if self._result_cache is not None:
            # dispatch fills this dict in place; _flush_result_cache
            # publishes it after the finalize, and only if dispatched
            self._rc_pending[id(out)] = [index, out, False, 0, None]
        return out, plans, stager

    def _cached_group(self, index: int) -> "dict | None":
        """All-or-nothing result-cache probe for row group ``index``: every
        selected column cached under this reader's signature, or None.  A
        hit counts into the row-group and row stats (rows from the widest
        column's leaf slots), so rows/s describes what was served."""
        names = [".".join(l.path) for l in self.schema.selected_leaves()]
        if not names:
            return None
        got = self._result_cache.lookup_group(index, names)
        if got is None:
            return None
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self._stats.row_groups += 1
        self._stats.rows += max(
            (int(c.num_leaf_slots or 0) for c in got.values()), default=0)
        self._stats.wall_seconds = now - self._t0
        tr = self._pipe_stats.tracer
        if tr is not None and tr.active:
            tr.instant("result_cache_hit", rg=index, columns=len(got))
        return got

    def _flush_result_cache(self) -> None:
        """Publish the dispatched groups' columns to the result cache.
        Called by ``_finalize_many`` after the deferred checks pass, never
        from the dispatch path: a column that would fail them is never
        served.  Each group's event (recorded after its launches) is waited
        on first, so a cached tensor is complete for a consumer on any
        stream."""
        rc = self._result_cache
        if rc is None or not self._rc_pending:
            return
        pending, self._rc_pending = self._rc_pending, {}
        self._rc_pending_bytes = 0
        for index, out, dispatched, _n, done in pending.values():
            if not dispatched:
                continue
            if done is not None:
                done.synchronize()
            for name, col in out.items():
                col = _owning_copy(col)
                rc.put(index, name, col, device_column_nbytes(col))

    def _plan_chunks(self, index, rg, leaves, f, collected, skip_pages,
                     planned_bufs, stager, out) -> list:
        """``_prepare_row_group``'s chunk loop: each selected chunk's
        assembler (collected here, or taken from the feed), its plan on
        ``stager``, the counters, and the route memo.  An empty or fully
        pruned chunk becomes a placeholder column in ``out``.

        With the tracer active each chunk is a ``chunk`` span (``column``,
        ``pages``, ``route``) holding ``collect`` (read and page walk),
        ``preship`` (route choice and its host work) and ``finish`` (the
        device plan); the chunk feed records the first two on its
        workers."""
        plans: list[tuple[str, _Plan]] = []
        tr = self._pipe_stats.tracer
        spans = tr is not None and tr.active
        for path, leaf, _chunk, md, offset in row_group_chunks(rg, leaves):
            name = ".".join(path)
            t_chunk = time.perf_counter()
            t_collect = t_preship = None
            if collected is not None:
                entry = collected["chunks"].get(path)
                if entry is None:
                    # the selection changed between feed and prepare (both
                    # run on the consumer thread: a caller bug)
                    raise ParquetError(
                        f"prefetched row group {index} missing chunk "
                        f"{name}")
                md, asm = entry
                if isinstance(asm, _FailedChunk):
                    # a data error the feed carried: raised here, so the
                    # scan pipeline contains both paths alike
                    raise asm.exc
                self._stats.chunks += 1
                self._stats.compressed_bytes += md.total_compressed_size
                self.alloc.register(md.total_compressed_size)
            else:
                # the pruning planner already read the filter chunks
                buf = planned_bufs.get(path)
                if buf is None:
                    f.seek(offset)
                    buf = timed_part(PART_READ, f.read,
                                     md.total_compressed_size)
                require_full(buf, offset, md.total_compressed_size,
                             context=f"column {name}")
                self._stats.chunks += 1
                self._stats.compressed_bytes += md.total_compressed_size
                self.alloc.register(md.total_compressed_size)
                ctx = {"file": self._source_name, "row_group": index,
                       "column": name, "chunk_offset": offset}
                asm = _collect_chunk(buf, md.codec, md.num_values, leaf,
                                     self._deferred,
                                     validate_crc=self.validate_crc,
                                     alloc=self.alloc,
                                     statistics=md.statistics,
                                     skip_pages=(skip_pages or {}).get(path),
                                     context=ctx, device=self.device,
                                     dict_cache=self._dict_cache)
                t_collect = time.perf_counter()
                asm.preship(self._ship_planner, self._pipe_stats,
                            route_hint=self._plan.route_hint(index, name))
                t_preship = time.perf_counter()
            n_pages = len(asm.pages)
            self._stats.pages += n_pages
            self._stats.pages_pruned += asm.pages_pruned
            if not asm.pages:
                # empty or fully pruned: an empty int64 placeholder
                # whatever the column's type, as the reference's
                out[name] = DeviceColumnData(
                    values=torch.zeros(0, dtype=torch.int64,
                                       device=self.device),
                    max_def=leaf.max_def, max_rep=leaf.max_rep,
                    num_leaf_slots=0,
                )
                if spans:
                    self._chunk_spans(tr, name, 0, None, t_chunk, t_collect,
                                      t_preship, None, asm)
                continue
            if spans:
                asm.level_plans = []
            t_finish = time.perf_counter()
            plan = asm.finish(stager)
            t_done = time.perf_counter()
            plans.append((name, plan))
            self._stats.pages_device_expanded += asm.pages_kept_compressed
            self._stats.fused_fallbacks += asm.fused_fallbacks
            logical_sum = shipped_sum = 0
            best_route, best_bytes = None, -1
            for (route, logical, shipped, predicted, predicted_dev,
                 predicted_unfused_dev) in asm.ship_records:
                self._stats.count_route(route, logical, shipped, predicted,
                                        predicted_dev, predicted_unfused_dev)
                logical_sum += logical
                shipped_sum += shipped
                if shipped > best_bytes:
                    best_route, best_bytes = route, shipped
                if spans:
                    # one instant per shipped stream: the trace summary
                    # folds them into its per-route prediction table
                    tr.instant("ship", route=route, column=name,
                               logical=logical, shipped=shipped,
                               predicted_s=round(predicted, 9),
                               predicted_device_s=round(predicted_dev, 9))
            # the device lane times the column under its dominant
            # (most-shipped-bytes) route
            plan.route = best_route or ROUTE_PLAIN
            plan.bytes_in = logical_sum
            plan.bytes_staged = shipped_sum
            # memoize the decision: a replay starts preship from it
            self._plan.note_route(index, name, plan.route, plan.family)
            if spans:
                self._chunk_spans(tr, name, n_pages, plan.route,
                                  t_chunk, t_collect, t_preship,
                                  (t_finish, t_done), asm)
        seen = set(out) | {name for name, _ in plans}
        missing = {".".join(p) for p in leaves} - seen
        if missing:
            raise ParquetError(
                f"row group {index} missing columns {sorted(missing)}"
            )
        return plans

    @staticmethod
    def _chunk_spans(tr, name, pages, route, t0, t_collect, t_preship,
                     finish, asm) -> None:
        """One chunk's spans, recorded once the chunk is planned: its
        ``collect`` and ``preship`` children when they ran here (not on
        the chunk feed), its ``finish`` child with a ``levels`` child for
        each level plan (``kind``, ``slots``, ``streams``, ``route``), then
        ``chunk`` itself (``column``, ``pages``, ``route``, the leaf's
        ``max_def`` and ``max_rep``, and ``walk``: ``native`` or the chunk
        walk's fallback reason)."""
        if t_collect is not None:
            tr.complete("collect", t0, t_collect, column=name)
            tr.complete("preship", t_collect, t_preship, column=name)
        if finish is not None:
            tr.complete("finish", *finish, column=name)
            for kind, slots, streams, lroute, l0, l1 in asm.level_plans or ():
                tr.complete("levels", l0, l1, column=name, kind=kind,
                            slots=slots, streams=streams, route=lroute)
        leaf = asm.leaf
        tr.complete("chunk", t0, time.perf_counter(), column=name,
                    pages=pages, route=route, max_def=leaf.max_def,
                    max_rep=leaf.max_rep, walk=asm.walk)

    def _note_staged(self, stager: _RowGroupStager) -> None:
        """A staged row-group buffer is on the device: into the ledger,
        pending until its group is dispatched, and its copies to the device
        lane as one ``h2d`` transfer (on a CPU reader, an empty interval at
        the end of staging)."""
        n = int(stager.total)
        if n:
            self.alloc.register_device(n)
            with self._stats_lock:
                self._device_staged_pending += n
        timer = self._device_timer
        if timer.enabled:
            marks = stager.copy_marks or [(timer.mark(), None)]
            for j, (start, end) in enumerate(marks):
                last = j == len(marks) - 1
                # passes carries the transfer count: one per group
                timer.submit("h2d", "h2d", "h2d", start,
                             bytes_staged=n if last else 0,
                             passes=1 if last else 0, end=end or start)

    def _note_dispatched(self, stager: _RowGroupStager) -> None:
        """The group's kernels are enqueued: its staged bytes are released
        at the next finalize."""
        n = int(stager.total)
        if n:
            with self._stats_lock:
                self._device_staged_pending -= n
                self._device_outstanding += n

    def _release_device_outstanding(self, all_bytes: bool = False) -> None:
        """Release the ledger for the groups whose kernels a finalize just
        proved complete; ``all_bytes`` (close) also drops the staged
        buffers still pending."""
        with self._stats_lock:
            n, self._device_outstanding = self._device_outstanding, 0
            if all_bytes:
                n += self._device_staged_pending
                self._device_staged_pending = 0
        if n:
            self.alloc.release_device(n)

    def _dispatch_row_group(self, prepared, buf_dev=None):
        """Stage (unless the staging worker did: ``buf_dev``) and enqueue
        every chunk's decode.  A request trace (riding the cancel token, or
        the thread's current one) gets one ``device`` span per group."""
        out, plans, stager = prepared
        cancel = self._host._cancel
        rtrace = getattr(cancel, "trace", None) if cancel is not None else None
        if rtrace is None:
            rtrace = current_request_trace()
        if plans:
            tr0 = time.perf_counter() if rtrace is not None else 0.0
            if buf_dev is None:
                t0, c0 = time.perf_counter(), time.thread_time()
                with self._pipe_stats.timed("stage", bytes=stager.total), \
                        _xprof_annotation("stage"):
                    buf_dev = stager.stage()
                with self._stats_lock:
                    self._stats.stage_seconds += time.perf_counter() - t0
                self._stats.host_phase.add_stage_cpu(time.thread_time() - c0)
                self._note_staged(stager)
            if stager.ready is not None:
                # the copies ran on the stream current when the stager was
                # made; if this thread's stream is another, it waits for
                # them, and the allocator learns the buffer's new user
                cur = torch.cuda.current_stream(self.device)
                if cur != stager._stream:
                    cur.wait_event(stager.ready)
                    buf_dev.record_stream(cur)
            t1 = time.perf_counter()
            with self._pipe_stats.timed("dispatch"), \
                    _xprof_annotation("dispatch"):
                out.update(_run_plans(plans, buf_dev, self._device_timer))
            with self._stats_lock:
                self._stats.dispatch_seconds += time.perf_counter() - t1
            self._note_dispatched(stager)
            if rtrace is not None:
                rtrace.add_timed("device", tr0, time.perf_counter(),
                                 plans=len(plans),
                                 staged_bytes=int(stager.total))
        if self._result_cache is not None:
            self._note_rc_dispatched(out)
        if self._t0 is not None:
            self._stats.wall_seconds = time.perf_counter() - self._t0
        self._pipe_stats.count_row_group()
        self._pipe_stats.touch_wall()
        return out

    def _note_rc_dispatched(self, out: dict) -> None:
        """The group's columns are real decoded results now: publishable at
        the next finalize.  The pending bytes are bounded at twice the
        tier's capacity (room for the flush to overfill the tier and evict):
        past it the oldest pending group is dropped unpublished, so a
        deferred-finalize scan over many files pins no more than that."""
        ent = self._rc_pending.get(id(out))
        if ent is None:
            return
        ent[2] = True
        ent[3] = sum(device_column_nbytes(c) for c in out.values())
        if self.device.type == "cuda":
            ent[4] = torch.cuda.Event()
            ent[4].record(torch.cuda.current_stream(self.device))
        self._rc_pending_bytes += ent[3]
        rc = self._result_cache
        cap = 2 * rc.cache.tier_capacity(rc.tier)
        while self._rc_pending_bytes > cap and len(self._rc_pending) > 1:
            oldest = next(iter(self._rc_pending))
            if oldest == id(out):
                break
            self._rc_pending_bytes -= self._rc_pending.pop(oldest)[3]

    def read_row_group(self, index: int, finalize: bool = True) -> dict:
        """Decode row group ``index``: ``{column name: DeviceColumnData}``.
        With ``prefetch`` > 0 its chunks are collected on the pool."""
        collected = None
        if self._prefetch > 0:
            feed = _chunk_feed(iter([(self, None, index)]), self._prefetch,
                               self.alloc.max_size,
                               cancel=self._host._cancel)
            try:
                _r, _p, _i, collected = next(feed)
            finally:
                feed.close()
        out = self._dispatch_row_group(
            self._prepare_row_group(index, collected=collected))
        if finalize:
            self.finalize()
            self._device_timer.settle()
        return out

    def finalize(self) -> None:
        """Run the deferred dictionary-range checks (one device read for
        all chunks; there are none when the native run walk is built).  The
        read also proves the kernels reading the staged buffers complete,
        so the HBM ledger releases them."""
        with self._pipe_stats.timed("finalize"), \
                _xprof_annotation("finalize"):
            _finalize_many([self])
        self._release_device_outstanding()
        self._pipe_stats.touch_wall()

    def iter_row_groups(self, finalize_each: bool = False):
        """Yield each row group's ``{column name: DeviceColumnData}``
        through the one-deep pipeline: row group N is staged on the staging
        worker (strips streamed while it is parsed) while the consumer
        prepares N+1, and with ``prefetch`` > 0 the chunk pool reads and
        parses ahead.  Row groups ``row_filter`` pruned are skipped unread,
        and under a skip policy a row group with a data error is recorded
        and skipped.  Each scan starts fresh ``pipeline_stats()``."""
        self._pipe_stats = PipelineStats(prefetch=self._prefetch,
                                         budget_bytes=self.alloc.max_size,
                                         tracer=self._tracer)
        # a fresh scan token (retry budget, coalescing ladder, abort
        # poison) on both paths, carrying the request's deadline and cancel
        cancel = self._host._cancel
        self._sr.set_scan(self._store.begin_scan(cancel=cancel))
        indices = [i for i in range(self.num_row_groups)
                   if self.row_group_selected(i)]
        self.quarantine.begin_scan(len(indices))
        if not indices:
            self.finalize()
            return
        # profile_dir captures the scan; without it, the TPQ_XPROF window
        # (the two captures never nest)
        prof = _profile_start(self.device) if self.profile_dir else None
        xprof = None if self.profile_dir else self._xprof
        if xprof is not None:
            xprof.start()
        out = None
        try:
            with ThreadPoolExecutor(1, thread_name_prefix="tpq-stage") as ex:
                for _, out in _scan_pipeline(
                        ((self, None, i) for i in indices),
                        ex, finalize_each=finalize_each,
                        prefetch=self._prefetch,
                        budget_bytes=self.alloc.max_size,
                        watchdog=self._watchdog,
                        quarantine=self.quarantine, cancel=cancel):
                    yield out
                    if xprof is not None:
                        xprof.tick()
        except Exception as e:
            # a scan ended by an error (an exhausted retry, a cancel, a
            # deadline, a hang, an uncontained data error): the staging
            # worker is joined, so every strip's pinned buffer is back in
            # the pool; the staged bytes of groups never finalized leave
            # the ledger
            self._release_device_outstanding(all_bytes=True)
            if isinstance(e, _SCAN_ABORTS):
                out = None
                self._drop_pending_results()
                _drop_scan_frames(e)
            raise
        finally:
            # the scan is over: its timed units land, and no device-lane
            # thread outlives it
            self._device_timer.settle()
            if xprof is not None:
                xprof.stop()
            if prof is not None:
                self.profile_path = _profile_stop(prof, self.profile_dir)

    def _drop_pending_results(self) -> None:
        """An aborted scan publishes nothing: its pending result-cache
        groups (which hold their columns) go now."""
        self._rc_pending = {}
        self._rc_pending_bytes = 0

    def iter_batches(self, batch_size: int, columns=None):
        """Yield fixed-size device batches ``{column: tensor[batch_size]}``.

        Rows flow across row-group boundaries; the final short remainder is
        NOT yielded (drop_remainder semantics).  Fixed-width, flat,
        null-free columns only: a ragged BYTE_ARRAY column has no fixed row
        shape and raises ``TypeError`` (a string dictionary column is
        materialized first, and raises too), as does a repeated column."""
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
                if col.max_rep > 0:
                    raise TypeError(
                        f"iter_batches needs flat columns; {name!r} is "
                        f"repeated"
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


# ---------------------------------------------------------------------------
# the host pipeline: chunk feed, scan pipeline, multi-file scan
# ---------------------------------------------------------------------------

def _timed(pipe_stats, stage: str):
    """``pipe_stats.timed(stage)``, or nothing without stats."""
    return (pipe_stats.timed(stage) if pipe_stats is not None
            else contextlib.nullcontext())


def _owning_copy(col: DeviceColumnData) -> DeviceColumnData:
    """``col`` if each of its tensors owns its whole storage, else a copy
    whose views are cloned: a cached view of a row group's staged buffer
    would pin the whole buffer while the tier counts only the view."""
    swap = {}
    for attr in DEVICE_TENSOR_ATTRS:
        t = getattr(col, attr, None)
        if (t is not None and t.untyped_storage().nbytes()
                != t.numel() * t.element_size()):
            swap[attr] = t.clone(memory_format=torch.contiguous_format)
    return _dc_replace(col, **swap) if swap else col


def _finalize_many(readers) -> None:
    """Run every reader's deferred dictionary-range checks with ONE device
    read, placed after the last dispatch so nothing queued behind it
    waits, then publish each reader's checked groups to its result cache.
    A failing check raises before any list is cleared, so a second call
    raises again."""
    deferred = [d for r in readers for d in r._deferred]
    if deferred:
        host_max = torch.stack([m for m, _, _ in deferred]).cpu().numpy()
        for mx, (_, dict_len, path) in zip(host_max, deferred):
            if int(mx) >= dict_len:
                raise ParquetError(
                    f"dictionary index {int(mx)} out of range ({dict_len}) "
                    f"in column {path}"
                )
        for r in readers:
            # in place: the assemblers of prepared groups hold this list
            r._deferred.clear()
    # the checks passed (or there were none): the dispatched groups'
    # columns are valid, and go to the result cache
    for r in readers:
        r._flush_result_cache()


def _timed_stage(reader: DeviceFileReader, stager: _RowGroupStager):
    """Stage on the worker, into the owning reader's ``stage`` lane and
    ``stage_seconds`` (the worker and the consumer write the stats at
    once: hence the lock)."""
    t0, c0 = time.perf_counter(), time.thread_time()
    with reader._pipe_stats.timed("stage", bytes=stager.total), \
            _xprof_annotation("stage"):
        buf_dev = stager.stage()
    with reader._stats_lock:
        reader._stats.stage_seconds += time.perf_counter() - t0
    reader._stats.host_phase.add_stage_cpu(time.thread_time() - c0)
    reader._note_staged(stager)
    return buf_dev


def _chunk_feed(work, prefetch: int, budget_bytes: int = 0, cancel=None,
                watchdog=None):
    """Chunk-granular prefetch over the ``(reader, path, index)`` stream.

    The host half of the pipeline: IO, CRC, decompression, page parse and
    ship planning of upcoming chunks run on a pool of ``prefetch`` threads,
    the work items flattened across row-group and file boundaries, so the
    pool keeps working while the consumer registers, stages and dispatches
    the current group.  Yields ``(reader, path, index, collected)`` in work
    order, where ``collected`` is what ``_prepare_row_group(collected=...)``
    takes: ``{"chunks": {column path: (md, _ChunkAssembler or
    _FailedChunk)}, "rows_dropped": n}``.

    Page-pruning planning runs on the consumer thread as items are pulled
    (it precedes its group's reads), its header walks through the
    reader's positioned reads; the filter chunks it read are handed to
    their items and never read twice.  A data error of a chunk's
    collection becomes a ``_FailedChunk`` when the reader's policy
    contains it.

    The same flatten/regroup protocol as ``reader.FileReader.
    _decode_row_groups``, with other payloads.  Everything on the workers
    is host-only (``_collect_chunk``, ``preship``); the device plan is
    built in ``finish`` on the consumer.  The bytes in flight are bounded
    by an ``InFlightBudget`` over ``budget_bytes`` (backpressure), and each
    worker chunk registers against its own ``AllocTracker`` (the
    decompression-bomb guard without sharing the reader's per-row-group
    counter across threads).

    Every read goes through the reader's store with a scan token minted
    when the feed first meets the reader (carrying its cancel token).  A
    group its reader's result cache holds whole is fed as a sentinel with
    ``"cached": True``: nothing is read for it.  For
    a store that coalesces, each row group's chunk ranges are planned into
    spans (``CoalescedFetcher``; chunks the pruning planner already read
    never join one), and a store with the async primitive puts them in
    flight on the fetch engine when the group is planned; the pool's
    workers then read through the fetcher.  ``cancel`` is checked at every
    chunk and handed to the budget's wait.  An armed ``watchdog`` gets the
    budget's ``abort`` as a hook for the feed's lifetime: its raise policy
    wakes a submitter blocked on backpressure with ``HangError``."""
    budget = InFlightBudget(budget_bytes)
    if watchdog is not None and watchdog.enabled:
        watchdog.add_abort_hook(budget.abort)
    fed: set = set()  # readers whose _live_budget is this feed's
    pending: dict = {}
    current = {"stats": None}  # stats of the reader whose item submits
    depth_owner = {"stats": None}  # the stats whose queue gauge was set
    feedbox = {"eng": None}  # the fetch engine, once a store routes to it

    class _Feed:
        """Late-binding look-ahead gate for ``prefetch_map``: a multi-file
        stream may mix engine-routed and plain stores, and the engine is
        known only once a routed group is planned; until then the gate
        reports no appetite (the threaded behaviour)."""

        @property
        def max_inflight(self):
            eng = feedbox["eng"]
            return eng.max_inflight if eng is not None else 0

        @staticmethod
        def want_more():
            eng = feedbox["eng"]
            return eng is not None and eng.want_more()

    class _StatsFwd:
        """Route prefetch_map's stall, peak and queue-depth accounting to
        the reader whose chunk is submitting (submission happens on the
        consumer thread right after ``gen_items`` yields, so ``current``
        names it).  When the window moves to the next reader, the previous
        owner's queue gauge drops to 0."""

        @staticmethod
        def add_stall(seconds):
            st = current["stats"]
            if st is not None:
                st.add_stall(seconds)

        @staticmethod
        def set_queue_depth(n):
            st = current["stats"]
            prev = depth_owner["stats"]
            if prev is not None and prev is not st:
                prev.set_queue_depth(0)
            depth_owner["stats"] = st
            if st is not None:
                st.set_queue_depth(n)

        @staticmethod
        def note_peak(b):
            st = current["stats"]
            if st is not None:
                st.note_peak(b)

    def gen_items():
        for r, path, i in work:
            current["stats"] = r._pipe_stats
            r._live_budget = budget
            sr = r._sr
            if r not in fed:
                # this scan's token: its own retry budget and coalescing
                # ladder, carrying the reader's deadline and cancel
                fed.add(r)
                sr.set_scan(sr.store.begin_scan(cancel=r._host._cancel))
            rc = r._result_cache
            if rc is not None and rc.has_group(
                    i, [".".join(l.path) for l in r.schema.selected_leaves()],
                    count_misses=True):
                # a warm group: the feed reads nothing for it (no pruning
                # walk, no chunk IO); prepare probes again and decodes on
                # the sequential path if it was evicted in between
                pending[(id(r), i)] = {"r": r, "path": path, "i": i,
                                       "todo": 1, "chunks": {},
                                       "rows_dropped": 0, "cached": True}
                yield (r, i, None, None, None, None, None, None, None)
                continue
            rg = r.metadata.row_groups[i]
            leaves = {l.path: l for l in r.schema.selected_leaves()}
            skip_pages, rows_dropped, planned_bufs = r._plan_page_pruning(
                rg, leaves, f=sr.as_file(), index=i)
            items = []
            ranges = []
            for p, leaf, _chunk, md, offset in row_group_chunks(rg, leaves):
                buf0 = planned_bufs.get(p)
                items.append([r, i, p, leaf, md, offset,
                              (skip_pages or {}).get(p), buf0, None])
                if buf0 is None:
                    # chunks the pruning planner read are in hand: they
                    # never join a span
                    ranges.append((offset, md.total_compressed_size))
            st, tok = sr.store, sr._scan
            eng = engine_for_store(st)
            if eng is not None:
                feedbox["eng"] = eng
            use_coalesce = (st.prefers_coalescing
                            and not (tok.coalesce_disabled if tok is not None
                                     else st.coalesce_disabled)
                            and len(ranges) > 1)
            if ranges and (use_coalesce or eng is not None):
                # engine mode submits the group's fetches now (spans, or
                # single ranges once the ladder stops merging)
                fetcher = CoalescedFetcher(st, ranges, scan=tok, engine=eng,
                                           coalesce=use_coalesce)
                for it in items:
                    if it[7] is None:
                        it[8] = fetcher
            pending[(id(r), i)] = {"r": r, "path": path, "i": i,
                                   "todo": max(len(items), 1), "chunks": {},
                                   "rows_dropped": rows_dropped}
            if not items:
                # sentinel so an empty group still comes out in order
                items.append([r, i, None, None, None, None, None, None,
                              None])
            yield from map(tuple, items)

    def cost(item):
        md = item[4]
        if md is None:
            return 0
        comp = max(md.total_compressed_size or 0, 0)
        return comp + max(md.total_uncompressed_size or 0, comp)

    def collect(item):
        """One chunk's host phase on a pool worker: a unit of its reader's
        ``host_phase``, and with the tracer active its ``collect`` and
        ``preship`` spans."""
        r, i, p, leaf, md, offset, skip, buf0, fetcher = item
        if md is None:
            return (id(r), i), None, None
        phase = r._stats.host_phase
        t0 = time.perf_counter()
        unit = phase.begin()
        try:
            return collect_chunk(r, i, p, leaf, md, offset, skip, buf0,
                                 fetcher, t0)
        finally:
            phase.end(unit, time.perf_counter() - t0)

    def collect_chunk(r, i, p, leaf, md, offset, skip, buf0, fetcher, t0):
        stats = r._pipe_stats
        name = ".".join(p)
        ctx = {"file": r._source_name, "row_group": i,
               "column": name, "chunk_offset": offset}
        try:
            tracker = AllocTracker(r.alloc.max_size)
            tracker.register(md.total_compressed_size)
            if buf0 is not None:
                buf = buf0  # the pruning planner already read this chunk
            else:
                with stats.timed("io"):
                    buf = timed_part(
                        PART_READ,
                        fetcher.read if fetcher is not None
                        else r._sr.pread,
                        offset, md.total_compressed_size)
            require_full(buf, offset, md.total_compressed_size,
                         context=f"column {'.'.join(p)}")
            with stats.timed("decompress"):
                asm = _collect_chunk(buf, md.codec, md.num_values, leaf,
                                     r._deferred,
                                     validate_crc=r.validate_crc,
                                     alloc=tracker, statistics=md.statistics,
                                     skip_pages=skip, context=ctx,
                                     device=r.device,
                                     dict_cache=r._dict_cache)
        except ParquetError as e:
            # containment seam: a marker instead of a raise keeps the feed
            # flowing; the consumer records the unit
            if not r.quarantine.contains or isinstance(e,
                                                       DataIntegrityError):
                raise
            return (id(r), i), p, (md, _FailedChunk(annotate_data_error(
                e, **{k: v for k, v in ctx.items() if k != "chunk_offset"})))
        # ship planning on the same worker (its compression seconds land
        # in the recompress lane): overlaps the consumer's stage/dispatch
        t1 = time.perf_counter()
        asm.preship(r._ship_planner, stats,
                    route_hint=r._plan.route_hint(i, name))
        tr = stats.tracer
        if tr is not None and tr.active:
            tr.complete("collect", t0, t1, column=name)
            tr.complete("preship", t1, time.perf_counter(), column=name)
        stats.count_chunk()
        return (id(r), i), p, (md, asm)

    try:
        for key, p, payload in prefetch_map(gen_items(), collect, prefetch,
                                            budget=budget, cost=cost,
                                            stats=_StatsFwd(),
                                            cancel=cancel, feed=_Feed()):
            slot = pending[key]
            if p is not None:
                slot["chunks"][p] = payload
            slot["todo"] -= 1
            if slot["todo"] == 0:
                del pending[key]
                r = slot["r"]
                r._pipe_stats.note_peak(budget)
                r._pipe_stats.touch_wall()
                yield r, slot["path"], slot["i"], {
                    "chunks": slot["chunks"],
                    "rows_dropped": slot["rows_dropped"],
                    "cached": slot.get("cached", False)}
    finally:
        # un-bind the dead feed's budget: a later dump or sampler tick must
        # not report it live, and the watchdog must not abort it
        if watchdog is not None and watchdog.enabled:
            watchdog.remove_abort_hook(budget.abort)
        for r in fed:
            if r._live_budget is budget:
                r._live_budget = None


def _scan_pipeline(work, ex, finalize_each: bool = False,
                   close_finished: bool = False,
                   defer_finalize: bool = False,
                   prefetch: int = 0, budget_bytes: int = 0,
                   quarantine=None, cancel=None, watchdog=None):
    """The one-deep prepare/stage/dispatch pipeline shared by
    ``DeviceFileReader.iter_row_groups`` (one reader) and :func:`scan_files`
    (many).  ``work`` yields ``(reader, path, row_group_index)``; this yields
    ``(path, columns)`` per row group.  Row group N is staged on ``ex``
    while the consumer prepares N+1, then dispatched and yielded.

    With ``prefetch`` > 0 the host phase (chunk IO, decompression, parse)
    comes from :func:`_chunk_feed`'s pool; an eager error from a prefetched
    chunk may then preempt the preceding yield by up to the feed's depth
    (the sequential path's by exactly one).

    Ordering contract: a row group is always yielded before its reader's
    deferred checks can raise (finalize runs after the yield, at a file
    boundary, per group with ``finalize_each``, or at the end; never with
    ``defer_finalize``, whose caller runs them once).  With
    ``close_finished`` a reader is closed as soon as its last row group is
    delivered: all of its chunk reads precede that yield.

    Containment: a data error (``ParquetError``) raised by a row group's
    host phase is recorded in ``quarantine`` (else the reader's own
    engine) and the group skipped, when the policy contains it;
    ``skip_file`` also skips the rest of that reader's groups (counted,
    never read).  A budget-exhausted ``DataIntegrityError`` always
    propagates, and so does everything that is not a ``ParquetError``
    (a kernel build or launch failure, a CUDA error, an exhausted retry, a
    cancel or a deadline).

    ``cancel`` is checked before every row group's host phase (the
    reference checks it only in the chunk feed and the store's retry loop,
    so its sequential path over a ``LocalStore`` never sees it) and goes
    to the chunk feed.

    ``watchdog``: its consumer lane marks this generator producing (the
    dog may fire only then: a consumer pausing between groups is no hang),
    a fired raise policy surfaces at each unit boundary, and the chunk
    feed's budget is its abort hook.  A ``CancelledError``,
    ``DeadlineExceededError`` or ``HangError`` leaving the scan drops the
    prepared groups, staged buffers and outputs it holds, and the frames
    below it (``_drop_scan_frames``), before it propagates."""
    stream = (_chunk_feed(work, prefetch, budget_bytes, cancel=cancel,
                          watchdog=watchdog)
              if prefetch > 0
              else ((r, path, i, None) for r, path, i in work))
    lane = (watchdog.watch_consumer()
            if watchdog is not None and watchdog.enabled else None)
    dead: set = set()  # readers quarantined whole (skip_file)
    prev = prepared = out = None
    try:
        if lane is not None:
            lane.producing()
        prev = None  # (reader, path, prepared, staging future)
        for r, path, i, collected in stream:
            if watchdog is not None:
                watchdog.check()  # a fired raise policy, also at prefetch 0
            if cancel is not None:
                cancel.check()  # unit boundary: stop before the host phase
            q = quarantine if quarantine is not None else r.quarantine
            if id(r) in dead:
                # collateral skip of a skip_file-quarantined file:
                # accounted, never decoded, never a new record
                q.note_unit_skipped(
                    int(r.metadata.row_groups[i].num_rows or 0))
                continue
            try:
                prepared = r._prepare_row_group(i, executor=ex,
                                                collected=collected)
            except ParquetError as e:
                if not q.contains or isinstance(e, DataIntegrityError):
                    raise
                q.note(e, file=r._source_name, row_group=i)
                # the unit is skipped, so its traceback goes: its frames
                # hold the feed's marker, which holds the error, and the
                # cycle would keep the failed prepare's staged bytes on
                # the device until the next garbage collection (the
                # reference keeps it)
                e.with_traceback(None)
                q.note_unit_skipped(
                    int(r.metadata.row_groups[i].num_rows or 0))
                if q.policy == "skip_file":
                    q.note_file_skipped()
                    dead.add(id(r))
                continue
            fut = (ex.submit(_timed_stage, r, prepared[2])
                   if prepared[1] else None)
            if prev is not None:
                pr, pp, pprep, pfut = prev
                out = pr._dispatch_row_group(
                    pprep, pfut.result() if pfut else None)
                if lane is not None:
                    lane.idle()
                yield pp, out
                if lane is not None:
                    lane.producing()
                if finalize_each or pr is not r:
                    if not defer_finalize:
                        pr.finalize()
                    if close_finished and pr is not r:
                        pr.close()
            prev = (r, path, prepared, fut)
        if prev is not None:
            pr, pp, pprep, pfut = prev
            out = pr._dispatch_row_group(
                pprep, pfut.result() if pfut else None)
            if lane is not None:
                lane.idle()
            yield pp, out
            if lane is not None:
                lane.producing()
            if not defer_finalize:
                pr.finalize()
    except _SCAN_ABORTS as e:
        # the departure from the reference: the verdict's traceback would
        # keep these frames, and with them the scan's tensors, until a
        # garbage collection (the token that latched the verdict holds it)
        prev = prepared = out = collected = pprep = pfut = fut = None
        if prefetch > 0:
            stream.close()
        _drop_scan_frames(e)
        raise
    finally:
        # an abandoned or failed scan joins the chunk pool here, not at GC
        if prefetch > 0:
            stream.close()
        # the scan is over or dead: the lane stays advancing, so a long-
        # lived watchdog never reads post-scan idleness as a wedge
        if lane is not None:
            lane.idle()


# the verdicts that end a scan from outside it: their scans drop what they
# hold on the way out (see _drop_scan_frames)
_SCAN_ABORTS = (CancelledError, DeadlineExceededError, HangError)


def _drop_scan_frames(exc: BaseException) -> None:
    """Clear the locals of the finished frames an aborting verdict's
    tracebacks hold (its own, and those of the errors chained to it).

    A cancel, deadline or hang verdict is latched on its token (or kept by
    the caller beside it), and the frames of its traceback hold the scan:
    prepared groups, staged buffers, outputs not yet yielded.  The frames
    hold the reader, the reader holds the token, and the cycle keeps the
    scan's device memory until a garbage collection runs.  Executing frames
    (the caller's) are left alone.  The reference keeps the frames
    (``tpu_parquet/resilience.py``, ``CancelToken.check``)."""
    todo, seen = [exc], set()
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        traceback.clear_frames(e.__traceback__)
        todo += [e.__cause__, e.__context__]


def scan_files(paths, columns=None, validate_crc=None, max_memory: int = 0,
               row_filter=None, with_path: bool = False, prefetch: int = 0,
               on_data_error=None, quarantine=None, device=None, store=None,
               plan_cache=None, trace=None, sample_ms=None, hang_s=None,
               hang_policy=None):
    """Scan several files' row groups through ONE continuous pipeline.

    ``paths`` is a path, a list of paths, or a dataset: a
    ``tpq_manifest.json`` or a directory holding one
    (``write.manifest.expand_dataset``).  One staging worker spans the
    whole dataset, so file N+1's footer and host phase overlap file N's
    tail transfers as adjacent row groups do within a file; with
    ``prefetch=K`` the chunk pool also spans file boundaries.

    Yields one ``{column: DeviceColumnData}`` dict per row group in file
    order; ``with_path=True`` yields ``(path, columns)`` pairs.  The
    deferred dictionary-range checks run ONCE, after the last group is
    yielded; eager per-chunk errors raise from the pipelined prepare and
    may preempt the preceding group's yield.  Finished files close at the
    boundary, and every reader is closed on exit, on an error or an early
    ``break`` too.

    A consumer that abandons the scan and lets the generator be closed by
    the garbage collector loses the deferred-check exception (Python drops
    it); the error is also logged on this module's logger before it is
    raised.  Close the generator explicitly, or run it to the end, to get
    the ``ParquetError``.

    ``row_filter`` prunes each file's row groups (a pruned group, or a
    whole pruned file, is not read past its footer) and pages, as
    ``DeviceFileReader``'s.  ``on_data_error`` / ``quarantine``: ONE
    containment engine spans the scan, shared by every file's reader, so
    the budget and the ledger are the scan's (only the absolute budget
    binds: the unit total is not known up front).

    ``store=`` picks each file's byte store (``iostore.resolve_store``):
    pass a factory (``lambda f: MyRangeStore(...)``) so each file gets its
    own store; one shared instance would mix the files' bytes.

    ``plan_cache=`` (a ``serve.PlanCache``) reads every file's footer,
    ScanPlan and decoded dictionaries through shared state, and with a
    sized device tier its decoded row groups too: a re-scanned file parses
    nothing, and a fully cached one reads nothing.

    ``trace``: ONE tracer spans the scan (with a path, the trace and the
    merged registry of every reader are written when the scan ends);
    ``sample_ms`` samples each reader on it.  ``hang_s`` / ``hang_policy``:
    ONE watchdog spans the scan, over every reader's pipeline, reader and
    store heartbeats (the readers themselves are armed with ``hang_s=0``),
    and every file's store is its abort hook; the ``TPQ_XPROF`` window
    spans the files too.  A cancel, deadline or hang verdict drops what the
    scan holds on its way out, as ``DeviceFileReader.iter_row_groups``'s
    does."""
    from .write.manifest import expand_dataset

    paths, _manifest = expand_dataset(paths)
    dev = _resolve_device(device, "scan_files")
    tracer, owns_tracer = resolve_tracer(trace)
    q = quarantine if quarantine is not None else Quarantine(on_data_error)
    q.begin_scan()
    readers: list[DeviceFileReader] = []
    pool = _PinnedPool() if dev.type == "cuda" else None
    watchdog = _scan_watchdog(readers, hang_s, hang_policy)

    def work():
        for path in paths:
            kw = (plan_cache.reader_kwargs(path, columns=columns,
                                           row_filter=row_filter,
                                           device=dev,
                                           validate_crc=validate_crc)
                  if plan_cache is not None else {})
            r = DeviceFileReader(path, columns=columns,
                                 validate_crc=validate_crc, device=dev,
                                 max_memory=max_memory,
                                 row_filter=row_filter, quarantine=q,
                                 store=store, trace=tracer,
                                 sample_ms=sample_ms, hang_s=0, **kw)
            # one pinned pool for the whole dataset: the next file's
            # strips reuse the last file's buffers
            r._pinned = pool
            readers.append(r)
            if watchdog.enabled:
                # a fired watchdog wakes a fetch stalled in any file's store
                watchdog.add_abort_hook(r._store.abort)
            for i in range(r.num_row_groups):
                if r.row_group_selected(i):
                    yield r, path, i

    xprof = _XprofWindow(dev)
    xprof.start()
    out = None
    try:
        with ThreadPoolExecutor(1, thread_name_prefix="tpq-stage") as ex:
            for pp, out in _scan_pipeline(work(), ex, close_finished=True,
                                          defer_finalize=True,
                                          prefetch=int(prefetch),
                                          budget_bytes=int(max_memory),
                                          watchdog=watchdog, quarantine=q):
                yield (pp, out) if with_path else out
                xprof.tick()
        _finalize_many(readers)
    except _SCAN_ABORTS as e:
        out = None
        for r in readers:
            r._drop_pending_results()
        _drop_scan_frames(e)
        raise
    finally:
        xprof.stop()
        watchdog.stop()
        try:
            # again for a consumer that abandoned the scan: the files it
            # consumed still validate when the generator closes
            try:
                _finalize_many(readers)
            except ParquetError as e:
                logging.getLogger(__name__).error(
                    "scan_files deferred validation failed (swallowed if "
                    "this close is GC-driven): %s", e)
                raise
        finally:
            for r in readers:
                r.close()
            if owns_tracer and readers:
                reg = readers[0].obs_registry()
                for r in readers[1:]:
                    reg.merge_from(r.obs_registry())
                tracer.write(registry=reg)


def _scan_watchdog(readers: list, hang_s, hang_policy) -> Watchdog:
    """``scan_files``' one watchdog, started when armed: the summed
    pipeline, reader and store heartbeats of ``readers`` (the list the scan
    appends to)."""
    watchdog = Watchdog(resolve_hang_s(hang_s), policy=hang_policy)
    if not watchdog.enabled:
        return watchdog

    def _summed(sample):
        out: dict = {}
        for r in list(readers):
            for k, v in (sample(r) or {}).items():
                out[k] = out.get(k, 0) + v
        return out

    watchdog.watch("pipeline", lambda: _summed(lambda r: r._pipe_stats
                                               .sample()))
    watchdog.watch("reader", lambda: _summed(lambda r: {
        "rows": r._stats.rows, "chunks": r._stats.chunks,
        "staged_bytes": r._stats.staged_bytes}))
    # frozen fetch counters and a frozen pipeline: a network stall the dump
    # can name
    watchdog.watch("iostore", lambda: _summed(
        lambda r: r._store.stats.progress() if r._store.stats is not None
        else None))
    watchdog.start()
    return watchdog
