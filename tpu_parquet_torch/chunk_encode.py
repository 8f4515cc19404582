"""Column-chunk encoding: page cutting, dictionary decision, page serialization.

Equivalent of the reference's chunk_writer.go (writeChunk :154-316, dictionary
decision :174-209, getValuesEncoder :80-128) + page_v1.go/page_v2.go/page_dict.go
write paths — batch-oriented: a chunk's values arrive as one ColumnData, pages are
cut at record boundaries targeting the max page size (default 1 MiB, matching
data_store.go:149-154), and the dictionary decision scans the whole chunk with the
reference's fallback threshold (> 32767 distinct values → plain, chunk_writer.go:
188-207 / type_dict.go:101-103).
"""

from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .column import ByteArrayData, ColumnData
from .compress import compress_block
from .footer import ParquetError
from .format import (
    ColumnChunk,
    ColumnMetaData,
    DataPageHeader,
    DataPageHeaderV2,
    DictionaryPageHeader,
    Encoding,
    KeyValue,
    PageHeader,
    PageType,
    Statistics,
    Type,
)
from .kernels import bitpack, bytearray as ba_codec, delta, plain, rle
from .schema.core import SchemaNode
from .stats import _lex_minmax, compute_statistics
from .thrift import serialize

MAX_DICT_SIZE = 32767  # MaxInt16, the reference's dictionary fallback threshold
DEFAULT_PAGE_SIZE = 1 << 20  # 1 MiB, data_store.go:149-154


@dataclass
class ChunkWriteResult:
    chunk: ColumnChunk
    total_compressed: int
    total_uncompressed: int


def _num_defined(cd: ColumnData) -> int:
    if cd.def_levels is None:
        return cd.num_leaf_slots
    return int(np.count_nonzero(cd.def_levels == cd.max_def))


def _values_slice(values, lo: int, hi: int):
    if isinstance(values, ByteArrayData):
        off = values.offsets[lo : hi + 1]
        heap = values.heap[off[0] : off[-1]]
        return ByteArrayData(offsets=off - off[0], heap=heap)
    return values[lo:hi]


def _unique_bytes_seq(values: ByteArrayData):
    """Sequential dict walk: O(heap) memory, bails at MAX_DICT_SIZE+1 distinct.
    The fallback for columns whose dominant length class would make the
    vectorized gather's transient memory excessive."""
    seen: dict = {}
    idx = np.empty(len(values), dtype=np.int64)
    for i, v in enumerate(values.to_list()):
        j = seen.get(v)
        if j is None:
            j = len(seen)
            if j >= MAX_DICT_SIZE:
                return None
            seen[v] = j
        idx[i] = j
    return ByteArrayData.from_list(list(seen)), idx


def _unique_rows(rows: np.ndarray):
    """(first_indices, inverse) for the distinct rows of a (m, L) u8 matrix.

    np.unique(axis=0) argsorts void-dtype rows — the single hottest writer
    cost on string columns (~80% of dict-encode time).  Instead: one
    vectorized FNV-1a pass gives a u64 hash per row, np.unique on the hashes
    sorts plain integers (~20x faster), and an exact vectorized compare of
    every row against its class representative guards correctness — any
    hash collision (never seen on real data, constructible adversarially)
    falls back to the sort-based path, so output never depends on hash
    quality.
    """
    m, ln = rows.shape
    if m <= 64 or ln > 512:
        # few rows, or very long values: the hash loop is one numpy op PER
        # BYTE COLUMN, so sort-based dedup (C over the whole matrix) wins
        _, first, inv = np.unique(rows, axis=0, return_index=True,
                                  return_inverse=True)
        return first, inv.reshape(-1)
    h = np.full(m, 14695981039346656037, dtype=np.uint64)
    fnv = np.uint64(1099511628211)
    for k in range(ln):
        h = (h ^ rows[:, k]) * fnv
    _, first, inv = np.unique(h, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    if not (rows == rows[first[inv]]).all():
        _, first, inv = np.unique(rows, axis=0, return_index=True,
                                  return_inverse=True)
        inv = inv.reshape(-1)
    return first, inv


def _unique_bytes(values: ByteArrayData):
    """Vectorized first-appearance uniquing of a ragged byte column.

    Native path: one O(n) open-addressing hash pass (tpq_dict_build_bytes)
    at memory speed.  Fallback: values grouped by length; each group's bytes
    gather into a fixed (m, L) u8 matrix that _unique_rows dedups at C speed
    — no per-value Python loop.  Distinct ids are renumbered by global first
    appearance; both paths produce identical output.
    """
    from . import native

    res = native.dict_build(
        len(values), MAX_DICT_SIZE,
        offsets=np.ascontiguousarray(values.offsets, dtype=np.int64),
        heap=np.ascontiguousarray(values.heap),
    )
    if res is not None:
        if isinstance(res, int):
            return None  # distinct count exceeded MAX_DICT_SIZE
        firsts, inverse = res
        return values.take(firsts), inverse.astype(np.int64)
    off = np.asarray(values.offsets)
    heap = np.asarray(values.heap)
    n = len(values)
    lens = np.diff(off)
    idx_out = np.empty(n, dtype=np.int64)
    groups = []  # (global_first[int64[k]], sel, inv) per length class
    distinct = 0
    for length in np.unique(lens):
        sel = np.flatnonzero(lens == length)
        ln = int(length)
        # the gather materializes ~9x this class's heap bytes transiently
        # (int64 index matrix + row copy + unique's sort buffers); past a
        # sane cap, the O(heap)-memory sequential walk is the better deal
        if len(sel) * max(ln, 1) * 9 > 512 << 20:
            return _unique_bytes_seq(values)
        rows = heap[off[sel][:, None] + np.arange(ln, dtype=np.int64)]
        first, inv = _unique_rows(rows)
        distinct += len(first)
        if distinct > MAX_DICT_SIZE:
            return None  # early bail: don't unique the remaining classes
        groups.append((sel[first], sel, inv))
    all_first = np.concatenate([g[0] for g in groups])
    order = np.argsort(all_first, kind="stable")
    rank = np.empty(len(all_first), dtype=np.int64)
    rank[order] = np.arange(len(order))
    pos = 0
    for g_first, sel, inv in groups:
        idx_out[sel] = rank[pos : pos + len(g_first)][inv]
        pos += len(g_first)
    return values.take(all_first[order]), idx_out


def _unique_with_indices(values, ptype: Type):
    """(dict_values, indices) preserving first-appearance order, or None if the
    distinct count exceeds the reference's MaxInt16 threshold."""
    if isinstance(values, ByteArrayData):
        if len(values) == 0:
            return ByteArrayData.from_list([]), np.zeros(0, dtype=np.int64)
        return _unique_bytes(values)
    arr = np.asarray(values)
    if ptype == Type.INT96:
        return None  # no dictionary for int96 (reference parity)
    from . import native

    if len(arr) and arr.ndim == 1 and arr.dtype.kind in "iuf":
        # native O(n) hash pass; distinct bit patterns are distinct values
        # (same memcmp semantics as the unique-on-int-views fallback).
        # Object/other dtypes would memcmp POINTERS, so they keep np.unique.
        res = native.dict_build(
            len(arr), MAX_DICT_SIZE,
            data=np.ascontiguousarray(arr), width=arr.dtype.itemsize,
        )
        if res is not None:
            if isinstance(res, int):
                return None
            firsts, inverse = res
            return arr[firsts], inverse.astype(np.int64)
    view = arr.view(np.int32) if arr.dtype == np.float32 else (
        arr.view(np.int64) if arr.dtype == np.float64 else arr
    )
    uniq, first_idx, inv = np.unique(view, return_index=True, return_inverse=True)
    if len(uniq) > MAX_DICT_SIZE:
        return None
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    dict_vals = arr[np.sort(first_idx)]
    return dict_vals, rank[inv]


def _encode_values(values, leaf: SchemaNode, encoding: Encoding) -> bytes:
    ptype = leaf.physical_type
    if encoding == Encoding.PLAIN:
        # zero-copy uint8 view for fixed-width types (compressors and the
        # parts-based page writer take any buffer)
        return plain.encode_view(values, ptype, leaf.type_length)
    if encoding == Encoding.DELTA_BINARY_PACKED:
        if ptype == Type.INT32:
            return delta.encode(np.asarray(values), bits=32)
        if ptype == Type.INT64:
            return delta.encode(np.asarray(values), bits=64)
        raise ParquetError(f"DELTA_BINARY_PACKED invalid for {ptype!r}")
    if encoding == Encoding.DELTA_LENGTH_BYTE_ARRAY:
        if not isinstance(values, ByteArrayData):
            raise ParquetError("DELTA_LENGTH_BYTE_ARRAY needs byte arrays")
        return ba_codec.encode_delta_length(values)
    if encoding == Encoding.DELTA_BYTE_ARRAY:
        if not isinstance(values, ByteArrayData):
            raise ParquetError("DELTA_BYTE_ARRAY needs byte arrays")
        return ba_codec.encode_delta(values)
    if encoding == Encoding.RLE:
        if ptype != Type.BOOLEAN:
            raise ParquetError("RLE value encoding is boolean-only")
        return rle.encode_prefixed(np.asarray(values).astype(np.uint64), 1)
    if encoding == Encoding.BYTE_STREAM_SPLIT:
        arr = np.asarray(values)
        raw = plain.encode(arr, ptype, leaf.type_length)
        width = {Type.FLOAT: 4, Type.DOUBLE: 8, Type.INT32: 4, Type.INT64: 8}[ptype]
        mat = np.frombuffer(raw, np.uint8).reshape(-1, width)
        return mat.T.tobytes()
    raise ParquetError(f"unsupported write encoding {encoding!r}")


class ChunkEncoder:
    """Serializes one column chunk (dict decision + page cutting + headers)."""

    def __init__(
        self,
        leaf: SchemaNode,
        codec: int,
        page_size: int = DEFAULT_PAGE_SIZE,
        data_page_version: int = 1,
        use_dictionary: bool = True,
        write_crc: bool = False,
        encoding: Optional[Encoding] = None,
        write_statistics: bool = True,
        stats=None,
    ):
        self.leaf = leaf
        self.codec = codec
        self.page_size = page_size
        self.v2 = data_page_version == 2
        self.use_dictionary = use_dictionary
        self.write_crc = write_crc
        self.fallback_encoding = encoding or Encoding.PLAIN
        self.write_statistics = write_statistics
        # (min, max) bytes for dict-encoded BYTE_ARRAY page stats; set per
        # write() from the dictionary (O(distinct)), see _page_statistics
        self._dict_stat_bounds = None
        # write-side lane attribution (write.WriteStats): write() books
        # its codec passes as `compress`, the sink write loop as `flush`,
        # and the remaining chunk wall as `encode` — the three lanes the
        # doctor needs to name a slow write's bottleneck
        self.stats = stats
        self._compress_s = 0.0

    def _compress(self, raw) -> bytes:
        """compress_block with the codec pass booked into the `compress`
        write lane (one perf_counter pair per page when stats are on)."""
        if self.stats is None:
            return compress_block(raw, self.codec)
        t0 = time.perf_counter()
        out = compress_block(raw, self.codec)
        self._compress_s += time.perf_counter() - t0
        return out

    # -- page boundary selection ----------------------------------------------

    def _page_bounds(self, cd: ColumnData) -> list[tuple[int, int]]:
        """Split slots into pages at record boundaries targeting page_size."""
        n = cd.num_leaf_slots
        if n == 0:
            return [(0, 0)]
        if cd.rep_levels is not None:
            record_starts = np.flatnonzero(cd.rep_levels == 0)
        else:
            record_starts = None  # flat: every slot is a record boundary
        # estimated bytes/slot
        if isinstance(cd.values, ByteArrayData):
            per_slot = (int(cd.values.offsets[-1]) + 4 * len(cd.values)) / max(n, 1)
        else:
            per_slot = cd.values.dtype.itemsize if len(cd.values) else 4
        slots_per_page = max(int(self.page_size / max(per_slot, 0.125)), 1)
        bounds = []
        start = 0
        while start < n:
            target = start + slots_per_page
            if target >= n:
                bounds.append((start, n))
                break
            if record_starts is None:
                bounds.append((start, target))
                start = target
                continue
            # next record boundary at/after target
            i = int(np.searchsorted(record_starts, target))
            if i >= len(record_starts):
                bounds.append((start, n))
                break
            nxt = int(record_starts[i])
            if nxt == start:
                nxt = int(record_starts[i + 1]) if i + 1 < len(record_starts) else n
            bounds.append((start, nxt))
            start = nxt
        return bounds

    # -- serialization ---------------------------------------------------------

    def write(self, cd: ColumnData, sink, offset: int) -> ChunkWriteResult:
        """Serialize the chunk into sink (a writable), starting at file offset."""
        t_start = time.perf_counter() if self.stats is not None else 0.0
        self._compress_s = 0.0
        leaf = self.leaf
        ptype = leaf.physical_type
        # normalize the all-defined shorthand (def_levels=None with max_def>0)
        # that the rest of the codebase accepts
        if cd.max_def > 0 and cd.def_levels is None:
            cd = ColumnData(
                values=cd.values,
                def_levels=np.full(cd.num_leaf_slots, cd.max_def, dtype=np.int32),
                rep_levels=cd.rep_levels,
                max_def=cd.max_def, max_rep=cd.max_rep,
                num_leaf_slots=cd.num_leaf_slots,
            )
        if cd.max_rep > 0 and cd.rep_levels is None:
            cd = ColumnData(
                values=cd.values, def_levels=cd.def_levels,
                rep_levels=np.zeros(cd.num_leaf_slots, dtype=np.int32),
                max_def=cd.max_def, max_rep=cd.max_rep,
                num_leaf_slots=cd.num_leaf_slots,
            )
        # parts list, not a growing bytearray: the += growth copies plus the
        # final bytes() copy re-wrote a 16 MB row group ~2.5x over — ~40% of
        # a plain-int64 chunk write
        parts: list = []
        pos = 0

        dict_pair = None
        if self.use_dictionary and ptype != Type.BOOLEAN:
            dict_pair = _unique_with_indices(cd.values, ptype)
        use_dict = dict_pair is not None
        # dictionary-wide lexicographic bounds for BYTE_ARRAY page stats:
        # one O(distinct) pass here instead of O(values) per page
        self._dict_stat_bounds = None
        if (use_dict and self.write_statistics
                and ptype == Type.BYTE_ARRAY
                and isinstance(dict_pair[0], ByteArrayData)
                and len(dict_pair[0])):
            self._dict_stat_bounds = _lex_minmax(dict_pair[0])

        encodings: set[int] = set()
        encoding_used = Encoding.RLE_DICTIONARY if use_dict else self.fallback_encoding
        dict_page_offset = None
        data_page_offset = None
        chunk_stats: Optional[Statistics] = None
        total_uncompressed = 0

        if use_dict:
            dict_vals, indices = dict_pair
            raw = plain.encode(dict_vals, ptype, leaf.type_length)
            comp = self._compress(raw)
            ph = PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                uncompressed_page_size=len(raw),
                compressed_page_size=len(comp),
                dictionary_page_header=DictionaryPageHeader(
                    num_values=len(dict_vals), encoding=int(Encoding.PLAIN)
                ),
            )
            if self.write_crc:
                ph.crc = _crc_i32(comp)
            hdr = serialize(ph)
            dict_page_offset = offset + pos
            parts.append(hdr)
            parts.append(comp)
            pos += len(hdr) + len(comp)
            total_uncompressed += len(raw) + len(hdr)
            encodings.add(int(Encoding.PLAIN))

        # per-page writes
        page_stats_list: list = []
        bounds = self._page_bounds(cd)
        defined_prefix = (
            np.cumsum(cd.def_levels == cd.max_def)
            if cd.def_levels is not None
            else None
        )
        for lo, hi in bounds:
            if defined_prefix is not None:
                vlo = int(defined_prefix[lo - 1]) if lo > 0 else 0
                vhi = int(defined_prefix[hi - 1]) if hi > 0 else 0
            else:
                vlo, vhi = lo, hi
            if use_dict:
                page_payload = self._encode_dict_indices(
                    dict_pair[1][vlo:vhi], len(dict_pair[0])
                )
            else:
                page_payload = _encode_values(
                    _values_slice(cd.values, vlo, vhi), leaf, encoding_used
                )
            page_parts, hdr_len, raw_len, pstats = self._write_data_page(
                cd, lo, hi, vlo, vhi, page_payload, encoding_used
            )
            page_stats_list.append(pstats)
            if data_page_offset is None:
                data_page_offset = offset + pos
            parts.extend(page_parts)
            pos += sum(len(pp) for pp in page_parts)
            total_uncompressed += raw_len + hdr_len
            encodings.add(int(encoding_used))
        encodings.add(int(Encoding.RLE))  # level (and dict-index) encoding

        if self.write_statistics:
            n_slots = (len(cd.def_levels) if cd.def_levels is not None
                       else len(cd.values))
            # chunk stats == fold of the per-page stats already computed in
            # the page loop (min of mins, summed nulls) — a second full
            # min/max pass over the chunk doubled the stats cost
            chunk_stats = _fold_page_stats(
                page_stats_list, ptype, n_slots - len(cd.values))
            if chunk_stats is None:
                # pages carried no stats (booleans, INT96, non-dict byte
                # arrays, all-NaN float pages): one chunk-level pass.  Dict
                # chunks compute min/max over the DICTIONARY (identical by
                # definition — the lexicographic pass over n values was the
                # single hottest writer cost on low-cardinality strings)
                stat_values = dict_pair[0] if use_dict else cd.values
                chunk_stats = compute_statistics(
                    stat_values, ptype, null_count=n_slots - len(cd.values),
                )

        if self.stats is not None:
            t_flush = time.perf_counter()
            for part in parts:
                sink.write(part)
            flush_s = time.perf_counter() - t_flush
            # the chunk's three write lanes, partitioned exactly: codec
            # passes (compress), the sink write loop (flush), and the
            # remaining encode wall (dict build, page cutting, values,
            # headers) — the doctor's slow-write attribution basis
            self.stats.add("compress", self._compress_s)
            self.stats.add("flush", flush_s)
            self.stats.add(
                "encode",
                max(time.perf_counter() - t_start
                    - self._compress_s - flush_s, 0.0))
        else:
            for part in parts:
                sink.write(part)

        md = ColumnMetaData(
            type=int(ptype),
            encodings=sorted(encodings),
            path_in_schema=list(leaf.path),
            codec=int(self.codec),
            num_values=cd.num_leaf_slots,
            total_uncompressed_size=total_uncompressed,
            total_compressed_size=pos,
            data_page_offset=data_page_offset if data_page_offset is not None else offset,
            dictionary_page_offset=dict_page_offset,
            statistics=chunk_stats if self.write_statistics else None,
        )
        chunk = ColumnChunk(file_offset=offset, meta_data=md)
        return ChunkWriteResult(
            chunk=chunk, total_compressed=pos,
            total_uncompressed=total_uncompressed,
        )

    def _encode_dict_indices(self, idx: np.ndarray, dict_len: int) -> bytes:
        width = bitpack.bit_width(max(dict_len - 1, 0))
        body = rle.encode(idx.astype(np.uint64), width)
        return bytes([width]) + body

    def _page_statistics(self, cd: ColumnData, lo, hi, vlo, vhi):
        """Per-page Statistics for fixed-width numeric pages (data_store.go:
        159-179 parity — the reference carries stats in every data page).
        Dict-encoded BYTE_ARRAY pages carry DICTIONARY-WIDE min/max bounds
        (set by write(): O(distinct) once per chunk, not O(values) per page
        — the per-page lexicographic pass was the writer's hottest path) and
        page-exact null counts; bounds wider than the page's actual values
        are sound for pruning readers.  Other ragged/boolean/INT96 pages
        skip stats."""
        if not self.write_statistics:
            return None
        if self.leaf.physical_type not in (Type.INT32, Type.INT64,
                                           Type.FLOAT, Type.DOUBLE):
            if self._dict_stat_bounds is not None and vhi > vlo:
                st = Statistics(null_count=(hi - lo) - (vhi - vlo))
                # dictionary-wide BOUNDS are only legal in min_value/max_value
                # (which permit non-occurring values); the deprecated min/max
                # fields imply actual page values and an ambiguous BYTE_ARRAY
                # sort order, so modern writers leave them unset here
                st.min_value = self._dict_stat_bounds[0]
                st.max_value = self._dict_stat_bounds[1]
                return st
            return None
        vals = cd.values[vlo:vhi]
        if len(vals) == 0:
            return None
        return compute_statistics(
            np.asarray(vals), self.leaf.physical_type,
            null_count=(hi - lo) - (vhi - vlo),
        )

    def _write_data_page(
        self, cd: ColumnData, lo, hi, vlo, vhi, payload, encoding
    ) -> tuple[list, int, int, "Optional[Statistics]"]:
        """Returns ([header, body parts...], header_len,
        uncompressed_payload_len, page_statistics).  Parts are bytes-like
        (the snappy path hands back uint8 arrays); callers append them to
        the chunk's parts list — concatenating here re-copied every page."""
        leaf = self.leaf
        num_values = hi - lo
        page_stats = self._page_statistics(cd, lo, hi, vlo, vhi)
        rep_bytes = b""
        def_bytes = b""
        if self.v2:
            if cd.max_rep > 0:
                rep_bytes = rle.encode(
                    cd.rep_levels[lo:hi].astype(np.uint64),
                    bitpack.bit_width(cd.max_rep),
                )
            if cd.max_def > 0:
                def_bytes = rle.encode(
                    cd.def_levels[lo:hi].astype(np.uint64),
                    bitpack.bit_width(cd.max_def),
                )
            comp = self._compress(payload)
            num_rows = (
                int(np.count_nonzero(cd.rep_levels[lo:hi] == 0))
                if cd.rep_levels is not None
                else num_values
            )
            header = PageHeader(
                type=int(PageType.DATA_PAGE_V2),
                uncompressed_page_size=len(rep_bytes) + len(def_bytes) + len(payload),
                compressed_page_size=len(rep_bytes) + len(def_bytes) + len(comp),
                data_page_header_v2=DataPageHeaderV2(
                    num_values=num_values,
                    num_nulls=num_values - (vhi - vlo),
                    num_rows=num_rows,
                    encoding=int(encoding),
                    definition_levels_byte_length=len(def_bytes),
                    repetition_levels_byte_length=len(rep_bytes),
                    is_compressed=True,
                    statistics=page_stats,
                ),
            )
            if self.write_crc:
                header.crc = _crc_i32(comp, zlib.crc32(def_bytes,
                                                       zlib.crc32(rep_bytes)))
            hdr = serialize(header)
            return ([hdr, rep_bytes, def_bytes, comp], len(hdr),
                    len(rep_bytes) + len(def_bytes) + len(payload),
                    page_stats)
        # v1: everything in one compressed block
        if cd.max_rep > 0:
            rep_bytes = rle.encode_prefixed(
                cd.rep_levels[lo:hi].astype(np.uint64),
                bitpack.bit_width(cd.max_rep),
            )
        if cd.max_def > 0:
            def_bytes = rle.encode_prefixed(
                cd.def_levels[lo:hi].astype(np.uint64),
                bitpack.bit_width(cd.max_def),
            )
        # flat required columns: compress the payload buffer directly (the
        # bytes concat would copy the whole page just to prepend nothing)
        if not rep_bytes and not def_bytes:
            raw = payload
        else:
            raw = rep_bytes + def_bytes + (
                payload if isinstance(payload, bytes) else bytes(payload))
        comp = self._compress(raw)
        header = PageHeader(
            type=int(PageType.DATA_PAGE),
            uncompressed_page_size=len(raw),
            compressed_page_size=len(comp),
            data_page_header=DataPageHeader(
                num_values=num_values,
                encoding=int(encoding),
                definition_level_encoding=int(Encoding.RLE),
                repetition_level_encoding=int(Encoding.RLE),
                statistics=page_stats,
            ),
        )
        if self.write_crc:
            header.crc = _crc_i32(comp)
        hdr = serialize(header)
        return [hdr, comp], len(hdr), len(raw), page_stats


def _fold_page_stats(plist, ptype: Type, null_count: int):
    """Chunk Statistics folded from per-page Statistics (numeric fixed
    types; None when any page lacks bounds — caller recomputes)."""
    fmts = {Type.INT32: "<i", Type.INT64: "<q",
            Type.FLOAT: "<f", Type.DOUBLE: "<d"}
    fmt = fmts.get(ptype)
    if fmt is None or not plist:
        return None
    if any(p is None or p.min_value is None or p.max_value is None
           for p in plist):
        return None
    mn = min(struct.unpack(fmt, p.min_value)[0] for p in plist)
    mx = max(struct.unpack(fmt, p.max_value)[0] for p in plist)
    st = Statistics(null_count=null_count)
    st.min = st.min_value = struct.pack(fmt, mn)
    st.max = st.max_value = struct.pack(fmt, mx)
    return st


def _crc_i32(data, start: int = 0) -> int:
    v = zlib.crc32(data, start) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v
