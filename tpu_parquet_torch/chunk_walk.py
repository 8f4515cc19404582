"""One column chunk's pages walked in a few native calls, not a loop per page.

The device reader's host phase walks every page of a chunk: the page header,
the CRC, the decompression of the pages the host needs as bytes, and in the
plan the run headers of every dictionary-index page.  Page by page from
Python (``chunk_decode.walk_pages`` and ``torch_decode.parse_data_page``),
each page pays an interpreter iteration, several ctypes calls and a thrift
``PageHeader`` object.  Here the chunk pays three native calls
(``native/chunk_walk.cpp``):

- :meth:`ChunkWalk.headers`: every page header into a flat page table, with
  ``walk_pages``' checks;
- :meth:`ChunkWalk.materialise`: the data pages' CRCs and decompression into
  one arena, with ``parse_data_page``'s per-page checks and lazy-page rule;
  the allocation register runs between the two calls;
- :meth:`ChunkWalk.index_runs`: the run walk of every dictionary-index page
  into one :class:`RunTables`, as ``_parse_dict_index_page`` walks each page.

The assembler's pages are :class:`WalkedPage` views over the page table and
the arena.  Every failure raises what the page loop raises, with the same
message; the device reader attaches the same page ordinal and offset.  The
walk engages on flat leaves (no level streams), v1 data pages and the
UNCOMPRESSED or SNAPPY codec (:func:`declines`); every other chunk takes the
page loop (``device_reader._collect_chunk``).
"""

from __future__ import annotations

import time

import numpy as np

from . import native
from .compress import CompressionError
from .errors import ParquetError
from .format import CompressionCodec, PageType
from .kernels.rle import RLEError
from .chunk_decode import PageSlice
from .format import DictionaryPageHeader, PageHeader
from .native import (F_CRC, F_ENCODING, F_TYPE, F_V2, M_DECOMPRESS, M_LAZY,
                     M_SNAPPY, M_VALIDATE_CRC, PT_CLAIM, PT_CRC, PT_CSIZE,
                     PT_ENCODING, PT_END, PT_FLAGS, PT_NVALUES, PT_START,
                     PT_TYPE, PT_USIZE, S_ARENA, S_LAZY)
from .obs import (PART_CRC, PART_DECOMPRESS, PART_PAGE_PARSE, PART_RUN_WALK,
                  split_part, timed_part)
from .thrift import ThriftError

__all__ = ["ChunkWalk", "RunTables", "WalkedPage", "declines",
           "materialize_pages"]

_perf = time.perf_counter

# chunk_walk.cpp's failure codes
(W_OK, W_EXHAUSTED, W_THRIFT, W_CSIZE, W_USIZE, W_PAST_END, W_EXTRA_DICT,
 W_DICT_HDR, W_V1_HDR, W_V2_HDR, W_CRC, W_NEG_VALUES, W_ENCODING,
 W_SNAPPY_LEN, W_SNAPPY_CLAIM, W_SNAPPY_BAD, W_SIZE, W_IDX_TRUNC,
 W_IDX_WIDTH, W_RUNS) = range(20)

# the native page-header parse's codes -> the thrift engine's messages
# (chunk_decode._NATIVE_THRIFT_ERRORS)
_THRIFT_ERRORS = {
    -40: "truncated thrift input",
    -41: "varint too long",
    -42: "thrift container exceeds sanity cap",
    -43: "thrift nesting too deep",
    -44: "cannot skip unknown thrift ctype",
}

_DATA, _DICT = int(PageType.DATA_PAGE), int(PageType.DICTIONARY_PAGE)
_SNAPPY = int(CompressionCodec.SNAPPY)
_CODECS = (int(CompressionCodec.UNCOMPRESSED), _SNAPPY)


def declines(codec, leaf) -> "str | None":
    """Why the chunk walk cannot take a chunk of ``leaf`` stored in
    ``codec`` (seen before any page is read), or None when it can."""
    if leaf.max_def > 0 or leaf.max_rep > 0:
        return "levels"
    if codec not in _CODECS:
        return "codec"
    if not native.available():
        return "no_native"
    return None


def _error(code: int, a: int, b: int) -> Exception:
    """The page loop's exception for a chunk_walk.cpp failure (all but
    ``W_EXHAUSTED``, whose message needs the page table)."""
    if code == W_THRIFT:
        msg = _THRIFT_ERRORS.get(a, f"thrift parse error {a}")
        e = ParquetError(f"corrupt page header: {msg}")
        e.__cause__ = ThriftError(msg)
        return e
    if code == W_CSIZE:
        return ParquetError(
            f"invalid compressed page size {a if b else None}")
    if code == W_USIZE:
        return ParquetError(
            f"invalid uncompressed page size {a if b else None}")
    if code == W_PAST_END:
        return ParquetError("page payload extends past chunk end")
    if code == W_EXTRA_DICT:
        return ParquetError("unexpected extra dictionary page")
    if code == W_DICT_HDR:
        return ParquetError("dictionary page missing its header")
    if code == W_V1_HDR:
        return ParquetError("data page v1 missing its header")
    if code == W_V2_HDR:
        return ParquetError("data page v2 missing its header")
    if code == W_CRC:
        return ParquetError(
            f"page CRC mismatch: header {a & 0xFFFFFFFF:#x}, data {b:#x}")
    if code == W_NEG_VALUES:
        return ParquetError(f"negative page value count {a}")
    if code == W_ENCODING:
        return ParquetError(f"unknown value encoding {a if b else None!r}")
    if code in (W_SNAPPY_LEN, W_SNAPPY_CLAIM, W_SNAPPY_BAD):
        if code == W_SNAPPY_LEN:
            msg = "malformed snappy data: bad length header"
        elif code == W_SNAPPY_CLAIM:
            msg = f"snappy stream claims {a} bytes, page declared {b}"
        else:
            msg = f"malformed snappy data (error {a})"
        e = CompressionError(msg)
        e.__cause__ = ValueError(msg)
        return e
    if code == W_SIZE:
        return CompressionError(
            f"page declared {a} uncompressed bytes, got {b}")
    if code == W_IDX_TRUNC:
        return ParquetError("dictionary page data truncated (missing width)")
    if code == W_IDX_WIDTH:
        return ParquetError(f"dictionary index width {a} invalid")
    if code == W_RUNS:
        return RLEError(native.NATIVE_ERRORS.get(a, f"hybrid parse error {a}"))
    return ParquetError(f"chunk walk error {code}")


class WalkedPage:
    """One data page of a walked chunk: what ``parse_data_page`` returns for
    a page of a flat leaf (``ParsedDataPage``'s fields and methods), as a
    view over the walk's page table and arena.  ``raw`` and ``comp`` are
    made on first use; a lazy page (PLAIN, SNAPPY) keeps its payload
    compressed until :meth:`materialize` or :meth:`peek`."""

    __slots__ = ("walk", "ix", "num_values", "defined", "encoding", "slot",
                 "_raw", "_comp")

    value_pos = 0
    def_levels = rep_levels = None
    def_stream = rep_stream = def_meta = None

    def __init__(self, walk, ix, num_values, encoding, slot, lazy):
        self.walk = walk
        self.ix = ix
        self.num_values = self.defined = num_values
        self.encoding = encoding
        self.slot = slot  # arena offset (-1: a view of the chunk)
        self._raw = b"" if lazy else None
        self._comp = True if lazy else None  # True: not made yet

    @property
    def raw(self):
        r = self._raw
        if r is None:
            r = self._raw = self.walk.page_bytes(self)
        return r

    @property
    def comp(self):
        c = self._comp
        if c is True:
            c = self._comp = self.walk.payload(self.ix)
        return c

    def materialize(self):
        """Host bytes, dropping the compressed payload (as
        ``ParsedDataPage.materialize``)."""
        if self._comp is not None:
            self.peek()
            self._comp = None
        return self.raw

    def peek(self):
        """Decompressed bytes, keeping the compressed payload (as
        ``ParsedDataPage.peek``)."""
        if self._comp is not None and len(self._raw) == 0:
            from .compress import decompress_block

            payload, codec, ulen = self.comp
            self._raw = decompress_block(payload, codec, ulen)
        return self.raw


def materialize_pages(pages, keep_comp: bool = False) -> None:
    """``materialize()`` (``peek()`` with ``keep_comp``) every page of a
    chunk; a walked chunk's lazy pages decompress in one native call."""
    walk = getattr(pages[0], "walk", None) if pages else None
    if walk is None:
        for p in pages:
            if keep_comp:
                p.peek()
            else:
                p.materialize()
        return
    walk.materialise_lazy(pages, keep_comp)


class RunTables:
    """The hybrid runs of consecutive dictionary-index pages, concatenated
    in page order (what ``_plan_hybrid_pallas`` builds from per-page
    ``HybridMeta``): per page ``ks`` runs, ``counts`` indices and the index
    ``widths``; per run ``ends`` (page-local cumulative), ``kinds`` (RLE),
    ``vals`` and ``starts`` (bit starts relative to the page's stream); each
    bit-packed run's used groups packed back to back in ``packed``, page
    j's from ``pk[j]`` to ``pk[j + 1]``; ``pages`` the pages walked."""

    __slots__ = ("pages", "ks", "counts", "widths", "ends", "kinds", "vals",
                 "starts", "packed", "pk", "r0")

    def __init__(self, pages, ks, counts, widths, ends, kinds, vals, starts,
                 packed, pk):
        self.pages = pages
        self.ks = ks
        self.counts = counts
        self.widths = widths
        self.ends = ends
        self.kinds = kinds
        self.vals = vals
        self.starts = starts
        self.packed = packed
        self.pk = pk
        self.r0 = None  # first run of each page, made on first use

    def _run0(self) -> np.ndarray:
        if self.r0 is None:
            self.r0 = np.concatenate([[0], np.cumsum(self.ks)])
        return self.r0

    def sub(self, a: int, b: int) -> "RunTables":
        """Pages ``a`` to ``b`` (exclusive) as run tables of their own."""
        r0 = self._run0()
        ra, rb = int(r0[a]), int(r0[b])
        return RunTables(self.pages[a:b], self.ks[a:b], self.counts[a:b],
                         self.widths[a:b], self.ends[ra:rb],
                         self.kinds[ra:rb], self.vals[ra:rb],
                         self.starts[ra:rb], self.packed,
                         self.pk[a : b + 1])

    def packed_bytes(self) -> np.ndarray:
        """The pages' bit-packed payloads, back to back."""
        return self.packed[int(self.pk[0]) : int(self.pk[-1])]

    def meta(self, j: int):
        """Page ``j``'s runs as the padded ``HybridMeta`` its own walk
        gives (``torch_decode._native_hybrid_meta``)."""
        from .torch_decode import HybridMeta, _bucket

        r0 = self._run0()
        a, n = int(r0[j]), int(self.ks[j])
        count = int(self.counts[j])
        rp = _bucket(max(n, 1))
        run_ends = np.full(rp, count, dtype=np.int64)
        run_is_rle = np.zeros(rp, dtype=bool)
        run_values = np.zeros(rp, dtype=np.uint32)
        run_bit_starts = np.zeros(rp, dtype=np.int64)
        run_ends[:n] = self.ends[a : a + n]
        run_is_rle[:n] = self.kinds[a : a + n]
        run_values[:n] = self.vals[a : a + n]
        run_bit_starts[:n] = self.starts[a : a + n]
        return HybridMeta(run_ends, run_is_rle, run_values, run_bit_starts,
                          count, 0, n_runs=n)


class ChunkWalk:
    """One chunk's page table (``native.PT_*`` columns, one row a page in
    file order), the chunk's bytes and the arena its decompressed data pages
    live in."""

    __slots__ = ("arr", "pt", "codec", "arena", "has_v2")

    def __init__(self, arr, pt, codec):
        self.arr = arr
        self.pt = pt
        self.codec = codec
        self.arena = None
        flags = pt[:, PT_FLAGS]
        self.has_v2 = bool((flags & F_V2).any())

    @classmethod
    def headers(cls, buf, total_values: int, codec) -> "ChunkWalk":
        """Walk every page header of the chunk ``buf`` (one native call),
        raising what ``chunk_decode.walk_pages`` raises."""
        arr = np.frombuffer(buf, np.uint8)
        t0 = _perf()
        pt, res = native.chunk_headers(arr, total_values, codec == _SNAPPY)
        split_part(PART_PAGE_PARSE, _perf() - t0, ())
        code = int(res[0])
        if code == W_EXHAUSTED:
            data = (pt[:, PT_FLAGS] & F_TYPE != 0) & np.isin(
                pt[:, PT_TYPE], (_DATA, int(PageType.DATA_PAGE_V2)))
            seen = sum(int(v) for v in pt[data, PT_NVALUES])
            raise ParquetError(
                f"chunk exhausted at {seen}/{total_values} values")
        if code != W_OK:
            raise _error(code, int(res[2]), int(res[3]))
        return cls(arr, pt, codec)

    def dictionary_page(self) -> "PageSlice | None":
        """The dictionary page (always the first page), as the page loop
        sees it, or None: the one thrift header the walk builds."""
        pt = self.pt
        if not (len(pt) and pt[0, PT_FLAGS] & F_TYPE
                and pt[0, PT_TYPE] == _DICT):
            return None
        row = [int(v) for v in pt[0]]
        flags = row[PT_FLAGS]
        header = PageHeader(
            type=_DICT, uncompressed_page_size=row[PT_USIZE],
            compressed_page_size=row[PT_CSIZE],
            crc=row[PT_CRC] if flags & F_CRC else None,
            dictionary_page_header=DictionaryPageHeader(
                num_values=row[PT_NVALUES],
                encoding=row[PT_ENCODING] if flags & F_ENCODING else None))
        return PageSlice(header, row[PT_START], row[PT_END])

    def data_pages(self) -> np.ndarray:
        """The page table rows of the data pages, in order (their data
        page ordinals are their positions here)."""
        pt = self.pt
        return np.flatnonzero((pt[:, PT_FLAGS] & F_TYPE != 0)
                              & (pt[:, PT_TYPE] == _DATA))

    def upper_bytes(self) -> int:
        """The most the read registers with its ``AllocTracker``: every
        dictionary and data page's declared size."""
        pt = self.pt
        real = (pt[:, PT_FLAGS] & F_TYPE != 0) & np.isin(
            pt[:, PT_TYPE], (_DATA, _DICT))
        return int(pt[real, PT_USIZE].sum())

    def materialise(self, ix: np.ndarray, validate_crc: bool, lazy: bool):
        """CRC-check and decompress the data pages ``ix`` (page table
        rows, in order) in one native call.  Returns (pages, failure):
        :class:`WalkedPage` per page done, and None or (j, code, exception)
        for the first page that failed (the pages before it are done)."""
        pt = self.pt
        snappy = self.codec == _SNAPPY
        flags = ((M_VALIDATE_CRC if validate_crc else 0)
                 | (M_LAZY if lazy else 0) | (M_SNAPPY if snappy else 0))
        rows = pt[ix]
        slot = np.zeros(len(ix), dtype=np.int64)
        if snappy:
            # a lazy page keeps its payload: no slot
            plain = ((rows[:, PT_FLAGS] & F_ENCODING != 0)
                     & (rows[:, PT_ENCODING] == 0) & lazy)
            claim = rows[:, PT_CLAIM]
            ok = ~plain & (claim >= 0) & (claim <= rows[:, PT_USIZE])
            slot = np.where(ok, claim, 0)
        room = (slot + 7) & ~7
        dst = np.cumsum(room) - room
        arena = np.empty(int(room.sum()) + 16, dtype=np.uint8)
        ix = np.ascontiguousarray(ix, dtype=np.int64)
        t0 = _perf()
        state, res = native.chunk_materialise(self.arr, pt, ix, flags, dst,
                                              arena)
        split_part(PART_PAGE_PARSE, _perf() - t0,
                   ((PART_CRC, int(res[4]) * 1e-9),
                    (PART_DECOMPRESS, int(res[5]) * 1e-9)))
        self.arena = arena
        code = int(res[0])
        done = int(res[1]) if code else len(ix)
        nv = rows[:done, PT_NVALUES].tolist()
        enc = np.where(rows[:done, PT_FLAGS] & F_ENCODING != 0,
                       rows[:done, PT_ENCODING], -1).tolist()
        st = state[:done].tolist()
        at = np.where(state[:done] == S_ARENA, dst[:done], -1).tolist()
        pages = [WalkedPage(self, i, n, None if e < 0 else e, s, k == S_LAZY)
                 for i, n, e, s, k in zip(ix[:done].tolist(), nv, enc, at,
                                          st)]
        if code:
            return pages, (done, code, _error(code, int(res[2]),
                                              int(res[3])))
        return pages, None

    def page_bytes(self, p: WalkedPage):
        """A page's host bytes: its arena slot, or its payload in the chunk
        (an uncompressed chunk's pages are views)."""
        row = self.pt[p.ix]
        if p.slot >= 0:
            return self.arena[p.slot : p.slot + int(row[PT_USIZE])]
        return self.arr[int(row[PT_START]) : int(row[PT_END])]

    def payload(self, ix: int):
        """A lazy page's ``comp``: (payload, codec, declared size)."""
        row = self.pt[ix]
        return (self.arr[int(row[PT_START]) : int(row[PT_END])], self.codec,
                int(row[PT_USIZE]))

    def materialise_lazy(self, pages, keep_comp: bool) -> None:
        """Decompress every lazy page of ``pages`` not decompressed yet in
        one native call, raising what the first failing page's
        ``materialize()`` raises; ``keep_comp`` keeps the payloads (as
        ``peek()``)."""
        todo = [p for p in pages if p._comp is not None and len(p._raw) == 0]
        if todo:
            ix = np.array([p.ix for p in todo], dtype=np.int64)
            rows = self.pt[ix]
            claim = rows[:, PT_CLAIM]
            ok = (claim >= 0) & (claim <= rows[:, PT_USIZE])
            room = (np.where(ok, claim, 0) + 7) & ~7
            dst = np.cumsum(room) - room
            arena = np.empty(int(room.sum()) + 16, dtype=np.uint8)
            _, res = timed_part(PART_DECOMPRESS, native.chunk_materialise,
                                self.arr, self.pt, ix,
                                M_DECOMPRESS | M_SNAPPY, dst, arena)
            done = int(res[1]) if res[0] else len(todo)
            for p, at, n in zip(todo[:done], dst[:done].tolist(),
                                rows[:done, PT_USIZE].tolist()):
                p._raw = arena[at : at + n]
            if res[0]:
                raise _error(int(res[0]), int(res[2]), int(res[3]))
        if not keep_comp:
            for p in pages:
                p._comp = None

    def index_runs(self, pages, dict_len: int) -> RunTables:
        """Walk the index streams of the dictionary-index ``pages`` (this
        walk's, in order) in one native call, as ``_parse_dict_index_page``
        walks each page, raising what the first failing page raises.
        Returns the run tables and the folded range max, or None without
        the native library (the pages are then walked one by one)."""
        base = self.arena if self.codec == _SNAPPY else self.arr
        starts = self.pt[:, PT_START]
        off = np.array([p.slot if p.slot >= 0 else starts[p.ix]
                        for p in pages], dtype=np.int64)
        lens = self.pt[[p.ix for p in pages], PT_USIZE]
        counts = np.array([p.defined for p in pages], dtype=np.int64)
        got = timed_part(PART_RUN_WALK, native.chunk_runs, base, off,
                         np.ascontiguousarray(lens), counts, dict_len)
        if got is None:
            return None
        ks, widths, ends, kinds, vals, bstarts, packed, pk, res = got
        if res[0]:
            raise _error(int(res[0]), int(res[2]), int(res[3]))
        runs = RunTables(pages, ks, counts, widths, ends, kinds.view(bool),
                         vals, bstarts, packed, pk)
        return runs, int(np.uint64(res[5]))

