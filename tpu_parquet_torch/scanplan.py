"""ScanPlan IR: the reusable plan a scan executes.

The counterpart of ``tpu_parquet.scanplan``.  A scan derives the same facts
on every open: the footer walk that turns row-group metadata into per-chunk
byte ranges, the statistics-based row-group pruning verdict, the page-level
predicate-pushdown plan (header walks and skip sets), and the ship
planner's route ranking.  This module builds them once as an explicit,
serializable IR:

    ScanPlan = file identity + projection + filter fingerprint
             + per-row-group chunk byte ranges (the footer slice)
             + row-group keep verdicts (group pruning)
             + memoized page-pruning skip sets
             + memoized ship-route choices + kernel families

Both readers (``FileReader`` / ``DeviceFileReader``) build one per open, or
accept a prebuilt one via ``plan=`` and *replay* it: group pruning is not
recomputed, page-pruning header walks are skipped, and the ship planner
starts from the memoized route.  ``SCANPLAN_VERSION`` and the serialized
layout are the reference's: a plan one package serializes, the other
deserializes — except that this package also accepts the ``fused`` kernel
family its own readers (and the reference's) record for K2/K3 chunks.

The module is also the home of the footer walk every read path shares
(:func:`row_group_chunks`), of the projection (:func:`apply_selection`)
and of the statistics span hint of the narrow routes
(:func:`int_stats_span`).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Optional

from .chunk_decode import validate_chunk_meta, walk_pages
from .errors import ParquetError
from .format import PageType
from .obs import PART_PAGE_PARSE, PART_READ, host_part, timed_part
from .ship import ROUTES

__all__ = [
    "SCANPLAN_VERSION", "ChunkPlan", "RowGroupPlan", "ScanPlan",
    "build_scan_plan", "row_group_chunks", "row_group_byte_span",
    "walk_header_pages", "plan_page_pruning", "predicate_fingerprint",
]

SCANPLAN_VERSION = 1
_MAGIC = b"TPQP"

# kernel-family names a deserialized plan may carry (device_reader's
# _KERNEL_FAMILIES values plus the host-only marker); anything else in a
# blob is a lie the deserializer rejects.  The reference's list lacks
# "fused", which its own readers record for fused_plain and
# fused_narrow_snappy chunks, so it rejects such plans of its own making;
# this list takes them.
_FAMILIES = frozenset((
    "snappy_resolve", "narrow", "levels", "gather", "unpack", "plain",
    "fused", "host",
))


# ---------------------------------------------------------------------------
# the shared footer walk (single source of truth for chunk byte ranges)
# ---------------------------------------------------------------------------

def row_group_chunks(rg, leaves):
    """Walk one row group's SELECTED column chunks in file order.

    Yields ``(path, leaf, chunk, md, offset)`` per selected leaf —
    ``md``/``offset`` already through :func:`validate_chunk_meta` (the
    dictionary-page-offset min, the type check, the external-file
    rejection).  This is the one chunk walk every consumer shares: the
    sequential reader, the prefetch feeds, and :func:`build_scan_plan`.
    """
    for chunk in rg.columns or []:
        md = chunk.meta_data
        if md is None or md.path_in_schema is None:
            raise ParquetError("column chunk missing metadata/path")
        path = tuple(md.path_in_schema)
        leaf = leaves.get(path)
        if leaf is None:
            continue  # unselected: never read its bytes
        md, offset = validate_chunk_meta(chunk, leaf)
        yield path, leaf, chunk, md, offset


def row_group_byte_span(rg, leaves) -> "tuple[int, int]":
    """One row group's contiguous data byte span ``(start, end)`` over ALL
    its (selected) chunks.  Rides the same :func:`validate_chunk_meta` walk
    as every read path, so a lying footer is rejected with the same typed
    errors a reader would raise."""
    start = end = None
    for _path, _leaf, _chunk, md, offset in row_group_chunks(rg, leaves):
        lo = int(offset)
        hi = lo + int(md.total_compressed_size or 0)
        start = lo if start is None else min(start, lo)
        end = hi if end is None else max(end, hi)
    if start is None:
        raise ParquetError("row group has no selected column chunks")
    return start, end


# ---------------------------------------------------------------------------
# IR nodes
# ---------------------------------------------------------------------------

@dataclass
class ChunkPlan:
    """One column chunk's slice of the footer: where its bytes live and what
    a cost model needs to know without reading them."""

    column: str          # dotted path
    offset: int          # first byte (dictionary page included)
    size: int            # total_compressed_size
    usize: int           # total_uncompressed_size (0 when absent)
    codec: int
    num_values: int

    def as_dict(self) -> dict:
        return {"column": self.column, "offset": self.offset,
                "size": self.size, "usize": self.usize,
                "codec": self.codec, "num_values": self.num_values}


@dataclass
class RowGroupPlan:
    ordinal: int
    num_rows: int
    chunks: list = field(default_factory=list)  # [ChunkPlan], file order

    def as_dict(self) -> dict:
        return {"ordinal": self.ordinal, "num_rows": self.num_rows,
                "chunks": [c.as_dict() for c in self.chunks]}


class ScanPlan:
    """The plan IR: footer slice + pruning verdicts + route memo.

    Thread-safe: the route/pruning memos are written by reader consumer
    threads and read by prefetch-pool workers.
    """

    __slots__ = ("version", "file_key", "columns", "filter_fp", "rg_keep",
                 "row_groups", "_routes", "_pruning", "_lock", "_nbytes")

    def __init__(self, file_key=None, columns=None, filter_fp=None,
                 rg_keep=None, row_groups=None):
        self.version = SCANPLAN_VERSION
        self.file_key = tuple(file_key) if file_key is not None else None
        self.columns = tuple(columns) if columns is not None else None
        self.filter_fp = filter_fp
        self.rg_keep = list(rg_keep) if rg_keep is not None else None
        self.row_groups: list[RowGroupPlan] = list(row_groups or [])
        self._routes: dict = {}   # (rg, column) -> (route, family|None)
        self._pruning: dict = {}  # rg -> (skip {path_tuple: set} | None, rows_dropped)
        self._lock = threading.Lock()
        self._nbytes: Optional[int] = None

    # -- identity ------------------------------------------------------------

    def cache_key(self) -> tuple:
        """What makes two plans interchangeable: the file generation, the
        projection, and the filter.  The route/pruning memos are NOT part of
        the key — they are replayable accelerations of the same plan."""
        return (self.file_key, self.columns, self.filter_fp)

    def nbytes(self) -> int:
        """Approximate in-memory footprint (the serialized size)."""
        if self._nbytes is None:
            self._nbytes = len(self.serialize())
        return self._nbytes

    # -- admission cost -------------------------------------------------------

    def estimated_bytes(self) -> int:
        """Worst-case bytes a scan of this plan holds in flight: compressed
        + decompressed per selected chunk of every surviving row group."""
        total = 0
        for rgp in self.row_groups:
            if self.rg_keep is not None and not (
                    0 <= rgp.ordinal < len(self.rg_keep)
                    and self.rg_keep[rgp.ordinal]):
                continue
            for c in rgp.chunks:
                total += c.size + max(c.usize, c.size)
        return total

    def selected_ordinals(self) -> list:
        """Row-group ordinals the group-pruning verdict keeps."""
        return [rgp.ordinal for rgp in self.row_groups
                if self.rg_keep is None
                or (0 <= rgp.ordinal < len(self.rg_keep)
                    and self.rg_keep[rgp.ordinal])]

    # -- route memo (the ship planner's replayable decisions) -----------------

    def note_route(self, rg: int, column: str, route: str,
                   family: "str | None" = None) -> None:
        if route not in ROUTES:
            return
        with self._lock:
            self._routes[(int(rg), column)] = (route, family)
            self._nbytes = None

    def route_hint(self, rg: int, column: str) -> "str | None":
        with self._lock:
            rec = self._routes.get((int(rg), column))
        return rec[0] if rec is not None else None

    def routes_table(self) -> dict:
        """``{(rg, column): (route, family)}`` snapshot (stats surface)."""
        with self._lock:
            return dict(self._routes)

    # -- page-pruning memo ----------------------------------------------------

    def note_pruning(self, rg: int, skip, rows_dropped: int) -> None:
        """Record a page-pruning outcome: ``skip`` is the reader-shaped
        ``{path_tuple: set(ordinals)}`` (or None — planned, nothing to
        prune / ineligible)."""
        with self._lock:
            self._pruning[int(rg)] = (
                None if skip is None
                else {tuple(p): set(s) for p, s in skip.items()},
                int(rows_dropped))
            self._nbytes = None

    def pruning_hint(self, rg: int):
        """``(skip, rows_dropped)`` when this row group's pruning was
        already planned under this plan's filter; None = never planned."""
        with self._lock:
            rec = self._pruning.get(int(rg))
            if rec is None:
                return None
            skip, dropped = rec
            return (None if skip is None
                    else {p: set(s) for p, s in skip.items()}), dropped

    # -- serialization --------------------------------------------------------

    def serialize(self) -> bytes:
        with self._lock:
            routes = {f"{rg}\x00{col}": [route, family]
                      for (rg, col), (route, family)
                      in sorted(self._routes.items())}
            pruning = {str(rg): [
                (None if skip is None
                 else {".".join(p): sorted(int(x) for x in s)
                       for p, s in sorted(skip.items())}),
                dropped,
            ] for rg, (skip, dropped) in sorted(self._pruning.items())}
        doc = {
            "file_key": list(self.file_key) if self.file_key else None,
            "columns": list(self.columns) if self.columns is not None else None,
            "filter_fp": self.filter_fp,
            "rg_keep": ([bool(x) for x in self.rg_keep]
                        if self.rg_keep is not None else None),
            "row_groups": [rgp.as_dict() for rgp in self.row_groups],
            "routes": routes,
            "pruning": pruning,
        }
        body = json.dumps(doc, separators=(",", ":"), sort_keys=True)
        return _MAGIC + bytes([SCANPLAN_VERSION]) + body.encode()

    @classmethod
    def deserialize(cls, data: bytes) -> "ScanPlan":
        """Strictly-validated inverse of :meth:`serialize`: any structural
        lie (bad magic/version, wrong types, negative byte ranges, unknown
        routes) raises :class:`ParquetError` — a stored or shipped plan
        must never be adopted on faith."""
        if not isinstance(data, (bytes, bytearray, memoryview)):
            raise ParquetError("scan plan: not bytes")
        data = bytes(data)
        if len(data) < len(_MAGIC) + 1 or data[:len(_MAGIC)] != _MAGIC:
            raise ParquetError("scan plan: bad magic")
        if data[len(_MAGIC)] != SCANPLAN_VERSION:
            raise ParquetError(
                f"scan plan: unknown version {data[len(_MAGIC)]}")
        try:
            doc = json.loads(data[len(_MAGIC) + 1:].decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise ParquetError(f"scan plan: corrupt body: {e}") from e
        if not isinstance(doc, dict):
            raise ParquetError("scan plan: body is not an object")

        def _nn_int(v, what):
            if not isinstance(v, int) or isinstance(v, bool) or v < 0:
                raise ParquetError(f"scan plan: invalid {what}: {v!r}")
            return v

        fk = doc.get("file_key")
        if fk is not None:
            if not isinstance(fk, list) or not all(
                    isinstance(x, (str, int, float)) or x is None
                    for x in fk):
                raise ParquetError("scan plan: invalid file_key")
            fk = tuple(fk)
        cols = doc.get("columns")
        if cols is not None and (not isinstance(cols, list) or not all(
                isinstance(c, str) for c in cols)):
            raise ParquetError("scan plan: invalid columns")
        fp = doc.get("filter_fp")
        if fp is not None and not isinstance(fp, str):
            raise ParquetError("scan plan: invalid filter_fp")
        keep = doc.get("rg_keep")
        if keep is not None and (not isinstance(keep, list) or not all(
                isinstance(x, bool) for x in keep)):
            raise ParquetError("scan plan: invalid rg_keep")
        rgs_doc = doc.get("row_groups")
        if not isinstance(rgs_doc, list):
            raise ParquetError("scan plan: invalid row_groups")
        row_groups = []
        seen_ord = set()
        for rd in rgs_doc:
            if not isinstance(rd, dict):
                raise ParquetError("scan plan: row group is not an object")
            o = _nn_int(rd.get("ordinal"), "row group ordinal")
            if o in seen_ord:
                raise ParquetError(f"scan plan: duplicate row group {o}")
            seen_ord.add(o)
            nr = _nn_int(rd.get("num_rows"), "num_rows")
            chunks_doc = rd.get("chunks")
            if not isinstance(chunks_doc, list):
                raise ParquetError("scan plan: invalid chunks")
            chunks = []
            for cd in chunks_doc:
                if not isinstance(cd, dict) or not isinstance(
                        cd.get("column"), str):
                    raise ParquetError("scan plan: invalid chunk entry")
                chunks.append(ChunkPlan(
                    column=cd["column"],
                    offset=_nn_int(cd.get("offset"), "chunk offset"),
                    size=_nn_int(cd.get("size"), "chunk size"),
                    usize=_nn_int(cd.get("usize"), "chunk usize"),
                    codec=_nn_int(cd.get("codec"), "chunk codec"),
                    num_values=_nn_int(cd.get("num_values"), "num_values"),
                ))
            row_groups.append(RowGroupPlan(ordinal=o, num_rows=nr,
                                           chunks=chunks))
        plan = cls(file_key=fk, columns=cols, filter_fp=fp, rg_keep=keep,
                   row_groups=row_groups)
        routes = doc.get("routes") or {}
        if not isinstance(routes, dict):
            raise ParquetError("scan plan: invalid routes")
        for key, rec in routes.items():
            if (not isinstance(key, str) or "\x00" not in key
                    or not isinstance(rec, list) or len(rec) != 2):
                raise ParquetError("scan plan: invalid route entry")
            rg_s, col = key.split("\x00", 1)
            try:
                rg = int(rg_s)
            except ValueError:
                raise ParquetError(
                    f"scan plan: invalid route row group {rg_s!r}") from None
            route, family = rec
            if rg < 0 or not isinstance(route, str) or route not in ROUTES:
                raise ParquetError(f"scan plan: unknown route {route!r}")
            if family is not None and (not isinstance(family, str)
                                       or family not in _FAMILIES):
                raise ParquetError(
                    f"scan plan: unknown kernel family {family!r}")
            plan._routes[(rg, col)] = (route, family)
        pruning = doc.get("pruning") or {}
        if not isinstance(pruning, dict):
            raise ParquetError("scan plan: invalid pruning")
        for rg_s, rec in pruning.items():
            try:
                rg = int(rg_s)
            except ValueError:
                raise ParquetError(
                    f"scan plan: invalid pruning row group {rg_s!r}") from None
            if rg < 0 or not isinstance(rec, list) or len(rec) != 2:
                raise ParquetError("scan plan: invalid pruning entry")
            skip_doc, dropped = rec
            dropped = _nn_int(dropped, "rows_dropped")
            if skip_doc is None:
                plan._pruning[rg] = (None, dropped)
                continue
            if not isinstance(skip_doc, dict):
                raise ParquetError("scan plan: invalid pruning skip set")
            skip = {}
            for col, ordinals in skip_doc.items():
                if (not isinstance(col, str) or not isinstance(ordinals, list)
                        or not all(isinstance(x, int)
                                   and not isinstance(x, bool) and x >= 0
                                   for x in ordinals)):
                    raise ParquetError("scan plan: invalid pruning ordinals")
                skip[tuple(col.split("."))] = set(ordinals)
            plan._pruning[rg] = (skip, dropped)
        return plan


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def predicate_fingerprint(pred) -> "str | None":
    """A stable content fingerprint for a row filter, or None when the
    predicate cannot be fingerprinted (an exotic subclass whose repr leaks
    object identity) — an un-fingerprintable filter simply never matches a
    cached plan, it is never wrongly matched."""
    if pred is None:
        return None
    r = repr(pred)
    if " object at 0x" in r:
        return None
    return r


def build_scan_plan(metadata, schema, *, file_key=None, row_filter=None,
                    filter_fp=None, rg_keep=None) -> ScanPlan:
    """Build the ScanPlan for ``metadata`` under ``schema``'s CURRENT column
    selection: chunk byte ranges via the shared footer walk, group-pruning
    verdicts from ``row_filter`` (or adopt a precomputed ``rg_keep`` so a
    reader that already pruned never pays twice)."""
    leaves = {l.path: l for l in schema.selected_leaves()}
    columns = tuple(sorted(".".join(p) for p in leaves))
    if row_filter is not None:
        if rg_keep is None:
            from .predicate import prune_row_groups

            rg_keep = prune_row_groups(metadata, schema, row_filter)
        if filter_fp is None:
            filter_fp = predicate_fingerprint(row_filter)
    row_groups = []
    for i, rg in enumerate(metadata.row_groups):
        chunks = [
            ChunkPlan(
                column=".".join(path), offset=int(offset),
                size=int(md.total_compressed_size or 0),
                usize=int(md.total_uncompressed_size or 0),
                codec=int(md.codec or 0),
                num_values=int(md.num_values or 0),
            )
            for path, _leaf, _chunk, md, offset in row_group_chunks(rg, leaves)
        ]
        row_groups.append(RowGroupPlan(ordinal=i,
                                       num_rows=int(rg.num_rows or 0),
                                       chunks=chunks))
    return ScanPlan(file_key=file_key, columns=columns, filter_fp=filter_fp,
                    rg_keep=rg_keep, row_groups=row_groups)


def apply_selection(schema, columns) -> None:
    """Validate-then-apply a column projection on a Schema (the readers'
    ``set_selected_columns``).  Validates BEFORE applying — a failed call leaves the selection as it
    was — and raises the one canonical no-such-columns ParquetError."""
    if columns is None:
        schema.set_selected(None)
        return
    paths = [tuple(c.split(".")) if isinstance(c, str) else tuple(c)
             for c in columns]
    if not schema.selection_matches(paths):
        known = [".".join(l.path) for l in schema.leaves]
        raise ParquetError(
            f"selected columns {['.'.join(p) for p in paths]} "
            f"match no schema columns; available: {known}"
        )
    schema.set_selected(paths)


def int_stats_span(statistics, leaf) -> "tuple[int, int] | None":
    """Decode chunk Statistics min/max into an int span hint, if plausible.

    Returns (min, max) for INT32/INT64 leaves whose stats carry well-formed
    PLAIN-encoded bounds, else None.  A planning INPUT (it routes the
    narrow-transcode vs device-snappy choice), never trusted for
    correctness — malformed or lying stats are simply ignored.
    """
    import numpy as np

    from .format import Type

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


# ---------------------------------------------------------------------------
# page-level predicate pushdown planning
# ---------------------------------------------------------------------------

@host_part(PART_PAGE_PARSE)
def walk_header_pages(f, offset: int, size: int, num_values: int):
    """Page headers of a chunk read via seeks — header bytes only, never
    the payloads (the pruning planner needs page BOUNDARIES of every
    selected column; loading whole chunks for that doubled peak host
    memory under row_filter).  Returns the data-page headers in order."""
    from .chunk_decode import _read_page_header
    from .thrift import ThriftError

    headers = []
    pos = 0
    seen = 0
    seen_dict = False
    while seen < num_values:
        if pos >= size:
            raise ParquetError(
                f"chunk exhausted at {seen}/{num_values} values")
        win = 1024
        while True:
            f.seek(offset + pos)
            head = timed_part(PART_READ, f.read, min(win, size - pos))
            try:
                header, hlen = _read_page_header(head, 0)
                break
            except ThriftError as e:
                # could be a truncated window, not corruption: widen
                # until the whole remaining chunk has been tried
                if win >= size - pos:
                    raise ParquetError(
                        f"corrupt page header: {e}") from e
                win *= 8
        csize = header.compressed_page_size
        if csize is None or csize < 0:
            raise ParquetError(f"invalid compressed page size {csize}")
        usize = header.uncompressed_page_size
        if usize is None or usize < 0:
            raise ParquetError(f"invalid uncompressed page size {usize}")
        if hlen + csize > size - pos:
            raise ParquetError("page payload extends past chunk end")
        # CONTRACT: the data-page ordinals this walk yields must match
        # walk_pages' exactly — skip_pages indices computed here are
        # applied against walk_pages' sequence in _collect_chunk, so
        # the reject set below mirrors walk_pages (missing per-type
        # headers raise; anything else would silently shift ordinals
        # and prune the wrong pages)
        if header.type == PageType.DATA_PAGE:
            if header.data_page_header is None:
                raise ParquetError("data page v1 missing its header")
            seen += header.data_page_header.num_values or 0
            headers.append(header)
        elif header.type == PageType.DATA_PAGE_V2:
            if header.data_page_header_v2 is None:
                raise ParquetError("data page v2 missing its header")
            seen += header.data_page_header_v2.num_values or 0
            headers.append(header)
        elif header.type == PageType.DICTIONARY_PAGE:
            if seen_dict or headers:
                raise ParquetError("unexpected extra dictionary page")
            if header.dictionary_page_header is None:
                raise ParquetError("dictionary page missing its header")
            seen_dict = True
        pos += hlen + csize
    return headers


def plan_page_pruning(rg, leaves, schema, pred, f):
    """Page-level predicate pushdown planning (the Go reference writes page
    Statistics but never reads them): within a surviving row
    group, maximal row runs the predicate provably cannot match — aligned
    to whole-page boundaries of EVERY selected column — are dropped by
    skipping those pages outright (no decompression, no staging, no
    decode).  Returns ``({column_path: set(data-page ordinals to skip)},
    rows_dropped, filter_chunk_bufs)``, or ``(None, 0, bufs)`` when
    ineligible (no filter, repeated columns, a filter column
    absent/repeated).

    Output contract (same lattice as group pruning): yielded rows are a
    SUPERSET of matching rows — callers re-filter exactly; whole-page
    alignment keeps every column's yielded rows identical.
    """
    if pred is None:
        return None, 0, {}
    from .predicate import prune_pages

    all_leaves = {".".join(l.path): l for l in schema.leaves}
    if any(l.max_rep > 0 for l in leaves.values()):
        return None, 0, {}
    fcols = set(pred.columns())
    for name in fcols:
        leaf = all_leaves.get(name)
        if leaf is None or leaf.max_rep > 0:
            return None, 0, {}
    by_path = {}
    for chunk in rg.columns or []:
        md = chunk.meta_data
        if md is not None and md.path_in_schema:
            by_path[".".join(md.path_in_schema)] = chunk
    if not fcols <= set(by_path):
        return None, 0, {}
    filter_pages = {}
    boundaries = {}
    # FILTER chunks' bytes, handed to the decode loop when also selected
    # — the planner already paid their IO.  Non-filter selected columns
    # are walked header-only via seeks (loading their whole chunks here
    # roughly doubled peak host memory under row_filter); the decode
    # loop reads them exactly once, as without a filter.
    bufs: dict = {}
    walk = set(fcols) | {".".join(p) for p in leaves}
    for name in walk:
        chunk = by_path.get(name)
        if chunk is None:
            return None, 0, bufs  # selected column missing: decode raises
        leaf = all_leaves[name]
        md, offset = validate_chunk_meta(chunk, leaf)
        if name in fcols:
            f.seek(offset)
            buf = timed_part(PART_READ, f.read, md.total_compressed_size)
            if tuple(name.split(".")) in leaves:
                bufs[tuple(name.split("."))] = buf
            hdrs = [ps.header for ps in walk_pages(buf, md.num_values)]
        else:
            hdrs = walk_header_pages(
                f, offset, md.total_compressed_size, md.num_values)
        ends, stats = [], []
        total = 0
        for h in hdrs:
            if h.type == PageType.DATA_PAGE and h.data_page_header:
                total += h.data_page_header.num_values or 0
                st = h.data_page_header.statistics
            elif (h.type == PageType.DATA_PAGE_V2
                  and h.data_page_header_v2):
                total += h.data_page_header_v2.num_values or 0
                st = h.data_page_header_v2.statistics
            else:
                continue
            ends.append(total)
            stats.append(st)
        boundaries[name] = ends
        if name in fcols:
            filter_pages[name] = (ends, stats, md.type)
    num_rows = rg.num_rows or 0
    sel_bounds = {n: boundaries[n]
                  for n in {".".join(p) for p in leaves}}
    runs = prune_pages(filter_pages, sel_bounds, num_rows, pred,
                       all_leaves)
    if not runs:
        return None, 0, bufs
    skip = {}
    for path in leaves:
        name = ".".join(path)
        ends = boundaries[name]
        drop = set()
        start = 0
        for i, e in enumerate(ends):
            if any(a <= start and e <= b for a, b in runs):
                drop.add(i)
            start = e
        if drop:
            skip[path] = drop
    rows_dropped = sum(b - a for a, b in runs)
    return skip, rows_dropped, bufs
