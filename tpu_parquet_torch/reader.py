"""FileReader: the host-side reader, with row iteration.

The counterpart of ``tpu_parquet.reader.FileReader``, and the port's second
entry point beside the device reader.  It decodes on the host into numpy
(``ColumnData``), with no device.  Options mirror the Go reference's
FileReader (file_reader.go:65-149): ``columns`` (projection),
``validate_crc``, ``max_memory`` (WithMaximumMemorySize) and ``metadata``
(WithFileMetaData); a row-group cursor (seek, skip, preload) and the footer
accessors.  Columnar first: ``read_row_group`` / ``read_all`` return decoded
columns per row group, and rows (``iter_rows``, NextRow parity) are
assembled on top of them by ``assembly``.

``row_filter`` (a ``predicate`` expression) prunes whole row groups from
the footer's statistics: the iteration APIs skip them and never read their
bytes.  ``plan`` replays a ``scanplan.ScanPlan`` (its group-pruning verdict
is adopted when its projection and filter match).  ``on_data_error`` /
``quarantine`` contain data errors to their row group
(``quarantine.Quarantine``).

``prefetch=K`` runs the chunk reads and decodes K-deep on a thread pool
(``pipeline.prefetch_map``), flattened across row groups, as the
reference's ``_decode_row_groups``.

``store`` picks the byte store every chunk byte enters through
(``iostore.resolve_store``: None for ``LocalStore``, a ``ByteStore``, or a
factory called with the open file); a ``GenericRangeStore`` retries,
re-reads torn ranges, coalesces a row group's adjacent chunks
(``CoalescedFetcher``) and, at ``prefetch`` > 0, routes through the async
fetch engine (``iostore_async``).  ``cancel`` (a
``resilience.CancelToken``) rides every store read and is checked at each
unit boundary; its ``CancelledError`` / ``DeadlineExceededError`` ends the
scan and is never contained.

``dict_cache`` (a ``serve.BoundDictCache``) serves decoded dictionary pages
across readers; ``result_cache`` (a ``serve.BoundResultCache`` bound to the
host decode signature) serves whole decoded chunks: a warm chunk reads no
byte, a cold one decodes once under single-flight and is published.  Both
are shared read-only; ``serve.PlanCache.reader_kwargs`` builds them.  An
adapter signed for another decode shape or CRC tier is dropped, never
adopted.

``trace`` picks the span tracer (``obs.resolve_tracer``: None is the
``TPQ_TRACE`` process tracer, a path a tracer of this reader whose trace
file, with the registry tree embedded, is written at ``close()``);
``obs_registry()`` is the reader's metrics tree.
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Iterable, Optional, Sequence, Union

import numpy as np

from .alloc import AllocTracker, InFlightBudget
from .chunk_decode import ChunkDecoder, read_chunk, validate_chunk_meta
from .column import ByteArrayData, ColumnData
from .errors import DataIntegrityError
from .footer import ParquetError, read_file_metadata
from .format import FileMetaData
from .iostore import CoalescedFetcher, require_full, resolve_store
from .iostore_async import engine_for_store, fold_engine_stats
from .obs import StatsRegistry, resolve_tracer
from .pipeline import PipelineStats, SharedReader, prefetch_map
from .quarantine import Quarantine, resolve_validate
from .scanplan import (apply_selection, build_scan_plan,
                       predicate_fingerprint, row_group_chunks)
from .schema.core import Schema, SchemaNode


class _ChunkFailed:
    """In-band marker for a quarantined chunk riding the ordered prefetch
    stream (a raise would end the pool).  Carries the annotated exception;
    the consumer notes exactly one quarantine record per failed unit (its
    first failing chunk in column order), so the ledger is the same at
    every prefetch depth.  The device reader's chunk feed carries it too
    (``device_reader._FailedChunk``)."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class FileReader:
    """Host parquet reader over a seekable byte source (a path, a binary
    file object or bytes).

    ``max_memory`` caps the bytes one row group's decode may register (chunk
    bytes and decompressed pages; 0 = no cap): passing it raises
    ``alloc.MemoryBudgetExceeded`` instead of running out of memory on a
    decompression bomb.  With ``prefetch`` > 0 it also bounds the bytes in
    flight on the prefetch pool (backpressure, not an error).

    ``prefetch`` is the depth of the chunk pipeline (0 = sequential); the
    read calls take it per call too.  ``row_filter``, ``plan``,
    ``on_data_error``, ``quarantine``, ``store``, ``cancel``, ``dict_cache``
    and ``result_cache``: see the module docstring.  A store this reader resolved (None or a factory) is
    closed with it; a ``ByteStore`` instance stays the caller's."""

    def __init__(
        self,
        source: Union[str, os.PathLike, BinaryIO, bytes],
        columns: Optional[Iterable[Union[str, Sequence[str]]]] = None,
        validate_crc=None,
        max_memory: int = 0,
        metadata: Optional[FileMetaData] = None,
        row_filter=None,
        prefetch: int = 0,
        on_data_error=None,
        quarantine=None,
        plan=None,
        store=None,
        cancel=None,
        dict_cache=None,
        result_cache=None,
        trace=None,
    ):
        # None: the TPQ_TRACE process tracer (a disabled no-op without the
        # env); a path: this reader's tracer, written at close()
        self._tracer, self._owns_tracer = resolve_tracer(trace)
        if isinstance(source, (str, os.PathLike)):
            self._f: BinaryIO = open(source, "rb")
            self._owns_file = True
            self._source_name = os.fspath(source)
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._f = io.BytesIO(bytes(source))
            self._owns_file = False
            self._source_name = "<memory>"
        else:
            self._f = source
            self._owns_file = False
            self._source_name = getattr(source, "name", None) or "<stream>"
        # the request's cancel token: checked at every unit boundary and
        # carried by the scan token into every store read
        self._cancel = cancel
        try:
            # one containment engine: ``quarantine=`` shares one across
            # readers (scan_files, the device reader's host half), so the
            # budget and the ledger are global to the scan
            self.quarantine = (quarantine if quarantine is not None
                               else Quarantine(on_data_error))
            self.validate_crc = resolve_validate(validate_crc)
            self.metadata = (metadata if metadata is not None
                             else read_file_metadata(self._f))
            self.schema = Schema.from_file_metadata(self.metadata)
            self._preloaded: Optional[dict[str, ColumnData]] = None
            if columns is not None:
                self.set_selected_columns(columns)
            self.alloc = AllocTracker(max_memory)
            self._current_row_group = 0
            # the byte store every chunk byte enters through; positioned
            # reads, so the prefetch pool's workers and the sequential
            # path share the source without sharing a position
            self._owns_store = store is None or callable(store)
            self._store = resolve_store(self._f, store)
            self._sr = SharedReader(self._f, store=self._store)
            self.prefetch = int(prefetch)
            self._pipe_stats = PipelineStats(prefetch=self.prefetch,
                                             budget_bytes=int(max_memory),
                                             tracer=self._tracer)
            # group pruning: groups whose footer stats prove the predicate
            # can never match are skipped by the iteration APIs
            self.row_filter = row_filter
            # the read caches (serve/): decoded dictionaries threaded into
            # every ChunkDecoder; decoded chunks behind get_or_build.  A
            # result adapter signed for another decode shape (device
            # tensors) or CRC tier is dropped rather than adopted
            self._dict_cache = dict_cache
            if result_cache is not None:
                sig = getattr(result_cache, "sig", None) or ()
                want = ("host", "v1" if self.validate_crc else "v0")
                if tuple(sig[:2]) != want:
                    result_cache = None
            self._result_cache = result_cache
            fp = predicate_fingerprint(row_filter)
            cols_sig = tuple(sorted(
                ".".join(l.path) for l in self.schema.selected_leaves()))
            fp_match = ((row_filter is None and plan is not None
                         and plan.filter_fp is None)
                        or (fp is not None and plan is not None
                            and plan.filter_fp == fp))
            if plan is not None and fp_match and plan.columns == cols_sig:
                # replay: the group-pruning verdict is adopted, never
                # recomputed; a plan whose projection or filter does not
                # match falls through to a fresh build
                self._plan = plan
                self._rg_keep = (list(plan.rg_keep)
                                 if plan.rg_keep is not None else None)
            else:
                if row_filter is not None:
                    from .predicate import prune_row_groups

                    self._rg_keep = prune_row_groups(
                        self.metadata, self.schema, row_filter)
                else:
                    self._rg_keep = None
                self._plan = build_scan_plan(
                    self.metadata, self.schema, row_filter=row_filter,
                    filter_fp=fp, rg_keep=self._rg_keep)
        except BaseException:
            # a constructor failure (bad footer, bad projection, bad filter)
            # must not leak the file or the store this reader opened
            if getattr(self, "_owns_store", False):
                self._store.close()
            if self._owns_file:
                self._f.close()
            raise

    def set_selected_columns(self, columns) -> None:
        """Re-project mid-read (SetSelectedColumns parity): later row-group
        reads decode only these columns.  ``None`` restores all columns.
        Clears any preloaded group and rebuilds the scan plan (a footer
        walk) for the new projection."""
        apply_selection(self.schema, columns)
        self._preloaded = None
        # during __init__ the constructor builds the first plan right after
        if hasattr(self, "_plan"):
            self._plan = build_scan_plan(self.metadata, self.schema,
                                         row_filter=self.row_filter,
                                         rg_keep=self._rg_keep)

    def row_group_selected(self, index: int) -> bool:
        """False when ``row_filter`` proves row group ``index`` cannot match."""
        return self._rg_keep is None or self._rg_keep[index]

    @property
    def num_selected_rows(self) -> int:
        """Rows in the row groups that survive ``row_filter``: what the
        iteration APIs yield (``num_rows`` stays the footer total; surviving
        groups may still hold rows the predicate rejects)."""
        if self._rg_keep is None:
            return self.metadata.num_rows
        return sum(rg.num_rows for rg, keep in
                   zip(self.metadata.row_groups, self._rg_keep) if keep)

    # -- context management ---------------------------------------------------

    def close(self):
        if self._owns_store:
            self._store.close()
            self._owns_store = False
        if self._owns_file:
            self._f.close()
            self._owns_file = False
        if self._owns_tracer:
            self._tracer.write(registry=self.obs_registry())
            self._owns_tracer = False

    def obs_registry(self):
        """This reader's metrics tree (``obs.StatsRegistry``): the
        pipeline's stage sums and histograms, the alloc peak, the store's
        counters when it keeps any (and the fetch engine's, when one ran),
        and the data-error counters once there are any."""
        reg = StatsRegistry()
        reg.add_pipeline(self._pipe_stats)
        reg.note_alloc_peak(self.alloc)
        if self._store.stats is not None:
            reg.add_io(self._store.stats)
        if getattr(self._store, "supports_async", False):
            fold_engine_stats(reg)
        if len(self.quarantine.log) or self.quarantine.units_skipped:
            reg.add_data_errors(self.quarantine)
        return reg

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- metadata accessors (file_reader.go parity) ---------------------------

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups)

    def row_group_num_rows(self, index: int) -> int:
        return self.metadata.row_groups[index].num_rows

    @property
    def created_by(self) -> Optional[str]:
        return self.metadata.created_by

    def key_value_metadata(self) -> dict:
        return {
            kv.key: kv.value for kv in (self.metadata.key_value_metadata or [])
        }

    def columns(self) -> list[SchemaNode]:
        return self.schema.selected_leaves()

    # -- columnar reads --------------------------------------------------------

    def pipeline_stats(self) -> PipelineStats:
        """Per-stage timing of the last or current prefetch pipeline (io,
        decompress, stall, peak in flight); zeros when ``prefetch`` was
        never used."""
        return self._pipe_stats

    def _decode_row_groups(self, indices, k: int, contain: bool = True):
        """Chunk-granular overlapped decode (the prefetch pipeline).

        Work items are (row group, chunk) pairs flattened across
        ``indices``: the K-deep window spans group boundaries, so workers
        decode the next group's chunks while a finished group is assembled
        and yielded.  Yields ``(index, {dotted path: ColumnData})`` in
        ``indices`` order; the per-group missing-column check is
        ``read_row_group``'s.

        Memory: every worker chunk gets its own ``AllocTracker(max_memory)``
        (the per-chunk decompression-bomb guard), and the bytes in flight
        across chunks are bounded by an ``InFlightBudget`` over the same
        budget.  ``device_reader._chunk_feed`` mirrors this flatten/regroup
        protocol with other payloads.

        Containment (``contain`` and a skip policy): a chunk's data error
        rides the stream as a ``_ChunkFailed``; the consumer records its
        unit once and skips it (``skip_file``: and the rest of the file)."""
        stats = PipelineStats(prefetch=k, budget_bytes=self.alloc.max_size,
                              tracer=self._tracer)
        self._pipe_stats = stats
        budget = InFlightBudget(self.alloc.max_size)
        sr = self._sr
        store = self._store
        # this scan's token: its own retry budget and coalescing ladder,
        # carrying the request's deadline and cancel into every read
        scan_tok = store.begin_scan(cancel=self._cancel)
        sr.set_scan(scan_tok)
        # the async fetch engine, for stores with the async primitive:
        # a row group's ranges go in flight when it is planned
        eng = engine_for_store(store)
        q = self.quarantine
        contain = contain and q.contains
        if contain:
            q.begin_scan(len(indices) if hasattr(indices, "__len__") else None)
        pending: dict[int, dict] = {}  # row group -> regrouping slot

        def gen_items():
            # runs in the consumer thread as the window refills, so the
            # selection snapshot keeps sequential semantics
            for i in indices:
                rg = self.metadata.row_groups[i]
                by_path = {l.path: l for l in self.schema.selected_leaves()}
                items = []
                for chunk in rg.columns or []:
                    md = chunk.meta_data
                    if md is None or md.path_in_schema is None:
                        raise ParquetError(
                            "column chunk missing metadata/path")
                    path = tuple(md.path_in_schema)
                    leaf = by_path.get(path)
                    if leaf is None:
                        continue  # unselected: its bytes are never read
                    items.append([i, path, chunk, leaf, None])
                # range coalescing: the group's adjacent chunk reads merge
                # into fewer, larger, retryable fetches, for stores that
                # ask for it (the local path pays nothing)
                use_coalesce = (store.prefers_coalescing
                                and not (scan_tok.coalesce_disabled
                                         if scan_tok is not None
                                         else store.coalesce_disabled)
                                and len(items) > 1)
                fetch_items = items
                if eng is not None and rc is not None and items:
                    # engine mode fetches at plan time, so the result cache
                    # is probed here: a warm chunk's bytes are never
                    # fetched (one evicted in between reads its own range)
                    fetch_items = [
                        c for c in items
                        if not rc.has_group(c[0], [".".join(c[1])])]
                if fetch_items and (use_coalesce or eng is not None):
                    ranges = []
                    for it in fetch_items:
                        md, offset = validate_chunk_meta(it[2], it[3])
                        ranges.append((offset, md.total_compressed_size))
                    fetcher = CoalescedFetcher(store, ranges, scan=scan_tok,
                                               engine=eng,
                                               coalesce=use_coalesce)
                    for it in fetch_items:
                        it[4] = fetcher
                pending[i] = {"expect": {".".join(p) for p in by_path},
                              "todo": max(len(items), 1), "out": {}}
                if not items:
                    # sentinel so an empty group still comes out in order
                    items.append([i, None, None, None, None])
                yield from map(tuple, items)

        def chunk_cost(item):
            chunk = item[2]
            if chunk is None:
                return 0
            md = chunk.meta_data
            comp = max(md.total_compressed_size or 0, 0)
            return comp + max(md.total_uncompressed_size or 0, comp)

        rc = self._result_cache

        def decode_item(item):
            i, path, chunk, leaf, fetcher = item
            if chunk is None:
                return i, None, None
            name = ".".join(path)

            def decode_chunk():
                md, offset = validate_chunk_meta(chunk, leaf)
                alloc = AllocTracker(self.alloc.max_size)
                alloc.register(md.total_compressed_size)
                with stats.timed("io"):
                    buf = (fetcher.read(offset, md.total_compressed_size)
                           if fetcher is not None
                           else sr.pread(offset, md.total_compressed_size))
                require_full(buf, offset, md.total_compressed_size,
                             context=f"column {name}")
                with stats.timed("decompress"):
                    dec = ChunkDecoder(
                        leaf, validate_crc=self.validate_crc, alloc=alloc,
                        context={"file": self._source_name, "row_group": i,
                                 "column": name, "chunk_offset": offset},
                        dict_cache=self._dict_cache)
                    return dec.decode(buf, md.codec, md.num_values)

            try:
                # a warm chunk comes from the result cache without a store
                # read; a cold one decodes once (single-flight) and is
                # published; a failed decode is never published
                cd = (rc.get_or_build(i, name, _cache_build(decode_chunk))
                      if rc is not None else decode_chunk())
            except ParquetError as e:
                # containment seam: under a skip policy the failure rides
                # the stream as a marker; the consumer notes it in order
                if not contain or isinstance(e, DataIntegrityError):
                    raise
                return i, name, _ChunkFailed(e)
            stats.count_chunk()
            return i, name, cd

        stats.touch_wall()
        order = list(indices)
        for i, name, cd in prefetch_map(gen_items(), decode_item, k,
                                        budget=budget, cost=chunk_cost,
                                        stats=stats, cancel=self._cancel,
                                        feed=eng):
            slot = pending[i]
            if name is not None:
                if isinstance(cd, _ChunkFailed):
                    slot.setdefault("failed", cd)
                else:
                    slot["out"][name] = cd
            slot["todo"] -= 1
            if slot["todo"] == 0:
                del pending[i]
                failed = slot.get("failed")
                if failed is not None:
                    # one record (the first failing chunk), nothing
                    # yielded; note() raises DataIntegrityError when the
                    # budget runs out
                    q.note(failed.exc, file=self._source_name, row_group=i)
                    q.note_unit_skipped(
                        int(self.metadata.row_groups[i].num_rows or 0))
                    if q.policy == "skip_file":
                        # collateral: the file's later groups (results come
                        # in order, so none of them was yielded)
                        q.note_file_skipped()
                        for j in order[order.index(i) + 1:]:
                            q.note_unit_skipped(int(
                                self.metadata.row_groups[j].num_rows or 0))
                        break
                    continue
                missing = slot["expect"] - set(slot["out"])
                if missing:
                    raise ParquetError(
                        f"row group {i} missing columns {sorted(missing)}")
                stats.count_row_group()
                stats.note_peak(budget)
                stats.touch_wall()
                yield i, slot["out"]
        stats.touch_wall()

    def read_row_group(self, index: int,
                       prefetch: Optional[int] = None) -> dict[str, ColumnData]:
        """Decode all selected column chunks of one row group:
        ``{dotted column path: ColumnData}``, one contiguous read and one
        batch decode per chunk.  With ``prefetch`` > 0 (the argument, else
        the reader's setting) the group's chunks decode on the pool.  A
        requested group always raises its data error: the skip policies
        belong to the iteration APIs."""
        if not 0 <= index < self.num_row_groups:
            raise IndexError(f"row group {index} of {self.num_row_groups}")
        k = self.prefetch if prefetch is None else int(prefetch)
        if k > 0:
            feed = self._decode_row_groups([index], k, contain=False)
            try:
                return next(feed)[1]
            finally:
                feed.close()  # joins the pool now, not when collected
        rg = self.metadata.row_groups[index]
        self.alloc.reset()
        by_path = {l.path: l for l in self.schema.selected_leaves()}
        # every byte enters through the store, sequential path included;
        # the "scan" here is one row group (a fresh retry budget each)
        self._sr.set_scan(self._store.begin_scan(cancel=self._cancel))
        f = self._sr.as_file()
        out: dict[str, ColumnData] = {}
        rc = self._result_cache
        for path, leaf, chunk, md, offset in row_group_chunks(rg, by_path):
            if self._cancel is not None:
                self._cancel.check()  # unit boundary: stop issuing IO
            name = ".".join(path)

            def decode_chunk(chunk=chunk, leaf=leaf, md=md, offset=offset):
                return read_chunk(
                    f, chunk, leaf, validate_crc=self.validate_crc,
                    alloc=self.alloc,
                    context={"file": self._source_name, "row_group": index},
                    dict_cache=self._dict_cache, meta=(md, offset))

            out[name] = (rc.get_or_build(index, name,
                                         _cache_build(decode_chunk))
                         if rc is not None else decode_chunk())
        missing = set(".".join(p) for p in by_path) - set(out)
        if missing:
            raise ParquetError(
                f"row group {index} missing columns {sorted(missing)}")
        return out

    def iter_row_groups(self, prefetch: Optional[int] = None):
        """Yield each surviving row group's columns (pruned groups are
        skipped unread; a quarantined group is skipped under a skip
        policy)."""
        k = self.prefetch if prefetch is None else int(prefetch)
        selected = [i for i in range(self.num_row_groups)
                    if self.row_group_selected(i)]
        if k > 0:
            for _i, out in self._decode_row_groups(selected, k):
                yield out
            return
        q = self.quarantine
        q.begin_scan(len(selected))
        for i in selected:
            if not q.contains:
                yield self.read_row_group(i, prefetch=0)
                continue
            try:
                out = self.read_row_group(i, prefetch=0)
            except ParquetError as e:
                # the unit is recorded and skipped; a budget-exhausted
                # DataIntegrityError aborts
                if isinstance(e, DataIntegrityError):
                    raise
                q.note(e, file=self._source_name, row_group=i)
                q.note_unit_skipped(
                    int(self.metadata.row_groups[i].num_rows or 0))
                if q.policy == "skip_file":
                    q.note_file_skipped()
                    for j in selected[selected.index(i) + 1:]:
                        q.note_unit_skipped(int(
                            self.metadata.row_groups[j].num_rows or 0))
                    return
                continue
            yield out

    def read_all(self, prefetch: Optional[int] = None
                 ) -> dict[str, ColumnData]:
        """Concatenate the surviving row groups' columns (convenience for
        small files).  ``prefetch`` overrides the reader's depth for this
        call."""
        groups = list(self.iter_row_groups(prefetch=prefetch))
        if not groups:
            return {
                ".".join(l.path): ColumnData(
                    values=np.zeros(0, dtype=np.int64),
                    max_def=l.max_def, max_rep=l.max_rep,
                )
                for l in self.schema.selected_leaves()
            }
        if len(groups) == 1:
            return groups[0]
        return {key: _concat_column_data([g[key] for g in groups])
                for key in groups[0]}

    # -- row-group cursor (SeekToRowGroup/SkipRowGroup/PreLoad parity) ---------

    def seek_to_row_group(self, index: int) -> None:
        if not 0 <= index < self.num_row_groups:
            raise IndexError(f"row group {index} of {self.num_row_groups}")
        if index != self._current_row_group:
            self._preloaded = None
        self._current_row_group = index

    def skip_row_group(self) -> None:
        if self._current_row_group >= self.num_row_groups:
            raise IndexError("already past the last row group")
        self._current_row_group += 1
        self._preloaded = None

    def preload(self) -> dict[str, ColumnData]:
        """Decode the cursor's row group now and keep it (PreLoad parity,
        file_reader.go:280-288).  Row iteration consumes it."""
        if self._current_row_group >= self.num_row_groups:
            raise IndexError("no row group to preload")
        if self._preloaded is None:
            self._preloaded = self.read_row_group(self._current_row_group)
        return self._preloaded

    def current_row_group(self):
        if self._current_row_group >= self.num_row_groups:
            raise IndexError("cursor past the last row group")
        return self.metadata.row_groups[self._current_row_group]

    # -- row-oriented API (NextRow parity) -------------------------------------

    def iter_rows(self):
        """Iterate raw nested dict rows (NextRow semantics)."""
        from .assembly import RowIterator

        return RowIterator(self)

    def iter_rows_logical(self):
        """Iterate rows with LIST/MAP wrappers unwrapped to python lists and
        dicts."""
        from .logical import unwrap_row

        for row in self.iter_rows():
            yield unwrap_row(self.schema, row)

    def __iter__(self):
        return self.iter_rows()

    # -- python-value conversion ----------------------------------------------

    def read_pylist(self) -> dict[str, list]:
        """Flat columns as Python lists with None for nulls."""
        out = {}
        for name, cd in self.read_all().items():
            leaf = self.schema.leaf_by_path(tuple(name.split(".")))
            out[name] = column_to_pylist(cd, leaf)
        return out


def _cache_build(decode):
    """Adapt a no-argument chunk decode to the result cache's
    ``get_or_build`` contract (``build() -> (value, nbytes)``)."""
    def build():
        from .serve.result_cache import column_nbytes

        cd = decode()
        return cd, column_nbytes(cd)
    return build


def _concat_column_data(parts: list[ColumnData]) -> ColumnData:
    first = parts[0]

    def cat_opt(attr):
        arrs = [getattr(p, attr) for p in parts]
        if any(a is None for a in arrs):
            return None
        return np.concatenate(arrs)

    if isinstance(first.values, ByteArrayData):
        offsets = [first.values.offsets]
        heaps = [first.values.heap]
        base = int(first.values.offsets[-1])
        for p in parts[1:]:
            offsets.append(p.values.offsets[1:] + base)
            heaps.append(p.values.heap)
            base += int(p.values.offsets[-1])
        values = ByteArrayData(np.concatenate(offsets), np.concatenate(heaps))
    else:
        values = np.concatenate([p.values for p in parts])
    return ColumnData(
        values=values,
        def_levels=cat_opt("def_levels"),
        rep_levels=cat_opt("rep_levels"),
        max_def=first.max_def,
        max_rep=first.max_rep,
        num_leaf_slots=sum(p.num_leaf_slots for p in parts),
    )


def column_to_pylist(cd: ColumnData,
                     leaf: Optional[SchemaNode] = None) -> list:
    """Flat (max_rep == 0) column -> Python list with None in null slots.
    BYTE_ARRAY becomes str when the column is logically UTF8, else
    bytes."""
    if cd.max_rep > 0:
        raise ParquetError("column_to_pylist only handles flat columns")
    from .assembly import materialize_leaf_values

    vals = materialize_leaf_values(leaf, cd) if leaf is not None else (
        cd.values.to_list() if isinstance(cd.values, ByteArrayData)
        else cd.values.tolist()
    )
    if cd.def_levels is None:
        return vals
    out = [None] * cd.num_leaf_slots
    vi = 0
    mask = cd.validity()
    for i in range(cd.num_leaf_slots):
        if mask[i]:
            out[i] = vals[vi]
            vi += 1
    return out
