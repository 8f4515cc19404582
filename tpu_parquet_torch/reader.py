"""FileReader: the host-side reader, with row iteration.

The counterpart of ``tpu_parquet.reader.FileReader`` on its sequential path,
and the port's second entry point beside the device reader.  It decodes on
the host into numpy (``ColumnData``), with no device.  Options mirror the Go
reference's FileReader (file_reader.go:65-149): ``columns`` (projection),
``validate_crc``, ``max_memory`` (WithMaximumMemorySize) and ``metadata``
(WithFileMetaData); a row-group cursor (seek, skip, preload) and the footer
accessors.  Columnar first: ``read_row_group`` / ``read_all`` return decoded
columns per row group, and rows (``iter_rows``, NextRow parity) are
assembled on top of them by ``assembly``.

``prefetch=K`` runs the chunk reads and decodes K-deep on a thread pool
(``pipeline.prefetch_map``), flattened across row groups, as the
reference's ``_decode_row_groups``; without the reference's quarantine,
result cache, range coalescing and fetch engine.
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Iterable, Optional, Sequence, Union

import numpy as np

from .alloc import AllocTracker, InFlightBudget
from .chunk_decode import (ChunkDecoder, read_chunk, require_full,
                           row_group_chunks, validate_chunk_meta)
from .column import ByteArrayData, ColumnData
from .footer import ParquetError, read_file_metadata
from .format import FileMetaData
from .pipeline import PipelineStats, SharedReader, prefetch_map
from .schema.core import Schema, SchemaNode

_VALIDATE_ON = ("1", "on", "true", "crc", "yes")
_VALIDATE_OFF = ("0", "off", "false", "no")


def resolve_validate(validate_crc=None) -> bool:
    """A reader's ``validate_crc`` as a bool: ``None`` reads
    ``TPQ_VALIDATE`` (default ``crc``: page CRCs are verified when present;
    an unknown value keeps the default), a bool is itself, and the strings
    ``crc``/``on``/``off``/... are strict."""
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


def apply_selection(schema: Schema, columns) -> None:
    """Validate, then apply, a column projection (dotted names or paths;
    ``None`` = all): a failed call leaves the selection as it was."""
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


class FileReader:
    """Host parquet reader over a seekable byte source (a path, a binary
    file object or bytes).

    ``max_memory`` caps the bytes one row group's decode may register (chunk
    bytes and decompressed pages; 0 = no cap): passing it raises
    ``alloc.MemoryBudgetExceeded`` instead of running out of memory on a
    decompression bomb.  With ``prefetch`` > 0 it also bounds the bytes in
    flight on the prefetch pool (backpressure, not an error).

    ``prefetch`` is the depth of the chunk pipeline (0 = sequential); the
    read calls take it per call too."""

    def __init__(
        self,
        source: Union[str, os.PathLike, BinaryIO, bytes],
        columns: Optional[Iterable[Union[str, Sequence[str]]]] = None,
        validate_crc=None,
        max_memory: int = 0,
        metadata: Optional[FileMetaData] = None,
        prefetch: int = 0,
    ):
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
        try:
            self.validate_crc = resolve_validate(validate_crc)
            self.metadata = (metadata if metadata is not None
                             else read_file_metadata(self._f))
            self.schema = Schema.from_file_metadata(self.metadata)
            self._preloaded: Optional[dict[str, ColumnData]] = None
            if columns is not None:
                self.set_selected_columns(columns)
            self.alloc = AllocTracker(max_memory)
            self._current_row_group = 0
            # positioned reads: the prefetch pool's workers and the
            # sequential path share the source without sharing a position
            self._sr = SharedReader(self._f)
            self.prefetch = int(prefetch)
            self._pipe_stats = PipelineStats(prefetch=self.prefetch,
                                             budget_bytes=int(max_memory))
        except BaseException:
            # a constructor failure (bad footer, bad projection) must not
            # leak the file this reader opened
            if self._owns_file:
                self._f.close()
            raise

    def set_selected_columns(self, columns) -> None:
        """Re-project mid-read (SetSelectedColumns parity): later row-group
        reads decode only these columns.  ``None`` restores all columns.
        Clears any preloaded group."""
        apply_selection(self.schema, columns)
        self._preloaded = None

    # -- context management ---------------------------------------------------

    def close(self):
        if self._owns_file:
            self._f.close()
            self._owns_file = False

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

    def _decode_row_groups(self, indices, k: int):
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
        protocol with other payloads."""
        stats = PipelineStats(prefetch=k, budget_bytes=self.alloc.max_size)
        self._pipe_stats = stats
        budget = InFlightBudget(self.alloc.max_size)
        sr = self._sr
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
                    items.append((i, path, chunk, leaf))
                pending[i] = {"expect": {".".join(p) for p in by_path},
                              "todo": max(len(items), 1), "out": {}}
                if not items:
                    # sentinel so an empty group still comes out in order
                    items.append((i, None, None, None))
                yield from items

        def chunk_cost(item):
            chunk = item[2]
            if chunk is None:
                return 0
            md = chunk.meta_data
            comp = max(md.total_compressed_size or 0, 0)
            return comp + max(md.total_uncompressed_size or 0, comp)

        def decode_item(item):
            i, path, chunk, leaf = item
            if chunk is None:
                return i, None, None
            name = ".".join(path)
            md, offset = validate_chunk_meta(chunk, leaf)
            alloc = AllocTracker(self.alloc.max_size)
            alloc.register(md.total_compressed_size)
            with stats.timed("io"):
                buf = sr.pread(offset, md.total_compressed_size)
            require_full(buf, offset, md.total_compressed_size,
                         context=f"column {name}")
            with stats.timed("decompress"):
                dec = ChunkDecoder(
                    leaf, validate_crc=self.validate_crc, alloc=alloc,
                    context={"file": self._source_name, "row_group": i,
                             "column": name, "chunk_offset": offset})
                cd = dec.decode(buf, md.codec, md.num_values)
            stats.count_chunk()
            return i, name, cd

        stats.touch_wall()
        for i, name, cd in prefetch_map(gen_items(), decode_item, k,
                                        budget=budget, cost=chunk_cost,
                                        stats=stats):
            slot = pending[i]
            if name is not None:
                slot["out"][name] = cd
            slot["todo"] -= 1
            if slot["todo"] == 0:
                del pending[i]
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
        the reader's setting) the group's chunks decode on the pool."""
        if not 0 <= index < self.num_row_groups:
            raise IndexError(f"row group {index} of {self.num_row_groups}")
        k = self.prefetch if prefetch is None else int(prefetch)
        if k > 0:
            feed = self._decode_row_groups([index], k)
            try:
                return next(feed)[1]
            finally:
                feed.close()  # joins the pool now, not when collected
        rg = self.metadata.row_groups[index]
        self.alloc.reset()
        by_path = {l.path: l for l in self.schema.selected_leaves()}
        f = self._sr.as_file()
        out: dict[str, ColumnData] = {}
        for path, leaf, chunk, md, offset in row_group_chunks(rg, by_path):
            out[".".join(path)] = read_chunk(
                f, chunk, leaf, validate_crc=self.validate_crc,
                alloc=self.alloc,
                context={"file": self._source_name, "row_group": index},
                meta=(md, offset))
        missing = set(".".join(p) for p in by_path) - set(out)
        if missing:
            raise ParquetError(
                f"row group {index} missing columns {sorted(missing)}")
        return out

    def iter_row_groups(self, prefetch: Optional[int] = None):
        k = self.prefetch if prefetch is None else int(prefetch)
        if k > 0:
            for _i, out in self._decode_row_groups(
                    range(self.num_row_groups), k):
                yield out
            return
        for i in range(self.num_row_groups):
            yield self.read_row_group(i, prefetch=0)

    def read_all(self, prefetch: Optional[int] = None
                 ) -> dict[str, ColumnData]:
        """Concatenate all row groups' columns (convenience for small
        files).  ``prefetch`` overrides the reader's depth for this call."""
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
