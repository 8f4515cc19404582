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
"""

from __future__ import annotations

import io
import os
from typing import BinaryIO, Iterable, Optional, Sequence, Union

import numpy as np

from .alloc import AllocTracker
from .chunk_decode import read_chunk, row_group_chunks
from .column import ByteArrayData, ColumnData
from .footer import ParquetError, read_file_metadata
from .format import FileMetaData
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
    decompression bomb."""

    def __init__(
        self,
        source: Union[str, os.PathLike, BinaryIO, bytes],
        columns: Optional[Iterable[Union[str, Sequence[str]]]] = None,
        validate_crc=None,
        max_memory: int = 0,
        metadata: Optional[FileMetaData] = None,
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

    def read_row_group(self, index: int) -> dict[str, ColumnData]:
        """Decode all selected column chunks of one row group:
        ``{dotted column path: ColumnData}``, one contiguous read and one
        batch decode per chunk."""
        if not 0 <= index < self.num_row_groups:
            raise IndexError(f"row group {index} of {self.num_row_groups}")
        rg = self.metadata.row_groups[index]
        self.alloc.reset()
        by_path = {l.path: l for l in self.schema.selected_leaves()}
        out: dict[str, ColumnData] = {}
        for path, leaf, chunk, md, offset in row_group_chunks(rg, by_path):
            out[".".join(path)] = read_chunk(
                self._f, chunk, leaf, validate_crc=self.validate_crc,
                alloc=self.alloc,
                context={"file": self._source_name, "row_group": index},
                meta=(md, offset))
        missing = set(".".join(p) for p in by_path) - set(out)
        if missing:
            raise ParquetError(
                f"row group {index} missing columns {sorted(missing)}")
        return out

    def iter_row_groups(self):
        for i in range(self.num_row_groups):
            yield self.read_row_group(i)

    def read_all(self) -> dict[str, ColumnData]:
        """Concatenate all row groups' columns (convenience for small
        files)."""
        groups = list(self.iter_row_groups())
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
