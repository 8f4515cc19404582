"""FileWriter: the low-level write API.

Equivalent of the reference's file_writer.go FileWriter (options :41-154, AddData
:280-295, FlushRowGroup :229-276, Close :297-350) — with a columnar batch path
(`write_columns`) as the primary TPU-native entry point and row-map writes
(`write_row`, AddData parity) layered on the shredder.

Layout discipline mirrors the reference: "PAR1" magic first, row groups flushed
incrementally (size-triggered or explicit), footer thrift + length + magic at
close.  Row-group/column key-value metadata via flush options (file_writer.go:
156-226).
"""

from __future__ import annotations

import os
from typing import BinaryIO, Optional, Sequence, Union

import numpy as np

from .chunk_encode import ChunkEncoder, DEFAULT_PAGE_SIZE
from .column import ByteArrayData, ColumnData
from .footer import MAGIC, serialize_footer
from .footer import ParquetError
from .format import (
    ColumnOrder,
    CompressionCodec,
    Encoding,
    FileMetaData,
    KeyValue,
    RowGroup,
    Type,
    TypeDefinedOrder,
)
from .reader import _concat_column_data
from .schema.core import Schema, SchemaNode
from .shred import Shredder, _coerce_values
from . import __version__

DEFAULT_ROW_GROUP_SIZE = 128 << 20  # 128 MiB, file_writer.go default
DEFAULT_CREATED_BY = f"tpu-parquet version {__version__}"

_CRC_ON = ("1", "on", "true", "crc", "yes")
_CRC_OFF = ("0", "off", "false", "no")


def resolve_write_crc(write_crc=None) -> bool:
    """Resolve a writer's ``write_crc`` option to a bool.

    ``None`` (the default) resolves through ``TPQ_WRITE_CRC``, whose
    default is ON — mirroring the reader's default-on ``TPQ_VALIDATE``
    contract: validation is default-on, so freshly written files must
    carry the CRCs the cheap integrity tier verifies, or the tier
    silently covers nothing.  Explicit ``False``/``"off"`` opts out;
    kwarg strings are strict, a malformed env degrades to the default
    with one warning (the same discipline as ``resolve_validate``).
    """
    if write_crc is None:
        from .obs import warn_env_once

        raw = os.environ.get("TPQ_WRITE_CRC", "1").strip().lower()
        if raw in _CRC_ON:
            return True
        if raw in _CRC_OFF:
            return False
        warn_env_once("TPQ_WRITE_CRC", raw, "1 (CRCs written)")
        return True
    if isinstance(write_crc, bool):
        return write_crc
    v = str(write_crc).strip().lower()
    if v in _CRC_ON:
        return True
    if v in _CRC_OFF:
        return False
    raise ValueError(
        f"write_crc must be a bool, 'on', or 'off'; got {write_crc!r}")


class FileWriter:
    """Low-level parquet writer.

    Options (file_writer.go parity): ``codec`` (WithCompressionCodec),
    ``row_group_size`` (WithMaxRowGroupSize, size-triggered auto-flush),
    ``page_size`` (WithMaxPageSize), ``data_page_version`` (WithDataPageV2),
    ``write_crc`` (WithCRC), ``created_by`` (WithCreator), ``kv_metadata``
    (WithMetaData), ``use_dictionary``, per-column ``column_encodings``.
    """

    def __init__(
        self,
        sink: Union[str, os.PathLike, BinaryIO],
        schema: Schema,
        codec: int = CompressionCodec.SNAPPY,
        row_group_size: int = DEFAULT_ROW_GROUP_SIZE,
        page_size: int = DEFAULT_PAGE_SIZE,
        data_page_version: int = 1,
        use_dictionary: bool = True,
        write_crc: "Optional[bool]" = None,
        write_statistics: bool = True,
        created_by: str = DEFAULT_CREATED_BY,
        kv_metadata: Optional[dict] = None,
        column_encodings: Optional[dict] = None,
        stats=None,
    ):
        if isinstance(sink, (str, os.PathLike)):
            self._f: BinaryIO = open(sink, "wb")
            self._owns_file = True
        else:
            self._f = sink
            self._owns_file = False
        self.schema = schema
        self.codec = int(codec)
        self.row_group_size = row_group_size
        self.page_size = page_size
        self.data_page_version = data_page_version
        self.use_dictionary = use_dictionary
        # None resolves via TPQ_WRITE_CRC (default ON): the reader's
        # integrity tier validates CRCs by default, so the writer writes
        # them by default — the two knobs mirror each other
        self.write_crc = resolve_write_crc(write_crc)
        self.write_statistics = write_statistics
        self.created_by = created_by
        self.kv_metadata = dict(kv_metadata or {})
        self.column_encodings = {
            tuple(k.split(".")) if isinstance(k, str) else tuple(k): Encoding(v)
            for k, v in (column_encodings or {}).items()
        }
        # optional write-side observability (write.WriteStats): encode/
        # compress/flush lane seconds + row counters for the registry
        # `write` section — the doctor's slow-write attribution
        self.stats = stats

        self._shredder = Shredder(schema)
        self._row_groups: list[RowGroup] = []
        self._pending_cols: Optional[dict[str, ColumnData]] = None
        self._pending_rows = 0
        self._total_rows = 0
        self._pos = 0
        self._closed = False
        self._write(MAGIC)
        if self.stats is not None:
            self.stats.touch_wall()  # the writer's wall spans open..close

    # -- plumbing -------------------------------------------------------------

    def _write(self, data: bytes) -> None:
        self._f.write(data)
        self._pos += len(data)

    @property
    def current_file_size(self) -> int:
        """Bytes written so far (CurrentFileSize parity, footer excluded)."""
        return self._pos

    @property
    def current_row_group_size(self) -> int:
        """Estimated in-memory size of the pending row group."""
        est = self._shredder.est_bytes
        if self._pending_cols:
            for cd in self._pending_cols.values():
                if isinstance(cd.values, ByteArrayData):
                    est += int(cd.values.offsets[-1]) + 4 * len(cd.values)
                else:
                    est += cd.values.nbytes
                est += cd.num_leaf_slots
        return est

    # -- row-oriented writes (AddData parity) ----------------------------------

    def write_row(self, row: dict) -> None:
        """Shred one nested dict row (raw physical or logical LIST/MAP shape)."""
        self._check_open()
        if self._pending_cols is not None:
            # switching from columnar to row writes: flush to keep row order
            self.flush_row_group()
        self._shredder.add_row(row)
        self._pending_rows += 1
        if self.current_row_group_size >= self.row_group_size:
            self.flush_row_group()

    def write_rows(self, rows) -> None:
        for row in rows:
            self.write_row(row)

    # -- columnar writes (the TPU-native path) ---------------------------------

    def write_columns(self, columns: dict, num_rows: Optional[int] = None) -> None:
        """Write a columnar batch: {dotted_path: array-like | ColumnData}.

        Flat required columns may be plain numpy arrays/lists; nullable or
        nested columns must be ColumnData with def/rep levels.
        """
        self._check_open()
        batch: dict[str, ColumnData] = {}
        batch_rows = None
        for leaf in self.schema.leaves:
            name = ".".join(leaf.path)
            if name not in columns:
                raise ParquetError(f"write_columns missing column {name!r}")
            v = columns[name]
            cd = self._as_column_data(v, leaf)
            rows_here = (
                int(np.count_nonzero(cd.rep_levels == 0))
                if cd.rep_levels is not None
                else cd.num_leaf_slots
            )
            if batch_rows is None:
                batch_rows = rows_here
            elif batch_rows != rows_here:
                raise ParquetError(
                    f"column {name}: {rows_here} rows, expected {batch_rows}"
                )
            batch[name] = cd
        if num_rows is not None and batch_rows != num_rows:
            raise ParquetError(f"batch has {batch_rows} rows, declared {num_rows}")
        if self._shredder.num_rows:
            # switching from row to columnar writes: flush to keep row order
            self.flush_row_group()
        if self._pending_cols is None:
            self._pending_cols = batch
        else:
            self._pending_cols = {
                k: _concat_column_data([self._pending_cols[k], batch[k]])
                for k in self._pending_cols
            }
        self._pending_rows += batch_rows or 0
        if self.current_row_group_size >= self.row_group_size:
            self.flush_row_group()

    def _as_column_data(self, v, leaf: SchemaNode) -> ColumnData:
        if isinstance(v, ColumnData):
            if v.max_def != leaf.max_def or v.max_rep != leaf.max_rep:
                raise ParquetError(
                    f"column {leaf.flat_name()}: ColumnData levels "
                    f"({v.max_rep},{v.max_def}) don't match schema "
                    f"({leaf.max_rep},{leaf.max_def})"
                )
            return v
        if leaf.max_rep > 0:
            raise ParquetError(
                f"column {leaf.flat_name()}: nested columns need ColumnData"
            )
        if isinstance(v, ByteArrayData):
            vals = v
        elif isinstance(v, np.ndarray) and leaf.physical_type not in (
            Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY,
        ):
            vals = v
        else:
            vals = _coerce_values(list(v), leaf)
        n = len(vals)
        if leaf.max_def > 0:
            return ColumnData(
                values=vals,
                def_levels=np.full(n, leaf.max_def, dtype=np.int32),
                max_def=leaf.max_def, max_rep=0, num_leaf_slots=n,
            )
        return ColumnData(values=vals, max_def=0, max_rep=0, num_leaf_slots=n)

    # -- flush / close ---------------------------------------------------------

    def flush_row_group(
        self,
        kv_metadata: Optional[dict] = None,
        column_kv_metadata: Optional[dict] = None,
    ) -> None:
        """Serialize pending data as one row group (FlushRowGroup parity; the
        kv options mirror WithRowGroupMetaData(ForColumn), file_writer.go:193-226)."""
        self._check_open()
        cols = self._pending_cols or {}
        if self._shredder.num_rows:
            shredded, _n = self._shredder.harvest()
            cols = shredded if not cols else cols
        num_rows = self._pending_rows
        if num_rows == 0 and not cols:
            return  # nothing pending (reference: flushing empty group is a no-op
                    # unless the file would otherwise have no groups)
        chunks = []
        total_bytes = 0
        total_comp = 0
        for leaf in self.schema.leaves:
            name = ".".join(leaf.path)
            cd = cols.get(name)
            if cd is None:
                raise ParquetError(f"row group missing column {name}")
            enc = ChunkEncoder(
                leaf,
                codec=self.codec,
                page_size=self.page_size,
                data_page_version=self.data_page_version,
                use_dictionary=self.use_dictionary,
                write_crc=self.write_crc,
                encoding=self.column_encodings.get(leaf.path),
                write_statistics=self.write_statistics,
                stats=self.stats,
            )
            res = enc.write(cd, self._f, self._pos)
            self._pos += res.total_compressed
            md = res.chunk.meta_data
            if column_kv_metadata and name in column_kv_metadata:
                md.key_value_metadata = [
                    KeyValue(key=k, value=v)
                    for k, v in column_kv_metadata[name].items()
                ]
            chunks.append(res.chunk)
            total_bytes += res.total_uncompressed
            total_comp += res.total_compressed
        rg = RowGroup(
            columns=chunks,
            total_byte_size=total_bytes,
            num_rows=num_rows,
            total_compressed_size=total_comp,
            file_offset=chunks[0].meta_data.dictionary_page_offset
            if chunks and chunks[0].meta_data.dictionary_page_offset is not None
            else (chunks[0].meta_data.data_page_offset if chunks else self._pos),
            ordinal=len(self._row_groups),
        )
        if kv_metadata:
            # row-group kv metadata is not part of the thrift RowGroup; the
            # reference stores it in the file-level kv list namespaced by group
            for k, v in kv_metadata.items():
                self.kv_metadata[f"rowgroup.{len(self._row_groups)}.{k}"] = v
        self._row_groups.append(rg)
        self._total_rows += num_rows
        self._pending_cols = None
        self._pending_rows = 0
        if self.stats is not None:
            self.stats.count_row_group(num_rows, chunks=len(chunks))
            self.stats.touch_wall()

    def close(self) -> None:
        if self._closed:
            return
        if self._pending_rows or self._shredder.num_rows or self._pending_cols:
            self.flush_row_group()
        meta = FileMetaData(
            version=1,
            schema=self.schema.to_flat_elements(),
            num_rows=self._total_rows,
            row_groups=self._row_groups,
            created_by=self.created_by,
            key_value_metadata=[
                KeyValue(key=k, value=v) for k, v in self.kv_metadata.items()
            ]
            or None,
            column_orders=[
                ColumnOrder(TYPE_ORDER=TypeDefinedOrder())
                for _ in self.schema.leaves
            ],
        )
        footer = serialize_footer(meta)
        if self.stats is not None:
            with self.stats.timed("flush", nbytes=len(footer)):
                self._write(footer)
            self.stats.touch_wall()
        else:
            self._write(footer)
        if self._owns_file:
            self._f.close()
        self._closed = True

    def _check_open(self):
        if self._closed:
            raise ParquetError("writer is closed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        elif self._owns_file:
            self._f.close()
        return False


def corrupt_page(path, row_group: int = 0, column=0, page: int = 0,
                 mode: str = "bitflip", seed: int = 0) -> tuple[int, int]:
    """Deterministically corrupt ONE page's payload of a written file,
    in place — the fault-injection helper behind the quarantine tests and
    ``chip_smoke.py``'s contained scans.

    ``column`` is a leaf ordinal or dotted name; ``page`` a data-page
    ordinal within the chunk (``-1`` corrupts the dictionary page).  The
    corruption is :func:`tpu_parquet_torch.quarantine.corrupt_bytes` over the
    page's COMPRESSED payload — length-preserving, so the file still
    parses structurally and the integrity tier (CRC when written,
    decode-time sanity otherwise) is what must catch it.  Returns the
    corrupted span's absolute ``(offset, length)``.
    """
    from .chunk_decode import validate_chunk_meta, walk_pages
    from .footer import read_file_metadata
    from .format import PageType
    from .quarantine import corrupt_bytes
    from .schema.core import Schema

    with open(path, "r+b") as f:
        md = read_file_metadata(f)
        schema = Schema.from_file_metadata(md)
        leaves = schema.leaves
        if isinstance(column, str):
            want = tuple(column.split("."))
            idx = next((i for i, l in enumerate(leaves) if l.path == want),
                       None)
            if idx is None:
                raise KeyError(f"no such column {column!r}")
            column = idx
        leaf = leaves[column]
        rg = md.row_groups[row_group]
        chunk = next(
            c for c in rg.columns
            if c.meta_data is not None
            and tuple(c.meta_data.path_in_schema or ()) == leaf.path)
        cmd, offset = validate_chunk_meta(chunk, leaf)
        f.seek(offset)
        buf = f.read(cmd.total_compressed_size)
        data_pages, dict_page = [], None
        for ps in walk_pages(buf, cmd.num_values):
            if ps.header.type == PageType.DICTIONARY_PAGE:
                dict_page = ps
            elif ps.header.type in (PageType.DATA_PAGE,
                                    PageType.DATA_PAGE_V2):
                data_pages.append(ps)
        ps = dict_page if page == -1 else data_pages[page]
        if ps is None:
            raise IndexError("chunk has no dictionary page")
        payload = buf[ps.payload_start : ps.payload_end]
        bad = corrupt_bytes(bytes(payload), mode, seed)
        f.seek(offset + ps.payload_start)
        f.write(bad)
    return offset + ps.payload_start, len(bad)
