"""Column-chunk page walk: page headers, CRC checks and chunk-metadata checks.

The host half of the device reader's chunk walk (the counterpart of
``tpu_parquet.chunk_decode``, cut to ``walk_pages``, ``_check_crc``,
``validate_chunk_meta`` and the host BYTE_STREAM_SPLIT decode that the
device path's FIXED_LEN_BYTE_ARRAY pages take; the other host value
decoders are not part of this package).
Mirrors readChunk/readPages of the reference (chunk_reader.go:182-330).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from .column import ByteArrayData
from .footer import ParquetError
from .format import PageHeader, PageType, Type
from .schema.core import SchemaNode
from .thrift import ThriftError, read_struct


@dataclass
class PageSlice:
    """One page located inside a chunk buffer (header + payload span)."""

    header: PageHeader
    payload_start: int
    payload_end: int


# native page-header parse error codes → the python engine's diagnostics
_NATIVE_THRIFT_ERRORS = {
    -40: "truncated thrift input",
    -41: "varint too long",
    -42: "thrift container exceeds sanity cap",
    -43: "thrift nesting too deep",
    -44: "cannot skip unknown thrift ctype",
}


def _read_page_header(buf: bytes, pos: int):
    """One PageHeader at ``pos``: native C parse (meta_parse.cpp, the
    per-page host hot path — ~100 µs of python thrift per page otherwise)
    with the python engine as fallback and fuzz-parity oracle."""
    from . import native

    res = native.page_header(buf, pos)
    if res is None:
        return read_struct(PageHeader, buf, pos)
    if isinstance(res, int):
        raise ThriftError(
            _NATIVE_THRIFT_ERRORS.get(res, f"thrift parse error {res}")
        )
    return res


def walk_pages(buf: bytes, total_values: int) -> list[PageSlice]:
    """Parse page headers until the chunk's declared value count is consumed.

    Mirrors readPages (chunk_reader.go:182-263): iterate thrift PageHeaders and
    their payloads; dictionary pages don't count toward the value total.
    """
    pages: list[PageSlice] = []
    pos = 0
    seen_values = 0
    seen_dict = False
    n = len(buf)
    while seen_values < total_values:
        if pos >= n:
            raise ParquetError(
                f"chunk exhausted at {seen_values}/{total_values} values"
            )
        try:
            header, pos = _read_page_header(buf, pos)
        except ThriftError as e:
            raise ParquetError(f"corrupt page header: {e}") from e
        if header.compressed_page_size is None or header.compressed_page_size < 0:
            raise ParquetError(
                f"invalid compressed page size {header.compressed_page_size}"
            )
        if header.uncompressed_page_size is None or header.uncompressed_page_size < 0:
            raise ParquetError(
                f"invalid uncompressed page size {header.uncompressed_page_size}"
            )
        end = pos + header.compressed_page_size
        if end > n:
            raise ParquetError("page payload extends past chunk end")
        ptype = header.type
        if ptype == PageType.DICTIONARY_PAGE:
            if seen_dict or pages:
                # only one dict page, and only at the start (chunk_reader.go:196-199)
                raise ParquetError("unexpected extra dictionary page")
            if header.dictionary_page_header is None:
                raise ParquetError("dictionary page missing its header")
            seen_dict = True
        elif ptype == PageType.DATA_PAGE:
            if header.data_page_header is None:
                raise ParquetError("data page v1 missing its header")
            seen_values += header.data_page_header.num_values or 0
        elif ptype == PageType.DATA_PAGE_V2:
            if header.data_page_header_v2 is None:
                raise ParquetError("data page v2 missing its header")
            seen_values += header.data_page_header_v2.num_values or 0
        # INDEX_PAGE and unknown types: skip payload silently
        pages.append(PageSlice(header, pos, end))
        pos = end
    return pages


def _check_crc(header: PageHeader, payload: bytes, validate: bool) -> None:
    if not validate or header.crc is None:
        return
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    if actual != header.crc & 0xFFFFFFFF:
        raise ParquetError(
            f"page CRC mismatch: header {header.crc & 0xFFFFFFFF:#x}, data {actual:#x}"
        )


def validate_chunk_meta(chunk, leaf: SchemaNode):
    """Validate a ColumnChunk's embedded metadata; returns (md, start_offset).

    Mirrors readChunk's entry checks (chunk_reader.go:299-330): requires embedded
    ColumnMetaData (PARQUET-291: file_offset is unreliable), rejects external
    file_path chunks, verifies the physical type, and picks the dictionary page
    offset when present else the first data page.  Shared by the host and device
    chunk readers so both reject the same malformed files.
    """
    md = chunk.meta_data
    if md is None:
        raise ParquetError(
            "column chunk missing embedded metadata (external metadata unsupported)"
        )
    if chunk.file_path:
        raise ParquetError(
            f"column chunk data in external file {chunk.file_path!r} unsupported"
        )
    if md.type is not None and leaf.physical_type is not None:
        if md.type != int(leaf.physical_type):
            raise ParquetError(
                f"chunk type {md.type} does not match schema type {leaf.physical_type!r}"
            )
    if md.data_page_offset is None or md.data_page_offset < 0:
        raise ParquetError(f"invalid data page offset {md.data_page_offset}")
    offset = md.data_page_offset
    if md.dictionary_page_offset is not None and md.dictionary_page_offset >= 0:
        offset = min(offset, md.dictionary_page_offset)
    if md.total_compressed_size is None or md.total_compressed_size < 0:
        raise ParquetError(f"invalid chunk size {md.total_compressed_size}")
    if md.num_values is None or md.num_values < 0:
        raise ParquetError(f"invalid chunk value count {md.num_values}")
    return md, offset


def _byte_stream_split_decode(raw: bytes, ptype: Type, count: int,
                              type_length: int):
    """BYTE_STREAM_SPLIT: K per-byte streams concatenated; de-interleave."""
    width = {
        Type.FLOAT: 4, Type.DOUBLE: 8, Type.INT32: 4, Type.INT64: 8,
    }.get(ptype, type_length)
    if width <= 0:
        raise ParquetError(f"BYTE_STREAM_SPLIT unsupported for {ptype!r}")
    need = count * width
    if len(raw) < need:
        raise ParquetError("BYTE_STREAM_SPLIT: truncated data")
    mat = np.frombuffer(raw, np.uint8, need).reshape(width, count).T.copy()
    flat = mat.reshape(-1)
    if ptype == Type.FLOAT:
        return flat.view("<f4").copy()
    if ptype == Type.DOUBLE:
        return flat.view("<f8").copy()
    if ptype == Type.INT32:
        return flat.view("<i4").copy()
    if ptype == Type.INT64:
        return flat.view("<i8").copy()
    offsets = np.arange(count + 1, dtype=np.int64) * width
    return ByteArrayData(offsets=offsets, heap=flat)
