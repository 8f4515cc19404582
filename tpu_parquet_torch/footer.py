"""Parquet file footer open/close discipline.

Equivalent of the reference's file_meta.go:14-74 (`ReadFileMetaData`): validate the
4-byte ``PAR1`` magic at both ends of the file, read the little-endian uint32 footer
length from the last 8 bytes, and thrift-decode the ``FileMetaData`` struct.  Footer-only
open — no data pages are touched — which is what makes metadata inspection, row-group
seeking, and column projection cheap (SURVEY.md §5.4).
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, Union

from .format import FileMetaData
from .thrift import ThriftError, deserialize, serialize

MAGIC = b"PAR1"
MAGIC_ENCRYPTED = b"PARE"
FOOTER_TAIL = 8  # uint32 footer length + 4-byte magic


from .errors import ParquetError  # noqa: F401  (canonical home: errors.py)


def read_file_metadata(
    source: Union[str, os.PathLike, BinaryIO, bytes], validate_head_magic: bool = True
) -> FileMetaData:
    """Read the ``FileMetaData`` footer from a path, file object, or bytes.

    Mirrors file_meta.go:18-74: head-magic check (optional, as in the reference's
    ``readHeader`` gate), seek to end, tail magic + footer-length validation, thrift
    decode.
    """
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            return read_file_metadata(f, validate_head_magic)
    if isinstance(source, (bytes, bytearray, memoryview)):
        return read_file_metadata(io.BytesIO(bytes(source)), validate_head_magic)

    f = source
    if validate_head_magic:
        f.seek(0)
        head = f.read(4)
        if head != MAGIC:
            if head == MAGIC_ENCRYPTED:
                raise ParquetError("encrypted parquet files are not supported")
            raise ParquetError(f"invalid parquet file: bad head magic {head!r}")

    size = f.seek(0, os.SEEK_END)
    if size < len(MAGIC) * 2 + FOOTER_TAIL - 4:
        raise ParquetError(f"file too small to be parquet ({size} bytes)")

    f.seek(size - FOOTER_TAIL)
    tail = f.read(FOOTER_TAIL)
    if tail[4:] != MAGIC:
        raise ParquetError(f"invalid parquet file: bad tail magic {tail[4:]!r}")
    footer_len = struct.unpack("<I", tail[:4])[0]
    if footer_len == 0 or footer_len > size - FOOTER_TAIL:
        raise ParquetError(
            f"invalid footer length {footer_len} (file size {size})"
        )

    f.seek(size - FOOTER_TAIL - footer_len)
    buf = f.read(footer_len)
    if len(buf) != footer_len:
        raise ParquetError("truncated footer")
    try:
        meta = deserialize(FileMetaData, buf)
    except ThriftError as e:
        raise ParquetError(f"corrupt footer thrift: {e}") from e

    if meta.schema is None or len(meta.schema) == 0:
        raise ParquetError("footer has no schema elements")
    if meta.num_rows is None or meta.num_rows < 0:
        raise ParquetError(f"footer has invalid num_rows {meta.num_rows}")
    if meta.row_groups is None:
        meta.row_groups = []
    return meta


def serialize_footer(meta: FileMetaData) -> bytes:
    """Footer bytes as written at Close: thrift body + uint32 length + magic.

    Mirrors file_writer.go:336-347.
    """
    body = serialize(meta)
    return body + struct.pack("<I", len(body)) + MAGIC
