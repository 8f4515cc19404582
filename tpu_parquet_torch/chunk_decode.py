"""Column-chunk decoding: page walk + (type x encoding) dispatch -> ColumnData.

The counterpart of ``tpu_parquet.chunk_decode``: the page walk
(``walk_pages``), the CRC and chunk-metadata checks shared with the device
reader, and the host decoder of the host ``FileReader`` (``ChunkDecoder``,
``read_chunk``) on the package's own host codecs (``kernels/``).  Mirrors
readChunk/readPages/readPageBlock and the getValuesDecoder dispatch of the
Go reference (chunk_reader.go:106-330), but columnar: the whole chunk's byte
range is read in one IO, pages are sliced out of the buffer, and every decode
step is a bulk array transform.  PLAIN_DICTIONARY is read as RLE_DICTIONARY;
BYTE_STREAM_SPLIT is read too.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import BinaryIO, Optional

import numpy as np

from .alloc import AllocTracker
from .column import ByteArrayData, ColumnData
from .compress import decompress_block
from .errors import error_context
from .footer import ParquetError
from .format import Encoding, PageHeader, PageType, Type, parse_encoding
from .iostore import require_full
from .kernels import bitpack, bytearray as ba_codec, delta, plain, rle
from .obs import PART_CRC, PART_PAGE_PARSE, host_part, timed_part
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


@host_part(PART_PAGE_PARSE)
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
    actual = timed_part(PART_CRC, zlib.crc32, payload) & 0xFFFFFFFF
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


class ChunkDecoder:
    """Decodes one column chunk into a ColumnData on the host.

    ``context`` carries the decode site ({file, column, row_group,
    chunk_offset}): every raise out of :meth:`decode` is annotated with it
    plus the failing page's ordinal and absolute byte offset
    (``errors.error_context``)."""

    def __init__(self, leaf: SchemaNode, validate_crc: bool = False,
                 alloc: Optional[AllocTracker] = None,
                 context: Optional[dict] = None, dict_cache=None):
        self.leaf = leaf
        self.validate_crc = validate_crc
        self.alloc = alloc or AllocTracker(0)
        self.context = dict(context or {})
        if "column" not in self.context and leaf.path:
            self.context["column"] = ".".join(leaf.path)
        self.dictionary = None  # decoded dict values (array or ByteArrayData)
        # read-through decoded-dictionary cache (serve.BoundDictCache duck
        # type): get(rg, column, kind) / put(rg, column, kind, value,
        # nbytes), keyed by this decoder's context coordinates — callers
        # without a row_group/column context never hit it.
        self.dict_cache = dict_cache

    # -- value decoding dispatch (getValuesDecoder, chunk_reader.go:106-159) --

    def _decode_values(self, enc: int, raw: bytes, count: int):
        ptype = self.leaf.physical_type
        tl = self.leaf.type_length
        enc = parse_encoding(enc)
        if enc == Encoding.PLAIN_DICTIONARY:
            enc = Encoding.RLE_DICTIONARY
        if enc == Encoding.PLAIN:
            return plain.decode(raw, ptype, count, tl)
        if enc == Encoding.RLE_DICTIONARY:
            if self.dictionary is None:
                raise ParquetError(
                    "dictionary-encoded page but no dictionary page seen"
                )
            if len(raw) < 1:
                raise ParquetError("dictionary page data truncated (missing width)")
            width = int(raw[0])
            if width > 32:
                raise ParquetError(f"dictionary index width {width} invalid")
            idx = rle.decode(raw[1:], width, count).astype(np.int64)
            dict_len = len(self.dictionary)
            if count and (idx.max(initial=0) >= dict_len):
                raise ParquetError(
                    f"dictionary index {int(idx.max())} out of range ({dict_len})"
                )
            if isinstance(self.dictionary, ByteArrayData):
                return self.dictionary.take(idx)
            return self.dictionary[idx]
        if enc == Encoding.DELTA_BINARY_PACKED:
            if ptype == Type.INT32:
                vals, _ = delta.decode(raw, bits=32)
            elif ptype == Type.INT64:
                vals, _ = delta.decode(raw, bits=64)
            else:
                raise ParquetError(f"DELTA_BINARY_PACKED invalid for {ptype!r}")
            if len(vals) < count:
                raise ParquetError(
                    f"delta stream yielded {len(vals)} of {count} values"
                )
            return vals[:count]
        if enc == Encoding.DELTA_LENGTH_BYTE_ARRAY:
            if ptype != Type.BYTE_ARRAY:
                raise ParquetError(f"DELTA_LENGTH_BYTE_ARRAY invalid for {ptype!r}")
            return ba_codec.decode_delta_length(raw, count)
        if enc == Encoding.DELTA_BYTE_ARRAY:
            if ptype != Type.BYTE_ARRAY:
                raise ParquetError(f"DELTA_BYTE_ARRAY invalid for {ptype!r}")
            return ba_codec.decode_delta(raw, count)
        if enc == Encoding.RLE:
            if ptype != Type.BOOLEAN:
                raise ParquetError(f"RLE value encoding invalid for {ptype!r}")
            vals, _ = rle.decode_prefixed(raw, 1, count)
            return vals.astype(bool)
        if enc == Encoding.BYTE_STREAM_SPLIT:
            return _byte_stream_split_decode(raw, ptype, count, tl)
        raise ParquetError(f"unsupported value encoding {enc.name} for {ptype!r}")

    # -- pages ----------------------------------------------------------------

    def _dict_cache_key(self):
        rg = self.context.get("row_group")
        col = self.context.get("column")
        if self.dict_cache is None or rg is None or col is None:
            return None
        # the CRC tier is part of the key: a validate_crc=True request must
        # never be served a dictionary decoded without the check it asked for
        return rg, col, f"host:v{1 if self.validate_crc else 0}"

    def _decode_dict_page(self, ps: PageSlice, buf: bytes, codec: int):
        # a dictionary the cache already decoded for this (row group,
        # column, CRC tier) of this file generation skips the decompress and
        # the PLAIN decode; it is shared read-only (takes copy)
        ck = self._dict_cache_key()
        if ck is not None:
            hit = self.dict_cache.get(*ck)
            if hit is not None:
                self.dictionary = hit
                return
        header = ps.header
        payload = buf[ps.payload_start : ps.payload_end]
        _check_crc(header, payload, self.validate_crc)
        self.alloc.register(header.uncompressed_page_size)
        raw = decompress_block(payload, codec, header.uncompressed_page_size)
        dh = header.dictionary_page_header
        enc = parse_encoding(dh.encoding, "dictionary page encoding")
        if enc not in (Encoding.PLAIN, Encoding.PLAIN_DICTIONARY):
            raise ParquetError(f"dictionary page encoding {enc.name} unsupported")
        count = dh.num_values or 0
        if count < 0:
            raise ParquetError(f"negative dictionary size {count}")
        self.dictionary = plain.decode(
            raw, self.leaf.physical_type, count, self.leaf.type_length
        )
        if ck is not None:
            d = self.dictionary
            nbytes = (int(d.offsets.nbytes + d.heap.nbytes)
                      if isinstance(d, ByteArrayData) else int(d.nbytes))
            self.dict_cache.put(*ck, d, nbytes)

    def _decode_data_page_v1(self, ps: PageSlice, buf: bytes, codec: int):
        header = ps.header
        dh = header.data_page_header
        payload = buf[ps.payload_start : ps.payload_end]
        _check_crc(header, payload, self.validate_crc)
        self.alloc.register(header.uncompressed_page_size)
        raw = decompress_block(payload, codec, header.uncompressed_page_size)
        num_values = dh.num_values or 0
        if num_values < 0:
            raise ParquetError(f"negative page value count {num_values}")
        pos = 0
        max_rep, max_def = self.leaf.max_rep, self.leaf.max_def
        rlv = dlv = None
        if max_rep > 0:
            rlv, used = rle.decode_prefixed(
                raw[pos:], bitpack.bit_width(max_rep), num_values
            )
            pos += used
        if max_def > 0:
            dlv, used = rle.decode_prefixed(
                raw[pos:], bitpack.bit_width(max_def), num_values
            )
            pos += used
        # structural sanity (always on, O(1)): a level run table yielding
        # the wrong count means the page lies about itself
        if rlv is not None and len(rlv) != num_values:
            raise ParquetError(
                f"page declares {num_values} values, repetition levels "
                f"decode {len(rlv)}")
        if dlv is not None and len(dlv) != num_values:
            raise ParquetError(
                f"page declares {num_values} values, definition levels "
                f"decode {len(dlv)}")
        defined = int(np.count_nonzero(dlv == max_def)) if dlv is not None else num_values
        values = self._decode_values(dh.encoding, raw[pos:], defined)
        return values, dlv, rlv, num_values

    def _decode_data_page_v2(self, ps: PageSlice, buf: bytes, codec: int):
        header = ps.header
        dh = header.data_page_header_v2
        payload = buf[ps.payload_start : ps.payload_end]
        _check_crc(header, payload, self.validate_crc)
        num_values = dh.num_values or 0
        if num_values < 0:
            raise ParquetError(f"negative page value count {num_values}")
        rep_len = dh.repetition_levels_byte_length or 0
        def_len = dh.definition_levels_byte_length or 0
        if rep_len < 0 or def_len < 0 or rep_len + def_len > len(payload):
            raise ParquetError("v2 level lengths exceed page")
        max_rep, max_def = self.leaf.max_rep, self.leaf.max_def
        rlv = dlv = None
        if max_rep > 0:
            if rep_len == 0:
                raise ParquetError("v2 page missing repetition levels")
            rlv = rle.decode(
                payload[:rep_len], bitpack.bit_width(max_rep), num_values
            )
        if max_def > 0:
            dlv = rle.decode(
                payload[rep_len : rep_len + def_len],
                bitpack.bit_width(max_def),
                num_values,
            )
        if rlv is not None and len(rlv) != num_values:
            raise ParquetError(
                f"v2 page declares {num_values} values, repetition levels "
                f"decode {len(rlv)}")
        if dlv is not None and len(dlv) != num_values:
            raise ParquetError(
                f"v2 page declares {num_values} values, definition levels "
                f"decode {len(dlv)}")
        values_block = payload[rep_len + def_len :]
        uncompressed_values = (
            header.uncompressed_page_size - rep_len - def_len
        )
        self.alloc.register(max(uncompressed_values, 0))
        if dh.is_compressed is None or dh.is_compressed:
            raw = decompress_block(values_block, codec, uncompressed_values)
        else:
            raw = values_block
        if dh.num_nulls is not None and dlv is not None:
            declared_nulls = dh.num_nulls
            actual_nulls = int(np.count_nonzero(dlv != max_def))
            if declared_nulls != actual_nulls and max_rep == 0:
                raise ParquetError(
                    f"v2 page declares {declared_nulls} nulls, levels say {actual_nulls}"
                )
        defined = int(np.count_nonzero(dlv == max_def)) if dlv is not None else num_values
        values = self._decode_values(dh.encoding, raw, defined)
        return values, dlv, rlv, num_values

    # -- whole chunk -----------------------------------------------------------

    def decode(self, buf: bytes, codec: int, total_values: int) -> ColumnData:
        ctx = dict(self.context)
        chunk_offset = ctx.pop("chunk_offset", 0) or 0
        with error_context(**ctx):
            pages = walk_pages(buf, total_values)
        values_parts = []
        def_parts = []
        rep_parts = []
        slots = 0
        page_ordinal = 0  # data pages only
        for ps in pages:
            pt = ps.header.type
            with error_context(
                    page=(page_ordinal if pt != PageType.DICTIONARY_PAGE
                          else None),
                    offset=chunk_offset + ps.payload_start, **ctx):
                if pt == PageType.DICTIONARY_PAGE:
                    self._decode_dict_page(ps, buf, codec)
                    continue
                if pt == PageType.DATA_PAGE:
                    v, d, r, n = self._decode_data_page_v1(ps, buf, codec)
                elif pt == PageType.DATA_PAGE_V2:
                    v, d, r, n = self._decode_data_page_v2(ps, buf, codec)
                else:
                    continue  # index/unknown pages: ignore
                page_ordinal += 1
            values_parts.append(v)
            slots += n
            if d is not None:
                def_parts.append(d)
            if r is not None:
                rep_parts.append(r)

        max_rep, max_def = self.leaf.max_rep, self.leaf.max_def
        values = _concat_values(values_parts)
        def_levels = (
            np.concatenate(def_parts).astype(np.int32) if def_parts else None
        )
        rep_levels = (
            np.concatenate(rep_parts).astype(np.int32) if rep_parts else None
        )
        with error_context(**ctx):
            if def_levels is not None and len(def_levels) != slots:
                raise ParquetError("definition level count mismatch")
            if rep_levels is not None and len(rep_levels) != slots:
                raise ParquetError("repetition level count mismatch")
        return ColumnData(
            values=values,
            def_levels=def_levels,
            rep_levels=rep_levels,
            max_def=max_def,
            max_rep=max_rep,
            num_leaf_slots=slots,
        )


def _concat_values(parts: list):
    if not parts:
        return np.zeros(0, dtype=np.int64)
    if len(parts) == 1:
        return parts[0]
    if isinstance(parts[0], ByteArrayData):
        offsets_parts = [parts[0].offsets]
        heap_parts = [parts[0].heap]
        base = int(parts[0].offsets[-1])
        for p in parts[1:]:
            offsets_parts.append(p.offsets[1:] + base)
            heap_parts.append(p.heap)
            base += int(p.offsets[-1])
        return ByteArrayData(
            offsets=np.concatenate(offsets_parts),
            heap=np.concatenate(heap_parts),
        )
    return np.concatenate(parts)


def read_chunk(f: BinaryIO, chunk, leaf: SchemaNode,
               validate_crc: bool = False,
               alloc: Optional[AllocTracker] = None,
               context: Optional[dict] = None, dict_cache=None,
               meta: "Optional[tuple]" = None) -> ColumnData:
    """Read + decode one column chunk from an open file (readChunk parity).

    ``meta``: a ``(md, offset)`` pair already through
    :func:`validate_chunk_meta` (the footer walk yields them)."""
    md, offset = meta if meta is not None else validate_chunk_meta(chunk, leaf)
    size = md.total_compressed_size
    if alloc is not None:
        alloc.register(size)
    ctx = dict(context or {})
    ctx.setdefault("chunk_offset", offset)
    with error_context(offset=offset,
                       **{k: v for k, v in ctx.items()
                          if k != "chunk_offset"}):
        f.seek(offset)
        buf = f.read(size)
        require_full(buf, offset, size,
                     context=f"column {'.'.join(leaf.path)}")
    dec = ChunkDecoder(leaf, validate_crc=validate_crc, alloc=alloc,
                       context=ctx, dict_cache=dict_cache)
    return dec.decode(buf, md.codec, md.num_values)
