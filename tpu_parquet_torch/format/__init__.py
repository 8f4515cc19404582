"""Parquet format metadata model (parquet-format 2.9.0).

Declarative equivalents of the thrift-generated structs the reference ships as 12.5k
lines of generated Go (parquet/parquet.go of the Go reference, generated from
parquet/parquet.thrift).  Field ids and enum values are format-spec facts from
apache/parquet-format 2.9.0; the (de)serialization engine lives in
thrift.py.
"""

from __future__ import annotations

import enum

from ..thrift import ThriftStruct


# ---------------------------------------------------------------------------
# Enums (integer values fixed by parquet.thrift)
# ---------------------------------------------------------------------------

class Type(enum.IntEnum):
    """Physical storage types (parquet.thrift `enum Type`)."""

    BOOLEAN = 0
    INT32 = 1
    INT64 = 2
    INT96 = 3  # deprecated; 12-byte legacy timestamps
    FLOAT = 4
    DOUBLE = 5
    BYTE_ARRAY = 6
    FIXED_LEN_BYTE_ARRAY = 7


class ConvertedType(enum.IntEnum):
    UTF8 = 0
    MAP = 1
    MAP_KEY_VALUE = 2
    LIST = 3
    ENUM = 4
    DECIMAL = 5
    DATE = 6
    TIME_MILLIS = 7
    TIME_MICROS = 8
    TIMESTAMP_MILLIS = 9
    TIMESTAMP_MICROS = 10
    UINT_8 = 11
    UINT_16 = 12
    UINT_32 = 13
    UINT_64 = 14
    INT_8 = 15
    INT_16 = 16
    INT_32 = 17
    INT_64 = 18
    JSON = 19
    BSON = 20
    INTERVAL = 21


class FieldRepetitionType(enum.IntEnum):
    REQUIRED = 0
    OPTIONAL = 1
    REPEATED = 2


class Encoding(enum.IntEnum):
    PLAIN = 0
    PLAIN_DICTIONARY = 2
    RLE = 3
    BIT_PACKED = 4
    DELTA_BINARY_PACKED = 5
    DELTA_LENGTH_BYTE_ARRAY = 6
    DELTA_BYTE_ARRAY = 7
    RLE_DICTIONARY = 8
    BYTE_STREAM_SPLIT = 9


def parse_encoding(value, what: str = "value encoding") -> "Encoding":
    """Convert an untrusted thrift field to Encoding, or raise ParquetError.

    Encoding fields are optional in the wire metadata and attacker-controlled;
    a bare enum ValueError would escape the unified error contract
    (errors.ParquetError) — found by the file_reader fuzz target.
    """
    from ..errors import ParquetError

    try:
        return Encoding(value)
    except (ValueError, TypeError):
        raise ParquetError(f"unknown {what} {value!r}") from None


class CompressionCodec(enum.IntEnum):
    UNCOMPRESSED = 0
    SNAPPY = 1
    GZIP = 2
    LZO = 3
    BROTLI = 4
    LZ4 = 5
    ZSTD = 6
    LZ4_RAW = 7


class PageType(enum.IntEnum):
    DATA_PAGE = 0
    INDEX_PAGE = 1
    DICTIONARY_PAGE = 2
    DATA_PAGE_V2 = 3


class BoundaryOrder(enum.IntEnum):
    UNORDERED = 0
    ASCENDING = 1
    DESCENDING = 2


# ---------------------------------------------------------------------------
# Logical type structs (the LogicalType union and its members)
# ---------------------------------------------------------------------------

class StringType(ThriftStruct):
    FIELDS = {}


class UUIDType(ThriftStruct):
    FIELDS = {}


class MapType(ThriftStruct):
    FIELDS = {}


class ListType(ThriftStruct):
    FIELDS = {}


class EnumType(ThriftStruct):
    FIELDS = {}


class DateType(ThriftStruct):
    FIELDS = {}


class NullType(ThriftStruct):
    FIELDS = {}


class JsonType(ThriftStruct):
    FIELDS = {}


class BsonType(ThriftStruct):
    FIELDS = {}


class Float16Type(ThriftStruct):
    FIELDS = {}


class DecimalType(ThriftStruct):
    FIELDS = {1: ("scale", "i32"), 2: ("precision", "i32")}


class MilliSeconds(ThriftStruct):
    FIELDS = {}


class MicroSeconds(ThriftStruct):
    FIELDS = {}


class NanoSeconds(ThriftStruct):
    FIELDS = {}


class TimeUnit(ThriftStruct):
    """Union: exactly one of MILLIS/MICROS/NANOS is set."""

    FIELDS = {
        1: ("MILLIS", MilliSeconds),
        2: ("MICROS", MicroSeconds),
        3: ("NANOS", NanoSeconds),
    }

    def which(self):
        """Name of the set union member, or None."""
        for _, (name, _spec) in self.FIELDS.items():
            if getattr(self, name) is not None:
                return name
        return None

    @classmethod
    def millis(cls):
        return cls(MILLIS=MilliSeconds())

    @classmethod
    def micros(cls):
        return cls(MICROS=MicroSeconds())

    @classmethod
    def nanos(cls):
        return cls(NANOS=NanoSeconds())


class TimestampType(ThriftStruct):
    FIELDS = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TimeUnit)}


class TimeType(ThriftStruct):
    FIELDS = {1: ("isAdjustedToUTC", "bool"), 2: ("unit", TimeUnit)}


class IntType(ThriftStruct):
    FIELDS = {1: ("bitWidth", "i8"), 2: ("isSigned", "bool")}


class LogicalType(ThriftStruct):
    """Union: exactly one member set (parquet.thrift `union LogicalType`)."""

    FIELDS = {
        1: ("STRING", StringType),
        2: ("MAP", MapType),
        3: ("LIST", ListType),
        4: ("ENUM", EnumType),
        5: ("DECIMAL", DecimalType),
        6: ("DATE", DateType),
        7: ("TIME", TimeType),
        8: ("TIMESTAMP", TimestampType),
        10: ("INTEGER", IntType),
        11: ("UNKNOWN", NullType),
        12: ("JSON", JsonType),
        13: ("BSON", BsonType),
        14: ("UUID", UUIDType),
        15: ("FLOAT16", Float16Type),
    }

    def which(self):
        """Name of the set union member, or None."""
        for _, (name, _spec) in self.FIELDS.items():
            if getattr(self, name) is not None:
                return name
        return None


# ---------------------------------------------------------------------------
# Schema + statistics
# ---------------------------------------------------------------------------

class Statistics(ThriftStruct):
    FIELDS = {
        1: ("max", "binary"),
        2: ("min", "binary"),
        3: ("null_count", "i64"),
        4: ("distinct_count", "i64"),
        5: ("max_value", "binary"),
        6: ("min_value", "binary"),
    }


class SchemaElement(ThriftStruct):
    FIELDS = {
        1: ("type", "i32"),
        2: ("type_length", "i32"),
        3: ("repetition_type", "i32"),
        4: ("name", "string"),
        5: ("num_children", "i32"),
        6: ("converted_type", "i32"),
        7: ("scale", "i32"),
        8: ("precision", "i32"),
        9: ("field_id", "i32"),
        10: ("logicalType", LogicalType),
    }


# ---------------------------------------------------------------------------
# Page headers
# ---------------------------------------------------------------------------

class DataPageHeader(ThriftStruct):
    FIELDS = {
        1: ("num_values", "i32"),
        2: ("encoding", "i32"),
        3: ("definition_level_encoding", "i32"),
        4: ("repetition_level_encoding", "i32"),
        5: ("statistics", Statistics),
    }


class IndexPageHeader(ThriftStruct):
    FIELDS = {}


class DictionaryPageHeader(ThriftStruct):
    FIELDS = {
        1: ("num_values", "i32"),
        2: ("encoding", "i32"),
        3: ("is_sorted", "bool"),
    }


class DataPageHeaderV2(ThriftStruct):
    FIELDS = {
        1: ("num_values", "i32"),
        2: ("num_nulls", "i32"),
        3: ("num_rows", "i32"),
        4: ("encoding", "i32"),
        5: ("definition_levels_byte_length", "i32"),
        6: ("repetition_levels_byte_length", "i32"),
        7: ("is_compressed", "bool"),
        8: ("statistics", Statistics),
    }


class PageHeader(ThriftStruct):
    FIELDS = {
        1: ("type", "i32"),
        2: ("uncompressed_page_size", "i32"),
        3: ("compressed_page_size", "i32"),
        4: ("crc", "i32"),
        5: ("data_page_header", DataPageHeader),
        6: ("index_page_header", IndexPageHeader),
        7: ("dictionary_page_header", DictionaryPageHeader),
        8: ("data_page_header_v2", DataPageHeaderV2),
    }


# ---------------------------------------------------------------------------
# Column chunks, row groups, file metadata
# ---------------------------------------------------------------------------

class KeyValue(ThriftStruct):
    FIELDS = {1: ("key", "string"), 2: ("value", "string")}


class SortingColumn(ThriftStruct):
    FIELDS = {
        1: ("column_idx", "i32"),
        2: ("descending", "bool"),
        3: ("nulls_first", "bool"),
    }


class PageEncodingStats(ThriftStruct):
    FIELDS = {
        1: ("page_type", "i32"),
        2: ("encoding", "i32"),
        3: ("count", "i32"),
    }


class ColumnMetaData(ThriftStruct):
    FIELDS = {
        1: ("type", "i32"),
        2: ("encodings", ("list", "i32")),
        3: ("path_in_schema", ("list", "string")),
        4: ("codec", "i32"),
        5: ("num_values", "i64"),
        6: ("total_uncompressed_size", "i64"),
        7: ("total_compressed_size", "i64"),
        8: ("key_value_metadata", ("list", KeyValue)),
        9: ("data_page_offset", "i64"),
        10: ("index_page_offset", "i64"),
        11: ("dictionary_page_offset", "i64"),
        12: ("statistics", Statistics),
        13: ("encoding_stats", ("list", PageEncodingStats)),
        14: ("bloom_filter_offset", "i64"),
    }


class EncryptionWithFooterKey(ThriftStruct):
    FIELDS = {}


class EncryptionWithColumnKey(ThriftStruct):
    FIELDS = {
        1: ("path_in_schema", ("list", "string")),
        2: ("key_metadata", "binary"),
    }


class ColumnCryptoMetaData(ThriftStruct):
    FIELDS = {
        1: ("ENCRYPTION_WITH_FOOTER_KEY", EncryptionWithFooterKey),
        2: ("ENCRYPTION_WITH_COLUMN_KEY", EncryptionWithColumnKey),
    }


class ColumnChunk(ThriftStruct):
    FIELDS = {
        1: ("file_path", "string"),
        2: ("file_offset", "i64"),
        3: ("meta_data", ColumnMetaData),
        4: ("offset_index_offset", "i64"),
        5: ("offset_index_length", "i32"),
        6: ("column_index_offset", "i64"),
        7: ("column_index_length", "i32"),
        8: ("crypto_metadata", ColumnCryptoMetaData),
        9: ("encrypted_column_metadata", "binary"),
    }


class RowGroup(ThriftStruct):
    FIELDS = {
        1: ("columns", ("list", ColumnChunk)),
        2: ("total_byte_size", "i64"),
        3: ("num_rows", "i64"),
        4: ("sorting_columns", ("list", SortingColumn)),
        5: ("file_offset", "i64"),
        6: ("total_compressed_size", "i64"),
        7: ("ordinal", "i16"),
    }


class TypeDefinedOrder(ThriftStruct):
    FIELDS = {}


class ColumnOrder(ThriftStruct):
    FIELDS = {1: ("TYPE_ORDER", TypeDefinedOrder)}


class PageLocation(ThriftStruct):
    FIELDS = {
        1: ("offset", "i64"),
        2: ("compressed_page_size", "i32"),
        3: ("first_row_index", "i64"),
    }


class OffsetIndex(ThriftStruct):
    FIELDS = {1: ("page_locations", ("list", PageLocation))}


class ColumnIndex(ThriftStruct):
    FIELDS = {
        1: ("null_pages", ("list", "bool")),
        2: ("min_values", ("list", "binary")),
        3: ("max_values", ("list", "binary")),
        4: ("boundary_order", "i32"),
        5: ("null_counts", ("list", "i64")),
    }


class AesGcmV1(ThriftStruct):
    FIELDS = {
        1: ("aad_prefix", "binary"),
        2: ("aad_file_unique", "binary"),
        3: ("supply_aad_prefix", "bool"),
    }


class AesGcmCtrV1(ThriftStruct):
    FIELDS = {
        1: ("aad_prefix", "binary"),
        2: ("aad_file_unique", "binary"),
        3: ("supply_aad_prefix", "bool"),
    }


class EncryptionAlgorithm(ThriftStruct):
    FIELDS = {1: ("AES_GCM_V1", AesGcmV1), 2: ("AES_GCM_CTR_V1", AesGcmCtrV1)}


class FileMetaData(ThriftStruct):
    FIELDS = {
        1: ("version", "i32"),
        2: ("schema", ("list", SchemaElement)),
        3: ("num_rows", "i64"),
        4: ("row_groups", ("list", RowGroup)),
        5: ("key_value_metadata", ("list", KeyValue)),
        6: ("created_by", "string"),
        7: ("column_orders", ("list", ColumnOrder)),
        8: ("encryption_algorithm", EncryptionAlgorithm),
        9: ("footer_signing_key_metadata", "binary"),
    }


class FileCryptoMetaData(ThriftStruct):
    FIELDS = {
        1: ("encryption_algorithm", EncryptionAlgorithm),
        2: ("key_metadata", "binary"),
    }
