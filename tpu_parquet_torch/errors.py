"""Unified error hierarchy: every malformed-input failure is a ParquetError.

The reference turns every internal panic into one error type at its public
boundary (FileReader.recover, file_reader.go:177-184; schemaParser.recover,
schema_parser.go:285-298).  The Python equivalent is subclassing: each layer
keeps its specific error (ThriftError, RLEError, ...), all rooted here, so
callers — and the fuzz harness's crash oracle — catch exactly one type.
"""


class ParquetError(ValueError):
    """Malformed parquet input."""
