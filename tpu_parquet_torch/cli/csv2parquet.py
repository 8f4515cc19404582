"""csv2parquet: convert CSV files to parquet with type hints.

Equivalent of the reference's cmd/csv2parquet (main.go:24-435): derives a schema
from the CSV header, with ``--type-hints col=type,...`` overrides (deriveSchema
:154, createColumn :188, per-type handlers :367-434).

Usage:
    python -m tpu_parquet_torch.cli.csv2parquet --input data.csv --output data.parquet \
        [--type-hints "id=int64,price=double,ok=boolean"] [--codec snappy] \
        [--delimiter ,] [--wrap optional]

Supported hint types: boolean, int32, int64, float, double, string (default),
byte_array, timestamp (RFC3339/ISO), date (YYYY-MM-DD), json.
"""

from __future__ import annotations

import argparse
import csv
import datetime
import json
import sys

from ..footer import ParquetError
from ..format import (
    CompressionCodec,
    ConvertedType,
    FieldRepetitionType as FRT,
    LogicalType,
    StringType,
    TimestampType,
    TimeUnit,
    Type,
)
from ..schema.core import ColumnParameters, SchemaNode, build_schema, data_column
from ..schema.dsl import schema_to_string

_HANDLERS = {}


def _handler(name):
    def reg(fn):
        _HANDLERS[name] = fn
        return fn
    return reg


@_handler("boolean")
def _h_bool(s: str):
    low = s.strip().lower()
    if low in ("true", "t", "1", "yes", "y"):
        return True
    if low in ("false", "f", "0", "no", "n"):
        return False
    raise ValueError(f"cannot parse boolean {s!r}")


@_handler("int32")
@_handler("int64")
def _h_int(s: str):
    return int(s.strip())


@_handler("float")
@_handler("double")
def _h_float(s: str):
    return float(s.strip())


@_handler("string")
def _h_str(s: str):
    return s


@_handler("byte_array")
def _h_bytes(s: str):
    return s.encode("utf-8")


@_handler("json")
def _h_json(s: str):
    json.loads(s)  # validate
    return s


@_handler("timestamp")
def _h_ts(s: str):
    from ..floor.time import parse_iso_datetime

    return parse_iso_datetime(s)


@_handler("date")
def _h_date(s: str):
    return datetime.date.fromisoformat(s.strip())


def column_for_type(name: str, typ: str, repetition: FRT) -> SchemaNode:
    if typ == "boolean":
        return data_column(name, Type.BOOLEAN, repetition)
    if typ == "int32":
        return data_column(name, Type.INT32, repetition)
    if typ == "int64":
        return data_column(name, Type.INT64, repetition)
    if typ == "float":
        return data_column(name, Type.FLOAT, repetition)
    if typ == "double":
        return data_column(name, Type.DOUBLE, repetition)
    if typ == "byte_array":
        return data_column(name, Type.BYTE_ARRAY, repetition)
    if typ == "json":
        return data_column(
            name, Type.BYTE_ARRAY, repetition,
            ColumnParameters(converted_type=ConvertedType.JSON),
        )
    if typ == "string":
        return data_column(
            name, Type.BYTE_ARRAY, repetition,
            ColumnParameters(
                logical_type=LogicalType(STRING=StringType()),
                converted_type=ConvertedType.UTF8,
            ),
        )
    if typ == "timestamp":
        return data_column(
            name, Type.INT64, repetition,
            ColumnParameters(
                logical_type=LogicalType(
                    TIMESTAMP=TimestampType(isAdjustedToUTC=True, unit=TimeUnit.nanos())
                )
            ),
        )
    if typ == "date":
        return data_column(
            name, Type.INT32, repetition,
            ColumnParameters(converted_type=ConvertedType.DATE),
        )
    raise ValueError(f"unknown type hint {typ!r}")


def parse_type_hints(s: str) -> dict[str, str]:
    """'a=int64,b=double' → {'a': 'int64', 'b': 'double'} (main.go:72-90)."""
    out = {}
    if not s:
        return out
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"invalid type hint {part!r} (want col=type)")
        col, typ = part.split("=", 1)
        typ = typ.strip().lower()
        if typ not in _HANDLERS:
            raise ValueError(
                f"unknown type {typ!r} in hint for {col!r}; "
                f"valid: {sorted(_HANDLERS)}"
            )
        out[col.strip()] = typ
    return out


def derive_schema(header: list[str], hints: dict[str, str], wrap: str):
    for col in hints:
        if col not in header:
            raise ValueError(f"type hint for unknown column {col!r}")
    rep = FRT.OPTIONAL if wrap == "optional" else FRT.REQUIRED
    cols = []
    types = []
    for name in header:
        typ = hints.get(name, "string")
        types.append(typ)
        cols.append(column_for_type(name, typ, rep))
    return build_schema(cols, root_name="csv"), types


def convert(
    input_path: str,
    output_path: str,
    type_hints: dict[str, str],
    codec: int = CompressionCodec.SNAPPY,
    delimiter: str = ",",
    wrap: str = "required",
    creator: str = "csv2parquet",
    out=sys.stdout,
) -> int:
    """Returns the number of rows written."""
    with open(input_path, newline="") as f:
        reader = csv.reader(f, delimiter=delimiter)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError("empty CSV input") from None
        schema, types = derive_schema(header, type_hints, wrap)
        handlers = [_HANDLERS[t] for t in types]
        n = 0
        # floor.Writer performs the logical conversions (timestamp/date -> ints)
        from ..floor import Writer as FloorWriter

        with FloorWriter(
            output_path, schema=schema, codec=codec, created_by=creator
        ) as w:
            for lineno, record in enumerate(reader, 2):
                if len(record) != len(header):
                    raise ValueError(
                        f"line {lineno}: {len(record)} fields, expected {len(header)}"
                    )
                row = {}
                for name, h, raw in zip(header, handlers, record):
                    if raw == "" and wrap == "optional":
                        row[name] = None
                        continue
                    try:
                        row[name] = h(raw)
                    except ValueError as e:
                        raise ValueError(f"line {lineno}, column {name!r}: {e}") from None
                w.write(row)
                n += 1
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="csv2parquet", description="Convert CSV to parquet"
    )
    p.add_argument("--input", "-i", required=True)
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--type-hints", default="", help="col=type,col=type,...")
    p.add_argument("--delimiter", default=",")
    p.add_argument("--codec", default="snappy",
                   choices=["uncompressed", "snappy", "gzip", "zstd"])
    p.add_argument("--wrap", default="required", choices=["required", "optional"],
                   help="optional: empty CSV fields become NULL")
    p.add_argument("--creator", default="csv2parquet")
    p.add_argument("--print-schema", action="store_true")
    args = p.parse_args(argv)
    try:
        if len(args.delimiter) != 1:
            raise ValueError(
                f"delimiter must be a single character, got {args.delimiter!r}"
            )
        hints = parse_type_hints(args.type_hints)
        if args.print_schema:
            with open(args.input, newline="") as f:
                try:
                    header = next(csv.reader(f, delimiter=args.delimiter))
                except StopIteration:
                    raise ValueError("empty CSV input") from None
            schema, _ = derive_schema(header, hints, args.wrap)
            sys.stdout.write(schema_to_string(schema))
            return 0
        codec = getattr(CompressionCodec, args.codec.upper())
        n = convert(args.input, args.output, hints, codec=codec,
                    delimiter=args.delimiter, wrap=args.wrap,
                    creator=args.creator)
        print(f"wrote {n} rows to {args.output}")
        return 0
    except (ParquetError, ValueError, OSError) as e:
        print(f"csv2parquet: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
