"""floor: the high-level object API.

Equivalent of the reference's floor package (floor/reader.go, floor/writer.go,
floor/interfaces/): read and write typed Python objects — dataclasses or dicts —
with logical-type conversion (datetime ⇄ TIMESTAMP, date ⇄ DATE, Time ⇄ TIME,
uuid ⇄ FIXED(16), Decimal ⇄ DECIMAL, INT96 julian timestamps) layered on the
low-level FileReader/FileWriter.

Custom marshalling hooks mirror the Marshaller/Unmarshaller interfaces
(floor/interfaces/marshaller.go:7-9, unmarshaller.go:15-17): an object with a
``to_parquet_row()`` method controls its own encoding; a class with a
``from_parquet_row(row)`` classmethod controls decoding.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from typing import Any, Iterable, Optional, Type as PyType, Union

from ..footer import ParquetError
from ..logical import unwrap_row
from ..reader import FileReader
from ..schema.autoschema import schema_from_type
from ..schema.core import Schema
from ..writer import FileWriter
from .marshal import MarshalError, convert_row, from_physical, to_physical
from .time import Time

__all__ = ["Reader", "Writer", "Time", "MarshalError", "open_reader", "open_writer"]


class Writer:
    """High-level writer (floor.Writer parity: NewFileWriter + Write,
    floor/writer.go:20-70)."""

    def __init__(self, sink, schema: Optional[Schema] = None,
                 obj_type: Optional[PyType] = None, **writer_options):
        if schema is None:
            if obj_type is None:
                raise ParquetError("floor.Writer needs a schema or an obj_type")
            schema = schema_from_type(obj_type)
        self.schema = schema
        self._w = FileWriter(sink, schema, **writer_options)

    def write(self, obj: Any) -> None:
        """Write one object: Marshaller hook, dataclass, or dict."""
        if hasattr(obj, "to_parquet_row"):
            row = obj.to_parquet_row()
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            row = _dataclass_to_row(obj)
        elif isinstance(obj, dict):
            row = obj
        else:
            raise MarshalError(
                f"cannot marshal {type(obj).__name__}: expected dataclass, dict, "
                f"or an object with to_parquet_row()"
            )
        physical = convert_row(self.schema.root, row, to_physical)
        self._w.write_row(physical)

    def write_many(self, objs: Iterable[Any]) -> None:
        for o in objs:
            self.write(o)

    def flush_row_group(self, **kw) -> None:
        self._w.flush_row_group(**kw)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
        return False


class Reader:
    """High-level reader (floor.Reader parity: Next/Scan, floor/reader.go:18-94)."""

    def __init__(self, source, obj_type: Optional[PyType] = None, **reader_options):
        self._r = FileReader(source, **reader_options)
        self.schema = self._r.schema
        self.obj_type = obj_type
        self._iter = None

    # iterator of converted logical rows
    def __iter__(self):
        for raw in self._r.iter_rows():
            logical = unwrap_row(self.schema, raw)
            yield convert_row(self.schema.root, logical, from_physical)

    def scan_all(self, obj_type: Optional[PyType] = None) -> list:
        """All rows as obj_type instances (Scan parity)."""
        cls = obj_type or self.obj_type
        return [self._construct(cls, row) for row in self]

    def _construct(self, cls, row: dict):
        if cls is None or cls is dict:
            return row
        if hasattr(cls, "from_parquet_row"):
            return cls.from_parquet_row(row)
        if dataclasses.is_dataclass(cls):
            return _row_to_dataclass(cls, row)
        raise MarshalError(
            f"cannot unmarshal into {cls!r}: expected dataclass, dict, or a class "
            f"with from_parquet_row()"
        )

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def num_rows(self) -> int:
        return self._r.num_rows

    @property
    def metadata(self):
        return self._r.metadata


def _dataclass_to_row(obj) -> dict:
    """Shallow per-field conversion (field names lowercased like floor's
    fieldNameFunc unless the dataclass declares metadata={'parquet': name})."""
    out = {}
    for f in dataclasses.fields(obj):
        name = f.metadata.get("parquet", f.name.lower())
        v = getattr(obj, f.name)
        out[name] = _obj_to_plain(v)
    return out


def _obj_to_plain(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return _dataclass_to_row(v)
    if isinstance(v, list):
        return [_obj_to_plain(x) for x in v]
    if isinstance(v, dict):
        return {k: _obj_to_plain(x) for k, x in v.items()}
    return v


def _row_to_dataclass(cls, row: dict):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        name = f.metadata.get("parquet", f.name.lower())
        if name not in row:
            continue
        v = row[name]
        hint = hints.get(f.name)
        kwargs[f.name] = _plain_to_obj(hint, v)
    return cls(**kwargs)


def _plain_to_obj(hint, v):
    if v is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return _plain_to_obj(args[0], v)
        return v
    if origin in (list, typing.List) and isinstance(v, list):
        (elem,) = typing.get_args(hint) or (None,)
        return [_plain_to_obj(elem, x) for x in v]
    if origin in (dict, typing.Dict) and isinstance(v, dict):
        args = typing.get_args(hint) or (None, None)
        return {_plain_to_obj(args[0], k): _plain_to_obj(args[1], x) for k, x in v.items()}
    if hint is not None and dataclasses.is_dataclass(hint) and isinstance(v, dict):
        return _row_to_dataclass(hint, v)
    import datetime as _dt

    if hint is _dt.time and isinstance(v, Time):
        return v.to_datetime_time()
    return v


def open_reader(source, obj_type=None, **kw) -> Reader:
    """NewFileReader parity."""
    return Reader(source, obj_type=obj_type, **kw)


def open_writer(sink, schema=None, obj_type=None, **kw) -> Writer:
    """NewFileWriter parity."""
    return Writer(sink, schema=schema, obj_type=obj_type, **kw)
