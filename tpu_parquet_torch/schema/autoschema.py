"""Autoschema: generate a parquet schema from Python type annotations.

Equivalent of the reference's reflection-based autoschema (parquetschema/
autoschema/gen.go:17-398, Go struct → schema definition): here a dataclass (or
any class with type annotations) maps to a message schema —

    int → int64 INT(64,true)         bool → boolean
    float → double                   str → binary (STRING)
    bytes → binary                   datetime.datetime → int64 TIMESTAMP(NANOS)
    datetime.date → int32 (DATE)     datetime.time → int64 TIME(NANOS)
    uuid.UUID → fixed(16) (UUID)     Annotated fixed bytes → fixed(N)
    Optional[T] → optional           list[T] → LIST group
    dict[K,V] → MAP group            nested dataclass → group
    np.int32/float32/... → matching physical types

Field naming mirrors floor's rules (floor/fieldname.go:8-19): a ``parquet``
metadata key in dataclass field metadata overrides, else the lowercased name.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal as _decimal
import typing
import uuid as uuid_mod
from typing import Optional

import numpy as np

from ..format import (
    ConvertedType,
    DateType,
    FieldRepetitionType as FRT,
    IntType,
    LogicalType,
    SchemaElement,
    StringType,
    TimestampType,
    TimeType,
    TimeUnit,
    Type,
    UUIDType,
)
from .core import Schema, SchemaError, SchemaNode


class AutoSchemaError(SchemaError):
    pass


def schema_from_type(cls, root_name: str = "autoschema") -> Schema:
    """GenerateSchema parity: python class w/ annotations → Schema."""
    hints = typing.get_type_hints(cls, include_extras=True)
    if not hints:
        raise AutoSchemaError(f"{cls!r} has no type annotations")
    field_meta = {}
    if dataclasses.is_dataclass(cls):
        field_meta = {f.name: f.metadata for f in dataclasses.fields(cls)}
    children = []
    for name, hint in hints.items():
        pq_name = field_meta.get(name, {}).get("parquet", name.lower())
        children.append(_field_node(pq_name, hint))
    root = SchemaNode(SchemaElement(name=root_name), children)
    return Schema(root)


def _strip_optional(hint):
    origin = typing.get_origin(hint)
    if origin is typing.Union:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1 and type(None) in typing.get_args(hint):
            return args[0], True
    return hint, False


def _field_node(name: str, hint, repetition: Optional[FRT] = None) -> SchemaNode:
    hint, optional = _strip_optional(hint)
    if repetition is None:
        repetition = FRT.OPTIONAL if optional else FRT.REQUIRED
    origin = typing.get_origin(hint)

    if origin in (list, typing.List):
        (elem_hint,) = typing.get_args(hint) or (int,)
        elem = _field_node("element", elem_hint)
        from ..format import ListType

        lst = SchemaElement(
            name=name,
            repetition_type=int(repetition),
            converted_type=int(ConvertedType.LIST),
            logicalType=LogicalType(LIST=ListType()),
        )
        inner = SchemaElement(name="list", repetition_type=int(FRT.REPEATED))
        return SchemaNode(lst, [SchemaNode(inner, [elem])])

    if origin in (dict, typing.Dict):
        args = typing.get_args(hint) or (str, int)
        key = _field_node("key", args[0], repetition=FRT.REQUIRED)
        value = _field_node("value", args[1])
        from ..format import MapType

        mp = SchemaElement(
            name=name,
            repetition_type=int(repetition),
            converted_type=int(ConvertedType.MAP),
            logicalType=LogicalType(MAP=MapType()),
        )
        kv = SchemaElement(
            name="key_value", repetition_type=int(FRT.REPEATED),
        )
        return SchemaNode(mp, [SchemaNode(kv, [key, value])])

    if dataclasses.is_dataclass(hint) or (
        isinstance(hint, type) and typing.get_type_hints(hint) and not _scalar(hint)
    ):
        sub = schema_from_type(hint, root_name=name)
        elem = SchemaElement(name=name, repetition_type=int(repetition))
        return SchemaNode(elem, sub.root.children)

    return _scalar_node(name, hint, repetition)


def _scalar(hint) -> bool:
    return hint in (
        int, float, str, bytes, bool,
        datetime.datetime, datetime.date, datetime.time, uuid_mod.UUID,
    ) or (isinstance(hint, type) and issubclass(hint, np.generic))


def _scalar_node(name: str, hint, repetition: FRT) -> SchemaNode:
    e = SchemaElement(name=name, repetition_type=int(repetition))
    if hint is bool or (isinstance(hint, type) and issubclass(hint, np.bool_)):
        e.type = int(Type.BOOLEAN)
    elif hint is int or (isinstance(hint, type) and issubclass(hint, np.int64)):
        e.type = int(Type.INT64)
        e.converted_type = int(ConvertedType.INT_64)
        e.logicalType = LogicalType(INTEGER=IntType(bitWidth=64, isSigned=True))
    elif isinstance(hint, type) and issubclass(hint, np.int32):
        e.type = int(Type.INT32)
        e.converted_type = int(ConvertedType.INT_32)
        e.logicalType = LogicalType(INTEGER=IntType(bitWidth=32, isSigned=True))
    elif isinstance(hint, type) and issubclass(hint, (np.uint32, np.uint64)):
        bits = 32 if issubclass(hint, np.uint32) else 64
        e.type = int(Type.INT32 if bits == 32 else Type.INT64)
        e.converted_type = int(ConvertedType[f"UINT_{bits}"])
        e.logicalType = LogicalType(INTEGER=IntType(bitWidth=bits, isSigned=False))
    elif isinstance(hint, type) and issubclass(hint, np.float32):
        e.type = int(Type.FLOAT)
    elif hint is float or (isinstance(hint, type) and issubclass(hint, np.floating)):
        e.type = int(Type.DOUBLE)
    elif hint is str:
        e.type = int(Type.BYTE_ARRAY)
        e.converted_type = int(ConvertedType.UTF8)
        e.logicalType = LogicalType(STRING=StringType())
    elif hint is bytes:
        e.type = int(Type.BYTE_ARRAY)
    elif hint is datetime.datetime:
        e.type = int(Type.INT64)
        e.logicalType = LogicalType(
            TIMESTAMP=TimestampType(isAdjustedToUTC=True, unit=TimeUnit.nanos())
        )
    elif hint is datetime.date:
        e.type = int(Type.INT32)
        e.converted_type = int(ConvertedType.DATE)
        e.logicalType = LogicalType(DATE=DateType())
    elif hint is datetime.time:
        e.type = int(Type.INT64)
        e.logicalType = LogicalType(
            TIME=TimeType(isAdjustedToUTC=True, unit=TimeUnit.nanos())
        )
    elif hint is uuid_mod.UUID:
        e.type = int(Type.FIXED_LEN_BYTE_ARRAY)
        e.type_length = 16
        e.logicalType = LogicalType(UUID=UUIDType())
    elif _decimal is not None and hint is _decimal.Decimal:
        # no precision/scale in the type: use the widest common default
        from ..format import DecimalType

        e.type = int(Type.BYTE_ARRAY)
        e.converted_type = int(ConvertedType.DECIMAL)
        e.precision, e.scale = 38, 18
        e.logicalType = LogicalType(DECIMAL=DecimalType(precision=38, scale=18))
    else:
        raise AutoSchemaError(f"field {name!r}: unsupported type {hint!r}")
    return SchemaNode(e, None)
