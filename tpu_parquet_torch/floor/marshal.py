"""Logical-type value conversion for the high-level object API.

Equivalent of the conversion logic inside the reference's floor reflection
marshaller/unmarshaller (floor/writer.go:81-454 decodeValue/decodeMap/...,
floor/reader.go:120-448 fillValue/fillMap/...): python-typed values
(datetime, date, time, uuid.UUID, Decimal, str) ⇄ physical parquet values,
driven by each leaf's logical/converted type annotations.
"""

from __future__ import annotations

import datetime
import decimal
import functools
import uuid as uuid_mod
from typing import Any, Callable, Optional

from ..footer import ParquetError
from ..format import ConvertedType, Type
from ..int96 import datetime_to_int96, int96_to_datetime
from ..schema.core import SchemaNode
from .time import Time, parse_iso_datetime

_EPOCH_DATE = datetime.date(1970, 1, 1)
_UTC = datetime.timezone.utc
_EPOCH_DT = datetime.datetime(1970, 1, 1, tzinfo=_UTC)


def _datetime_to_epoch_ns(v: datetime.datetime) -> int:
    """Exact integer epoch-nanoseconds (timedelta arithmetic — no float
    truncation, correct for pre-epoch times)."""
    if v.tzinfo is None:
        v = v.replace(tzinfo=_UTC)
    delta = v - _EPOCH_DT
    return (delta.days * 86_400 + delta.seconds) * 1_000_000_000 + delta.microseconds * 1000


class MarshalError(ParquetError):
    pass


def _ts_unit_ns(leaf: SchemaNode) -> Optional[int]:
    """ns per tick for TIMESTAMP leaves, None if not a timestamp."""
    lt = leaf.logical_type
    if lt is not None and lt.TIMESTAMP is not None:
        u = lt.TIMESTAMP.unit.which()
        return {"MILLIS": 1_000_000, "MICROS": 1_000, "NANOS": 1}[u]
    conv = leaf.converted_type
    if conv == ConvertedType.TIMESTAMP_MILLIS:
        return 1_000_000
    if conv == ConvertedType.TIMESTAMP_MICROS:
        return 1_000
    return None


def _time_unit_ns(leaf: SchemaNode) -> Optional[int]:
    lt = leaf.logical_type
    if lt is not None and lt.TIME is not None:
        u = lt.TIME.unit.which()
        return {"MILLIS": 1_000_000, "MICROS": 1_000, "NANOS": 1}[u]
    conv = leaf.converted_type
    if conv == ConvertedType.TIME_MILLIS:
        return 1_000_000
    if conv == ConvertedType.TIME_MICROS:
        return 1_000
    return None


def _is_utc(leaf: SchemaNode, which: str) -> bool:
    lt = leaf.logical_type
    if lt is None:
        return True
    member = getattr(lt, which, None)
    return bool(member.isAdjustedToUTC) if member is not None else True


def _is_date(leaf) -> bool:
    lt = leaf.logical_type
    return (lt is not None and lt.DATE is not None) or (
        leaf.converted_type == ConvertedType.DATE
    )


def _is_uuid(leaf) -> bool:
    lt = leaf.logical_type
    return lt is not None and lt.UUID is not None


def _is_decimal(leaf) -> bool:
    lt = leaf.logical_type
    return (lt is not None and lt.DECIMAL is not None) or (
        leaf.converted_type == ConvertedType.DECIMAL
    )


def _decimal_scale(leaf) -> int:
    lt = leaf.logical_type
    if lt is not None and lt.DECIMAL is not None:
        return lt.DECIMAL.scale or 0
    return leaf.element.scale or 0


# ---------------------------------------------------------------------------
# python → physical (write side)
# ---------------------------------------------------------------------------

def _parse_time_string(v: str) -> datetime.datetime:
    """Best-effort string → datetime (floor/writer.go:256 dateparse.ParseAny
    parity, scoped to ISO-8601 and unix-time digit strings)."""
    s = v.strip()
    try:
        body = s[1:] if s.startswith("-") else s
        if body.isdigit():
            return _unix_heuristic_dt(int(s))
        dt = parse_iso_datetime(s)
    except (ValueError, MarshalError) as e:
        raise MarshalError(f"cannot parse {v!r} as a timestamp") from e
    return dt if dt.tzinfo else dt.replace(tzinfo=_UTC)


@functools.lru_cache(maxsize=1)
def _unix_digit_refs() -> tuple:
    """Digit counts of 'now' per unit, cached per process (the counts next
    change in 2033 — per-value now() calls would dominate bulk writes)."""
    now_s = int(datetime.datetime.now(tz=_UTC).timestamp())
    return tuple(
        (ns_per_tick, len(str(now_s * mult)))
        for ns_per_tick, mult in (
            (1_000_000_000, 1), (1_000_000, 1_000),
            (1_000, 1_000_000), (1, 1_000_000_000),
        )
    )


def _unix_heuristic_dt(i: int) -> datetime.datetime:
    """Digit-count unix-time interpretation — seconds, then millis, micros,
    nanos.  Exact decodeUnixTime parity (floor/writer.go:317-340): the
    reference compares DIGIT COUNTS against now's per-unit digit counts
    ('since 99% of the time these are timestamps and are <= now this is a
    fairly safe bet' — its words), not magnitudes."""
    digits = len(str(abs(i))) if i else 1
    for ns_per_tick, ref_digits in _unix_digit_refs():
        if digits <= ref_digits:
            return _EPOCH_DT + datetime.timedelta(
                microseconds=i * ns_per_tick // 1_000
            )
    raise MarshalError(f"INT96 value {i} is not a plausible unix time")


def to_physical(leaf: SchemaNode, v: Any) -> Any:
    if v is None:
        return None
    t = leaf.physical_type

    unit = _ts_unit_ns(leaf)
    if unit is not None and isinstance(v, str):
        v = _parse_time_string(v)
    if unit is not None and isinstance(v, datetime.datetime):
        return _datetime_to_epoch_ns(v) // unit
    if t == Type.INT96:
        if isinstance(v, str):
            v = _parse_time_string(v)
        elif isinstance(v, int) and not isinstance(v, bool):
            v = _unix_heuristic_dt(v)
        if isinstance(v, datetime.datetime):
            return datetime_to_int96(v)
    if _is_date(leaf) and isinstance(v, datetime.date) and not isinstance(
        v, datetime.datetime
    ):
        return (v - _EPOCH_DATE).days
    tunit = _time_unit_ns(leaf)
    if tunit is not None:
        if isinstance(v, datetime.time):
            v = Time.from_datetime_time(v)
        if isinstance(v, Time):
            return v.nanoseconds // tunit
    if _is_uuid(leaf):
        if isinstance(v, uuid_mod.UUID):
            return v.bytes
        if isinstance(v, (bytes, bytearray)) and len(v) == 16:
            return bytes(v)
        raise MarshalError(f"column {leaf.flat_name()}: UUID needs uuid or 16 bytes")
    if _is_decimal(leaf) and isinstance(v, decimal.Decimal):
        scale = _decimal_scale(leaf)
        unscaled = int(v.scaleb(scale).to_integral_value(decimal.ROUND_HALF_EVEN))
        if t in (Type.INT32, Type.INT64):
            return unscaled
        if t in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
            length = leaf.type_length if t == Type.FIXED_LEN_BYTE_ARRAY else max(
                (unscaled.bit_length() + 8) // 8, 1
            )
            return unscaled.to_bytes(length, "big", signed=True)
    return v


# ---------------------------------------------------------------------------
# physical → python (read side)
# ---------------------------------------------------------------------------

def from_physical(leaf: SchemaNode, v: Any) -> Any:
    if v is None:
        return None
    t = leaf.physical_type

    unit = _ts_unit_ns(leaf)
    if unit is not None and isinstance(v, int):
        ns = v * unit
        dt = datetime.datetime.fromtimestamp(ns // 1_000_000_000, tz=_UTC)
        dt = dt.replace(microsecond=(ns // 1000) % 1_000_000)
        if not _is_utc(leaf, "TIMESTAMP"):
            dt = dt.replace(tzinfo=None)
        return dt
    if t == Type.INT96:
        if isinstance(v, (bytes, bytearray)):
            return int96_to_datetime(v)
        if isinstance(v, (list, tuple)) and len(v) == 3:
            # row assembly materializes INT96 as [lo, hi, julian_day] uint32s
            return int96_to_datetime(
                b"".join(int(x).to_bytes(4, "little") for x in v)
            )
    if _is_date(leaf) and isinstance(v, int):
        return _EPOCH_DATE + datetime.timedelta(days=v)
    tunit = _time_unit_ns(leaf)
    if tunit is not None and isinstance(v, int):
        return Time(v * tunit, utc=_is_utc(leaf, "TIME"))
    if _is_uuid(leaf) and isinstance(v, (bytes, bytearray)):
        return uuid_mod.UUID(bytes=bytes(v))
    if _is_decimal(leaf):
        scale = _decimal_scale(leaf)
        if isinstance(v, int):
            return decimal.Decimal(v).scaleb(-scale)
        if isinstance(v, (bytes, bytearray)):
            unscaled = int.from_bytes(bytes(v), "big", signed=True)
            return decimal.Decimal(unscaled).scaleb(-scale)
    return v


# ---------------------------------------------------------------------------
# recursive row conversion along the schema (logical shapes)
# ---------------------------------------------------------------------------

def convert_row(node: SchemaNode, row: dict, fn: Callable) -> dict:
    """Apply fn(leaf, value) to every leaf of a logical-shape row."""
    out = {}
    for child in node.children or []:
        name = child.name
        if not isinstance(row, dict) or name not in row:
            continue
        out[name] = _convert_value(child, row[name], fn)
    return out


def _convert_value(node: SchemaNode, v: Any, fn: Callable) -> Any:
    if v is None:
        return None
    from ..logical import _is_list_node, _is_map_node

    if node.is_leaf:
        return fn(node, v)
    if _is_list_node(node) and isinstance(v, list) and node.children:
        from ..logical import _repeated_group_is_element

        rep = node.children[0]
        if not rep.is_leaf and _repeated_group_is_element(node.name, rep):
            # legacy 2-level list: the repeated group IS the element struct
            return [_convert_value_instance(rep, item, fn) for item in v]
        elem = rep.children[0] if (not rep.is_leaf and rep.children) else rep
        return [_convert_value(elem, item, fn) for item in v]
    if _is_map_node(node) and isinstance(v, dict) and node.children:
        kv = node.children[0]
        key_node = kv.child("key") if not kv.is_leaf else None
        val_node = kv.child("value") if not kv.is_leaf else None
        return {
            (_convert_value(key_node, k, fn) if key_node else k):
            (_convert_value(val_node, w, fn) if val_node else w)
            for k, w in v.items()
        }
    if node.repetition.name == "REPEATED" and isinstance(v, list):
        return [_convert_value_instance(node, item, fn) for item in v]
    return _convert_value_instance(node, v, fn)


def _convert_value_instance(node: SchemaNode, v: Any, fn: Callable) -> Any:
    if node.is_leaf:
        return fn(node, v)
    if isinstance(v, dict):
        return convert_row(node, v, fn)
    return v
