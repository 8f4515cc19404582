"""Record shredding: nested rows → per-leaf (values, def levels, rep levels).

Write-side Dremel, the inverse of assembly.py.  Equivalent of the reference's
recursiveAddColumnData/recursiveAddColumnNil (schema.go:837-891) + ColumnStore.add
(data_store.go:96-136), which walk one row at a time through interface dispatch;
here a row is shredded in one tree walk appending to per-leaf accumulators, and a
columnar fast path accepts whole arrays + validity masks without any per-row work.
"""

from __future__ import annotations

import datetime
from typing import Any, Optional

import numpy as np

from .column import ByteArrayData, ColumnData
from .footer import ParquetError
from .format import FieldRepetitionType as FRT, Type
from .schema.core import Schema, SchemaNode


class ShredError(ParquetError):
    pass


class LeafBuilder:
    """Accumulates one leaf column's slots across rows until a flush."""

    __slots__ = ("leaf", "values", "defs", "reps", "num_slots", "est_bytes")

    def __init__(self, leaf: SchemaNode):
        self.leaf = leaf
        self.values: list = []
        self.defs: list[int] = []
        self.reps: list[int] = []
        self.num_slots = 0
        self.est_bytes = 0

    def add_slot(self, d: int, r: int, value=None, present: bool = False):
        self.defs.append(d)
        self.reps.append(r)
        self.num_slots += 1
        if present:
            self.values.append(value)
            self.est_bytes += _value_size(self.leaf, value)
        self.est_bytes += 1  # levels

    def to_column_data(self) -> ColumnData:
        leaf = self.leaf
        vals = _coerce_values(self.values, leaf)
        defs = (
            np.asarray(self.defs, dtype=np.int32) if leaf.max_def > 0 else None
        )
        reps = (
            np.asarray(self.reps, dtype=np.int32) if leaf.max_rep > 0 else None
        )
        return ColumnData(
            values=vals,
            def_levels=defs,
            rep_levels=reps,
            max_def=leaf.max_def,
            max_rep=leaf.max_rep,
            num_leaf_slots=self.num_slots,
        )

    def reset(self):
        self.values = []
        self.defs = []
        self.reps = []
        self.num_slots = 0
        self.est_bytes = 0


def _value_size(leaf: SchemaNode, v) -> int:
    t = leaf.physical_type
    if t in (Type.INT32, Type.FLOAT):
        return 4
    if t in (Type.INT64, Type.DOUBLE):
        return 8
    if t == Type.INT96:
        return 12
    if t == Type.BOOLEAN:
        return 1
    try:
        return len(v) + 4
    except TypeError:
        return 8


def _coerce_leaf_value(v: Any, leaf: SchemaNode):
    """Validate/coerce one python value for a leaf (typedColumnStore.getValues
    parity — type errors raise rather than silently mangle)."""
    t = leaf.physical_type
    if t == Type.BOOLEAN:
        if not isinstance(v, (bool, np.bool_)):
            raise ShredError(f"column {leaf.flat_name()}: expected bool, got {type(v).__name__}")
        return bool(v)
    if t in (Type.INT32, Type.INT64):
        if isinstance(v, bool) or not isinstance(v, (int, np.integer)):
            raise ShredError(f"column {leaf.flat_name()}: expected int, got {type(v).__name__}")
        v = int(v)
        lim = 31 if t == Type.INT32 else 63
        if not -(1 << lim) <= v < (1 << lim):
            raise ShredError(f"column {leaf.flat_name()}: {v} out of {t.name} range")
        return v
    if t in (Type.FLOAT, Type.DOUBLE):
        if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            return float(v)
        if not isinstance(v, (float, np.floating)):
            raise ShredError(f"column {leaf.flat_name()}: expected float, got {type(v).__name__}")
        return float(v)
    if t == Type.INT96:
        if isinstance(v, (bytes, bytearray)) and len(v) == 12:
            return np.frombuffer(bytes(v), "<u4")
        arr = np.asarray(v)
        if arr.shape == (3,):
            return arr.astype("<u4")
        raise ShredError(f"column {leaf.flat_name()}: INT96 needs 12 bytes")
    if t in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        if isinstance(v, str):
            v = v.encode("utf-8")
        elif isinstance(v, (bytes, bytearray, np.bytes_)):
            v = bytes(v)
        else:
            raise ShredError(
                f"column {leaf.flat_name()}: expected bytes/str, got {type(v).__name__}"
            )
        tl = leaf.type_length
        if t == Type.FIXED_LEN_BYTE_ARRAY and tl and len(v) != tl:
            raise ShredError(
                f"column {leaf.flat_name()}: FIXED[{tl}] got {len(v)} bytes"
            )
        return v
    raise ShredError(f"column {leaf.flat_name()}: unsupported type {t!r}")


def _coerce_values(vals: list, leaf: SchemaNode):
    t = leaf.physical_type
    if t == Type.INT32:
        return np.asarray(vals, dtype=np.int32)
    if t == Type.INT64:
        return np.asarray(vals, dtype=np.int64)
    if t == Type.FLOAT:
        return np.asarray(vals, dtype=np.float32)
    if t == Type.DOUBLE:
        return np.asarray(vals, dtype=np.float64)
    if t == Type.BOOLEAN:
        return np.asarray(vals, dtype=bool)
    if t == Type.INT96:
        if not vals:
            return np.zeros((0, 3), dtype="<u4")
        return np.stack(vals).astype("<u4")
    return ByteArrayData.from_list(vals)


class Shredder:
    """Shreds dict rows (raw physical shape) into per-leaf accumulators."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.leaf_data = {l.path: LeafBuilder(l) for l in schema.leaves}
        self.num_rows = 0

    @property
    def est_bytes(self) -> int:
        return sum(b.est_bytes for b in self.leaf_data.values())

    def add_row(self, row: dict) -> None:
        if not isinstance(row, dict):
            raise ShredError(f"row must be a dict, got {type(row).__name__}")
        self._shred_group(self.schema.root, row, 0, 0)
        self.num_rows += 1

    def _emit_empty(self, node: SchemaNode, d: int, r: int) -> None:
        """One null/absent slot for every leaf beneath node."""
        if node.is_leaf:
            self.leaf_data[node.path].add_slot(d, r)
            return
        for c in node.children or []:
            self._emit_empty(c, d, r)

    def _shred_group(self, node: SchemaNode, value: dict, d: int, r: int) -> None:
        for child in node.children or []:
            v = value.get(child.name) if isinstance(value, dict) else None
            self._shred_node(child, v, d, r)

    def _shred_node(self, node: SchemaNode, value: Any, d: int, r: int) -> None:
        rep = node.repetition
        if rep == FRT.REPEATED:
            items = self._normalize_repeated(node, value)
            if not items:
                self._emit_empty(node, d, r)
                return
            for i, item in enumerate(items):
                ri = r if i == 0 else node.max_rep
                self._shred_instance(node, item, node.max_def, ri)
            return
        if value is None:
            if rep == FRT.REQUIRED:
                raise ShredError(
                    f"required column {node.flat_name() or node.name} is missing"
                )
            self._emit_empty(node, d, r)
            return
        nd = node.max_def if rep == FRT.OPTIONAL else d
        self._shred_instance(node, value, nd, r)

    def _shred_instance(self, node: SchemaNode, value: Any, d: int, r: int) -> None:
        if node.is_leaf:
            if value is None:
                # only reachable for a None element of a repeated leaf — the
                # format has no encoding for that (repeated == present)
                raise ShredError(
                    f"repeated column {node.flat_name()}: elements cannot be None"
                )
            cv = _coerce_leaf_value(value, node)
            self.leaf_data[node.path].add_slot(d, r, cv, present=True)
            return
        if not isinstance(value, dict):
            raise ShredError(
                f"group {node.flat_name()}: expected dict, got {type(value).__name__}"
            )
        self._shred_group(node, value, d, r)

    def _normalize_repeated(self, node: SchemaNode, value: Any) -> list:
        if value is None:
            return []
        if isinstance(value, list):
            return value
        if isinstance(value, np.ndarray):
            return value.tolist()
        raise ShredError(
            f"repeated column {node.flat_name()}: expected list, got {type(value).__name__}"
        )

    # -- output ---------------------------------------------------------------

    def harvest(self) -> tuple[dict[str, ColumnData], int]:
        """Returns (columns, row_count) and resets the accumulators."""
        out = {
            ".".join(path): b.to_column_data()
            for path, b in self.leaf_data.items()
        }
        for b in self.leaf_data.values():
            b.reset()
        n = self.num_rows
        self.num_rows = 0
        return out, n
