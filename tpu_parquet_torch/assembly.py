"""Dremel record assembly: columnar (values + def/rep levels) -> nested rows.

The counterpart of ``tpu_parquet.assembly``, whole; the read-side record
assembly of the Go reference (schema.go:216-312 getData/getNextData,
data_store.go:262-309 ColumnStore.get) walks one value at a time.  Here
records are assembled from whole decoded column chunks:

- flat schemas (no repeated fields) take a vectorized path;
- nested schemas use a recursive span-splitting assembler over the schema
  tree, driven by the level semantics: a slot's definition level is the
  depth of the deepest present optional/repeated node on the path, and its
  repetition level r means "this slot starts a new element of the depth-r
  repeated list" (r=0 starts a new record).

Rows are plain dicts mirroring the schema: groups -> dicts, repeated nodes
-> lists, null optionals -> None (present in the dict, where the Go
reference omits nil keys).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .column import ByteArrayData, ColumnData
from .footer import ParquetError
from .format import FieldRepetitionType
from .logical import is_string_leaf
from .schema.core import Schema, SchemaNode


def materialize_leaf_values(leaf: SchemaNode, cd: ColumnData, lo: int = 0,
                            hi: Optional[int] = None) -> list:
    """Python values for the defined slots in value-index window [lo, hi).

    The single canonical values→pylist conversion (UTF-8 decode for string
    leaves), shared by row assembly and the reader's columnar pylist API.
    """
    if isinstance(cd.values, ByteArrayData):
        ba = cd.values
        n = len(ba)
        hi = n if hi is None else hi
        if lo >= hi:
            return []
        base = int(ba.offsets[lo])
        heap = ba.heap[base : int(ba.offsets[hi])].tobytes()  # window only
        off = ba.offsets
        vals = [heap[off[i] - base : off[i + 1] - base] for i in range(lo, hi)]
        if is_string_leaf(leaf):
            vals = [v.decode("utf-8", errors="replace") for v in vals]
        return vals
    arr = cd.values[lo:] if hi is None else cd.values[lo:hi]
    return arr.tolist()


class _LeafState:
    """Per-leaf decoded arrays + lazily-windowed python-value materialization."""

    __slots__ = ("leaf", "cd", "defs", "reps", "vals", "val_idx", "record_starts",
                 "_val_base")

    def __init__(self, leaf: SchemaNode, cd: ColumnData):
        self.leaf = leaf
        self.cd = cd
        n = cd.num_leaf_slots
        self.defs = (
            cd.def_levels
            if cd.def_levels is not None
            else np.full(n, cd.max_def, dtype=np.int32)
        )
        self.reps = (
            cd.rep_levels
            if cd.rep_levels is not None
            else np.zeros(n, dtype=np.int32)
        )
        self.vals: Optional[list] = None
        self._val_base = 0
        # slot -> index into the full defined-value sequence
        defined = self.defs == cd.max_def
        self.val_idx = np.cumsum(defined) - 1
        self.record_starts = np.flatnonzero(self.reps == 0)

    def materialize(self, slot_lo: int, slot_hi: int) -> None:
        """Convert only the defined values inside the slot window to python."""
        vlo = int(self.val_idx[slot_lo - 1]) + 1 if slot_lo > 0 else 0
        vhi = int(self.val_idx[slot_hi - 1]) + 1 if slot_hi > 0 else 0
        self._val_base = vlo
        self.vals = materialize_leaf_values(self.leaf, self.cd, vlo, vhi)

    def value_at(self, slot: int):
        return self.vals[int(self.val_idx[slot]) - self._val_base]


def assemble_rows(
    schema: Schema,
    columns: dict[str, ColumnData],
    start: int = 0,
    count: Optional[int] = None,
) -> list[dict]:
    """Assemble rows [start, start+count) of one row group's decoded columns."""
    leaves = [l for l in schema.selected_leaves() if ".".join(l.path) in columns]
    if not leaves:
        return []
    states = {l.path: _LeafState(l, columns[".".join(l.path)]) for l in leaves}

    nrecords = len(next(iter(states.values())).record_starts)
    for path, st in states.items():
        if len(st.record_starts) != nrecords:
            raise ParquetError(
                f"column {'.'.join(path)} has {len(st.record_starts)} records, "
                f"expected {nrecords}"
            )
    if count is None:
        count = nrecords - start
    end = min(start + count, nrecords)
    if start < 0 or start > nrecords:
        raise IndexError(f"record {start} of {nrecords}")

    # materialize python values only for the requested record window
    for st in states.values():
        slot_lo = int(st.record_starts[start]) if start < nrecords else len(st.defs)
        slot_hi = int(st.record_starts[end]) if end < nrecords else len(st.defs)
        st.materialize(slot_lo, slot_hi)

    if all(l.max_rep == 0 and len(l.path) == 1 for l in leaves):
        return _assemble_flat(schema, leaves, states, start, end)

    rows = []
    for rec in range(start, end):
        spans = {}
        for path, st in states.items():
            s = int(st.record_starts[rec])
            e = (
                int(st.record_starts[rec + 1])
                if rec + 1 < nrecords
                else len(st.defs)
            )
            spans[path] = (s, e)
        rows.append(_assemble_group(schema.root, states, spans, is_root=True))
    return rows


def _assemble_flat(schema, leaves, states, start, end):
    """Vectorized path: every column is a top-level scalar."""
    cols = {}
    for l in leaves:
        st = states[l.path]
        name = l.path[0]
        if st.cd.def_levels is None:
            cols[name] = st.vals[start - st._val_base : end - st._val_base]
        else:
            defined = st.defs == st.cd.max_def
            out = [None] * (end - start)
            for i in range(start, end):
                if defined[i]:
                    out[i - start] = st.value_at(i)
            cols[name] = out
    names = [l.path[0] for l in leaves]
    return [
        {name: cols[name][i] for name in names} for i in range(end - start)
    ]


def _first_def(states, spans, node) -> int:
    """Definition level of the first slot of this node instance."""
    for path, (s, _e) in spans.items():
        if path[: len(node.path)] == node.path:
            return int(states[path].defs[s])
    raise ParquetError(f"no leaf spans under {'.'.join(node.path)}")


def _assemble_node(node: SchemaNode, states, spans):
    """Assemble one schema node given leaf spans covering one parent instance."""
    rep = node.repetition
    if rep == FieldRepetitionType.REPEATED:
        if _first_def(states, spans, node) < node.max_def:
            return []  # zero elements
        # split each leaf's span at slots where rep == node.max_rep
        k = node.max_rep
        elements = None
        split_spans: list[dict] = []
        for path, (s, e) in spans.items():
            if path[: len(node.path)] != node.path:
                continue
            reps = states[path].reps
            bounds = [s] + [
                int(i) for i in range(s + 1, e) if reps[i] == k
            ] + [e]
            segs = list(zip(bounds[:-1], bounds[1:]))
            if elements is None:
                elements = len(segs)
                split_spans = [dict() for _ in range(elements)]
            elif len(segs) != elements:
                raise ParquetError(
                    f"repeated group {'.'.join(node.path)}: sibling columns "
                    f"disagree on element count ({len(segs)} vs {elements})"
                )
            for i, seg in enumerate(segs):
                split_spans[i][path] = seg
        return [_instance_value(node, states, sp) for sp in split_spans]
    if rep == FieldRepetitionType.OPTIONAL:
        if _first_def(states, spans, node) < node.max_def:
            return None
    return _instance_value(node, states, spans)


def _instance_value(node: SchemaNode, states, spans):
    """Value of one present instance of node (scalar or dict of children)."""
    if node.is_leaf:
        (path, (s, _e)) = next(
            (p, sp) for p, sp in spans.items() if p == node.path
        )
        st = states[path]
        return st.value_at(s)
    return _assemble_group(node, states, spans, is_root=False)


def _assemble_group(node: SchemaNode, states, spans, is_root: bool):
    out = {}
    for child in node.children or []:
        child_spans = {
            p: sp for p, sp in spans.items() if p[: len(child.path)] == child.path
        }
        if not child_spans:
            continue  # unselected subtree
        out[child.name] = _assemble_node(child, states, child_spans)
    return out


class RowIterator:
    """Row-at-a-time cursor over a FileReader (NextRow parity,
    file_reader.go:258-273 + advanceIfNeeded): starts from the reader's
    current row-group cursor (so seek_to_row_group/skip_row_group are
    honored), skips the groups ``row_filter`` pruned, consumes the preload
    cache when it matches, and never mutates the reader's cursor itself."""

    def __init__(self, reader):
        self.reader = reader
        self._rows: list[dict] = []
        self._pos = 0
        self._group = reader._current_row_group

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while self._pos >= len(self._rows):
            if self._group >= self.reader.num_row_groups:
                raise StopIteration
            if not self.reader.row_group_selected(self._group):
                self._group += 1  # pruned by row_filter: skip without IO
                continue
            if (
                self.reader._current_row_group == self._group
                and self.reader._preloaded is not None
            ):
                cols = self.reader._preloaded
            else:
                cols = self.reader.read_row_group(self._group)
            self._rows = assemble_rows(self.reader.schema, cols)
            self._pos = 0
            self._group += 1
        row = self._rows[self._pos]
        self._pos += 1
        return row
