"""Schema tree: the Column hierarchy with def/rep level bookkeeping.

Equivalent of the reference's schema.go Column tree: a node per schema element,
max repetition/definition levels computed top-down (recursiveFix, schema.go:667-693),
flat-footer ⇄ tree conversion (readSchema/readColumnSchema/readGroupSchema,
schema.go:893-1015), column selection by path (schema.go:347-367), and the
LIST/MAP-convention constructors (schema.go:582-647).
"""

from __future__ import annotations

from ..errors import ParquetError

from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from ..format import (
    ConvertedType,
    FieldRepetitionType,
    LogicalType,
    SchemaElement,
    Type,
)


class SchemaError(ParquetError):
    pass


@dataclass
class ColumnParameters:
    """Optional typing knobs for a column (ColumnParameters, schema.go parity)."""

    logical_type: Optional[LogicalType] = None
    converted_type: Optional[int] = None
    type_length: Optional[int] = None
    scale: Optional[int] = None
    precision: Optional[int] = None
    field_id: Optional[int] = None


class SchemaNode:
    """One node of the schema tree (reference `Column`, schema.go)."""

    __slots__ = (
        "element",
        "children",
        "parent",
        "max_def",
        "max_rep",
        "path",
        "leaf_index",
    )

    def __init__(self, element: SchemaElement, children: Optional[list] = None):
        self.element = element
        self.children: Optional[list[SchemaNode]] = children
        self.parent: Optional[SchemaNode] = None
        self.max_def = 0
        self.max_rep = 0
        self.path: tuple[str, ...] = ()
        self.leaf_index = -1

    # -- structure ----------------------------------------------------------

    @property
    def name(self) -> str:
        return self.element.name

    @property
    def is_leaf(self) -> bool:
        return self.children is None

    @property
    def repetition(self) -> FieldRepetitionType:
        rt = self.element.repetition_type
        try:
            return FieldRepetitionType(
                rt if rt is not None else FieldRepetitionType.REQUIRED
            )
        except ValueError:
            raise SchemaError(f"invalid repetition type {rt!r}") from None

    @property
    def physical_type(self) -> Optional[Type]:
        t = self.element.type
        if t is None:
            return None
        try:
            return Type(t)
        except ValueError:
            raise SchemaError(f"invalid physical type {t!r}") from None

    @property
    def type_length(self) -> int:
        return self.element.type_length or 0

    @property
    def converted_type(self) -> Optional[ConvertedType]:
        c = self.element.converted_type
        if c is None:
            return None
        try:
            return ConvertedType(c)
        except ValueError:
            raise SchemaError(f"invalid converted type {c!r}") from None

    @property
    def logical_type(self) -> Optional[LogicalType]:
        return self.element.logicalType

    def child(self, name: str) -> Optional["SchemaNode"]:
        if self.children is None:
            return None
        for c in self.children:
            if c.name == name:
                return c
        return None

    def flat_name(self) -> str:
        return ".".join(self.path)

    def __repr__(self):
        kind = (
            self.physical_type.name
            if self.is_leaf and self.physical_type is not None
            else "group"
        )
        return (
            f"SchemaNode({self.flat_name() or self.name!r}, {kind}, "
            f"{self.repetition.name}, maxR={self.max_rep}, maxD={self.max_def})"
        )


class Schema:
    """Schema tree + leaf registry (reference `schema` struct)."""

    def __init__(self, root: SchemaNode):
        self.root = root
        self.leaves: list[SchemaNode] = []
        self._selected: Optional[set[tuple[str, ...]]] = None
        self._fix()

    # -- construction -------------------------------------------------------

    @classmethod
    def from_file_metadata(cls, meta) -> "Schema":
        """Build the tree from the footer's flat element list (makeSchema,
        schema.go:1048-1079 + readSchema recursion)."""
        elems = meta.schema
        if not elems:
            raise SchemaError("empty schema")
        root_elem = elems[0]
        pos = 1

        def read_children(count: int) -> list[SchemaNode]:
            nonlocal pos
            out = []
            for _ in range(count):
                if pos >= len(elems):
                    raise SchemaError("schema element list shorter than num_children")
                e = elems[pos]
                pos += 1
                if not isinstance(e.name, str):
                    # a None/absent name breaks every path join downstream
                    # (readColumnSchema parity: "name is required")
                    raise SchemaError("schema element missing name")
                nc = e.num_children or 0
                if nc > 0:
                    node = SchemaNode(e, read_children(nc))
                else:
                    if e.type is None:
                        raise SchemaError(
                            f"leaf schema element {e.name!r} missing physical type"
                        )
                    node = SchemaNode(e, None)
                out.append(node)
            return out

        children = read_children(root_elem.num_children or 0)
        if pos != len(elems):
            raise SchemaError(
                f"schema has {len(elems) - pos} trailing elements beyond the tree"
            )
        root = SchemaNode(root_elem, children)
        return cls(root)

    def to_flat_elements(self) -> list[SchemaElement]:
        """Flatten back to the footer layout (depth-first preorder)."""
        out: list[SchemaElement] = []

        def visit(node: SchemaNode):
            e = node.element
            e.num_children = len(node.children) if node.children is not None else None
            out.append(e)
            for c in node.children or []:
                visit(c)

        visit(self.root)
        return out

    # -- level bookkeeping (recursiveFix, schema.go:667-693) ----------------

    def _fix(self):
        self.leaves = []

        def visit(node: SchemaNode, max_r: int, max_d: int, path: tuple[str, ...]):
            rep = node.repetition if node is not self.root else FieldRepetitionType.REQUIRED
            if node is not self.root:
                if rep == FieldRepetitionType.OPTIONAL:
                    max_d += 1
                elif rep == FieldRepetitionType.REPEATED:
                    max_d += 1
                    max_r += 1
                path = path + (node.name,)
            node.max_rep = max_r
            node.max_def = max_d
            node.path = path
            if node.is_leaf and node is not self.root:
                node.leaf_index = len(self.leaves)
                self.leaves.append(node)
            for c in node.children or []:
                c.parent = node
                visit(c, max_r, max_d, path)

        visit(self.root, 0, 0, ())

    # -- selection (SetSelectedColumns, schema.go:347-367) -------------------

    def set_selected(self, paths: Optional[Iterable[Sequence[str]]]) -> None:
        """Restrict decoding to the given column paths (None = all).

        A selected path selects the whole subtree under it.
        """
        if paths is None:
            self._selected = None
            return
        self._selected = {tuple(p) for p in paths}

    def is_selected(self, path: Sequence[str]) -> bool:
        if self._selected is None:
            return True
        path = tuple(path)
        for sel in self._selected:
            if path[: len(sel)] == sel or sel[: len(path)] == path:
                return True
        return False

    def selected_leaves(self) -> list[SchemaNode]:
        return [l for l in self.leaves if self.is_selected(l.path)]

    def selection_matches(self, paths) -> bool:
        """Would ``set_selected(paths)`` select at least one leaf?  Lets
        callers validate BEFORE mutating the live selection."""
        sel = {tuple(p) for p in paths}
        return any(
            l.path[: len(s)] == s or s[: len(l.path)] == l.path
            for l in self.leaves for s in sel
        )

    # -- lookup --------------------------------------------------------------

    def leaf_by_path(self, path: Sequence[str]) -> Optional[SchemaNode]:
        path = tuple(path)
        for l in self.leaves:
            if l.path == path:
                return l
        return None

    def node_by_path(self, path: Sequence[str]) -> Optional[SchemaNode]:
        node = self.root
        for part in path:
            node = node.child(part)
            if node is None:
                return None
        return node

    @property
    def num_columns(self) -> int:
        return len(self.leaves)

    def __repr__(self):
        return f"Schema({self.num_columns} leaf columns)"


# ---------------------------------------------------------------------------
# Programmatic constructors (NewDataColumn / NewListColumn / NewMapColumn,
# schema.go:570-647)
# ---------------------------------------------------------------------------

def _apply_params(e: SchemaElement, params: Optional[ColumnParameters]):
    if params is None:
        return
    if params.logical_type is not None:
        e.logicalType = params.logical_type
    if params.converted_type is not None:
        e.converted_type = int(params.converted_type)
    if params.type_length is not None:
        e.type_length = params.type_length
    if params.scale is not None:
        e.scale = params.scale
    if params.precision is not None:
        e.precision = params.precision
    if params.field_id is not None:
        e.field_id = params.field_id


def data_column(
    name: str,
    ptype: Type,
    repetition: FieldRepetitionType = FieldRepetitionType.REQUIRED,
    params: Optional[ColumnParameters] = None,
) -> SchemaNode:
    """A leaf data column (NewDataColumnWithParams semantics)."""
    e = SchemaElement(
        name=name, type=int(ptype), repetition_type=int(repetition)
    )
    _apply_params(e, params)
    if ptype == Type.FIXED_LEN_BYTE_ARRAY and not e.type_length:
        raise SchemaError("FIXED_LEN_BYTE_ARRAY requires type_length in params")
    return SchemaNode(e, None)


def group_column(
    name: str,
    children: list[SchemaNode],
    repetition: FieldRepetitionType = FieldRepetitionType.REQUIRED,
    params: Optional[ColumnParameters] = None,
) -> SchemaNode:
    e = SchemaElement(name=name, repetition_type=int(repetition))
    _apply_params(e, params)
    return SchemaNode(e, list(children))


def list_column(
    name: str,
    element: SchemaNode,
    repetition: FieldRepetitionType = FieldRepetitionType.OPTIONAL,
    params: Optional[ColumnParameters] = None,
) -> SchemaNode:
    """Spec-conventional LIST: <rep> group name (LIST) { repeated group list {
    <element> element } } (NewListColumn, schema.go:582-611)."""
    from ..format import ListType

    if element.name != "element":
        element.element.name = "element"
    lst = SchemaElement(
        name=name,
        repetition_type=int(repetition),
        converted_type=int(ConvertedType.LIST),
        logicalType=LogicalType(LIST=ListType()),
    )
    _apply_params(lst, params)
    inner = SchemaElement(
        name="list", repetition_type=int(FieldRepetitionType.REPEATED)
    )
    return SchemaNode(lst, [SchemaNode(inner, [element])])


def map_column(
    name: str,
    key: SchemaNode,
    value: SchemaNode,
    repetition: FieldRepetitionType = FieldRepetitionType.OPTIONAL,
    params: Optional[ColumnParameters] = None,
) -> SchemaNode:
    """Spec-conventional MAP: <rep> group name (MAP) { repeated group key_value {
    required <key>; <value> } } (NewMapColumn, schema.go:613-647)."""
    from ..format import MapType

    if key.repetition != FieldRepetitionType.REQUIRED:
        raise SchemaError("map key must be REQUIRED")
    key.element.name = "key"
    value.element.name = "value"
    mp = SchemaElement(
        name=name,
        repetition_type=int(repetition),
        converted_type=int(ConvertedType.MAP),
        logicalType=LogicalType(MAP=MapType()),
    )
    _apply_params(mp, params)
    kv = SchemaElement(
        name="key_value",
        repetition_type=int(FieldRepetitionType.REPEATED),
        converted_type=int(ConvertedType.MAP_KEY_VALUE),
    )
    return SchemaNode(mp, [SchemaNode(kv, [key, value])])


def build_schema(columns: list[SchemaNode], root_name: str = "msg") -> Schema:
    """Assemble a Schema from top-level columns."""
    root = SchemaNode(SchemaElement(name=root_name), list(columns))
    return Schema(root)
