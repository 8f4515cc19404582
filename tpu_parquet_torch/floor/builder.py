"""Schema-guided nested row construction/access without defining a class.

The builder-style object API of the reference's floor layer
(floor/interfaces/marshaller.go:7-208 ``MarshalObject``/``MarshalElement``/
``MarshalList``/``MarshalMap``; unmarshaller.go:15-310 for the read side):
programmatic construction and traversal of nested parquet rows guided by the
schema, covering shapes Python dicts alone get wrong — the LIST wrapper
(``{"list": [{"element": v}]}``), its Athena compatibility naming
(``bag``/``array_element``, the marshaller.go:100-109 special case), and the
MAP ``key_value`` pair groups.

Pythonic surface instead of the Go interface pair: ``RowBuilder`` produces
the raw row dict a ``FileWriter.write_row`` expects; ``RowView`` wraps a raw
row from ``FileReader.iter_rows`` with field access that raises
``FieldNotPresent`` (unmarshaller.go's ``ErrFieldNotPresent``) instead of
silently yielding None.

    b = RowBuilder(schema)
    b.field("name").group().field("first").set(b"Hans")
    lst = b.field("tags").list()
    lst.add().set(b"a"); lst.add().set(b"b")
    m = b.field("attrs").map()
    k, v = m.add(); k.set(b"k"); v.set(1)
    writer.write_row(b.data)

    view = RowView(row, schema)
    view.field("name").group().field("first").bytes()   # b"Hans"
    [e.bytes() for e in view.field("tags").list()]
    {k.bytes(): v.int64() for k, v in view.field("attrs").map()}
"""

from __future__ import annotations

from typing import Any, Optional

from ..footer import ParquetError
from ..schema.core import SchemaNode


class FieldNotPresent(ParquetError, KeyError):
    """Requested field is absent from the row (ErrFieldNotPresent parity)."""


def _child(node: Optional[SchemaNode], name: str) -> Optional[SchemaNode]:
    for c in (node.children or ()) if node is not None else ():
        if c.name == name:
            return c
    return None


def _list_names(node: Optional[SchemaNode]) -> tuple[str, str]:
    """(wrapper, element) names for a LIST group under ``node`` — standard
    ``list``/``element`` unless the schema uses the Athena ``bag``/
    ``array_element`` shape (marshaller.go:100-109)."""
    if _child(node, "bag") is not None:
        return "bag", "array_element"
    return "list", "element"


class RowBuilder:
    """Builds the raw nested row dict for ``FileWriter.write_row``."""

    def __init__(self, schema: Optional[SchemaNode] = None,
                 _data: Optional[dict] = None):
        self._node = schema
        self._data = {} if _data is None else _data

    @property
    def data(self) -> dict:
        """The built raw row (live — further field() calls keep mutating)."""
        return self._data

    def field(self, name: str) -> "ElementBuilder":
        return ElementBuilder(self._data, name, _child(self._node, name))


class ElementBuilder:
    def __init__(self, data: dict, name: str, node: Optional[SchemaNode]):
        self._data = data
        self._name = name
        self._node = node

    def set(self, value: Any) -> None:
        """Scalar value (int/float/bool/bytes/str — whatever the writer's
        marshal layer accepts for the leaf)."""
        self._data[self._name] = value

    def group(self) -> RowBuilder:
        obj = self._data.setdefault(self._name, {})
        return RowBuilder(self._node, _data=obj)

    def list(self) -> "ListBuilder":
        wrapper, elem = _list_names(self._node)
        lst = self._data.setdefault(self._name, {}).setdefault(wrapper, [])
        rep = _child(self._node, wrapper)
        return ListBuilder(lst, elem, _child(rep, elem))

    def map(self) -> "MapBuilder":
        pairs = self._data.setdefault(self._name, {}).setdefault(
            "key_value", [])
        return MapBuilder(pairs, _child(self._node, "key_value"))


class ListBuilder:
    def __init__(self, items: list, elem_name: str,
                 node: Optional[SchemaNode]):
        self._items = items
        self._elem = elem_name
        self._node = node

    def add(self) -> ElementBuilder:
        entry: dict = {}
        self._items.append(entry)
        return ElementBuilder(entry, self._elem, self._node)


class MapBuilder:
    def __init__(self, pairs: list, node: Optional[SchemaNode]):
        self._pairs = pairs
        self._node = node

    def add(self) -> tuple[ElementBuilder, ElementBuilder]:
        entry: dict = {}
        self._pairs.append(entry)
        return (ElementBuilder(entry, "key", _child(self._node, "key")),
                ElementBuilder(entry, "value", _child(self._node, "value")))


# ---------------------------------------------------------------------------
# read side (unmarshaller.go parity)
# ---------------------------------------------------------------------------


class RowView:
    """Typed access into a raw row dict from ``FileReader.iter_rows``."""

    def __init__(self, row: dict, schema: Optional[SchemaNode] = None):
        self._row = row
        self._node = schema

    @property
    def data(self) -> dict:
        return self._row

    def field(self, name: str) -> "ElementView":
        if name not in self._row:
            raise FieldNotPresent(name)
        return ElementView(self._row[name], _child(self._node, name), name)


class ElementView:
    def __init__(self, value: Any, node: Optional[SchemaNode], name: str):
        self._v = value
        self._node = node
        self._name = name

    def value(self) -> Any:
        return self._v

    def _typed(self, types, what: str):
        if not isinstance(self._v, types):
            raise ParquetError(
                f"field {self._name!r} is {type(self._v).__name__}, "
                f"not {what}")
        return self._v

    def int32(self) -> int:
        return int(self._typed((int,), "an int"))

    def int64(self) -> int:
        return int(self._typed((int,), "an int"))

    def float32(self) -> float:
        return float(self._typed((int, float), "a float"))

    def float64(self) -> float:
        return float(self._typed((int, float), "a float"))

    def bool(self) -> bool:
        return self._typed((bool,), "a bool")

    def bytes(self) -> bytes:
        v = self._typed((bytes, bytearray, str), "a byte array")
        return v.encode() if isinstance(v, str) else bytes(v)

    def group(self) -> RowView:
        return RowView(self._typed((dict,), "a group"), self._node)

    def list(self):
        """Iterate element views of a LIST field (either naming shape)."""
        d = self._typed((dict,), "a LIST group")
        wrapper, elem = _list_names(self._node)
        if wrapper not in d and "list" in d:
            wrapper, elem = "list", "element"
        items = d.get(wrapper)
        if items is None:
            raise ParquetError(f"field {self._name!r} is not a LIST group")
        rep = _child(self._node, wrapper)
        node = _child(rep, elem)
        for entry in items:
            if elem not in entry:
                raise FieldNotPresent(f"{self._name}.{elem}")
            yield ElementView(entry[elem], node, elem)

    def map(self):
        """Iterate (key_view, value_view) pairs of a MAP field."""
        d = self._typed((dict,), "a MAP group")
        pairs = d.get("key_value")
        if pairs is None:
            raise ParquetError(f"field {self._name!r} is not a MAP group")
        kv = _child(self._node, "key_value")
        kn, vn = _child(kv, "key"), _child(kv, "value")
        for entry in pairs:
            if "key" not in entry:
                raise FieldNotPresent(f"{self._name}.key")
            yield (ElementView(entry["key"], kn, "key"),
                   ElementView(entry.get("value"), vn, "value"))
