"""Logical-view conversion: raw nested rows <-> pythonic values.

The counterpart of ``tpu_parquet.logical``, whole.  The raw row model
(``assembly``) mirrors the physical schema: LIST columns appear as
``{"list": [{"element": v}, ...]}`` and MAP columns as
``{"key_value": [{"key": k, "value": v}, ...]}``, the shape of the Go
reference's row maps, which its floor layer then unwraps (LIST/MAP
traversal, Athena ``bag``/``array_element`` names included).  This module
is that unwrapping for dict rows: LIST -> python list, MAP -> python dict
(a list of pairs when a key is unhashable), under the same structural
conventions.
"""

from __future__ import annotations

from typing import Any, Optional

from .format import ConvertedType
from .schema.core import SchemaNode


def is_string_leaf(leaf: SchemaNode) -> bool:
    """Leaf is logically a UTF-8 string (shared by row assembly and columnar
    pylist conversion so the two APIs can never disagree on str-vs-bytes)."""
    ct = leaf.converted_type
    lt = leaf.logical_type
    return ct in (ConvertedType.UTF8, ConvertedType.ENUM, ConvertedType.JSON) or (
        lt is not None and lt.which() in ("STRING", "ENUM", "JSON")
    )


def _repeated_group_is_element(lst_name: str, rep_group: SchemaNode) -> bool:
    """parquet-format LogicalTypes.md backward-compat rule: inside a LIST group,
    the repeated group is itself the element (2-level list of structs) when it
    has multiple fields, or is named ``array``, or ``<list-name>_tuple``."""
    if rep_group.children is None:
        return False
    if len(rep_group.children) != 1:
        return True
    return rep_group.name == "array" or rep_group.name == f"{lst_name}_tuple"


def _is_list_node(node: SchemaNode) -> bool:
    if node.is_leaf:
        return False
    ct = node.converted_type
    lt = node.logical_type
    return ct == ConvertedType.LIST or (lt is not None and lt.which() == "LIST")


def _is_map_node(node: SchemaNode) -> bool:
    if node.is_leaf:
        return False
    ct = node.converted_type
    lt = node.logical_type
    return ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE) or (
        lt is not None and lt.which() == "MAP"
    )


def unwrap_value(node: SchemaNode, value: Any) -> Any:
    """Convert one raw value for schema node into its logical python form."""
    if value is None:
        return None
    if node.is_leaf:
        return value
    if _is_list_node(node) and node.children:
        rep_group = node.children[0]
        if rep_group.is_leaf:
            # 2-level legacy list: repeated primitive directly
            return [unwrap_value(rep_group, v) for v in value.get(rep_group.name, [])]
        items = value.get(rep_group.name)
        if items is None:
            return []
        if _repeated_group_is_element(node.name, rep_group):
            # legacy 2-level list of structs: the repeated group IS the element
            return [unwrap_group(rep_group, item) for item in items]
        elem = rep_group.children[0]
        return [
            unwrap_value(elem, item.get(elem.name)) if isinstance(item, dict) else item
            for item in items
        ]
    if _is_map_node(node) and node.children:
        if isinstance(value, list):
            # legacy layout: MAP_KEY_VALUE annotates the repeated group itself;
            # `value` is already the list of {key,value} items
            return _pairs_to_map(node, value)
        kv = node.children[0]
        items = value.get(kv.name)
        if items is None:
            return {}
        return _pairs_to_map(kv, items)
    if isinstance(value, list):
        # plain repeated group/leaf (no LIST annotation)
        return [unwrap_group(node, v) if isinstance(v, dict) else v for v in value]
    return unwrap_group(node, value)


def _pairs_to_map(kv_node: SchemaNode, items: list):
    """{key,value} item dicts → python dict, or list of pairs when a key is
    unhashable (e.g. group-typed keys that unwrap to dicts)."""
    key_node = kv_node.child("key") if not kv_node.is_leaf else None
    val_node = kv_node.child("value") if not kv_node.is_leaf else None
    pairs = []
    for item in items:
        k = unwrap_value(key_node, item.get("key")) if key_node else item.get("key")
        v = unwrap_value(val_node, item.get("value")) if val_node else item.get("value")
        pairs.append((k, v))
    try:
        return dict(pairs)
    except TypeError:
        return pairs


def unwrap_group(node: SchemaNode, value: dict) -> dict:
    if not isinstance(value, dict):
        return value
    out = {}
    for child in node.children or []:
        if child.name in value:
            out[child.name] = unwrap_value(child, value[child.name])
    return out


def unwrap_row(schema, row: dict) -> dict:
    """Logical view of one raw row (schema is a tpu_parquet.schema.Schema)."""
    return unwrap_group(schema.root, row)
