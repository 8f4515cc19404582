"""Schema layer: tree model, definition-language parser, validation, autoschema."""

from .core import (
    ColumnParameters,
    Schema,
    SchemaNode,
    SchemaError,
    data_column,
    group_column,
    list_column,
    map_column,
)

__all__ = [
    "Schema",
    "SchemaNode",
    "SchemaError",
    "ColumnParameters",
    "data_column",
    "group_column",
    "list_column",
    "map_column",
]
