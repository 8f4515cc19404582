"""Schema validation: structural conventions + logical-type parameter checks.

Equivalent of the reference's Validate/ValidateStrict (schema_parser.go:724-1053):
LIST/MAP structural rules (with the Athena/Hive backward-compat shapes allowed in
lenient mode: ``bag``/``array_element`` naming, missing MAP value), DECIMAL
precision/scale vs physical type, INT bit widths, UUID/INTERVAL fixed lengths,
TIME/TIMESTAMP unit consistency, ENUM/JSON/UTF8 on binary only.
"""

from __future__ import annotations

from ..format import ConvertedType, FieldRepetitionType as FRT, Type
from .core import Schema, SchemaError, SchemaNode


class SchemaValidationError(SchemaError):
    pass


def validate(schema: Schema, strict: bool = False) -> None:
    """Raises SchemaValidationError on violations.  ``strict`` enforces the
    spec's exact LIST/MAP member naming (ValidateStrict parity); lenient mode
    accepts the compatibility shapes the reference tolerates."""
    root = schema.root
    if not root.children:
        raise SchemaValidationError("schema has no columns")
    for child in root.children:
        _validate_node(child, strict)


def validate_strict(schema: Schema) -> None:
    validate(schema, strict=True)


def _err(node: SchemaNode, msg: str) -> SchemaValidationError:
    return SchemaValidationError(f"column {node.flat_name() or node.name!r}: {msg}")


def _conv(node: SchemaNode):
    return node.converted_type


def _logical_which(node: SchemaNode):
    lt = node.logical_type
    return lt.which() if lt is not None else None


def _validate_node(node: SchemaNode, strict: bool) -> None:
    conv = _conv(node)
    which = _logical_which(node)

    if node.is_leaf:
        _validate_leaf(node, strict)
        return

    if conv == ConvertedType.LIST or which == "LIST":
        _validate_list(node, strict)
    elif conv == ConvertedType.MAP or which == "MAP":
        _validate_map(node, strict)
    for c in node.children or []:
        _validate_node(c, strict)


def _validate_list(node: SchemaNode, strict: bool) -> None:
    # spec: <rep> group name (LIST) { repeated group list { <element> } }
    if node.repetition == FRT.REPEATED:
        raise _err(node, "LIST group must not be repeated")
    if not node.children or len(node.children) != 1:
        raise _err(node, "LIST group must have exactly one child")
    rep_group = node.children[0]
    if rep_group.repetition != FRT.REPEATED:
        raise _err(node, "LIST child must be repeated")
    if strict:
        if rep_group.name != "list":
            raise _err(node, f"LIST child must be named 'list', got {rep_group.name!r}")
        if rep_group.is_leaf or len(rep_group.children) != 1:
            raise _err(node, "LIST repeated group must have exactly one child")
        if rep_group.children[0].name != "element":
            raise _err(
                node,
                f"LIST element must be named 'element', got {rep_group.children[0].name!r}",
            )
    else:
        # lenient: allow 2-level lists (repeated leaf/struct directly) and the
        # Athena 'bag'/'array_element' names (validateListLogicalType parity)
        if not rep_group.is_leaf and rep_group.children is not None and len(rep_group.children) == 0:
            raise _err(node, "LIST repeated group has no children")


def _validate_map(node: SchemaNode, strict: bool) -> None:
    # spec: <rep> group name (MAP) { repeated group key_value { key; value } }
    if node.repetition == FRT.REPEATED:
        raise _err(node, "MAP group must not be repeated")
    if not node.children or len(node.children) != 1:
        raise _err(node, "MAP group must have exactly one child")
    kv = node.children[0]
    if kv.repetition != FRT.REPEATED:
        raise _err(node, "MAP child must be repeated")
    if kv.is_leaf:
        raise _err(node, "MAP repeated child must be a group")
    names = [c.name for c in kv.children]
    if strict:
        if kv.name != "key_value":
            raise _err(node, f"MAP child must be named 'key_value', got {kv.name!r}")
        if names != ["key", "value"]:
            raise _err(node, f"MAP key_value must have key, value; got {names}")
    else:
        if "key" not in names:
            raise _err(node, "MAP key_value group is missing 'key'")
        if len(names) > 2:
            raise _err(node, f"MAP key_value has extra fields {names}")
    key = kv.child("key")
    if key is not None and key.repetition != FRT.REQUIRED:
        raise _err(node, "MAP key must be required")


_INT_CONV_WIDTHS = {
    ConvertedType.INT_8: (Type.INT32,), ConvertedType.INT_16: (Type.INT32,),
    ConvertedType.INT_32: (Type.INT32,), ConvertedType.INT_64: (Type.INT64,),
    ConvertedType.UINT_8: (Type.INT32,), ConvertedType.UINT_16: (Type.INT32,),
    ConvertedType.UINT_32: (Type.INT32,), ConvertedType.UINT_64: (Type.INT64,),
}


def _validate_leaf(node: SchemaNode, strict: bool) -> None:
    t = node.physical_type
    conv = _conv(node)
    which = _logical_which(node)
    lt = node.logical_type

    if t == Type.FIXED_LEN_BYTE_ARRAY and not node.type_length:
        raise _err(node, "FIXED_LEN_BYTE_ARRAY requires a length")

    if conv in (ConvertedType.UTF8, ConvertedType.ENUM, ConvertedType.JSON,
                ConvertedType.BSON) and t != Type.BYTE_ARRAY:
        raise _err(node, f"{conv.name} annotation requires binary, got {t.name}")
    if which in ("STRING", "ENUM", "JSON", "BSON") and t != Type.BYTE_ARRAY:
        raise _err(node, f"{which} logical type requires binary, got {t.name}")

    if conv in _INT_CONV_WIDTHS and t not in _INT_CONV_WIDTHS[conv]:
        raise _err(node, f"{conv.name} requires {_INT_CONV_WIDTHS[conv][0].name}")
    if which == "INTEGER":
        need = Type.INT64 if lt.INTEGER.bitWidth == 64 else Type.INT32
        if t != need:
            raise _err(node, f"INT({lt.INTEGER.bitWidth}) requires {need.name}")

    if conv == ConvertedType.DATE or which == "DATE":
        if t != Type.INT32:
            raise _err(node, "DATE requires int32")
    if conv == ConvertedType.TIME_MILLIS and t != Type.INT32:
        raise _err(node, "TIME_MILLIS requires int32")
    if conv == ConvertedType.TIME_MICROS and t != Type.INT64:
        raise _err(node, "TIME_MICROS requires int64")
    if conv in (ConvertedType.TIMESTAMP_MILLIS, ConvertedType.TIMESTAMP_MICROS):
        if t != Type.INT64:
            raise _err(node, f"{conv.name} requires int64")
    if which == "TIME":
        unit = lt.TIME.unit.which()
        need = Type.INT32 if unit == "MILLIS" else Type.INT64
        if t != need:
            raise _err(node, f"TIME({unit}) requires {need.name}")
    if which == "TIMESTAMP" and t != Type.INT64:
        raise _err(node, "TIMESTAMP requires int64")

    if which == "UUID":
        if t != Type.FIXED_LEN_BYTE_ARRAY or node.type_length != 16:
            raise _err(node, "UUID requires fixed_len_byte_array(16)")
    if conv == ConvertedType.INTERVAL:
        if t != Type.FIXED_LEN_BYTE_ARRAY or node.type_length != 12:
            raise _err(node, "INTERVAL requires fixed_len_byte_array(12)")

    if conv == ConvertedType.DECIMAL or which == "DECIMAL":
        precision = node.element.precision
        scale = node.element.scale
        if which == "DECIMAL":
            precision = lt.DECIMAL.precision
            scale = lt.DECIMAL.scale
        if precision is None or precision <= 0:
            raise _err(node, f"DECIMAL precision {precision} must be > 0")
        if scale is None or scale < 0 or scale > precision:
            raise _err(node, f"DECIMAL scale {scale} must be in [0, precision]")
        if t == Type.INT32 and precision > 9:
            raise _err(node, f"DECIMAL(int32) precision {precision} > 9")
        elif t == Type.INT64 and precision > 18:
            raise _err(node, f"DECIMAL(int64) precision {precision} > 18")
        elif t == Type.FIXED_LEN_BYTE_ARRAY:
            n = node.type_length
            max_digits = len(str(1 << (8 * n - 1))) - 1
            if precision > max_digits:
                raise _err(
                    node,
                    f"DECIMAL(fixed[{n}]) precision {precision} > {max_digits}",
                )
        elif t not in (Type.INT32, Type.INT64, Type.BYTE_ARRAY,
                       Type.FIXED_LEN_BYTE_ARRAY):
            raise _err(node, f"DECIMAL invalid on {t.name}")

    if conv == ConvertedType.MAP_KEY_VALUE and not strict:
        pass  # legacy annotation on leaf tolerated in lenient mode
