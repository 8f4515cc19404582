"""Textual schema-definition language: parser + printer.

Same grammar as the reference (documented at parquetschema/schema_def.go:35-93 and
implemented by its lexer/parser in schema_parser.go:100-723):

    message ::= 'message' <identifier> '{' <column-definition>* '}'
    column  ::= ('required'|'optional'|'repeated')
                ( 'group' <id> [ '(' CONVERTED ')' ] '{' ... '}'
                | <type> <id> [ '(' LOGICAL ')' ] [ '=' <fieldid> ] ';' )
    type    ::= binary|boolean|float|double|int32|int64|int96
                |fixed_len_byte_array '(' N ')'

with parameterized logical annotations TIMESTAMP(unit,utc), TIME(unit,utc),
INT(bits,signed), DECIMAL(precision,scale), and the full converted-type name set.
The printer round-trips: parse(print(schema)) == schema.
"""

from __future__ import annotations

import re
from typing import Optional

from ..format import (
    ConvertedType,
    DateType,
    DecimalType,
    EnumType,
    FieldRepetitionType,
    IntType,
    JsonType,
    BsonType,
    ListType,
    LogicalType,
    MapType,
    SchemaElement,
    StringType,
    TimestampType,
    TimeType,
    TimeUnit,
    Type,
    UUIDType,
)
from .core import Schema, SchemaNode, SchemaError


class SchemaParseError(SchemaError):
    def __init__(self, msg: str, line: int = 0):
        super().__init__(f"line {line}: {msg}" if line else msg)
        self.line = line


_TYPES = {
    "binary": Type.BYTE_ARRAY,
    "boolean": Type.BOOLEAN,
    "float": Type.FLOAT,
    "double": Type.DOUBLE,
    "int32": Type.INT32,
    "int64": Type.INT64,
    "int96": Type.INT96,
    "fixed_len_byte_array": Type.FIXED_LEN_BYTE_ARRAY,
}
_TYPE_NAMES = {v: k for k, v in _TYPES.items()}

_TOKEN_RE = re.compile(r"[{}();,=]|[^\s{}();,=]+")


class _Lexer:
    """Tokens + line tracking (schemaLexer parity, schema_parser.go:100-263)."""

    def __init__(self, text: str):
        self.tokens: list[tuple[str, int]] = []
        for lineno, line in enumerate(text.splitlines(), 1):
            # strip #- and //-style comments (the reference has none, but they
            # cost nothing and schema files in the wild use them)
            for m in _TOKEN_RE.finditer(line.split("#")[0]):
                self.tokens.append((m.group(0), lineno))
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos][0] if self.pos < len(self.tokens) else None

    @property
    def line(self) -> int:
        i = min(self.pos, len(self.tokens) - 1)
        return self.tokens[i][1] if self.tokens else 0

    def next(self) -> str:
        if self.pos >= len(self.tokens):
            raise SchemaParseError("unexpected end of schema", self.line)
        tok, _ = self.tokens[self.pos]
        self.pos += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise SchemaParseError(f"expected {tok!r}, got {got!r}", self.line)


def parse_schema_definition(text: str) -> Schema:
    """ParseSchemaDefinition parity (schema_def.go:94)."""
    lx = _Lexer(text)
    lx.expect("message")
    name = lx.next()
    if name in ("{", "}", ";"):
        raise SchemaParseError(f"invalid message name {name!r}", lx.line)
    lx.expect("{")
    children = _parse_body(lx)
    lx.expect("}")
    if lx.peek() is not None:
        raise SchemaParseError(f"trailing content {lx.peek()!r}", lx.line)
    root = SchemaNode(SchemaElement(name=name), children)
    return Schema(root)


def _parse_body(lx: _Lexer) -> list[SchemaNode]:
    out = []
    while lx.peek() != "}":
        out.append(_parse_column(lx))
    return out


_REPETITIONS = {
    "required": FieldRepetitionType.REQUIRED,
    "optional": FieldRepetitionType.OPTIONAL,
    "repeated": FieldRepetitionType.REPEATED,
}


def _parse_column(lx: _Lexer) -> SchemaNode:
    rep_tok = lx.next()
    rep = _REPETITIONS.get(rep_tok)
    if rep is None:
        raise SchemaParseError(
            f"expected repetition (required/optional/repeated), got {rep_tok!r}",
            lx.line,
        )
    tok = lx.next()
    if tok == "group":
        name = lx.next()
        elem = SchemaElement(name=name, repetition_type=int(rep))
        if lx.peek() == "(":
            _parse_annotation(lx, elem, is_group=True)
        lx.expect("{")
        children = _parse_body(lx)
        lx.expect("}")
        if not children:
            raise SchemaParseError(f"group {name!r} has no children", lx.line)
        return SchemaNode(elem, children)
    # leaf field
    ptype = _TYPES.get(tok)
    if ptype is None:
        raise SchemaParseError(f"unknown type {tok!r}", lx.line)
    elem = SchemaElement(repetition_type=int(rep), type=int(ptype))
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        lx.expect("(")
        elem.type_length = _parse_int(lx)
        if elem.type_length <= 0:
            raise SchemaParseError(
                f"invalid fixed_len_byte_array length {elem.type_length}", lx.line
            )
        lx.expect(")")
    elem.name = lx.next()
    if elem.name in ("{", "}", ";", "(", ")"):
        raise SchemaParseError(f"invalid column name {elem.name!r}", lx.line)
    if lx.peek() == "(":
        _parse_annotation(lx, elem, is_group=False)
    if lx.peek() == "=":
        lx.next()
        elem.field_id = _parse_int(lx)
    lx.expect(";")
    return SchemaNode(elem, None)


def _parse_int(lx: _Lexer) -> int:
    tok = lx.next()
    try:
        return int(tok)
    except ValueError:
        raise SchemaParseError(f"expected number, got {tok!r}", lx.line) from None


def _parse_bool(lx: _Lexer) -> bool:
    tok = lx.next()
    if tok == "true":
        return True
    if tok == "false":
        return False
    raise SchemaParseError(f"expected true/false, got {tok!r}", lx.line)


_SIMPLE_CONVERTED = {e.name: e for e in ConvertedType}


def _parse_annotation(lx: _Lexer, elem: SchemaElement, is_group: bool) -> None:
    lx.expect("(")
    name = lx.next()
    lt = LogicalType()

    if name == "STRING":
        lt.STRING = StringType()
        elem.converted_type = int(ConvertedType.UTF8)
    elif name == "UTF8":
        lt.STRING = StringType()
        elem.converted_type = int(ConvertedType.UTF8)
    elif name == "DATE":
        lt.DATE = DateType()
        elem.converted_type = int(ConvertedType.DATE)
    elif name == "ENUM":
        lt.ENUM = EnumType()
        elem.converted_type = int(ConvertedType.ENUM)
    elif name == "JSON":
        lt.JSON = JsonType()
        elem.converted_type = int(ConvertedType.JSON)
    elif name == "BSON":
        lt.BSON = BsonType()
        elem.converted_type = int(ConvertedType.BSON)
    elif name == "UUID":
        lt.UUID = UUIDType()
    elif name == "LIST":
        lt.LIST = ListType()
        elem.converted_type = int(ConvertedType.LIST)
    elif name == "MAP":
        lt.MAP = MapType()
        elem.converted_type = int(ConvertedType.MAP)
    elif name == "MAP_KEY_VALUE":
        elem.converted_type = int(ConvertedType.MAP_KEY_VALUE)
        lt = None
    elif name in ("TIMESTAMP", "TIME"):
        lx.expect("(")
        unit_tok = lx.next()
        unit = {
            "MILLIS": TimeUnit.millis, "MICROS": TimeUnit.micros,
            "NANOS": TimeUnit.nanos,
        }.get(unit_tok)
        if unit is None:
            raise SchemaParseError(f"invalid time unit {unit_tok!r}", lx.line)
        lx.expect(",")
        utc = _parse_bool(lx)
        lx.expect(")")
        if name == "TIMESTAMP":
            lt.TIMESTAMP = TimestampType(isAdjustedToUTC=utc, unit=unit())
            elem.converted_type = {
                "MILLIS": int(ConvertedType.TIMESTAMP_MILLIS),
                "MICROS": int(ConvertedType.TIMESTAMP_MICROS),
            }.get(unit_tok)
        else:
            lt.TIME = TimeType(isAdjustedToUTC=utc, unit=unit())
            elem.converted_type = {
                "MILLIS": int(ConvertedType.TIME_MILLIS),
                "MICROS": int(ConvertedType.TIME_MICROS),
            }.get(unit_tok)
    elif name == "INT":
        lx.expect("(")
        bits = _parse_int(lx)
        if bits not in (8, 16, 32, 64):
            raise SchemaParseError(f"invalid INT bit width {bits}", lx.line)
        lx.expect(",")
        signed = _parse_bool(lx)
        lx.expect(")")
        lt.INTEGER = IntType(bitWidth=bits, isSigned=signed)
        elem.converted_type = int(
            ConvertedType[f"{'INT' if signed else 'UINT'}_{bits}"]
        )
    elif name == "DECIMAL":
        lx.expect("(")
        precision = _parse_int(lx)
        lx.expect(",")
        scale = _parse_int(lx)
        lx.expect(")")
        lt.DECIMAL = DecimalType(precision=precision, scale=scale)
        elem.converted_type = int(ConvertedType.DECIMAL)
        elem.precision = precision
        elem.scale = scale
    elif name in _SIMPLE_CONVERTED:
        # bare converted-type names (TIME_MILLIS, UINT_8, INTERVAL, ...)
        elem.converted_type = int(_SIMPLE_CONVERTED[name])
        lt = None
    else:
        raise SchemaParseError(f"unknown annotation {name!r}", lx.line)
    if lt is not None and lt.which() is not None:
        elem.logicalType = lt
    lx.expect(")")


# ---------------------------------------------------------------------------
# Printer (round-trippable String(), schema_def.go parity)
# ---------------------------------------------------------------------------

def _annotation_str(elem: SchemaElement) -> str:
    lt = elem.logicalType
    if lt is not None:
        which = lt.which()
        if which == "STRING":
            return " (STRING)"
        if which == "DATE":
            return " (DATE)"
        if which == "ENUM":
            return " (ENUM)"
        if which == "JSON":
            return " (JSON)"
        if which == "BSON":
            return " (BSON)"
        if which == "UUID":
            return " (UUID)"
        if which == "LIST":
            return " (LIST)"
        if which == "MAP":
            return " (MAP)"
        if which == "TIMESTAMP":
            t = lt.TIMESTAMP
            unit = t.unit.which()
            return f" (TIMESTAMP({unit},{'true' if t.isAdjustedToUTC else 'false'}))"
        if which == "TIME":
            t = lt.TIME
            unit = t.unit.which()
            return f" (TIME({unit},{'true' if t.isAdjustedToUTC else 'false'}))"
        if which == "INTEGER":
            i = lt.INTEGER
            return f" (INT({i.bitWidth},{'true' if i.isSigned else 'false'}))"
        if which == "DECIMAL":
            d = lt.DECIMAL
            return f" (DECIMAL({d.precision},{d.scale}))"
    if elem.converted_type is not None:
        conv = ConvertedType(elem.converted_type)
        if conv == ConvertedType.DECIMAL:
            # bare (DECIMAL) is unparseable; legacy columns carry p/s on the element
            return f" (DECIMAL({elem.precision or 0},{elem.scale or 0}))"
        return f" ({conv.name})"
    return ""


def schema_to_string(schema: Schema) -> str:
    lines = [f"message {schema.root.name} {{"]

    def visit(node: SchemaNode, indent: int):
        pad = "  " * indent
        rep = node.repetition.name.lower()
        if not node.is_leaf:
            lines.append(
                f"{pad}{rep} group {node.name}{_annotation_str(node.element)} {{"
            )
            for c in node.children:
                visit(c, indent + 1)
            lines.append(f"{pad}}}")
            return
        t = node.physical_type
        tname = _TYPE_NAMES[t]
        if t == Type.FIXED_LEN_BYTE_ARRAY:
            tname += f"({node.type_length})"
        fid = (
            f" = {node.element.field_id}" if node.element.field_id is not None else ""
        )
        lines.append(
            f"{pad}{rep} {tname} {node.name}{_annotation_str(node.element)}{fid};"
        )

    for c in schema.root.children or []:
        visit(c, 1)
    lines.append("}")
    return "\n".join(lines) + "\n"
