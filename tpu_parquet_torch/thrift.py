"""Thrift compact-protocol engine.

A from-scratch, declarative implementation of the Thrift compact protocol — the only
wire format Apache Parquet uses for its metadata (file footer, page headers).  The
reference implementation relies on the full apache/thrift Go runtime plus 12.5k lines
of generated code (parquet/parquet.go of the Go reference); here the ~20 structs Parquet
needs are described by small declarative field specs (see format/__init__.py)
and serialized by this generic engine.

Wire-format facts implemented here (verified against the thrift spec and the behaviour
of the reference's vendored Go runtime, e.g. compact_protocol.go: doubles are
little-endian, i16/i32/i64 are zigzag varints, field ids are delta-encoded):

  field header  : one byte ``(delta << 4) | ctype``; delta==0 → explicit zigzag varint id
  bool fields   : value carried in the header ctype (1=true, 2=false)
  list header   : one byte ``(size << 4) | elem_ctype``; size==15 → explicit varint size
  binary/string : varint length + bytes
  struct        : fields then a 0x00 stop byte

Malformed-input hardening mirrors the posture of the reference's fuzz-hardened
helpers.go:103-119 readThrift path: all reads are bounds-checked against the buffer and
raise ``ThriftError`` instead of crashing, and containers are size-sanity-checked.
"""

from __future__ import annotations

from .errors import ParquetError

import struct as _struct
from typing import Any, Callable, Optional

__all__ = [
    "ThriftError",
    "ThriftStruct",
    "read_struct",
    "write_struct",
    "serialize",
    "deserialize",
    "CompactReader",
    "CompactWriter",
]


class ThriftError(ParquetError):
    """Raised on malformed thrift input (truncated, oversized, or type-confused)."""


# Compact-protocol wire type ids.
CT_STOP = 0x00
CT_TRUE = 0x01
CT_FALSE = 0x02
CT_BYTE = 0x03
CT_I16 = 0x04
CT_I32 = 0x05
CT_I64 = 0x06
CT_DOUBLE = 0x07
CT_BINARY = 0x08
CT_LIST = 0x09
CT_SET = 0x0A
CT_MAP = 0x0B
CT_STRUCT = 0x0C

# Declarative field-spec atoms → compact wire type.
_ATOM_CTYPE = {
    "bool": CT_TRUE,  # placeholder; bools are special-cased in field headers
    "i8": CT_BYTE,
    "i16": CT_I16,
    "i32": CT_I32,
    "i64": CT_I64,
    "double": CT_DOUBLE,
    "binary": CT_BINARY,
    "string": CT_BINARY,
}

# Hard cap on any single container/blob parsed from untrusted bytes.  Real parquet
# footers have a few thousand schema elements; 16M entries is far beyond legitimate
# use and cheap insurance against decompression-bomb-style thrift payloads (the
# reference defends the same way via its allocTracker, alloc.go:10-89).
_MAX_CONTAINER = 1 << 24


def _spec_ctype(spec: Any) -> int:
    if isinstance(spec, str):
        return _ATOM_CTYPE[spec]
    if isinstance(spec, tuple):
        if spec[0] == "list":
            return CT_LIST
        if spec[0] == "map":
            return CT_MAP
    if isinstance(spec, type) and issubclass(spec, ThriftStruct):
        return CT_STRUCT
    raise TypeError(f"bad thrift field spec: {spec!r}")


def _zigzag32(n: int) -> int:
    if not -(1 << 31) <= n < (1 << 31):
        raise ThriftError(f"value {n} out of range for 32-bit thrift field")
    return ((n << 1) ^ (n >> 31)) & 0xFFFFFFFF


def _zigzag64(n: int) -> int:
    if not -(1 << 63) <= n < (1 << 63):
        raise ThriftError(f"value {n} out of range for 64-bit thrift field")
    return ((n << 1) ^ (n >> 63)) & 0xFFFFFFFFFFFFFFFF


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


class CompactReader:
    """Cursor over a bytes-like object decoding compact-protocol primitives."""

    __slots__ = ("buf", "pos", "end")

    def __init__(self, buf, pos: int = 0, end: Optional[int] = None):
        if isinstance(buf, memoryview):
            buf = bytes(buf)
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end

    def _need(self, n: int) -> int:
        p = self.pos
        if p + n > self.end:
            raise ThriftError(
                f"truncated thrift input: need {n} bytes at {p}, have {self.end - p}"
            )
        self.pos = p + n
        return p

    def read_byte(self) -> int:
        p = self._need(1)
        return self.buf[p]

    def read_varint(self) -> int:
        """Unsigned LEB128 varint (unbounded width is rejected past 10 bytes)."""
        result = 0
        shift = 0
        buf = self.buf
        pos = self.pos
        end = self.end
        while True:
            if pos >= end:
                raise ThriftError("truncated varint")
            b = buf[pos]
            pos += 1
            result |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise ThriftError("varint too long")
        if result >> 64:
            raise ThriftError("varint exceeds 64 bits")
        self.pos = pos
        return result

    def read_zigzag(self) -> int:
        return _unzigzag(self.read_varint())

    def read_double(self) -> float:
        p = self._need(8)
        return _struct.unpack_from("<d", self.buf, p)[0]

    def read_binary(self) -> bytes:
        n = self.read_varint()
        if n > _MAX_CONTAINER:
            raise ThriftError(f"thrift binary of {n} bytes exceeds sanity cap")
        p = self._need(n)
        return bytes(self.buf[p : p + n])

    def read_list_header(self) -> tuple[int, int]:
        b = self.read_byte()
        size = (b >> 4) & 0x0F
        etype = b & 0x0F
        if size == 15:
            size = self.read_varint()
        if size > _MAX_CONTAINER:
            raise ThriftError(f"thrift list of {size} elements exceeds sanity cap")
        return size, etype

    def read_field_header(self, last_fid: int) -> tuple[int, int]:
        """Returns (ctype, field_id); ctype==CT_STOP terminates the struct."""
        b = self.read_byte()
        if b == CT_STOP:
            return CT_STOP, 0
        ctype = b & 0x0F
        delta = (b >> 4) & 0x0F
        fid = last_fid + delta if delta else self.read_zigzag()
        return ctype, fid

    # -- skipping unknown fields (forward/backward compat + fuzz robustness) ------

    def skip(self, ctype: int, depth: int = 0) -> None:
        if depth > 32:
            raise ThriftError("thrift nesting too deep")
        if ctype in (CT_TRUE, CT_FALSE):
            return
        if ctype == CT_BYTE:
            self._need(1)
        elif ctype in (CT_I16, CT_I32, CT_I64):
            self.read_varint()
        elif ctype == CT_DOUBLE:
            self._need(8)
        elif ctype == CT_BINARY:
            n = self.read_varint()
            if n > _MAX_CONTAINER:
                raise ThriftError("oversized binary while skipping")
            self._need(n)
        elif ctype in (CT_LIST, CT_SET):
            size, etype = self.read_list_header()
            if etype in (CT_TRUE, CT_FALSE):
                # list elements carry bools as one byte each (unlike field headers)
                self._need(size)
            else:
                for _ in range(size):
                    self.skip(etype, depth + 1)
        elif ctype == CT_MAP:
            size = self.read_varint()
            if size > _MAX_CONTAINER:
                raise ThriftError("oversized map while skipping")
            if size:
                kv = self.read_byte()
                ktype, vtype = (kv >> 4) & 0x0F, kv & 0x0F
                for _ in range(size):
                    self.skip(ktype, depth + 1)
                    self.skip(vtype, depth + 1)
        elif ctype == CT_STRUCT:
            last = 0
            while True:
                ft, fid = self.read_field_header(last)
                if ft == CT_STOP:
                    return
                if ft not in (CT_TRUE, CT_FALSE):
                    self.skip(ft, depth + 1)
                last = fid
        else:
            raise ThriftError(f"cannot skip unknown thrift ctype {ctype}")


class CompactWriter:
    """Append-only compact-protocol emitter into a bytearray."""

    __slots__ = ("out",)

    def __init__(self):
        self.out = bytearray()

    def write_byte(self, b: int) -> None:
        self.out.append(b & 0xFF)

    def write_varint(self, n: int) -> None:
        out = self.out
        while True:
            if n < 0x80:
                out.append(n)
                return
            out.append((n & 0x7F) | 0x80)
            n >>= 7

    def write_zigzag32(self, n: int) -> None:
        self.write_varint(_zigzag32(n))

    def write_zigzag64(self, n: int) -> None:
        self.write_varint(_zigzag64(n))

    def write_double(self, v: float) -> None:
        self.out += _struct.pack("<d", v)

    def write_binary(self, v: bytes) -> None:
        self.write_varint(len(v))
        self.out += v

    def write_list_header(self, size: int, etype: int) -> None:
        if size < 15:
            self.write_byte((size << 4) | etype)
        else:
            self.write_byte(0xF0 | etype)
            self.write_varint(size)

    def write_field_header(self, ctype: int, fid: int, last_fid: int) -> None:
        delta = fid - last_fid
        if 0 < delta <= 15:
            self.write_byte((delta << 4) | ctype)
        else:
            self.write_byte(ctype)
            self.write_zigzag32(fid)


class ThriftStruct:
    """Base for declaratively-specified thrift structs.

    Subclasses set ``FIELDS``: a dict ``{field_id: (attr_name, spec)}`` where spec is
    an atom string ('bool','i8','i16','i32','i64','double','binary','string'), a
    ``('list', spec)`` tuple, or a ThriftStruct subclass.  Unset/None fields are
    omitted on write; unknown fields are skipped on read.
    """

    FIELDS: dict[int, tuple[str, Any]] = {}

    def __init__(self, **kwargs):
        for _, (name, _spec) in self.FIELDS.items():
            setattr(self, name, kwargs.pop(name, None))
        if kwargs:
            raise TypeError(f"{type(self).__name__}: unknown fields {sorted(kwargs)}")

    def __repr__(self):
        parts = []
        for _, (name, _spec) in sorted(self.FIELDS.items()):
            v = getattr(self, name)
            if v is not None:
                parts.append(f"{name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(
            getattr(self, name) == getattr(other, name)
            for _, (name, _spec) in self.FIELDS.items()
        )

    __hash__ = None


def _read_value(
    r: CompactReader, spec: Any, ctype: int, depth: int, from_field: bool = False
) -> Any:
    if depth > 32:
        raise ThriftError("thrift nesting too deep")
    if isinstance(spec, str):
        if spec == "bool":
            if from_field:
                # in field context the value is carried in the header's ctype
                return ctype == CT_TRUE
            # list/set elements carry bools as one byte each (0x01/0x02)
            return r.read_byte() == CT_TRUE
        if spec == "i8":
            v = r.read_byte()
            return v - 256 if v >= 128 else v
        if spec in ("i16", "i32", "i64"):
            return r.read_zigzag()
        if spec == "double":
            return r.read_double()
        if spec == "binary":
            return r.read_binary()
        if spec == "string":
            return r.read_binary().decode("utf-8", errors="replace")
        raise TypeError(f"bad atom spec {spec!r}")
    if isinstance(spec, tuple) and spec[0] == "list":
        size, etype = r.read_list_header()
        elem_spec = spec[1]
        # type-confusion guard: if the wire's element type doesn't match the
        # spec, consume the list per the wire type and treat the field as absent
        if elem_spec == "bool":
            ok = etype in (CT_TRUE, CT_FALSE)
        else:
            ok = etype == _spec_ctype(elem_spec)
        if not ok:
            if etype in (CT_TRUE, CT_FALSE):
                r._need(size)
            else:
                for _ in range(size):
                    r.skip(etype, depth + 1)
            return None
        return [_read_value(r, elem_spec, etype, depth + 1) for _ in range(size)]
    if isinstance(spec, type) and issubclass(spec, ThriftStruct):
        return _read_struct_body(r, spec, depth + 1)
    raise TypeError(f"bad thrift field spec: {spec!r}")


def _read_struct_body(r: CompactReader, cls: type, depth: int = 0):
    if depth > 32:
        raise ThriftError("thrift nesting too deep")
    obj = cls()
    fields = cls.FIELDS
    last = 0
    while True:
        ctype, fid = r.read_field_header(last)
        if ctype == CT_STOP:
            return obj
        ent = fields.get(fid)
        if ent is None:
            r.skip(ctype, depth)
        else:
            name, spec = ent
            # Guard against wire-type/spec confusion on malformed input: a field id
            # we know, carrying a different wire type, is skipped by its wire type.
            if spec == "bool":
                ok = ctype in (CT_TRUE, CT_FALSE)
            else:
                ok = ctype == _spec_ctype(spec) or (
                    ctype == CT_SET and isinstance(spec, tuple) and spec[0] == "list"
                )
            if ok:
                setattr(obj, name, _read_value(r, spec, ctype, depth, from_field=True))
            else:
                r.skip(ctype, depth)
        last = fid


def _write_value(w: CompactWriter, spec: Any, v: Any) -> None:
    if isinstance(spec, str):
        if spec == "bool":
            w.write_byte(CT_TRUE if v else CT_FALSE)
        elif spec == "i8":
            w.write_byte(v & 0xFF)
        elif spec in ("i16", "i32"):
            w.write_zigzag32(int(v))
        elif spec == "i64":
            w.write_zigzag64(int(v))
        elif spec == "double":
            w.write_double(v)
        elif spec == "binary":
            w.write_binary(bytes(v))
        elif spec == "string":
            w.write_binary(v.encode("utf-8") if isinstance(v, str) else bytes(v))
        else:
            raise TypeError(f"bad atom spec {spec!r}")
    elif isinstance(spec, tuple) and spec[0] == "list":
        elem_spec = spec[1]
        w.write_list_header(len(v), _spec_ctype(elem_spec))
        for item in v:
            _write_value(w, elem_spec, item)
    elif isinstance(spec, type) and issubclass(spec, ThriftStruct):
        _write_struct_body(w, v)
    else:
        raise TypeError(f"bad thrift field spec: {spec!r}")


def _write_struct_body(w: CompactWriter, obj: ThriftStruct) -> None:
    last = 0
    for fid in sorted(obj.FIELDS):
        name, spec = obj.FIELDS[fid]
        v = getattr(obj, name)
        if v is None:
            continue
        if spec == "bool":
            w.write_field_header(CT_TRUE if v else CT_FALSE, fid, last)
        else:
            w.write_field_header(_spec_ctype(spec), fid, last)
            _write_value(w, spec, v)
        last = fid
    w.write_byte(CT_STOP)


def read_struct(cls: type, buf, pos: int = 0) -> tuple[Any, int]:
    """Parse one ``cls`` from ``buf[pos:]``; returns (object, end_position)."""
    r = CompactReader(buf, pos)
    obj = _read_struct_body(r, cls)
    return obj, r.pos


def write_struct(obj: ThriftStruct) -> bytes:
    w = CompactWriter()
    _write_struct_body(w, obj)
    return bytes(w.out)


# Friendlier aliases used by higher layers.
serialize = write_struct


def deserialize(cls: type, buf) -> Any:
    obj, _ = read_struct(cls, buf)
    return obj
