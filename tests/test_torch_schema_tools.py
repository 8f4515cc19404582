"""The port's schema and object tools (``tpu_parquet_torch.schema.dsl``,
``schema.validate``, ``schema.autoschema`` and ``int96``) against the JAX
package's, case for case with ``tests/test_schema_dsl.py``.

Every case feeds the same text, dataclass or value to both packages and
requires the same outcome: printed schemas equal as strings, leaf elements
equal as serialized thrift bytes, parse and validation errors of the same
type with the same text, INT96 matrices and datetimes equal.  Host code
only: no tensor, no device.
"""

import dataclasses
import datetime
import glob
import os
import uuid
from typing import Dict, List, Optional

import numpy as np
import pytest

from tpu_parquet import int96 as R96
from tpu_parquet import thrift as RT
from tpu_parquet.schema import autoschema as RA
from tpu_parquet.schema import dsl as RD
from tpu_parquet.schema import validate as RV
from tpu_parquet_torch import int96 as P96
from tpu_parquet_torch import thrift as PT
from tpu_parquet_torch.format import ConvertedType, Type
from tpu_parquet_torch.format import FieldRepetitionType as FRT
from tpu_parquet_torch.schema import autoschema as PA
from tpu_parquet_torch.schema import dsl as PD
from tpu_parquet_torch.schema import validate as PV

SCHEMA_DIR = os.path.join(os.path.dirname(__file__), "schema-files")
SCHEMA_FILES = sorted(glob.glob(os.path.join(SCHEMA_DIR, "*.schema")))


def _outcome(fn, *args, **kw):
    """``("ok", value)`` or ``("raise", error class name, text)``."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the class is the comparison
        return ("raise", type(e).__name__, str(e))


def _leaf_bytes(schema, thrift):
    return [(l.path, l.max_def, l.max_rep, thrift.serialize(l.element))
            for l in schema.leaves]


def _parse_both(text):
    got, want = (PD.parse_schema_definition(text),
                 RD.parse_schema_definition(text))
    assert PD.schema_to_string(got) == RD.schema_to_string(want)
    assert _leaf_bytes(got, PT) == _leaf_bytes(want, RT)
    return got, want


def test_parse_simple():
    s, _ = _parse_both("message foo { required int64 bar; }")
    assert s.root.name == "foo" and len(s.leaves) == 1
    assert s.leaves[0].physical_type == Type.INT64
    assert s.leaves[0].repetition == FRT.REQUIRED


ALL_TYPES = """message msg {
  required int64 id = 7;
  optional binary name (STRING);
  optional binary blob;
  required boolean flag;
  optional float f32;
  required double f64;
  optional int96 legacy_ts;
  required fixed_len_byte_array(16) uid (UUID);
  optional int32 day (DATE);
  optional int64 ts (TIMESTAMP(MILLIS,true));
  optional int64 t (TIME(NANOS,false));
  optional int32 small (INT(8,true));
  optional int32 price (DECIMAL(9,2));
  optional binary doc (JSON);
  optional int32 old_time (TIME_MILLIS);
}"""

NESTED = """message m {
  optional group lst (LIST) {
    repeated group list {
      optional binary element (STRING);
    }
  }
  optional group mp (MAP) {
    repeated group key_value {
      required binary key (STRING);
      optional int64 value;
    }
  }
  required group plain {
    required int32 x;
    repeated int64 ys;
  }
}"""

ROUND_TRIP = """message m {
  required int64 id;
  optional binary name (STRING);
  required fixed_len_byte_array(12) iv (INTERVAL);
  optional group tags (LIST) {
    repeated group list {
      optional int64 element (INT(64,false));
    }
  }
  optional int64 ts (TIMESTAMP(NANOS,true));
  optional int32 dec (DECIMAL(5,2));
}"""


def test_parse_all_types_and_annotations():
    s, _ = _parse_both(ALL_TYPES)
    by = {l.name: l for l in s.leaves}
    assert by["id"].element.field_id == 7
    assert by["name"].converted_type == ConvertedType.UTF8
    assert by["ts"].converted_type == ConvertedType.TIMESTAMP_MILLIS
    assert by["small"].converted_type == ConvertedType.INT_8
    assert by["price"].logical_type.DECIMAL.precision == 9


def test_parse_nested_groups():
    s, r = _parse_both(NESTED)
    assert s.num_columns == r.num_columns == 5
    el = s.leaf_by_path(("lst", "list", "element"))
    assert (el.max_rep, el.max_def) == (1, 3)
    for strict in (False, True):
        assert (_outcome(PV.validate, s, strict=strict)
                == _outcome(RV.validate, r, strict=strict) == ("ok", None))


def test_roundtrip_print_parse():
    s1, _ = _parse_both(ROUND_TRIP)
    printed = PD.schema_to_string(s1)
    s2, _ = _parse_both(printed)
    assert PD.schema_to_string(s2) == printed
    assert [l.element for l in s1.leaves] == [l.element for l in s2.leaves]


PARSE_ERRORS = [
    "",
    "msg foo {}",
    "message foo {",
    "message foo { required int64 }",
    "message foo { int64 bar; }",
    "message foo { required unknown bar; }",
    "message foo { required int64 bar }",
    "message foo { required int64 bar; } trailing",
    "message foo { required group g { } }",
    "message foo { required fixed_len_byte_array(0) x; }",
    "message foo { required fixed_len_byte_array(abc) x; }",
    "message foo { optional int64 t (TIMESTAMP(WEEKS,true)); }",
    "message foo { optional int32 i (INT(9,true)); }",
    "message foo { optional int64 x (NOT_A_THING); }",
    "message foo { required int64 bar = x; }",
]


@pytest.mark.parametrize("text", PARSE_ERRORS)
def test_parse_errors(text):
    got = _outcome(PD.parse_schema_definition, text)
    want = _outcome(RD.parse_schema_definition, text)
    assert got[0] == want[0] == "raise"
    assert got[1:] == want[1:] == ("SchemaParseError", want[2])
    with pytest.raises(PD.SchemaParseError):
        PD.parse_schema_definition(text)


VALIDATION_CASES = [
    "message m { optional int64 s (STRING); }",
    "message m { optional int64 d (DATE); }",
    "message m { optional fixed_len_byte_array(8) u (UUID); }",
    "message m { optional fixed_len_byte_array(16) u (INTERVAL); }",
    "message m { optional int32 d (DECIMAL(10,2)); }",
    "message m { optional int64 d (DECIMAL(5,6)); }",
    "message m { optional int64 t (TIME_MILLIS); }",
    "message m { optional int32 i (INT(64,true)); }",
    """message m { optional group l (LIST) {
         repeated group list { optional int64 element; }
         required int64 extra;
       } }""",
    """message m { optional group mp (MAP) {
         repeated group key_value {
           optional binary key (STRING);
           optional int64 value;
         } } }""",
]


@pytest.mark.parametrize("text", VALIDATION_CASES)
def test_validation_rules(text):
    got, want = _parse_both(text)
    g, w = _outcome(PV.validate, got), _outcome(RV.validate, want)
    assert g == w and g[:2] == ("raise", "SchemaValidationError")
    with pytest.raises(PV.SchemaValidationError):
        PV.validate(got)


def test_validation_accepts_a_string_column():
    got, want = _parse_both("message m { optional binary s (STRING); }")
    assert _outcome(PV.validate, got) == _outcome(RV.validate, want)


def test_strict_vs_lenient_athena_bag():
    text = """message m { optional group l (LIST) {
        repeated group bag { optional int64 array_element; } } }"""
    got, want = _parse_both(text)
    assert _outcome(PV.validate, got) == ("ok", None)
    g, w = _outcome(PV.validate_strict, got), _outcome(RV.validate_strict,
                                                       want)
    assert g == w and g[:2] == ("raise", "SchemaValidationError")


CRASHERS = [
    "message { required int64 x; }" * 100,
    "message m {" + "{" * 200,
    "message m { required group g (LIST) { " * 50,
    "message m { required int64 \x00; }",
    "message " + "a" * 10000 + " { required int64 x; }",
]


@pytest.mark.parametrize("i", range(len(CRASHERS)))
def test_crash_regression_inputs(i):
    got = _outcome(PD.parse_schema_definition, CRASHERS[i])
    want = _outcome(RD.parse_schema_definition, CRASHERS[i])
    assert got[0] == want[0]
    if got[0] == "raise":
        assert got[1:] == want[1:] and got[1] == "SchemaParseError"
    else:
        assert PD.schema_to_string(got[1]) == RD.schema_to_string(want[1])


# ---------------------------------------------------------------------------
# autoschema
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Person:
    name: str
    age: int
    height: Optional[float]
    tags: List[str]
    attrs: Dict[str, int]
    uid: uuid.UUID
    born: datetime.datetime
    day: datetime.date


@dataclasses.dataclass
class Inner:
    x: int
    y: Optional[str]


@dataclasses.dataclass
class Outer:
    inner: Optional[Inner]
    items: List[Inner]


@dataclasses.dataclass
class Renamed:
    MyField: int = dataclasses.field(default=0,
                                     metadata={"parquet": "my_field"})


@dataclasses.dataclass
class Event:
    id: int
    name: str
    score: Optional[float]
    tags: List[str]


class Weird:
    x: complex


@pytest.mark.parametrize("cls", [Person, Outer, Renamed, Event, Weird],
                         ids=lambda c: c.__name__)
def test_autoschema_matches_the_reference(cls):
    got = _outcome(PA.schema_from_type, cls, root_name="auto")
    want = _outcome(RA.schema_from_type, cls, root_name="auto")
    assert got[0] == want[0]
    if got[0] == "raise":
        assert got[1:] == want[1:] and got[1] == "AutoSchemaError"
        return
    text = PD.schema_to_string(got[1])
    assert text == RD.schema_to_string(want[1])
    assert _leaf_bytes(got[1], PT) == _leaf_bytes(want[1], RT)
    assert _outcome(PV.validate, got[1]) == ("ok", None)
    assert PD.schema_to_string(PD.parse_schema_definition(text)) == text


def test_autoschema_dataclass_lines():
    text = PD.schema_to_string(PA.schema_from_type(Person))
    for line in ("required binary name (STRING)",
                 "required int64 age (INT(64,true))",
                 "optional double height", "tags (LIST)", "attrs (MAP)",
                 "fixed_len_byte_array(16) uid (UUID)",
                 "born (TIMESTAMP(NANOS,true))", "day (DATE)"):
        assert line in text
    s = PA.schema_from_type(Outer)
    assert s.leaf_by_path(("items", "list", "element", "y")) is not None
    assert PA.schema_from_type(Renamed).leaves[0].name == "my_field"


def test_autoschema_write_read(tmp_path):
    """The autoschema's file from each package's writer: the same bytes,
    and the same unwrapped rows from each package's reader."""
    from tpu_parquet.logical import unwrap_row as ref_unwrap
    from tpu_parquet.reader import FileReader as RefReader
    from tpu_parquet.writer import FileWriter as RefWriter
    from tpu_parquet_torch.logical import unwrap_row
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.writer import FileWriter

    rows = [{"id": 1, "name": "a", "score": 0.5, "tags": ["x"]},
            {"id": 2, "name": "b", "score": None, "tags": []}]
    out = {}
    for tag, A, W, Rd, unwrap in (
            ("port", PA, FileWriter, FileReader, unwrap_row),
            ("ref", RA, RefWriter, RefReader, ref_unwrap)):
        p = str(tmp_path / f"{tag}.parquet")
        with W(p, A.schema_from_type(Event, root_name="event")) as w:
            w.write_rows(rows)
        with Rd(p) as r:
            assert [unwrap(r.schema, row) for row in r] == rows
        out[tag] = open(p, "rb").read()
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("path", SCHEMA_FILES,
                         ids=lambda p: os.path.basename(p))
def test_schema_file_fixture_roundtrip(path):
    text = open(path).read()
    got, want = _parse_both(text)
    printed = PD.schema_to_string(got)
    again, _ = _parse_both(printed)
    assert PD.schema_to_string(again) == printed
    assert (_outcome(PV.validate_strict, got)
            == _outcome(RV.validate_strict, want) == ("ok", None))


def test_schema_file_fixtures_present():
    assert len(SCHEMA_FILES) == 7


# ---------------------------------------------------------------------------
# int96
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_int96_conversions_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    ns = rng.integers(0, 4_000_000_000 * 10**9, 1000, dtype=np.int64)
    got, want = P96.ns_epoch_to_int96(ns), R96.ns_epoch_to_int96(ns)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(P96.int96_to_ns_epoch(got), ns)
    np.testing.assert_array_equal(R96.int96_to_ns_epoch(got), ns)
    for row in got[:50]:
        assert P96.int96_to_datetime(row) == R96.int96_to_datetime(row)
        raw = row.astype("<u4").tobytes()
        assert P96.int96_to_datetime(raw) == R96.int96_to_datetime(raw)
    utc = datetime.timezone.utc
    for dt in (datetime.datetime(2021, 7, 4, 9, 30, 0, 250000, tzinfo=utc),
               datetime.datetime(1970, 1, 1), datetime.datetime(2262, 1, 1)):
        assert P96.datetime_to_int96(dt) == R96.datetime_to_int96(dt)
    for fn in (P96.ns_epoch_to_int96, R96.ns_epoch_to_int96):
        assert _outcome(fn, np.array([-1]))[:2] == ("raise", "ValueError")
    assert (_outcome(P96.ns_epoch_to_int96, np.array([-1]))
            == _outcome(R96.ns_epoch_to_int96, np.array([-1])))
