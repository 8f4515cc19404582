"""The port's object API (``tpu_parquet_torch.floor``: ``Reader``,
``Writer``, ``Time``, the marshal hooks and the row builder) against the JAX
package's, case for case with ``tests/test_floor.py`` and
``tests/test_floor_builder.py``.

Each case runs once per package on the same records: the two files must be
byte-identical, and the records each package's ``Reader`` gives back must be
equal (a ``Time`` compared by its fields, since each package has its own
class).  Errors compare by class name and text.  pyarrow reads the port's
files as the foreign reader.  Host code only: no tensor, no device.
"""

import dataclasses
import datetime
import decimal
import uuid
from typing import Dict, List, Optional

import numpy as np
import pyarrow.parquet as pq
import pytest

import tpu_parquet.floor as RF
import tpu_parquet.floor.builder as RB
import tpu_parquet.floor.marshal as RM
import tpu_parquet.reader as RR
import tpu_parquet.schema.dsl as RD
import tpu_parquet.writer as RW
import tpu_parquet_torch.floor as PF
import tpu_parquet_torch.floor.builder as PB
import tpu_parquet_torch.floor.marshal as PM
import tpu_parquet_torch.reader as PR
import tpu_parquet_torch.schema.dsl as PD
import tpu_parquet_torch.writer as PW
from tpu_parquet_torch.footer import read_file_metadata

UTC = datetime.timezone.utc


@dataclasses.dataclass(frozen=True)
class Pkg:
    name: str
    floor: object
    marshal: object
    builder: object
    dsl: object
    reader: object
    writer: object


PORT = Pkg("port", PF, PM, PB, PD, PR, PW)
REF = Pkg("reference", RF, RM, RB, RD, RR, RW)
BOTH = (PORT, REF)


def _plain(v):
    """A record with each package's ``Time`` as its fields."""
    if isinstance(v, (PF.Time, RF.Time)):
        return ("Time", v.nanoseconds, v.utc)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, _plain(dataclasses.asdict(v)))
    return v


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the class is the comparison
        return ("raise", type(e).__name__, str(e))


def _both(tmp_path, case):
    """Run ``case(pkg, path)`` per package; the files must be equal bytes.
    Returns the per-package results and the port's path."""
    out, files = [], []
    for pkg in BOTH:
        path = str(tmp_path / f"{pkg.name}.parquet")
        out.append(case(pkg, path))
        files.append(open(path, "rb").read())
    assert files[0] == files[1]
    assert _plain(out[0]) == _plain(out[1])
    return out[0], str(tmp_path / "port.parquet")


@dataclasses.dataclass
class Trip:
    id: int
    rider: str
    fare: Optional[float]
    pickup: datetime.datetime
    day: datetime.date
    stops: List[str]
    meta: Dict[str, int]


def sample_trips(n=100):
    return [
        Trip(id=i, rider=f"rider_{i % 10}",
             fare=None if i % 9 == 0 else i * 1.5,
             pickup=datetime.datetime(2023, 1, 1, tzinfo=UTC)
             + datetime.timedelta(minutes=i),
             day=datetime.date(2023, 1, 1) + datetime.timedelta(days=i % 30),
             stops=[f"s{j}" for j in range(i % 4)], meta={"n": i})
        for i in range(n)
    ]


def _write_read(pkg, path, rows, *, obj_type=None, schema_text=None,
                read_type=None, **opts):
    schema = (pkg.dsl.parse_schema_definition(schema_text)
              if schema_text else None)
    with pkg.floor.Writer(path, schema=schema, obj_type=obj_type,
                          **opts) as w:
        w.write_many(rows)
    with pkg.floor.Reader(path, obj_type=read_type) as r:
        return r.num_rows, (r.scan_all() if read_type else list(r))


def test_dataclass_roundtrip(tmp_path):
    trips = sample_trips()
    (n, got), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, trips, obj_type=Trip, read_type=Trip))
    assert n == 100 and got == trips


def test_pyarrow_reads_floor_output(tmp_path):
    _r, path = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, sample_trips(10), obj_type=Trip))
    row = pq.read_table(path).to_pylist()[3]
    assert row["rider"] == "rider_3"
    assert row["day"] == datetime.date(2023, 1, 4)
    assert row["pickup"] == datetime.datetime(2023, 1, 1, 0, 3, tzinfo=UTC)


def test_timestamp_units(tmp_path):
    dt = datetime.datetime(2024, 6, 15, 12, 30, 45, 123456, tzinfo=UTC)
    (_n, rows), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [{"ms": dt, "us": dt, "ns": dt}], schema_text="""message m {
          optional int64 ms (TIMESTAMP(MILLIS,true));
          optional int64 us (TIMESTAMP(MICROS,true));
          optional int64 ns (TIMESTAMP(NANOS,true));
        }"""))
    assert rows == [{"ms": dt.replace(microsecond=123000), "us": dt,
                     "ns": dt}]


def test_time_type(tmp_path):
    def case(pkg, p):
        t = pkg.floor.Time.from_parts(14, 30, 15, 500_000_000)
        _n, rows = _write_read(pkg, p, [{"tm": t, "tu": t}],
                               schema_text="""message m {
          optional int32 tm (TIME(MILLIS,true));
          optional int64 tu (TIME(MICROS,true));
        }""")
        assert rows == [{"tm": t, "tu": t}]
        return rows, str(t), t.to_datetime_time()

    (rows, text, tod), _ = _both(tmp_path, case)
    assert text == "14:30:15.5Z" and tod.hour == 14


def test_time_validation():
    for pkg in BOTH:
        T = pkg.floor.Time
        assert T.from_milliseconds(1000).second == 1
    for args in ((-1,), (86_400_000_000_000,)):
        got = _outcome(PF.Time, *args)
        assert got == _outcome(RF.Time, *args) and got[1] == "ValueError"
    got = _outcome(PF.Time.from_parts, 24, 0)
    assert got == _outcome(RF.Time.from_parts, 24, 0)
    assert got[1] == "ValueError"


def test_uuid_and_decimal(tmp_path):
    u = uuid.UUID("12345678-1234-5678-1234-567812345678")
    row = {"uid": u, "price": decimal.Decimal("123.45"),
           "big": decimal.Decimal("-99999.1234")}
    (_n, rows), path = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [row], schema_text="""message m {
          required fixed_len_byte_array(16) uid (UUID);
          optional int32 price (DECIMAL(9,2));
          optional binary big (DECIMAL(20,4));
        }"""))
    assert rows == [row]
    assert pq.read_table(path).column("price").to_pylist() == [
        decimal.Decimal("123.45")]


def test_int96_timestamps(tmp_path):
    dt = datetime.datetime(2021, 7, 4, 9, 30, 0, 250000, tzinfo=UTC)
    (_n, rows), path = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [{"ts": dt}], schema_text="message m { optional int96 ts; }",
        use_dictionary=False))
    assert rows == [{"ts": dt}]
    assert pq.read_table(path).column("ts").to_pylist()[0] == dt.replace(
        tzinfo=None)


def test_pre_epoch_timestamps(tmp_path):
    dt = datetime.datetime(1969, 12, 31, 23, 59, 59, 500000, tzinfo=UTC)
    (_n, rows), path = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [{"us": dt}],
        schema_text="message m { optional int64 us (TIMESTAMP(MICROS,true)); }"))
    assert rows == [{"us": dt}]
    assert pq.read_table(path).column("us").to_pylist()[0] == dt


def test_optional_columnar_write_without_levels(tmp_path):
    from tpu_parquet import column as RC
    from tpu_parquet.format import FieldRepetitionType as RFRT, Type as RT
    from tpu_parquet.schema import core as RS
    from tpu_parquet_torch import column as PC
    from tpu_parquet_torch.format import FieldRepetitionType as FRT, Type
    from tpu_parquet_torch.schema import core as PS

    def case(pkg, p):
        C, S, F, T = ((PC, PS, FRT, Type) if pkg is PORT
                      else (RC, RS, RFRT, RT))
        schema = S.build_schema([S.data_column("v", T.INT64, F.OPTIONAL)])
        cd = C.ColumnData(values=np.arange(5, dtype=np.int64), max_def=1,
                          max_rep=0)
        with pkg.writer.FileWriter(p, schema) as w:
            w.write_columns({"v": cd})
        return None

    _r, path = _both(tmp_path, case)
    assert pq.read_table(path).column("v").to_pylist() == [0, 1, 2, 3, 4]


def test_decimal_printer_roundtrip_converted_only():
    from tpu_parquet import format as RFmt
    from tpu_parquet.schema import core as RS
    from tpu_parquet_torch import format as PFmt
    from tpu_parquet_torch.schema import core as PS

    texts = []
    for pkg, Fmt, S in ((PORT, PFmt, PS), (REF, RFmt, RS)):
        elem = Fmt.SchemaElement(
            name="d", type=int(Fmt.Type.INT32), repetition_type=1,
            converted_type=int(Fmt.ConvertedType.DECIMAL), precision=9,
            scale=2)
        s = S.Schema(S.SchemaNode(Fmt.SchemaElement(name="m"),
                                  [S.SchemaNode(elem, None)]))
        text = pkg.dsl.schema_to_string(s)
        assert "DECIMAL(9,2)" in text
        again = pkg.dsl.parse_schema_definition(text)
        assert again.leaves[0].element.precision == 9
        texts.append(text)
    assert texts[0] == texts[1]


class Point:
    def __init__(self, x, y):
        self.x, self.y = x, y

    def to_parquet_row(self):
        return {"x": self.x, "y": self.y}

    @classmethod
    def from_parquet_row(cls, row):
        return cls(row["x"], row["y"])

    def __eq__(self, other):
        return (self.x, self.y) == (other.x, other.y)


def test_custom_marshaller_hooks(tmp_path):
    (_n, got), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [Point(3, 4)], read_type=Point,
        schema_text="message p { required int64 x; required int64 y; }"))
    assert [(g.x, g.y) for g in got] == [(3, 4)]


def test_unmarshalable_raises(tmp_path):
    texts = []
    for pkg in BOTH:
        schema = pkg.dsl.parse_schema_definition(
            "message m { required int64 x; }")
        with pkg.floor.Writer(str(tmp_path / f"{pkg.name}.parquet"),
                              schema=schema) as w:
            got = _outcome(w.write, 42)
            with pytest.raises(pkg.marshal.MarshalError):
                w.write(42)
        texts.append(got)
    assert texts[0] == texts[1] and texts[0][1] == "MarshalError"


@dataclasses.dataclass
class Addr:
    city: str
    zip: Optional[str]


@dataclasses.dataclass
class Person:
    name: str
    addr: Optional[Addr]
    previous: List[Addr]


def test_nested_dataclasses(tmp_path):
    people = [Person("ann", Addr("berlin", "10115"), [Addr("munich", None)]),
              Person("bob", None, [])]
    (_n, got), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, people, obj_type=Person, read_type=Person))
    assert got == people


@dataclasses.dataclass
class Sched:
    at: datetime.time


def test_datetime_time_field(tmp_path):
    s = Sched(at=datetime.time(8, 45, 30, tzinfo=UTC))
    (_n, got), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [s], obj_type=Sched, read_type=Sched))
    assert got[0].at.replace(tzinfo=UTC) == s.at


def test_int96_and_timestamp_string_unix_parity(tmp_path):
    dt = datetime.datetime(2021, 1, 1, 12, 0, 0, tzinfo=UTC)
    unix_s = int(dt.timestamp())
    rows = [
        {"ts": unix_s, "lt": "2021-01-01T12:00:00+00:00"},
        {"ts": unix_s * 1000, "lt": "2021-01-01 12:00:00+00:00"},
        {"ts": unix_s * 1_000_000, "lt": dt},
        {"ts": str(unix_s), "lt": dt},
        {"ts": "2021-01-01T12:00:00Z", "lt": dt},
    ]
    (_n, out), _ = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, rows, schema_text="message m { required int96 ts; "
        "required int64 lt (TIMESTAMP(MILLIS, true)); }"))
    assert out == [{"ts": dt, "lt": dt}] * 5


def test_int96_implausible_unix_int_rejected(tmp_path):
    texts = []
    for pkg in BOTH:
        schema = pkg.dsl.parse_schema_definition(
            "message m { required int96 ts; }")
        w = pkg.floor.Writer(str(tmp_path / f"{pkg.name}.parquet"), schema)
        texts.append(_outcome(w.write, {"ts": 10**20}))
        w.close()
    assert texts[0] == texts[1] and texts[0][1] == "MarshalError"


def test_all_null_byte_array_chunk_statistics(tmp_path):
    _r, path = _both(tmp_path, lambda pkg, p: _write_read(
        pkg, p, [{"s": None}] * 10,
        schema_text="message m { optional binary s (STRING); }"))
    st = read_file_metadata(path).row_groups[0].columns[0].meta_data.statistics
    assert st is not None and st.null_count == 10
    assert st.min_value is None and st.max_value is None
    assert pq.read_table(path)["s"].to_pylist() == [None] * 10


# ---------------------------------------------------------------------------
# the row builder (tests/test_floor_builder.py)
# ---------------------------------------------------------------------------

BUILDER_SCHEMA = """message test {
  required int64 id;
  optional binary name (STRING);
  required group who {
    required binary first (STRING);
    optional binary last (STRING);
  }
  optional group tags (LIST) {
    repeated group list {
      required binary element (STRING);
    }
  }
  optional group attrs (MAP) {
    repeated group key_value {
      required binary key (STRING);
      optional int64 value;
    }
  }
}"""

SCHEMA_BAG = """message athena {
  optional group tags (LIST) {
    repeated group bag {
      optional binary array_element (STRING);
    }
  }
}"""


def _build_row(pkg, root, i):
    b = pkg.builder.RowBuilder(root)
    b.field("id").set(i)
    if i % 3:
        b.field("name").set(f"name{i}".encode())
    who = b.field("who").group()
    who.field("first").set(b"Hans")
    if i % 2:
        who.field("last").set(b"Mustermann")
    lst = b.field("tags").list()
    for k in range(i % 4):
        lst.add().set(f"tag{k}".encode())
    m = b.field("attrs").map()
    for k in range(i % 3):
        kel, vel = m.add()
        kel.set(f"k{k}".encode())
        vel.set(i * 10 + k)
    return b.data


def test_builder_roundtrip(tmp_path):
    def case(pkg, p):
        schema = pkg.dsl.parse_schema_definition(BUILDER_SCHEMA)
        rows = [_build_row(pkg, schema.root, i) for i in range(50)]
        with pkg.writer.FileWriter(p, schema, codec=1) as w:
            for r in rows:
                w.write_row(r)
        with pkg.reader.FileReader(p) as r:
            got = list(r.iter_rows())
        views = []
        for row in got:
            v = pkg.builder.RowView(row, schema.root)
            views.append((
                v.field("id").int64(),
                v.field("name").bytes() if row.get("name") is not None
                else None,
                v.field("who").group().field("first").bytes(),
                [e.bytes() for e in v.field("tags").list()],
                {k.bytes(): val.int64() for k, val in v.field("attrs").map()}))
        return rows, got, views

    (rows, got, views), _ = _both(tmp_path, case)
    assert len(got) == 50
    for i, (ident, name, first, tags, attrs) in enumerate(views):
        assert ident == i and first == b"Hans"
        assert name == (f"name{i}".encode() if i % 3 else None)
        assert tags == [f"tag{k}".encode() for k in range(i % 4)]
        assert attrs == {f"k{k}".encode(): i * 10 + k for k in range(i % 3)}


def test_builder_athena_bag_shape():
    out = []
    for pkg in BOTH:
        schema = pkg.dsl.parse_schema_definition(SCHEMA_BAG)
        b = pkg.builder.RowBuilder(schema.root)
        lst = b.field("tags").list()
        lst.add().set(b"x")
        lst.add().set(b"y")
        v = pkg.builder.RowView(b.data, schema.root)
        out.append((b.data, [e.bytes() for e in v.field("tags").list()]))
    assert out[0] == out[1] == (
        {"tags": {"bag": [{"array_element": b"x"},
                          {"array_element": b"y"}]}}, [b"x", b"y"])


def test_view_errors():
    out = []
    for pkg in BOTH:
        schema = pkg.dsl.parse_schema_definition(BUILDER_SCHEMA)
        v = pkg.builder.RowView({"id": 7, "who": {"first": b"a"}},
                                schema.root)
        with pytest.raises(pkg.builder.FieldNotPresent):
            v.field("missing")
        assert issubclass(pkg.builder.FieldNotPresent, KeyError)
        out.append((_outcome(v.field, "missing")[:2],
                    _outcome(v.field("id").bytes),
                    _outcome(v.field("id").group),
                    v.field("id").int64()))
    assert out[0] == out[1]
    assert out[0][0] == ("raise", "FieldNotPresent")
    assert out[0][1][1] == out[0][2][1] == "ParquetError"
    assert out[0][3] == 7


def test_builder_without_schema_defaults_standard_list():
    out = []
    for pkg in BOTH:
        b = pkg.builder.RowBuilder()
        b.field("tags").list().add().set(b"a")
        out.append(b.data)
    assert out[0] == out[1] == {"tags": {"list": [{"element": b"a"}]}}
