"""The port's ``predicate`` module against the JAX package's.

``tpu_parquet_torch.predicate`` is a copy of ``tpu_parquet.predicate``: the
same algebra, the same statistics decoding (with its refusals for unsigned,
decimal and legacy byte-array bounds, and the NaN rule for floats), the
same ``parse_filter`` grammar.  Each check builds one predicate in both
algebras from one spec and compares, exactly:

- ``prune_row_groups`` verdicts on files with sorted and unsorted keys,
  strings, NaN, an all-null group, unsigned and decimal columns and a
  file written without statistics;
- ``prune_pages`` through both packages' ``scanplan.plan_page_pruning``
  (skip sets per column and rows dropped), row group by row group;
- ``parse_filter`` on the reference's accepted and rejected inputs (the
  parsed trees' reprs, and the error texts);
- a seeded sweep of 300 random predicates, each also checked for
  soundness against the rows (a pruned group or page run holds no match).
"""

import math

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpu_parquet import predicate as RP
from tpu_parquet import scanplan as RSP
from tpu_parquet.errors import ParquetError as RefParquetError
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import predicate as P
from tpu_parquet_torch import scanplan as SP
from tpu_parquet_torch.errors import ParquetError
from tpu_parquet_torch.format import (CompressionCodec,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

GROUPS, ROWS = 6, 600


def _ints_file(path, stats=True):
    """``a`` sorted inside each group and rising across groups, ``b`` a
    DOUBLE band per group, ``x`` an OPTIONAL INT32 with nulls (group 2
    all null), small pages so each group holds several."""
    rng = np.random.default_rng(5)
    schema = build_schema([
        data_column("a", Type.INT64, FRT.REQUIRED),
        data_column("b", Type.DOUBLE, FRT.REQUIRED),
        data_column("x", Type.INT32, FRT.OPTIONAL),
    ])
    rows = {"a": [], "b": [], "x": []}
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    use_dictionary=False, page_size=1024,
                    write_statistics=stats) as w:
        for g in range(GROUPS):
            a = np.sort(g * 1000 + rng.integers(0, 500, ROWS))
            b = g + rng.uniform(0, 1, ROWS)
            x = [None if (g == 2 or rng.random() < 0.3)
                 else int(rng.integers(-50, 50)) for _ in range(ROWS)]
            for i in range(ROWS):
                w.write_row({"a": int(a[i]), "b": float(b[i]), "x": x[i]})
            w.flush_row_group()
            rows["a"] += a.tolist()
            rows["b"] += b.tolist()
            rows["x"] += x
    return rows


def _arrow_file(path):
    """pyarrow: a sorted string key, a shuffled int, doubles with NaN, an
    OPTIONAL column all null in group 1, unsigned ints and a decimal."""
    rng = np.random.default_rng(9)
    n = GROUPS * ROWS
    s = [f"k{i:06d}" for i in range(n)]
    u = rng.integers(0, 1 << 31, n)
    d = rng.uniform(-100, 100, n)
    d[rng.random(n) < 0.05] = np.nan
    opt = [None if (ROWS <= i < 2 * ROWS or rng.random() < 0.2)
           else int(rng.integers(0, 100)) for i in range(n)]
    import decimal

    dec = [decimal.Decimal(int(v)) / 100 for v in rng.integers(0, 99999, n)]
    table = pa.table({
        "s": pa.array(s, pa.string()),
        "r": pa.array(rng.permutation(n), pa.int64()),
        "d": pa.array(d, pa.float64()),
        "o": pa.array(opt, pa.int32()),
        "u32": pa.array(u.astype(np.uint32), pa.uint32()),
        "u64": pa.array(u.astype(np.uint64), pa.uint64()),
        "dec": pa.array(dec, pa.decimal128(9, 2)),
    })
    pq.write_table(table, path, row_group_size=ROWS, data_page_size=512,
                   use_dictionary=False, compression="snappy")
    return {name: table.column(name).to_pylist() for name in table.column_names}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_predicate")
    paths = {n: str(root / f"{n}.parquet") for n in ("ints", "nostats",
                                                      "arrow")}
    _ints_file(paths["nostats"], stats=False)
    return {"ints": (paths["ints"], _ints_file(paths["ints"])),
            "nostats": (paths["nostats"], None),
            "arrow": (paths["arrow"], _arrow_file(paths["arrow"]))}


def build(M, spec):
    """One predicate from ``spec`` in the algebra of module ``M``."""
    kind = spec[0]
    if kind == "and":
        return build(M, spec[1]) & build(M, spec[2])
    if kind == "or":
        return build(M, spec[1]) | build(M, spec[2])
    if kind == "not":
        return ~build(M, spec[1])
    c = M.col(spec[1])
    if kind == "null":
        return c.is_null() if spec[2] else c.not_null()
    if kind == "between":
        return c.between(spec[2], spec[3])
    op, v = spec[2], spec[3]
    return {"lt": lambda: c < v, "le": lambda: c <= v, "gt": lambda: c > v,
            "ge": lambda: c >= v, "eq": lambda: c == v,
            "ne": lambda: c != v}[op]()


def _eval(spec, row):
    """SQL truth of ``spec`` on one row: True, or False/None (no match)."""
    kind = spec[0]
    if kind in ("and", "or"):
        a, b = _eval(spec[1], row), _eval(spec[2], row)
        if kind == "and":
            return False if (a is False or b is False) else (
                None if (a is None or b is None) else True)
        return True if (a is True or b is True) else (
            None if (a is None or b is None) else False)
    if kind == "not":
        a = _eval(spec[1], row)
        return None if a is None else not a
    v = row[spec[1]]
    if kind == "null":
        return (v is None) == spec[2]
    if v is None or (isinstance(v, float) and math.isnan(v)):
        # NULL: unknown; NaN: fails every ordered comparison, ne holds
        if v is not None and kind == "cmp" and spec[2] == "ne":
            return True
        return None if v is None else False
    if isinstance(v, str):
        v = v.encode()
    lits = [x.encode() if isinstance(x, str) else x for x in spec[2:]]
    try:
        if kind == "between":
            return lits[0] <= v <= lits[1]
        lit = lits[1]
        return {"lt": v < lit, "le": v <= lit, "gt": v > lit,
                "ge": v >= lit, "eq": v == lit, "ne": v != lit}[spec[2]]
    except TypeError:
        return None  # an incomparable literal matches nothing


def _group_rows(data, g):
    """Group ``g``'s rows of a file's ``{column: list}`` as dicts."""
    return [{n: data[n][i] for n in data}
            for i in range(g * ROWS, (g + 1) * ROWS)]


def _both_prunes(path, spec, pages=True):
    """(row-group verdicts, per-group page plans) of both packages."""
    out = []
    for M, S, Reader in ((RP, RSP, RefReader), (P, SP, FileReader)):
        pred = build(M, spec)
        with Reader(path) as r:
            keep = M.prune_row_groups(r.metadata, r.schema, pred)
            plans = []
            if pages:
                leaves = {l.path: l for l in r.schema.selected_leaves()}
                for rg in r.metadata.row_groups:
                    r._f.seek(0)
                    skip, dropped, bufs = S.plan_page_pruning(
                        rg, leaves, r.schema, pred, r._f)
                    plans.append((skip, dropped, sorted(bufs)))
        out.append((keep, plans))
    return out


INT_SPECS = [
    ("cmp", "a", "gt", 3500), ("cmp", "a", "le", 1200),
    ("and", ("cmp", "a", "ge", 2000), ("cmp", "a", "lt", 3000)),
    ("or", ("cmp", "a", "lt", 100), ("cmp", "a", "gt", 5300)),
    ("not", ("cmp", "a", "gt", 2500)), ("between", "a", 1100, 1300),
    ("cmp", "a", "eq", 4003), ("cmp", "a", "ne", 7),
    ("cmp", "b", "lt", 2.5), ("cmp", "b", "ge", 4.0),
    ("cmp", "x", "gt", 40), ("null", "x", True), ("null", "x", False),
    ("cmp", "x", "eq", 3), ("not", ("null", "x", False)),
    ("cmp", "a", "gt", "text"),  # incomparable literal: no evidence
]

ARROW_SPECS = [
    ("cmp", "s", "lt", "k000700"), ("between", "s", "k001200", "k001300"),
    ("cmp", "s", "ge", "k003000"), ("cmp", "s", "eq", b"k000005"),
    ("cmp", "r", "lt", 10), ("cmp", "d", "gt", 99.0),
    ("cmp", "d", "ne", 0.5), ("not", ("cmp", "d", "lt", 1000.0)),
    ("cmp", "o", "gt", 10), ("null", "o", True), ("null", "o", False),
    ("cmp", "u32", "lt", 5), ("cmp", "u64", "gt", 1 << 40),
    ("cmp", "dec", "lt", 0), ("and", ("cmp", "s", "lt", "k000100"),
                              ("cmp", "r", "gt", 0)),
]


@pytest.mark.parametrize("name,specs", [("ints", INT_SPECS),
                                        ("nostats", INT_SPECS),
                                        ("arrow", ARROW_SPECS)])
def test_pruning_verdicts_match_the_reference(files, name, specs):
    path, data = files[name]
    pruned_any = False
    for spec in specs:
        want, got = _both_prunes(path, spec)
        assert got == want, spec
        keep, plans = got
        pruned_any |= not all(keep) or any(p[0] for p in plans)
        if data is not None:
            _assert_sound(path, data, spec, keep, plans)
    # files with statistics prune somewhere; the one without never does
    assert pruned_any == (name != "nostats")


def _assert_sound(path, data, spec, keep, plans):
    for g in range(GROUPS):
        rows = _group_rows(data, g)
        hits = [i for i, row in enumerate(rows) if _eval(spec, row) is True]
        if not keep[g]:
            assert not hits, (spec, g)
            continue
        skip, dropped, _ = plans[g]
        if skip:
            gone = _skipped_rows(path, g, skip)
            assert len(gone) == dropped and not set(hits) & gone, (spec, g)


def _skipped_rows(path, g, skip, column=None):
    """Rows of group ``g`` the skip set of ``column`` (default: the first
    skipped column) drops, from its page headers' value counts."""
    from tpu_parquet_torch.chunk_decode import validate_chunk_meta

    with FileReader(path) as r:
        leaves = {l.path: l for l in r.schema.leaves}
        rg = r.metadata.row_groups[g]
        want = column if column is not None else sorted(skip)[0]
        for chunk in rg.columns:
            path_t = tuple(chunk.meta_data.path_in_schema)
            if path_t != want:
                continue
            md, off = validate_chunk_meta(chunk, leaves[path_t])
            hdrs = SP.walk_header_pages(r._f, off, md.total_compressed_size,
                                        md.num_values)
            start, rows = 0, set()
            for i, h in enumerate(hdrs):
                end = start + (h.data_page_header
                               or h.data_page_header_v2).num_values
                if i in skip.get(path_t, ()):
                    rows |= set(range(start, end))
                start = end
            return rows
    raise AssertionError(f"no chunk {column}")


def test_page_runs_are_whole_pages_of_every_column(files):
    """The skip sets drop the same rows in every selected column, and
    exactly ``rows_dropped`` of them."""
    path, _ = files["ints"]
    pred = build(P, ("between", "a", 1100, 1300))
    seen = 0
    with FileReader(path) as r:
        leaves = {l.path: l for l in r.schema.selected_leaves()}
        plans = [SP.plan_page_pruning(rg, leaves, r.schema, pred, r._f)
                 for rg in r.metadata.row_groups]
    for g, (skip, dropped, _bufs) in enumerate(plans):
        if skip is None:
            continue
        sets = [_skipped_rows(path, g, skip, c) for c in leaves]
        assert all(rs == sets[0] for rs in sets)
        assert len(sets[0]) == dropped > 0
        seen += 1
    assert seen


PARSE_OK = ["a > 3500", "3500 < a", "a > 2000 and a < 3000 or b < 0.5",
            "not (a > 3500)", "x == None", "x != None", "a >= -1",
            "s == 'k000001'", "s != b'raw'", "a.b.c <= 2.5",
            "not (a < 1 or b > 2) and x == None", "-3 >= a"]
PARSE_BAD = ["a >", "import os", "a + 1 > 2", "f(x) > 1", "a > b",
             "a > None", "1 < a < 3", "a in (1, 2)", "a > -b", "a is None",
             "a > [1]", "(a > 1) + 1"]


@pytest.mark.parametrize("text", PARSE_OK)
def test_parse_filter_accepts_as_the_reference(text):
    assert repr(P.parse_filter(text)) == repr(RP.parse_filter(text))


@pytest.mark.parametrize("text", PARSE_BAD)
def test_parse_filter_rejects_as_the_reference(text):
    with pytest.raises(RefParquetError) as want:
        RP.parse_filter(text)
    with pytest.raises(ParquetError) as got:
        P.parse_filter(text)
    assert str(got.value) == str(want.value)


def test_unknown_column_raises_the_reference_text(files):
    path, _ = files["ints"]
    with RefReader(path) as r:
        with pytest.raises(RefParquetError) as want:
            RP.prune_row_groups(r.metadata, r.schema, RP.col("zz") > 1)
    with FileReader(path) as r:
        with pytest.raises(ParquetError) as got:
            P.prune_row_groups(r.metadata, r.schema, P.col("zz") > 1)
    assert str(got.value) == str(want.value)


def test_stats_decoding_matches_the_reference(files):
    """``chunk_stats_range`` per chunk: bounds, null counts, types."""
    for name in ("ints", "arrow"):
        path, _ = files[name]
        with RefReader(path) as rr, FileReader(path) as r:
            rleaves = {tuple(l.path): l for l in rr.schema.leaves}
            leaves = {tuple(l.path): l for l in r.schema.leaves}
            for rrg, rg in zip(rr.metadata.row_groups, r.metadata.row_groups):
                for rc, c in zip(rrg.columns, rg.columns):
                    p_ = tuple(c.meta_data.path_in_schema)
                    want = RP.chunk_stats_range(rc.meta_data,
                                                rleaves[p_].element)
                    got = P.chunk_stats_range(c.meta_data, leaves[p_].element)
                    assert _norm(got) == _norm(want), (name, p_)


def _norm(t):
    return tuple(("nan" if isinstance(x, float) and math.isnan(x) else x)
                 for x in t)


def _random_spec(rng, cols, depth=0):
    if depth < 2 and rng.random() < 0.4:
        kind = ["and", "or", "not"][int(rng.integers(0, 3))]
        if kind == "not":
            return ("not", _random_spec(rng, cols, depth + 1))
        return (kind, _random_spec(rng, cols, depth + 1),
                _random_spec(rng, cols, depth + 1))
    name, lo, hi, isint = cols[int(rng.integers(0, len(cols)))]
    r = rng.random()
    if r < 0.1:
        return ("null", name, bool(rng.integers(0, 2)))

    def lit():
        v = rng.uniform(lo, hi)
        return int(v) if isint else float(v)

    if r < 0.25:
        a, b = sorted((lit(), lit()))
        return ("between", name, a, b)
    op = ["lt", "le", "gt", "ge", "eq", "ne"][int(rng.integers(0, 6))]
    return ("cmp", name, op, lit())


def test_random_predicate_sweep(files):
    """300 seeded predicates over the INT/DOUBLE/OPTIONAL file: the same
    verdicts and page plans in both packages, and sound on the rows."""
    path, data = files["ints"]
    cols = [("a", -100, 6000, True), ("b", -0.5, 6.5, False),
            ("x", -60, 60, True)]
    rng = np.random.default_rng(2024)
    for n in range(300):
        spec = _random_spec(rng, cols)
        want, got = _both_prunes(path, spec, pages=n % 5 == 0)
        assert got == want, spec
        keep, plans = got
        for g in range(GROUPS):
            if not keep[g]:
                rows = _group_rows(data, g)
                assert not any(_eval(spec, row) is True for row in rows), \
                    (spec, g)
