"""Predicate pushdown in the port's readers against the JAX package's.

``tpu_parquet_torch.device_reader.DeviceFileReader(path, row_filter=...,
device="cpu")`` runs beside ``tpu_parquet.device_reader``'s under
``TPQ_PALLAS=1 TPQ_FUSE=1`` (its Pallas kernels in interpret mode; the
port runs its kernels' plain versions).  Row groups whose footer
statistics exclude the filter are skipped whole; inside a surviving flat
group, page runs the page headers' statistics exclude are skipped when
their edges are page edges of every selected column.  The files, made from
numpy seeds, each with a sorted ``k`` key:

- PLAIN fixed-width columns, uncompressed (K2's ``fused_plain``) and
  SNAPPY (``device_snappy`` and the narrow routes);
- dictionary columns (the fused K1 on the index streams), DELTA_BINARY_PACKED,
  PLAIN and dictionary strings, an OPTIONAL column with nulls (def levels);
- pyarrow's dictionary fallback (``_finish_mixed_dict_plain``);
- misaligned page grids (no page pruning), a filter that falls between
  two pages (every page pruned: the placeholder columns), a nested file
  (group pruning only).

Each read is compared exactly, unforced and under each of the seven
``TPQ_FORCE_ROUTE`` names, at ``prefetch`` 0 and 4: ``to_host()``,
``levels_to_host()``, the column classes, ``pages_pruned``, ``rows``,
``chunks``, ``pages``, ``compressed_bytes``, the ship routes with their
link bytes, ``staged_bytes`` (on files without level streams; across depths
on the others), and the plan's route memo with its kernel families.  Also
``iter_batches`` under a filter, ``scan_files(row_filter=...)`` over three
files, and the host ``FileReader``'s group pruning.
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tests.test_torch_host_prefetch import _make_nested
from tpu_parquet import device_reader as RDR
from tpu_parquet import predicate as RP
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import predicate as P
from tpu_parquet_torch.column import ByteArrayData, ColumnData
from tpu_parquet_torch.format import (CompressionCodec, Encoding,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.ship import ROUTES
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

DEPTHS = [0, 4]
G, N = 3, 4096  # row groups x rows per group
S, GZ, U = (CompressionCodec.SNAPPY, CompressionCodec.GZIP,
            CompressionCodec.UNCOMPRESSED)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_thread_outlives_a_test():
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _strings(values):
    raw = [v.encode() for v in values]
    offs = np.cumsum([0] + [len(x) for x in raw]).astype(np.int64)
    return ColumnData(values=ByteArrayData(
        offsets=offs, heap=np.frombuffer(b"".join(raw), np.uint8).copy()))


def _port_file(path, cols, codec, *, dictionary=False, encodings=None,
               optional=(), page_size=2048, version=1):
    """``G`` row groups of ``N`` rows through the port's writer: ``k``
    sorted (k = 3 * row), then ``cols`` {name: (type, maker(rng, lo, n))}."""
    rng = np.random.default_rng(41)
    fields = [data_column("k", Type.INT64, FRT.REQUIRED)]
    for name, (ptype, _make) in cols.items():
        rep = FRT.OPTIONAL if name in optional else FRT.REQUIRED
        fields.append(data_column(name, ptype, rep))
    with FileWriter(path, build_schema(fields), codec=codec,
                    use_dictionary=dictionary, write_crc=True,
                    page_size=page_size, data_page_version=version,
                    column_encodings=encodings) as w:
        for g in range(G):
            lo = g * N
            batch = {"k": np.arange(lo, lo + N, dtype=np.int64) * 3}
            for name, (_ptype, make) in cols.items():
                part = make(rng, lo, N)
                if name in optional:
                    present = rng.random(N) >= 0.15
                    part = ColumnData(values=part[present],
                                      def_levels=present.astype(np.int32),
                                      max_def=1, num_leaf_slots=N)
                batch[name] = part
            w.write_columns(batch)
            w.flush_row_group()


I64 = (Type.INT64, lambda rng, lo, n: rng.integers(0, 1 << 40, n))
NARROW = (Type.INT64, lambda rng, lo, n: rng.integers(0, 50_000, n))
DBL = (Type.DOUBLE, lambda rng, lo, n: rng.uniform(0, 1e6, n))
I32 = (Type.INT32, lambda rng, lo, n: rng.integers(-1000, 1000, n)
       .astype(np.int32))
LOWCARD = (Type.INT32, lambda rng, lo, n: rng.integers(0, 40, n)
           .astype(np.int32))
LOWDBL = (Type.DOUBLE, lambda rng, lo, n: np.round(
    rng.integers(0, 60, n) * 1.25, 2))
STR4 = (Type.BYTE_ARRAY, lambda rng, lo, n: _strings(
    [f"s{int(x):03d}" for x in rng.integers(0, 700, n)]))


def _fallback_file(path):
    """pyarrow's dictionary fallback: a dictionary-encoded prefix of pages,
    then PLAIN pages, in both columns."""
    n = G * N
    rng = np.random.default_rng(43)
    table = pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64) * 3, pa.int64()),
        "x": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
    })
    pq.write_table(table, path, row_group_size=N, data_page_size=2048,
                   dictionary_pagesize_limit=4096, compression="snappy",
                   write_batch_size=256)


def _misaligned_file(path):
    """The reference test's grids: INT64, INT32 and varying strings pages
    (375/750/333 rows) share no interior edge."""
    n = 30000
    k = np.arange(n, dtype=np.int64) * 3
    v32 = (np.arange(n) % 1000).astype(np.int32)
    s = _strings([f"sv{i % 300:03d}" for i in range(n)])
    schema = build_schema([
        data_column("k", Type.INT64, FRT.REQUIRED),
        data_column("v32", Type.INT32, FRT.REQUIRED),
        data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED),
    ])
    with FileWriter(path, schema, codec=S, use_dictionary=False,
                    page_size=3000, row_group_size=1 << 22) as w:
        w.write_columns({"k": k, "v32": v32, "s": s})


def _nested_file(path):
    _make_nested(path, rows=3000)
    table = pq.read_table(path)
    pq.write_table(table, path, row_group_size=1000)


FILES = {
    "plain": lambda p: _port_file(p, {"v": I64, "f": DBL, "w": I32}, U),
    "snappy": lambda p: _port_file(p, {"v": NARROW, "f": DBL, "w": I32}, S),
    "dict": lambda p: _port_file(p, {"d": LOWCARD, "e": LOWDBL}, GZ,
                                 dictionary=True),
    "delta": lambda p: _port_file(
        p, {"v": NARROW}, S,
        encodings={"k": Encoding.DELTA_BINARY_PACKED,
                   "v": Encoding.DELTA_BINARY_PACKED}),
    "strings_plain": lambda p: _port_file(p, {"s": STR4}, S),
    "strings_dict": lambda p: _port_file(p, {"s": STR4}, GZ,
                                         dictionary=True),
    "optional": lambda p: _port_file(p, {"v": I64, "w": I32}, GZ,
                                     optional=("v",), version=2),
    "fallback": _fallback_file,
    "misaligned": _misaligned_file,
}

# the window: inside row group 1 (rows 4096..8191), page edges at 256 rows
WINDOW = (3 * (N + 1000), 3 * (N + 1700))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_pruning")
    out = {}
    for name, make in {**FILES, "nested": _nested_file}.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


def _host(col):
    v = col.to_host()
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        v = (np.asarray(v.offsets), np.asarray(v.heap))
    else:
        v = (np.asarray(v),)
    return type(col).__name__, v, col.levels_to_host()


def _same(got, want, where):
    (gcls, gv, (gd, gr)), (wcls, wv, (wd, wr)) = got, want
    assert gcls == wcls, where
    assert len(gv) == len(wv), where
    for g, w in zip(gv, wv):
        assert g.dtype == w.dtype and g.shape == w.shape, where
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), where
    for g, w in ((gd, wd), (gr, wr)):
        assert (g is None) == (w is None), where
        if w is not None:
            assert np.array_equal(np.asarray(g), np.asarray(w)), where


def _same_outs(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for name in w:
            _same(g[name], w[name], (i, name))


KEYS = ("row_groups", "chunks", "pages", "pages_pruned", "rows",
        "compressed_bytes", "link_bytes_logical", "link_bytes_shipped",
        "fused_fallbacks", "pages_device_expanded")


def _read(reader):
    with reader as r:
        outs = [{k: _host(v) for k, v in g.items()}
                for g in r.iter_row_groups()]
        st = r.stats().as_dict()
        routes = {n: (v["streams"], v["logical"], v["shipped"])
                  for n, v in st["ship_routes"].items()}
        return (outs, {k: st[k] for k in KEYS}, routes, st["staged_bytes"],
                r._plan.routes_table())


def _filter(M, name):
    if name == "nested":
        return M.col("id").between(1200, 1500)
    if name == "fallback":
        # the dictionary-encoded prefix pages and the first PLAIN ones
        return M.col("k").between(3 * (N + 300), 3 * (N + 900))
    if name == "gap":
        # between two adjacent pages of k: no page can hold a match
        return (M.col("k") > 3 * 255) & (M.col("k") < 3 * 256)
    return M.col("k").between(*WINDOW)


def _check(files, name, fname=None, columns=None, staged_ref=False):
    """Read ``name`` under its filter with both packages (the port at each
    depth) and compare; ``staged_ref`` also holds ``staged_bytes`` to the
    reference's.  Returns the reference's read."""
    path = files[name]
    fname = fname or name
    want = _read(RDR.DeviceFileReader(path, row_filter=_filter(RP, fname),
                                      columns=columns))
    staged = set()
    for k in DEPTHS:
        CK.reset_launches()
        got = _read(DR.DeviceFileReader(path, row_filter=_filter(P, fname),
                                        columns=columns, device="cpu",
                                        prefetch=k))
        assert set(CK.launches.values()) == {0}
        _same_outs(got[0], want[0])
        assert got[1] == want[1], k
        assert got[2] == want[2], k
        assert got[4] == want[4], k
        if staged_ref:
            assert got[3] == want[3], k
        staged.add(got[3])
    assert len(staged) == 1
    return want


LEVELLED = {"optional", "fallback"}  # def-level streams: staged differs


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", list(FILES))
def test_filtered_read_matches_the_reference(files, reference_env, name,
                                             route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    _outs, counters, *_ = _check(files, name,
                                 staged_ref=name not in LEVELLED)
    if name == "misaligned":
        assert counters["pages_pruned"] == 0
    else:
        assert counters["row_groups"] == 1  # groups 0 and 2 pruned
    if name not in ("misaligned", "fallback"):
        assert counters["pages_pruned"] > 0
        assert counters["rows"] < N


def test_rows_are_the_generators_window(files, reference_env):
    """The yielded rows are whole pages: a superset of the window, row
    aligned in every column."""
    with DR.DeviceFileReader(files["plain"], row_filter=_filter(P, "k"),
                             device="cpu") as r:
        (g,) = list(r.iter_row_groups())
        st = r.stats()
    k = g["k"].to_host()
    lo, hi = WINDOW
    assert k[0] <= lo and k[-1] >= hi and len(k) == st.rows
    assert np.array_equal(np.diff(k), np.full(len(k) - 1, 3))
    assert k[0] % (3 * 256) == 0  # starts on a page edge
    assert all(len(c.to_host()) == len(k) for c in g.values())


@pytest.mark.parametrize("route", ["unforced", "plain", "fused_plain"])
def test_fully_pruned_group_gives_placeholders(files, reference_env, route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    outs, counters, *_ = _check(files, "plain", fname="gap")
    assert counters["rows"] == 0 and counters["pages"] == 0
    assert counters["pages_pruned"] > 0
    (g,) = outs
    for name, (cls, (vals,), _lv) in g.items():
        assert cls == "DeviceColumnData" and vals.dtype == np.int64
        assert len(vals) == 0, name


def test_nested_file_prunes_groups_only(files, reference_env):
    outs, counters, *_ = _check(files, "nested", columns=["id", "items"])
    assert counters["pages_pruned"] == 0
    assert counters["row_groups"] == 1 and counters["rows"] == 1000


@pytest.mark.parametrize("k", DEPTHS)
def test_iter_batches_under_a_filter(files, reference_env, k):
    path = files["plain"]
    with RDR.DeviceFileReader(path, row_filter=_filter(RP, "k")) as r:
        want = [{n: np.asarray(v) for n, v in b.items()}
                for b in r.iter_batches(300)]
    with DR.DeviceFileReader(path, row_filter=_filter(P, "k"), device="cpu",
                             prefetch=k) as r:
        got = [{n: v.numpy() for n, v in b.items()}
               for b in r.iter_batches(300)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for n in w:
            # the reference's DOUBLE batches are uint32 word pairs
            assert np.array_equal(
                g[n].view(np.uint8).reshape(-1),
                np.ascontiguousarray(w[n]).view(np.uint8).reshape(-1)), n


@pytest.mark.parametrize("k", DEPTHS)
def test_scan_files_with_a_filter(files, reference_env, k):
    paths = [files["plain"], files["dict"], files["snappy"]]
    want = [(p, {n: _host(c) for n, c in g.items()})
            for p, g in RDR.scan_files(paths, row_filter=_filter(RP, "k"),
                                       with_path=True, prefetch=k)]
    got = [(p, {n: _host(c) for n, c in g.items()})
           for p, g in DR.scan_files(paths, row_filter=_filter(P, "k"),
                                     with_path=True, prefetch=k,
                                     device="cpu")]
    assert [p for p, _ in got] == [p for p, _ in want] == paths
    _same_outs([g for _, g in got], [w for _, w in want])


def test_scan_files_skips_a_whole_pruned_file(files, reference_env,
                                              monkeypatch):
    """A file the filter prunes whole is not read past its footer."""
    reads = []
    real = DR._RowGroupStager.add_segments

    def spy(self, segments):
        reads.append(len(segments))
        return real(self, segments)

    monkeypatch.setattr(DR._RowGroupStager, "add_segments", spy)
    far = P.col("k") > 10 ** 9
    assert list(DR.scan_files([files["plain"], files["dict"]],
                              row_filter=far, device="cpu")) == []
    assert reads == []


@pytest.mark.parametrize("name", ["plain", "dict", "nested"])
def test_host_reader_prunes_groups(files, name):
    path = files[name]
    with RefReader(path, row_filter=_filter(RP, name)) as ref, \
            FileReader(path, row_filter=_filter(P, name)) as r:
        assert ([r.row_group_selected(i) for i in range(r.num_row_groups)]
                == [ref.row_group_selected(i)
                    for i in range(ref.num_row_groups)])
        assert r.num_selected_rows == ref.num_selected_rows < r.num_rows
        for k in DEPTHS:
            want = ref.read_all(prefetch=k)
            got = r.read_all(prefetch=k)
            assert list(got) == list(want)
            for n in want:
                g, w = got[n], want[n]
                gv, wv = g.values, w.values
                if isinstance(wv, np.ndarray):
                    assert np.array_equal(gv.view(np.uint8),
                                          wv.view(np.uint8)), n
                else:
                    assert np.array_equal(gv.offsets, wv.offsets), n
                    assert np.array_equal(gv.heap, wv.heap), n
                for lv in ("def_levels", "rep_levels"):
                    a, b = getattr(g, lv), getattr(w, lv)
                    assert (a is None) == (b is None)
                    if b is not None:
                        assert np.array_equal(a, b)


def test_host_rows_skip_pruned_groups(files):
    path = files["plain"]
    with FileReader(path, row_filter=_filter(P, "k")) as r:
        rows = list(r.iter_rows())
    assert len(rows) == N and rows[0]["k"] == 3 * N
