"""The port's host ``FileReader(prefetch=K)`` against the JAX package's.

``tpu_parquet_torch.reader.FileReader`` and ``tpu_parquet.reader.
FileReader`` read the same files at prefetch depths 0, 1 and 4 (the
chunk pipeline of ``pipeline.prefetch_map``, flattened across row
groups).  The files, made from numpy seeds: the pyarrow file of
``tests/test_pipeline.py`` (nullable INT64, DOUBLE, nullable strings and
INT32 over 8 row groups, SNAPPY), the same in GZIP, a nested file (a list
of structs and a map, through pyarrow) and a file with an empty row
group.  Compared exactly: ``read_all``, ``iter_row_groups``,
``read_row_group(i, prefetch=...)`` and a projection, bit for bit with
levels; ``pipeline_stats()``' chunk and row-group counts; ``max_memory``
bounding the bytes in flight; a corrupt page in the middle of the file
raising the reference's ``ParquetError`` text at every depth, with no
``tpq-prefetch`` thread left.
"""

import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tpu_parquet.column import ByteArrayData as RefBytes
from tpu_parquet.footer import ParquetError as RefError
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch.alloc import MemoryBudgetExceeded
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.footer import ParquetError
from tpu_parquet_torch.reader import FileReader
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


DEPTHS = [0, 1, 4]


@pytest.fixture(autouse=True)
def _no_thread_outlives_a_test():
    """No ``tpq-`` thread (the pools and the staging worker) that a test
    started is alive after it."""
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


def _make_flat(path, rows=40_000, row_group_size=5_000, compression="snappy"):
    """``tests/test_pipeline.py``'s file."""
    rng = np.random.default_rng(11)
    vals = [None if rng.random() < 0.2 else int(v)
            for v in rng.integers(0, 1 << 40, rows)]
    strs = [None if rng.random() < 0.2 else f"name_{i % 257:04d}"
            for i in range(rows)]
    table = pa.table({
        "v": pa.array(vals, pa.int64()),
        "d": pa.array(rng.uniform(0, 1e6, rows), pa.float64()),
        "s": pa.array(strs, pa.string()),
        "k": pa.array(rng.integers(0, 50, rows), pa.int32()),
    })
    pq.write_table(table, path, compression=compression,
                   row_group_size=row_group_size)


def _make_nested(path, rows=6_000):
    rng = np.random.default_rng(17)
    items = []
    for _ in range(rows):
        n = int(rng.integers(0, 5))
        items.append(None if rng.random() < 0.1 else [
            {"q": int(rng.integers(0, 100)),
             "p": None if rng.random() < 0.2 else float(rng.uniform(0, 9))}
            for _ in range(n)])
    attrs = [[(f"k{int(j)}", int(rng.integers(0, 1000)))
              for j in range(int(rng.integers(0, 3)))] for _ in range(rows)]
    table = pa.table({
        "id": pa.array(np.arange(rows), pa.int64()),
        "items": pa.array(items, pa.list_(pa.struct([("q", pa.int32()),
                                                     ("p", pa.float64())]))),
        "attrs": pa.array(attrs, pa.map_(pa.string(), pa.int64())),
    })
    pq.write_table(table, path, compression="snappy",
                   row_group_size=1_500)


def _make_with_empty_group(path):
    rng = np.random.default_rng(19)
    t = pa.table({"a": pa.array(rng.integers(0, 1 << 30, 3_000), pa.int64()),
                  "s": pa.array([f"x{i % 13}" for i in range(3_000)])})
    with pq.ParquetWriter(path, t.schema, compression="gzip") as w:
        w.write_table(t)
        w.write_table(t.slice(0, 0))
        w.write_table(t)


FILES = {
    "flat_snappy": _make_flat,
    "flat_gzip": lambda p: _make_flat(p, rows=8_000, row_group_size=2_000,
                                      compression="gzip"),
    "nested": _make_nested,
    "empty_group": _make_with_empty_group,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_host_prefetch")
    out = {}
    for name, make in FILES.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


def _same_column(got, want, name):
    assert got.num_leaf_slots == want.num_leaf_slots, name
    assert (got.max_def, got.max_rep) == (want.max_def, want.max_rep), name
    for attr in ("def_levels", "rep_levels"):
        g, w = getattr(got, attr), getattr(want, attr)
        assert (g is None) == (w is None), (name, attr)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, attr)
    if isinstance(want.values, RefBytes):
        assert isinstance(got.values, ByteArrayData), name
        assert np.array_equal(got.values.offsets, want.values.offsets), name
        assert np.array_equal(got.values.heap, want.values.heap), name
    else:
        g, w = np.asarray(got.values), np.asarray(want.values)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), name


def _same_group(got, want):
    assert list(got) == list(want)
    for name in want:
        _same_column(got[name], want[name], name)


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("name", list(FILES))
def test_read_all_and_iteration_match_the_reference(files, name, k):
    path = files[name]
    with FileReader(path, prefetch=k) as r, RefReader(path, prefetch=k) as ref:
        got_groups = list(r.iter_row_groups())
        want_groups = list(ref.iter_row_groups())
        assert len(got_groups) == len(want_groups) == r.num_row_groups
        for g, w in zip(got_groups, want_groups):
            _same_group(g, w)
        gs, ws = r.pipeline_stats(), ref.pipeline_stats()
        assert (gs.chunks, gs.row_groups) == (ws.chunks, ws.row_groups)
        if k:
            assert gs.row_groups == r.num_row_groups
            assert gs.chunks == sum(len(rg.columns)
                                    for rg in r.metadata.row_groups)
        if name == "empty_group":
            # both packages' read_all fails to join an empty string chunk
            # (decoded as an empty array) to the others (ROADMAP Queue 3)
            return
        _same_group(r.read_all(), ref.read_all())
        # the per-call depth overrides the reader's
        _same_group(r.read_all(prefetch=4 - k), ref.read_all(prefetch=k))


@pytest.mark.parametrize("k", DEPTHS)
def test_read_row_group_and_projection_match(files, k):
    path = files["flat_snappy"]
    cols = ["v", "s"]
    with FileReader(path, columns=cols, prefetch=k) as r, \
            RefReader(path, columns=cols) as ref:
        for i in (0, 3, 7):
            want = ref.read_row_group(i, prefetch=0)
            _same_group(r.read_row_group(i), want)
            _same_group(r.read_row_group(i, prefetch=3), want)
            _same_group(r.read_row_group(i, prefetch=0), want)
        with pytest.raises(IndexError):
            r.read_row_group(8, prefetch=k)


def test_bytes_source_takes_the_locked_reads(files):
    with open(files["flat_gzip"], "rb") as f:
        raw = f.read()
    want = RefReader(raw).read_all()
    for k in DEPTHS:
        r = FileReader(raw, prefetch=k)
        assert not r._sr.parallel
        _same_group(r.read_all(), want)


def _chunk_costs(path):
    with FileReader(path) as r:
        costs = []
        for rg in r.metadata.row_groups:
            for cc in rg.columns:
                md = cc.meta_data
                comp = md.total_compressed_size
                costs.append(comp + max(md.total_uncompressed_size or 0,
                                        comp))
    return costs


def test_max_memory_bounds_in_flight_bytes(files):
    path = files["flat_snappy"]
    costs = _chunk_costs(path)
    budget = 2 * max(costs) + 1024  # room for about two chunks
    assert budget < sum(costs)
    baseline = RefReader(path).read_all()
    with FileReader(path, max_memory=budget, prefetch=4) as r, \
            RefReader(path, max_memory=budget, prefetch=4) as ref:
        _same_group(r.read_all(), baseline)
        ref.read_all()
        st, rst = r.pipeline_stats(), ref.pipeline_stats()
    assert 0 < st.peak_in_flight_bytes <= budget
    assert 0 < rst.peak_in_flight_bytes <= budget
    assert st.as_dict()["budget_bytes"] == budget


@pytest.mark.parametrize("k", DEPTHS)
def test_decompression_bomb_raises_as_the_reference(files, k):
    """A budget under one chunk's decompressed pages raises the budget
    error, at every depth, with the reference's text."""
    path = files["flat_gzip"]
    with pytest.raises(MemoryBudgetExceeded) as e:
        FileReader(path, max_memory=4096, prefetch=k).read_all()
    with pytest.raises(MemoryError) as r:
        RefReader(path, max_memory=4096, prefetch=k).read_all()
    assert str(e.value) == str(r.value)


def _corrupt_mid_file(path, tmp_path):
    with FileReader(path) as r:
        md = r.metadata.row_groups[4].columns[0].meta_data
        off = md.data_page_offset
        if (md.dictionary_page_offset is not None
                and md.dictionary_page_offset >= 0):
            off = min(off, md.dictionary_page_offset)
    raw = bytearray(open(path, "rb").read())
    raw[off : off + 64] = b"\xff" * 64
    bad = tmp_path / "corrupt.parquet"
    bad.write_bytes(bytes(raw))
    return str(bad)


@pytest.mark.parametrize("validate_crc", [False, True])
@pytest.mark.parametrize("k", DEPTHS)
def test_corrupt_mid_file_page_raises_the_reference_text(files, tmp_path, k,
                                                         validate_crc):
    bad = _corrupt_mid_file(files["flat_snappy"], tmp_path)
    good = []
    with FileReader(bad, validate_crc=validate_crc, prefetch=k) as r:
        with pytest.raises(ParquetError) as e:
            for _ in r.iter_row_groups():
                good.append(1)
    with RefReader(bad, validate_crc=validate_crc, prefetch=k) as ref:
        with pytest.raises(RefError) as w:
            list(ref.iter_row_groups())
    assert len(good) == 4  # the groups before the corrupt one, in order
    assert str(e.value) == str(w.value)


def test_early_abandon_shuts_the_pool_down(files):
    with FileReader(files["flat_snappy"], prefetch=4) as r:
        it = r.iter_row_groups()
        next(it)
        it.close()
