"""The PyTorch port's DeviceFileReader against the JAX package's, file by file.

Each file is written once — with the JAX package's writer or with pyarrow —
and the same path goes to both readers:
``tpu_parquet_torch.device_reader.DeviceFileReader(path, device="cpu")`` and
``tpu_parquet.device_reader.DeviceFileReader(path)``.  The reference runs
with ``TPQ_PALLAS=1`` and ``TPQ_FUSE=1``, so its BP-group unpack and fused
PLAIN kernels run in Pallas interpret mode; the port runs its kernels' plain
PyTorch versions (the CUDA kernels run only on the card, in
``chip_smoke.py``).  ``to_host()`` and ``levels_to_host()`` must be
bit-identical, and under a forced route the route counters and link bytes
must be equal.

The file matrix covers REQUIRED and OPTIONAL columns of INT32, INT64, FLOAT
and DOUBLE; multi-page and multi-row-group chunks; RLE and bit-packed index
runs; a dictionary whose index width grows page to page (pyarrow); a stream
with more bit-packed runs than the K1 path takes; SNAPPY, GZIP and
UNCOMPRESSED; data pages v1 and v2; and page CRCs.
"""

import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpu_parquet.column import ColumnData
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.format import (CompressionCodec, FieldRepetitionType as FRT,
                                Type)
from tpu_parquet.schema.core import build_schema, data_column
from tpu_parquet.writer import FileWriter, corrupt_page
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.errors import ParquetError as PortParquetError
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

ROWS = 12_000
GROUP = 6_000


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side, and PyTorch's default of one thread per
    core would oversubscribe the host for the tests next to these."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _runs(rng, card, n, dtype):
    """Index data with long repeated spans: the encoder emits RLE runs and
    bit-packed runs."""
    v = rng.integers(0, card, n)
    for x in rng.integers(0, n - 400, n // 800):
        v[x : x + 300] = v[x]
    return v.astype(dtype)


def _optional(values, rng, null_rate):
    """ColumnData for an OPTIONAL leaf: nulls at ``null_rate``."""
    present = rng.random(len(values)) >= null_rate
    return ColumnData(values=values[present],
                      def_levels=present.astype(np.int32), max_def=1,
                      num_leaf_slots=len(values))


def _tpq_file(path, *, codec, version, optional, null_rate, seed,
              pathological=False, use_dictionary=True):
    rng = np.random.default_rng(seed)
    rep = FRT.OPTIONAL if optional else FRT.REQUIRED
    cols = {
        "i32d": (Type.INT32, _runs(rng, 50, ROWS, np.int32)),
        "i64p": (Type.INT64, rng.integers(-(1 << 62), 1 << 62, ROWS)),
        "f32p": (Type.FLOAT, rng.standard_normal(ROWS).astype(np.float32)),
        "f64d": (Type.DOUBLE, rng.integers(0, 20, ROWS) / 7.0),
        "i64d": (Type.INT64, _runs(rng, 3000, ROWS, np.int64)),
        "f64p": (Type.DOUBLE, rng.standard_normal(ROWS)),
        "i32p": (Type.INT32, rng.integers(-(1 << 31), 1 << 31, ROWS,
                                          dtype=np.int64).astype(np.int32)),
    }
    if pathological:
        # one 8-value bit-packed group between RLE runs, thousands of times:
        # more BP runs than the K1 path stages (run-table expand instead)
        block = np.concatenate([np.arange(8), np.full(9, 3)])
        cols["i32x"] = (Type.INT32,
                        np.resize(block, ROWS).astype(np.int32))
    schema = build_schema([
        data_column(name, t, FRT.REQUIRED if name == "i64p" else rep)
        for name, (t, _) in cols.items()])
    with FileWriter(path, schema, codec=codec, data_page_version=version,
                    write_crc=True, page_size=16 << 10,
                    use_dictionary=use_dictionary) as w:
        for lo in range(0, ROWS, GROUP):
            batch = {}
            for name, (_, v) in cols.items():
                part = v[lo : lo + GROUP]
                if optional and name != "i64p":
                    part = _optional(part, rng, null_rate)
                batch[name] = part
            w.write_columns(batch)
            w.flush_row_group()


def _pyarrow_growth(path):
    """pyarrow: dictionaries whose index width grows page to page (small
    pages over a cardinality that rises along the file), nulls, CRCs."""
    rng = np.random.default_rng(11)
    n = ROWS
    ramp = (np.arange(n) * 4000 // n + 1)
    grow = (rng.random(n) * ramp).astype(np.int64)
    mask = rng.random(n) < 0.1
    table = pa.table({
        "grow64": pa.array(grow, mask=mask),
        "grow32": pa.array(grow.astype(np.int32)),
        "gdbl": pa.array(grow / 3.0, mask=rng.random(n) < 0.05),
        "gflt": pa.array((grow % 500).astype(np.float32)),
        "wide": pa.array(rng.integers(-(1 << 62), 1 << 62, n)),
    })
    pq.write_table(table, path, row_group_size=GROUP, data_page_size=2048,
                   compression="snappy", write_page_checksum=True,
                   use_dictionary=["grow64", "grow32", "gdbl", "gflt"])


def _pyarrow_v2(path):
    """pyarrow: GZIP, data pages v2, plain and dictionary columns."""
    rng = np.random.default_rng(12)
    n = ROWS
    table = pa.table({
        "a": pa.array(rng.integers(0, 30, n).astype(np.int32)),
        "b": pa.array(rng.standard_normal(n),
                      mask=rng.random(n) < 0.3),
        "c": pa.array(rng.integers(-(1 << 40), 1 << 40, n)),
        "d": pa.array(rng.standard_normal(n).astype(np.float32),
                      mask=rng.random(n) < 0.5),
    })
    pq.write_table(table, path, row_group_size=GROUP, data_page_size=8192,
                   compression="gzip", data_page_version="2.0",
                   use_dictionary=["a", "b"])


FILES = {
    "tpq_required_plain_snappy_v1": lambda p: _tpq_file(
        p, codec=CompressionCodec.SNAPPY, version=1, optional=False,
        null_rate=0.0, seed=1, use_dictionary=False),
    "tpq_required_dict_snappy_v2": lambda p: _tpq_file(
        p, codec=CompressionCodec.SNAPPY, version=2, optional=False,
        null_rate=0.0, seed=4),
    "tpq_optional_dict_gzip_v1": lambda p: _tpq_file(
        p, codec=CompressionCodec.GZIP, version=1, optional=True,
        null_rate=0.2, seed=2),
    "tpq_optional_dict_uncompressed_v2": lambda p: _tpq_file(
        p, codec=CompressionCodec.UNCOMPRESSED, version=2, optional=True,
        null_rate=0.0, seed=3, pathological=True),
    "pyarrow_dict_growth_snappy": _pyarrow_growth,
    "pyarrow_gzip_v2": _pyarrow_v2,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_reader")
    out = {}
    for name, make in FILES.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's K1 and K2 in Pallas interpret mode."""
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    monkeypatch.delenv("TPQ_FORCE_ROUTE", raising=False)
    return monkeypatch


def _read_both(path):
    with RefReader(path) as r:
        ref = [{k: (v.to_host(), v.levels_to_host()) for k, v in g.items()}
               for g in r.iter_row_groups()]
        ref_stats = r.stats().as_dict()
    with DeviceFileReader(path, device="cpu") as r:
        got = [{k: (v.to_host(), v.levels_to_host()) for k, v in g.items()}
               for g in r.iter_row_groups()]
        got_stats = r.stats().as_dict()
    return ref, got, ref_stats, got_stats


def _assert_same(ref, got):
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name, ((rv, (rd, rr)), (gv, (gd, gr))) in (
                (k, (rg_ref[k], rg_got[k])) for k in rg_ref):
            assert gv.dtype == rv.dtype, (name, gv.dtype, rv.dtype)
            assert gv.shape == rv.shape, name
            assert np.array_equal(gv.view(np.uint8), rv.view(np.uint8)), name
            assert (gd is None) == (rd is None), name
            if rd is not None:
                assert gd.dtype == rd.dtype and np.array_equal(gd, rd), name
            assert gr is None and rr is None


def _routes(stats):
    return {r: (v["streams"], v["logical"], v["shipped"])
            for r, v in stats["ship_routes"].items()}


@pytest.mark.parametrize("name", list(FILES))
def test_reader_matches_reference(files, reference_env, name):
    ref, got, ref_stats, got_stats = _read_both(files[name])
    _assert_same(ref, got)
    for key in ("row_groups", "chunks", "pages", "rows", "compressed_bytes"):
        assert got_stats[key] == ref_stats[key], key


@pytest.mark.parametrize("route", ["plain", "fused_plain"])
@pytest.mark.parametrize("name", list(FILES))
def test_forced_route_counters_match_reference(files, reference_env, name,
                                               route):
    reference_env.setenv("TPQ_FORCE_ROUTE", route)
    ref, got, ref_stats, got_stats = _read_both(files[name])
    _assert_same(ref, got)
    assert _routes(got_stats) == _routes(ref_stats)
    for key in ("link_bytes_logical", "link_bytes_shipped",
                "fused_fallbacks"):
        assert got_stats[key] == ref_stats[key], key


def test_read_row_group_and_iter_batches_match_reference(files,
                                                         reference_env):
    path = files["tpq_required_plain_snappy_v1"]
    cols = ["i32d", "i64p", "f64d", "f32p"]
    with RefReader(path, columns=cols) as r:
        ref_rg = {k: v.to_host() for k, v in r.read_row_group(1).items()}
        ref_batches = [{k: np.asarray(v) for k, v in b.items()}
                       for b in r.iter_batches(5000)]
    with DeviceFileReader(path, columns=cols, device="cpu") as r:
        got_rg = {k: v.to_host() for k, v in r.read_row_group(1).items()}
        got_batches = [{k: v.numpy() for k, v in b.items()}
                       for b in r.iter_batches(5000)]
    assert set(got_rg) == set(cols)
    for k in cols:
        assert np.array_equal(got_rg[k].view(np.uint8),
                              ref_rg[k].view(np.uint8))
    assert len(got_batches) == len(ref_batches) == ROWS // 5000
    for gb, rb in zip(got_batches, ref_batches):
        for k in cols:
            want = rb[k]
            if k == "f64d":  # the reference keeps DOUBLE as u32 word pairs
                want = np.ascontiguousarray(want).view("<f8").reshape(-1)
            assert np.array_equal(gb[k].view(np.uint8), want.view(np.uint8))


def test_cpu_read_launches_no_kernel(files):
    CK.reset_launches()
    with DeviceFileReader(files["tpq_required_plain_snappy_v1"],
                          device="cpu") as r:
        list(r.iter_row_groups())
        routes = r.stats().as_dict()["ship_routes"]
    assert CK.launches == {"unpack_bp_groups": 0, "hybrid_unpack_combine": 0,
                           "fused_plain_words": 0, "fused_narrow_words": 0}
    # ranked by the full planner, as on the card
    assert set(routes) == {"device_snappy", "fused_plain", "narrow"}


def test_default_device_is_cuda_and_raises_without_it(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFileReader(files["tpq_required_plain_snappy_v1"])


def test_columns_outside_the_slice_raise(tmp_path, reference_env):
    """Once outside the slice, now read equal to the reference: BOOLEAN
    columns, DELTA_LENGTH_BYTE_ARRAY strings beside DELTA_BINARY_PACKED
    integers, a dictionary-overflow chunk (early pages dictionary encoded,
    later pages PLAIN) and a repeated leaf (a LIST column)."""
    path = str(tmp_path / "other.parquet")
    pq.write_table(pa.table({"b": pa.array([True, False] * 50),
                             "n": pa.array(np.arange(100))}), path)
    ref, got, _, _ = _read_both(path)
    _assert_same(ref, got)
    assert got[0]["b"][0].dtype == np.bool_
    with DeviceFileReader(path, columns=["n"], device="cpu") as r:
        assert np.array_equal(r.read_row_group(0)["n"].to_host(),
                              np.arange(100))
    delta = str(tmp_path / "delta.parquet")
    pq.write_table(pa.table({"d": pa.array(np.arange(100)),
                             "s": pa.array(["x", "yy"] * 50)}), delta,
                   use_dictionary=False,
                   column_encoding={"d": "DELTA_BINARY_PACKED",
                                    "s": "DELTA_LENGTH_BYTE_ARRAY"})
    with DeviceFileReader(delta, columns=["d"], device="cpu") as r:
        assert np.array_equal(r.read_row_group(0)["d"].to_host(),
                              np.arange(100))
    with RefReader(delta) as r:
        want = r.read_row_group(0)["s"].to_host()
    with DeviceFileReader(delta, device="cpu") as r:
        strings = r.read_row_group(0)["s"].to_host()
    assert np.array_equal(strings.offsets, want.offsets)
    assert np.array_equal(strings.heap, want.heap)
    assert strings.to_list() == [b"x", b"yy"] * 50
    mixed = str(tmp_path / "mixed.parquet")
    pq.write_table(pa.table({"m": pa.array(np.arange(5000))}), mixed,
                   dictionary_pagesize_limit=256, data_page_size=512)
    ref, got, ref_stats, got_stats = _read_both(mixed)
    _assert_same(ref, got)
    assert np.array_equal(got[0]["m"][0], np.arange(5000))
    assert _routes(got_stats) == _routes(ref_stats)
    # a repeated leaf, refused before nested columns were ported, reads
    # equal to the reference, rep levels included
    nested = str(tmp_path / "nested.parquet")
    pq.write_table(pa.table({"l": pa.array(
        [list(range(i % 5)) if i % 7 else None for i in range(300)],
        pa.list_(pa.int64()))}), nested)
    with RefReader(nested) as r:
        ref = r.read_row_group(0)["l.list.element"]
        want, (want_d, want_r) = ref.to_host(), ref.levels_to_host()
    with DeviceFileReader(nested, device="cpu") as r:
        col = r.read_row_group(0)["l.list.element"]
    got, (got_d, got_r) = col.to_host(), col.levels_to_host()
    assert col.max_rep == 1 and got_r is not None
    for g, w in ((got, want), (got_d, want_d), (got_r, want_r)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert int((got_r == 0).sum()) == 300  # one rep-0 slot per row


def test_corrupt_page_crc_raises(files, tmp_path):
    path = str(tmp_path / "corrupt.parquet")
    shutil.copy(files["tpq_required_dict_snappy_v2"], path)
    corrupt_page(path, row_group=1, column="i64d", page=0)
    with DeviceFileReader(path, device="cpu") as r:
        r.read_row_group(0)  # untouched group still decodes
        with pytest.raises(PortParquetError, match="CRC"):
            r.read_row_group(1)
