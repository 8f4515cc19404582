"""The port's DeviceFileReader on every flat value shape, against the JAX
package: BOOLEAN PLAIN and RLE, INT96 with the dictionary on and off,
FIXED_LEN_BYTE_ARRAY (``binary(4)`` and decimals) PLAIN, dictionary and
BYTE_STREAM_SPLIT, FLOAT/DOUBLE/INT32/INT64 BYTE_STREAM_SPLIT,
DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY, beside PLAIN and dictionary
columns, each REQUIRED and OPTIONAL with nulls.

pyarrow writes the files from seeded numpy data under SNAPPY, GZIP, ZSTD
and no compression, with data pages v1 and v2.  Each file goes to
``tpu_parquet_torch.device_reader.DeviceFileReader(path, device="cpu")``
and ``tpu_parquet.device_reader.DeviceFileReader(path)`` (``TPQ_PALLAS=1
TPQ_FUSE=1``), unforced and under each of the seven ``TPQ_FORCE_ROUTE``
names.  Compared exactly: ``to_host()`` and ``levels_to_host()`` bit for
bit, the column's class (and a ``DeviceDictColumn``'s indices, dictionary
rows and ``materialize()``), ``ship_routes``, the link bytes,
``fused_fallbacks`` and ``pages_device_expanded``; and the ``iter_batches``
output or refusal.
"""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpu_parquet.device_reader import DeviceDictColumn as RefDict
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.device_reader import DeviceDictColumn, DeviceFileReader
from tpu_parquet_torch.ship import ROUTES

N = 3000
GROUP = 1500


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One tensor thread: the suite runs several test processes side by
    side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _columns(rng, n):
    days = rng.integers(0, 2526, n)
    cents = rng.integers(-10_000_000, 10_000_000, n)
    ctx = decimal.Context(prec=20)
    return {
        # name: (arrow array, column encoding, or None for the dictionary)
        "i64_plain": (pa.array(rng.integers(0, 1 << 40, n)), "PLAIN"),
        "i32_dict": (pa.array(rng.integers(0, 90, n).astype(np.int32)), None),
        "i32_bss": (pa.array(rng.integers(-(1 << 31), 1 << 31, n,
                                          dtype=np.int64).astype(np.int32)),
                    "BYTE_STREAM_SPLIT"),
        "i64_bss": (pa.array(rng.integers(-(1 << 62), 1 << 62, n)),
                    "BYTE_STREAM_SPLIT"),
        "f32_bss": (pa.array(np.where(rng.random(n) < 0.05, np.nan,
                                      rng.standard_normal(n)).astype(
            np.float32)), "BYTE_STREAM_SPLIT"),
        "f64_bss": (pa.array(np.where(rng.random(n) < 0.05, -0.0,
                                      rng.standard_normal(n))),
                    "BYTE_STREAM_SPLIT"),
        "bool_plain": (pa.array(rng.random(n) < 0.4), "PLAIN"),
        "bool_rle": (pa.array(np.repeat(rng.random(n // 3 + 1) < 0.5,
                                        3)[:n]), "RLE"),
        "ts96_plain": (pa.array(((days + 8035) * 86_400_000_000_000
                                 + rng.integers(0, 86_400_000_000_000, n)
                                 ).astype("datetime64[ns]")), "PLAIN"),
        "ts96_dict": (pa.array(((days % 50 + 8035) * 86_400_000_000_000
                                ).astype("datetime64[ns]")), None),
        "bin4_plain": (pa.array([bytes(r) for r in rng.integers(
            0, 256, (n, 4)).astype(np.uint8)], pa.binary(4)), "PLAIN"),
        "bin4_dict": (pa.array([bytes([d % 30, 1, 2, 3]) for d in days],
                               pa.binary(4)), None),
        "bin4_bss": (pa.array([bytes([d % 256, 9, d % 5, 0]) for d in days],
                              pa.binary(4)), "BYTE_STREAM_SPLIT"),
        "dec_plain": (pa.array([ctx.create_decimal(int(c)).scaleb(-2)
                                for c in cents], pa.decimal128(15, 2)),
                      "PLAIN"),
        "dec_dict": (pa.array([ctx.create_decimal(int(c) % 700).scaleb(-2)
                               for c in cents], pa.decimal128(15, 2)), None),
        "str_dlba": (pa.array([f"c{int(x)}{'y' * (int(x) % 9)}"
                               for x in rng.integers(0, 5000, n)]),
                     "DELTA_LENGTH_BYTE_ARRAY"),
        "str_dba": (pa.array(sorted(f"k{int(x):06d}" for x in
                                    rng.integers(0, 90_000, n))),
                    "DELTA_BYTE_ARRAY"),
    }


def _file(path, *, seed, compression, version):
    rng = np.random.default_rng(seed)
    mask = rng.random(N) < 0.2
    fields, arrays, enc, dicts = [], [], {}, []
    for name, (arr, e) in _columns(rng, N).items():
        for suffix, nullable in (("", False), ("_opt", True)):
            a = arr
            if nullable:
                py = arr.to_pylist()
                a = pa.array([None if m else v for v, m in zip(py, mask)],
                             arr.type)
            fields.append(pa.field(name + suffix, arr.type,
                                   nullable=nullable))
            arrays.append(a)
            if e is None:
                dicts.append(name + suffix)
            else:
                enc[name + suffix] = e
    pq.write_table(pa.Table.from_arrays(arrays, schema=pa.schema(fields)),
                   path, row_group_size=GROUP, data_page_size=4096,
                   compression=compression, data_page_version=version,
                   use_dictionary=dicts, column_encoding=enc,
                   use_deprecated_int96_timestamps=True,
                   write_page_checksum=True)


FILES = {
    "snappy_v1": dict(seed=11, compression="snappy", version="1.0"),
    "gzip_v2": dict(seed=12, compression="gzip", version="2.0"),
    "zstd_v2": dict(seed=13, compression="zstd", version="2.0"),
    "uncompressed_v1": dict(seed=14, compression="none", version="1.0"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_value_shapes")
    out = {}
    for name, kw in FILES.items():
        path = str(root / f"{name}.parquet")
        _file(path, **kw)
        out[name] = path
    return out


def _read(reader):
    with reader as r:
        groups = list(r.iter_row_groups())
        return groups, r.stats().as_dict()


def _counters(stats):
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in stats["ship_routes"].items()}
    return routes, {k: stats[k] for k in (
        "link_bytes_logical", "link_bytes_shipped", "fused_fallbacks",
        "pages_device_expanded", "row_groups", "chunks", "pages", "rows",
        "compressed_bytes")}


def _same_column(rc, gc, name):
    assert isinstance(gc, DeviceDictColumn) == isinstance(rc, RefDict), name
    assert type(gc).__name__ == type(rc).__name__, name
    rv, gv = rc.to_host(), gc.to_host()
    if hasattr(rv, "offsets"):
        assert isinstance(gv, ByteArrayData), name
        assert np.array_equal(gv.offsets, np.asarray(rv.offsets)), name
        assert np.array_equal(gv.heap, np.asarray(rv.heap)), name
    else:
        assert gv.dtype == rv.dtype and gv.shape == rv.shape, (name, gv.dtype,
                                                               rv.dtype)
        assert np.array_equal(_bits(gv), _bits(rv)), name
    for r, g in zip(rc.levels_to_host(), gc.levels_to_host()):
        assert (r is None) == (g is None), name
        if r is not None:
            assert g.dtype == r.dtype and np.array_equal(g, r), name
    assert gc.num_values == rc.num_values, name
    assert gc.num_leaf_slots == rc.num_leaf_slots, name
    if isinstance(rc, RefDict):
        n = rc.num_values
        assert np.array_equal(gc.indices[:n].numpy().view(np.uint32),
                              np.asarray(rc.indices)[:n]), name
        if rc.dict_u8 is not None:
            assert gc.dict_dtype == rc.dict_dtype, name
            reach = int(np.asarray(rc.indices)[:n].max(initial=0)) + 1
            assert np.array_equal(gc.dict_u8.numpy()[:reach],
                                  np.asarray(rc.dict_u8)[:reach]), name
            rm, gm = rc.materialize(), gc.materialize()
            assert np.array_equal(_bits(gm.to_host()), _bits(rm.to_host()))


def _assert_same(path):
    ref, ref_stats = _read(RefReader(path))
    got, got_stats = _read(DeviceFileReader(path, device="cpu"))
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name in rg_ref:
            _same_column(rg_ref[name], rg_got[name], name)
    assert _counters(got_stats) == _counters(ref_stats)
    return got_stats


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", list(FILES))
def test_value_shapes_match_reference(files, reference_env, name, route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    CK.reset_launches()
    _assert_same(files[name])
    assert set(CK.launches.values()) == {0}  # CPU tensors launch nothing


def test_value_shapes_take_their_planned_paths(files, reference_env):
    """BOOLEAN PLAIN and INT96 / FLBA PLAIN are batched on the row group's
    buffer; BYTE_STREAM_SPLIT, delta byte arrays and boolean RLE take the
    host path."""
    taken = {}
    for method in ("_finish_plain_bool", "_finish_plain_rows",
                   "_finish_host", "_finish_dict"):
        real = getattr(DR._ChunkAssembler, method)

        def spy(self, *args, _real=real, _m=method, **kw):
            taken.setdefault(".".join(self.leaf.path), set()).add(_m)
            return _real(self, *args, **kw)

        reference_env.setattr(DR._ChunkAssembler, method, spy)
    with DeviceFileReader(files["snappy_v1"], device="cpu") as r:
        list(r.iter_row_groups())
    for col, want in (("bool_plain", "_finish_plain_bool"),
                      ("ts96_plain", "_finish_plain_rows"),
                      ("bin4_plain", "_finish_plain_rows"),
                      ("dec_plain", "_finish_plain_rows"),
                      ("bool_rle", "_finish_host"),
                      ("f64_bss", "_finish_host"),
                      ("bin4_bss", "_finish_host"),
                      ("str_dlba", "_finish_host"),
                      ("str_dba", "_finish_host"),
                      ("ts96_dict", "_finish_dict"),
                      ("bin4_dict", "_finish_dict")):
        for c in (col, col + "_opt"):
            assert taken[c] == {want}, (c, taken[c])


def test_lazy_pages_of_rows_and_booleans_are_host_bytes(tmp_path,
                                                        reference_env):
    """INT96, FLBA and BOOLEAN PLAIN pages of a SNAPPY chunk reach their
    plans as host bytes (only the fixed-width number and BYTE_ARRAY routes
    take lazily-compressed pages), in v1 and v2 pages."""
    rng = np.random.default_rng(3)
    n = 5000
    t = pa.table({
        "b": pa.array(rng.random(n) < 0.5),
        "t": pa.array((rng.integers(0, 1 << 50, n)).astype("datetime64[ns]")),
        "f": pa.array([bytes(r) for r in rng.integers(0, 256, (n, 4)).astype(
            np.uint8)], pa.binary(4)),
    })
    for version in ("1.0", "2.0"):
        path = str(tmp_path / f"lazy_{version}.parquet")
        pq.write_table(t, path, compression="snappy", use_dictionary=False,
                       column_encoding={"b": "PLAIN"}, data_page_size=2048,
                       use_deprecated_int96_timestamps=True,
                       data_page_version=version)
        _assert_same(path)


@pytest.mark.parametrize("name", list(FILES))
def test_iter_batches_output_or_refusal_matches_reference(files,
                                                          reference_env,
                                                          name):
    """Fixed-width REQUIRED columns batch in both readers alike (booleans,
    INT96 words, dictionaries materialized); a nullable or ragged column is
    refused with the same TypeError."""
    path = files[name]
    fixed = ["i64_plain", "i32_dict", "f64_bss", "bool_plain", "bool_rle",
             "ts96_plain", "ts96_dict"]
    with RefReader(path, columns=fixed) as r:
        want = [{k: np.asarray(v) for k, v in b.items()}
                for b in r.iter_batches(640)]
    with DeviceFileReader(path, columns=fixed, device="cpu") as r:
        got = [{k: v.numpy() for k, v in b.items()}
               for b in r.iter_batches(640)]
    assert len(got) == len(want) == N // 640
    for gb, wb in zip(got, want):
        for k in fixed:
            assert gb[k].shape[0] == wb[k].shape[0] == 640, k
            assert np.array_equal(_bits(gb[k]), _bits(wb[k])), k
    for cols in (["bin4_plain"], ["str_dba"], ["i32_bss_opt"],
                 ["bool_rle_opt"]):
        msgs = []
        for reader in (RefReader(path, columns=cols),
                       DeviceFileReader(path, columns=cols, device="cpu")):
            with reader as r, pytest.raises(TypeError) as exc:
                next(r.iter_batches(100))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], cols
