"""Fixed-width dictionary columns in the port, against the JAX package.

A dictionary-encoded chunk comes back from both readers as a
``DeviceDictColumn``: ``uint32`` indices plus the dictionary's byte rows
(``dict_u8``, ``dict_dtype``), gathered only by ``materialize()`` (on the
device) or ``to_host()`` (on the host).  The files are written by pyarrow
from seeded numpy data and read with
``tpu_parquet_torch.device_reader.DeviceFileReader(path, device="cpu")``
and ``tpu_parquet.device_reader.DeviceFileReader(path)`` (``TPQ_PALLAS=1
TPQ_FUSE=1``: the reference's Pallas kernels in interpret mode).  Compared
exactly, bit for bit: the class, the indices up to ``num_values``, the
dictionary rows, ``dict_dtype``, ``materialize()``'s values (the whole
padded tensor) and ``to_host()``; and the tensor functions behind them,
``dict_gather_bytes``, ``ragged_take`` and ``byte_stream_split_decode``,
against ``tpu_parquet.jax_kernels`` at several seeds and lengths.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from tpu_parquet import jax_kernels as JK
from tpu_parquet.device_reader import DeviceDictColumn as RefDict
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet_torch import torch_kernels as TK
from tpu_parquet_torch.device_reader import DeviceDictColumn, DeviceFileReader

N = 4000


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
    monkeypatch.delenv("TPQ_FORCE_ROUTE", raising=False)
    return monkeypatch


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


# ---------------------------------------------------------------------------
# the tensor functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,itemsize", [
    ("int32", 4), ("int64", 8), ("float32", 4), ("float64", 8),
    ("uint32", 12)])
@pytest.mark.parametrize("seed,n,k", [(0, 0, 5), (1, 1, 1), (2, 777, 64),
                                      (3, 5000, 3000)])
def test_dict_gather_bytes_matches_jax(dtype, itemsize, seed, n, k):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (k, itemsize)).astype(np.uint8)
    idx = rng.integers(0, k, n).astype(np.uint32)
    with JK.enable_x64():
        want = np.asarray(JK.dict_gather_bytes(jnp.asarray(rows),
                                               jnp.asarray(idx), dtype))
    got = TK.dict_gather_bytes(torch.from_numpy(rows),
                               torch.from_numpy(idx.view(np.int32)),
                               dtype).numpy()
    assert got.shape[0] == want.shape[0] == n
    assert np.array_equal(_bits(got), _bits(want))


def test_dict_gather_bytes_out_of_range_reads_fill_rows():
    """An index past the table (the deferred range check's path) reads the
    reference's fill row of 0xFF bytes."""
    rows = np.arange(24, dtype=np.uint8).reshape(3, 8)
    idx = np.array([5, 1, 2, 1 << 31], np.uint32)
    with JK.enable_x64():
        want = np.asarray(JK.dict_gather_bytes(
            jnp.asarray(rows), jnp.asarray(idx), "float64"))
    got = TK.dict_gather_bytes(torch.from_numpy(rows),
                               torch.from_numpy(idx.view(np.int32)),
                               "float64").numpy()
    assert np.array_equal(_bits(got), _bits(want))
    # an empty table (the reference's take raises): every row is fill
    got = TK.dict_gather_bytes(torch.zeros((0, 8), dtype=torch.uint8),
                               torch.from_numpy(idx.view(np.int32)),
                               "float64")
    assert (got.numpy().view(np.uint8) == 0xFF).all()


@pytest.mark.parametrize("seed,k,n", [(0, 1, 1), (1, 40, 300), (2, 500, 4096),
                                      (3, 7, 10)])
def test_ragged_take_matches_jax(seed, k, n):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 9, k)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    heap = rng.integers(0, 256, int(offsets[-1])).astype(np.uint8)
    idx = rng.integers(0, k, n).astype(np.uint32)
    out = int((offsets[idx + 1] - offsets[idx]).sum())
    for size in (max(out, 1), out + 64):  # exact and bucketed heaps
        with JK.enable_x64():
            wo, wh = JK.ragged_take(jnp.asarray(offsets), jnp.asarray(heap),
                                    jnp.asarray(idx), size)
        go, gh = TK.ragged_take(torch.from_numpy(offsets),
                                torch.from_numpy(heap),
                                torch.from_numpy(idx.view(np.int32)), size)
        assert np.array_equal(go.numpy(), np.asarray(wo))
        assert np.array_equal(gh.numpy(), np.asarray(wh))


def test_ragged_take_empty_heap_matches_jax():
    offsets = np.zeros(4, np.int64)
    idx = np.array([0, 2, 1], np.uint32)
    with JK.enable_x64():
        wo, wh = JK.ragged_take(jnp.asarray(offsets),
                                jnp.asarray(np.zeros(0, np.uint8)),
                                jnp.asarray(idx), 64)
    go, gh = TK.ragged_take(torch.from_numpy(offsets),
                            torch.zeros(0, dtype=torch.uint8),
                            torch.from_numpy(idx.view(np.int32)), 64)
    assert np.array_equal(go.numpy(), np.asarray(wo))
    assert gh.shape == np.asarray(wh).shape == (0,)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("seed,n", [(0, 0), (1, 1), (2, 1000), (3, 4099)])
def test_byte_stream_split_decode_matches_jax(dtype, seed, n):
    rng = np.random.default_rng(seed)
    width = np.dtype(dtype).itemsize
    buf = rng.integers(0, 256, n * width + 11).astype(np.uint8)
    with JK.enable_x64():
        want = np.asarray(JK.byte_stream_split_decode(jnp.asarray(buf),
                                                      dtype, n))
    got = TK.byte_stream_split_decode(torch.from_numpy(buf), dtype,
                                      n).numpy()
    assert got.shape[0] == n
    assert np.array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the reader's dictionary columns
# ---------------------------------------------------------------------------

def _special_floats(rng, n, dtype):
    v = (rng.integers(0, 300, n) / 7.0).astype(dtype)
    v[rng.random(n) < 0.05] = np.nan
    v[rng.random(n) < 0.05] = -0.0
    v[rng.random(n) < 0.02] = np.inf
    return v


def _table(seed, n=N):
    rng = np.random.default_rng(seed)
    days = rng.integers(0, 2526, n)
    mask = rng.random(n) < 0.15
    return pa.table({
        "i32": pa.array(rng.integers(-50, 50, n).astype(np.int32)),
        "i64": pa.array(rng.integers(0, 900, n) * 1_000_003, mask=mask),
        "flt": pa.array(_special_floats(rng, n, np.float32)),
        "dbl": pa.array(_special_floats(rng, n, np.float64), mask=mask),
        "ts96": pa.array(((days + 8035) * 86_400_000_000_000).astype(
            "datetime64[ns]")),
    })


FILES = {
    "snappy_v1": dict(compression="snappy"),
    "gzip_v2": dict(compression="gzip", data_page_version="2.0"),
    "zstd_v1_small_pages": dict(compression="zstd", data_page_size=1024),
    "uncompressed_v2": dict(compression="none", data_page_version="2.0"),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dictcol")
    out = {}
    for i, (name, kw) in enumerate(FILES.items()):
        path = str(root / f"{name}.parquet")
        pq.write_table(_table(31 + i), path, row_group_size=N // 2,
                       use_deprecated_int96_timestamps=True, **kw)
        out[name] = path
    one = str(root / "one_row.parquet")
    pq.write_table(pa.table({"x": pa.array([7], pa.int32())}), one)
    out["one_row"] = one
    return out


def _read(reader):
    with reader as r:
        return list(r.iter_row_groups())


def _assert_dict_columns_equal(ref_groups, got_groups, min_dicts=1,
                               exact_tables=True):
    seen = 0
    assert len(ref_groups) == len(got_groups) > 0
    for rg_ref, rg_got in zip(ref_groups, got_groups):
        assert set(rg_ref) == set(rg_got)
        for name, rc in rg_ref.items():
            gc = rg_got[name]
            assert isinstance(gc, DeviceDictColumn) == isinstance(
                rc, RefDict), name
            rh, gh = rc.to_host(), gc.to_host()
            assert gh.dtype == rh.dtype and gh.shape == rh.shape, name
            assert np.array_equal(_bits(gh), _bits(rh)), name
            assert np.array_equal(*(c.levels_to_host()[0] if
                                    c.levels_to_host()[0] is not None
                                    else np.zeros(0) for c in (gc, rc)))
            if not isinstance(rc, RefDict):
                continue
            seen += 1
            n = rc.num_values
            assert gc.num_values == n and gc.dict_dtype == rc.dict_dtype
            assert np.array_equal(
                gc.indices[:n].numpy().view(np.uint32),
                np.asarray(rc.indices)[:n]), name
            ru8, gu8 = np.asarray(rc.dict_u8), gc.dict_u8.numpy()
            assert gu8.dtype == np.uint8 and gu8.shape == ru8.shape, name
            if not exact_tables:
                # a table shipped compressed: rows past the dictionary's
                # real size resolve through the op tables' padding, bytes
                # of the staged buffer's layout; compare every row an index
                # can reach
                reach = int(np.asarray(rc.indices)[:n].max(initial=0)) + 1
                ru8, gu8 = ru8[:reach], gu8[:reach]
            assert np.array_equal(gu8, ru8), name
            rm, gm = rc.materialize(), gc.materialize()
            assert type(gm).__name__ == type(rm).__name__ == \
                "DeviceColumnData"
            assert gm.n_values == rm.n_values
            assert np.array_equal(_bits(gm.values.numpy()),
                                  _bits(rm.values)), name
            mh = gm.to_host()
            assert mh.dtype == rh.dtype and np.array_equal(_bits(mh),
                                                           _bits(rh))
    assert seen >= min_dicts
    return seen


@pytest.mark.parametrize("name", list(FILES))
def test_fixed_width_dictionaries_match_reference(files, reference_env,
                                                  name):
    ref = _read(RefReader(files[name]))
    got = _read(DeviceFileReader(files[name], device="cpu"))
    # every column is dictionary-encoded in both row groups; on SNAPPY the
    # planner may ship a value table compressed
    assert _assert_dict_columns_equal(
        ref, got, exact_tables="snappy" not in name) == 2 * 5


def test_one_row_int32_is_a_dictionary_column(files, reference_env):
    """The smallest input that showed the old class difference."""
    ref = _read(RefReader(files["one_row"]))
    got = _read(DeviceFileReader(files["one_row"], device="cpu"))
    assert isinstance(got[0]["x"], DeviceDictColumn)
    assert got[0]["x"].dict_dtype == "int32"
    _assert_dict_columns_equal(ref, got)
    assert got[0]["x"].to_host().tolist() == [7]


def test_int96_dictionary_rows_are_words(files, reference_env):
    with DeviceFileReader(files["snappy_v1"], columns=["ts96"],
                          device="cpu") as r:
        col = r.read_row_group(0)["ts96"]
    assert col.dict_dtype == "uint32" and col.dict_u8.shape[1] == 12
    host = col.to_host()
    assert host.dtype == np.uint32 and host.shape == (N // 2, 3)
    # Julian day in the last word, zero nanoseconds
    assert (host[:, :2] == 0).all() and (host[:, 2] >= 2_440_588).all()
    mat = col.materialize()
    assert mat.values.dtype == torch.int32
    assert tuple(mat.values.shape[1:]) == (3,)


@pytest.mark.parametrize("columns", [["i32", "flt", "ts96"], ["i32"]])
def test_iter_batches_materializes_dictionaries_as_the_reference(
        files, reference_env, columns):
    path = files["snappy_v1"]
    with RefReader(path, columns=columns) as r:
        want = [{k: np.asarray(v) for k, v in b.items()}
                for b in r.iter_batches(700)]
    with DeviceFileReader(path, columns=columns, device="cpu") as r:
        got = [{k: v.numpy() for k, v in b.items()}
               for b in r.iter_batches(700)]
    assert len(got) == len(want) == N // 700
    for gb, wb in zip(got, want):
        for k in columns:
            assert gb[k].shape[0] == wb[k].shape[0] == 700
            assert np.array_equal(_bits(gb[k]), _bits(wb[k])), k


def test_iter_batches_refuses_nullable_dictionary_as_the_reference(
        files, reference_env):
    msgs = []
    for reader in (RefReader(files["snappy_v1"], columns=["i64"]),
                   DeviceFileReader(files["snappy_v1"], columns=["i64"],
                                    device="cpu")):
        with reader as r, pytest.raises(TypeError) as exc:
            next(r.iter_batches(100))
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "null" in msgs[1]


def test_dictionary_table_is_not_a_view_of_the_staged_buffer(files):
    with DeviceFileReader(files["uncompressed_v2"], columns=["i64", "dbl"],
                          device="cpu") as r:
        cols = r.read_row_group(0)
    for col in cols.values():
        assert col.dict_u8._base is None
        assert col.dict_u8.untyped_storage().nbytes() == col.dict_u8.numel()
