"""The port's DELTA_BINARY_PACKED decode against the JAX package.

``torch_kernels.extract_bits64`` is held against ``tpu_parquet.jax_kernels.
extract_bits`` at every width 1..64 and every bit offset 0..7 (the three
regimes: up to 25 bits, up to 57, and 58..64 with a ninth byte), and
``torch_kernels.delta_reconstruct`` against its JAX twin on INT32 and INT64
streams whose sums wrap around.  Then whole files: multi-page DELTA chunks
of INT32 and INT64, REQUIRED and OPTIONAL, values near the ends of their
ranges, data pages v1 and v2, under SNAPPY and GZIP, read by both readers
(the reference with ``TPQ_PALLAS=1 TPQ_FUSE=1``) with equal ``to_host()``,
``levels_to_host()`` and counters; and ``bench.gen_lineitem16``'s 16-column
table read whole by both.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import bench
from tpu_parquet import jax_kernels as JK
from tpu_parquet.column import ColumnData
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.format import (CompressionCodec, Encoding,
                                FieldRepetitionType as FRT, Type)
from tpu_parquet.kernels import delta as ref_delta
from tpu_parquet.schema.core import build_schema, data_column
from tpu_parquet.writer import FileWriter
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import torch_decode as TD
from tpu_parquet_torch import torch_kernels as TK
from tpu_parquet_torch.device_reader import DeviceDictColumn, DeviceFileReader
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_width", range(1, 65))
def test_extract_bits64_matches_jax(max_width):
    rng = np.random.default_rng(max_width)
    buf = rng.integers(0, 256, 256, dtype=np.uint8)
    for offset in range(8):
        pos = rng.integers(0, 240, 48) * 8 + offset
        widths = rng.integers(0, max_width + 1, 48).astype(np.int32)
        widths[:2] = max_width
        for width in (widths, max_width):
            with JK.enable_x64():
                want = np.asarray(JK.extract_bits(
                    jnp.asarray(buf), jnp.asarray(pos), jnp.asarray(width)
                    if isinstance(width, np.ndarray) else width, max_width))
            got = TK.extract_bits64(
                torch.from_numpy(buf), torch.from_numpy(pos),
                torch.from_numpy(width) if isinstance(width, np.ndarray)
                else width, max_width)
            assert got.dtype == torch.int64
            if max_width <= 32:
                assert want.dtype == np.uint32
                np.testing.assert_array_equal(got.numpy(),
                                              want.astype(np.int64))
            else:
                assert want.dtype == np.uint64
                np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                              want)


def test_extract_bits_keeps_its_32_bit_form():
    buf = torch.arange(64, dtype=torch.uint8)
    pos = torch.arange(0, 64 * 8 - 72, 13)
    got = TK.extract_bits(buf, pos, 32, 32)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32),
                          TK.extract_bits64(buf, pos, 32, 32).numpy())
    with pytest.raises(ValueError, match="extract_bits64"):
        TK.extract_bits(buf, pos, 40, 40)
    with pytest.raises(ValueError):
        TK.extract_bits64(buf, pos, 65, 65)


def _delta_case(bits, values, vpm_blocks=(128, 4)):
    """Encode ``values`` with the reference's encoder; returns the stream and
    its padded DeltaMeta."""
    block, minis = vpm_blocks
    stream = ref_delta.encode(values, bits, block_size=block,
                              minis_per_block=minis)
    return stream, TD.parse_delta_meta(stream, bits)


WRAP64 = np.array([(1 << 63) - 5, -(1 << 63) + 3, (1 << 63) - 1, -7,
                   -(1 << 63), 12, (1 << 62), -(1 << 62) - 9], np.int64)
WRAP32 = np.array([(1 << 31) - 5, -(1 << 31) + 3, (1 << 31) - 1, -7,
                   -(1 << 31), 12, (1 << 30), -(1 << 30) - 9], np.int32)


@pytest.mark.parametrize("bits,case", [
    (64, "wrap"), (64, "walk"), (64, "full"), (64, "one"),
    (32, "wrap"), (32, "walk"), (32, "full"), (32, "one"),
])
def test_delta_reconstruct_matches_jax(bits, case):
    rng = np.random.default_rng(bits + len(case))
    dt = np.int64 if bits == 64 else np.int32
    info = np.iinfo(dt)
    if case == "wrap":
        values = np.resize(WRAP64 if bits == 64 else WRAP32, 1000)
        values[::7] += rng.integers(-50, 50, len(values[::7])).astype(dt)
    elif case == "walk":
        values = np.cumsum(rng.integers(-3, 900, 3000)).astype(dt)
    elif case == "full":
        values = rng.integers(info.min, info.max, 777, dtype=dt,
                              endpoint=True)
    else:
        values = np.array([info.min], dt)
    stream, meta = _delta_case(bits, values)
    count = TD._bucket_count(meta.count)
    buf = np.concatenate([np.frombuffer(stream, np.uint8),
                          np.zeros(16, np.uint8)])
    mw = max(1, int(meta.mini_widths.max()))
    with JK.enable_x64():  # 64-bit tables, as the reference reader runs
        want = np.asarray(JK.delta_reconstruct(
            jnp.asarray(buf), meta.first_value,
            jnp.asarray(meta.mini_bit_starts), jnp.asarray(meta.mini_widths),
            jnp.asarray(meta.mini_min_delta), meta.values_per_mini, count,
            bits, mw))
    got = TK.delta_reconstruct(
        torch.from_numpy(buf), meta.first_value,
        torch.from_numpy(meta.mini_bit_starts),
        torch.from_numpy(meta.mini_widths),
        torch.from_numpy(meta.mini_min_delta.view(np.int64)),
        meta.values_per_mini, count, bits, mw)
    assert got.dtype == (torch.int64 if bits == 64 else torch.int32)
    assert got.shape == (count,) and want.dtype == dt
    # the values the stream holds, and the reference's tail lanes too
    np.testing.assert_array_equal(got.numpy()[: len(values)], values)
    np.testing.assert_array_equal(got.numpy(), want)


def test_delta_reconstruct_batches_pages():
    """A leading page axis decodes each page as its own stream."""
    streams = [_delta_case(64, np.cumsum(np.arange(n) * (k + 1)))
               for k, n in enumerate((300, 129, 1))]
    buf = np.concatenate([np.frombuffer(s, np.uint8) for s, _ in streams]
                         + [np.zeros(16, np.uint8)])
    base = np.concatenate([[0], np.cumsum([len(s) for s, _ in streams])])
    m = max(len(meta.mini_widths) for _, meta in streams)

    def table(attr, b=0):
        out = np.zeros((3, m), getattr(streams[0][1], attr).dtype)
        for i, (_, meta) in enumerate(streams):
            t = getattr(meta, attr)
            out[i, : len(t)] = t + (base[i] * 8 if b else 0)
        return out

    got = TK.delta_reconstruct(
        torch.from_numpy(buf),
        torch.tensor([meta.first_value for _, meta in streams]),
        torch.from_numpy(table("mini_bit_starts", 1)),
        torch.from_numpy(table("mini_widths")),
        torch.from_numpy(table("mini_min_delta").view(np.int64)),
        streams[0][1].values_per_mini, 320, 64, 64)
    for i, (n, (_, meta)) in enumerate(zip((300, 129, 1), streams)):
        want = np.cumsum(np.arange(n) * (i + 1))
        np.testing.assert_array_equal(got[i, :n].numpy(), want)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

ROWS = 6_000
GROUP = 3_000


def _delta_columns(rng):
    walk = np.cumsum(rng.integers(-5, 400, ROWS))
    return {
        "k64": (Type.INT64, walk + (1 << 62)),
        "w64": (Type.INT64, np.resize(WRAP64, ROWS)
                + rng.integers(-9, 9, ROWS)),
        "k32": (Type.INT32, (walk % 100_000).astype(np.int32)),
        "w32": (Type.INT32, np.resize(WRAP32, ROWS)
                + rng.integers(-9, 9, ROWS).astype(np.int32)),
    }


def _delta_file(path, codec, version, optional):
    rng = np.random.default_rng(53 + version)
    cols = _delta_columns(rng)
    rep = FRT.OPTIONAL if optional else FRT.REQUIRED
    schema = build_schema([data_column(c, t, rep)
                           for c, (t, _) in cols.items()])
    want = []
    with FileWriter(path, schema, codec=codec, data_page_version=version,
                    write_crc=True, page_size=4 << 10, use_dictionary=False,
                    column_encodings={c: Encoding.DELTA_BINARY_PACKED
                                      for c in cols}) as w:
        for lo in range(0, ROWS, GROUP):
            batch, exp = {}, {}
            for c, (_, v) in cols.items():
                part = v[lo : lo + GROUP]
                if optional:
                    present = rng.random(len(part)) >= 0.15
                    exp[c] = part[present]
                    part = ColumnData(values=part[present],
                                      def_levels=present.astype(np.int32),
                                      max_def=1, num_leaf_slots=len(part))
                else:
                    exp[c] = part
                batch[c] = part
            w.write_columns(batch)
            w.flush_row_group()
            want.append(exp)
    return want


# a first row group over the writer's dictionary cap (32,767 distinct
# values), where l_orderkey takes DELTA_BINARY_PACKED and l_partkey and
# l_extendedprice PLAIN, then a small one where every column is a dictionary
L16_ROWS = 36_000
L16_GROUP = 34_000
S, G = CompressionCodec.SNAPPY, CompressionCodec.GZIP
DELTA_FILES = {
    "required_snappy_v1": (S, 1, False),
    "optional_gzip_v1": (G, 1, True),
    "optional_snappy_v2": (S, 2, True),
    "required_gzip_v2": (G, 2, False),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_delta")
    out = {}
    for name, args in DELTA_FILES.items():
        path = str(root / f"{name}.parquet")
        out[name] = (path, _delta_file(path, *args))
    path = str(root / "pyarrow_delta.parquet")
    rng = np.random.default_rng(59)
    pq.write_table(pa.table({
        "d": pa.array(rng.integers(-(1 << 40), 1 << 40, ROWS),
                      mask=rng.random(ROWS) < 0.1),
        "e": pa.array(np.cumsum(rng.integers(0, 3, ROWS)).astype(np.int32)),
    }), path, use_dictionary=False, row_group_size=GROUP,
        data_page_size=2048, write_page_checksum=True,
        column_encoding={"d": "DELTA_BINARY_PACKED",
                         "e": "DELTA_BINARY_PACKED"})
    out["pyarrow"] = (path, None)
    path = str(root / "lineitem16.parquet")
    bench.gen_lineitem16(path, L16_ROWS, L16_GROUP)
    out["lineitem16"] = (path, None)
    return out


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _read(reader):
    with reader as r:
        out = [{k: (v, v.to_host(), v.levels_to_host())
                for k, v in g.items()} for g in r.iter_row_groups()]
        return out, r.stats().as_dict()


def _counters(stats):
    return {k: stats[k] for k in (
        "ship_routes", "link_bytes_logical", "link_bytes_shipped",
        "fused_fallbacks", "pages_device_expanded", "row_groups", "chunks",
        "pages", "rows", "compressed_bytes")}


def _assert_same(path):
    ref, ref_stats = _read(RefReader(path))
    got, got_stats = _read(DeviceFileReader(path, device="cpu"))
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert list(rg_ref) == list(rg_got)
        for name in rg_ref:
            (rcol, rv, (rd, rr)), (gcol, gv, (gd, gr)) = (rg_ref[name],
                                                         rg_got[name])
            assert type(gv).__name__ == type(rv).__name__, name
            if isinstance(rv, np.ndarray):
                assert gv.dtype == rv.dtype and gv.shape == rv.shape, name
                assert np.array_equal(gv.view(np.uint8), rv.view(np.uint8))
            else:
                assert np.array_equal(gv.offsets, rv.offsets), name
                assert np.array_equal(gv.heap, rv.heap), name
            assert (gd is None) == (rd is None), name
            if rd is not None:
                assert gd.dtype == rd.dtype and np.array_equal(gd, rd), name
            assert gr is None and rr is None
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in got_stats["ship_routes"].items()}
    ref_routes = {r: (v["streams"], v["logical"], v["shipped"])
                  for r, v in ref_stats["ship_routes"].items()}
    assert routes == ref_routes
    for stats in (got_stats, ref_stats):
        stats.pop("ship_routes")
    assert _counters({**got_stats, "ship_routes": 0}) == _counters(
        {**ref_stats, "ship_routes": 0})
    return got, got_stats


@pytest.mark.parametrize("name", list(DELTA_FILES))
def test_delta_files_match_reference(files, reference_env, name):
    path, want = files[name]
    got, stats = _assert_same(path)
    assert stats["pages"] > 4 * 2 * 2  # several pages per chunk
    for rg, exp in zip(got, want):
        for col, values in exp.items():
            np.testing.assert_array_equal(rg[col][1], values)


def test_pyarrow_delta_matches_reference(files, reference_env):
    got, _ = _assert_same(files["pyarrow"][0])
    table = pq.read_table(files["pyarrow"][0])
    e = np.concatenate([rg["e"][1] for rg in got])
    np.testing.assert_array_equal(e, table["e"].to_numpy())


def test_lineitem16_reads_whole_as_the_reference(files, reference_env):
    """``bench.gen_lineitem16`` (16 columns, five of them STRING, four
    written with DELTA_BINARY_PACKED as their non-dictionary encoding,
    SNAPPY, CRCs): every column of both readers equal, every dictionary
    column's index stream (the strings' too) through the fused K1."""
    from tpu_parquet_torch import device_reader as DR

    path = files["lineitem16"][0]
    meta = pq.ParquetFile(path).metadata
    dict_chunks = delta_chunks = 0
    for g in range(meta.num_row_groups):
        for c in range(meta.num_columns):
            encs = meta.row_group(g).column(c).encodings
            dict_chunks += "RLE_DICTIONARY" in encs
            delta_chunks += "DELTA_BINARY_PACKED" in encs
    assert delta_chunks >= 1
    CK.reset_launches()
    planned = []
    real = DR._plan_hybrid_pallas

    def spy(*args):
        plan = real(*args)
        planned.append(plan is not None)
        return plan

    reference_env.setattr(DR, "_plan_hybrid_pallas", spy)
    got, stats = _assert_same(path)
    assert stats["rows"] == L16_ROWS and stats["chunks"] == 2 * 16
    for rg, n in zip(got, (L16_GROUP, L16_ROWS - L16_GROUP)):
        assert len(rg) == 16
        for name in ("l_returnflag", "l_linestatus", "l_shipinstruct",
                     "l_shipmode", "l_comment"):
            assert isinstance(rg[name][0], DeviceDictColumn), name
            assert len(rg[name][1]) == n
        keys = rg["l_orderkey"][1]
        assert keys.dtype == np.int64 and (np.diff(keys) > 0).all()
    assert planned == [True] * dict_chunks
    assert set(CK.launches.values()) == {0}  # CPU: the plain versions


def test_delta_on_float_raises_as_the_reference():
    """DELTA_BINARY_PACKED on a FLOAT column: the same ParquetError from
    both assemblers."""
    from tpu_parquet import device_reader as RDR
    from tpu_parquet.footer import ParquetError as RefError
    from tpu_parquet_torch import device_reader as DR
    from tpu_parquet_torch.footer import ParquetError as PortError
    from tpu_parquet_torch.format import (FieldRepetitionType as PFRT,
                                          Type as PType)
    from tpu_parquet_torch.schema.core import (build_schema as p_build,
                                               data_column as p_column)

    ref_leaf = build_schema([data_column("x", Type.FLOAT, FRT.REQUIRED)]
                            ).leaves[0]
    leaf = p_build([p_column("x", PType.FLOAT, PFRT.REQUIRED)]).leaves[0]
    with pytest.raises(RefError) as ref_exc:
        RDR._ChunkAssembler(ref_leaf, [])._finish_delta({}, None)
    with pytest.raises(PortError) as exc:
        DR._ChunkAssembler(leaf, [])._finish_delta({}, None)
    assert str(exc.value) == str(ref_exc.value)
    assert "DELTA_BINARY_PACKED invalid" in str(exc.value)
