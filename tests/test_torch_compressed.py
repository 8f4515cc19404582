"""The port's compressed shipping against the JAX package, file by file.

Each file is written once with the JAX package's writer and the same path
goes to both readers: ``tpu_parquet_torch.device_reader.DeviceFileReader(
path, device="cpu")`` and ``tpu_parquet.device_reader.DeviceFileReader(
path)``.  The reference runs with ``TPQ_PALLAS=1`` and ``TPQ_FUSE=1``, so its
fused kernels (K2, K3) run in Pallas interpret mode; the port runs its
kernels' plain PyTorch versions.  Both rank the seven ship routes with the
same cost model, unforced and under ``TPQ_FORCE_ROUTE`` for each route, and
must agree exactly on:

- ``to_host()`` and ``levels_to_host()``, bit for bit;
- ``ship_routes`` (streams, logical and shipped bytes per route),
  ``link_bytes_logical`` / ``link_bytes_shipped``, ``fused_fallbacks`` and
  ``pages_device_expanded``.

The columns are the reference's own K3 file (``tests/test_fused_decode.py``:
``dates`` INT64 runs of 50, ``wide`` INT64 full range, ``cnt`` INT32,
``rate`` FLOAT, ``dbl`` DOUBLE runs of 100) plus ``dates32``, an INT32
column of runs of 50 over ``l_shipdate``'s range.  The matrix: that file at
20,000 rows per group (2 groups, about 1,100 snappy ops per run stream, so
K3 claims it when the route is forced) in SNAPPY, GZIP and UNCOMPRESSED; the
same at 40,000 rows per group, where the planner ranks
``fused_narrow_snappy`` first; the GZIP and SNAPPY files without chunk
statistics (the narrow probe path); OPTIONAL columns with nulls on data
pages v2 (lazy v2 pages, level lanes, fused fallbacks); SNAPPY and GZIP
dictionary files (the dictionary value table shipped compressed, or the
recompression attempt); and one group of 131,072 rows, over K3's op cap, so
the fused route falls back to the staged chain with ``fused_fallbacks``
counted.
"""

import numpy as np
import pytest
import torch

from tpu_parquet.column import ColumnData
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.format import (CompressionCodec, FieldRepetitionType as FRT,
                                Type)
from tpu_parquet.schema.core import build_schema, data_column
from tpu_parquet.writer import FileWriter
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.ship import ROUTES

TYPES = {"dates": Type.INT64, "wide": Type.INT64, "cnt": Type.INT32,
         "rate": Type.FLOAT, "dbl": Type.DOUBLE, "dates32": Type.INT32}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _columns(n, seed=23):
    rng = np.random.default_rng(seed)
    return {
        "dates": np.repeat(19_000 + rng.integers(0, 1200, -(-n // 50)),
                           50)[:n].astype(np.int64),
        "wide": rng.integers(-(1 << 62), 1 << 62, n),
        "cnt": rng.integers(0, 50_000, n).astype(np.int32),
        "rate": rng.uniform(0, 1, n).astype(np.float32),
        "dbl": np.repeat(rng.uniform(0.0, 1.0, -(-n // 100)), 100)[:n],
        "dates32": np.repeat(8035 + rng.integers(0, 2526, -(-n // 50)),
                             50)[:n].astype(np.int32),
    }


def _write(path, *, rows, group, codec, names=tuple(TYPES), version=1,
           optional=False, stats=True, dictionary=False):
    cols = _columns(rows)
    rng = np.random.default_rng(7)
    rep = FRT.OPTIONAL if optional else FRT.REQUIRED
    schema = build_schema([data_column(c, TYPES[c], rep) for c in names])
    with FileWriter(path, schema, codec=codec, write_crc=True,
                    data_page_version=version, use_dictionary=dictionary,
                    write_statistics=stats) as w:
        for lo in range(0, rows, group):
            batch = {}
            for c in names:
                part = cols[c][lo : lo + group]
                if optional:
                    present = rng.random(len(part)) >= 0.1
                    part = ColumnData(values=part[present],
                                      def_levels=present.astype(np.int32),
                                      max_def=1, num_leaf_slots=len(part))
                batch[c] = part
            w.write_columns(batch)
            w.flush_row_group()


def _dict_file(path, codec):
    """Dictionary-encoded INT64 and DOUBLE columns over 20,000-value pools:
    value tables large enough for the planner to ship them compressed."""
    rng = np.random.default_rng(29)
    n = 40_000
    pool_i = rng.integers(0, 1 << 45, 20_000)
    pool_d = np.round(rng.uniform(0, 1000, 20_000), 2)
    schema = build_schema([data_column("di", Type.INT64, FRT.REQUIRED),
                           data_column("dd", Type.DOUBLE, FRT.REQUIRED)])
    with FileWriter(path, schema, codec=codec, write_crc=True,
                    use_dictionary=True) as w:
        w.write_columns({"di": pool_i[rng.integers(0, 20_000, n)],
                         "dd": pool_d[rng.integers(0, 20_000, n)]})


S, G, U = (CompressionCodec.SNAPPY, CompressionCodec.GZIP,
           CompressionCodec.UNCOMPRESSED)
FILES = {
    "snappy_20k": lambda p: _write(p, rows=40_000, group=20_000, codec=S),
    "gzip_20k": lambda p: _write(p, rows=40_000, group=20_000, codec=G),
    "uncompressed_20k": lambda p: _write(p, rows=40_000, group=20_000,
                                         codec=U),
    "gzip_40k": lambda p: _write(p, rows=80_000, group=40_000, codec=G),
    "snappy_40k": lambda p: _write(p, rows=80_000, group=40_000, codec=S),
    "gzip_nostats": lambda p: _write(p, rows=40_000, group=20_000, codec=G,
                                     stats=False),
    "snappy_nostats": lambda p: _write(p, rows=40_000, group=20_000,
                                       codec=S, stats=False),
    "snappy_optional_v2": lambda p: _write(p, rows=40_000, group=20_000,
                                           codec=S, version=2,
                                           optional=True),
    "snappy_dict": lambda p: _dict_file(p, S),
    "gzip_dict": lambda p: _dict_file(p, G),
    "gzip_131072": lambda p: _write(p, rows=131_072, group=131_072, codec=G,
                                    names=("dates", "dates32")),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_compressed")
    out = {}
    for name, make in FILES.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's fused kernels in Pallas interpret mode, unforced."""
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _read(reader):
    with reader as r:
        out = [{k: (v.to_host(), v.levels_to_host()) for k, v in g.items()}
               for g in r.iter_row_groups()]
        return out, r.stats().as_dict()


def _counters(stats):
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in stats["ship_routes"].items()}
    return routes, {k: stats[k] for k in (
        "link_bytes_logical", "link_bytes_shipped", "fused_fallbacks",
        "pages_device_expanded", "row_groups", "chunks", "pages", "rows",
        "compressed_bytes")}


def _assert_same(path):
    ref, ref_stats = _read(RefReader(path))
    got, got_stats = _read(DeviceFileReader(path, device="cpu"))
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name in rg_ref:
            (rv, (rd, rr)), (gv, (gd, gr)) = rg_ref[name], rg_got[name]
            assert gv.dtype == rv.dtype and gv.shape == rv.shape, name
            assert np.array_equal(gv.view(np.uint8), rv.view(np.uint8)), name
            assert (gd is None) == (rd is None), name
            if rd is not None:
                assert gd.dtype == rd.dtype and np.array_equal(gd, rd), name
            assert gr is None and rr is None
    assert _counters(got_stats) == _counters(ref_stats)
    assert got_stats["planner_link_mbps"] == ref_stats["planner_link_mbps"]
    return got_stats


# every file of the matrix, unforced and under each forced route; the
# 40,000-row and SNAPPY-without-statistics files are read unforced below
SWEPT = [n for n in FILES if n not in ("gzip_40k", "snappy_40k",
                                        "snappy_nostats")]


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", SWEPT)
def test_compressed_shipping_matches_reference(files, reference_env, name,
                                               route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    CK.reset_launches()
    stats = _assert_same(files[name])
    assert set(CK.launches.values()) == {0}  # CPU tensors launch nothing
    if route == "unforced":
        return
    # a forced route runs wherever its plan function can claim the stream
    ran = set(stats["ship_routes"])
    flat = name != "snappy_optional_v2"  # fused routes claim flat streams
    if "dict" not in name and (route in ("plain", "narrow")
                               or route == "fused_plain" and flat):
        assert route in ran
    if route == "fused_narrow_snappy" and flat:
        if name == "gzip_131072":
            assert stats["fused_fallbacks"] > 0  # over K3's op cap
        elif "dict" not in name:
            assert route in ran


def test_planner_ranks_k3_first_on_the_k3_file(files, reference_env):
    """Unforced, at 40,000-row groups the run columns rank
    fused_narrow_snappy first, as in the reference; on SNAPPY the file's own
    payloads take them (device_snappy)."""
    stats = _assert_same(files["gzip_40k"])
    assert stats["ship_routes"]["fused_narrow_snappy"]["streams"] == 4
    assert stats["ship_routes"]["fused_plain"]["streams"] == 4
    stats = _assert_same(files["snappy_40k"])
    assert "device_snappy" in stats["ship_routes"]
    assert stats["planner_link_mbps"] == 350.0


def test_narrow_probe_without_statistics(files, reference_env):
    """Without chunk statistics the SNAPPY file's int columns have no
    narrow hint and keep their compressed pages (device_snappy)."""
    stats = _assert_same(files["snappy_nostats"])
    assert "device_snappy" in stats["ship_routes"]


def test_fast_link_changes_the_ranking_as_the_reference(files,
                                                        reference_env):
    """TPQ_LINK_MBPS is a ranking input: at 50,000 MB/s shrinking the
    payload no longer pays, in both packages alike."""
    reference_env.setenv("TPQ_LINK_MBPS", "50000")
    stats = _assert_same(files["gzip_40k"])
    assert stats["planner_link_mbps"] == 50_000.0
    assert "fused_narrow_snappy" not in stats["ship_routes"]


def test_dictionary_value_table_ships_compressed(files, reference_env):
    stats = _assert_same(files["snappy_dict"])
    assert stats["ship_routes"]["device_snappy"]["streams"] >= 1
    shipped = stats["ship_routes"]["device_snappy"]["shipped"]
    assert shipped < stats["ship_routes"]["device_snappy"]["logical"]
