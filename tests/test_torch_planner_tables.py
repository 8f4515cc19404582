"""The reader-less batched decode and the planner's tables against the JAX
package's.

- ``device_reader.decode_chunk_batched``: every chunk of the nested file of
  ``test_torch_nested`` and of a flat file (fixed-width PLAIN with chunk
  statistics, dictionary, DELTA, strings, booleans), decoded chunk by chunk
  by both packages (the port with ``device="cpu"``, the reference under
  ``TPQ_PALLAS=1 TPQ_FUSE=1``), unforced and under each
  ``TPQ_FORCE_ROUTE``; and the corrupt dictionary index of
  ``tests/test_device_reader.py`` with the same ``ParquetError`` text.
- ``ShipPlanner.unfused_device_costs`` and ``decision_table`` over a grid of
  ``ChunkFacts`` and planner rates, ``recalibrate_link_mbps`` and
  ``recalibrate_device_mbps`` over measured rates, all equal exactly.
- ``default_planner``: one process-wide planner, rebuilt when a routing
  knob of the environment changes, at the same points as the reference's.
"""

import itertools

import numpy as np
import pytest
import torch

from tests.test_jax_decode import _craft_dict_chunk
from tests.test_torch_nested import nested_rows, nested_schema
from tpu_parquet import device_reader as RDR
from tpu_parquet import ship as RS
from tpu_parquet.chunk_decode import validate_chunk_meta
from tpu_parquet.format import (CompressionCodec, Encoding,
                                FieldRepetitionType as FRT, Type)
from tpu_parquet.reader import FileReader as RefHostReader
from tpu_parquet.schema.core import build_schema, data_column
from tpu_parquet.writer import FileWriter
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import ship as PS
from tpu_parquet_torch.errors import ParquetError as PortParquetError
from tpu_parquet_torch.footer import read_file_metadata
from tpu_parquet_torch.schema.core import Schema
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def _flat_file(path):
    rng = np.random.default_rng(41)
    n = 20_000
    schema = build_schema([
        data_column("narrow", Type.INT64, FRT.REQUIRED),
        data_column("wide", Type.INT64, FRT.REQUIRED),
        data_column("dict32", Type.INT32, FRT.OPTIONAL),
        data_column("dbl", Type.DOUBLE, FRT.REQUIRED),
        data_column("delta", Type.INT64, FRT.REQUIRED),
        data_column("flag", Type.BOOLEAN, FRT.REQUIRED),
        data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED),
    ])
    from tpu_parquet.column import ByteArrayData, ColumnData

    present = rng.random(n) >= 0.1
    cols = {
        "narrow": 19_000 + rng.integers(0, 1200, n),
        "wide": rng.integers(-(1 << 62), 1 << 62, n),
        "dict32": ColumnData(values=rng.integers(0, 40, int(present.sum())
                                                 ).astype(np.int32),
                             def_levels=present.astype(np.int32), max_def=1,
                             num_leaf_slots=n),
        "dbl": rng.standard_normal(n),
        "delta": np.cumsum(rng.integers(1, 9, n)),
        "flag": rng.random(n) < 0.3,
        "s": ColumnData(values=ByteArrayData.from_list(
            [f"s{int(v)}".encode() for v in rng.integers(0, 90_000, n)])),
    }
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    write_crc=True, use_dictionary=False,
                    column_encodings={"delta": Encoding.DELTA_BINARY_PACKED}
                    ) as w:
        w.write_columns(cols)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_planner_tables")
    nested = str(root / "nested.parquet")
    with FileWriter(nested, nested_schema(), page_size=1024,
                    codec=CompressionCodec.SNAPPY) as w:
        w.write_rows(nested_rows(600, seed=12))
    return {"nested": nested, "flat": _flat_file(str(root / "flat.parquet"))}


def _chunks(path):
    """(name, buf, codec, num_values, reference leaf, port leaf) for each
    chunk of row group 0."""
    with RefHostReader(path) as r:
        ref_leaves = {l.path: l for l in r.schema.leaves}
        rg = r.metadata.row_groups[0]
        with open(path, "rb") as f:
            meta = read_file_metadata(f)
            port_leaves = {l.path: l for l in
                           Schema.from_file_metadata(meta).leaves}
            out = []
            for chunk in rg.columns:
                path_t = tuple(chunk.meta_data.path_in_schema)
                md, offset = validate_chunk_meta(chunk, ref_leaves[path_t])
                f.seek(offset)
                out.append((".".join(path_t),
                            f.read(md.total_compressed_size), md.codec,
                            md.num_values, ref_leaves[path_t],
                            port_leaves[path_t]))
    return out


def _host(col):
    return type(col).__name__, col.to_host(), col.levels_to_host()


def _same(got, want, name):
    (gk, gv, (gd, gr)), (wk, wv, (wd, wr)) = got, want
    assert gk == wk, name
    if hasattr(wv, "offsets"):
        assert np.array_equal(gv.offsets, wv.offsets), name
        assert np.array_equal(gv.heap, wv.heap), name
    else:
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        assert np.array_equal(np.ascontiguousarray(gv).view(np.uint8),
                              np.ascontiguousarray(wv).view(np.uint8)), name
    for g, w in ((gd, wd), (gr, wr)):
        assert (g is None) == (w is None), name
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), name


@pytest.mark.parametrize("route", [None] + list(PS.ROUTES))
@pytest.mark.parametrize("name", ["nested", "flat"])
def test_decode_chunk_batched_matches_reference(files, reference_env, name,
                                                route):
    if route is not None:
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    for col, buf, codec, n, ref_leaf, port_leaf in _chunks(files[name]):
        ref_def, got_def = [], []
        want = RDR.decode_chunk_batched(buf, codec, n, ref_leaf, ref_def)
        got = DR.decode_chunk_batched(buf, codec, n, port_leaf, got_def,
                                      device="cpu")
        assert len(got_def) == len(ref_def) == 0  # the native walk checked
        _same(_host(got), _host(want), col)


def test_decode_chunk_batched_empty_chunk(files):
    (col, buf, codec, n, ref_leaf, port_leaf), *_ = _chunks(files["flat"])
    want = RDR.decode_chunk_batched(buf, codec, 0, ref_leaf, [])
    got = DR.decode_chunk_batched(buf, codec, 0, port_leaf, [], device="cpu")
    assert got.values.dtype == torch.int64 and got.num_leaf_slots == 0
    _same(_host(got), _host(want), col)


def test_decode_chunk_batched_default_device_is_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    (col, buf, codec, n, _, port_leaf), *_ = _chunks(files["flat"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DR.decode_chunk_batched(buf, codec, n, port_leaf, [])


def test_decode_chunk_batched_corrupt_dict_index(reference_env):
    from tpu_parquet.footer import ParquetError
    from tpu_parquet_torch.format import (FieldRepetitionType as PFRT,
                                          Type as PType)
    from tpu_parquet_torch.schema.core import (build_schema as p_build,
                                               data_column as p_column)

    ref_leaf = build_schema([data_column("v", Type.INT64,
                                         FRT.REQUIRED)]).leaves[0]
    port_leaf = p_build([p_column("v", PType.INT64,
                                  PFRT.REQUIRED)]).leaves[0]
    buf, codec = _craft_dict_chunk([1, 9, 2], np.arange(4))
    with pytest.raises(ParquetError, match="out of range") as ref_err:
        RDR.decode_chunk_batched(buf, codec, 3, ref_leaf, [])
    with pytest.raises(PortParquetError, match="out of range") as got_err:
        DR.decode_chunk_batched(buf, codec, 3, port_leaf, [], device="cpu")
    assert str(got_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# the planner's tables
# ---------------------------------------------------------------------------

FACT_GRID = list(itertools.product(
    (0, 4_096, 65_536, 1 << 20, 9 << 20),   # logical
    (0, 4, 8),                              # width
    (0, 1, 3),                              # narrow_k
    (False, True),                          # narrow_possible
    (0, 0.4),                               # comp_bytes, as a share
    (False, True),                          # native
    (False, True),                          # host_bytes_ready
    (False, True),                          # flat
))
RATES = [(None, None), (40.0, 3000.0), (5000.0, 200.0), (1.0, 1e6)]


def _facts(mod, row):
    logical, width, k, possible, comp, native, ready, flat = row
    return mod.ChunkFacts(logical=logical, width=width, narrow_k=k,
                          narrow_possible=possible,
                          comp_bytes=int(comp * logical), native=native,
                          host_bytes_ready=ready, flat=flat)


@pytest.mark.parametrize("link,device", RATES)
def test_planner_tables_match_reference(link, device, monkeypatch):
    monkeypatch.delenv("TPQ_FORCE_ROUTE", raising=False)
    monkeypatch.delenv("TPQ_LINK_MBPS", raising=False)
    monkeypatch.delenv("TPQ_DEVICE_MBPS", raising=False)
    ref = RS.ShipPlanner(link_mbps=link, device_mbps=device, fuse=True)
    got = PS.ShipPlanner(link_mbps=link, device_mbps=device)
    for row in FACT_GRID:
        rf, gf = _facts(RS, row), _facts(PS, row)
        assert got.decision_table(gf) == ref.decision_table(rf), row
        assert got.unfused_device_costs(gf) == ref.unfused_device_costs(rf)
        costs = got.costs(gf)
        assert got.unfused_device_costs(gf, routes=costs) == \
            ref.unfused_device_costs(rf, routes=ref.costs(rf))


@pytest.mark.parametrize("rate", [None, 0, -5.0, 1.0, 49_999.0, 5e5,
                                  3.5e8, 1.234567e9, 7.77e12,
                                  float("inf"), float("nan")])
def test_recalibrate_matches_reference(rate):
    for name in ("recalibrate_link_mbps", "recalibrate_device_mbps"):
        want = getattr(RS, name)(rate)
        got = getattr(PS, name)(rate)
        assert repr(got) == repr(want), (name, rate)


def test_default_planner_rebuilds_as_reference(monkeypatch):
    for knob in ("TPQ_LINK_MBPS", "TPQ_FORCE_ROUTE", "TPQ_DEVICE_MBPS",
                 "TPQ_FUSE"):
        monkeypatch.delenv(knob, raising=False)
    steps = [("TPQ_LINK_MBPS", "120"), ("TPQ_LINK_MBPS", "120"),
             ("TPQ_FORCE_ROUTE", "narrow"), ("TPQ_DEVICE_MBPS", "800"),
             ("TPQ_FUSE", "1"), ("TPQ_FORCE_ROUTE", "bogus"),
             ("TPQ_LINK_MBPS", None)]
    prev_ref, prev_got = RS.default_planner(), PS.default_planner()
    assert PS.default_planner() is prev_got
    for knob, value in steps:
        if value is None:
            monkeypatch.delenv(knob)
        else:
            monkeypatch.setenv(knob, value)
        ref, got = RS.default_planner(), PS.default_planner()
        assert (got is prev_got) == (ref is prev_ref), (knob, value)
        assert (got.link_mbps, got.device_mbps, got.force) == (
            ref.link_mbps, ref.device_mbps, ref.force), (knob, value)
        assert PS.default_planner() is got
        prev_ref, prev_got = ref, got
