"""Nested columns: the port's DeviceFileReader against the JAX package's.

Each file is written once and the same path goes to both readers:
``tpu_parquet_torch.device_reader.DeviceFileReader(path, device="cpu")``
(the kernels' plain PyTorch versions) and
``tpu_parquet.device_reader.DeviceFileReader(path)`` under ``TPQ_PALLAS=1``
and ``TPQ_FUSE=1`` (its Pallas kernels in interpret mode).  Everything is
compared exactly: ``to_host()`` and ``levels_to_host()`` (rep levels
included) bit for bit, the column class, ``ship_routes``, the link-byte
counters, ``fused_fallbacks`` and ``pages_device_expanded``, and how many
level and index streams each reader planned through its BP-group kernel.

The nested shapes, one column each in one schema: LIST<OPTIONAL INT64> with
null lists, empty lists and null elements; LIST<STRING>;
LIST<LIST<OPTIONAL INT32>> (``max_rep`` 2); MAP<STRING, OPTIONAL INT64>; a
LIST of a struct; a legacy two-level ``repeated int32``; a repeated group
inside an OPTIONAL struct; LIST<INT64> written DELTA_BINARY_PACKED where
the dictionary is off; and a flat OPTIONAL string beside them.  The matrix:
dictionary on and off, data pages v1 and v2, SNAPPY and GZIP, small pages;
a v1 file whose pages end in the middle of a record; each unforced and
under each of the seven ``TPQ_FORCE_ROUTE`` names.  Then pyarrow-written
LIST and MAP files (where the reference refuses one, the port must refuse
it with the same class), a LIST column through each value path of the
assembler (the dictionary fallback, DELTA, the host-decode path, PLAIN
booleans, FLBA rows), the ``iter_batches`` refusal of a repeated column,
and ``torch_kernels.row_starts_from_rep`` / ``scatter_defined`` against
``tpu_parquet.jax_kernels``.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpu_parquet import device_reader as RDR
from tpu_parquet import jax_kernels as JK
from tpu_parquet.chunk_encode import ChunkEncoder
from tpu_parquet.column import ByteArrayData
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.format import (CompressionCodec, ConvertedType, Encoding,
                                FieldRepetitionType as FRT, LogicalType,
                                StringType, Type)
from tpu_parquet.schema.core import (ColumnParameters, build_schema,
                                     data_column, group_column, list_column,
                                     map_column)
from tpu_parquet.writer import FileWriter
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import torch_kernels as TK
from tpu_parquet_torch.column import ByteArrayData as PortByteArrayData
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.ship import ROUTES
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

ROWS = 1_200


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's kernels in Pallas interpret mode, unforced."""
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    monkeypatch.delenv("TPQ_FORCE_ROUTE", raising=False)
    return monkeypatch


def _string(name, repetition=FRT.REQUIRED):
    return data_column(name, Type.BYTE_ARRAY, repetition, ColumnParameters(
        logical_type=LogicalType(STRING=StringType()),
        converted_type=ConvertedType.UTF8))


def nested_schema():
    return build_schema([
        list_column("tags", data_column("element", Type.INT64,
                                        FRT.OPTIONAL)),
        list_column("names", _string("element")),
        list_column("grid", list_column(
            "element", data_column("element", Type.INT32, FRT.OPTIONAL))),
        map_column("attrs", _string("key"),
                   data_column("value", Type.INT64, FRT.OPTIONAL)),
        list_column("points", group_column("element", [
            data_column("a", Type.INT32, FRT.REQUIRED),
            data_column("b", Type.DOUBLE, FRT.OPTIONAL)], FRT.REQUIRED)),
        data_column("legacy", Type.INT32, FRT.REPEATED),
        group_column("info", [group_column("vals", [
            data_column("x", Type.INT64, FRT.REQUIRED)], FRT.REPEATED)],
            FRT.OPTIONAL),
        list_column("deltas", data_column("element", Type.INT64,
                                          FRT.REQUIRED)),
        _string("label", FRT.OPTIONAL),
    ])


def nested_rows(n=ROWS, seed=5):
    """Logical rows: lists of 0-7 elements (a null list every 13th row, an
    empty one every 7th), null elements, short strings."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        k = int(rng.integers(0, 8))
        tags = (None if i % 13 == 0 else [] if i % 7 == 0 else
                [None if rng.random() < 0.2 else int(v)
                 for v in rng.integers(-50, 50, k)])
        grid = None if i % 11 == 0 else [
            None if rng.random() < 0.1 else
            [None if rng.random() < 0.2 else int(v)
             for v in rng.integers(0, 9, int(rng.integers(0, 4)))]
            for _ in range(int(rng.integers(0, 4)))]
        attrs = None if i % 17 == 0 else {
            f"k{int(j)}": (None if rng.random() < 0.25 else int(j) * 3)
            for j in rng.choice(20, int(rng.integers(0, 5)), replace=False)}
        rows.append({
            "tags": tags,
            "names": [f"n{int(v)}" for v in rng.integers(0, 30, k % 4)],
            "grid": grid,
            "attrs": attrs,
            "points": [{"a": int(rng.integers(0, 100)),
                        "b": None if rng.random() < 0.3
                        else float(rng.integers(0, 1000)) / 8}
                       for _ in range(int(rng.integers(0, 3)))],
            "legacy": [int(v) for v in rng.integers(0, 60, k % 3)],
            "info": None if i % 5 == 0 else {
                "vals": [{"x": int(v)}
                         for v in rng.integers(0, 1 << 40,
                                               int(rng.integers(0, 3)))]},
            "deltas": [int(v) for v in
                       np.cumsum(rng.integers(1, 1000, k)) + i * 10_000],
            "label": None if i % 9 == 0 else f"L{i % 40}",
        })
    return rows


def _write_nested(path, *, dictionary, version, codec, split_records=False,
                  monkeypatch=None):
    if split_records:
        # pages cut every 97 slots, wherever a record is: legal in v1 (some
        # writers do it), never done by this writer or pyarrow
        def bounds(self, cd):
            n = cd.num_leaf_slots
            return [(lo, min(lo + 97, n)) for lo in range(0, max(n, 1), 97)]

        monkeypatch.setattr(ChunkEncoder, "_page_bounds", bounds)
    with FileWriter(path, nested_schema(), codec=codec,
                    data_page_version=version, page_size=1024,
                    row_group_size=1 << 16, use_dictionary=dictionary,
                    write_crc=True,
                    column_encodings={"deltas.list.element":
                                      Encoding.DELTA_BINARY_PACKED}) as w:
        w.write_rows(nested_rows())
    if split_records:
        monkeypatch.undo()


S, G = CompressionCodec.SNAPPY, CompressionCodec.GZIP
FILES = {
    f"dict{int(d)}_v{v}_{c.name.lower()}": dict(dictionary=d, version=v,
                                                codec=c)
    for d in (True, False) for v in (1, 2) for c in (S, G)
}
FILES["split_records_v1"] = dict(dictionary=True, version=1, codec=S,
                                 split_records=True)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_nested")
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for name, kw in FILES.items():
            path = str(root / f"{name}.parquet")
            _write_nested(path, monkeypatch=mp, **kw)
            out[name] = path
    finally:
        mp.undo()
    return out


def _snapshot(reader):
    """Every row group as ``{column: (class name, to_host(), levels)}``,
    and the reader's counters."""
    groups = [{k: (type(v).__name__, v.to_host(), v.levels_to_host())
               for k, v in g.items()} for g in reader.iter_row_groups()]
    return groups, reader.stats().as_dict()


def _hybrid_plans(monkeypatch, module):
    """Count the streams ``module._plan_hybrid_pallas`` planned through the
    BP-group kernel (non-None returns), by bit width."""
    real = module._plan_hybrid_pallas
    seen = {}

    def spy(stager, pages_info, width, *args):
        plan = real(stager, pages_info, width, *args)
        if plan is not None:
            seen[width] = seen.get(width, 0) + 1
        return plan

    monkeypatch.setattr(module, "_plan_hybrid_pallas", spy)
    return seen


def _read_both(path, monkeypatch):
    ref_plans = _hybrid_plans(monkeypatch, RDR)
    got_plans = _hybrid_plans(monkeypatch, DR)
    with RefReader(path) as r:
        ref, ref_stats = _snapshot(r)
    with DeviceFileReader(path, device="cpu") as r:
        got, got_stats = _snapshot(r)
    return ref, got, ref_stats, got_stats, ref_plans, got_plans


def _same_values(gv, rv, name):
    if isinstance(rv, ByteArrayData):
        assert isinstance(gv, PortByteArrayData), name
        assert np.array_equal(gv.offsets, rv.offsets), name
        assert np.array_equal(gv.heap, rv.heap), name
        return
    assert gv.dtype == rv.dtype and gv.shape == rv.shape, (name, gv.dtype,
                                                          rv.dtype)
    assert np.array_equal(np.ascontiguousarray(gv).view(np.uint8),
                          np.ascontiguousarray(rv).view(np.uint8)), name


def _assert_same(ref, got):
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name in rg_ref:
            (rk, rv, (rd, rr)), (gk, gv, (gd, gr)) = rg_ref[name], rg_got[name]
            assert gk == rk, (name, gk, rk)
            _same_values(gv, rv, name)
            for g, r in ((gd, rd), (gr, rr)):
                assert (g is None) == (r is None), name
                if r is not None:
                    assert g.dtype == r.dtype and np.array_equal(g, r), name


def _routes(stats):
    return {r: (v["streams"], v["logical"], v["shipped"])
            for r, v in stats["ship_routes"].items()}


def _assert_counters(ref_stats, got_stats):
    assert _routes(got_stats) == _routes(ref_stats)
    for key in ("link_bytes_logical", "link_bytes_shipped",
                "fused_fallbacks", "pages_device_expanded", "row_groups",
                "chunks", "pages", "rows", "compressed_bytes"):
        assert got_stats[key] == ref_stats[key], key


@pytest.mark.parametrize("route", [None] + list(ROUTES))
@pytest.mark.parametrize("name", list(FILES))
def test_nested_matches_reference(files, reference_env, name, route):
    if route is not None:
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    ref, got, ref_stats, got_stats, ref_plans, got_plans = _read_both(
        files[name], reference_env)
    _assert_same(ref, got)
    _assert_counters(ref_stats, got_stats)
    # every level and index stream the reference sent through its K1 the
    # port sends through the fused K1, at the same widths
    assert got_plans == ref_plans
    if route is None:
        # rep streams at K1 widths 1 (max_rep 1) and 2 (``grid``)
        assert got_plans.get(1, 0) > 0 and got_plans.get(2, 0) > 0
        cols = got[0]
        assert cols["grid.list.element.list.element"][2][1] is not None
        assert cols["grid.list.element.list.element"][2][1].max() == 2


def test_split_record_pages_cross_records(files):
    """The split file's pages really end inside records: some v1 data page
    starts with a nonzero rep level."""
    from tpu_parquet_torch.chunk_decode import ChunkDecoder, walk_pages
    from tpu_parquet_torch.footer import read_file_metadata
    from tpu_parquet_torch.schema.core import Schema

    path = files["split_records_v1"]
    with open(path, "rb") as f:
        meta = read_file_metadata(f)
        schema = Schema.from_file_metadata(meta)
        leaf = schema.leaf_by_path(("tags", "list", "element"))
        md = next(c.meta_data for c in meta.row_groups[0].columns
                  if tuple(c.meta_data.path_in_schema) == leaf.path)
        start = min(md.data_page_offset, md.dictionary_page_offset
                    or md.data_page_offset)
        f.seek(start)
        buf = f.read(md.total_compressed_size)
    dec = ChunkDecoder(leaf)
    firsts = []
    for ps in walk_pages(buf, md.num_values):
        if ps.header.type == 0:  # DATA_PAGE
            dec.dictionary = np.zeros(1 << 16, np.int64)
            _, _, rep, _ = dec._decode_data_page_v1(ps, buf, md.codec)
            firsts.append(int(rep[0]))
    assert len(firsts) > 3 and any(firsts)


# ---------------------------------------------------------------------------
# pyarrow-written LIST and MAP files
# ---------------------------------------------------------------------------

def _pyarrow_tables():
    rng = np.random.default_rng(31)
    n = 3_000
    lens = rng.integers(0, 6, n)
    ints = [None if i % 19 == 0 else
            [None if rng.random() < 0.1 else int(v)
             for v in rng.integers(0, 40, int(k))]
            for i, k in enumerate(lens)]
    strs = [[f"s{int(v)}" for v in rng.integers(0, 25, int(k))]
            for k in lens]
    maps = [None if i % 23 == 0 else
            [(f"k{j}", None if rng.random() < 0.2 else int(j * 7 + i))
             for j in range(int(k))] for i, k in enumerate(lens)]
    nested = [[[int(v) for v in rng.integers(0, 5, int(m))]
               for m in rng.integers(0, 3, int(k) % 3)] for k in lens]
    structs = [[{"a": int(v), "b": float(v) / 4} for v in
                rng.integers(0, 9, int(k) % 3)] for k in lens]
    return {
        "list_int64": pa.table({"l": pa.array(ints, pa.list_(pa.int64()))}),
        "list_string": pa.table({"l": pa.array(strs,
                                               pa.list_(pa.string()))}),
        "map_string_int64": pa.table({"m": pa.array(
            maps, pa.map_(pa.string(), pa.int64()))}),
        "list_list_int32": pa.table({"l": pa.array(
            nested, pa.list_(pa.list_(pa.int32())))}),
        "list_struct": pa.table({"l": pa.array(structs, pa.list_(
            pa.struct([("a", pa.int32()), ("b", pa.float64())])))}),
        "large_list_int64": pa.table({"l": pa.array(
            ints, pa.large_list(pa.int64()))}),
    }


PA_CASES = [(t, v, d, "snappy") for t in (
    "list_int64", "list_string", "map_string_int64", "list_list_int32",
    "list_struct", "large_list_int64")
    for v, d in (("1.0", True), ("2.0", False))]
# codecs neither package reads: both refuse, with the same error
PA_CASES += [("list_int64", "1.0", True, "lz4"),
             ("map_string_int64", "2.0", False, "brotli")]


@pytest.fixture(scope="module")
def pa_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_nested_pa")
    tables = _pyarrow_tables()
    out = {}
    for case in PA_CASES:
        table, version, dictionary, codec = case
        path = str(root / ("_".join(map(str, case)) + ".parquet"))
        pq.write_table(tables[table], path, data_page_version=version,
                       use_dictionary=dictionary, data_page_size=2048,
                       row_group_size=1_500, compression=codec,
                       write_page_checksum=True)
        out[case] = path
    return out


@pytest.mark.parametrize("case", PA_CASES, ids=lambda c: "-".join(map(str, c)))
def test_pyarrow_nested_matches_reference(pa_files, reference_env, case):
    path = pa_files[case]
    try:
        with RefReader(path) as r:
            ref, ref_stats = _snapshot(r)
    except Exception as e:  # the reference refuses: so must the port
        with pytest.raises(Exception) as got_err:
            with DeviceFileReader(path, device="cpu") as r:
                _snapshot(r)
        assert type(got_err.value).__name__ == type(e).__name__
        assert str(got_err.value) == str(e)
        assert case[3] != "snappy"  # only the unread codecs are refused
        return
    assert case[3] == "snappy"
    with DeviceFileReader(path, device="cpu") as r:
        got, got_stats = _snapshot(r)
    _assert_same(ref, got)
    _assert_counters(ref_stats, got_stats)
    assert any(lv[1] is not None for rg in got for _, _, lv in rg.values())


def _value_path_table(kind):
    """One LIST column of 3,000 rows (0-5 elements, null lists) whose
    values take one of the assembler's value paths."""
    rng = np.random.default_rng(37)
    lens = rng.integers(0, 6, 3_000)

    def lists(draw, typ):
        return pa.table({"l": pa.array(
            [None if i % 17 == 0 else [draw() for _ in range(int(k))]
             for i, k in enumerate(lens)], pa.list_(typ))})

    if kind in ("mixed_dict_plain", "delta"):
        return lists(lambda: int(rng.integers(0, 1 << 40)), pa.int64())
    if kind == "bss":
        return lists(lambda: float(rng.random()), pa.float32())
    if kind == "dlba":
        return lists(lambda: f"v{int(rng.integers(0, 500))}", pa.string())
    if kind in ("bool_rle", "bool_plain"):
        return lists(lambda: bool(rng.random() < 0.3), pa.bool_())
    return lists(lambda: bytes(rng.integers(0, 256, 4, dtype=np.uint8)),
                 pa.binary(4))


ELEM = "l.list.element"
# kind -> (the port's _ChunkAssembler method the chunks must take, the
# pyarrow writer's options)
VALUE_PATHS = {
    "mixed_dict_plain": ("_finish_mixed_dict_plain",
                         dict(use_dictionary=True,
                              dictionary_pagesize_limit=2048)),
    "delta": ("_finish_delta", dict(use_dictionary=False, column_encoding={
        ELEM: "DELTA_BINARY_PACKED"})),
    "bss": ("_finish_host", dict(use_dictionary=False, column_encoding={
        ELEM: "BYTE_STREAM_SPLIT"})),
    "dlba": ("_finish_host", dict(use_dictionary=False, column_encoding={
        ELEM: "DELTA_LENGTH_BYTE_ARRAY"})),
    "bool_rle": ("_finish_host", dict(use_dictionary=False,
                                      column_encoding={ELEM: "RLE"})),
    "bool_plain": ("_finish_plain_bool", dict(use_dictionary=False,
                                              column_encoding={
                                                  ELEM: "PLAIN"})),
    "flba": ("_finish_plain_rows", dict(use_dictionary=False)),
}


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("kind", list(VALUE_PATHS))
def test_nested_value_paths_match_reference(tmp_path, reference_env, kind,
                                            version):
    """A repeated leaf through each value path of the assembler (the
    dictionary fallback, DELTA, the host-decode path, PLAIN booleans, FLBA
    rows) reads equal to the reference, rep levels and class included."""
    method, kw = VALUE_PATHS[kind]
    path = str(tmp_path / f"{kind}.parquet")
    pq.write_table(_value_path_table(kind), path, data_page_version=version,
                   data_page_size=2048, row_group_size=1_500, **kw)
    taken = []
    real = getattr(DR._ChunkAssembler, method)

    def spy(self, *args, **kwargs):
        taken.append(self.leaf.max_rep)
        return real(self, *args, **kwargs)

    reference_env.setattr(DR._ChunkAssembler, method, spy)
    with RefReader(path) as r:
        ref, ref_stats = _snapshot(r)
    with DeviceFileReader(path, device="cpu") as r:
        got, got_stats = _snapshot(r)
    _assert_same(ref, got)
    _assert_counters(ref_stats, got_stats)
    assert taken and set(taken) == {1}, (method, taken)
    assert all(rg[ELEM][2][1] is not None for rg in got)


def test_iter_batches_refuses_repeated_as_reference(files, reference_env):
    path = files["dict1_v1_snappy"]
    for cols in (["legacy"], ["deltas.list.element"]):
        with pytest.raises(TypeError) as ref_err:
            with RefReader(path) as r:
                next(r.iter_batches(10, columns=cols))
        with pytest.raises(TypeError) as got_err:
            with DeviceFileReader(path, device="cpu") as r:
                next(r.iter_batches(10, columns=cols))
        assert str(got_err.value) == str(ref_err.value)
        assert "is repeated" in str(got_err.value)
    # a ragged repeated column is refused as ragged first, as in the
    # reference
    with pytest.raises(TypeError) as ref_err:
        with RefReader(path) as r:
            next(r.iter_batches(10, columns=["names.list.element"]))
    with pytest.raises(TypeError) as got_err:
        with DeviceFileReader(path, device="cpu") as r:
            next(r.iter_batches(10, columns=["names.list.element"]))
    assert str(got_err.value) == str(ref_err.value)


# ---------------------------------------------------------------------------
# row_starts_from_rep and scatter_defined
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,max_rep,seed", [(0, 1, 0), (1, 1, 1), (777, 1, 2),
                                            (4096, 2, 3)])
def test_row_starts_from_rep_matches_reference(n, max_rep, seed):
    rep = np.random.default_rng(seed).integers(0, max_rep + 1, n,
                                               dtype=np.int32)
    if n:
        rep[0] = 0
    with JK.enable_x64():
        w_starts, w_index = JK.row_starts_from_rep(jnp.asarray(rep))
        w_starts, w_index = np.asarray(w_starts), np.asarray(w_index)
    g_starts, g_index = TK.row_starts_from_rep(torch.from_numpy(rep))
    assert g_starts.dtype == torch.bool and g_index.dtype == torch.int64
    assert np.array_equal(g_starts.numpy(), w_starts)
    assert w_index.dtype == np.int64
    assert np.array_equal(g_index.numpy(), w_index)


SCATTER = [
    ("int32", 1, 0, -1), ("int64", 1, 1, 7), ("float64", 1, 2, 0.0),
    ("int32", 2, 3, 0), ("float64", 2, 4, -2.5), ("int64", 1, 5, 0),
]


@pytest.mark.parametrize("dtype,ndim,seed,fill", SCATTER)
@pytest.mark.parametrize("empty", [False, True])
def test_scatter_defined_matches_reference(dtype, ndim, seed, fill, empty):
    rng = np.random.default_rng(seed)
    n = 1_000
    validity = rng.random(n) < (0.0 if empty else 0.7)
    k = int(validity.sum())
    shape = (k,) if ndim == 1 else (k, 3)
    if dtype == "float64":
        values = rng.standard_normal(shape)
        values.reshape(-1)[:2] = [np.nan, -0.0] if values.size >= 2 else []
    else:
        values = rng.integers(-(1 << 30), 1 << 30, shape).astype(dtype)
    with JK.enable_x64():
        want = np.asarray(JK.scatter_defined(jnp.asarray(values),
                                             jnp.asarray(validity), fill))
    got = TK.scatter_defined(torch.from_numpy(values),
                             torch.from_numpy(validity), fill).numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
