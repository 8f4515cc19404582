"""The port's page-by-page device decoder and the reader's host-decode path,
against the JAX package.

``tpu_parquet_torch.torch_decode.DeviceChunkDecoder`` /
``read_chunk_device`` decode one column chunk page by page, as the
reference's ``jax_decode`` twins do; the batched reader sends the chunks it
does not batch through the same decoder (``_finish_host``).  The inputs are
written by pyarrow (or by the port's writer, for hand-built DELTA pages)
from seeded numpy data; the reference runs with ``TPQ_PALLAS=1 TPQ_FUSE=1``.
Compared exactly (bit for bit through ``.view``): ``to_host()``,
``levels_to_host()`` and the slot counts, per encoding and physical type;
the four DELTA_BINARY_PACKED chunk shapes the batched plan hands to the
host path; and the text of every corruption error, decode-site suffix
(``[file=... column=... row_group=... page=... offset=...]``) and all.
"""

import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpu_parquet import jax_decode as JD
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.footer import read_file_metadata as ref_metadata
from tpu_parquet.schema.core import Schema as RefSchema
from tpu_parquet.writer import corrupt_page
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import torch_decode as TD
from tpu_parquet_torch.column import ByteArrayData, ColumnData
from tpu_parquet_torch.errors import ParquetError
from tpu_parquet_torch.footer import read_file_metadata
from tpu_parquet_torch.format import (CompressionCodec, Encoding,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.kernels import delta as port_delta
from tpu_parquet_torch.schema.core import Schema, build_schema, data_column
from tpu_parquet_torch.writer import FileWriter

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
    monkeypatch.delenv("TPQ_FORCE_ROUTE", raising=False)
    return monkeypatch


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def _same_host(rv, gv, what=""):
    if isinstance(rv, ByteArrayData) or hasattr(rv, "offsets"):
        assert np.array_equal(np.asarray(gv.offsets),
                              np.asarray(rv.offsets)), what
        assert np.array_equal(np.asarray(gv.heap), np.asarray(rv.heap)), what
        return
    assert gv.dtype == rv.dtype and gv.shape == rv.shape, (what, gv.dtype,
                                                           rv.dtype)
    assert np.array_equal(_bits(gv), _bits(rv)), what


def _same_levels(ref_col, got_col, what=""):
    for r, g in zip(ref_col.levels_to_host(), got_col.levels_to_host()):
        assert (r is None) == (g is None), what
        if r is not None:
            assert g.dtype == r.dtype and np.array_equal(g, r), what


# ---------------------------------------------------------------------------
# files: one column per (encoding, physical type), REQUIRED and OPTIONAL
# ---------------------------------------------------------------------------

def _strings(rng, n, pool=60):
    words = [f"w{i:03d}-{'x' * (i % 7)}" for i in range(pool)]
    return [words[i] for i in rng.integers(0, pool, n)]


def _shape_columns(rng, n):
    days = rng.integers(0, 2526, n)
    grow = (rng.random(n) * (np.arange(n) * 3000 // n + 1)).astype(np.int64)
    return {
        # name: (arrow array, pyarrow column encoding or None = dictionary)
        "i32_plain": (pa.array(rng.integers(-9, 9, n).astype(np.int32)),
                      "PLAIN"),
        "i64_dict": (pa.array(grow), None),
        "i32_delta": (pa.array(grow.astype(np.int32)), "DELTA_BINARY_PACKED"),
        "i64_delta": (pa.array(grow * -77), "DELTA_BINARY_PACKED"),
        "f32_bss": (pa.array(rng.standard_normal(n).astype(np.float32)),
                    "BYTE_STREAM_SPLIT"),
        "f64_bss": (pa.array(np.where(rng.random(n) < 0.1, -0.0,
                                      rng.standard_normal(n))),
                    "BYTE_STREAM_SPLIT"),
        "f64_plain": (pa.array(rng.standard_normal(n)), "PLAIN"),
        "bool_plain": (pa.array(rng.random(n) < 0.3), "PLAIN"),
        # spans of 4: bit-packed runs, and RLE runs where spans repeat
        "bool_rle": (pa.array(np.repeat(rng.random(n // 4 + 1) < 0.5,
                                        4)[:n]), "RLE"),
        "ts96_plain": (pa.array(((days + 8035) * 86_400_000_000_000).astype(
            "datetime64[ns]")), "PLAIN"),
        "ts96_dict": (pa.array(((days % 90) * 86_400_000_000_123).astype(
            "datetime64[ns]")), None),
        "flba4_plain": (pa.array([bytes([d % 256, 7, d % 3, 1]) for d in days],
                                 pa.binary(4)), "PLAIN"),
        "flba4_dict": (pa.array([bytes([d % 40, 0, 0, 9]) for d in days],
                                pa.binary(4)), None),
        "flba4_bss": (pa.array([bytes([d % 256, d % 7, 1, 2]) for d in days],
                               pa.binary(4)), "BYTE_STREAM_SPLIT"),
        "str_plain": (pa.array(_strings(rng, n)), "PLAIN"),
        "str_dict": (pa.array(_strings(rng, n)), None),
        "str_dlba": (pa.array(_strings(rng, n, 900)),
                     "DELTA_LENGTH_BYTE_ARRAY"),
        "str_dba": (pa.array(sorted(_strings(rng, n, 900))),
                    "DELTA_BYTE_ARRAY"),
    }


SHAPES = list(_shape_columns(np.random.default_rng(0), 10))


def _shapes_file(path, *, seed, compression, version):
    rng = np.random.default_rng(seed)
    cols = _shape_columns(rng, N)
    arrays, fields, enc, dict_cols = [], [], {}, []
    mask = rng.random(N) < 0.2
    for name, (arr, e) in cols.items():
        for suffix, nullable in (("", False), ("_opt", True)):
            a = arr
            if nullable:
                a = pa.array(arr.to_pylist(), arr.type,
                             mask=mask) if not pa.types.is_boolean(
                    arr.type) else pa.array(arr.to_numpy(
                        zero_copy_only=False), mask=mask)
            fields.append(pa.field(name + suffix, arr.type,
                                   nullable=nullable))
            arrays.append(a)
            if e is None:
                dict_cols.append(name + suffix)
            else:
                enc[name + suffix] = e
    table = pa.Table.from_arrays(arrays, schema=pa.schema(fields))
    pq.write_table(table, path, row_group_size=GROUP, data_page_size=2048,
                   compression=compression, data_page_version=version,
                   use_dictionary=dict_cols, column_encoding=enc,
                   use_deprecated_int96_timestamps=True,
                   write_page_checksum=True)


SHAPE_FILES = {
    "snappy_v1": dict(seed=1, compression="snappy", version="1.0"),
    "gzip_v2": dict(seed=2, compression="gzip", version="2.0"),
    "zstd_v1": dict(seed=3, compression="zstd", version="1.0"),
}


@pytest.fixture(scope="module")
def shape_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_host_decode")
    out = {}
    for name, kw in SHAPE_FILES.items():
        path = str(root / f"{name}.parquet")
        _shapes_file(path, **kw)
        out[name] = path
    return out


def _chunks(path):
    """[(row group, column name, ref chunk, ref leaf, port chunk, port
    leaf)] of a file, from each package's own footer parse."""
    with open(path, "rb") as f:
        rmd, pmd = ref_metadata(f), read_file_metadata(f)
    rleaves = {l.path: l for l in RefSchema.from_file_metadata(rmd).leaves}
    pleaves = {l.path: l for l in Schema.from_file_metadata(pmd).leaves}
    out = []
    for i, (rrg, prg) in enumerate(zip(rmd.row_groups, pmd.row_groups)):
        for rc, pc in zip(rrg.columns, prg.columns):
            path_t = tuple(rc.meta_data.path_in_schema)
            out.append((i, ".".join(path_t), rc, rleaves[path_t], pc,
                        pleaves[path_t]))
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(SHAPE_FILES))
def test_read_chunk_device_matches_reference(shape_files, reference_env,
                                             name, shape):
    """Per encoding and physical type, REQUIRED and OPTIONAL: the port's
    page-by-page decoder equals the reference's, chunk by chunk."""
    path = shape_files[name]
    CK.reset_launches()
    seen = 0
    with open(path, "rb") as f:
        for rg, col, rc, rleaf, pc, pleaf in _chunks(path):
            if col not in (shape, shape + "_opt"):
                continue
            ref = JD.read_chunk_device(f, rc, rleaf)
            got = TD.read_chunk_device(f, pc, pleaf, device="cpu")
            what = f"{col} rg {rg}"
            assert got.num_leaf_slots == ref.num_leaf_slots, what
            assert got.num_values == ref.num_values, what
            _same_host(ref.to_host(), got.to_host(), what)
            _same_levels(ref, got, what)
            seen += 1
    assert seen == 4
    assert set(CK.launches.values()) == {0}  # CPU tensors launch nothing


def test_chunk_decoder_defaults_to_the_card(shape_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.DeviceChunkDecoder(_chunks(shape_files["snappy_v1"])[0][5])


def test_boolean_rle_pages_plan_the_fused_k1(shape_files, monkeypatch):
    """A boolean RLE page with bit-packed runs is planned through the fused
    K1 (width 1); the run-table expand is the planner's decline."""
    planned = []
    real = DR._plan_hybrid_pallas

    def spy(stager, pages_info, width, total, count_pad):
        plan = real(stager, pages_info, width, total, count_pad)
        planned.append((width, plan is not None))
        return plan

    monkeypatch.setattr(DR, "_plan_hybrid_pallas", spy)
    path = shape_files["snappy_v1"]
    with open(path, "rb") as f:
        for _, col, _, _, pc, pleaf in _chunks(path):
            if col == "bool_rle":
                TD.read_chunk_device(f, pc, pleaf, device="cpu")
    assert planned and all(w == 1 for w, _ in planned)
    assert any(ok for _, ok in planned)


# ---------------------------------------------------------------------------
# the four DELTA_BINARY_PACKED shapes the batched plan declines
# ---------------------------------------------------------------------------

def _delta_file(path, monkeypatch, geometries):
    """Port writer, DELTA_BINARY_PACKED INT64 and INT32, several pages per
    chunk; page i is encoded with ``geometries[i % len]`` (block size,
    miniblocks per block)."""
    calls = [0]
    real = port_delta.encode

    def encode(values, bits=64, block_size=128, minis_per_block=4):
        bs, mb = geometries[calls[0] % len(geometries)]
        calls[0] += 1
        return real(values, bits=bits, block_size=bs, minis_per_block=mb)

    monkeypatch.setattr(port_delta, "encode", encode)
    rng = np.random.default_rng(5)
    n = 4000
    schema = build_schema([
        data_column("d64", Type.INT64, FRT.REQUIRED),
        data_column("d32", Type.INT32, FRT.OPTIONAL)])
    present = rng.random(n) >= 0.2
    vals32 = rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32)
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    page_size=4096, write_crc=True, use_dictionary=False,
                    column_encodings={c: Encoding.DELTA_BINARY_PACKED
                                      for c in ("d64", "d32")}) as w:
        w.write_columns({
            "d64": np.cumsum(rng.integers(-50, 1000, n)),
            "d32": ColumnData(values=vals32[present],
                              def_levels=present.astype(np.int32),
                              max_def=1, num_leaf_slots=n)})
    monkeypatch.setattr(port_delta, "encode", real)


def _read_both(path):
    with RefReader(path) as r:
        ref = [dict(g) for g in r.iter_row_groups()]
    with DR.DeviceFileReader(path, device="cpu") as r:
        got = [dict(g) for g in r.iter_row_groups()]
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name in rg_ref:
            _same_host(rg_ref[name].to_host(), rg_got[name].to_host(), name)
            _same_levels(rg_ref[name], rg_got[name], name)


def _count_host(monkeypatch):
    calls = []
    real = DR._ChunkAssembler._finish_host

    def spy(self, common):
        calls.append(".".join(self.leaf.path))
        return real(self, common)

    monkeypatch.setattr(DR._ChunkAssembler, "_finish_host", spy)
    return calls


@pytest.mark.parametrize("shape,geometries", [
    ("block geometry differing by page", [(128, 4), (256, 4)]),
    ("miniblock counts differing by page", [(128, 4), (256, 8)]),
])
def test_delta_geometry_by_page_takes_the_host_path(tmp_path, reference_env,
                                                    shape, geometries):
    path = str(tmp_path / "delta.parquet")
    _delta_file(path, reference_env, geometries)
    calls = _count_host(reference_env)
    _read_both(path)
    assert sorted(set(calls)) == ["d32", "d64"], shape


def test_delta_miniblock_off_a_byte_boundary_takes_the_host_path(
        tmp_path, reference_env):
    """Miniblocks are byte-aligned in every valid stream; a header walk that
    reported one off a byte boundary sends the chunk to the host path."""
    path = str(tmp_path / "delta.parquet")
    _delta_file(path, reference_env, [(128, 4)])
    real = DR.parse_delta_meta

    def shifted(buf, bits, pos=0):
        meta = real(buf, bits, pos)
        meta.mini_bit_starts = meta.mini_bit_starts + 1
        return meta

    reference_env.setattr(DR, "parse_delta_meta", shifted)
    calls = _count_host(reference_env)
    _read_both(path)
    assert sorted(set(calls)) == ["d32", "d64"]


def test_delta_staged_offsets_past_int32_take_the_host_path(tmp_path,
                                                            reference_env):
    """Block starts are staged as int32: a row group whose staged bytes
    would pass that takes the host path (the ceiling lowered to reach it)."""
    path = str(tmp_path / "delta.parquet")
    _delta_file(path, reference_env, [(128, 4)])
    reference_env.setattr(DR, "_I32_MAX", 16)
    calls = _count_host(reference_env)
    _read_both(path)
    assert sorted(set(calls)) == ["d32", "d64"]


# ---------------------------------------------------------------------------
# corruption: the same error text, decode-site suffix included
# ---------------------------------------------------------------------------

def _error_texts(path, **kw):
    texts = []
    for reader in (lambda: RefReader(path, **kw),
                   lambda: DR.DeviceFileReader(path, device="cpu", **kw)):
        with pytest.raises(Exception) as exc:
            with reader() as r:
                list(r.iter_row_groups())
        texts.append((type(exc.value).__name__, str(exc.value)))
    return texts


def _corrupt_index_page(path, row_group, column, page):
    """Overwrite a REQUIRED, uncompressed dictionary-index page's stream
    after its width byte with one RLE run of all-ones values covering the
    page: an index past the dictionary."""
    off, _ = corrupt_page(path, row_group=row_group, column=column,
                          page=page, mode="zero")
    with open(path, "r+b") as f:
        f.seek(off)
        width = f.read(1)[0]
        # run header (1 << 20) << 1: an RLE run longer than any page
        f.write(b"\x80\x80\x80\x01" + b"\xff" * ((width + 7) // 8))


def _tpq_dict_file(path, *, codec, crc=True):
    rng = np.random.default_rng(9)
    schema = build_schema([data_column("k", Type.INT64, FRT.REQUIRED),
                           data_column("v", Type.DOUBLE, FRT.OPTIONAL)])
    present = rng.random(6000) >= 0.1
    vals = rng.integers(0, 300, 6000) / 4.0
    with FileWriter(path, schema, codec=codec, write_crc=crc,
                    page_size=4096, use_dictionary=True) as w:
        for lo in (0, 3000):
            w.write_columns({
                "k": rng.integers(0, 200, 3000),
                "v": ColumnData(values=vals[lo : lo + 3000][
                    present[lo : lo + 3000]],
                    def_levels=present[lo : lo + 3000].astype(np.int32),
                    max_def=1, num_leaf_slots=3000)})
            w.flush_row_group()


@pytest.mark.parametrize("page", [0, 2, -1])
def test_page_crc_error_text_matches_reference(tmp_path, reference_env,
                                               page):
    path = str(tmp_path / "crc.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.SNAPPY)
    corrupt_page(path, row_group=1, column="v", page=page)
    (rt, rmsg), (gt, gmsg) = _error_texts(path)
    assert rt == gt == "ParquetError"
    assert gmsg == rmsg
    assert "CRC" in gmsg and f"[file={path} column=v row_group=1" in gmsg
    assert ("page=" in gmsg) == (page >= 0) and " offset=" in gmsg


def test_dictionary_index_error_text_matches_reference(tmp_path,
                                                       reference_env):
    """A dictionary-index page corrupted without page CRCs: the decode-time
    sanity checks raise, in both readers with the same text."""
    path = str(tmp_path / "idx.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.UNCOMPRESSED, crc=False)
    _corrupt_index_page(path, 0, "k", 1)
    (rt, rmsg), (gt, gmsg) = _error_texts(path)
    assert rt == gt and gmsg == rmsg
    assert "out of range" in gmsg


def test_dictionary_index_error_in_chunk_decoder_matches_reference(
        tmp_path, reference_env):
    """The page-by-page decoder stamps the page and its offset onto a
    dictionary-index error."""
    path = str(tmp_path / "idx.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.UNCOMPRESSED, crc=False)
    _corrupt_index_page(path, 0, "k", 1)
    texts = []
    with open(path, "rb") as f:
        _, _, rc, rleaf, pc, pleaf = _chunks(path)[0]
        for call in (lambda: JD.read_chunk_device(f, rc, rleaf),
                     lambda: TD.read_chunk_device(f, pc, pleaf,
                                                  device="cpu")):
            with pytest.raises(Exception) as exc:
                call()
            texts.append((type(exc.value).__name__, str(exc.value)))
    assert texts[0] == texts[1]
    assert "[column=k page=1 offset=" in texts[1][1]


def test_page_header_error_text_matches_reference(tmp_path, reference_env):
    path = str(tmp_path / "hdr.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.SNAPPY)
    with open(path, "rb") as f:
        md = read_file_metadata(f)
    chunk = md.row_groups[1].columns[0].meta_data
    start = chunk.dictionary_page_offset or chunk.data_page_offset
    with open(path, "r+b") as f:
        f.seek(start)
        f.write(b"\xff" * 12)
    (rt, rmsg), (gt, gmsg) = _error_texts(path)
    assert rt == gt == "ParquetError" and gmsg == rmsg
    assert gmsg.endswith(f"[file={path} column=k row_group=1]")


def test_error_context_names_a_memory_source(tmp_path, reference_env):
    path = str(tmp_path / "crc.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.GZIP)
    corrupt_page(path, row_group=0, column="k", page=0)
    data = open(path, "rb").read()
    msgs = []
    for reader in (RefReader(data), DR.DeviceFileReader(data, device="cpu")):
        with reader as r, pytest.raises(Exception) as exc:
            r.read_row_group(0)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] and "[file=<memory> column=k" in msgs[1]


def test_errors_are_annotated_once(tmp_path):
    from tpu_parquet_torch.errors import annotate_data_error, error_context

    with pytest.raises(ParquetError) as exc:
        with error_context(file="f", column="c"):
            with error_context(column="inner", page=3, offset=10):
                raise ParquetError("bad")
    assert str(exc.value) == "bad [file=f column=inner page=3 offset=10]"
    e = annotate_data_error(ValueError("x"), unit=1)
    assert str(e) == "x [unit=1]" and e.data_context == {"unit": 1}
    shutil.rmtree(tmp_path, ignore_errors=True)
    assert not os.path.exists(tmp_path)


# ---------------------------------------------------------------------------
# the writer's DELTA_BYTE_ARRAY encoder (vectorized) against the reference's
# ---------------------------------------------------------------------------

def _byte_strings(seed):
    rng = np.random.default_rng(seed)
    return [
        [],
        [b""],
        [b"a"],
        [b"", b"", b"x", b""],
        [b"abc", b"abd", b"ab", b"", b"abc", b"abcdef", b"abcdef"],
        sorted(bytes(rng.integers(97, 100, rng.integers(0, 12)))
               for _ in range(3000)),
        [bytes(rng.integers(0, 3, rng.integers(0, 6))) for _ in range(2000)],
    ]


@pytest.mark.parametrize("case", range(7))
def test_encode_delta_matches_reference_bytes(case):
    from tpu_parquet.column import ByteArrayData as RefBytes
    from tpu_parquet.kernels import bytearray as ref_ba
    from tpu_parquet_torch.kernels import bytearray as port_ba

    values = _byte_strings(case)[case]
    want = ref_ba.encode_delta(RefBytes.from_list(values))
    got = port_ba.encode_delta(ByteArrayData.from_list(values))
    assert got == want
    assert port_ba.decode_delta(got, len(values)).to_list() == values
    # a slice whose offsets do not start at zero encodes the same
    if len(values) > 2:
        whole = ByteArrayData.from_list(values)
        part = ByteArrayData(offsets=whole.offsets[1:], heap=whole.heap)
        assert port_ba.encode_delta(part) == ref_ba.encode_delta(
            RefBytes.from_list(values[1:]))
