"""The port's host FileReader, with row assembly, against the JAX package's.

The same files go to ``tpu_parquet_torch.reader.FileReader`` and
``tpu_parquet.reader.FileReader`` (both decode on the host into numpy):
nested files of every shape in ``test_torch_nested`` (written by the
reference's writer, dictionary on and off, v1 and v2 pages), a flat file of
every physical type with nulls, and a pyarrow file.  Compared exactly:

- ``read_row_group`` / ``read_all`` / ``iter_row_groups`` ``ColumnData``
  (values, def levels, rep levels, counts);
- ``iter_rows``, ``iter_rows_logical``, ``__iter__``, ``read_pylist`` and
  ``column_to_pylist``;
- the cursor: ``seek_to_row_group``, ``skip_row_group``, ``preload``,
  ``current_row_group`` and their ``IndexError`` texts;
- the footer accessors;
- the error texts of a bad projection, a corrupted page (CRC), a truncated
  file and a ``max_memory`` budget passed.

Then the writers: the port's ``FileWriter`` given the same logical LIST/MAP
rows as the reference's must write a file that both readers decode to the
reference writer's columns.
"""

import io
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.test_torch_nested import nested_rows, nested_schema
from tpu_parquet.column import ByteArrayData
from tpu_parquet.format import (CompressionCodec, ConvertedType,
                                FieldRepetitionType as FRT, LogicalType,
                                StringType, Type)
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet.reader import column_to_pylist as ref_column_to_pylist
from tpu_parquet.schema.core import (ColumnParameters, build_schema,
                                     data_column)
from tpu_parquet.writer import FileWriter, corrupt_page
from tpu_parquet_torch import format as PF
from tpu_parquet_torch import schema as PS
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.reader import column_to_pylist
from tpu_parquet_torch.writer import FileWriter as PortWriter
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

CODECS = {"snappy": CompressionCodec.SNAPPY, "gzip": CompressionCodec.GZIP}


def _flat_schema():
    string = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                              converted_type=ConvertedType.UTF8)
    return build_schema([
        data_column("id", Type.INT64, FRT.REQUIRED),
        data_column("x", Type.INT32, FRT.OPTIONAL),
        data_column("score", Type.DOUBLE, FRT.OPTIONAL),
        data_column("ratio", Type.FLOAT, FRT.REQUIRED),
        data_column("active", Type.BOOLEAN, FRT.OPTIONAL),
        data_column("name", Type.BYTE_ARRAY, FRT.OPTIONAL, string),
        data_column("raw", Type.BYTE_ARRAY, FRT.REQUIRED),
    ])


def _flat_rows(n=2_500, seed=9):
    rng = np.random.default_rng(seed)
    return [{
        "id": i * 3 - 1000,
        "x": None if i % 7 == 0 else int(rng.integers(-500, 500)),
        "score": None if i % 11 == 0 else float(rng.standard_normal()),
        "ratio": float(i % 13) * 0.5,
        "active": None if i % 5 == 0 else bool(i % 2),
        "name": None if i % 6 == 0 else f"name-{i % 300}",
        "raw": bytes(rng.integers(0, 256, i % 9, dtype=np.uint8)),
    } for i in range(n)]


def _write(path, schema, rows, **kw):
    kw.setdefault("row_group_size", 24 << 10)  # several row groups
    with FileWriter(path, schema, write_crc=True, page_size=2048, **kw) as w:
        w.write_rows(rows)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_host_reader")
    out = {}
    for dictionary in (True, False):
        for version in (1, 2):
            name = f"nested_dict{int(dictionary)}_v{version}"
            out[name] = str(root / f"{name}.parquet")
            _write(out[name], nested_schema(), nested_rows(),
                   use_dictionary=dictionary, data_page_version=version,
                   codec=CODECS["snappy" if version == 1 else "gzip"])
    out["flat"] = str(root / "flat.parquet")
    _write(out["flat"], _flat_schema(), _flat_rows(),
           codec=CompressionCodec.SNAPPY)
    out["pyarrow"] = str(root / "pyarrow.parquet")
    rng = np.random.default_rng(3)
    pq.write_table(pa.table({
        "n": pa.array(rng.integers(0, 1 << 40, 4_000)),
        "s": pa.array([f"v{i % 17}" if i % 4 else None
                       for i in range(4_000)]),
        "l": pa.array([[int(v) for v in rng.integers(0, 9, i % 4)]
                       for i in range(4_000)], pa.list_(pa.int32())),
    }), out["pyarrow"], row_group_size=1_500, data_page_size=4096,
        write_page_checksum=True)
    return out


NAMES = ["nested_dict1_v1", "nested_dict1_v2", "nested_dict0_v1",
         "nested_dict0_v2", "flat", "pyarrow"]


def _same_column(got, want, name):
    assert (got.max_def, got.max_rep, got.num_leaf_slots) == (
        want.max_def, want.max_rep, want.num_leaf_slots), name
    if isinstance(want.values, ByteArrayData):
        assert type(got.values).__name__ == "ByteArrayData", name
        assert np.array_equal(got.values.offsets, want.values.offsets), name
        assert np.array_equal(got.values.heap, want.values.heap), name
    else:
        gv, wv = np.asarray(got.values), np.asarray(want.values)
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, name
        assert np.array_equal(np.ascontiguousarray(gv).view(np.uint8),
                              np.ascontiguousarray(wv).view(np.uint8)), name
    for lv in ("def_levels", "rep_levels"):
        g, w = getattr(got, lv), getattr(want, lv)
        assert (g is None) == (w is None), (name, lv)
        if w is not None:
            assert g.dtype == w.dtype and np.array_equal(g, w), (name, lv)


def _same_group(got, want):
    assert list(got) == list(want)
    for name in want:
        _same_column(got[name], want[name], name)


@pytest.mark.parametrize("name", NAMES)
def test_columns_match_reference(files, name):
    with RefReader(files[name]) as ref, FileReader(files[name]) as got:
        assert got.num_row_groups == ref.num_row_groups > 1
        for i in range(ref.num_row_groups):
            _same_group(got.read_row_group(i), ref.read_row_group(i))
        for g, w in zip(got.iter_row_groups(), ref.iter_row_groups(),
                        strict=True):
            _same_group(g, w)
        _same_group(got.read_all(), ref.read_all())


@pytest.mark.parametrize("name", NAMES)
def test_rows_match_reference(files, name):
    with RefReader(files[name]) as ref, FileReader(files[name]) as got:
        rows = list(got.iter_rows())
        assert rows == list(ref.iter_rows())
        assert len(rows) == got.num_rows
        assert list(got) == rows
        logical = list(got.iter_rows_logical())
        assert logical == list(ref.iter_rows_logical())


def test_logical_rows_are_the_written_rows(files):
    """What the writer took as logical rows comes back from
    ``iter_rows_logical()``, LIST and MAP unwrapped."""
    with FileReader(files["nested_dict1_v1"]) as r:
        got = list(r.iter_rows_logical())
    want = nested_rows()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["tags"] == w["tags"]
        assert g["attrs"] == w["attrs"]
        assert g["grid"] == w["grid"]
        assert g["names"] == w["names"]
        assert g["label"] == w["label"]


def test_pylists_match_reference(files):
    path = files["flat"]
    with RefReader(path) as ref, FileReader(path) as got:
        assert got.read_pylist() == ref.read_pylist()
        want, cols = ref.read_row_group(1), got.read_row_group(1)
        for name, cd in cols.items():
            leaf = got.schema.leaf_by_path(tuple(name.split(".")))
            rleaf = ref.schema.leaf_by_path(tuple(name.split(".")))
            assert column_to_pylist(cd, leaf) == ref_column_to_pylist(
                want[name], rleaf)
            assert column_to_pylist(cd) == ref_column_to_pylist(want[name])
    with RefReader(files["nested_dict1_v1"]) as ref, \
            FileReader(files["nested_dict1_v1"]) as got:
        cd, rcd = got.read_row_group(0)["legacy"], ref.read_row_group(0)[
            "legacy"]
        with pytest.raises(Exception) as ref_err:
            ref_column_to_pylist(rcd)
        with pytest.raises(Exception) as got_err:
            column_to_pylist(cd)
        assert str(got_err.value) == str(ref_err.value)


def test_cursor_matches_reference(files):
    path = files["nested_dict0_v2"]
    with RefReader(path) as ref, FileReader(path) as got:
        n = got.num_row_groups
        for r in (ref, got):
            r.seek_to_row_group(1)
        assert got.current_row_group().num_rows == \
            ref.current_row_group().num_rows
        assert list(got.iter_rows()) == list(ref.iter_rows())
        for r in (ref, got):
            r.skip_row_group()
            pre = r.preload()
            assert r.preload() is pre
        _same_group(got.preload(), ref.preload())
        assert list(got.iter_rows()) == list(ref.iter_rows())
        for call in (lambda r: r.seek_to_row_group(n),
                     lambda r: r.read_row_group(-1)):
            with pytest.raises(IndexError) as ref_err:
                call(ref)
            with pytest.raises(IndexError) as got_err:
                call(got)
            assert str(got_err.value) == str(ref_err.value)
        for r in (ref, got):
            r.seek_to_row_group(n - 1)
            r.skip_row_group()
        for call in (lambda r: r.skip_row_group(), lambda r: r.preload(),
                     lambda r: r.current_row_group()):
            with pytest.raises(IndexError) as ref_err:
                call(ref)
            with pytest.raises(IndexError) as got_err:
                call(got)
            assert str(got_err.value) == str(ref_err.value)
        assert list(got.iter_rows()) == list(ref.iter_rows()) == []


def test_footer_accessors_match_reference(files):
    path = files["pyarrow"]
    with RefReader(path) as ref, FileReader(path) as got:
        assert got.num_rows == ref.num_rows
        assert got.created_by == ref.created_by
        assert got.key_value_metadata() == ref.key_value_metadata()
        assert [got.row_group_num_rows(i) for i in range(got.num_row_groups)
                ] == [ref.row_group_num_rows(i)
                      for i in range(ref.num_row_groups)]
        assert [l.path for l in got.columns()] == [
            l.path for l in ref.columns()]
    # an external footer (WithFileMetaData) and a projection
    with RefReader(path) as ref:
        meta = ref.metadata
    with open(path, "rb") as f:
        data = f.read()
    from tpu_parquet_torch.footer import read_file_metadata

    with open(path, "rb") as f:
        port_meta = read_file_metadata(f)
    with RefReader(data, metadata=meta, columns=["l.list.element"]) as ref, \
            FileReader(data, metadata=port_meta,
                       columns=["l.list.element"]) as got:
        assert [l.path for l in got.columns()] == [("l", "list", "element")]
        _same_group(got.read_all(), ref.read_all())
        got.set_selected_columns(None)
        ref.set_selected_columns(None)
        _same_group(got.read_row_group(0), ref.read_row_group(0))


def _error_pair(make_ref, make_got, exc=Exception):
    with pytest.raises(exc) as ref_err:
        make_ref()
    with pytest.raises(exc) as got_err:
        make_got()
    assert type(got_err.value).__name__ == type(ref_err.value).__name__
    assert str(got_err.value) == str(ref_err.value)
    return str(got_err.value)


def test_error_texts_match_reference(files, tmp_path):
    path = files["nested_dict1_v1"]

    def read_all(cls, p, **kw):
        with cls(p, **kw) as r:
            return r.read_all()

    msg = _error_pair(lambda: read_all(RefReader, path, columns=["nope"]),
                      lambda: read_all(FileReader, path, columns=["nope"]))
    assert "match no schema columns" in msg
    bad = str(tmp_path / "crc.parquet")
    shutil.copy(path, bad)
    corrupt_page(bad, row_group=1, column="grid.list.element.list.element",
                 page=0)
    msg = _error_pair(lambda: read_all(RefReader, bad),
                      lambda: read_all(FileReader, bad))
    assert "CRC mismatch" in msg and "row_group=1" in msg
    # the footer of the whole file over truncated data bytes
    with RefReader(path) as r:
        meta = r.metadata
        last = r.metadata.row_groups[-1].columns[-1].meta_data
    from tpu_parquet_torch.footer import read_file_metadata

    with open(path, "rb") as f:
        port_meta = read_file_metadata(f)
        data = f.seek(0) or f.read()
    cut = data[: last.data_page_offset + 8]
    msg = _error_pair(lambda: read_all(RefReader, cut, metadata=meta),
                      lambda: read_all(FileReader, cut, metadata=port_meta))
    assert "truncated file reading column" in msg
    msg = _error_pair(lambda: read_all(RefReader, path, max_memory=4096),
                      lambda: read_all(FileReader, path, max_memory=4096),
                      MemoryError)
    assert "memory budget exceeded" in msg
    # a budget the file fits: every row group reads, the peak below it
    with FileReader(path, max_memory=1 << 20) as r:
        _same_group(r.read_all(), read_all(RefReader, path))
        assert 0 < r.alloc.peak <= 1 << 20


def _port_schema():
    S = PS.core
    string = S.ColumnParameters(
        logical_type=PF.LogicalType(STRING=PF.StringType()),
        converted_type=PF.ConvertedType.UTF8)

    def s(name, rep=PF.FieldRepetitionType.REQUIRED):
        return S.data_column(name, PF.Type.BYTE_ARRAY, rep, string)

    FR, T = PF.FieldRepetitionType, PF.Type
    return S.build_schema([
        S.list_column("tags", S.data_column("element", T.INT64,
                                            FR.OPTIONAL)),
        S.list_column("names", s("element")),
        S.list_column("grid", S.list_column(
            "element", S.data_column("element", T.INT32, FR.OPTIONAL))),
        S.map_column("attrs", s("key"),
                     S.data_column("value", T.INT64, FR.OPTIONAL)),
        S.list_column("points", S.group_column("element", [
            S.data_column("a", T.INT32, FR.REQUIRED),
            S.data_column("b", T.DOUBLE, FR.OPTIONAL)], FR.REQUIRED)),
        S.data_column("legacy", T.INT32, FR.REPEATED),
        S.group_column("info", [S.group_column("vals", [
            S.data_column("x", T.INT64, FR.REQUIRED)], FR.REPEATED)],
            FR.OPTIONAL),
        S.list_column("deltas", S.data_column("element", T.INT64,
                                              FR.REQUIRED)),
        s("label", FR.OPTIONAL),
    ])


@pytest.mark.parametrize("version", [1, 2])
def test_port_writer_logical_rows_match_reference_writer(version):
    rows = nested_rows(600, seed=8)
    ref_buf, got_buf = io.BytesIO(), io.BytesIO()
    with FileWriter(ref_buf, nested_schema(), data_page_version=version,
                    page_size=1024) as w:
        w.write_rows(rows)
    with PortWriter(got_buf, _port_schema(), data_page_version=version,
                    page_size=1024) as w:
        w.write_rows(rows)
    with RefReader(ref_buf.getvalue()) as r:
        want = r.read_all()
        want_rows = list(r.iter_rows_logical())
    for reader in (RefReader, FileReader):
        with reader(got_buf.getvalue()) as r:
            _same_group(r.read_all(), want)
            assert list(r.iter_rows_logical()) == want_rows
