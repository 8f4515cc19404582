"""The port's BYTE_ARRAY columns against the JAX package, file by file.

Each file is written once (the JAX package's writer, or pyarrow) and the same
path goes to both readers: ``tpu_parquet_torch.device_reader.
DeviceFileReader(path, device="cpu")`` and ``tpu_parquet.device_reader.
DeviceFileReader(path)``, the reference with ``TPQ_PALLAS=1 TPQ_FUSE=1`` (its
kernels in Pallas interpret mode).  They must agree exactly on
``to_host()`` (offsets and heap), ``levels_to_host()``, ``ship_routes``,
``link_bytes_*`` and ``pages_device_expanded``, unforced and under
``TPQ_FORCE_ROUTE`` for ``plain``, ``device_snappy`` and ``recompress``.

PLAIN files: a REQUIRED and an OPTIONAL (about 20% nulls) string column of
word-pool text with empty strings and one value of 70,000 bytes, small pages,
two row groups, on data pages v1 and v2 under SNAPPY, GZIP and UNCOMPRESSED.
Dictionary files: a pyarrow file whose string cardinality rises along the
file over small pages (the index width grows page to page: the per-run-width
expand), and dictionaries whose heap is large enough for the planner to
recompress it.  The native length walk's absence (``_finish_plain_bytes_host``)
is forced by patching both packages' ``native.bytearray_lengths``.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import tpu_parquet.native as ref_native
import tpu_parquet_torch.native as port_native
from tpu_parquet.column import ByteArrayData, ColumnData
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet.format import (CompressionCodec, FieldRepetitionType as FRT,
                                Type)
from tpu_parquet.schema.core import build_schema, data_column
from tpu_parquet.writer import FileWriter
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.device_reader import DeviceDictColumn, DeviceFileReader

ROWS = 5_000
GROUP = 2_500
BIG = 70_000  # one value of at least 64 KiB
WORDS = [f"w{i:03d}".encode() for i in range(300)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _strings(rng, n, pool=WORDS, big_at=None):
    """``n`` strings of 0..8 words (about a tenth empty); the value at
    ``big_at`` is ``BIG`` bytes long."""
    k = rng.integers(0, 9, n)
    k[rng.random(n) < 0.1] = 0
    out = [b" ".join(pool[j] for j in rng.integers(0, len(pool), kk))
           for kk in k]
    if big_at is not None:
        out[big_at] = bytes(rng.integers(97, 100, BIG).astype(np.uint8))
    return out


def _column(items, rng, optional):
    if not optional:
        return ColumnData(values=ByteArrayData.from_list(items)), items
    present = rng.random(len(items)) >= 0.2
    kept = [v for v, p in zip(items, present) if p]
    return ColumnData(values=ByteArrayData.from_list(kept),
                      def_levels=present.astype(np.int32), max_def=1,
                      num_leaf_slots=len(items)), kept


def _plain_file(path, codec, version):
    """Columns ``r`` (REQUIRED) and ``o`` (OPTIONAL); returns the expected
    defined values per row group."""
    rng = np.random.default_rng(31 + version)
    schema = build_schema([data_column("r", Type.BYTE_ARRAY, FRT.REQUIRED),
                           data_column("o", Type.BYTE_ARRAY, FRT.OPTIONAL)])
    want = []
    with FileWriter(path, schema, codec=codec, data_page_version=version,
                    write_crc=True, page_size=8 << 10,
                    use_dictionary=False) as w:
        for g in range(ROWS // GROUP):
            r = _strings(rng, GROUP, big_at=17 if g == 0 else None)
            o_col, o_kept = _column(_strings(rng, GROUP), rng, True)
            w.write_columns({"r": _column(r, rng, False)[0], "o": o_col})
            w.flush_row_group()
            want.append({"r": r, "o": o_kept})
    return want


def _growth_file(path):
    """pyarrow: string dictionaries whose index width grows page to page,
    with nulls, SNAPPY, page CRCs."""
    rng = np.random.default_rng(37)
    ramp = np.arange(ROWS) * 3000 // ROWS + 1
    grow = (rng.random(ROWS) * ramp).astype(np.int64)
    table = pa.table({
        "gs": pa.array([f"name-{v}" for v in grow],
                       mask=rng.random(ROWS) < 0.1),
        "gr": pa.array([f"{v:06d}" for v in grow[::-1]]),
    })
    pq.write_table(table, path, row_group_size=GROUP, data_page_size=1024,
                   compression="snappy", write_page_checksum=True,
                   use_dictionary=True)


def _big_dict_file(path, codec, version=1):
    """Dictionaries of about 2,000 distinct strings of 6..12 words per
    chunk: heaps of about 90 KB (over ``ship.MIN_COMPRESS_BYTES``) that
    compress well, so the planner recompresses them; one column
    OPTIONAL."""
    rng = np.random.default_rng(41)
    pool = [b" ".join(WORDS[j] for j in rng.integers(0, 40, k))
            + b"." + str(i).encode()
            for i, k in enumerate(rng.integers(6, 13, 6_000))]
    schema = build_schema([data_column("d", Type.BYTE_ARRAY, FRT.REQUIRED),
                           data_column("do", Type.BYTE_ARRAY, FRT.OPTIONAL)])
    with FileWriter(path, schema, codec=codec, data_page_version=version,
                    write_crc=True, page_size=8 << 10,
                    use_dictionary=True) as w:
        for _ in range(ROWS // GROUP):
            d = [pool[i] for i in rng.integers(0, len(pool), GROUP)]
            do = [pool[i] for i in rng.integers(0, len(pool), GROUP)]
            w.write_columns({"d": _column(d, rng, False)[0],
                             "do": _column(do, rng, True)[0]})
            w.flush_row_group()


S, G, U = (CompressionCodec.SNAPPY, CompressionCodec.GZIP,
           CompressionCodec.UNCOMPRESSED)
PLAIN = {f"plain_{c.name.lower()}_v{v}": (c, v)
         for c in (S, G, U) for v in (1, 2)}
DICT = {
    "dict_growth_snappy": _growth_file,
    "dict_big_gzip": lambda p: _big_dict_file(p, G),
    "dict_big_snappy_v2": lambda p: _big_dict_file(p, S, 2),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_bytes")
    out, want = {}, {}
    for name, (codec, version) in PLAIN.items():
        out[name] = str(root / f"{name}.parquet")
        want[name] = _plain_file(out[name], codec, version)
    for name, make in DICT.items():
        out[name] = str(root / f"{name}.parquet")
        make(out[name])
    return out, want


@pytest.fixture
def reference_env(monkeypatch):
    """The reference's kernels in Pallas interpret mode, unforced."""
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
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in stats["ship_routes"].items()}
    return routes, {k: stats[k] for k in (
        "link_bytes_logical", "link_bytes_shipped", "fused_fallbacks",
        "pages_device_expanded", "row_groups", "chunks", "pages", "rows",
        "compressed_bytes")}


def _assert_same(path):
    """Both readers over ``path``: equal host output and counters.  Returns
    the port's per-row-group columns and stats."""
    ref, ref_stats = _read(RefReader(path))
    got, got_stats = _read(DeviceFileReader(path, device="cpu"))
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name in rg_ref:
            (rcol, rv, (rd, rr)), (gcol, gv, (gd, gr)) = (rg_ref[name],
                                                         rg_got[name])
            assert type(gcol).__name__ == type(rcol).__name__, name
            assert type(gv).__name__ == type(rv).__name__, name
            if isinstance(rv, ByteArrayData):
                assert gv.offsets.dtype == rv.offsets.dtype == np.int64
                assert np.array_equal(gv.offsets, rv.offsets), name
                assert gv.heap.dtype == rv.heap.dtype == np.uint8
                assert np.array_equal(gv.heap, rv.heap), name
            else:
                assert gv.dtype == rv.dtype and np.array_equal(gv, rv), name
            assert (gd is None) == (rd is None), name
            if rd is not None:
                assert gd.dtype == rd.dtype and np.array_equal(gd, rd), name
            assert gr is None and rr is None
    assert _counters(got_stats) == _counters(ref_stats)
    return got, got_stats


BYTE_ROUTES = ["unforced", "plain", "device_snappy", "recompress"]


@pytest.mark.parametrize("route", BYTE_ROUTES)
@pytest.mark.parametrize("name", list(PLAIN))
def test_plain_bytes_match_reference(files, reference_env, name, route):
    paths, want = files
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    CK.reset_launches()
    got, stats = _assert_same(paths[name])
    assert set(CK.launches.values()) == {0}  # CPU tensors launch nothing
    for rg, exp in zip(got, want[name]):
        for col in ("r", "o"):
            assert rg[col][1].to_list() == exp[col]
    assert max(len(v) for v in got[0]["r"][1].to_list()) == BIG
    ran = set(stats["ship_routes"])
    codec = PLAIN[name][0]
    if route == "plain":
        assert ran == {"plain"}
    elif route == "device_snappy" and codec == S:
        # v1 pages of the OPTIONAL column hold their levels inside the
        # compressed region, so only v2 keeps every page compressed
        assert "device_snappy" in ran
        if PLAIN[name][1] == 2:
            assert stats["pages_device_expanded"] == stats["pages"]
    elif route == "recompress" and codec != S:
        assert ran == {"recompress"}


def test_unforced_routes_follow_the_codec(files, reference_env):
    """Unforced, the SNAPPY files keep their pages compressed; under the
    other codecs the one chunk over ``ship.MIN_COMPRESS_BYTES`` (the one
    with the 70,000-byte value) recompresses and the rest ship plain, as
    the reference ranks them."""
    paths, _ = files
    for name, (codec, version) in PLAIN.items():
        _, stats = _assert_same(paths[name])
        routes = stats["ship_routes"]
        if codec == S:
            # the OPTIONAL column's v1 pages are decompressed on the host
            assert set(routes) == ({"device_snappy"} if version == 2
                                   else {"device_snappy", "plain"}), name
        else:
            assert routes["recompress"]["streams"] == 1, name
            assert routes["plain"]["streams"] == 3, name


@pytest.mark.parametrize("route", BYTE_ROUTES)
@pytest.mark.parametrize("name", list(DICT))
def test_string_dictionaries_match_reference(files, reference_env, name,
                                             route):
    paths, _ = files
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    got, stats = _assert_same(paths[name])
    for rg in got:
        for col, values, _ in rg.values():
            assert isinstance(col, DeviceDictColumn)
            assert col.indices.dtype == torch.int32
            assert int(col.validity().sum()) == len(values)
    if name.startswith("dict_big") and route in ("unforced", "recompress"):
        # the heap of every dictionary shipped recompressed
        assert stats["ship_routes"]["recompress"]["streams"] == 4
        assert (stats["ship_routes"]["recompress"]["shipped"]
                < stats["ship_routes"]["recompress"]["logical"])


def test_growing_index_width_takes_the_per_run_width_expand(files,
                                                            reference_env):
    """The pyarrow file's index width grows page to page: each index stream
    takes the per-run-width expand (not the fused K1), and the strings are
    pyarrow's."""
    paths, _ = files
    calls = []
    real = DR._hybrid_vw

    def spy(*args, **kw):
        calls.append(kw["max_width"])
        return real(*args, **kw)

    reference_env.setattr(DR, "_hybrid_vw", spy)
    got, _ = _assert_same(paths["dict_growth_snappy"])
    assert calls  # index streams whose width changed between pages
    table = pq.read_table(paths["dict_growth_snappy"])
    for col in ("gs", "gr"):
        want = [v.encode() for v in table[col].to_pylist() if v is not None]
        assert sum((rg[col][1].to_list() for rg in got), []) == want


@pytest.mark.parametrize("name", ["plain_gzip_v1", "plain_uncompressed_v2",
                                  "dict_big_gzip"])
def test_without_the_native_length_walk(files, reference_env, name):
    """No native length walk in either package: PLAIN chunks take the host
    decode (``_finish_plain_bytes_host``) and still agree exactly."""
    paths, want = files
    reference_env.setattr(ref_native, "bytearray_lengths", lambda *a, **k: None)
    reference_env.setattr(port_native, "bytearray_lengths",
                          lambda *a, **k: None)
    got, stats = _assert_same(paths[name])
    if name in want:
        assert stats["ship_routes"] == {}
        for rg, exp in zip(got, want[name]):
            assert rg["r"][1].to_list() == exp["r"]
            assert rg["o"][1].to_list() == exp["o"]


def test_host_length_walk_reads_lazy_snappy_pages(files, monkeypatch):
    """Without the native length walk, a SNAPPY chunk's pages that preship
    left compressed are decompressed for the host decode."""
    paths, want = files
    monkeypatch.setattr(port_native, "bytearray_lengths",
                        lambda *a, **k: None)
    with DeviceFileReader(paths["plain_snappy_v1"], device="cpu") as r:
        got = [g["r"].to_host().to_list() for g in r.iter_row_groups()]
        assert r.stats().pages > 4
    assert got == [g["r"] for g in want["plain_snappy_v1"]]


def test_iter_batches_refuses_ragged_columns_as_the_reference(
        files, reference_env):
    paths, _ = files
    for name in ("plain_gzip_v1", "dict_big_gzip"):
        msgs = []
        for reader in (RefReader(paths[name]),
                       DeviceFileReader(paths[name], device="cpu")):
            with reader as r, pytest.raises(TypeError) as exc:
                next(r.iter_batches(100))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1] and "ragged" in msgs[1], msgs


def test_iter_batches_materializes_string_dictionaries_first(
        files, monkeypatch):
    paths, _ = files
    seen = []
    real = DeviceDictColumn.materialize

    def spy(self):
        col = real(self)
        seen.append(col)
        return col

    monkeypatch.setattr(DeviceDictColumn, "materialize", spy)
    with DeviceFileReader(paths["dict_big_gzip"], device="cpu") as r:
        with pytest.raises(TypeError, match="ragged"):
            next(r.iter_batches(100))
    # the materialized column is the gathered strings, in place of the
    # dictionary form
    assert seen and not isinstance(seen[0], DeviceDictColumn)
    assert seen[0].offsets is not None and seen[0].values is None
    with DeviceFileReader(paths["dict_big_gzip"], device="cpu") as r:
        col = r.read_row_group(0)["d"]
    assert seen[0].to_host() == col.to_host()


def test_slice_names_byte_arrays():
    from tpu_parquet_torch.format import (FieldRepetitionType as PFRT,
                                          Type as PType)
    from tpu_parquet_torch.schema.core import (build_schema as p_build,
                                               data_column as p_column)

    assert "BYTE_ARRAY" in DR.SLICE and "DELTA_BINARY_PACKED" in DR.SLICE
    assert "BYTE_ARRAY" in DR.__doc__ and "DeviceDictColumn" in DR.__doc__
    from tpu_parquet_torch.schema.core import list_column

    schema = p_build([p_column("s", PType.BYTE_ARRAY, PFRT.OPTIONAL),
                      p_column("b", PType.BOOLEAN, PFRT.REQUIRED),
                      list_column("r", p_column("element", PType.BYTE_ARRAY,
                                                PFRT.REQUIRED))])
    strings, flags, repeated = schema.leaves
    DR._check_leaf(strings)  # in the slice
    DR._check_leaf(flags)  # every flat leaf is, BOOLEAN included
    with pytest.raises(NotImplementedError, match="BYTE_ARRAY"):
        DR._check_leaf(repeated)  # the refusal names the slice's types
