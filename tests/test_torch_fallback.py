"""pyarrow's dictionary fallback in the port's reader, against the JAX
package.

pyarrow dictionary-encodes a chunk's first pages; once the dictionary
outgrows ``dictionary_pagesize_limit`` the rest of the chunk is written
PLAIN, and each dictionary page's index width is the bit width of the
dictionary size when the page was written, so widths grow page to page.
The port reads such a fixed-width chunk in ``_finish_mixed_dict_plain``
(equal-width page groups through the fused K1's planner, one gather, the
PLAIN suffix) and a string chunk on the host path; the reference in its own
``_finish_mixed_dict_plain`` and ``_finish_host``.

Files: pyarrow from seeded numpy data (``dictionary_pagesize_limit=4096``,
small pages), INT32, INT64, DOUBLE with NaN and -0.0, and strings, each
REQUIRED and OPTIONAL with nulls, under SNAPPY, GZIP and ZSTD with data
pages v1 and v2; and the file ``chip_smoke.py`` phase 8 writes in
pyarrow's layout, at a small size.  Read unforced and under each of the
seven ``TPQ_FORCE_ROUTE`` names by ``DeviceFileReader(path,
device="cpu")`` and the reference (``TPQ_PALLAS=1 TPQ_FUSE=1``), compared
exactly: values and levels bit for bit, the column's class, the route
counters and link bytes, and the ``iter_batches`` output or refusal.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import chip_smoke as CS
from tpu_parquet.device_reader import DeviceFileReader as RefReader
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.chunk_decode import walk_pages
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.device_reader import DeviceFileReader
from tpu_parquet_torch.footer import read_file_metadata
from tpu_parquet_torch.format import Encoding, PageType
from tpu_parquet_torch.ship import ROUTES
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

N = 10_000
GROUP = 5000


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


def _table(seed):
    """The dictionary grows page by page along each row group, then
    overflows the 4 KiB limit."""
    rng = np.random.default_rng(seed)

    def grow(p):
        """Dictionary ids: each row is a new value with probability ``p``,
        else an earlier one, so the dictionary grows steadily."""
        out = np.empty(N, dtype=np.int64)
        for lo in range(0, N, GROUP):
            new = rng.random(GROUP) < p
            new[0] = True
            seen = np.cumsum(new)
            old = (rng.random(GROUP) * (seen - 1)).astype(np.int64)
            out[lo : lo + GROUP] = np.where(new, seen - 1, old)
        return out

    dbl = grow(0.2) / 7.0
    dbl[rng.random(N) < 0.03] = np.nan
    dbl[rng.random(N) < 0.03] = -0.0
    mask = rng.random(N) < 0.2
    cols = {
        # each overflows the 4 KiB dictionary after a few 1,024-row pages
        "i32": pa.array(grow(0.4).astype(np.int32)),
        "i64": pa.array(grow(0.2) * 1_000_003 - (1 << 40)),
        "dbl": pa.array(dbl),
        "str": pa.array([f"s{int(x)}" for x in grow(0.16)]),
    }
    fields, arrays = [], []
    for name, arr in cols.items():
        fields.append(pa.field(name, arr.type, nullable=False))
        arrays.append(arr)
        fields.append(pa.field(name + "_opt", arr.type, nullable=True))
        py = arr.to_pylist()
        arrays.append(pa.array([None if m else v for v, m in zip(py, mask)],
                               arr.type))
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


FILES = {
    f"{codec}_v{version[0]}": dict(compression=codec,
                                   data_page_version=version)
    for codec in ("snappy", "gzip", "zstd") for version in ("1.0", "2.0")
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fallback")
    out = {}
    for i, (name, kw) in enumerate(FILES.items()):
        path = str(root / f"{name}.parquet")
        pq.write_table(_table(40 + i), path, row_group_size=GROUP,
                       dictionary_pagesize_limit=4096, data_page_size=1024,
                       write_page_checksum=True, **kw)
        out[name] = path
    return out


def _page_encodings(path, column):
    """Per row group: the data pages' encodings of ``column``, in order."""
    out = []
    with open(path, "rb") as f:
        md = read_file_metadata(f)
        for rg in md.row_groups:
            for c in rg.columns:
                m = c.meta_data
                if ".".join(m.path_in_schema) != column:
                    continue
                start = min(x for x in (m.dictionary_page_offset,
                                        m.data_page_offset) if x is not None)
                f.seek(start)
                buf = f.read(m.total_compressed_size)
                encs = []
                for ps in walk_pages(buf, m.num_values):
                    h = ps.header
                    dh = h.data_page_header or h.data_page_header_v2
                    if h.type != PageType.DICTIONARY_PAGE and dh:
                        encs.append(Encoding(dh.encoding).name)
                out.append(encs)
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


def _assert_same(path):
    ref, ref_stats = _read(RefReader(path))
    got, got_stats = _read(DeviceFileReader(path, device="cpu"))
    assert len(ref) == len(got) > 0
    for rg_ref, rg_got in zip(ref, got):
        assert set(rg_ref) == set(rg_got)
        for name, rc in rg_ref.items():
            gc = rg_got[name]
            assert type(gc).__name__ == type(rc).__name__, name
            rv, gv = rc.to_host(), gc.to_host()
            if hasattr(rv, "offsets"):
                assert isinstance(gv, ByteArrayData), name
                assert np.array_equal(gv.offsets, np.asarray(rv.offsets))
                assert np.array_equal(gv.heap, np.asarray(rv.heap)), name
            else:
                assert gv.dtype == rv.dtype and gv.shape == rv.shape, name
                assert np.array_equal(_bits(gv), _bits(rv)), name
            for r, g in zip(rc.levels_to_host(), gc.levels_to_host()):
                assert (r is None) == (g is None), name
                if r is not None:
                    assert np.array_equal(g, r), name
    assert _counters(got_stats) == _counters(ref_stats)
    return got


def _spy_mixed(monkeypatch):
    """Counts ``_finish_mixed_dict_plain`` chunks and the group plans made
    inside them: [(column, width, accepted)]."""
    calls, plans, inside = [], [], [None]
    real_mixed = DR._ChunkAssembler._finish_mixed_dict_plain
    real_plan = DR._plan_hybrid_pallas

    def mixed(self, common, stager):
        inside[0] = ".".join(self.leaf.path)
        calls.append(inside[0])
        try:
            return real_mixed(self, common, stager)
        finally:
            inside[0] = None

    def plan(stager, pages_info, width, total, count_pad):
        p = real_plan(stager, pages_info, width, total, count_pad)
        if inside[0] is not None:
            plans.append((inside[0], width, p is not None))
        return p

    monkeypatch.setattr(DR._ChunkAssembler, "_finish_mixed_dict_plain",
                        mixed)
    monkeypatch.setattr(DR, "_plan_hybrid_pallas", plan)
    return calls, plans


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", list(FILES))
def test_dictionary_fallback_matches_reference(files, reference_env, name,
                                               route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    calls, plans = _spy_mixed(reference_env)
    _assert_same(files[name])
    # every fixed-width chunk fell back in both row groups
    assert sorted(set(calls)) == ["dbl", "dbl_opt", "i32", "i32_opt", "i64",
                                  "i64_opt"]
    assert any(ok for _, _, ok in plans)


def test_fallback_widths_grow_and_group(files, reference_env):
    """The fixture is what it claims: dictionary pages then PLAIN pages in
    every chunk, index widths growing page to page; the mixed plan makes one
    group per run of equal widths."""
    path = files["snappy_v1"]
    for col, least in (("i64", 2), ("str_opt", 1)):
        for encs in _page_encodings(path, col):
            n_dict = encs.index("PLAIN")
            assert n_dict >= least and set(encs[n_dict:]) == {"PLAIN"}
            assert set(encs[:n_dict]) == {"RLE_DICTIONARY"}
    calls, plans = _spy_mixed(reference_env)
    with DeviceFileReader(path, columns=["i64"], device="cpu") as r:
        list(r.iter_row_groups())
    widths = [w for c, w, _ in plans if c == "i64"]
    half = len(widths) // 2  # the two row groups' plans
    assert half >= 3 and widths[:half] == widths[half:]
    # one plan per equal-width run: strictly growing widths
    assert all(a < b for a, b in zip(widths[:half], widths[1:half]))


@pytest.mark.parametrize("name", ["snappy_v1", "zstd_v2"])
def test_iter_batches_over_fallback_matches_reference(files, reference_env,
                                                      name):
    cols = ["i32", "i64", "dbl"]
    with RefReader(files[name], columns=cols) as r:
        want = [{k: np.asarray(v) for k, v in b.items()}
                for b in r.iter_batches(1000)]
    with DeviceFileReader(files[name], columns=cols, device="cpu") as r:
        got = [{k: v.numpy() for k, v in b.items()}
               for b in r.iter_batches(1000)]
    assert len(got) == len(want) == N // 1000
    for gb, wb in zip(got, want):
        for k in cols:
            assert np.array_equal(_bits(gb[k]), _bits(wb[k])), k
    for cols in (["i64_opt"], ["str"]):
        msgs = []
        for reader in (RefReader(files[name], columns=cols),
                       DeviceFileReader(files[name], columns=cols,
                                        device="cpu")):
            with reader as r, pytest.raises(TypeError) as exc:
                next(r.iter_batches(100))
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]


def _move_first_plain_page_forward(path, column):
    """Rewrite ``column``'s first chunk so its first PLAIN data page comes
    before its dictionary-encoded pages (each page is self-contained, so the
    chunk stays valid): dictionary pages after PLAIN pages, the shape the
    fallback never writes."""
    with open(path, "rb") as f:
        md = read_file_metadata(f)
    m = next(c.meta_data for c in md.row_groups[0].columns
             if ".".join(c.meta_data.path_in_schema) == column)
    start = min(x for x in (m.dictionary_page_offset, m.data_page_offset)
                if x is not None)
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(m.total_compressed_size)
    pages = walk_pages(buf, m.num_values)
    spans, header_start = [], 0
    for ps in pages:
        spans.append((ps, header_start, ps.payload_end))
        header_start = ps.payload_end
    dict_page = [s for s in spans if s[0].header.type
                 == PageType.DICTIONARY_PAGE]
    data = [s for s in spans if s[0].header.type != PageType.DICTIONARY_PAGE]
    encs = [Encoding((s[0].header.data_page_header
                      or s[0].header.data_page_header_v2).encoding)
            for s in data]
    k = encs.index(Encoding.PLAIN)
    order = dict_page + [data[k]] + data[:k] + data[k + 1 :]
    out = b"".join(buf[a:b] for _, a, b in order)
    assert len(out) == len(buf)
    with open(path, "r+b") as f:
        f.seek(start)
        f.write(out)


def test_dictionary_pages_after_plain_take_the_host_path(tmp_path,
                                                         reference_env):
    path = str(tmp_path / "reordered.parquet")
    pq.write_table(_table(7).select(["i64", "dbl_opt"]), path,
                   row_group_size=GROUP, dictionary_pagesize_limit=4096,
                   data_page_size=1024)
    for col in ("i64", "dbl_opt"):
        _move_first_plain_page_forward(path, col)
    host = []
    real = DR._ChunkAssembler._finish_host

    def spy(self, common):
        host.append(".".join(self.leaf.path))
        return real(self, common)

    reference_env.setattr(DR._ChunkAssembler, "_finish_host", spy)
    got = _assert_same(path)
    assert sorted(host) == ["dbl_opt", "i64"]
    want = pq.read_table(path)
    assert np.array_equal(_bits(got[0]["i64"].to_host()),
                          _bits(want["i64"].to_numpy()[:GROUP]))


def test_chip_smoke_pyarrow_layout_file(tmp_path, reference_env):
    """``chip_smoke.py`` phase 8's writer, at a small size: pyarrow reads
    the file, and pyarrow and both readers agree with the draw; the
    fixed-width fallback columns' prefixes go through the fused K1's
    planner in equal-width groups."""
    reference_env.setattr(CS, "PYARROW_DICT_LIMIT", 64 << 10)
    reference_env.setattr(CS, "PYARROW_PAGE_ROWS", 2000)
    draws = list(CS.draw_lineitem16(24_000, 12_000))
    groups = [CS.lineitem_strings(g) for g in draws]
    path = str(tmp_path / "layout.parquet")
    layouts = CS.write_pyarrow_layout(path, CS.lineitem16_schema(), groups,
                                      {"l_comment": CS.COMMENT_DICT_LIMIT})
    for c in CS.MIXED_COLUMNS:
        for layout in layouts[c]:
            assert layout[0] != "PLAIN" and "PLAIN" in layout, c
    widths = [w for w in layouts["l_orderkey"][0] if w != "PLAIN"]
    assert widths == sorted(widths) and len(set(widths)) > 1
    table = pq.read_table(path)
    for i, g in enumerate(groups):
        for c in CS.L16_COLUMNS:
            col = table[c].to_numpy(zero_copy_only=False)[
                i * 12_000 : (i + 1) * 12_000]
            want = g[c]
            if isinstance(want, ByteArrayData):
                assert [s.encode() for s in col] == want.to_list(), c
            else:
                assert np.array_equal(_bits(col), _bits(want)), c
    calls, plans = _spy_mixed(reference_env)
    got = _assert_same(path)
    assert sorted(set(calls)) == ["l_extendedprice", "l_orderkey",
                                  "l_partkey"]
    assert len(plans) == sum(CS.width_groups(l) for c in CS.MIXED_COLUMNS[:3]
                             for l in layouts[c] if "PLAIN" in l)
    assert all(ok for _, _, ok in plans)
    for rg, g in zip(got, groups):
        assert rg["l_comment"].to_host().to_list() == \
            g["l_comment"].to_list()
