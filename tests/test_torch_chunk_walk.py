"""The chunk walk (``tpu_parquet_torch.chunk_walk``: a column chunk's page
headers, CRCs, decompression and dictionary-index run walks in a few native
calls) against the page loop it replaces (``device_reader._collect_pages``:
``walk_pages`` and ``parse_data_page`` page by page), both called directly.

On every chunk shape of the files here — pyarrow files of every value shape
in SNAPPY, UNCOMPRESSED and GZIP, v1 and v2 pages, REQUIRED and OPTIONAL, the
dictionary fallback in fixed and string columns, DELTA, lazy PLAIN pages,
pruned pages, a dictionary-cache hit, and both benchmark layouts at a reduced
row count — the two give the same page tables, decompressed bytes, lazy
payloads, dictionaries, run tables and range maxima, the same staged bytes
and device plan, and the same decoded column.  On corrupt chunks they raise
the same exception type and message with the same page ordinal and offset.
Beside them: the native CRC-32 against zlib's, and the host phase's
engagement counters.
"""

import json
import os
import sys
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from tpu_parquet_torch import chunk_walk, native, obs
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.alloc import AllocTracker, MemoryBudgetExceeded
from tpu_parquet_torch.errors import ParquetError
from tpu_parquet_torch.format import (CompressionCodec, DataPageHeader,
                                      DictionaryPageHeader,
                                      FieldRepetitionType as FRT, PageHeader,
                                      Type)
from tpu_parquet_torch.kernels import rle
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.scanplan import row_group_chunks
from tpu_parquet_torch.serve.result_cache import DEVICE_TENSOR_ATTRS
from tpu_parquet_torch.ship import default_planner
from tpu_parquet_torch.thrift import write_struct

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, GROUP = 6_000, 3_000
CPU = torch.device("cpu")

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="the chunk walk is native code")


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

def _table(rows: int, seed: int, nullable: bool = False) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array([f"w{i:03d} pack{i % 7}" for i in range(40)])
    cols = {
        "i64_dict": rng.integers(0, 50, rows).astype(np.int64),
        "i32_dict": rng.integers(-9, 9, rows).astype(np.int32),
        "f64_dict": rng.integers(0, 30, rows) / 4.0,
        "i64_plain": rng.integers(-(1 << 40), 1 << 40, rows),
        "i64_fallback": rng.integers(0, 2_000, rows).astype(np.int64),
        "f32": rng.random(rows).astype(np.float32),
        "str_dict": words[rng.integers(0, 40, rows)],
        "str_fallback": np.array([f"s{v}" for v in
                                  rng.integers(0, 3_000, rows)]),
        "flag": rng.random(rows) < 0.3,
        "i64_delta": np.cumsum(rng.integers(0, 9, rows)).astype(np.int64),
        "dec": pa.array([int(v) for v in rng.integers(0, 10**6, rows)],
                        pa.decimal128(9, 2)),
    }
    arrays = {k: v if isinstance(v, pa.Array) else pa.array(v)
              for k, v in cols.items()}
    if nullable:
        mask = rng.random(rows) < 0.1
        arrays = {k: pa.array(a.to_pylist(), a.type,
                              mask=mask if k != "flag" else None)
                  for k, a in arrays.items()}
    return pa.Table.from_arrays(
        list(arrays.values()),
        schema=pa.schema([pa.field(k, a.type, nullable=nullable)
                          for k, a in arrays.items()]))


_COMMON = dict(row_group_size=GROUP, data_page_size=2048,
               dictionary_pagesize_limit=2048, write_page_checksum=True,
               column_encoding=None, use_dictionary=[
                   "i64_dict", "i32_dict", "f64_dict", "i64_fallback",
                   "str_dict", "str_fallback", "dec"])
FILES = {
    "snappy_v1": dict(compression="snappy"),
    "none_v1": dict(compression="none"),
    "gzip_v1": dict(compression="gzip"),
    "snappy_v2": dict(compression="snappy", data_page_version="2.0"),
    "snappy_optional": dict(compression="snappy", nullable=True),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunk_walk")
    out = {}
    for i, (name, kw) in enumerate(FILES.items()):
        kw = dict(kw)
        nullable = kw.pop("nullable", False)
        opts = dict(_COMMON, **kw)
        opts["use_dictionary"] = list(opts["use_dictionary"])
        opts.pop("column_encoding")
        path = str(root / f"{name}.parquet")
        table = _table(ROWS, 30 + i, nullable)
        pq.write_table(table.drop(["i64_delta"]), path, **opts)
        out[name] = path
        # DELTA needs the dictionary off for its column
        dpath = str(root / f"{name}_delta.parquet")
        pq.write_table(table.select(["i64_delta", "i64_plain"]), dpath,
                       row_group_size=GROUP, data_page_size=2048,
                       write_page_checksum=True, use_dictionary=False,
                       column_encoding={"i64_delta": "DELTA_BINARY_PACKED",
                                        "i64_plain": "PLAIN"},
                       **kw)
        out[f"{name}_delta"] = dpath
    return out


@pytest.fixture(scope="module")
def bench_files(tmp_path_factory):
    """Both benchmark layouts (``pqbench/``) at a reduced row count: the
    port writer's (dictionary, DELTA, PLAIN keys) and pyarrow's
    (dictionary-then-PLAIN fixed-width and string chunks, 20,000-row
    pages)."""
    sys.path.insert(0, ROOT)
    from pqbench import lineitem, write

    root = tmp_path_factory.mktemp("chunk_walk_bench")
    out = {}
    for name in ("tpch_lineitem_sf1", "tpch_lineitem_sf1_pyarrow"):
        with open(os.path.join(ROOT, "pqbench", "configs",
                               f"{name}.json")) as f:
            cfg = json.load(f)
        groups = lineitem.draw(2_147_485_901, 90_000, 45_000)
        path = str(root / f"{name}.parquet")
        write.write_file(cfg, groups, path)
        out[name] = path
    return out


def _chunks(path):
    """Every column chunk of ``path``: (name, buf, md, leaf, context)."""
    r = FileReader(path)
    try:
        leaves = {l.path: l for l in r.schema.selected_leaves()}
        with open(path, "rb") as f:
            for g, rg in enumerate(r.metadata.row_groups):
                for p, leaf, _c, md, offset in row_group_chunks(rg, leaves):
                    f.seek(offset)
                    buf = f.read(md.total_compressed_size)
                    ctx = {"file": path, "row_group": g,
                           "column": ".".join(p), "chunk_offset": offset}
                    yield f"{g}:{'.'.join(p)}", buf, md, leaf, ctx
    finally:
        r.close()


# ---------------------------------------------------------------------------
# the two collections, compared
# ---------------------------------------------------------------------------

def _collect(walk, buf, codec, total, leaf, **kw):
    kw.setdefault("validate_crc", True)
    return DR._collect_chunk_as(walk, buf, codec, total, leaf, [],
                                device=CPU, **kw)


def _outcome(fn):
    """The assembler, or the raised error as (type, message, context)."""
    try:
        return fn()
    except (ParquetError, MemoryBudgetExceeded) as e:
        return (type(e), str(e), getattr(e, "data_context", None))


def _b(x):
    return None if x is None else bytes(np.frombuffer(x, np.uint8))


def _n(x):
    """Arrays and buffers as bytes, the rest as it is, for ``==``."""
    if isinstance(x, tuple):
        return tuple(_n(v) for v in x)
    if isinstance(x, np.ndarray):
        # a byte buffer is bytes whichever type holds it
        return x.tobytes() if x.dtype == np.uint8 else (x.dtype.str,
                                                          x.tobytes())
    if isinstance(x, (bytes, bytearray, memoryview)):
        return bytes(x)
    return x


def _pages(asm):
    return [_n((p.num_values, p.defined, p.encoding, p.value_pos, _b(p.raw),
                p.comp, p.def_levels, p.rep_levels, p.def_stream,
                p.rep_stream))
            for p in asm.pages]


def _state(asm):
    rag = asm.dict_ragged
    return (_pages(asm), asm.pages_pruned, _b(asm.dict_u8), asm.dict_dtype,
            asm.dict_len,
            None if rag is None else (_b(rag.offsets), _b(rag.heap)),
            None if asm.dict_comp is None else (_b(asm.dict_comp[0]),
                                                asm.dict_comp[1]),
            asm.stats_span)


def _host(col):
    return {a: getattr(col, a).cpu().numpy().tobytes()
            for a in DEVICE_TENSOR_ATTRS
            if isinstance(getattr(col, a, None), torch.Tensor)}


def _plain(x):
    """A plan's arguments as plain values."""
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, (int, np.integer)):
        return int(x)
    return repr(x)


def _finish(asm):
    """Preship and finish on a stager of its own, then run the plan: the
    staged bytes, the plan's arguments, the ship records and the decoded
    column; or the error finish raised."""
    if not asm.pages:
        return None

    def run():
        asm.preship(default_planner())
        stager = DR._RowGroupStager()
        plan = asm.finish(stager)
        buf = np.zeros(stager.size(), np.uint8)
        stager.fill(buf)
        col = DR._run_plans([("c", plan)], torch.from_numpy(buf.copy()))["c"]
        return (buf.tobytes(), _plain(plan.dyn),
                asm.ship_records, asm.fused_fallbacks,
                asm.pages_kept_compressed, _host(col), list(asm._deferred))

    return _outcome(run)


def _same(buf, md, leaf, ctx, **kw):
    """Both collections of one chunk, compared (the assemblers, then their
    finished plans); returns the walked one's outcome, an assembler marked
    ``walked`` when its pages came through the chunk walk."""
    kw.setdefault("context", ctx)
    want = _outcome(lambda: _collect(False, buf, md.codec, md.num_values,
                                     leaf, **kw))
    got = _outcome(lambda: _collect(True, buf, md.codec, md.num_values,
                                    leaf, **kw))
    if isinstance(want, tuple):
        assert got == want
        return got
    assert isinstance(got, DR._ChunkAssembler), got
    assert _state(got) == _state(want)
    got.walked = _walked(got)
    got.n_pages = len(got.pages)
    assert _finish(got) == _finish(want)
    return got


def _walked(asm) -> bool:
    if hasattr(asm, "walked"):
        return asm.walked
    return bool(asm.pages) and isinstance(asm.pages[0],
                                          chunk_walk.WalkedPage)


@pytest.mark.parametrize("name", [*FILES, *(f"{n}_delta" for n in FILES)])
def test_every_chunk_shape_matches_the_page_loop(files, name):
    walked = 0
    for label, buf, md, leaf, ctx in _chunks(files[name]):
        asm = _same(buf, md, leaf, ctx)
        walked += _walked(asm)
        engages = (chunk_walk.declines(md.codec, leaf) is None
                   and "v2" not in name)
        assert _walked(asm) == (engages and asm.n_pages > 0), label
    assert (walked > 0) == (name.startswith(("snappy_v1", "none_v1"))
                            and "optional" not in name)


@pytest.mark.parametrize("name", ["tpch_lineitem_sf1",
                                  "tpch_lineitem_sf1_pyarrow"])
def test_the_benchmark_layouts_match_the_page_loop(bench_files, name):
    walked = 0
    for _label, buf, md, leaf, ctx in _chunks(bench_files[name]):
        walked += _walked(_same(buf, md, leaf, ctx))
    assert walked == 2 * 16  # two row groups of sixteen flat columns


def test_the_run_tables_are_the_per_page_walks(bench_files):
    """The concatenated run tables, the per-page widths, the folded range
    maximum and the packed bit-packed payloads equal what
    ``_parse_dict_index_page`` gives page by page."""
    seen = 0
    for _label, buf, md, leaf, ctx in _chunks(
            bench_files["tpch_lineitem_sf1_pyarrow"]):
        asm = _collect(True, buf, md.codec, md.num_values, leaf, context=ctx)
        idx = [p for p in asm.pages if p.encoding in (2, 8)]
        if not idx or not asm.dict_len:
            continue
        runs, host_max = asm._walked_index_runs(idx)
        ref_max, r = 0, 0
        packed = bytearray()
        for j, p in enumerate(idx):
            meta, width, stream, ref_max = asm._parse_dict_index_page(
                p, ref_max)
            n = meta.n_runs
            assert runs.ks[j] == n and runs.widths[j] == width
            assert runs.counts[j] == p.defined
            for mine, ref in ((runs.ends, meta.run_ends),
                              (runs.kinds, meta.run_is_rle),
                              (runs.vals, meta.run_values),
                              (runs.starts, meta.run_bit_starts)):
                np.testing.assert_array_equal(mine[r:r + n], ref[:n])
            pad = runs.meta(j)
            for a in ("run_ends", "run_is_rle", "run_values",
                      "run_bit_starts", "count", "n_runs"):
                np.testing.assert_array_equal(getattr(pad, a),
                                              getattr(meta, a))
            prev = 0
            for q in range(n):
                end = int(meta.run_ends[q])
                if not meta.run_is_rle[q]:
                    at = (int(meta.run_bit_starts[q]) + prev * width) >> 3
                    packed += bytes(stream[at:at + -(-(end - prev) // 8)
                                           * width])
                prev = end
            r += n
        assert host_max == ref_max
        assert runs.packed_bytes().tobytes() == bytes(packed)
        seen += 1
    assert seen >= 20


def test_pruned_pages_match(bench_files):
    for label, buf, md, leaf, ctx in _chunks(
            bench_files["tpch_lineitem_sf1_pyarrow"]):
        asm = _same(buf, md, leaf, ctx, skip_pages={0, 2})
        assert asm.pages_pruned == 2, label


class _DictCache:
    """A ``serve.BoundDictCache`` stand-in: get / put by key."""

    def __init__(self):
        self.d, self.gets, self.puts = {}, 0, 0

    def get(self, *k):
        self.gets += 1
        return self.d.get(k)

    def put(self, *k):
        self.puts += 1
        self.d[k[:3]] = k[3]


def test_a_dictionary_cache_hit_matches(files):
    path = files["snappy_v1"]
    for label, buf, md, leaf, ctx in _chunks(path):
        caches = []
        for walk in (False, True):
            cache = _DictCache()
            first = _collect(walk, buf, md.codec, md.num_values, leaf,
                             context=ctx, dict_cache=cache)
            hit = _collect(walk, buf, md.codec, md.num_values, leaf,
                           context=ctx, dict_cache=cache)
            assert _state(hit)[1:] == _state(first)[1:]
            caches.append((cache.gets, cache.puts, _state(hit)))
        assert caches[0] == caches[1], label


# ---------------------------------------------------------------------------
# corrupt chunks: the same exception, message, page ordinal and offset
# ---------------------------------------------------------------------------

LEAF = build_schema([data_column("k", Type.INT64, FRT.REQUIRED)]).leaves[0]
STR_LEAF = build_schema([data_column("s", Type.BYTE_ARRAY,
                                     FRT.REQUIRED)]).leaves[0]
SNAPPY, NONE = int(CompressionCodec.SNAPPY), int(CompressionCodec.UNCOMPRESSED)


def _crc(b: bytes) -> int:
    c = zlib.crc32(b)
    return c - (1 << 32) if c >= 1 << 31 else c


def _page(raw: bytes, codec: int, *, dict_page=False, n=0, enc=8,
          header=None, payload=None, bad_crc=False):
    """One page: header and body (``raw`` compressed by ``codec``, or
    ``payload``); ``header`` rewrites header fields."""
    body = bytes(native.snappy_compress(raw)) if codec == SNAPPY else raw
    if payload is not None:
        body = payload
    h = dict(type=2 if dict_page else 0, uncompressed_page_size=len(raw),
             compressed_page_size=len(body), crc=_crc(body) ^ bad_crc)
    if dict_page:
        h["dictionary_page_header"] = DictionaryPageHeader(
            num_values=n, encoding=0)
    else:
        h["data_page_header"] = DataPageHeader(
            num_values=n, encoding=enc, definition_level_encoding=3,
            repetition_level_encoding=3)
    h.update(header or {})
    return bytes(write_struct(PageHeader(**h))) + body


def _chunk(codec, plain=False, pages=3, at=-1, index=None, extra=b"",
           **fault):
    """A dictionary page of 20 INT64 values and ``pages`` index pages of
    200 values at width 5 (``plain``: no dictionary, PLAIN pages of 100
    INT64 values); page ``at`` takes ``fault`` (``_page``'s keywords),
    ``index`` replaces its raw index stream, ``extra`` follows the pages.
    Returns (chunk, total values)."""
    rng = np.random.default_rng(5)
    n = 100 if plain else 200
    out = b"" if plain else _page(np.arange(20, dtype=np.int64).tobytes(),
                                  codec, dict_page=True, n=20)
    for i in range(pages):
        if plain:
            raw = rng.integers(0, 1 << 40, n).astype(np.int64).tobytes()
        else:
            idx = rng.integers(0, 20, n).astype(np.uint64)
            raw = bytes([5]) + bytes(rle.encode(idx, 5))
        opts = dict(n=n, enc=0 if plain else 8)
        if i == at % pages:
            opts.update(fault)
            if index is not None:
                raw = index
        out += _page(raw, codec, **opts)
    return out + extra, pages * n


_V1 = lambda **k: DataPageHeader(definition_level_encoding=3,  # noqa: E731
                                 repetition_level_encoding=3, **k)
_OUT_OF_RANGE = bytes([5]) + bytes(rle.encode(np.full(200, 31, np.uint64), 5))
# case -> (_chunk's keywords, total-values adjustment, snappy only)
CORRUPT = {
    "truncated header": (dict(extra=b"\x15\x00\x15"), 1, False),
    "exhausted": ({}, 1, False),
    "negative compressed size": (
        dict(header={"compressed_page_size": -3}), 0, False),
    "negative uncompressed size": (
        dict(header={"uncompressed_page_size": -1}), 0, False),
    "overlong size": (
        dict(header={"compressed_page_size": 1 << 20}), 0, False),
    "second dictionary page": (
        dict(extra=_page(b"\0" * 16, NONE, dict_page=True, n=2)), 1, False),
    "late dictionary page": (
        dict(plain=True, extra=_page(b"\0" * 16, NONE, dict_page=True,
                                     n=2)), 1, False),
    "data page without its header": (
        dict(header={"data_page_header": None}), 0, False),
    "crc mismatch, last page": (dict(bad_crc=True), 0, False),
    "crc mismatch, first data page": (dict(at=0, bad_crc=True), 0, False),
    # the first page's count is -5, so the chunk ends 205 values early
    "negative value count": (
        dict(at=0, header={"data_page_header": _V1(num_values=-5,
                                                   encoding=8)}),
        -205, False),
    "snappy bomb": (dict(payload=bytes(native.snappy_compress(
        b"\0" * 4096))), 0, True),
    "declared size lie": (
        dict(header={"uncompressed_page_size": 10_000}), 0, False),
    "short declared size": (
        dict(header={"uncompressed_page_size": 7}), 0, False),
    "malformed snappy": (dict(payload=b"\x10\xff\xff\xff"), 0, True),
    "bad length header": (dict(payload=b"\xff" * 6), 0, True),
    "unknown encoding, plain chunk": (dict(plain=True, enc=42), 0, False),
    "no encoding, plain chunk": (
        dict(plain=True, header={"data_page_header": _V1(num_values=100)}),
        0, False),
    # faults of the index streams: raised by the plan, at finish
    "index width over 32": (dict(index=bytes([40, 3, 1])), 0, False),
    "index page without its width": (dict(index=b""), 0, False),
    "truncated bit-packed run": (dict(index=bytes([5, 0x0B, 1, 2])), 0,
                                 False),
    "exhausted index stream": (dict(index=bytes([5, 8, 1])), 0, False),
    "index out of range": (dict(index=_OUT_OF_RANGE), 0, False),
}
_AT_FINISH = {"index width over 32", "index page without its width",
              "truncated bit-packed run", "exhausted index stream",
              "index out of range"}


_HEADER_WALK = {"truncated header", "exhausted", "negative compressed size",
                "negative uncompressed size", "overlong size",
                "second dictionary page", "late dictionary page",
                "data page without its header"}


class _Md:
    def __init__(self, codec, num_values):
        self.codec, self.num_values = codec, num_values


@pytest.mark.parametrize("codec, case", [
    pytest.param(c, case, id=f"{name}-{case}")
    for c, name in ((SNAPPY, "snappy"), (NONE, "none"))
    for case in sorted(CORRUPT) if c == SNAPPY or not CORRUPT[case][2]])
def test_a_corrupt_chunk_raises_what_the_page_loop_raises(codec, case):
    kw, more, _snappy_only = CORRUPT[case]
    buf, total = _chunk(codec, **kw)
    ctx = {"file": "f.parquet", "row_group": 3, "column": "k",
           "chunk_offset": 1000}
    got = _same(buf, _Md(codec, total + more), LEAF, ctx)
    if case in _AT_FINISH or ("encoding" in case and codec == NONE):
        # an uncompressed chunk keeps no page lazy: its encodings are read
        # by the plan
        assert _walked(got)
        err = _finish(got)
        assert isinstance(err, tuple) and issubclass(err[0], ParquetError)
    elif case == "short declared size" and codec == SNAPPY:
        # the snappy stream claims more than the page declares
        assert isinstance(got, tuple) and "claims" in got[1]
    else:
        assert isinstance(got, tuple), case
        assert issubclass(got[0], ParquetError)
        # a page's own fault carries its ordinal and offset; a fault of
        # the header walk the chunk's coordinates alone
        per_page = case not in _HEADER_WALK
        assert ("page" in got[2] and "offset" in got[2]) == per_page, got


def test_a_lazy_page_that_fails_to_decompress_raises_at_finish():
    """A PLAIN page stays compressed through the collection in both; the
    plan that needs its bytes raises the codec's error."""
    buf, n = _chunk(SNAPPY, plain=True, payload=b"\x10\xff\xff\xff")
    got = _same(buf, _Md(SNAPPY, n), LEAF, {"column": "k"})
    assert _walked(got)
    err = _finish(got)
    assert isinstance(err, tuple) and "snappy" in err[1]


@pytest.mark.parametrize("budget", [300, 600, 1 << 30])
def test_the_memory_budget_raises_at_the_same_page(budget):
    """Where the chunk's declared page sizes could pass the budget, the
    page loop takes the chunk (it registers page by page, so it names the
    failing page) and counts as the walk's ``budget`` fallback."""
    buf, n = _chunk(SNAPPY, pages=4)
    got = []
    for walk in (False, True):
        alloc = AllocTracker(budget)
        stats = obs.HostPhaseStats()
        unit = stats.begin()
        try:
            got.append((_outcome(lambda: _state(_collect(
                walk, buf, SNAPPY, n, LEAF, alloc=alloc))), alloc.total))
        finally:
            stats.end(unit, 0.0)
    assert got[0] == got[1]
    upper = chunk_walk.ChunkWalk.headers(buf, n, SNAPPY).upper_bytes()
    out = got[1][0]
    failed = isinstance(out, tuple) and isinstance(out[0], type)
    assert failed == (budget < 1 << 30)
    d = stats.as_dict()
    if upper > budget:
        assert d["chunk_walks"] == 0
        assert d["chunk_walk_fallbacks"] == {"budget": 1}
    else:
        assert d["chunk_walks"] == 1 and d["chunk_walk_fallbacks"] == {}


def test_a_failing_page_releases_what_the_pages_after_it_registered():
    for case in ("crc mismatch, first data page", "snappy bomb",
                 "negative value count", "declared size lie"):
        buf, n = _chunk(SNAPPY, **CORRUPT[case][0])
        totals = []
        for walk in (False, True):
            alloc = AllocTracker(0)
            _outcome(lambda: _collect(walk, buf, SNAPPY, n, LEAF,
                                      alloc=alloc))
            totals.append(alloc.total)
        assert totals[0] == totals[1], case


def test_strings_of_an_uncompressed_chunk_are_views_of_it():
    vals = [b"alpha", b"", b"bb"] * 30
    raw = b"".join(len(v).to_bytes(4, "little") + v for v in vals)
    buf = _page(raw, NONE, n=len(vals), enc=0) * 2
    asm = _same(buf, _Md(NONE, 2 * len(vals)), STR_LEAF, {})
    assert _walked(asm)
    assert all(bytes(p.raw) == raw for p in asm.pages)


# ---------------------------------------------------------------------------
# the native CRC-32, and the host phase's counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 15, 16, 63, 64, 65, 127, 128, 1000,
                               65_537, 1 << 20])
def test_the_native_crc32_is_zlibs(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert native.crc32(data) == zlib.crc32(data) & 0xFFFFFFFF
    assert native.crc32(memoryview(data)[1:]) == zlib.crc32(data[1:])


def _scan(path, **kw):
    r = DR.DeviceFileReader(path, device="cpu", **kw)
    try:
        for _ in r.iter_row_groups():
            pass
        r.finalize()
        return r.stats().host_parts(), r
    finally:
        r.close()


@pytest.mark.parametrize("name, reasons", [
    ("snappy_v1", {}),
    ("none_v1", {}),
    ("gzip_v1", {"codec": 20}),
    ("snappy_v2", {"page_v2": 20}),
    ("snappy_optional", {"levels": 20}),
])
def test_the_counters_count_every_chunk_by_its_path(files, name, reasons):
    before = obs.host_phase_totals()
    d, r = _scan(files[name], prefetch=0)
    after = obs.host_phase_totals()
    chunks = 2 * 10  # two row groups of ten columns
    assert d["chunk_walks"] + sum(d["chunk_walk_fallbacks"].values()) \
        == chunks
    assert d["chunk_walk_fallbacks"] == reasons
    assert d["chunk_walks"] == chunks - sum(reasons.values())
    assert after["chunk_walks"] - before["chunk_walks"] == d["chunk_walks"]
    assert sum(d["parts"].values()) == pytest.approx(d["host_seconds"],
                                                     rel=0.01)
    assert all(v >= -1e-9 for v in d["parts"].values()), d["parts"]
    if d["chunk_walks"]:
        for part in ("crc", "page_parse", "run_walk"):
            assert d["parts"][part] > 0, part
    # the def streams' walks are a part of their own
    assert (d["parts"]["level_walk"] > 0) == ("levels" in reasons)


def test_the_counters_count_the_chunk_feeds_chunks(files):
    d, _ = _scan(files["snappy_v1"], prefetch=2)
    assert d["chunk_walks"] == 20 and d["chunk_walk_fallbacks"] == {}

