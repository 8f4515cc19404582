"""The decoded-dictionary cache in the port's readers, against the JAX
package's: ``chunk_decode.ChunkDecoder(dict_cache=)`` under the host
``FileReader``, and ``_collect_chunk(dict_cache=)`` with
``_ChunkAssembler.dict_cache_entry`` / ``adopt_dictionary`` under the
device reader.

A ``PlanCache`` with no result tier (the dictionary store alone) reads
each file twice.  The files: the reference writer's SNAPPY dictionary
file (INT64 and DOUBLE tables over 20,000 values, shipped compressed),
the same in GZIP, ``bench.gen_lineitem16`` (string and integer
dictionaries beside DELTA and PLAIN chunks) and a pyarrow file whose
dictionary falls back to PLAIN mid-chunk.  Held exactly, at prefetch 0
and 4:

- the second read adopts every dictionary the first decoded
  (``dict_hits`` equal to the first read's ``dict_misses``) and is
  bit-equal to it;
- on the device reader its ship routes, link bytes and kernel calls equal
  the first read's;
- ``counters()`` of both caches and the outputs equal the reference's;
- a validating read never adopts an unvalidated decode, the host and
  device shapes never share an entry, an entry holds host arrays equal to
  the reference's, and an adopted table is never written.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import bench
from tests.test_torch_compressed import _counters, _dict_file
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_result_cache import (BOTH, PORT, _cache_counters,
                                           _dev_col, _host_col, _Launches)
from tpu_parquet import device_reader as RDR
from tpu_parquet.schema.core import Schema as RefSchema
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.chunk_decode import validate_chunk_meta
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.footer import read_file_metadata
from tpu_parquet_torch.format import CompressionCodec
from tpu_parquet_torch.schema.core import Schema
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()


def _pyarrow_fallback(path):
    """Strings and integers with dictionaries on; ``s``'s dictionary page
    passes pyarrow's 1 KiB limit and the chunk falls back to PLAIN."""
    rng = np.random.default_rng(17)
    n = 30_000
    words = [f"w{i:05d}" for i in range(3_000)]
    t = pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "s": pa.array([words[i] for i in rng.integers(0, 3_000, n)]),
        "c": pa.array([words[i] for i in rng.integers(0, 40, n)]),
    })
    pq.write_table(t, path, row_group_size=15_000, compression="snappy",
                   dictionary_pagesize_limit=1024)


FILES = {
    "dict_snappy": lambda p: _dict_file(p, CompressionCodec.SNAPPY),
    "dict_gzip": lambda p: _dict_file(p, CompressionCodec.GZIP),
    "lineitem16": lambda p: bench.gen_lineitem16(p, 12_000, 6_000),
    "pyarrow_fallback": _pyarrow_fallback,
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_dict_cache")
    out = {}
    for name, make in FILES.items():
        out[name] = str(root / f"{name}.parquet")
        make(out[name])
    return out


def _dict_only(pkg):
    return pkg.PlanCache(result_cache_mb=0, result_cache_hbm_mb=0)


@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("name", list(FILES))
def test_host_reader_adopts_every_dictionary(files, name, prefetch):
    path = files[name]
    got = {}
    for pkg in BOTH:
        cache = _dict_only(pkg)
        outs, counts = [], []
        for _ in range(2):
            kw = cache.reader_kwargs(path)
            assert "result_cache" not in kw
            with pkg.FileReader(path, prefetch=prefetch, **kw) as r:
                outs.append({k: _host_col(v)
                             for k, v in r.read_all().items()})
            counts.append(cache.counters())
        assert outs[0] == outs[1]
        first, second = counts
        assert first["dict_misses"] > 0 and first["dict_hits"] == 0
        assert second["dict_hits"] == first["dict_misses"]
        assert second["dict_misses"] == first["dict_misses"]
        got[pkg.name] = (outs[0], _cache_counters(cache))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("name", list(FILES))
def test_device_reader_adopts_every_dictionary(files, name, prefetch,
                                               monkeypatch):
    path = files[name]
    spy = _Launches(monkeypatch)
    got = {}
    for pkg in BOTH:
        cache = _dict_only(pkg)
        reads = []
        for _ in range(2):
            kw = cache.reader_kwargs(path, device=pkg.sig_dev)
            assert "result_cache" not in kw
            with pkg.DeviceFileReader(path, prefetch=prefetch, **kw) as r:
                out = [{k: _dev_col(v) for k, v in g.items()}
                       for g in r.iter_row_groups()]
                stats = _counters(r.stats().as_dict())
            reads.append((out, stats, spy.take(), cache.counters()))
        (out1, st1, l1, c1), (out2, st2, l2, c2) = reads
        assert out1 == out2 and st1 == st2 and l1 == l2
        assert c1["dict_misses"] > 0 and c1["dict_hits"] == 0
        assert c2["dict_hits"] == c1["dict_misses"]
        if pkg is PORT:
            assert l1["plans"] > 0
        got[pkg.name] = (out1, st1, _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_crc_tier_and_shape_are_in_the_key(files):
    """A device read without CRC checks fills ``dev:v0`` entries: a
    validating device read adopts none of them, nor does a host read
    (``host:v*``), and each then fills its own."""
    path = files["lineitem16"]
    got = {}
    for pkg in BOTH:
        cache = _dict_only(pkg)
        n = []
        for dev, crc in ((True, False), (True, True), (False, True),
                         (True, False)):
            kw = cache.reader_kwargs(path, device=pkg.sig_dev if dev
                                     else False, validate_crc=crc)
            if dev:
                with pkg.DeviceFileReader(path, validate_crc=crc, **kw) as r:
                    for _ in r.iter_row_groups():
                        pass
            else:
                with pkg.FileReader(path, validate_crc=crc, **kw) as r:
                    r.read_all()
            n.append(cache.counters())
        per_read = n[0]["dict_misses"]
        assert per_read > 0
        assert n[1]["dict_hits"] == 0 and n[2]["dict_hits"] == 0
        assert n[2]["dict_misses"] == 3 * per_read
        assert n[3]["dict_hits"] == per_read
        kinds = {k[4] for k in cache.results._entries}
        assert kinds == {"dev:v0", "dev:v1", "host:v1"}
        got[pkg.name] = _cache_counters(cache)
    assert got["port"] == got["ref"]


class _Capture:
    """A dictionary cache that records what is put (the duck type the
    decoders call)."""

    def __init__(self):
        self.entries = {}
        self.gets = 0

    def get(self, rg, column, kind):
        self.gets += 1
        return self.entries.get((rg, column, kind), (None, 0))[0]

    def put(self, rg, column, kind, value, nbytes):
        self.entries[(rg, column, kind)] = (value, nbytes)


def _collect(mod, path, cache, schema_cls):
    meta = read_file_metadata(path)
    schema = schema_cls.from_file_metadata(meta)
    leaves = {l.path: l for l in schema.leaves}
    asms = []
    with open(path, "rb") as f:
        for i, rg in enumerate(meta.row_groups):
            for chunk in rg.columns:
                leaf = leaves[tuple(chunk.meta_data.path_in_schema)]
                md, offset = validate_chunk_meta(chunk, leaf)
                f.seek(offset)
                buf = f.read(md.total_compressed_size)
                asms.append(mod._collect_chunk(
                    buf, md.codec, md.num_values, leaf, [],
                    context={"row_group": i,
                             "column": ".".join(leaf.path)},
                    dict_cache=cache))
    return asms


def _entry_bytes(entry):
    out = {k: entry[k] for k in ("dtype", "len", "nbytes")}
    out["u8"] = None if entry["u8"] is None else (
        entry["u8"].shape, entry["u8"].tobytes())
    rg = entry["ragged"]
    out["ragged"] = None if rg is None else (
        np.asarray(rg.offsets).astype(np.int64).tobytes(),
        np.asarray(rg.heap).tobytes())
    out["comp"] = None if entry["comp"] is None else (
        bytes(entry["comp"][0]), entry["comp"][1])
    return out


@pytest.mark.parametrize("name", ["dict_snappy", "lineitem16",
                                  "pyarrow_fallback"])
def test_entries_match_reference_and_stay_unwritten(files, name):
    path = files[name]
    port, ref = _Capture(), _Capture()
    _collect(DR, path, port, Schema)
    _collect(RDR, path, ref, RefSchema)
    assert port.entries and set(port.entries) == set(ref.entries)
    for key, (entry, nbytes) in port.entries.items():
        assert nbytes == entry["nbytes"] == ref.entries[key][1]
        # the tables stay on the host until the row group is staged
        assert entry["u8"] is None or isinstance(entry["u8"], np.ndarray)
        assert entry["ragged"] is None or isinstance(entry["ragged"],
                                                     ByteArrayData)
        assert _entry_bytes(entry) == _entry_bytes(ref.entries[key][0])
    snapshot = {k: _entry_bytes(e) for k, (e, _n) in port.entries.items()}
    # a second collection adopts every entry; finishing its chunks (plan
    # building, staging and the decode on the CPU) writes none of them
    gets = port.gets
    asms = _collect(DR, path, port, Schema)
    assert port.gets - gets == len(port.entries)
    dicts = [a for a in asms if a.dict_len]
    assert len(dicts) == len(port.entries)
    with DR.DeviceFileReader(path, device="cpu", validate_crc=False,
                             dict_cache=port) as r:
        for _ in r.iter_row_groups():
            pass
    assert port.gets - gets == 2 * len(port.entries)
    assert {k: _entry_bytes(e) for k, (e, _n) in port.entries.items()} \
        == snapshot
    for a in dicts:
        key = next(k for k, (e, _n) in port.entries.items()
                   if e["u8"] is a.dict_u8 and e["ragged"] is a.dict_ragged)
        assert port.entries[key][0]["len"] == a.dict_len


def test_adopt_round_trip():
    asm = DR._ChunkAssembler(None, [])
    assert asm.dict_cache_entry() is None
    u8 = np.arange(24, dtype=np.uint8).reshape(3, 8)
    asm.adopt_dictionary({"u8": u8, "dtype": "int64", "ragged": None,
                          "len": 3, "comp": (b"xyz", 24)})
    e = asm.dict_cache_entry()
    assert e["u8"] is u8 and e["dtype"] == "int64" and e["len"] == 3
    assert e["nbytes"] == 24 + 3 and e["comp"] == (b"xyz", 24)
    ragged = ByteArrayData(offsets=np.array([0, 2, 5], dtype=np.int64),
                           heap=np.frombuffer(b"abcde", np.uint8))
    b = DR._ChunkAssembler(None, [])
    b.adopt_dictionary({"ragged": ragged, "len": 2})
    e2 = b.dict_cache_entry()
    assert e2["ragged"] is ragged and e2["u8"] is None
    assert e2["nbytes"] == 24 + 5 and e2["comp"] is None
