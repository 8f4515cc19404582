"""The port's two-tier result cache (``tpu_parquet_torch.serve``) against
the JAX package's, case for case with ``tests/test_result_cache.py``.

The same files (the reference's writer, ``bench.gen_lineitem16`` and the
K3 writer, each written once from a seed) and the same sequence of calls go
through both packages: the port's readers on ``device="cpu"``, the
reference's under ``TPQ_PALLAS=1 TPQ_FUSE=1``.  Held exactly, for every
case: ``ResultCache.counters()`` and ``PlanCache.counters()`` key by key,
the stores' ``IOStats.reads``, and every output bit for bit.  Held on the
port alone:

- warm device scans at prefetch 0 and 4 read no byte and launch nothing
  (no ``_run_plans`` call, no kernel wrapper call);
- a CPU reader's entries never reach a reader on another device, and
  ``"cuda"`` and ``"cuda:0"`` sign alike;
- every published tensor owns its storage: ``untyped_storage().nbytes()``
  equals the bytes the tier counts.

Left out of the reference's cases: the ``ScanService`` hit path and its
admission charge, the doctor verdict and the ``serve-stats`` CLI (the
service and the CLI are not ported yet).  The column-order and mutation
cases, which the reference drives through ``ScanService``, run here
through the readers.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import bench
from tests.test_result_cache import _write_file
from tests.test_torch_compressed import _write as write_k3
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tpu_parquet import device_reader as RDR
from tpu_parquet import iostore as RS
from tpu_parquet import predicate as RP
from tpu_parquet import serve as RSV
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch import predicate as P
from tpu_parquet_torch import serve as SV
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.format import CompressionCodec
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.serve.result_cache import (DEVICE_TENSOR_ATTRS,
                                                  column_nbytes,
                                                  decode_signature,
                                                  device_column_nbytes,
                                                  device_tag)
from tpu_parquet_torch.torch_decode import DeviceColumnData
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()


class _Pkg:
    """One package's entry points, driven by the same case code."""

    def __init__(self, name, serve, host_reader, dr, store_mod, pred, dev):
        self.name = name
        self.PlanCache = serve.PlanCache
        self.ResultCache = serve.ResultCache
        self.FileReader = host_reader
        self.dr = dr
        self.S = store_mod
        self.col = pred.col
        self.dev_kw = dev  # the device reader's device argument
        self.sig_dev = dev.get("device", True)  # reader_kwargs(device=)

    def DeviceFileReader(self, path, **kw):
        return self.dr.DeviceFileReader(path, **self.dev_kw, **kw)

    def scan_files(self, paths, **kw):
        return self.dr.scan_files(paths, **self.dev_kw, **kw)


PORT = _Pkg("port", SV, FileReader, DR, S, P, {"device": "cpu"})
REF = _Pkg("ref", RSV, RefReader, RDR, RS, RP, {})
BOTH = (REF, PORT)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def afile(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_result_cache")
    return _write_file(str(d / "f.parquet"))


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_result_cache_li")
    path = str(d / "lineitem16.parquet")
    bench.gen_lineitem16(path, 12_000, 6_000)
    return path


@pytest.fixture(scope="module")
def k3file(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_result_cache_k3")
    path = str(d / "k3.parquet")
    write_k3(path, rows=40_000, group=20_000, codec=CompressionCodec.GZIP)
    return path


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _warm_cache(pkg):
    return pkg.PlanCache(result_cache_mb=64, result_cache_hbm_mb=64)


def _counting_factory(pkg, stores):
    def factory(f):
        st = pkg.S.FaultInjectingStore(pkg.S.LocalStore(f))
        stores.append(st)
        return st
    return factory


def _host_col(cd):
    """A host ColumnData as bytes (values, def levels, rep levels)."""
    v = cd.values
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        vals = (np.asarray(v.offsets).astype(np.int64).tobytes(),
                np.asarray(v.heap).tobytes())
    else:
        vals = (np.asarray(v).tobytes(),)
    return vals + tuple(None if a is None else np.asarray(a).tobytes()
                        for a in (cd.def_levels, cd.rep_levels))


def _dev_col(col):
    """A device column through ``to_host()`` / ``levels_to_host()``."""
    v = col.to_host()
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        v = (np.asarray(v.offsets), np.asarray(v.heap))
    else:
        v = (np.asarray(v),)
    return (tuple(x.view(np.uint8).tobytes() for x in v),
            tuple(None if x is None else np.asarray(x).tobytes()
                  for x in col.levels_to_host()))


def _host_scan(pkg, path, cache, stores, prefetch=0, crc=None, **kw):
    rk = cache.reader_kwargs(path, device=False, validate_crc=crc)
    with pkg.FileReader(path, prefetch=prefetch, validate_crc=crc,
                        store=_counting_factory(pkg, stores), **rk,
                        **kw) as r:
        out = r.read_all()
    return {k: _host_col(v) for k, v in out.items()}, stores[-1].stats.reads


class _Launches:
    """Counts the port's decode dispatches (``_run_plans``) and its three
    kernel wrappers' calls, on any device (the wrappers' own ``launches``
    count CUDA tensors only)."""

    def __init__(self, monkeypatch):
        self.n = {"plans": 0, "hybrid_unpack_combine": 0,
                  "fused_plain_words": 0, "fused_narrow_words": 0}
        run = DR._run_plans

        def run_plans(plans, buf, *timer):
            self.n["plans"] += len(plans)
            return run(plans, buf, *timer)

        monkeypatch.setattr(DR, "_run_plans", run_plans)
        for name in ("hybrid_unpack_combine", "fused_plain_words",
                     "fused_narrow_words"):
            monkeypatch.setattr(DR, name, self._wrap(name, getattr(DR, name)))

    def _wrap(self, name, fn):
        def call(*a, **k):
            self.n[name] += 1
            return fn(*a, **k)
        return call

    def take(self) -> dict:
        out, self.n = self.n, {k: 0 for k in self.n}
        return out


def _ref_dispatches(reg):
    dev = reg.get("device") or {}
    return sum(int(c.get("dispatches", 0))
               for c in (dev.get("routes") or {}).values())


def _dev_scan(pkg, path, cache, stores, prefetch=0, crc=None, **kw):
    """One device scan through ``cache``: (outputs, store reads, the
    reference's dispatches or None)."""
    rk = cache.reader_kwargs(path, device=pkg.sig_dev, validate_crc=crc)
    assert "result_cache" in rk
    with pkg.DeviceFileReader(path, prefetch=prefetch, validate_crc=crc,
                              store=_counting_factory(pkg, stores), **rk,
                              **kw) as r:
        out = [{k: _dev_col(v) for k, v in g.items()}
               for g in r.iter_row_groups()]
        disp = (_ref_dispatches(r.obs_registry().as_dict())
                if pkg is REF else None)
        if pkg is PORT:
            assert r.alloc.device_snapshot()[0] == 0
    return out, stores[-1].stats.reads, disp


def _cache_counters(cache):
    return cache.counters(), cache.results.counters()


# ---------------------------------------------------------------------------
# warm scans: zero reads, zero launches, bit-identical (reference :104, :139)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("crc", [True, False])
def test_warm_host_scan_zero_reads_bit_identical(afile, prefetch, crc):
    got = {}
    for pkg in BOTH:
        cache, stores = _warm_cache(pkg), []
        scans = [_host_scan(pkg, afile, cache, stores, prefetch, crc)
                 for _ in range(3)]
        (cold, cold_reads), (w1, r1), (w2, r2) = scans
        assert cold_reads > 0 and r1 == 0 and r2 == 0
        assert w1 == cold and w2 == cold
        got[pkg.name] = (scans, _cache_counters(cache))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("crc", [True, False])
def test_warm_device_scan_zero_reads_zero_launches(afile, prefetch, crc,
                                                   monkeypatch):
    spy = _Launches(monkeypatch)
    got = {}
    for pkg in BOTH:
        cache, stores = _warm_cache(pkg), []
        scans, launches = [], []
        for _ in range(3):
            out, reads, disp = _dev_scan(pkg, afile, cache, stores,
                                         prefetch, crc)
            scans.append((out, reads))
            launches.append(disp if pkg is REF else spy.take())
        (cold, cold_reads), (w1, r1), (w2, r2) = scans
        assert cold_reads > 0 and r1 == 0 and r2 == 0
        assert len(cold) == 2 and w1 == cold and w2 == cold
        if pkg is REF:
            assert launches[0] > 0 and launches[1] == launches[2] == 0
        else:
            assert launches[0]["plans"] > 0
            assert launches[0]["hybrid_unpack_combine"] > 0
            assert all(v == 0 for v in launches[1].values())
            assert all(v == 0 for v in launches[2].values())
        got[pkg.name] = (scans, _cache_counters(cache))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_warm_lineitem16_scan_launches_nothing(lineitem, prefetch,
                                               monkeypatch):
    """All 16 columns (dictionary, DELTA, PLAIN strings) warm at prefetch
    0 and 4: no read, no dispatch, no kernel call; the cold read's kernel
    calls are those of a read without the cache."""
    spy = _Launches(monkeypatch)
    with DR.DeviceFileReader(lineitem, device="cpu", prefetch=prefetch) as r:
        plain = [{k: _dev_col(v) for k, v in g.items()}
                 for g in r.iter_row_groups()]
    uncached = spy.take()
    got = {}
    for pkg in BOTH:
        cache, stores = _warm_cache(pkg), []
        cold, cold_reads, _ = _dev_scan(pkg, lineitem, cache, stores,
                                        prefetch)
        cold_launches = spy.take()
        warm, warm_reads, disp = _dev_scan(pkg, lineitem, cache, stores,
                                           prefetch)
        assert warm == cold == plain
        assert cold_reads > 0 and warm_reads == 0
        if pkg is PORT:
            assert cold_launches == uncached
            assert all(v == 0 for v in spy.take().values())
        else:
            assert disp == 0
        got[pkg.name] = (cold_reads, _cache_counters(cache))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_scan_files_plan_cache_second_sweep_reads_nothing(tmp_path,
                                                          prefetch):
    files = [_write_file(str(tmp_path / f"z{i}.parquet"), seed=i)
             for i in range(3)]
    got = {}
    for pkg in BOTH:
        cache, stores = _warm_cache(pkg), []
        factory = _counting_factory(pkg, stores)

        def sweep():
            stores.clear()
            out = [_dev_col(cols["a"])
                   for cols in pkg.scan_files(files, columns=["a"],
                                              plan_cache=cache,
                                              store=factory,
                                              prefetch=prefetch)]
            return out, sum(st.stats.reads for st in stores)

        (first, reads1), (second, reads2) = sweep(), sweep()
        assert reads1 > 0 and reads2 == 0
        assert first == second
        assert cache.results.counters()["device"]["hits"] >= 6
        got[pkg.name] = (first, reads1, _cache_counters(cache))
    assert got["port"] == got["ref"]


# ---------------------------------------------------------------------------
# the HBM tier (reference :253, :302)
# ---------------------------------------------------------------------------

def test_hbm_tier_residency_and_eviction_bound(tmp_path):
    path = _write_file(str(tmp_path / "big.parquet"), seed=3, groups=6,
                       rows=600)
    cap = 24 << 10
    got = {}
    for pkg in BOTH:
        cache = pkg.PlanCache(results=pkg.ResultCache(
            max_bytes=1 << 20, hbm_bytes=cap, chunks_enabled=True))
        kw = cache.reader_kwargs(path, device=pkg.sig_dev)
        with pkg.DeviceFileReader(path, **kw) as r:
            out = [{k: _dev_col(v) for k, v in g.items()}
                   for g in r.iter_row_groups()]
        rc = cache.results
        c = rc.counters()["device"]
        in_use, peak = rc.tracker.device_snapshot()
        assert c["evictions"] > 0
        assert in_use == c["held_bytes"] <= cap
        assert peak <= cap
        got[pkg.name] = (out, _cache_counters(cache), in_use, peak)
    assert got["port"] == got["ref"]


def test_device_pending_publish_bounded_by_tier_capacity(tmp_path):
    path = _write_file(str(tmp_path / "big2.parquet"), seed=8, groups=6,
                       rows=600)
    cap = 8 << 10
    got = {}
    for pkg in BOTH:
        cache = pkg.PlanCache(results=pkg.ResultCache(
            max_bytes=1 << 20, hbm_bytes=cap, chunks_enabled=True))
        kw = cache.reader_kwargs(path, device=pkg.sig_dev)
        with pkg.DeviceFileReader(path, **kw) as r:
            pending = []
            for _ in r.iter_row_groups():
                pending.append((r._rc_pending_bytes, len(r._rc_pending)))
            assert max(p for p, _n in pending) <= 2 * cap + (8 << 10)
            assert len(r._rc_pending) < 6
        got[pkg.name] = (pending, _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_oversized_entry_rejected_not_admitted():
    got = []
    for pkg in BOTH:
        rc = pkg.ResultCache(max_bytes=64, hbm_bytes=0, chunks_enabled=True)
        full = pkg.ResultCache.chunk_key(("file", "/x", 1, 1), 0, "a",
                                         ("host", "v0"))
        assert not rc.put(full, b"x" * 100, 100, "host")
        c = rc.counters()["host"]
        assert c["rejected"] == 1 and c["entries"] == 0
        assert c["held_bytes"] == 0
        got.append(rc.counters())
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# column order and invalidation (reference :280, :334, through readers)
# ---------------------------------------------------------------------------

def test_warm_read_column_order_matches_cold(tmp_path):
    from tpu_parquet.format import FieldRepetitionType as FRT, Type
    from tpu_parquet.schema.core import build_schema, data_column
    from tpu_parquet.writer import FileWriter

    path = str(tmp_path / "order.parquet")
    schema = build_schema([data_column("zz", Type.INT64, FRT.REQUIRED),
                           data_column("aa", Type.INT64, FRT.REQUIRED)])
    rng = np.random.default_rng(2)
    with open(path, "wb") as fh:
        with FileWriter(fh, schema, codec=CompressionCodec.SNAPPY) as w:
            w.write_columns({"zz": rng.integers(0, 9, 100),
                             "aa": rng.integers(0, 9, 100)})
    got = {}
    for pkg in BOTH:
        cache, orders = _warm_cache(pkg), []
        for _ in range(2):
            with pkg.FileReader(path, **cache.reader_kwargs(path)) as r:
                host = r.read_all()
            kw = cache.reader_kwargs(path, device=pkg.sig_dev)
            with pkg.DeviceFileReader(path, **kw) as r:
                dev = next(iter(r.iter_row_groups()))
            orders.append((list(host), list(dev),
                           {k: _host_col(v) for k, v in host.items()}))
        assert orders[0][0] == orders[0][1] == ["zz", "aa"]
        assert orders[1] == orders[0]
        got[pkg.name] = (orders, _cache_counters(cache))
    assert got["port"] == got["ref"]


def _bump_mtime(path):
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


@pytest.mark.parametrize("device", [False, True])
def test_mutation_invalidates_exactly_never_stale(tmp_path, device):
    """Both packages' caches over one file: warm, rewrite with a new seed,
    read again.  Every entry of the old generation is invalidated, each
    counted, and the served values are the new file's."""
    path = _write_file(str(tmp_path / "mut.parquet"), seed=5)
    caches = {pkg.name: _warm_cache(pkg) for pkg in BOTH}

    def read(pkg):
        cache = caches[pkg.name]
        if device:
            kw = cache.reader_kwargs(path, device=pkg.sig_dev)
            with pkg.DeviceFileReader(path, **kw) as r:
                return [{k: _dev_col(v) for k, v in g.items()}
                        for g in r.iter_row_groups()]
        with pkg.FileReader(path, **cache.reader_kwargs(path)) as r:
            return {k: _host_col(v) for k, v in r.read_all().items()}

    tier = "device" if device else "host"
    before = {}
    for pkg in BOTH:
        first = read(pkg)
        assert read(pkg) == first  # provably warm
        c = caches[pkg.name].results.counters()[tier]
        before[pkg.name] = (first, c["entries"], c["invalidations"])
        assert c["entries"] > 0
    _write_file(path, seed=6)
    _bump_mtime(path)
    after = {}
    for pkg in BOTH:
        first, entries, inv0 = before[pkg.name]
        fresh = read(pkg)
        c = caches[pkg.name].results.counters()
        # the chunks of the old generation (and, on the host, its
        # dictionaries) all invalidated, each counted
        inv = c["host"]["invalidations"] + c["device"]["invalidations"]
        assert inv - inv0 >= entries
        assert fresh != first
        after[pkg.name] = (fresh, _cache_counters(caches[pkg.name]))
    with FileReader(path) as r:
        plain = {k: _host_col(v) for k, v in r.read_all().items()}
    if not device:
        assert after["port"][0] == plain
    assert after["port"] == after["ref"]


# ---------------------------------------------------------------------------
# single flight (reference :361, :401)
# ---------------------------------------------------------------------------

def test_single_flight_builds_once_for_concurrent_waiters():
    got = []
    for pkg in BOTH:
        rc = pkg.ResultCache(max_bytes=1 << 20, hbm_bytes=0,
                             chunks_enabled=True)
        full = pkg.ResultCache.chunk_key(("file", "/x", 1, 1), 0, "a",
                                         ("host", "v0"))
        builds, results, errors = [], [], []
        gate, started = threading.Event(), threading.Event()

        def build():
            builds.append(threading.get_ident())
            started.set()
            gate.wait(5)
            return b"value", 5

        def worker():
            try:
                results.append(rc.get_or_build(full, build, "host"))
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(6)]
        threads[0].start()
        started.wait(5)
        for t in threads[1:]:
            t.start()
        time.sleep(0.1)  # the waiters queue on the build lock
        gate.set()
        for t in threads:
            t.join(10)
        assert not errors, errors
        assert len(builds) == 1
        assert results == [b"value"] * 6
        assert rc.single_flight_waits >= 1
        c = rc.counters()
        assert c["host"]["misses"] == 1 and c["host"]["hits"] == 5
        got.append({k: v for k, v in c.items()
                    if k != "single_flight_waits"})
    assert got[0] == got[1]


def test_single_flight_failed_build_not_published():
    got = []
    for pkg in BOTH:
        rc = pkg.ResultCache(max_bytes=1 << 20, hbm_bytes=0,
                             chunks_enabled=True)
        full = pkg.ResultCache.chunk_key(("file", "/x", 1, 1), 0, "a",
                                         ("host", "v0"))

        def bad():
            raise ValueError("decode failed")

        with pytest.raises(ValueError):
            rc.get_or_build(full, bad, "host")
        assert rc.get(full) is None
        assert rc.get_or_build(full, lambda: (b"ok", 2), "host") == b"ok"
        got.append(rc.counters())
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# the dictionary store folded into the host tier (reference :418, :438)
# ---------------------------------------------------------------------------

def test_dictionaries_fold_into_result_cache_lru(afile):
    got = {}
    for pkg in BOTH:
        cache = pkg.PlanCache()
        outs = []
        for _ in range(2):
            with pkg.FileReader(afile, **cache.reader_kwargs(afile)) as r:
                outs.append({k: _host_col(v)
                             for k, v in r.read_all().items()})
        assert outs[0] == outs[1]
        c = cache.counters()
        assert c["dict_hits"] > 0
        rcounters = cache.results.counters()["host"]
        assert rcounters["entries"] > 0 and rcounters["held_bytes"] > 0
        assert all(k[0] in ("footer", "plan") for k in cache._entries)
        assert all(k[0] == "dict" for k in cache.results._entries)
        assert cache.results.tier_capacity("host") == cache.max_bytes
        got[pkg.name] = (outs, _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_dict_fallback_shares_plan_budget():
    got = []
    for pkg in BOTH:
        k1, k2 = ("file", "/x", 1, 1), ("file", "/y", 1, 1)
        lean = pkg.PlanCache(max_bytes=1000)
        lean._put("footer", (k1,), "f1", 300)
        lean._put("footer", (k2,), "f2", 300)
        assert lean.counters()["evictions"] == 0
        full = pkg.PlanCache(max_bytes=1000)
        assert full.results.dict_fallback_active
        full.dict_put(k1, 0, "a", "host:v0", b"d", 900)
        full._put("footer", (k1,), "f1", 300)
        full._put("footer", (k2,), "f2", 300)
        assert full.counters()["evictions"] >= 1
        assert not _warm_cache(pkg).results.dict_fallback_active
        got.append((lean.counters(), _cache_counters(full)))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# decode-signature discipline (reference :545, :560, :574, :599, :625, :650)
# ---------------------------------------------------------------------------

def test_crc_tiers_never_share_entries(afile):
    got = {}
    for pkg in BOTH:
        cache = _warm_cache(pkg)
        kw = cache.reader_kwargs(afile, device=False, validate_crc=True)
        with pkg.FileReader(afile, validate_crc=True, **kw) as r:
            r.read_all()
        hits_before = cache.results.counters()["host"]["hits"]
        kw2 = cache.reader_kwargs(afile, device=False, validate_crc=False)
        with pkg.FileReader(afile, validate_crc=False, **kw2) as r:
            r.read_all()
        assert cache.results.counters()["host"]["hits"] == hits_before
        assert kw["result_cache"].sig != kw2["result_cache"].sig
        got[pkg.name] = _cache_counters(cache)
    assert got["port"] == got["ref"]


def test_host_and_device_shapes_never_share_entries(afile):
    got = {}
    for pkg in BOTH:
        cache = _warm_cache(pkg)
        with pkg.FileReader(afile, **cache.reader_kwargs(afile)) as r:
            host = r.read_all()
        kw = cache.reader_kwargs(afile, device=pkg.sig_dev)
        with pkg.DeviceFileReader(afile, **kw) as r:
            groups = list(r.iter_row_groups())
        dev = np.concatenate([np.asarray(g["a"].to_host()) for g in groups])
        np.testing.assert_array_equal(dev, host["a"].values)
        sigs = {k[4][0] for k in cache.results._entries if k[0] == "chunk"}
        assert sigs == {"host", "dev"}
        got[pkg.name] = (dev.tobytes(), _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_mismatched_adapter_tier_dropped_not_adopted(afile):
    got = {}
    for pkg in BOTH:
        cache = _warm_cache(pkg)
        dev_kw = cache.reader_kwargs(afile, device=pkg.sig_dev)
        with pkg.FileReader(afile, **dev_kw) as r:
            assert r._result_cache is None
            host = r.read_all()
        assert all(k[4][0] != "dev" for k in cache.results._entries
                   if k[0] == "chunk")
        kw = cache.reader_kwargs(afile, device=pkg.sig_dev)
        with pkg.DeviceFileReader(afile, **kw) as r:
            groups = list(r.iter_row_groups())
        dev = np.concatenate([np.asarray(g["a"].to_host()) for g in groups])
        np.testing.assert_array_equal(dev, host["a"].values)
        with pkg.DeviceFileReader(
                afile, **cache.reader_kwargs(afile, device=False)) as r:
            assert r._result_cache is None
        got[pkg.name] = _cache_counters(cache)
    assert got["port"] == got["ref"]


def test_crc_or_fingerprint_mismatched_adapter_dropped(afile):
    got = {}
    for pkg in BOTH:
        cache = _warm_cache(pkg)
        kw = cache.reader_kwargs(afile, device=False, validate_crc=False)
        with pkg.FileReader(afile, validate_crc=True, **kw) as r:
            assert r._result_cache is None
        kwd = cache.reader_kwargs(afile, device=pkg.sig_dev,
                                  validate_crc=False)
        with pkg.DeviceFileReader(afile, validate_crc=True, **kwd) as r:
            assert r._result_cache is None
        kwf = cache.reader_kwargs(afile, device=pkg.sig_dev)
        kwf.pop("plan")
        with pkg.DeviceFileReader(afile, row_filter=pkg.col("a") > 0,
                                  **kwf) as r:
            assert r._result_cache is None
        ok = cache.reader_kwargs(afile, device=pkg.sig_dev,
                                 validate_crc=True)
        with pkg.DeviceFileReader(afile, validate_crc=True, **ok) as r:
            assert r._result_cache is not None
        got[pkg.name] = _cache_counters(cache)
    assert got["port"] == got["ref"]


def test_stale_generation_publisher_rejected():
    got = []
    for pkg in BOTH:
        RC = pkg.ResultCache
        rc = RC(max_bytes=1 << 20, hbm_bytes=0, chunks_enabled=True)
        g1 = ("file", "/x", 100, 1000)
        g2 = ("file", "/x", 120, 2000)
        old_key = RC.chunk_key(g1, 0, "a", ("host", "v1"))
        rc.put(old_key, b"old", 3, "host")
        rc.note_generation(g2)
        new_key = RC.chunk_key(g2, 0, "a", ("host", "v1"))
        assert rc.put(new_key, b"new", 3, "host")
        assert not rc.put(old_key, b"stale", 5, "host")
        assert rc.get(new_key) == b"new"
        assert rc.get(old_key) is None
        c = rc.counters()["host"]
        assert c["rejected"] >= 1 and c["entries"] == 1
        g3 = ("file", "/x", 130, 3000)
        assert rc.put(RC.chunk_key(g3, 0, "a", ("host", "v1")), b"v3", 2,
                      "host")
        assert rc.get(new_key) is None
        got.append(rc.counters())
    assert got[0] == got[1]


def test_straggling_footer_observation_does_not_wipe():
    got = []
    for pkg in BOTH:
        RC = pkg.ResultCache
        rc = RC(max_bytes=1 << 20, hbm_bytes=0, chunks_enabled=True)
        g1 = ("file", "/x", 100, 1000)
        g2 = ("file", "/x", 120, 2000)
        rc.note_generation(g2)
        k2 = RC.chunk_key(g2, 0, "a", ("host", "v1"))
        assert rc.put(k2, b"new", 3, "host")
        rc.note_generation(g1)
        assert rc.get(k2) == b"new"
        assert rc.counters()["host"]["invalidations"] == 0
        got.append(rc.counters())
    assert got[0] == got[1]


def test_device_cold_misses_counted_at_prefetch(afile):
    got = {}
    for pkg in BOTH:
        cache = _warm_cache(pkg)
        kw = cache.reader_kwargs(afile, device=pkg.sig_dev)
        with pkg.DeviceFileReader(afile, prefetch=4, **kw) as r:
            for _ in r.iter_row_groups():
                pass
        assert cache.results.counters()["device"]["misses"] >= 4
        got[pkg.name] = _cache_counters(cache)
    assert got["port"] == got["ref"]


def test_column_nbytes_accounting(afile):
    with FileReader(afile) as r:
        out = r.read_all()
    n = column_nbytes(out["s"])
    assert n == out["s"].values.offsets.nbytes + out["s"].values.heap.nbytes
    assert column_nbytes(out["a"]) == out["a"].values.nbytes
    from tpu_parquet.serve.result_cache import column_nbytes as ref_nbytes

    with RefReader(afile) as r:
        ref = r.read_all()
    assert {k: column_nbytes(v) for k, v in out.items()} == {
        k: ref_nbytes(v) for k, v in ref.items()}


# ---------------------------------------------------------------------------
# the port's own cases: device signatures, storage ownership
# ---------------------------------------------------------------------------

def test_signature_matches_reference_and_names_the_device():
    from tpu_parquet.serve.result_cache import (
        decode_signature as ref_signature)

    for crc in (True, False):
        for fp in (None, "x"):
            want = ref_signature(True, crc, fp)
            for dev in (True, "cpu", "cuda", "cuda:0",
                        torch.device("cpu")):
                sig = decode_signature(dev, crc, fp)
                assert sig[:5] == want
                assert sig[5] == device_tag(dev)
        assert decode_signature(False, crc) == ref_signature(False, crc)
    assert decode_signature("cuda", True) == decode_signature("cuda:0", True)
    assert decode_signature(True, True) == decode_signature("cuda:0", True)
    assert decode_signature("cpu", True) != decode_signature("cuda", True)
    assert device_tag(torch.device("cpu")) == "cpu"


def test_cpu_entries_never_reach_another_device(afile):
    """A CPU reader warms the device tier; an adapter signed for a CUDA
    device is dropped by the CPU reader and finds none of its entries."""
    cache = _warm_cache(PORT)
    kw = cache.reader_kwargs(afile, device="cpu")
    with DR.DeviceFileReader(afile, device="cpu", **kw) as r:
        for _ in r.iter_row_groups():
            pass
    held = cache.results.counters()["device"]["entries"]
    assert held == 4
    cuda_kw = cache.reader_kwargs(afile, device="cuda")
    rc = cuda_kw["result_cache"]
    assert rc.sig[-1] == "cuda:0" and rc.sig[:5] == kw["result_cache"].sig[:5]
    with DR.DeviceFileReader(afile, device="cpu", **cuda_kw) as r:
        assert r._result_cache is None  # dropped at the door
    hits = cache.results.counters()["device"]["hits"]
    for rg in range(2):
        assert rc.lookup_group(rg, ["a", "s"]) is None
        assert not rc.has_group(rg, ["a", "s"])
    c = cache.results.counters()["device"]
    assert c["hits"] == hits and c["entries"] == held


@pytest.mark.parametrize("name", ["afile", "lineitem", "k3file"])
@pytest.mark.parametrize("prefetch", [0, 4])
def test_published_tensors_own_their_storage(name, prefetch, request):
    path = request.getfixturevalue(name)
    cache = _warm_cache(PORT)
    kw = cache.reader_kwargs(path, device="cpu")
    with DR.DeviceFileReader(path, device="cpu", prefetch=prefetch,
                             **kw) as r:
        for _ in r.iter_row_groups():
            pass
    counted = 0
    entries = [e for k, e in cache.results._entries.items()
               if k[0] == "chunk"]
    assert entries
    for value, nbytes, tier, _tenant in entries:
        assert tier == "device"
        assert nbytes == device_column_nbytes(value)
        for attr in DEVICE_TENSOR_ATTRS:
            t = getattr(value, attr, None)
            if t is not None:
                assert (t.untyped_storage().nbytes()
                        == t.numel() * t.element_size()), attr
        counted += nbytes
    assert counted == cache.results.counters()["device"]["held_bytes"]
    assert cache.results.tracker.device_snapshot()[0] == counted


def test_owning_copy_clones_views_only():
    base = torch.arange(64, dtype=torch.int64)
    owned = torch.arange(8, dtype=torch.int32)
    col = DeviceColumnData(values=base[8:16], def_levels=owned,
                           num_leaf_slots=8)
    pub = DR._owning_copy(col)
    assert pub is not col and col.values.data_ptr() == base[8:].data_ptr()
    assert pub.def_levels is owned
    assert torch.equal(pub.values, col.values)
    assert pub.values.untyped_storage().nbytes() == 64
    whole = DeviceColumnData(values=owned, num_leaf_slots=8)
    assert DR._owning_copy(whole) is whole
