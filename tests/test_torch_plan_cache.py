"""The port's ``PlanCache`` (``tpu_parquet_torch.serve.cache``) against the
JAX package's, case for case with the ``PlanCache`` cases of
``tests/test_serve.py``.

Footers keyed by file generation (a local file's size and mtime, a
store's identity token and size), a mutated file invalidating cleanly,
``note_mutation``, the LRU bound at ``max_bytes=1``, plans shared and
replayed across readers, and ``scan_files(plan_cache=)``.  The same files
and the same calls go through both packages (the port on
``device="cpu"``, the reference under ``TPQ_PALLAS=1 TPQ_FUSE=1``), and
``counters()`` and the outputs are held equal.  A filtered
``scan_files`` sweep through a warm plan cache walks no page header: its
pruning memo is replayed.

Left out of the reference's cases: the ``ScanService`` ones (not ported
yet).
"""

import io
import os

import pytest
import torch

from tests.test_serve import _write_file
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_result_cache import (BOTH, PORT, REF, _cache_counters,
                                           _dev_col, _host_col)
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch.serve import BoundDictCache, PlanCache
from tpu_parquet_torch.serve.cache import _columns_sig
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_plan_cache")
    return [_write_file(str(d / f"f{i}.parquet"), seed=i) for i in range(3)]


def _bump_mtime(path):
    st = os.stat(path)
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))


def test_footer_cache_local_mutation_invalidates(tmp_path):
    path = _write_file(str(tmp_path / "mut.parquet"), seed=1, groups=1,
                       rows=100)
    caches = {pkg.name: pkg.PlanCache() for pkg in BOTH}
    first = {}
    for pkg in BOTH:
        cache = caches[pkg.name]
        meta1, _ = cache.footer(path)
        meta1b, _ = cache.footer(path)
        c = cache.counters()
        assert c["footer_misses"] == 1 and c["footer_hits"] == 1
        assert meta1 is meta1b
        first[pkg.name] = meta1
    _write_file(path, seed=2, groups=1, rows=150)
    _bump_mtime(path)
    for pkg in BOTH:
        cache = caches[pkg.name]
        meta2, _ = cache.footer(path)
        assert meta2.num_rows == 150 and first[pkg.name].num_rows == 100
        c = cache.counters()
        assert c["footer_misses"] == 2 and c["invalidations"] >= 1
    assert caches["port"].counters() == caches["ref"].counters()


def test_footer_cache_store_identity_token(files):
    data = open(files[0], "rb").read()
    got = []
    for pkg in BOTH:
        def mem_store(token, S=pkg.S):
            return S.FaultInjectingStore(S.LocalStore(io.BytesIO(data)),
                                         identity_token=token)

        cache = pkg.PlanCache()
        meta1, _ = cache.footer(None, store=mem_store("obj://b/f0@etag1"))
        meta2, _ = cache.footer(None, store=mem_store("obj://b/f0@etag1"))
        c = cache.counters()
        assert meta2 is meta1
        assert c["footer_misses"] == 1 and c["footer_hits"] == 1
        meta3, _ = cache.footer(None, store=mem_store("obj://b/f0@etag2"))
        assert meta3 is not meta1
        assert cache.counters()["footer_misses"] == 2
        s4 = mem_store(None)
        cache.footer(None, store=s4)
        cache.footer(None, store=s4)
        assert cache.counters()["footer_hits"] == 1
        got.append((cache.counters(), meta1.num_rows, meta3.num_rows))
    assert got[0] == got[1]


def test_plan_cache_lru_eviction(files):
    got = []
    for pkg in BOTH:
        cache = pkg.PlanCache(max_bytes=1)
        cache.footer(files[0])
        cache.footer(files[1])
        c = cache.counters()
        assert c["evictions"] >= 1 and c["entries"] <= 1
        got.append(c)
    assert got[0] == got[1]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_scan_files_plan_cache(files, prefetch):
    got = {}
    for pkg in BOTH:
        def collect(**kw):
            return [_dev_col(cols["a"])
                    for cols in pkg.scan_files(files, columns=["a"],
                                               prefetch=prefetch, **kw)]

        base = collect()
        cache = pkg.PlanCache()
        first = collect(plan_cache=cache)
        second = collect(plan_cache=cache)
        assert first == base and second == base
        c = cache.counters()
        assert c["footer_misses"] == len(files)
        assert c["footer_hits"] >= len(files)
        got[pkg.name] = (base, _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_plan_is_shared_and_replayed(files):
    """``reader_kwargs`` hands every reader of one (file, projection,
    filter) the same plan object; both readers adopt it, and its route
    memo, filled by the first device read, replays bit-identically."""
    got = {}
    for pkg in BOTH:
        cache = pkg.PlanCache()
        kw1 = cache.reader_kwargs(files[0], columns=["a"],
                                  device=pkg.sig_dev)
        kw2 = cache.reader_kwargs(files[0], columns=["a"],
                                  device=pkg.sig_dev)
        assert kw1["plan"] is kw2["plan"]
        assert kw1["metadata"] is kw2["metadata"]
        assert type(kw1["dict_cache"]).__name__ == "BoundDictCache"
        assert pkg is REF or isinstance(kw1["dict_cache"], BoundDictCache)
        assert kw1["dict_cache"].key == cache.file_key(files[0])
        outs = []
        for kw in (kw1, kw2):
            with pkg.DeviceFileReader(files[0], columns=["a"], **kw) as r:
                assert r._plan is kw["plan"]
                outs.append([_dev_col(g["a"]) for g in r.iter_row_groups()])
        assert outs[0] == outs[1]
        routes = kw1["plan"].routes_table()
        assert routes
        with pkg.FileReader(files[0], columns=["a"],
                            **cache.reader_kwargs(files[0],
                                                  columns=["a"])) as r:
            assert r._plan is kw1["plan"]
            host = {k: _host_col(v) for k, v in r.read_all().items()}
        other = cache.reader_kwargs(files[0], columns=["s"])
        assert other["plan"] is not kw1["plan"]
        got[pkg.name] = (outs[0], host, routes, kw1["plan"].serialize(),
                         _cache_counters(cache))
    assert got["port"] == got["ref"]


@pytest.mark.parametrize("device", [False, True])
def test_note_mutation_drops_the_old_generation(tmp_path, device):
    path = _write_file(str(tmp_path / "mut.parquet"), seed=3)
    caches = {pkg.name: pkg.PlanCache(result_cache_mb=64,
                                      result_cache_hbm_mb=64)
              for pkg in BOTH}

    def read(pkg):
        cache = caches[pkg.name]
        if device:
            kw = cache.reader_kwargs(path, device=pkg.sig_dev)
            with pkg.DeviceFileReader(path, **kw) as r:
                return [{k: _dev_col(v) for k, v in g.items()}
                        for g in r.iter_row_groups()]
        with pkg.FileReader(path, **cache.reader_kwargs(path)) as r:
            return {k: _host_col(v) for k, v in r.read_all().items()}

    old = {pkg.name: read(pkg) for pkg in BOTH}
    _write_file(path, seed=4)
    _bump_mtime(path)
    dropped = {}
    for pkg in BOTH:
        cache = caches[pkg.name]
        held = cache.counters()["entries"]
        chunks = sum(1 for k in cache.results._entries if k[0] == "chunk")
        dicts = sum(1 for k in cache.results._entries if k[0] == "dict")
        dropped[pkg.name] = cache.note_mutation(path)
        assert dropped[pkg.name] == held  # the footer and the plan
        rc = cache.results.counters()
        assert (rc["host"]["invalidations"]
                + rc["device"]["invalidations"]) == chunks + dicts
        assert not cache.results._entries
        assert cache.note_mutation(path) == 0  # nothing left to drop
        new = read(pkg)
        assert new != old[pkg.name]
        dropped[pkg.name] = (held, new, _cache_counters(cache))
    assert dropped["port"] == dropped["ref"]
    os.remove(path)
    for pkg in BOTH:
        # a removed file drops by identity
        assert caches[pkg.name].note_mutation(path) == 2


@pytest.mark.parametrize("prefetch", [0, 4])
def test_filtered_sweep_replays_the_pruning_memo(files, prefetch,
                                                 monkeypatch):
    """A filtered ``scan_files`` through a warm plan cache (no result
    tier): the second sweep walks no page header (each file's pruning
    memo lives in its shared plan) and yields what the first did."""
    walks = []
    plan_pruning = DR.plan_page_pruning

    def spy(*a, **k):
        walks.append(1)
        return plan_pruning(*a, **k)

    monkeypatch.setattr(DR, "plan_page_pruning", spy)
    got = {}
    for pkg in BOTH:
        cache = pkg.PlanCache()
        pred = pkg.col("a") > 0
        sweeps = []
        for _ in range(2):
            walks.clear()
            out = [{k: _dev_col(v) for k, v in g.items()}
                   for g in pkg.scan_files(files, row_filter=pred,
                                           plan_cache=cache,
                                           prefetch=prefetch)]
            sweeps.append((out, len(walks)))
        assert sweeps[0][0] == sweeps[1][0]
        if pkg is PORT:
            assert sweeps[0][1] == 6 and sweeps[1][1] == 0
        got[pkg.name] = (sweeps[0][0], _cache_counters(cache))
    assert got["port"] == got["ref"]


def test_columns_signature():
    assert _columns_sig(None) is None
    assert _columns_sig(["b", ("a", "x")]) == ("a.x", "b")
    from tpu_parquet.serve.cache import _columns_sig as ref_sig

    assert _columns_sig(["b", ("a", "x")]) == ref_sig(["b", ("a", "x")])


def test_unkeyed_sources_are_never_cached(files):
    data = open(files[0], "rb").read()
    got = []
    for pkg in BOTH:
        cache = pkg.PlanCache()
        assert cache.file_key(io.BytesIO(data)) is None
        assert cache.file_key(str(files[0]) + ".missing") is None
        plan = cache.plan(None, None, None, source=files[0])
        assert plan.columns == ("a", "s")
        kw = cache.reader_kwargs(files[0])
        assert "result_cache" not in kw
        got.append(cache.counters())
    assert got[0] == got[1]
    assert PlanCache.file_key(files[0])[:2] == (
        "file", os.path.abspath(files[0]))
    assert REF.PlanCache.file_key(files[0]) == PlanCache.file_key(files[0])
