"""The port's scan service under faults, caches, traces, tenants and the
fleet spool, against the JAX package's: the serve cases of
``tests/test_resilience.py``, ``tests/test_result_cache.py``,
``tests/test_request_trace.py``, ``tests/test_fetch_engine.py`` and
``tests/test_obs_fleet.py``, case for case.

Each case runs the port's ``ScanService(device="cpu")`` beside the
reference's (``TPQ_PALLAS=1 TPQ_FUSE=1``) on the reference tests' own
files, with the same calls, and holds exactly: every response bit for
bit, the ``serve`` section's counts (seconds by key only), the plan- and
result-cache counters, ``IOStats.reads``, the breakers' counters, every
typed error's class and text, and the doctor's and autopsy's reports on
the same trees.

Held on the port alone, the departures from the reference:

- a warm ``device=True`` request on a ``device="cpu"`` service is served
  from the result cache's device tier (its entries signed with the
  service's resolved device): no store built, no byte read, no
  ``_run_plans`` dispatch, no kernel call;
- a cancel, a deadline or a hang that ends a device request reaches its
  ticket without the read's frames: with the garbage collector off, no
  staged buffer and no decoded group of the read is left alive.

Waiting for the port's CLI (``pq_tool``): the ``serve-stats``, ``doctor``,
``autopsy`` and ``trace`` command lines of these files; the reports the
commands print are held through ``obs.doctor_registry``,
``obs.autopsy_dump`` and ``ScanService.get_trace`` instead.
"""

import gc
import json
import os
import re
import threading
import time
import weakref

import numpy as np
import pytest

from tests.test_obs_fleet import _write_file as fleet_file
from tests.test_resilience import _write_file as resilience_file
from tests.test_result_cache import _write_file as cache_file
from tests.test_torch_result_cache import _Launches
from tests.test_torch_serve import (BOTH, PORT, REF, counts, outcome,
                                    response)
from tpu_parquet import obs as RO
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import obs as O
from tpu_parquet_torch.format import (CompressionCodec,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)

ensure_reference_native()


@pytest.fixture(autouse=True)
def _parity_env(io_env, no_reference_crashes, reference_env_warnings):
    """``io_env``: the reference's device reads in Pallas interpret mode,
    no IO knob set, both packages' default fetch engines (process-wide,
    both threads named ``tpq-fetch``) stopped around the test and no
    ``tpq-`` thread left by it; the reference's ``worker_crash`` events
    and the once-per-value env warnings it spent leave with the test."""
    yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_resilience")
    return [resilience_file(str(d / f"f{i}.parquet"), seed=i)
            for i in range(3)]


@pytest.fixture(scope="module")
def afile(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve_result_cache")
    return cache_file(str(d / "f.parquet"))


def _latency_factory(pkg, latency_s, stores=None, **cfg):
    def make(f):
        st = pkg.S.FaultInjectingStore(
            pkg.S.LocalStore(f), pkg.S.FaultSpec(latency_s=latency_s),
            config=pkg.S.IOConfig(backoff_ms=0, **cfg))
        if stores is not None:
            stores.append(st)
        return st
    return make


def _blackout_factory(pkg, victim_path):
    cfg = pkg.S.IOConfig(retries=1, backoff_ms=0, retry_budget=8)

    def factory(f):
        name = os.path.abspath(getattr(f, "name", "") or "")
        spec = (pkg.S.FaultSpec(fail_first=1 << 30)
                if name == os.path.abspath(victim_path)
                else pkg.S.FaultSpec())
        return pkg.S.FaultInjectingStore(pkg.S.LocalStore(f), spec,
                                         config=cfg)

    return factory


def _no_orphans(stores) -> bool:
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        if all("inflight_offset" not in st.stats.sample() for st in stores):
            return True
        time.sleep(0.02)
    return False


# ---------------------------------------------------------------------------
# deadlines and cancels (tests/test_resilience.py :97-:188)
# ---------------------------------------------------------------------------

def test_deadline_expired_typed_fast_and_budget_released(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=2, queue_depth=8, max_memory=1 << 24,
                          store=_latency_factory(pkg, 0.06))
        t0 = time.perf_counter()
        err = outcome(lambda: svc.scan(pkg.Request(files[0],
                                                   deadline_s=0.1),
                                       timeout=30))
        assert time.perf_counter() - t0 < 2.0
        assert err[0] == "DeadlineExceededError"
        assert svc._budget.held == 0
        stores = list(svc._served_stores)
        before = [s.stats.progress() for s in stores]
        time.sleep(0.25)
        assert [s.stats.progress() for s in stores] == before
        assert _no_orphans(stores)
        sv = svc.serve_stats()
        assert sv["failed"] == 1 and sv["deadline_exceeded"] == 1
        out[pkg.name] = (err[0], err[1].split(" (")[0], counts(sv))
        svc.close()
    assert out["port"] == out["ref"]


def test_deadline_expired_in_queue_never_reads(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, queue_depth=8,
                          store=_latency_factory(pkg, 0.08))
        slow = svc.submit(pkg.Request(files[0]))
        quick = svc.submit(pkg.Request(files[1], deadline_s=0.01))
        err = outcome(lambda: quick.result(30))
        res = response(slow.result(60))
        st = svc.serve_stats()
        assert st["deadline_exceeded"] == 1
        out[pkg.name] = (err, res, counts(st))
        svc.close()
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_cancel_mid_flight_typed_and_no_orphans(files, prefetch):
    out = {}
    for pkg in BOTH:
        stores = []

        def factory(f, pkg=pkg, stores=stores):
            st = pkg.S.FaultInjectingStore(
                pkg.S.LocalStore(f), pkg.S.FaultSpec(stall_first=1,
                                                     stall_s=10.0),
                config=pkg.S.IOConfig(backoff_ms=0, retries=2))
            stores.append(st)
            return st

        svc = pkg.Service(concurrency=2, queue_depth=8, max_memory=1 << 24,
                          store=factory)
        ticket = svc.submit(pkg.Request(files[0], prefetch=prefetch))
        time.sleep(0.1)
        ticket.cancel()
        for st in stores:
            st.release()
        err = outcome(lambda: ticket.result(30))
        assert _no_orphans(stores)
        assert svc._budget.held == 0
        sv = svc.serve_stats()
        assert sv["cancelled"] == 1 and sv["failed"] == 1
        out[pkg.name] = (err, counts(sv))
        svc.close()
    assert out["port"] == out["ref"]
    assert out["port"][0][0] == "CancelledError"


def test_cancel_before_start_is_typed(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, queue_depth=8,
                          store=_latency_factory(pkg, 0.1))
        blocker = svc.submit(pkg.Request(files[0]))
        queued = svc.submit(pkg.Request(files[1]))
        queued.cancel()
        err = outcome(lambda: queued.result(30))
        blocker.result(60)
        out[pkg.name] = (err[0], err[1].split("#")[0], counts(
            svc.serve_stats()))
        svc.close()
    assert out["port"] == out["ref"]
    assert out["port"][0] == "CancelledError"


# ---------------------------------------------------------------------------
# circuit breakers and brownout (tests/test_resilience.py :386-:545)
# ---------------------------------------------------------------------------

def test_circuit_trips_within_n_failures_and_names_file(files):
    victim, healthy = files[2], files[0]
    out = {}
    for pkg in BOTH:
        board = pkg.sv.service.BreakerBoard(fails=2, window_s=60,
                                            cooldown_s=60)
        svc = pkg.Service(concurrency=2, queue_depth=32, breakers=board,
                          store=_blackout_factory(pkg, victim))
        errs = [outcome(lambda: svc.scan(pkg.Request(victim), timeout=60))
                for _ in range(3)]
        assert [e[0] for e in errs] == ["RetryExhaustedError"] * 2 + [
            "CircuitOpenError"]
        with pytest.raises(pkg.E.CircuitOpenError) as ei:
            svc.scan(pkg.Request(victim), timeout=60)
        assert ei.value.file == str(victim)
        assert ei.value.retry_after_s is not None
        del ei
        with pkg.FileReader(healthy) as r:
            want_rows = r.num_rows
        res = svc.scan(pkg.Request(healthy, columns=["a"]), timeout=60)
        got = res[healthy]["a"]
        parts = got if isinstance(got, list) else [got]
        assert sum(p.num_leaf_slots for p in parts) == want_rows
        circ = svc.serve_stats()["circuit"]
        assert circ["open_now"] == 1 and circ["open_files"] == [str(victim)]
        assert svc.sample()["circuit_open"][0]["file"] == str(victim)
        out[pkg.name] = ([(c, t.split(" after ")[0]) for c, t in errs[:2]],
                         errs[2][0], response(res), circ,
                         counts(svc.serve_stats()))
        svc.close()
    assert out["port"] == out["ref"]


def test_deadline_failures_never_trip_circuits(files):
    out = {}
    for pkg in BOTH:
        board = pkg.sv.service.BreakerBoard(fails=1, window_s=60,
                                            cooldown_s=60)
        svc = pkg.Service(concurrency=2, queue_depth=8, breakers=board,
                          store=_latency_factory(pkg, 0.08))
        err = outcome(lambda: svc.scan(pkg.Request(files[0],
                                                   deadline_s=0.02),
                                       timeout=30))
        assert err[0] == "DeadlineExceededError"
        assert board.counters()["open_now"] == 0
        res = svc.scan(pkg.Request(files[0], columns=["a"]), timeout=60)
        out[pkg.name] = (response(res), board.counters())
        svc.close()
    assert out["port"] == out["ref"]


def test_brownout_sheds_low_admits_high(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, queue_depth=4, brownout=0.25,
                          store=_latency_factory(pkg, 0.05))
        tickets, shed = [], None
        for _ in range(10):
            try:
                tickets.append(svc.submit(pkg.Request(
                    files[0], columns=["a"], priority=pkg.sv.PRIORITY_LOW)))
            except pkg.E.OverloadError as e:
                shed = (type(e).__name__, str(e).split(" (")[0],
                        str(e).split(": ")[-1], e.shed_priority,
                        e.retry_after_s > 0, e.queue_depth is not None,
                        e.in_flight is not None)
        assert shed is not None
        assert shed[3] == pkg.sv.PRIORITY_LOW and all(shed[4:])
        tickets.append(svc.submit(pkg.Request(
            files[0], columns=["a"], priority=pkg.sv.PRIORITY_HIGH)))
        res = [response(t.result(60)) for t in tickets]
        sv = svc.serve_stats()
        assert sv["sheds"]["low"] >= 1 and sv["completed"] == len(tickets)
        out[pkg.name] = (shed, res[-1])
        svc.close()
    assert out["port"] == out["ref"]


def test_brownout_disabled_and_default(files):
    for pkg in BOTH:
        with pkg.Service(concurrency=1, queue_depth=4, brownout=0.0) as svc:
            assert svc.brownout == 0.0
        with pkg.Service(concurrency=1) as svc:
            assert svc.brownout == pytest.approx(0.85)


def test_chaos_matrix_blackout_trips_circuit_healthy_files_clean(files):
    out = {}
    for pkg in BOTH:
        R = pkg.sv.service
        from importlib import import_module

        res_mod = import_module(pkg.sv.__name__.rsplit(".", 1)[0]
                                + ".resilience")
        schedule = res_mod.ChaosSchedule([
            res_mod.ChaosPhase(0, 8, "stall", intensity=1, stall_s=0.05),
            res_mod.ChaosPhase(8, 1 << 20, "blackout", file_index=2),
        ], seed=11)
        factory = schedule.store_factory(
            files, config=pkg.S.IOConfig(retries=1, backoff_ms=1.0,
                                         retry_budget=32))
        board = R.BreakerBoard(fails=2, window_s=60, cooldown_s=60)
        expect = {}
        for p in files[:2]:
            with pkg.FileReader(p, columns=["a"]) as r:
                expect[p] = r.read_all()["a"].values.copy()
        seen = []
        with pkg.Service(concurrency=2, queue_depth=32, breakers=board,
                         store=factory) as svc:
            for p in files[:2]:
                got = svc.scan(pkg.Request(p, columns=["a"]),
                               timeout=120)[p]["a"]
                np.testing.assert_array_equal(got.values, expect[p])
                seen.append(response({p: {"a": got}}))
            outcome_ = []
            for _ in range(4):
                outcome_.append(outcome(lambda: svc.scan(
                    pkg.Request(files[2], columns=["a"]), timeout=120))[0])
            assert outcome_ == ["RetryExhaustedError"] * 2 + [
                "CircuitOpenError"] * 2
            for p in files[:2]:
                got = svc.scan(pkg.Request(p, columns=["a"]),
                               timeout=120)[p]["a"]
                np.testing.assert_array_equal(got.values, expect[p])
            circ = svc.serve_stats()["circuit"]
            assert circ["open_files"] == [str(files[2])]
            factory.release()
        out[pkg.name] = (seen, outcome_, circ)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# obs surfaces: doctor, autopsy, merges, io stats (reference :630-:757)
# ---------------------------------------------------------------------------

def _reg_tree_with_everything():
    return {
        "obs_version": 1,
        "pipeline": {"io_seconds": 0.4, "stage_seconds": 0.1,
                     "stall_seconds": 0.0},
        "reader": {},
        "io": {"reads": 100, "hedges_issued": 10, "hedges_won": 1,
               "hedges_wasted_bytes": 5000, "hedge_mismatches": 0},
        "serve": {
            "submitted": 10, "completed": 5, "rejected": 3, "failed": 2,
            "queue_wait_seconds": 0.2, "exec_seconds": 1.0, "rows": 100,
            "queue_depth_peak": 4, "deadline_exceeded": 1, "cancelled": 1,
            "sheds": {"low": 3, "normal": 0},
            "circuit": {"opened": 1, "reopened": 0, "closed": 0,
                        "fast_fails": 2, "open_now": 1,
                        "open_files": ["/data/bad.parquet"]},
            "cache": {"footer_hits": 1, "footer_misses": 1, "plan_hits": 1,
                      "plan_misses": 1, "dict_hits": 0, "dict_misses": 0,
                      "evictions": 0, "invalidations": 0, "held_bytes": 10,
                      "capacity_bytes": 100, "entries": 2},
        },
        "histograms": {},
    }


@pytest.mark.parametrize("edit", ["as_is", "hedge_won", "circuit_closed"])
def test_doctor_circuit_open_and_hedge_ineffective(edit):
    tree = _reg_tree_with_everything()
    if edit != "as_is":
        tree["io"]["hedges_won"] = 9
    if edit == "circuit_closed":
        tree["serve"]["circuit"]["open_now"] = 0
    rep = O.doctor_registry(tree)
    assert rep == RO.doctor_registry(tree)
    assert ("hedge" in rep) == (edit == "as_is")
    assert ("circuit_open" in rep) == (edit != "circuit_closed")


def test_autopsy_names_open_circuit(files):
    doc = {
        "flight_version": 1, "reason": "explicit", "pid": 1234,
        "threads": {}, "stacks": {}, "budgets": [], "samples": {
            "serve": {
                "queue_depth": 0, "in_flight": 0, "requests": {},
                "circuit_open": [{"file": str(files[2]),
                                  "retry_after_s": 4.5, "state": "open"}],
            },
        },
    }
    rep = O.autopsy_dump(doc)
    assert rep == RO.autopsy_dump(doc)
    assert rep["verdict"] == "circuit-open"
    assert str(files[2]) in rep["probable_cause"]


def test_autopsy_of_a_live_service_sample(files):
    """The ``serve`` flight source of a live service (an open circuit)
    autopsied by both packages: the same verdict and cause."""
    out = {}
    for pkg in BOTH:
        board = pkg.sv.service.BreakerBoard(fails=1, window_s=60,
                                            cooldown_s=60)
        with pkg.Service(concurrency=1, breakers=board,
                         store=_blackout_factory(pkg, files[2])) as svc:
            outcome(lambda: svc.scan(pkg.Request(files[2]), timeout=60))
            sample = json.loads(json.dumps(svc.sample()))
        doc = {"flight_version": 1, "reason": "explicit", "pid": 1,
               "threads": {}, "stacks": {}, "budgets": [],
               "samples": {"serve": sample}}
        rep = pkg.O.autopsy_dump(doc)
        # the cooldown left is a clock reading
        out[pkg.name] = (rep["verdict"], re.sub(
            r"next probe in [0-9.]+s", "", rep["probable_cause"]),
            sorted(sample))
    assert out["port"] == out["ref"]
    assert out["port"][0] == "circuit-open"


def test_registry_serve_merge_with_new_keys():
    out = {}
    for pkg in BOTH:
        reg = pkg.O.StatsRegistry()
        reg.merge_dict(_reg_tree_with_everything())
        reg.merge_dict(_reg_tree_with_everything())
        tree = reg.as_dict()
        sv = tree["serve"]
        assert sv["deadline_exceeded"] == 2 and sv["sheds"]["low"] == 6
        assert sv["circuit"]["opened"] == 2
        assert sv["circuit"]["open_now"] == 1
        assert tree["io"]["hedges_issued"] == 20
        out[pkg.name] = (sv, tree["io"])
    assert out["port"] == out["ref"]


def test_io_stats_survive_store_collection(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(
            concurrency=2, queue_depth=8,
            store=lambda f, pkg=pkg: pkg.S.FaultInjectingStore(
                pkg.S.LocalStore(f), pkg.S.FaultSpec(fail_first=1),
                config=pkg.S.IOConfig(backoff_ms=0)))
        svc.scan(pkg.Request(files[0]), timeout=60)
        gc.collect()
        io_sec = svc.obs_registry().as_dict()["io"]
        assert io_sec and io_sec["reads"] > 0 and io_sec["retries"] > 0
        out[pkg.name] = (io_sec["reads"], io_sec["retries"])
        svc.close()
    assert out["port"] == out["ref"]


def test_overload_error_carries_lifecycle_fields():
    for pkg in BOTH:
        E = pkg.E
        e = E.OverloadError("shed", queue_depth=3, in_flight=2,
                            retry_after_s=0.7, shed_priority=0)
        assert e.retry_after_s == 0.7 and e.shed_priority == 0
        for cls in (E.DeadlineExceededError, E.CancelledError,
                    E.CircuitOpenError, E.OverloadError):
            assert not issubclass(cls, E.ParquetError)
        assert issubclass(E.DeadlineExceededError, TimeoutError)


# ---------------------------------------------------------------------------
# the result cache through the service (tests/test_result_cache.py :199-:334)
# ---------------------------------------------------------------------------

def _counting(pkg, stores):
    def factory(f):
        st = pkg.S.FaultInjectingStore(pkg.S.LocalStore(f))
        stores.append(st)
        return st
    return factory


def test_service_hit_path_constructs_no_store(afile):
    out = {}
    for pkg in BOTH:
        stores = []
        with pkg.Service(concurrency=2, store=_counting(pkg, stores),
                         result_cache_mb=64) as svc:
            cold = response(svc.scan(pkg.Request(afile)))
            n_after_cold = len(stores)
            warm = response(svc.scan(pkg.Request(afile)))
            assert len(stores) == n_after_cold
            assert warm == cold
            c = svc.cache.results.counters()["host"]
            assert c["hits"] >= 4
            out[pkg.name] = (cold, n_after_cold, svc.cache.counters(),
                             svc.cache.results.counters(),
                             [st.stats.reads for st in stores])
    assert out["port"] == out["ref"]


def test_service_warm_device_request_reads_nothing_dispatches_nothing(
        afile, monkeypatch):
    """The port's warm device request, signed with the service's device
    (``"cpu"`` here): served from the device tier without a store, a read,
    a dispatch or a kernel call.  The reference's warm device request
    builds no store either."""
    stores = {}
    warm = {}
    for pkg in BOTH:
        stores[pkg.name] = []
        with pkg.Service(concurrency=1, result_cache_hbm_mb=64,
                         store=_counting(pkg, stores[pkg.name])) as svc:
            cold = response(svc.scan(pkg.Request(afile, device=True)))
            n_cold = len(stores[pkg.name])
            reads = [st.stats.reads for st in stores[pkg.name]]
            if pkg is PORT:
                launched = _Launches(monkeypatch)
            warm[pkg.name] = response(svc.scan(pkg.Request(afile,
                                                           device=True)))
            assert len(stores[pkg.name]) == n_cold
            assert [st.stats.reads for st in stores[pkg.name]] == reads
            assert warm[pkg.name] == cold
            dev = svc.cache.results.counters()["device"]
            assert dev["hits"] == 4 and dev["misses"] == 4
            if pkg is PORT:
                assert launched.take() == {
                    "plans": 0, "hybrid_unpack_combine": 0,
                    "fused_plain_words": 0, "fused_narrow_words": 0}
                assert svc.device.type == "cpu"
    assert warm["port"] == warm["ref"]


def test_service_hit_path_charges_actual_cached_bytes(afile):
    out = {}
    for pkg in BOTH:
        cache = pkg.sv.PlanCache(result_cache_mb=64, result_cache_hbm_mb=64)
        with pkg.Service(concurrency=1, cache=cache) as svc:
            svc.scan(pkg.Request(afile))
        key = cache.file_key(afile)
        plan = cache.plan(key, None, None)
        units = [pkg.sv.ResultCache.chunk_key(key, rg, c, ("host", "v1"))
                 for rg in plan.selected_ordinals() for c in plan.columns]
        got = cache.results.lookup_units(units)
        assert got is not None
        actual = sum(n for _v, n in got)
        assert actual != plan.estimated_bytes()
        with pkg.Service(concurrency=1, cache=cache,
                         max_memory=1 << 30) as svc2:
            res = svc2.scan(pkg.Request(afile))[afile]
            assert res["a"].num_leaf_slots > 0
            assert svc2._budget.peak == actual
        out[pkg.name] = (actual, plan.estimated_bytes())
    assert out["port"] == out["ref"]


def test_service_without_result_cache_unchanged(afile):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            assert not svc.cache.results.chunks_enabled
            a = response(svc.scan(pkg.Request(afile)))
            b = response(svc.scan(pkg.Request(afile)))
            assert a == b
            assert all(k[0] != "chunk" for k in svc.cache.results._entries)
            out[pkg.name] = (a, svc.cache.results.counters())
    assert out["port"] == out["ref"]


def test_warm_response_column_order_matches_cold(tmp_path):
    path = str(tmp_path / "order.parquet")
    schema = build_schema([
        data_column("zz", Type.INT64, FRT.REQUIRED),
        data_column("aa", Type.INT64, FRT.REQUIRED),
    ])
    rng = np.random.default_rng(2)
    with open(path, "wb") as fh:
        with FileWriter(fh, schema, codec=CompressionCodec.SNAPPY) as w:
            w.write_columns({"zz": rng.integers(0, 9, 100),
                             "aa": rng.integers(0, 9, 100)})
    out = {}
    for pkg in BOTH:
        for device in (False, True):
            with pkg.Service(concurrency=1, result_cache_mb=64,
                             result_cache_hbm_mb=64) as svc:
                cold = svc.scan(pkg.Request(path, device=device))[path]
                warm = svc.scan(pkg.Request(path, device=device))[path]
            assert list(cold) == ["zz", "aa"] == list(warm)
            assert response({"w": warm}) == response({"w": cold})
            out[(pkg.name, device)] = response({"w": cold})
    assert out[("port", False)] == out[("ref", False)]
    assert out[("port", True)] == out[("ref", True)]


def test_mutation_invalidates_exactly_never_stale(tmp_path):
    out = {}
    for pkg in BOTH:
        path = cache_file(str(tmp_path / f"mut_{pkg.name}.parquet"), seed=5)
        cache = pkg.sv.PlanCache(result_cache_mb=64, result_cache_hbm_mb=64)
        with pkg.Service(concurrency=1, cache=cache) as svc:
            first = response(svc.scan(pkg.Request(path)))[path]
            svc.scan(pkg.Request(path))
            entries_before = cache.results.counters()["host"]["entries"]
            inv0 = cache.results.counters()["host"]["invalidations"]
            assert entries_before > 0
            cache_file(path, seed=6)
            st = os.stat(path)
            os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
            after = response(svc.scan(pkg.Request(path)))[path]
            inv1 = cache.results.counters()["host"]["invalidations"]
        assert inv1 - inv0 == entries_before
        assert after != first
        with pkg.FileReader(path) as r:
            assert after == response({"p": r.read_all()})["p"]
        out[pkg.name] = (first, after, entries_before, inv1 - inv0)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# request traces (tests/test_request_trace.py :326-:615)
# ---------------------------------------------------------------------------

RECOVERABLE = {
    "latency_spike": dict(latency_s=0.005),
    "transient_errors": dict(fail_first=2),
    "torn_read": dict(torn_first=1),
    "torn_then_error": dict(torn_first=1, fail_first=2),
}


def _fault_factory(pkg, spec):
    return lambda f: pkg.S.FaultInjectingStore(
        pkg.S.LocalStore(f), pkg.S.FaultSpec(**spec),
        config=pkg.S.IOConfig(retries=4, backoff_ms=1.0))


@pytest.fixture(scope="module")
def trace_files(tmp_path_factory):
    from tests.test_request_trace import _write_file

    d = tmp_path_factory.mktemp("torch_serve_trace")
    return [_write_file(str(d / f"f{i}.parquet"), seed=i) for i in range(2)]


def _span_names(svc) -> set:
    return {s["name"] for d in svc.sampler.traces() for s in d["spans"]}


@pytest.mark.parametrize("fault", sorted(RECOVERABLE))
def test_scan_bit_identical_tracing_on_off(trace_files, fault, monkeypatch):
    path = trace_files[0]
    out = {}
    for pkg in BOTH:
        results = {}
        for mode, env in (("off", "0"), ("retain_all", "1")):
            monkeypatch.setenv("TPQ_TRACE_TAIL", env)
            svc = pkg.Service(concurrency=2,
                              store=_fault_factory(pkg, RECOVERABLE[fault]))
            try:
                results[mode] = response(svc.scan(pkg.Request(path),
                                                  timeout=60))
                c = svc.sampler.counters()
                if mode == "off":
                    assert c["offered"] == 0
                else:
                    assert c["retained"] >= 1
                    assert {"submit", "queue_wait", "read",
                            "fetch"} <= _span_names(svc)
                    for d in svc.sampler.traces():
                        for i, s in enumerate(d["spans"]):
                            assert s["parent"] == -1 or 0 <= s["parent"] < i
                            assert s["dur_s"] is not None
                    names = sorted(_span_names(svc))
            finally:
                svc.close()
        assert results["retain_all"] == results["off"]
        out[pkg.name] = (results["off"], names)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("fault", ["transient_errors", "torn_then_error"])
def test_stream_bit_identical_tracing_on_off(trace_files, fault,
                                             monkeypatch):
    from tests.test_torch_stream import _batch

    out = {}
    for pkg in BOTH:
        drained = {}
        for mode, env in (("off", "0"), ("retain_all", "1")):
            monkeypatch.setenv("TPQ_TRACE_TAIL", env)
            svc = pkg.Service(concurrency=2,
                              store=_fault_factory(pkg, RECOVERABLE[fault]))
            try:
                session = svc.scan(pkg.Request(trace_files, stream=True,
                                               batch_rows=128), timeout=60)
                drained[mode] = [_batch(b) for b in session]
                if mode == "retain_all":
                    deadline = time.time() + 10.0
                    while (time.time() < deadline
                           and not svc.sampler.counters()["retained"]):
                        time.sleep(0.01)
                    assert {"submit", "batch", "group"} <= _span_names(svc)
            finally:
                svc.close()
        assert drained["retain_all"] == drained["off"]
        out[pkg.name] = drained["off"]
    assert out["port"] == out["ref"]


def test_errored_request_trace_reconstructable(trace_files, tmp_path,
                                               monkeypatch):
    monkeypatch.setenv("TPQ_TRACE_TAIL", "128")
    path = trace_files[0]
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, store=_fault_factory(
            pkg, dict(fail_first=10 ** 6)))
        try:
            err = outcome(lambda: svc.scan(pkg.Request(path), timeout=60))
            docs = svc.sampler.traces()
            assert len(docs) == 1 and docs[0]["error"] is not None
            tid = docs[0]["trace_id"]
            assert svc.get_trace(tid)["trace_id"] == tid
            dump = str(tmp_path / f"traces_{pkg.name}.json")
            svc.trace_dump(dump)
            with open(dump) as f:
                dumped = json.load(f)
            names = {s["name"] for s in docs[0]["spans"]}
            assert "fetch" in names
            out[pkg.name] = (err[0], docs[0]["error"]["type"],
                             sorted(names), len(dumped["traces"]),
                             sorted(dumped))
        finally:
            svc.close()
    assert out["port"] == out["ref"]


def test_exemplar_links_tenant_histogram_to_trace(trace_files, monkeypatch):
    monkeypatch.setenv("TPQ_TRACE_TAIL", "1")
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1)
        try:
            svc.register_tenant("acme", weight=2, slo_p99_ms=50.0)
            for _ in range(3):
                svc.scan(pkg.Request(trace_files[0], tenant="acme"),
                         timeout=60)
            tree = svc.obs_registry().as_dict()
            hd = tree["histograms"]["serve.tenant.acme"]
            assert hd.get("exemplars"), hd
            for idx, (tid, val) in hd["exemplars"].items():
                assert svc.get_trace(tid) is not None
                assert pkg.O.LatencyHistogram.bucket_index(
                    float(val)) == int(idx)
            assert tree["serve"]["tenants"]["acme"]["traces_retained"] >= 3
            assert tree["serve"]["trace"]["retained"] >= 3
            out[pkg.name] = (counts(tree["serve"]["tenants"]["acme"]),
                             counts(tree["serve"]["trace"]))
        finally:
            svc.close()
    assert out["port"] == out["ref"]


def _dumper_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("tpq-metricsdump")]


def test_service_dumper_env_snapshot(trace_files, tmp_path, monkeypatch):
    out = {}
    for pkg in BOTH:
        path = str(tmp_path / f"live_{pkg.name}.json")
        monkeypatch.setenv("TPQ_METRICS_DUMP", f"{path}:30")
        svc = pkg.Service(concurrency=1)
        try:
            svc.scan(pkg.Request(trace_files[0]), timeout=60)
            assert _dumper_threads()
        finally:
            svc.close()
        assert not _dumper_threads()
        with open(path) as f:
            tree = json.load(f)
        assert tree["serve"]["submitted"] >= 1
        out[pkg.name] = (counts(tree["serve"]), sorted(tree))
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# tenant deadlines (tests/test_fetch_engine.py :351, :377)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_file(tmp_path_factory):
    from tests.test_fetch_engine import _write_file

    path = str(tmp_path_factory.mktemp("torch_fetch_serve") / "s.parquet")
    _write_file(path, groups=3, rows=300)
    return path


def test_tenant_default_deadline_inherited(serve_file):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=2, queue_depth=8,
                          store=_latency_factory(pkg, 0.06))
        try:
            t = svc.register_tenant("batch", weight=2, deadline_s=0.05)
            assert t.deadline_s == 0.05
            err = outcome(lambda: svc.scan(pkg.Request(
                serve_file, tenant="batch"), timeout=30))
            assert err[0] == "DeadlineExceededError"
            res = svc.scan(pkg.Request(serve_file, tenant="batch",
                                       deadline_s=60.0), timeout=60)
            assert len(res[serve_file]["a"].values) == 900
            sv = svc.serve_stats()
            assert sv["tenants"]["batch"]["deadline_s"] == 0.05
            assert "deadline_s" not in sv["tenants"]["default"]
            out[pkg.name] = (err[0], response(res),
                             counts(sv["tenants"]))
        finally:
            svc.close()
    assert out["port"] == out["ref"]


def test_tenant_deadline_from_spec_string():
    for pkg in BOTH:
        reg = pkg.T.TenantRegistry(max_memory=1 << 20,
                                   spec="gold=4:2.5,bronze=1")
        assert reg.get("gold").deadline_s == 2.5
        assert reg.get("gold").weight == 4
        assert reg.get("bronze").deadline_s is None
        with pkg.Service(concurrency=1, tenants="slo=2:1.5") as svc:
            assert svc.tenants.get("slo").deadline_s == 1.5
    from tests.test_torch_serve import T, RT

    assert (T.TenantRegistry(max_memory=1 << 20, spec="gold=4:2.5,b=1")
            .as_dict() == RT.TenantRegistry(
                max_memory=1 << 20, spec="gold=4:2.5,b=1").as_dict())


# ---------------------------------------------------------------------------
# the fleet: tenant files, stream yields, spool auto-arm
# (tests/test_obs_fleet.py :489-:596)
# ---------------------------------------------------------------------------

def test_tenant_file_spec_and_from_file(tmp_path):
    p = tmp_path / "tenants.json"
    p.write_text(json.dumps({
        "gold": {"weight": 3, "deadline_s": 2.5, "slo_p99_ms": 50},
        "bronze": 1,
        "weird": {"weight": -4},
        "": {"weight": 9},
        "bool": True,
    }))
    tables = {pkg.name: pkg.T.tenant_table(f"@{p}") for pkg in BOTH}
    assert tables["port"] == tables["ref"]
    assert tables["port"]["gold"] == {"weight": 3, "deadline_s": 2.5,
                                      "slo_p99_ms": 50.0}
    assert set(tables["port"]) == {"gold", "bronze", "weird"}
    regs = {pkg.name: pkg.T.TenantRegistry.from_file(str(p))
            for pkg in BOTH}
    assert regs["port"].as_dict() == regs["ref"].as_dict()
    t = regs["port"].get("gold")
    assert t.weight == 3 and t.slo_p99_ms == 50.0


def test_tenant_file_malformed_degrades(tmp_path):
    p = tmp_path / "tenants.json"
    for text in ("{broken json", "[1, 2]"):
        p.write_text(text)
        for pkg in BOTH:
            assert pkg.T.tenant_table(f"@{p}") == {}
    for pkg in BOTH:
        assert pkg.T.tenant_table(f"@{tmp_path}/missing.json") == {}


@pytest.mark.parametrize("stream_yield", [True, False])
def test_stream_yields_slot_between_batches(tmp_path, stream_yield):
    path = fleet_file(str(tmp_path / "f.parquet"), seed=3, groups=8,
                      rows=800)
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, queue_depth=64, fair=True,
                          result_cache_mb=0, stream_yield=stream_yield)
        svc.register_tenant("victim", weight=2)
        svc.register_tenant("noisy", weight=1)
        try:
            session = svc.scan(pkg.Request(path, columns=["a"],
                                           tenant="noisy", stream=True,
                                           batch_rows=100), timeout=60)
            rows, victims, sums = 0, [], []
            for i, batch in enumerate(session):
                rows += len(batch["a"])
                sums.append(int(np.asarray(batch["a"]).sum()))
                if i < 8:
                    victims.append(svc.submit(pkg.Request(
                        path, columns=["a"], tenant="victim")))
            assert rows == 8 * 800
            res = [response(t.result(60)) for t in victims]
            stats = svc.serve_stats()
            if stream_yield:
                assert stats["stream_yields"] > 0
            else:
                assert stats["stream_yields"] == 0
            out[pkg.name] = (sums, res[0], stats["stream_batches"],
                             stats["completed"])
        finally:
            svc.close()
    assert out["port"] == out["ref"]


def test_scan_service_auto_arms_spool(tmp_path, monkeypatch):
    monkeypatch.setenv("TPQ_OBS_SPOOL_S", "60")
    path = fleet_file(str(tmp_path / "f.parquet"), seed=1, groups=2,
                      rows=300)
    out = {}
    for pkg in BOTH:
        spool = tmp_path / f"spool_{pkg.name}"
        monkeypatch.setenv("TPQ_OBS_SPOOL", str(spool))
        svc = pkg.Service(concurrency=1, result_cache_mb=0)
        try:
            svc.scan(pkg.Request(path, columns=["a"]), timeout=60)
        finally:
            svc.close()
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith("tpq-spool")]
        roles = {json.load(open(os.path.join(spool, fn)))["role"]
                 for fn in os.listdir(spool) if fn.endswith(".json")}
        assert roles == {"serve"}
        agg = pkg.sv.service.__name__.split(".")[0]
        from importlib import import_module

        fleet = import_module(agg + ".obs_fleet")
        snap = fleet.FleetAggregator(spool_dir=str(spool)).scan()
        assert snap["registry"]["serve"]["submitted"] >= 1
        out[pkg.name] = counts(snap["registry"]["serve"])
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the port's abort verdicts free the read's tensors
# ---------------------------------------------------------------------------

def _tensor_refs(monkeypatch) -> list:
    """Weak references to every staged buffer and every decoded group's
    tensors of the port's device reads."""
    refs = []
    stage = DR._RowGroupStager.stage

    def staged(self, *a, **kw):
        buf = stage(self, *a, **kw)
        refs.append(weakref.ref(buf))
        return buf

    groups = DR.DeviceFileReader.iter_row_groups

    def decoded(self, *a, **kw):
        for g in groups(self, *a, **kw):
            for col in g.values():
                for k in ("values", "indices", "dict_u8", "offsets",
                          "heap"):
                    t = getattr(col, k, None)
                    if t is not None:
                        refs.append(weakref.ref(t))
            yield g

    monkeypatch.setattr(DR._RowGroupStager, "stage", staged)
    monkeypatch.setattr(DR.DeviceFileReader, "iter_row_groups", decoded)
    return refs


@pytest.mark.parametrize("verdict", ["cancel", "deadline", "hang"])
def test_abort_verdict_reaches_the_ticket_without_the_reads_tensors(
        tmp_path, monkeypatch, verdict):
    path = resilience_file(str(tmp_path / "v.parquet"), seed=4, groups=4)
    monkeypatch.setenv("TPQ_FLIGHT", str(tmp_path / "dump.json"))
    with PORT.FileReader(path) as r:
        meta = r.metadata.row_groups[-1].columns[0].meta_data
    last = min(o for o in (meta.dictionary_page_offset,
                           meta.data_page_offset) if o)
    refs = _tensor_refs(monkeypatch)
    stores = []
    stalled = threading.Event()

    def factory(f):
        # the last row group's fetch stalls: the groups before it decode
        # (and sit in the response being built) before the verdict
        def match(offset, size):
            if offset >= last:
                stalled.set()
                return True
            return False

        st = PORT.S.FaultInjectingStore(
            PORT.S.LocalStore(f), PORT.S.FaultSpec(stall_first=1,
                                                   stall_s=30.0,
                                                   match=match),
            config=PORT.S.IOConfig(backoff_ms=0))
        stores.append(st)
        return st

    svc = PORT.Service(concurrency=1, store=factory,
                       hang_s=0.5 if verdict == "hang" else None)
    gc.collect()
    gc.disable()
    try:
        ticket = svc.submit(PORT.Request(
            path, device=True, prefetch=0,
            deadline_s=1.0 if verdict == "deadline" else None))
        assert stalled.wait(30)
        if verdict == "cancel":
            ticket.cancel()
            for st in stores:
                st.release()
        with pytest.raises((PORT.E.CancelledError,
                            PORT.E.DeadlineExceededError,
                            PORT.E.HangError)) as ei:
            ticket.result(60)
        want = {"cancel": "CancelledError",
                "deadline": "DeadlineExceededError",
                "hang": "HangError"}[verdict]
        assert type(ei.value).__name__ == want
        assert ticket._exc is ei.value  # the ticket keeps its verdict
        assert len(refs) > 4, "the read decoded nothing before its verdict"
        dead = [w() is None for w in refs]
        assert all(dead), dead
    finally:
        gc.enable()
        for st in stores:
            st.release()
        svc.close()


def test_flight_snapshot_keeps_no_thread_frames_alive():
    """A hang's flight dump leaves no frame of any thread alive: the port's
    ``FlightRecorder.snapshot`` drops its ``sys._current_frames()`` map,
    which holds the snapshot's own frame (the reference keeps that cycle,
    and with it every thread's frames at the dump, until a collection)."""
    import torch

    def holder(out):
        t = torch.zeros(1024)
        out.append(weakref.ref(t))
        O.flight_recorder().snapshot(reason="frame-cycle-check")

    refs = []
    gc.collect()
    gc.disable()
    try:
        holder(refs)
        assert refs[0]() is None
    finally:
        gc.enable()
