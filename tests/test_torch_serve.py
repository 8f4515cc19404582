"""The port's scan service and tenancy (``tpu_parquet_torch.serve``) against
the JAX package's, case for case with ``tests/test_serve.py``'s service and
tenancy cases.

The same files (the reference test's ``_write_file``, from its seeds) and
the same sequence of calls go through both packages: the port's
``ScanService(device="cpu")``, the reference's service under
``TPQ_PALLAS=1 TPQ_FUSE=1``.  Held exactly, case by case: every response
bit for bit (host ``ColumnData``; device columns through ``to_host()`` /
``levels_to_host()``), ``ServeStats.as_dict()`` and the registry's
``serve`` / ``tenants`` sections key by key (counts exactly; seconds, the
back-off hint and the racy queue-depth peak by key only), the plan-cache
counters, the ``FairScheduler``'s dispatch order, the parsed tenant specs,
and every typed error's class and text.  Cases whose counts race between
concurrent workers (the 16-client hammer's dictionary lookups) hold the
counts the reference's own test holds.

Held on the port alone, the departures from the reference:

- ``ScanService(device=)``: a ``device=True`` request on a CUDA service
  without a card raises at ``submit()`` and never runs on the CPU;
- a device response never aliases a buffer that a later request reuses;
- ``close()`` leaves no ``tpq-serve`` thread, no budget charge and no
  worker holding a finished response.

Waiting for the port's CLI (``pq_tool``): ``test_serve_stats_cli``,
``test_serve_stats_cli_tenants`` and the ``pq_tool autopsy`` lines of
``test_stalled_request_watchdog_autopsy``; the doctor's verdicts on the
same trees stand in their place.  The scan-plan and ``scan_files`` cases
of ``tests/test_serve.py`` are held by ``test_torch_scanplan.py`` and
``test_torch_plan_cache.py``.
"""

import gc
import re
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from tests.test_serve import _write_file
from tpu_parquet import errors as RE
from tpu_parquet import iostore as RS
from tpu_parquet import obs as RO
from tpu_parquet import serve as RSV
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet.serve import tenancy as RT
from tpu_parquet_torch import errors as E
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch import obs as O
from tpu_parquet_torch import serve as SV
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.serve.result_cache import DEVICE_TENSOR_ATTRS
from tpu_parquet_torch.serve import tenancy as T
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


class _Pkg:
    """One package's serve entry points, driven by the same case code."""

    def __init__(self, name, sv, errors, store, obs, reader, tenancy, dev):
        self.name = name
        self.sv = sv
        self.E = errors
        self.S = store
        self.O = obs
        self.FileReader = reader
        self.T = tenancy
        self.dev = dev  # the service's device argument

    def Service(self, **kw):
        return self.sv.ScanService(**self.dev, **kw)

    def Request(self, *a, **kw):
        return self.sv.ScanRequest(*a, **kw)


PORT = _Pkg("port", SV, E, S, O, FileReader, T, {"device": "cpu"})
REF = _Pkg("ref", RSV, RE, RS, RO, RefReader, RT, {})
BOTH = (REF, PORT)

# the ServeStats keys a run's timing decides: held by key only
TIMED = {"queue_wait_seconds", "exec_seconds", "retry_after_hint_s",
         "queue_depth_peak", "retained_bytes"}


@pytest.fixture(autouse=True)
def _parity_env(io_env, no_reference_crashes):
    """``io_env``: the reference's device reads in Pallas interpret mode,
    no IO knob set, both packages' default fetch engines (process-wide,
    both threads named ``tpq-fetch``) stopped around the test and no
    ``tpq-`` thread left by it; the reference's ``worker_crash`` events
    leave with the test."""
    yield


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_serve")
    return [_write_file(str(d / f"f{i}.parquet"), seed=i) for i in range(3)]


# ---------------------------------------------------------------------------
# comparison helpers (the other serve parity files import these)
# ---------------------------------------------------------------------------

def host_col(cd):
    """A host ColumnData as bytes (values, def levels, rep levels)."""
    v = cd.values
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        vals = (np.asarray(v.offsets).astype(np.int64).tobytes(),
                np.asarray(v.heap).tobytes())
    else:
        vals = (np.asarray(v).tobytes(),)
    return ("host", cd.num_leaf_slots) + vals + tuple(
        None if a is None else np.asarray(a).tobytes()
        for a in (cd.def_levels, cd.rep_levels))


def dev_col(col):
    """A device column through ``to_host()`` / ``levels_to_host()``."""
    v = col.to_host()
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        v = (np.asarray(v.offsets), np.asarray(v.heap))
    else:
        v = (np.asarray(v),)
    return (("dev", col.num_leaf_slots)
            + tuple(x.view(np.uint8).tobytes() for x in v)
            + tuple(None if x is None else np.asarray(x).tobytes()
                    for x in col.levels_to_host()))


def response(res) -> dict:
    """A service response (``{path: {column: column | [parts]}}``) as
    comparable bytes, column order kept."""
    out = {}
    for path, cols in res.items():
        out[path] = [(name, [dev_col(p) if hasattr(p, "to_host")
                             else host_col(p)
                             for p in (v if isinstance(v, list) else [v])])
                     for name, v in cols.items()]
    return out


def counts(tree):
    """A stats tree with its timing-decided values blanked (compared by
    key only)."""
    if isinstance(tree, dict):
        return {k: (None if k in TIMED else counts(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [counts(v) for v in tree]
    return tree


def outcome(fn, collect: bool = True):
    """``("ok", value)`` or the raise's ``(class name, text)``, its
    traceback dropped and, with ``collect``, collected (it holds the
    raising read's frames).  A request's number (``#<n>``, a per-process
    counter of each package) reads ``#<id>``."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — any raise is the finding
        out = (type(e).__name__, re.sub(r"#\d+", "#<id>", str(e)))
    if collect:
        gc.collect()
    return out


def serve_threads() -> set:
    return {t.name for t in threading.enumerate()
            if t.name.startswith(("tpq-serve", "tpq-watchdog"))}


def releasing(stores):
    """A thread that keeps releasing every stalled store (including ones
    made after it starts) until its event is set."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for st in list(stores):
                st.release()
            time.sleep(0.02)

    t = threading.Thread(target=run)
    t.start()
    return stop, t


# ---------------------------------------------------------------------------
# the acceptance hammer: 16 concurrent clients (reference :95)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
def test_concurrent_hammer_bit_identical_and_parsed_once(files, prefetch):
    projections = [None, ["a"], ["s"], ["a", "s"]]
    expect = {}
    for path in files:
        for cols in projections:
            with FileReader(path, columns=cols) as r:
                expect[(path, tuple(cols or ()))] = response(
                    {path: r.read_all()})[path]
    got = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=4, queue_depth=256)
        results, errors = {}, []

        def client(ci, svc=svc, results=results, errors=errors, pkg=pkg):
            try:
                for qi in range(4):
                    path = files[(ci + qi) % len(files)]
                    cols = projections[(ci * 3 + qi) % len(projections)]
                    res = svc.scan(pkg.Request(path, columns=cols,
                                               prefetch=prefetch),
                                   timeout=120)
                    results[(ci, qi)] = ((path, tuple(cols or ())),
                                         response(res)[path])
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        try:
            assert not errors, errors[:2]
            assert len(results) == 64
            for key, cols in results.values():
                assert cols == expect[key]
            c = svc.cache.counters()
            assert c["footer_misses"] == len(files)
            assert c["footer_hits"] == 64 - len(files)
            assert c["plan_misses"] == len(files) * len(projections)
            assert c["plan_hits"] == 64 - len(files) * len(projections)
            assert c["dict_hits"] > 0
            st = svc.serve_stats()
            assert st["completed"] == 64 and st["failed"] == 0
            got[pkg.name] = (results, st["rows"], st["submitted"])
        finally:
            svc.close()
    assert got["port"] == got["ref"]


def test_device_request_matches_host(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            host = svc.scan(pkg.Request(files[0]))[files[0]]
            dev = svc.scan(pkg.Request(files[0], device=True))[files[0]]
            stats = counts(svc.serve_stats())
        a = dev["a"]
        parts = a if isinstance(a, list) else [a]
        got = np.concatenate([np.asarray(p.to_host()) for p in parts])
        np.testing.assert_array_equal(got, host["a"].values)
        out[pkg.name] = (response({"h": host}), response({"d": dev}), stats)
    assert out["port"] == out["ref"]
    # the port's device response is torch tensors on the service's device
    with PORT.Service(concurrency=1) as svc:
        dev = svc.scan(PORT.Request(files[0], device=True))[files[0]]
    for part in (dev["a"] if isinstance(dev["a"], list) else [dev["a"]]):
        tensors = [getattr(part, k) for k in DEVICE_TENSOR_ATTRS
                   if getattr(part, k, None) is not None]
        assert tensors and all(isinstance(t, torch.Tensor)
                               and t.device.type == "cpu" for t in tensors)


def test_row_filter_request(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            got = svc.scan(pkg.Request(files[0], filter="a > 0"))[files[0]]
            got2 = svc.scan(pkg.Request(files[0], filter="a > 0"))[files[0]]
            out[pkg.name] = (response({"a": got}), response({"a": got2}),
                             counts(svc.serve_stats()))
    from tpu_parquet_torch.predicate import parse_filter

    with FileReader(files[0], row_filter=parse_filter("a > 0")) as r:
        want = response({"a": r.read_all()})
    assert out["port"][0] == out["port"][1] == want
    assert out["port"] == out["ref"]


def test_admission_budget_backpressure(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=4, max_memory=1 << 16) as svc:
            tickets = [svc.submit(pkg.Request(files[i % len(files)]))
                       for i in range(8)]
            res = [response(t.result(timeout=120)) for t in tickets]
            st = svc.serve_stats()
            assert st["completed"] == 8
            assert svc._budget.held == 0
            out[pkg.name] = (res, st["rows"], st["submitted"])
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# overload fast-reject, close (reference :182, :226)
# ---------------------------------------------------------------------------

def test_overload_fast_reject(files):
    out = {}
    for pkg in BOTH:
        stores = []

        def factory(f, pkg=pkg, stores=stores):
            st = pkg.S.FaultInjectingStore(
                pkg.S.LocalStore(f), pkg.S.FaultSpec(stall_first=1,
                                                     stall_s=30.0))
            stores.append(st)
            return st

        svc = pkg.Service(concurrency=1, queue_depth=1, store=factory)
        try:
            t1 = svc.submit(pkg.Request(files[0]))
            time.sleep(0.15)
            t2 = svc.submit(pkg.Request(files[1]))
            t0 = time.perf_counter()
            with pytest.raises(pkg.E.OverloadError) as ei:
                svc.submit(pkg.Request(files[2]))
            assert time.perf_counter() - t0 < 1.0
            err = ei.value
            assert err.queue_depth == 1
            assert svc.serve_stats()["rejected"] == 1
            stop, rel = releasing(stores)
            try:
                res = [response(t.result(timeout=120)) for t in (t1, t2)]
            finally:
                stop.set()
                rel.join()
            out[pkg.name] = (type(err).__name__, str(err), err.in_flight,
                             res, counts(svc.serve_stats()))
            del err, ei
        finally:
            for st in stores:
                st.release()
            svc.close()
    assert out["port"] == out["ref"]


def test_close_fails_queued_requests(files):
    out = {}
    for pkg in BOTH:
        stores = []

        def factory(f, pkg=pkg, stores=stores):
            st = pkg.S.FaultInjectingStore(
                pkg.S.LocalStore(f), pkg.S.FaultSpec(stall_first=1,
                                                     stall_s=5.0))
            stores.append(st)
            return st

        svc = pkg.Service(concurrency=1, queue_depth=4, store=factory)
        svc.submit(pkg.Request(files[0]))
        time.sleep(0.1)
        queued = svc.submit(pkg.Request(files[1]))
        stop, rel = releasing(stores)
        try:
            svc.close()
            got = outcome(lambda: queued.result(timeout=30))
            # drained at close, or picked up before the drain: both legal
            assert got[0] in ("ok", "OverloadError")
            if got[0] == "OverloadError":
                assert got[1] == ("scan service closed before this "
                                  "request started")
        finally:
            stop.set()
            rel.join()
        out[pkg.name] = outcome(lambda: svc.submit(pkg.Request(files[0])))
    assert out["port"] == out["ref"] == ("RuntimeError",
                                         "ScanService is closed")


# ---------------------------------------------------------------------------
# stalled request: the watchdog fires for it alone (reference :270)
# ---------------------------------------------------------------------------

def test_stalled_request_watchdog_autopsy(files, tmp_path, monkeypatch):
    out = {}
    for pkg in BOTH:
        dump_path = str(tmp_path / f"serve_hang_{pkg.name}.json")
        monkeypatch.setenv("TPQ_FLIGHT", dump_path)
        stall_target = files[0]
        stores = []

        def factory(f, pkg=pkg, stores=stores, target=stall_target):
            if getattr(f, "name", "") == target:
                st = pkg.S.FaultInjectingStore(
                    pkg.S.LocalStore(f), pkg.S.FaultSpec(stall_first=64,
                                                         stall_s=60.0))
                stores.append(st)
                return st
            return pkg.S.LocalStore(f)

        svc = pkg.Service(concurrency=3, queue_depth=32, store=factory,
                          hang_s=1.0)
        try:
            stuck = svc.submit(pkg.Request(stall_target))
            healthy = [svc.submit(pkg.Request(files[1 + (i % 2)]))
                       for i in range(6)]
            res = [response(t.result(timeout=120)) for t in healthy]
            with pytest.raises(pkg.E.HangError) as ei:
                stuck.result(timeout=120)
            path = ei.value.dump_path
            del ei
            assert path
            import json

            with open(path) as f:
                doc = json.load(f)
            rep = pkg.O.autopsy_dump(doc)
            sv = rep.get("serve")
            assert sv is not None and sv["stuck_request"] is not None
            assert sv["stuck_request"]["path"] == str(stall_target)
            assert rep["verdict"] == "network-stall"
            after = svc.scan(pkg.Request(files[1]), timeout=120)
            assert after[files[1]]["a"].num_leaf_slots > 0
            st = svc.serve_stats()
            out[pkg.name] = (res, rep["verdict"], st["failed"],
                             st["completed"], st["submitted"])
        finally:
            for st in stores:
                st.release()
            svc.close()
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# obs wiring: the registry section, doctor verdicts (reference :505-:568)
# ---------------------------------------------------------------------------

def test_registry_serve_section_and_merge(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            svc.scan(pkg.Request(files[0]))
            tree = svc.obs_registry().as_dict()
        sv = tree["serve"]
        assert sv["submitted"] == 1 and sv["completed"] == 1
        assert sv["cache"]["footer_misses"] == 1
        assert {"serve.queue_wait", "serve.exec", "serve.request"} <= set(
            tree["histograms"])
        other = pkg.O.StatsRegistry()
        other.merge_dict(tree)
        other.merge_dict(tree)
        t2 = other.as_dict()
        assert t2["serve"]["submitted"] == 2
        assert t2["serve"]["queue_depth_peak"] == sv["queue_depth_peak"]
        out[pkg.name] = (counts(sv), counts(t2["serve"]),
                         sorted(tree["histograms"]),
                         tree["histograms"]["serve.request"]["count"])
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("tree", [
    {"pipeline": {"stage_seconds": 0.2, "io_seconds": 0.1,
                  "stall_seconds": 0.0},
     "reader": {}, "serve": {"queue_wait_seconds": 5.0,
                             "exec_seconds": 0.5}},
    {"pipeline": {"stage_seconds": 0.2}, "reader": {}},
], ids=["admission-bound", "no-serve-section"])
def test_doctor_admission_bound(tree):
    rep = O.doctor_registry(tree)
    assert rep == RO.doctor_registry(tree)
    if "serve" in tree:
        assert rep["verdict"] == "admission-bound"
        assert rep["dominant_lane"] == "admission"
    else:
        assert rep["verdict"] == "link-bound"


def test_doctor_verdict_on_a_served_registry(files):
    """In place of ``test_serve_stats_cli`` (the CLI waits for the port's
    ``pq_tool``): the doctor's report on a real service's registry is the
    reference's doctor's on the same tree."""
    with PORT.Service(concurrency=2) as svc:
        for _ in range(3):
            svc.scan(PORT.Request(files[0]))
        tree = svc.obs_registry().as_dict()
    assert tree["serve"]["submitted"] == 3
    assert O.doctor_registry(tree) == RO.doctor_registry(tree)
    # a registry with no serve section gets the same (None) report
    assert O.doctor_registry({"obs_version": 1}) == RO.doctor_registry(
        {"obs_version": 1})


def test_overload_error_is_not_parquet_error():
    for pkg in BOTH:
        assert not issubclass(pkg.E.OverloadError, pkg.E.ParquetError)
        assert not issubclass(pkg.E.OverloadError, IOError)
        assert pkg.E.OverloadError.__mro__[1] is RuntimeError
        e = pkg.E.OverloadError("full", queue_depth=4, in_flight=2)
        assert e.queue_depth == 4 and e.in_flight == 2
        assert e.retry_after_s is None and e.shed_priority is None


def test_service_thread_hygiene(files):
    for pkg in BOTH:
        before = serve_threads()
        svc = pkg.Service(concurrency=3, hang_s=60.0)
        assert {f"tpq-serve-{i}" for i in range(3)} <= serve_threads()
        svc.scan(pkg.Request(files[0]))
        svc.close()
        time.sleep(0.05)
        assert serve_threads() <= before


def test_close_leaves_no_thread_charge_or_response(files):
    """The port's ``close()`` after device requests: no ``tpq-serve``
    thread, no budget charge, and no worker keeping a response alive (the
    worker serves each request in a call of its own)."""
    before = serve_threads()
    svc = PORT.Service(concurrency=2, max_memory=1 << 24)
    res = svc.scan(PORT.Request(files[0], device=True))
    parts = res[files[0]]["a"]
    refs = [weakref.ref(getattr(p, k))
            for p in (parts if isinstance(parts, list) else [parts])
            for k in DEVICE_TENSOR_ATTRS if getattr(p, k, None) is not None]
    assert refs
    del res, parts
    gc.collect()
    assert all(r() is None for r in refs)  # the worker kept nothing
    svc.close()
    assert svc._budget.held == 0
    assert all(t.budget.held == 0 for t in svc.tenants.tenants().values())
    assert serve_threads() <= before


# ---------------------------------------------------------------------------
# the device: departures from the reference
# ---------------------------------------------------------------------------

def test_device_request_without_a_card_raises_at_submit(files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = SV.ScanService(concurrency=1)  # device None: "cuda"
    try:
        assert svc.device == torch.device("cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.submit(SV.ScanRequest(files[0], device=True))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            svc.submit(SV.ScanRequest(files[0], columns=["a"], stream=True,
                                      device=True))
        st = svc.serve_stats()
        assert st["submitted"] == 0 and st["rejected"] == 0
        # a host request needs no card
        res = svc.scan(SV.ScanRequest(files[0]))
        assert isinstance(res[files[0]]["a"].values, np.ndarray)
    finally:
        svc.close()
    with SV.ScanService(concurrency=1, device="meta") as svc:
        with pytest.raises(ValueError, match="unsupported device"):
            svc.submit(SV.ScanRequest(files[0], device=True))


def test_device_response_never_aliases_a_later_request(files):
    with PORT.Service(concurrency=1, result_cache_mb=64,
                      result_cache_hbm_mb=64) as svc:
        first = svc.scan(PORT.Request(files[0], device=True))
        want = response(first)
        # other files, other projections, a warm repeat: the first
        # response's tensors keep their bytes
        for path in files[1:]:
            svc.scan(PORT.Request(path, device=True))
            svc.scan(PORT.Request(path, columns=["a"], device=True))
        warm = svc.scan(PORT.Request(files[0], device=True))
        assert response(first) == want == response(warm)


# ---------------------------------------------------------------------------
# multi-tenant QoS (reference :596-:816)
# ---------------------------------------------------------------------------

def test_fair_scheduler_drr_and_fifo():
    out = {}
    for pkg in BOTH:
        q = pkg.T.FairScheduler(64, fair=True)
        for i in range(3):
            q.put_nowait("noisy", 1, f"n{i}")
        for i in range(3):
            q.put_nowait("victim", 3, f"v{i}")
        order = [q.get() for _ in range(6)]
        assert order.index("v0") <= 1 and order.index("v2") <= 4, order
        fifo = pkg.T.FairScheduler(64, fair=False)
        fifo.put_nowait("noisy", 1, "n0")
        fifo.put_nowait("victim", 3, "v0")
        fifo.put_nowait("noisy", 1, "n1")
        fifo_order = [fifo.get() for _ in range(3)]
        assert fifo_order == ["n0", "v0", "n1"]
        # a longer mixed run with requeues, depths and sentinels
        q = pkg.T.FairScheduler(8, fair=True)
        log = []
        for i in range(8):
            q.put_nowait(("a", "b", "c")[i % 3], (2, 1, 3)[i % 3], i)
        try:
            q.put_nowait("a", 2, 99)
        except Exception as e:  # noqa: BLE001
            log.append(type(e).__name__)
        log.append(q.tenant_depths())
        for _ in range(4):
            log.append(q.get())
        q.requeue("b", 1, "rq")
        log.append(q.has_other_waiters("b"))
        q.put_sentinel()
        log.append(q.get())
        log.append(q.drain())
        log.append(q.qsize())
        out[pkg.name] = (order, fifo_order, log)
    assert out["port"] == out["ref"]


def test_fair_share_protects_victim_p99(files):
    """The port alone against the reference test's bars (the reference's
    own run of this timing case is ``tests/test_serve.py``'s): fair share
    holds the victim within 2x its isolated p99, FIFO does not, and both
    tenants' books are kept apart.  The tenants subtree's keys and counts
    are held against the reference's in
    ``test_registry_tenants_subtree_and_merge``."""
    lat, noisy_n, path = 0.012, 12, files[0]

    def mk(fair):
        svc = PORT.Service(
            concurrency=1, queue_depth=64, fair=fair, result_cache_mb=0,
            store=lambda f: S.FaultInjectingStore(
                S.LocalStore(f), S.FaultSpec(latency_s=lat),
                config=S.IOConfig(backoff_ms=1.0)))
        svc.register_tenant("victim", weight=4)
        svc.register_tenant("noisy", weight=1)
        svc.scan(PORT.Request(path, tenant="victim"), timeout=60)
        return svc

    def victim_p99(svc, flood):
        tickets = [svc.submit(PORT.Request(path, columns=["a"],
                                           tenant="noisy"))
                   for _ in range(noisy_n if flood else 0)]
        walls = []
        for _ in range(4):
            t0 = time.perf_counter()
            svc.scan(PORT.Request(path, tenant="victim"), timeout=60)
            walls.append(time.perf_counter() - t0)
        for t in tickets:
            t.result(60)
        return max(walls)

    for _attempt in range(3):
        svc = mk(True)
        iso = victim_p99(svc, flood=False)
        svc.close()
        svc = mk(True)
        fair = victim_p99(svc, flood=True)
        tstats = svc.serve_stats()["tenants"]
        svc.close()
        svc = mk(False)
        fifo = victim_p99(svc, flood=True)
        svc.close()
        if fair <= 2.0 * iso < fifo:
            break
    assert fair <= 2.0 * iso, (iso, fair, fifo)
    assert fifo > 2.0 * iso, (iso, fair, fifo)
    assert tstats["victim"]["submitted"] == 5
    assert tstats["noisy"]["submitted"] == noisy_n
    assert tstats["victim"]["completed"] == 5
    assert tstats["noisy"]["completed"] == noisy_n


def test_tenant_budget_slices_and_shed_accounting(files):
    out = {}
    for pkg in BOTH:
        svc = pkg.Service(concurrency=1, queue_depth=1, max_memory=1 << 20)
        try:
            svc.register_tenant("gold", weight=3)
            svc.register_tenant("bronze", weight=1)
            slices = {n: t.budget.max_bytes
                      for n, t in svc.tenants.tenants().items()}
            assert slices["gold"] == 3 * slices["bronze"]
            plug = svc.submit(pkg.Request(files[0], tenant="gold"))
            shed = None
            for _ in range(12):
                try:
                    svc.submit(pkg.Request(files[0], tenant="bronze"))
                except pkg.E.OverloadError as e:
                    shed = (type(e).__name__, str(e), e.queue_depth,
                            e.shed_priority, e.retry_after_s > 0)
                    break
            plug.result(60)
            assert shed is not None and "bronze" in shed[1]
            st = svc.serve_stats()
            assert st["tenants"]["bronze"]["rejected"] >= 1
            assert st["tenants"]["gold"]["rejected"] == 0
            assert st["retry_after_hint_s"] > 0
            # the in-flight count in the text races the plug's pickup
            out[pkg.name] = (slices, shed[0], shed[1].split(" (")[0],
                             shed[1].split("; ")[-1], shed[2:],
                             counts(st["tenants"]["gold"]))
        finally:
            svc.close()
    assert out["port"] == out["ref"]


def test_registry_tenants_subtree_and_merge(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            svc.register_tenant("team-a", weight=2, slo_p99_ms=50.0)
            svc.scan(pkg.Request(files[0], tenant="team-a"))
            svc.scan(pkg.Request(files[0]))
            tree = svc.obs_registry().as_dict()
        sv = tree["serve"]
        ta = sv["tenants"]["team-a"]
        assert ta["submitted"] == ta["completed"] == 1
        assert ta["weight"] == 2 and ta["slo_p99_ms"] == 50.0
        assert {"rejected", "sheds", "cache_held_bytes", "budget_bytes",
                "rows"} <= set(ta)
        assert sv["tenants"]["default"]["submitted"] == 1
        assert "serve.tenant.team-a" in tree["histograms"]
        other = pkg.O.StatsRegistry()
        other.merge_dict(tree)
        other.merge_dict(tree)
        t2 = other.as_dict()["serve"]["tenants"]
        assert t2["team-a"]["submitted"] == 2 and t2["team-a"]["weight"] == 2
        out[pkg.name] = (counts(sv["tenants"]), counts(t2),
                         sorted(tree["histograms"]))
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("rejected", [5, "below"])
def test_doctor_overload_names_offending_tenant(rejected):
    tree = {
        "pipeline": {"io_seconds": 1.0}, "reader": {},
        "serve": {
            "queue_wait_seconds": 0.2, "rejected": 5,
            "sheds": {"low": 2, "normal": 0}, "retry_after_hint_s": 0.4,
            "tenants": {
                "noisy": {"submitted": 50, "rejected": 1},
                "victim": {"submitted": 2, "rejected": 4},
            },
        },
    }
    if rejected == "below":
        tree["serve"]["rejected"] = O.OVERLOAD_MIN_REJECTS - 1 - 2
        assert O.OVERLOAD_MIN_REJECTS == RO.OVERLOAD_MIN_REJECTS
    rep = O.doctor_registry(tree)
    assert rep == RO.doctor_registry(tree)
    if rejected == "below":
        assert "overload" not in rep
    else:
        ov = rep["overload"]
        assert ov["offending_tenant"] == "noisy"
        assert ov["victims"] == ["victim"]


def test_doctor_verdict_on_a_tenant_registry(files):
    """In place of ``test_serve_stats_cli_tenants`` (the CLI waits for the
    port's ``pq_tool``): a tenant and a stream through the port's service,
    and both doctors' reports on its tree."""
    with PORT.Service(concurrency=1) as svc:
        svc.register_tenant("team-a", weight=2, slo_p99_ms=75.0)
        svc.scan(PORT.Request(files[0], tenant="team-a"))
        list(svc.scan(PORT.Request(files[0], stream=True, batch_rows=256)))
        tree = svc.obs_registry().as_dict()
    assert tree["serve"]["stream_sessions"] == 1
    assert tree["serve"]["tenants"]["team-a"]["slo_p99_ms"] == 75.0
    assert "serve.tenant.team-a" in tree["histograms"]
    assert O.doctor_registry(tree) == RO.doctor_registry(tree)


def test_tenant_env_spec(monkeypatch):
    specs = ["a=3, b=1,junk,c=x,=9,", "gold=4:2.5,slow=1:x,neg=2:-1", "",
             None, "x=0,y=-3:0"]
    for spec in specs:
        assert T.parse_tenant_spec(spec) == RT.parse_tenant_spec(spec)
        assert T.tenant_table(spec) == RT.tenant_table(spec)
    assert T.parse_tenant_spec("a=3, b=1,junk,c=x,=9,") == {
        "a": (3, None), "b": (1, None), "junk": (1, None), "c": (1, None)}
    monkeypatch.setenv("TPQ_SERVE_TENANTS", "gold=4,bronze=1")
    for pkg in BOTH:
        reg = pkg.T.TenantRegistry(max_memory=6 << 20)
        assert reg.get("gold").weight == 4
        assert reg.get("gold").budget.max_bytes == 4 * (1 << 20)
    assert (T.TenantRegistry(max_memory=6 << 20).as_dict()
            == RT.TenantRegistry(max_memory=6 << 20).as_dict())
    monkeypatch.setenv("TPQ_SERVE_FAIR", "0")
    for pkg in BOTH:
        assert not pkg.T.fair_enabled(None)
        assert pkg.T.fair_enabled(True)


def test_tenants_kwarg_coercion(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1,
                         tenants={"gold": 3, "bronze": 1}) as svc:
            svc.scan(pkg.Request(files[0], tenant="gold"))
            svc.scan(pkg.Request(files[0]))
            tens = svc.obs_registry().as_dict()["serve"]["tenants"]
        assert tens["gold"]["weight"] == 3
        assert tens["gold"]["submitted"] == 1
        with pkg.Service(concurrency=1, tenants="gold=3,bronze=1") as svc:
            assert svc.tenants.get("gold").weight == 3
        err = outcome(lambda: pkg.Service(concurrency=1, tenants=42))
        assert err[0] == "TypeError" and "tenants=" in err[1]
        out[pkg.name] = (counts(tens), err)
    assert out["port"] == out["ref"]


def test_doctor_overload_on_serve_only_registry():
    trees = [
        {"serve": {"rejected": 6, "sheds": {"low": 0, "normal": 0},
                   "tenants": {"hog": {"submitted": 25, "rejected": 0},
                               "v": {"submitted": 1, "rejected": 6}}}},
        {"serve": {"rejected": 1}},
    ]
    rep = O.doctor_registry(trees[0])
    assert rep == RO.doctor_registry(trees[0])
    assert "lanes" not in rep
    assert rep["overload"]["offending_tenant"] == "hog"
    assert O.doctor_registry(trees[1]) is None
    assert RO.doctor_registry(trees[1]) is None


def test_serve_all_is_the_references():
    assert SV.__all__ == RSV.__all__
    assert T.__all__ == RT.__all__
    for name in SV.__all__:
        assert hasattr(SV, name), name
    assert (SV.PRIORITY_LOW, SV.PRIORITY_NORMAL, SV.PRIORITY_HIGH) == (
        RSV.PRIORITY_LOW, RSV.PRIORITY_NORMAL, RSV.PRIORITY_HIGH)
    from tpu_parquet.serve import service as RSVC
    from tpu_parquet_torch.serve import service as SVC

    assert SVC.__all__ == RSVC.__all__
    assert ([c.__name__ for c in SVC._CLASSIFIED_FAILURES]
            == [c.__name__ for c in RSVC._CLASSIFIED_FAILURES])
    assert (sorted(SV.ServeStats().as_dict())
            == sorted(RSV.ServeStats().as_dict()))
