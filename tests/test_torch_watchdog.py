"""The port's hang watchdog, flight recorder, autopsy and doctor against the
JAX package's.

A store that stalls on its third fetch (``FaultSpec(stall_first=1)`` on the
third range it is asked for) is read by both packages' device readers with
``hang_s`` and ``hang_policy="raise"``, sequentially and at prefetch 4,
threaded and through the fetch engine: both raise ``HangError`` naming a
flight dump, the dumps give the same reason, ``autopsy_dump`` names a
``network-stall`` with the same stalled range in both, and both packages'
``doctor_registry`` give the same verdicts on each reader's registry tree
(the verdicts rest on lane seconds, so the two runs' trees are not held to
one verdict).  Then the cases
the IO layer's port left out: ``scan_files`` under one watchdog, a healthy
consumer that pauses between groups never firing it, the budget's
``abort`` waking a blocked submitter, the doctor's ``io-concurrency-bound``
verdicts and the engine section of the reader's registry.  No watchdog,
sampler or device-lane thread outlives a reader's ``close()``.
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from tpu_parquet import device_reader as RDR
from tpu_parquet import iostore as RS
from tpu_parquet import obs as RO
from tpu_parquet.errors import HangError as RefHangError
from tpu_parquet.iostore_async import \
    shutdown_default_engine as ref_shutdown_engine
from tpu_parquet_torch import obs as PO
from tpu_parquet_torch.alloc import InFlightBudget
from tpu_parquet_torch.device_reader import DeviceFileReader, scan_files
from tpu_parquet_torch.errors import HangError
from tpu_parquet_torch.format import (CompressionCodec,
                                     FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                       IOConfig, LocalStore)
from tpu_parquet_torch.iostore_async import shutdown_default_engine
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


HANG_S = 0.3


def _write_file(path, groups=3, rows=400, seed=0):
    schema = build_schema([data_column("a", Type.INT64, FRT.REQUIRED),
                           data_column("b", Type.INT64, FRT.REQUIRED)])
    rng = np.random.default_rng(seed)
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY) as w:
        for _ in range(groups):
            w.write_columns({"a": rng.integers(0, 1 << 30, rows),
                             "b": rng.integers(0, 1 << 30, rows)})
            w.flush_row_group()
    return path


def _third_fetch():
    """A ``FaultSpec.match`` true for the third range a store is asked
    for, and only it."""
    seen = []
    lock = threading.Lock()

    def match(offset, size):
        with lock:
            seen.append(offset)
            return len(seen) == 3

    return match


def _stall_factory(pkg, stores):
    def make(f):
        st = pkg.FaultInjectingStore(
            pkg.LocalStore(f),
            pkg.FaultSpec(stall_first=1, stall_s=60.0, match=_third_fetch()),
            config=pkg.IOConfig(retries=0, backoff_ms=1.0))
        stores.append(st)
        return st

    return make


class _Port:
    FaultInjectingStore, FaultSpec = FaultInjectingStore, FaultSpec
    IOConfig, LocalStore = IOConfig, LocalStore


def _obs_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("tpq-sampler", "tpq-watchdog",
                                  "tpq-devtimer"))]


@pytest.fixture
def env(monkeypatch, tmp_path):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    monkeypatch.delenv("TPQ_TRACE", raising=False)
    # a dump of an unexpected fire lands here, never in the working tree
    monkeypatch.setenv("TPQ_FLIGHT", str(tmp_path / "flight.json"))
    yield monkeypatch
    shutdown_default_engine()
    ref_shutdown_engine()


def _hang(make_reader, pkg, dump, monkeypatch, hang_error):
    """Read until the watchdog raises; returns (error, dump document,
    registry tree, seconds to the raise)."""
    monkeypatch.setenv("TPQ_FLIGHT", dump)
    stores = []
    r = make_reader(_stall_factory(pkg, stores))
    t0 = time.monotonic()
    try:
        with pytest.raises(hang_error) as ei:
            for _ in r.iter_row_groups():
                pass
        took = time.monotonic() - t0
        tree = r.obs_registry().as_dict()
    finally:
        for st in stores:
            st.release()
        r.close()
    e = ei.value
    assert e.dump_path and os.path.exists(e.dump_path)
    with open(e.dump_path) as f:
        doc = json.load(f)
    return e, doc, tree, took


@pytest.mark.parametrize("engine", ["0", "1"])
@pytest.mark.parametrize("prefetch", [0, 4])
def test_stalled_third_fetch_raises_hang_as_the_reference(tmp_path, env,
                                                          prefetch, engine):
    env.setenv("TPQ_IO_ASYNC", engine)
    path = _write_file(str(tmp_path / "stall.parquet"))
    e, doc, tree, took = _hang(
        lambda st: DeviceFileReader(path, device="cpu", prefetch=prefetch,
                                    max_memory=1 << 20, hang_s=HANG_S,
                                    hang_policy="raise", store=st),
        _Port, str(tmp_path / "port_dump.json"), env, HangError)
    re_, rdoc, rtree, _ = _hang(
        lambda st: RDR.DeviceFileReader(path, prefetch=prefetch,
                                        max_memory=1 << 20, hang_s=HANG_S,
                                        hang_policy="raise", store=st),
        RS, str(tmp_path / "ref_dump.json"), env, RefHangError)
    assert took < HANG_S + 2.0
    assert doc["reason"] == rdoc["reason"]
    assert doc["watchdog"]["hang_s"] == rdoc["watchdog"]["hang_s"]
    rep, rrep = PO.autopsy_dump(doc), RO.autopsy_dump(rdoc)
    assert rep["verdict"] == rrep["verdict"] == "network-stall"
    assert rep["io"] is not None and rep["io"]["size"] > 0
    assert str(rep["io"]["offset"]) in rep["probable_cause"]
    # the same file, the same stalled range
    assert (rep["io"]["offset"], rep["io"]["size"]) == (
        rrep["io"]["offset"], rrep["io"]["size"])
    # the doctor's verdicts rest on lane seconds, which differ run to run:
    # both packages' doctors give the same verdicts on each tree
    assert PO.doctor_registry(tree) == RO.doctor_registry(tree)
    assert PO.doctor_registry(rtree) == RO.doctor_registry(rtree)
    assert PO.doctor_registry(tree)["verdict"] is not None
    # the dump embeds the live readers' merged registry, as the reference's
    assert doc["registry"] is not None and rdoc["registry"] is not None
    assert set(doc["registry"]) == set(rdoc["registry"])
    assert not _obs_threads()


def test_scan_files_one_watchdog_over_every_file(tmp_path, env):
    env.setenv("TPQ_FLIGHT", str(tmp_path / "scan_dump.json"))
    paths = [_write_file(str(tmp_path / f"f{i}.parquet"), seed=i)
             for i in range(2)]
    stores = []
    got = []
    with pytest.raises(HangError) as ei:
        for g in scan_files(paths, device="cpu", prefetch=2, hang_s=HANG_S,
                            hang_policy="raise",
                            store=_stall_factory(_Port, stores)):
            got.append(g)
    for st in stores:
        st.release()
    with open(ei.value.dump_path) as f:
        assert PO.autopsy_dump(json.load(f))["verdict"] == "network-stall"
    assert not _obs_threads()


def test_healthy_consumer_pausing_between_groups_never_fires(tmp_path, env):
    """The consumer lane: a consumer away between groups for longer than
    ``hang_s`` is no hang.  The deadline is wide against the work (a
    400-row group, the path warmed first) so a loaded machine's slow
    group never reads as one."""
    path = _write_file(str(tmp_path / "ok.parquet"), groups=2)
    for _ in DeviceFileReader(path, device="cpu").iter_row_groups():
        pass
    r = DeviceFileReader(path, device="cpu", prefetch=2, hang_s=2.0,
                         hang_policy="raise")
    time.sleep(2.5)  # built long before its first scan: the idle gate
    assert not r._watchdog.fired
    n = 0
    for _ in r.iter_row_groups():
        time.sleep(2.5)  # the consumer is away: no lane advances
        n += 1
    assert n == 2 and not r._watchdog.fired
    r.close()
    assert not _obs_threads()


def test_budget_abort_wakes_a_blocked_submitter():
    b = InFlightBudget(100)
    b.acquire(100)
    box = {}

    def submit():
        try:
            b.acquire(50)
        except HangError as e:
            box["e"] = e

    t = threading.Thread(target=submit)
    t.start()
    deadline = time.monotonic() + 5
    while b.snapshot()["waiters"] == 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    snap = b.snapshot()
    assert snap["waiters"] == 1 and snap["longest_wait_s"] >= 0
    b.abort(HangError("stuck", dump_path="x.json"))
    t.join(5)
    assert box["e"].dump_path == "x.json"
    with pytest.raises(HangError):
        b.acquire(50)  # poisoned for good


def _io_tree(*, peak, cap, qw, fs, prefetch=4, io_s=10.0, decomp_s=1.0):
    return {
        "pipeline": {"io_seconds": io_s, "decompress_seconds": decomp_s,
                     "recompress_seconds": 0.0, "stage_seconds": 0.5,
                     "stall_seconds": 0.0, "prefetch": prefetch},
        "reader": {},
        "io": {"engine": {"submitted": 300, "completed": 300, "failed": 0,
                          "inflight": 0, "inflight_peak": peak,
                          "inflight_cap": cap, "queue_wait_seconds": qw,
                          "fetch_seconds": fs}},
    }


@pytest.mark.parametrize("case", [
    dict(peak=256, cap=256, qw=50.0, fs=12.0),
    dict(peak=5, cap=256, qw=0.0, fs=12.0, prefetch=4),
    dict(peak=256, cap=256, qw=50.0, fs=12.0, io_s=1.0, decomp_s=20.0),
    dict(peak=256, cap=256, qw=1.0, fs=12.0),
    dict(peak=64, cap=256, qw=50.0, fs=12.0),
])
def test_doctor_io_concurrency_verdicts_equal_the_reference(case):
    tree = _io_tree(**case)
    rep = PO.doctor_registry(tree)
    assert rep == RO.doctor_registry(tree)
    if case["peak"] == 256 and case["qw"] == 50.0 and "io_s" not in case:
        assert rep["io_concurrency"]["verdict"] == "io-concurrency-bound"
        assert rep["io_concurrency"]["knob"] == "TPQ_IO_INFLIGHT"


def test_engine_section_in_reader_registry(tmp_path, env):
    env.setenv("TPQ_IO_ASYNC", "1")
    path = _write_file(str(tmp_path / "eng.parquet"))
    store = (lambda f: FaultInjectingStore(
        LocalStore(f), FaultSpec(latency_s=0.001),
        config=IOConfig(retries=2, backoff_ms=1.0)))
    with FileReader(path, prefetch=4, store=store) as r:
        for _ in r.iter_row_groups():
            pass
        tree = r.obs_registry().as_dict()
    eng = tree["io"]["engine"]
    assert eng["submitted"] > 0 and eng["inflight_cap"] >= 1
    assert "io.queue_wait" in tree["histograms"]


def test_flight_dump_carries_budgets_trackers_and_sources(tmp_path, env):
    """A dump taken mid-scan holds the live budget, the reader's tracker,
    the pipeline's lanes and the reader's registry tree."""
    path = _write_file(str(tmp_path / "dump.parquet"))
    r = DeviceFileReader(path, device="cpu", prefetch=2,
                         max_memory=1 << 20)
    it = r.iter_row_groups()
    next(it)
    out = str(tmp_path / "explicit.json")
    PO.flight_recorder().dump(path=out, reason="explicit")
    it.close()
    r.close()
    with open(out) as f:
        doc = json.load(f)
    assert doc["reason"] == "explicit"
    assert doc["budgets"] and doc["trackers"]
    assert any(k.startswith("pipeline[") for k in doc["samples"])
    assert doc["registry"]["reader"]["row_groups"] >= 1
    assert PO.autopsy_dump(doc)["verdict"]
