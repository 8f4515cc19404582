"""The port's host pipeline pieces against the JAX package's.

``tpu_parquet_torch.pipeline`` (``prefetch_map``, ``PipelineStats``,
``SharedReader``) and ``tpu_parquet_torch.alloc`` (``InFlightBudget``, the
``AllocTracker`` ledgers) run here beside ``tpu_parquet.pipeline`` and
``tpu_parquet.alloc`` on the same item streams, made from a numpy seed:

- ``prefetch_map``: results in item order under scrambled completion, an
  error raised at its item's position with no ``tpq-prefetch`` thread left,
  cleanup after a consumer ``break``, budget backpressure (the peak under
  the cap, equal to the reference's where it is deterministic), and an
  item larger than the whole budget passing alone without a deadlock;
- ``InFlightBudget``: the oversize item admitted alone, the disabled
  budget, a blocking ``acquire`` woken by a ``release`` from another
  thread;
- ``PipelineStats``: the stage names, ``merge_from``, and ``as_dict()``'s
  keys against the reference's, ``stage_histograms`` included;
- ``SharedReader``: positioned reads on a real file and on ``BytesIO``
  from 8 threads at once.

Everything is compared exactly.
"""

import io
import sys
import threading
import time

import numpy as np
import pytest

from tpu_parquet import alloc as ref_alloc
from tpu_parquet import pipeline as ref_pipeline
from tpu_parquet_torch import alloc, pipeline
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


@pytest.fixture(autouse=True)
def _no_thread_outlives_a_test():
    """No ``tpq-`` thread (the pools and the staging worker) that a test
    started is alive after it."""
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


PACKAGES = [pytest.param((pipeline, alloc), id="port"),
            pytest.param((ref_pipeline, ref_alloc), id="reference")]


def _sleeps(n, seed):
    """Per-item worker delays that scramble the completion order."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 0.01, n)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_prefetch_map_orders_results_as_the_reference(k):
    delays = _sleeps(40, seed=k)
    done = []

    def work(i):
        time.sleep(delays[i])
        done.append(i)
        return i * i

    got = list(pipeline.prefetch_map(range(40), work, k))
    order = list(done)
    done.clear()
    want = list(ref_pipeline.prefetch_map(range(40), work, k))
    assert got == want == [i * i for i in range(40)]
    assert sorted(order) == list(range(40))


def test_prefetch_map_zero_depth_runs_on_the_caller_thread():
    names = []

    def work(i):
        names.append(threading.current_thread().name)
        return i

    assert list(pipeline.prefetch_map(range(5), work, 0)) == list(range(5))
    assert set(names) == {threading.current_thread().name}


@pytest.mark.parametrize("pkgs", PACKAGES)
def test_prefetch_map_error_at_its_position(pkgs):
    pl, _ = pkgs

    def work(i):
        time.sleep(0.002 * (i % 3))
        if i == 5:
            raise ValueError("boom")
        return i

    out = []
    with pytest.raises(ValueError, match="boom"):
        for v in pl.prefetch_map(range(10), work, 3):
            out.append(v)
    assert out == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("pkgs", PACKAGES)
def test_prefetch_map_consumer_break_cleans_up(pkgs):
    pl, al = pkgs
    budget = al.InFlightBudget(100)

    def work(i):
        time.sleep(0.002)
        return i

    for v in pl.prefetch_map(range(100), work, 4, budget=budget,
                             cost=lambda i: 30):
        if v == 3:
            break
    assert budget.held == 0  # every charge of the abandoned window refunded


@pytest.mark.parametrize("cap,cost", [(100, 40), (100, 25), (90, 30)])
def test_prefetch_map_backpressure_matches_the_reference(cap, cost):
    peaks = []
    for pl, al in ((pipeline, alloc), (ref_pipeline, ref_alloc)):
        budget = al.InFlightBudget(cap)
        stats = pl.PipelineStats(prefetch=4, budget_bytes=cap)
        in_flight = []
        lock = threading.Lock()
        most = [0]

        def work(i):
            with lock:
                in_flight.append(i)
                most[0] = max(most[0], len(in_flight))
            time.sleep(0.003)
            with lock:
                in_flight.remove(i)
            return i

        out = list(pl.prefetch_map(range(12), work, 4, budget=budget,
                                   cost=lambda i: cost, stats=stats))
        assert out == list(range(12))
        assert budget.held == 0
        assert budget.peak <= cap
        assert most[0] <= cap // cost
        assert stats.peak_in_flight_bytes == budget.peak
        peaks.append(budget.peak)
    # the window fills to the cap before the first result is taken
    assert peaks[0] == peaks[1] == (cap // cost) * cost


@pytest.mark.parametrize("pkgs", PACKAGES)
def test_prefetch_map_oversize_item_does_not_deadlock(pkgs):
    pl, al = pkgs
    budget = al.InFlightBudget(100)
    costs = [30, 500, 30, 30, 1000, 10]
    out = list(pl.prefetch_map(range(len(costs)), lambda i: i, 3,
                               budget=budget, cost=lambda i: costs[i]))
    assert out == list(range(len(costs)))
    assert budget.held == 0 and budget.peak == 100


@pytest.mark.parametrize("pkgs", PACKAGES)
def test_in_flight_budget_oversize_admitted_alone(pkgs):
    _, al = pkgs
    b = al.InFlightBudget(100)
    b.acquire(1000)  # charged at the cap, with nothing in flight
    assert b.held == 100
    assert not b.try_acquire(1)
    b.release(1000)
    assert b.held == 0
    assert b.try_acquire(60) and not b.try_acquire(60)
    b.release(60)
    assert b.snapshot()["peak"] == 100


@pytest.mark.parametrize("pkgs", PACKAGES)
def test_in_flight_budget_disabled(pkgs):
    _, al = pkgs
    b = al.InFlightBudget(0)
    b.acquire(1 << 40)
    assert b.try_acquire(1 << 40)
    b.release(1 << 40)
    assert b.held == 0 and b.peak == 0


def test_in_flight_budget_blocking_acquire_woken_by_release():
    b = alloc.InFlightBudget(100)
    b.acquire(80)
    got = threading.Event()

    def waiter():
        b.acquire(50)
        got.set()

    t = threading.Thread(target=waiter)
    t.start()
    deadline = time.monotonic() + 5
    while b.snapshot()["waiters"] == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    assert b.snapshot()["waiters"] == 1
    assert not got.is_set()
    b.release(80)
    t.join(timeout=5)
    assert not t.is_alive() and got.is_set()
    assert b.held == 50 and b.peak == 80
    snap = b.snapshot()
    assert snap["waiters"] == 0
    assert (snap["held"], snap["peak"], snap["max_bytes"]) == (50, 80, 100)


def test_alloc_tracker_ledgers_match_the_reference():
    steps = [("register", 40), ("register_transient", 30),
             ("register_device", 500), ("release", 10),
             ("register_device", 200), ("release_device", 500),
             ("register", 25)]
    got, want = alloc.AllocTracker(100), ref_alloc.AllocTracker(100)
    for name, n in steps:
        getattr(got, name)(n)
        getattr(want, name)(n)
        assert got.snapshot() == want.snapshot()
        assert got.device_snapshot() == want.device_snapshot()
    assert got.snapshot() == (55, 70)
    assert got.device_snapshot() == (200, 700)
    with pytest.raises(alloc.MemoryBudgetExceeded) as e:
        got.register_transient(50)
    with pytest.raises(ref_alloc.MemoryBudgetExceeded) as r:
        want.register_transient(50)
    assert str(e.value) == str(r.value)


def test_pipeline_stats_stages_merge_and_keys():
    assert pipeline.STAGES == ref_pipeline.STAGES
    rng = np.random.default_rng(5)
    adds = [(s, float(x)) for s, x in zip(
        rng.choice(pipeline.STAGES, 30), rng.uniform(0, 0.01, 30))]
    got = [pipeline.PipelineStats(prefetch=2, budget_bytes=64)
           for _ in range(2)]
    want = [ref_pipeline.PipelineStats(prefetch=2, budget_bytes=64)
            for _ in range(2)]
    for j, (s, x) in enumerate(adds):
        for st in (got[j % 2], want[j % 2]):
            st.add(s, x)
            st.count_chunk()
            if j % 5 == 0:
                st.count_row_group()
                st.add_stall(x)
    b = alloc.InFlightBudget(1000)
    b.acquire(300)
    got[1].note_peak(b)
    rb = ref_alloc.InFlightBudget(1000)
    rb.acquire(300)
    want[1].note_peak(rb)
    got[0].merge_from(got[1])
    want[0].merge_from(want[1])
    g, w = got[0].as_dict(), want[0].as_dict()
    assert set(g) == set(w)
    for key in g:
        if key not in ("wall_seconds", "overlap_efficiency",
                       "stage_histograms"):
            assert g[key] == w[key], key
    # the histograms hold the same durations: equal counts and buckets
    gh, wh = g["stage_histograms"], w["stage_histograms"]
    assert set(gh) == set(wh)
    for stage in gh:
        assert gh[stage]["count"] == wh[stage]["count"], stage
        assert gh[stage]["buckets"] == wh[stage]["buckets"], stage
    assert g["peak_in_flight_bytes"] == 300
    assert g["chunks"] == 30 and g["row_groups"] == 6
    for s in pipeline.STAGES:
        assert got[0].stage_seconds(s) == pytest.approx(
            want[0].stage_seconds(s), abs=0)
    with pytest.raises(ValueError, match="unknown pipeline stage"):
        got[0].add("parse", 1.0)
    got[0].touch_wall()
    time.sleep(0.002)
    got[0].touch_wall()
    assert got[0].wall_seconds > 0
    assert got[0].overlap_efficiency == pytest.approx(
        got[0].busy_seconds / got[0].wall_seconds)


def _positions(size, n, seed):
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, size, n)
    lens = rng.integers(0, 4096, n)
    return list(zip(offs.tolist(), lens.tolist()))


@pytest.mark.parametrize("kind", ["file", "bytesio"])
def test_shared_reader_from_eight_threads(tmp_path, kind):
    data = np.random.default_rng(3).integers(0, 256, 1 << 18,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "blob.bin"
    path.write_bytes(data)
    f = open(path, "rb") if kind == "file" else io.BytesIO(data)
    try:
        sr = pipeline.SharedReader(f)
        assert sr.parallel == (kind == "file")
        jobs = [_positions(len(data), 200, seed) for seed in range(8)]
        errors = []

        def run(job):
            pf = sr.as_file()
            for off, n in job:
                if sr.pread(off, n) != data[off : off + n]:
                    errors.append((off, n))
                pf.seek(off)
                if pf.read(n) != data[off : off + n]:
                    errors.append((off, n))

        before = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=run, args=(j,)) for j in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(before)
        assert not any(t.is_alive() for t in threads)
        assert errors == []
        # past the end: a short read, as the reference's store gives
        ref = ref_pipeline.SharedReader(f)
        assert sr.pread(len(data) - 10, 100) == ref.pread(len(data) - 10,
                                                          100)
    finally:
        f.close()
