"""The rate, spread and interval arithmetic, and that a stall inside
the window moves the end-to-end metrics."""

import time

import pytest

from pqbench_support import run_cell
from pqbench import timing


def test_rate_and_spread():
    assert timing.rate(300, 2.0) == 150.0
    with pytest.raises(ValueError):
        timing.rate(1, 0.0)
    assert timing.quartile_spread([10, 10, 10, 10]) == 0.0
    v = [9.0, 10.0, 10.0, 11.0]
    q1, med, q3 = (9.25, 10.0, 10.75)
    assert timing.quartile_spread(v) == pytest.approx((q3 - q1) / med)


def test_trimmed_spread_leaves_out_the_farthest_run():
    v = [10.0, 10.2, 9.9, 10.1, 10.0, 14.0]
    assert timing.trimmed_spread(v) == pytest.approx(
        timing.quartile_spread([10.0, 10.2, 9.9, 10.1, 10.0]))
    assert timing.trimmed_spread(v) < timing.quartile_spread(v)


def test_the_host_clock_and_probe():
    clock = timing.HostClock()
    sum(i * i for i in range(200_000))
    got = clock.since()
    assert got["wall_s"] > 0 and got["user_s"] >= 0 and got["sys_s"] >= 0
    assert 0 < timing.host_probe(rounds=1) < 5


def test_the_benchmarks_own_device_memory_is_left_out(monkeypatch):
    from pqbench import harness

    class Allocator:  # the caching allocator's two counters
        now = peak = 0

        def alloc(self, n):
            self.now += n
            self.peak = max(self.peak, self.now)

    a = Allocator()
    monkeypatch.setattr(harness, "peak_bytes", lambda dev: a.peak)
    monkeypatch.setattr(harness, "reset_peak",
                        lambda dev: setattr(a, "peak", a.now))
    a.alloc(100)  # held from set-up
    mem = harness.DeviceMemory(None)
    mem.start()
    a.alloc(400)  # the program's row group
    with mem.own():
        a.alloc(5000)  # the benchmark's digest temporaries
        a.alloc(-5000)
    a.alloc(-400)
    a.alloc(300)  # the next row group
    mem.stop()
    assert mem.program == 500 and mem.process == 5500


def test_union_gaps_and_attribution():
    busy = timing.union([(0, 10), (5, 20), (30, 40)])
    assert busy == [(0, 20), (30, 40)]
    assert timing.total(busy) == 30
    g = timing.gaps(busy, -5, 50)
    assert g == [(-5, 0), (20, 30), (40, 50)]
    spans = [("wait", 18, 25), ("digest", 25, 28)]
    idle = timing.attribute([(x * 10**9, y * 10**9) for x, y in g],
                            [(n, s * 10**9, e * 10**9) for n, s, e in spans],
                            "outside")
    assert idle == {"wait": 5.0, "digest": 3.0, "outside": 17.0}


def test_a_stall_inside_the_window_lowers_rows_per_s(tiny_root,
                                                     monkeypatch):
    from tpu_parquet_torch import device_reader

    plain = run_cell(tiny_root, "lineitem_scan", seconds=3.0)
    real = device_reader.DeviceFileReader.iter_row_groups
    passes = [0]
    stalled = [False]

    def stall_once(self, *a, **k):
        passes[0] += 1  # the first pass warms, the second is in the window
        for out in real(self, *a, **k):
            if passes[0] == 2 and not stalled[0]:
                stalled[0] = True
                time.sleep(2.0)
            yield out

    monkeypatch.setattr(device_reader.DeviceFileReader, "iter_row_groups",
                        stall_once)
    slow = run_cell(tiny_root, "lineitem_scan", seconds=3.0)
    assert stalled[0]
    assert plain["correct"] and slow["correct"]
    assert (slow["metrics"]["rows_per_s"]["value"]
            < 0.7 * plain["metrics"]["rows_per_s"]["value"])
