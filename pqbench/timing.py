"""The benchmark's own arithmetic: rates, spreads, host spans and clocks,
and interval unions.  Pure Python, no program import."""

from __future__ import annotations

import math
import resource
import statistics
import threading
import time
from contextlib import contextmanager


def rate(count: float, seconds: float) -> float:
    """Work per second over a window; a window of no length has none."""
    if seconds <= 0:
        raise ValueError("a rate needs a window of some length")
    return count / seconds


def quartile_spread(values) -> float:
    """(third quartile - first quartile) / median, the quartiles as
    ``statistics.quantiles(values, n=4)`` gives them."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def trimmed_spread(values) -> float:
    """:func:`quartile_spread` with the value farthest from the median left
    out (one far-off run in a set does no harm)."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return quartile_spread([v for i, v in enumerate(values) if i != far])


class HostClock:
    """What the host gave this process over a stretch: its CPU seconds in
    user and kernel mode beside the wall clock's."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)

    def since(self) -> dict:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        return {"wall_s": time.perf_counter() - self.t0,
                "user_s": ru.ru_utime - self.ru0.ru_utime,
                "sys_s": ru.ru_stime - self.ru0.ru_stime}


def host_probe(rounds: int = 5) -> float:
    """Seconds of the fastest of ``rounds`` runs of a fixed pure-Python
    loop: the host's speed for this process, beside the window, so that a
    slow run can be told from a slow program."""
    best = math.inf
    for _ in range(rounds):
        t0 = time.perf_counter()
        acc = 0
        for i in range(300_000):
            acc = (acc * 31 + i) & 0xFFFFFFFF
        best = min(best, time.perf_counter() - t0)
    return best


class Spans:
    """Host spans ``(name, start_ns, end_ns)`` on the wall clock the
    profiler's trace uses (``time.time_ns``), kept in memory."""

    def __init__(self):
        self.items: list = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.add(name, t0, time.time_ns())

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((name, t0, t1))


def union(intervals) -> list:
    """Merge ``(start, end)`` intervals into disjoint sorted ones."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def total(intervals) -> float:
    return sum(e - s for s, e in intervals)


def gaps(busy, lo, hi) -> list:
    """The stretches of ``[lo, hi]`` that disjoint sorted ``busy`` leaves
    uncovered."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def attribute(gap_list, labelled, rest: str) -> dict:
    """Seconds of each gap covered by each labelled segment
    ``(label, start_ns, end_ns)``, the segments disjoint; what no segment
    covers goes to ``rest``.  Gaps (disjoint) and segments in nanoseconds,
    the result in seconds."""
    out: dict = {}
    segs = sorted(labelled, key=lambda x: x[1])
    first = 0
    for gs, ge in sorted(gap_list):
        while first < len(segs) and segs[first][2] <= gs:
            first += 1
        covered = 0
        for label, s, e in segs[first:]:
            if s >= ge:
                break
            ov = min(ge, e) - max(gs, s)
            if ov > 0:
                out[label] = out.get(label, 0) + ov
                covered += ov
        if ge - gs - covered > 0:
            out[rest] = out.get(rest, 0) + (ge - gs - covered)
    return {k: v / 1e9 for k, v in out.items()}
