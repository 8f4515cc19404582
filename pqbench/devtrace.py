"""The device's side of a traced run, from ``torch.profiler``'s trace.

Only device activity is recorded (kernels, copies, sets), so tracing costs
the program little; the host side is the benchmark's own spans
(:class:`pqbench.timing.Spans`), on the same wall clock as the trace.  The
benchmark's digests run on a stream of their own, found in the trace by a
marker kernel launched on it, so the program's device time can be told
from the benchmark's.
"""

from __future__ import annotations

import torch

from . import timing

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel
NAME_CHARS = 120  # of a device operation's name in the breakdown


class DeviceTrace:
    def __init__(self, side_stream):
        self.side = side_stream
        self._prof = None
        self.events: list = []  # (start_ns, end_ns, name, stream)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.cuda.stream(self.side):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = e.start_ns()
            self.events.append((s, s + e.duration_ns(), e.name(),
                                e.device_resource_id()))
        self._prof = None

    def summary(self, w0: int, w1: int, labelled: list,
                rest: str = "outside_spans") -> dict:
        """Over the window ``[w0, w1]`` (ns): device busy seconds of every
        operation and of the program's alone (the benchmark's stream left
        out), and the breakdown: the ten device operations that took most
        time, and the idle time attributed to the host spans ``labelled``
        (``(label, start_ns, end_ns)``, disjoint)."""
        side = {s for _a, _b, name, s in self.events if MARKER in name}
        inside = [(max(a, w0), min(b, w1), name, s)
                  for a, b, name, s in self.events if b > w0 and a < w1]
        busy_all = timing.union((a, b) for a, b, _n, _s in inside)
        busy_prog = timing.union((a, b) for a, b, _n, s in inside
                                 if s not in side)
        # the program's time in host<->device copies (over the link)
        link_prog = timing.union((a, b) for a, b, n, s in inside
                                 if s not in side and n.startswith("Memcpy")
                                 and ("HtoD" in n or "DtoH" in n))
        by_name: dict = {}
        for a, b, name, _s in inside:
            key = name[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = timing.attribute(timing.gaps(busy_all, w0, w1), labelled,
                                rest)
        top_idle = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": timing.total(busy_all) / 1e9,
            "program_busy_s": timing.total(busy_prog) / 1e9,
            "program_link_s": timing.total(link_prog) / 1e9,
            "device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in top_idle],
            "events": len(inside),
            "side_stream_found": bool(side),
        }
