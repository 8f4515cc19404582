"""Run one cell of ``BENCHMARK.json`` once.

Everything a cell is made of is found by name: its configuration in the
file ``BENCHMARK.json`` gives it, its traffic mix as
``<path>/traffic/<name>.json`` and each per-layer metric as
``<path>/metrics/<name>.py`` under the benchmark's ``paths``; the traffic
file's ``kind`` names the module that drives it (``drivers/<kind>.py``),
and the configuration's ``table`` and ``layout`` the modules that draw its
table and write its file (``tables/<table>.py``, ``writers/<layout>.py``).
A configuration, a cell, a mix or a metric is added by adding files and
entries, never by editing one.

A run: the card is checked (no card, or fewer than the cell asks for: exit
non-zero, no result); the table is drawn from the seed and written by the
program's writer in the configuration's layout into a temporary directory,
and its layout is held against the one the configuration pins; the kernels
are built (in the checkout, so only a checkout's first run builds); the
traffic's module warms the cell's shapes; then one window of ``--seconds``
is measured, traced by ``torch.profiler`` with ``--trace 1``.  Once the
window has closed and the program's state is freed, the reference judges
what the window produced.  Last, the process must hold no module of JAX or
of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# whole top-level module names the measured process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_parquet")
# the card's peak bandwidth: H100 SXM HBM3, NVIDIA's data sheet
PEAK_BYTES_PER_S = 3.35e12


class NoResult(Exception):
    """The run cannot give a result (exit non-zero, print none)."""


def cache_dirs(root: str) -> dict:
    """Fixed build and kernel-cache directories inside the checkout."""
    base = os.path.join(root, "build", "pqbench")
    return {"TRITON_CACHE_DIR": os.path.join(base, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "CUDA_CACHE_PATH": os.path.join(base, "cuda_cache")}


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(root: str, bench: dict, folder: str, name: str,
         exts=(".json",)) -> str:
    """``<path>/<folder>/<name><ext>`` under the first of the benchmark's
    ``paths`` that has it."""
    for p in bench["paths"]:
        for ext in exts:
            cand = os.path.join(root, p, folder, name + ext)
            if os.path.isfile(cand):
                return cand
    raise NoResult(f"no {folder} file named {name!r} under {bench['paths']}")


def load_data(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(root: str, bench: dict, name: str):
    path = find(root, bench, "metrics", name, exts=(".py",))
    spec = importlib.util.spec_from_file_location(
        "pqbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_of(name: str):
    """The ``read`` of the metric file ``name`` beside this module: a
    metric split by cell reads as the one it was split from."""
    return load_metric(ROOT, {"paths": [os.path.basename(HERE)]}, name).read


def cell_of(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise NoResult(f"no workload named {workload!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries the cell reports: its end-to-end metrics, or
    with ``trace`` the per-layer metrics that list it (or, without a
    ``workloads`` key, that move an end-to-end metric the cell reports)."""
    ends = [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]
    if not trace:
        return ends
    moved = {m["name"] for m in ends}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules() -> list:
    return sorted(n for n in list(sys.modules)
                  if n.split(".")[0] in FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


class DeviceMemory:
    """The program's device memory over the window, the benchmark's own
    left out: the allocator's peak is read as each stretch of the
    benchmark's own device work begins (:meth:`own`) and reset as it
    ends, once what it allocated is freed.  ``program`` is the highest of
    those readings; ``process`` also takes in the benchmark's work."""

    def __init__(self, device):
        self.device = device
        self.program = self.process = 0

    def start(self) -> None:
        reset_peak(self.device)
        self.program = self.process = peak_bytes(self.device)

    @contextmanager
    def own(self):
        self.program = max(self.program, peak_bytes(self.device))
        try:
            yield
        finally:
            self.process = max(self.process, peak_bytes(self.device))
            reset_peak(self.device)

    def stop(self) -> None:
        now = peak_bytes(self.device)
        self.program = max(self.program, now)
        self.process = max(self.process, now, self.program)


class Context:
    """What a driver is given: the device, the seed, the configuration and
    traffic, the generated table and its file, the host spans, the side
    stream the benchmark's own device work runs on, and the meter of the
    program's device memory."""

    def __init__(self, device, seed, config, traffic, groups, path, layout):
        import torch

        from . import digest, timing

        self.device = device
        self.seed = seed
        self.config = config
        self.traffic = traffic
        self.groups = groups
        self.path = path
        self.layout = layout
        self.spans = timing.Spans()
        self.pos = digest.Positions(device)
        self.memory = DeviceMemory(device)
        self.side = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        self.main = (torch.cuda.current_stream(device) if self.side
                     else None)

    def on_side(self, fn, tensors=()):
        """Run ``fn``'s device work on the side stream, after what the
        caller's stream holds.  The program's stream never waits for it:
        each of the program's ``tensors`` it reads is marked as in use on
        the side stream, so its memory is not reused before the side
        stream is done with it."""
        import torch

        if self.side is None:
            return fn()
        self.side.wait_stream(self.main)
        with torch.cuda.stream(self.side):
            out = fn()
        for t in tensors:
            if t.is_cuda:
                t.record_stream(self.side)
        return out


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="pqbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def open_device(cell: dict):
    """The card the cell runs on, initialised; :class:`NoResult` without
    one, or with fewer cards than the cell asks for.  Never the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoResult("no CUDA device: this benchmark measures the card "
                       "and never falls back to the CPU")
    if torch.cuda.device_count() < int(cell["chips"]):
        raise NoResult(f"{torch.cuda.device_count()} CUDA devices, the "
                       f"cell asks for {cell['chips']}")
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    return torch.device("cuda")


def run(argv, *, root: str = ROOT, t_start: "float | None" = None,
        out=sys.stdout, err=sys.stderr) -> dict:
    """One run; returns the result line's object (also printed).  Raises
    :class:`NoResult` when there is none to give."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = load_benchmark(root)
    cell = cell_of(bench, args.workload)
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_data(os.path.join(root, cfg_entry["file"]))
    traffic = load_data(find(root, bench, "traffic", cell["traffic"]))
    for k, v in cache_dirs(root).items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    split = {}

    import torch

    dev = open_device(cell)
    on_card = dev.type == "cuda"
    t = time.perf_counter()
    split["import_and_init_s"] = t - t_start

    from . import devtrace, tables, timing, write

    groups = tables.load(config["table"]).draw(args.seed, config)
    t1 = time.perf_counter()
    split["draw_s"] = t1 - t
    with tempfile.TemporaryDirectory(prefix="pqbench-") as tmp:
        path = os.path.join(tmp, config["name"] + ".parquet")
        write.write_file(config, groups, path)
        t2 = time.perf_counter()
        split["write_s"] = t2 - t1
        layout = write.file_layout(path)
        diffs = write.layout_differences(config["pinned_layout"], layout)
        if diffs:
            raise NoResult("the file's layout is not the pinned one: "
                           + "; ".join(diffs))
        from tpu_parquet_torch import cuda_kernels, native

        if on_card:
            cuda_kernels.build()
        native.load()
        t3 = time.perf_counter()
        split["build_s"] = t3 - t2

        ctx = Context(dev, args.seed, config, traffic, groups, path, layout)
        kind = traffic["kind"]
        driver = importlib.import_module(f"pqbench.drivers.{kind}").Driver(
            ctx)
        driver.warm()
        sync(dev)
        # what set-up left is collected and frozen, so that the window's
        # collections walk only what the window allocates
        gc.collect()
        gc.freeze()
        t4 = time.perf_counter()
        split["warm_s"] = t4 - t3
        setup_s = t4 - t_start
        peak_setup = peak_bytes(dev)

        # the device's side of a traced run needs the card's profiler; a
        # traced CPU run (the CPU tests) reads the program's counters alone
        trace = (devtrace.DeviceTrace(ctx.side)
                 if args.trace and on_card else None)
        if trace is not None:
            trace.start()
        sync(dev)
        ctx.memory.start()
        host0 = timing.HostClock()
        w0, w0_ns = time.perf_counter(), time.time_ns()
        with GcClock() as gcc:
            driver.window(w0 + args.seconds)
            sync(dev)
            w1, w1_ns = time.perf_counter(), time.time_ns()
        ctx.memory.stop()
        host = host0.since()
        if trace is not None:
            trace.stop()
        gc.unfreeze()
        driver.close()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        host["probe_s"] = timing.host_probe()
        ends = driver.end_to_end(w1 - w0)
        layer = driver.layer()
        spans = driver.labelled_spans()
        checks, attempted, failed = driver.verify()

    found = forbidden_modules()
    if found:
        raise NoResult(f"the process holds {found}: nothing of JAX or of "
                       f"the JAX package may be loaded")
    correct = all(v <= lim if op == "<=" else v >= lim
                  for _n, v, op, lim in checks)
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else dev.type),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": max(peak_setup,
                                            ctx.memory.process)}
    ends["peak_device_mib"] = ctx.memory.program / 2**20
    ends["setup_s"] = setup_s
    result = {"correct": correct, "attempted": attempted, "failed": failed}
    metrics = {}
    tsum = None
    if trace is not None:
        tsum = trace.summary(w0_ns, w1_ns, spans)
        device_info["busy_s"] = tsum["busy_s"]
        device_info["window_s"] = tsum["window_s"]
    if args.trace:
        run_facts = {"layer": layer, "device": tsum, "window_s": w1 - w0,
                     "peak_bytes_per_s": PEAK_BYTES_PER_S}
        for m in cell_metrics(bench, args.workload, True):
            value = load_metric(root, bench, m["name"]).read(run_facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, args.workload, False):
            metrics[m["name"]] = {"value": ends[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if tsum is not None:
        result["breakdown"] = {"device_ops": tsum["device_ops"],
                               "idle_gaps": tsum["idle_gaps"]}
    result["checks"] = {n: {"value": int(v), "limit": f"{op} {lim}"}
                        for n, v, op, lim in checks}
    side = {"setup_split": split, "card": power_limit() if on_card
            else "cpu", "layer": layer, "window_s": w1 - w0,
            "seconds_asked": args.seconds, "gc": gcc.summary(),
            "host": host, "peak_bytes": {"program": ctx.memory.program,
                                         "process": ctx.memory.process}}
    if tsum is not None:
        side["device"] = {k: tsum[k] for k in (
            "busy_s", "program_busy_s", "program_link_s", "events",
            "side_stream_found")}
    print(json.dumps(side, default=float), file=out, flush=True)
    for n, v, op, lim in checks:
        print(f"check {n}: {v} (limit {op} {lim})", file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
    return result


class GcClock:
    """The garbage collector's pauses while it is entered: count and
    seconds per generation (it stops every thread of the process)."""

    def __init__(self):
        self.pauses: dict = {}
        self._t0 = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            n, s = self.pauses.get(info["generation"], (0, 0.0))
            self.pauses[info["generation"]] = (
                n + 1, s + time.perf_counter() - self._t0)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def summary(self) -> dict:
        return {f"gen{g}": {"count": n, "seconds": round(s, 6)}
                for g, (n, s) in sorted(self.pauses.items())}


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_bytes(dev) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def main(argv=None, t_start: "float | None" = None) -> int:
    try:
        run(sys.argv[1:] if argv is None else argv, t_start=t_start)
    except NoResult as e:
        print(f"pqbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    return 0
