#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_parquet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` (CUDA_HOME or /usr/local/cuda) and the
repository checkout beside this script; exits non-zero without them.  It
imports nothing of JAX and nothing of the ``tpu_parquet`` package.

Phases:

1. the card's name and power limit; build of the CUDA kernels from
   ``tpu_parquet_torch/csrc`` (one ``nvcc`` per source, in parallel);
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at edge shapes and at the main path's shapes, with its median time over
   CUDA events (L2 flushed before each launch), its bound, the plain
   version's time and, where one PyTorch call computes the same function,
   that call's time;
3. the main path, REQUIRED: TPC-H SF1 ``lineitem`` (6,001,215 rows, the
   seven fixed-width columns that are not delta-encoded, the generator and
   seed of ``bench.py`` ``gen_lineitem16``) written with the port's writer
   (SNAPPY, dictionary on, page CRCs, 1,000,000 rows per row group), read
   with ``DeviceFileReader(...).iter_row_groups()`` on the card, checked bit
   for bit against the generator, with the kernel launch counts of the read
   and the rows per second of a warm second pass;
4. the main path, OPTIONAL: the same columns written OPTIONAL with no nulls
   (1,000,000 rows), checked the same way;
5. one JSON line listing every ported kernel, then the result line.

Any failure exits non-zero; no phase swallows its own failure.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
SF1_ROWS = 6_001_215
ROWS_PER_GROUP = 1_000_000
# ~2 ms of device spin at H100 clocks: longer than the host takes to
# enqueue any timed call below (the plain versions are tens of tensor ops)
SPIN_CYCLES = 4_000_000
COLUMNS = ["l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax"]


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> "SystemExit":
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return SystemExit(1)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _median_ms(torch, fn, flush, reps: int = 30) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, with the L2 cache
    flushed (a 64 MiB write) before each launch, after 3 warm-up calls.

    The card is kept busy (``torch.cuda._sleep``) while the host enqueues
    the start event, ``fn``'s launches and the end event, so the interval
    is device time and not the host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _bound_ms(nbytes: int) -> float:
    return nbytes / PEAK_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(torch, a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise fail(f"shape/dtype mismatch {a.shape}/{a.dtype} vs "
                   f"{b.shape}/{b.dtype}")
    d = (a.to(torch.int64) - b.to(torch.int64)).abs()
    return int(d.max().item()) if d.numel() else 0


def check_k1(torch, ck, flush, rng, smi: str) -> dict:
    """K1 at every width 1..32 on edge shapes, then timed at the main
    path's shapes (1,048,576 values at widths 6 and 14)."""
    import numpy as np

    dev = torch.device("cuda")
    worst = 0
    checks = 0
    for width in range(1, 33):
        for groups, base in ((1024, 0), (2048, 0), (3000, 7), (1025, 13)):
            gpad = ck.bp_groups_pad(groups)
            nbytes = base + gpad * width + int(rng.integers(0, 9))
            host = rng.integers(0, 256, nbytes, dtype=np.uint8)
            buf = torch.from_numpy(host).to(dev)
            got = ck.unpack_bp_groups(buf, base, width, gpad)
            want = ck.unpack_bp_groups_plain(buf, base, width, gpad)
            err = _max_err(torch, got, want)
            worst = max(worst, err)
            checks += 1
            if err:
                raise fail(f"K1 width {width} groups {groups} base {base}: "
                           f"max abs err {err}")
    torch.cuda.synchronize()
    log(f"K1 unpack_bp_groups: {checks} edge cases bit-exact "
        f"(widths 1..32, tile edges, ragged counts, odd bases)")
    timings = {}
    for width in (6, 14):
        gpad = ck.bp_groups_pad(-(-1_000_000 // 8))
        base = 192
        host = rng.integers(0, 256, base + gpad * width + 64, dtype=np.uint8)
        buf = torch.from_numpy(host).to(dev)
        got = ck.unpack_bp_groups(buf, base, width, gpad)
        want = ck.unpack_bp_groups_plain(buf, base, width, gpad)
        err = _max_err(torch, got, want)
        if err:
            raise fail(f"K1 main-path shape width {width}: max abs err {err}")
        ms = _median_ms(torch, lambda: ck.unpack_bp_groups(buf, base, width,
                                                           gpad), flush)
        plain_ms = _median_ms(
            torch, lambda: ck.unpack_bp_groups_plain(buf, base, width, gpad),
            flush, reps=10)
        moved = gpad * width + gpad * 8 * 4
        timings[width] = dict(ms=ms, plain_ms=plain_ms,
                              bound_ms=_bound_ms(moved), values=gpad * 8,
                              bytes=moved)
        log(f"K1 width {width}: {gpad * 8} values, {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms), bound {_bound_ms(moved):.4f} ms "
            f"({moved} bytes at 3.35 TB/s), "
            f"{moved / (ms * 1e-3) / 1e9:.1f} GB/s ({smi})")
    return dict(worst=worst, timings=timings)


def check_k2(torch, ck, flush, rng, smi: str) -> dict:
    """K2 at widths 4 and 8 with n_valid at and beside tile edges and odd
    bases, then timed on 1M int64 values."""
    import numpy as np

    dev = torch.device("cuda")
    worst = 0
    checks = 0
    for width in (4, 8):
        for count, vbase in ((1024, 0), (1024, 3), (2048, 1), (5000, 64),
                             (4096, 5)):
            count_pad = ck.fused_count_pad(count)
            nbytes = vbase + count_pad * width + int(rng.integers(0, 9))
            host = rng.integers(0, 256, nbytes, dtype=np.uint8)
            buf = torch.from_numpy(host).to(dev)
            for n_valid in {0, 1, count - 1, count, min(count + 1, count_pad),
                            1023, 1024, 1025, count_pad}:
                if not 0 <= n_valid <= count_pad:
                    continue
                got = ck.fused_plain_words(buf, vbase, n_valid, width=width,
                                           count_pad=count_pad)
                want = ck.fused_plain_words_plain(
                    buf, vbase, n_valid, width=width, count_pad=count_pad)
                err = _max_err(torch, got, want)
                worst = max(worst, err)
                checks += 1
                if err:
                    raise fail(f"K2 width {width} count {count} vbase "
                               f"{vbase} n_valid {n_valid}: err {err}")
    torch.cuda.synchronize()
    log(f"K2 fused_plain_words: {checks} edge cases bit-exact "
        f"(widths 4/8, n_valid at and beside tile edges, odd vbase)")
    n = 1_000_000
    count_pad = ck.fused_count_pad(n)
    width = 8
    vals = rng.integers(-(1 << 62), 1 << 62, count_pad)
    out = {}
    for vbase in (0, 3):
        host = np.zeros(vbase + count_pad * width + 64, dtype=np.uint8)
        host[vbase : vbase + count_pad * width] = vals.view(np.uint8)
        buf = torch.from_numpy(host).to(dev)
        got = ck.fused_plain_words(buf, vbase, n, width=width,
                                   count_pad=count_pad)
        want = ck.fused_plain_words_plain(buf, vbase, n, width=width,
                                          count_pad=count_pad)
        err = _max_err(torch, got, want)
        exact = np.array_equal(got.view(torch.int64).reshape(-1)[:n].cpu()
                               .numpy(), vals[:n])
        if err or not exact:
            raise fail(f"K2 1M int64 values at vbase {vbase}: err {err}, "
                       f"matches the generator: {exact}")
        ms = _median_ms(torch, lambda: ck.fused_plain_words(
            buf, vbase, n, width=width, count_pad=count_pad), flush)
        plain_ms = _median_ms(torch, lambda: ck.fused_plain_words_plain(
            buf, vbase, n, width=width, count_pad=count_pad), flush, reps=10)
        out[vbase] = dict(ms=ms, plain_ms=plain_ms, buf=buf)
    moved = 2 * count_pad * width

    def library_call():
        # one PyTorch call computing the same function on an aligned base:
        # a dtype-view copy of the byte slice, then the tail mask
        v = out[0]["buf"][: count_pad * width].view(torch.int64).clone()
        v[n:] = 0
        return v

    lib = library_call()
    if not torch.equal(lib, ck.fused_plain_words(
            out[0]["buf"], 0, n, width=width,
            count_pad=count_pad).view(torch.int64).reshape(-1)):
        raise fail("K2 disagrees with the library yardstick")
    library_ms = _median_ms(torch, library_call, flush)
    for vbase, t in out.items():
        log(f"K2 width 8 vbase {vbase}: {count_pad} values, {t['ms']:.4f} ms "
            f"(plain {t['plain_ms']:.4f} ms), bound {_bound_ms(moved):.4f} ms "
            f"({moved} bytes at 3.35 TB/s), "
            f"{moved / (t['ms'] * 1e-3) / 1e9:.1f} GB/s ({smi})")
    log(f"K2 library yardstick (view copy + tail mask, aligned): "
        f"{library_ms:.4f} ms ({smi})")
    return dict(worst=worst, ms=out[0]["ms"], ms_odd=out[3]["ms"],
                plain_ms=out[0]["plain_ms"], bound_ms=_bound_ms(moved),
                library_ms=library_ms, values=count_pad, bytes=moved)


# ---------------------------------------------------------------------------
# phases 3-4: the main path over TPC-H lineitem
# ---------------------------------------------------------------------------

def gen_lineitem(rows: int, rows_per_group: int = ROWS_PER_GROUP):
    """Yield per-row-group dicts of the seven fixed-width, non-delta
    lineitem columns, drawn exactly as ``bench.py`` ``gen_lineitem16`` draws
    them (seed 4; the draws of the other nine columns are made and dropped
    so that the random stream stays the same)."""
    import numpy as np

    rng = np.random.default_rng(4)
    for lo in range(0, rows, rows_per_group):
        n = min(rows_per_group, rows - lo)
        rng.integers(1, 5, n)                     # l_orderkey deltas
        cols = {
            "l_partkey": rng.integers(1, 200_000, n),
            "l_suppkey": rng.integers(1, 10_000, n),
            "l_linenumber": rng.integers(1, 8, n).astype(np.int32),
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.uniform(900, 105_000, n),
            "l_discount": rng.uniform(0, 0.1, n).round(2),
            "l_tax": rng.uniform(0, 0.08, n).round(2),
        }
        rng.integers(0, 3, n)                     # l_returnflag
        rng.integers(0, 2, n)                     # l_linestatus
        for _ in range(3):                        # ship/commit/receipt dates
            rng.integers(0, 2526, n)
        rng.integers(0, 4, n)                     # l_shipinstruct
        rng.integers(0, 7, n)                     # l_shipmode
        rng.integers(0, 256, n)                   # l_comment
        yield cols


def write_lineitem(path: str, groups, optional: bool) -> float:
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    rep = FRT.OPTIONAL if optional else FRT.REQUIRED
    types = {"l_linenumber": Type.INT32, "l_extendedprice": Type.DOUBLE,
             "l_discount": Type.DOUBLE, "l_tax": Type.DOUBLE}
    schema = build_schema([data_column(c, types.get(c, Type.INT64), rep)
                           for c in COLUMNS])
    t0 = time.perf_counter()
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    use_dictionary=True, write_crc=True,
                    row_group_size=128 << 20) as w:
        for cols in groups:
            w.write_columns(cols)
            w.flush_row_group()
    return time.perf_counter() - t0


def read_main_path(torch, ck, path: str, groups, label: str) -> dict:
    """Read ``path`` on the card through the public entry point, check every
    column bit for bit, and time a warm second pass."""
    import numpy as np

    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_launches()
    with DeviceFileReader(path, columns=COLUMNS) as r:
        outs = list(r.iter_row_groups())
        torch.cuda.synchronize()
        counts = dict(ck.launches)
        st = r.stats().as_dict()
    rows = 0
    decoded = 0
    for rg, want in zip(outs, groups, strict=True):
        for name in COLUMNS:
            col = rg[name]
            got = col.to_host()
            exp = want[name]
            if got.dtype != exp.dtype or not np.array_equal(
                    got.view(np.uint8), exp.view(np.uint8)):
                raise fail(f"{label}: column {name} differs from the "
                           f"generator")
            if col.max_def:
                d, _ = col.levels_to_host()
                if d is None or len(d) != len(exp) or not (d == 1).all():
                    raise fail(f"{label}: def levels of {name} are wrong")
            decoded += got.nbytes
        rows += len(want[COLUMNS[0]])
    del outs
    # warm second pass, timed end to end (host parse + staging + decode)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with DeviceFileReader(path, columns=COLUMNS) as r:
        keep = list(r.iter_row_groups())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        st2 = r.stats().as_dict()
    del keep
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {rows} rows bit-exact against the generator; "
        f"launches {counts}; routes "
        f"{ {k: v['streams'] for k, v in st['ship_routes'].items()} }, "
        f"fused_fallbacks {st['fused_fallbacks']}")
    log(f"{label}: warm pass {seconds:.4f} s = {rows / seconds:.1f} rows/s; "
        f"host {st2['host_seconds']:.4f} s, stage enqueue "
        f"{st2['stage_seconds']:.4f} s, dispatch enqueue "
        f"{st2['dispatch_seconds']:.4f} s; staged {st['staged_bytes']} bytes, "
        f"file {st['compressed_bytes']} bytes, decoded {decoded} bytes, "
        f"max_memory_allocated {peak} bytes")
    return dict(counts=counts, rows=rows, seconds=seconds,
                rows_per_s=rows / seconds, staged=st["staged_bytes"],
                decoded=decoded, peak=peak)


def device_breakdown(torch, path: str, label: str) -> dict:
    """One more read of ``path`` under ``torch.profiler``: device time by
    kernel (and copy), and the device's idle share of the profiled wall.
    The profiler's own host overhead lengthens that wall, so the idle share
    is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with DeviceFileReader(path, columns=COLUMNS) as r:
            keep = list(r.iter_row_groups())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del keep
    by_name = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us:
                by_name[e.key] = (us, e.count)
    busy_s = sum(us for us, _ in by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    if busy_s:
        log(f"{label}: profiled pass {wall:.4f} s wall, device busy "
            f"{busy_s:.6f} s, idle share {1 - busy_s / wall:.4f}")
        for name, (us, n) in top:
            log(f"  device {us / 1e3:.3f} ms in {n} x {name[:70]}")
    else:
        log(f"{label}: device time not measured (the profiler recorded no "
            f"device events)")
    return dict(wall=wall, busy=busy_s)


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpu_parquet_torch")):
        print("chip_smoke: the tpu_parquet_torch package is not beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this script measures the port on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from tpu_parquet_torch import cuda_kernels as ck

    # phase 1: the card and the build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"capability {torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    ck.build()
    log(f"built {sorted(ck.KERNELS)} in {time.perf_counter() - t0:.2f} s "
        f"into {ck.build_dir()}")

    # phase 2: each kernel against its plain version, on the card
    rng = np.random.default_rng(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    k1 = check_k1(torch, ck, flush, rng, smi)
    k2 = check_k2(torch, ck, flush, rng, smi)
    del flush

    # phase 3: main path, REQUIRED lineitem SF1
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    groups = list(gen_lineitem(SF1_ROWS))
    req_path = os.path.join(work, "lineitem_sf1_required.parquet")
    secs = write_lineitem(req_path, groups, optional=False)
    log(f"wrote {req_path}: {SF1_ROWS} rows, {len(groups)} row groups, "
        f"{os.path.getsize(req_path)} bytes in {secs:.2f} s")
    main = read_main_path(torch, ck, req_path, groups, "REQUIRED lineitem")
    for name in ("unpack_bp_groups", "fused_plain_words"):
        if main["counts"][name] <= 0:
            raise fail(f"main path never launched {name}")
    device_breakdown(torch, req_path, "REQUIRED lineitem")

    # phase 4: main path, OPTIONAL lineitem (no nulls), 1M rows
    opt_groups = groups[:1]
    opt_path = os.path.join(work, "lineitem_1m_optional.parquet")
    secs = write_lineitem(opt_path, opt_groups, optional=True)
    log(f"wrote {opt_path}: {ROWS_PER_GROUP} rows in {secs:.2f} s")
    opt = read_main_path(torch, ck, opt_path, opt_groups, "OPTIONAL lineitem")
    if opt["counts"]["unpack_bp_groups"] <= 0:
        raise fail("OPTIONAL path never launched unpack_bp_groups")

    # phase 5: the kernels line and the result line
    t14 = k1["timings"][14]
    kernels = [
        {"name": "unpack_bp_groups", "route": "cuda",
         "source": "tpu_parquet_torch/csrc/bp_unpack.cu",
         "replaces": "tpu_parquet/pallas_kernels.py:93",
         "launches": main["counts"]["unpack_bp_groups"],
         "max_abs_err": k1["worst"], "ms": t14["ms"],
         "plain_ms": t14["plain_ms"], "bound_ms": t14["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "fused_plain_words", "route": "cuda",
         "source": "tpu_parquet_torch/csrc/fused_plain.cu",
         "replaces": "tpu_parquet/pallas_kernels.py:280",
         "launches": main["counts"]["fused_plain_words"],
         "max_abs_err": k2["worst"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": "bytes", "library_ms": k2["library_ms"]},
    ]
    log(f"main path rows/s: REQUIRED {main['rows_per_s']:.1f}, "
        f"OPTIONAL {opt['rows_per_s']:.1f} ({smi})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
