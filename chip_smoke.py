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
   at edge shapes and at each shape the main path launches it at, with its
   median time over CUDA events (L2 flushed before each launch; the time
   of a near-empty launch measured the same way is printed first), its
   time per launch over 50 back-to-back launches (warm L2, no floor), its
   bound, the plain version's time and, where one PyTorch call computes
   the same function, that call's time and the ratio (K3 and the fused K1
   have none: their yardstick is the unfused chain they replace, timed on
   the same stream).  The fused K1's main-path shapes are SF1 row group
   0's dictionary-index streams, planned by the port's own host code;
3. the main path, REQUIRED: TPC-H SF1 ``lineitem`` (6,001,215 rows, the
   seven fixed-width columns that are not delta-encoded, the generator and
   seed of ``bench.py`` ``gen_lineitem16``) written with the port's writer
   (SNAPPY, dictionary on, page CRCs, 1,000,000 rows per row group), read
   with ``DeviceFileReader(...).iter_row_groups()`` on the card through the
   full ship planner, checked bit for bit against the generator, with the
   kernel launch counts (the fused K1 once per planned hybrid stream) and
   route table of the read, the rows per second of a warm second pass and
   a profiled pass; then the same read with the hybrid streams through the
   unfused chain the fused K1 replaced (standalone K1 + PyTorch combine),
   checked, timed and profiled as the same-call yardstick;
4. the main path, OPTIONAL: the same columns written OPTIONAL with no nulls
   (1,000,000 rows), checked, profiled and compared the same way;
5. the compressed-shipping main path: the reference's K3 file
   (``tests/test_fused_decode.py``: ``dates`` INT64 runs of 50, ``wide``
   INT64 full range, ``cnt`` INT32, ``rate`` FLOAT, ``dbl`` DOUBLE runs of
   100, plus ``dates32``, INT32 runs of 50 over ``l_shipdate``'s range) at
   6,000,000 rows in row groups of 65,536, written GZIP (page CRCs,
   dictionary off, chunk statistics on), read unforced on the card and
   checked bit for bit; K3 must run twice per row group.  Then the same
   read forced to ``plain`` and to ``fused_plain``, for their rows/s;
6. the whole 16-column table of ``bench.py`` ``gen_lineitem16`` at SF1
   (its schema, generator, seed and writer settings: SNAPPY, dictionary on,
   DELTA_BINARY_PACKED as the non-dictionary encoding of ``l_orderkey``
   and the three dates, page CRCs) written with the port's writer, read on
   the card and checked column by column against the generator, strings
   included; the fused K1 must run for the five string dictionaries'
   index streams of every row group; a warm pass, a profiled pass and a
   cProfile'd pass;
7. the five string columns of the first two row groups written PLAIN
   (dictionary off), SNAPPY and GZIP: each read unforced (on SNAPPY the four
   short-string columns must keep their pages compressed,
   ``device_snappy``; ``l_comment``'s pages hold more snappy ops than the
   staged chain takes and ship plain, as in the reference) and forced to
   ``plain``, checked, timed, profiled and cProfile'd;
8. lineitem as pyarrow writes it: the 16 columns of phase 6 in pyarrow's
   dictionary-on layout (a helper here on the port's encoders: the index
   width of each page is the bit width of the dictionary size when the
   page is written; a dictionary over 1 MiB, or 1 KiB for ``l_comment``,
   falls back to PLAIN pages), SNAPPY, 1 MiB pages.  ``l_orderkey``,
   ``l_partkey``, ``l_extendedprice`` and ``l_comment`` become
   dictionary-prefix-then-PLAIN chunks; the fused K1 must take the
   equal-width page groups of the fixed-width prefixes.  Checked column by
   column, profiled and cProfile'd;
9. the value shapes at SF1 from the same draw, with the port's writer
   (dictionary off, SNAPPY): BOOLEAN PLAIN and RLE, INT96 timestamps,
   decimal(15,2) in a 7-byte FIXED_LEN_BYTE_ARRAY, DOUBLE
   BYTE_STREAM_SPLIT, DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY strings;
   the boolean RLE pages must go through the fused K1; then an INT96
   column with the dictionary on.  Phases 3, 4, 6, 8 and 9 check a
   fixed-width dictionary column's ``DeviceDictColumn``: its device
   ``materialize()`` against its ``to_host()``;
10. one JSON line listing every ported kernel, then the result line.

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
# float32 outside the tensor cores, NVIDIA data sheet; taken as the peak for
# K3's 32-bit integer compares (an upper bound on the integer rate)
PEAK_OPS_PER_S = 67e12
SF1_ROWS = 6_001_215
ROWS_PER_GROUP = 1_000_000
# ~2 ms of device spin at H100 clocks: longer than the host takes to
# enqueue any timed call below (the plain versions are tens of tensor ops)
SPIN_CYCLES = 4_000_000
COLUMNS = ["l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
           "l_extendedprice", "l_discount", "l_tax"]
K3_ROWS = 6_000_000
K3_GROUP = 65_536
K3_COLUMNS = ["dates", "wide", "cnt", "rate", "dbl", "dates32"]
L16_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
               "l_quantity", "l_extendedprice", "l_discount", "l_tax",
               "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
               "l_receiptdate", "l_shipinstruct", "l_shipmode", "l_comment"]
STRING_COLUMNS = ["l_returnflag", "l_linestatus", "l_shipinstruct",
                  "l_shipmode", "l_comment"]
# bench.py gen_lineitem16's column_encodings: the encoding of these columns
# when the writer declines a dictionary (over 32,767 distinct values)
DELTA_COLUMNS = ["l_orderkey", "l_shipdate", "l_commitdate",
                 "l_receiptdate"]
PLAIN_STRING_GROUPS = 2


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


def _b2b_ms(torch, fn, launches: int = 50) -> float:
    """Device time per launch of ``launches`` back-to-back calls of ``fn``
    between two CUDA events, the card kept busy while the host enqueues
    them (warm L2: the timing floor of one launch is spread over all)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(3):
        torch.cuda._sleep(SPIN_CYCLES * 5)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[1]


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
    """The standalone K1 at every width 1..32 on edge shapes, then timed
    at SF1's index-stream shapes (1,048,576 values at widths 6 and 14; on
    the main path these streams now take the fused K1)."""
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
        run = lambda: ck.unpack_bp_groups(buf, base, width, gpad)  # noqa
        ms = _median_ms(torch, run, flush)
        b2b = _b2b_ms(torch, run)
        plain_ms = _median_ms(
            torch, lambda: ck.unpack_bp_groups_plain(buf, base, width, gpad),
            flush, reps=10)
        moved = gpad * width + gpad * 8 * 4
        timings[width] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain_ms,
                              bound_ms=_bound_ms(moved), values=gpad * 8,
                              bytes=moved)
        log(f"K1 width {width}: {gpad * 8} values, {ms:.4f} ms "
            f"(back-to-back {b2b:.4f} ms per launch; plain {plain_ms:.4f} "
            f"ms), bound {_bound_ms(moved):.4f} ms "
            f"({moved} bytes at 3.35 TB/s), "
            f"{moved / (ms * 1e-3) / 1e9:.1f} GB/s ({smi})")
    return dict(worst=worst, timings=timings)


# ---------------------------------------------------------------------------
# the fused K1: BP unpack + run-table combine
# ---------------------------------------------------------------------------

def synth_hybrid(rng, n_runs: int, max_len: int, zero_every: int = 0):
    """A hybrid stream's run table as the planner builds it: runs of 1 to
    ``max_len`` values, RLE (odd lengths) or bit-packed (any length, so the
    next run starts off a group boundary) at random, every
    ``zero_every``-th run of length 0.  Returns (ends, is_rle, values,
    bp_idx_base, bit-packed groups)."""
    import numpy as np

    lengths = rng.integers(1, max_len + 1, n_runs)
    rle = rng.random(n_runs) < 0.5
    lengths = np.where(rle, lengths | 1, lengths)
    if zero_every:
        lengths[::zero_every] = 0
    ends = np.cumsum(lengths)
    groups = np.where(rle, 0, -(-lengths // 8))
    bib = np.where(rle, 0, (np.cumsum(groups) - groups) * 8 - (ends - lengths))
    values = rng.integers(0, 1 << 32, n_runs, dtype=np.uint64)
    return (ends.astype(np.int32), rle.astype(np.uint8),
            values.astype(np.uint32), bib.astype(np.int32), int(groups.sum()))


def stage_hybrid(torch, ck, rng, table, width: int, rp: int, podd: int,
                 tail: int, dev):
    """The run table padded to ``rp`` rows (ends with the total) at byte
    64, the payload (``bp_groups_pad`` groups of random bytes) ``podd``
    bytes past the next 64-byte boundary, the buffer ending ``tail`` bytes
    past the read extent.  Returns (buf, bp_base, tbase, gpad, total)."""
    import numpy as np

    ends, isr, vals, bib, groups = table
    total = int(ends[-1])
    tabs = [np.full(rp, total, np.int32), np.zeros(rp, np.uint8),
            np.zeros(rp, np.uint32), np.zeros(rp, np.int32)]
    for t, v in zip(tabs, (ends, isr, vals, bib)):
        t[: len(v)] = v
    tbase = 64
    bp_base = tbase + -(-13 * rp // 64) * 64 + podd
    gpad = ck.bp_groups_pad(groups)
    host = rng.integers(0, 256, bp_base + gpad * width + tail, dtype=np.uint8)
    host[tbase : tbase + 13 * rp] = np.concatenate(
        [t.view(np.uint8) for t in tabs])
    return torch.from_numpy(host).to(dev), bp_base, tbase, gpad, total


def hybrid_tiles(torch, ck, buf, bp_base, tbase, n_valid, *, width, gpad,
                 count, rp) -> dict:
    """How the fused K1's blocks take this stream, decided as
    ``csrc/bp_unpack.cu`` decides: the tiles with a position under
    ``n_valid``, those of them whose run window is over ``HYBRID_WINDOW``
    rows (the run table read from global memory), those whose payload span
    is over the shared capacity (the payload read from global memory), and
    the stream's bit-packed positions under ``n_valid``."""
    dev = buf.device
    tab = buf[tbase : tbase + 13 * rp]
    ends = tab[: 4 * rp].view(torch.int32)
    isr = tab[4 * rp : 5 * rp] != 0
    bib = tab[9 * rp :].view(torch.int32)

    def run(p):
        return torch.clamp(torch.searchsorted(ends, p.to(torch.int32),
                                              right=True), max=rp - 1)

    T = ck.HYBRID_TILE
    n_tiles = -(-count // T)
    lim = min(count, max(n_valid, 0))
    t0 = torch.arange(n_tiles, dtype=torch.int64, device=dev) * T
    v1 = torch.clamp(t0 + T, max=lim)
    live = v1 > t0
    wide = live & (run(v1 - 1) - run(t0) + 1 > ck.HYBRID_WINDOW)
    pos = torch.arange(lim, dtype=torch.int32, device=dev)
    r = run(pos)
    bp = ~isr[r]
    idx = torch.clamp(bib[r] + pos, 0, gpad * 8 - 1).to(torch.int64)[bp]
    tile = (pos.to(torch.int64) // T)[bp]
    mn = torch.full((n_tiles,), 1 << 40, dtype=torch.int64,
                    device=dev).scatter_reduce(0, tile, idx, "amin")
    mx = torch.full((n_tiles,), -1, dtype=torch.int64,
                    device=dev).scatter_reduce(0, tile, idx, "amax")
    base = buf.data_ptr() + bp_base
    a0 = (base + ((mn * width) >> 3)) & ~15
    a1 = (base + (((mx + 1) * width + 7) >> 3) + 8 + 15) & ~15
    cap = ((ck.HYBRID_SPAN_VALUES * width) // 8 + 48 + 15) & ~15
    span = live & (mx >= 0) & (a1 - a0 > cap)
    return dict(tiles=int(live.sum()), wide_window=int(wide.sum()),
                wide_span=int(span.sum()), bp_values=int(bp.sum()))


def sf1_index_streams(torch, path: str) -> tuple:
    """SF1 row group 0's index streams of ``l_suppkey`` (width 14),
    ``l_quantity`` (6) and ``l_linenumber`` (3), planned by the port's own
    host code (``_plan_hybrid_pallas`` on the reader's row-group stager)
    and staged on the card: (buf, {width: plan})."""
    from tpu_parquet_torch import device_reader as DR

    plans = {}
    real = DR._plan_hybrid_pallas

    def keep(stager, pages_info, width, total, count_pad):
        plan = real(stager, pages_info, width, total, count_pad)
        if plan is not None:
            plans[width] = plan
        return plan

    DR._plan_hybrid_pallas = keep
    try:
        with DR.DeviceFileReader(path, columns=["l_suppkey", "l_quantity",
                                                "l_linenumber"]) as r:
            _, _, stager = r._prepare_row_group(0)
            buf = stager.stage(r.device)
    finally:
        DR._plan_hybrid_pallas = real
    if sorted(plans) != [3, 6, 14]:
        raise fail(f"SF1 row group 0 planned hybrid streams of widths "
                   f"{sorted(plans)}, want 3, 6 and 14")
    return buf, plans


def check_hybrid(torch, ck, flush, rng, smi: str, sf1_path: str) -> dict:
    """The fused K1 against its plain version on the card, bit-exact: every
    width 1..32 on long runs with an aligned payload; short odd-length RLE
    runs between bit-packed runs with zero-length runs, an odd payload base,
    ``count`` not a multiple of 4 and ``n_valid`` under the total; a table
    padded to four times its runs with ``n_valid = count`` (positions past
    the total read padded rows, their index clamped); buffers ending exactly
    at the read extent; then 60,000 runs of 0..3 values (windows over the
    shared capacity).  Then SF1 row group 0's index streams, timed beside
    the plain version and the unfused chain they replace (standalone K1 +
    the PyTorch combine)."""
    from tpu_parquet_torch.torch_decode import _bucket, _bucket_count

    dev = flush.device
    worst = 0
    checks = 0
    seen = dict(tiles=0, wide_window=0, wide_span=0)

    def check(buf, bp_base, tbase, n_valid, what, **kw):
        nonlocal worst, checks
        got = ck.hybrid_unpack_combine(buf, bp_base, tbase, n_valid, **kw)
        want = ck.hybrid_unpack_combine_plain(buf, bp_base, tbase, n_valid,
                                              **kw)
        err = _max_err(torch, got, want)
        worst = max(worst, err)
        checks += 1
        if err:
            raise fail(f"fused K1 width {kw['width']} {what}: max abs err "
                       f"{err}")
        t = hybrid_tiles(torch, ck, buf, bp_base, tbase, n_valid, **kw)
        for key in seen:
            seen[key] += t[key]

    def case(width, table, rp, podd, tail, n_valid, count, what):
        buf, bp_base, tbase, gpad, total = stage_hybrid(
            torch, ck, rng, table, width, rp, podd, tail, dev)
        count = count(total)
        check(buf, bp_base, tbase, n_valid(total, count), what, width=width,
              gpad=gpad, count=count, rp=rp)

    for width in range(1, 33):
        t = synth_hybrid(rng, 40, 600)
        case(width, t, _bucket(40), 0, 0, lambda tot, c: tot, _bucket_count,
             "long runs, aligned base")
        t = synth_hybrid(rng, 900, 24, zero_every=7)
        case(width, t, _bucket(900), 1 + width % 15, 0,
             lambda tot, c: tot - 7, lambda tot: tot + 5,
             "short runs, zero-length runs, odd base, ragged count")
        t = synth_hybrid(rng, 60, 600)
        case(width, t, 4 * _bucket(60), 3, 5, lambda tot, c: c,
             _bucket_count, "padded table, n_valid = count")
    for width in (5, 17):
        t = synth_hybrid(rng, 60_000, 3, zero_every=5)
        case(width, t, _bucket(60_000), 7, 0, lambda tot, c: tot,
             _bucket_count, "60,000 runs of 0..3 values")
    torch.cuda.synchronize()
    log(f"fused K1 hybrid_unpack_combine: {checks} edge cases bit-exact "
        f"(widths 1..32, odd-length RLE runs between bit-packed runs, "
        f"zero-length runs, padded tables, count > n_valid and ragged, odd "
        f"and aligned payload bases, buffers ending at the read extent, "
        f"60,000-run streams); of their {seen['tiles']} tiles, "
        f"{seen['wide_window']} read the run table and {seen['wide_span']} "
        f"the payload from global memory (over the shared capacity)")

    buf, plans = sf1_index_streams(torch, sf1_path)
    shapes = {}
    for name, width in (("l_suppkey", 14), ("l_quantity", 6),
                        ("l_linenumber", 3)):
        plan = plans[width]
        bp_base, tbase, total = plan.dyn
        kw = plan.fn.keywords
        count, rp, gpad = kw["count"], kw["rp"], kw["gpad"]
        run = lambda: ck.hybrid_unpack_combine(  # noqa: E731
            buf, bp_base, tbase, total, **kw)
        plain = lambda: ck.hybrid_unpack_combine_plain(  # noqa: E731
            buf, bp_base, tbase, total, **kw)
        chain = lambda: ck.hybrid_combine_plain(  # noqa: E731
            ck.unpack_bp_groups(buf, bp_base, width, gpad), buf, tbase,
            total, count=count, rp=rp)
        got = run()
        err = max(_max_err(torch, got, plain()), _max_err(torch, got, chain()))
        worst = max(worst, err)
        if err:
            raise fail(f"fused K1 main-path shape {name}: max abs err {err}")
        t = hybrid_tiles(torch, ck, buf, bp_base, tbase, total, **kw)
        ms = _median_ms(torch, run, flush)
        b2b = _b2b_ms(torch, run)
        plain_ms = _median_ms(torch, plain, flush, reps=10)
        chain_ms = _median_ms(torch, chain, flush, reps=10)
        moved = -(-t["bp_values"] * width // 8) + 13 * rp + 4 * count
        bound_ms = _bound_ms(moved)
        shapes[name] = dict(ms=ms, b2b_ms=b2b, plain_ms=plain_ms,
                            chain_ms=chain_ms, bound_ms=bound_ms)
        log(f"fused K1 {name}: {count} positions ({total} valid, "
            f"{t['bp_values']} bit-packed), width {width}, {rp} table rows, "
            f"{t['tiles']} tiles ({t['wide_window']} with the run table and "
            f"{t['wide_span']} with the payload in global memory): "
            f"{ms:.4f} ms (back-to-back {b2b:.4f} ms per launch; plain "
            f"{plain_ms:.4f} ms; unfused chain K1 + PyTorch combine "
            f"{chain_ms:.4f} ms, fused/chain {ms / chain_ms:.3f}), bound "
            f"{bound_ms:.4f} ms ({moved} bytes at 3.35 TB/s) ({smi})")
    main = shapes["l_suppkey"]
    return dict(worst=worst, **main)


def check_k2(torch, ck, flush, rng, smi: str) -> dict:
    """K2 at widths 4 and 8 with n_valid at and beside tile edges and odd
    bases; ``vbase`` at every residue mod 16 in buffers that end exactly at
    the read extent ``vbase + count_pad * width``; buffer views whose first
    byte is not 16-byte aligned.  Then timed at the main path's shapes:
    1,048,576 int64 values (SF1's ``l_extendedprice``) aligned and at an
    odd base, and 65,536 int64 and int32 values (phase 5's ``wide`` and
    ``rate``), each beside the library yardstick of the same call."""
    import numpy as np

    dev = torch.device("cuda")
    worst = 0
    checks = 0

    def check(buf, vbase, n_valid, width, count_pad, what):
        nonlocal worst, checks
        got = ck.fused_plain_words(buf, vbase, n_valid, width=width,
                                   count_pad=count_pad)
        want = ck.fused_plain_words_plain(buf, vbase, n_valid, width=width,
                                          count_pad=count_pad)
        err = _max_err(torch, got, want)
        worst = max(worst, err)
        checks += 1
        if err:
            raise fail(f"K2 width {width} {what} vbase {vbase} n_valid "
                       f"{n_valid}: err {err}")

    for width in (4, 8):
        for count, vbase in ((1024, 0), (1024, 3), (2048, 1), (5000, 64),
                             (4096, 5)):
            count_pad = ck.fused_count_pad(count)
            nbytes = vbase + count_pad * width + int(rng.integers(0, 9))
            host = rng.integers(0, 256, nbytes, dtype=np.uint8)
            buf = torch.from_numpy(host).to(dev)
            for n_valid in {0, 1, count - 1, count, min(count + 1, count_pad),
                            1023, 1024, 1025, count_pad}:
                if 0 <= n_valid <= count_pad:
                    check(buf, vbase, n_valid, width, count_pad,
                          f"count {count}")
        count_pad = ck.fused_count_pad(2048)
        for residue in range(16):
            # the buffer ends exactly at the read extent
            vbase = 48 + residue
            host = rng.integers(0, 256, vbase + count_pad * width,
                                dtype=np.uint8)
            buf = torch.from_numpy(host).to(dev)
            for n_valid in (count_pad, count_pad - 1, 1000):
                check(buf, vbase, n_valid, width, count_pad,
                      "buffer ending at the read extent")
            # a view whose first byte is not 16-byte aligned
            base = torch.from_numpy(rng.integers(
                0, 256, 16 + count_pad * width + 16, dtype=np.uint8)).to(dev)
            view = base[residue + 1 : residue + 1 + count_pad * width + 3]
            for vbase in (0, 3):
                check(view, vbase, count_pad - 5, width, count_pad,
                      f"view at {residue + 1} bytes")
    torch.cuda.synchronize()
    log(f"K2 fused_plain_words: {checks} edge cases bit-exact (widths 4/8, "
        f"n_valid at and beside tile edges, vbase at every residue mod 16 "
        f"with the buffer ending at the read extent, unaligned views)")

    shapes = []
    for n, width, vbase, what in (
            (1_000_000, 8, 0, "SF1 l_extendedprice"),
            (1_000_000, 8, 3, "SF1 shape at an odd base"),
            (65_536, 8, 0, "phase 5 wide"), (65_536, 4, 0, "phase 5 rate")):
        count_pad = ck.fused_count_pad(n)
        dtype = np.int64 if width == 8 else np.int32
        vals = rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max,
                            count_pad, dtype=dtype)
        host = np.zeros(vbase + count_pad * width + 64, dtype=np.uint8)
        host[vbase : vbase + count_pad * width] = vals.view(np.uint8)
        buf = torch.from_numpy(host).to(dev)
        run = lambda: ck.fused_plain_words(  # noqa: E731
            buf, vbase, n, width=width, count_pad=count_pad)
        got = run()
        err = _max_err(torch, got, ck.fused_plain_words_plain(
            buf, vbase, n, width=width, count_pad=count_pad))
        tdt = torch.int64 if width == 8 else torch.int32
        exact = np.array_equal(got.view(tdt).reshape(-1)[:n].cpu().numpy(),
                               vals[:n])
        if err or not exact:
            raise fail(f"K2 {what}: err {err}, matches the generator: "
                       f"{exact}")
        src = buf[vbase : vbase + count_pad * width]

        def library_call():
            # one PyTorch call computing the same function: a dtype-view
            # copy of the byte slice, then the tail mask (aligned bases only)
            v = src.view(tdt).clone()
            v[n:] = 0
            return v

        library_ms = None
        if vbase == 0:
            if not torch.equal(library_call(), got.view(tdt).reshape(-1)):
                raise fail(f"K2 {what} disagrees with the library yardstick")
            library_ms = _median_ms(torch, library_call, flush)
        ms = _median_ms(torch, run, flush)
        b2b = _b2b_ms(torch, run)
        plain_ms = _median_ms(torch, lambda: ck.fused_plain_words_plain(
            buf, vbase, n, width=width, count_pad=count_pad), flush, reps=10)
        moved = 2 * count_pad * width
        t = dict(what=what, values=count_pad, width=width, vbase=vbase, ms=ms,
                 b2b_ms=b2b, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=_bound_ms(moved), bytes=moved)
        shapes.append(t)
        ratio = (f", library {library_ms:.4f} ms, K2/library "
                 f"{ms / library_ms:.3f}" if library_ms else "")
        log(f"K2 {what}: {count_pad} values, width {width}, vbase {vbase}: "
            f"{ms:.4f} ms (back-to-back {b2b:.4f} ms per launch; plain "
            f"{plain_ms:.4f} ms{ratio}), bound "
            f"{t['bound_ms']:.4f} ms ({moved} bytes at 3.35 TB/s), "
            f"{moved / (ms * 1e-3) / 1e9:.1f} GB/s ({smi})")
    sf1 = shapes[0]
    return dict(worst=worst, ms=sf1["ms"], ms_odd=shapes[1]["ms"],
                plain_ms=sf1["plain_ms"], bound_ms=sf1["bound_ms"],
                library_ms=sf1["library_ms"], values=sf1["values"],
                bytes=sf1["bytes"], shapes=shapes)


# ---------------------------------------------------------------------------
# K3: op tables
# ---------------------------------------------------------------------------

def synth_ops(rng, out_len: int, depth: int, n_ops: int, literal_only: bool):
    """Snappy-style op tables over ``out_len`` output bytes whose deepest
    copy chain is exactly ``depth``: a literal, ``depth`` copies each copying
    the op before it, then random literals and copies (overlapping ones,
    offset < length, among them) that stay within ``depth``.  Returns K3's
    (ends, asrc, offs, islit) with payload-relative literal sources, and the
    payload."""
    import bisect

    import numpy as np

    longest = max(2 * out_len // n_ops, 1)
    ends, srcs, lits, depths = [], [], [], []
    pay = pos = 0

    def add(length, src, lit, d):
        nonlocal pos
        ends.append(pos + length)
        srcs.append(src)
        lits.append(lit)
        depths.append(d)
        pos += length

    def literal(length):
        nonlocal pay
        add(length, pay, 1, 0)
        pay += length

    literal(min(out_len, 4))
    for _ in range(0 if literal_only else depth):
        if pos >= out_len:
            break
        prev = ends[-1] - (ends[-2] if len(ends) > 1 else 0)
        add(min(prev, out_len - pos), prev, 0, depths[-1] + 1)
    while pos < out_len:
        length = int(min(out_len - pos, rng.integers(1, longest + 1)))
        if literal_only or rng.random() < 0.35:
            literal(length)
            continue
        off = int(rng.integers(1, pos + 1))
        if rng.random() < 0.3:
            off = int(rng.integers(1, min(length, pos) + 1))  # overlapping
        lo, hi = pos - off, pos - off + min(length, off)
        i0, i1 = bisect.bisect_right(ends, lo), bisect.bisect_left(ends, hi)
        d = 1 + max(depths[i0 : i1 + 1])
        if d > depth:
            literal(length)
            continue
        add(length, off, 0, d)
    assert max(depths) == (0 if literal_only else depth), max(depths)
    dst_end = np.array(ends, np.int64)
    st = np.concatenate([[0], dst_end[:-1]])
    op_src = np.array(srcs, np.int64)
    is_lit = np.array(lits, np.uint8)
    payload = rng.integers(0, 256, max(pay, 1), dtype=np.uint8)
    return (dst_end, np.where(is_lit != 0, op_src, st - op_src),
            np.where(is_lit != 0, 1, op_src), is_lit), payload


def stage_k3(torch, stream_tables, payload, n: int, out_pad: int, podd: int,
             dev):
    """Tables and payload in one staged buffer, as the reader lays them
    out: the tables padded to ``n`` rows (sorted ends padded with
    ``out_pad``) at a 64-byte boundary, the payload ``podd`` bytes past the
    next one, random bytes around both.  Returns (buf, tbase, pbase,
    ppad)."""
    import numpy as np

    from tpu_parquet_torch.torch_decode import _bucket_bytes

    ends, asrc, offs, islit = stream_tables
    tabs = [np.full(n, out_pad, np.int32), np.zeros(n, np.int32),
            np.ones(n, np.int32), np.ones(n, np.uint8)]
    for t, v in zip(tabs, (ends, asrc, offs, islit)):
        t[: len(v)] = v
    ppad = _bucket_bytes(len(payload), 64)
    tbase = 64
    pbase = tbase + -(-13 * n // 64) * 64 + podd
    host = np.random.default_rng(n).integers(0, 256, pbase + ppad + 40,
                                             dtype=np.uint8)
    host[tbase : tbase + 13 * n] = np.concatenate(
        [t.view(np.uint8) for t in tabs])
    host[pbase : pbase + len(payload)] = payload
    return torch.from_numpy(host).to(dev), tbase, pbase, ppad


def k3_work(torch, ck, buf, tbase, n_ops_pad, count_pad, k, out_pad, depth):
    """The data-dependent part of K3's operation count on this stream:
    ``(rounds, steps)``, the chase rounds its bytes take (a byte stops at
    its literal; an unresolved one takes depth + 1) and the binary-search
    steps of their lookups, each searching only the ops between the coarse
    index entries of its bucket and the next (the index built here as the
    kernel builds it: the upper bound of each bucket start)."""
    n = n_ops_pad
    tab = buf[tbase : tbase + 13 * n]
    ends = tab[: 4 * n].view(torch.int32)
    asrc = tab[4 * n : 8 * n].view(torch.int32)
    offs = tab[8 * n : 12 * n].view(torch.int32)
    islit = tab[12 * n :] != 0
    _, shift, _ = ck.fused_narrow_geometry(count_pad, n_ops_pad, out_pad, 1)
    nb = -(-out_pad >> shift)
    starts = torch.arange(nb + 1, dtype=torch.int32, device=buf.device)
    index = torch.searchsorted(ends, starts << shift, right=True)
    p = torch.clamp(torch.arange(count_pad * k, dtype=torch.int32,
                                 device=buf.device), 0, out_pad - 1)
    done = torch.zeros(p.shape, dtype=torch.bool, device=buf.device)
    rounds = steps = 0
    for _ in range(depth + 1):
        live = ~done
        rounds += int(live.sum().item())
        bk = (p >> shift).long()
        span = (index[bk + 1] - index[bk]).double()
        steps += int(torch.ceil(torch.log2(span + 1))[live].sum().item())
        op = torch.clamp(torch.searchsorted(ends, p, right=True), max=n - 1)
        prev = ends[torch.clamp(op - 1, min=0)]
        within = p - torch.where(op > 0, prev, torch.zeros_like(prev))
        lit = islit[op]
        done = done | lit
        p = torch.where(lit, p, asrc[op] + torch.remainder(
            within, torch.clamp(offs[op], min=1)))
    return rounds, steps


def check_k3(torch, ck, flush, rng, smi: str, dates) -> dict:
    """K3 against its plain version on the card, bit-exact: every k at
    widths 4 and 8 under chain depths 0, 1, 12 and 16, overlapping copies
    and literal-only streams, 8 and 4096 op rows, biases whose low word
    carries and negative minima, n_valid at and beside a 256-value tile
    edge, payloads at odd offsets; then a literal-only stream of a handful
    of ops over a 1 MiB output, 4096 op rows at depth 16, and k = 8 at
    width 8 with every row valid.  Then the main path's shape — the first
    row group of phase 5's ``dates`` (65,536 values, k = 2, width 8) through
    the port's own narrow transcode and table packing — timed beside its
    plain version and the unfused chain (snappy_resolve + gather + widen)
    on the same stream."""
    import numpy as np

    from tpu_parquet_torch import device_reader as DR
    from tpu_parquet_torch import native
    from tpu_parquet_torch.torch_decode import (_bucket, _bucket_bytes,
                                                _bucket_count)

    dev = flush.device
    worst = 0
    checks = 0
    biases = [(1 << 40) + 0xFFFFFFF0, -(1 << 63), -5, 0xFFFFFFFF, 19_000]
    combos = [(w, k, d) for w in (4, 8) for k in range(1, w + 1)
              for d in (0, 1, 12, 16)]
    for i, (width, k, depth) in enumerate(combos):
        count = 2048 if i % 3 else 1000
        out_len = count * k
        # alternate small tables (8 rows) and full ones (4096 rows)
        n_ops = 3 if i % 2 else min(4000, out_len)
        literal_only = depth == 0 and i % 4 == 0
        tables, payload = synth_ops(rng, out_len, depth, n_ops, literal_only)
        n_ops_pad = _bucket(len(tables[0]))
        out_pad = _bucket_bytes(out_len + 8, 8)
        count_pad = ck.fused_narrow_count_pad(count)
        buf, tbase, pbase, ppad = stage_k3(
            torch, tables, payload, n_ops_pad, out_pad, i % 7, dev)
        for n_valid in (255, 256, 257, count):
            bias = biases[(i + n_valid) % len(biases)]
            args = (buf, tbase, pbase, bias, n_valid)
            kw = dict(k=k, width=width, depth=depth, count_pad=count_pad,
                      out_pad=out_pad, n_ops_pad=n_ops_pad, ppad=ppad)
            got = ck.fused_narrow_words(*args, **kw)
            want = ck.fused_narrow_words_plain(*args, **kw)
            err = _max_err(torch, got, want)
            worst = max(worst, err)
            checks += 1
            if err:
                raise fail(f"K3 width {width} k {k} depth {depth} n_ops_pad "
                           f"{n_ops_pad} n_valid {n_valid}: err {err}")
    # the redesign's edges: a literal-only stream of a handful of ops over
    # a 1 MiB output (the coarse index's large buckets), 4096 op rows at
    # depth 16, and k = 8 at width 8 with every row valid
    for width, k, depth, n_ops, count, literal_only in (
            (4, 2, 0, 4, 1 << 19, True), (8, 3, 16, 3500, 2048, False),
            (8, 8, 12, 600, 1024, False)):
        tables, payload = synth_ops(rng, count * k, depth, n_ops,
                                    literal_only)
        n_ops_pad = _bucket(len(tables[0]))
        out_pad = _bucket_bytes(count * k + 8, 8)
        count_pad = ck.fused_narrow_count_pad(count)
        buf, tbase, pbase, ppad = stage_k3(
            torch, tables, payload, n_ops_pad, out_pad, 3, dev)
        for n_valid in (count_pad, count_pad - 1):
            args = (buf, tbase, pbase, biases[n_valid % 5], n_valid)
            kw = dict(k=k, width=width, depth=depth, count_pad=count_pad,
                      out_pad=out_pad, n_ops_pad=n_ops_pad, ppad=ppad)
            err = _max_err(torch, ck.fused_narrow_words(*args, **kw),
                           ck.fused_narrow_words_plain(*args, **kw))
            worst = max(worst, err)
            checks += 1
            if err:
                raise fail(f"K3 width {width} k {k} depth {depth} n_ops_pad "
                           f"{n_ops_pad} out_pad {out_pad} n_valid {n_valid}: "
                           f"err {err}")
    torch.cuda.synchronize()
    log(f"K3 fused_narrow_words: {checks} edge cases bit-exact (k 1..width "
        f"at widths 4/8, depths 0/1/12/16, 8..4096 op rows, overlapping "
        f"copies, literal-only streams up to a 1 MiB output, carrying and "
        f"negative biases, n_valid at and beside the 256-value tile edge and "
        f"at count_pad, odd payload bases)")

    # the main path's shape, from the port's own host code
    n = len(dates)
    mn, mx = int(dates.min()), int(dates.max())
    k = DR._span_bytes(mn, mx)
    out = np.empty(n * k, np.uint8)
    native.int_truncate(dates, 0, n, 8, mn, k, out)
    comp = native.snappy_compress(out)
    fz = DR._fused_narrow_tables(comp, out.nbytes)
    if fz is None:
        raise fail("K3 main-path stream is over K3's caps")
    tables, depth, n_ops_pad, out_pad, ppad = fz
    stager = DR._RowGroupStager()
    tbase = DR._pack_tables(stager, tables)
    pbase = stager.add(np.frombuffer(comp, np.uint8))
    stager.note_read_extent(pbase, ppad)
    # the unfused chain's tables (absolute literal sources), same stream
    info = DR._plan_snappy_ops(stager, [("comp", comp, out.nbytes, None)])
    buf = stager.stage(dev)
    count_pad = ck.fused_narrow_count_pad(n)
    kw = dict(k=k, width=8, depth=depth, count_pad=count_pad,
              out_pad=out_pad, n_ops_pad=n_ops_pad, ppad=ppad)
    run = lambda: ck.fused_narrow_words(buf, tbase, pbase, mn, n, **kw)  # noqa
    plain = lambda: ck.fused_narrow_words_plain(  # noqa: E731
        buf, tbase, pbase, mn, n, **kw)
    ucount = _bucket_count(n)
    unfused = lambda: DR._snappy_narrow_staged(  # noqa: E731
        buf, info.tbase, mn, n_ops=info.n_ops, out_pad=info.out_pad,
        iters=info.iters, k=k, dtype="int64", count=ucount)
    got = run()
    err = _max_err(torch, got, plain())
    vals = got.view(torch.int64).reshape(-1)[:n].cpu().numpy()
    if err or not np.array_equal(vals, dates):
        raise fail(f"K3 main-path shape: err {err}, matches the generator: "
                   f"{np.array_equal(vals, dates)}")
    if not np.array_equal(unfused()[:n].cpu().numpy(), dates):
        raise fail("the unfused chain disagrees with the generator")
    worst = max(worst, err)
    real_ops = int(np.count_nonzero(tables[0] < out_pad))
    ms = _median_ms(torch, run, flush)
    b2b = _b2b_ms(torch, run)
    plain_ms = _median_ms(torch, plain, flush, reps=10)
    unfused_ms = _median_ms(torch, unfused, flush, reps=10)
    moved = ppad + 13 * n_ops_pad + count_pad * 8
    rounds, steps = k3_work(torch, ck, buf, tbase, n_ops_pad, count_pad, k,
                            out_pad, depth)
    # per chase round: the bucket, its two index entries, start, within,
    # the literal test and the modulo or the source (8 integer operations),
    # a compare and a select per search step; per value: widen + bias
    ops = rounds * 8 + steps * 2 + count_pad * (2 * k + 2)
    bytes_ms = moved / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"K3 main-path shape: {n} values, k {k}, width 8, {real_ops} ops "
        f"({n_ops_pad} table rows), depth {depth}, payload "
        f"{len(comp)} bytes (ppad {ppad}); {ms:.4f} ms (back-to-back "
        f"{b2b:.4f} ms per launch; plain {plain_ms:.4f} ms, unfused chain "
        f"snappy_resolve + gather + widen {unfused_ms:.4f} ms, "
        f"{info.iters} doubling rounds, K3/unfused "
        f"{ms / unfused_ms:.3f}); bound {bound_ms:.6f} ms by "
        f"{bound_by} ({moved} bytes -> {bytes_ms:.6f} ms at 3.35 TB/s; "
        f"{rounds} chase rounds, {steps} search steps -> {ops} ops -> "
        f"{ops_ms:.6f} ms at 67 T/s) ({smi})")
    return dict(worst=worst, ms=ms, b2b_ms=b2b, plain_ms=plain_ms,
                unfused_ms=unfused_ms, bound_ms=bound_ms, bound_by=bound_by)


# ---------------------------------------------------------------------------
# phases 3-4: the main path over TPC-H lineitem
# ---------------------------------------------------------------------------

def draw_lineitem16(rows: int, rows_per_group: int = ROWS_PER_GROUP):
    """Yield per-row-group dicts of ``bench.py`` ``gen_lineitem16``'s 16
    columns, drawn exactly as it draws them (seed 4): the integer and float
    columns as arrays, each STRING column as ``(pool, indices)`` (the strings
    are ``pool[indices]``; :func:`lineitem_strings` builds them)."""
    import numpy as np

    flags = [b"A", b"N", b"R"]
    status = [b"F", b"O"]
    instr = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
             b"TAKE BACK RETURN"]
    modes = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"REG AIR", b"SHIP", b"TRUCK"]
    words = [f"word{i}".encode() for i in range(64)]
    comment_pool = [b" ".join(words[j % 64] for j in range(i, i + 5))
                    for i in range(256)]
    rng = np.random.default_rng(4)
    key = 0
    for lo in range(0, rows, rows_per_group):
        n = min(rows_per_group, rows - lo)
        keys = key + np.cumsum(rng.integers(1, 5, n))
        key = int(keys[-1])
        yield {
            "l_orderkey": keys.astype(np.int64),
            "l_partkey": rng.integers(1, 200_000, n),
            "l_suppkey": rng.integers(1, 10_000, n),
            "l_linenumber": rng.integers(1, 8, n).astype(np.int32),
            "l_quantity": rng.integers(1, 51, n),
            "l_extendedprice": rng.uniform(900, 105_000, n),
            "l_discount": rng.uniform(0, 0.1, n).round(2),
            "l_tax": rng.uniform(0, 0.08, n).round(2),
            "l_returnflag": (flags, rng.integers(0, len(flags), n)),
            "l_linestatus": (status, rng.integers(0, len(status), n)),
            "l_shipdate": (8035 + rng.integers(0, 2526, n)).astype(np.int32),
            "l_commitdate": (8035 + rng.integers(0, 2526, n)).astype(
                np.int32),
            "l_receiptdate": (8035 + rng.integers(0, 2526, n)).astype(
                np.int32),
            "l_shipinstruct": (instr, rng.integers(0, len(instr), n)),
            "l_shipmode": (modes, rng.integers(0, len(modes), n)),
            "l_comment": (comment_pool,
                          rng.integers(0, len(comment_pool), n)),
        }


def lineitem_strings(group: dict) -> dict:
    """The group with each ``(pool, indices)`` STRING column built into its
    ``ByteArrayData`` (the bytes ``bench.py`` writes)."""
    from tpu_parquet_torch.column import ByteArrayData

    return {c: (ByteArrayData.from_list(v[0]).take(v[1])
                if isinstance(v, tuple) else v) for c, v in group.items()}


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


def route_table(st: dict) -> str:
    return ", ".join(f"{r} {v['streams']} streams {v['logical']} logical "
                     f"{v['shipped']} shipped"
                     for r, v in st["ship_routes"].items())


def check_route_launches(counts: dict, st: dict, label: str) -> None:
    """Every fused stream in the route table is one launch of its kernel."""
    for route, kernel in (("fused_plain", "fused_plain_words"),
                          ("fused_narrow_snappy", "fused_narrow_words")):
        streams = st["ship_routes"].get(route, {}).get("streams", 0)
        if counts[kernel] != streams:
            raise fail(f"{label}: {counts[kernel]} launches of {kernel} for "
                       f"{streams} {route} streams")


def check_groups(outs, groups, columns, label: str) -> tuple:
    """Every column of every row group bit for bit against the generator
    (a STRING column's offsets and heap); returns (rows, decoded bytes)."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    rows = 0
    decoded = 0
    for rg, want in zip(outs, groups, strict=True):
        for name in columns:
            col = rg[name]
            got = col.to_host()
            exp = want[name]
            if isinstance(exp, ByteArrayData):
                same = (isinstance(got, ByteArrayData)
                        and np.array_equal(got.offsets, exp.offsets)
                        and np.array_equal(got.heap, exp.heap))
                nbytes = got.offsets.nbytes + got.heap.nbytes if same else 0
            else:
                same = got.dtype == exp.dtype and np.array_equal(
                    got.view(np.uint8), exp.view(np.uint8))
                nbytes = got.nbytes
            if not same:
                raise fail(f"{label}: column {name} differs from the "
                           f"generator")
            if col.max_def:
                d, _ = col.levels_to_host()
                if d is None or len(d) != len(exp) or not (d == 1).all():
                    raise fail(f"{label}: def levels of {name} are wrong")
            decoded += nbytes
        rows += len(want[columns[0]])
    return rows, decoded


def check_dict_column(outs, name: str, label: str) -> None:
    """``name`` is a fixed-width ``DeviceDictColumn`` in every row group:
    indices and byte rows on the card, its device gather
    (``materialize()``) equal to the host gather (``to_host()``)."""
    import numpy as np

    from tpu_parquet_torch.device_reader import DeviceDictColumn

    for i, rg in enumerate(outs):
        col = rg[name]
        if not isinstance(col, DeviceDictColumn) or col.dict_u8 is None:
            raise fail(f"{label}: {name} of row group {i} is a "
                       f"{type(col).__name__}, not a fixed-width "
                       f"DeviceDictColumn")
        if col.dict_u8.device.type != "cuda":
            raise fail(f"{label}: {name}'s dictionary is not on the card")
        got = col.materialize().to_host()
        want = col.to_host()
        if got.dtype != want.dtype or not np.array_equal(
                got.view(np.uint8), want.view(np.uint8)):
            raise fail(f"{label}: {name}'s materialize() differs from its "
                       f"to_host() in row group {i}")
    log(f"{label}: {name} is a DeviceDictColumn ({col.dict_dtype}, "
        f"{tuple(col.dict_u8.shape)} byte rows) in all {len(outs)} row "
        f"groups; materialize() on the card equals to_host()")


def timed_pass(torch, path: str, columns, force: "str | None" = None):
    """One read of ``path`` through the public entry point, timed end to
    end (host parse + staging + decode, ending in a synchronize); under
    ``TPQ_FORCE_ROUTE=force`` when given (the environment is restored).
    Returns (outputs, seconds, stats)."""
    from tpu_parquet_torch.device_reader import DeviceFileReader

    before = os.environ.get("TPQ_FORCE_ROUTE")
    if force is not None:
        os.environ["TPQ_FORCE_ROUTE"] = force
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with DeviceFileReader(path, columns=columns) as r:
            outs = list(r.iter_row_groups())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            st = r.stats().as_dict()
    finally:
        if before is None:
            os.environ.pop("TPQ_FORCE_ROUTE", None)
        else:
            os.environ["TPQ_FORCE_ROUTE"] = before
    return outs, seconds, st


def read_main_path(torch, ck, path: str, groups, label: str,
                   columns=COLUMNS, dict_column: "str | None" = None) -> dict:
    """Read ``path`` on the card through the public entry point and the full
    ship planner (unforced), check every column bit for bit, and time a
    warm second pass.  The first pass also counts the planned hybrid
    streams, and among them the string dictionaries' index streams
    (``ragged_fused``).  ``dict_column`` names a fixed-width dictionary
    column that must come back as a ``DeviceDictColumn`` whose device
    ``materialize()`` equals its ``to_host()`` in every row group."""
    from tpu_parquet_torch import device_reader as DR

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    planned = [0]
    ragged_fused = [0]
    real = DR._plan_hybrid_pallas
    real_ragged = DR._ChunkAssembler._finish_dict_ragged

    def count_plans(*args):
        plan = real(*args)
        planned[0] += plan is not None
        return plan

    def count_ragged(self, common, stager, idx_fn, *args):
        # the index stream's plan is the fused K1's wrapper
        if getattr(idx_fn, "func", None) is DR.hybrid_unpack_combine:
            ragged_fused[0] += 1
        return real_ragged(self, common, stager, idx_fn, *args)

    DR._plan_hybrid_pallas = count_plans
    DR._ChunkAssembler._finish_dict_ragged = count_ragged
    try:
        ck.reset_launches()
        outs, _, st = timed_pass(torch, path, columns)
        counts = dict(ck.launches)
    finally:
        DR._plan_hybrid_pallas = real
        DR._ChunkAssembler._finish_dict_ragged = real_ragged
    check_route_launches(counts, st, label)
    # each planned hybrid stream is one launch of the fused K1, and the
    # standalone unpack is off the path
    if counts["hybrid_unpack_combine"] != planned[0] or \
            counts["unpack_bp_groups"]:
        raise fail(f"{label}: {counts['hybrid_unpack_combine']} launches of "
                   f"hybrid_unpack_combine and {counts['unpack_bp_groups']} "
                   f"of unpack_bp_groups for {planned[0]} hybrid streams")
    rows, decoded = check_groups(outs, groups, columns, label)
    if dict_column is not None:
        check_dict_column(outs, dict_column, label)
    del outs
    # warm second pass, timed end to end (host parse + staging + decode)
    keep, seconds, st2 = timed_pass(torch, path, columns)
    del keep
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {rows} rows bit-exact against the generator; "
        f"launches {counts}")
    log(f"{label}: routes {route_table(st)}; fused_fallbacks "
        f"{st['fused_fallbacks']}; pages_device_expanded "
        f"{st['pages_device_expanded']}; planner_link_mbps "
        f"{st['planner_link_mbps']}; link_bytes_logical "
        f"{st['link_bytes_logical']}, link_bytes_shipped "
        f"{st['link_bytes_shipped']}")
    log(f"{label}: warm pass {seconds:.4f} s = {rows / seconds:.1f} rows/s; "
        f"host {st2['host_seconds']:.4f} s, stage enqueue "
        f"{st2['stage_seconds']:.4f} s, dispatch enqueue "
        f"{st2['dispatch_seconds']:.4f} s; staged {st['staged_bytes']} bytes, "
        f"file {st['compressed_bytes']} bytes, decoded {decoded} bytes, "
        f"max_memory_allocated {peak} bytes")
    return dict(counts=counts, rows=rows, seconds=seconds,
                rows_per_s=rows / seconds, staged=st["staged_bytes"],
                decoded=decoded, peak=peak, stats=st, warm=st2,
                ragged_fused=ragged_fused[0])


def device_breakdown(torch, path: str, label: str, columns=COLUMNS) -> dict:
    """One more read of ``path`` under ``torch.profiler``: device time by
    kernel (and copy), and the device's idle share of the profiled wall.
    The profiler's own host overhead lengthens that wall, so the idle share
    is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    # acc_events: keep every event of the pass (without it the profiler
    # dropped one row group's events of the 92-group read)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        with DeviceFileReader(path, columns=columns) as r:
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
    n_device = sum(n for _, n in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the eight largest, and the port's own kernels wherever they rank
    top = [kv for i, kv in enumerate(ranked) if i < 8 or "tpq_" in kv[0]]
    if busy_s:
        log(f"{label}: profiled pass {wall:.4f} s wall, device busy "
            f"{busy_s:.6f} s in {n_device} kernels and copies, idle share "
            f"{1 - busy_s / wall:.4f}")
        for name, (us, n) in top:
            log(f"  device {us / 1e3:.3f} ms in {n} x {name[:70]} "
                f"({us / n:.2f} us each)")
    else:
        log(f"{label}: device time not measured (the profiler recorded no "
            f"device events)")
    return dict(wall=wall, busy=busy_s, launches=n_device,
                idle=1 - busy_s / wall if busy_s else None)


def unfused_yardstick(torch, ck, path: str, groups, label: str,
                      columns=COLUMNS) -> None:
    """The same read with every hybrid stream through the chain the fused
    K1 replaced (standalone K1 + the PyTorch combine), checked, timed warm
    and profiled: the same-call yardstick of the fused K1 on the main
    path."""
    from tpu_parquet_torch import device_reader as DR

    real = DR.hybrid_unpack_combine

    def chain(buf, bp_base, tbase, n_valid, *, width, gpad, count, rp):
        vals = ck.unpack_bp_groups(buf, bp_base, width, gpad)
        return ck.hybrid_combine_plain(vals, buf, tbase, n_valid,
                                       count=count, rp=rp)

    label = f"{label} through the unfused chain"
    DR.hybrid_unpack_combine = chain
    try:
        outs, _, _ = timed_pass(torch, path, columns)
        check_groups(outs, groups, columns, label)
        del outs
        keep, seconds, st = timed_pass(torch, path, columns)
        del keep
        rows = sum(len(g[columns[0]]) for g in groups)
        log(f"{label}: warm pass {seconds:.4f} s = {rows / seconds:.1f} "
            f"rows/s; host {st['host_seconds']:.4f} s, dispatch enqueue "
            f"{st['dispatch_seconds']:.4f} s")
        device_breakdown(torch, path, label, columns)
    finally:
        DR.hybrid_unpack_combine = real


def host_breakdown(torch, path: str, label: str, columns) -> None:
    """One more read of ``path`` under ``cProfile``: the host functions
    that take the most time of their own (the host phase is the bottleneck
    lane; the profiler's overhead inflates the total)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    keep, seconds, _ = timed_pass(torch, path, columns)
    prof.disable()
    del keep
    rows = pstats.Stats(prof).sort_stats("tottime")
    log(f"{label}: cProfile'd pass {seconds:.4f} s; top host functions by "
        f"own time:")
    for (fname, line, func), (cc, nc, tt, ct, _) in sorted(
            rows.stats.items(), key=lambda kv: -kv[1][2])[:10]:
        log(f"  host {tt:.4f} s own, {ct:.4f} s cumulative, {nc} calls: "
            f"{os.path.basename(fname)}:{line} {func}")


# ---------------------------------------------------------------------------
# phase 5: the compressed-shipping main path
# ---------------------------------------------------------------------------

def gen_k3_groups(rows: int = K3_ROWS, group: int = K3_GROUP):
    """The reference's K3 file's columns (``tests/test_fused_decode.py``,
    seed 23) plus ``dates32``, INT32 runs of 50 over ``l_shipdate``'s range
    (8035 + 0..2525, ``bench.py``), drawn whole and cut into row groups."""
    import numpy as np

    rng = np.random.default_rng(23)
    cols = {
        "dates": np.repeat(19_000 + rng.integers(0, 1200, -(-rows // 50)),
                           50)[:rows].astype(np.int64),
        "wide": rng.integers(-(1 << 62), 1 << 62, rows),
        "cnt": rng.integers(0, 50_000, rows).astype(np.int32),
        "rate": rng.uniform(0, 1, rows).astype(np.float32),
        "dbl": np.repeat(rng.uniform(0.0, 1.0, -(-rows // 100)),
                         100)[:rows],
        "dates32": np.repeat(8035 + rng.integers(0, 2526, -(-rows // 50)),
                             50)[:rows].astype(np.int32),
    }
    return [{c: v[lo : lo + group] for c, v in cols.items()}
            for lo in range(0, rows, group)]


def write_k3_file(path: str, groups) -> float:
    """GZIP, page CRCs, dictionary off, chunk statistics on: one row group
    per generated group."""
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    types = {"dates": Type.INT64, "wide": Type.INT64, "cnt": Type.INT32,
             "rate": Type.FLOAT, "dbl": Type.DOUBLE, "dates32": Type.INT32}
    schema = build_schema([data_column(c, types[c], FRT.REQUIRED)
                           for c in K3_COLUMNS])
    t0 = time.perf_counter()
    with FileWriter(path, schema, codec=CompressionCodec.GZIP,
                    use_dictionary=False, write_crc=True,
                    write_statistics=True, row_group_size=128 << 20) as w:
        for cols in groups:
            w.write_columns(cols)
            w.flush_row_group()
    return time.perf_counter() - t0


def k3_over_caps(groups) -> list:
    """The ``dates``/``dates32`` streams of ``groups`` that K3 cannot claim,
    found with the port's own host code (narrow transcode, snappy, tag walk,
    ``_fused_narrow_tables``): [(row group, column, ops, depth, payload
    bytes)]."""
    import numpy as np

    from tpu_parquet_torch import device_reader as DR
    from tpu_parquet_torch import native

    over = []
    for g, cols in enumerate(groups):
        for name, width in (("dates", 8), ("dates32", 4)):
            v = cols[name]
            mn = int(v.min())
            k = DR._span_bytes(mn, int(v.max()))
            out = np.empty(len(v) * k, np.uint8)
            native.int_truncate(v, 0, len(v), width, mn, k, out)
            comp = native.snappy_compress(out)
            if DR._fused_narrow_tables(comp, out.nbytes) is None:
                dst_end, _, _, depth = native.snappy_plan(comp, out.nbytes)
                over.append((g, name, len(dst_end), depth, len(comp)))
    return over


def read_k3_path(torch, ck, path: str, groups, smi: str) -> dict:
    """Phase 5: the unforced read through the full planner, checked bit for
    bit, with K3 launched for ``dates`` and ``dates32`` in every row group;
    then a warm pass and the reads forced to ``plain`` and ``fused_plain``."""
    label = "K3 file"
    main = read_main_path(torch, ck, path, groups, label, columns=K3_COLUMNS)
    counts, st = main["counts"], main["stats"]
    routes = st["ship_routes"]
    n_groups = len(groups)
    # dates and dates32 rank fused_narrow_snappy first in every row group;
    # a stream over one of K3's caps (a copy chain deeper than
    # FUSED_MAX_DEPTH) takes the staged narrow_snappy chain with a counted
    # fallback, as in the reference.  cnt and wide fall back once per group
    # (cnt does not compress; wide has no narrow span).
    over = k3_over_caps(groups)
    k3 = counts["fused_narrow_words"]
    staged = routes.get("narrow_snappy", {}).get("streams", 0)
    if k3 != 2 * n_groups - len(over) or staged != len(over):
        raise fail(f"{label}: K3 launched {k3} times and narrow_snappy took "
                   f"{staged} streams; want {2 * n_groups - len(over)} and "
                   f"{len(over)} (dates and dates32 per row group, "
                   f"{len(over)} over K3's caps)")
    if st["fused_fallbacks"] != 2 * n_groups + staged:
        raise fail(f"{label}: fused_fallbacks {st['fused_fallbacks']}, want "
                   f"{2 * n_groups + staged}")
    log(f"{label}: K3 launched for {k3} of the {2 * n_groups} dates/dates32 "
        f"streams; over K3's caps (ops <= {ck.FUSED_MAX_OPS}, depth <= "
        f"{ck.FUSED_MAX_DEPTH}, payload <= {ck.FUSED_MAX_PAYLOAD}), taking "
        f"narrow_snappy: " + (", ".join(
            f"row group {g} {c} ({n} ops, depth {d}, {p} bytes)"
            for g, c, n, d, p in over) or "none"))
    if counts["fused_plain_words"] != 2 * n_groups:
        raise fail(f"{label}: K2 launched {counts['fused_plain_words']} "
                   f"times, want {2 * n_groups} (wide, rate)")
    for route in ("narrow", "recompress"):
        if route not in routes:
            raise fail(f"{label}: the staged chain {route} did not run")
    forced = {}
    for force in ("plain", "fused_plain"):
        outs, seconds, fst = timed_pass(torch, path, K3_COLUMNS, force)
        check_groups(outs, groups, K3_COLUMNS, f"{label} forced {force}")
        del outs
        forced[force] = main["rows"] / seconds
        log(f"{label} forced {force}: {seconds:.4f} s = "
            f"{forced[force]:.1f} rows/s; host {fst['host_seconds']:.4f} "
            f"s, dispatch enqueue {fst['dispatch_seconds']:.4f} s; routes "
            f"{route_table(fst)}; staged {fst['staged_bytes']} bytes ({smi})")
    log(f"{label}: rows/s unforced {main['rows_per_s']:.1f}, forced plain "
        f"{forced['plain']:.1f}, forced fused_plain "
        f"{forced['fused_plain']:.1f} ({smi})")
    main["forced"] = forced
    return main


# ---------------------------------------------------------------------------
# phases 6-7: the whole 16-column lineitem, and PLAIN strings
# ---------------------------------------------------------------------------

def write_lineitem16(path: str, groups, columns=L16_COLUMNS, codec=None,
                     dictionary: bool = True) -> float:
    """``bench.py`` ``gen_lineitem16``'s writer settings with the port's
    writer: the STRING columns UTF8, SNAPPY unless ``codec`` says
    otherwise, dictionary on unless ``dictionary`` is false, DELTA for the
    four DELTA columns, page CRCs, one row group per generated group."""
    from tpu_parquet_torch.column import ByteArrayData, ColumnData
    from tpu_parquet_torch.format import (CompressionCodec, ConvertedType,
                                          Encoding,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column)
    from tpu_parquet_torch.writer import FileWriter

    types = {"l_linenumber": Type.INT32, "l_extendedprice": Type.DOUBLE,
             "l_discount": Type.DOUBLE, "l_tax": Type.DOUBLE,
             "l_shipdate": Type.INT32, "l_commitdate": Type.INT32,
             "l_receiptdate": Type.INT32}

    def column(c):
        if c in STRING_COLUMNS:
            return data_column(c, Type.BYTE_ARRAY, FRT.REQUIRED,
                               ColumnParameters(
                                   logical_type=LogicalType(
                                       STRING=StringType()),
                                   converted_type=ConvertedType.UTF8))
        return data_column(c, types.get(c, Type.INT64), FRT.REQUIRED)

    schema = build_schema([column(c) for c in columns])
    t0 = time.perf_counter()
    with FileWriter(path, schema,
                    codec=CompressionCodec.SNAPPY if codec is None else codec,
                    use_dictionary=dictionary, write_crc=True,
                    row_group_size=128 << 20,
                    column_encodings={c: Encoding.DELTA_BINARY_PACKED
                                      for c in DELTA_COLUMNS
                                      if c in columns}) as w:
        for g in groups:
            w.write_columns({
                c: ColumnData(values=g[c])
                if isinstance(g[c], ByteArrayData) else g[c]
                for c in columns})
            w.flush_row_group()
    return time.perf_counter() - t0


def chunk_encodings(path: str) -> dict:
    """{column: sorted encoding names over the file's chunks}, from the
    port's own footer parse."""
    from tpu_parquet_torch.footer import read_file_metadata
    from tpu_parquet_torch.format import Encoding

    with open(path, "rb") as f:
        meta = read_file_metadata(f)
    out: dict = {}
    for rg in meta.row_groups:
        for chunk in rg.columns:
            name = ".".join(chunk.meta_data.path_in_schema)
            out.setdefault(name, set()).update(
                Encoding(e).name for e in chunk.meta_data.encodings)
    return {c: sorted(v) for c, v in out.items()}


def summary(main: dict, dev: dict, label: str, smi: str) -> None:
    """The phase's numbers on one line, beside the card."""
    st, warm = main["stats"], main["warm"]
    idle = ("not measured" if dev["idle"] is None
            else f"{dev['idle']:.4f}")
    log(f"{label} summary ({smi}): warm pass {main['rows_per_s']:.1f} rows/s "
        f"({main['seconds']:.4f} s); host_seconds {warm['host_seconds']:.4f} "
        f"s; device busy {dev['busy']:.6f} s in {dev['launches']} kernels "
        f"and copies, idle share {idle}; kernel launches "
        f"{ {k: v for k, v in main['counts'].items() if v} }; routes "
        f"{route_table(st)}; link_bytes_logical {st['link_bytes_logical']}, "
        f"link_bytes_shipped {st['link_bytes_shipped']}; "
        f"max_memory_allocated {main['peak']} bytes")


def read_lineitem16(torch, ck, path: str, groups, smi: str) -> dict:
    """Phase 6: all 16 columns on the card, checked against the generator
    (strings included), with the fused K1 launched for the string
    dictionaries' index streams."""
    label = "lineitem16 SF1"
    encs = chunk_encodings(path)
    log(f"{label}: chunk encodings {encs}")
    main = read_main_path(torch, ck, path, groups, label,
                          columns=L16_COLUMNS, dict_column="l_suppkey")
    n_groups = len(groups)
    want = len(STRING_COLUMNS) * n_groups
    if main["ragged_fused"] != want:
        raise fail(f"{label}: {main['ragged_fused']} string index streams "
                   f"planned through hybrid_unpack_combine, want {want}")
    # each planned stream is one launch (read_main_path checks the total)
    log(f"{label}: hybrid_unpack_combine launched "
        f"{main['counts']['hybrid_unpack_combine']} times, "
        f"{main['ragged_fused']} of them for the {len(STRING_COLUMNS)} "
        f"string dictionaries' index streams of {n_groups} row groups")
    if not any("DELTA_BINARY_PACKED" in v for v in encs.values()):
        raise fail(f"{label}: no DELTA_BINARY_PACKED chunk in the file")
    dev = device_breakdown(torch, path, label, columns=L16_COLUMNS)
    summary(main, dev, label, smi)
    host_breakdown(torch, path, label, L16_COLUMNS)
    main["device"] = dev
    return main


def read_plain_strings(torch, ck, groups, work: str, smi: str) -> dict:
    """Phase 7: the five string columns written PLAIN (dictionary off),
    SNAPPY and GZIP, read unforced (SNAPPY keeps the short-string columns'
    pages compressed: ``device_snappy``) and forced to ``plain``, each
    checked."""
    from tpu_parquet_torch.format import CompressionCodec

    out = {}
    for codec in (CompressionCodec.SNAPPY, CompressionCodec.GZIP):
        name = codec.name.lower()
        label = f"PLAIN strings {name}"
        path = os.path.join(work, f"strings_plain_{name}.parquet")
        secs = write_lineitem16(path, groups, columns=STRING_COLUMNS,
                                codec=codec, dictionary=False)
        log(f"wrote {path}: {sum(len(g['l_comment']) for g in groups)} "
            f"rows, {len(groups)} row groups, {os.path.getsize(path)} "
            f"bytes in {secs:.2f} s; encodings {chunk_encodings(path)}")
        main = read_main_path(torch, ck, path, groups, label,
                              columns=STRING_COLUMNS)
        routes = main["stats"]["ship_routes"]
        # on SNAPPY every stream keeps the file's pages, except a stream
        # whose pages hold more snappy ops than the staged chain takes
        # (l_comment: device_reader._SNAPPY_MAX_OPS), which ships plain
        small = (len(STRING_COLUMNS) - 1) * len(groups)
        if (codec == CompressionCodec.SNAPPY and routes.get(
                "device_snappy", {}).get("streams", 0) < small):
            raise fail(f"{label}: routes {route_table(main['stats'])}, "
                       f"want device_snappy for at least {small} streams")
        dev = device_breakdown(torch, path, label, columns=STRING_COLUMNS)
        summary(main, dev, label, smi)
        host_breakdown(torch, path, label, STRING_COLUMNS)
        torch.cuda.reset_peak_memory_stats()
        outs, seconds, fst = timed_pass(torch, path, STRING_COLUMNS, "plain")
        check_groups(outs, groups, STRING_COLUMNS, f"{label} forced plain")
        del outs
        peak = torch.cuda.max_memory_allocated()
        log(f"{label} forced plain ({smi}): {seconds:.4f} s = "
            f"{main['rows'] / seconds:.1f} rows/s; host "
            f"{fst['host_seconds']:.4f} s, dispatch enqueue "
            f"{fst['dispatch_seconds']:.4f} s; routes {route_table(fst)}; "
            f"link_bytes_shipped {fst['link_bytes_shipped']}; "
            f"max_memory_allocated {peak} bytes")
        main["device"] = dev
        main["forced_plain"] = main["rows"] / seconds
        out[name] = main
    return out


# ---------------------------------------------------------------------------
# phases 8-9: lineitem as pyarrow writes it, and the remaining value shapes
# ---------------------------------------------------------------------------

# pyarrow's defaults: the dictionary page limit, the data page size, the
# batch after which it checks both, and the rows per data page
PYARROW_DICT_LIMIT = 1 << 20
PYARROW_PAGE_SIZE = 1 << 20
PYARROW_BATCH = 1024
PYARROW_PAGE_ROWS = 20_000
# l_comment's dictionary limit: its 64 distinct comments take about 2.4 KB
# of PLAIN dictionary, so a limit under that makes the string chunk fall
# back too
COMMENT_DICT_LIMIT = 1 << 10
JULIAN_EPOCH = 2_440_588  # Julian day of 1970-01-01
MIXED_COLUMNS = ["l_orderkey", "l_partkey", "l_extendedprice", "l_comment"]


def _first_seen_dictionary(values):
    """(firsts, ids): the distinct values' first positions in order of
    first appearance, and each value's dictionary id (the port's native
    dictionary build, uncapped)."""
    import numpy as np

    from tpu_parquet_torch import native
    from tpu_parquet_torch.column import ByteArrayData

    n = len(values)
    if isinstance(values, ByteArrayData):
        res = native.dict_build(
            n, n + 1, offsets=np.ascontiguousarray(values.offsets,
                                                   dtype=np.int64),
            heap=np.ascontiguousarray(values.heap))
    else:
        rows = np.ascontiguousarray(values)
        res = native.dict_build(n, n + 1, data=rows,
                                width=rows.nbytes // max(n, 1))
    if res is None or isinstance(res, int):
        raise fail("the native dictionary build is unavailable")
    firsts, inverse = res
    return firsts, inverse.astype(np.int64)


def fallback_layout(values, dict_limit: int, page_size: "int | None" = None):
    """pyarrow's page layout for one dictionary-on REQUIRED column chunk.

    A data page holds at most 20,000 rows (or ``page_size`` encoded bytes)
    and is filled in batches of 1,024 rows.  After each batch the
    dictionary's PLAIN size is checked against ``dict_limit``: once it is
    over, the page in progress is flushed and the rest of the chunk is
    written PLAIN.  A dictionary page is flushed at the bit width of the
    dictionary size at that moment (at least 1), so widths grow page to
    page.  Returns (firsts, ids, dict_len, [(lo, hi, width)] dictionary
    pages, [(lo, hi)] PLAIN pages)."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    page_size = PYARROW_PAGE_SIZE if page_size is None else page_size
    n = len(values)
    firsts, ids = _first_seen_dictionary(values)
    if isinstance(values, ByteArrayData):
        lens = np.diff(np.asarray(values.offsets))
        entry = 4 + lens[firsts]
        value_bytes = np.concatenate([[0], np.cumsum(4 + lens)])
    else:
        row = np.asarray(values).nbytes // max(n, 1)
        entry = np.full(len(firsts), row, dtype=np.int64)
        value_bytes = np.arange(n + 1, dtype=np.int64) * row
    dict_bytes = np.concatenate([[0], np.cumsum(entry)])

    def dict_size(k):  # distinct values among the first k
        return int(np.searchsorted(firsts, k, side="left"))

    def width(k):
        return max(1, int(np.ceil(np.log2(max(dict_size(k), 1)))))

    dict_pages, plain_pages = [], []
    lo, fallen = 0, False
    while lo < n:
        hi = lo
        while hi < n:
            hi = min(hi + PYARROW_BATCH, lo + PYARROW_PAGE_ROWS, n)
            if not fallen and dict_bytes[dict_size(hi)] > dict_limit:
                fallen = "now"
                break
            size = ((hi - lo) * width(hi) // 8 if not fallen
                    else value_bytes[hi] - value_bytes[lo])
            if hi - lo >= PYARROW_PAGE_ROWS or size >= page_size:
                break
        if fallen == "now" or not fallen:
            dict_pages.append((lo, hi, width(hi)))
            if fallen:
                fallen, dict_end = True, hi
        else:
            plain_pages.append((lo, hi))
        lo = hi
    dict_len = dict_size(dict_end if fallen else n)
    return firsts, ids, dict_len, dict_pages, plain_pages


def _fallback_encoder_class():
    """A ``ChunkEncoder`` that lays a REQUIRED chunk out as pyarrow does
    (:func:`fallback_layout`), on the port's own encoders: ``plain`` for
    the dictionary page and the PLAIN suffix, ``rle`` for the index pages,
    the encoder's page writer (compression, headers, CRCs).  Per-column
    dictionary limits in ``limits`` (dotted name -> bytes)."""
    import numpy as np

    from tpu_parquet_torch.chunk_encode import (ChunkEncoder,
                                                ChunkWriteResult, _crc_i32)
    from tpu_parquet_torch.column import ByteArrayData
    from tpu_parquet_torch.format import (ColumnChunk, ColumnMetaData,
                                          DictionaryPageHeader, Encoding,
                                          PageHeader, PageType)
    from tpu_parquet_torch.kernels import plain, rle
    from tpu_parquet_torch.thrift import serialize

    class FallbackEncoder(ChunkEncoder):
        limits: dict = {}
        layouts: dict = {}

        def write(self, cd, sink, offset):
            leaf = self.leaf
            if cd.max_def or cd.max_rep:
                raise fail("the pyarrow-layout writer takes REQUIRED flat "
                           "columns")
            self.write_statistics = False
            values = cd.values
            name = ".".join(leaf.path)
            firsts, ids, dict_len, dpages, ppages = fallback_layout(
                values, self.limits.get(name, PYARROW_DICT_LIMIT))
            self.layouts.setdefault(name, []).append(
                [w for _, _, w in dpages] + ["PLAIN"] * len(ppages))
            ptype = leaf.physical_type
            dict_vals = (values.take(firsts[:dict_len])
                         if isinstance(values, ByteArrayData)
                         else values[firsts[:dict_len]])
            raw = plain.encode(dict_vals, ptype, leaf.type_length)
            comp = self._compress(raw)
            ph = PageHeader(
                type=int(PageType.DICTIONARY_PAGE),
                uncompressed_page_size=len(raw),
                compressed_page_size=len(comp),
                dictionary_page_header=DictionaryPageHeader(
                    num_values=dict_len, encoding=int(Encoding.PLAIN)))
            if self.write_crc:
                ph.crc = _crc_i32(comp)
            hdr = serialize(ph)
            parts = [hdr, comp]
            pos = len(hdr) + len(comp)
            total_unc = len(hdr) + len(raw)
            data_off = None
            pages = ([(lo, hi, Encoding.RLE_DICTIONARY,
                       bytes([w]) + rle.encode(ids[lo:hi].astype(np.uint64),
                                               w))
                      for lo, hi, w in dpages]
                     + [(lo, hi, Encoding.PLAIN, None) for lo, hi in ppages])
            for lo, hi, enc, payload in pages:
                if payload is None:
                    sl = (ByteArrayData(
                        offsets=values.offsets[lo : hi + 1]
                        - values.offsets[lo],
                        heap=values.heap[values.offsets[lo]:
                                         values.offsets[hi]])
                          if isinstance(values, ByteArrayData)
                          else values[lo:hi])
                    payload = plain.encode(sl, ptype, leaf.type_length)
                page_parts, hdr_len, raw_len, _ = self._write_data_page(
                    cd, lo, hi, lo, hi, payload, enc)
                if data_off is None:
                    data_off = offset + pos
                parts.extend(page_parts)
                pos += sum(len(p) for p in page_parts)
                total_unc += raw_len + hdr_len
            for part in parts:
                sink.write(part)
            encodings = {Encoding.PLAIN, Encoding.RLE}
            if dpages:
                encodings.add(Encoding.RLE_DICTIONARY)
            md = ColumnMetaData(
                type=int(ptype), encodings=sorted(int(e) for e in encodings),
                path_in_schema=list(leaf.path), codec=int(self.codec),
                num_values=cd.num_leaf_slots,
                total_uncompressed_size=total_unc,
                total_compressed_size=pos, data_page_offset=data_off,
                dictionary_page_offset=offset)
            return ChunkWriteResult(
                chunk=ColumnChunk(file_offset=offset, meta_data=md),
                total_compressed=pos, total_uncompressed=total_unc)

    return FallbackEncoder


def write_pyarrow_layout(path: str, schema, groups, limits=None) -> dict:
    """Write ``groups`` (one row group each, REQUIRED columns) SNAPPY with
    page CRCs in pyarrow's dictionary-on layout (:func:`fallback_layout`)
    with the port's writer and encoders; returns each column's page layout
    per row group: the index widths of its dictionary pages, then "PLAIN"
    per PLAIN page."""
    from tpu_parquet_torch import writer as W
    from tpu_parquet_torch.format import CompressionCodec

    enc = _fallback_encoder_class()
    enc.limits = dict(limits or {})
    enc.layouts = {}
    real = W.ChunkEncoder
    W.ChunkEncoder = enc
    try:
        with W.FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                          use_dictionary=True, write_crc=True,
                          row_group_size=128 << 20,
                          page_size=PYARROW_PAGE_SIZE) as w:
            for g in groups:
                w.write_columns(g)
                w.flush_row_group()
    finally:
        W.ChunkEncoder = real
    return enc.layouts


def lineitem16_schema(columns=L16_COLUMNS):
    """``bench.py`` ``gen_lineitem16``'s schema (REQUIRED; STRING columns
    UTF8), through the port's schema builder."""
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column)

    types = {"l_linenumber": Type.INT32, "l_extendedprice": Type.DOUBLE,
             "l_discount": Type.DOUBLE, "l_tax": Type.DOUBLE,
             "l_shipdate": Type.INT32, "l_commitdate": Type.INT32,
             "l_receiptdate": Type.INT32}

    def column(c):
        if c in STRING_COLUMNS:
            return data_column(c, Type.BYTE_ARRAY, FRT.REQUIRED,
                               ColumnParameters(
                                   logical_type=LogicalType(
                                       STRING=StringType()),
                                   converted_type=ConvertedType.UTF8))
        return data_column(c, types.get(c, Type.INT64), FRT.REQUIRED)

    return build_schema([column(c) for c in columns])


def width_groups(layout) -> int:
    """Runs of consecutive dictionary pages of one index width."""
    widths = [w for w in layout if w != "PLAIN"]
    return sum(1 for i, w in enumerate(widths) if i == 0 or widths[i - 1] != w)


def read_pyarrow_layout(torch, ck, groups, work: str, smi: str) -> dict:
    """Phase 8: the 16 lineitem16 columns in pyarrow's dictionary-on layout
    (1 MiB dictionary limit; ``l_comment`` 1 KiB), read unforced on the
    card and checked column by column.  ``l_orderkey``, ``l_partkey`` and
    ``l_extendedprice`` overflow their dictionaries: dictionary-encoded
    prefixes whose index widths grow page to page, then PLAIN pages, read by
    ``_finish_mixed_dict_plain`` (its equal-width page groups through the
    fused K1); ``l_comment`` takes the host path (``_finish_host``, its
    dictionary pages through the fused K1 page by page)."""
    from tpu_parquet_torch import device_reader as DR

    label = "lineitem16 pyarrow layout"
    path = os.path.join(work, "lineitem16_pyarrow_layout.parquet")
    t0 = time.perf_counter()
    layouts = write_pyarrow_layout(path, lineitem16_schema(), groups,
                                   {"l_comment": COMMENT_DICT_LIMIT})
    secs = time.perf_counter() - t0
    log(f"wrote {path}: {SF1_ROWS} rows x {len(L16_COLUMNS)} columns, "
        f"{len(groups)} row groups, {os.path.getsize(path)} bytes in "
        f"{secs:.2f} s")
    for c in MIXED_COLUMNS:
        log(f"{label}: {c} pages per row group (index widths, then PLAIN): "
            f"{[sorted(set(map(str, l))) + [len(l)] for l in layouts[c]]}")
        # every full row group falls back (the last, of 1,215 rows, only
        # l_comment: its dictionary limit is 1 KiB)
        full = layouts[c] if c == "l_comment" else layouts[c][:-1]
        if not all("PLAIN" in l and l[0] != "PLAIN" for l in full):
            raise fail(f"{label}: {c} did not fall back to PLAIN in every "
                       f"full row group")
    mixed_plans = []  # (column, accepted) of each mixed-prefix group plan
    in_mixed = [None]
    real_plan = DR._plan_hybrid_pallas
    real_mixed = DR._ChunkAssembler._finish_mixed_dict_plain

    def plan_spy(*args):
        plan = real_plan(*args)
        if in_mixed[0] is not None:
            mixed_plans.append((in_mixed[0], plan is not None))
        return plan

    def mixed_spy(self, common, stager):
        in_mixed[0] = ".".join(self.leaf.path)
        try:
            return real_mixed(self, common, stager)
        finally:
            in_mixed[0] = None

    DR._plan_hybrid_pallas = plan_spy
    DR._ChunkAssembler._finish_mixed_dict_plain = mixed_spy
    try:
        main = read_main_path(torch, ck, path, groups, label,
                              columns=L16_COLUMNS, dict_column="l_suppkey")
    finally:
        DR._plan_hybrid_pallas = real_plan
        DR._ChunkAssembler._finish_mixed_dict_plain = real_mixed
    want_groups = sum(width_groups(l) for c in MIXED_COLUMNS[:3]
                      for l in layouts[c] if "PLAIN" in l)
    # read_main_path reads twice (checked, then warm): the first read's
    first = mixed_plans[: len(mixed_plans) // 2]
    accepted = sum(ok for _, ok in first)
    if len(mixed_plans) != 2 * want_groups or not accepted:
        raise fail(f"{label}: {len(first)} mixed-prefix group plans "
                   f"({accepted} through the fused K1), want {want_groups} "
                   f"equal-width page groups")
    log(f"{label}: hybrid_unpack_combine launched "
        f"{main['counts']['hybrid_unpack_combine']} times (the accepted "
        f"plans: {accepted} of the {want_groups} equal-width page groups of "
        f"the dictionary-fallback prefixes, plus the dictionary chunks' "
        f"streams and l_comment's dictionary pages)")
    dev = device_breakdown(torch, path, label, columns=L16_COLUMNS)
    summary(main, dev, label, smi)
    host_breakdown(torch, path, label, L16_COLUMNS)
    main["device"] = dev
    main["mixed_groups"] = (accepted, want_groups)
    return main


def value_shape_groups(draws) -> list:
    """Phase 9's columns from the lineitem16 draw: ``l_returnflag == "R"``
    and ``l_linestatus == "O"`` as booleans, ``l_shipdate`` and
    ``l_commitdate`` as INT96 timestamps (Julian day, zero nanoseconds, as
    Spark and Impala write them), ``l_extendedprice`` as decimal(15,2) in a
    7-byte big-endian FIXED_LEN_BYTE_ARRAY (Spark's legacy format), and
    ``l_discount``, ``l_tax``, ``l_comment``, ``l_shipmode`` and
    ``l_shipinstruct`` as drawn."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    out = []
    for g in draws:
        n = len(g["l_orderkey"])

        def int96(days):
            words = np.zeros((n, 3), dtype=np.uint32)
            words[:, 2] = days.astype(np.int64) + JULIAN_EPOCH
            return words

        cents = np.round(g["l_extendedprice"] * 100).astype(np.int64)
        dec = ((cents[:, None] >> (8 * np.arange(6, -1, -1))) & 0xFF).astype(
            np.uint8)
        out.append({
            "l_returnflag_r": g["l_returnflag"][1] == 2,
            "l_linestatus_o": g["l_linestatus"][1] == 1,
            "l_shipdate_int96": int96(g["l_shipdate"]),
            "l_extendedprice_dec": ByteArrayData(
                offsets=np.arange(n + 1, dtype=np.int64) * 7,
                heap=dec.reshape(-1)),
            "l_discount": g["l_discount"],
            "l_tax": g["l_tax"],
            "l_comment": ByteArrayData.from_list(
                g["l_comment"][0]).take(g["l_comment"][1]),
            "l_shipmode": ByteArrayData.from_list(
                g["l_shipmode"][0]).take(g["l_shipmode"][1]),
            "l_shipinstruct": ByteArrayData.from_list(
                g["l_shipinstruct"][0]).take(g["l_shipinstruct"][1]),
            "l_commitdate_int96": int96(g["l_commitdate"]),
        })
    return out


VALUE_SHAPE_ENCODINGS = {
    "l_returnflag_r": "PLAIN", "l_linestatus_o": "RLE",
    "l_shipdate_int96": "PLAIN", "l_extendedprice_dec": "PLAIN",
    "l_discount": "BYTE_STREAM_SPLIT", "l_tax": "BYTE_STREAM_SPLIT",
    "l_comment": "DELTA_LENGTH_BYTE_ARRAY",
    "l_shipmode": "DELTA_BYTE_ARRAY", "l_shipinstruct": "DELTA_BYTE_ARRAY",
}


def write_value_shapes(path: str, groups) -> float:
    """Phase 9's file: the port's writer, dictionary off, SNAPPY, page CRCs,
    each column in its ``VALUE_SHAPE_ENCODINGS`` encoding."""
    from tpu_parquet_torch.format import (CompressionCodec, ConvertedType,
                                          DecimalType, Encoding,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column)
    from tpu_parquet_torch.writer import FileWriter

    utf8 = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                            converted_type=ConvertedType.UTF8)
    types = {
        "l_returnflag_r": (Type.BOOLEAN, None),
        "l_linestatus_o": (Type.BOOLEAN, None),
        "l_shipdate_int96": (Type.INT96, None),
        "l_extendedprice_dec": (Type.FIXED_LEN_BYTE_ARRAY, ColumnParameters(
            logical_type=LogicalType(DECIMAL=DecimalType(scale=2,
                                                         precision=15)),
            converted_type=ConvertedType.DECIMAL, type_length=7, scale=2,
            precision=15)),
        "l_discount": (Type.DOUBLE, None), "l_tax": (Type.DOUBLE, None),
        "l_comment": (Type.BYTE_ARRAY, utf8),
        "l_shipmode": (Type.BYTE_ARRAY, utf8),
        "l_shipinstruct": (Type.BYTE_ARRAY, utf8),
    }
    schema = build_schema([data_column(c, t, FRT.REQUIRED, p)
                           for c, (t, p) in types.items()])
    t0 = time.perf_counter()
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    use_dictionary=False, write_crc=True,
                    row_group_size=128 << 20,
                    column_encodings={c: Encoding[e] for c, e in
                                      VALUE_SHAPE_ENCODINGS.items()}) as w:
        for g in groups:
            w.write_columns({c: g[c] for c in types})
            w.flush_row_group()
    return time.perf_counter() - t0


def read_value_shapes(torch, ck, groups, work: str, smi: str) -> dict:
    """Phase 9: BOOLEAN PLAIN and RLE, INT96, decimal FLBA,
    BYTE_STREAM_SPLIT, DELTA_LENGTH_BYTE_ARRAY and DELTA_BYTE_ARRAY columns
    at SF1, read on the card and checked bit for bit against the draw; the
    boolean RLE pages go through the fused K1 (width 1); then an INT96
    column with the dictionary on, whose ``DeviceDictColumn`` is checked
    (``materialize()`` on the card against ``to_host()``)."""
    from tpu_parquet_torch import device_reader as DR

    label = "value shapes"
    cols = list(VALUE_SHAPE_ENCODINGS)
    path = os.path.join(work, "value_shapes_sf1.parquet")
    secs = write_value_shapes(path, groups)
    log(f"wrote {path}: {SF1_ROWS} rows x {len(cols)} columns, "
        f"{len(groups)} row groups, {os.path.getsize(path)} bytes in "
        f"{secs:.2f} s; encodings {chunk_encodings(path)}")
    bool_plans = []
    real_plan = DR._plan_hybrid_pallas

    def plan_spy(stager, pages_info, width, total, count_pad):
        plan = real_plan(stager, pages_info, width, total, count_pad)
        if width == 1:
            bool_plans.append(plan is not None)
        return plan

    DR._plan_hybrid_pallas = plan_spy
    try:
        main = read_main_path(torch, ck, path, groups, label, columns=cols)
    finally:
        DR._plan_hybrid_pallas = real_plan
    # read_main_path reads twice (checked, then warm): the first read's
    first = bool_plans[: len(bool_plans) // 2]
    if not any(first):
        raise fail(f"{label}: no boolean RLE page went through "
                   f"hybrid_unpack_combine ({len(first)} planned)")
    if main["counts"]["hybrid_unpack_combine"] != sum(first):
        raise fail(f"{label}: {main['counts']['hybrid_unpack_combine']} "
                   f"fused K1 launches for {sum(first)} boolean RLE pages")
    log(f"{label}: hybrid_unpack_combine launched "
        f"{main['counts']['hybrid_unpack_combine']} times for the "
        f"{len(first)} boolean RLE pages of l_linestatus_o")
    dev = device_breakdown(torch, path, label, columns=cols)
    summary(main, dev, label, smi)
    host_breakdown(torch, path, label, cols)
    main["device"] = dev
    # an INT96 column with the dictionary on
    dict_label = "INT96 dictionary"
    dict_path = os.path.join(work, "int96_dict_sf1.parquet")
    from tpu_parquet_torch.format import FieldRepetitionType as FRT, Type
    from tpu_parquet_torch.schema.core import build_schema, data_column

    write_pyarrow_layout(
        dict_path, build_schema([data_column("l_commitdate_int96",
                                             Type.INT96, FRT.REQUIRED)]),
        [{"l_commitdate_int96": g["l_commitdate_int96"]} for g in groups])
    main["int96_dict"] = read_main_path(
        torch, ck, dict_path, groups, dict_label,
        columns=["l_commitdate_int96"], dict_column="l_commitdate_int96")
    return main


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
    # what the timing below reads for a launch that does almost nothing:
    # every kernel time includes it
    tiny = torch.empty(1, dtype=torch.int32, device="cuda")
    log(f"timing floor: one 4-byte fill timed as the kernels are, "
        f"{_median_ms(torch, tiny.zero_, flush):.4f} ms ({smi})")
    k1 = check_k1(torch, ck, flush, rng, smi)
    # the SF1 file (phase 3) first: its row group 0 gives the fused K1's
    # main-path shapes
    work = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    draws = list(draw_lineitem16(SF1_ROWS))
    groups = [{c: g[c] for c in COLUMNS} for g in draws]
    req_path = os.path.join(work, "lineitem_sf1_required.parquet")
    secs = write_lineitem(req_path, groups, optional=False)
    log(f"wrote {req_path}: {SF1_ROWS} rows, {len(groups)} row groups, "
        f"{os.path.getsize(req_path)} bytes in {secs:.2f} s")
    hyb = check_hybrid(torch, ck, flush, rng, smi, req_path)
    k2 = check_k2(torch, ck, flush, rng, smi)
    k3_groups = gen_k3_groups()
    k3 = check_k3(torch, ck, flush, rng, smi, k3_groups[0]["dates"])
    del flush

    # phase 3: main path, REQUIRED lineitem SF1
    main = read_main_path(torch, ck, req_path, groups, "REQUIRED lineitem",
                          dict_column="l_suppkey")
    for name in ("hybrid_unpack_combine", "fused_plain_words"):
        if main["counts"][name] <= 0:
            raise fail(f"main path never launched {name}")
    device_breakdown(torch, req_path, "REQUIRED lineitem")
    unfused_yardstick(torch, ck, req_path, groups, "REQUIRED lineitem")

    # phase 4: main path, OPTIONAL lineitem (no nulls), 1M rows
    opt_groups = groups[:1]
    opt_path = os.path.join(work, "lineitem_1m_optional.parquet")
    secs = write_lineitem(opt_path, opt_groups, optional=True)
    log(f"wrote {opt_path}: {ROWS_PER_GROUP} rows in {secs:.2f} s")
    opt = read_main_path(torch, ck, opt_path, opt_groups, "OPTIONAL lineitem",
                         dict_column="l_suppkey")
    if opt["counts"]["hybrid_unpack_combine"] <= 0:
        raise fail("OPTIONAL path never launched hybrid_unpack_combine")
    device_breakdown(torch, opt_path, "OPTIONAL lineitem")
    unfused_yardstick(torch, ck, opt_path, opt_groups, "OPTIONAL lineitem")

    # phase 5: the compressed-shipping main path, the reference's K3 file
    k3_path = os.path.join(work, "k3_file_gzip.parquet")
    secs = write_k3_file(k3_path, k3_groups)
    log(f"wrote {k3_path}: {K3_ROWS} rows, {len(k3_groups)} row groups of "
        f"{K3_GROUP} (the last {len(k3_groups[-1]['dates'])}), "
        f"{os.path.getsize(k3_path)} bytes in {secs:.2f} s")
    k3_main = read_k3_path(torch, ck, k3_path, k3_groups, smi)
    device_breakdown(torch, k3_path, "K3 file", columns=K3_COLUMNS)
    host_breakdown(torch, k3_path, "K3 file", K3_COLUMNS)

    # phase 6: the whole 16-column lineitem, SF1, strings and delta included
    l16_groups = [lineitem_strings(g) for g in draws]
    l16_path = os.path.join(work, "lineitem16_sf1.parquet")
    secs = write_lineitem16(l16_path, l16_groups)
    log(f"wrote {l16_path}: {SF1_ROWS} rows x {len(L16_COLUMNS)} columns, "
        f"{len(l16_groups)} row groups, {os.path.getsize(l16_path)} bytes "
        f"in {secs:.2f} s")
    l16 = read_lineitem16(torch, ck, l16_path, l16_groups, smi)

    # phase 7: the string columns written PLAIN, SNAPPY and GZIP
    strings = read_plain_strings(
        torch, ck, [{c: g[c] for c in STRING_COLUMNS}
                    for g in l16_groups[:PLAIN_STRING_GROUPS]], work, smi)

    # phase 8: the 16 columns in pyarrow's layout (dictionary fallback)
    pa_layout = read_pyarrow_layout(torch, ck, l16_groups, work, smi)
    del l16_groups

    # phase 9: the remaining value shapes
    shapes = read_value_shapes(torch, ck, value_shape_groups(draws), work,
                               smi)
    del draws

    # the kernels line and the result line
    t14 = k1["timings"][14]
    kernels = [
        {"name": "hybrid_unpack_combine", "route": "cuda",
         "source": "tpu_parquet_torch/csrc/bp_unpack.cu",
         "replaces": "tpu_parquet/pallas_kernels.py:93",
         "launches": main["counts"]["hybrid_unpack_combine"],
         "max_abs_err": hyb["worst"], "ms": hyb["ms"],
         "plain_ms": hyb["plain_ms"], "bound_ms": hyb["bound_ms"],
         "bound_by": "bytes", "library_ms": None},
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
        {"name": "fused_narrow_words", "route": "cuda",
         "source": "tpu_parquet_torch/csrc/fused_narrow.cu",
         "replaces": "tpu_parquet/pallas_kernels.py:353",
         "launches": k3_main["counts"]["fused_narrow_words"],
         "max_abs_err": k3["worst"], "ms": k3["ms"],
         "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None},
    ]
    log(f"main path rows/s: REQUIRED {main['rows_per_s']:.1f}, "
        f"OPTIONAL {opt['rows_per_s']:.1f}, K3 file unforced "
        f"{k3_main['rows_per_s']:.1f}, lineitem16 {l16['rows_per_s']:.1f}, "
        f"PLAIN strings snappy {strings['snappy']['rows_per_s']:.1f} "
        f"(forced plain {strings['snappy']['forced_plain']:.1f}), gzip "
        f"{strings['gzip']['rows_per_s']:.1f} (forced plain "
        f"{strings['gzip']['forced_plain']:.1f}), lineitem16 pyarrow layout "
        f"{pa_layout['rows_per_s']:.1f}, value shapes "
        f"{shapes['rows_per_s']:.1f}, INT96 dictionary "
        f"{shapes['int96_dict']['rows_per_s']:.1f}; hybrid_unpack_combine "
        f"launches: lineitem16 {l16['counts']['hybrid_unpack_combine']}, "
        f"pyarrow layout {pa_layout['counts']['hybrid_unpack_combine']} "
        f"(mixed-prefix groups through it {pa_layout['mixed_groups'][0]} of "
        f"{pa_layout['mixed_groups'][1]}), value shapes "
        f"{shapes['counts']['hybrid_unpack_combine']} ({smi})")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
