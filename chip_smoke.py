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
10. nested columns.  (a) TPC-H orders with their lineitems nested: the
    6,001,215 lineitems of phase 6's draw (six of their columns) grouped
    into orders of 1-7 lineitems (an OPTIONAL LIST of a REQUIRED group),
    the port's writer (ColumnData with def and rep levels), SNAPPY,
    dictionary on, page CRCs, 250,000 orders per row group.  (b) edge
    shapes at 200,000 rows, data pages v2, dictionary on: ``input_ids``
    LIST<INT32> (lengths 0-512, a 32,000-token vocabulary), ``tags``
    LIST<OPTIONAL INT64>, ``attrs`` MAP<STRING, OPTIONAL INT64> and
    ``matrix`` LIST<LIST<OPTIONAL INT32>> (``max_rep`` 2).  Each read on the
    card, checked bit for bit (values, def and rep levels), rows counted on
    the card with ``row_starts_from_rep``, one leaf scattered to its slots
    with ``scatter_defined``; the fused K1 must run on rep-level streams
    (its launches printed by stream: rep, def, index); a warm, a profiled
    and a cProfile'd pass.  Row group 0 of (a) also through the host
    ``FileReader``: equal to the device read, and ``iter_rows_logical()``
    giving back the generator's first 1,000 orders;
11. the host pipeline: (a) lineitem16 SF1 (phase 6's file), (b) the
    pyarrow layout (phase 8's) and (c) the K3 file (phase 5's), each read
    with ``DeviceFileReader(prefetch=p).iter_row_groups()`` for p in
    {0, 2, K}, K = min(8, os.cpu_count()): every depth bit-equal to prefetch
    0 on the card (every tensor of every column), launch counts and routes
    equal to the file's own phase, warm rows/s, ``pipeline_stats()`` (stage
    seconds, stall, peak in flight, overlap), ``host_seconds`` and
    ``max_memory_allocated`` per depth, and a profiled pass at K; (d)
    lineitem16 SF1 written as 7 one-group files with phase 6's writer
    settings and a ``tpq_manifest.json``, read through ``scan_files`` at 0
    and K with ``max_memory`` 256 MiB (bytes in flight under it), through
    the manifest, and at K under a non-default ``torch.cuda.Stream``: every
    row group bit-equal to (a)'s, launches equal to phase 6's; (e) the host
    ``FileReader(prefetch=p).read_all()`` at 0 and K, equal;
12. filtered and contained scans (predicate pushdown, the ScanPlan IR,
    quarantine).  (a) ``row_filter = col("l_orderkey").between(lo, hi)``
    on phase 6's file (chunk and page statistics on; ``l_orderkey`` is
    sorted), a window of about 3% of the keys around the start of row group
    2: (a1) phase 3's seven columns, whose pages share an edge every
    262,144 rows, and (a2) all 16 columns; group pruning must keep row
    groups 1 and 2, and (a1) must prune pages.  The yielded rows must be
    the generator's rows of the pages the plan kept, every window row among
    them, in every column; pages parsed + pruned equal the kept groups'
    pages; each fused stream one launch on the surviving pages.  (b) TPC-H
    Q6's predicate (``l_shipdate`` in 1994, ``l_discount`` 0.05-0.07,
    ``l_quantity`` < 24) on unsorted dates: nothing pruned, bit-equal to
    the unfiltered read, warm rows/s beside it.  (c) (a1) again through
    ``plan=`` its serialized and deserialized ``ScanPlan``: bit-equal,
    equal routes, pruning and launches, no header walk.  (d) (a1) at
    prefetch K and under a non-default stream, and ``scan_files`` with the
    filter over phase 11's seven shards at 0 and K (five shards read no
    chunk).  (e) the host ``FileReader``'s group pruning.  (f) a copy of
    phase 5's K3 file with row group 40's ``dates`` page corrupted
    (``writer.corrupt_page``, CRC on): ``skip_unit`` at 0 and K (one
    record, the other 91 groups bit-exact, K3 launched phase 5's count
    less group 40's), ``raise`` (the same error with and without a
    policy), and ``scan_files`` with the clean file under ``skip_unit``
    and ``skip_file``; after every pass no ``tpq-`` thread, no pinned
    buffer out of its pool and no byte in a reader's device ledger;
13. reads through byte stores (``iostore``, ``iostore_async``,
    ``resilience``), reusing the files of phases 3, 5, 6 and 11: (a)
    lineitem16 SF1 through ``FaultInjectingStore(LocalStore(f),
    FaultSpec(latency_s=0.020))`` at prefetch 0, K threaded
    (``TPQ_IO_ASYNC=0``) and K through the fetch engine, beside the same
    reads through a plain ``LocalStore``: every read bit-equal (checked
    against the generator, then on the card), launches, routes, staged and
    link bytes equal, rows/s, requests, coalesced spans, the engine's peak
    in flight and the device's idle share; (b) the fault matrix
    (``fail_first=2``, ``torn_first=1``, both) on phase 3's file and the K3
    file at prefetch 0 and K, threaded and through the engine, each
    bit-equal with the clean read's launches; (c) one lineitem16 chunk
    failing past its retries: ``RetryExhaustedError`` with its attempt
    log; (d) the K3 file through the engine, ended by a timer's
    ``cancel()`` and by ``CancelToken.with_timeout``; (e)
    ``FaultSpec(corrupt="bitflip")`` on one K3 chunk under ``skip_unit``:
    one record, K3 launched twice less; (f) phase 11's seven shards through
    ``scan_files`` under ``ChaosSchedule.store_factory``.  After every
    read: no ``tpq-`` thread (the engine shut down, with the outputs alive
    on the card), no pinned buffer out, an empty device ledger, no budget;
    a clean re-read after each failure bit-equal;
14. the read caches (``serve.PlanCache``, ``serve.ResultCache``), reusing
    the files of phases 6, 8 and 11: (a) lineitem16 SF1's 16 columns
    through ``PlanCache(result_cache_mb=0, result_cache_hbm_mb=2048)
    .reader_kwargs(path, device=True)``, once cold (launches equal phase
    6's) and twice warm (no store read, no launch, no byte allocated, every
    tensor equal to the cold read's), and the bytes the cache keeps
    allocated against the bytes its tier counts; rows/s uncached, cold and
    warm; (b) the same reads through a 256 MiB device tier: evictions
    inside it, its ledger never over the cap, bit-equal, and the device
    memory back to its level once the cache is dropped; (c) phase 8's
    pyarrow-layout file through the dictionary cache alone, twice: the
    second read adopts every dictionary, bit-equal, with equal launches and
    routes; (d) TPC-H Q6 through ``scan_files(plan_cache=)`` over phase
    11's seven shards, two sweeps at prefetch 0 and two at K through the
    fetch engine, with the plan cache alone (the second sweep walks no
    footer and no page header) and with a device tier (the second reads
    nothing and launches nothing), each bit-equal to the unfiltered read;
    (e) one shard rewritten with a new seed and ``note_mutation``: its
    entries dropped and counted exactly, the re-read bit-equal to the new
    generator; (f) a warm read on a non-default stream, bit-equal.  After
    every pass: no ``tpq-`` thread, no pinned buffer out, an empty device
    ledger in every reader, and the cache's ledger holding its tier's
    bytes;
15. obs on the card, lineitem16 SF1 (phase 6's file): (a) a read with
    every option on (``trace=`` a path, ``sample_ms=50``, ``hang_s=30``,
    the device lane) bit-equal to the plain read, rows/s of both in turns
    (plain, obs, obs, plain), the trace holding the stage spans, the
    sampler's tracks and the lane's ``device.*`` spans; (b) the device
    lane's launches per CUDA kernel equal to the launch counters' rise,
    and its serialized seconds within the read's device window (two
    timing events around the read); (c) ``profile_dir=`` on the same read:
    a ``torch.profiler`` trace naming ``hybrid_unpack_combine`` and
    ``fused_plain_words`` and the stages, its kernel times printed beside
    the lane's per-route and per-kernel seconds, and a ``TPQ_XPROF``
    window on phase 5's K3 file naming ``fused_narrow_words``; (d) a
    store stalling on its third fetch at prefetch 4 with
    ``hang_s=2``, ``hang_policy="raise"``: ``HangError`` within 4 s, its
    flight dump autopsied as ``network-stall``, and, with the garbage
    collector off, the device memory back to the phase's baseline after
    the hang and after a cancelled read (the verdicts still held);
16. training input on the card, ``bench.py`` ``bench_loader``'s
    configuration: lineitem16 SF1 (the 16 columns, phase 6's writer) in
    250,000-row groups (25 units), its 11 fixed-width columns, batches of
    8,192, ``shuffle=True``, ``seed=11``, ``shuffle_window=65536``,
    ``drop_remainder``, ``to_device=True``.  (a) an untimed epoch checked
    batch by batch against a ``to_device=False`` epoch, then prefetch 0
    and 4 in turns, two epochs each, each bit-equal to it by a per-batch
    checksum on the card; rows/s, ``decode_wait_seconds`` and
    ``max_memory_allocated`` of each, and ``loader_vs_scan`` against a
    ``scan_files`` pass of the same columns; (b) a ``state_blob()`` after
    300 batches at prefetch 0, restored into a fresh loader at prefetch 4:
    the first batches plus the rest equal the uninterrupted epoch; (c)
    shards (i, 4) partition the rows exactly; (d) unshuffled, the loader's
    batches equal ``DeviceFileReader.iter_batches(8192)``'s, with the
    reader's fused K1 and K2 launches on that pass as ``loader_launches``
    (the loader itself launches none); (e) ``parallel`` on NCCL, a world of
    one (a ``file://`` rendezvous): the sharded dictionary (with stats),
    DELTA and PLAIN decodes and ``column_stats`` on 64 pages of 20,000
    values of ``l_suppkey`` (a 10,000-row int64 dictionary),
    ``l_orderkey`` and ``l_extendedprice``, each equal to its plain CPU
    decode, and ``process_local_column(l_orderkey)`` equal to the device
    reader's column; (f) the resumed loader's ``TPQ_OBS_SPOOL`` member seen
    by ``FleetAggregator`` with its lanes, and a ledger record of the
    phase's numbers fingerprinted ``kernel_mode == "cuda"``, checked
    against itself.  After it: no loader thread alive, the device memory
    back to its baseline;
17. the serve tier on the card (``serve.ScanService``, device requests on
    ``cuda``), reusing the files of phases 5, 6 and 16: (a) ``bench.py``
    ``bench_serve``'s sweep, 1, 4 and 16 client threads on one service of
    min(clients, 8) workers, device requests over lineitem16 SF1 with the
    projections rotating over its 16 columns, the first 8 and the first
    1, at least 12 requests per count, every response bit-equal on the
    card to an uncached read of its columns; rows/s served, request p50,
    p95 and p99, ``queue_wait_seconds``, the plan cache's hit rate and the
    launches (the fused K1 and K2 must run); (b) one device request over
    the K3 file: exact, K3 launched as in phase 5; (c) a 2 GiB device
    tier: a second identical request exact, with no store read and no
    launch; (d) ``bench_serve_tenants``' shape cut to one round: a victim
    (weight 3) and a noisy tenant's flood (weight 1), one worker, 20 ms
    per range, isolated, FIFO and fair: fair's victim p99 must be under
    FIFO's; (e) a device stream (``stream=True, device=True,
    batch_rows=8192``) over phase 16's 11 fixed-width columns: every full
    batch equal to ``DeviceFileReader.iter_batches``', the padded tail to
    the file, a cursor resumed bit-identically, a deadline and a cancel
    ending it typed; (f) a blacked-out file tripping its breaker while a
    healthy one stays exact, brownout shedding ``PRIORITY_LOW`` and
    admitting ``PRIORITY_HIGH``, a stalled store under ``hang_s=2``
    raising ``HangError`` for its request alone.  After every service: no
    worker alive and no budget held; after the phase no ``tpq-`` thread
    and no byte above its start;
18. the write side, read back on the card: (a) ``bench.py``
    ``bench_write_scale``'s encode, 12 row groups of 500,000 rows (``k``
    INT64 below 2^40, ``v`` DOUBLE, seed 11), with the single
    ``FileWriter`` and ``write.write_sharded`` at 1, 4 and 8 workers, each
    file byte-identical to the single writer's, rows/s and the
    ``WriteStats`` lanes of each, then the file read on the card against
    the batches; (b) lineitem16 SF1 (phase 6's groups and writer settings)
    through ``write_sharded`` at 4 workers: as one file, byte-identical to
    phase 6's, and as a manifest dataset, read through ``scan_files`` on
    the card bit-equal to phase 6's file with phase 6's launches; (c)
    (a)'s batches as 48 files of 125,000 rows, ``compact``ed (files,
    codec, modeled ``link_bytes_ratio``, seconds), both datasets read
    through ``scan_files`` on the card in turns, exact, rows/s and the
    measured link bytes shipped beside the modeled ratio; (d) the
    fragmented dataset compacted twice with a ``PlanCache`` while a
    ``ScanService(device="cuda")`` sweeps it: every sweep one whole
    generation, equal to the batches; (e) ``merge_files`` over (b)'s
    members: byte-identical to phase 6's file, read on the card bit-equal;
    (f) 100,000 records through ``floor.Writer`` (timestamps in each unit,
    INT96, decimal, uuid, a nested record), equal through ``floor.Reader``,
    the leaves on the card equal to the host reader's.  After it: no
    ``tpq-`` thread, no temporary file, no byte above its start;
19. the CLI, ``python -m tpu_parquet_torch.cli.pq_tool`` and
    ``tpu_parquet_torch.cli.csv2parquet`` as child processes: (a)
    ``rowcount``, ``meta``, ``schema`` and ``stats`` on phase 6's
    lineitem16 SF1 file, checked against the generator; (b) on a
    100,000-row lineitem16 cut (phase 6's generator and writer settings:
    ``cat`` and ``split`` make one Python call per row), ``head``, ``cat``
    (every field of every row against the generator), ``split`` into at
    least 3 parts and ``merge`` of the parts; (c) ``merge`` of phase
    18(b)'s manifest members, byte-identical to phase 6's file, with phase
    6's launches; (d) ``compact`` of 18(c)'s 48 fragments, made again; (e)
    ``csv2parquet`` of the cut as CSV with type hints (dates as DATE); (f)
    ``trace`` and ``doctor`` on phase 15's trace, ``autopsy`` on its hang
    dump (phase 15's verdict) and ``top`` on phase 16's spool.  Every
    output file read back through ``DeviceFileReader(device="cuda")``,
    exactly; each command's seconds printed;
20. the fuzz harness, ``python -m tpu_parquet_torch.fuzz --device cuda``
    in a child process (a kernel's fault cannot poison this one): every
    file of ``tests/fuzz_corpus/`` and ``tests/fuzz_corpus_torch/``
    replayed, then ``tests/test_fuzz.py``'s smoke batch (seed 1234, 120
    runs of ``file_reader``, 400 of every other target) with
    ``device_reader`` and ``result_cache`` on the card, crashers not
    saved: no crasher, the fused K1 launched, the seconds and launches
    per kernel printed;
21. one JSON line listing every ported kernel (with phase 11's launches as
    ``pipeline_launches``, phase 12's as ``filter_launches``, phase 13's
    as ``store_launches``, phase 14's as ``cache_launches``, phase 15's
    as ``obs_launches``, phase 16's as ``loader_launches``, phase 17's
    as ``serve_launches``, phase 18's as ``write_launches``, phase 19's
    as ``cli_launches`` and phase 20's as ``fuzz_launches``), then the
    result line.

Any failure exits non-zero; no phase swallows its own failure.
"""

from __future__ import annotations

import dataclasses
import datetime
import decimal
import json
import os
import shutil
import subprocess
import sys
import time
import uuid

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

def draw_lineitem16(rows: int, rows_per_group: int = ROWS_PER_GROUP,
                    seed: int = 4):
    """Yield per-row-group dicts of ``bench.py`` ``gen_lineitem16``'s 16
    columns, drawn exactly as it draws them (its seed is 4): the integer and
    float columns as arrays, each STRING column as ``(pool, indices)`` (the
    strings are ``pool[indices]``; :func:`lineitem_strings` builds them)."""
    import numpy as np

    flags = [b"A", b"N", b"R"]
    status = [b"F", b"O"]
    instr = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE",
             b"TAKE BACK RETURN"]
    modes = [b"AIR", b"FOB", b"MAIL", b"RAIL", b"REG AIR", b"SHIP", b"TRUCK"]
    words = [f"word{i}".encode() for i in range(64)]
    comment_pool = [b" ".join(words[j % 64] for j in range(i, i + 5))
                    for i in range(256)]
    rng = np.random.default_rng(seed)
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
                   columns=COLUMNS, dict_column: "str | None" = None,
                   check=check_groups) -> dict:
    """Read ``path`` on the card through the public entry point and the full
    ship planner (unforced), check every column bit for bit, and time a
    warm second pass.  The first pass also counts the planned hybrid
    streams, and among them the string dictionaries' index streams
    (``ragged_fused``).  ``dict_column`` names a fixed-width dictionary
    column that must come back as a ``DeviceDictColumn`` whose device
    ``materialize()`` equals its ``to_host()`` in every row group.
    ``check(outs, groups, columns, label)`` checks the first pass and
    returns (rows, decoded bytes)."""
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
    rows, decoded = check(outs, groups, columns, label)
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


def device_breakdown(torch, path: str, label: str, columns=COLUMNS,
                     prefetch: int = 0, **reader_kw) -> dict:
    """One more read of ``path`` under ``torch.profiler`` (at ``prefetch``;
    ``reader_kw`` go to the reader: a row filter, a data-error policy):
    device time by kernel (and copy), and the device's idle share of the
    profiled wall.  The profiler's own host overhead lengthens that wall,
    so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    # acc_events: keep every event of the pass (without it the profiler
    # dropped one row group's events of the 92-group read)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        with DeviceFileReader(path, columns=columns, prefetch=prefetch,
                              **reader_kw) as r:
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
                idle=1 - busy_s / wall if busy_s else None,
                per_launch_us={name: us / n for name, (us, n)
                               in by_name.items() if "tpq_" in name})


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

def lineitem16_layout(columns=L16_COLUMNS, codec=None,
                      dictionary: bool = True) -> tuple:
    """``bench.py`` ``gen_lineitem16``'s schema and writer settings for the
    port's writer: the STRING columns UTF8, SNAPPY unless ``codec`` says
    otherwise, dictionary on unless ``dictionary`` is false, DELTA for the
    four DELTA columns, page CRCs.  Returns ``(schema, FileWriter
    keywords)``."""
    from tpu_parquet_torch.format import (CompressionCodec, ConvertedType,
                                          Encoding,
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

    return build_schema([column(c) for c in columns]), dict(
        codec=CompressionCodec.SNAPPY if codec is None else codec,
        use_dictionary=dictionary, write_crc=True, row_group_size=128 << 20,
        column_encodings={c: Encoding.DELTA_BINARY_PACKED
                          for c in DELTA_COLUMNS if c in columns})


def lineitem16_batch(g: dict, columns=L16_COLUMNS) -> dict:
    """One generated group as the writer's batch (strings as
    ``ColumnData``)."""
    from tpu_parquet_torch.column import ByteArrayData, ColumnData

    return {c: ColumnData(values=g[c]) if isinstance(g[c], ByteArrayData)
            else g[c] for c in columns}


def write_lineitem16(path: str, groups, columns=L16_COLUMNS, codec=None,
                     dictionary: bool = True) -> float:
    """lineitem16 with :func:`lineitem16_layout`'s settings, one row group
    per generated group."""
    from tpu_parquet_torch.writer import FileWriter

    schema, opts = lineitem16_layout(columns, codec, dictionary)
    t0 = time.perf_counter()
    with FileWriter(path, schema, **opts) as w:
        for g in groups:
            w.write_columns(lineitem16_batch(g, columns))
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


# ---------------------------------------------------------------------------
# phase 10: nested columns
# ---------------------------------------------------------------------------

NESTED_LINE_COLUMNS = ["l_partkey", "l_quantity", "l_extendedprice",
                       "l_shipdate", "l_shipmode", "l_comment"]
ORDERS_PER_GROUP = 250_000
LOGICAL_ORDERS = 1_000
EDGE_ROWS = 200_000
EDGE_GROUP = 50_000
VOCAB = 32_000
EDGE_LEAVES = ["input_ids.list.element", "tags.list.element",
               "attrs.key_value.key", "attrs.key_value.value",
               "matrix.list.element.list.element"]


def list_levels(lens, null, present=None):
    """Def and rep levels of an OPTIONAL LIST column, one row per entry of
    ``lens`` (elements per row) and ``null`` (the row's list is null): a
    null list is one slot at def 0, an empty one a slot at def 1; an
    element is at def 2, or, when the element is OPTIONAL (``present``
    given, one flag per element), 3 where present and 2 where null."""
    import numpy as np

    lens = np.where(null, 0, lens)
    slots = np.where(lens == 0, 1, lens)
    starts = np.cumsum(slots) - slots
    total = int(slots.sum())
    rep = np.ones(total, np.int32)
    rep[starts] = 0
    d = np.full(total, 2, np.int32)
    elem = np.ones(total, bool)
    elem[starts[lens == 0]] = False
    if present is not None:
        d[elem] = np.where(present, 3, 2)
    d[starts[null]] = 0
    d[starts[(lens == 0) & ~null]] = 1
    return d, rep


def matrix_levels(outer, outer_null, inner, inner_null, present):
    """Def and rep levels of an OPTIONAL LIST of OPTIONAL LISTs of OPTIONAL
    INT32 (max_def 5, max_rep 2).  ``outer``/``outer_null`` per row;
    ``inner``/``inner_null`` per inner list of the non-null rows, in
    order; ``present`` per element of the non-null inner lists."""
    import numpy as np

    outer = np.where(outer_null, 0, outer)
    units = np.where(outer == 0, 1, outer)       # slots' first level
    marker = np.repeat(outer == 0, units)        # a null or empty row
    first = np.zeros(int(units.sum()), bool)
    first[np.cumsum(units) - units] = True
    q = np.zeros(len(marker), np.int64)
    inull = np.zeros(len(marker), bool)
    q[~marker] = np.where(inner_null, 0, inner)
    inull[~marker] = inner_null
    slots = np.where(q == 0, 1, q)
    starts = np.cumsum(slots) - slots
    total = int(slots.sum())
    rep = np.full(total, 2, np.int32)
    rep[starts] = np.where(first, 0, 1)
    d = np.zeros(total, np.int32)
    elem = np.ones(total, bool)
    elem[starts[q == 0]] = False
    d[elem] = np.where(present, 5, 4)
    row_null = np.repeat(outer_null, units)
    d[starts[marker & row_null]] = 0
    d[starts[marker & ~row_null]] = 1
    d[starts[~marker & inull]] = 2
    d[starts[~marker & ~inull & (q == 0)]] = 3
    return d, rep


def nested_orders(draws):
    """Phase 10a: the 6,001,215 lineitems of ``draw_lineitem16`` (seed 4),
    six of their columns, grouped into orders of 1-7 lineitems (TPC-H's
    range, drawn from a generator of their own, the last order cut short),
    with TPC-H-like sparse order keys.  Returns per-row-group dicts of
    ``ORDERS_PER_GROUP`` orders: ``o_orderkey``, each lineitem column's
    values (a STRING column as ``ByteArrayData``), and ``def``/``rep``, the
    lineitem leaves' levels (every list present: def 2; rep 0 at each
    order's first lineitem)."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    lines = {}
    for c in NESTED_LINE_COLUMNS:
        parts = [g[c] for g in draws]
        if isinstance(parts[0], tuple):
            lines[c] = (parts[0][0], np.concatenate([p[1] for p in parts]))
        else:
            lines[c] = np.concatenate(parts)
    n_lines = len(lines["l_partkey"])
    rng = np.random.default_rng(7)
    lens = rng.integers(1, 8, n_lines // 3)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, n_lines))
    lens = lens[: k + 1].copy()
    lens[-1] -= int(ends[k]) - n_lines
    keys = np.cumsum(rng.integers(1, 5, len(lens))).astype(np.int64)
    line_start = np.concatenate([[0], np.cumsum(lens)])
    groups = []
    for lo in range(0, len(lens), ORDERS_PER_GROUP):
        hi = min(lo + ORDERS_PER_GROUP, len(lens))
        a, b = int(line_start[lo]), int(line_start[hi])
        rep = np.ones(b - a, np.int32)
        rep[line_start[lo:hi] - a] = 0
        g = {"o_orderkey": keys[lo:hi], "lens": lens[lo:hi],
             "def": np.full(b - a, 2, np.int32), "rep": rep}
        for c, v in lines.items():
            g[c] = (ByteArrayData.from_list(v[0]).take(v[1][a:b])
                    if isinstance(v, tuple) else v[a:b])
        groups.append(g)
    return groups


def orders_schema():
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column,
                                               group_column, list_column)

    utf8 = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                            converted_type=ConvertedType.UTF8)
    types = {"l_partkey": Type.INT64, "l_quantity": Type.INT64,
             "l_extendedprice": Type.DOUBLE, "l_shipdate": Type.INT32}
    line = [data_column(c, types[c], FRT.REQUIRED) if c in types else
            data_column(c, Type.BYTE_ARRAY, FRT.REQUIRED, utf8)
            for c in NESTED_LINE_COLUMNS]
    return build_schema([
        data_column("o_orderkey", Type.INT64, FRT.REQUIRED),
        list_column("lines", group_column("element", line, FRT.REQUIRED),
                    FRT.OPTIONAL)])


def write_orders(path: str, groups) -> float:
    """Phase 10a's file with the port's writer, column by column (each
    lineitem leaf a ``ColumnData`` with its def and rep levels): SNAPPY,
    dictionary on, page CRCs, one row group per group of orders."""
    from tpu_parquet_torch.column import ColumnData
    from tpu_parquet_torch.format import CompressionCodec
    from tpu_parquet_torch.writer import FileWriter

    t0 = time.perf_counter()
    with FileWriter(path, orders_schema(), codec=CompressionCodec.SNAPPY,
                    use_dictionary=True, write_crc=True,
                    row_group_size=1 << 30) as w:
        for g in groups:
            cols = {"o_orderkey": g["o_orderkey"]}
            for c in NESTED_LINE_COLUMNS:
                cols[f"lines.list.element.{c}"] = ColumnData(
                    values=g[c], def_levels=g["def"], rep_levels=g["rep"],
                    max_def=2, max_rep=1, num_leaf_slots=len(g["rep"]))
            w.write_columns(cols)
            w.flush_row_group()
    return time.perf_counter() - t0


def edge_groups(rows: int = EDGE_ROWS, group: int = EDGE_GROUP):
    """Phase 10b's columns, per row group of ``group`` rows, from seed 10:
    ``input_ids`` LIST<INT32> (lengths uniform on 0-512, 1% null lists, ids
    of a 32,000-token vocabulary), ``tags`` LIST<OPTIONAL INT64> (0-7
    elements, 5% null lists, 10% null elements), ``attrs`` MAP<STRING,
    OPTIONAL INT64> (0-5 of 64 keys, 3% null maps, 15% null values) and
    ``matrix`` LIST<LIST<OPTIONAL INT32>> (0-4 lists of 0-4 values, nulls
    at every level).  Each leaf is ``(values, def, rep, max_def,
    max_rep)``."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    rng = np.random.default_rng(10)
    keys = [f"attr_{i:02d}".encode() for i in range(64)]
    out = []
    for lo in range(0, rows, group):
        n = min(group, rows - lo)
        g = {}
        lens = rng.integers(0, 513, n)
        null = rng.random(n) < 0.01
        ids = rng.integers(0, VOCAB, int(lens[~null].sum())).astype(np.int32)
        g["input_ids.list.element"] = (ids, *list_levels(lens, null), 2, 1)
        lens = rng.integers(0, 8, n)
        null = rng.random(n) < 0.05
        m = int(lens[~null].sum())
        present = rng.random(m) >= 0.10
        vals = rng.integers(0, 1 << 40, int(present.sum()))
        g["tags.list.element"] = (vals, *list_levels(lens, null, present),
                                  3, 1)
        lens = rng.integers(0, 6, n)
        null = rng.random(n) < 0.03
        m = int(lens[~null].sum())
        kidx = rng.integers(0, len(keys), m)
        present = rng.random(m) >= 0.15
        g["attrs.key_value.key"] = (ByteArrayData.from_list(keys).take(kidx),
                                    *list_levels(lens, null), 2, 1)
        g["attrs.key_value.value"] = (
            rng.integers(-(1 << 31), 1 << 31, int(present.sum())),
            *list_levels(lens, null, present), 3, 1)
        outer = rng.integers(0, 5, n)
        onull = rng.random(n) < 0.02
        n_inner = int(np.where(onull, 0, outer).sum())
        inner = rng.integers(0, 5, n_inner)
        inull = rng.random(n_inner) < 0.05
        m = int(np.where(inull, 0, inner).sum())
        present = rng.random(m) >= 0.10
        g["matrix.list.element.list.element"] = (
            rng.integers(0, 100, int(present.sum())).astype(np.int32),
            *matrix_levels(outer, onull, inner, inull, present), 5, 2)
        g["rows"] = n
        out.append(g)
    return out


def edge_schema():
    from tpu_parquet_torch.format import (ConvertedType,
                                          FieldRepetitionType as FRT,
                                          LogicalType, StringType, Type)
    from tpu_parquet_torch.schema.core import (ColumnParameters,
                                               build_schema, data_column,
                                               list_column, map_column)

    utf8 = ColumnParameters(logical_type=LogicalType(STRING=StringType()),
                            converted_type=ConvertedType.UTF8)
    return build_schema([
        list_column("input_ids",
                    data_column("element", Type.INT32, FRT.REQUIRED)),
        list_column("tags", data_column("element", Type.INT64,
                                        FRT.OPTIONAL)),
        map_column("attrs",
                   data_column("key", Type.BYTE_ARRAY, FRT.REQUIRED, utf8),
                   data_column("value", Type.INT64, FRT.OPTIONAL)),
        list_column("matrix", list_column(
            "element", data_column("element", Type.INT32, FRT.OPTIONAL))),
    ])


def write_edges(path: str, groups) -> float:
    """Phase 10b's file: the port's writer, data pages v2, dictionary on,
    SNAPPY, page CRCs, one row group per group."""
    from tpu_parquet_torch.column import ColumnData
    from tpu_parquet_torch.format import CompressionCodec
    from tpu_parquet_torch.writer import FileWriter

    t0 = time.perf_counter()
    with FileWriter(path, edge_schema(), codec=CompressionCodec.SNAPPY,
                    data_page_version=2, use_dictionary=True,
                    write_crc=True, row_group_size=1 << 30) as w:
        for g in groups:
            w.write_columns({
                leaf: ColumnData(values=v, def_levels=d, rep_levels=r,
                                 max_def=md, max_rep=mr,
                                 num_leaf_slots=len(r))
                for leaf, (v, d, r, md, mr) in
                ((k, g[k]) for k in EDGE_LEAVES)})
            w.flush_row_group()
    return time.perf_counter() - t0


def _same_host(got, want) -> bool:
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    if isinstance(want, ByteArrayData):
        return (isinstance(got, ByteArrayData)
                and np.array_equal(got.offsets, want.offsets)
                and np.array_equal(got.heap, want.heap))
    return got.dtype == want.dtype and np.array_equal(
        np.ascontiguousarray(got).view(np.uint8),
        np.ascontiguousarray(want).view(np.uint8))


def check_leaf(col, values, d, r, name: str, label: str) -> int:
    """One nested leaf bit for bit: values, def levels, rep levels; on the
    card, ``row_starts_from_rep`` counts the rows.  Returns the decoded
    bytes."""
    import numpy as np

    from tpu_parquet_torch import torch_kernels as TK

    got = col.to_host()
    gd, gr = col.levels_to_host()
    if not _same_host(got, values):
        raise fail(f"{label}: values of {name} differ from the generator")
    for lv, g, w in (("def", gd, d), ("rep", gr, r)):
        if g is None or len(g) != len(w) or not np.array_equal(
                g.astype(np.int64), w.astype(np.int64)):
            raise fail(f"{label}: {lv} levels of {name} differ from the "
                       f"generator")
    slots = col.num_leaf_slots
    starts, row_index = TK.row_starts_from_rep(col.rep_levels[:slots])
    rows = int((r == 0).sum())
    if int(starts.sum()) != rows or int(row_index[-1]) != rows - 1:
        raise fail(f"{label}: row_starts_from_rep of {name} on the card "
                   f"does not count {rows} rows")
    nbytes = (got.offsets.nbytes + got.heap.nbytes
              if hasattr(got, "offsets") else got.nbytes)
    return nbytes + gd.nbytes + gr.nbytes


def check_scatter(torch, col, want_slots, fill, name: str,
                  label: str) -> None:
    """``scatter_defined`` of one leaf's defined values on the card equals
    the generator's values slot by slot (``fill`` at null slots)."""
    from tpu_parquet_torch import torch_kernels as TK
    from tpu_parquet_torch.device_reader import DeviceDictColumn

    if isinstance(col, DeviceDictColumn):
        col = col.materialize()
    slots = col.num_leaf_slots
    valid = col.def_levels[:slots] == col.max_def
    got = TK.scatter_defined(col.values[: col.num_values], valid, fill)
    want = torch.from_numpy(want_slots).to(got.device)
    if not torch.equal(got, want):
        raise fail(f"{label}: scatter_defined of {name} on the card differs "
                   f"from the generator's slots")


def check_orders(torch, outs, groups, label: str) -> tuple:
    """Phase 10a's check: every leaf of every row group bit for bit against
    the generator (values, def and rep levels), rows counted on the card
    from the rep levels, ``l_quantity`` scattered to its slots on the card.
    Returns (orders, decoded bytes)."""
    import numpy as np

    orders = decoded = 0
    for rg, g in zip(outs, groups, strict=True):
        key = rg["o_orderkey"].to_host()
        if not _same_host(key, g["o_orderkey"]):
            raise fail(f"{label}: o_orderkey differs from the generator")
        decoded += key.nbytes
        for c in NESTED_LINE_COLUMNS:
            name = f"lines.list.element.{c}"
            decoded += check_leaf(rg[name], g[c], g["def"], g["rep"], name,
                                  label)
        check_scatter(torch, rg["lines.list.element.l_quantity"],
                      np.asarray(g["l_quantity"]), -1,
                      "lines.list.element.l_quantity", label)
        orders += len(g["o_orderkey"])
    return orders, decoded


def check_edges(torch, outs, groups, label: str) -> tuple:
    """Phase 10b's check: each leaf bit for bit against the generator, rows
    counted on the card; ``tags`` scattered to its slots on the card (0 at
    the null slots).  Returns (rows, decoded bytes)."""
    import numpy as np

    rows = decoded = 0
    for rg, g in zip(outs, groups, strict=True):
        for name in EDGE_LEAVES:
            v, d, r, md, _ = g[name]
            if rg[name].max_def != md:
                raise fail(f"{label}: {name} has max_def "
                           f"{rg[name].max_def}, want {md}")
            decoded += check_leaf(rg[name], v, d, r, name, label)
        v, d, _, md, _ = g["tags.list.element"]
        slots = np.zeros(len(d), v.dtype)
        slots[d == md] = v
        check_scatter(torch, rg["tags.list.element"], slots, 0,
                      "tags.list.element", label)
        rows += g["rows"]
    return rows, decoded


def k1_stream_split(kinds: list) -> dict:
    """{"rep": n, "def": n, "index": n} over the planned streams of ONE
    read (``read_main_path`` reads twice; the first half is the checked
    read)."""
    first = kinds[: len(kinds) // 2]
    return {k: first.count(k) for k in ("rep", "def", "index")}


def read_nested(torch, ck, path: str, groups, label: str, check,
                smi: str) -> dict:
    """Read a nested file on the card through the public entry point
    (``read_main_path``: the launch counts, a checked pass, a warm pass),
    with each fused K1 launch attributed to the stream it decoded (rep
    levels, def levels, dictionary indices); then the profiled and the
    cProfile'd passes."""
    from tpu_parquet_torch import device_reader as DR

    kinds = []
    current = ["index"]
    real_levels = DR._ChunkAssembler._plan_levels
    real_plan = DR._plan_hybrid_pallas

    def levels_spy(self, stager, streams, *args, **kw):
        rep = bool(self.pages) and streams[0] is self.pages[0].rep_stream
        current.append("rep" if rep else "def")
        try:
            return real_levels(self, stager, streams, *args, **kw)
        finally:
            current.pop()

    def plan_spy(*args):
        plan = real_plan(*args)
        if plan is not None:
            kinds.append(current[-1])
        return plan

    DR._ChunkAssembler._plan_levels = levels_spy
    DR._plan_hybrid_pallas = plan_spy
    try:
        main = read_main_path(
            torch, ck, path, groups, label, columns=None,
            check=lambda outs, gs, _cols, lab: check(torch, outs, gs, lab))
    finally:
        DR._ChunkAssembler._plan_levels = real_levels
        DR._plan_hybrid_pallas = real_plan
    split = k1_stream_split(kinds)
    if sum(split.values()) != main["counts"]["hybrid_unpack_combine"] or \
            split["rep"] <= 0:
        raise fail(f"{label}: hybrid_unpack_combine launched "
                   f"{main['counts']['hybrid_unpack_combine']} times for "
                   f"planned streams {split}; rep-level streams must be "
                   f"among them")
    main["k1_split"] = split
    log(f"{label}: hybrid_unpack_combine launches by stream: {split}")
    main["device"] = device_breakdown(torch, path, label, columns=None)
    summary(main, main["device"], label, smi)
    host_breakdown(torch, path, label, None)
    return main


def logical_orders(g, count: int) -> list:
    """The first ``count`` orders of a group as the logical rows a reader's
    ``iter_rows_logical()`` gives back."""
    starts = [0]
    for n in g["lens"][:count]:
        starts.append(starts[-1] + int(n))
    cols = {c: (g[c].to_list()[: starts[-1]] if hasattr(g[c], "offsets")
                else g[c][: starts[-1]].tolist())
            for c in NESTED_LINE_COLUMNS}
    for c in ("l_shipmode", "l_comment"):
        cols[c] = [b.decode() for b in cols[c]]
    return [{"o_orderkey": int(g["o_orderkey"][i]),
             "lines": [{c: cols[c][j] for c in NESTED_LINE_COLUMNS}
                       for j in range(starts[i], starts[i + 1])]}
            for i in range(count)]


def check_host_reader(torch, path: str, groups, label: str) -> None:
    """Row group 0 through the port's host ``FileReader``: its ``ColumnData``
    equal to the device read's ``to_host()`` / ``levels_to_host()``, and
    ``iter_rows_logical()`` giving back the generator's first orders."""
    import itertools

    import numpy as np

    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.reader import FileReader

    t0 = time.perf_counter()
    with FileReader(path) as r:
        host = r.read_row_group(0)
        t1 = time.perf_counter()
        rows = list(itertools.islice(r.iter_rows_logical(), LOGICAL_ORDERS))
        t2 = time.perf_counter()
    with DeviceFileReader(path) as r:
        dev = r.read_row_group(0)
    for name, cd in host.items():
        col = dev[name]
        d, rep = col.levels_to_host()
        same = _same_host(cd.values, col.to_host())
        for hl, dl in ((cd.def_levels, d), (cd.rep_levels, rep)):
            same = same and (hl is None) == (dl is None) and (
                hl is None or np.array_equal(hl.astype(np.int64),
                                             dl.astype(np.int64)))
        if not same:
            raise fail(f"{label}: the host FileReader's {name} differs from "
                       f"the device read's")
    if rows != logical_orders(groups[0], LOGICAL_ORDERS):
        raise fail(f"{label}: iter_rows_logical() does not give back the "
                   f"generator's first {LOGICAL_ORDERS} orders")
    log(f"{label}: host FileReader row group 0 ({len(host)} columns) equal "
        f"to the device read in {t1 - t0:.4f} s; iter_rows_logical() gave "
        f"the generator's first {LOGICAL_ORDERS} orders in {t2 - t1:.4f} s "
        f"(assembly of the whole row group)")


def read_nested_phase(torch, ck, draws, work: str, smi: str) -> dict:
    """Phase 10: (a) TPC-H orders with their lineitems nested, SF1; (b) the
    edge shapes (a tokenized corpus's ``input_ids``, null elements, a MAP,
    ``max_rep`` 2), 200,000 rows, v2 pages."""
    out = {}
    label = "nested orders SF1"
    groups = nested_orders(draws)
    path = os.path.join(work, "orders_nested_sf1.parquet")
    secs = write_orders(path, groups)
    lines = sum(len(g["rep"]) for g in groups)
    log(f"wrote {path}: {sum(len(g['o_orderkey']) for g in groups)} orders, "
        f"{lines} lineitems, {len(groups)} row groups, "
        f"{os.path.getsize(path)} bytes in {secs:.2f} s; encodings "
        f"{chunk_encodings(path)}")
    main = read_nested(torch, ck, path, groups, label, check_orders, smi)
    main["lines_per_s"] = lines / main["seconds"]
    log(f"{label}: warm pass {main['rows_per_s']:.1f} orders/s, "
        f"{main['lines_per_s']:.1f} lineitems/s ({smi})")
    check_host_reader(torch, path, groups, label)
    out["orders"] = main
    del groups
    label = "nested edge shapes"
    groups = edge_groups(EDGE_ROWS, EDGE_GROUP)
    path = os.path.join(work, "nested_edges.parquet")
    secs = write_edges(path, groups)
    slots = sum(len(g["input_ids.list.element"][2]) for g in groups)
    log(f"wrote {path}: {EDGE_ROWS} rows, {len(groups)} row groups, "
        f"{slots} input_ids slots, {os.path.getsize(path)} bytes in "
        f"{secs:.2f} s; encodings {chunk_encodings(path)}")
    main = read_nested(torch, ck, path, groups, label, check_edges, smi)
    if main["k1_split"]["rep"] <= 0 or not any(
            len(g["matrix.list.element.list.element"][2]) for g in groups):
        raise fail(f"{label}: no rep stream through the fused K1")
    out["edges"] = main
    return out


# ---------------------------------------------------------------------------
# phase 11: the host pipeline
# ---------------------------------------------------------------------------

PIPELINE_BUDGET = 256 << 20  # scan_files' max_memory in phase 11(d)
MANIFEST_NAME = "tpq_manifest.json"


def pipeline_depth() -> int:
    """K: the chunk pool's depth, capped at the host's cores."""
    return min(8, os.cpu_count() or 1)


def _bits(torch, t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def same_on_card(torch, outs, want, label: str) -> None:
    """Every tensor of every column (values, offsets and heap, indices and
    dictionary, def and rep levels; padding included) bit for bit against
    ``want``, compared on the card: nothing large is copied to the host."""
    if len(outs) != len(want):
        raise fail(f"{label}: {len(outs)} row groups, want {len(want)}")
    for i, (g, w) in enumerate(zip(outs, want)):
        if list(g) != list(w):
            raise fail(f"{label}: row group {i} columns {list(g)}, want "
                       f"{list(w)}")
        for name in w:
            gt = {k: v for k, v in vars(g[name]).items()
                  if isinstance(v, torch.Tensor)}
            wt = {k: v for k, v in vars(w[name]).items()
                  if isinstance(v, torch.Tensor)}
            if type(g[name]) is not type(w[name]) or set(gt) != set(wt):
                raise fail(f"{label}: row group {i} column {name} is a "
                           f"{type(g[name]).__name__} of {sorted(gt)}, want "
                           f"{type(w[name]).__name__} of {sorted(wt)}")
            for k, t in wt.items():
                u = gt[k]
                if (u.dtype != t.dtype or u.shape != t.shape
                        or not torch.equal(_bits(torch, u), _bits(torch, t))):
                    raise fail(f"{label}: row group {i} column {name}.{k} "
                               f"differs")


def pipeline_pass(torch, ck, path: str, columns, prefetch: int):
    """One ``DeviceFileReader(prefetch=...).iter_row_groups()`` read, timed
    end to end (ending in a synchronize).  Returns (outputs, seconds, reader
    stats, pipeline stats, launches, the device memory the pass added at
    its peak, pinned bytes): ``max_memory_allocated`` less what was
    allocated before the pass (the outputs phase 11 keeps to compare
    with)."""
    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ck.reset_launches()
    t0 = time.perf_counter()
    with DeviceFileReader(path, columns=columns, prefetch=prefetch) as r:
        outs = list(r.iter_row_groups())
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(ck.launches)
        st = r.stats().as_dict()
        pipe = r.pipeline_stats().as_dict()
        pinned = r._pinned.peak_held_bytes if r._pinned is not None else 0
    return (outs, seconds, st, pipe, counts,
            torch.cuda.max_memory_allocated() - before, pinned)


def pipe_line(pipe: dict) -> str:
    return (", ".join(f"{k} {pipe[k]}" for k in (
        "io_seconds", "decompress_seconds", "recompress_seconds",
        "stage_seconds", "dispatch_seconds", "finalize_seconds",
        "busy_seconds", "wall_seconds", "stall_seconds",
        "peak_in_flight_bytes", "overlap_efficiency", "chunks",
        "row_groups")))


def read_pipeline_file(torch, ck, path: str, columns, label: str, main: dict,
                       depths, rows: int, smi: str, launched: dict,
                       keep_base: bool = False) -> dict:
    """Phase 11(a)-(c) for one file: at each prefetch depth a checked pass
    (every tensor bit-equal to the prefetch-0 pass on the card; launch
    counts and the route table equal to ``main``'s, the file's own phase)
    and a warm pass; a profiled pass at the deepest depth."""
    base = None
    per_depth = {}
    for p in depths:
        outs, _, st, _, counts, _, _ = pipeline_pass(torch, ck, path,
                                                      columns, p)
        for name, n in counts.items():
            launched[name] = launched.get(name, 0) + n
        if counts != main["counts"]:
            raise fail(f"{label} prefetch {p}: launches {counts}, want the "
                       f"phase's {main['counts']}")
        if st["ship_routes"] != main["stats"]["ship_routes"]:
            raise fail(f"{label} prefetch {p}: routes {route_table(st)}, "
                       f"want {route_table(main['stats'])}")
        if base is None:
            base = outs
        else:
            same_on_card(torch, outs, base, f"{label} prefetch {p}")
        del outs
        _, seconds, st2, pipe, _, peak, pinned = pipeline_pass(
            torch, ck, path, columns, p)
        per_depth[p] = dict(rows_per_s=rows / seconds, seconds=seconds,
                            pipe=pipe, host=st2["host_seconds"], peak=peak)
        log(f"{label} prefetch {p}: bit-equal to prefetch 0, launches and "
            f"routes equal the phase's; warm pass {seconds:.4f} s = "
            f"{rows / seconds:.1f} rows/s; host_seconds "
            f"{st2['host_seconds']:.4f}, stage_seconds "
            f"{st2['stage_seconds']:.4f}, dispatch_seconds "
            f"{st2['dispatch_seconds']:.4f}; peak device memory of the pass "
            f"{peak} bytes (the phase's max_memory_allocated "
            f"{main['peak']}); pinned staging buffers "
            f"{pinned} bytes at most ({smi})")
        log(f"{label} prefetch {p} pipeline_stats: {pipe_line(pipe)}")
    deep = max(depths)
    dev = device_breakdown(torch, path, f"{label} prefetch {deep}", columns,
                           prefetch=deep)
    return dict(base=base if keep_base else None, depths=per_depth,
                device=dev)


def write_shards(path_dir: str, groups) -> list:
    """lineitem16 SF1 as one file per row group, phase 6's writer settings
    (the layout Spark writes: one file per task), and the dataset's
    manifest, written here as the JSON the reference's ``write_manifest``
    writes."""
    from tpu_parquet_torch.footer import read_file_metadata

    os.makedirs(path_dir, exist_ok=True)
    for old in os.listdir(path_dir):
        os.unlink(os.path.join(path_dir, old))
    paths, entries = [], []
    for i, g in enumerate(groups):
        p = os.path.join(path_dir, f"part-{i:05d}.parquet")
        write_lineitem16(p, [g])
        with open(p, "rb") as f:
            md = read_file_metadata(f)
        paths.append(p)
        entries.append({"path": os.path.basename(p),
                        "rows": int(md.num_rows or 0),
                        "bytes": os.path.getsize(p),
                        "row_groups": len(md.row_groups or [])})
    doc = {"magic": "TPQM", "manifest_version": 1, "generation": 1,
           "created_by": "chip_smoke.py",
           "total_rows": sum(e["rows"] for e in entries), "files": entries}
    with open(os.path.join(path_dir, MANIFEST_NAME), "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return paths


def largest_chunk_cost(paths) -> int:
    """The chunk feed's largest charge: compressed + uncompressed bytes."""
    from tpu_parquet_torch.footer import read_file_metadata

    most = 0
    for p in paths:
        with open(p, "rb") as f:
            md = read_file_metadata(f)
        for rg in md.row_groups:
            for c in rg.columns:
                comp = c.meta_data.total_compressed_size
                most = max(most, comp + max(
                    c.meta_data.total_uncompressed_size, comp))
    return most


def scan_pass(torch, ck, source, prefetch: int, stream=None, made=None,
              **scan_kw):
    """One ``scan_files(source, prefetch=..., max_memory=PIPELINE_BUDGET)``
    read, timed end to end; under ``stream`` when given; ``scan_kw`` go to
    ``scan_files`` and the readers it opens are appended to ``made``.
    Returns (outputs, seconds, launches, the largest bytes in flight any
    reader saw, the device memory the pass added at its peak, rows)."""
    import contextlib

    from tpu_parquet_torch import device_reader as DR

    made = [] if made is None else made
    real = DR.DeviceFileReader.__init__

    def spy(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)

    DR.DeviceFileReader.__init__ = spy
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ck.reset_launches()
        t0 = time.perf_counter()
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            outs = list(DR.scan_files(source, prefetch=prefetch,
                                      max_memory=PIPELINE_BUDGET, **scan_kw))
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = dict(ck.launches)
    finally:
        DR.DeviceFileReader.__init__ = real
    in_flight = max((r.pipeline_stats().peak_in_flight_bytes for r in made),
                    default=0)
    rows = sum(r.stats().rows for r in made)
    return (outs, seconds, counts, in_flight,
            torch.cuda.max_memory_allocated() - before, rows)


def host_reader_pass(path: str, prefetch: int):
    """``FileReader(path, prefetch=...).read_all()``, timed."""
    from tpu_parquet_torch.reader import FileReader

    t0 = time.perf_counter()
    with FileReader(path, prefetch=prefetch) as r:
        cols = r.read_all()
        pipe = r.pipeline_stats().as_dict()
    return cols, time.perf_counter() - t0, pipe


def same_host_columns(got: dict, want: dict, label: str) -> None:
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    if list(got) != list(want):
        raise fail(f"{label}: columns {list(got)}, want {list(want)}")
    for name, w in want.items():
        g = got[name]
        pairs = [(g.def_levels, w.def_levels), (g.rep_levels, w.rep_levels)]
        if isinstance(w.values, ByteArrayData):
            pairs += [(g.values.offsets, w.values.offsets),
                      (g.values.heap, w.values.heap)]
        else:
            pairs.append((g.values, w.values))
        for a, b in pairs:
            if (a is None) != (b is None) or (
                    b is not None and (a.dtype != b.dtype or not
                                       np.array_equal(a.view(np.uint8),
                                                      b.view(np.uint8)))):
                raise fail(f"{label}: column {name} differs")


def read_pipeline_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                        l16_groups, l16: dict, pa_layout: dict,
                        k3_path: str, k3_main: dict, k3_rows: int) -> dict:
    """Phase 11: the host pipeline on the card.  (a) lineitem16 SF1, (b) the
    pyarrow layout and (c) the K3 file through
    ``DeviceFileReader(prefetch=p).iter_row_groups()`` for p in {0, 2, K};
    (d) lineitem16 SF1 as 7 one-group files through ``scan_files`` at 0 and
    K under a 256 MiB budget, through the dataset's manifest, and under a
    non-default stream; (e) the host ``FileReader`` at 0 and K."""
    k = pipeline_depth()
    depths = sorted({0, 2, k})
    log(f"pipeline: os.cpu_count() {os.cpu_count()}, K = min(8, cores) = "
        f"{k}; depths {depths} ({smi})")
    launched: dict = {}
    out = {"k": k, "depths": depths}
    label = "pipeline lineitem16 SF1"
    a = read_pipeline_file(torch, ck, l16_path, L16_COLUMNS, label, l16,
                           depths, SF1_ROWS, smi, launched, keep_base=True)
    out["lineitem16"] = a
    pa_path = os.path.join(work, "lineitem16_pyarrow_layout.parquet")
    out["pyarrow_layout"] = read_pipeline_file(
        torch, ck, pa_path, L16_COLUMNS, "pipeline pyarrow layout",
        pa_layout, depths, SF1_ROWS, smi, launched)
    out["k3"] = read_pipeline_file(
        torch, ck, k3_path, K3_COLUMNS, "pipeline K3 file", k3_main, depths,
        k3_rows, smi, launched)

    # (d) scan_files over the dataset
    label = "pipeline scan_files"
    shard_dir = os.path.join(work, "lineitem16_sf1_shards")
    t0 = time.perf_counter()
    paths = write_shards(shard_dir, l16_groups)
    log(f"wrote {len(paths)} one-group files of lineitem16 SF1 and "
        f"{MANIFEST_NAME} under {shard_dir} in "
        f"{time.perf_counter() - t0:.2f} s")
    most = largest_chunk_cost(paths)
    if most > PIPELINE_BUDGET:
        raise fail(f"{label}: the largest chunk costs {most} bytes, over "
                   f"the {PIPELINE_BUDGET}-byte budget")
    log(f"{label}: largest chunk compressed + uncompressed {most} bytes; "
        f"max_memory {PIPELINE_BUDGET}")
    base = a["base"]
    scans = {}
    runs = [(f"prefetch {p}", paths, p, None) for p in (0, k)]
    runs.append((f"manifest prefetch {k}", shard_dir, k, None))
    runs.append((f"prefetch {k} on a non-default stream", paths, k,
                 torch.cuda.Stream()))
    for name, source, p, stream in runs:
        outs, seconds, counts, in_flight, peak, rows = scan_pass(
            torch, ck, source, p, stream)
        for kname, n in counts.items():
            launched[kname] = launched.get(kname, 0) + n
        if stream is not None:
            with torch.cuda.stream(stream):
                same_on_card(torch, outs, base, f"{label} {name}")
        else:
            same_on_card(torch, outs, base, f"{label} {name}")
        del outs
        if counts != l16["counts"]:
            raise fail(f"{label} {name}: launches {counts}, want phase 6's "
                       f"{l16['counts']}")
        if in_flight > PIPELINE_BUDGET:
            raise fail(f"{label} {name}: {in_flight} bytes in flight, over "
                       f"max_memory {PIPELINE_BUDGET}")
        if rows != SF1_ROWS:
            raise fail(f"{label} {name}: {rows} rows")
        scans[name] = rows / seconds
        log(f"{label} {name}: every row group bit-equal to (a)'s; launches "
            f"equal phase 6's; peak_in_flight_bytes {in_flight} <= "
            f"{PIPELINE_BUDGET}; {seconds:.4f} s = {rows / seconds:.1f} "
            f"rows/s; peak device memory of the pass {peak} bytes ({smi})")
    out["scan"] = scans
    a["base"] = None
    del base

    # (e) the host FileReader
    label = "pipeline host FileReader lineitem16 SF1"
    host = {}
    want = None
    for p in (0, k):
        cols, seconds, pipe = host_reader_pass(l16_path, p)
        if want is None:
            want = cols
        else:
            same_host_columns(cols, want, f"{label} prefetch {p}")
        host[p] = seconds
        log(f"{label} prefetch {p}: read_all {seconds:.4f} s = "
            f"{SF1_ROWS / seconds:.1f} rows/s; pipeline_stats "
            f"{pipe_line(pipe)}")
        del cols
    del want
    out["host"] = host
    for kname, need in (("hybrid_unpack_combine", True),
                        ("fused_plain_words", True),
                        ("fused_narrow_words", True)):
        if need and not launched.get(kname):
            raise fail(f"phase 11 never launched {kname}")
    out["launched"] = launched
    log(f"pipeline summary ({smi}): K {k} of {os.cpu_count()} cores; rows/s "
        + "; ".join(
            f"{n} " + ", ".join(
                f"p{p} {out[key]['depths'][p]['rows_per_s']:.1f}"
                for p in depths)
            for n, key in (("lineitem16", "lineitem16"),
                           ("pyarrow layout", "pyarrow_layout"),
                           ("K3 file", "k3")))
        + "; scan_files " + ", ".join(f"{n} {v:.1f}"
                                      for n, v in scans.items())
        + "; host FileReader " + ", ".join(
            f"p{p} {SF1_ROWS / v:.1f}" for p, v in host.items())
        + f"; phase 11 launches {launched}")
    return out


# ---------------------------------------------------------------------------
# phase 12: filtered and contained scans
# ---------------------------------------------------------------------------

# the sort-key window of phase 12(a): about 3% of the keys, straddling the
# boundary of row groups 1 and 2
WINDOW_HALF_ROWS = 90_000
# Q6's dates as days since 1970-01-01: [1994-01-01, 1995-01-01)
Q6_DATES = (8766, 9131)
Q6_COLUMNS = ["l_quantity", "l_extendedprice", "l_discount", "l_shipdate"]
QUARANTINE_GROUP = 40  # the K3 file's row group whose dates page is corrupt


def collected_bytes(torch) -> int:
    """Run a garbage collection and return the device bytes it freed: the
    tensors of earlier passes that only reference cycles still held."""
    import gc

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.synchronize()
    return before - torch.cuda.memory_allocated()


class FrozenHeap:
    """A timed pass with the objects alive before it moved into the
    collector's permanent generation (``gc.freeze``), and every collection
    that runs during the pass recorded.

    By phase 13 the script holds the inputs and results of twelve phases,
    and a full collection that walks them stops every thread for a few
    hundred milliseconds: a pause of the script's own heap, not of the
    scan under test.  Frozen, they are not walked; what the pass itself
    allocates is still collected.  ``full_s`` is the full collection that
    ran before the freeze, ``pauses`` the (generation, seconds) of each
    collection inside the block."""

    def __init__(self):
        self.full_s = 0.0
        self.pauses: list = []
        self._t0 = None

    def _note(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.pauses.append((info["generation"],
                                time.perf_counter() - self._t0))
            self._t0 = None

    def __enter__(self):
        import gc

        t0 = time.perf_counter()
        gc.collect()
        self.full_s = time.perf_counter() - t0
        gc.freeze()
        gc.callbacks.append(self._note)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._note)
        gc.unfreeze()
        return False

    def summary(self) -> str:
        longest = max((s for _, s in self.pauses), default=0.0)
        return (f"a full collection before it {self.full_s:.4f} s; "
                f"{len(self.pauses)} collections in it, the longest "
                f"{longest:.4f} s")


def tpq_threads() -> list:
    import threading

    return [t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith("tpq-")]


def check_released(readers, label: str) -> None:
    """After a pass: no pool or staging thread alive, every pinned buffer
    back in its pool, and each reader's device ledger at zero."""
    threads = tpq_threads()
    if threads:
        raise fail(f"{label}: threads still alive after the pass: {threads}")
    for r in readers:
        pool = r._pinned
        if pool is not None and pool.out_bytes:
            raise fail(f"{label}: {pool.out_bytes} pinned bytes not given "
                       f"back to the pool")
        if (r._device_staged_pending or r._device_outstanding
                or r.alloc.device_snapshot()[0]):
            raise fail(f"{label}: device ledger not released (pending "
                       f"{r._device_staged_pending}, outstanding "
                       f"{r._device_outstanding}, alloc "
                       f"{r.alloc.device_snapshot()[0]})")


def filtered_pass(torch, ck, path: str, columns, prefetch: int = 0,
                  stream=None, **reader_kw):
    """One ``DeviceFileReader(...).iter_row_groups()`` read with
    ``reader_kw`` (a row filter, a plan, a data-error policy), timed end to
    end; under ``stream`` when given.  Returns (outputs, seconds, reader
    stats, launches, the reader's plan, its quarantine engine, the kept row
    groups); the reader is closed and checked released."""
    import contextlib

    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    ck.reset_launches()
    t0 = time.perf_counter()
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        with DeviceFileReader(path, columns=columns, prefetch=prefetch,
                              **reader_kw) as r:
            outs = list(r.iter_row_groups())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(ck.launches)
            st = r.stats().as_dict()
            kept = [i for i in range(r.num_row_groups)
                    if r.row_group_selected(i)]
    check_released([r], f"{path} prefetch {prefetch}")
    return outs, seconds, st, counts, r._plan, r.quarantine, kept


def kept_rows(path: str, plan, index: int, column: str, num_rows: int):
    """Boolean mask of row group ``index``'s rows the plan's pruning memo
    keeps, from ``column``'s page headers (the skip sets drop whole pages,
    the same rows in every selected column)."""
    import numpy as np

    from tpu_parquet_torch.footer import read_file_metadata
    from tpu_parquet_torch.scanplan import walk_header_pages

    hint = plan.pruning_hint(index)
    if hint is None:
        raise fail(f"{path}: row group {index} has no pruning memo")
    skip = (hint[0] or {}).get((column,), set())
    mask = np.ones(num_rows, dtype=bool)
    with open(path, "rb") as f:
        md = read_file_metadata(f)
        chunk = next(c for c in md.row_groups[index].columns
                     if c.meta_data.path_in_schema == [column])
        cmd = chunk.meta_data
        offset = cmd.data_page_offset
        if cmd.dictionary_page_offset is not None:
            offset = min(offset, cmd.dictionary_page_offset)
        start = 0
        for i, h in enumerate(walk_header_pages(
                f, offset, cmd.total_compressed_size, cmd.num_values)):
            n = (h.data_page_header or h.data_page_header_v2).num_values
            if i in skip:
                mask[start : start + n] = False
            start += n
    if int((~mask).sum()) != hint[1]:
        raise fail(f"{path}: row group {index} drops {int((~mask).sum())} "
                   f"rows by its pages, {hint[1]} by its memo")
    return mask


def check_window(outs, groups, kept, plan, path: str, columns, lo: int,
                 hi: int, label: str) -> int:
    """Each kept group's output is the generator's rows of the page runs
    the plan kept, in every column (strings included), every row of the
    window among them.  Returns the rows checked."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    if len(outs) != len(kept):
        raise fail(f"{label}: {len(outs)} row groups for kept {kept}")
    rows = 0
    for out, g in zip(outs, kept):
        want = groups[g]
        n = len(want["l_orderkey"])
        mask = kept_rows(path, plan, g, columns[0], n)
        keys = want["l_orderkey"]
        hit = (keys >= lo) & (keys <= hi)
        if (hit & ~mask).any():
            raise fail(f"{label}: row group {g} dropped rows of the window")
        idx = np.flatnonzero(mask)
        for name in columns:
            got = out[name].to_host()
            exp = want[name]
            if isinstance(exp, ByteArrayData):
                exp = exp.take(idx)
                same = (isinstance(got, ByteArrayData)
                        and np.array_equal(got.offsets, exp.offsets)
                        and np.array_equal(got.heap, exp.heap))
            else:
                exp = exp[idx]
                same = got.dtype == exp.dtype and np.array_equal(
                    got.view(np.uint8), exp.view(np.uint8))
            if not same:
                raise fail(f"{label}: row group {g} column {name} is not "
                           f"the generator's kept rows")
        rows += len(idx)
    return rows


def unfiltered_groups(torch, ck, path: str, columns, groups):
    """Row groups ``groups`` of ``path`` read unfiltered, one by one:
    (pages, compressed bytes, launches) — what a filtered read of those
    groups is held against."""
    from tpu_parquet_torch.device_reader import DeviceFileReader

    ck.reset_launches()
    with DeviceFileReader(path, columns=columns) as r:
        for g in groups:
            r.read_row_group(g)
        torch.cuda.synchronize()
        st = r.stats().as_dict()
    return st["pages"], st["compressed_bytes"], dict(ck.launches)


def add_launches(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n


def read_filter_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                      l16_groups, k3_path: str, k3_groups,
                      k3_main: dict) -> dict:
    """Phase 12: filtered and contained scans on the card.  (a) a sort-key
    window on lineitem16 SF1, over phase 3's seven columns (a1) and all 16
    (a2); (b) TPC-H Q6's predicate, which prunes nothing; (c) a replay of
    (a1) through its serialized plan; (d) (a1) pipelined and under a
    non-default stream, and ``scan_files`` with the filter over phase 11's
    shards; (e) the host ``FileReader``'s group pruning; (f) a corrupt page
    in the K3 file under each data-error policy."""
    from tpu_parquet_torch import device_reader as DR
    from tpu_parquet_torch.predicate import col
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.scanplan import ScanPlan

    log(f"filter: {collected_bytes(torch)} bytes on the card freed by a "
        f"garbage collection at the phase's start ({smi})")
    k = pipeline_depth()
    launched: dict = {}
    out = {"k": k}
    boundary = len(l16_groups[0]["l_orderkey"]) * 2
    lo = int(l16_groups[1]["l_orderkey"][-WINDOW_HALF_ROWS])
    hi = int(l16_groups[2]["l_orderkey"][WINDOW_HALF_ROWS - 1])
    window = col("l_orderkey").between(lo, hi)
    n_window = sum(int(((g["l_orderkey"] >= lo)
                        & (g["l_orderkey"] <= hi)).sum())
                   for g in l16_groups)
    log(f"filter: l_orderkey between {lo} and {hi}: {n_window} of "
        f"{SF1_ROWS} rows ({n_window / SF1_ROWS:.4f}), around row "
        f"{boundary} (the start of row group 2); K = {k} ({smi})")

    # (a) the window, on phase 3's seven columns and on all 16
    base = {}
    for tag, columns in (("a1", COLUMNS), ("a2", L16_COLUMNS)):
        label = f"filter ({tag}) {len(columns)} columns"
        unf = timed_pass(torch, l16_path, columns)
        unf_stats = unf[2]
        del unf
        outs, _, st, counts, plan, _, kept = filtered_pass(
            torch, ck, l16_path, columns, row_filter=window)
        add_launches(launched, counts)
        if kept != [1, 2]:
            raise fail(f"{label}: kept row groups {kept}, want [1, 2]")
        rows = check_window(outs, l16_groups, kept, plan, l16_path, columns,
                            lo, hi, label)
        if rows != st["rows"]:
            raise fail(f"{label}: {rows} rows checked, stats say "
                       f"{st['rows']}")
        pages, comp, unf_counts = unfiltered_groups(torch, ck, l16_path,
                                                    columns, kept)
        if st["pages"] + st["pages_pruned"] != pages:
            raise fail(f"{label}: {st['pages']} pages parsed + "
                       f"{st['pages_pruned']} pruned, the kept groups hold "
                       f"{pages}")
        # every fused stream of the route table is one launch on the
        # surviving pages (K2 where fused_plain ranks first)
        check_route_launches(counts, st, label)
        if counts.get("hybrid_unpack_combine", 0) <= 0:
            raise fail(f"{label}: the fused K1 never launched on the "
                       f"surviving index pages")
        if tag == "a1" and st["pages_pruned"] <= 0:
            raise fail(f"{label}: no page pruned")
        _, seconds, st2, _, _, _, _ = filtered_pass(
            torch, ck, l16_path, columns, row_filter=window)
        log(f"{label}: kept row groups {kept} of {len(l16_groups)}; "
            f"pages_pruned {st['pages_pruned']} of {pages} in the kept "
            f"groups; rows {st['rows']} (rows_dropped "
            f"{2 * ROWS_PER_GROUP - st['rows']}), the generator's rows of "
            f"the kept pages, every window row among them; compressed bytes "
            f"read {st['compressed_bytes']} against "
            f"{unf_stats['compressed_bytes']} unfiltered ({comp} in the "
            f"kept groups); staged "
            f"{st['staged_bytes']} against {unf_stats['staged_bytes']}; "
            f"launches {counts} against {unf_counts} for the kept groups "
            f"unfiltered; routes {route_table(st)}; warm pass "
            f"{seconds:.4f} s; prune_seconds {st2['prune_seconds']:.4f} of "
            f"host_seconds {st2['host_seconds']:.4f} ({smi})")
        base[tag] = dict(outs=outs, st=st, counts=counts, plan=plan,
                         seconds=seconds, prune=st2["prune_seconds"])
    del base["a2"]["outs"]
    out["a"] = {t: {kk: v for kk, v in b.items() if kk in ("st", "counts",
                                                          "seconds")}
                for t, b in base.items()}
    a1 = base["a1"]
    dev = device_breakdown(torch, l16_path, "filter (a1) 7 columns",
                           columns=COLUMNS, row_filter=window)
    out["a1_device"] = dev

    # (b) Q6's predicate on unsorted dates: nothing prunes
    label = "filter (b) TPC-H Q6"
    q6 = ((col("l_shipdate") >= Q6_DATES[0])
          & (col("l_shipdate") < Q6_DATES[1])
          & col("l_discount").between(0.05, 0.07)
          & (col("l_quantity") < 24))
    want, _, _ = timed_pass(torch, l16_path, Q6_COLUMNS)
    outs, _, st, counts, _, _, kept = filtered_pass(
        torch, ck, l16_path, Q6_COLUMNS, row_filter=q6)
    add_launches(launched, counts)
    if (st["pages_pruned"] or st["rows"] != SF1_ROWS
            or len(kept) != len(l16_groups)):
        raise fail(f"{label}: pruned {st['pages_pruned']} pages, {st['rows']}"
                   f" rows, kept {kept}: the dates are not sorted")
    same_on_card(torch, outs, want, label)
    del outs, want
    _, plain_s, _ = timed_pass(torch, l16_path, Q6_COLUMNS)
    _, q6_s, st2, _, _, _, _ = filtered_pass(torch, ck, l16_path, Q6_COLUMNS,
                                             row_filter=q6)
    out["q6"] = dict(plain=SF1_ROWS / plain_s, filtered=SF1_ROWS / q6_s,
                     prune=st2["prune_seconds"])
    log(f"{label}: nothing pruned; bit-equal to the unfiltered read; warm "
        f"{SF1_ROWS / q6_s:.1f} rows/s filtered against "
        f"{SF1_ROWS / plain_s:.1f} unfiltered; prune_seconds "
        f"{st2['prune_seconds']:.4f} of host_seconds "
        f"{st2['host_seconds']:.4f} ({smi})")

    # (c) replay through the serialized plan
    label = "filter (c) replay"
    blob = a1["plan"].serialize()
    walks = [0]
    real = DR.plan_page_pruning

    def counted(*args, **kwargs):
        walks[0] += 1
        return real(*args, **kwargs)

    DR.plan_page_pruning = counted
    try:
        replay = ScanPlan.deserialize(blob)
        outs, _, st, counts, plan, _, _ = filtered_pass(
            torch, ck, l16_path, COLUMNS, row_filter=window, plan=replay)
    finally:
        DR.plan_page_pruning = real
    add_launches(launched, counts)
    if plan is not replay or walks[0]:
        raise fail(f"{label}: plan adopted {plan is replay}, header walks "
                   f"{walks[0]}")
    same_on_card(torch, outs, a1["outs"], label)
    del outs
    if (replay.routes_table() != a1["plan"].routes_table()
            or st["ship_routes"] != a1["st"]["ship_routes"]
            or st["pages_pruned"] != a1["st"]["pages_pruned"]
            or counts != a1["counts"]):
        raise fail(f"{label}: routes, pages pruned or launches differ from "
                   f"(a1)")
    out["replay_prune"] = st["prune_seconds"]
    log(f"{label}: {len(blob)}-byte plan; bit-equal to (a1), routes, "
        f"pages_pruned and launches equal; no header walk; prune_seconds "
        f"{st['prune_seconds']:.6f} against {a1['prune']:.6f} for the first "
        f"read ({smi})")

    # (d) pipelined, a non-default stream, and scan_files over the shards
    for name, p, stream in ((f"prefetch {k}", k, None),
                            (f"prefetch {k} on a non-default stream", k,
                             torch.cuda.Stream())):
        label = f"filter (d) {name}"
        outs, seconds, st, counts, _, _, _ = filtered_pass(
            torch, ck, l16_path, COLUMNS, prefetch=p, stream=stream,
            row_filter=window)
        add_launches(launched, counts)
        if stream is not None:
            with torch.cuda.stream(stream):
                same_on_card(torch, outs, a1["outs"], label)
        else:
            same_on_card(torch, outs, a1["outs"], label)
        del outs
        if (st["pages_pruned"] != a1["st"]["pages_pruned"]
                or counts != a1["counts"]):
            raise fail(f"{label}: pages_pruned {st['pages_pruned']} or "
                       f"launches {counts} differ from (a1)")
        log(f"{label}: bit-equal to (a1), pages_pruned and launches equal; "
            f"{seconds:.4f} s ({smi})")
    shard_dir = os.path.join(work, "lineitem16_sf1_shards")
    shards = sorted(os.path.join(shard_dir, f) for f in os.listdir(shard_dir)
                    if f.endswith(".parquet"))
    for p in (0, k):
        label = f"filter (d) scan_files prefetch {p}"
        made: list = []
        outs, seconds, counts, in_flight, _, rows = scan_pass(
            torch, ck, shards, p, made=made, row_filter=window,
            columns=COLUMNS)
        add_launches(launched, counts)
        same_on_card(torch, outs, a1["outs"], label)
        del outs
        untouched = sum(1 for r in made if r.stats().chunks == 0)
        pruned = sum(r.stats().pages_pruned for r in made)
        check_released(made, label)
        if (untouched != len(shards) - 2 or pruned != a1["st"]["pages_pruned"]
                or counts != a1["counts"] or rows != a1["st"]["rows"]
                or in_flight > PIPELINE_BUDGET):
            raise fail(f"{label}: {untouched} shards unread, pages_pruned "
                       f"{pruned}, launches {counts}, rows {rows}, in "
                       f"flight {in_flight}")
        log(f"{label}: bit-equal to (a1); {untouched} of {len(shards)} "
            f"shards read no chunk; pages_pruned and launches equal (a1)'s; "
            f"peak_in_flight_bytes {in_flight}; {seconds:.4f} s ({smi})")

    # (e) the host reader's group pruning
    with FileReader(l16_path, columns=COLUMNS, row_filter=window) as r:
        host_kept = [i for i in range(r.num_row_groups)
                     if r.row_group_selected(i)]
        selected = r.num_selected_rows
    if host_kept != [1, 2] or selected != 2 * ROWS_PER_GROUP:
        raise fail(f"filter (e) host FileReader: kept {host_kept}, "
                   f"num_selected_rows {selected}")
    log(f"filter (e) host FileReader: num_selected_rows {selected}, kept "
        f"row groups {host_kept}, the device read's (group pruning only)")
    del base, a1

    # (f) a corrupt page in the K3 file, under each policy
    out["quarantine"] = read_quarantine(torch, ck, work, smi, k3_path,
                                        k3_groups, k3_main, launched)
    for kname in ("hybrid_unpack_combine", "fused_plain_words",
                  "fused_narrow_words"):
        if not launched.get(kname):
            raise fail(f"phase 12 never launched {kname}")
    out["launched"] = launched
    log(f"filter phase summary ({smi}): (a1) {out['a']['a1']['st']['rows']} "
        f"rows, pages_pruned {out['a']['a1']['st']['pages_pruned']}, warm "
        f"{out['a']['a1']['seconds']:.4f} s; (a2) "
        f"{out['a']['a2']['st']['rows']} rows, pages_pruned "
        f"{out['a']['a2']['st']['pages_pruned']}, warm "
        f"{out['a']['a2']['seconds']:.4f} s; Q6 {out['q6']['filtered']:.1f} "
        f"rows/s filtered, {out['q6']['plain']:.1f} unfiltered; replay "
        f"prune_seconds {out['replay_prune']:.6f}; phase 12 launches "
        f"{launched}")
    return out


def read_quarantine(torch, ck, work: str, smi: str, k3_path: str, k3_groups,
                    k3_main: dict, launched: dict) -> dict:
    """Phase 12(f): row group 40's ``dates`` page corrupted in a copy of
    the K3 file, read under ``skip_unit`` (prefetch 0 and K, and with the
    clean file through ``scan_files``), ``raise`` and ``skip_file``."""
    import shutil

    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.errors import ParquetError
    from tpu_parquet_torch.quarantine import Quarantine
    from tpu_parquet_torch.writer import corrupt_page

    k = pipeline_depth()
    g40 = QUARANTINE_GROUP
    bad = os.path.join(work, "k3_file_gzip_corrupt.parquet")
    shutil.copyfile(k3_path, bad)
    offset, nbytes = corrupt_page(bad, row_group=g40, column="dates", page=0,
                                  mode="bitflip", seed=g40)
    log(f"quarantine: copied the K3 file to {bad}; corrupted row group "
        f"{g40}'s dates page 0 ({nbytes} bytes at {offset})")
    ck.reset_launches()
    with DeviceFileReader(k3_path, columns=K3_COLUMNS) as r:
        r.read_row_group(g40)
    k3_g40 = ck.launches["fused_narrow_words"]
    k3_pass = k3_main["counts"]["fused_narrow_words"]
    survivors = [g for i, g in enumerate(k3_groups) if i != g40]
    fields = {"file", "column", "row_group", "page", "offset", "error",
              "message"}

    def check_record(q, label):
        recs = q.log.snapshot()
        if len(recs) != 1:
            raise fail(f"{label}: {len(recs)} quarantine records")
        rec = recs[0]
        if (set(rec) != fields or rec["row_group"] != g40
                or rec["column"] != "dates" or rec["page"] != 0
                or rec["file"] != bad or rec["error"] != "ParquetError"):
            raise fail(f"{label}: record {rec}")
        return rec

    out = {}
    for p in (0, k):
        label = f"quarantine skip_unit prefetch {p}"
        outs, seconds, st, counts, _, q, _ = filtered_pass(
            torch, ck, bad, K3_COLUMNS, prefetch=p, on_data_error="skip_unit")
        add_launches(launched, counts)
        check_groups(outs, survivors, K3_COLUMNS, label)
        del outs
        rec = check_record(q, label)
        if (q.units_skipped != 1 or q.rows_skipped != K3_GROUP
                or counts["fused_narrow_words"] != k3_pass - k3_g40):
            raise fail(f"{label}: units_skipped {q.units_skipped}, "
                       f"rows_skipped {q.rows_skipped}, K3 launches "
                       f"{counts['fused_narrow_words']} (want {k3_pass} - "
                       f"{k3_g40})")
        out[p] = seconds
        log(f"{label}: one record {rec}; the other {len(survivors)} row "
            f"groups bit-exact against the generator; K3 launched "
            f"{counts['fused_narrow_words']} = {k3_pass} - {k3_g40} (row "
            f"group {g40}'s); {seconds:.4f} s ({smi})")
    dev = device_breakdown(torch, bad, "quarantine skip_unit",
                           columns=K3_COLUMNS, on_data_error="skip_unit")
    out["device"] = dev

    # raise: the same class and text as without a policy
    texts = []
    for kw in ({}, {"on_data_error": "raise"}):
        try:
            with DeviceFileReader(bad, columns=K3_COLUMNS, **kw) as r:
                for _ in r.iter_row_groups():
                    pass
        except ParquetError as e:
            texts.append((type(e).__name__, str(e)))
        else:
            raise fail(f"quarantine raise {kw}: the read did not raise")
        check_released([r], f"quarantine raise {kw}")
    if texts[0] != texts[1] or f"row_group={g40}" not in texts[0][1]:
        raise fail(f"quarantine raise: {texts}")
    log(f"quarantine raise: {texts[0][0]}: {texts[0][1][:160]}")

    # scan_files with the clean file: skip_unit and skip_file
    for policy, want_groups, skipped in (
            ("skip_unit", survivors + list(k3_groups), 1),
            ("skip_file", list(k3_groups[:g40]) + list(k3_groups),
             len(k3_groups) - g40)):
        for p in (0, k):
            label = f"quarantine scan_files {policy} prefetch {p}"
            q = Quarantine(policy)
            made: list = []
            outs, seconds, counts, _, _, _ = scan_pass(
                torch, ck, [bad, k3_path], p, made=made, quarantine=q,
                columns=K3_COLUMNS)
            add_launches(launched, counts)
            check_groups(outs, want_groups, K3_COLUMNS, label)
            del outs
            check_released(made, label)
            check_record(q, label)
            want_k3 = ((k3_pass - k3_g40) if policy == "skip_unit"
                       else None)
            if (q.units_skipped != skipped
                    or q.files_skipped != (policy == "skip_file")
                    or (want_k3 is not None
                        and counts["fused_narrow_words"]
                        != want_k3 + k3_pass)):
                raise fail(f"{label}: units_skipped {q.units_skipped}, "
                           f"files_skipped {q.files_skipped}, K3 launches "
                           f"{counts['fused_narrow_words']}")
            log(f"{label}: one record; {len(want_groups)} row groups "
                f"bit-exact against the generator; units_skipped "
                f"{q.units_skipped}, files_skipped {q.files_skipped}; K3 "
                f"launched {counts['fused_narrow_words']}; {seconds:.4f} s "
                f"({smi})")
    return out


# ---------------------------------------------------------------------------
# phase 13: reads through byte stores
# ---------------------------------------------------------------------------

# the remote-shaped store's fixed latency per request (13a, 13d)
STORE_LATENCY_S = 0.020
# the fault matrix's store settings (13b): 1 ms backoffs and no per-scan
# retry cap (at prefetch 0 the K3 file's 552 chunk reads at two faults
# each pass the default budget of 64 retries)
MATRIX_CONFIG = {"backoff_ms": 1.0, "retry_budget": 0}
EXHAUST_GROUP = 3  # lineitem16's row group whose l_shipmode chunk fails


def fault_factory(spec: dict, stores: list, **config):
    """A ``store=`` factory: ``FaultInjectingStore(LocalStore(f),
    FaultSpec(**spec), config=IOConfig(**config))``, each store kept in
    ``stores``."""
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)

    def make(f):
        st = FaultInjectingStore(LocalStore(f), FaultSpec(**spec),
                                 config=IOConfig(**config))
        stores.append(st)
        return st
    return make


def io_sum(stores) -> dict:
    """The stores' ``IOStats`` counters, summed."""
    out: dict = {}
    for st in stores:
        for k, v in st.stats.as_dict().items():
            out[k] = out.get(k, 0) + v
    return out


def stop_engine(label: str) -> None:
    """Shut the default fetch engine down (the reads' CUDA tensors still
    alive) and check that its thread is gone: the next engine-routed read
    starts a fresh one."""
    import threading

    from tpu_parquet_torch.iostore_async import shutdown_default_engine

    shutdown_default_engine()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("tpq-fetch")]
    if left:
        raise fail(f"{label}: the fetch engine's thread outlived its "
                   f"shutdown: {left}")


def detached(exc: BaseException) -> BaseException:
    """``exc`` with its traceback and those of the exceptions chained to
    it dropped, for a caller that keeps it.  A traceback's frames hold
    their callers, up to the frame that keeps ``exc``: the cycle would keep
    every tensor of the read's frames on the card until the next garbage
    collection."""
    todo, seen = [exc], set()
    while todo:
        e = todo.pop()
        if e is None or id(e) in seen:
            continue
        seen.add(id(e))
        e.__traceback__ = None
        todo += [e.__cause__, e.__context__]
    return exc


def store_pass(torch, ck, path: str, columns, prefetch: int, mode: str,
               stop=None, **reader_kw) -> dict:
    """One ``DeviceFileReader(..., **reader_kw).iter_row_groups()`` read
    with ``TPQ_IO_ASYNC=mode`` (``"0"`` threaded, ``"1"`` the fetch
    engine), timed end to end.  An IO, cancel or deadline error ends the
    pass and is returned as ``error``; afterwards the engine is shut down
    and the reader checked released (no thread, no pinned buffer out, an
    empty device ledger, no budget).  ``stop``, a token, is cancelled when
    the pass ends (a timer that did not fire)."""
    from tpu_parquet_torch import iostore_async
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.errors import (CancelledError,
                                          DeadlineExceededError,
                                          RetryExhaustedError)

    before = os.environ.get("TPQ_IO_ASYNC")
    os.environ["TPQ_IO_ASYNC"] = mode
    outs, err = [], None
    try:
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        with DeviceFileReader(path, columns=columns, prefetch=prefetch,
                              **reader_kw) as r:
            try:
                for g in r.iter_row_groups():
                    outs.append(g)
            except (RetryExhaustedError, CancelledError,
                    DeadlineExceededError) as e:
                err = detached(e)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(ck.launches)
            st = r.stats().as_dict()
            budget = r._live_budget
            records = r.quarantine.log.snapshot()
    finally:
        if stop is not None:
            stop.cancel()
        if before is None:
            os.environ.pop("TPQ_IO_ASYNC", None)
        else:
            os.environ["TPQ_IO_ASYNC"] = before
    eng = iostore_async.default_engine_if_running()
    peak = eng.stats.inflight_peak if eng is not None else None
    label = f"{os.path.basename(path)} prefetch {prefetch} TPQ_IO_ASYNC={mode}"
    stop_engine(label)
    check_released([r], label)
    if budget is not None:
        raise fail(f"{label}: the chunk feed's budget outlived the scan")
    return dict(outs=outs, seconds=seconds, stats=st, counts=counts,
                peak=peak, records=records, error=err)


def same_read(torch, label: str, got: dict, base: dict) -> None:
    """A store read against the clean ``LocalStore`` read: every tensor on
    the card, the launches, the routes, staged, compressed and link
    bytes."""
    if got["error"] is not None:
        raise fail(f"{label}: {type(got['error']).__name__}: "
                   f"{got['error']}")
    same_on_card(torch, got["outs"], base["outs"], label)
    if got["counts"] != base["counts"]:
        raise fail(f"{label}: launches {got['counts']}, want "
                   f"{base['counts']}")
    for key in ("ship_routes", "staged_bytes", "compressed_bytes",
                "link_bytes_logical", "link_bytes_shipped", "chunks",
                "pages"):
        if got["stats"][key] != base["stats"][key]:
            raise fail(f"{label}: {key} {got['stats'][key]}, want "
                       f"{base['stats'][key]}")


def store_remote(torch, ck, smi: str, path: str, groups, launched: dict):
    """Phase 13(a): lineitem16 SF1 through ``FaultInjectingStore(
    LocalStore(f), FaultSpec(latency_s=STORE_LATENCY_S))`` at prefetch 0, K
    threaded and K through the fetch engine, beside the same reads through
    a plain ``LocalStore``.  Returns (the checked LocalStore read, rows/s
    by pass, idle shares)."""
    k = pipeline_depth()
    label = "store lineitem16 SF1"
    base = store_pass(torch, ck, path, L16_COLUMNS, 0, "0")
    rows, _ = check_groups(base["outs"], groups, L16_COLUMNS,
                           f"{label} LocalStore p0")
    add_launches(launched, base["counts"])
    rates = {}
    runs = [("LocalStore p0", 0, "0", None),
            (f"LocalStore p{k}", k, "0", None)]
    runs += [(f"store {n}", p, m, {"latency_s": STORE_LATENCY_S})
             for n, p, m in (("p0", 0, "0"), (f"p{k} threaded", k, "0"),
                             (f"p{k} engine", k, "1"))]
    for name, p, mode, spec in runs:
        stores: list = []
        kw = {} if spec is None else {"store": fault_factory(spec, stores)}
        got = store_pass(torch, ck, path, L16_COLUMNS, p, mode, **kw)
        same_read(torch, f"{label} {name}", got, base)
        got["outs"] = None
        add_launches(launched, got["counts"])
        rates[name] = rows / got["seconds"]
        extra = ""
        if stores:
            d = io_sum(stores)
            if (d["bytes_read"] != got["stats"]["compressed_bytes"]
                    or d["retries"] or d["exhausted"]):
                raise fail(f"{label} {name}: store counters {d}")
            extra = (f"; {d['reads']} requests ({d['coalesced_spans']} "
                     f"coalesced spans, {d['coalesced_bytes']} bytes) for "
                     f"{got['stats']['chunks']} chunks; engine peak in "
                     f"flight {got['peak']}")
        log(f"{label} {name}: bit-equal to the LocalStore read; launches, "
            f"routes, staged and link bytes equal; {got['seconds']:.4f} s = "
            f"{rates[name]:.1f} rows/s{extra} ({smi})")
    idle = {}
    for name, p, mode, spec in (
            ("LocalStore p0", 0, "0", None),
            ("store p0", 0, "0", {"latency_s": STORE_LATENCY_S}),
            (f"store p{k} engine", k, "1", {"latency_s": STORE_LATENCY_S})):
        os.environ["TPQ_IO_ASYNC"] = mode
        try:
            kw = {} if spec is None else {"store": fault_factory(spec, [])}
            idle[name] = device_breakdown(torch, path, f"{label} {name}",
                                          L16_COLUMNS, prefetch=p,
                                          **kw)["idle"]
        finally:
            os.environ.pop("TPQ_IO_ASYNC", None)
        stop_engine(f"{label} {name} profiled")
    return base, rates, idle


def store_matrix(torch, ck, smi: str, label: str, path: str, columns,
                 base: dict, launched: dict) -> None:
    """Phase 13(b) on one file: ``fail_first=2``, ``torn_first=1`` and
    both, at prefetch 0 and K, threaded and through the engine (prefetch 0
    reads on the consumer thread: its one pass stands for both)."""
    k = pipeline_depth()
    for sname, spec in (("fail_first=2", {"fail_first": 2}),
                        ("torn_first=1", {"torn_first": 1}),
                        ("both", {"fail_first": 2, "torn_first": 1})):
        for p, mode, how in ((0, "0", ""), (k, "0", " threaded"),
                             (k, "1", " engine")):
            name = f"{label} {sname} p{p}{how}"
            stores: list = []
            got = store_pass(torch, ck, path, columns, p, mode,
                             store=fault_factory(spec, stores,
                                                 **MATRIX_CONFIG))
            same_read(torch, name, got, base)
            got["outs"] = None
            add_launches(launched, got["counts"])
            d = io_sum(stores)
            if (d["exhausted"] or ("fail_first" in spec and not d["retries"])
                    or ("torn_first" in spec and not d["short_reads"])):
                raise fail(f"{name}: store counters {d}")
            log(f"{name}: bit-equal, launches equal the clean read; "
                f"{d['reads']} requests, {d['retries']} retries, "
                f"{d['short_reads']} torn re-reads, {d['transient_errors']} "
                f"transient errors; {got['seconds']:.4f} s ({smi})")


def store_exhaust(torch, ck, smi: str, path: str, base: dict,
                  launched: dict) -> None:
    """Phase 13(c): row group ``EXHAUST_GROUP``'s ``l_shipmode`` chunk
    (and any span holding it) fails on every attempt, more than the
    retries: the scan ends in ``RetryExhaustedError`` with its attempt log
    after the earlier groups were staged, and leaves nothing; a clean
    re-read is bit-equal."""
    from tpu_parquet_torch.footer import read_file_metadata

    with open(path, "rb") as f:
        rg = read_file_metadata(f).row_groups[EXHAUST_GROUP]
    victim = next(c.meta_data.data_page_offset for c in rg.columns
                  if c.meta_data.path_in_schema == ["l_shipmode"])
    k = pipeline_depth()
    for p, mode, how in ((0, "0", ""), (k, "1", " engine")):
        label = f"store exhaustion p{p}{how}"
        stores: list = []
        got = store_pass(torch, ck, path, L16_COLUMNS, p, mode,
                         store=fault_factory(
                             {"fail_first": 99,
                              "match": lambda o, s: o <= victim < o + s},
                             stores, backoff_ms=1.0))
        err = got["error"]
        if (type(err).__name__ != "RetryExhaustedError"
                or not err.offset <= victim < err.offset + err.size
                or len(err.attempts) != 5
                or len(got["outs"]) > EXHAUST_GROUP or got["records"]):
            raise fail(f"{label}: {err!r}, {len(got['outs'])} row groups, "
                       f"records {got['records']}")
        d = io_sum(stores)
        log(f"{label}: RetryExhaustedError after {len(got['outs'])} row "
            f"groups: {err}; attempt log {[a['error'] for a in err.attempts]}"
            f"; exhausted {d['exhausted']}, coalesce_fallbacks "
            f"{d['coalesce_fallbacks']}; nothing left: no thread, pinned "
            f"buffer, ledger byte or budget ({smi})")
    got = store_pass(torch, ck, path, L16_COLUMNS, k, "1",
                     store=fault_factory({}, []))
    same_read(torch, "store exhaustion clean re-read", got, base)
    add_launches(launched, got["counts"])
    log(f"store exhaustion: the clean re-read bit-equal, "
        f"{got['seconds']:.4f} s ({smi})")


def store_cancel(torch, ck, smi: str, path: str, base: dict,
                 launched: dict) -> dict:
    """Phase 13(d): the K3 file through the engine at K over a
    ``STORE_LATENCY_S`` store, ended mid-scan by a timer thread's
    ``cancel()`` (``CancelledError``) and by ``CancelToken.with_timeout``
    (``DeadlineExceededError``, within the deadline and one row group),
    at a quarter and two fifths of the clean read's time: nothing left,
    and a re-read is bit-equal."""
    import threading

    from tpu_parquet_torch.resilience import CancelToken

    k = pipeline_depth()
    out = {}
    # a quarter and two fifths of the clean read's time at K: mid-scan on
    # any card
    fire = round(base["seconds"] * 0.25, 3)
    deadline = round(base["seconds"] * 0.4, 3)
    for name, fire, timeout, want in (
            (f"cancel at {fire} s", fire, None, "CancelledError"),
            (f"deadline {deadline} s", None, deadline,
             "DeadlineExceededError")):
        label = f"store {name}"
        stores: list = []
        # the earlier phases' heap frozen: a full collection walking it is
        # a pause of this script, and would land in the bound below
        with FrozenHeap() as heap:
            tok = CancelToken.with_timeout(timeout)
            timer = threading.Timer(fire, tok.cancel) if fire else None
            if timer is not None:
                timer.start()
            got = store_pass(torch, ck, path, K3_COLUMNS, k, "1",
                             stop=timer, cancel=tok,
                             store=fault_factory(
                                 {"latency_s": STORE_LATENCY_S}, stores))
        err = got["error"]
        # one unit: a row group of the clean read at K, plus a request
        unit = base["seconds"] / len(base["outs"]) + STORE_LATENCY_S
        if (type(err).__name__ != want or got["records"]
                or (timeout is not None
                    and got["seconds"] > timeout + unit + 0.25)):
            raise fail(f"{label}: {err!r} after {got['seconds']:.4f} s, "
                       f"records {got['records']}; {heap.summary()}")
        if any("inflight_offset" in st.stats.sample() for st in stores):
            raise fail(f"{label}: a range is still in flight")
        out[name] = got["seconds"]
        log(f"{label}: {want}: {err} after {len(got['outs'])} of "
            f"{len(base['outs'])} row groups, {got['seconds']:.4f} s (a "
            f"unit: {unit:.4f} s; {heap.summary()}); no thread, pinned "
            f"buffer, ledger byte, budget charge or range in flight left "
            f"({smi})")
    got = store_pass(torch, ck, path, K3_COLUMNS, k, "1",
                     store=fault_factory({"latency_s": STORE_LATENCY_S}, []))
    same_read(torch, "store cancel re-read", got, base)
    add_launches(launched, got["counts"])
    log(f"store cancel: a re-read through the engine bit-equal, "
        f"{got['seconds']:.4f} s ({smi})")
    return out


def store_corrupt(torch, ck, smi: str, path: str, groups, base: dict,
                  launched: dict) -> None:
    """Phase 13(e): ``FaultSpec(corrupt="bitflip", match=...)`` on the
    read that starts at row group 40's ``dates`` chunk of the K3 file
    (``coalesce_gap=0``: the chunk alone at prefetch 0; through the engine
    the span of the group's adjacent chunks, which a zero gap still
    merges, as in the reference) under ``skip_unit``, at prefetch 0 and K
    through the engine: one quarantine record of phase 12(f)'s form, K3 launched
    less than on the clean read by group 40's own launches (its ``dates``
    and ``dates32``), the other groups bit-exact."""
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.footer import read_file_metadata

    g40 = QUARANTINE_GROUP
    with open(path, "rb") as f:
        rg = read_file_metadata(f).row_groups[g40]
    victim = rg.columns[K3_COLUMNS.index("dates")].meta_data.data_page_offset
    k = pipeline_depth()
    survivors = [g for i, g in enumerate(groups) if i != g40]
    fields = {"file", "column", "row_group", "page", "offset", "error",
              "message"}
    clean_k3 = base["counts"]["fused_narrow_words"]
    ck.reset_launches()
    with DeviceFileReader(path, columns=K3_COLUMNS) as r:
        r.read_row_group(g40)
    k3_g40 = ck.launches["fused_narrow_words"]
    for p, mode, how in ((0, "0", ""), (k, "1", " engine")):
        label = f"store corrupt skip_unit p{p}{how}"
        got = store_pass(
            torch, ck, path, K3_COLUMNS, p, mode, on_data_error="skip_unit",
            store=fault_factory({"corrupt": "bitflip", "corrupt_seed": g40,
                                 "match": lambda o, s: o == victim},
                                [], coalesce_gap=0))
        add_launches(launched, got["counts"])
        check_groups(got["outs"], survivors, K3_COLUMNS, label)
        got["outs"] = None
        recs = got["records"]
        if (got["error"] is not None or len(recs) != 1
                or set(recs[0]) != fields or recs[0]["row_group"] != g40
                or recs[0]["column"] != "dates"
                or got["counts"]["fused_narrow_words"] != clean_k3 - k3_g40):
            raise fail(f"{label}: {got['error']!r}, records {recs}, K3 "
                       f"launches {got['counts']['fused_narrow_words']} "
                       f"(clean {clean_k3})")
        log(f"{label}: one record {recs[0]}; the other {len(survivors)} row "
            f"groups bit-exact against the generator; K3 launched "
            f"{got['counts']['fused_narrow_words']} = {clean_k3} - {k3_g40} "
            f"(row group {g40}'s); {got['seconds']:.4f} s ({smi})")


def store_chaos(torch, ck, smi: str, shard_dir: str, base: dict,
                l16: dict, launched: dict) -> None:
    """Phase 13(f): phase 11's seven shards through ``scan_files`` with
    ``ChaosSchedule.store_factory`` over a transient burst (the first 40
    read ordinals fail twice, then heal), at prefetch 0 and K through the
    engine: bit-equal to 13(a)'s read, launches equal to phase 11's
    ``scan_files`` pass."""
    from tpu_parquet_torch.iostore import IOConfig
    from tpu_parquet_torch.resilience import ChaosPhase, ChaosSchedule

    paths = sorted(os.path.join(shard_dir, n) for n in os.listdir(shard_dir)
                   if n.endswith(".parquet"))
    schedule = ChaosSchedule([ChaosPhase(0, 40, "transient", intensity=2)],
                             seed=13)
    for p, mode, how in ((0, "0", ""), (pipeline_depth(), "1", " engine")):
        label = f"store chaos scan_files p{p}{how}"
        factory = schedule.store_factory(
            paths, config=IOConfig(backoff_ms=1.0, retry_budget=0))
        made: list = []
        os.environ["TPQ_IO_ASYNC"] = mode
        try:
            outs, seconds, counts, _, _, rows = scan_pass(
                torch, ck, paths, p, made=made, store=factory)
        finally:
            os.environ.pop("TPQ_IO_ASYNC", None)
        stop_engine(label)
        check_released(made, label)
        same_on_card(torch, outs, base["outs"], label)
        del outs
        add_launches(launched, counts)
        if counts != l16["counts"] or rows != SF1_ROWS:
            raise fail(f"{label}: launches {counts}, want phase 11's "
                       f"{l16['counts']}; {rows} rows")
        d = io_sum(factory.stores)
        if d["exhausted"] or not d["transient_errors"]:
            raise fail(f"{label}: store counters {d}")
        log(f"{label}: every row group bit-equal to 13(a)'s; launches equal "
            f"phase 11's; {d['reads']} requests, {d['transient_errors']} "
            f"transient errors, {d['retries']} retries over "
            f"{len(factory.stores)} stores; {seconds:.4f} s = "
            f"{rows / seconds:.1f} rows/s ({smi})")


def read_store_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                     l16_groups, l16: dict, req_path: str, req_groups,
                     k3_path: str, k3_groups) -> dict:
    """Phase 13: the port's reads through byte stores on the card."""
    t0 = time.perf_counter()
    k = pipeline_depth()
    launched: dict = {}
    log(f"store: {collected_bytes(torch)} bytes on the card freed by a "
        f"garbage collection at the phase's start ({smi})")
    log(f"store: FaultInjectingStore over LocalStore; latency "
        f"{STORE_LATENCY_S * 1e3:.0f} ms per request; K = {k}; default "
        f"IOConfig (retries 4, backoff 25 ms, coalesce gap 64 KiB) but in "
        f"the fault matrix, {MATRIX_CONFIG}")
    l16_base, rates, idle = store_remote(torch, ck, smi, l16_path,
                                         l16_groups, launched)
    store_exhaust(torch, ck, smi, l16_path, l16_base, launched)
    store_chaos(torch, ck, smi, os.path.join(work, "lineitem16_sf1_shards"),
                l16_base, l16, launched)
    del l16_base
    req_base = store_pass(torch, ck, req_path, COLUMNS, k, "0")
    check_groups(req_base["outs"], req_groups, COLUMNS,
                 "store REQUIRED lineitem LocalStore")
    add_launches(launched, req_base["counts"])
    store_matrix(torch, ck, smi, "store REQUIRED lineitem", req_path,
                 COLUMNS, req_base, launched)
    del req_base
    k3_base = store_pass(torch, ck, k3_path, K3_COLUMNS, k, "0")
    check_groups(k3_base["outs"], k3_groups, K3_COLUMNS,
                 "store K3 file LocalStore")
    add_launches(launched, k3_base["counts"])
    store_matrix(torch, ck, smi, "store K3 file", k3_path, K3_COLUMNS,
                 k3_base, launched)
    cancels = store_cancel(torch, ck, smi, k3_path, k3_base, launched)
    store_corrupt(torch, ck, smi, k3_path, k3_groups, k3_base, launched)
    del k3_base
    for kname in ("hybrid_unpack_combine", "fused_plain_words",
                  "fused_narrow_words"):
        if not launched.get(kname):
            raise fail(f"phase 13 never launched {kname}")
    wall = time.perf_counter() - t0
    log(f"store summary ({smi}): lineitem16 SF1 rows/s " + ", ".join(
        f"{n} {v:.1f}" for n, v in rates.items()) + "; idle share "
        + ", ".join(f"{n} {v}" for n, v in idle.items())
        + f"; cancel/deadline seconds {cancels}; phase 13 launches "
        f"{launched}; phase 13 wall {wall:.2f} s")
    return dict(launched=launched, rates=rates, idle=idle, wall=wall)


# ---------------------------------------------------------------------------
# phase 14: the read caches
# ---------------------------------------------------------------------------

CACHE_HBM_MB = 2048  # 14(a): the device tier holds all of lineitem16 SF1
SMALL_HBM_MB = 256  # 14(b): a tier smaller than the file's columns
MUTATED_SHARD = 3  # 14(e): the shard rewritten with MUTATION_SEED
MUTATION_SEED = 14


def counting_local_factory(reads: list):
    """A ``store=`` factory of ``LocalStore``s (the default read path) that
    count their ``read_range`` calls into ``reads[0]``."""
    from tpu_parquet_torch.iostore import LocalStore

    class CountingLocalStore(LocalStore):
        def read_range(self, offset, size, *args, **kwargs):
            reads[0] += 1
            return super().read_range(offset, size, *args, **kwargs)

    return CountingLocalStore


def check_cache_ledger(cache, label: str) -> None:
    """The cache's own device ledger holds its tier's bytes and nothing
    else."""
    held = cache.results.counters()["device"]["held_bytes"]
    in_use = cache.results.tracker.device_snapshot()[0]
    if in_use != held:
        raise fail(f"{label}: the cache's device ledger holds {in_use} "
                   f"bytes, its tier {held}")


def cache_pass(torch, ck, cache, path: str, columns, label: str,
               prefetch: int = 0, stream=None) -> dict:
    """One read of ``path`` through ``cache.reader_kwargs(path,
    device=True)`` (the footer, plan, dictionary and result caches),
    timed end to end from the cache lookups to a synchronize, under
    ``stream`` when given.  Returns the outputs, seconds, launches, store
    reads, reader stats and the device memory the pass left allocated;
    the reader is checked released and the cache's ledger its tier's."""
    import contextlib
    import gc

    from tpu_parquet_torch.device_reader import DeviceFileReader

    reads = [0]
    gc.collect()
    torch.cuda.synchronize()
    ck.reset_launches()
    before = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        kw = cache.reader_kwargs(path, columns=columns, device=True)
        with DeviceFileReader(path, columns=columns, prefetch=prefetch,
                              store=counting_local_factory(reads),
                              **kw) as r:
            outs = list(r.iter_row_groups())
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = dict(ck.launches)
            st = r.stats().as_dict()
    check_released([r], label)
    check_cache_ledger(cache, label)
    return dict(outs=outs, seconds=seconds, counts=counts, reads=reads[0],
                stats=st, added=torch.cuda.memory_allocated() - before,
                grown=torch.cuda.memory_reserved() - reserved)


def cached_tensors(cache, label: str) -> int:
    """The device tier's tensors, each checked to own its whole storage
    (a view would pin the buffer it views); returns their number."""
    from tpu_parquet_torch.serve.result_cache import DEVICE_TENSOR_ATTRS

    n = 0
    for key, (col, _n, _t, _u) in cache.results._entries.items():
        if key[0] != "chunk":
            continue
        for attr in DEVICE_TENSOR_ATTRS:
            t = getattr(col, attr, None)
            if t is None:
                continue
            n += 1
            if t.untyped_storage().nbytes() != t.numel() * t.element_size():
                raise fail(f"{label}: cached {key[3]}.{attr} of row group "
                           f"{key[2]} views {t.untyped_storage().nbytes()} "
                           f"bytes for {t.numel() * t.element_size()}")
    return n


def cache_lineitem16(torch, ck, smi: str, l16_path: str, l16: dict,
                     launched: dict) -> dict:
    """Phase 14(a), (b) and (f): lineitem16 SF1's 16 columns through a
    2 GiB device tier (a cold read, two warm ones, one warm on a
    non-default stream), then through a 256 MiB tier."""
    import gc

    from tpu_parquet_torch.serve import PlanCache

    label = "cache (a) lineitem16 SF1"
    base, plain_s, _ = timed_pass(torch, l16_path, L16_COLUMNS)
    cache = PlanCache(result_cache_mb=0, result_cache_hbm_mb=CACHE_HBM_MB)
    gc.collect()
    torch.cuda.synchronize()
    before_cache = torch.cuda.memory_allocated()
    cold = cache_pass(torch, ck, cache, l16_path, L16_COLUMNS,
                      f"{label} cold")
    add_launches(launched, cold["counts"])
    if cold["counts"] != l16["counts"]:
        raise fail(f"{label}: cold launches {cold['counts']}, want phase "
                   f"6's {l16['counts']}")
    same_on_card(torch, cold["outs"], base, f"{label} cold")
    # tensors published as copies: the cold read's were views
    cloned = sum(
        t.data_ptr() != getattr(g[key[3]], attr).data_ptr()
        for key, (col, _n, _t, _u) in cache.results._entries.items()
        if key[0] == "chunk"
        for g in (cold["outs"][key[2]],)
        for attr, t in vars(col).items() if isinstance(t, torch.Tensor))
    rc = cache.results.counters()
    dev = rc["device"]
    n_chunks = len(base) * len(L16_COLUMNS)
    if (dev["entries"] != n_chunks or dev["evictions"] or dev["rejected"]
            or rc["host"]["evictions"]):
        raise fail(f"{label}: the device tier after the cold read {rc}")
    warm = []
    for i in (1, 2):
        w = cache_pass(torch, ck, cache, l16_path, L16_COLUMNS,
                       f"{label} warm {i}")
        if w["reads"] or any(w["counts"].values()) or w["added"]:
            raise fail(f"{label} warm {i}: {w['reads']} store reads, "
                       f"launches {w['counts']}, {w['added']} bytes "
                       f"allocated")
        same_on_card(torch, w["outs"], cold["outs"], f"{label} warm {i}")
        w["outs"] = None
        warm.append(w)
    dev = cache.results.counters()["device"]
    if dev["hits"] != 2 * n_chunks:
        raise fail(f"{label}: {dev['hits']} device hits, want "
                   f"{2 * n_chunks}")
    cold_outs = cold.pop("outs")
    del cold_outs
    gc.collect()
    torch.cuda.synchronize()
    pinned_by_cache = torch.cuda.memory_allocated() - before_cache
    tensors = cached_tensors(cache, label)
    # the allocator rounds a block up to 512 bytes and may leave up to 1 MiB
    # of a large segment unsplit in it; a cached view of a staged buffer
    # would keep the whole buffer (tens of MiB) allocated
    if not dev["held_bytes"] <= pinned_by_cache <= (dev["held_bytes"]
                                                     + (1 << 20) * tensors):
        raise fail(f"{label}: {pinned_by_cache} bytes left allocated by "
                   f"the cache, its tier counts {dev['held_bytes']} in "
                   f"{tensors} tensors")
    out = dict(plain=SF1_ROWS / plain_s, cold=SF1_ROWS / cold["seconds"],
               warm=[SF1_ROWS / w["seconds"] for w in warm],
               held=dev["held_bytes"], pinned=pinned_by_cache,
               cold_reads=cold["reads"], cloned=cloned, grown=cold["grown"])
    log(f"{label}: cold read (fills the tier) launches equal phase 6's, "
        f"{cold['reads']} store reads, bit-equal to an uncached read, "
        f"{cloned} tensors published as copies of views, the allocator's "
        f"reserve grown {cold['grown']} bytes in it; two "
        f"warm reads: 0 store reads, 0 launches, 0 bytes allocated, every "
        f"tensor equal to the cold read's; the tier holds {n_chunks} "
        f"chunks, {dev['held_bytes']} bytes in {tensors} tensors, each "
        f"owning its storage; {pinned_by_cache} bytes allocated after the "
        f"cold outputs are dropped; rows/s uncached "
        f"{out['plain']:.1f} (phase 6's warm pass "
        f"{l16['rows_per_s']:.1f}), cold {out['cold']:.1f}, warm "
        + ", ".join(f"{v:.1f}" for v in out["warm"]) + f" ({smi})")

    # (f) a warm read on a non-default stream
    label_f = "cache (f) warm read on a non-default stream"
    stream = torch.cuda.Stream()
    w = cache_pass(torch, ck, cache, l16_path, L16_COLUMNS, label_f,
                   stream=stream)
    if w["reads"] or any(w["counts"].values()):
        raise fail(f"{label_f}: {w['reads']} store reads, launches "
                   f"{w['counts']}")
    with torch.cuda.stream(stream):
        same_on_card(torch, w["outs"], base, label_f)
    out["stream"] = SF1_ROWS / w["seconds"]
    del w
    log(f"{label_f}: bit-equal to the uncached read, compared on that "
        f"stream; {out['stream']:.1f} rows/s ({smi})")
    del cache
    gc.collect()
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != before_cache:
        raise fail(f"{label}: {torch.cuda.memory_allocated() - before_cache}"
                   f" bytes still allocated after the cache was dropped")

    # (b) a 256 MiB device tier: evictions inside it
    label = "cache (b) lineitem16 SF1, 256 MiB device tier"
    cache = PlanCache(result_cache_mb=0, result_cache_hbm_mb=SMALL_HBM_MB)
    cap = SMALL_HBM_MB << 20
    passes = []
    for i in range(2):
        p = cache_pass(torch, ck, cache, l16_path, L16_COLUMNS,
                       f"{label} read {i + 1}")
        add_launches(launched, p["counts"])
        same_on_card(torch, p["outs"], base, f"{label} read {i + 1}")
        p["outs"] = None
        passes.append(p)
    rc = cache.results.counters()
    in_use, peak = cache.results.tracker.device_snapshot()
    if (not rc["device"]["evictions"] or rc["host"]["evictions"]
            or peak > cap or in_use > cap):
        raise fail(f"{label}: device evictions {rc['device']['evictions']}, "
                   f"host evictions {rc['host']['evictions']}, ledger "
                   f"{in_use} bytes, peak {peak} against a {cap}-byte cap")
    out["small"] = dict(evictions=rc["device"]["evictions"],
                        hits=rc["device"]["hits"], peak=peak,
                        held=rc["device"]["held_bytes"],
                        rates=[SF1_ROWS / p["seconds"] for p in passes])
    del cache, passes, p
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before_cache
    if left:
        raise fail(f"{label}: {left} bytes still allocated after the cache "
                   f"was dropped")
    log(f"{label}: both reads bit-equal to the uncached read; "
        f"{out['small']['evictions']} device evictions, 0 host; device "
        f"hits {out['small']['hits']}; the ledger's peak {peak} bytes "
        f"under the {cap}-byte cap; rows/s " + ", ".join(
            f"{v:.1f}" for v in out["small"]["rates"])
        + f"; allocation back to its level before the cache ({smi})")
    del base
    return out


def cache_dictionaries(torch, ck, smi: str, pa_path: str, pa_layout: dict,
                       launched: dict) -> dict:
    """Phase 14(c): phase 8's pyarrow-layout file through the dictionary
    cache alone, twice: the second read adopts every dictionary."""
    from tpu_parquet_torch.serve import PlanCache

    label = "cache (c) dictionaries, lineitem16 pyarrow layout"
    cache = PlanCache(result_cache_mb=0, result_cache_hbm_mb=0)
    first = cache_pass(torch, ck, cache, pa_path, L16_COLUMNS,
                       f"{label} read 1")
    c1 = cache.counters()
    second = cache_pass(torch, ck, cache, pa_path, L16_COLUMNS,
                        f"{label} read 2")
    c2 = cache.counters()
    for p in (first, second):
        add_launches(launched, p["counts"])
    same_on_card(torch, second["outs"], first["outs"], label)
    del first["outs"], second["outs"]
    if (c1["dict_hits"] or not c1["dict_misses"]
            or c2["dict_hits"] != c1["dict_misses"]
            or c2["dict_misses"] != c1["dict_misses"]):
        raise fail(f"{label}: dictionary counters {c1} then {c2}")
    if (first["counts"] != pa_layout["counts"]
            or second["counts"] != first["counts"]
            or second["stats"]["ship_routes"]
            != first["stats"]["ship_routes"]):
        raise fail(f"{label}: launches {first['counts']} then "
                   f"{second['counts']} (phase 8's {pa_layout['counts']}), "
                   f"or routes differ")
    out = dict(dicts=c1["dict_misses"], first=SF1_ROWS / first["seconds"],
               second=SF1_ROWS / second["seconds"],
               host1=first["stats"]["host_seconds"],
               host2=second["stats"]["host_seconds"])
    log(f"{label}: read 2 adopted all {c1['dict_misses']} decoded "
        f"dictionaries; bit-equal, launches and routes equal read 1's and "
        f"phase 8's; rows/s {out['first']:.1f} then {out['second']:.1f}; "
        f"host_seconds {out['host1']:.4f} then {out['host2']:.4f} ({smi})")
    return out


def q6_sweep(torch, ck, cache, shards, prefetch: int, mode: str,
             label: str, launched: dict) -> dict:
    """One ``scan_files(shards, row_filter=Q6, plan_cache=cache)`` sweep
    through ``FaultInjectingStore``s with no fault (so ``TPQ_IO_ASYNC=1``
    routes them through the fetch engine), counting page-header walks.
    Returns the outputs, seconds, launches, store reads, header walks,
    prune and host seconds summed over the shards' readers."""
    from tpu_parquet_torch import device_reader as DR
    from tpu_parquet_torch.predicate import col

    q6 = ((col("l_shipdate") >= Q6_DATES[0])
          & (col("l_shipdate") < Q6_DATES[1])
          & col("l_discount").between(0.05, 0.07)
          & (col("l_quantity") < 24))
    stores: list = []
    made: list = []
    walks = [0]
    real = DR.plan_page_pruning

    def counted(*args, **kwargs):
        walks[0] += 1
        return real(*args, **kwargs)

    DR.plan_page_pruning = counted
    os.environ["TPQ_IO_ASYNC"] = mode
    try:
        outs, seconds, counts, _, _, rows = scan_pass(
            torch, ck, shards, prefetch, made=made, row_filter=q6,
            columns=Q6_COLUMNS, plan_cache=cache,
            store=fault_factory({}, stores))
    finally:
        DR.plan_page_pruning = real
        os.environ.pop("TPQ_IO_ASYNC", None)
    stop_engine(label)
    check_released(made, label)
    check_cache_ledger(cache, label)
    add_launches(launched, counts)
    if rows != SF1_ROWS:
        raise fail(f"{label}: {rows} rows, want {SF1_ROWS}: Q6 prunes "
                   f"nothing")
    return dict(outs=outs, seconds=seconds, counts=counts,
                reads=io_sum(stores).get("reads", 0), walks=walks[0],
                prune=sum(r.stats().prune_seconds for r in made),
                host=sum(r.stats().host_seconds for r in made))


def cache_q6(torch, ck, smi: str, l16_path: str, shard_dir: str,
             launched: dict) -> dict:
    """Phase 14(d) and (e): Q6 over phase 11's seven shards through
    ``scan_files(plan_cache=)``, two sweeps at prefetch 0 and two at K
    through the fetch engine, with the plan cache alone and with a device
    tier; then one shard rewritten with a new seed and ``note_mutation``."""
    import gc

    from tpu_parquet_torch.serve import PlanCache

    k = pipeline_depth()
    shards = sorted(os.path.join(shard_dir, n) for n in os.listdir(shard_dir)
                    if n.endswith(".parquet"))
    want, _, _ = timed_pass(torch, l16_path, Q6_COLUMNS)
    out: dict = {}
    warm_cache = None
    for p, mode, how in ((0, "0", ""), (k, "1", " engine")):
        for tier_mb in (0, CACHE_HBM_MB):
            tag = f"p{p}{how}, " + (f"{tier_mb} MiB device tier" if tier_mb
                                    else "plan cache alone")
            label = f"cache (d) Q6 scan_files {tag}"
            cache = PlanCache(result_cache_mb=0,
                              result_cache_hbm_mb=tier_mb)
            sweeps = []
            for i in (1, 2):
                s = q6_sweep(torch, ck, cache, shards, p, mode,
                             f"{label} sweep {i}", launched)
                same_on_card(torch, s["outs"], want, f"{label} sweep {i}")
                s["outs"] = None
                s["counters"] = cache.counters()
                sweeps.append(s)
            s1, s2 = sweeps
            if (s2["walks"] or s2["counters"]["footer_misses"]
                    != s1["counters"]["footer_misses"]
                    or s1["counters"]["footer_misses"] != len(shards)
                    or not s1["walks"]):
                raise fail(f"{label}: header walks {s1['walks']} then "
                           f"{s2['walks']}, footer misses "
                           f"{s1['counters']['footer_misses']} then "
                           f"{s2['counters']['footer_misses']}")
            if tier_mb and (s2["reads"] or any(s2["counts"].values())):
                raise fail(f"{label}: the warm sweep made {s2['reads']} "
                           f"store reads and launches {s2['counts']}")
            if not tier_mb and s2["counts"] != s1["counts"]:
                raise fail(f"{label}: launches {s1['counts']} then "
                           f"{s2['counts']}")
            out[tag] = dict(rates=[SF1_ROWS / s["seconds"] for s in sweeps],
                            prune=[s["prune"] for s in sweeps],
                            host=[s["host"] for s in sweeps],
                            reads=[s["reads"] for s in sweeps])
            log(f"{label}: both sweeps bit-equal to the unfiltered read; "
                f"sweep 2 walked no footer and no page header (footer "
                f"misses {s1['counters']['footer_misses']}, walks "
                f"{s1['walks']} then 0); store reads {s1['reads']} then "
                f"{s2['reads']}; launches {s1['counts']} then "
                f"{s2['counts']}; prune_seconds {s1['prune']:.6f} then "
                f"{s2['prune']:.6f} of host_seconds {s1['host']:.4f} then "
                f"{s2['host']:.4f}; rows/s {out[tag]['rates'][0]:.1f} then "
                f"{out[tag]['rates'][1]:.1f} ({smi})")
            if tier_mb and p == k:
                warm_cache = cache
            del cache, sweeps, s1, s2
    del want
    gc.collect()

    # (e) one shard rewritten with a new seed, then note_mutation
    label = "cache (e) invalidation"
    cache = warm_cache
    target = os.path.abspath(shards[MUTATED_SHARD])
    stale = [key for key in cache.results._entries if key[1][1] == target]
    held = sum(1 for key in cache._entries if key[1][1] == target)
    inv0 = cache.results.counters()
    group = lineitem_strings(next(draw_lineitem16(ROWS_PER_GROUP,
                                                  seed=MUTATION_SEED)))
    write_lineitem16(target, [group])
    dropped = cache.note_mutation(target)
    inv1 = cache.results.counters()
    invalidated = sum(inv1[t]["invalidations"] - inv0[t]["invalidations"]
                      for t in ("host", "device"))
    left = [key for key in cache.results._entries if key[1][1] == target]
    if dropped != held or invalidated != len(stale) or left:
        raise fail(f"{label}: dropped {dropped} of {held} plan-cache "
                   f"entries, invalidated {invalidated} of {len(stale)} "
                   f"results, {len(left)} left")
    check_cache_ledger(cache, label)
    s = q6_sweep(torch, ck, cache, shards, k, "1", f"{label} re-read",
                 launched)
    fresh = s["outs"][MUTATED_SHARD:MUTATED_SHARD + 1]
    check_groups(fresh, [group], Q6_COLUMNS, f"{label} rewritten shard")
    rest = s["outs"][:MUTATED_SHARD] + s["outs"][MUTATED_SHARD + 1:]
    want, _, _ = timed_pass(torch, l16_path, Q6_COLUMNS)
    same_on_card(torch, rest, want[:MUTATED_SHARD] + want[MUTATED_SHARD + 1:],
                 f"{label} other shards")
    del want, rest, fresh
    s["outs"] = None
    out["mutation"] = dict(dropped=dropped, invalidated=invalidated,
                           reads=s["reads"], counts=s["counts"])
    log(f"{label}: shard {MUTATED_SHARD} rewritten (seed {MUTATION_SEED}); "
        f"note_mutation dropped its {dropped} footer and plan entries and "
        f"invalidated its {invalidated} cached results ("
        f"{inv1['device']['invalidations'] - inv0['device']['invalidations']}"
        f" device chunks, "
        f"{inv1['host']['invalidations'] - inv0['host']['invalidations']} "
        f"dictionaries); the re-read bit-equal to the new generator on that "
        f"shard and to the old read elsewhere, {s['reads']} store reads and "
        f"launches {s['counts']} for the one cold shard ({smi})")
    del cache, warm_cache, s
    gc.collect()
    return out


def read_cache_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                     l16: dict, pa_layout: dict) -> dict:
    """Phase 14: the read caches on the card."""
    import gc

    t0 = time.perf_counter()
    launched: dict = {}
    # the baseline is taken after a collection: garbage of earlier phases
    # freed inside this one would read as a negative leak
    freed = collected_bytes(torch)
    before = torch.cuda.memory_allocated()
    log(f"cache: PlanCache(result_cache_mb=0, result_cache_hbm_mb="
        f"{CACHE_HBM_MB}) and {SMALL_HBM_MB}; K = {pipeline_depth()}; "
        f"{freed} bytes on the card freed by a garbage collection at the "
        f"phase's start ({smi})")
    out = {"lineitem16": cache_lineitem16(torch, ck, smi, l16_path, l16,
                                          launched)}
    out["dicts"] = cache_dictionaries(
        torch, ck, smi, os.path.join(work, "lineitem16_pyarrow_layout.parquet"),
        pa_layout, launched)
    out["q6"] = cache_q6(torch, ck, smi, l16_path,
                         os.path.join(work, "lineitem16_sf1_shards"),
                         launched)
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    if left:
        raise fail(f"phase 14: {left} bytes still allocated after its "
                   f"caches were dropped")
    for kname in ("hybrid_unpack_combine", "fused_plain_words"):
        if not launched.get(kname):
            raise fail(f"phase 14 never launched {kname}")
    out["launched"] = launched
    out["wall"] = time.perf_counter() - t0
    a = out["lineitem16"]
    log(f"cache summary ({smi}): lineitem16 SF1 rows/s uncached "
        f"{a['plain']:.1f}, cold {a['cold']:.1f}, warm "
        + ", ".join(f"{v:.1f}" for v in a["warm"])
        + f", warm on a side stream {a['stream']:.1f}; device tier "
        f"{a['held']} bytes; phase 14 launches {launched}; phase 14 wall "
        f"{out['wall']:.2f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: obs on the card
# ---------------------------------------------------------------------------

OBS_HANG_S = 2.0  # phase 15(d)'s watchdog deadline


def obs_pass(torch, ck, path: str, columns, **reader_kw) -> dict:
    """One ``DeviceFileReader(path, **reader_kw).iter_row_groups()`` read,
    timed end to end (ending in a synchronize), between two timing events
    on the current stream: the read's device window, which the device
    lane's serialized seconds cannot exceed.  Returns the outputs, the
    seconds, the launches, the device window, the registry tree, the
    lane's view by CUDA kernel and the reader (closed)."""
    from tpu_parquet_torch.device_reader import DeviceFileReader

    torch.cuda.synchronize()
    ck.reset_launches()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    r = DeviceFileReader(path, columns=columns, **reader_kw)
    outs = list(r.iter_row_groups())
    e1.record()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = dict(ck.launches)
    tree = r.obs_registry().as_dict()
    view = r.device_stats().cuda_kernels()
    r.close()
    return dict(outs=outs, seconds=seconds, counts=counts, tree=tree,
                view=view, window=e0.elapsed_time(e1) / 1e3, reader=r)


def lane_checks(p: dict, label: str) -> float:
    """The device lane of one pass, against the launch counters and the
    read's device window.  Returns the lane's total seconds."""
    dev = p["tree"]["device"]
    if dev is None:
        raise fail(f"{label}: no device section (the lane is off)")
    for name, n in p["counts"].items():
        got = p["view"].get(name, {}).get("launches", 0)
        if got != n:
            raise fail(f"{label}: the device lane counted {got} launches of "
                       f"{name}, the counter rose by {n}")
    total = (sum(c["device_seconds"] for c in dev["routes"].values())
             + dev["h2d"]["device_seconds"])
    units = dev["dispatches"] + dev["h2d"]["transfers"]
    # each timed unit's two events read the device clock at 0.5 us steps
    if total > p["window"] + 1e-6 * units:
        raise fail(f"{label}: the lane's {total:.6f} s exceed the read's "
                   f"device window {p['window']:.6f} s")
    return total


def profile_kernel_times(path: str) -> dict:
    """``{kernel name: (device seconds, launches)}`` from a
    ``torch.profiler`` Chrome trace (its ``kernel`` events)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            s, n = out.get(e["name"], (0.0, 0))
            out[e["name"]] = (s + e["dur"] / 1e6, n + 1)
    return out


def trace_names(path: str) -> set:
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def stall_third_fetch():
    """A store factory whose store stalls (60 s, until the watchdog's abort
    wakes it) on the third range it is asked for; returns (factory, the
    stores it made)."""
    import threading

    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)

    stores = []

    def make(f):
        seen, lock = [], threading.Lock()

        def third(offset, size):
            with lock:
                seen.append(offset)
                return len(seen) == 3

        st = FaultInjectingStore(
            LocalStore(f), FaultSpec(stall_first=1, stall_s=60.0,
                                     match=third),
            config=IOConfig(retries=0, backoff_ms=1.0))
        stores.append(st)
        return st

    return make, stores


def aborted_reads(torch, work: str, path: str, columns, smi: str) -> dict:
    """Phase 15(d): a read through a stalling store at prefetch 4 under
    ``hang_s=OBS_HANG_S``, ``hang_policy="raise"``, and a read cancelled
    after its first row group, both with the garbage collector off: the
    hang raised within ``hang_s`` + 2 s, its flight dump autopsied as a
    network stall, and the device memory back to the phase's baseline
    after each, the verdicts still held."""
    import gc

    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.errors import CancelledError, HangError
    from tpu_parquet_torch.iostore_async import shutdown_default_engine
    from tpu_parquet_torch.obs import autopsy_dump
    from tpu_parquet_torch.resilience import CancelToken

    label = "obs (d)"
    dump = os.path.join(work, "obs_hang_dump.json")
    os.environ["TPQ_FLIGHT"] = dump
    collected_bytes(torch)
    base = torch.cuda.memory_allocated()
    out = {}
    gc.disable()
    try:
        factory, stores = stall_third_fetch()
        r = DeviceFileReader(path, columns=columns, prefetch=4,
                             hang_s=OBS_HANG_S, hang_policy="raise",
                             store=factory)
        t0 = time.perf_counter()
        hang = None
        try:
            for g in r.iter_row_groups():
                del g
        except HangError as e:
            hang = e
        took = time.perf_counter() - t0
        for st in stores:
            st.release()
        r.close()
        shutdown_default_engine()
        if hang is None:
            raise fail(f"{label}: the stalled read ended without a HangError")
        if took > OBS_HANG_S + 2.0:
            raise fail(f"{label}: HangError after {took:.3f} s, want under "
                       f"{OBS_HANG_S + 2.0} s")
        torch.cuda.synchronize()
        left_hang = torch.cuda.memory_allocated() - base
        tok = CancelToken()
        r2 = DeviceFileReader(path, columns=columns, prefetch=4, cancel=tok)
        it = r2.iter_row_groups()
        g = next(it)
        del g
        tok.cancel()
        cancelled = None
        try:
            next(it)
        except CancelledError as e:
            cancelled = e
        r2.close()
        torch.cuda.synchronize()
        left_cancel = torch.cuda.memory_allocated() - base
        if cancelled is None or tok._exc is not cancelled:
            raise fail(f"{label}: the cancelled read did not raise the "
                       f"token's verdict")
        held = (r._watchdog.error is hang, cancelled.__traceback__ is not None)
    finally:
        gc.enable()
        os.environ.pop("TPQ_FLIGHT", None)
    if left_hang or left_cancel:
        raise fail(f"{label}: {left_hang} bytes (hang) and {left_cancel} "
                   f"bytes (cancel) still on the card with no collection")
    with open(hang.dump_path) as f:
        rep = autopsy_dump(json.load(f))
    if rep["verdict"] != "network-stall" or rep["io"] is None:
        raise fail(f"{label}: autopsy verdict {rep['verdict']!r}, io "
                   f"{rep['io']}, want network-stall")
    check_released([r, r2], label)
    log(f"{label}: HangError after {took:.3f} s (hang_s {OBS_HANG_S}); "
        f"autopsy {rep['verdict']}: {rep['probable_cause']}; device memory "
        f"back to the baseline with the collector off after the hang and "
        f"the cancel (verdicts still held: {held}) ({smi})")
    out.update(took=took, verdict=rep["verdict"])
    return out


def read_obs_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                   l16: dict, k3_path: str) -> dict:
    """Phase 15: obs on the card, lineitem16 SF1 at full size."""
    t_phase = time.perf_counter()
    launched: dict = {}
    label = "obs"
    trace_path = os.path.join(work, "obs_trace.json")
    # (a) every option on against the plain read, in turns
    want, _, _ = timed_pass(torch, l16_path, L16_COLUMNS)
    rates = {"plain": [], "obs": []}
    kept = None
    for kind in ("plain", "obs", "obs", "plain"):
        if kind == "plain":
            keep, secs, _ = timed_pass(torch, l16_path, L16_COLUMNS)
            del keep
        else:
            p = obs_pass(torch, ck, l16_path, L16_COLUMNS, trace=trace_path,
                         sample_ms=50, hang_s=30)
            secs = p["seconds"]
            if kept is None:
                kept = p
                same_on_card(torch, p["outs"], want, f"{label} (a)")
            add_launches(launched, p["counts"])
            p["outs"] = None
        rates[kind].append(SF1_ROWS / secs)
    del want
    for name in ("hybrid_unpack_combine", "fused_plain_words"):
        if not kept["counts"][name]:
            raise fail(f"{label} (a): never launched {name}")
    names = trace_names(trace_path)
    for want_name in ("stage", "dispatch", "finalize", "pipeline_lanes",
                      "device.h2d"):
        if want_name not in names:
            raise fail(f"{label} (a): the trace has no {want_name!r}")
    log(f"{label} (a): every option on (trace, sample_ms=50, hang_s=30, "
        f"device lane) bit-equal to the plain read; rows/s plain "
        + ", ".join(f"{v:.1f}" for v in rates["plain"]) + ", obs "
        + ", ".join(f"{v:.1f}" for v in rates["obs"])
        + f" ({smi})")
    # (b) the lane against the counters and the device window
    total = lane_checks(kept, f"{label} (b)")
    dev = kept["tree"]["device"]
    log(f"{label} (b): lane {total:.6f} s of the read's device window "
        f"{kept['window']:.6f} s; per CUDA kernel "
        + ", ".join(f"{k} {v['plans']} plans {v['launches']} launches "
                    f"{v['device_seconds']:.6f} s"
                    for k, v in kept["view"].items()))
    # (c) profile_dir= on the same read: the profiler's kernel times beside
    # the lane's, and the wrappers named in the trace
    prof_dir = os.path.join(work, "obs_profile")
    shutil.rmtree(prof_dir, ignore_errors=True)
    p = obs_pass(torch, ck, l16_path, L16_COLUMNS, profile_dir=prof_dir)
    p["outs"] = None
    add_launches(launched, p["counts"])
    lane_checks(p, f"{label} (c)")
    prof_path = p["reader"].profile_path
    if not prof_path or not os.path.exists(prof_path):
        raise fail(f"{label} (c): profile_dir wrote no trace")
    names = trace_names(prof_path)
    for want_name in ("hybrid_unpack_combine", "fused_plain_words",
                      "stage", "dispatch", "finalize"):
        if want_name not in names:
            raise fail(f"{label} (c): the profile names no {want_name!r}")
    kt = profile_kernel_times(prof_path)
    tpq = {k: v for k, v in kt.items() if "tpq_" in k}
    busy = sum(s for s, _ in kt.values())
    dev = p["tree"]["device"]
    log(f"{label} (c): {prof_path}: device busy {busy:.6f} s in "
        f"{sum(n for _, n in kt.values())} kernels; the port's kernels "
        + ", ".join(f"{k} {s:.6f} s in {n}" for k, (s, n) in sorted(
            tpq.items())))
    log(f"{label} (c): lane per route (device_seconds, dispatches, "
        f"device_passes): " + ", ".join(
            f"{r} {c['device_seconds']:.6f} s {c['dispatches']} "
            f"{c['device_passes']}" for r, c in dev["routes"].items())
        + f"; h2d {dev['h2d']['device_seconds']:.6f} s in "
        f"{dev['h2d']['transfers']}; per CUDA kernel " + ", ".join(
            f"{k} {v['device_seconds']:.6f} s" for k, v in p["view"].items())
        + f"; window {p['window']:.6f} s ({smi})")
    # a TPQ_XPROF window on phase 5's K3 file
    xdir = os.path.join(work, "obs_xprof")
    shutil.rmtree(xdir, ignore_errors=True)
    os.environ["TPQ_XPROF"] = xdir
    os.environ["TPQ_XPROF_S"] = "60"
    try:
        px = obs_pass(torch, ck, k3_path, K3_COLUMNS)
    finally:
        os.environ.pop("TPQ_XPROF", None)
        os.environ.pop("TPQ_XPROF_S", None)
    px["outs"] = None
    add_launches(launched, px["counts"])
    if not px["counts"]["fused_narrow_words"]:
        raise fail(f"{label} (c): the K3 read never launched "
                   f"fused_narrow_words")
    xfiles = sorted(os.listdir(xdir)) if os.path.isdir(xdir) else []
    if not xfiles or "fused_narrow_words" not in trace_names(
            os.path.join(xdir, xfiles[0])):
        raise fail(f"{label} (c): the TPQ_XPROF window {xfiles} names no "
                   f"fused_narrow_words")
    xk = profile_kernel_times(os.path.join(xdir, xfiles[0]))
    log(f"{label} (c): TPQ_XPROF window {xfiles[0]} on the K3 file: "
        + ", ".join(f"{k} {s:.6f} s in {n}" for k, (s, n) in sorted(
            xk.items()) if "tpq_" in k)
        + "; lane per CUDA kernel " + ", ".join(
            f"{k} {v['device_seconds']:.6f} s" for k, v in
            px["view"].items()))
    del p, px
    kept["outs"] = None
    # (d) a hang and a cancel, the collector off
    hang = aborted_reads(torch, work, l16_path, L16_COLUMNS, smi)
    wall = time.perf_counter() - t_phase
    log(f"obs summary ({smi}): lineitem16 SF1 rows/s plain "
        + ", ".join(f"{v:.1f}" for v in rates["plain"]) + ", every option "
        "on " + ", ".join(f"{v:.1f}" for v in rates["obs"])
        + f"; hang raised in {hang['took']:.3f} s; phase 15 launches "
        f"{launched}; phase 15 wall {wall:.2f} s")
    return dict(launched=launched, rates=rates, lane=kept["view"],
                device=kept["tree"]["device"], kernel_times=tpq,
                xprof_times=xk, hang=hang, wall=wall)


# ---------------------------------------------------------------------------
# phase 16: training input on the card
# ---------------------------------------------------------------------------

# bench.py bench_loader's configuration: lineitem16 SF1 in training-shaped
# row groups, its 11 fixed-width columns, 8,192-row shuffled batches
LOADER_GROUP = 250_000
LOADER_COLUMNS = ["l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
                  "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                  "l_shipdate", "l_commitdate", "l_receiptdate"]
LOADER_BATCH = 8192
LOADER_SEED = 11
LOADER_WINDOW = 1 << 16
LOADER_SHARDS = 4
RESTORE_CUT = 300  # 16(b): batches taken before the state blob
PAR_PAGES = 64  # 16(e): pages per batch, of pyarrow's 20,000 rows each
PAR_PAGE_ROWS = 20_000
SUPP_DICT_ROWS = 10_000  # l_suppkey's keys index a 10,000-row dictionary


def dense_values(col):
    """A flat device column's values (a dictionary column gathered)."""
    from tpu_parquet_torch.device_reader import DeviceDictColumn

    if isinstance(col, DeviceDictColumn):
        col = col.materialize()
    return col.values[:col.num_values]


def loader_kw(**kw) -> dict:
    base = dict(columns=LOADER_COLUMNS, shuffle=True, seed=LOADER_SEED,
                shuffle_window=LOADER_WINDOW, drop_remainder=True)
    base.update(kw)
    return base


def word_view(torch, t):
    """The tensor's bits as int64 or int32 words (floats compare by bits)."""
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def batch_sums(torch, batch):
    """A per-batch checksum on the batch's device: the columns' 32-bit
    words laid end to end, their sum and their index-weighted sum (int64,
    wrapping); a handful of launches per batch."""
    w = torch.cat([batch[c].reshape(-1).view(torch.int32)
                   for c in LOADER_COLUMNS]).to(torch.int64)
    idx = torch.arange(1, w.numel() + 1, dtype=torch.int64, device=w.device)
    return torch.stack([w.sum(), (w * idx).sum()])


def same_batch(torch, got: dict, want: dict, label: str, i: int) -> None:
    """A device batch against a host batch, bit for bit."""
    import numpy as np

    if set(got) != set(want):
        raise fail(f"{label}: batch {i} keys {sorted(got)} != "
                   f"{sorted(want)}")
    for c, h in want.items():
        d = got[c].cpu().numpy()
        if (d.dtype != h.dtype or d.shape != h.shape
                or not np.array_equal(d.view(np.uint8), h.view(np.uint8))):
            raise fail(f"{label}: batch {i} column {c} differs from the "
                       f"host epoch")


def loader_epoch(torch, paths, device, prefetch: int) -> dict:
    """One shuffled epoch with ``to_device=True``, timed from the first
    ``next`` to a synchronize after the last batch; each batch's checksum
    is taken on the card as it arrives."""
    from tpu_parquet_torch.data import DataLoader

    loader = DataLoader(paths, LOADER_BATCH, **loader_kw(
        prefetch=prefetch, to_device=True, device=device))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    sums, rows = [], 0
    t0 = time.perf_counter()
    for batch in loader:
        sums.append(batch_sums(torch, batch))
        rows += len(batch["l_orderkey"])
    del batch
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return dict(sums=torch.stack(sums), seconds=seconds, rows=rows,
                peak=torch.cuda.max_memory_allocated() - before,
                stats=loader.stats().as_dict(),
                registry=loader.obs_registry().as_dict())


def loader_depths(torch, paths, device, smi: str) -> dict:
    """16(a): an untimed epoch checked batch by batch against a
    ``to_device=False`` epoch, then prefetch 0 and 4 in turns, two passes
    each, each bit-equal to it by the per-batch checksums; then
    ``scan_files`` over the same columns for ``loader_vs_scan``."""
    import itertools

    from tpu_parquet_torch.data import DataLoader
    from tpu_parquet_torch.device_reader import scan_files

    label = "loader (a)"
    dev = DataLoader(paths, LOADER_BATCH, **loader_kw(
        prefetch=2, to_device=True, device=device))
    host = DataLoader(paths, LOADER_BATCH, **loader_kw(prefetch=2))
    want, n = [], 0
    t0 = time.perf_counter()
    for d, h in itertools.zip_longest(dev, host):
        if d is None or h is None:
            raise fail(f"{label}: the device and host epochs differ in "
                       f"length at batch {n}")
        same_batch(torch, d, h, label, n)
        want.append(batch_sums(torch, d))
        n += 1
    del d, h
    want = torch.stack(want)
    log(f"{label}: untimed epoch of {n} batches x {LOADER_BATCH} rows on "
        f"the card bit-equal to a to_device=False epoch, batch by batch "
        f"({time.perf_counter() - t0:.2f} s with the comparison)")
    runs = {0: [], 4: []}
    for k in (0, 4, 0, 4):
        r = loader_epoch(torch, paths, device, k)
        if r["sums"].shape != want.shape or not torch.equal(r["sums"], want):
            raise fail(f"{label}: prefetch {k} epoch's checksums differ "
                       f"from the untimed epoch's")
        r["sums"] = None
        runs[k].append(r)
        log(f"{label}: prefetch {k}: {r['rows'] / r['seconds']:.1f} rows/s "
            f"({r['rows']} rows in {r['seconds']:.4f} s), "
            f"decode_wait_seconds {r['stats']['decode_wait_seconds']}, "
            f"window_peak_rows {r['stats']['window_peak_rows']}, "
            f"max_memory_allocated +{r['peak']} bytes ({smi})")
    scans = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = list(scan_files(paths, columns=LOADER_COLUMNS,
                               device=device))
        torch.cuda.synchronize()
        scans.append(time.perf_counter() - t0)
        del outs
    rows = runs[4][0]["rows"]
    total = SF1_ROWS
    med = {k: sorted(r["seconds"] for r in v)[len(v) // 2]
           for k, v in runs.items()}
    scan_s = sorted(scans)[len(scans) // 2]
    out = dict(batches=n, runs=runs, rows=rows, scan_s=scans,
               rates={k: [r["rows"] / r["seconds"] for r in v]
                      for k, v in runs.items()},
               loader_vs_scan=(rows / med[4]) / (total / scan_s),
               loader_speedup=med[0] / med[4])
    log(f"{label}: scan_files over the same columns "
        + ", ".join(f"{total / s:.1f}" for s in scans)
        + f" rows/s; loader_vs_scan {out['loader_vs_scan']:.4f} "
        f"(median prefetch-4 rows/s over median scan_files rows/s, as "
        f"bench.py computes it); loader_speedup p0/p4 "
        f"{out['loader_speedup']:.4f} ({smi})")
    return out


def loader_restore(torch, paths, device, spool: str) -> dict:
    """16(b): a state blob after RESTORE_CUT batches at prefetch 0,
    restored into a fresh loader at prefetch 4 (publishing to the fleet
    spool): the first batches plus the rest equal the uninterrupted epoch
    (a host epoch), batch by batch."""
    from tpu_parquet_torch.data import DataLoader

    label = "loader (b)"
    host = iter(DataLoader(paths, LOADER_BATCH, **loader_kw(prefetch=4)))
    cut = DataLoader(paths, LOADER_BATCH, **loader_kw(
        prefetch=0, to_device=True, device=device))
    it = iter(cut)
    n = 0
    for batch in it:
        same_batch(torch, batch, next(host), label, n)
        n += 1
        if n == RESTORE_CUT:
            it.close()
            break
    blob = cut.state_blob()
    resumed = DataLoader(paths, LOADER_BATCH, **loader_kw(
        prefetch=4, to_device=True, device=device)).restore(blob)
    os.environ["TPQ_OBS_SPOOL"] = spool
    try:
        for batch in resumed:
            same_batch(torch, batch, next(host), label, n)
            n += 1
    finally:
        os.environ.pop("TPQ_OBS_SPOOL", None)
    if next(host, None) is not None:
        raise fail(f"{label}: the resumed loader ended early at batch {n}")
    log(f"{label}: state_blob() after {RESTORE_CUT} batches at prefetch 0 "
        f"({len(blob)} bytes), restored at prefetch 4: {RESTORE_CUT} + "
        f"{n - RESTORE_CUT} batches equal the uninterrupted epoch")
    return dict(batches=n, blob=len(blob), stats=resumed.stats().as_dict(),
                registry=resumed.obs_registry().as_dict())


def loader_shards(torch, paths, device, keys) -> None:
    """16(c): shards (i, 4) in one process partition the rows exactly
    (``l_orderkey`` is strictly increasing, so its keys name the rows)."""
    from tpu_parquet_torch.data import DataLoader

    parts, sizes = [], []
    for i in range(LOADER_SHARDS):
        loader = DataLoader(paths, LOADER_BATCH, **loader_kw(
            shard=(i, LOADER_SHARDS), drop_remainder=False, prefetch=4,
            to_device=True, device=device))
        mine = [b["l_orderkey"][b["mask"]] for b in loader]
        sizes.append(sum(len(m) for m in mine))
        parts += mine
    got = torch.sort(torch.cat(parts)).values
    want = torch.from_numpy(keys).to(got.device)
    if got.shape != want.shape or not torch.equal(got, want):
        raise fail(f"loader (c): the {LOADER_SHARDS} shards' rows "
                   f"({sizes}) do not partition the file's "
                   f"{len(keys)} rows")
    log(f"loader (c): shards (i, {LOADER_SHARDS}) hold {sizes} rows, their "
        f"union is every row exactly once")


def loader_vs_reader(torch, ck, path: str, device) -> dict:
    """16(d): unshuffled, the loader's batches equal
    ``DeviceFileReader.iter_batches``'s over the same columns; the launch
    counters' rise on the pass is the reader's (``loader_launches``), the
    loader's own ``next`` calls launch nothing."""
    from tpu_parquet_torch.data import DataLoader
    from tpu_parquet_torch.device_reader import DeviceFileReader

    label = "loader (d)"
    loader = iter(DataLoader([path], LOADER_BATCH, **loader_kw(
        shuffle=False, prefetch=4, to_device=True, device=device)))
    own = {k: 0 for k in ck.launches}
    n = 0
    with DeviceFileReader(path, columns=LOADER_COLUMNS, device=device) as r:
        ck.reset_launches()
        for want in r.iter_batches(LOADER_BATCH, columns=LOADER_COLUMNS):
            before = dict(ck.launches)
            got = next(loader, None)
            for k, v in ck.launches.items():
                own[k] += v - before[k]
            if got is None or set(got) != set(want):
                raise fail(f"{label}: batch {n} missing or with other "
                           f"columns")
            for c in LOADER_COLUMNS:
                a, b = word_view(torch, got[c]), word_view(torch, want[c])
                if a.dtype != b.dtype or not torch.equal(a, b):
                    raise fail(f"{label}: batch {n} column {c} differs "
                               f"from iter_batches")
            n += 1
        counts = dict(ck.launches)
    if next(loader, None) is not None:
        raise fail(f"{label}: the loader yields more batches than "
                   f"iter_batches ({n})")
    if any(own.values()):
        raise fail(f"{label}: the loader itself launched {own}")
    counts = {k: v - own[k] for k, v in counts.items()}
    for kname in ("hybrid_unpack_combine", "fused_plain_words"):
        if not counts[kname]:
            raise fail(f"{label}: iter_batches never launched {kname}")
    log(f"{label}: unshuffled loader == DeviceFileReader.iter_batches("
        f"{LOADER_BATCH}) over {n} batches, bit for bit; loader_launches "
        f"(the reader's pass) {counts}; the loader itself launches no "
        f"hand-written kernel (it decodes on the host FileReader and "
        f"ships each batch with one copy per column), as the reference's")
    return counts


def parallel_nccl(torch, work: str, path: str, draws, device, backend,
                  smi: str) -> None:
    """16(e): ``parallel`` on a world of one over ``backend`` (NCCL on the
    card), each sharded decode held against the port's plain CPU decode of
    the same pages and against the generator."""
    import datetime

    import numpy as np
    import torch.distributed as dist

    from tpu_parquet_torch import parallel as par
    from tpu_parquet_torch import torch_kernels as K
    from tpu_parquet_torch.kernels import delta as delta_host
    from tpu_parquet_torch.kernels import rle as rle_host
    from tpu_parquet_torch.reader import FileReader

    label = "parallel (e)"
    n = PAR_PAGES * PAR_PAGE_ROWS
    cols = {c: np.concatenate([g[c] for g in draws])[:n]
            for c in ("l_suppkey", "l_orderkey", "l_extendedprice")}
    pages = {c: v.reshape(PAR_PAGES, PAR_PAGE_ROWS) for c, v in cols.items()}
    width = int(SUPP_DICT_ROWS - 1).bit_length()
    dictionary = np.arange(SUPP_DICT_ROWS, dtype=np.int64)
    t0 = time.perf_counter()
    hyb = par.pack_hybrid_pages(
        [rle_host.encode(p.astype(np.uint64), width)
         for p in pages["l_suppkey"]], width, PAR_PAGE_ROWS)
    dlt = par.pack_delta_pages(
        [delta_host.encode(p, bits=64) for p in pages["l_orderkey"]], 64,
        PAR_PAGE_ROWS)
    plain = np.zeros((PAR_PAGES, par._bucket(PAR_PAGE_ROWS * 8 + par._SLACK,
                                             64)), np.uint8)
    for i, p in enumerate(pages["l_extendedprice"]):
        plain[i, :PAR_PAGE_ROWS * 8] = p.view(np.uint8)
    plain = torch.from_numpy(plain)
    dict_u8 = torch.from_numpy(dictionary.view(np.uint8).reshape(-1, 8))
    pack_s = time.perf_counter() - t0
    rdv = os.path.join(work, "nccl_rendezvous")
    if os.path.exists(rdv):
        os.remove(rdv)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    dist.init_process_group(backend, init_method=f"file://{rdv}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = par.make_mesh(device)
        # the communicator is built at the first collective: time it apart
        warm = torch.zeros(1, dtype=torch.int64, device=device)
        dist.all_reduce(warm, group=mesh.get_group("data"))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vals, stats = par.sharded_dict_decode(hyb, dict_u8, "int64", mesh,
                                              with_stats=True)
        keys = par.sharded_delta_decode(dlt, 64, mesh)
        price = par.sharded_plain_decode(plain, "float64", PAR_PAGE_ROWS,
                                         mesh)
        kstats = par.column_stats(keys, mesh)
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t0
        # the plain CPU decode of the same pages
        idx = torch.stack([K.expand_rle_hybrid(b, e, r, v, s, width,
                                               PAR_PAGE_ROWS)
                           for b, e, r, v, s in zip(
                               hyb.bufs, hyb.run_ends, hyb.run_is_rle,
                               hyb.run_values, hyb.run_bit_starts)])
        cpu = {
            "l_suppkey": K.dict_gather_bytes(dict_u8, idx.reshape(-1),
                                             "int64").reshape(idx.shape),
            "l_orderkey": K.delta_reconstruct(
                dlt.bufs.reshape(-1), dlt.first_values,
                dlt.mini_bit_starts + (torch.arange(PAR_PAGES)
                                       * dlt.bufs.shape[1] * 8)[:, None],
                dlt.mini_widths, dlt.mini_min_delta, dlt.values_per_mini,
                PAR_PAGE_ROWS, 64, dlt.max_width),
            "l_extendedprice": torch.stack([
                K.plain_decode_fixed(b, "float64", PAR_PAGE_ROWS)
                for b in plain]),
        }
        got = {"l_suppkey": vals, "l_orderkey": keys,
               "l_extendedprice": price}
        for c, t in got.items():
            full = t.full_tensor()
            if full.device.type != torch.device(device).type:
                raise fail(f"{label}: {c} decoded on {full.device}")
            host = full.cpu()
            if not torch.equal(word_view(torch, host),
                               word_view(torch, cpu[c])):
                raise fail(f"{label}: {c} differs from its plain CPU "
                           f"decode")
            if not np.array_equal(host.numpy().view(np.uint8),
                                  pages[c].view(np.uint8)):
                raise fail(f"{label}: {c} differs from the generator")
        want_st = [n, int(cols["l_suppkey"].min()),
                   int(cols["l_suppkey"].max())]
        if stats.cpu().tolist() != want_st:
            raise fail(f"{label}: dictionary stats {stats.tolist()} != "
                       f"{want_st}")
        want_k = [n, int(cols["l_orderkey"].min()),
                  int(cols["l_orderkey"].max())]
        if kstats.cpu().tolist() != want_k:
            raise fail(f"{label}: column_stats {kstats.tolist()} != "
                       f"{want_k}")
        # the multi-host form against the device reader's column
        from tpu_parquet_torch.device_reader import DeviceFileReader

        t0 = time.perf_counter()
        with FileReader(path) as r:
            col, valid = par.process_local_column(r, "l_orderkey", mesh,
                                                  prefetch=4)
        local_s = time.perf_counter() - t0
        with DeviceFileReader(path, columns=["l_orderkey"],
                              device=device) as r:
            want = torch.cat([dense_values(g["l_orderkey"])
                              for g in r.iter_row_groups()])
        full = col.full_tensor()
        if valid != SF1_ROWS or not torch.equal(full, want):
            raise fail(f"{label}: process_local_column(l_orderkey) differs "
                       f"from the DeviceFileReader column")
        log(f"{label}: {backend} world of 1, mesh {mesh}: "
            f"sharded_dict_decode(with_stats) on {PAR_PAGES} l_suppkey "
            f"pages of {PAR_PAGE_ROWS} (width {width}, {SUPP_DICT_ROWS}-row "
            f"int64 dictionary), sharded_delta_decode of l_orderkey, "
            f"sharded_plain_decode of l_extendedprice and column_stats in "
            f"{dec_s:.4f} s (packing {pack_s:.2f} s on the host, the group "
            f"and its communicator {setup_s:.2f} s), each "
            f"equal to its plain CPU decode and the generator; stats "
            f"{want_st}, {want_k}; process_local_column(l_orderkey) == the "
            f"DeviceFileReader column ({valid} rows, {local_s:.2f} s) "
            f"({smi})")
        log(f"{label}: a world larger than one needs more cards than this "
            f"machine has; worlds of 4 (1-D and 2x2) run on gloo in "
            f"tests/test_torch_parallel.py")
    finally:
        dist.destroy_process_group()


def fleet_check(spool: str, restore: dict) -> None:
    """16(f), first half: the resumed loader's spool member, seen by
    ``FleetAggregator`` as a live ``loader`` with its lanes."""
    from tpu_parquet_torch.obs import fleet_host
    from tpu_parquet_torch.obs_fleet import FleetAggregator, process_lanes

    label = "fleet (f)"
    snap = FleetAggregator(spool_dir=spool).scan()
    key = f"{fleet_host()}:{os.getpid()}"
    proc = snap["processes"].get(key)
    if proc is None or proc["role"] != "loader" or proc["stale"]:
        raise fail(f"{label}: the aggregator does not see {key} as a live "
                   f"loader: " + ", ".join(
                       f"{k} role {p['role']} stale {p['stale']} age "
                       f"{p['heartbeat_age_s']} s"
                       for k, p in snap["processes"].items()))
    lanes = process_lanes(proc["registry"])
    if not lanes["host_decompress"] > 0:
        raise fail(f"{label}: the loader's lanes are empty: {lanes}")
    if snap["registry"]["loader"]["batches"] != (
            restore["batches"] - RESTORE_CUT):
        raise fail(f"{label}: the spool's loader batches "
                   f"{snap['registry']['loader']['batches']} != the resumed "
                   f"loader's {restore['batches'] - RESTORE_CUT}")
    log(f"{label}: {snap['files_scanned']} spool file(s), process {key} "
        f"role {proc['role']}, heartbeat {proc['heartbeat_age_s']} s old, "
        f"lanes " + ", ".join(f"{k} {v:.6f}" for k, v in lanes.items() if v))


def ledger_record(work: str, depth: dict, smi: str) -> None:
    """16(f), second half: a ledger record of phase 16's numbers,
    fingerprinted ``kernel_mode == "cuda"``, checked against itself."""
    from tpu_parquet_torch import ledger

    label = "ledger (f)"
    runs = depth["runs"]
    cfg = {
        "rows": depth["rows"],
        "prefetch0_rows_per_sec": depth["rates"][0][-1],
        "prefetch4_rows_per_sec": depth["rates"][4][-1],
        "prefetch0_reps_s": [r["seconds"] for r in runs[0]],
        "prefetch4_reps_s": [r["seconds"] for r in runs[4]],
        "loader_speedup": depth["loader_speedup"],
        "scan_files_rows_per_sec": SF1_ROWS / min(depth["scan_s"]),
        "scan_files_reps_s": depth["scan_s"],
        "loader_vs_scan": depth["loader_vs_scan"],
        "obs": runs[4][-1]["registry"],
    }
    path = os.path.join(work, "ledger.jsonl")
    if os.path.exists(path):
        os.remove(path)
    rec = ledger.make_record({
        "metric": "loader_prefetch4_rows_per_sec",
        "value": cfg["prefetch4_rows_per_sec"], "unit": "rows/s",
        "vs_baseline": None, "device": smi, "configs": {"loader": cfg}})
    ledger.append(path, rec)
    back = ledger.load_side(path)
    env = back["env"]
    if env.get("kernel_mode") != "cuda" or not env.get("kernel_device"):
        raise fail(f"{label}: the ledger fingerprint says kernel_mode "
                   f"{env.get('kernel_mode')!r}")
    regressions = ledger.check(back, back)
    if regressions:
        raise fail(f"{label}: check() of the record against itself: "
                   f"{regressions}")
    d = ledger.diff(back, back)
    log(f"{label}: ledger record appended to {path}: kernel_mode "
        f"{env['kernel_mode']} on {env['kernel_device']}; check() against "
        f"itself finds no regression ({d['compared']} metrics compared)")


def read_loader_phase(torch, ck, work: str, smi: str, device="cuda",
                      backend="nccl") -> dict:
    """Phase 16: training input on the card (lineitem16 SF1 in
    250,000-row groups, ``bench.py`` ``bench_loader``'s configuration)."""
    import gc

    import numpy as np

    t_phase = time.perf_counter()
    freed = collected_bytes(torch)
    before = torch.cuda.memory_allocated()
    draws = list(draw_lineitem16(SF1_ROWS, LOADER_GROUP))
    path = os.path.join(work, "lineitem16_sf1_rg250k.parquet")
    secs = write_lineitem16(path, [lineitem_strings(g) for g in draws])
    log(f"loader: wrote {path}: {SF1_ROWS} rows x {len(L16_COLUMNS)} "
        f"columns, {len(draws)} row groups of {LOADER_GROUP}, "
        f"{os.path.getsize(path)} bytes in {secs:.2f} s; batch "
        f"{LOADER_BATCH}, seed {LOADER_SEED}, shuffle_window "
        f"{LOADER_WINDOW}, drop_remainder, {len(LOADER_COLUMNS)} columns; "
        f"{freed} bytes on the card freed by a garbage collection at the "
        f"phase's start ({smi})")
    spool = os.path.join(work, "obs_spool")
    shutil.rmtree(spool, ignore_errors=True)
    depth = loader_depths(torch, [path], device, smi)
    restore = loader_restore(torch, [path], device, spool)
    fleet_check(spool, restore)
    keys = np.concatenate([g["l_orderkey"] for g in draws])
    loader_shards(torch, [path], device, keys)
    del keys
    launches = loader_vs_reader(torch, ck, path, device)
    parallel_nccl(torch, work, path, draws, device, backend, smi)
    del draws
    ledger_record(work, depth, smi)
    threads = [t for t in tpq_threads() if t.startswith(
        ("tpq-prefetch", "tpq-sampler", "tpq-watchdog", "tpq-spool"))]
    if threads:
        raise fail(f"phase 16: threads still alive after it: {threads}")
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    if left:
        raise fail(f"phase 16: {left} bytes still allocated after it")
    wall = time.perf_counter() - t_phase
    log(f"loader summary ({smi}): lineitem16 SF1 loader rows/s prefetch 0 "
        + ", ".join(f"{v:.1f}" for v in depth["rates"][0]) + ", prefetch 4 "
        + ", ".join(f"{v:.1f}" for v in depth["rates"][4])
        + f"; decode_wait_seconds p0 "
        + ", ".join(f"{r['stats']['decode_wait_seconds']}"
                    for r in depth["runs"][0]) + ", p4 "
        + ", ".join(f"{r['stats']['decode_wait_seconds']}"
                    for r in depth["runs"][4])
        + f"; max_memory_allocated p0 "
        + ", ".join(f"+{r['peak']}" for r in depth["runs"][0]) + ", p4 "
        + ", ".join(f"+{r['peak']}" for r in depth["runs"][4])
        + f" bytes; loader_vs_scan {depth['loader_vs_scan']:.4f}; "
        f"loader_launches {launches}; 0 bytes left, no loader thread "
        f"alive; phase 16 wall {wall:.2f} s")
    return dict(loader_launches=launches, depth=depth, wall=wall)


# ---------------------------------------------------------------------------
# phase 17: the serve tier on the card
# ---------------------------------------------------------------------------

# bench.py bench_serve's sweep: client threads on one ScanService of
# min(clients, 8) workers, projections rotating over all 16 columns, the
# first 8 and the first 1; at least SERVE_MIN_REQUESTS requests per count
SERVE_CLIENTS = (1, 4, 16)
SERVE_MIN_REQUESTS = 12
# bench.py bench_serve_tenants' shape, cut to one round: 20 ms per range,
# one worker, victim weight 3 against noisy weight 1
SERVE_LATENCY_S = 0.020
SERVE_NOISY = 12
SERVE_VICTIM = 4
SERVE_HANG_S = 2.0  # 17(f)'s watchdog deadline
STREAM_CUT = 300  # 17(e): batches taken before the cursor
STREAM_DEADLINE_S = 0.5  # 17(e): the deadline that ends a stream


def serve_projections() -> list:
    return [L16_COLUMNS, L16_COLUMNS[:8], L16_COLUMNS[:1]]


def same_response(torch, res: dict, path: str, base, label: str) -> None:
    """A device response's columns (``{path: {column: column | [one per
    row group]}}``) against an uncached read's groups, every tensor bit for
    bit on the card."""
    cols = res[path]
    if list(cols) != list(base[0]):
        raise fail(f"{label}: columns {list(cols)}, want {list(base[0])}")
    parts = {n: (v if isinstance(v, list) else [v]) for n, v in cols.items()}
    groups = [{n: p[i] for n, p in parts.items()}
              for i in range(len(next(iter(parts.values()))))]
    same_on_card(torch, groups, base, label)


def latency_ms(walls: list) -> dict:
    """Nearest-rank p50, p95 and p99 of the clients' request walls (the
    service's ``serve.request`` histogram holds bucket edges only)."""
    s = sorted(walls)
    return {q: s[min(int(v * len(s)), len(s) - 1)] * 1e3
            for q, v in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))}


def closed_clean(svc, label: str) -> None:
    """After ``close()``: no worker alive and nothing charged."""
    import threading

    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("tpq-serve")]
    held = svc._budget.held + sum(t.budget.held for t in
                                  svc.tenants.tenants().values())
    if alive or held:
        raise fail(f"{label}: after close(), workers {alive}, {held} "
                   f"budget bytes held")


def serve_sweep(torch, ck, path: str, bases: dict, single_s: float,
                smi: str, launched: dict) -> dict:
    """17(a): 1, 4 and 16 clients on one service, device requests."""
    import threading

    from tpu_parquet_torch.serve import ScanRequest, ScanService

    projections = serve_projections()
    out = {}
    for clients in SERVE_CLIENTS:
        label = f"serve (a) {clients} client(s)"
        q = -(-SERVE_MIN_REQUESTS // clients)
        svc = ScanService(concurrency=min(clients, 8),
                          queue_depth=max(2 * clients, 4))
        got, errors, walls = [], [], []

        def client(ci, svc=svc, got=got, errors=errors, walls=walls, q=q):
            try:
                for i in range(q):
                    pi = (ci + i) % len(projections)
                    t0 = time.perf_counter()
                    res = svc.scan(ScanRequest(path,
                                               columns=projections[pi],
                                               device=True), timeout=600)
                    walls.append(time.perf_counter() - t0)
                    got.append((pi, ci, i, res))
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(detached(e))

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(clients)]
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ck.launches)
        tree = svc.obs_registry().as_dict()
        svc.close()
        closed_clean(svc, label)
        if errors:
            raise fail(f"{label}: {errors[0]!r}")
        for pi, ci, i, res in got:
            same_response(torch, res, path, bases[pi]["outs"],
                          f"{label}, client {ci} request {i}")
        n = len(got)
        del got, res
        add_launches(launched, counts)
        want = {}
        for pi in [(ci + i) % len(projections) for ci in range(clients)
                   for i in range(q)]:
            add_launches(want, bases[pi]["counts"])
        for kname in ("hybrid_unpack_combine", "fused_plain_words"):
            if not counts.get(kname):
                raise fail(f"{label}: {kname} never launched")
        sv = tree["serve"]
        cache = sv["cache"]
        hits = sum(cache[f"{k}_hits"] for k in ("footer", "plan", "dict"))
        total = hits + sum(cache[f"{k}_misses"]
                           for k in ("footer", "plan", "dict"))
        plan_rate = cache["plan_hits"] / max(cache["plan_hits"]
                                             + cache["plan_misses"], 1)
        rows = sv["rows"]
        lat = latency_ms(walls)
        out[clients] = dict(requests=n, wall=wall, rows=rows,
                            rows_per_s=rows / wall, lat=lat,
                            queue_wait=sv["queue_wait_seconds"],
                            plan_hit_rate=plan_rate,
                            hit_rate=hits / max(total, 1), counts=counts)
        log(f"{label}: {n} device requests ({q} per client), every "
            f"response bit-equal to the uncached read of its columns; "
            f"{rows} rows served in {wall:.4f} s = "
            f"{rows / wall:.1f} rows/s (one uncached 16-column read "
            f"{SF1_ROWS / single_s:.1f}); request walls p50 "
            f"{lat['p50']:.3f} "
            f"ms, p95 {lat['p95']:.3f} ms, p99 {lat['p99']:.3f} ms; "
            f"queue_wait_seconds {sv['queue_wait_seconds']}, exec_seconds "
            f"{sv['exec_seconds']}; plan cache hit rate {plan_rate:.4f} "
            f"(footer+plan+dict {hits / max(total, 1):.4f}); launches "
            f"{counts} (the same requests read uncached: {want}) ({smi})")
    return out


def serve_k3(torch, ck, path: str, base: dict, want_k3: int, smi: str,
             launched: dict) -> dict:
    """17(b): one device request over the K3 file: exact, K3 launched as
    in phase 5."""
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    label = "serve (b) K3 file"
    with ScanService(concurrency=1) as svc:
        torch.cuda.synchronize()
        ck.reset_launches()
        t0 = time.perf_counter()
        res = svc.scan(ScanRequest(path, columns=K3_COLUMNS, device=True),
                       timeout=600)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = dict(ck.launches)
    closed_clean(svc, label)
    same_response(torch, res, path, base["outs"], label)
    del res
    add_launches(launched, counts)
    if counts != base["counts"] or counts["fused_narrow_words"] != want_k3:
        raise fail(f"{label}: launches {counts}, want the uncached read's "
                   f"{base['counts']} ({want_k3} K3)")
    log(f"{label}: bit-equal to the uncached read, launches {counts} "
        f"(K3 {want_k3}, as phase 5); {K3_ROWS / secs:.1f} rows/s "
        f"(uncached read {K3_ROWS / base['seconds']:.1f}) ({smi})")
    return dict(counts=counts, rows_per_s=K3_ROWS / secs)


def serve_cached(torch, ck, path: str, base: dict, smi: str,
                 launched: dict) -> dict:
    """17(c): a 2 GiB device tier: a second identical device request is
    exact, reads nothing and launches nothing."""
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    label = "serve (c) result cache"
    reads = [0]
    svc = ScanService(concurrency=1, result_cache_mb=0,
                      result_cache_hbm_mb=CACHE_HBM_MB,
                      store=counting_local_factory(reads))
    times, counts = [], []
    try:
        for i in range(2):
            before = reads[0]
            torch.cuda.synchronize()
            ck.reset_launches()
            t0 = time.perf_counter()
            res = svc.scan(ScanRequest(path, columns=L16_COLUMNS,
                                       device=True), timeout=600)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts.append(dict(ck.launches))
            same_response(torch, res, path, base["outs"],
                          f"{label} request {i + 1}")
            del res
            if i == 0:
                cold_reads = reads[0] - before
            elif reads[0] != before or any(counts[1].values()):
                raise fail(f"{label}: the warm request read "
                           f"{reads[0] - before} ranges, launched "
                           f"{counts[1]}")
        dev = svc.cache.results.counters()["device"]
    finally:
        svc.close()
    closed_clean(svc, label)
    add_launches(launched, counts[0])
    if counts[0] != base["counts"]:
        raise fail(f"{label}: cold launches {counts[0]}, want "
                   f"{base['counts']}")
    log(f"{label}: cold request {times[0] * 1e3:.3f} ms ({cold_reads} store "
        f"reads, launches as the uncached read), warm request "
        f"{times[1] * 1e3:.3f} ms: 0 store reads, 0 launches, bit-equal; "
        f"device tier {dev['entries']} chunks, {dev['held_bytes']} bytes, "
        f"{dev['hits']} hits ({smi})")
    return dict(cold_ms=times[0] * 1e3, warm_ms=times[1] * 1e3)


def serve_tenants(torch, ck, path: str, smi: str, launched: dict) -> dict:
    """17(d): a victim (weight 3) under a noisy tenant's flood (weight 1),
    one worker, 20 ms per range: isolated, FIFO and fair."""
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    col = [L16_COLUMNS[0]]
    out = {}
    for phase, fair in (("isolated", True), ("fifo", False), ("fair", True)):
        svc = ScanService(
            concurrency=1, queue_depth=4 * (SERVE_NOISY + SERVE_VICTIM),
            fair=fair, result_cache_mb=0,
            store=lambda f: FaultInjectingStore(
                LocalStore(f), FaultSpec(latency_s=SERVE_LATENCY_S),
                config=IOConfig(backoff_ms=1.0)))
        svc.register_tenant("victim", weight=3)
        svc.register_tenant("noisy", weight=1)
        try:
            ck.reset_launches()
            noisy = ([svc.submit(ScanRequest(path, columns=col, device=True,
                                             tenant="noisy"))
                      for _ in range(SERVE_NOISY)]
                     if phase != "isolated" else [])
            walls = []
            for _ in range(SERVE_VICTIM):
                t0 = time.perf_counter()
                svc.scan(ScanRequest(path, columns=col, device=True,
                                     tenant="victim"), timeout=600)
                walls.append(time.perf_counter() - t0)
            for t in noisy:
                t.result(600)
            del noisy
            add_launches(launched, dict(ck.launches))
            st = svc.serve_stats()["tenants"]
        finally:
            svc.close()
        closed_clean(svc, f"serve (d) {phase}")
        out[phase] = dict(p99_ms=max(walls) * 1e3,
                          p50_ms=sorted(walls)[len(walls) // 2] * 1e3,
                          victim=st["victim"]["submitted"],
                          noisy=st.get("noisy", {}).get("submitted", 0))
    stop_engine("serve (d)")
    if not out["fair"]["p99_ms"] < out["fifo"]["p99_ms"]:
        raise fail(f"serve (d): victim p99 fair {out['fair']['p99_ms']:.3f}"
                   f" ms not under FIFO {out['fifo']['p99_ms']:.3f} ms")
    log("serve (d) tenants, " + f"{SERVE_NOISY} noisy and {SERVE_VICTIM} "
        f"victim device requests of {col[0]}, one worker, "
        f"{SERVE_LATENCY_S * 1e3:.0f} ms per range: victim p99 "
        + ", ".join(f"{k} {v['p99_ms']:.3f} ms (p50 {v['p50_ms']:.3f})"
                    for k, v in out.items())
        + f"; fair/FIFO {out['fair']['p99_ms'] / out['fifo']['p99_ms']:.4f}"
        f" ({smi})")
    return out


def stream_batches(torch, svc, path: str, **req) -> list:
    from tpu_parquet_torch.serve import ScanRequest

    return svc.scan(ScanRequest(path, columns=LOADER_COLUMNS, stream=True,
                                device=True, batch_rows=LOADER_BATCH,
                                **req), timeout=600)


def same_stream_batch(torch, got: dict, want: dict, label: str) -> None:
    if set(got) != set(LOADER_COLUMNS) | {"mask"}:
        raise fail(f"{label}: batch keys {sorted(got)}")
    if not bool(got["mask"].all()):
        raise fail(f"{label}: a full batch has masked rows")
    for c in LOADER_COLUMNS:
        a, b = word_view(torch, got[c]), word_view(torch, want[c])
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise fail(f"{label}: column {c} differs from iter_batches")


def serve_stream(torch, path: str, loader_rate: float, smi: str) -> dict:
    """17(e): a device stream over the 11 fixed-width columns of phase 16's
    25-group file against ``iter_batches``, a cursor resumed, a deadline
    and a cancel."""
    import numpy as np

    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.errors import (CancelledError,
                                          DeadlineExceededError)
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    label = "serve (e) device stream"
    with DeviceFileReader(path, columns=LOADER_COLUMNS) as r:
        want = list(r.iter_batches(LOADER_BATCH, columns=LOADER_COLUMNS))
        n_groups = len(r.metadata.row_groups)
    rem = SF1_ROWS - len(want) * LOADER_BATCH
    with FileReader(path, columns=LOADER_COLUMNS) as h:
        tail = {c: np.concatenate([h.read_row_group(g)[c].values
                                   for g in (n_groups - 2, n_groups - 1)]
                                  )[-rem:] for c in LOADER_COLUMNS}
    svc = ScanService(concurrency=1)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(stream_batches(torch, svc, path))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if len(got) != len(want) + 1:
            raise fail(f"{label}: {len(got)} batches, want "
                       f"{len(want) + 1} ({len(want)} full and the tail)")
        for i, (g, w) in enumerate(zip(got, want)):
            if g["mask"].device.type != svc.device.type:
                raise fail(f"{label}: batch {i} on {g['mask'].device}")
            same_stream_batch(torch, g, w, f"{label} batch {i}")
        last = got[-1]
        if int(last["mask"].sum()) != rem or bool(last["mask"][rem:].any()):
            raise fail(f"{label}: the tail's mask does not hold its {rem} "
                       f"rows")
        for c in LOADER_COLUMNS:
            h = last[c][:rem].cpu().numpy()
            if not np.array_equal(h.view(np.uint8),
                                  np.ascontiguousarray(tail[c]).view(
                                      np.uint8)):
                raise fail(f"{label}: the tail's {c} differs from the file")
        del got, last
        # a cursor mid-stream, resumed in a new session
        s1 = stream_batches(torch, svc, path)
        for _ in range(STREAM_CUT):
            next(s1)
        blob = s1.cursor()
        s1.close()
        rest = list(stream_batches(torch, svc, path, cursor=blob))
        if len(rest) != len(want) + 1 - STREAM_CUT:
            raise fail(f"{label}: {len(rest)} batches after the cursor")
        for i, (g, w) in enumerate(zip(rest, want[STREAM_CUT:])):
            same_stream_batch(torch, g, w,
                              f"{label} resumed batch {STREAM_CUT + i}")
        del rest
        # a deadline and a cancel end the stream, typed
        verdicts = {}
        for kind in ("deadline", "cancel"):
            taken = 0
            try:
                s = stream_batches(torch, svc, path, **(
                    {"deadline_s": STREAM_DEADLINE_S}
                    if kind == "deadline" else {}))
                for _ in s:
                    taken += 1
                    if kind == "cancel" and taken == 3:
                        s.cancel()
                    elif kind == "deadline":
                        time.sleep(0.02)  # a consumer slower than the stream
                raise fail(f"{label}: the {kind} never ended the stream")
            except (DeadlineExceededError, CancelledError) as e:
                verdicts[kind] = (type(e).__name__, taken)
            s = None
        if (verdicts["deadline"][0] != "DeadlineExceededError"
                or verdicts["cancel"][0] != "CancelledError"):
            raise fail(f"{label}: verdicts {verdicts}")
        st = svc.serve_stats()
    finally:
        svc.close()
    closed_clean(svc, label)
    del want
    rate = SF1_ROWS / secs
    log(f"{label}: {SF1_ROWS} rows in "
        f"{secs:.4f} s = {rate:.1f} rows/s (phase 16's shuffled loader "
        f"{loader_rate:.1f}); every full batch equal to "
        f"iter_batches({LOADER_BATCH}), the padded tail's {rem} rows equal "
        f"to the file's; a cursor after {STREAM_CUT} batches resumed "
        f"bit-identically; deadline -> {verdicts['deadline'][0]} after "
        f"{verdicts['deadline'][1]} batches, cancel -> "
        f"{verdicts['cancel'][0]}; stream_sessions "
        f"{st['stream_sessions']}, stream_batches {st['stream_batches']} "
        f"({smi})")
    return dict(rows_per_s=rate, verdicts=verdicts)


def serve_faults(torch, work: str, l16_path: str, k3_path: str, bases: dict,
                 smi: str, launched: dict) -> dict:
    """17(f): a blacked-out file trips its breaker, brownout sheds low
    priority, a stalled store hangs one request alone."""
    from tpu_parquet_torch.errors import (CircuitOpenError, HangError,
                                          OverloadError,
                                          RetryExhaustedError)
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)
    from tpu_parquet_torch.resilience import BreakerBoard
    from tpu_parquet_torch.serve import (PRIORITY_HIGH, PRIORITY_LOW,
                                         ScanRequest, ScanService)

    one = serve_projections()[2]
    base = bases[2]["outs"]
    out = {}

    # the blackout: every read of the K3 file fails
    label = "serve (f) blackout"

    def blackout(f):
        victim = (os.path.abspath(getattr(f, "name", "") or "")
                  == os.path.abspath(k3_path))
        return FaultInjectingStore(
            LocalStore(f), FaultSpec(fail_first=1 << 30) if victim
            else FaultSpec(),
            config=IOConfig(retries=1, backoff_ms=0, retry_budget=8))

    board = BreakerBoard(fails=2, window_s=60, cooldown_s=60)
    with ScanService(concurrency=2, breakers=board, store=blackout) as svc:
        seen = []
        for _ in range(4):
            try:
                svc.scan(ScanRequest(k3_path, device=True), timeout=600)
                seen.append("ok")
            except (RetryExhaustedError, CircuitOpenError) as e:
                seen.append(type(detached(e)).__name__)
            res = svc.scan(ScanRequest(l16_path, columns=one, device=True),
                           timeout=600)
            same_response(torch, res, l16_path, base, f"{label} healthy")
            del res
        circ = svc.serve_stats()["circuit"]
    closed_clean(svc, label)
    if (seen != ["RetryExhaustedError"] * 2 + ["CircuitOpenError"] * 2
            or circ["open_files"] != [str(k3_path)]):
        raise fail(f"{label}: outcomes {seen}, circuit {circ}")
    out["blackout"] = seen
    log(f"{label}: the K3 file {seen}; the breaker open on it "
        f"({circ['opened']} opened, {circ['fast_fails']} fast fails); "
        f"lineitem16's {one[0]} bit-equal between every try ({smi})")

    # brownout: low priority shed, high admitted
    label = "serve (f) brownout"
    svc = ScanService(concurrency=1, queue_depth=4, brownout=0.25,
                      store=lambda f: FaultInjectingStore(
                          LocalStore(f), FaultSpec(latency_s=SERVE_LATENCY_S),
                          config=IOConfig(backoff_ms=0)))
    try:
        tickets, shed = [], None
        for _ in range(10):
            try:
                tickets.append(svc.submit(ScanRequest(
                    l16_path, columns=one, device=True,
                    priority=PRIORITY_LOW)))
            except OverloadError as e:
                shed = detached(e)
        if shed is None or shed.shed_priority != PRIORITY_LOW:
            raise fail(f"{label}: no low-priority request shed")
        tickets.append(svc.submit(ScanRequest(
            l16_path, columns=one, device=True, priority=PRIORITY_HIGH)))
        for i, t in enumerate(tickets):
            same_response(torch, t.result(600), l16_path, base,
                          f"{label} request {i}")
        tickets = None
        sv = svc.serve_stats()
    finally:
        svc.close()
    closed_clean(svc, label)
    out["brownout"] = dict(shed_low=sv["sheds"]["low"],
                           completed=sv["completed"],
                           retry_after_s=shed.retry_after_s)
    log(f"{label}: {sv['sheds']['low']} low-priority requests shed "
        f"(\"{shed}\", retry_after_s {shed.retry_after_s}), the "
        f"high-priority one admitted; {sv['completed']} completed, "
        f"bit-equal ({smi})")

    # a stalled store: one request hangs, its neighbour completes
    label = "serve (f) hang"
    stall, stores = stall_third_fetch()

    def hang_factory(f):
        if (os.path.abspath(getattr(f, "name", "") or "")
                == os.path.abspath(k3_path)):
            return stall(f)
        return LocalStore(f)

    dump = os.path.join(work, "serve_hang_flight.json")
    os.environ["TPQ_FLIGHT"] = dump
    svc = ScanService(concurrency=2, hang_s=SERVE_HANG_S, store=hang_factory)
    try:
        t0 = time.perf_counter()
        stuck = svc.submit(ScanRequest(k3_path, device=True, prefetch=4))
        healthy = svc.submit(ScanRequest(l16_path, columns=one,
                                         device=True))
        same_response(torch, healthy.result(600), l16_path, base,
                      f"{label} healthy")
        healthy = None
        try:
            stuck.result(600)
            raise fail(f"{label}: the stalled request completed")
        except HangError as e:
            hung_s = time.perf_counter() - t0
            err = detached(e)
        sv = svc.serve_stats()
    finally:
        for st in stores:
            st.release()
        svc.close()
        os.environ.pop("TPQ_FLIGHT", None)
    closed_clean(svc, label)
    if sv["failed"] != 1 or sv["completed"] != 1:
        raise fail(f"{label}: {sv['failed']} failed, {sv['completed']} "
                   f"completed")
    out["hang_s"] = hung_s
    log(f"{label}: HangError after {hung_s:.3f} s under hang_s="
        f"{SERVE_HANG_S} for the stalled request alone (dump "
        f"{err.dump_path}); its neighbour bit-equal ({smi})")
    stop_engine(label)
    return out


def read_serve_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                     k3_path: str, k3_main: dict, loader: dict) -> dict:
    """Phase 17: the serve tier on the card (``ScanService`` device
    requests over lineitem16 SF1 and the K3 file, the result cache,
    tenants, a device stream, faults)."""
    import gc

    t_phase = time.perf_counter()
    freed = collected_bytes(torch)
    before = torch.cuda.memory_allocated()
    log(f"serve: {freed} bytes on the card freed by a garbage collection at "
        f"the phase's start ({smi})")
    launched: dict = {}
    bases = []
    for cols in serve_projections():
        ck.reset_launches()
        outs, secs, _ = timed_pass(torch, l16_path, cols)
        bases.append(dict(outs=outs, seconds=secs,
                          counts=dict(ck.launches)))
    del outs
    ck.reset_launches()
    k3_outs, k3_secs, _ = timed_pass(torch, k3_path, K3_COLUMNS)
    k3_base = dict(outs=k3_outs, seconds=k3_secs, counts=dict(ck.launches))
    del k3_outs
    sweep = serve_sweep(torch, ck, l16_path, bases, bases[0]["seconds"],
                        smi, launched)
    k3 = serve_k3(torch, ck, k3_path, k3_base,
                  k3_main["counts"]["fused_narrow_words"], smi, launched)
    del k3_base
    cached = serve_cached(torch, ck, l16_path, bases[0], smi, launched)
    tenants = serve_tenants(torch, ck, l16_path, smi, launched)
    stream = serve_stream(
        torch, os.path.join(work, "lineitem16_sf1_rg250k.parquet"),
        loader["depth"]["rates"][0][0], smi)
    faults = serve_faults(torch, work, l16_path, k3_path, bases, smi,
                          launched)
    single = SF1_ROWS / bases[0]["seconds"]
    del bases
    threads = tpq_threads()
    if threads:
        raise fail(f"phase 17: threads still alive after it: {threads}")
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    if left:
        raise fail(f"phase 17: {left} bytes still allocated after it")
    wall = time.perf_counter() - t_phase
    log(f"serve summary ({smi}): rows/s served "
        + ", ".join(f"{c} client(s) {v['rows_per_s']:.1f} (p99 "
                    f"{v['lat']['p99']:.3f} ms, queue wait "
                    f"{v['queue_wait']} s)" for c, v in sweep.items())
        + f" against one uncached read {single:.1f}; K3 request "
        f"{k3['rows_per_s']:.1f}; warm request {cached['warm_ms']:.3f} ms "
        f"(cold {cached['cold_ms']:.3f}); victim p99 FIFO "
        f"{tenants['fifo']['p99_ms']:.3f} ms, fair "
        f"{tenants['fair']['p99_ms']:.3f} ms; stream "
        f"{stream['rows_per_s']:.1f} rows/s; hang at {faults['hang_s']:.3f}"
        f" s; serve_launches {launched}; 0 bytes left, no tpq- thread "
        f"alive; phase 17 wall {wall:.2f} s")
    return dict(launched=launched, sweep=sweep, wall=wall)


WRITE_GROUPS = 12  # 18(a), bench.py bench_write_scale: 12 row groups
WRITE_GROUP_ROWS = 500_000  # of 500,000 rows
WRITE_SEED = 11
WRITE_WORKERS = (1, 4, 8)
FRAG_PARTS = 4  # 18(c): each batch in 4 files, 48 files of 125,000 rows
COMPACT_PASSES = 3  # 18(c): scan_files passes of each dataset, in turns
FLOOR_RECORDS = 100_000  # 18(f)
FLOOR_SCHEMA = """message rec {
  required int64 id;
  required int64 ts_ms (TIMESTAMP(MILLIS,true));
  required int64 ts_us (TIMESTAMP(MICROS,true));
  required int64 ts_ns (TIMESTAMP(NANOS,true));
  required int96 legacy;
  required int64 price (DECIMAL(18,4));
  required fixed_len_byte_array(16) uid (UUID);
  required group addr {
    required binary city (STRING);
    optional binary zip (STRING);
  }
}"""


@dataclasses.dataclass
class FloorAddr:
    city: str
    zip: str | None


@dataclasses.dataclass
class FloorRecord:
    id: int
    ts_ms: datetime.datetime
    ts_us: datetime.datetime
    ts_ns: datetime.datetime
    legacy: datetime.datetime
    price: decimal.Decimal
    uid: uuid.UUID
    addr: FloorAddr


def write_scale_schema():
    from tpu_parquet_torch.format import FieldRepetitionType as FRT, Type
    from tpu_parquet_torch.schema.core import build_schema, data_column

    return build_schema([data_column("k", Type.INT64, FRT.REQUIRED),
                         data_column("v", Type.DOUBLE, FRT.REQUIRED)])


def write_scale_batches() -> list:
    """``bench.py`` ``bench_write_scale``'s batches: ``k`` INT64 uniform
    below 2^40, ``v`` DOUBLE, seed 11."""
    import numpy as np

    rng = np.random.default_rng(WRITE_SEED)
    return [{"k": rng.integers(0, 1 << 40, WRITE_GROUP_ROWS).astype(np.int64),
             "v": rng.random(WRITE_GROUP_ROWS)} for _ in range(WRITE_GROUPS)]


def fresh_dir(path: str) -> str:
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def same_file(a: str, b: str, label: str) -> None:
    import filecmp

    if not filecmp.cmp(a, b, shallow=False):
        raise fail(f"{label}: {a} ({os.path.getsize(a)} bytes) is not "
                   f"byte-identical to {b} ({os.path.getsize(b)} bytes)")


def write_lanes(st) -> str:
    from tpu_parquet_torch.write import WRITE_STAGES

    d = st.as_dict()
    return (", ".join(f"{s} {d[s + '_seconds']} s" for s in WRITE_STAGES)
            + f", stall_seconds {d['stall_seconds']}, workers "
            f"{d['workers']}, wall_seconds {d['wall_seconds']}")


def no_write_leftovers(d: str, label: str) -> None:
    """After a write: no ``tpq-`` thread and no temporary file."""
    threads = tpq_threads()
    temps = [f for f in os.listdir(d) if ".tmp-" in f]
    if threads or temps:
        raise fail(f"{label}: threads {threads}, temporary files {temps} "
                   f"left after the write")


def write_encode(torch, ck, d: str, smi: str, launched: dict) -> dict:
    """18(a): ``bench_write_scale``'s encode with the single writer and
    ``write_sharded`` at each worker count, byte-identical, then read back
    on the card."""
    from tpu_parquet_torch.write import WriteStats, write_sharded
    from tpu_parquet_torch.writer import FileWriter

    schema, batches = write_scale_schema(), write_scale_batches()
    rows = WRITE_GROUPS * WRITE_GROUP_ROWS
    single = os.path.join(d, "single.parquet")
    st = WriteStats()
    t0 = time.perf_counter()
    with FileWriter(single, schema, stats=st) as w:
        for b in batches:
            w.write_columns(b)
            w.flush_row_group()
    single_s = time.perf_counter() - t0
    rates = {"single": rows / single_s}
    log(f"write (a) single writer: {rows} rows in {WRITE_GROUPS} row "
        f"groups, {os.path.getsize(single)} bytes in {single_s:.4f} s = "
        f"{rows / single_s:.1f} rows/s; lanes {write_lanes(st)} ({smi})")
    for n in WRITE_WORKERS:
        label = f"write (a) write_sharded workers={n}"
        path = os.path.join(d, f"sharded_w{n}.parquet")
        st = WriteStats()
        t0 = time.perf_counter()
        res = write_sharded(path, schema, batches, workers=n, stats=st)
        secs = time.perf_counter() - t0
        no_write_leftovers(d, label)
        same_file(path, single, label)
        os.unlink(path)
        rates[n] = rows / secs
        log(f"{label}: {res.rows} rows, {res.bytes_written} bytes, "
            f"byte-identical to the single writer's file, in {secs:.4f} s "
            f"= {rows / secs:.1f} rows/s ({single_s / secs:.3f}x the single "
            f"writer); lanes {write_lanes(st)} ({smi})")
    main = read_main_path(torch, ck, single, batches, "write (a) read-back",
                          columns=["k", "v"])
    add_launches(launched, main["counts"])
    return dict(rates=rates, batches=batches, schema=schema, single=single,
                read_rows_per_s=main["rows_per_s"])


def write_lineitem16_sets(torch, ck, d: str, smi: str, *, l16_path: str,
                          l16_groups, l16: dict, launched: dict) -> dict:
    """18(b) and (e): lineitem16 SF1 through ``write_sharded`` at 4
    workers, as one file (byte-identical to phase 6's) and as a manifest
    dataset read through ``scan_files`` on the card; then ``merge_files``
    over the manifest's members, read back on the card."""
    from tpu_parquet_torch.write import WriteStats, merge_files, write_sharded

    schema, opts = lineitem16_layout()
    label = "write (b) lineitem16 write_sharded workers=4, file layout"
    path = os.path.join(d, "lineitem16_sharded.parquet")
    st = WriteStats()
    t0 = time.perf_counter()
    write_sharded(path, schema, (lineitem16_batch(g) for g in l16_groups),
                  workers=4, stats=st, **opts)
    file_s = time.perf_counter() - t0
    no_write_leftovers(d, label)
    same_file(path, l16_path, label)
    os.unlink(path)
    log(f"{label}: byte-identical to phase 6's single-writer file, "
        f"{SF1_ROWS / file_s:.1f} rows/s ({file_s:.4f} s); lanes "
        f"{write_lanes(st)} ({smi})")
    label = "write (b) lineitem16 write_sharded workers=4, manifest layout"
    ds = fresh_dir(os.path.join(d, "lineitem16_ds"))
    t0 = time.perf_counter()
    res = write_sharded(ds, schema, (lineitem16_batch(g) for g in l16_groups),
                        workers=4, layout="manifest", **opts)
    ds_s = time.perf_counter() - t0
    no_write_leftovers(ds, label)
    base, _, _ = timed_pass(torch, l16_path, L16_COLUMNS)
    outs, secs, counts, _, _, rows = scan_pass(torch, ck, ds, 0)
    same_on_card(torch, outs, base, label)
    del outs
    if rows != SF1_ROWS or counts != l16["counts"]:
        raise fail(f"{label}: {rows} rows, launches {counts}; phase 6's "
                   f"single pass launched {l16['counts']}")
    add_launches(launched, counts)
    log(f"{label}: {res.files} members, generation {res.generation}, "
        f"written in {ds_s:.4f} s; scan_files over the manifest on the "
        f"card bit-equal to phase 6's file, {rows / secs:.1f} rows/s, "
        f"launches {counts} (phase 6's one pass) ({smi})")
    label = "write (e) merge_files over (b)'s members"
    merged = os.path.join(d, "lineitem16_merged.parquet")
    st = WriteStats()
    t0 = time.perf_counter()
    merge_files(merged, res.paths, stats=st)
    merge_s = time.perf_counter() - t0
    no_write_leftovers(d, label)
    same_file(merged, l16_path, label)
    ck.reset_launches()
    outs, secs, _ = timed_pass(torch, merged, L16_COLUMNS)
    counts = dict(ck.launches)
    same_on_card(torch, outs, base, label)
    del outs, base
    if counts != l16["counts"]:
        raise fail(f"{label}: launches {counts}, phase 6's {l16['counts']}")
    add_launches(launched, counts)
    log(f"{label}: {len(res.paths)} files merged in {merge_s:.4f} s "
        f"(lanes {write_lanes(st)}), byte-identical to phase 6's file; "
        f"read on the card bit-equal, {SF1_ROWS / secs:.1f} rows/s ({smi})")
    os.unlink(merged)
    # the members stay for phase 19's merge
    return dict(file_rows_per_s=SF1_ROWS / file_s, ds=ds,
                members=[os.path.relpath(p, ds) for p in res.paths])


def concat_check(outs, want: dict, label: str) -> None:
    """The groups' columns, concatenated on the host, bit for bit against
    ``want`` (a column name to its whole array)."""
    import numpy as np

    for name, exp in want.items():
        got = np.concatenate([g[name].to_host() for g in outs])
        if got.dtype != exp.dtype or not np.array_equal(
                got.view(np.uint8), exp.view(np.uint8)):
            raise fail(f"{label}: column {name} differs from the batches")


def write_fragments(d: str, schema, batches) -> list:
    """``bench_write_scale``'s fragmented dataset: each batch in
    ``FRAG_PARTS`` files."""
    from tpu_parquet_torch.writer import FileWriter

    small = []
    part = WRITE_GROUP_ROWS // FRAG_PARTS
    for i, b in enumerate(batches):
        for j in range(FRAG_PARTS):
            p = os.path.join(d, f"in-{i:03d}-{j}.parquet")
            with FileWriter(p, schema) as w:
                w.write_columns({k: v[j * part:(j + 1) * part]
                                 for k, v in b.items()})
            small.append(p)
    return small


def write_compaction(torch, ck, d: str, enc: dict, smi: str,
                     launched: dict) -> dict:
    """18(c): the fragmented dataset compacted, then each read through
    ``scan_files`` on the card, in turns."""
    import numpy as np

    from tpu_parquet_torch.format import CompressionCodec
    from tpu_parquet_torch.write import WriteStats, compact

    frag = fresh_dir(os.path.join(d, "frag"))
    want = {c: np.concatenate([b[c] for b in enc["batches"]])
            for c in ("k", "v")}
    small = write_fragments(frag, enc["schema"], enc["batches"])
    st = WriteStats()
    t0 = time.perf_counter()
    rep = compact(small, out=frag, workers=pipeline_depth(), stats=st)
    compact_s = time.perf_counter() - t0
    no_write_leftovers(frag, "write (c) compact")
    codec = CompressionCodec(rep.codec).name
    log(f"write (c) compact: {rep.files_before} files ({rep.bytes_before} "
        f"bytes, {rep.row_groups_before} row groups) -> {rep.files_after} "
        f"({rep.bytes_after} bytes, {rep.row_groups_after} row groups), "
        f"codec {codec}, modeled link bytes {rep.link_bytes_before} -> "
        f"{rep.link_bytes_after} (link_bytes_ratio "
        f"{rep.link_bytes_ratio:.4f}), {compact_s:.4f} s; lanes "
        f"{write_lanes(st)} ({smi})")
    sources = {"fragmented": small, "compacted": frag}
    seen: dict = {n: [] for n in sources}
    shipped: dict = {}
    order = ["fragmented", "compacted", "compacted", "fragmented"]
    for i in range(COMPACT_PASSES * 2):
        name = order[i % 4]
        made: list = []
        outs, secs, counts, _, _, rows = scan_pass(torch, ck, sources[name],
                                                   0, made=made)
        label = f"write (c) {name} pass {len(seen[name]) + 1}"
        if rows != len(want["k"]):
            raise fail(f"{label}: {rows} rows, want {len(want['k'])}")
        if not seen[name]:
            concat_check(outs, want, label)
            shipped[name] = (sum(r.stats().link_bytes_shipped for r in made),
                             sum(r.stats().link_bytes_logical for r in made))
            log(f"{label}: {len(outs)} row groups bit-exact against the "
                f"batches; launches {counts}; routes "
                f"{route_table(made[0].stats().as_dict())} (first file); "
                f"link bytes shipped {shipped[name][0]} of logical "
                f"{shipped[name][1]}")
        del outs
        add_launches(launched, counts)
        seen[name].append(rows / secs)
    for r in made:
        check_released([r], "write (c)")
    measured = shipped["compacted"][0] / shipped["fragmented"][0]
    rates = {n: float(np.median(v)) for n, v in seen.items()}
    log(f"write (c) scan_files rows/s, passes in turns: " + "; ".join(
        f"{n} {', '.join(f'{x:.1f}' for x in v)} (median {rates[n]:.1f})"
        for n, v in seen.items())
        + f"; compacted/fragmented {rates['compacted'] / rates['fragmented']:.4f}x;"
        f" link bytes shipped compacted/fragmented {measured:.4f} (modeled "
        f"link_bytes_ratio {rep.link_bytes_ratio:.4f}) ({smi})")
    return dict(frag=frag, small=small, want=want, rates=rates,
                measured_ratio=measured, modeled_ratio=rep.link_bytes_ratio,
                codec=codec, compact_s=compact_s)


def write_live_compaction(torch, ck, comp: dict, smi: str) -> dict:
    """18(d): ``compact`` twice with a ``PlanCache`` while a
    ``ScanService(device="cuda")`` sweeps the dataset: every sweep serves
    one whole generation, equal to the batches."""
    import threading

    import numpy as np

    from tpu_parquet_torch.serve import PlanCache, ScanRequest, ScanService
    from tpu_parquet_torch.write import compact, load_manifest, write_manifest

    frag, want = comp["frag"], comp["want"]
    first = write_manifest(frag, comp["small"]).generation
    cache = PlanCache()
    svc = ScanService(concurrency=2, cache=cache)
    sweeps, errors = [], []
    stop = threading.Event()

    def sweep():
        try:
            while not stop.is_set():
                m = load_manifest(frag)
                parts: dict = {}
                for p in m.member_paths():
                    res = svc.scan(ScanRequest(p, device=True), timeout=600)
                    for n, v in res[p].items():
                        parts.setdefault(n, []).extend(
                            v if isinstance(v, list) else [v])
                    del res
                for n, exp in want.items():
                    got = np.concatenate([c.to_host() for c in parts[n]])
                    if not np.array_equal(got.view(np.uint8),
                                          exp.view(np.uint8)):
                        raise AssertionError(
                            f"generation {m.generation}: column {n} torn "
                            f"or stale")
                del parts
                sweeps.append((m.generation, len(m.files)))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(detached(e))

    t = threading.Thread(target=sweep, name="write-d-sweep")
    t.start()
    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        reps = [compact(frag, plan_cache=cache, workers=pipeline_depth())
                for _ in range(2)]
        final = reps[-1].generation
        deadline = time.monotonic() + 300
        while (t.is_alive() and time.monotonic() < deadline
               and not any(g == final for g, _ in sweeps)):
            time.sleep(0.05)
    finally:
        stop.set()
        t.join(600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    svc.close()
    closed_clean(svc, "write (d)")
    if t.is_alive() or errors:
        raise fail(f"write (d): sweep alive {t.is_alive()}, "
                   f"{errors[0] if errors else ''!r}")
    if final not in {g for g, _ in sweeps}:
        raise fail(f"write (d): no sweep of the final generation {final}; "
                   f"sweeps {sweeps}")
    log(f"write (d) compaction under a live ScanService(device='cuda') "
        f"sweep: generations {first} -> {reps[0].generation} -> {final} in "
        f"{wall:.4f} s; {len(sweeps)} sweeps, each one whole generation "
        f"bit-equal to the batches (generation, members): {sweeps}; plan "
        f"cache counters {cache.counters()}; launches {counts} ({smi})")
    return dict(sweeps=len(sweeps), counts=counts)


def floor_records() -> list:
    """``FLOOR_RECORDS`` records from a seed: timestamps in each unit (each
    a whole number of its unit), INT96, decimal, uuid, a nested record."""
    import numpy as np

    utc = datetime.timezone.utc
    base = datetime.datetime(2020, 1, 1, tzinfo=utc)
    n = FLOOR_RECORDS
    rng = np.random.default_rng(18)
    ms = rng.integers(0, 10**11, n).tolist()
    us = rng.integers(0, 10**14, n).tolist()
    cents = rng.integers(-10**12, 10**12, n).tolist()
    hi = rng.integers(0, 1 << 62, n).tolist()
    return [FloorRecord(
        id=i, ts_ms=base + datetime.timedelta(milliseconds=ms[i]),
        ts_us=base + datetime.timedelta(microseconds=us[i]),
        ts_ns=base + datetime.timedelta(microseconds=us[n - 1 - i]),
        legacy=base + datetime.timedelta(microseconds=us[(7 * i) % n]),
        price=decimal.Decimal(cents[i]).scaleb(-4),
        uid=uuid.UUID(int=(hi[i] << 64) | i),
        addr=FloorAddr(city=f"city{i % 50}",
                       zip=None if i % 3 == 0 else f"{i:05d}"))
        for i in range(n)]


def write_floor(torch, ck, d: str, smi: str, launched: dict) -> dict:
    """18(f): ``floor.Writer`` records, back through ``floor.Reader``
    equal, and the flat leaves through ``DeviceFileReader`` on the card
    equal to the host reader's."""
    import numpy as np

    from tpu_parquet_torch import floor
    from tpu_parquet_torch.column import ByteArrayData
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.schema.dsl import parse_schema_definition

    recs = floor_records()
    path = os.path.join(d, "floor.parquet")
    t0 = time.perf_counter()
    with floor.Writer(path, schema=parse_schema_definition(FLOOR_SCHEMA)) as w:
        w.write_many(recs)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with floor.Reader(path, obj_type=FloorRecord) as r:
        back = r.scan_all()
    read_s = time.perf_counter() - t0
    if back != recs:
        bad = next(i for i, (a, b) in enumerate(zip(back, recs)) if a != b) \
            if len(back) == len(recs) else len(back)
        raise fail(f"write (f) floor: record {bad} read back differs")
    del back
    with FileReader(path) as r:
        host = r.read_all()
    ck.reset_launches()
    with DeviceFileReader(path) as r:
        outs = list(r.iter_row_groups())
        torch.cuda.synchronize()
    counts = dict(ck.launches)
    add_launches(launched, counts)
    for name, cd in host.items():
        got = [g[name] for g in outs]
        if isinstance(cd.values, ByteArrayData):
            vals = [c.to_host() for c in got]
            off = np.concatenate([vals[0].offsets] + [
                v.offsets[1:] + sum(len(x.heap) for x in vals[:j + 1])
                for j, v in enumerate(vals[1:])])
            heap = np.concatenate([v.heap for v in vals])
            same = (np.array_equal(off, cd.values.offsets)
                    and np.array_equal(heap, cd.values.heap))
        else:
            v = np.concatenate([c.to_host() for c in got])
            same = v.dtype == cd.values.dtype and np.array_equal(
                v.view(np.uint8), cd.values.view(np.uint8))
        if cd.def_levels is not None:
            dl = np.concatenate([c.levels_to_host()[0] for c in got])
            same = same and np.array_equal(dl, cd.def_levels)
        if not same:
            raise fail(f"write (f) floor: leaf {name} on the card differs "
                       f"from the host reader's")
    ids = np.concatenate([g["id"].to_host() for g in outs])
    if not np.array_equal(ids, np.arange(FLOOR_RECORDS)):
        raise fail("write (f) floor: ids on the card are not 0..n-1")
    del outs
    log(f"write (f) floor: {FLOOR_RECORDS} records written in "
        f"{write_s:.4f} s ({FLOOR_RECORDS / write_s:.1f} records/s), read "
        f"back equal through floor.Reader in {read_s:.4f} s "
        f"({FLOOR_RECORDS / read_s:.1f} records/s); its {len(host)} leaves "
        f"{sorted(host)} on the card equal to the host reader's; launches "
        f"{counts} ({smi})")
    return dict(write_s=write_s, read_s=read_s)


def read_write_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                     l16_groups, l16: dict) -> dict:
    """Phase 18: the write side (the single writer, ``write_sharded``,
    ``merge_files``, ``compact`` under a live sweep, ``floor``) read back
    on the card."""
    import gc

    t_phase = time.perf_counter()
    freed = collected_bytes(torch)
    before = torch.cuda.memory_allocated()
    log(f"write: {freed} bytes on the card freed by a garbage collection at "
        f"the phase's start ({smi})")
    d = fresh_dir(os.path.join(work, "write"))
    launched: dict = {}
    enc = write_encode(torch, ck, d, smi, launched)
    l16w = write_lineitem16_sets(torch, ck, d, smi, l16_path=l16_path,
                                 l16_groups=l16_groups, l16=l16,
                                 launched=launched)
    comp = write_compaction(torch, ck, d, enc, smi, launched)
    live = write_live_compaction(torch, ck, comp, smi)
    add_launches(launched, live["counts"])
    fl = write_floor(torch, ck, d, smi, launched)
    del enc["batches"], comp["want"]
    for name in ("hybrid_unpack_combine", "fused_plain_words"):
        if not launched.get(name):
            raise fail(f"phase 18: {name} never launched")
    threads = tpq_threads()
    if threads:
        raise fail(f"phase 18: threads still alive after it: {threads}")
    gc.collect()
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() - before
    if left:
        raise fail(f"phase 18: {left} bytes still allocated after it")
    kept = os.path.join(work, "lineitem16_members")
    shutil.rmtree(kept, ignore_errors=True)
    os.replace(l16w["ds"], kept)
    shutil.rmtree(d)
    wall = time.perf_counter() - t_phase
    r = enc["rates"]
    log(f"write summary ({smi}): encode rows/s single {r['single']:.1f}, "
        + ", ".join(f"workers {n} {r[n]:.1f} ({r[n] / r['single']:.3f}x)"
                    for n in WRITE_WORKERS)
        + f"; lineitem16 sharded (4 workers) {l16w['file_rows_per_s']:.1f} "
        f"rows/s; compaction {comp['compact_s']:.4f} s, codec "
        f"{comp['codec']}, scan_files compacted "
        f"{comp['rates']['compacted']:.1f} vs fragmented "
        f"{comp['rates']['fragmented']:.1f} rows/s, link bytes shipped "
        f"ratio {comp['measured_ratio']:.4f} (modeled "
        f"{comp['modeled_ratio']:.4f}); {live['sweeps']} live sweeps; floor "
        f"{FLOOR_RECORDS / fl['write_s']:.1f} records/s written, "
        f"{FLOOR_RECORDS / fl['read_s']:.1f} read; write_launches "
        f"{launched}; 0 bytes left, no tpq- thread alive; phase 18 wall "
        f"{wall:.2f} s")
    return dict(launched=launched, wall=wall,
                members=[os.path.join(kept, m) for m in l16w["members"]])


# ---------------------------------------------------------------------------
# phase 19: the CLI on the card's files
# ---------------------------------------------------------------------------

# 19: the row commands (cat, split, csv2parquet) make one Python call per
# row in the reference too, so they run on a 100,000-row cut of lineitem16
CLI_ROWS = 100_000
CLI_SPLIT_PARTS = 3  # split must cut the cut into at least this many parts
CLI_HINTS = {"l_orderkey": "int64", "l_partkey": "int64",
             "l_suppkey": "int64", "l_linenumber": "int32",
             "l_quantity": "int64", "l_extendedprice": "double",
             "l_discount": "double", "l_tax": "double",
             "l_shipdate": "date", "l_commitdate": "date",
             "l_receiptdate": "date"}


def child_env() -> dict:
    """The environment of a child process: no ``TPQ_`` knob an earlier
    phase left set (a spool, a flight path) reaches it."""
    return {k: v for k, v in os.environ.items() if not k.startswith("TPQ_")}


def run_cli(args, label: str, times: list,
            module: str = "tpu_parquet_torch.cli.pq_tool") -> str:
    """``python -m <module> <args>`` from the checkout; fails on a non-zero
    exit.  Its seconds go to ``times``; returns its stdout."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module, *args], cwd=HERE,
                       env=child_env(), capture_output=True, text=True,
                       timeout=900)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise fail(f"{label}: {module} {' '.join(args[:2])} exited "
                   f"{r.returncode}: {r.stderr[-3000:]}")
    times.append((label, secs))
    return r.stdout


def host_column(parts) -> tuple:
    """One column's pieces (``to_host()`` of each row group, or generator
    arrays) as one comparable value: a STRING column's lengths and heap, a
    fixed-width column's dtype and bytes."""
    import numpy as np

    from tpu_parquet_torch.column import ByteArrayData

    if isinstance(parts[0], ByteArrayData):
        lens = np.concatenate([np.diff(np.asarray(p.offsets, np.int64))
                               for p in parts])
        heap = b"".join(bytes(np.asarray(p.heap)[int(p.offsets[0]):
                                                 int(p.offsets[-1])])
                        for p in parts)
        return ("bytes", lens.tobytes(), heap)
    arr = np.concatenate([np.asarray(p) for p in parts])
    return (str(arr.dtype), arr.view(np.uint8).tobytes())


def read_back(torch, ck, paths, columns, label: str, launched: dict):
    """Every row group of ``paths`` read on the card through
    ``DeviceFileReader(device="cuda")``; returns ({column: host value},
    rows, the launches of the reads, added to ``launched``)."""
    from tpu_parquet_torch.device_reader import DeviceFileReader

    parts: dict = {c: [] for c in columns}
    rows = 0
    ck.reset_launches()
    for p in paths:
        with DeviceFileReader(p, columns=columns, device="cuda") as r:
            for g in r.iter_row_groups():
                for c in columns:
                    parts[c].append(g[c].to_host())
                rows += len(parts[columns[0]][-1])
    torch.cuda.synchronize()
    counts = dict(ck.launches)
    add_launches(launched, counts)
    return {c: host_column(v) for c, v in parts.items()}, rows, counts


def same_columns(got: dict, want: dict, label: str) -> None:
    for name, exp in want.items():
        if got.get(name) != exp:
            raise fail(f"{label}: column {name} differs")


def cat_check(text: str, g: dict, label: str) -> int:
    """``cat``'s JSON lines against the generator's rows, every field."""
    lines = text.splitlines()
    if len(lines) != CLI_ROWS:
        raise fail(f"{label}: {len(lines)} lines, want {CLI_ROWS}")
    cols = {c: (v.to_list() if hasattr(v, "to_list") else v.tolist())
            for c, v in g.items()}
    for c in STRING_COLUMNS:
        cols[c] = [b.decode() for b in cols[c]]
    for i, line in enumerate(lines):
        row = json.loads(line)
        for c in L16_COLUMNS:
            if row[c] != cols[c][i]:
                raise fail(f"{label}: row {i} column {c}: {row[c]!r}, want "
                           f"{cols[c][i]!r}")
    return len(lines)


def write_cli_csv(path: str, g: dict) -> None:
    """The cut as CSV: integers and dates as text (dates ISO), doubles as
    ``repr`` (read back exactly), strings as written."""
    import csv

    epoch = datetime.date(1970, 1, 1)
    cols = []
    for c in L16_COLUMNS:
        v = g[c]
        if c in STRING_COLUMNS:
            cols.append([b.decode() for b in v.to_list()])
        elif CLI_HINTS[c] == "date":
            cols.append([(epoch + datetime.timedelta(days=int(d))).isoformat()
                         for d in v])
        else:
            cols.append([repr(x) for x in v.tolist()])
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(L16_COLUMNS)
        w.writerows(zip(*cols))


def read_cli_phase(torch, ck, work: str, smi: str, *, l16_path: str,
                   l16_groups, l16: dict, members: list, obs: dict) -> dict:
    """Phase 19: ``python -m tpu_parquet_torch.cli.pq_tool`` and
    ``tpu_parquet_torch.cli.csv2parquet`` as child processes on the
    files of phases 6, 15, 16 and 18, every output read back on the
    card."""
    import numpy as np

    from tpu_parquet_torch.schema.dsl import parse_schema_definition

    t_phase = time.perf_counter()
    d = fresh_dir(os.path.join(work, "cli"))
    launched: dict = {}
    times: list = []
    label = "cli (a) footer commands on lineitem16 SF1"
    out = run_cli(["rowcount", l16_path], "rowcount", times)
    if out.strip() != str(SF1_ROWS):
        raise fail(f"{label}: rowcount printed {out.strip()!r}")
    out = run_cli(["meta", l16_path], "meta", times)
    for want in (f"rows: {SF1_ROWS}", f"row groups: {len(l16_groups)}"):
        if want not in out:
            raise fail(f"{label}: meta lacks {want!r}")
    out = run_cli(["schema", l16_path], "schema", times)
    if parse_schema_definition(out).num_columns != len(L16_COLUMNS):
        raise fail(f"{label}: the schema printed does not parse to "
                   f"{len(L16_COLUMNS)} columns")
    out = run_cli(["stats", l16_path], "stats", times)
    keys = [ln.split() for ln in out.splitlines()
            if ln.strip().startswith("l_orderkey ")]
    want = [(f"min={int(g['l_orderkey'].min())}",
             f"max={int(g['l_orderkey'].max())}") for g in l16_groups]
    if [tuple(k[1:3]) for k in keys] != want:
        raise fail(f"{label}: stats' l_orderkey ranges {keys} differ from "
                   f"the generator's {want}")
    log(f"{label}: rowcount {SF1_ROWS}, meta, schema ({len(L16_COLUMNS)} "
        f"columns parsed back), stats (l_orderkey's range per row group "
        f"equal to the generator's) ({smi})")

    # (b) the row commands on the 100,000-row cut
    label = f"cli (b) row commands on a {CLI_ROWS}-row lineitem16 cut"
    g = lineitem_strings(next(draw_lineitem16(CLI_ROWS)))
    cut = os.path.join(d, "lineitem16_cut.parquet")
    write_lineitem16(cut, [g])
    want_cut = {c: host_column([g[c]]) for c in L16_COLUMNS}
    head = run_cli(["head", "-n", "3", cut], "head", times)
    if [json.loads(ln)["l_orderkey"] for ln in head.splitlines()] != \
            g["l_orderkey"][:3].tolist():
        raise fail(f"{label}: head's first keys differ")
    n = cat_check(run_cli(["cat", cut], "cat", times), g, label)
    size = os.path.getsize(cut)
    pattern = os.path.join(d, "part_{}.parquet")
    # the parts are written with the writer's defaults, larger per row
    # than the cut (DELTA and dictionaries off): a third of its size makes
    # about four
    run_cli(["split", "--size", str(size // CLI_SPLIT_PARTS),
             "--output-pattern", pattern, cut], "split", times)
    parts = [pattern.format(i) for i in range(len(
        [f for f in os.listdir(d) if f.startswith("part_")]))]
    if len(parts) < CLI_SPLIT_PARTS:
        raise fail(f"{label}: split made {len(parts)} parts, want at least "
                   f"{CLI_SPLIT_PARTS}")
    got, rows, _ = read_back(torch, ck, parts, L16_COLUMNS, label, launched)
    same_columns(got, want_cut, f"{label}, split parts")
    merged = os.path.join(d, "merged_parts.parquet")
    run_cli(["merge", merged, *parts], "merge (split parts)", times)
    got, rows, counts = read_back(torch, ck, [merged], L16_COLUMNS, label,
                                  launched)
    same_columns(got, want_cut, f"{label}, merged parts")
    log(f"{label}: cat {n} rows equal to the generator; split into "
        f"{len(parts)} parts and merged back, both read on the card equal "
        f"to the cut ({rows} rows, launches {counts}) ({smi})")

    # (c) merge of phase 18(b)'s manifest members: phase 6's file again
    label = "cli (c) merge of 18(b)'s members"
    merged = os.path.join(d, "lineitem16_merged.parquet")
    run_cli(["merge", merged, *members], "merge (18(b) members)", times)
    same_file(merged, l16_path, label)
    base, _, _ = timed_pass(torch, l16_path, L16_COLUMNS)
    ck.reset_launches()
    outs, secs, _ = timed_pass(torch, merged, L16_COLUMNS)
    counts = dict(ck.launches)
    same_on_card(torch, outs, base, label)
    del outs, base
    if counts != l16["counts"]:
        raise fail(f"{label}: launches {counts}, phase 6's {l16['counts']}")
    add_launches(launched, counts)
    os.unlink(merged)
    log(f"{label}: {len(members)} members merged, byte-identical to phase "
        f"6's file; read on the card bit-equal, {SF1_ROWS / secs:.1f} rows/s, "
        f"launches {counts} ({smi})")

    # (d) compact of 18(c)'s 48 fragments
    label = "cli (d) compact of 18(c)'s fragments"
    frag = fresh_dir(os.path.join(d, "frag"))
    batches = write_scale_batches()
    small = write_fragments(frag, write_scale_schema(), batches)
    out = run_cli(["compact", *small, "--out", frag], "compact", times)
    if f"compacted {len(small)} file(s)" not in out:
        raise fail(f"{label}: compact printed {out!r}")
    from tpu_parquet_torch.write import load_manifest

    m = load_manifest(frag)
    got, rows, counts = read_back(torch, ck, m.member_paths(), ["k", "v"],
                                  label, launched)
    same_columns(got, {c: host_column([b[c] for b in batches])
                       for c in ("k", "v")}, label)
    del batches
    log(f"{label}: {out.strip().splitlines()[0]}; the compacted dataset "
        f"({len(m.files)} file(s), {rows} rows) read on the card equal to the "
        f"batches, launches {counts} ({smi})")
    shutil.rmtree(frag)

    # (e) csv2parquet on the cut as CSV, with type hints
    label = "cli (e) csv2parquet"
    csv_path = os.path.join(d, "lineitem16_cut.csv")
    write_cli_csv(csv_path, g)
    conv = os.path.join(d, "lineitem16_cut_csv.parquet")
    out = run_cli(["-i", csv_path, "-o", conv, "--type-hints",
                   ",".join(f"{c}={t}" for c, t in CLI_HINTS.items())],
                  "csv2parquet", times,
                  module="tpu_parquet_torch.cli.csv2parquet")
    if f"wrote {CLI_ROWS} rows" not in out:
        raise fail(f"{label}: printed {out!r}")
    got, rows, counts = read_back(torch, ck, [conv], L16_COLUMNS, label,
                                  launched)
    same_columns(got, want_cut, label)
    del g
    log(f"{label}: {CLI_ROWS} CSV rows with type hints (dates as DATE) "
        f"converted, read on the card equal to the cut, launches {counts} "
        f"({smi})")

    # (f) the obs artifacts of phases 15 and 16
    label = "cli (f) trace, doctor, autopsy, top"
    trace = os.path.join(work, "obs_trace.json")
    out = run_cli(["trace", trace], "trace", times)
    for want in ("stage", "dispatch", "overlap efficiency"):
        if want not in out:
            raise fail(f"{label}: trace lacks {want!r}")
    out = run_cli(["doctor", trace], "doctor", times)
    verdict = [ln for ln in out.splitlines() if ln.startswith("verdict:")]
    if not verdict:
        raise fail(f"{label}: doctor printed no verdict: {out!r}")
    out = run_cli(["autopsy", os.path.join(work, "obs_hang_dump.json")],
                  "autopsy", times)
    if f"verdict: {obs['hang']['verdict']}" not in out:
        raise fail(f"{label}: autopsy printed no "
                   f"{obs['hang']['verdict']!r} verdict: {out[-2000:]!r}")
    out = run_cli(["top", "--once", "--stale", "1e9",
                   os.path.join(work, "obs_spool")], "top", times)
    if "process(es)" not in out:
        raise fail(f"{label}: top printed {out!r}")
    log(f"{label}: trace's stages, doctor {verdict[0]!r}, autopsy "
        f"{obs['hang']['verdict']} as phase 15's, top over phase 16's spool "
        f"({smi})")
    shutil.rmtree(d)
    for name in ("hybrid_unpack_combine", "fused_plain_words"):
        if not launched.get(name):
            raise fail(f"phase 19: {name} never launched")
    wall = time.perf_counter() - t_phase
    log(f"cli summary ({smi}): command seconds " + ", ".join(
        f"{n} {s:.3f}" for n, s in times) + f"; cli_launches {launched}; "
        f"phase 19 wall {wall:.2f} s")
    return dict(launched=launched, times=times, wall=wall)


# ---------------------------------------------------------------------------
# phase 20: the fuzz harness on the card
# ---------------------------------------------------------------------------

FUZZ_SEED = 1234  # tests/test_fuzz.py's smoke batch
FUZZ_RUNS = 400
FUZZ_FILE_READER_RUNS = 120


def read_fuzz_phase(work: str, smi: str) -> dict:
    """Phase 20: ``python -m tpu_parquet_torch.fuzz`` in a child process
    on the card: both corpus directories replayed, then the smoke batch,
    crashers not saved (a kernel's out-of-bounds read would poison this
    process, so it runs in its own)."""
    t_phase = time.perf_counter()
    summary = os.path.join(work, "fuzz_summary.json")
    dirs = [os.path.join(HERE, "tests", "fuzz_corpus"),
            os.path.join(HERE, "tests", "fuzz_corpus_torch")]
    n_files = sum(1 for p in dirs if os.path.isdir(p)
                  for f in os.listdir(p) if not f.startswith("."))
    args = ["--device", "cuda", "--seed", str(FUZZ_SEED), "--runs",
            str(FUZZ_RUNS), "--target-runs",
            f"file_reader={FUZZ_FILE_READER_RUNS}", "--no-save", "--json",
            summary]
    for p in dirs:
        args += ["--replay", p]
    r = subprocess.run([sys.executable, "-m", "tpu_parquet_torch.fuzz",
                        *args], cwd=HERE, env=child_env(),
                       capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise fail(f"phase 20: the fuzz harness exited {r.returncode}: "
                   f"{r.stderr[-4000:]}")
    with open(summary) as f:
        doc = json.load(f)
    os.unlink(summary)
    rep = doc["replay"]
    if rep["files"] != n_files or rep["crashers"]:
        raise fail(f"phase 20: replay of {rep['files']} files (want "
                   f"{n_files}), crashers {rep['failed']}")
    bad = {t: v["crashers"] for t, v in doc["targets"].items()
           if v["crashers"]}
    if bad or len(doc["targets"]) != 25:
        raise fail(f"phase 20: crashers {bad}, targets "
                   f"{sorted(doc['targets'])}")
    launches = doc["launches"]
    if not launches.get("hybrid_unpack_combine"):
        raise fail(f"phase 20: the fused K1 never launched: {launches}")
    wall = time.perf_counter() - t_phase
    log(f"fuzz (a) replay on the card: {rep['files']} corpus files, 0 "
        f"crashers, {rep['seconds']:.3f} s ({smi})")
    log(f"fuzz (b) smoke batch on the card, seed {FUZZ_SEED}: " + ", ".join(
        f"{t} {v['runs']} runs 0 crashers {v['seconds']:.3f} s "
        f"({v['runs'] / v['seconds']:.1f} runs/s)"
        for t, v in doc["targets"].items()) + f" ({smi})")
    log(f"fuzz summary ({smi}): fuzz_launches {launches}; phase 20 wall "
        f"{wall:.2f} s")
    return dict(launched=launches, targets=doc["targets"], replay=rep,
                wall=wall)


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

    # phase 9: the remaining value shapes
    shapes = read_value_shapes(torch, ck, value_shape_groups(draws), work,
                               smi)

    # phase 10: nested columns (rep levels through the fused K1)
    nested = read_nested_phase(torch, ck, draws, work, smi)
    del draws

    # phase 11: the host pipeline (prefetch, staging worker, scan_files)
    pipe = read_pipeline_phase(
        torch, ck, work, smi, l16_path=l16_path, l16_groups=l16_groups,
        l16=l16, pa_layout=pa_layout, k3_path=k3_path, k3_main=k3_main,
        k3_rows=sum(len(g["dates"]) for g in k3_groups))

    # phase 12: filtered and contained scans
    filt = read_filter_phase(torch, ck, work, smi, l16_path=l16_path,
                             l16_groups=l16_groups, k3_path=k3_path,
                             k3_groups=k3_groups, k3_main=k3_main)

    # phase 13: reads through byte stores (retries, torn reads, coalescing,
    # the fetch engine, cancel and deadline, corrupt data, chaos)
    store = read_store_phase(
        torch, ck, work, smi, l16_path=l16_path, l16_groups=l16_groups,
        l16=l16, req_path=req_path, req_groups=groups, k3_path=k3_path,
        k3_groups=k3_groups)

    # phase 14: the read caches (footers, plans, dictionaries, results)
    cache = read_cache_phase(torch, ck, work, smi, l16_path=l16_path,
                             l16=l16, pa_layout=pa_layout)

    # phase 15: obs on the card (every option on, the device lane, the
    # profiles, a hang and a cancel with the collector off)
    obs = read_obs_phase(torch, ck, work, smi, l16_path=l16_path, l16=l16,
                         k3_path=k3_path)

    # phase 16: training input on the card (the loader at two depths,
    # save and restore, shards, against iter_batches, parallel on NCCL,
    # the fleet spool and the ledger)
    loader = read_loader_phase(torch, ck, work, smi)

    # phase 17: the serve tier (a concurrency sweep of device requests, the
    # K3 file, the result cache, tenants, a device stream, faults)
    serve = read_serve_phase(torch, ck, work, smi, l16_path=l16_path,
                             k3_path=k3_path, k3_main=k3_main, loader=loader)

    # phase 18: the write side (the single writer, write_sharded in both
    # layouts, merge_files, compact under a live sweep, floor), read back
    write = read_write_phase(torch, ck, work, smi, l16_path=l16_path,
                             l16_groups=l16_groups, l16=l16)

    # phase 19: the CLI as child processes on the card's files (footer
    # commands at SF1, row commands on a 100,000-row cut, merge, compact,
    # csv2parquet, the obs artifacts), every output read back on the card
    cli = read_cli_phase(torch, ck, work, smi, l16_path=l16_path,
                         l16_groups=l16_groups, l16=l16,
                         members=write["members"], obs=obs)
    del l16_groups
    shutil.rmtree(os.path.dirname(write["members"][0]))

    # phase 20: the fuzz harness in a child process on the card (both
    # corpus directories, the smoke batch of every target)
    fuzz = read_fuzz_phase(work, smi)

    # phase 21: the kernels line and the result line
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
        f"{shapes['counts']['hybrid_unpack_combine']}; nested orders "
        f"{nested['orders']['rows_per_s']:.1f} orders/s "
        f"({nested['orders']['lines_per_s']:.1f} lineitems/s), "
        f"hybrid_unpack_combine {nested['orders']['k1_split']}; nested edge "
        f"shapes {nested['edges']['rows_per_s']:.1f} rows/s, "
        f"hybrid_unpack_combine {nested['edges']['k1_split']}; pipeline "
        f"(K {pipe['k']}) lineitem16 " + ", ".join(
            f"p{p} {v['rows_per_s']:.1f}"
            for p, v in pipe["lineitem16"]["depths"].items())
        + ", pyarrow layout " + ", ".join(
            f"p{p} {v['rows_per_s']:.1f}"
            for p, v in pipe["pyarrow_layout"]["depths"].items())
        + ", K3 file " + ", ".join(
            f"p{p} {v['rows_per_s']:.1f}"
            for p, v in pipe["k3"]["depths"].items())
        + ", scan_files " + ", ".join(
            f"{n} {v:.1f}" for n, v in pipe["scan"].items())
        + f" ({smi})")
    # phases 11's to 20's launches beside each kernel's main-path count
    for entry in kernels:
        entry["pipeline_launches"] = pipe["launched"].get(entry["name"], 0)
        entry["filter_launches"] = filt["launched"].get(entry["name"], 0)
        entry["store_launches"] = store["launched"].get(entry["name"], 0)
        entry["cache_launches"] = cache["launched"].get(entry["name"], 0)
        entry["obs_launches"] = obs["launched"].get(entry["name"], 0)
        entry["loader_launches"] = loader["loader_launches"].get(
            entry["name"], 0)
        entry["serve_launches"] = serve["launched"].get(entry["name"], 0)
        entry["write_launches"] = write["launched"].get(entry["name"], 0)
        entry["cli_launches"] = cli["launched"].get(entry["name"], 0)
        entry["fuzz_launches"] = fuzz["launched"].get(entry["name"], 0)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
