"""pq-tool: inspect and manipulate parquet files.

Command parity with the reference's parquet-tool (cmd/parquet-tool/cmds/):

    cat       print all records              (cat.go:14-27)
    head      print the first N records      (head.go:17-30)
    meta      flat schema + per-column R/D levels + row group info (meta.go)
    schema    print the textual schema definition  (schema.go:16-37)
    rowcount  number of rows from the footer       (rowcount.go:16-37)
    stats     per-row-group column min/max/null_count (beyond the reference)
    split     re-shard into parts of at most a given size (split.go:31-117)
    trace     summarize a TPQ_TRACE run (per-stage p50/p95 incl. the
              device.<route> completion lanes, overlap efficiency, stall
              attribution, ship-route prediction error)
    doctor    rule-based bottleneck attribution of a traced run (link- vs
              host-decompress- vs stall- vs device-resolve- vs h2d-bound,
              naming the dominant device route/kernel), with the
              recalibrated TPQ_LINK_MBPS / TPQ_DEVICE_MBPS when the routes
              disagree with the ship planner's cost model
    autopsy   post-mortem of a flight-recorder dump (the watchdog's or
              TPQ_DUMP_SIGNAL's hang/crash snapshot): stalled lane,
              blocked-thread classification, probable cause
    bench     run-ledger tools: `bench diff A B` (per-metric deltas with
              noise bounds from rep variance + stage attribution) and
              `bench history LEDGER` (one line per recorded run)

trace/doctor/bench-diff arguments may be ledger refs — `latest`, `#N`,
`ledger.jsonl#N` (default ledger: TPQ_LEDGER or ./ledger.jsonl) — so a
post-mortem never requires remembering an artifact path.

cat/head/rowcount take --filter "a > 5 and b == 'x'" for statistics-based
row-group pruning (tpu_parquet_torch.predicate).

Usage: python -m tpu_parquet_torch.cli.pq_tool <command> [options] <file>
"""

from __future__ import annotations

import argparse
import base64
import datetime
import decimal
import json
import sys
import uuid

from ..floor.time import Time
from ..footer import ParquetError
from ..format import CompressionCodec, Type
from ..logical import unwrap_row
from ..reader import FileReader
from ..schema.dsl import schema_to_string
from ..writer import FileWriter


def _json_default(v):
    if isinstance(v, (bytes, bytearray)):
        try:
            return bytes(v).decode("utf-8")
        except UnicodeDecodeError:
            return base64.b64encode(bytes(v)).decode("ascii")
    if isinstance(v, (datetime.datetime, datetime.date, Time)):
        return str(v)
    if isinstance(v, (decimal.Decimal, uuid.UUID)):
        return str(v)
    return repr(v)


def _row_filter(args):
    if getattr(args, "filter", None) is None:
        return None
    from ..predicate import parse_filter

    return parse_filter(args.filter)


def cmd_cat(args, out=sys.stdout) -> int:
    """Shared handler for cat and head (identical modulo the -n default)."""
    from ..floor import Reader

    count = 0
    with Reader(args.file, row_filter=_row_filter(args)) as r:
        for row in r:
            if args.n is not None and count >= args.n:
                break
            out.write(json.dumps(row, default=_json_default) + "\n")
            count += 1
    return 0


def cmd_meta(args, out=sys.stdout) -> int:
    with FileReader(args.file) as r:
        meta = r.metadata
        out.write(f"file: {args.file}\n")
        out.write(f"created by: {meta.created_by}\n")
        out.write(f"rows: {meta.num_rows}\n")
        out.write(f"row groups: {len(meta.row_groups)}\n")
        kv = r.key_value_metadata()
        if kv:
            out.write("key-value metadata:\n")
            for k, v in sorted(kv.items()):
                if k == "ARROW:schema":
                    v = "(arrow schema blob)"
                out.write(f"  {k} = {v}\n")
        out.write("columns:\n")
        name_w = max((len(l.flat_name()) for l in r.schema.leaves), default=4)
        for leaf in r.schema.leaves:
            t = leaf.physical_type
            tname = t.name if t is not None else "group"  # BOOLEAN is enum 0
            out.write(
                f"  {leaf.flat_name():<{name_w}}  type={tname:<22} "
                f"R={leaf.max_rep} D={leaf.max_def}\n"
            )
        for i, rg in enumerate(meta.row_groups):
            out.write(
                f"row group {i}: rows={rg.num_rows} "
                f"bytes={rg.total_byte_size}\n"
            )
            for chunk in rg.columns or []:
                md = chunk.meta_data
                if md is None:
                    continue
                codec = CompressionCodec(md.codec).name
                out.write(
                    f"  {'.'.join(md.path_in_schema):<{name_w}}  "
                    f"values={md.num_values} codec={codec} "
                    f"compressed={md.total_compressed_size} "
                    f"uncompressed={md.total_uncompressed_size}\n"
                )
    return 0


def cmd_schema(args, out=sys.stdout) -> int:
    with FileReader(args.file) as r:
        out.write(schema_to_string(r.schema))
    return 0


def cmd_rowcount(args, out=sys.stdout) -> int:
    with FileReader(args.file, row_filter=_row_filter(args)) as r:
        # surviving groups' total; equals num_rows when no filter is set
        out.write(f"{r.num_selected_rows}\n")
    return 0


def cmd_stats(args, out=sys.stdout) -> int:
    """Per-row-group, per-column statistics (the pruning evidence)."""
    from ..predicate import chunk_stats_range

    def fmt(v):
        if v is None:
            return "-"
        if isinstance(v, bytes):
            try:
                return repr(v.decode("utf-8"))
            except UnicodeDecodeError:
                return v.hex()
        return str(v)

    with FileReader(args.file) as r:
        leaves = {".".join(l.path): l for l in r.schema.leaves}
        name_w = max((len(n) for n in leaves), default=4)
        for i, rg in enumerate(r.metadata.row_groups):
            out.write(f"row group {i}: rows={rg.num_rows}\n")
            for chunk in rg.columns or []:
                md = chunk.meta_data
                if md is None or not md.path_in_schema:
                    continue
                name = ".".join(md.path_in_schema)
                leaf = leaves.get(name)
                if leaf is None:
                    continue
                mn, mx, nulls, _, _ = chunk_stats_range(md, leaf.element)
                out.write(
                    f"  {name:<{name_w}}  min={fmt(mn)} max={fmt(mx)} "
                    f"nulls={fmt(nulls)}\n"
                )
    return 0


def _load_doc(spec: str):
    """Load a command argument to a JSON document: a plain file path, or a
    ledger reference (``latest``, ``#N``, ``ledger.jsonl[#N]`` — see
    ledger.load_side), so post-mortems address runs the way ``bench diff``
    already does instead of remembering artifact paths."""
    from .. import ledger

    if ledger.is_ref(spec):
        return ledger.load_side(spec)
    try:
        with open(spec) as f:
            return json.load(f)
    except json.JSONDecodeError as e:
        raise ValueError(f"{spec}: not JSON ({e})") from None


def _fmt_span_args(args_d: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in args_d.items())


def _write_span_tree(out, tr: dict, indent: str = "") -> None:
    """Emit one trace document's span tree (indentation is nesting)."""
    spans = tr.get("spans") or []
    children: dict = {}
    for i, s in enumerate(spans):
        children.setdefault(s.get("parent", -1), []).append(i)

    def emit(idx: int, depth: int) -> None:
        s = spans[idx]
        d = s.get("dur_s")
        line = (f"{indent}  {'  ' * depth}"
                f"{s.get('name', '?'):<{18 - 2 * min(depth, 6)}} "
                f"@{s.get('t_s', 0) * 1e3:>9.3f}ms "
                + (f"{d * 1e3:>9.3f}ms" if d is not None else f"{'?':>11}"))
        extra = _fmt_span_args(s.get("args") or {})
        out.write(line + (f"  {extra}" if extra else "") + "\n")
        for c in children.get(idx, ()):
            emit(c, depth + 1)

    for root in children.get(-1, ()):
        emit(root, 0)


def _spool_trace_docs(spool_dir: str) -> list:
    """Every trace document published into a fleet spool (each member's
    freshest generation), for stitched multi-process rendering."""
    from ..obs_fleet import FleetAggregator

    snap = FleetAggregator(spool_dir=spool_dir).scan()
    return [t for t in snap.get("traces") or () if isinstance(t, dict)]


def cmd_trace_request(args, out=sys.stdout) -> int:
    """``pq_tool trace --request <id> <dump>``: print one retained
    request's span tree from a tail-sampler dump
    (:meth:`~tpu_parquet_torch.serve.ScanService.trace_dump` /
    ``TailSampler.dump`` output) — indentation is nesting, each line a
    span's start offset, duration, and annotations (retry counts, hedge
    outcomes, cache hits), so a bad exemplar percentile reads as a story:
    which range fetch stalled, which probe missed, where the time went.

    With ``--spool DIR`` the fleet spool's trace docs join the pool (the
    dump file becomes optional) and children that adopted the request's
    exported trace context — loader iterations, ``write_sharded`` encode
    passes, any process that called ``adopt_context`` — render stitched
    under it, labelled ``[host:pid]``: one request, every process."""
    traces: list = []
    label = args.file or ""
    if args.file:
        doc = _load_doc(args.file)
        if isinstance(doc, dict) and isinstance(doc.get("traces"), list):
            traces = [t for t in doc["traces"] if isinstance(t, dict)]
        elif isinstance(doc, dict) and "trace_id" in doc:
            traces = [doc]
        else:
            out.write(f"pq-tool trace: {args.file}: not a trace dump "
                      f"(expected the ScanService.trace_dump / "
                      f"TailSampler.dump format)\n")
            return 1
    spool = getattr(args, "spool", None)
    if spool:
        traces.extend(_spool_trace_docs(spool))
        label = f"{label} + spool {spool}" if label else f"spool {spool}"
    if not args.file and not spool:
        out.write("pq-tool trace: --request needs a dump file and/or "
                  "--spool DIR\n")
        return 1
    want = args.request
    match = [t for t in traces if t.get("trace_id") == want]
    if not match:  # prefix match: ids are long, tails are what users copy
        match = [t for t in traces
                 if str(t.get("trace_id", "")).startswith(want)]
    if not match:
        ids = ", ".join(str(t.get("trace_id")) for t in traces[-8:])
        out.write(f"pq-tool trace: {label}: no retained trace "
                  f"{want!r} ({len(traces)} retained"
                  + (f"; most recent: {ids}" if ids else "")
                  + ") — it may have been evicted (raise TPQ_TRACE_RING) "
                    "or never retained (raise sampling: TPQ_TRACE_TAIL)\n")
        return 1
    tr = match[0]
    dur = tr.get("duration_s")
    origin = (f" [{tr['host']}:{tr['pid']}]"
              if tr.get("host") and tr.get("pid") else "")
    out.write(f"trace {tr.get('trace_id')}{origin}: "
              + (f"{dur * 1e3:.2f}ms" if dur is not None else "?")
              + (f", dropped {tr['dropped']} span(s)"
                 if tr.get("dropped") else "")
              + (f", flags [{', '.join(tr['flags'])}]"
                 if tr.get("flags") else "")
              + "\n")
    err = tr.get("error")
    if err:
        out.write(f"error: {err.get('type')}: {err.get('message')}\n")
    out.write("spans:\n")
    _write_span_tree(out, tr)
    from ..obs_fleet import stitch_traces

    stitched = stitch_traces(traces, str(tr.get("trace_id")))
    for ch in (stitched or {}).get("children") or ():
        cdur = ch.get("duration_s")
        out.write(f"  child [{ch.get('host', '?')}:{ch.get('pid', '?')}] "
                  f"trace {ch.get('trace_id')}: "
                  + (f"{cdur * 1e3:.2f}ms" if cdur is not None else "?")
                  + "\n")
        _write_span_tree(out, ch, indent="    ")
    return 0


def cmd_trace(args, out=sys.stdout) -> int:
    """Render a Chrome trace-event JSON (a ``TPQ_TRACE`` run) as the
    per-stage latency / overlap / stall / route-prediction report — the
    trace made useful without a browser (obs.trace_summary does the math;
    Perfetto / chrome://tracing load the same file for the timeline).

    Also accepts ledger refs (``latest``, ``#N``): the record's env names
    the run's ``TPQ_TRACE`` base, and the per-config artifact
    ``<base>.<config>.json`` (``--config``, default the record's first
    config) is summarized in its place.

    ``--request <trace_id>`` switches modes: the argument is a tail-sampler
    dump and the named retained REQUEST trace prints as a span tree."""
    from ..obs import trace_summary

    if getattr(args, "request", None):
        return cmd_trace_request(args, out)
    if not args.file:
        out.write("pq-tool trace: FILE is required (it is optional only "
                  "with --request --spool)\n")
        return 2
    doc = _load_doc(args.file)
    label = args.file
    if isinstance(doc, dict) and "traceEvents" not in doc and "configs" in doc:
        # a bench/ledger record: resolve its per-config trace artifact
        base = (doc.get("env") or {}).get("TPQ_TRACE")
        if not base:
            out.write(f"pq-tool trace: {args.file}: run was recorded "
                      f"without TPQ_TRACE — no trace artifact to "
                      f"summarize (re-run with TPQ_TRACE=<base>)\n")
            return 1
        cfgs = doc.get("configs") or {}
        cfg = getattr(args, "config", None) or next(iter(cfgs), None)
        if not cfg:
            out.write(f"pq-tool trace: {args.file}: record has no configs\n")
            return 1
        label = f"{base}.{cfg}.json"
        try:
            with open(label) as f:
                doc = json.load(f)
        except FileNotFoundError:
            out.write(f"pq-tool trace: {args.file}: trace artifact "
                      f"{label} not found (moved or cleaned?)\n")
            return 1
        except json.JSONDecodeError as e:
            raise ValueError(f"{label}: not JSON ({e})") from None
    args = argparse.Namespace(**{**vars(args), "file": label})
    s = trace_summary(doc)
    if not s["stages"]:
        # zero spans: the run recorded nothing to summarize — one-line
        # diagnosis, not a table of zeros (or a traceback downstream)
        out.write(f"pq-tool trace: {args.file}: no spans recorded — was the "
                  f"tracer enabled for the run (TPQ_TRACE / trace=)?\n")
        return 1
    out.write(f"trace: {args.file}\n")
    out.write(f"events: {s['events']}  threads: {s['threads']}  "
              f"wall: {s['wall_seconds']:.3f}s\n")
    if s["stages"]:
        name_w = max(max(len(n) for n in s["stages"]), 5)
        out.write(f"{'stage':<{name_w}} {'count':>7} {'total_s':>9} "
                  f"{'p50_ms':>9} {'p95_ms':>9} {'max_ms':>9}\n")
        for name, st in s["stages"].items():
            out.write(
                f"{name:<{name_w}} {st['count']:>7} "
                f"{st['total_seconds']:>9.3f} "
                f"{st['p50_seconds'] * 1e3:>9.3f} "
                f"{st['p95_seconds'] * 1e3:>9.3f} "
                f"{st['max_seconds'] * 1e3:>9.3f}\n")
    out.write(f"overlap efficiency: {s['busy_seconds']:.3f}s busy / "
              f"{s['wall_seconds']:.3f}s wall = "
              f"{s['overlap_efficiency']:.3f}\n")
    out.write(f"stall: {s['stall_seconds']:.3f}s "
              f"({100 * s['stall_share']:.1f}% of wall)\n")
    if s["routes"]:
        out.write(f"ship routes (measured link "
                  f"{s['link_bytes_per_sec'] / 1e6:.1f} MB/s):\n")
        name_w = max(max(len(n) for n in s["routes"]), 5)
        out.write(f"  {'route':<{name_w}} {'streams':>7} {'shipped_mb':>11} "
                  f"{'predicted_s':>12} {'measured_s':>11} {'error':>7}\n")
        for name, r in s["routes"].items():
            meas = r.get("measured_seconds")
            err = r.get("error_ratio")
            out.write(
                f"  {name:<{name_w}} {r['streams']:>7} "
                f"{r['shipped_bytes'] / 1e6:>11.2f} "
                f"{r['predicted_seconds']:>12.4f} "
                + (f"{meas:>11.4f} " if meas is not None else f"{'-':>11} ")
                + (f"{err:>7.2f}" if err is not None else f"{'-':>7}")
                + "\n")
    reg = s.get("registry")
    if not reg:
        # the span tables above still printed; the nonzero exit tells
        # scripts the artifact is registry-less (an atexit-written process
        # trace, or a hand-built one) so `doctor`/`bench diff` can't use it
        out.write(f"pq-tool trace: {args.file}: no embedded registry — "
                  f"write the trace via a reader-owned trace= path (or "
                  f"Tracer.write(registry=...))\n")
        return 1
    pipe = reg.get("pipeline") or {}
    out.write(
        f"embedded registry: obs_version={reg.get('obs_version')} "
        f"chunks={pipe.get('chunks')} "
        f"busy={pipe.get('busy_seconds')}s "
        f"stall={pipe.get('stall_seconds')}s\n")
    return 0


def _load_registry_tree(path, config=None):
    """Resolve a doctor argument to one registry tree.

    Accepts a trace-event document (uses the embedded registry), a bare
    registry tree (``obs_version`` at top level), a bench artifact
    (``configs``: picks ``--config`` or the first config embedding an
    ``obs`` tree), or a ledger record / ledger ref (``latest``, ``#N``,
    ``ledger.jsonl[#N]``).  Returns ``(tree, None)`` or ``(None,
    diagnosis)``.
    """
    doc = _load_doc(path)
    if not isinstance(doc, dict):
        return None, "top level is not an object"
    if "traceEvents" in doc:
        tree = (doc.get("otherData") or {}).get("registry")
        if not tree:
            return None, ("trace has no embedded registry — write it via a "
                          "reader-owned trace= path")
        return tree, None
    if "obs_version" in doc:
        return doc, None
    cfgs = doc.get("configs")
    if isinstance(cfgs, dict):
        names = ([config] if config else
                 [n for n, c in cfgs.items()
                  if isinstance(c, dict) and isinstance(c.get("obs"), dict)])
        for n in names:
            c = cfgs.get(n)
            if isinstance(c, dict) and isinstance(c.get("obs"), dict):
                return c["obs"], None
        return None, (f"config {config!r} has no embedded obs registry"
                      if config else "no config embeds an obs registry")
    return None, "not a trace, registry tree, or bench artifact"


def cmd_doctor(args, out=sys.stdout) -> int:
    """Rule-based bottleneck attribution: which lane bounds this run (link /
    host decompress / stall / device resolve), how sure, and — when the
    measured routes disagree with the ship planner's cost model — the
    recalibrated ``TPQ_LINK_MBPS`` to re-run with.  obs.doctor_registry
    does the math; this renders the verdict."""
    from ..obs import doctor_registry

    tree, why = _load_registry_tree(args.file, getattr(args, "config", None))
    if tree is None:
        out.write(f"pq-tool doctor: {args.file}: {why}\n")
        return 1
    rep = doctor_registry(tree)
    if rep is None:
        out.write(f"pq-tool doctor: {args.file}: registry has no lane "
                  f"seconds to attribute (nothing was decoded?)\n")
        return 1
    out.write(f"doctor: {args.file}\n")
    lanes = rep.get("lanes")
    if lanes:
        out.write("lanes: " + "  ".join(
            f"{k}={lanes[k]:.3f}s"
            for k in sorted(lanes, key=lambda k: -lanes[k])) + "\n")
        out.write(f"verdict: {rep['verdict']} "
                  f"({100 * rep['dominant_share']:.0f}% of lane seconds)\n")
    rm = rep.get("route_model")
    if rm:
        err = rm.get("error_ratio")
        if err is None:
            out.write("route model: chosen routes never measured "
                      "(measured_s null — no staging seconds recorded)\n")
        else:
            side = ("optimistic" if err > 1 else "pessimistic")
            out.write(
                f"route model: predicted {rm['predicted_seconds']:.4f}s, "
                f"measured {rm['measured_seconds']:.4f}s "
                f"(error {err:.2f}x {side}; planner assumed "
                f"{rm['planner_link_mbps'] or '?'} MB/s, measured "
                f"{rm['measured_link_mbps'] or '?'} MB/s)\n")
    recal = rep.get("recalibrate_link_mbps")
    if recal is not None:
        out.write(f"recalibrate: re-run with TPQ_LINK_MBPS={recal:g} "
                  f"(the measured staging rate) to align the planner\n")
    dv = rep.get("device")
    if dv:
        err = dv.get("error_ratio")
        out.write(
            f"device: dominant route {dv['dominant_route']!r}"
            + (f" (kernel {dv['dominant_kernel']})"
               if dv.get("dominant_kernel") else "")
            + f", measured {dv['measured_seconds']:.4f}s"
            + (f", predicted {dv['predicted_seconds']:.4f}s "
               f"(error {err:.2f}x)" if err is not None
               else ", prediction n/a")
            + "\n")
        drecal = rep.get("recalibrate_device_mbps")
        if drecal is not None:
            out.write(f"recalibrate: re-run with TPQ_DEVICE_MBPS={drecal:g} "
                      f"(the measured device-resolve rate) to align the "
                      f"planner's device lane\n")
        fw = rep.get("fusion_win")
        if fw:
            out.write(
                f"fusion-win: {fw['route']!r} measured "
                f"{fw['measured_seconds']:.6f}s vs unfused chain prediction "
                f"{fw['unfused_predicted_seconds']:.6f}s "
                f"({fw['speedup']:.2f}x) — the fused megakernel beats the "
                f"staged chain; keep TPQ_FUSE on for this workload\n")
    else:
        # records predating the device registry section (or runs with
        # TPQ_DEVICE_TIMING=0): explicitly n/a, never a KeyError
        out.write("device: n/a (no device section — record predates device "
                  "timing, or TPQ_DEVICE_TIMING=0)\n")
    ct = rep.get("cache")
    if ct:
        top = ct.get("top_evict_file")
        knob = ct.get("budget_knob") or "TPQ_RESULT_CACHE_MB"
        out.write(f"cache-thrash: {ct['tier']} tier churning "
                  f"({ct['evictions']} evictions at "
                  f"{100 * ct['hit_rate']:.0f}% hit rate"
                  + (f"; top evictor {top} x{ct['top_evict_count']}"
                     if top else "")
                  + f") — the working set exceeds "
                    f"{ct['capacity_bytes']} bytes; raise {knob} or shard "
                    f"the hot set\n")
    co = rep.get("circuit_open")
    if co:
        out.write(f"circuit-open: {', '.join(co['files']) or '?'} "
                  f"({co['opened']} trip(s), {co['fast_fails']} fast-fail(s)"
                  f") — the named file keeps failing; inspect or replace "
                  f"it, healthy traffic is unaffected\n")
    ov = rep.get("overload")
    if ov:
        sheds = ov.get("sheds") or {}
        hint = ov.get("retry_after_hint_s")
        out.write(f"overload: {ov['rejected']} rejected, "
                  f"{sheds.get('low', 0)}+{sheds.get('normal', 0)} shed"
                  + (f"; offender '{ov['offending_tenant']}' "
                     f"(demand {ov['offender_demand']})"
                     if ov.get("offending_tenant") else "")
                  + (f"; victims {', '.join(ov['victims'])}"
                     if ov.get("victims") else "")
                  + (f"; retry-after {hint:g}s" if hint else "")
                  + f" — {ov['advice']}\n")
    sb = rep.get("slo_burn")
    if sb:
        out.write(f"slo-burn: tenant {sb['tenant']!r} p99 "
                  f"{sb['p99_ms']:.2f}ms vs slo {sb['slo_p99_ms']:g}ms "
                  f"({sb['burn_ratio']:.1f}x), offending bucket le "
                  f"{sb['bucket_le_s'] * 1e3:g}ms"
                  + (f", exemplar trace {sb['exemplar_trace']}"
                     if sb.get("exemplar_trace") else "")
                  + (f" ({sb['exemplar_value_s'] * 1e3:.2f}ms)"
                     if sb.get("exemplar_value_s") is not None else "")
                  + f" — {sb['advice']}\n")
        burning = sb.get("burning_tenants") or []
        if len(burning) > 1:
            out.write(f"slo-burn: {len(burning)} tenants over target "
                      f"({', '.join(burning)}); worst burn shown\n")
    hg = rep.get("hedge")
    if hg:
        out.write(f"hedge-ineffective: {hg['won']}/{hg['issued']} hedges "
                  f"won ({100 * hg['win_rate']:.0f}%) for "
                  f"{hg['wasted_bytes']} wasted bytes — the hedge delay "
                  f"sits below the real p90; raise TPQ_IO_HEDGE_MS or let "
                  f"auto re-learn\n")
    ioc = rep.get("io_concurrency")
    if ioc:
        out.write(f"io-concurrency-bound: in-flight peak "
                  f"{ioc['inflight_peak']}/{ioc['inflight_cap']} cap, "
                  f"slot queue-wait {ioc['queue_wait_seconds']:.3f}s vs "
                  f"fetch {ioc['fetch_seconds']:.3f}s — {ioc['advice']}\n")
    wrt = rep.get("write")
    if wrt:
        wl = wrt["lanes"]
        out.write("write: " + "  ".join(
            f"{k}={wl[k]:.3f}s"
            for k in sorted(wl, key=lambda k: -wl[k])) + "\n")
        out.write(f"write verdict: {wrt['verdict']} "
                  f"({100 * wrt['dominant_share']:.0f}% of write lane "
                  f"seconds; {wrt['rows_per_sec']:.0f} rows/s, "
                  f"{wrt['bytes_per_sec'] / 1e6:.1f} MB/s)\n")
    return 0


def cmd_metrics(args, out=sys.stdout) -> int:
    """Live metrics plumbing over registry snapshots (the JSON trees
    ``TPQ_METRICS_DUMP`` writes, or any input ``doctor`` accepts):

    - one snapshot: render the OpenMetrics text exposition (counters,
      gauges, ``_bucket``/``_sum``/``_count`` histogram families with
      trace-id exemplars) — what a scraper would ingest;
    - two snapshots: the numeric counter deltas A → B;
    - ``--watch``: poll the snapshot file and print deltas as they land
      (``--count`` bounds the polls for scripting);
    - ``--spool DIR``: aggregate a fleet spool instead of reading a file
      and render the fleet exposition, every per-process series labelled
      ``host``/``pid``/``role`` — one scrape, the whole fleet."""
    from ..obs import diff_registry_trees, render_openmetrics

    def load(spec):
        tree, why = _load_registry_tree(spec, getattr(args, "config", None))
        if tree is None:
            raise ValueError(f"{spec}: {why}")
        return tree

    spool = getattr(args, "spool", None)
    if spool:
        from ..obs_fleet import FleetAggregator, render_fleet_openmetrics

        snap = FleetAggregator(spool_dir=spool).scan()
        if not snap["processes"]:
            out.write(f"pq-tool metrics: {spool}: no spool members\n")
            return 1
        out.write(render_fleet_openmetrics(snap))
        return 0
    if not getattr(args, "file", None):
        out.write("pq-tool metrics: FILE is required (it is optional only "
                  "with --spool DIR)\n")
        return 2

    def write_diff(old, new, indent="  "):
        d = diff_registry_trees(old, new)
        if not d:
            out.write(f"{indent}(no numeric changes)\n")
            return
        w = max(len(p) for p in d)
        for path in sorted(d):
            o, n, delta = d[path]
            out.write(f"{indent}{path:<{w}}  {o:g} -> {n:g}  ({delta:+g})\n")

    if getattr(args, "watch", False):
        import time as _time

        interval = max(float(args.interval), 0.01)
        out.write(f"metrics: watching {args.file} "
                  f"(interval {interval:g}s"
                  + (f", {args.count} poll(s)" if args.count else "")
                  + ")\n")
        prev = None
        polls = 0
        while args.count is None or polls < args.count:
            if polls:
                _time.sleep(interval)
            polls += 1
            try:
                tree = load(args.file)
            except (OSError, ValueError):
                continue  # dumper mid-replace or not written yet: next poll
            if prev is not None and tree != prev:
                out.write(f"poll {polls}:\n")
                write_diff(prev, tree)
            prev = tree
        return 0
    try:
        if getattr(args, "file2", None):
            old, new = load(args.file), load(args.file2)
            out.write(f"metrics diff: {args.file} -> {args.file2}\n")
            write_diff(old, new)
            return 0
        out.write(render_openmetrics(load(args.file)))
        return 0
    except (OSError, ValueError) as e:
        out.write(f"pq-tool metrics: {e}\n")
        return 1


def cmd_autopsy(args, out=sys.stdout) -> int:
    """Post-mortem of a flight-recorder dump (a hang/crash snapshot written
    by the watchdog, ``TPQ_DUMP_SIGNAL``, a worker crash, or the explicit
    API): which lane stopped advancing first, which threads are blocked on
    which lock/queue, the longest budget-wait age, each thread's last
    recorded event, and a one-line probable cause — the ``doctor`` verdict
    style, for runs that never finished (obs.autopsy_dump does the math)."""
    from ..obs import autopsy_dump

    doc = _load_doc(args.file)
    try:
        rep = autopsy_dump(doc)
    except ValueError as e:
        out.write(f"pq-tool autopsy: {args.file}: {e}\n")
        return 1
    out.write(f"autopsy: {args.file} (reason: {rep['reason']}, "
              f"pid {rep['pid']})\n")
    ages = rep["ages"]
    if rep["stalled_first"] is not None:
        out.write(f"stalled first: {rep['stalled_first']} "
                  f"(no advance for {ages.get(rep['stalled_first'], '?')}s "
                  f"of a {rep['hang_s']}s deadline)\n")
    if ages:
        worst = sorted(ages.items(), key=lambda kv: -kv[1])[:6]
        out.write("lane ages: " + "  ".join(
            f"{k}={v:g}s" for k, v in worst) + "\n")
    threads = rep["threads"]
    if threads:
        name_w = max(max(len(t["name"]) for t in threads.values()), 6)
        out.write("threads:\n")
        for _tid, t in sorted(threads.items(),
                              key=lambda kv: kv[1]["name"]):
            last = t["last_event"]
            tail = (f"  last: {last['name']} {last['age_s']:g}s ago"
                    if last else "")
            dead = "" if t["alive"] else "  [DEAD]"
            out.write(f"  {t['name']:<{name_w}}  {t['class']}{dead}{tail}\n")
    b = rep.get("budget")
    if b:
        out.write(f"budget: {b['waiters']} waiter(s), longest wait "
                  f"{b['longest_wait_s']:g}s\n")
    io = rep.get("io")
    if io:
        out.write(f"io: range at offset {io['offset']} ({io['size']} bytes) "
                  f"in flight for {io['age_s']:g}s\n")
    sv = rep.get("serve")
    if sv:
        stuck = sv.get("stuck_request")
        tail = (f"; stuck request #{stuck['id']} over {stuck['path']!r} "
                f"({stuck['age_s']:g}s in flight)" if stuck else "")
        out.write(f"serve: {sv.get('in_flight', 0)} in flight, queue depth "
                  f"{sv.get('queue_depth', 0)}{tail}\n")
        for c in sv.get("circuit_open") or []:
            out.write(f"circuit: OPEN for {c['file']!r} (next probe in "
                      f"{c.get('retry_after_s', '?')}s)\n")
    de = rep.get("data_errors")
    if de:
        first = de.get("first") or {}
        where = (f" — first bad: file {first.get('file')!r} column "
                 f"{first.get('column')!r} row_group "
                 f"{first.get('row_group')} page {first.get('page')}"
                 if first else "")
        out.write(f"data: {de['errors']} quarantined error(s){where}\n")
    err = rep.get("error")
    if err:
        out.write(f"error: {err.get('type')}: {err.get('message')}\n")
    out.write(f"verdict: {rep['verdict']}\n")
    out.write(f"probable cause: {rep['probable_cause']}\n")
    return 0


def cmd_serve_stats(args, out=sys.stdout) -> int:
    """Summarize a scan service run's ``serve`` registry section: request/
    rejection counters, queue depth, plan-cache hit rates, and the
    per-request latency SLO table (p50/p95 from the ``serve.*``
    histograms).  Accepts the same inputs as ``doctor`` (registry tree,
    trace artifact, bench artifact, ledger ref) plus flight dumps."""
    from ..obs import LatencyHistogram

    tree, why = _load_registry_tree(args.file, getattr(args, "config", None))
    if tree is None:
        doc = _load_doc(args.file)
        if isinstance(doc, dict) and isinstance(doc.get("registry"), dict):
            tree, why = doc["registry"], None  # a flight dump's snapshot
    if tree is None:
        out.write(f"pq-tool serve-stats: {args.file}: {why}\n")
        return 1
    sv = tree.get("serve")
    if not isinstance(sv, dict):
        out.write(f"pq-tool serve-stats: {args.file}: registry has no "
                  f"`serve` section (run was not served through a "
                  f"ScanService)\n")
        return 1
    out.write(f"serve-stats: {args.file}\n")
    out.write(f"requests: {sv.get('submitted', 0)} submitted, "
              f"{sv.get('completed', 0)} completed, "
              f"{sv.get('rejected', 0)} rejected (overload), "
              f"{sv.get('failed', 0)} failed\n")
    out.write(f"queue: depth peak {sv.get('queue_depth_peak', 0)}, "
              f"total wait {float(sv.get('queue_wait_seconds', 0)):.4f}s, "
              f"total exec {float(sv.get('exec_seconds', 0)):.4f}s\n")
    sheds = sv.get("sheds") or {}
    dl, cn = sv.get("deadline_exceeded", 0), sv.get("cancelled", 0)
    if any(sheds.values()) or dl or cn:
        out.write(f"lifecycle: {dl} deadline-exceeded, {cn} cancelled, "
                  f"shed {sheds.get('low', 0)} low / "
                  f"{sheds.get('normal', 0)} normal priority (brownout)\n")
    if sv.get("retry_after_hint_s"):
        out.write(f"overload: last retry-after hint "
                  f"{float(sv['retry_after_hint_s']):.3f}s (callers should "
                  f"back off at least this long)\n")
    if sv.get("stream_sessions"):
        out.write(f"streaming: {sv.get('stream_sessions', 0)} session(s), "
                  f"{sv.get('stream_batches', 0)} batch(es) emitted\n")
    circ = sv.get("circuit") or {}
    if any(v for k, v in circ.items() if k != "open_files"):
        files = circ.get("open_files") or []
        out.write(f"circuit: {circ.get('open_now', 0)} open now"
                  + (f" ({', '.join(str(f) for f in files)})" if files
                     else "")
                  + f", {circ.get('opened', 0)} opened / "
                    f"{circ.get('reopened', 0)} reopened / "
                    f"{circ.get('closed', 0)} closed, "
                    f"{circ.get('fast_fails', 0)} fast-fails\n")
    io_sec = tree.get("io") or {}
    if io_sec.get("hedges_issued"):
        issued = int(io_sec.get("hedges_issued", 0))
        won = int(io_sec.get("hedges_won", 0))
        out.write(f"hedges: {issued} issued, {won} won "
                  f"({100 * won / issued:.0f}%), "
                  f"{io_sec.get('hedges_wasted_bytes', 0)} wasted bytes, "
                  f"{io_sec.get('hedge_mismatches', 0)} mismatches\n")
    cache = sv.get("cache") or {}
    if cache:
        def rate(kind):
            h = int(cache.get(f"{kind}_hits", 0))
            m = int(cache.get(f"{kind}_misses", 0))
            return f"{kind} {h}/{h + m}" + (
                f" ({100 * h / (h + m):.0f}%)" if h + m else "")

        out.write("cache hits: " + "  ".join(
            rate(k) for k in ("footer", "plan", "dict"))
            + f"  [{cache.get('held_bytes', 0)} B held, "
              f"{cache.get('evictions', 0)} evicted, "
              f"{cache.get('invalidations', 0)} invalidated]\n")
    rcache = tree.get("cache") or {}
    for tier in ("host", "device"):
        tc = rcache.get(tier)
        if not isinstance(tc, dict):
            continue
        h, m = int(tc.get("hits", 0)), int(tc.get("misses", 0))
        if not (h + m or tc.get("entries")):
            continue
        out.write(
            f"result cache [{tier}]: {h}/{h + m} hits"
            + (f" ({100 * h / (h + m):.0f}%)" if h + m else "")
            + f", {tc.get('held_bytes', 0)}/{tc.get('capacity_bytes', 0)} B"
              f" held, {tc.get('entries', 0)} entries, "
              f"{tc.get('evictions', 0)} evicted, "
              f"{tc.get('invalidations', 0)} invalidated\n")
    if rcache.get("single_flight_waits"):
        out.write(f"result cache: {rcache['single_flight_waits']} "
                  f"single-flight wait(s) (concurrent first-touches "
                  f"served by one decode)\n")
    hists = tree.get("histograms") or {}
    tenants = {n: t for n, t in (sv.get("tenants") or {}).items()
               if isinstance(t, dict)}
    # one-tenant registries are the untenanted default — the table only
    # earns its lines when QoS is actually partitioning the service
    if len(tenants) > 1 or any(t.get("rejected") or t.get("sheds", {}).get(
            "low") or t.get("sheds", {}).get("normal")
            for t in tenants.values()):
        out.write("tenants:\n")
        out.write(f"  {'name':<16}{'weight':>7}{'submit':>8}{'done':>7}"
                  f"{'reject':>8}{'shed':>6}{'cacheB':>10}{'p99':>12}\n")
        for name in sorted(tenants):
            t = tenants[name]
            tsheds = t.get("sheds") or {}
            shed = int(tsheds.get("low", 0)) + int(tsheds.get("normal", 0))
            hd = hists.get(f"serve.tenant.{name}")
            if isinstance(hd, dict):
                q99 = LatencyHistogram.from_dict(hd).quantile(0.99) * 1e3
                p99 = f"{q99:>10.2f}ms"
            else:
                p99 = f"{'-':>12}"
            slo_ms = t.get("slo_p99_ms")
            ddl = t.get("deadline_s")
            out.write(f"  {name:<16}{t.get('weight', 1):>7}"
                      f"{t.get('submitted', 0):>8}{t.get('completed', 0):>7}"
                      f"{t.get('rejected', 0):>8}{shed:>6}"
                      f"{t.get('cache_held_bytes', 0):>10}{p99}"
                      + (f"  (slo {float(slo_ms):g}ms)" if slo_ms else "")
                      + (f"  (deadline {float(ddl):g}s)" if ddl else "")
                      + "\n")
    slo = [(name.split(".", 1)[1], LatencyHistogram.from_dict(hd))
           for name, hd in sorted(hists.items())
           if name.startswith("serve.")]
    if slo:
        out.write("latency (per request):\n")
        out.write(f"  {'lane':<12}{'count':>7}{'p50':>12}{'p95':>12}"
                  f"{'p99':>12}{'max':>12}\n")
        for lane, h in slo:
            out.write(f"  {lane:<12}{h.count:>7}"
                      f"{h.quantile(0.5) * 1e3:>10.2f}ms"
                      f"{h.quantile(0.95) * 1e3:>10.2f}ms"
                      f"{h.quantile(0.99) * 1e3:>10.2f}ms"
                      f"{h.max_seconds * 1e3:>10.2f}ms\n")
    # exemplar rows: the percentile-to-trace link — each populated bucket's
    # most recent RETAINED trace id (pq_tool trace --request fetches it)
    ex_rows = []
    for name, hd in sorted(hists.items()):
        if not name.startswith("serve.") or not isinstance(hd, dict):
            continue
        for b, ex in sorted((hd.get("exemplars") or {}).items(),
                            key=lambda kv: int(kv[0])):
            ex_rows.append((name.split(".", 1)[1], int(b), ex))
    if ex_rows:
        out.write("exemplars (bucket -> retained trace):\n")
        for lane, b, ex in ex_rows:
            le = LatencyHistogram.bucket_upper_seconds(b) * 1e3
            out.write(f"  {lane:<16} le={le:g}ms  {ex[0]}  "
                      f"({float(ex[1]) * 1e3:.3f}ms)\n")
    trc = sv.get("trace") or {}
    if trc.get("offered"):
        out.write(f"tracing: {trc.get('offered', 0)} offered, "
                  f"{trc.get('retained', 0)} retained, "
                  f"{trc.get('evicted', 0)} evicted, "
                  f"{trc.get('retained_bytes', 0)}/"
                  f"{trc.get('ring_capacity_bytes', 0)} B ring\n")
    return 0


def _render_fleet_top(snap, out) -> int:
    """One ``pq_tool top`` frame from a :meth:`FleetAggregator.scan`
    snapshot: per-process lanes/queue/cache table, the merged tenant
    table, then active fleet verdicts."""
    from ..obs import LatencyHistogram
    from ..obs_fleet import doctor_fleet, process_lanes

    procs = snap.get("processes") or {}
    if not procs:
        out.write(f"pq-tool top: {snap.get('spool_dir')}: no spool members "
                  f"yet — processes publish once TPQ_OBS_SPOOL points here\n")
        return 1
    stale_n = sum(1 for p in procs.values() if p.get("stale"))
    out.write(f"fleet top — {snap.get('spool_dir')} — {len(procs)} "
              f"process(es), {stale_n} stale, "
              f"{snap.get('rejected', 0)} rejected file(s)\n")
    name_w = max(max(len(n) for n in procs), 7) + 2
    out.write(f"{'process':<{name_w}}{'role':<8}{'hb':>8}{'queue':>7}"
              f"{'cache%':>8}{'lane_s':>9}  dominant lane\n")
    for name in sorted(procs):
        p = procs[name]
        tree = p.get("registry") or {}
        lanes = {k: v for k, v in process_lanes(tree).items() if v > 0}
        total = sum(lanes.values())
        sv = tree.get("serve") or {}
        cache = sv.get("cache") or {}
        hits = sum(int(cache.get(f"{k}_hits", 0))
                   for k in ("footer", "plan", "dict"))
        miss = sum(int(cache.get(f"{k}_misses", 0))
                   for k in ("footer", "plan", "dict"))
        rate = f"{100 * hits / (hits + miss):.0f}" if hits + miss else "-"
        age = p.get("heartbeat_age_s")
        hb = ("STALE" if p.get("stale")
              else f"{age:.1f}s" if age is not None else "?")
        dom = max(lanes, key=lanes.get) if lanes else None
        out.write(f"{name:<{name_w}}{p.get('role', '?'):<8}{hb:>8}"
                  f"{sv.get('queue_depth', 0):>7}{rate:>8}{total:>9.3f}  "
                  + (f"{dom} ({lanes[dom]:.3f}s)" if dom else "-") + "\n")
    merged = snap.get("registry") or {}
    msv = merged.get("serve") or {}
    tenants = {n: t for n, t in (msv.get("tenants") or {}).items()
               if isinstance(t, dict)}
    if tenants:
        hists = merged.get("histograms") or {}
        out.write("tenants (fleet-merged):\n")
        out.write(f"  {'name':<16}{'weight':>7}{'submit':>8}{'done':>7}"
                  f"{'reject':>8}{'p99':>12}\n")
        for name in sorted(tenants):
            t = tenants[name]
            hd = hists.get(f"serve.tenant.{name}")
            if isinstance(hd, dict):
                q99 = LatencyHistogram.from_dict(hd).quantile(0.99) * 1e3
                p99 = f"{q99:>10.2f}ms"
            else:
                p99 = f"{'-':>12}"
            out.write(f"  {name:<16}{t.get('weight', 1):>7}"
                      f"{t.get('submitted', 0):>8}{t.get('completed', 0):>7}"
                      f"{t.get('rejected', 0):>8}{p99}\n")
    rep = doctor_fleet(snap)
    verdicts = (rep or {}).get("verdicts") or []
    if not verdicts:
        out.write("verdicts: none\n")
        return 0
    out.write("verdicts:\n")
    for v in verdicts:
        kind = v.get("verdict")
        if kind == "straggler":
            out.write(f"  straggler: {v.get('process')} ({v.get('role')}) — "
                      f"dominant lane {v.get('dominant_lane')}, "
                      f"{float(v.get('deviation', 0)):.2f}x the fleet "
                      f"median lane-seconds\n")
        elif kind == "dead-process":
            out.write(f"  dead-process: {v.get('process')} "
                      f"({v.get('role')}) — heartbeat "
                      f"{float(v.get('heartbeat_age_s', 0)):.1f}s old "
                      f"(stale after {float(v.get('stale_after_s', 0)):g}s)\n")
        elif kind == "slo-burn":
            out.write(f"  slo-burn: tenant {v.get('tenant')} p99 "
                      f"{float(v.get('p99_ms', 0)):.1f}ms over its "
                      f"{float(v.get('slo_p99_ms', 0)):g}ms budget "
                      f"(x{float(v.get('burn_ratio', 0)):.2f}"
                      + (f"; exemplar {v['exemplar_trace']} retained by "
                         f"{v.get('exemplar_process') or '?'}"
                         if v.get("exemplar_trace") else "")
                      + ")\n")
        else:
            out.write(f"  {kind}: {v.get('advice', v)}\n")
    return 0


def cmd_top(args, out=sys.stdout) -> int:
    """``pq_tool top <spool_dir>``: the live fleet dashboard — every
    process publishing into a ``TPQ_OBS_SPOOL`` directory on one screen
    (throughput lanes, queue depths, cache hit rates, merged tenant
    table, active ``straggler``/``dead-process``/``slo-burn`` verdicts),
    refreshed in place with plain ANSI.  ``--once`` renders a single
    frame and exits (tests/CI); ``--count`` bounds the refresh loop."""
    import time as _time

    from ..obs_fleet import FleetAggregator

    agg = FleetAggregator(spool_dir=args.spool,
                          stale_s=getattr(args, "stale", None))
    if args.once:
        return _render_fleet_top(agg.scan(), out)
    polls = 0
    rc = 0
    try:
        while args.count is None or polls < args.count:
            if polls:
                _time.sleep(max(float(args.interval), 0.05))
            polls += 1
            out.write("\x1b[2J\x1b[H")  # clear + home — the whole protocol
            rc = _render_fleet_top(agg.scan(), out)
            if hasattr(out, "flush"):
                out.flush()
    except KeyboardInterrupt:
        pass
    return rc


def cmd_quarantine(args, out=sys.stdout) -> int:
    """Summarize a run's quarantine ledger (the JSONL ``TPQ_QUARANTINE_LOG``
    wrote, one record per contained data error): totals, per-file /
    per-column / per-error-class breakdowns, and the first bad
    (file, column, page) — the fleet-scale view of a degraded run."""
    from ..quarantine import summarize_quarantine_log

    records = []
    try:
        with open(args.file) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError as e:
                    out.write(f"pq-tool quarantine: {args.file}:{ln}: "
                              f"bad record: {e}\n")
                    return 1
    except OSError as e:
        out.write(f"pq-tool quarantine: {args.file}: {e}\n")
        return 1
    rep = summarize_quarantine_log(records)
    if not rep["records"]:
        out.write(f"quarantine: {args.file}: no records — the run "
                  f"contained no data errors\n")
        return 0
    out.write(f"quarantine: {args.file}: {rep['records']} record(s) "
              f"across {rep['files']} file(s)\n")
    first = rep["first"] or {}
    out.write(f"first bad: file {first.get('file')!r} column "
              f"{first.get('column')!r} row_group {first.get('row_group')} "
              f"page {first.get('page')} ({first.get('error')}: "
              f"{str(first.get('message'))[:120]})\n")
    for title, key in (("by file", "by_file"), ("by column", "by_column"),
                       ("by error", "by_class")):
        rows = rep[key]
        if rows:
            out.write(f"{title}:\n")
            for name, n in list(rows.items())[:12]:
                out.write(f"  {n:>6}  {name}\n")
            if len(rows) > 12:
                out.write(f"  ... and {len(rows) - 12} more\n")
    return 0


def cmd_bench_diff(args, out=sys.stdout) -> int:
    """Noise-aware comparison of two recorded runs (ledger entries or bench
    artifacts); exits 1 when a metric regressed beyond its noise bound."""
    from .. import ledger

    a = ledger.load_side(args.a)
    b = ledger.load_side(args.b)
    d = ledger.diff(a, b, floor=args.floor)
    out.write(ledger.format_diff(d, args.a, args.b))
    return 1 if d["regressions"] else 0


def cmd_bench_history(args, out=sys.stdout) -> int:
    from .. import ledger

    records = ledger.read(args.ledger)
    start = 0
    if args.n and len(records) > args.n:
        out.write(f"(showing last {args.n} of {len(records)} runs)\n")
        start = len(records) - args.n
        records = records[start:]
    out.write(ledger.format_history(records, args.ledger, start=start))
    return 0


def parse_human_size(s: str) -> int:
    """'100MB', '1GiB', '4096' → bytes (helpers.go:10-40 parity)."""
    s = s.strip()
    units = {
        "": 1, "B": 1,
        "KB": 1000, "MB": 1000**2, "GB": 1000**3, "TB": 1000**4,
        "KIB": 1024, "MIB": 1024**2, "GIB": 1024**3, "TIB": 1024**4,
        "K": 1024, "M": 1024**2, "G": 1024**3,
    }
    num = s
    unit = ""
    for i, ch in enumerate(s):
        if not (ch.isdigit() or ch == "."):
            num, unit = s[:i], s[i:]
            break
    try:
        value = float(num)
        mult = units[unit.strip().upper()]
    except (ValueError, KeyError):
        raise ValueError(f"cannot parse size {s!r}") from None
    return int(value * mult)


def cmd_split(args, out=sys.stdout) -> int:
    max_size = parse_human_size(args.size)
    src = args.file
    with FileReader(src) as r:
        schema = r.schema
        part = 0
        writer = None
        written = 0

        def open_part():
            nonlocal writer, part, written
            path = args.output_pattern.format(part)
            writer = FileWriter(path, schema, codec=args_codec)
            out.write(f"writing {path}\n")
            part += 1
            written = 0
            return writer

        args_codec = getattr(CompressionCodec, args.codec.upper())
        writer = None
        for raw in r.iter_rows():
            if writer is not None and (
                writer.current_file_size + writer.current_row_group_size >= max_size
            ):
                writer.close()
                writer = None
            if writer is None:
                writer = open_part()  # opened lazily: no empty trailing parts
            writer.write_row(raw)
        if writer is None:
            writer = open_part()  # empty input still produces one valid file
        writer.close()
    return 0


def cmd_merge(args, out=sys.stdout) -> int:
    """Footer-merge N parquet files into one: row groups relocated with
    corrected offsets, data bytes copied untouched (CRCs ride along),
    atomic publish.  The write-side inverse of ``split``."""
    from ..write import WriteStats, merge_files

    st = WriteStats()
    meta = merge_files(args.output, args.inputs, stats=st)
    out.write(f"merged {len(args.inputs)} file(s) -> {args.output}: "
              f"{meta.num_rows} rows in {len(meta.row_groups)} row "
              f"group(s), {st.bytes_written} bytes\n")
    return 0


def cmd_compact(args, out=sys.stdout) -> int:
    """Compact a dataset (manifest dir or file list) into few large files:
    codec re-planned through the ship planner, CRCs always written,
    atomic manifest publish with a generation bump."""
    from ..write import compact

    rep = compact(
        args.dataset if len(args.dataset) > 1 else args.dataset[0],
        out=args.out,
        target_file_bytes=parse_human_size(args.target_size),
        workers=args.workers,
        remove_inputs=args.remove_inputs,
    )
    d = rep.as_dict()
    out.write(
        f"compacted {d['files_before']} file(s) ({d['bytes_before']} B, "
        f"{d['row_groups_before']} row groups) -> {d['files_after']} "
        f"file(s) ({d['bytes_after']} B, {d['row_groups_after']} row "
        f"groups), {d['rows']} rows\n")
    out.write(
        f"link bytes (ship-planner model): {d['link_bytes_before']} -> "
        f"{d['link_bytes_after']} (ratio {d['link_bytes_ratio']:.3f})\n")
    if rep.manifest_path:
        out.write(f"published: {rep.manifest_path} "
                  f"(generation {rep.generation})\n")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pq-tool", description="Inspect and manipulate parquet files"
    )
    sub = p.add_subparsers(dest="command", required=True)

    FILTER_HELP = ("row-group pruning predicate, e.g. \"a > 5 and b == 'x'\" "
                   "(skips groups whose stats cannot match)")
    c = sub.add_parser("cat", help="print all records as JSON lines")
    c.add_argument("-n", type=int, default=None, help="limit record count")
    c.add_argument("--filter", default=None, help=FILTER_HELP)
    c.add_argument("file")
    c.set_defaults(func=cmd_cat)

    h = sub.add_parser("head", help="print the first N records")
    h.add_argument("-n", type=int, default=5)
    h.add_argument("--filter", default=None, help=FILTER_HELP)
    h.add_argument("file")
    h.set_defaults(func=cmd_cat)

    m = sub.add_parser("meta", help="print file metadata")
    m.add_argument("file")
    m.set_defaults(func=cmd_meta)

    s = sub.add_parser("schema", help="print the schema definition")
    s.add_argument("file")
    s.set_defaults(func=cmd_schema)

    rc = sub.add_parser("rowcount", help="print the number of rows")
    rc.add_argument("--filter", default=None,
                    help=FILTER_HELP + "; prints surviving groups' row total")
    rc.add_argument("file")
    rc.set_defaults(func=cmd_rowcount)

    st = sub.add_parser("stats",
                        help="per-row-group column min/max/null statistics")
    st.add_argument("file")
    st.set_defaults(func=cmd_stats)

    tr = sub.add_parser(
        "trace", help="summarize a TPQ_TRACE run (Chrome trace-event JSON, "
                      "or a ledger ref: latest, #N, ledger.jsonl#N)")
    tr.add_argument("file", nargs="?", default=None,
                    help="trace/dump file (optional with --request --spool)")
    tr.add_argument("--config", default=None,
                    help="ledger-ref input: which config's trace artifact "
                         "to summarize (default: the record's first)")
    tr.add_argument("--request", default=None, metavar="TRACE_ID",
                    help="FILE is a tail-sampler dump (ScanService."
                         "trace_dump): print the named retained request's "
                         "span tree (prefix match accepted)")
    tr.add_argument("--spool", default=None, metavar="DIR",
                    help="--request: also pool the fleet spool's trace docs "
                         "(TPQ_OBS_SPOOL dir) and render child-process "
                         "traces stitched under the request")
    tr.set_defaults(func=cmd_trace)

    dr = sub.add_parser(
        "doctor",
        help="bottleneck attribution of a traced run (trace / registry / "
             "bench artifact / ledger ref: latest, #N, ledger.jsonl#N) "
             "+ TPQ_LINK_MBPS recalibration")
    dr.add_argument("file")
    dr.add_argument("--config", default=None,
                    help="bench-artifact input: which config's registry to "
                         "diagnose (default: first with an obs tree)")
    dr.set_defaults(func=cmd_doctor)

    au = sub.add_parser(
        "autopsy",
        help="post-mortem of a flight-recorder dump (hang/crash snapshot): "
             "stalled lane, blocked-thread classes, probable cause")
    au.add_argument("file")
    au.set_defaults(func=cmd_autopsy)

    qa = sub.add_parser(
        "quarantine",
        help="summarize a quarantine ledger (TPQ_QUARANTINE_LOG JSONL)")
    qa.add_argument("file", help="quarantine JSONL path")
    qa.set_defaults(func=cmd_quarantine)

    ss = sub.add_parser(
        "serve-stats",
        help="summarize a ScanService run's `serve` registry section: "
             "queue depth, cache hit rates, per-request p50/p95 SLO table")
    ss.add_argument("file", help="registry/trace/bench artifact, flight "
                                 "dump, or ledger ref")
    ss.add_argument("--config", default=None,
                    help="bench-artifact input: which config's registry to "
                         "summarize")
    ss.set_defaults(func=cmd_serve_stats)

    tp = sub.add_parser(
        "top",
        help="live fleet dashboard over a TPQ_OBS_SPOOL directory: "
             "per-process lanes/queues/caches, tenant table, verdicts")
    tp.add_argument("spool", help="fleet spool directory (TPQ_OBS_SPOOL)")
    tp.add_argument("--once", action="store_true",
                    help="render one frame and exit (tests/CI)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval seconds (default 2)")
    tp.add_argument("--count", type=int, default=None,
                    help="stop after N refreshes (default: forever)")
    tp.add_argument("--stale", type=float, default=None,
                    help="heartbeat staleness threshold seconds "
                         "(default TPQ_OBS_STALE_S / 10)")
    tp.set_defaults(func=cmd_top)

    mt = sub.add_parser(
        "metrics",
        help="OpenMetrics exposition of a registry snapshot "
             "(TPQ_METRICS_DUMP output); two snapshots diff; --watch polls")
    mt.add_argument("file", nargs="?", default=None,
                    help="registry snapshot JSON, trace/bench artifact, or "
                         "ledger ref (optional with --spool)")
    mt.add_argument("--spool", default=None, metavar="DIR",
                    help="render the aggregated fleet spool instead: every "
                         "per-process series labelled host/pid/role")
    mt.add_argument("file2", nargs="?", default=None,
                    help="second snapshot: print numeric counter deltas "
                         "FILE -> FILE2 instead of rendering")
    mt.add_argument("--config", default=None,
                    help="bench-artifact input: which config's registry to "
                         "render")
    mt.add_argument("--watch", action="store_true",
                    help="poll FILE, printing counter deltas as they land")
    mt.add_argument("--interval", type=float, default=2.0,
                    help="--watch poll interval seconds (default 2)")
    mt.add_argument("--count", type=int, default=None,
                    help="--watch: stop after N polls (default: forever)")
    mt.set_defaults(func=cmd_metrics)

    be = sub.add_parser(
        "bench", help="run-ledger tools: compare and list recorded runs")
    bsub = be.add_subparsers(dest="bench_command", required=True)
    bd = bsub.add_parser(
        "diff",
        help="per-metric deltas A -> B with noise bounds from rep variance; "
             "exit 1 on a regression beyond noise")
    bd.add_argument("a", help="bench artifact .json, ledger .jsonl (last "
                              "run), or ledger.jsonl#N")
    bd.add_argument("b", help="same forms as A")
    bd.add_argument("--floor", type=float, default=0.10,
                    help="minimum relative band when reps carry no noise "
                         "information (default 0.10)")
    bd.set_defaults(func=cmd_bench_diff)
    bh = bsub.add_parser("history", help="one line per recorded run")
    bh.add_argument("ledger", help="ledger.jsonl path")
    bh.add_argument("-n", type=int, default=20, help="show the last N runs")
    bh.set_defaults(func=cmd_bench_history)

    sp = sub.add_parser("split", help="split into files of at most SIZE bytes")
    sp.add_argument("--size", required=True, help="max part size, e.g. 100MB")
    sp.add_argument(
        "--output-pattern", default="part_{}.parquet",
        help="output filename pattern with {} for the part number",
    )
    sp.add_argument("--codec", default="snappy",
                    choices=["uncompressed", "snappy", "gzip", "zstd"])
    sp.add_argument("file")
    sp.set_defaults(func=cmd_split)

    mg = sub.add_parser(
        "merge", help="footer-merge N parquet files into one (no re-encode)")
    mg.add_argument("output")
    mg.add_argument("inputs", nargs="+")
    mg.set_defaults(func=cmd_merge)

    cp = sub.add_parser(
        "compact",
        help="compact a dataset into few large files (manifest publish, "
             "ship-planner codec replanning, CRCs always on)")
    cp.add_argument("dataset", nargs="+",
                    help="manifest dir/file, or a list of parquet files")
    cp.add_argument("--out", default=None,
                    help="output directory (default: the dataset's own)")
    cp.add_argument("--target-size", default="128MB",
                    help="target output file size, e.g. 512MB")
    cp.add_argument("--workers", type=int, default=None,
                    help="encode workers (default TPQ_WRITE_WORKERS)")
    cp.add_argument("--remove-inputs", action="store_true",
                    help="unlink superseded members after the manifest flip")
    cp.set_defaults(func=cmd_compact)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (ParquetError, ValueError, OSError) as e:
        print(f"pq-tool: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
