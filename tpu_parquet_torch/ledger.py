"""Versioned run ledger + noise-aware bench diff (observability over runs).

The port's copy of ``tpu_parquet.ledger``: the same record schema
(``LEDGER_VERSION``), gated metrics, noise model, stage attribution, gate
and renderings, so a ledger written by either package is read and diffed
by the other with the same verdicts.  Stdlib-only, as ``obs``.

- **Ledger** — an append-only ``ledger.jsonl`` of run records: each line is
  the full bench record (per-config metrics, rep lists, registry trees)
  wrapped with a schema version, timestamp, git revision, and an environment
  fingerprint (every ``TPQ_*``/``BENCH_*`` knob that changes what a number
  means — two runs with different ``TPQ_LINK_MBPS`` are different
  experiments, and the ledger says so).

- **Noise-aware diff** — :func:`diff` compares two run records per config
  and metric, with the tolerance band derived from the REP VARIANCE both
  records already carry (``device_windows_s``, ``host_reps_s``, ...): a
  delta is only a regression/improvement when it leaves ``max(z * combined
  rel-MAD, floor)``.  Flagged regressions are *attributed*: the registry
  stage whose seconds moved the most is named next to the metric
  (:func:`attribute_stages`).

- **Gate** — :func:`check` is the CI form: only regressions, with a wider
  default floor (``DEFAULT_CHECK_FLOOR``) so weather-prone boxes gate on
  2x-class regressions, not 5% drifts.

Records compare only when their config's ``rows`` match — a smoke run
against a full-scale baseline yields "incomparable", never a fake 100x
regression.

Where the port differs: the fingerprint's ``kernel_mode``
(``cuda_kernels.kernel_mode``: ``"cuda"`` beside ``kernel_device``, the
card's name, or ``"plain"``) stands where the reference records
``pallas_mode``; ``_ENV_KEYS`` records ``CUDA_VISIBLE_DEVICES`` where the
reference records ``JAX_PLATFORMS``, and leaves out the reference's knobs
the port has no counterpart for (``TPQ_PALLAS``, ``TPQ_FUSE``,
``TPQ_FUSE_RG``, ``TPQ_COMPILE_CACHE``, ``TPQ_DEVICE_SNAPPY``,
``TPQ_DEFER_DICT_CHECK``).
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import time

__all__ = [
    "LEDGER_VERSION", "append", "attribute_stages", "check", "default_path",
    "diff", "env_fingerprint", "format_diff", "format_history", "git_rev",
    "is_ref", "load_side", "make_record", "read", "rel_noise",
]

# version of the ledger line schema; bumped when a field changes meaning so
# `bench history` / `bench diff` can refuse records they'd misread
LEDGER_VERSION = 1

# the environment that changes what a bench number MEANS: route/link knobs,
# sampling shape, and the backend.  Recorded per run so a diff across a knob
# flip is visibly a different experiment.
_ENV_KEYS = (
    "TPQ_LINK_MBPS", "TPQ_FORCE_ROUTE", "TPQ_TRACE", "TPQ_SAMPLE_MS",
    "TPQ_DEVICE_MBPS", "TPQ_DEVICE_TIMING",
    "TPQ_XPROF", "TPQ_SERVE_CONCURRENCY", "TPQ_SERVE_QUEUE",
    "TPQ_PLAN_CACHE_MB", "TPQ_RESULT_CACHE_MB", "TPQ_RESULT_CACHE_HBM_MB",
    "TPQ_SERVE_BROWNOUT", "TPQ_IO_HEDGE_MS",
    "TPQ_SERVE_FAIR", "TPQ_SERVE_TENANTS", "TPQ_STREAM_BUFFER_BATCHES",
    "TPQ_WRITE_CRC", "TPQ_WRITE_WORKERS",
    "TPQ_IO_HEDGE_MAX", "TPQ_IO_INFLIGHT", "TPQ_IO_ASYNC",
    "TPQ_CIRCUIT_FAILS", "TPQ_CIRCUIT_WINDOW_S",
    "TPQ_CIRCUIT_COOLDOWN_S",
    "TPQ_TRACE_TAIL", "TPQ_TRACE_RING", "TPQ_TRACE_SPANS",
    "TPQ_TRACE_SLOW_Q", "TPQ_METRICS_DUMP",
    "TPQ_OBS_SPOOL", "TPQ_OBS_SPOOL_S", "TPQ_OBS_SPOOL_KEEP",
    "TPQ_OBS_STALE_S", "TPQ_SERVE_STREAM_YIELD",
    "BENCH_SCALE", "BENCH_DEVICE_REPS",
    "BENCH_BASELINE_REPS", "BENCH_RESAMPLE", "BENCH_CONFIGS",
    "CUDA_VISIBLE_DEVICES",
)

# gated per-config metrics -> (rep-list key for the noise bound, direction).
# direction +1: higher is better.  The rep lists are the raw per-rep SECONDS
# bench.py already banks in every artifact; a metric whose reps are absent
# falls back to the floor alone.
_METRICS = {
    "device_rows_per_sec": ("device_windows_s", 1),
    "device_mb_per_sec": ("device_windows_s", 1),
    "host_rows_per_sec": ("host_reps_s", 1),
    "pyarrow_rows_per_sec": ("pyarrow_reps_s", 1),
    "device_vs_host": ("device_windows_s", 1),
    "device_vs_host_pipeline": ("device_windows_s", 1),
    "prefetch0_rows_per_sec": ("prefetch0_reps_s", 1),
    "prefetch4_rows_per_sec": ("prefetch4_reps_s", 1),
    "pipeline_speedup": ("prefetch4_reps_s", 1),
    "loader_speedup": ("prefetch4_reps_s", 1),
    "scan_files_rows_per_sec": ("scan_files_reps_s", 1),
    # byte counts are deterministic functions of the code + file: any move
    # is real, the floor alone bounds them; fewer shipped bytes is better
    "link_bytes_ratio": (None, -1),
}

DEFAULT_NOISE_Z = 3.0
DEFAULT_DIFF_FLOOR = 0.10   # human diff: show 10%+ moves beyond noise
DEFAULT_CHECK_FLOOR = 0.30  # CI gate: 2x-class regressions, not drift

# registry stage seconds the attribution ranks (the obs pipeline tree)
_STAGE_KEYS = (
    "io_seconds", "decompress_seconds", "recompress_seconds",
    "stage_seconds", "dispatch_seconds", "finalize_seconds", "stall_seconds",
)


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

def env_fingerprint() -> dict:
    fp = {
        "python": platform.python_version(),
        "platform": platform.platform(),
    }
    for k in _ENV_KEYS:
        v = os.environ.get(k)
        if v is not None:
            fp[k] = v
    # whether the CUDA kernels were built and launched on a card, or the
    # plain versions ran on CPU tensors: a plain-mode device number is
    # bit-identical but NOT a kernel measurement, and a banked run must
    # say which it was.  Best-effort: a ledger read on a torch-less host
    # still fingerprints the rest.
    try:
        from .cuda_kernels import kernel_mode

        fp["kernel_mode"] = kernel_mode()
        if fp["kernel_mode"] == "cuda":
            import torch

            fp["kernel_device"] = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — fingerprinting never raises
        pass
    return fp


def git_rev(cwd: "str | None" = None) -> "str | None":
    """Best-effort short revision of the running tree (None outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)))
    except (OSError, subprocess.SubprocessError):
        return None
    rev = out.stdout.strip()
    return rev if out.returncode == 0 and rev else None


def make_record(bench_record: dict, ts: "float | None" = None) -> dict:
    """Wrap one bench result tree as a versioned ledger record."""
    rec = {
        "ledger_version": LEDGER_VERSION,
        "ts": round(time.time() if ts is None else float(ts), 3),
        "git_rev": git_rev(),
        "env": env_fingerprint(),
    }
    rec.update(bench_record)
    return rec


def append(path: str, record: dict) -> int:
    """Append one record (one compact JSON line); returns its 0-based
    sequence number.  Missing parent directories are created — same
    contract as ``Tracer.write`` (no late FileNotFoundError after the run
    already happened).

    The record and its newline go down in ONE ``write`` call, and a torn
    tail left by a writer that died mid-append (bytes after the last
    newline) is truncated away first — that record was never durably
    written, and gluing the new line onto it would poison the whole
    ledger for every later ``read``.
    """
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    seq = 0
    if os.path.exists(path):
        with open(path, "r+b") as f:
            data = f.read()
            if data and not data.endswith(b"\n"):
                # in-place truncate of JUST the torn bytes — a rewrite
                # (open "wb" + write-back) would hold the whole ledger
                # hostage to a crash mid-rewrite, destroying the durable
                # records the repair exists to protect
                data = data[: data.rfind(b"\n") + 1]
                f.truncate(len(data))
        seq = sum(1 for line in data.splitlines() if line.strip())
    with open(path, "a") as f:
        f.write(json.dumps(record, separators=(",", ":"), sort_keys=True)
                + "\n")
    return seq


def read(path: str) -> "list[dict]":
    """All records of a ledger.  A torn TAIL (a final line without its
    newline — a writer died mid-append) is skipped: the intact records
    must stay readable.  Corruption anywhere else is fatal — silently
    dropping a mid-file record would shift every ``#N`` address."""
    with open(path) as f:
        text = f.read()
    ends_complete = text.endswith("\n")
    lines = text.split("\n")
    if lines and lines[-1] == "":
        lines.pop()
    out = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except json.JSONDecodeError as e:
            if i == len(lines) - 1 and not ends_complete:
                break  # torn tail: never durably written
            raise ValueError(
                f"{path}:{i + 1}: corrupt ledger line ({e})") from None
    return out


def default_path() -> str:
    """The default ledger the bare refs resolve against: ``TPQ_LEDGER``
    when set, else ``ledger.jsonl`` in the working directory (the same
    name bench.py appends to next to its artifact)."""
    return os.environ.get("TPQ_LEDGER") or "ledger.jsonl"


def is_ref(spec: str) -> bool:
    """True when ``spec`` is a ledger reference rather than a plain
    artifact path: ``latest``, ``latest#N``, ``#N``, ``*.jsonl``, or
    ``*.jsonl#N`` — the forms ``load_side`` resolves through a ledger."""
    path, _, _idx = spec.partition("#")
    return path in ("", "latest") or path.endswith(".jsonl")


def load_side(spec: str) -> dict:
    """Resolve one side of a diff/check to a run record.

    Accepted forms: a bench artifact ``*.json`` (read whole), a ledger
    ``*.jsonl`` (its LAST record), ``ledger.jsonl#N`` (record N; negative
    counts from the end, so ``#-2`` is the previous run), and the default-
    ledger shorthands ``latest`` (last record of :func:`default_path`),
    ``latest#N``, and bare ``#N`` — so post-mortems (`pq_tool doctor
    latest`) never require remembering artifact paths.
    """
    path, _, idx = spec.partition("#")
    if path in ("", "latest"):
        path = default_path()
    if idx or path.endswith(".jsonl"):
        records = read(path)
        if not records:
            raise ValueError(f"{path}: empty ledger")
        i = int(idx) if idx else -1
        try:
            return records[i]
        except IndexError:
            raise ValueError(
                f"{path}: no record #{i} (have {len(records)})") from None
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: not a run record (top level not an object)")
    return doc


# ---------------------------------------------------------------------------
# noise model
# ---------------------------------------------------------------------------

def _median(xs):
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def _reps(cfg: dict, key: "str | None") -> "list[float]":
    """Flatten a config's rep list (``device_windows_s`` nests windows)."""
    if key is None:
        return []
    v = cfg.get(key)
    if not isinstance(v, list):
        return []
    flat: list = []
    for x in v:
        if isinstance(x, list):
            flat.extend(x)
        else:
            flat.append(x)
    return [float(t) for t in flat
            if isinstance(t, (int, float)) and t > 0]


def rel_noise(reps: "list[float]") -> float:
    """Relative rep-to-rep noise of one sample list.

    n >= 4: normal-consistent relative MAD (robust to the one rep a context
    switch ate).  n in {2, 3}: half-range over the median — MAD under-reads
    badly at tiny n.  n < 2: 0.0 (no information; the caller's floor is the
    only band).
    """
    if len(reps) < 2:
        return 0.0
    med = _median(reps)
    if med <= 0:
        return 0.0
    if len(reps) < 4:
        return (max(reps) - min(reps)) / (2.0 * med)
    mad = _median([abs(x - med) for x in reps])
    return 1.4826 * mad / med


# ---------------------------------------------------------------------------
# diff / attribution / gate
# ---------------------------------------------------------------------------

def attribute_stages(cfg_a: dict, cfg_b: dict) -> "dict | None":
    """Name the registry stage whose seconds grew the most from a to b.

    Reads each config's embedded registry tree (``obs.pipeline`` plus the
    per-route device completion seconds of the ``obs.device`` section, as
    ``device:<route>`` pseudo-stages — so a regression can be pinned to a
    SPECIFIC device route, not just "dispatch grew"); the stage with the
    largest absolute second growth is the attribution a flagged regression
    carries.  Records predating the device section simply contribute no
    device pseudo-stages (graceful n/a, never a KeyError).  None when
    neither side embedded a registry, or when no stage grew at all (a
    shrinking stage can't explain a regression — attributing the
    least-shrinking one would mislead).
    """
    oa = cfg_a.get("obs") or {}
    ob = cfg_b.get("obs") or {}
    pa = oa.get("pipeline") or {}
    pb = ob.get("pipeline") or {}
    moves = {}
    for k in _STAGE_KEYS:
        sa = float(pa.get(k) or 0.0)
        sb = float(pb.get(k) or 0.0)
        if sa or sb:
            moves[k] = (sa, sb)
    da = (oa.get("device") or {}).get("routes") or {}
    db = (ob.get("device") or {}).get("routes") or {}
    for r in set(da) | set(db):
        sa = float((da.get(r) or {}).get("device_seconds") or 0.0)
        sb = float((db.get(r) or {}).get("device_seconds") or 0.0)
        if sa or sb:
            moves[f"device:{r}_seconds"] = (sa, sb)
    if not moves:
        return None
    stage = max(moves, key=lambda k: moves[k][1] - moves[k][0])
    sa, sb = moves[stage]
    if sb <= sa:
        # no stage grew: the registry can't explain this regression (a
        # machine/env change, or reps the registry never saw) — naming the
        # least-shrinking stage would mislead, so attribute nothing
        return None
    return {
        "stage": stage[: -len("_seconds")],
        "a_seconds": round(sa, 6),
        "b_seconds": round(sb, 6),
        "moved_seconds": round(sb - sa, 6),
        "ratio": round(sb / sa, 3) if sa else None,
    }


def diff(a: dict, b: dict, z: float = DEFAULT_NOISE_Z,
         floor: float = DEFAULT_DIFF_FLOOR) -> dict:
    """Per-metric deltas of run ``b`` against run ``a`` with noise bounds.

    For each config present in both records with MATCHING ``rows`` and each
    gated metric: ``ratio = b/a``; the band is ``max(z * sqrt(na^2 + nb^2),
    floor)`` over the two sides' :func:`rel_noise`.  Outside the band in
    the bad direction -> a regression entry carrying the stage attribution;
    the good direction -> an improvement; inside -> within_noise.
    Configs whose ``rows`` differ are listed as incomparable (a smoke run
    against a full-scale baseline is a different experiment).
    """
    out = {
        "metrics": {},
        "regressions": [],
        "improvements": [],
        "incomparable": [],
        "compared": 0,
        "noise_z": z,
        "floor": floor,
    }
    acfgs = a.get("configs")
    bcfgs = b.get("configs")
    if not isinstance(acfgs, dict) or not isinstance(bcfgs, dict):
        return out
    for name in sorted(set(acfgs) & set(bcfgs)):
        ca, cb = acfgs[name], bcfgs[name]
        if not isinstance(ca, dict) or not isinstance(cb, dict):
            continue
        if ca.get("rows") != cb.get("rows"):
            out["incomparable"].append({
                "config": name,
                "reason": f"rows {ca.get('rows')} != {cb.get('rows')}",
            })
            continue
        for key, (rep_key, direction) in _METRICS.items():
            va, vb = ca.get(key), cb.get(key)
            if (not isinstance(va, (int, float)) or isinstance(va, bool)
                    or not isinstance(vb, (int, float)) or not va):
                continue
            na = rel_noise(_reps(ca, rep_key))
            nb = rel_noise(_reps(cb, rep_key))
            bound = max(z * (na * na + nb * nb) ** 0.5, floor)
            ratio = vb / va
            signed = (ratio - 1.0) * direction  # negative = worse
            entry = {
                "config": name, "metric": key, "a": va, "b": vb,
                "ratio": round(ratio, 4), "noise_bound": round(bound, 4),
                "direction": direction,
            }
            out["compared"] += 1
            if signed < -bound:
                entry["verdict"] = "regression"
                entry["attribution"] = attribute_stages(ca, cb)
                out["regressions"].append(entry)
            elif signed > bound:
                entry["verdict"] = "improvement"
                out["improvements"].append(entry)
            else:
                entry["verdict"] = "within_noise"
            out["metrics"][f"{name}.{key}"] = entry
    return out


def check(baseline: dict, current: dict, z: float = DEFAULT_NOISE_Z,
          floor: float = DEFAULT_CHECK_FLOOR) -> "list[dict]":
    """The CI regression gate: flagged regressions of ``current`` vs
    ``baseline`` at the gate floor (improvements never fail a build)."""
    return diff(baseline, current, z=z, floor=floor)["regressions"]


# ---------------------------------------------------------------------------
# rendering (the pq_tool bench backends)
# ---------------------------------------------------------------------------

def _fmt_val(v: float) -> str:
    return f"{v:.4g}" if isinstance(v, float) and abs(v) < 1e4 else f"{v:,.0f}"


def format_diff(d: dict, a_label: str = "A", b_label: str = "B") -> str:
    lines = [f"bench diff: {a_label} -> {b_label}  "
             f"({d['compared']} comparable metrics, noise z={d['noise_z']:g}, "
             f"floor {100 * d['floor']:.0f}%)"]
    for verdict, entries in (("REGRESSION", d["regressions"]),
                             ("improvement", d["improvements"])):
        for e in entries:
            line = (f"  {verdict}  {e['config']}.{e['metric']}: "
                    f"{_fmt_val(e['a'])} -> {_fmt_val(e['b'])} "
                    f"({100 * (e['ratio'] - 1):+.1f}%, "
                    f"bound ±{100 * e['noise_bound']:.1f}%)")
            att = e.get("attribution")
            if att:
                grown = (f"{att['ratio']:.2f}x" if att["ratio"] is not None
                         else f"+{att['moved_seconds']:.3f}s")
                line += f"  <- {att['stage']} stage moved {grown}"
            lines.append(line)
    if not d["regressions"] and not d["improvements"]:
        lines.append("  all metrics within noise bounds")
    for inc in d["incomparable"]:
        lines.append(f"  incomparable  {inc['config']}: {inc['reason']}")
    return "\n".join(lines) + "\n"


def format_history(records: "list[dict]", path: str, start: int = 0) -> str:
    lines = [f"ledger: {path}  ({len(records)} runs)"]
    for i, r in enumerate(records, start):
        ts = r.get("ts")
        when = (time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))
                if isinstance(ts, (int, float)) else "-")
        rev = r.get("git_rev") or "-"
        value = r.get("value")
        vs = r.get("vs_baseline")
        lines.append(
            f"  #{i}  {when}  {rev:<12}  {r.get('metric', '?')}="
            f"{_fmt_val(value) if isinstance(value, (int, float)) else '?'} "
            f"{r.get('unit', '')}  vs_baseline="
            f"{vs if vs is not None else '-'}")
    return "\n".join(lines) + "\n"
