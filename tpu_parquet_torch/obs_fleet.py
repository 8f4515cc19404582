"""Fleet observability: cross-process metrics spool, aggregation, and
straggler attribution.

The port's copy of ``tpu_parquet.obs_fleet``, whole: ``SPOOL_VERSION`` and
``FLEET_VERSION`` are the reference's, and so is every document key, so a
spool directory holding documents of both packages aggregates as one
fleet, and each package's readers (the doctor, the OpenMetrics rendering,
trace stitching) read the other's snapshots.

Every layer below this one — :class:`~tpu_parquet_torch.obs.StatsRegistry`, the
ledger, the flight recorder, request tracing — sees exactly ONE process.
Production is a *fleet*: N loader/writer/serve processes per host, M
hosts.  This module is the seam between the two:

- :class:`SpoolWriter` rides the ``MetricsDumper`` discipline to publish
  versioned per-process snapshots ``{host, pid, role, seq, heartbeat_ts,
  registry tree, tail-sampled trace docs}`` into a shared spool directory
  (``TPQ_OBS_SPOOL``; default off).  One file per process generation,
  written tmp + ``os.replace`` so a reader never sees a torn snapshot;
  older generations are pruned to ``TPQ_OBS_SPOOL_KEEP``.

- :class:`FleetAggregator` scans the spool and folds every member's
  registry through the existing ``merge_dict`` paths into ONE fleet
  snapshot: counters reconcile exactly with the per-process sum, gauges
  take the max (``_MERGE_MAXED``), histograms add bucket-wise.  Torn,
  truncated, stale, or version-skewed files are counted and skipped,
  never fatal — a half-written snapshot is normal operation, not an
  error.

- :func:`doctor_fleet` turns the snapshot into verdicts the single-process
  doctor cannot reach: ``straggler`` (the process whose lane-seconds total
  sits outside the fleet's rel-MAD deviation band — named by host:pid,
  dominant lane, and deviation ratio), ``dead-process`` (heartbeat older
  than ``TPQ_OBS_STALE_S``), and the fleet-level ``slo-burn`` (the merged
  tree's worst tenant, with the exemplar attributed to the process whose
  histogram retained it).

- :func:`render_fleet_openmetrics` labels every per-process series with
  ``host``/``pid``/``role`` so one scrape shows the whole fleet.

- :func:`stitch_traces` / :func:`ambient_request_trace` carry a request's
  identity across OS-process seams: the parent exports
  ``RequestTrace.trace_context()`` (JSON via ``TPQ_TRACE_CONTEXT``), the
  child adopts it, and the aggregated view re-parents the child's spans
  under the originating request — ``pq_tool trace --request`` renders one
  multi-process tree.
"""

from __future__ import annotations

import json
import os
import threading
import time

from .ledger import rel_noise
from .obs import (
    LatencyHistogram, RequestTrace, StatsRegistry, TailSampler, _om_escape,
    _om_name, _om_num, current_request_trace, doctor_registry, env_float,
    env_int, fleet_host, set_request_trace, warn_env_once,
)

__all__ = [
    "FLEET_VERSION", "SPOOL_VERSION", "FleetAggregator", "SpoolWriter",
    "ambient_request_trace", "doctor_fleet", "render_fleet_openmetrics",
    "resolve_spool_dir", "stitch_traces",
]

# version of the per-process spool document (`SpoolWriter` output)
SPOOL_VERSION = 1
# version of the aggregated fleet snapshot (`FleetAggregator.scan` output)
FLEET_VERSION = 1

# straggler detection: a process fires only when the fleet has enough
# members for a median to mean anything, and its lane-seconds total sits
# past BAND_K fleet-noise bands (rel-MAD, the ledger's discipline) over
# the median — with an absolute floor so a near-zero-noise fleet doesn't
# flag a 1% wobble
STRAGGLER_MIN_PROCS = 3
STRAGGLER_BAND_K = 3.0
STRAGGLER_FLOOR = 0.5


def resolve_spool_dir(spec: "str | None" = None) -> "str | None":
    """The spool directory (default: ``TPQ_OBS_SPOOL``), or ``None`` when
    fleet observability is off."""
    raw = os.environ.get("TPQ_OBS_SPOOL", "") if spec is None else spec
    return raw or None


def _member_name(host: str, pid: int, role: str) -> str:
    """A filesystem-safe spool-member prefix for ``host:pid:role``.  The
    role is part of the identity: one process may run several armed entry
    points (a job that ``write_sharded``s then ``DataLoader``s), and two
    writers sharing a prefix would ``os.replace``/prune each other's
    generations."""
    def safe(s):
        return "".join(ch if (ch.isascii() and (ch.isalnum() or ch in "-_."))
                       else "_" for ch in str(s))
    return f"{safe(host) or 'localhost'}-{int(pid)}-{safe(role) or 'unknown'}"


class SpoolWriter:
    """Daemon thread publishing this process's observability snapshot into
    the fleet spool directory (``TPQ_OBS_SPOOL``; inert when unset).

    ``source`` is a :class:`StatsRegistry`, a zero-arg callable returning
    one (or an ``as_dict`` tree), or a plain tree; ``sampler`` is a
    :class:`TailSampler`, a
    zero-arg callable returning trace documents, or ``None``.  Each tick
    writes one versioned generation file ``<host>-<pid>-<role>.<seq>.json``
    atomically (tmp + ``os.replace``) and prunes this member's older
    generations down to ``TPQ_OBS_SPOOL_KEEP``.  Lifecycle discipline
    matches :class:`~tpu_parquet_torch.obs.MetricsDumper`: ``stop()`` publishes
    a final generation and joins, a failing source or write is counted,
    never raised.  ``host``/``pid`` overrides exist for tests and the
    fuzz harness (simulated fleets in one process).
    """

    def __init__(self, source, role: str, sampler=None,
                 spool_dir: "str | None" = None,
                 interval_s: "float | None" = None,
                 keep: "int | None" = None,
                 host: "str | None" = None, pid: "int | None" = None):
        self.source = source
        self.role = str(role)
        self.sampler = sampler
        self.spool_dir = (resolve_spool_dir() if spool_dir is None
                          else (spool_dir or None))
        self.interval_s = (env_float("TPQ_OBS_SPOOL_S", 1.0, lo=0.05)
                           if interval_s is None else float(interval_s))
        self.keep = (env_int("TPQ_OBS_SPOOL_KEEP", 2, lo=1)
                     if keep is None else max(int(keep), 1))
        self.host = str(host) if host is not None else fleet_host()
        self.pid = int(pid) if pid is not None else os.getpid()
        self._member = _member_name(self.host, self.pid, self.role)
        self._seq = 0
        self._last_hb = 0.0
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.written = 0
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return self.spool_dir is not None and self.interval_s > 0

    def start(self) -> "SpoolWriter":
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"tpq-spool-{self.role}", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the spool thread (no leak, bench-gated)."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "SpoolWriter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        while True:
            stopping = self._stop.wait(self.interval_s)
            self.publish_once()
            if stopping:
                return

    def _trace_docs(self) -> list:
        if self.sampler is None:
            return []
        if isinstance(self.sampler, TailSampler):
            return self.sampler.traces()
        return list(self.sampler() or [])

    def publish_once(self) -> "str | None":
        """Publish one snapshot generation; returns its path (``None``
        when disabled or the publish failed — failures never raise)."""
        if self.spool_dir is None:
            return None
        try:
            tree = self.source
            if callable(tree) and not isinstance(tree, StatsRegistry):
                tree = tree()
            if isinstance(tree, StatsRegistry):
                tree = tree.as_dict()
            # heartbeat is monotonic per member even if the wall clock
            # steps backwards (the fuzz harness checks)
            self._last_hb = max(time.time(), self._last_hb)
            self._seq += 1
            doc = {
                "spool_version": SPOOL_VERSION,
                "host": self.host,
                "pid": self.pid,
                "role": self.role,
                "seq": self._seq,
                "heartbeat_ts": self._last_hb,
                "registry": tree,
                "traces": self._trace_docs(),
            }
            os.makedirs(self.spool_dir, exist_ok=True)
            path = os.path.join(self.spool_dir,
                                f"{self._member}.{self._seq:08d}.json")
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, default=repr)
                f.write("\n")
            os.replace(tmp, path)
            self.written += 1
            self._prune()
            return path
        except Exception:  # noqa: BLE001 — observability never takes the run down
            self.dropped += 1
            return None

    def _prune(self) -> None:
        """Drop this member's generations beyond the newest ``keep``."""
        prefix = f"{self._member}."
        mine = sorted(fn for fn in os.listdir(self.spool_dir)
                      if fn.startswith(prefix) and fn.endswith(".json"))
        for fn in mine[:-self.keep]:
            try:
                os.remove(os.path.join(self.spool_dir, fn))
            except OSError:
                pass  # a concurrent aggregator/pruner got there first


def _valid_spool_doc(doc) -> bool:
    return (isinstance(doc, dict)
            and doc.get("spool_version") == SPOOL_VERSION
            and isinstance(doc.get("host"), str) and doc["host"]
            and isinstance(doc.get("pid"), int)
            and isinstance(doc.get("seq"), int) and doc["seq"] > 0
            and isinstance(doc.get("heartbeat_ts"), (int, float))
            and isinstance(doc.get("registry"), dict))


class FleetAggregator:
    """Scan a spool directory and fold every member's latest snapshot into
    one versioned fleet snapshot.

    Per member (``host:pid:role``) only the highest-``seq`` readable
    document counts; lower generations are ``stale_skipped``; members
    sharing a ``host:pid`` (one process, several armed entry points) fold
    into one process entry.  Torn / truncated /
    non-JSON / version-skewed files are ``rejected`` — counted, never
    fatal (a writer mid-``os.replace`` is normal).  The merged registry
    reconciles exactly with the per-process trees by construction:
    counters add, ``_MERGE_MAXED`` gauges max, histograms add bucket-wise
    (the fuzz target and the 3-process e2e test hold it to "exactly").
    """

    def __init__(self, spool_dir: "str | None" = None,
                 stale_s: "float | None" = None):
        self.spool_dir = (resolve_spool_dir() if spool_dir is None
                          else (spool_dir or None))
        self.stale_s = (env_float("TPQ_OBS_STALE_S", 10.0, lo=0.1)
                        if stale_s is None else float(stale_s))

    def scan(self, now: "float | None" = None) -> dict:
        """One aggregation pass; returns the fleet snapshot dict (empty
        fleet when the spool is unset/missing, never raises)."""
        now = time.time() if now is None else float(now)
        files_scanned = rejected = stale_skipped = 0
        latest: dict = {}  # (host, pid) -> doc
        try:
            names = sorted(os.listdir(self.spool_dir or ""))
        except OSError:
            names = []
        for fn in names:
            if not fn.endswith(".json"):
                continue
            files_scanned += 1
            try:
                with open(os.path.join(self.spool_dir, fn)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                rejected += 1
                continue
            if not _valid_spool_doc(doc):
                rejected += 1
                continue
            key = (doc["host"], doc["pid"], str(doc.get("role") or "unknown"))
            prev = latest.get(key)
            if prev is None:
                latest[key] = doc
            elif doc["seq"] > prev["seq"]:
                latest[key] = doc
                stale_skipped += 1
            else:
                stale_skipped += 1
        merged = StatsRegistry()
        processes: dict = {}
        traces: list = []
        for (host, pid, role), doc in sorted(latest.items()):
            try:
                merged.merge_dict(doc["registry"])
            except (ValueError, TypeError, AttributeError):
                rejected += 1
                continue
            hb = float(doc["heartbeat_ts"])
            pkey = f"{host}:{pid}"
            prev = processes.get(pkey)
            if prev is None:
                processes[pkey] = {
                    "role": role,
                    "seq": doc["seq"],
                    "heartbeat_ts": hb,
                    "registry": doc["registry"],
                }
            else:
                # one OS process, several armed entry points (e.g. a job
                # that write_sharded's then DataLoader's): one process
                # entry, roles joined, registries folded, newest heartbeat
                roles = set(prev["role"].split("+")) | {role}
                prev["role"] = "+".join(sorted(roles))
                prev["seq"] = max(prev["seq"], doc["seq"])
                prev["heartbeat_ts"] = max(prev["heartbeat_ts"], hb)
                fold = StatsRegistry()
                fold.merge_dict(prev["registry"])
                fold.merge_dict(doc["registry"])
                prev["registry"] = fold.as_dict()
            for td in doc.get("traces") or []:
                if isinstance(td, dict) and td.get("trace_id"):
                    traces.append(td)
        for p in processes.values():
            age = max(now - p["heartbeat_ts"], 0.0)
            p["heartbeat_ts"] = round(p["heartbeat_ts"], 3)
            p["heartbeat_age_s"] = round(age, 3)
            p["stale"] = age > self.stale_s
        return {
            "fleet_version": FLEET_VERSION,
            "generated_unix": round(now, 3),
            "spool_dir": self.spool_dir,
            "stale_after_s": self.stale_s,
            "processes": processes,
            "registry": merged.as_dict(),
            "traces": traces,
            "files_scanned": files_scanned,
            "rejected": rejected,
            "stale_skipped": stale_skipped,
        }


# ---------------------------------------------------------------------------
# fleet diagnosis: straggler / dead-process / fleet slo-burn
# ---------------------------------------------------------------------------

def _num(d, k) -> float:
    v = d.get(k) if isinstance(d, dict) else None
    return float(v) if isinstance(v, (int, float)) else 0.0


def process_lanes(tree: dict) -> dict:
    """Per-process lane seconds — the same lane extraction the
    single-process doctor attributes on, plus the write lanes, so a
    straggling writer and a straggling decoder are both nameable."""
    if not isinstance(tree, dict):
        return {}
    pipe = tree.get("pipeline") or {}
    reader = tree.get("reader") or {}
    dev = tree.get("device")
    dev = dev if isinstance(dev, dict) else {}
    serve = tree.get("serve")
    serve = serve if isinstance(serve, dict) else {}
    host = (_num(pipe, "io_seconds") + _num(pipe, "decompress_seconds")
            + _num(pipe, "recompress_seconds"))
    if host == 0.0:
        host = _num(reader, "host_seconds")
    dev_resolve = sum(_num(c, "device_seconds")
                      for c in (dev.get("routes") or {}).values()
                      if isinstance(c, dict))
    lanes = {
        "link": _num(pipe, "stage_seconds"),
        "host_decompress": host,
        "device_resolve": dev_resolve or (_num(pipe, "dispatch_seconds")
                                          + _num(pipe, "finalize_seconds")),
        "h2d": _num(dev.get("h2d") or {}, "device_seconds"),
        "stall": _num(pipe, "stall_seconds"),
        "admission": _num(serve, "queue_wait_seconds"),
    }
    wr = tree.get("write")
    wr = wr if isinstance(wr, dict) else {}
    for s in ("encode", "compress", "flush", "merge", "compact"):
        lanes[f"write_{s}"] = _num(wr, f"{s}_seconds")
    lanes["write_stall"] = _num(wr, "stall_seconds")
    return {k: v for k, v in lanes.items()}


def _median(xs: "list[float]") -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _straggler_block(processes: dict) -> "dict | None":
    totals = {}
    lanes_by = {}
    for key, p in processes.items():
        if p.get("stale"):
            continue  # a dead process is its own verdict, not a straggler
        lanes = process_lanes(p.get("registry") or {})
        total = sum(lanes.values())
        if total > 0:
            totals[key] = total
            lanes_by[key] = lanes
    if len(totals) < STRAGGLER_MIN_PROCS:
        return None
    worst = max(totals, key=lambda k: (totals[k], k))
    # leave-one-out: the candidate's own total must not define the fleet's
    # noise band (at small n the half-range estimator would let one extreme
    # straggler inflate the band past its own deviation and never fire)
    rest = [v for k, v in totals.items() if k != worst]
    med = _median(rest)
    if med <= 0:
        return None
    band = rel_noise(rest)
    ratio = totals[worst] / med
    bar = 1.0 + max(STRAGGLER_BAND_K * band, STRAGGLER_FLOOR)
    if ratio <= bar:
        return None
    lanes = lanes_by[worst]
    dominant = max(lanes, key=lambda k: (lanes[k], k))
    return {
        "verdict": "straggler",
        "process": worst,
        "role": (processes[worst] or {}).get("role", "unknown"),
        "dominant_lane": dominant,
        "deviation": round(ratio, 3),
        "band": round(band, 4),
        "total_lane_s": round(totals[worst], 6),
        "median_lane_s": round(med, 6),
        "lanes": {k: round(v, 6) for k, v in lanes.items() if v > 0},
        "advice": (
            f"process {worst} carries {ratio:.2f}x the fleet-median lane "
            f"seconds (band {band:.3f}); its dominant lane is "
            f"'{dominant}' — diagnose THAT process: pq_tool doctor on its "
            f"own snapshot, or pq_tool trace --request on a trace it "
            f"retained"),
    }


def _dead_blocks(processes: dict, stale_s: float) -> "list[dict]":
    out = []
    for key, p in sorted(processes.items()):
        if not p.get("stale"):
            continue
        out.append({
            "verdict": "dead-process",
            "process": key,
            "role": p.get("role", "unknown"),
            "heartbeat_age_s": p.get("heartbeat_age_s", 0.0),
            "stale_after_s": round(float(stale_s), 3),
            "advice": (
                f"process {key} ({p.get('role', 'unknown')}) last "
                f"heartbeat {p.get('heartbeat_age_s', 0.0):g}s ago "
                f"(> {stale_s:g}s): restart it or prune its spool entry; "
                f"its counters still ride the fleet totals"),
        })
    return out


def _owning_process(processes: dict, trace_id: str) -> "str | None":
    """The fleet member whose snapshot retained ``trace_id`` — first as a
    histogram exemplar (the slo-burn linkage), then among its trace docs."""
    if not trace_id:
        return None
    for key, p in sorted(processes.items()):
        hists = (p.get("registry") or {}).get("histograms") or {}
        for hd in hists.values():
            for ex in (hd.get("exemplars") or {}).values():
                if isinstance(ex, (list, tuple)) and ex \
                        and str(ex[0]) == trace_id:
                    return key
    return None


def doctor_fleet(snapshot: dict) -> "dict | None":
    """Fleet-level diagnosis over a :meth:`FleetAggregator.scan` snapshot.

    Returns ``{"verdicts": [...], "doctor": <merged-tree doctor report>}``
    — or ``None`` when the fleet produced no evidence at all.  Verdicts:
    ``straggler``, one ``dead-process`` per stale member, and the merged
    tree's ``slo-burn`` annotated with ``exemplar_process`` (which member
    retained the exemplar trace).  The merged-tree doctor report rides
    along so the fleet view never says less than the single-process one.
    """
    if not isinstance(snapshot, dict):
        return None
    processes = snapshot.get("processes") or {}
    verdicts: list = []
    strag = _straggler_block(processes)
    if strag:
        verdicts.append(strag)
    verdicts.extend(_dead_blocks(
        processes, float(snapshot.get("stale_after_s") or 0.0)))
    report = doctor_registry(snapshot.get("registry") or {})
    burn = (report or {}).get("slo_burn")
    if isinstance(burn, dict):
        burn = dict(burn)
        owner = _owning_process(processes, burn.get("exemplar_trace") or "")
        burn["exemplar_process"] = owner
        if owner:
            burn["advice"] = (burn.get("advice", "")
                              + f"; the exemplar was retained by {owner}")
        verdicts.append(burn)
    if not verdicts and report is None:
        return None
    return {"verdicts": verdicts, "doctor": report}


# ---------------------------------------------------------------------------
# fleet OpenMetrics: host/pid/role-labelled exposition
# ---------------------------------------------------------------------------

def _om_labels(host: str, pid: int, role: str, extra: str = "") -> str:
    base = (f'host="{_om_escape(host)}",pid="{int(pid)}",'
            f'role="{_om_escape(role)}"')
    return f"{{{base}{',' + extra if extra else ''}}}"


def _om_walk_labelled(lines: list, prefix: tuple, tree: dict,
                      labels: str, typed: set) -> None:
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            _om_walk_labelled(lines, prefix + (k,), v, labels, typed)
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        else:
            name = _om_name("tpq", *prefix, k)
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{labels} {_om_num(v)}")


def render_fleet_openmetrics(snapshot: dict) -> str:
    """Render a fleet snapshot as an OpenMetrics exposition where every
    per-process series carries ``host``/``pid``/``role`` labels — one
    scrape, the whole fleet — followed by the per-member heartbeat ages.
    Ends with ``# EOF``.
    """
    if not isinstance(snapshot, dict):
        raise ValueError("not a fleet snapshot")
    lines: list[str] = []
    typed: set = set()
    for key, p in sorted((snapshot.get("processes") or {}).items()):
        host, _, pid = key.rpartition(":")
        try:
            pid_i = int(pid)
        except ValueError:
            continue
        role = str(p.get("role") or "unknown")
        labels = _om_labels(host, pid_i, role)
        tree = p.get("registry") or {}
        for section in ("pipeline", "reader", "loader", "io", "data_errors",
                        "device", "serve", "cache", "write", "alloc"):
            sub = tree.get(section)
            if isinstance(sub, dict):
                sub = dict(sub)
                sub.pop("ship_feedback", None)
                _om_walk_labelled(lines, (section,), sub, labels, typed)
        for hname, hd in sorted((tree.get("histograms") or {}).items()):
            if not isinstance(hd, dict):
                continue
            name = _om_name("tpq", hname, "seconds")
            if name not in typed:
                typed.add(name)
                lines.append(f"# TYPE {name} histogram")
            exemplars = hd.get("exemplars") or {}
            cum = 0
            for i in sorted(int(k) for k in (hd.get("buckets") or {})):
                cum += int(hd["buckets"][str(i)])
                le = LatencyHistogram.bucket_upper_seconds(i)
                lab = _om_labels(host, pid_i, role, f'le="{le!r}"')
                line = f"{name}_bucket{lab} {cum}"
                ex = exemplars.get(str(i))
                if isinstance(ex, (list, tuple)) and len(ex) == 2:
                    line += (f' # {{trace_id="{_om_escape(ex[0])}"}}'
                             f" {float(ex[1])!r}")
                lines.append(line)
            lab = _om_labels(host, pid_i, role, 'le="+Inf"')
            lines.append(f"{name}_bucket{lab} {int(hd.get('count', 0))}")
            lines.append(f"{name}_sum{labels} "
                         f"{float(hd.get('sum_seconds', 0.0))!r}")
            lines.append(f"{name}_count{labels} {int(hd.get('count', 0))}")
        hb = _om_name("tpq", "fleet", "heartbeat_age_seconds")
        if hb not in typed:
            typed.add(hb)
            lines.append(f"# TYPE {hb} gauge")
        lines.append(f"{hb}{labels} "
                     f"{float(p.get('heartbeat_age_s') or 0.0)!r}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# cross-process trace stitching
# ---------------------------------------------------------------------------

def stitch_traces(docs: "list[dict]", trace_id: str) -> "dict | None":
    """Assemble one multi-process view of a request from retained trace
    documents: the root (the doc whose own ``trace_id`` matches) plus
    every child doc whose ``origin.trace_id`` points at it (adopted via
    :meth:`RequestTrace.adopt_context` in another process).  Children sort
    by ``(host, pid, trace_id)``.  Returns ``None`` when neither a root
    nor any child matches.
    """
    root = None
    children = []
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        if doc.get("trace_id") == trace_id:
            # highest-information copy wins: a later spool generation of
            # the same doc simply replaces the earlier one
            root = doc
        elif (doc.get("origin") or {}).get("trace_id") == trace_id:
            children.append(doc)
    if root is None and not children:
        return None
    seen = set()
    uniq = []
    for d in sorted(children,
                    key=lambda d: (str(d.get("host") or ""),
                                   int(d.get("pid") or 0),
                                   str(d.get("trace_id") or ""))):
        tid = d.get("trace_id")
        if tid in seen:
            continue  # the same child republished across generations
        seen.add(tid)
        uniq.append(d)
    return {"trace_id": trace_id, "root": root, "children": uniq}


def ambient_request_trace() -> "RequestTrace | None":
    """The request trace this work should record into: the thread's
    current one when set, else one adopted from the ``TPQ_TRACE_CONTEXT``
    env blob a parent process exported (installed thread-locally so
    nested code finds it).  ``None`` when neither exists; a malformed
    blob degrades via ``warn_env_once``, never raises."""
    tr = current_request_trace()
    if tr is not None:
        return tr
    raw = os.environ.get("TPQ_TRACE_CONTEXT", "")
    if not raw:
        return None
    try:
        tr = RequestTrace.adopt_context(json.loads(raw))
    except (ValueError, TypeError):
        warn_env_once("TPQ_TRACE_CONTEXT", raw, None)
        return None
    set_request_trace(tr)
    return tr
