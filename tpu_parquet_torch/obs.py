"""Unified trace/metrics layer: span tracer, flight recorder, hang
watchdog and one stats registry.

The port's copy of ``tpu_parquet.obs``, whole: every structure, key and
verdict is the reference's, so a trace, a registry tree or a flight dump of
the port reads like one of the reference.  Stdlib-only (the innermost hot
loops import it, so it never pulls numpy or torch):

- :class:`Tracer` — a thread-safe span tracer (nestable spans, instants,
  counters) writing Chrome trace-event JSON that Perfetto loads.  Disabled,
  ``span()`` returns a shared no-op after one attribute check.  Activation:
  ``TPQ_TRACE=<path>`` (a process tracer written at exit) or ``trace=`` on
  ``FileReader`` / ``DeviceFileReader`` / ``scan_files`` (written when the
  object closes).
- :class:`LatencyHistogram` — log2-bucketed latency distribution, mergeable
  across threads and processes (``as_dict`` / ``from_dict``).
- :class:`RequestTrace` / :class:`TailSampler` — per-request span trees
  (riding ``resilience.CancelToken.trace``) and their tail sampling.
- :class:`StatsRegistry` — the one versioned ``as_dict()`` tree over
  ``PipelineStats``, ``ReaderStats`` (ship decisions with the planner's
  predicted seconds), the store's ``IOStats``, the quarantine counters, the
  device lane (``device_reader.DeviceStats``, timed with CUDA events) and
  the alloc peaks; ``ship_feedback()`` puts the planner's predictions beside
  the measured link and device lanes.
- :class:`Sampler` — live counter tracks on the trace.
- :class:`FlightRecorder` — an always-on bounded per-thread ring of recent
  trace events; ``dump()`` writes the ring, every thread's stack, the live
  budgets and trackers, the registered flight sources and the live registry
  trees.
- :class:`Watchdog` — a daemon thread watching progress heartbeats; when
  none advances within ``TPQ_HANG_S`` / ``hang_s=`` it writes a flight dump
  and logs, or (policy ``raise``) aborts the in-flight budget and the
  stores so the submitter raises
  :class:`~tpu_parquet_torch.errors.HangError`.
- :func:`trace_summary`, :func:`doctor_registry`, :func:`autopsy_dump` —
  the readers of a trace, a registry tree and a flight dump.

Where the port differs: :func:`_classify_frames` recognizes a device wait
by ``torch.cuda`` synchronization frames (``synchronize``,
``Event.synchronize``) where the reference looks for ``/jax/`` paths and
``block_until_ready``, and the port's own module paths; the doctor's
kernel names are the CUDA kernels (``hybrid_unpack_combine``,
``fused_plain_words``, ``fused_narrow_words``).
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import sys
import threading
import time
import weakref
from collections import deque
from typing import Optional

__all__ = [
    "FLIGHT_VERSION", "HOST_PARTS", "OBS_VERSION", "ConsumerLane",
    "FlightRecorder", "HostPhaseStats",
    "LatencyHistogram", "MetricsDumper", "RequestTrace",
    "Sampler", "StatsRegistry", "TailSampler", "Tracer", "Watchdog",
    "autopsy_dump", "clock_anchor",
    "current_request_trace", "current_tracer", "doctor_registry",
    "env_float", "env_int", "fleet_host",
    "flight_dump_path",
    "flight_recorder", "host_phase_totals", "install_flight_hooks",
    "level_totals",
    "note_worker_crash",
    "register_flight_registry", "register_flight_source",
    "render_openmetrics",
    "resolve_hang_s", "resolve_sample_ms", "resolve_tracer",
    "set_request_trace", "trace_summary", "unix_ns", "warn_env_once",
]

# version of every schema this module emits (the registry tree, the trace
# file's otherData, the histogram dict) — parsers of these documents key
# on it, and the parity tests hold the key sets to the reference's
OBS_VERSION = 1


# ---------------------------------------------------------------------------
# env knob parsing: malformed values degrade, never raise
# ---------------------------------------------------------------------------

# (name, raw) pairs already warned about — one line per bad value, not one
# per reader construction (a scan_files over 1000 shards must not log 1000x)
_env_warned: "set[tuple[str, str]]" = set()


def _env_num(name: str, default, cast, lo=None, hi=None):
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = cast(raw)
    except (TypeError, ValueError):
        key = (name, raw)
        if key not in _env_warned:
            _env_warned.add(key)
            import logging

            logging.getLogger(__name__).warning(
                "%s=%r is not a valid %s; using the default %r",
                name, raw, cast.__name__, default)
        return default
    if lo is not None and v < lo:
        v = lo
    if hi is not None and v > hi:
        v = hi
    return v


def env_float(name: str, default: float, lo=None, hi=None) -> float:
    """``float(os.environ[name])`` with the TPQ_HANG_POLICY degradation
    contract: unset → default; malformed → default plus ONE warning line
    (an env typo must never turn every reader construction into a raise);
    out-of-range values clamp to ``[lo, hi]``."""
    return _env_num(name, default, float, lo, hi)


def env_int(name: str, default: int, lo=None, hi=None) -> int:
    """Integer twin of :func:`env_float`, same degradation contract."""
    return _env_num(name, default, int, lo, hi)


def warn_env_once(name: str, raw: str, fallback) -> None:
    """One warning line per bad (env var, value) pair — the shared
    degradation mechanism for non-numeric knobs (TPQ_ON_DATA_ERROR,
    TPQ_VALIDATE, TPQ_DATA_ERROR_BUDGET) so a typo never raises and never
    floods the log (same `_env_warned` set as the numeric knobs)."""
    key = (name, raw)
    if key not in _env_warned:
        _env_warned.add(key)
        import logging

        logging.getLogger(__name__).warning(
            "%s=%r is not valid; using %r", name, raw, fallback)


# ---------------------------------------------------------------------------
# latency histograms
# ---------------------------------------------------------------------------

class LatencyHistogram:
    """Log2-bucketed latency distribution; lock-protected, mergeable.

    Bucket ``i`` holds durations whose nanosecond count has bit length ``i``
    (i.e. ``[2^(i-1), 2^i)`` ns; bucket 0 is exactly 0 ns) — ~62 sparse
    buckets cover 1 ns to minutes with <2x relative error, which is what a
    p50/p95 over decode stages needs.  Quantiles interpolate at the bucket's
    geometric midpoint.  ``merge_from`` folds another histogram in
    (thread-safe on both sides); ``as_dict``/``from_dict`` round-trip across
    process boundaries (the loader-resume shaped 2-process test).
    """

    __slots__ = ("_lock", "buckets", "count", "sum_seconds", "max_seconds",
                 "exemplars")

    def __init__(self):
        self._lock = threading.Lock()
        self.buckets: dict[int, int] = {}
        self.count = 0
        self.sum_seconds = 0.0
        self.max_seconds = 0.0
        # bucket idx -> [trace_id, seconds]: the most recent RETAINED trace
        # whose duration landed in that bucket — the OpenMetrics exemplar
        # (one per bucket, last-writer-wins; a map, not a ring, so the
        # memory bound is the bucket count)
        self.exemplars: "dict[int, list]" = {}

    @staticmethod
    def bucket_index(seconds: float) -> int:
        """The bucket a duration lands in (the ``record`` formula)."""
        ns = int(seconds * 1e9)
        return ns.bit_length() if ns > 0 else 0

    @staticmethod
    def bucket_upper_seconds(idx: int) -> float:
        """Bucket ``idx``'s exclusive upper bound in seconds (``2^idx`` ns;
        bucket 0 is exactly 0) — the OpenMetrics ``le`` value."""
        return 0.0 if idx <= 0 else (2.0 ** idx) / 1e9

    def record(self, seconds: float, exemplar: "str | None" = None) -> None:
        idx = self.bucket_index(seconds)
        with self._lock:
            self.buckets[idx] = self.buckets.get(idx, 0) + 1
            self.count += 1
            self.sum_seconds += seconds
            if seconds > self.max_seconds:
                self.max_seconds = seconds
            if exemplar is not None:
                # raw seconds, never rounded: the exemplar's value must
                # re-derive the SAME bucket index (fuzz target #23 checks)
                self.exemplars[idx] = [str(exemplar), seconds]

    def merge_from(self, other: "LatencyHistogram") -> None:
        with other._lock:
            snap = (dict(other.buckets), other.count, other.sum_seconds,
                    other.max_seconds, dict(other.exemplars))
        self._merge_snap(*snap)

    def _merge_snap(self, buckets, count, sum_s, max_s,
                    exemplars=None) -> None:
        with self._lock:
            for i, n in buckets.items():
                self.buckets[i] = self.buckets.get(i, 0) + n
            self.count += count
            self.sum_seconds += sum_s
            self.max_seconds = max(self.max_seconds, max_s)
            for i, ex in (exemplars or {}).items():
                self.exemplars[i] = list(ex)

    def quantile(self, q: float) -> float:
        """Approximate quantile in seconds (geometric bucket midpoint)."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            seen = 0
            for i in sorted(self.buckets):
                seen += self.buckets[i]
                if seen >= target:
                    if i == 0:
                        return 0.0
                    # bucket spans [2^(i-1), 2^i) ns: geometric midpoint
                    return (2.0 ** (i - 0.5)) / 1e9
            return self.max_seconds

    @property
    def mean_seconds(self) -> float:
        return self.sum_seconds / self.count if self.count else 0.0

    def as_dict(self) -> dict:
        with self._lock:
            buckets = {str(i): n for i, n in sorted(self.buckets.items())}
            count, sum_s, max_s = self.count, self.sum_seconds, self.max_seconds
            exemplars = {str(i): [ex[0], ex[1]]
                         for i, ex in sorted(self.exemplars.items())}
        out = {
            "count": count,
            "sum_seconds": round(sum_s, 6),
            "max_seconds": round(max_s, 6),
            "p50_seconds": round(self.quantile(0.50), 9),
            "p95_seconds": round(self.quantile(0.95), 9),
            "buckets": buckets,
        }
        if exemplars:
            # only when present: exemplar-free histograms keep the exact
            # key set the golden tests pin, and the round-trip below holds
            out["exemplars"] = exemplars
        return out

    @staticmethod
    def _parse_exemplars(d: dict) -> dict:
        return {int(i): [str(ex[0]), float(ex[1])]
                for i, ex in (d.get("exemplars") or {}).items()
                if isinstance(ex, (list, tuple)) and len(ex) == 2}

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls()
        h._merge_snap({int(i): int(n) for i, n in d.get("buckets", {}).items()},
                      int(d.get("count", 0)), float(d.get("sum_seconds", 0.0)),
                      float(d.get("max_seconds", 0.0)),
                      cls._parse_exemplars(d))
        return h

    def merge_dict(self, d: dict) -> None:
        """Fold a serialized histogram (another process's) into this one."""
        self._merge_snap(
            {int(i): int(n) for i, n in d.get("buckets", {}).items()},
            int(d.get("count", 0)), float(d.get("sum_seconds", 0.0)),
            float(d.get("max_seconds", 0.0)), self._parse_exemplars(d))


# ---------------------------------------------------------------------------
# request tracing: per-request span trees + tail sampling
# ---------------------------------------------------------------------------

# version of the retained-trace document (`RequestTrace.as_dict`,
# `TailSampler.dump`) — `pq_tool trace --request` keys on it
TRACE_VERSION = 1

# process-unique trace-id minting: a random base per process plus a
# counter, so ids stay unique across services in one process and collide
# across processes only with 2^-32 probability
_trace_lock = threading.Lock()
_trace_base = os.urandom(4).hex()
_trace_seq = 0


def _mint_trace_id() -> str:
    global _trace_seq
    with _trace_lock:
        _trace_seq += 1
        return f"{_trace_base}-{_trace_seq:06x}"


_fleet_host_cache: "str | None" = None


def fleet_host() -> str:
    """This process's host name as it appears in spool snapshots and
    stitched traces (cached; never raises)."""
    global _fleet_host_cache
    if _fleet_host_cache is None:
        try:
            _fleet_host_cache = os.uname().nodename or "localhost"
        except (AttributeError, OSError):
            _fleet_host_cache = "localhost"
    return _fleet_host_cache


class _TraceSpan:
    """Span context manager for :class:`RequestTrace` (slots, one lock
    round-trip per open and per close)."""

    __slots__ = ("_tr", "_idx")

    def __init__(self, tr, idx):
        self._tr = tr
        self._idx = idx

    def __enter__(self):
        return self

    def __exit__(self, tp, val, tb):
        self._tr._close(self._idx, val)
        return False


class RequestTrace:
    """One request's span tree: allocation-light, always on, completed for
    EVERY request so the tail sampler can decide afterwards (Dapper-style
    tail sampling needs the whole tree in hand at the decision point).

    Spans are small lists ``[name, t0_rel, dur, parent, args]`` appended at
    OPEN time, so a parent's index is always smaller than its children's
    (the well-nestedness invariant fuzz target #23 checks).  Nesting is
    per-thread: each thread keeps its own open-span stack, and the first
    span a helper thread opens parents to the top-level (the producer /
    prefetch-worker / fetch-engine spans hang off the request root without
    cross-thread stack corruption).  A ``max_spans`` cap bounds memory per
    request (``TPQ_TRACE_SPANS``); drops are counted, never silent.
    """

    __slots__ = ("trace_id", "t0", "t0_unix", "duration_s", "spans",
                 "max_spans", "dropped", "error", "flags", "origin",
                 "_lock", "_local")

    def __init__(self, trace_id: "str | None" = None,
                 max_spans: "int | None" = None):
        if max_spans is None:
            max_spans = env_int("TPQ_TRACE_SPANS", 512, lo=1)
        self.trace_id = trace_id or _mint_trace_id()
        self.origin: "dict | None" = None
        self.t0 = time.perf_counter()
        self.t0_unix = time.time()
        self.duration_s: "float | None" = None
        self.spans: list = []  # [name, t0_rel, dur, parent, args]
        self.max_spans = int(max_spans)
        self.dropped = 0
        self.error: "dict | None" = None
        self.flags: set = set()
        self._lock = threading.Lock()
        self._local = threading.local()

    # -- recording ------------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args):
        """Open a nested span (context manager).  Over the cap: counted
        drop, shared no-op."""
        st = self._stack()
        parent = st[-1] if st else -1
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return _NULL_SPAN
            idx = len(self.spans)
            self.spans.append([name, time.perf_counter() - self.t0, None,
                               parent, args or None])
        st.append(idx)
        return _TraceSpan(self, idx)

    def _close(self, idx: int, exc) -> None:
        now = time.perf_counter() - self.t0
        st = self._stack()
        # pop through idx: an interleaved close (fuzzed op streams) closes
        # the children it skipped, keeping every retained tree well-nested
        while st and st[-1] >= idx:
            st.pop()
        with self._lock:
            s = self.spans[idx]
            if s[2] is None:
                s[2] = max(now - s[1], 0.0)
            if exc is not None:
                args = s[4] or {}
                args["error"] = type(exc).__name__
                s[4] = args

    def add_timed(self, name: str, t0: float, t1: float, **args) -> None:
        """Record an already-timed interval (perf_counter seconds) as a
        closed child of the current thread's open span."""
        st = self._stack()
        parent = st[-1] if st else -1
        with self._lock:
            if len(self.spans) >= self.max_spans:
                self.dropped += 1
                return
            self.spans.append([name, t0 - self.t0, max(t1 - t0, 0.0),
                               parent, args or None])

    def annotate(self, idx: "int | None" = None, **kv) -> None:
        """Attach facts to a span (default: the current thread's open
        one) — retry counts, hedge outcomes, byte sizes."""
        st = self._stack()
        if idx is None:
            idx = st[-1] if st else None
        if idx is None:
            return
        with self._lock:
            if 0 <= idx < len(self.spans):
                s = self.spans[idx]
                args = s[4] or {}
                args.update(kv)
                s[4] = args

    def mark_error(self, exc: BaseException) -> None:
        with self._lock:
            self.error = {"type": type(exc).__name__,
                          "message": str(exc)[:300]}

    def set_flag(self, flag: str) -> None:
        """Request-level outcome flags the sampler keys on
        (``deadline``, ``shed``, ``cancelled``)."""
        with self._lock:
            self.flags.add(str(flag))

    def finish(self) -> float:
        """Close the tree (idempotent); returns the request duration."""
        with self._lock:
            if self.duration_s is None:
                self.duration_s = time.perf_counter() - self.t0
            # close any span left open by an abandoned thread: a retained
            # tree never carries null durations
            for s in self.spans:
                if s[2] is None:
                    s[2] = max((self.t0 + self.duration_s)
                               - (self.t0 + s[1]), 0.0)
            return self.duration_s

    # -- cross-process stitching ----------------------------------------------

    def trace_context(self) -> dict:
        """Exportable context blob identifying this request across process
        seams — hand it (e.g. JSON via ``TPQ_TRACE_CONTEXT``) to a child
        process whose traces should re-parent under this request."""
        return {
            "trace_version": TRACE_VERSION,
            "trace_id": self.trace_id,
            "host": fleet_host(),
            "pid": os.getpid(),
            "t0_unix": round(self.t0_unix, 3),
        }

    @classmethod
    def adopt_context(cls, ctx: dict,
                      max_spans: "int | None" = None) -> "RequestTrace":
        """Create a child-process trace re-parented under the originating
        request described by ``ctx`` (a :meth:`trace_context` blob).  The
        child gets its OWN trace id (ids stay process-unique); ``origin``
        records the parent so the aggregated view can stitch the trees.
        Raises ``ValueError`` on a malformed blob — callers adopting from
        an env var degrade via ``warn_env_once`` instead."""
        if not isinstance(ctx, dict):
            raise ValueError(f"trace context must be a dict, got "
                             f"{type(ctx).__name__}")
        tid = ctx.get("trace_id")
        if not isinstance(tid, str) or not tid:
            raise ValueError(f"trace context missing trace_id: {ctx!r}")
        tr = cls(max_spans=max_spans)
        tr.origin = {"trace_id": tid,
                     "host": str(ctx.get("host") or "unknown"),
                     "pid": int(ctx.get("pid") or 0)}
        return tr

    # -- export ---------------------------------------------------------------

    def as_dict(self) -> dict:
        with self._lock:
            spans = [{
                "name": s[0],
                "t_s": round(s[1], 6),
                "dur_s": round(s[2], 6) if s[2] is not None else None,
                "parent": s[3],
                **({"args": s[4]} if s[4] else {}),
            } for s in self.spans]
            doc = {
                "trace_version": TRACE_VERSION,
                "trace_id": self.trace_id,
                "host": fleet_host(),
                "pid": os.getpid(),
                "t0_unix": round(self.t0_unix, 3),
                "duration_s": (round(self.duration_s, 6)
                               if self.duration_s is not None else None),
                "error": self.error,
                "flags": sorted(self.flags),
                "dropped": self.dropped,
                "spans": spans,
            }
            if self.origin:
                doc["origin"] = dict(self.origin)
            return doc


# the request trace of the thread currently executing a request — how code
# with no token in hand (plan/result cache probes, device dispatch) finds
# the trace; serve workers and stream producers set/restore it per unit
_req_local = threading.local()


def current_request_trace() -> "RequestTrace | None":
    return getattr(_req_local, "trace", None)


def set_request_trace(trace: "RequestTrace | None"):
    """Install ``trace`` as this thread's current request trace; returns
    the previous one (callers restore it, nesting-safe)."""
    prev = getattr(_req_local, "trace", None)
    _req_local.trace = trace
    return prev


class TailSampler:
    """Tail sampler + bounded retained-trace ring.

    Every request's completed tree is ``offer()``-ed with its outcome; the
    sampler RETAINS the interesting ones — errored, deadline-exceeded,
    brownout-shed, slower than a rolling quantile of its own traffic
    (``TPQ_TRACE_SLOW_Q`` over an internal :class:`LatencyHistogram`), or
    1-in-N (``TPQ_TRACE_TAIL``; 1 retains everything, 0 disables request
    tracing entirely) — serialized into a ring bounded by BYTES
    (``TPQ_TRACE_RING``), evicting oldest-first.  ``offer`` returns whether
    the trace was retained, so exemplars only ever name a trace that can
    actually be fetched back (``get``/``dump`` → ``pq_tool trace
    --request``).
    """

    # the rolling-quantile gate needs this many samples before "slow" means
    # anything; below it only errors/flags/1-in-N retain
    SLOW_MIN_SAMPLES = 32

    def __init__(self, one_in_n: "int | None" = None,
                 ring_bytes: "int | None" = None,
                 slow_q: "float | None" = None):
        if one_in_n is None:
            one_in_n = env_int("TPQ_TRACE_TAIL", 128, lo=0)
        if ring_bytes is None:
            ring_bytes = env_int("TPQ_TRACE_RING", 1 << 20, lo=4096)
        if slow_q is None:
            slow_q = env_float("TPQ_TRACE_SLOW_Q", 0.95, lo=0.5, hi=0.9999)
        self.one_in_n = int(one_in_n)
        self.ring_bytes = int(ring_bytes)
        self.slow_q = float(slow_q)
        self._lock = threading.Lock()
        self._ring: "deque[tuple[str, bytes]]" = deque()
        self._index: dict[str, bytes] = {}
        self._hist = LatencyHistogram()
        self.offered = 0
        self.retained = 0
        self.evicted = 0
        self.retained_bytes = 0

    @property
    def enabled(self) -> bool:
        return self.one_in_n > 0

    def offer(self, trace: RequestTrace, duration_s: "float | None" = None,
              error: bool = False) -> bool:
        """Decide on a completed trace; retain interesting ones.  Returns
        True iff retained (the exemplar gate)."""
        if not self.enabled:
            return False
        dur = trace.finish() if duration_s is None else float(duration_s)
        slow_bar = None
        if self._hist.count >= self.SLOW_MIN_SAMPLES:
            slow_bar = self._hist.quantile(self.slow_q)
        self._hist.record(dur)
        with self._lock:
            self.offered += 1
            keep = (error or trace.error is not None or bool(trace.flags)
                    or (slow_bar is not None and dur >= slow_bar)
                    or self.offered % self.one_in_n == 0)
        if not keep:
            return False
        blob = json.dumps(trace.as_dict(), default=repr).encode()
        with self._lock:
            if len(blob) > self.ring_bytes:
                return False  # one pathological tree must not flush the ring
            self._ring.append((trace.trace_id, blob))
            self._index[trace.trace_id] = blob
            self.retained += 1
            self.retained_bytes += len(blob)
            while self.retained_bytes > self.ring_bytes and len(self._ring) > 1:
                old_id, old = self._ring.popleft()
                self.retained_bytes -= len(old)
                self.evicted += 1
                if self._index.get(old_id) is old:
                    del self._index[old_id]
        return True

    def get(self, trace_id: str) -> "dict | None":
        with self._lock:
            blob = self._index.get(trace_id)
        return json.loads(blob) if blob is not None else None

    def traces(self) -> "list[dict]":
        with self._lock:
            blobs = [b for _, b in self._ring]
        return [json.loads(b) for b in blobs]

    def counters(self) -> dict:
        with self._lock:
            return {
                "offered": self.offered,
                "retained": self.retained,
                "evicted": self.evicted,
                "retained_bytes": self.retained_bytes,
                "ring_capacity_bytes": self.ring_bytes,
            }

    def dump(self, path: str) -> str:
        """Write the retained traces (versioned; the ``pq_tool trace
        --request`` input).  Same mkdir-parents contract as Tracer.write."""
        doc = {"trace_dump_version": TRACE_VERSION, "traces": self.traces()}
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path


# ---------------------------------------------------------------------------
# flight recorder: the always-on black box
# ---------------------------------------------------------------------------

# version of the dump snapshot schema `FlightRecorder.dump` writes and
# `autopsy_dump` consumes — golden-key-tested like the registry tree
FLIGHT_VERSION = 1

# live providers the dump pulls from (module-level, not per-recorder, so a
# test's private recorder still sees the process's live pipelines/readers):
# weakrefs only — registration must never extend a reader's lifetime
_flight_lock = threading.Lock()
_flight_sources: "list[tuple[str, weakref.ref, str]]" = []
_flight_registries: "list[tuple[weakref.ref, str]]" = []


def _prune_providers(lst) -> None:
    lst[:] = [entry for entry in lst if entry[-2]() is not None]


def register_flight_source(label: str, obj, method: str = "sample") -> None:
    """Register a live counter source (``obj.method() -> {name: number}``)
    for flight dumps — e.g. every :class:`~tpu_parquet_torch.pipeline
    .PipelineStats` registers its ``sample`` so a dump shows the per-lane
    seconds and queue depth at the moment of the wedge.  Weakly held."""
    with _flight_lock:
        _prune_providers(_flight_sources)
        _flight_sources.append((label, weakref.ref(obj), method))


def register_flight_registry(obj, method: str = "obs_registry") -> None:
    """Register a live registry provider (``obj.method() ->
    StatsRegistry``): readers and loaders register themselves so a dump
    embeds the same tree a clean close would have written.  Weakly held."""
    with _flight_lock:
        _prune_providers(_flight_registries)
        _flight_registries.append((weakref.ref(obj), method))


def flight_dump_path() -> str:
    """Where unsolicited dumps land: ``TPQ_FLIGHT`` when set, else
    ``tpq_flight.<pid>.json`` in the working directory."""
    return os.environ.get("TPQ_FLIGHT") or f"tpq_flight.{os.getpid()}.json"


class FlightRecorder:
    """Always-on bounded in-memory ring of recent trace events.

    One ``deque(maxlen=capacity)`` per thread (``TPQ_RING_EVENTS`` events
    each, default 256; 0 disables), appended lock-free on the hot path (a
    thread only ever appends to its own ring; CPython deque appends are
    atomic) — the recording cost is one thread-local attribute read, a
    tuple build, and an append, guarded <3% by the tier-1 overhead test.
    A chatty thread can never evict a stalled thread's history, which is
    exactly the history a hang autopsy needs.

    ``snapshot()``/``dump()`` produce the versioned post-mortem document:
    ring events per thread with ages, every thread's current stack, live
    budget/tracker/pipeline state, and the merged live registry tree.
    Dumping never raises into the caller's control flow beyond I/O errors
    on the explicit path — every provider is individually guarded.
    """

    def __init__(self, capacity: "int | None" = None):
        if capacity is None:
            capacity = env_int("TPQ_RING_EVENTS", 256, lo=0)
        self.capacity = max(int(capacity), 0)
        self._lock = threading.Lock()
        self._threads: "dict[int, tuple[str, deque]]" = {}
        self._local = threading.local()

    @property
    def enabled(self) -> bool:
        return self.capacity > 0

    # -- recording (hot path) -------------------------------------------------

    def _register_thread(self) -> deque:
        t = threading.current_thread()
        ring: deque = deque(maxlen=self.capacity)
        with self._lock:
            # keyed by ident: reused idents overwrite their dead
            # predecessor, so the map stays bounded by live threads
            self._threads[t.ident or 0] = (t.name, ring)
        self._local.ring = ring
        return ring

    def record(self, ph: str, name: str, ts: float, dur: float = 0.0,
               args: "dict | None" = None) -> None:
        """Append one event (``ts``/``dur`` in perf_counter seconds)."""
        if not self.capacity:
            return
        try:
            ring = self._local.ring
        except AttributeError:
            ring = self._register_thread()
        ring.append((ph, name, ts, dur, args))

    # -- snapshot / dump ------------------------------------------------------

    @staticmethod
    def _format_stack(frame) -> "list[dict]":
        import traceback

        out = []
        for fs in traceback.extract_stack(frame):
            out.append({"file": fs.filename, "line": fs.lineno,
                        "func": fs.name, "code": fs.line or ""})
        return out  # outermost first, same order as a printed traceback

    def snapshot(self, reason: str = "explicit",
                 watchdog: "dict | None" = None,
                 error: "BaseException | None" = None) -> dict:
        now_p = time.perf_counter()
        with self._lock:
            rings = list(self._threads.items())
        threads = {}
        for tid, (name, ring) in rings:
            # writers append to their own ring lock-free (by design), and a
            # CPython deque raises if mutated during iteration even at
            # constant maxlen size — retry the copy; a busy thread's ring
            # settles between appends, and a dump must never be lost to it
            events: list = []
            for _ in range(5):
                try:
                    events = list(ring)
                    break
                except RuntimeError:
                    continue
            threads[tid] = (name, events)
        frames = sys._current_frames()
        # `or 0`: enumerate() can briefly surface a thread whose ident is
        # not yet assigned (mid-start) — it must not break the dump
        alive = {(t.ident or 0): t.name for t in threading.enumerate()}
        tout: dict = {}
        for tid in sorted(set(threads) | set(frames) | set(alive)):
            name, ring = threads.get(tid, (alive.get(tid, "?"), []))
            events = [{
                "ph": ph, "name": nm,
                "age_s": round(now_p - ts, 6),
                "dur_s": round(dur, 6),
                **({"args": a} if a else {}),
            } for ph, nm, ts, dur, a in ring]
            entry: dict = {
                "name": alive.get(tid, name),
                "alive": tid in alive,
                "events": events,
                "last_event": events[-1] if events else None,
            }
            f = frames.get(tid)
            if f is not None:
                try:
                    entry["stack"] = self._format_stack(f)
                except Exception:  # noqa: BLE001 — a dump must not fail
                    entry["stack"] = []
            tout[str(tid)] = entry
        # the frames map holds this very frame, whose locals hold the map:
        # left bound, that cycle keeps every thread's frames at the dump
        # (a hung scan's staged tensors among them) until a collection
        frames = f = None
        doc = {
            "flight_version": FLIGHT_VERSION,
            "obs_version": OBS_VERSION,
            "reason": reason,
            "ts": round(time.time(), 3),
            "pid": os.getpid(),
            "ring_capacity": self.capacity,
            "threads": tout,
            "watchdog": watchdog,
            "error": ({"type": type(error).__name__,
                       "message": str(error)[:500]}
                      if error is not None else None),
            # the events' ages count back from this anchor's perf_counter
            # reading: unix_ns - age_s * 1e9 puts them on the wall clock
            "clock_sync": clock_anchor(),
        }
        try:
            from . import alloc

            doc["budgets"] = alloc.budget_snapshots()
            doc["trackers"] = alloc.tracker_snapshots()
        except Exception:  # noqa: BLE001
            doc["budgets"], doc["trackers"] = [], []
        samples: dict = {}
        with _flight_lock:
            sources = list(_flight_sources)
            registries = list(_flight_registries)
        for label, ref, method in sources:
            obj = ref()
            if obj is None:
                continue
            try:
                v = getattr(obj, method)()
            except Exception:  # noqa: BLE001 — a dead source never kills a dump
                continue
            if isinstance(v, dict):
                samples[label] = v
        doc["samples"] = samples
        reg_tree = None
        merged = StatsRegistry()
        found = False
        for ref, method in registries:
            obj = ref()
            if obj is None:
                continue
            try:
                merged.merge_from(getattr(obj, method)())
                found = True
            except Exception:  # noqa: BLE001
                continue
        if found:
            try:
                reg_tree = merged.as_dict()
            except Exception:  # noqa: BLE001
                reg_tree = None
        doc["registry"] = reg_tree
        return doc

    def dump(self, path: "str | None" = None, reason: str = "explicit",
             watchdog: "dict | None" = None,
             error: "BaseException | None" = None) -> str:
        """Write a snapshot to ``path`` (default :func:`flight_dump_path`);
        returns the path.  Same mkdir-parents contract as Tracer.write."""
        doc = self.snapshot(reason=reason, watchdog=watchdog, error=error)
        path = path or flight_dump_path()
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f, default=repr)
            f.write("\n")
        return path


_flight: "FlightRecorder | None" = None


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (capacity from ``TPQ_RING_EVENTS``
    at first use).  Always returns an object; with capacity 0 its record
    calls are no-ops and tracers skip the tee entirely."""
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                _flight = FlightRecorder()
    return _flight


# ---------------------------------------------------------------------------
# one clock with the device trace
# ---------------------------------------------------------------------------

def clock_anchor() -> dict:
    """``perf_counter`` (the tracer's and the flight ring's clock) and
    ``time.time_ns()`` (the wall clock ``torch.profiler``'s device events
    carry) read together: ``{"perf_counter_s", "unix_ns"}``, the
    ``perf_counter`` reading the midpoint of two around the wall clock's."""
    p0 = time.perf_counter()
    u = time.time_ns()
    p1 = time.perf_counter()
    return {"perf_counter_s": (p0 + p1) / 2, "unix_ns": u}


def unix_ns(t: float, anchor: "dict | None" = None) -> int:
    """A ``perf_counter`` second ``t`` on the wall clock, in ns since the
    epoch, through ``anchor`` (a :func:`clock_anchor`; default: one read
    now, so the two clocks' drift counts only from ``t`` to the call)."""
    a = clock_anchor() if anchor is None else anchor
    return a["unix_ns"] + round((t - a["perf_counter_s"]) * 1e9)


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------

class _NullSpan:
    """The shared no-op context manager a disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tr", "_name", "_args", "_t0")

    def __init__(self, tr, name, args):
        self._tr = tr
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._tr.complete(self._name, self._t0, time.perf_counter(),
                          **self._args)
        return False


class Tracer:
    """Thread-safe span tracer with Chrome trace-event JSON export.

    Spans are recorded as complete events (``ph: "X"``: one event carrying
    ``ts`` + ``dur`` in microseconds on the shared ``perf_counter`` clock),
    so nesting is implied by containment — Perfetto and ``chrome://tracing``
    rebuild the flame graph per (pid, tid) without begin/end pairing.
    ``instant``/``counter`` events carry point-in-time facts (a chunk's
    chosen ship route, the shuffle window's occupancy).  The export leads
    with a ``clock_sync`` metadata event: :func:`clock_anchor` read at the
    tracer's creation (``created``) and at the export (``exported``), so a
    span's ``ts`` maps onto the device trace's wall clock and the two
    clocks' drift over the run shows.

    When ``enabled`` is False every record call is one ``if`` and ``span()``
    returns a module-level no-op singleton — the hot loops keep their obs
    calls unconditionally and pay <3% (tier-1 guarded).

    Every tracer additionally TEES its events into a
    :class:`FlightRecorder` ring (the process recorder by default, even
    when disabled — that is the black box: the last N events per thread
    survive in memory with no ``TPQ_TRACE`` set).  ``ring=None`` opts a
    tracer out entirely; hot-path guards check :attr:`active` (enabled OR
    ring-teed) so span timing happens exactly when someone is listening.
    """

    def __init__(self, path: "str | None" = None, enabled: bool = True,
                 ring: "FlightRecorder | None | type[Ellipsis]" = ...):
        self.enabled = bool(enabled)
        self.path = path
        if ring is ...:
            ring = flight_recorder()
        self.ring = ring if (ring is not None and ring.enabled) else None
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._pid = os.getpid()
        self._named_tids: set[int] = set()
        self._written = False
        self.clock_sync = clock_anchor()
        if path is not None and self.enabled:
            atexit.register(self._atexit_write)

    @property
    def active(self) -> bool:
        """True when recording anywhere (the event list or the flight
        ring) — the guard hot loops use around building span args."""
        return self.enabled or self.ring is not None

    # -- recording ------------------------------------------------------------

    def _tid(self) -> int:
        t = threading.current_thread()
        tid = t.ident or 0
        if tid not in self._named_tids:
            with self._lock:
                if tid not in self._named_tids:  # re-check under the lock
                    self._named_tids.add(tid)
                    self._events.append({
                        "name": "thread_name", "ph": "M",
                        "pid": self._pid, "tid": tid,
                        "args": {"name": t.name},
                    })
        return tid

    def span(self, name: str, **args):
        """Context manager timing a nested span (no-op when neither the
        event list nor the flight ring is recording)."""
        if not self.enabled and self.ring is None:
            return _NULL_SPAN
        return _Span(self, name, args)

    def complete(self, name: str, t0: float, t1: float, **args) -> None:
        """Record an already-timed interval (perf_counter seconds)."""
        ring = self.ring
        if ring is not None:
            ring.record("X", name, t0, t1 - t0, args or None)
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "X", "ts": int(t0 * 1e6),
            "dur": max(int((t1 - t0) * 1e6), 0),
            "pid": self._pid, "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, **args) -> None:
        ring = self.ring
        if ring is not None:
            ring.record("i", name, time.perf_counter(), 0.0, args or None)
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "i", "s": "t",
            "ts": int(time.perf_counter() * 1e6),
            "pid": self._pid, "tid": self._tid(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, track_id=None, **values) -> None:
        """One counter sample.  ``track_id`` sets the trace event's ``id``
        field: Chrome counter tracks are keyed ``(pid, name[, id])``, so
        same-named counters from different emitters (two readers of one
        ``scan_files`` sampling onto the shared tracer) render as separate
        ``name[id]`` tracks instead of interleaving into one sawtooth."""
        ring = self.ring
        if ring is not None:
            ring.record("C", name, time.perf_counter(), 0.0, values or None)
        if not self.enabled:
            return
        ev = {
            "name": name, "ph": "C",
            "ts": int(time.perf_counter() * 1e6),
            "pid": self._pid, "tid": self._tid(),
            "args": values,
        }
        if track_id is not None:
            ev["id"] = str(track_id)
        with self._lock:
            self._events.append(ev)

    # -- merge / export -------------------------------------------------------

    def merge_events(self, events: list) -> None:
        """Fold exported events (typically another process's) in verbatim —
        pids differ, so Perfetto renders them as separate process tracks."""
        with self._lock:
            self._events.extend(events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def export(self, registry: "StatsRegistry | None" = None) -> dict:
        """The Chrome trace-event *object form*: events plus ``otherData``
        (obs version, and the registry tree when given — so one artifact
        carries both the timeline and the aggregate metrics)."""
        other: dict = {"obs_version": OBS_VERSION}
        if registry is not None:
            other["registry"] = registry.as_dict()
        sync = {"name": "clock_sync", "ph": "M", "pid": self._pid, "tid": 0,
                "args": {"created": self.clock_sync,
                         "exported": clock_anchor()}}
        return {
            "traceEvents": [sync, *self.events()],
            "displayTimeUnit": "ms",
            "otherData": other,
        }

    def write(self, path: "str | None" = None,
              registry: "StatsRegistry | None" = None) -> "str | None":
        """Serialize to ``path`` (default: the construction path).  Missing
        parent directories are created here, not discovered at close time:
        ``TPQ_TRACE=runs/today/t.json`` into a fresh tree must not fail with
        a late FileNotFoundError after the run already happened."""
        path = path or self.path
        if path is None:
            return None
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.export(registry), f)
            f.write("\n")
        self._written = True
        return path

    def _atexit_write(self) -> None:
        if self._written or not self._events:
            return
        try:
            self.write()
        except OSError:
            pass  # interpreter teardown: a dead path must not mask the exit


_DISABLED = Tracer(enabled=False)
_global: "Tracer | None" = None
_global_key: "str | None" = None
_global_lock = threading.Lock()


def current_tracer() -> Tracer:
    """The process-wide tracer: enabled iff ``TPQ_TRACE=<path>`` is set
    (rebuilt when the env changes, so monkeypatched tests see theirs); the
    shared disabled singleton otherwise."""
    global _global, _global_key
    key = os.environ.get("TPQ_TRACE", "")
    if not key:
        return _DISABLED if _global_key in (None, "") else _refresh("")
    with _global_lock:
        if _global is None or _global_key != key:
            _global = Tracer(path=key)
            _global_key = key
        return _global


def _refresh(key: str) -> Tracer:
    global _global, _global_key
    with _global_lock:
        _global, _global_key = None, key
    return _DISABLED


def resolve_tracer(trace) -> "tuple[Tracer, bool]":
    """Resolve a ``trace=`` kwarg to ``(tracer, owned)``.

    ``None`` → the process tracer (owned by the process, not the caller);
    a path → a fresh enabled tracer the CALLER must ``write()`` (readers do
    so in ``close()``); a :class:`Tracer` → itself, not owned.
    """
    if trace is None:
        return current_tracer(), False
    if isinstance(trace, Tracer):
        return trace, False
    return Tracer(path=os.fspath(trace)), True


# ---------------------------------------------------------------------------
# counter sampler
# ---------------------------------------------------------------------------

def resolve_sample_ms(sample_ms=None) -> float:
    """Resolve a ``sample_ms=`` kwarg against ``TPQ_SAMPLE_MS`` (kwarg wins;
    0 or unset disables sampling)."""
    if sample_ms is not None:
        try:
            return max(float(sample_ms), 0.0)
        except (TypeError, ValueError):
            return 0.0
    return env_float("TPQ_SAMPLE_MS", 0.0, lo=0.0)


class Sampler:
    """Daemon thread snapshotting counter sources into a tracer every N ms.

    The tracer's spans say how long each unit of work took; this says what
    the whole machine looked like OVER TIME — Chrome counter tracks of the
    cumulative stage seconds (their slope is live per-lane throughput), the
    prefetch queue depth, and the alloc watermarks, so Perfetto shows
    throughput/backpressure *curves* instead of end totals and a stall is
    visible as the flat stretch where every curve stops climbing.

    Sources are zero-arg callables returning ``{counter: number}``; each
    tick emits one ``tracer.counter(track, **values)`` per source.  A
    source that raises is skipped for that tick (``dropped`` counts them) —
    sampling must never take the run down.  Inert (``start`` is a no-op)
    when the tracer is disabled or the interval is 0, so callers wire it
    unconditionally.  Shutdown is thread-leak-safe: ``stop()`` joins the
    thread (which emits one final sample so the track's last point is the
    end state), and the thread is a daemon so an abandoned sampler can
    never hold the interpreter open.
    """

    def __init__(self, tracer: "Tracer | None", interval_ms: float,
                 name: str = "tpq-sampler", track_id=None):
        self.tracer = tracer
        self.interval_s = max(float(interval_ms or 0.0), 0.0) / 1e3
        self.name = name
        # forwarded as the counter events' Chrome track id so concurrent
        # samplers (scan_files opens several readers) keep separate tracks
        self.track_id = track_id
        self._sources: list = []  # [(track, fn)]
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._thread: "threading.Thread | None" = None
        self.ticks = 0
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return (self.tracer is not None and self.tracer.enabled
                and self.interval_s > 0)

    def add_source(self, track: str, fn) -> "Sampler":
        with self._lock:
            self._sources.append((track, fn))
        return self

    def start(self) -> "Sampler":
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the sampling thread (no leak, tier-1 guarded)."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "Sampler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        while True:
            self.sample_once()
            if self._stop.wait(self.interval_s):
                self.sample_once()  # final point: the track ends at the end state
                return

    def sample_once(self) -> None:
        with self._lock:
            sources = list(self._sources)
        for track, fn in sources:
            try:
                values = fn()
            except Exception:  # noqa: BLE001 — sampling never kills the run
                self.dropped += 1
                continue
            if not values:
                continue
            nums = {k: v for k, v in values.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
            nums.pop("track_id", None)  # reserved for the keyword below
            if nums:
                # the EMIT side is guarded like the read side: scan_files
                # can close/write the shared tracer while a sibling
                # reader's sampler (or the watchdog) still ticks, and a
                # torn-down tracer must drop the tick, not kill the daemon
                # thread mid-run (satellite: shared-cadence hygiene)
                try:
                    self.tracer.counter(track, track_id=self.track_id, **nums)
                except Exception:  # noqa: BLE001
                    self.dropped += 1
        self.ticks += 1


# ---------------------------------------------------------------------------
# host-phase parts: where the device read's host phase spends its time
# ---------------------------------------------------------------------------

# the timed parts, in the order their indices run, then the remainder;
# ``level_walk`` holds the run-header walks (and host decodes) of def and
# rep level streams, ``run_walk`` every other structure walk
HOST_PARTS = ("read", "crc", "decompress", "page_parse", "run_walk",
              "snappy_walk", "transcode", "host_copy", "level_walk",
              "python")
(PART_READ, PART_CRC, PART_DECOMPRESS, PART_PAGE_PARSE, PART_RUN_WALK,
 PART_SNAPPY_WALK, PART_TRANSCODE, PART_HOST_COPY,
 PART_LEVEL_WALK) = range(9)
_N_TIMED = len(HOST_PARTS) - 1


class _HostTLS(threading.local):
    unit = None  # the class default: a thread with no unit reads None


_host_tls = _HostTLS()
_perf = time.perf_counter


class _HostUnit:
    """One unit of a reader's host phase on one thread: a row group's
    prepare on the caller, or one chunk's collection on a chunk-feed
    worker.  ``inner`` is the time of the timed parts run inside the part
    now open, which that part leaves out of its own (self time).
    ``open_n`` / ``open_s``: snappy tag walks whose plan is not yet used
    or thrown away."""

    __slots__ = ("parts", "inner", "walks", "retries", "declined", "wasted",
                 "open_n", "open_s", "outer", "cpu0", "chunk_walks",
                 "walk_fallbacks")

    def __init__(self, outer):
        self.parts = [0.0] * _N_TIMED
        self.inner = 0.0
        self.walks = self.retries = self.declined = 0
        self.wasted = self.open_s = 0.0
        self.open_n = 0
        self.outer = outer
        self.cpu0 = time.thread_time()
        self.chunk_walks = 0
        self.walk_fallbacks = None  # {reason: chunks}, made on first use


def host_unit() -> "_HostUnit | None":
    """The host-phase unit open on this thread, or None."""
    return _host_tls.unit


def timed_part(part: int, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds added to ``part`` of the unit
    open on this thread (less the parts timed inside it); without a unit,
    just the call."""
    u = _host_tls.unit
    if u is None:
        return fn(*args, **kwargs)
    outer = u.inner
    u.inner = 0.0
    t0 = _perf()
    try:
        return fn(*args, **kwargs)
    finally:
        dt = _perf() - t0
        u.parts[part] += dt - u.inner
        u.inner = outer + dt


def host_part(part: int, walk_counts: bool = False):
    """Decorator: every call of the function is :func:`timed_part` (its
    body inlined: the per-page leaves pay no second Python frame).

    With ``walk_counts`` (the snappy tag walk, ``native.snappy_plan``) the
    call's self time also goes to the walk counts, from the same two clock
    reads: the attempts restarted inside the call add theirs to ``wasted``
    as they fail, and the rest goes to the walk the call leaves open, if it
    leaves one.  So a walk thrown away whole (:func:`snappy_walks_settle`)
    adds to ``wasted_seconds`` exactly what it added to the part."""
    def deco(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            u = _host_tls.unit
            if u is None:
                return fn(*args, **kwargs)
            outer = u.inner
            u.inner = 0.0
            if walk_counts:
                wasted0, open0 = u.wasted, u.open_n
            t0 = _perf()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = _perf() - t0
                own = dt - u.inner
                u.parts[part] += own
                u.inner = outer + dt
                if walk_counts and u.open_n > open0:
                    u.open_s += own - (u.wasted - wasted0)
        return timed
    return deco


def split_part(rest: int, seconds: float, measured) -> None:
    """Add a native call of ``seconds`` to the unit open on this thread:
    each ``(part, seconds)`` of ``measured`` as the call timed it inside,
    the rest of the call to ``rest``.  The call must run no timed part."""
    u = _host_tls.unit
    if u is None:
        return
    inside = 0.0
    for part, s in measured:
        u.parts[part] += s
        inside += s
    u.parts[rest] += seconds - inside
    u.inner += seconds


def note_chunk_walk(fallback: "str | None") -> None:
    """One column chunk collected: walked in one native call (``None``), or
    through the page loop for ``fallback``, the reason the walk declined."""
    u = _host_tls.unit
    if u is None:
        return
    if fallback is None:
        u.chunk_walks += 1
        return
    if u.walk_fallbacks is None:
        u.walk_fallbacks = {}
    u.walk_fallbacks[fallback] = u.walk_fallbacks.get(fallback, 0) + 1


def snappy_walks_settle(used: bool) -> None:
    """The snappy tag walks made since the last settle have been staged
    (``used``) or thrown away: those count in ``declined`` and their
    seconds in ``wasted_seconds``.  A walk never settled counts as used."""
    u = _host_tls.unit
    if u is None:
        return
    if not used:
        u.declined += u.open_n
        u.wasted += u.open_s
    u.open_n, u.open_s = 0, 0.0


# level streams: the two kinds, and the routes a stream's expansion takes
# (the fused K1 ``hybrid_unpack_combine``, the run-table expand, or the
# host decode of ``torch_decode.DeviceChunkDecoder``)
LEVEL_KINDS = ("def", "rep")
LEVEL_ROUTES = ("k1", "run_table", "host")


class _LevelCounts:
    """Level streams and slots planned in the process, by kind and by
    route; always on (one update a column chunk and kind)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.streams = dict.fromkeys(LEVEL_KINDS + LEVEL_ROUTES, 0)
        self.slots = dict.fromkeys(LEVEL_KINDS + LEVEL_ROUTES, 0)

    def note(self, kind: str, route: str, streams: int, slots: int) -> None:
        with self._lock:
            self.streams[kind] += streams
            self.streams[route] += streams
            self.slots[kind] += slots
            self.slots[route] += slots

    def as_dict(self) -> dict:
        with self._lock:
            return {what: {"by_kind": {k: n[k] for k in LEVEL_KINDS},
                           "by_route": {k: n[k] for k in LEVEL_ROUTES}}
                    for what, n in (("streams", self.streams),
                                    ("slots", self.slots))}


_LEVELS = _LevelCounts()


def note_levels(kind: str, route: str, streams: int, slots: int) -> None:
    """One column chunk's ``kind`` level streams (``def`` or ``rep``, one a
    page) planned along ``route`` (:data:`LEVEL_ROUTES`), ``slots`` leaf
    slots in all."""
    _LEVELS.note(kind, route, streams, slots)


def level_totals() -> dict:
    """The level streams and slots the process has planned since import,
    each by kind and by route (``{"streams": {"by_kind": {...},
    "by_route": {...}}, "slots": {...}}``): a benchmark's reading, as
    :func:`host_phase_totals` is."""
    return _LEVELS.as_dict()


class HostPhaseStats:
    """Self-time counters of one reader's host phase: ``parts`` (seconds
    per :data:`HOST_PARTS` name, ``python`` the remainder, so they sum to
    ``seconds``), ``cpu_seconds`` (``time.thread_time`` over the same
    units: ``seconds - cpu_seconds`` is time off the CPU, the GIL waits
    among it), ``stage_cpu_seconds`` (the staging thread's CPU time), the
    snappy tag walk's counts, and the column chunks whose pages were walked
    in one native call (``chunk_walks``) or took the page loop
    (``chunk_walk_fallbacks``, by reason).  Each unit folds in once, under a
    lock, here and into the process's :func:`host_phase_totals`."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds = 0.0
        self.cpu_seconds = 0.0
        self.stage_cpu_seconds = 0.0
        self.rows = 0
        self.parts = [0.0] * len(HOST_PARTS)
        self.walks = self.retries = self.declined = 0
        self.wasted_seconds = 0.0
        self.chunk_walks = 0
        self.chunk_walk_fallbacks: dict = {}

    def begin(self) -> _HostUnit:
        """Open a unit on this thread (the leaves' seconds go to it)."""
        u = _HostUnit(_host_tls.unit)
        _host_tls.unit = u
        return u

    def end(self, u: _HostUnit, seconds: float, rows: int = 0) -> None:
        """Close ``u`` (``seconds`` long, ``rows`` finished) and fold it."""
        cpu = time.thread_time() - u.cpu0
        _host_tls.unit = u.outer
        parts = u.parts + [seconds - sum(u.parts)]
        for stats in (self, _TOTALS):
            with stats._lock:
                stats._fold(seconds, cpu, rows, parts, u)

    @staticmethod
    def drop(u: _HostUnit) -> None:
        """Close ``u`` without folding it (its work raised)."""
        _host_tls.unit = u.outer

    def _fold(self, seconds, cpu, rows, parts, u) -> None:
        self.seconds += seconds
        self.cpu_seconds += cpu
        self.rows += rows
        for i, v in enumerate(parts):
            self.parts[i] += v
        self.walks += u.walks
        self.retries += u.retries
        self.declined += u.declined
        self.wasted_seconds += u.wasted
        self.chunk_walks += u.chunk_walks
        if u.walk_fallbacks:
            for k, v in u.walk_fallbacks.items():
                self.chunk_walk_fallbacks[k] = (
                    self.chunk_walk_fallbacks.get(k, 0) + v)

    def add_stage_cpu(self, seconds: float) -> None:
        for stats in (self, _TOTALS):
            with stats._lock:
                stats.stage_cpu_seconds += seconds

    def as_dict(self) -> dict:
        with self._lock:
            return {
                "host_seconds": self.seconds,
                "host_cpu_seconds": self.cpu_seconds,
                "stage_cpu_seconds": self.stage_cpu_seconds,
                "rows": self.rows,
                "parts": dict(zip(HOST_PARTS, self.parts)),
                "snappy_walk": {"walks": self.walks,
                                "retries": self.retries,
                                "declined": self.declined,
                                "wasted_seconds": self.wasted_seconds},
                "chunk_walks": self.chunk_walks,
                "chunk_walk_fallbacks": dict(self.chunk_walk_fallbacks),
            }

    def progress(self) -> dict:
        """Flat numbers for a sampler track."""
        d = self.as_dict()
        out = {k: d[k] for k in ("host_seconds", "host_cpu_seconds",
                                 "stage_cpu_seconds")}
        out.update({f"{k}_s": v for k, v in d["parts"].items()})
        out.update({f"snappy_{k}": v for k, v in d["snappy_walk"].items()})
        return out


# every DeviceFileReader's units of the process, folded as each ends
_TOTALS = HostPhaseStats()


def host_phase_totals() -> dict:
    """The process's host-phase counters, summed over every device reader
    since import (:meth:`HostPhaseStats.as_dict`'s keys): what an
    operator's scrape, or a benchmark's reading of a window, takes."""
    return _TOTALS.as_dict()


# ---------------------------------------------------------------------------
# hang watchdog
# ---------------------------------------------------------------------------

def resolve_hang_s(hang_s=None) -> float:
    """Resolve a ``hang_s=`` kwarg against ``TPQ_HANG_S`` (kwarg wins —
    including an explicit 0, which disables the watchdog even when the env
    is set; unset/invalid env disables)."""
    if hang_s is not None:
        try:
            return max(float(hang_s), 0.0)
        except (TypeError, ValueError):
            return 0.0
    return env_float("TPQ_HANG_S", 0.0, lo=0.0)


class ConsumerLane:
    """A watchdog lane that distinguishes a wedged pipeline from a merely
    paused consumer.

    Every other heartbeat freezes the moment the consumer stops pulling
    (the prefetch window fills, counters stop) — so a training loop that
    pauses between batches to checkpoint or eval would look exactly like a
    hang.  This lane's value ADVANCES (wall clock) while the consumer is
    away (``idle``) and FREEZES at the moment it entered the producer
    (``producing``): the watchdog can then only fire while the consumer is
    genuinely blocked inside ``next()`` on a frozen pipeline.
    """

    __slots__ = ("_since",)

    def __init__(self):
        self._since: "float | None" = None

    def producing(self) -> None:
        """The consumer just entered the producer (blocked in next())."""
        self._since = time.monotonic()

    def idle(self) -> None:
        """About to yield: the consumer is going away with its batch."""
        self._since = None

    def value(self) -> float:
        s = self._since
        return s if s is not None else time.monotonic()


class Watchdog:
    """Daemon thread that detects a wedged pipeline from frozen heartbeats.

    ``watch(label, fn)`` registers a progress source: a zero-arg callable
    returning a number or a ``{lane: number}`` dict (each dict key becomes
    its own ``label.lane``).  The thread re-reads every source on a cadence
    of ``hang_s / 4`` (clamped to [20 ms, 1 s]); a lane "advances" when its
    value changes.  When **no** watched lane advances within ``hang_s``,
    the watchdog fires ONCE:

    1. writes a flight-recorder dump (``reason="hang"``) carrying per-lane
       no-advance ages and the lane that stopped advancing first, then
    2. policy ``"log"``: logs a warning and re-arms (graceful degradation:
       the run continues, the dump is the artifact), or policy ``"raise"``
       (the default, ``TPQ_HANG_POLICY`` overrides): builds a
       :class:`~tpu_parquet_torch.errors.HangError` naming the dump and calls
       every registered abort hook — readers/loaders register their
       :meth:`~tpu_parquet_torch.alloc.InFlightBudget.abort`, so the SUBMITTER
       blocked on backpressure wakes and raises instead of hanging
       forever.

    Lifecycle discipline matches :class:`Sampler`: inert (``start`` is a
    no-op) when ``hang_s`` is 0 or nothing is watched, ``stop()`` joins,
    the thread is a daemon, and every heartbeat/dump/hook call is guarded
    — a watchdog must never take a healthy run down.

    The deadline must exceed the longest legitimate single unit of work
    (one chunk's IO+decompress, one device sync): heartbeats are
    cumulative counters that only move when a unit COMPLETES.
    """

    def __init__(self, hang_s, recorder: "FlightRecorder | None" = None,
                 name: str = "tpq-watchdog", policy: "str | None" = None,
                 dump_path: "str | None" = None):
        self.hang_s = max(float(hang_s or 0.0), 0.0)
        self.recorder = recorder
        self.name = name
        env_policy = os.environ.get("TPQ_HANG_POLICY", "")
        self.policy = policy or env_policy or "raise"
        if self.policy not in ("raise", "log"):
            if policy:  # explicit kwarg: a code bug, fail loudly
                raise ValueError(
                    f"hang policy {self.policy!r} is not 'raise' or 'log'")
            # env typo: degrade to the safe default instead of failing
            # every reader/loader construction (resolve_hang_s treats a
            # malformed TPQ_HANG_S the same way — disabled, not fatal)
            import logging

            logging.getLogger(__name__).warning(
                "TPQ_HANG_POLICY=%r is not 'raise' or 'log'; using 'raise'",
                env_policy)
            self.policy = "raise"
        self.dump_path = dump_path
        self._watch: list = []  # [(label, fn)]
        self._abort_hooks: list = []
        self._last: dict = {}  # lane -> [value, t_change, advanced_ever]
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.fired = False
        self.error = None
        self.last_dump: "str | None" = None
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return self.hang_s > 0

    def watch(self, label: str, fn) -> "Watchdog":
        with self._lock:
            self._watch.append((label, fn))
        return self

    def watch_consumer(self, label: str = "consumer") -> ConsumerLane:
        """Register (or REPLACE — one lane per label, so a reader's second
        scan doesn't leave a stale always-advancing lane that would defeat
        the all-frozen condition) a :class:`ConsumerLane` gate."""
        lane = ConsumerLane()
        with self._lock:
            self._watch = [(l, f) for l, f in self._watch if l != label]
            self._watch.append((label, lane.value))
            self._last.pop(label, None)
        return lane

    def add_abort_hook(self, fn) -> "Watchdog":
        """Register ``fn(exc)`` to run when the raise policy fires (e.g.
        ``budget.abort`` — the hook that turns a wedge into an error)."""
        with self._lock:
            self._abort_hooks.append(fn)
        return self

    def remove_abort_hook(self, fn) -> None:
        """Deregister a hook (idempotent).  A reader-lifetime watchdog sees
        one budget per scan: each feed must remove its hook on teardown or
        dead budgets accumulate for the reader's whole life."""
        with self._lock:
            try:
                self._abort_hooks.remove(fn)
            except ValueError:
                pass

    def check(self) -> None:
        """Submitter-side hook: raise the pending HangError, if any."""
        if self.error is not None:
            raise self.error

    def start(self) -> "Watchdog":
        if not self.enabled or not self._watch or self._thread is not None:
            return self
        self._stop.clear()
        self._note(self._read(), time.monotonic())
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the watchdog thread (no leak, tier-1 guarded)."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- internals ------------------------------------------------------------

    def _read(self) -> dict:
        with self._lock:
            watch = list(self._watch)
        out = {}
        for label, fn in watch:
            try:
                v = fn()
            except Exception:  # noqa: BLE001 — a heartbeat never kills the run
                self.dropped += 1
                continue
            if isinstance(v, dict):
                for k, x in v.items():
                    if isinstance(x, (int, float)) and not isinstance(x, bool):
                        out[f"{label}.{k}"] = x
            elif isinstance(v, (int, float)) and not isinstance(v, bool):
                out[label] = v
        return out

    def _note(self, vals: dict, now: float) -> float:
        """Fold one reading in; returns the newest per-lane change time.
        Locked: ``watch_consumer`` may drop a lane from another thread."""
        with self._lock:
            for lane, v in vals.items():
                rec = self._last.get(lane)
                if rec is None:
                    self._last[lane] = [v, now, False]
                elif v != rec[0]:
                    rec[0], rec[1], rec[2] = v, now, True
            return max((rec[1] for rec in self._last.values()), default=now)

    def _run(self) -> None:
        interval = min(max(self.hang_s / 4.0, 0.02), 1.0)
        while not self._stop.wait(interval):
            now = time.monotonic()
            newest = self._note(self._read(), now)
            if not self._last or now - newest <= self.hang_s:
                continue
            self._fire(now)
            if self.policy == "raise":
                return  # fired for good: the error is armed, nothing to re-watch
            with self._lock:
                for rec in self._last.values():  # log policy: re-arm
                    rec[1] = now

    def _fire(self, now: float) -> None:
        import logging

        self.fired = True
        with self._lock:
            ages = {lane: round(now - rec[1], 3)
                    for lane, rec in self._last.items()}
            moved = [l for l, rec in self._last.items() if rec[2]]
        pool = moved or list(ages)
        stalled_first = max(pool, key=lambda l: (ages[l], l)) if pool else None
        report = {
            "hang_s": self.hang_s,
            "policy": self.policy,
            "ages": ages,
            "stalled_first": stalled_first,
        }
        rec = self.recorder if self.recorder is not None else flight_recorder()
        try:
            self.last_dump = rec.dump(self.dump_path, reason="hang",
                                      watchdog=report)
        except Exception:  # noqa: BLE001 — an unwritable dump must not mask the hang
            self.last_dump = None
        msg = (f"watchdog: no watched lane advanced for {self.hang_s:g}s "
               f"(first stalled: {stalled_first}); "
               f"flight dump: {self.last_dump or '<unwritable>'}")
        logging.getLogger(__name__).warning(msg)
        if self.policy == "raise":
            from .errors import HangError

            err = HangError(msg, dump_path=self.last_dump)
            self.error = err
            with self._lock:
                hooks = list(self._abort_hooks)
            for h in hooks:
                try:
                    h(err)
                except Exception:  # noqa: BLE001
                    pass


# ---------------------------------------------------------------------------
# unified registry
# ---------------------------------------------------------------------------

# keys that are peaks/config, not flows: composition takes the max
_MERGE_MAXED = frozenset((
    "peak_in_flight_bytes", "window_peak_rows", "prefetch", "budget_bytes",
    "planner_link_mbps",
    # write section config: pool size composes by max, exactly as the
    # read side's prefetch does
    "workers",
    # serve section gauges: the cache footprint and the admission peak are
    # point-in-time state of ONE shared object, not flows to sum (the
    # names are serve-specific — a generic "bytes" here would max the
    # device section's h2d byte FLOW)
    "queue_depth_peak", "held_bytes", "capacity_bytes", "entries",
    # circuit-breaker gauge: circuits open RIGHT NOW on one board — two
    # snapshots of the same board must not sum
    "open_now",
    # tenant QoS gauges: configuration (weight, SLO target) and resident
    # state (cache bytes, the last computed retry hint) of one registry —
    # flows like submitted/rejected still sum; these must not
    "weight", "slo_p99_ms", "retry_after_hint_s", "cache_held_bytes",
))
# ratios/rates derived from the flows: summing them is meaningless (four
# files' overlap_efficiency is not their sum) — the merge drops them and
# as_dict() recomputes each from the merged numerators/denominators
_MERGE_DERIVED = frozenset((
    "overlap_efficiency", "rows_per_sec", "bytes_per_sec", "pages_per_chunk",
    "batches_per_sec",
))


def _merge_num_tree(dst: dict, src: dict) -> None:
    """Fold one numeric tree into another: dicts recurse, flows add, peaks
    and config take the max, derived ratios are dropped (recomputed at
    ``as_dict``), anything else last-writer-wins."""
    for k, v in src.items():
        if k in _MERGE_DERIVED:
            continue
        if isinstance(v, dict):
            _merge_num_tree(dst.setdefault(k, {}), v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            if k in _MERGE_MAXED:
                dst[k] = max(dst.get(k, 0), v)
            else:
                dst[k] = dst.get(k, 0) + v
        else:
            dst[k] = v


def _ratio(num, den, digits):
    return round(num / den, digits) if den else 0.0


def _recompute_derived(tree: dict) -> None:
    """Rebuild the `_MERGE_DERIVED` ratios of a composed tree from its
    merged flows, section by section (the formulas mirror PipelineStats /
    ReaderStats / LoaderStats properties)."""
    pipe, reader, loader = (tree.get("pipeline"), tree.get("reader"),
                            tree.get("loader"))
    if pipe:
        pipe["overlap_efficiency"] = _ratio(
            pipe.get("busy_seconds", 0.0), pipe.get("wall_seconds", 0.0), 3)
    if reader:
        wall = reader.get("wall_seconds", 0.0)
        reader["rows_per_sec"] = _ratio(reader.get("rows", 0), wall, 1)
        reader["bytes_per_sec"] = _ratio(
            reader.get("compressed_bytes", 0), wall, 1)
        reader["pages_per_chunk"] = _ratio(
            reader.get("pages", 0), reader.get("chunks", 0), 3)
    if loader:
        wall = loader.get("wall_seconds", 0.0)
        loader["rows_per_sec"] = _ratio(loader.get("rows", 0), wall, 1)
        loader["batches_per_sec"] = _ratio(loader.get("batches", 0), wall, 3)
    write = tree.get("write")
    if write:
        wall = write.get("wall_seconds", 0.0)
        write["rows_per_sec"] = _ratio(write.get("rows", 0), wall, 1)
        write["bytes_per_sec"] = _ratio(
            write.get("bytes_written", 0), wall, 1)


class StatsRegistry:
    """One versioned tree over every stats surface the engine already has.

    Sources accumulate (``add_*`` may be called once per reader/file of a
    multi-file scan); ``as_dict()`` snapshots the composition.  The tree is
    versioned (``obs_version``) and its keys are held to the reference's,
    so parsers of the tree cannot silently break on key drift.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pipeline: "dict | None" = None
        self._reader: "dict | None" = None
        self._loader: "dict | None" = None
        self._io: "dict | None" = None
        self._data_errors: "dict | None" = None
        self._device: "dict | None" = None
        self._serve: "dict | None" = None
        self._cache: "dict | None" = None
        self._write: "dict | None" = None
        self._alloc_peak = 0
        self._alloc_device_peak = 0
        self._hists: dict[str, LatencyHistogram] = {}

    # -- composition ----------------------------------------------------------

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            return h

    def add_pipeline(self, pstats) -> None:
        """Fold a :class:`~tpu_parquet_torch.pipeline.PipelineStats` in (its
        per-stage histograms become registry histograms ``stage.<name>``)."""
        d = pstats.as_dict()
        hists = d.pop("stage_histograms", {})
        with self._lock:
            if self._pipeline is None:
                self._pipeline = {}
            _merge_num_tree(self._pipeline, d)
        for stage, hd in hists.items():
            self.histogram(f"stage.{stage}").merge_dict(hd)

    def add_reader(self, rstats) -> None:
        """Fold a :class:`~tpu_parquet_torch.device_reader.ReaderStats` in."""
        with self._lock:
            if self._reader is None:
                self._reader = {}
            _merge_num_tree(self._reader, rstats.as_dict())

    def add_loader(self, lstats) -> None:
        """Fold a :class:`~tpu_parquet_torch.data.loader.LoaderStats` in (its
        nested pipeline section routes to the pipeline composition)."""
        d = lstats.as_dict()
        pipe = d.pop("pipeline", None)
        with self._lock:
            if self._loader is None:
                self._loader = {}
            _merge_num_tree(self._loader, d)
        if pipe is not None:
            self.add_pipeline(lstats.pipeline)

    def add_io(self, iostats) -> None:
        """Fold a :class:`~tpu_parquet_torch.iostore.IOStats` in (retry/backoff/
        coalescing counters of one store; all flows, so multi-file scans
        compose by addition).  Raw dicts accepted for tests."""
        d = iostats if isinstance(iostats, dict) else iostats.as_dict()
        with self._lock:
            if self._io is None:
                self._io = {}
            _merge_num_tree(self._io, d)

    def add_data_errors(self, quarantine) -> None:
        """Fold a :class:`~tpu_parquet_torch.quarantine.Quarantine`'s counters in
        (the ``data_errors`` section: errors / units_skipped / rows_skipped /
        files_skipped / by_class — all flows, so multi-engine scans compose
        by addition).  Raw dicts accepted for tests."""
        d = (quarantine if isinstance(quarantine, dict)
             else quarantine.as_dict())
        with self._lock:
            if self._data_errors is None:
                self._data_errors = {}
            _merge_num_tree(self._data_errors, d)

    def add_device(self, devstats) -> None:
        """Fold a :class:`~tpu_parquet_torch.device_reader.DeviceStats` in (the
        ``device`` section: per-route and per-kernel-family completion-side
        dispatch timing plus the h2d transfer lane — all flows, so
        multi-file scans compose by addition).  Raw dicts accepted for
        tests and cross-process merges."""
        d = devstats if isinstance(devstats, dict) else devstats.as_dict()
        with self._lock:
            if self._device is None:
                self._device = {}
            _merge_num_tree(self._device, d)

    def add_serve(self, serve_stats) -> None:
        """Fold a :class:`~tpu_parquet_torch.serve.ServeStats` tree in (the
        ``serve`` section: request/rejection counters, queue-wait and exec
        second sums, and the plan-cache hit/miss/eviction counters — all
        flows except the ``queue_depth_peak``/cache-gauge keys, which the
        generic merge already treats per its rules).  Raw dicts accepted
        for tests and cross-process merges."""
        d = (serve_stats if isinstance(serve_stats, dict)
             else serve_stats.as_dict())
        with self._lock:
            if self._serve is None:
                self._serve = {}
            _merge_num_tree(self._serve, d)

    def add_cache(self, cache_counters) -> None:
        """Fold a :class:`~tpu_parquet_torch.serve.ResultCache`'s counters in
        (the ``cache`` section: per-tier hit/miss/eviction/invalidation
        flows, ``held_bytes``/``capacity_bytes``/``entries`` gauges — the
        generic merge maxes those by name — and the single-flight wait
        count).  Raw dicts accepted (they are the native form)."""
        d = (cache_counters if isinstance(cache_counters, dict)
             else cache_counters.counters())
        with self._lock:
            if self._cache is None:
                self._cache = {}
            _merge_num_tree(self._cache, d)

    def add_write(self, write_stats) -> None:
        """Fold a :class:`~tpu_parquet_torch.write.WriteStats` in (the ``write``
        section: encode/compress/flush/merge/compact lane seconds plus
        row/file/byte flows — all flows except ``workers``, which maxes
        like the read side's ``prefetch``).  Its per-stage histograms
        become registry histograms ``write.<stage>``.  Raw dicts accepted
        for tests and cross-process merges."""
        d = (write_stats if isinstance(write_stats, dict)
             else write_stats.as_dict())
        d = dict(d)
        hists = d.pop("stage_histograms", {})
        with self._lock:
            if self._write is None:
                self._write = {}
            _merge_num_tree(self._write, d)
        for stage, hd in hists.items():
            self.histogram(f"write.{stage}").merge_dict(hd)

    def note_alloc_peak(self, tracker) -> None:
        """Record an :class:`~tpu_parquet_torch.alloc.AllocTracker`'s high-water
        marks (host ``peak`` + device-bytes ``device_peak``; raw ints
        accepted for tests as the host peak alone)."""
        peak = int(getattr(tracker, "peak", tracker or 0))
        dev_peak = int(getattr(tracker, "device_peak", 0) or 0)
        with self._lock:
            self._alloc_peak = max(self._alloc_peak, peak)
            self._alloc_device_peak = max(self._alloc_device_peak, dev_peak)

    def merge_from(self, other: "StatsRegistry") -> None:
        with other._lock:
            pipeline = dict(other._pipeline) if other._pipeline else None
            reader = dict(other._reader) if other._reader else None
            loader = dict(other._loader) if other._loader else None
            io = dict(other._io) if other._io else None
            data_errors = (dict(other._data_errors)
                           if other._data_errors else None)
            device = dict(other._device) if other._device else None
            serve = dict(other._serve) if other._serve else None
            cache = dict(other._cache) if other._cache else None
            write = dict(other._write) if other._write else None
            peak = other._alloc_peak
            dev_peak = other._alloc_device_peak
            hists = dict(other._hists)
        with self._lock:
            for name, src in (("_pipeline", pipeline), ("_reader", reader),
                              ("_loader", loader), ("_io", io),
                              ("_data_errors", data_errors),
                              ("_device", device), ("_serve", serve),
                              ("_cache", cache), ("_write", write)):
                if src is None:
                    continue
                dst = getattr(self, name)
                if dst is None:
                    setattr(self, name, dst := {})
                _merge_num_tree(dst, src)
            self._alloc_peak = max(self._alloc_peak, peak)
            self._alloc_device_peak = max(self._alloc_device_peak, dev_peak)
        for name, h in hists.items():
            self.histogram(name).merge_from(h)

    def merge_dict(self, tree: dict) -> None:
        """Fold a serialized registry tree (another process's) in."""
        if tree.get("obs_version") != OBS_VERSION:
            raise ValueError(
                f"obs_version {tree.get('obs_version')!r} != {OBS_VERSION}")
        for key, attr in (("pipeline", "_pipeline"), ("reader", "_reader"),
                          ("loader", "_loader"), ("io", "_io"),
                          ("data_errors", "_data_errors"),
                          ("device", "_device"), ("serve", "_serve"),
                          ("cache", "_cache"), ("write", "_write")):
            src = tree.get(key)
            if src is None:
                continue
            src = dict(src)
            src.pop("ship_feedback", None)
            with self._lock:
                dst = getattr(self, attr)
                if dst is None:
                    setattr(self, attr, dst := {})
                _merge_num_tree(dst, src)
        with self._lock:
            alloc = tree.get("alloc", {})
            self._alloc_peak = max(self._alloc_peak,
                                   int(alloc.get("peak_bytes", 0)))
            self._alloc_device_peak = max(
                self._alloc_device_peak,
                int(alloc.get("device_peak_bytes", 0) or 0))
        for name, hd in tree.get("histograms", {}).items():
            self.histogram(name).merge_dict(hd)

    # -- reporting ------------------------------------------------------------

    def ship_feedback(self) -> dict:
        """Per-route predicted vs measured link-lane seconds.

        Predicted: the ship planner's modeled bottleneck-lane seconds for
        each stream's CHOSEN route (summed per route — ReaderStats carries
        them next to the byte counters).  Measured: the route's shipped
        bytes through the link rate this run actually achieved
        (staged bytes / stage-stage seconds — the staging span IS the link
        lane).  ``error_ratio`` = measured/predicted: >1 means the model
        was optimistic (raise ``TPQ_LINK_MBPS``'s denominator — i.e. the
        link was slower than planned), <1 pessimistic.

        The ``measured_seconds``/``error_ratio`` keys are always present:
        a route chosen by the planner but never timed (a forced route with
        tracing off, a run whose staging span recorded no seconds) reports
        ``null`` — explicitly unmeasured, never a divide-by-zero or a bogus
        0.0 ratio a diff would read as "infinitely fast".

        The DEVICE lane rides each route the same way: predicted device
        seconds from the planner's device cost term
        (``predicted_device_s`` on ReaderStats), measured from the
        completion-side device timing (the ``device`` section's per-route
        ``device_seconds``, ``TPQ_DEVICE_TIMING``) — null when the timing
        lane never ran, same contract as the link lane.
        """
        with self._lock:
            reader = dict(self._reader or {})
            pipeline = dict(self._pipeline or {})
            device = dict(self._device or {})
        routes = reader.get("ship_routes") or {}
        staged = reader.get("staged_bytes") or 0
        stage_s = pipeline.get("stage_seconds") or 0.0
        link_bps = staged / stage_s if staged and stage_s else 0.0
        dev_routes = device.get("routes") or {}
        out = {}
        for route, c in sorted(routes.items()):
            # null-check and ratio on the RAW values, display rounding last:
            # a 100-byte stream on a fast link measures ~1e-7s, which
            # round(..., 6) flattens to exactly the bogus-0.0 this contract
            # exists to rule out
            pred = float(c.get("predicted_s", 0.0))
            meas = c.get("shipped", 0) / link_bps if link_bps else None
            dev_pred = float(c.get("predicted_device_s", 0.0) or 0.0)
            dr = dev_routes.get(route) or {}
            dev_meas = (float(dr["device_seconds"])
                        if dr.get("dispatches") else None)
            # fused routes carry the UNFUSED chain's device prediction too
            # (null elsewhere) — the fusion-win comparison's bar
            unf = float(c.get("predicted_unfused_device_s", 0.0) or 0.0)
            out[route] = {
                "streams": c.get("streams", 0),
                "shipped_bytes": c.get("shipped", 0),
                "predicted_seconds": round(pred, 9),
                "measured_seconds": (round(meas, 9) if meas is not None
                                     else None),
                "error_ratio": (round(meas / pred, 3)
                                if meas is not None and pred else None),
                "device_predicted_seconds": round(dev_pred, 9),
                "device_measured_seconds": (round(dev_meas, 9)
                                            if dev_meas is not None
                                            else None),
                "device_error_ratio": (round(dev_meas / dev_pred, 3)
                                       if dev_meas is not None and dev_pred
                                       else None),
                "device_unfused_predicted_seconds": (round(unf, 9)
                                                     if unf else None),
            }
        return {"link_bytes_per_sec": round(link_bps, 1), "routes": out}

    def as_dict(self) -> dict:
        with self._lock:
            tree = {
                "obs_version": OBS_VERSION,
                "pipeline": dict(self._pipeline) if self._pipeline else None,
                "reader": dict(self._reader) if self._reader else None,
                "loader": dict(self._loader) if self._loader else None,
                "io": dict(self._io) if self._io else None,
                "data_errors": (dict(self._data_errors)
                                if self._data_errors else None),
                "device": dict(self._device) if self._device else None,
                "serve": dict(self._serve) if self._serve else None,
                "cache": dict(self._cache) if self._cache else None,
                "write": dict(self._write) if self._write else None,
                "alloc": {"peak_bytes": self._alloc_peak,
                          "device_peak_bytes": self._alloc_device_peak},
                "histograms": {n: h.as_dict()
                               for n, h in sorted(self._hists.items())},
            }
        _recompute_derived(tree)
        if tree["reader"] is not None:
            tree["reader"]["ship_feedback"] = self.ship_feedback()
        return tree

    def render_openmetrics(self) -> str:
        """OpenMetrics text exposition of the live tree (see
        :func:`render_openmetrics`)."""
        return render_openmetrics(self.as_dict())


# ---------------------------------------------------------------------------
# OpenMetrics export: text exposition + periodic snapshot dumper
# ---------------------------------------------------------------------------

def _om_name(*parts) -> str:
    """A legal OpenMetrics metric name from tree-path parts."""
    name = "_".join(str(p) for p in parts if p not in (None, ""))
    out = []
    for ch in name:
        out.append(ch if (ch.isascii() and (ch.isalnum() or ch == "_"))
                   else "_")
    name = "".join(out) or "_"
    return name if not name[0].isdigit() else f"_{name}"


def _om_escape(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _om_num(v) -> str:
    # integral floats render as ints: counter samples read naturally and
    # snapshots diff cleanly
    if isinstance(v, float) and not v.is_integer():
        return repr(v)
    return str(int(v))


def _om_walk(lines: list, prefix: "tuple", tree: dict) -> None:
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            _om_walk(lines, prefix + (k,), v)
        elif isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        else:
            name = _om_name("tpq", *prefix, k)
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_om_num(v)}")


def render_openmetrics(tree: dict) -> str:
    """Render a registry tree (``StatsRegistry.as_dict`` form) as an
    OpenMetrics text exposition: every numeric leaf as a gauge
    ``tpq_<section>_<path>``, every histogram as a cumulative-``le``
    bucket family with ``_sum``/``_count`` — and, where a bucket carries a
    retained-trace exemplar, the OpenMetrics exemplar suffix
    ``# {trace_id="..."} value`` that lets a dashboard jump from a bucket
    straight to ``pq_tool trace --request``.  Ends with ``# EOF``.
    """
    if not isinstance(tree, dict):
        raise ValueError("not a registry tree")
    lines: list[str] = []
    for section in ("pipeline", "reader", "loader", "io", "data_errors",
                    "device", "serve", "cache", "write", "alloc"):
        sub = tree.get(section)
        if isinstance(sub, dict):
            sub = dict(sub)
            sub.pop("ship_feedback", None)  # ratios with nulls, not samples
            _om_walk(lines, (section,), sub)
    for hname, hd in sorted((tree.get("histograms") or {}).items()):
        if not isinstance(hd, dict):
            continue
        name = _om_name("tpq", hname, "seconds")
        lines.append(f"# TYPE {name} histogram")
        exemplars = hd.get("exemplars") or {}
        cum = 0
        for i in sorted(int(k) for k in (hd.get("buckets") or {})):
            cum += int(hd["buckets"][str(i)])
            le = LatencyHistogram.bucket_upper_seconds(i)
            line = f'{name}_bucket{{le="{le!r}"}} {cum}'
            ex = exemplars.get(str(i))
            if isinstance(ex, (list, tuple)) and len(ex) == 2:
                line += (f' # {{trace_id="{_om_escape(ex[0])}"}}'
                         f" {float(ex[1])!r}")
            lines.append(line)
        lines.append(f'{name}_bucket{{le="+Inf"}} {int(hd.get("count", 0))}')
        lines.append(f'{name}_sum {float(hd.get("sum_seconds", 0.0))!r}')
        lines.append(f'{name}_count {int(hd.get("count", 0))}')
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def diff_registry_trees(old: dict, new: dict) -> dict:
    """Numeric-leaf deltas between two registry snapshots (``pq_tool
    metrics A B`` / ``--watch``): ``{dotted.path: (old, new, delta)}`` for
    every leaf that changed, sections and histograms alike."""

    def leaves(tree, prefix, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                leaves(v, f"{prefix}.{k}" if prefix else str(k), out)
        elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
            out[prefix] = tree

    a: dict = {}
    b: dict = {}
    leaves(old, "", a)
    leaves(new, "", b)
    out = {}
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key, 0), b.get(key, 0)
        if va != vb:
            out[key] = (va, vb, vb - va)
    return out


def resolve_metrics_dump(spec: "str | None" = None):
    """Parse a ``path:interval_s`` metrics-dump spec (default:
    ``TPQ_METRICS_DUMP``).  Returns ``(path, interval_s)`` or ``None``;
    malformed values degrade with one :func:`warn_env_once` line, never
    raise (the env-knob contract)."""
    raw = os.environ.get("TPQ_METRICS_DUMP", "") if spec is None else spec
    if not raw:
        return None
    path, sep, interval = raw.rpartition(":")
    if not sep or not path:
        warn_env_once("TPQ_METRICS_DUMP", raw, None)
        return None
    try:
        iv = float(interval)
    except (TypeError, ValueError):
        warn_env_once("TPQ_METRICS_DUMP", raw, None)
        return None
    if iv <= 0:
        warn_env_once("TPQ_METRICS_DUMP", raw, None)
        return None
    return path, iv


class MetricsDumper:
    """Daemon thread writing periodic registry snapshots to disk
    (``TPQ_METRICS_DUMP=path:interval_s``) — the live scrape surface
    ``pq_tool metrics --watch`` polls.

    ``source`` is a zero-arg callable returning a :class:`StatsRegistry`
    or an ``as_dict`` tree; each tick writes the JSON tree atomically
    (tmp + ``os.replace`` — a watcher never reads a torn file).  Lifecycle
    discipline matches :class:`Sampler`: inert when the spec is unset or
    malformed, ``stop()`` joins (and writes one final snapshot so the file
    ends at the end state), the thread is a daemon, and a failing source
    or write is counted, never raised.
    """

    def __init__(self, source, spec: "str | None" = None,
                 name: str = "tpq-metricsdump"):
        self.source = source
        parsed = resolve_metrics_dump(spec)
        self.path, self.interval_s = parsed if parsed else (None, 0.0)
        self.name = name
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self.written = 0
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return self.path is not None and self.interval_s > 0

    def start(self) -> "MetricsDumper":
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name=self.name,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the dumper thread (no leak, bench-gated)."""
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=10.0)
        self._thread = None

    def __enter__(self) -> "MetricsDumper":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def _run(self) -> None:
        while True:
            stopping = self._stop.wait(self.interval_s)
            self.dump_once()
            if stopping:
                return

    def dump_once(self) -> "str | None":
        if self.path is None:
            return None
        try:
            tree = self.source()
            if isinstance(tree, StatsRegistry):
                tree = tree.as_dict()
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(tree, f, default=repr)
                f.write("\n")
            os.replace(tmp, self.path)
            self.written += 1
            return self.path
        except Exception:  # noqa: BLE001 — metrics export never takes the run down
            self.dropped += 1
            return None


# ---------------------------------------------------------------------------
# trace summarization (the pq_tool backend)
# ---------------------------------------------------------------------------

# the span names PipelineStats.timed emits — the busy-seconds basis of
# overlap efficiency, kept in lockstep with pipeline.STAGES by test_obs
PIPELINE_SPAN_NAMES = ("io", "decompress", "recompress", "stage", "dispatch",
                       "finalize")


def _exact_quantile(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[i]


def trace_summary(doc) -> dict:
    """Aggregate a Chrome trace-event document (object or bare-array form)
    into the per-stage/overlap/stall/route report ``pq_tool trace`` prints.

    Works from the trace alone: stage stats come from the ``X`` spans
    (exact p50/p95 over the recorded durations — the full population is in
    hand, no histogram approximation needed), overlap efficiency is
    busy/wall over the pipeline span names, stall attribution from the
    ``stall`` spans, and route prediction error from the ``ship`` instants'
    args against the measured link lane (staged bytes / stage seconds).
    """
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        other = doc.get("otherData") or {}
    else:
        events, other = doc, {}
    if not isinstance(events, list):
        raise ValueError("not a trace-event document: no traceEvents array")
    spans: dict[str, list[float]] = {}
    ships: list[dict] = []
    t_min, t_max = None, None
    n_threads = set()
    pipe_walls: dict = {}  # (pid, pipe-token) -> that pipeline's max wall
    for ev in events:
        if not isinstance(ev, dict):
            raise ValueError("malformed trace event (not an object)")
        ph = ev.get("ph")
        if ph == "M":
            continue
        n_threads.add((ev.get("pid"), ev.get("tid")))
        ts = ev.get("ts")
        if ts is None:
            continue
        end = ts + ev.get("dur", 0)
        t_min = ts if t_min is None else min(t_min, ts)
        t_max = end if t_max is None else max(t_max, end)
        if ph == "X":
            spans.setdefault(ev.get("name", "?"), []).append(
                ev.get("dur", 0) / 1e6)
        elif ph == "i" and ev.get("name") == "ship":
            ships.append(ev.get("args") or {})
        elif ph == "C" and ev.get("name") == "pipeline_wall":
            args = ev.get("args") or {}
            key = (ev.get("pid"), args.get("pipe"))
            pipe_walls[key] = max(pipe_walls.get(key, 0.0),
                                  float(args.get("seconds", 0)))
    # the overlap denominator: the PipelineStats wall clocks when they rode
    # the trace — each stats object's counter is cumulative, so take its
    # max, then SUM across objects (one per file of a scan: sequential
    # segments whose busy spans the numerator also sums).  Falls back to
    # the span extent for traces with no pipeline counters.
    pipe_wall = sum(pipe_walls.values())
    wall = pipe_wall or ((t_max - t_min) / 1e6 if t_min is not None else 0.0)
    stages = {}
    for name, durs in sorted(spans.items()):
        durs.sort()
        stages[name] = {
            "count": len(durs),
            "total_seconds": round(sum(durs), 6),
            "p50_seconds": round(_exact_quantile(durs, 0.50), 9),
            "p95_seconds": round(_exact_quantile(durs, 0.95), 9),
            "max_seconds": round(durs[-1], 9),
        }
    busy = sum(stages[s]["total_seconds"] for s in PIPELINE_SPAN_NAMES
               if s in stages)
    stall = stages.get("stall", {}).get("total_seconds", 0.0)
    # measured link lane: the stage spans carry their staged byte counts
    stage_bytes = 0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("name") == "stage":
            stage_bytes += (ev.get("args") or {}).get("bytes", 0)
    stage_s = stages.get("stage", {}).get("total_seconds", 0.0)
    link_bps = stage_bytes / stage_s if stage_bytes and stage_s else 0.0
    routes: dict[str, dict] = {}
    for s in ships:
        r = routes.setdefault(str(s.get("route", "?")), {
            "streams": 0, "logical_bytes": 0, "shipped_bytes": 0,
            "predicted_seconds": 0.0, "device_predicted_seconds": 0.0,
        })
        r["streams"] += 1
        r["logical_bytes"] += int(s.get("logical", 0))
        r["shipped_bytes"] += int(s.get("shipped", 0))
        r["predicted_seconds"] += float(s.get("predicted_s", 0.0))
        r["device_predicted_seconds"] += float(
            s.get("predicted_device_s", 0.0) or 0.0)
    for name, r in routes.items():
        # keys always present; null = unmeasured (same contract as
        # StatsRegistry.ship_feedback — never a fake 0.0 ratio, so the
        # ratio and the null check use the RAW values, rounding last)
        pred = r["predicted_seconds"]
        meas = r["shipped_bytes"] / link_bps if link_bps else None
        r["predicted_seconds"] = round(pred, 9)
        r["measured_seconds"] = round(meas, 9) if meas is not None else None
        r["error_ratio"] = (round(meas / pred, 3)
                            if meas is not None and pred else None)
        # the device lane: completion-side `device.<route>` spans (the
        # TPQ_DEVICE_TIMING worker emits one per dispatch).  Same null
        # contract — a run with the timing lane off reports null, and an
        # artifact predating it can never KeyError.
        dev_pred = r["device_predicted_seconds"]
        dev = spans.get(f"device.{name}")
        dev_meas = sum(dev) if dev else None
        r["device_predicted_seconds"] = round(dev_pred, 9)
        r["device_measured_seconds"] = (round(dev_meas, 9)
                                        if dev_meas is not None else None)
        r["device_error_ratio"] = (round(dev_meas / dev_pred, 3)
                                   if dev_meas is not None and dev_pred
                                   else None)
    return {
        "obs_version": other.get("obs_version"),
        "events": len(events),
        "threads": len(n_threads),
        "wall_seconds": round(wall, 6),
        "busy_seconds": round(busy, 6),
        "overlap_efficiency": round(busy / wall, 3) if wall else 0.0,
        "stall_seconds": round(stall, 6),
        "stall_share": round(stall / wall, 4) if wall else 0.0,
        "stages": stages,
        "link_bytes_per_sec": round(link_bps, 1),
        "routes": dict(sorted(routes.items())),
        "registry": other.get("registry"),
    }


# ---------------------------------------------------------------------------
# doctor: rule-based bottleneck attribution (the pq_tool doctor backend)
# ---------------------------------------------------------------------------

# the verdicts `pq_tool doctor` can return, keyed by lane
DOCTOR_VERDICTS = {
    "link": "link-bound",
    "host_decompress": "host-decompress-bound",
    "stall": "stall-bound",
    "device_resolve": "device-resolve-bound",
    "h2d": "h2d-bound",
    "admission": "admission-bound",
}
# routes whose overall error_ratio leaves this band disagree with the cost
# model enough that re-running with the recalibrated TPQ_LINK_MBPS is the
# next step (inside it, re-banking changes no route choice worth chasing)
DOCTOR_ERROR_BAND = (0.8, 1.25)
# hedging advisory thresholds: below this many issued hedges the win rate
# is noise; below this win rate with wasted bytes on the books the hedge
# delay is mis-set (too aggressive) and doctor says so
HEDGE_VERDICT_MIN_ISSUED = 8
HEDGE_VERDICT_MIN_WIN_RATE = 0.2
# cache-thrash advisory thresholds (the result cache's `cache` section):
# a tier evicting at least this many entries while serving under this hit
# rate is churning — the working set does not fit its byte budget, and
# doctor names the tier (raise TPQ_RESULT_CACHE_MB / _HBM_MB) and the
# top-evicting file (or shard it) instead of letting the tier burn decode
# work it immediately throws away
CACHE_THRASH_MIN_EVICTIONS = 8
CACHE_THRASH_MAX_HIT_RATE = 0.5
# io-concurrency advisory thresholds (the async fetch engine's
# ``io.engine`` subtree): with the io lane dominant, ranges spending at
# least IO_CONC_QUEUE_WAIT_RATIO× as long waiting for an in-flight slot
# as actually fetching means concurrency — not the store — is the
# bottleneck.  A peak within IO_CONC_PIN_FRACTION of the engine cap names
# TPQ_IO_INFLIGHT; a peak pinned at the decode window instead names
# ``prefetch=`` (the feed could not submit deeper than decode allowed).
# Fewer than IO_CONC_MIN_FETCHES finished fetches is noise, not evidence.
IO_CONC_MIN_FETCHES = 16
IO_CONC_PIN_FRACTION = 0.9
IO_CONC_QUEUE_WAIT_RATIO = 2.0
# overload advisory threshold: fewer rejects+sheds than this is routine
# backpressure noise, not a verdict.  At or above it doctor names the
# tenant with the largest demand (submitted + rejected) as the offender
# and lists the tenants that ate rejections alongside it — the operator's
# next step is that tenant's weight/budget, not a global knob
OVERLOAD_MIN_REJECTS = 4


def _slo_burn_block(serve: dict, tree: dict) -> "dict | None":
    """The ``slo-burn`` verdict: a tenant whose measured p99 (its
    ``serve.tenant.<name>`` histogram) exceeds its declared ``slo_p99_ms``.
    Names the worst offender (largest p99/SLO ratio), the offending
    bucket, and — when the tail sampler linked one — the exemplar trace id
    that turns the bad percentile into a ``pq_tool trace --request``."""
    tens = {n: t for n, t in (serve.get("tenants") or {}).items()
            if isinstance(t, dict)}
    hists = tree.get("histograms")
    hists = hists if isinstance(hists, dict) else {}
    burns = []
    for name, t in sorted(tens.items()):
        slo_ms = t.get("slo_p99_ms")
        slo_ms = float(slo_ms) if isinstance(slo_ms, (int, float)) else 0.0
        hd = hists.get(f"serve.tenant.{name}")
        if slo_ms <= 0 or not isinstance(hd, dict) or not hd.get("count"):
            continue
        p99 = LatencyHistogram.from_dict(hd).quantile(0.99)
        if p99 * 1e3 <= slo_ms:
            continue
        # the offending bucket: the slowest populated bucket at/above the
        # SLO bound — where the burn actually lives (never the fast body)
        slo_idx = LatencyHistogram.bucket_index(slo_ms / 1e3)
        pop = [i for i, n in ((int(k), int(v))
                              for k, v in (hd.get("buckets") or {}).items())
               if n > 0]
        over = [i for i in pop if i >= slo_idx]
        bucket = max(over) if over else (max(pop) if pop else 0)
        ex = (hd.get("exemplars") or {}).get(str(bucket))
        burns.append({
            "tenant": name,
            "slo_p99_ms": round(slo_ms, 3),
            "p99_ms": round(p99 * 1e3, 3),
            "burn_ratio": round(p99 * 1e3 / slo_ms, 3),
            "bucket": bucket,
            "bucket_le_s": round(
                LatencyHistogram.bucket_upper_seconds(bucket), 9),
            "exemplar_trace": (str(ex[0])
                               if isinstance(ex, (list, tuple)) and ex
                               else None),
            "exemplar_value_s": (round(float(ex[1]), 6)
                                 if isinstance(ex, (list, tuple))
                                 and len(ex) == 2 else None),
        })
    if not burns:
        return None
    burns.sort(key=lambda b: (-b["burn_ratio"], b["tenant"]))
    worst = burns[0]
    ex_hint = (f"; pq_tool trace --request {worst['exemplar_trace']} "
               f"prints the retained trace"
               if worst["exemplar_trace"] else
               "; no exemplar retained yet (raise sampling: TPQ_TRACE_TAIL)")
    return {
        "verdict": "slo-burn",
        **worst,
        "burning_tenants": [b["tenant"] for b in burns],
        "advice": (
            f"tenant '{worst['tenant']}' p99 {worst['p99_ms']:g}ms exceeds "
            f"its {worst['slo_p99_ms']:g}ms SLO ({worst['burn_ratio']}x); "
            f"the burn sits in bucket {worst['bucket']} "
            f"(<= {worst['bucket_le_s']:g}s){ex_hint}"),
    }


def doctor_registry(tree: dict) -> "dict | None":
    """Attribute a run's bottleneck from its registry tree (rule-based).

    The overlapped pipeline runs four lanes concurrently; steady-state wall
    time is the *largest* lane, so the verdict is simply the lane with the
    most recorded seconds:

    - ``link``            ``stage_seconds`` (host->device staging — the
      transfers themselves)
    - ``host_decompress``  ``io + decompress + recompress`` seconds (the
      host's half of the work; falls back to the reader's ``host_seconds``
      for prefetch=0 runs that never routed through the chunk pool)
    - ``device_resolve``  the measured per-route device completion seconds
      (the ``device`` registry section, ``TPQ_DEVICE_TIMING``); falls back
      to ``dispatch + finalize`` host-side seconds for artifacts predating
      the device section (never a KeyError — old records stay readable)
    - ``h2d``             measured h2d transfer completion seconds (the
      ``device`` section's ``h2d`` lane; 0 for old artifacts, so the new
      verdict can never fire on a record that carries no evidence for it)
    - ``stall``           budget backpressure (the submitter blocked on
      ``max_memory`` — more memory or less lookahead, not more bandwidth)

    Folds in ``ship_feedback()``: when the routes' measured link-lane
    seconds disagree with the planner's predictions beyond
    ``DOCTOR_ERROR_BAND``, the report carries ``recalibrate_link_mbps`` —
    the measured staging rate as the ``TPQ_LINK_MBPS`` value to re-run
    with (exactly the 1B re-measure procedure in ROADMAP item 1).  With a
    ``device`` section, the report additionally carries a ``device`` block
    naming the dominant device route and kernel family with its
    predicted-vs-measured error ratio, and ``recalibrate_device_mbps``
    when that ratio leaves the band — the device twin of the link loop.

    Returns ``None`` when the tree has no lane seconds to attribute.
    """
    if not isinstance(tree, dict):
        return None
    pipe = tree.get("pipeline") or {}
    reader = tree.get("reader") or {}
    if not isinstance(pipe, dict) or not isinstance(reader, dict):
        return None
    dev = tree.get("device")
    dev = dev if isinstance(dev, dict) else {}
    serve = tree.get("serve")
    serve = serve if isinstance(serve, dict) else {}

    def g(d, k):
        v = d.get(k)
        return float(v) if isinstance(v, (int, float)) else 0.0

    host = (g(pipe, "io_seconds") + g(pipe, "decompress_seconds")
            + g(pipe, "recompress_seconds"))
    if host == 0.0:
        host = g(reader, "host_seconds")
    dev_routes = {r: c for r, c in (dev.get("routes") or {}).items()
                  if isinstance(c, dict)}
    dev_resolve = sum(g(c, "device_seconds") for c in dev_routes.values())
    lanes = {
        "link": g(pipe, "stage_seconds"),
        "host_decompress": host,
        # measured completion seconds when the timing lane ran; the
        # host-side dispatch+finalize wall otherwise (old artifacts,
        # TPQ_DEVICE_TIMING=0 runs)
        "device_resolve": dev_resolve or (g(pipe, "dispatch_seconds")
                                          + g(pipe, "finalize_seconds")),
        "h2d": g(dev.get("h2d") or {}, "device_seconds"),
        "stall": g(pipe, "stall_seconds"),
        # the serve section's queue-wait sum: requests waiting for a worker
        # slot.  Dominant queue-wait means the service is admission-bound —
        # raise TPQ_SERVE_CONCURRENCY (or shed load earlier), the decode
        # lanes are not the problem (records without a serve section carry
        # a 0 here, so the verdict can never fire on old artifacts)
        "admission": g(serve, "queue_wait_seconds"),
    }
    total = sum(lanes.values())
    wr = tree.get("write")
    wr = wr if isinstance(wr, dict) else {}
    wr_lanes = {s: g(wr, f"{s}_seconds")
                for s in ("encode", "compress", "flush", "merge", "compact")}
    wr_lanes["stall"] = g(wr, "stall_seconds")
    wr_total = sum(wr_lanes.values())
    _sheds = serve.get("sheds")
    _sheds = _sheds if isinstance(_sheds, dict) else {}
    overload_pressure = (g(serve, "rejected") + g(_sheds, "low")
                         + g(_sheds, "normal"))
    slo_burn = _slo_burn_block(serve, tree)
    if total <= 0 and wr_total <= 0:
        # no decode/write lane ran — but a service rejecting work IS
        # evidence: an overload where nothing got far enough to decode is
        # exactly when the operator reaches for doctor, and a tenant
        # burning its SLO is evidence the same way
        if overload_pressure < OVERLOAD_MIN_REJECTS and slo_burn is None:
            return None
    out: dict = {}
    if total > 0:
        dominant = max(lanes, key=lambda k: (lanes[k], k))
        out = {
            "lanes": {k: round(v, 6) for k, v in lanes.items()},
            "dominant_lane": dominant,
            "verdict": DOCTOR_VERDICTS[dominant],
            "dominant_share": round(lanes[dominant] / total, 4),
        }
    if dev_routes:
        # name the dominant device route (and kernel family) with its
        # predicted-vs-measured error — the fused-kernel work (ROADMAP
        # direction 2) starts from exactly this attribution
        routes_pred = reader.get("ship_routes") or {}
        dom_route = max(dev_routes,
                        key=lambda r: (g(dev_routes[r], "device_seconds"), r))
        dm = g(dev_routes[dom_route], "device_seconds")
        dp = float((routes_pred.get(dom_route) or {})
                   .get("predicted_device_s") or 0.0)
        kernels = {k: c for k, c in (dev.get("kernels") or {}).items()
                   if isinstance(c, dict)}
        dom_kernel = (max(kernels,
                          key=lambda k: (g(kernels[k], "device_seconds"), k))
                      if kernels else None)
        # the recalibration rate comes from the DOMINANT route alone — a
        # blend across routes (plain's near-zero-compute bytes included)
        # would hand back a TPQ_DEVICE_MBPS far off the resolve
        # throughput whose error ratio tripped the band in the first place
        dom_bytes = g(dev_routes[dom_route], "bytes_in")
        dev_bps = dom_bytes / dm if dom_bytes and dm else 0.0
        dev_err = round(dm / dp, 3) if dm and dp else None
        out["device"] = {
            "dominant_route": dom_route,
            "dominant_kernel": dom_kernel,
            "measured_seconds": round(dm, 9),
            "predicted_seconds": round(dp, 9),
            "error_ratio": dev_err,
            "measured_device_mbps": (round(dev_bps / 1e6, 1)
                                     if dev_bps else None),
        }
        lo, hi = DOCTOR_ERROR_BAND
        if dev_err is not None and dev_bps and not (lo <= dev_err <= hi):
            from .ship import recalibrate_device_mbps

            out["recalibrate_device_mbps"] = recalibrate_device_mbps(dev_bps)
        # fusion-win: a fused megakernel route whose MEASURED device
        # seconds beat the UNFUSED chain's prediction for the same bytes
        # (ship.ShipPlanner.unfused_device_costs, recorded on the fused
        # ship records).  Reported for the dominant (most bytes_in) fused
        # route; interpret-mode runs never qualify on timing grounds here
        # because their measured seconds are not kernel measurements.  On
        # the port the fused routes are the CUDA kernels fused_plain_words
        # (fused_plain) and fused_narrow_words (fused_narrow_snappy); a
        # device="cpu" read runs their plain versions, whose seconds say
        # nothing of the kernels.
        from .ship import FUSED_ROUTES as _FUSED

        fused = sorted((r for r in dev_routes if r in _FUSED),
                       key=lambda r: (-g(dev_routes[r], "bytes_in"), r))
        for r in fused:
            fm = g(dev_routes[r], "device_seconds")
            fp = float((routes_pred.get(r) or {})
                       .get("predicted_unfused_device_s") or 0.0)
            if fm and fp and fm < fp:
                out["fusion_win"] = {
                    "route": r,
                    "measured_seconds": round(fm, 9),
                    "unfused_predicted_seconds": round(fp, 9),
                    "speedup": round(fp / fm, 2),
                }
                break
    cache_sec = tree.get("cache")
    cache_sec = cache_sec if isinstance(cache_sec, dict) else {}
    for tier in ("device", "host"):  # device pressure is the scarcer tier
        tc = cache_sec.get(tier)
        if not isinstance(tc, dict):
            continue
        ev, hits, misses = g(tc, "evictions"), g(tc, "hits"), g(tc, "misses")
        lookups = hits + misses
        rate = hits / lookups if lookups else 0.0
        if (ev >= CACHE_THRASH_MIN_EVICTIONS and lookups
                and rate < CACHE_THRASH_MAX_HIT_RATE):
            # rank the top-evicting file from the per-file map (merged
            # trees sum counts per file, so the ranking stays truthful
            # across merged snapshots)
            files = tc.get("evict_files")
            files = files if isinstance(files, dict) else {}
            top = max(files, key=lambda f: (files[f], f)) if files else None
            out["cache"] = {
                "verdict": "cache-thrash",
                "tier": tier,
                "evictions": int(ev),
                "hit_rate": round(rate, 3),
                "held_bytes": int(g(tc, "held_bytes")),
                "capacity_bytes": int(g(tc, "capacity_bytes")),
                "top_evict_file": top,
                "top_evict_count": int(files.get(top, 0)) if top else 0,
                # the knob that actually governs this tier's budget (the
                # host tier may be riding the plan cache's in fallback)
                "budget_knob": tc.get("budget_knob") or (
                    "TPQ_RESULT_CACHE_HBM_MB" if tier == "device"
                    else "TPQ_RESULT_CACHE_MB"),
            }
            break
    circ = serve.get("circuit")
    circ = circ if isinstance(circ, dict) else {}
    if g(circ, "open_now") > 0:
        # a tripped breaker names its file: the operator's next step is
        # the FILE (quarantine/replace it), not the service's tuning
        out["circuit_open"] = {
            "verdict": "circuit-open",
            "files": [str(f) for f in (circ.get("open_files") or [])],
            "fast_fails": int(g(circ, "fast_fails")),
            "opened": int(g(circ, "opened") + g(circ, "reopened")),
        }
    sheds = _sheds
    if overload_pressure >= OVERLOAD_MIN_REJECTS:
        # the service is turning work away: name WHO is driving the
        # pressure.  Demand (submitted + rejected) ranks the offender —
        # rejected requests never reach `submitted`, so admitted flow
        # alone would hide exactly the tenant being throttled hardest
        tens = {n: t for n, t in (serve.get("tenants") or {}).items()
                if isinstance(t, dict)}
        demand = {n: g(t, "submitted") + g(t, "rejected")
                  for n, t in tens.items()}
        offender = (max(demand, key=lambda n: (demand[n], n))
                    if demand else None)
        victims = sorted(n for n, t in tens.items()
                         if n != offender and g(t, "rejected") > 0)
        hint = g(serve, "retry_after_hint_s")
        out["overload"] = {
            "verdict": "overload",
            "rejected": int(g(serve, "rejected")),
            "sheds": {"low": int(g(sheds, "low")),
                      "normal": int(g(sheds, "normal"))},
            "offending_tenant": offender,
            "offender_demand": int(demand.get(offender, 0)) if offender
            else 0,
            "victims": victims,
            "retry_after_hint_s": round(hint, 3) if hint else None,
            "advice": (
                f"tenant '{offender}' drives the overload: lower its "
                "fair-share weight or give it a dedicated budget slice "
                "(TPQ_SERVE_TENANTS), or raise queue_depth/max_memory"
                if offender else
                "raise queue_depth/max_memory or shed earlier"),
        }
    if slo_burn is not None:
        out["slo_burn"] = slo_burn
    io_sec = tree.get("io")
    io_sec = io_sec if isinstance(io_sec, dict) else {}
    hedges_issued = g(io_sec, "hedges_issued")
    if hedges_issued >= HEDGE_VERDICT_MIN_ISSUED:
        hedges_won = g(io_sec, "hedges_won")
        wasted = g(io_sec, "hedges_wasted_bytes")
        win_rate = hedges_won / hedges_issued
        if win_rate < HEDGE_VERDICT_MIN_WIN_RATE and wasted > 0:
            # duplicates were paid but the primary almost always won the
            # race anyway: the hedge delay is below the real p90 —
            # raise TPQ_IO_HEDGE_MS (or let auto re-learn) before the
            # wasted bytes outweigh the tail they were buying down
            out["hedge"] = {
                "verdict": "hedge-ineffective",
                "issued": int(hedges_issued),
                "won": int(hedges_won),
                "win_rate": round(win_rate, 3),
                "wasted_bytes": int(wasted),
            }
    eng = io_sec.get("engine")
    eng = eng if isinstance(eng, dict) else {}
    eng_done = g(eng, "completed") + g(eng, "failed")
    if eng_done >= IO_CONC_MIN_FETCHES:
        cap = g(eng, "inflight_cap")
        peak = g(eng, "inflight_peak")
        qw = g(eng, "queue_wait_seconds")
        fs = g(eng, "fetch_seconds")
        io_lane = g(pipe, "io_seconds")
        # the io lane must actually dominate the decode-side lanes: a run
        # bottlenecked on decompress or staging has no concurrency story
        io_dominant = (io_lane > 0
                       and io_lane >= (g(pipe, "decompress_seconds")
                                       + g(pipe, "recompress_seconds"))
                       and io_lane >= g(pipe, "stage_seconds"))
        pf = int(g(pipe, "prefetch"))
        if io_dominant and cap > 0:
            knob = None
            if (peak >= IO_CONC_PIN_FRACTION * cap and qw > 0
                    and qw >= IO_CONC_QUEUE_WAIT_RATIO * fs):
                # every slot stayed occupied and ranges queued for slots
                # far longer than they fetched: the engine cap is the wall
                knob = "TPQ_IO_INFLIGHT"
            elif (pf > 0 and peak <= pf + 1
                  and peak < IO_CONC_PIN_FRACTION * cap and fs > 0):
                # slots were free (no slot queueing to speak of) but the
                # feed never got deeper than the decode window: in-flight
                # depth is prefetch-limited, not engine-limited
                knob = "prefetch="
            if knob is not None:
                out["io_concurrency"] = {
                    "verdict": "io-concurrency-bound",
                    "inflight_peak": int(peak),
                    "inflight_cap": int(cap),
                    "queue_wait_seconds": round(qw, 6),
                    "fetch_seconds": round(fs, 6),
                    "knob": knob,
                    "advice": (
                        f"in-flight peak {int(peak)} pinned at the engine "
                        f"cap {int(cap)} with {qw:.3f}s of slot queueing vs "
                        f"{fs:.3f}s fetching: raise TPQ_IO_INFLIGHT"
                        if knob == "TPQ_IO_INFLIGHT" else
                        f"in-flight peak {int(peak)} never left the "
                        f"prefetch={pf} decode window (engine cap "
                        f"{int(cap)} idle): raise prefetch="),
                }
    fb = reader.get("ship_feedback")
    routes = (fb or {}).get("routes") or {}
    if routes:
        pred = sum(float(r.get("predicted_seconds") or 0.0)
                   for r in routes.values())
        timed = [float(r["measured_seconds"]) for r in routes.values()
                 if r.get("measured_seconds") is not None]
        # same null-vs-0.0 contract as ship_feedback: "no route was ever
        # timed" is None, a tiny-but-real sum stays a number (9 decimals,
        # is-not-None gating — truthiness would flatten ~1e-7s to "unmeasured")
        meas = sum(timed) if timed else None
        link_bps = float(fb.get("link_bytes_per_sec") or 0.0)
        err = (round(meas / pred, 3)
               if meas is not None and pred else None)
        out["route_model"] = {
            "predicted_seconds": round(pred, 9),
            "measured_seconds": round(meas, 9) if meas is not None else None,
            "error_ratio": err,
            "measured_link_mbps": (round(link_bps / 1e6, 1)
                                   if link_bps else None),
            "planner_link_mbps": reader.get("planner_link_mbps") or None,
        }
        lo, hi = DOCTOR_ERROR_BAND
        if err is not None and link_bps and not (lo <= err <= hi):
            from .ship import recalibrate_link_mbps

            out["recalibrate_link_mbps"] = recalibrate_link_mbps(link_bps)
    if wr_total > 0:
        # the write-side attribution: same rule shape as the read lanes —
        # the dominant lane names the bottleneck (encode = CPU encoding,
        # compress = the codec, flush = the sink, stall = the memory
        # budget), so a slow write is attributable the way a slow read is
        wd = max(wr_lanes, key=lambda k: (wr_lanes[k], k))
        out["write"] = {
            "lanes": {k: round(v, 6) for k, v in wr_lanes.items()},
            "dominant_lane": wd,
            "verdict": f"write-{wd}-bound",
            "dominant_share": round(wr_lanes[wd] / wr_total, 4),
            "rows_per_sec": wr.get("rows_per_sec") or 0.0,
            "bytes_per_sec": wr.get("bytes_per_sec") or 0.0,
        }
    return out


# ---------------------------------------------------------------------------
# autopsy: rule-based hang/crash attribution (the pq_tool autopsy backend)
# ---------------------------------------------------------------------------

# thread-blockage classes autopsy can assign, most diagnostic first; the
# rule table below walks each dumped stack innermost-out and returns the
# first matching class (obs/threading frames are skipped, not classified —
# a signal handler's own frames sit on top of the interrupted wait)
AUTOPSY_CLASSES = ("io-wait", "budget-wait", "queue-get", "future-wait",
                   "device-sync", "worker-idle", "lock-wait", "obs",
                   "running")


def _classify_frames(frames) -> str:
    """One thread's blockage class from its dumped stack (outermost-first
    frame dicts, as FlightRecorder stores them)."""
    waitish = None
    for f in reversed(frames or []):  # innermost first
        path = str(f.get("file", "")).replace("\\", "/")
        func = str(f.get("func", ""))
        if path.endswith("tpu_parquet_torch/iostore.py"):
            # blocked inside the IO backend (a stalled fetch, an injected
            # stall, a backoff sleep): the network-stall verdict's signal —
            # checked before the generic waits because the stalled worker's
            # INNERMOST frames are an Event/sleep in threading.py
            return "io-wait"
        if path.endswith("tpu_parquet_torch/alloc.py") and func in (
                "acquire", "try_acquire"):
            return "budget-wait"
        if path.endswith("/queue.py") and func in ("get", "put"):
            return "queue-get"
        if "concurrent/futures" in path and func in ("result", "wait"):
            return "future-wait"
        if "concurrent/futures" in path and func == "_worker":
            # a pool worker idle on its (C-level, frame-less) work queue:
            # the producer side waiting for work, NOT a starved consumer —
            # it must never feed the dead-worker verdict
            return "worker-idle"
        if "/torch/cuda/" in path and func == "synchronize":
            # torch.cuda.synchronize, Event.synchronize, Stream.synchronize:
            # the thread waits for the card
            return "device-sync"
        if path.endswith("/threading.py") or path.endswith(
                "tpu_parquet_torch/obs.py"):
            # a bare lock/Event wait, or the recorder's own dump frames on
            # top of the interrupted stack: keep scanning outward for the
            # frame that says WHOSE wait this is
            if func in ("wait", "_wait_for_tstate_lock", "join"):
                waitish = waitish or "lock-wait"
            continue
    return waitish or "running"


# exception class names the data-corruption autopsy rule recognizes: the
# ParquetError family a decode raises for malformed INPUT (HangError /
# RetryExhaustedError are deliberately absent — hangs and transport faults
# have their own verdicts)
_DATA_ERROR_TYPES = frozenset({
    "ParquetError", "DataIntegrityError", "CompressionError", "RLEError",
    "ThriftError", "CheckpointError",
})


def autopsy_dump(doc: dict) -> dict:
    """Attribute a flight-recorder dump: which lane stopped advancing
    first, which threads are blocked on what, the longest budget-wait age,
    and a one-line probable cause (rule-based, golden-tested).

    Raises ``ValueError`` for anything that is not a readable
    ``FLIGHT_VERSION`` dump — autopsy must refuse documents it would
    misread, the same contract as the registry/ledger versions.
    """
    if not isinstance(doc, dict) or "flight_version" not in doc:
        raise ValueError("not a flight-recorder dump (no flight_version)")
    if doc.get("flight_version") != FLIGHT_VERSION:
        raise ValueError(
            f"flight_version {doc.get('flight_version')!r} != "
            f"{FLIGHT_VERSION}")
    wd = doc.get("watchdog") or {}
    threads_out: dict = {}
    classes: dict[str, int] = {}
    for tid, t in (doc.get("threads") or {}).items():
        if not isinstance(t, dict):
            continue
        name = str(t.get("name", "?"))
        if name.startswith(("tpq-watchdog", "tpq-sampler")):
            cls = "obs"
        else:
            cls = _classify_frames(t.get("stack"))
        last = t.get("last_event") or None
        threads_out[tid] = {
            "name": name,
            "alive": bool(t.get("alive", True)),
            "class": cls,
            "last_event": ({"name": last.get("name"),
                            "age_s": last.get("age_s")}
                           if isinstance(last, dict) else None),
        }
        classes[cls] = classes.get(cls, 0) + 1
    budgets = [b for b in (doc.get("budgets") or []) if isinstance(b, dict)]
    waiters = sum(int(b.get("waiters") or 0) for b in budgets)
    longest = max((float(b.get("longest_wait_s") or 0.0) for b in budgets),
                  default=0.0)
    dead = [t["name"] for t in threads_out.values() if not t["alive"]]
    stalled_first = wd.get("stalled_first")
    # quarantine state at dump time (quarantine.Quarantine registers itself
    # as a flight source): recorded data errors + the FIRST bad
    # (file, column, page) — the data-corruption verdict's evidence
    q_first = None
    q_errors = 0
    for label, s in sorted((doc.get("samples") or {}).items()):
        if label.startswith("quarantine") and isinstance(s, dict):
            q_errors += int(s.get("errors") or 0)
            if q_first is None and isinstance(s.get("first"), dict):
                q_first = s["first"]
    err = doc.get("error") or {}
    data_error = (isinstance(err, dict)
                  and err.get("type") in _DATA_ERROR_TYPES)
    # an explicit error of some OTHER class outranks contained quarantine
    # records: errors the run already moved past must not mask the crash
    # that actually killed it
    unrelated_error = (isinstance(err, dict) and err.get("type")
                       and not data_error)
    # the in-flight range of any IO store at dump time (iostore.IOStats
    # registers itself as a flight source) — a stalled fetch's single most
    # diagnostic fact
    io_inflight = None
    for label, s in sorted((doc.get("samples") or {}).items()):
        if (label.startswith("iostore") and isinstance(s, dict)
                and s.get("inflight_age_s")):
            if io_inflight is None or (s["inflight_age_s"]
                                       > io_inflight["age_s"]):
                io_inflight = {"offset": s.get("inflight_offset"),
                               "size": s.get("inflight_size"),
                               "age_s": s.get("inflight_age_s")}
    # the scan service's admission state at dump time (serve.ScanService
    # registers itself as a flight source): the report names the OLDEST
    # in-flight request — for a one-request wedge, that IS the stuck one
    serve_state = None
    sv = (doc.get("samples") or {}).get("serve")
    if isinstance(sv, dict):
        oldest = None
        for rid, r in sorted((sv.get("requests") or {}).items()):
            if isinstance(r, dict) and (
                    oldest is None
                    or float(r.get("age_s") or 0.0)
                    > float(oldest[1].get("age_s") or 0.0)):
                oldest = (rid, r)
        serve_state = {
            "queue_depth": sv.get("queue_depth"),
            "in_flight": sv.get("in_flight"),
            "stuck_request": ({"id": oldest[0],
                               "path": oldest[1].get("path"),
                               "age_s": oldest[1].get("age_s")}
                              if oldest is not None else None),
            # open circuits at dump time (BreakerBoard.open_files shape):
            # the verdict names the first file when nothing more specific
            # explains the dump
            "circuit_open": [c for c in (sv.get("circuit_open") or [])
                             if isinstance(c, dict) and c.get("file")],
        }
    # the rule table, most specific first.  Data corruption never hangs —
    # an explicit data-integrity error (or quarantined failures on a crash
    # dump) outranks every stall inference.
    if data_error or (q_errors and not stalled_first
                      and not unrelated_error):
        verdict = "data-corruption"
        if q_first is not None:
            where = (f" — first bad: file {q_first.get('file')!r}, column "
                     f"{q_first.get('column')!r}, row group "
                     f"{q_first.get('row_group')}, page {q_first.get('page')}")
        elif isinstance(err, dict) and err.get("message"):
            where = f" — {err['message']}"
        else:
            where = ""
        cause = (f"the input data is malformed, not the pipeline"
                 f"{where}; quarantine the named unit "
                 f"(TPQ_ON_DATA_ERROR=skip_unit contains it, "
                 f"pq_tool quarantine summarizes the ledger)")
    elif classes.get("io-wait") or (io_inflight is not None
                                    and wd.get("stalled_first")):
        verdict = "network-stall"
        where = (f" (offset {io_inflight['offset']}, "
                 f"{io_inflight['size']} bytes, in flight "
                 f"{io_inflight['age_s']:g}s)" if io_inflight else "")
        cause = (f"a range fetch stalled in the IO backend{where} — the "
                 f"store never returned and every lane behind it froze; "
                 f"check the transport, or bound the fetch with "
                 f"TPQ_IO_DEADLINE_S so retries can take over")
    elif classes.get("budget-wait") or waiters:
        verdict = "budget-wait"
        cause = (f"submitter starved on InFlightBudget "
                 f"({max(waiters, classes.get('budget-wait', 0))} waiter(s), "
                 f"longest wait {longest:.1f}s): nothing downstream releases "
                 f"bytes — raise max_memory, shrink prefetch, or unblock the "
                 f"consumer")
    elif classes.get("device-sync"):
        verdict = "device-sync"
        cause = ("a thread is blocked inside the device runtime "
                 "(stage/dispatch never returned) — a device hang, not a "
                 "host-side bug")
    elif classes.get("queue-get") or classes.get("future-wait"):
        verdict = "dead-worker"
        cause = ("consumers are waiting on work that is not being produced"
                 + (f" (dead thread(s): {', '.join(sorted(dead))})"
                    if dead else "")
                 + " — a worker died or its input stream stopped")
    elif stalled_first:
        verdict = f"stalled-{stalled_first.split('.', 1)[0]}"
        cause = (f"lane {stalled_first!r} stopped advancing first with no "
                 f"classified blocked thread — likely stuck in user code or "
                 f"a long single unit of work")
    elif serve_state and serve_state.get("circuit_open"):
        # nothing wedged or corrupt, but circuits are open: the dump's
        # most actionable fact is WHICH file keeps failing
        first_open = serve_state["circuit_open"][0]
        verdict = "circuit-open"
        cause = (f"circuit open for {first_open['file']!r} "
                 f"(next probe in {first_open.get('retry_after_s', '?')}s)"
                 f" — the file keeps failing its requests; inspect or "
                 f"replace it (pq_tool quarantine shows contained errors), "
                 f"healthy files are unaffected")
    else:
        verdict = "inconclusive"
        cause = ("no blocked thread classified and no stalled lane recorded"
                 " — re-dump while the process is actually wedged")
    return {
        "reason": doc.get("reason"),
        "pid": doc.get("pid"),
        "stalled_first": stalled_first,
        "ages": wd.get("ages") or {},
        "hang_s": wd.get("hang_s"),
        "threads": threads_out,
        "budget": {"waiters": waiters,
                   "longest_wait_s": round(longest, 3)} if budgets else None,
        "io": io_inflight,
        "serve": serve_state,
        "data_errors": ({"errors": q_errors, "first": q_first}
                        if q_errors or data_error else None),
        "error": doc.get("error"),
        "verdict": verdict,
        "probable_cause": cause,
    }


# ---------------------------------------------------------------------------
# dump triggers: worker crash, unhandled exception, signal
# ---------------------------------------------------------------------------

_crash_dump_done = False


def note_worker_crash(exc: BaseException) -> None:
    """Called by pipeline/loader worker wrappers when ``fn`` raises: the
    crash lands in the ring unconditionally (``worker_crash`` instant);
    with ``TPQ_FLIGHT`` set, the FIRST crash also writes a dump — the
    artifact for a worker death the consumer may never fully report."""
    global _crash_dump_done
    rec = flight_recorder()
    rec.record("i", "worker_crash", time.perf_counter(), 0.0,
               {"type": type(exc).__name__, "msg": str(exc)[:200]})
    from .errors import HangError

    if isinstance(exc, HangError):
        # the watchdog's own abort propagating through a worker: it
        # already wrote the hang dump (mid-stall state, the one autopsy
        # wants) — a second dump here would OVERWRITE it with a
        # post-mortem taken after the stall cleared
        return
    if os.environ.get("TPQ_FLIGHT") and not _crash_dump_done:
        _crash_dump_done = True
        try:
            rec.dump(reason="worker-crash", error=exc)
        except Exception:  # noqa: BLE001 — diagnostics never mask the crash
            pass


_hooks_installed = False
_installed_excepthook = None
_installed_prev_hook = None


def install_flight_hooks(force: bool = False) -> dict:
    """Install the opt-in dump triggers (idempotent; returns what took):

    - ``TPQ_DUMP_SIGNAL=<USR1|SIGUSR1|10|...>``: a signal handler that
      writes a flight dump on receipt (``faulthandler`` style — send the
      signal to a hung process, collect the dump, run ``pq_tool autopsy``).
      Main-thread only; silently skipped elsewhere.
    - ``TPQ_FLIGHT=<path>``: a ``sys.excepthook`` wrapper that writes a
      dump before the interpreter dies of an unhandled exception (the
      exit-on-error artifact), chaining to the previous hook.

    Runs once at import; ``force=True`` re-reads the env (tests)."""
    global _hooks_installed
    out = {"signal": False, "excepthook": False}
    if _hooks_installed and not force:
        return out
    _hooks_installed = True
    sig = os.environ.get("TPQ_DUMP_SIGNAL", "")
    if sig:
        try:
            import signal as _signal

            if sig.isdigit():
                signum = _signal.Signals(int(sig))
            else:
                signum = getattr(
                    _signal, sig if sig.startswith("SIG") else f"SIG{sig}")

            def _dump_async():
                try:
                    flight_recorder().dump(reason="signal")
                except Exception:  # noqa: BLE001 — never crash the helper
                    pass

            def _on_dump_signal(signum, frame):  # noqa: ARG001
                # Python signal handlers run on the MAIN thread between its
                # bytecodes: the interrupted code may hold one of the locks
                # the snapshot needs (recorder ring, PipelineStats, budget
                # cv), and a same-thread re-acquire would deadlock the very
                # process this handler is meant to diagnose.  A helper
                # thread WAITS on those locks instead (they are all short,
                # never-held-while-blocking critical sections).
                try:
                    threading.Thread(target=_dump_async,
                                     name="tpq-flight-dump",
                                     daemon=True).start()
                except Exception:  # noqa: BLE001 — never crash the handler
                    pass

            _signal.signal(signum, _on_dump_signal)
            out["signal"] = True
        except (AttributeError, ValueError, OSError, TypeError):
            pass  # unknown name, non-main thread, unsupported platform
    if os.environ.get("TPQ_FLIGHT"):
        global _installed_excepthook, _installed_prev_hook
        prev_hook = sys.excepthook
        if prev_hook is _installed_excepthook and prev_hook is not None:
            # re-install (force=True): chain to the ORIGINAL hook, never to
            # our own previous wrapper — stacking would dump N times and
            # pin every prior wrapper alive
            prev_hook = _installed_prev_hook

        def _flight_excepthook(tp, val, tb):
            try:
                flight_recorder().dump(reason="crash", error=val)
            except Exception:  # noqa: BLE001
                pass
            prev_hook(tp, val, tb)

        _installed_excepthook = _flight_excepthook
        _installed_prev_hook = prev_hook
        sys.excepthook = _flight_excepthook
        out["excepthook"] = True
    return out


install_flight_hooks()
