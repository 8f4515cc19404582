"""ScanService: many concurrent scan requests over one shared plan cache.

The counterpart of ``tpu_parquet.serve.service``.  The one-shot readers
are the wrong shape for heavy traffic from many users: every request
re-parses, re-plans, and fights every other request for memory with no
arbitration.  This service puts a bounded admission pipeline in front of
the same readers:

    submit() --bounded queue--> worker pool --InFlightBudget--> reader
       |                           |
       +- queue full: OverloadError (fast-reject, never a blocked caller)
                                   +- per-request p50/p95 latency SLOs

- **Shared state**: one :class:`~tpu_parquet_torch.serve.PlanCache`:
  footers, ScanPlans (route and pruning memos) and decoded dictionaries
  are read through it, so concurrent requests over a working set parse
  each file's metadata once.
- **Admission control**: a bounded request queue (``TPQ_SERVE_QUEUE``)
  and ``TPQ_SERVE_CONCURRENCY`` workers (``tpq-serve-<i>``); each admitted
  request charges its plan's
  :meth:`~tpu_parquet_torch.scanplan.ScanPlan.estimated_bytes` against
  one shared :class:`~tpu_parquet_torch.alloc.InFlightBudget`
  (``max_memory``) before reading a byte.  Brownout sheds low-priority
  work first, per-file circuit breakers fast-fail a file that keeps
  failing, and fair-share tenants (``tenancy``) keep a noisy neighbor's
  flood from parking everyone else.
- **SLOs**: per-request queue-wait and execution latencies land in
  :class:`~tpu_parquet_torch.obs.LatencyHistogram`\\ s under the
  registry ``serve`` section (``obs.doctor_registry`` says
  ``admission-bound`` when queue wait dominates).
- **Hang containment**: with ``hang_s`` (or ``TPQ_HANG_S``) each
  executing request is watched by its own
  :class:`~tpu_parquet_torch.obs.Watchdog`; a stalled store fetch dumps
  flight state (the dump's ``serve`` sample names the stuck request) and
  aborts THAT request with :class:`~tpu_parquet_torch.errors.HangError`.
- **The device**: ``device=True`` requests decode with
  ``DeviceFileReader`` on the service's device (``ScanService(device=)``,
  ``cuda`` unless the caller names another) into torch tensors, and
  ``device=True`` streams ship their batches there.  Without a CUDA
  device such a request raises at ``submit()``; it never runs on the CPU
  instead.  ``device=False`` requests decode with the host ``FileReader``
  into numpy, as in the reference.

Where the port differs from the reference on purpose: the explicit
``device`` above (the reference's ``device=True`` means the default JAX
device), result-cache entries signed with that resolved device (a bare
``True`` would sign the default CUDA device and a ``device="cpu"``
service's reader would drop the adapter: every warm request a silent
miss), a cancel, deadline or hang verdict delivered without the read's
frames (their tensors would stay on the card for as long as the caller
keeps the error), and a worker that keeps no finished request alive
while it waits for the next.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
import weakref
from collections.abc import Mapping
from contextlib import nullcontext

import torch

from ..alloc import InFlightBudget
from ..errors import (CancelledError, DeadlineExceededError, HangError,
                      OverloadError, ParquetError, RetryExhaustedError,
                      TransientIOError)
from ..obs import (LatencyHistogram, MetricsDumper, RequestTrace,
                   TailSampler, env_float, env_int, register_flight_source,
                   resolve_hang_s, set_request_trace)
from ..resilience import BreakerBoard, CancelToken
from ..torch_decode import _resolve_device
from .cache import BoundDictCache, PlanCache
from .stream import (StreamingScan, check_cursor_compatible, request_digest,
                     unpack_cursor)
from .tenancy import (DEFAULT_TENANT, FairScheduler, TenantRegistry,
                      fair_enabled)

__all__ = ["ScanRequest", "ScanService", "ScanTicket", "ServeStats"]

# request priority bands (ScanRequest.priority): brownout sheds from the
# bottom up — LOW goes first, NORMAL under deeper pressure, HIGH only when
# the queue is physically full
PRIORITY_LOW, PRIORITY_NORMAL, PRIORITY_HIGH = 0, 1, 2

# the failure classes a circuit breaker counts: transport exhaustion,
# transient-surfaced faults, malformed data, and transport wedges — all
# properties of the FILE/STORE, not of the caller (deadline expiry and
# caller cancellation are deliberately absent: an impatient client must
# never open a healthy file's circuit)
_CLASSIFIED_FAILURES = (RetryExhaustedError, TransientIOError, ParquetError,
                        HangError)

# the verdicts that end a request from outside its read: delivered to the
# caller without the read's frames (and the tensors they hold)
_ABORT_VERDICTS = (HangError, DeadlineExceededError, CancelledError)

_req_ids = itertools.count(1)


def _span(trace, name, **args):
    """A RequestTrace span, or a no-op when the request carries no trace
    (tracing off) — keeps the instrumented call sites branch-free."""
    return trace.span(name, **args) if trace is not None else nullcontext()


def _count_rows(result: dict) -> int:
    """Best-effort served-row accounting over a response tree ({path:
    {column: ColumnData | DeviceColumnData | [per-row-group parts]}}).
    Accounting only — it must never be able to fail a completed request."""
    rows = 0
    for cols in result.values():
        if not cols:
            continue
        first = next(iter(cols.values()))
        parts = first if isinstance(first, list) else [first]
        rows += sum(int(getattr(p, "num_leaf_slots", 0) or 0)
                    for p in parts)
    return rows


class ScanRequest:
    """One scan: a file set + projection + predicate + response shape.

    ``paths``: the files (str/PathLike), scanned in order.  ``columns``:
    projection (None = all).  ``filter``: a :mod:`~tpu_parquet_torch.predicate`
    Predicate or its text form (``parse_filter`` grammar); yielded rows are
    the readers' usual superset contract.  ``prefetch``: per-file chunk
    pipeline depth.  ``device=True`` decodes to torch tensors on the
    service's device through ``DeviceFileReader`` (host ``FileReader``
    otherwise, numpy; the fixed shape of a batched response is the
    loader's job: this service returns the reader's columnar output per
    file).

    ``deadline_s`` is the request's END-TO-END budget (queue wait
    included): when it expires the request stops issuing new IO at the
    next unit boundary, frees its admission-budget charge, and raises
    :class:`~tpu_parquet_torch.errors.DeadlineExceededError` for this caller
    only.  ``priority`` (:data:`PRIORITY_LOW` / ``NORMAL`` / ``HIGH``)
    feeds brownout shedding: under ``TPQ_SERVE_BROWNOUT`` pressure the
    low band is shed first with a drain-rate ``retry_after_s`` hint while
    high-priority traffic still admits.

    ``tenant`` names the requester for fair-share admission, budget
    slicing, and per-tenant SLO accounting (unset = the default tenant).
    ``stream=True`` returns a :class:`~tpu_parquet_torch.serve.StreamingScan`
    session from ``scan()``/``result()`` instead of a materialized
    response: iterate it for fixed-shape ``batch_rows``-row padded+masked
    batches.  ``cursor`` resumes a streaming session from a prior
    session's :meth:`~tpu_parquet_torch.serve.StreamingScan.cursor` blob
    (validated at submit time; a mismatched request shape raises
    :class:`~tpu_parquet_torch.errors.CheckpointError`).
    """

    __slots__ = ("paths", "columns", "filter", "prefetch", "device",
                 "validate_crc", "deadline_s", "priority", "tenant",
                 "stream", "batch_rows", "cursor")

    def __init__(self, paths, columns=None, filter=None,  # noqa: A002
                 prefetch: int = 0, device: bool = False,
                 validate_crc=None, deadline_s: "float | None" = None,
                 priority: int = PRIORITY_NORMAL,
                 tenant: "str | None" = None, stream: bool = False,
                 batch_rows: int = 1024,
                 cursor: "bytes | None" = None):
        import os

        self.paths = ([paths] if isinstance(paths, (str, bytes, os.PathLike))
                      else list(paths))
        self.columns = columns
        self.filter = filter
        self.prefetch = int(prefetch)
        self.device = bool(device)
        self.validate_crc = validate_crc
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.priority = min(max(int(priority), PRIORITY_LOW), PRIORITY_HIGH)
        self.tenant = DEFAULT_TENANT if not tenant else str(tenant)
        self.stream = bool(stream)
        self.batch_rows = int(batch_rows)
        self.cursor = cursor


class ScanTicket:
    """The admission receipt: ``result(timeout)`` blocks for the response
    (re-raising the request's failure), ``done()`` polls, ``cancel()``
    takes the request back — it stops issuing new IO at the next unit
    boundary, releases what it held, and ``result()`` raises
    :class:`~tpu_parquet_torch.errors.CancelledError`."""

    __slots__ = ("id", "token", "_event", "_result", "_exc", "queue_wait_s",
                 "exec_s")

    def __init__(self, rid: int, token: "CancelToken | None" = None):
        self.id = rid
        self.token = token if token is not None else CancelToken()
        self._event = threading.Event()
        self._result = None
        self._exc: "BaseException | None" = None
        self.queue_wait_s = 0.0
        self.exec_s = 0.0

    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        """Cancel this request (idempotent; the first cause wins).  A
        queued request fails the moment a worker picks it up; an executing
        one stops at its next unit boundary — either way its budget bytes
        release and no new IO is issued."""
        self.token.cancel(CancelledError(
            f"scan request #{self.id} cancelled by caller"))

    def result(self, timeout: "float | None" = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"scan request #{self.id} still running")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _finish(self, result=None, exc: "BaseException | None" = None):
        self._result = result
        self._exc = exc
        self._event.set()


class ServeStats:
    """Service counters (all flows except the gauges; composes by addition
    in the registry ``serve`` section)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.queue_wait_seconds = 0.0
        self.exec_seconds = 0.0
        self.rows = 0
        self.queue_depth_peak = 0
        # request-lifecycle outcomes (subsets of `failed`).  Accounting
        # contract: `submitted` counts ADMITTED requests only; `rejected`
        # counts never-admitted ones (queue-full + brownout sheds, which
        # never enter `submitted`) plus close()-drained tickets (which
        # do) — so admitted work reconciles as submitted == completed +
        # failed + drained, while sheds/fast-rejects stand apart as the
        # load the service refused at the door.
        self.deadline_exceeded = 0
        self.cancelled = 0
        # brownout sheds by priority band (subsets of `rejected`)
        self.shed_low = 0
        self.shed_normal = 0
        # streaming sessions admitted (subset of `submitted`) + batches
        # delivered; retry_after_hint_s is a GAUGE — the back-off hint the
        # most recent shed/reject carried (obs merges max it)
        self.stream_sessions = 0
        self.stream_batches = 0
        # mid-stream worker-slot yields (stream-aware fair scheduling):
        # how many times a session parked so another tenant could run
        self.stream_yields = 0
        self.retry_after_hint_s = 0.0

    def as_dict(self) -> dict:
        with self.lock:
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                "queue_wait_seconds": round(self.queue_wait_seconds, 6),
                "exec_seconds": round(self.exec_seconds, 6),
                "rows": self.rows,
                "queue_depth_peak": self.queue_depth_peak,
                "deadline_exceeded": self.deadline_exceeded,
                "cancelled": self.cancelled,
                "sheds": {"low": self.shed_low, "normal": self.shed_normal},
                "stream_sessions": self.stream_sessions,
                "stream_batches": self.stream_batches,
                "stream_yields": self.stream_yields,
                "retry_after_hint_s": self.retry_after_hint_s,
            }


class ScanService:
    """The concurrent scan front end.  Construct once, ``submit()`` from
    any thread, ``close()`` when done (context manager supported)."""

    def __init__(self, concurrency: "int | None" = None,
                 queue_depth: "int | None" = None, max_memory: int = 0,
                 cache: "PlanCache | None" = None, store=None,
                 hang_s=None, validate_crc=None,
                 brownout: "float | None" = None,
                 breakers: "BreakerBoard | None" = None,
                 result_cache_mb: "int | None" = None,
                 result_cache_hbm_mb: "int | None" = None,
                 tenants: "TenantRegistry | Mapping | str | None" = None,
                 fair: "bool | None" = None,
                 stream_yield: "bool | None" = None,
                 device=None):
        from ..iostore import ByteStore

        # where device=True requests decode and device streams ship:
        # checked at submit(), so a host-only service needs no card
        self.device = torch.device("cuda" if device is None else device)

        if concurrency is None:
            concurrency = env_int("TPQ_SERVE_CONCURRENCY", 4, lo=1)
        if queue_depth is None:
            queue_depth = env_int("TPQ_SERVE_QUEUE", 2 * concurrency, lo=1)
        self.concurrency = int(concurrency)
        # result_cache_mb/_hbm_mb size the decoded-result tier explicitly
        # (the TPQ_RESULT_CACHE_* knobs otherwise decide): with it on, a
        # hot repeated scan becomes a pure cache lookup + batch assembly
        # (see serve/result_cache.py)
        self.cache = (cache if cache is not None
                      else PlanCache(result_cache_mb=result_cache_mb,
                                     result_cache_hbm_mb=result_cache_hbm_mb))
        self.stats = ServeStats()
        self._hang_s = hang_s
        self._validate_crc = validate_crc
        # brownout load shedding: when queue occupancy or held budget
        # bytes cross this fraction, low-priority requests shed with a
        # drain-rate retry_after_s; halfway from there to full, normal
        # priority sheds too — high admits until the queue is physically
        # full.  0 disables.
        self.brownout = (env_float("TPQ_SERVE_BROWNOUT", 0.85, lo=0.0,
                                   hi=1.0)
                         if brownout is None else float(brownout))
        # per-file circuit breakers keyed by the PlanCache generation key
        # (a rewritten file starts with a clean breaker)
        self.breakers = breakers if breakers is not None else BreakerBoard()
        # per-file ByteStore factory (iostore contract), wrapped so the
        # service can fold every created store's IOStats (retries, hedges)
        # into its own registry tree.  Live stores are WEAKLY held (they
        # stay collectable), and each factory store's counters are folded
        # into a service-owned aggregate when its reader CLOSES it —
        # without the fold, a completed request's stats would be
        # garbage-collected with its store and the io section would
        # report zeros for all finished work.
        self._served_stores: "weakref.WeakSet" = weakref.WeakSet()
        self._io_agg: dict = {}
        self._io_agg_lock = threading.Lock()
        if store is None:
            self._store = None
        elif isinstance(store, ByteStore):
            self._store = store
            if store.stats is not None:
                self._served_stores.add(store)
        elif callable(store):
            def _capturing_factory(f, _orig=store):
                st = _orig(f)
                if getattr(st, "stats", None) is not None:
                    self._served_stores.add(st)
                    orig_close = st.close

                    def _close_and_fold(_st=st, _close=orig_close):
                        _close()
                        self._fold_io(_st)

                    st.close = _close_and_fold
                return st

            self._store = _capturing_factory
        else:
            self._store = store  # resolve_store raises its typed error
        # admission: bounded multi-tenant scheduler (fast-reject; deficit
        # round-robin across per-tenant queues unless TPQ_SERVE_FAIR=0
        # degrades it to global FIFO) + shared memory budget (backpressure
        # between ADMITTED requests, charged from the plan IR's byte
        # estimate before any byte is read).  Each tenant also carries its
        # own weight-proportional budget SLICE (tenancy.py) charged before
        # the global budget — one tenant's giant scans queue behind that
        # tenant's slice, not the fleet's.
        self._q = FairScheduler(int(queue_depth), fair=fair_enabled(fair))
        self._budget = InFlightBudget(int(max_memory))
        if tenants is None:
            tenants = TenantRegistry(max_memory=int(max_memory))
        elif isinstance(tenants, str):
            tenants = TenantRegistry(max_memory=int(max_memory), spec=tenants)
        elif isinstance(tenants, Mapping):
            reg = TenantRegistry(max_memory=int(max_memory), spec="")
            for name, weight in tenants.items():
                reg.register(str(name), weight=int(weight))
            tenants = reg
        elif not isinstance(tenants, TenantRegistry):
            raise TypeError(
                "tenants= must be a TenantRegistry, a {name: weight} "
                f"mapping, or a spec string, not {type(tenants).__name__}")
        self.tenants = tenants
        if tenants is not None and int(max_memory) > 0:
            self.tenants.set_max_memory(int(max_memory))
        # live streaming sessions by ticket id — close() aborts them so a
        # blocked next() caller gets its terminal verdict, not a hang
        self._streams: dict = {}
        self._hist_wait = LatencyHistogram()
        self._hist_exec = LatencyHistogram()
        self._hist_total = LatencyHistogram()
        # request tracing: every admitted request carries a RequestTrace on
        # its cancel token; the tail sampler keeps the interesting trees
        # (slow / errored / deadline / shed / 1-in-N) in a byte-bounded
        # ring.  Per-instance (env-tuned at construction) so one test's or
        # service's retention never bleeds into another's.
        self.sampler = TailSampler()
        # periodic registry snapshots (TPQ_METRICS_DUMP=path:interval_s) —
        # the file `pq_tool metrics --watch` polls; inert when unset
        self._dumper = MetricsDumper(self.obs_registry)
        self._dumper.start()
        # fleet spool: per-process snapshots into TPQ_OBS_SPOOL (obs_fleet;
        # inert when unset) — what FleetAggregator / `pq_tool top` read
        from ..obs_fleet import SpoolWriter

        self._spool = SpoolWriter(self.obs_registry, role="serve",
                                  sampler=self.sampler)
        self._spool.start()
        # stream-aware fair scheduling: a streaming session hands its
        # worker slot back between batches while another tenant has queued
        # work (DRR at batch granularity).  Only meaningful under fair
        # scheduling; TPQ_SERVE_STREAM_YIELD=0 (or stream_yield=False)
        # pins a session to its slot for its whole lifetime (the old
        # behavior, and the bench A/B).
        if stream_yield is None:
            stream_yield = os.environ.get(
                "TPQ_SERVE_STREAM_YIELD", "1") != "0"
        self._stream_yield = bool(stream_yield) and self._q.fair
        self._inflight: dict = {}  # rid -> (path0, t_start)
        self._inflight_lock = threading.Lock()
        self._closed = False
        # serializes the closed-check+enqueue in submit() against close()'s
        # drain+sentinels: without it a racing submit can land its item
        # BEHIND the shutdown sentinels — never processed, never finished,
        # a caller blocked in result() forever
        self._submit_lock = threading.Lock()
        self._workers = [
            threading.Thread(target=self._worker, name=f"tpq-serve-{i}",
                             daemon=True)
            for i in range(self.concurrency)
        ]
        for t in self._workers:
            t.start()
        # a wedged process's flight dump must name the stuck request —
        # autopsy prints this sample's oldest in-flight entry
        register_flight_source("serve", self, "sample")

    # -- submission ------------------------------------------------------------

    def _occupancy(self) -> float:
        """Admission pressure in [0, 1]: the FULLER of the request queue
        and the in-flight memory budget (either one saturating is the
        brownout signal — a deep queue of tiny requests and a shallow
        queue of huge ones both mean new work will wait)."""
        q_frac = self._q.qsize() / self._q.maxsize if self._q.maxsize else 0.0
        b = self._budget
        b_frac = (b.held / b.max_bytes) if b.max_bytes > 0 else 0.0
        return max(q_frac, min(b_frac, 1.0))

    def _retry_after_s(self) -> float:
        """Back-off hint from the observed drain rate: roughly how long
        until the current backlog clears one worker slot (floored so a
        cold service never tells a caller to retry in 0 seconds)."""
        with self.stats.lock:
            completed = self.stats.completed
            exec_s = self.stats.exec_seconds
        avg = (exec_s / completed) if completed else 0.05
        backlog = self._q.qsize() + len(self._inflight)
        return round(max(backlog * avg / max(self.concurrency, 1), 0.05), 3)

    def register_tenant(self, name: str, weight: int = 1,
                        slo_p99_ms: "float | None" = None,
                        cache_fraction: "float | None" = None,
                        deadline_s: "float | None" = None):
        """Configure a tenant's QoS: fair-share ``weight``, optional SLO
        target (the ``serve.tenants`` subtree and doctor read it), an
        optional fraction of the result cache its inserts may hold, and an
        optional default request deadline (inherited by requests that set
        no ``deadline_s`` of their own)."""
        t = self.tenants.register(name, weight=weight, slo_p99_ms=slo_p99_ms,
                                  cache_fraction=cache_fraction,
                                  deadline_s=deadline_s)
        self.cache.results.set_tenant_share(name, cache_fraction)
        return t

    def _maybe_shed(self, request: ScanRequest, tenant) -> None:
        """Brownout gate: shed low-priority work at ``brownout``
        occupancy and normal-priority work halfway from there to full —
        graceful degradation instead of a cliff, with the shed caller
        handed ``retry_after_s`` and the admission snapshot."""
        if self.brownout <= 0 or request.priority >= PRIORITY_HIGH:
            return
        occ = self._occupancy()
        threshold = self.brownout
        if request.priority >= PRIORITY_NORMAL:
            threshold = self.brownout + (1.0 - self.brownout) / 2
        if occ < threshold:
            return
        hint = self._retry_after_s()
        with self.stats.lock:
            self.stats.rejected += 1
            if request.priority <= PRIORITY_LOW:
                self.stats.shed_low += 1
            else:
                self.stats.shed_normal += 1
            self.stats.retry_after_hint_s = hint
            inflight = len(self._inflight)
        with tenant.lock:
            tenant.rejected += 1
            if request.priority <= PRIORITY_LOW:
                tenant.shed_low += 1
            else:
                tenant.shed_normal += 1
        band = "low" if request.priority <= PRIORITY_LOW else "normal"
        raise OverloadError(
            f"scan service browning out ({occ:.0%} occupancy >= "
            f"{threshold:.0%}): shedding {band}-priority work of tenant "
            f"{tenant.name!r}",
            queue_depth=self._q.qsize(), in_flight=inflight,
            retry_after_s=hint, shed_priority=request.priority)

    def submit(self, request: ScanRequest) -> ScanTicket:
        """Admit one request; raises :class:`OverloadError` IMMEDIATELY
        when the queue is full (load shedding, never a blocked caller) or
        when brownout sheds this priority band (``retry_after_s`` set).
        The returned ticket's ``cancel()`` and the request's
        ``deadline_s`` both flow into every downstream read.

        A ``stream=True`` request's ticket resolves to a
        :class:`~tpu_parquet_torch.serve.StreamingScan` session the moment a
        worker picks it up; a resume ``cursor`` is validated HERE,
        synchronously, so a mismatched blob fails the caller typed and
        immediately rather than mid-stream."""
        if request.device:
            # no card: refused here, typed, never decoded on the CPU
            _resolve_device(self.device, "ScanService")
        tenant = self.tenants.get(request.tenant)
        # an explicit request deadline always wins; otherwise the tenant's
        # registered default applies (None -> no deadline, as before)
        deadline = (request.deadline_s if request.deadline_s is not None
                    else tenant.deadline_s)
        ticket = ScanTicket(next(_req_ids),
                            CancelToken.with_timeout(deadline))
        if self.sampler.enabled:
            # the trace rides the cancel token into every downstream layer
            # (readers, prefetch pipeline, iostore, device dispatch); the
            # zero-length "submit" span carries the request's identity
            trace = RequestTrace()
            t_sub = time.perf_counter()
            trace.add_timed("submit", t_sub, t_sub, request=ticket.id,
                            tenant=tenant.name, paths=len(request.paths),
                            stream=bool(request.stream),
                            device=bool(request.device),
                            priority=int(request.priority))
            ticket.token.trace = trace
        self._maybe_shed(request, tenant)
        session = None
        if request.stream:
            state = None
            if request.cursor is not None:
                state = unpack_cursor(request.cursor)
                check_cursor_compatible(state, {
                    "batch_rows": int(request.batch_rows),
                    "device": bool(request.device),
                    "n_paths": len(request.paths),
                    "request_digest": request_digest(request),
                })
            session = StreamingScan(self, request, ticket, tenant,
                                    resume_state=state)
            with self._inflight_lock:
                self._streams[ticket.id] = session
        try:
            with self._submit_lock:
                if self._closed:
                    raise RuntimeError("ScanService is closed")
                self._q.put_nowait(
                    tenant.name, tenant.weight,
                    (ticket, request, time.perf_counter(), session))
        except queue.Full:
            if session is not None:
                with self._inflight_lock:
                    self._streams.pop(ticket.id, None)
            hint = self._retry_after_s()
            with self.stats.lock:
                self.stats.rejected += 1
                self.stats.retry_after_hint_s = hint
                inflight = len(self._inflight)
            with tenant.lock:
                tenant.rejected += 1
            raise OverloadError(
                f"scan service overloaded: queue full "
                f"({self._q.maxsize} queued, {inflight} in flight; "
                f"tenant {tenant.name!r})",
                queue_depth=self._q.maxsize, in_flight=inflight,
                retry_after_s=hint) from None
        except BaseException:
            if session is not None:  # closed-service raise: no stale entry
                with self._inflight_lock:
                    self._streams.pop(ticket.id, None)
            raise
        with self.stats.lock:
            self.stats.submitted += 1
            if session is not None:
                self.stats.stream_sessions += 1
            self.stats.queue_depth_peak = max(self.stats.queue_depth_peak,
                                              self._q.qsize())
        with tenant.lock:
            tenant.submitted += 1
        return ticket

    def scan(self, request: ScanRequest, timeout: "float | None" = None):
        """Submit + wait: the one-call form."""
        return self.submit(request).result(timeout)

    # -- workers ---------------------------------------------------------------

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            # one call per request: its response and error leave with the
            # call's frame, not at the next request's pickup
            self._serve_one(item)
            del item

    def _serve_one(self, item) -> None:
        ticket, request, t_submit, session = item
        tenant = self.tenants.get(request.tenant)
        t_start = time.perf_counter()
        wait = t_start - t_submit
        ticket.queue_wait_s = wait
        self._hist_wait.record(wait)
        trace = getattr(ticket.token, "trace", None)
        prev_trace = None
        if trace is not None:
            trace.add_timed("queue_wait", t_submit, t_start)
            # install as this worker thread's request trace: cache
            # probes and device dispatch deep in the call tree find it
            # without a token in hand
            prev_trace = set_request_trace(trace)
        first = request.paths[0] if request.paths else None
        with self._inflight_lock:
            self._inflight[ticket.id] = (str(first), t_start)
        rows = 0
        yielded = False
        try:
            # a request that expired (or was cancelled) while queued
            # fails HERE, typed, before any byte is charged or read
            ticket.token.check()
            if session is not None:
                # the session IS the response: the caller's result()
                # unblocks with it now, batches flow as they decode.
                # Under stream-aware fair scheduling the session hands
                # this slot back between batches whenever another
                # tenant has queued work; otherwise it occupies the
                # slot until it drains, errors, or is cancelled.
                if not ticket.done():
                    ticket._finish(result=session)
                ycheck = None
                if self._stream_yield and tenant is not None:
                    tname = tenant.name
                    ycheck = (lambda _t=tname:
                              self._q.has_other_waiters(_t))
                finished = session._produce(yield_check=ycheck)
                if not finished and self._closed:
                    # closed while mid-yield: requeueing would strand
                    # the session behind the shutdown sentinels
                    exc0 = CancelledError(
                        "scan service closed; streaming session "
                        "terminated")
                    session._abort(exc0)
                    raise exc0
                yielded = not finished
                rows = session.rows_emitted
                result, exc = session, None
            else:
                result, exc = self._execute(request, ticket.token), None
                rows = _count_rows(result)
        except BaseException as e:  # noqa: BLE001 — delivered to caller
            result, exc = None, e
            yielded = False
            if isinstance(e, _ABORT_VERDICTS):
                from ..device_reader import _drop_scan_frames

                _drop_scan_frames(e)
            # a continuation leg's ticket already resolved to the
            # session — its failure must reach the consumer through
            # the session buffer (first verdict wins; idempotent)
            if session is not None and ticket.done():
                session._fail(e)
        if yielded:
            # mid-stream slot yield: book this leg's seconds, hand the
            # slot back, requeue the session as a fresh arrival (DRR
            # charges the tenant's deficit again — batch-granular
            # fairness).  No completion bookkeeping: the stream is
            # still live and a later leg finishes it.
            t_end = time.perf_counter()
            if trace is not None:
                set_request_trace(prev_trace)
            with self._inflight_lock:
                self._inflight.pop(ticket.id, None)
            with self.stats.lock:
                self.stats.queue_wait_seconds += wait
                self.stats.exec_seconds += t_end - t_start
                self.stats.stream_yields += 1
            with tenant.lock:
                tenant.queue_wait_seconds += wait
                tenant.exec_seconds += t_end - t_start
            self._q.requeue(tenant.name, tenant.weight,
                            (ticket, request, time.perf_counter(),
                             session))
            return
        # ALL bookkeeping lands before _finish sets the ticket's event:
        # a caller waking from result() must read final exec_s/stats,
        # never a zero the worker hadn't written yet
        t_end = time.perf_counter()
        ticket.exec_s = t_end - t_start
        retained = False
        if trace is not None:
            set_request_trace(prev_trace)
            if exc is not None:
                trace.mark_error(exc)
                if isinstance(exc, DeadlineExceededError):
                    trace.set_flag("deadline")
                elif isinstance(exc, CancelledError):
                    trace.set_flag("cancelled")
                elif isinstance(exc, OverloadError):
                    trace.set_flag("shed")
            trace.finish()
            retained = self.sampler.offer(trace,
                                          duration_s=t_end - t_submit,
                                          error=exc is not None)
        # exemplars only name RETAINED traces — a percentile's example
        # must be fetchable back via `pq_tool trace --request`
        ex = trace.trace_id if retained else None
        self._hist_exec.record(ticket.exec_s, exemplar=ex)
        self._hist_total.record(t_end - t_submit, exemplar=ex)
        if tenant is not None:
            tenant.hist.record(t_end - t_submit, exemplar=ex)
        with self._inflight_lock:
            self._inflight.pop(ticket.id, None)
            self._streams.pop(ticket.id, None)
        with self.stats.lock:
            self.stats.queue_wait_seconds += wait
            self.stats.exec_seconds += ticket.exec_s
            if exc is not None:
                self.stats.failed += 1
                if isinstance(exc, DeadlineExceededError):
                    self.stats.deadline_exceeded += 1
                elif isinstance(exc, CancelledError):
                    self.stats.cancelled += 1
            else:
                self.stats.completed += 1
                self.stats.rows += rows
        with tenant.lock:
            tenant.queue_wait_seconds += wait
            tenant.exec_seconds += ticket.exec_s
            if retained:
                tenant.traces_retained += 1
            if exc is not None:
                tenant.failed += 1
            else:
                tenant.completed += 1
                tenant.rows += rows
        # a streaming ticket already resolved to its session; its
        # producer's failure was delivered through the session buffer
        if not ticket.done():
            if exc is not None:
                ticket._finish(exc=exc)
            else:
                ticket._finish(result=result)

    def _fold_io(self, store) -> None:
        """Bank a closing store's IOStats into the service aggregate (the
        registry io section's durable half) and drop it from the live
        view so obs_registry never double-counts it."""
        from ..obs import _merge_num_tree

        d = store.stats.as_dict()
        self._served_stores.discard(store)
        with self._io_agg_lock:
            _merge_num_tree(self._io_agg, d)

    def _charge_stream(self, tenant, nbytes: int, token) -> tuple:
        """Charge ``nbytes`` against the tenant's budget SLICE first, then
        the global budget (each clamped to its own cap, mirroring the
        one-shot path's oversized-item rule).  Tenant-first ordering is
        the fairness property: a tenant over its slice blocks HERE, on
        its own budget, without ever holding global bytes a neighbor
        needs.  Returns the (tenant, global) charges for release."""
        tc = gc = 0
        tb = tenant.budget if tenant is not None else None
        if tb is not None and tb.max_bytes > 0:
            tc = min(int(nbytes), tb.max_bytes)
            if tc:
                tb.acquire(tc, cancel=token)
        if self._budget.max_bytes > 0:
            gc = min(int(nbytes), self._budget.max_bytes)
            if gc:
                try:
                    self._budget.acquire(gc, cancel=token)
                except BaseException:
                    if tc:
                        tb.release(tc)
                    raise
        return (tc, gc)

    def _release_stream(self, tenant, charges: tuple) -> None:
        tc, gc = charges
        if gc:
            self._budget.release(gc)
        if tc and tenant is not None:
            tenant.budget.release(tc)

    def _resolve_filter(self, request: ScanRequest):
        flt = request.filter
        if isinstance(flt, str):
            from ..predicate import parse_filter

            return parse_filter(flt)
        return flt

    def _execute(self, request: ScanRequest,
                 token: "CancelToken | None" = None) -> dict:
        """Run one request over the shared cache: per file, gate on the
        file's circuit breaker, read the footer/plan through the cache,
        charge the plan's byte estimate against the admission budget, then
        scan with a plan-replaying reader carrying the request's cancel
        token.  Returns ``{path: {column: ColumnData}}`` in request order.

        Classified failures (transport exhaustion, malformed data, wedges)
        are noted against the file's breaker so a persistently-failing
        file fast-fails future requests; deadline/cancel verdicts are NOT
        — an impatient caller never opens a healthy file's circuit."""
        from ..reader import FileReader

        pred = self._resolve_filter(request)
        tenant = self.tenants.get(request.tenant)
        trace = getattr(token, "trace", None) if token is not None else None
        out: dict = {}
        for path in request.paths:
            if token is not None:
                token.check()  # file boundary: stop before the next file
            key = self.cache.file_key(path)
            bkey = key if key is not None else ("path", str(path))
            self.breakers.admit(bkey, str(path))
            try:
                meta, schema = self.cache.footer(path)
                plan = self.cache.plan(key, request.columns, pred,
                                       meta=meta, schema=schema)
                vcrc = (request.validate_crc
                        if request.validate_crc is not None
                        else self._validate_crc)
                # the decoded-result tier (serve/result_cache.py), bound
                # through the ONE gate PlanCache.bind_results encodes
                # signed with the resolved device: a bare True would name
                # the default CUDA device, and a reader on another device
                # drops the adapter (a silent miss on every warm request)
                rcache = self.cache.bind_results(
                    key, plan, row_filter=pred,
                    device=self.device if request.device else False,
                    validate_crc=vcrc, tenant=tenant.name)
                with _span(trace, "cache_probe", path=str(path)):
                    served = (self._serve_from_cache(rcache, plan, request,
                                                     token, tenant)
                              if rcache is not None else None)
                    if trace is not None:
                        trace.annotate(hit=served is not None)
                if served is not None:
                    # pure cache hit: no reader, no store, no device
                    # dispatch — the file's breaker still notes the success
                    out[str(path)] = served
                    self.breakers.note(bkey, str(path), ok=True)
                    continue
                # admission wait: the budget acquire is where a request
                # blocks behind its tenant's slice or the global pool
                with _span(trace, "admission",
                           estimated_bytes=plan.estimated_bytes()):
                    charges = self._charge_stream(
                        tenant, plan.estimated_bytes(), token)
                try:
                    kw = dict(columns=request.columns, metadata=meta,
                              row_filter=pred, prefetch=request.prefetch,
                              validate_crc=vcrc,
                              store=self._store, plan=plan,
                              dict_cache=BoundDictCache(self.cache, key),
                              result_cache=rcache,
                              cancel=token)
                    with _span(trace, "read", path=str(path),
                               device=request.device):
                        if request.device:
                            from ..device_reader import DeviceFileReader

                            with DeviceFileReader(path, device=self.device,
                                                  hang_s=self._hang_s,
                                                  **kw) as r:
                                cols: dict = {}
                                for group in r.iter_row_groups():
                                    for name, cd in group.items():
                                        cols.setdefault(name,
                                                        []).append(cd)
                                out[str(path)] = {
                                    name: (parts[0] if len(parts) == 1
                                           else parts)
                                    for name, parts in cols.items()}
                        else:
                            with FileReader(path, **kw) as r:
                                out[str(path)] = self._read_watched(r)
                finally:
                    self._release_stream(tenant, charges)
            except _CLASSIFIED_FAILURES:
                self.breakers.note(bkey, str(path), ok=False)
                raise
            self.breakers.note(bkey, str(path), ok=True)
        return out

    def _serve_from_cache(self, rcache, plan, request: ScanRequest,
                          token, tenant=None) -> "dict | None":
        """The result-cache hit path: when EVERY (surviving row group,
        selected column) unit of the plan is cached under this request's
        decode signature, assemble the response straight from the cache —
        zero ``ByteStore`` reads, zero device dispatches, no reader at all.

        Admission accounting: the hit path charges
        the ACTUAL cached decoded size against the shared budget, not the
        plan's full-decode estimate — hot traffic must not queue behind a
        phantom charge for work it will never do.  Returns None on any
        missing unit (the reader path decodes and populates)."""
        ordinals = plan.selected_ordinals()
        columns = plan.columns
        if not ordinals or not columns:
            return None
        # response dict order must match the reader path's (footer chunk
        # order — plan.columns is SORTED): a consumer must never see the
        # same request's columns transposed by cache temperature
        rgp = next((r for r in plan.row_groups if r.ordinal == ordinals[0]),
                   None)
        ordered = ([cp.column for cp in rgp.chunks] if rgp is not None
                   else list(columns))
        if set(ordered) != set(columns):
            ordered = list(columns)
        columns = ordered
        units = [rcache._full(rg, c) for rg in ordinals for c in columns]
        got = rcache.cache.lookup_units(units)
        if got is None:
            return None
        total = sum(n for _v, n in got)
        charges = self._charge_stream(tenant, total, token)
        try:
            per_col: dict = {}
            vals = iter(got)
            for _rg in ordinals:
                for c in columns:
                    per_col.setdefault(c, []).append(next(vals)[0])
            if request.device:
                return {c: parts[0] if len(parts) == 1 else parts
                        for c, parts in per_col.items()}
            from ..reader import _concat_column_data

            return {c: (parts[0] if len(parts) == 1
                        else _concat_column_data(parts))
                    for c, parts in per_col.items()}
        finally:
            self._release_stream(tenant, charges)

    def _read_watched(self, r) -> dict:
        """``read_all`` under a per-request watchdog: a stalled store fetch
        (the transport wedge) dumps flight state and aborts THIS request
        with HangError while every other worker keeps serving.  Mirrors
        DeviceFileReader's own watchdog wiring — the host FileReader has
        none of its own."""
        from ..obs import Watchdog

        wd = Watchdog(resolve_hang_s(self._hang_s))
        if not wd.enabled or r._store.stats is None:
            # a plain local store cannot stall (os.pread either returns or
            # errors), and its counters don't tick on the sequential path —
            # arming the dog there would misread a long clean read as a
            # wedge.  Stall containment is for instrumented range stores.
            return r.read_all()
        wd.watch("pipeline", lambda: r._pipe_stats.sample())
        wd.watch("iostore", r._store.stats.progress)
        wd.add_abort_hook(r._store.abort)
        # ALSO poison the request's own cancel token: on a SHARED store a
        # neighbor's begin_scan legitimately clears the store-wide abort,
        # but this request's unit boundaries must still observe the wedge
        # verdict and stop
        if r._cancel is not None:
            wd.add_abort_hook(r._cancel.cancel)
        wd.start()
        try:
            out = r.read_all()
            wd.check()  # surface a fired raise-policy HangError
            return out
        finally:
            wd.stop()

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> None:
        """Drain-free shutdown: queued-but-unstarted requests fail with
        OverloadError; executing one-shot requests finish; LIVE streaming
        sessions are aborted — their producers stop at the next batch
        boundary, buffered batches release their budget bytes, and a
        consumer blocked in ``next()`` raises the terminal
        :class:`~tpu_parquet_torch.errors.CancelledError` promptly (no worker
        thread leaks behind an abandoned session)."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
        for item in self._q.drain():
            ticket, _req, _t, session = item
            with self.stats.lock:
                # accounted as rejections so the serve section always
                # reconciles: submitted == completed + failed + rejected
                self.stats.rejected += 1
            exc = OverloadError(
                "scan service closed before this request started")
            if session is not None:
                with self._inflight_lock:
                    self._streams.pop(ticket.id, None)
                session._abort(exc)
            # a yielded streaming continuation's ticket already resolved
            # to its session — the abort above delivered the verdict; a
            # re-finish would clobber the caller's result
            if not ticket.done():
                ticket._finish(exc=exc)
        with self._inflight_lock:
            live = list(self._streams.values())
        for session in live:
            session._abort(CancelledError(
                "scan service closed; streaming session terminated"))
        for _ in self._workers:
            self._q.put_sentinel()
        for t in self._workers:
            t.join(timeout=60)
        self._dumper.stop()
        self._spool.stop()

    def __enter__(self) -> "ScanService":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- reporting -------------------------------------------------------------

    def get_trace(self, trace_id: str) -> "dict | None":
        """A retained trace tree by id (exemplar trace ids resolve here —
        the ``pq_tool trace --request`` backend)."""
        return self.sampler.get(trace_id)

    def trace_dump(self, path: str) -> str:
        """Write every retained trace tree to ``path`` (the versioned
        dump ``pq_tool trace --request`` reads offline)."""
        return self.sampler.dump(path)

    def sample(self) -> dict:
        """Live admission state (flight dumps + obs.Sampler track): queue
        depth, in-flight requests with ages, and the cache counters."""
        now = time.perf_counter()
        with self._inflight_lock:
            inflight = {str(rid): {"path": p, "age_s": round(now - t0, 6)}
                        for rid, (p, t0) in self._inflight.items()}
        oldest = max((v["age_s"] for v in inflight.values()), default=0.0)
        return {
            "queue_depth": self._q.qsize(),
            "in_flight": len(inflight),
            "oldest_request_s": oldest,
            "occupancy": round(self._occupancy(), 4),
            "brownout": self.brownout,
            "fair": self._q.fair,
            "tenant_queues": self._q.tenant_depths(),
            "streams": len(self._streams),
            "requests": inflight,
            "cache": self.cache.counters(),
            "result_cache": self.cache.results.counters(),
            # open circuits by file, oldest first — the autopsy/doctor
            # `circuit-open` evidence rides every flight dump
            "circuit_open": self.breakers.open_files(),
        }

    def serve_stats(self) -> dict:
        """The registry ``serve`` section: counters + cache counters +
        circuit-breaker transitions + the per-tenant ``tenants`` subtree
        (weights, lifecycle flows, shed counters, budget slices, and each
        tenant's resident result-cache bytes)."""
        tenants = {}
        for name, t in self.tenants.tenants().items():
            d = t.as_dict()
            d["cache_held_bytes"] = self.cache.results.tenant_bytes(name)
            tenants[name] = d
        return {**self.stats.as_dict(), "cache": self.cache.counters(),
                "circuit": self.breakers.counters(), "tenants": tenants,
                "trace": self.sampler.counters()}

    def obs_registry(self):
        """Unified metrics tree: the ``serve`` section, the request
        latency histograms (``serve.queue_wait`` / ``serve.exec`` /
        ``serve.request`` — the p50/p95/p99 SLO surface), and the ``io``
        section folded from every store this service's requests read
        through (retries, hedges issued/won/wasted — the hedge
        effectiveness evidence doctor reads)."""
        from ..obs import StatsRegistry

        reg = StatsRegistry()
        reg.add_serve(self.serve_stats())
        # the tiered decoded-result cache's own section (per-tier hit/miss/
        # eviction/invalidation flows + byte gauges + single-flight waits)
        reg.add_cache(self.cache.results.counters())
        reg.histogram("serve.queue_wait").merge_from(self._hist_wait)
        reg.histogram("serve.exec").merge_from(self._hist_exec)
        reg.histogram("serve.request").merge_from(self._hist_total)
        # per-tenant end-to-end latency (the fairness SLO surface the
        # noisy-neighbor bench and `pq_tool serve-stats` read)
        for name, t in self.tenants.tenants().items():
            if t.hist.count:
                reg.histogram(f"serve.tenant.{name}").merge_from(t.hist)
        with self._io_agg_lock:
            if self._io_agg:
                reg.add_io(dict(self._io_agg))
        for st in list(self._served_stores):
            if st.stats is not None:
                reg.add_io(st.stats)
        # async fetch-engine counters (in-flight gauge, queue-wait) for
        # requests whose stores routed through the shared engine
        from ..iostore_async import fold_engine_stats
        fold_engine_stats(reg)
        return reg
