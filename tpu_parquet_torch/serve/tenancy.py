"""Multi-tenant fair-share QoS for the serve tier.

The counterpart of ``tpu_parquet.serve.tenancy``; no device code.  One
ScanService carrying many tenants through a single FIFO queue has a
textbook failure mode: a noisy neighbor floods the queue and every other
tenant's latency becomes the flood's drain time.  Brownout sheds *load*,
but blindly: it cannot say "tenant A is the problem, keep serving tenant
B".  This module adds the per-tenant half:

- :class:`Tenant`: one tenant's identity, weight, counters, latency
  histogram, SLO target, and a *slice* of the service's in-flight memory
  budget (its own :class:`~tpu_parquet_torch.alloc.InFlightBudget`, sized
  from its weight share, so one tenant's giant scans backpressure that
  tenant, not the fleet).
- :class:`TenantRegistry`: the tenant table (``TPQ_SERVE_TENANTS``
  preconfigures ``name=weight`` pairs, or names a shared JSON file with
  ``@path``; unknown tenants auto-register at weight 1), budget-slice
  rebalancing, and the ``serve.tenants`` registry subtree.
- :class:`FairScheduler`: the admission queue, per-tenant sub-queues
  drained by deficit round-robin (quantum = weight, unit item cost), so a
  tenant with weight *w* gets *w* dequeues per cycle however deep any
  neighbor's backlog runs.  ``TPQ_SERVE_FAIR=0`` (or ``fair=False``)
  degrades it to global FIFO, the A/B the noisy-neighbor measurement
  compares.

The scheduler keeps ScanService's admission contract: one global
``maxsize`` bound, ``put_nowait`` raising ``queue.Full`` at the door,
blocking ``get`` for workers, and ``None`` shutdown sentinels that always
outrank queued work.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from collections import OrderedDict, deque

from ..alloc import InFlightBudget
from ..obs import LatencyHistogram, warn_env_once

__all__ = ["DEFAULT_TENANT", "FairScheduler", "Tenant", "TenantRegistry",
           "fair_enabled", "load_tenant_file", "parse_tenant_spec",
           "tenant_table"]

# requests that name no tenant all land here — single-tenant deployments
# never see tenancy at all (one queue, the whole budget, weight 1)
DEFAULT_TENANT = "default"


def fair_enabled(flag: "bool | None" = None) -> bool:
    """Resolve the fair-share switch: an explicit constructor flag wins,
    else ``TPQ_SERVE_FAIR`` (default ON — FIFO is the degraded A/B mode,
    not the product)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("TPQ_SERVE_FAIR", "1") != "0"


def load_tenant_file(path: str) -> "dict[str, dict]":
    """Parse a shared tenants.json (the ``TPQ_SERVE_TENANTS=@/path`` form
    — one tenant table every process in a fleet loads): ``{"name":
    weight_int | {"weight": w, "deadline_s": d, "slo_p99_ms": s}}``.
    Returns ``{name: {"weight", "deadline_s", "slo_p99_ms"}}``.  A
    missing/unreadable/malformed file degrades to an empty table via one
    :func:`warn_env_once` line, never raises — a bad shared config must
    not take a fleet member down."""
    try:
        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError("tenant table must be a JSON object")
    except (OSError, ValueError) as e:
        warn_env_once("TPQ_SERVE_TENANTS", f"@{path} ({e})", None)
        return {}
    out: "dict[str, dict]" = {}
    for name, cfg in raw.items():
        name = str(name).strip()
        if not name:
            continue
        if isinstance(cfg, bool):
            continue
        if isinstance(cfg, (int, float)):
            cfg = {"weight": cfg}
        if not isinstance(cfg, dict):
            continue  # a malformed entry, not a malformed table

        def fnum(key, lo=None, _cfg=cfg):
            v = _cfg.get(key)
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                return None
            v = float(v)
            return v if (lo is None or v > lo) else None

        w = fnum("weight", lo=0)
        out[name] = {
            "weight": max(int(w), 1) if w is not None else 1,
            "deadline_s": fnum("deadline_s", lo=0),
            "slo_p99_ms": fnum("slo_p99_ms", lo=0),
        }
    return out


def tenant_table(spec: "str | None") -> "dict[str, dict]":
    """Resolve a ``TPQ_SERVE_TENANTS`` value — inline ``name=weight:
    deadline_s`` pairs or the ``@/path/to/tenants.json`` shared-file form
    — to ``{name: {"weight", "deadline_s", "slo_p99_ms"}}``."""
    if not spec:
        return {}
    spec = str(spec).strip()
    if spec.startswith("@"):
        return load_tenant_file(spec[1:])
    return {name: {"weight": w, "deadline_s": d, "slo_p99_ms": None}
            for name, (w, d) in _parse_inline_spec(spec).items()}


def parse_tenant_spec(spec: "str | None") -> "dict[str, tuple]":
    """Parse ``TPQ_SERVE_TENANTS``: ``"name=weight:deadline_s,..."``
    (weight optional, defaults 1, floored at 1; ``:deadline_s`` optional —
    a per-tenant default request deadline in seconds) or
    ``@/path/to/tenants.json`` (see :func:`load_tenant_file`).  Returns
    ``{name: (weight, deadline_s_or_None)}``.  Malformed entries are
    ignored rather than raised — a bad env var must not take the serve
    tier down at import time."""
    return {name: (cfg["weight"], cfg["deadline_s"])
            for name, cfg in tenant_table(spec).items()}


def _parse_inline_spec(spec: str) -> "dict[str, tuple]":
    out: "dict[str, tuple]" = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        name, _, w = part.partition("=")
        name = name.strip()
        if not name:
            continue
        w, _, d = w.partition(":")
        try:
            weight = max(int(w), 1) if w.strip() else 1
        except ValueError:
            weight = 1
        try:
            deadline = float(d) if d.strip() else None
            if deadline is not None and deadline <= 0:
                deadline = None
        except ValueError:
            deadline = None
        out[name] = (weight, deadline)
    return out


class Tenant:
    """One tenant's QoS state.  Counters mirror :class:`ServeStats`'s
    lifecycle contract (``submitted`` counts admitted work only; sheds and
    queue-full rejections land in ``rejected``/``shed_*``) so the
    per-tenant subtree reconciles the same way the global section does."""

    __slots__ = ("name", "weight", "slo_p99_ms", "budget", "hist", "lock",
                 "submitted", "completed", "rejected", "failed",
                 "shed_low", "shed_normal", "queue_wait_seconds",
                 "exec_seconds", "rows", "stream_batches",
                 "cache_fraction", "deadline_s", "traces_retained")

    def __init__(self, name: str, weight: int = 1,
                 slo_p99_ms: "float | None" = None,
                 cache_fraction: "float | None" = None,
                 deadline_s: "float | None" = None):
        self.name = str(name)
        self.weight = max(int(weight), 1)
        self.slo_p99_ms = None if slo_p99_ms is None else float(slo_p99_ms)
        # default request deadline: requests that name no deadline_s of
        # their own inherit this (an explicit request value always wins)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        # this tenant's slice of the service budget; max_bytes is set by
        # TenantRegistry._rebalance (0 until the service sizes it)
        self.budget = InFlightBudget(0)
        self.hist = LatencyHistogram()
        self.lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.rejected = 0
        self.failed = 0
        self.shed_low = 0
        self.shed_normal = 0
        self.queue_wait_seconds = 0.0
        self.exec_seconds = 0.0
        self.rows = 0
        self.stream_batches = 0
        # requests whose trace the tail sampler kept (the per-tenant half
        # of the exemplar story: how many of MY requests are inspectable)
        self.traces_retained = 0
        self.cache_fraction = cache_fraction

    def as_dict(self) -> dict:
        """This tenant's ``serve.tenants.<name>`` subtree: flows compose by
        addition across registries; ``weight``/``slo_p99_ms``/
        ``budget_bytes`` are gauges (obs merges max them)."""
        with self.lock:
            out = {
                "weight": self.weight,
                "submitted": self.submitted,
                "completed": self.completed,
                "rejected": self.rejected,
                "failed": self.failed,
                # same nested shape as the serve section's own sheds
                # counter, so readers (CLI table, doctor) share one path
                "sheds": {"low": self.shed_low, "normal": self.shed_normal},
                "queue_wait_seconds": round(self.queue_wait_seconds, 6),
                "exec_seconds": round(self.exec_seconds, 6),
                "rows": self.rows,
                "stream_batches": self.stream_batches,
                "traces_retained": self.traces_retained,
                "budget_bytes": self.budget.max_bytes,
            }
            if self.slo_p99_ms is not None:
                out["slo_p99_ms"] = self.slo_p99_ms
            if self.deadline_s is not None:
                out["deadline_s"] = self.deadline_s
            return out


class TenantRegistry:
    """The tenant table + budget-slice arithmetic.

    ``max_memory`` is the service's whole in-flight budget; each tenant's
    slice is ``max_memory * weight / total_weight`` (or an explicit
    ``budget_fraction``), recomputed whenever the table changes — so the
    slices always partition the same bytes the global budget bounds, and
    a tenant's worst case is its fair share, not the whole pool."""

    def __init__(self, max_memory: int = 0, spec: "str | None" = None):
        self.max_memory = int(max_memory)
        self._lock = threading.Lock()
        self._tenants: "dict[str, Tenant]" = {}
        if spec is None:
            spec = os.environ.get("TPQ_SERVE_TENANTS")
        for name, cfg in tenant_table(spec).items():
            self._tenants[name] = Tenant(name, weight=cfg["weight"],
                                         deadline_s=cfg["deadline_s"],
                                         slo_p99_ms=cfg["slo_p99_ms"])
        if DEFAULT_TENANT not in self._tenants:
            self._tenants[DEFAULT_TENANT] = Tenant(DEFAULT_TENANT)
        self._rebalance_locked()

    @classmethod
    def from_file(cls, path: str, max_memory: int = 0) -> "TenantRegistry":
        """The fleet form: every process loads ONE shared tenants.json
        (equivalent to ``spec="@"+path``; malformed degrades to the
        default table, never raises)."""
        return cls(max_memory=max_memory, spec=f"@{path}")

    def _rebalance_locked(self) -> None:
        total = sum(t.weight for t in self._tenants.values()) or 1
        for t in self._tenants.values():
            t.budget.max_bytes = (
                int(self.max_memory * t.weight / total)
                if self.max_memory > 0 else 0)

    def set_max_memory(self, max_memory: int) -> None:
        with self._lock:
            self.max_memory = int(max_memory)
            self._rebalance_locked()

    def register(self, name: str, weight: int = 1,
                 slo_p99_ms: "float | None" = None,
                 cache_fraction: "float | None" = None,
                 deadline_s: "float | None" = None) -> Tenant:
        """Add or reconfigure a tenant; slices rebalance immediately."""
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(
                    name, weight=weight, slo_p99_ms=slo_p99_ms,
                    cache_fraction=cache_fraction, deadline_s=deadline_s)
            else:
                t.weight = max(int(weight), 1)
                if slo_p99_ms is not None:
                    t.slo_p99_ms = float(slo_p99_ms)
                if cache_fraction is not None:
                    t.cache_fraction = float(cache_fraction)
                if deadline_s is not None:
                    t.deadline_s = float(deadline_s)
            self._rebalance_locked()
            return t

    def get(self, name: "str | None") -> Tenant:
        """Resolve (auto-registering at weight 1) — an unknown tenant is a
        new light user, not an error."""
        name = DEFAULT_TENANT if not name else str(name)
        with self._lock:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = Tenant(name)
                self._rebalance_locked()
            return t

    def tenants(self) -> "dict[str, Tenant]":
        with self._lock:
            return dict(self._tenants)

    def as_dict(self) -> dict:
        return {name: t.as_dict() for name, t in self.tenants().items()}


class _Empty:
    """Internal marker: no item currently dequeueable (distinct from the
    ``None`` shutdown sentinel, which IS a legal return of ``get``)."""


_EMPTY = _Empty()


class FairScheduler:
    """Bounded multi-tenant admission queue with deficit-round-robin
    dequeue (``fair=True``) or global FIFO (``fair=False``).

    DRR with unit item cost: the cursor visits tenant queues cyclically;
    arriving at a tenant whose deficit is spent refills it by the
    tenant's weight, then serves one item per dequeue while deficit
    remains, advancing only when the quantum is spent or the queue
    empties (an empty queue forfeits its deficit — credit never
    accumulates while idle, the classic DRR anti-burst rule)."""

    def __init__(self, maxsize: int, fair: bool = True):
        self.maxsize = int(maxsize)
        self.fair = bool(fair)
        self._cv = threading.Condition()
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._weights: "dict[str, int]" = {}
        self._deficit: "dict[str, float]" = {}
        self._order: "list[str]" = []
        self._cursor = 0
        self._size = 0
        self._seq = 0
        self._sentinels = 0

    def qsize(self) -> int:
        with self._cv:
            return self._size

    def tenant_depths(self) -> "dict[str, int]":
        with self._cv:
            return {t: len(q) for t, q in self._queues.items() if q}

    def put_nowait(self, tenant: str, weight: int, item) -> None:
        """Enqueue under the GLOBAL bound; ``queue.Full`` when it's hit —
        the fast-reject contract is unchanged, fairness only reorders
        what was admitted."""
        with self._cv:
            if self._size >= self.maxsize:
                raise queue.Full
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._order.append(tenant)
                self._deficit[tenant] = 0.0
            self._weights[tenant] = max(int(weight), 1)
            self._seq += 1
            q.append((self._seq, item))
            self._size += 1
            self._cv.notify()

    def requeue(self, tenant: str, weight: int, item) -> None:
        """Re-enqueue ALREADY-ADMITTED work (a streaming session yielding
        its worker slot between batches).  Exempt from the ``maxsize``
        bound — the item was admitted once and must never bounce on
        re-entry — but it takes a fresh arrival sequence, so DRR charges
        the tenant's deficit again per leg (batch-granular fairness)."""
        with self._cv:
            q = self._queues.get(tenant)
            if q is None:
                q = self._queues[tenant] = deque()
                self._order.append(tenant)
                self._deficit[tenant] = 0.0
            self._weights[tenant] = max(int(weight), 1)
            self._seq += 1
            q.append((self._seq, item))
            self._size += 1
            self._cv.notify()

    def has_other_waiters(self, tenant: str) -> bool:
        """True when any OTHER tenant has queued work — the stream-yield
        trigger (a lone tenant's stream keeps its slot; handing it back
        would only add requeue latency)."""
        with self._cv:
            return any(q for t, q in self._queues.items() if t != tenant)

    def put_sentinel(self) -> None:
        """Queue one worker-shutdown sentinel (``get`` returns ``None``).
        Sentinels outrank queued work — close() drains the queues first,
        so by the time sentinels land there is nothing left to starve."""
        with self._cv:
            self._sentinels += 1
            self._cv.notify()

    def drain(self) -> list:
        """Remove and return every queued item (close()'s reject sweep)."""
        with self._cv:
            items = []
            for q in self._queues.values():
                items.extend(it for _seq, it in q)
                q.clear()
            self._size = 0
            for t in self._deficit:
                self._deficit[t] = 0.0
            return items

    def get(self):
        """Block for the next item (or ``None`` for a shutdown sentinel)."""
        with self._cv:
            while True:
                got = self._pop_locked()
                if not isinstance(got, _Empty):
                    return got
                self._cv.wait()

    def _pop_locked(self):
        if self._sentinels:
            self._sentinels -= 1
            return None
        if not self._size:
            return _EMPTY
        if not self.fair:
            # global FIFO: strictly by arrival sequence across all tenants
            best = min((t for t, q in self._queues.items() if q),
                       key=lambda t: self._queues[t][0][0])
            _seq, item = self._queues[best].popleft()
            self._size -= 1
            return item
        n = len(self._order)
        for _ in range(2 * n):
            t = self._order[self._cursor % n]
            q = self._queues[t]
            if not q:
                self._deficit[t] = 0.0  # idle forfeits its credit
                self._cursor += 1
                continue
            if self._deficit[t] < 1.0:
                self._deficit[t] += self._weights.get(t, 1)
            if self._deficit[t] >= 1.0:
                self._deficit[t] -= 1.0
                _seq, item = q.popleft()
                self._size -= 1
                if self._deficit[t] < 1.0 or not q:
                    self._cursor += 1  # quantum spent (or queue drained)
                return item
            self._cursor += 1
        return _EMPTY  # unreachable with weights >= 1; safe fallback
