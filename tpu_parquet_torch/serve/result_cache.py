"""ResultCache: the two-tier cache of decoded results.

The counterpart of ``tpu_parquet.serve.result_cache``.  A ``PlanCache``
makes the planning side of a repeated scan nearly free; this cache holds
what every plan-cache hit still pays for, the decoded values, behind one
bounded LRU per tier:

- **host tier** (``TPQ_RESULT_CACHE_MB``): decoded column chunks (host
  ``ColumnData``) and decoded dictionary pages.  The dictionary store lives
  here: one LRU and one byte budget, not two (``PlanCache`` delegates its
  ``dict_get`` / ``dict_put`` into this cache);
- **device tier** (``TPQ_RESULT_CACHE_HBM_MB``): decoded
  ``DeviceColumnData`` resident on the card.  Its bytes are registered on
  the cache's own ``alloc.AllocTracker`` device ledger
  (``register_device`` / ``release_device``), and device-memory pressure
  evicts within the device tier only: host entries are never dropped to
  relieve the card, nor the reverse.

Keys are ``(file generation key, row group, column, decode signature)``
with ``PlanCache.file_key``'s generation semantics: a mutated file changes
its key, the stale generation is dropped eagerly (``invalidations``
counted exactly), and stale bytes are never served.  The decode signature
(:func:`decode_signature`) covers the decode shape (host arrays or device
tensors, the CRC tier, the filter fingerprint, the route knob), so two
requests share an entry exactly when their decodes are bit-identical.

Host builds are single-flight (``get_or_build``): concurrent first touches
of one chunk decode it once, late arrivals adopt the published entry
(``single_flight_waits``).  The device reader publishes at finalize, the
one point that proves the deferred checks passed.  Cached values are
shared read-only.  Both tiers are off by default; dictionaries are always
cached, bounded by the plan cache's budget when no result budget is set.

Where the port departs from the reference:

- the device half of the signature ends with the resolved device
  (:func:`device_tag`: ``"cuda"`` and ``"cuda:0"`` share entries, a CPU
  reader's never reach a CUDA reader); the first five fields are the
  reference's under ``TPQ_FUSE=1``, and the fuse field is the constant
  ``True`` (the port's planner always ranks as the reference's does then);
- :func:`device_column_nbytes` counts ``numel() * element_size()`` of each
  tensor; the device reader publishes no view of a larger buffer (it
  clones one at publish time), so the counted bytes are what the tier pins.

Observability: each cache is a flight source (``result_cache``, its
``counters()``), and a request trace gets a ``result_probe`` span per
group probe.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import torch

from ..alloc import AllocTracker
from ..obs import current_request_trace, env_int, register_flight_source

__all__ = ["BoundResultCache", "ResultCache", "ResultTierStats",
           "decode_signature", "column_nbytes", "device_column_nbytes",
           "device_tag"]

TIERS = ("host", "device")

# per-tier cap on the eviction-attribution map (a pathological key stream
# must not grow it without limit)
_EVICT_FILES_CAP = 64

# every tensor a DeviceColumnData or a DeviceDictColumn may hold
DEVICE_TENSOR_ATTRS = ("values", "offsets", "heap", "def_levels",
                       "rep_levels", "indices", "dict_u8", "dict_offsets",
                       "dict_heap")


def device_tag(device) -> str:
    """The device field of a device decode signature: ``True`` (or None)
    means the readers' default, ``cuda``; a CUDA device without an index is
    the current one, so ``"cuda"`` and ``"cuda:0"`` share entries."""
    dev = torch.device("cuda" if device is True or device is None
                       else device)
    if dev.type == "cuda" and dev.index is None:
        idx = torch.cuda.current_device() if torch.cuda.is_available() else 0
        dev = torch.device("cuda", idx)
    return str(dev)


def decode_signature(device, validate_crc=None, filter_fp=None):
    """The decode-shape half of a result key.

    Two lookups share an entry only when their decodes are bit-identical:
    the same output shape (host ``ColumnData`` or device tensors), the same
    CRC tier (a ``validate_crc=True`` request never adopts an unvalidated
    decode), and for the device shape the same filter fingerprint (page
    pruning drops row runs from device output), the same route knob
    (``TPQ_FORCE_ROUTE``) and the same device.  ``device`` is False for the
    host shape; True (the default device), a ``torch.device`` or a device
    string for the device shape."""
    from ..quarantine import resolve_validate

    crc = "v1" if resolve_validate(validate_crc) else "v0"
    if device is False or device is None:
        return ("host", crc)
    return ("dev", crc, filter_fp,
            os.environ.get("TPQ_FORCE_ROUTE") or None, True,
            device_tag(device))


def column_nbytes(cd) -> int:
    """Accounting size of a host ColumnData (values + levels)."""
    from ..column import ByteArrayData

    n = 0
    v = cd.values
    if isinstance(v, ByteArrayData):
        n += int(v.offsets.nbytes) + int(v.heap.nbytes)
    elif v is not None:
        n += int(v.nbytes)
    for attr in ("def_levels", "rep_levels"):
        a = getattr(cd, attr, None)
        if a is not None:
            n += int(a.nbytes)
    return n


def device_column_nbytes(cd) -> int:
    """Accounting size of a DeviceColumnData: every tensor it holds, the
    dictionary tables of a DeviceDictColumn included."""
    n = 0
    for attr in DEVICE_TENSOR_ATTRS:
        t = getattr(cd, attr, None)
        if t is not None:
            n += int(t.numel()) * int(t.element_size())
    return n


class ResultTierStats:
    """One tier's counters, mutated only under the owning cache's lock."""

    __slots__ = ("hits", "misses", "evictions", "invalidations", "rejected")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rejected = 0


class ResultCache:
    """Two-tier bounded LRU of decoded results.  Thread-safe; one instance
    is shared by every consumer of a ``serve.PlanCache`` (which owns one:
    ``PlanCache().results``).

    ``max_bytes`` / ``hbm_bytes`` default from ``TPQ_RESULT_CACHE_MB`` /
    ``TPQ_RESULT_CACHE_HBM_MB`` (MB; 0 disables the tier).  With the host
    knob unset the cache still serves as the decoded-dictionary store with
    no host chunk tier; ``dict_fallback_bytes`` (the plan cache's budget)
    then bounds it, so dictionaries stay under exactly one budget."""

    def __init__(self, max_bytes: "int | None" = None,
                 hbm_bytes: "int | None" = None,
                 chunks_enabled: "bool | None" = None,
                 dict_fallback_bytes: int = 0):
        if max_bytes is None:
            max_bytes = env_int("TPQ_RESULT_CACHE_MB", 0, lo=0) << 20
        if hbm_bytes is None:
            hbm_bytes = env_int("TPQ_RESULT_CACHE_HBM_MB", 0, lo=0) << 20
        if chunks_enabled is None:
            chunks_enabled = max_bytes > 0 or hbm_bytes > 0
        self.chunks_enabled = bool(chunks_enabled)
        # per-tier chunk admission: an unset host knob leaves the host tier
        # as the dictionary store alone, never a chunk cache riding the
        # fallback budget
        self._chunk_tier_ok = {"host": max_bytes > 0, "device": hbm_bytes > 0}
        # True when the host tier is the dictionary store on the plan
        # cache's budget: PlanCache then counts these bytes against its own
        # eviction limit
        self.dict_fallback_active = max_bytes <= 0 and dict_fallback_bytes > 0
        if max_bytes <= 0:
            max_bytes = int(dict_fallback_bytes)
        self._caps = {"host": int(max_bytes), "device": int(hbm_bytes)}
        # the device tier's residency ledger (device_snapshot())
        self.tracker = AllocTracker(0)
        self.stats = {t: ResultTierStats() for t in TIERS}
        self.single_flight_waits = 0
        self._lock = threading.Lock()
        # full key -> (value, nbytes, tier, tenant); recency lives in the
        # per-tier index below, so an eviction finds a same-tier victim in
        # O(1)
        self._entries: "dict[tuple, tuple]" = {}
        # tenant name -> the fraction of each tier a tenant's entries may
        # hold; a tenant over its share evicts its own oldest entries
        self._tenant_share: "dict[str, float]" = {}
        self._tenant_bytes = {t: {} for t in TIERS}
        # per-tier LRU index: full key -> None, insertion order = recency
        self._lru = {t: OrderedDict() for t in TIERS}
        self._bytes = {t: 0 for t in TIERS}
        # file identity -> current generation (the eager stale drop)
        self._gen: dict = {}
        # single-flight build locks
        self._building: dict = {}
        # keys whose built value its tier rejected: they bypass the
        # single-flight lock, or N scans of an uncachable chunk would decode
        # it N times in series.  Bounded; cleared when full.
        self._uncachable: set = set()
        # per-tier {file name: evictions}
        self._evict_files = {t: {} for t in TIERS}
        register_flight_source("result_cache", self, "counters")

    # -- keys ------------------------------------------------------------------

    @staticmethod
    def chunk_key(file_key, rg: int, column: str, sig) -> tuple:
        return ("chunk", file_key, int(rg), column, sig)

    @staticmethod
    def dict_key(file_key, rg: int, column: str, kind) -> tuple:
        return ("dict", file_key, int(rg), column, kind)

    def tier_capacity(self, tier: str) -> int:
        return self._caps[tier]

    def host_held(self) -> int:
        """Host-tier resident bytes (PlanCache's shared-budget input)."""
        with self._lock:
            return self._bytes["host"]

    def bind(self, file_key, device=False, validate_crc=None,
             filter_fp=None,
             tenant: "str | None" = None) -> "BoundResultCache | None":
        """The per-(file, decode shape) adapter the readers call, or None
        when this cache cannot serve chunk results for it (chunk tiers off,
        no file key, or no budget in the shape's tier).  ``device``: False
        for the host shape, else the device (see :func:`decode_signature`).
        ``tenant`` attributes the adapter's inserts to that tenant's byte
        share; lookups ignore shares."""
        if not self.chunks_enabled or file_key is None:
            return None
        tier = "host" if device is False or device is None else "device"
        if not self._chunk_tier_ok[tier] or self._caps[tier] <= 0:
            return None
        sig = decode_signature(device, validate_crc, filter_fp)
        return BoundResultCache(self, file_key, sig, tenant=tenant)

    def set_tenant_share(self, tenant: str, fraction: "float | None") -> None:
        """Cap ``tenant``'s resident bytes at ``fraction`` of each tier's
        capacity (None removes the cap), enforced at insert time."""
        with self._lock:
            if fraction is None:
                self._tenant_share.pop(tenant, None)
            else:
                self._tenant_share[tenant] = min(max(float(fraction), 0.0),
                                                 1.0)

    def tenant_bytes(self, tenant: str) -> int:
        """Resident bytes attributed to ``tenant`` across both tiers."""
        with self._lock:
            return sum(self._tenant_bytes[t].get(tenant, 0) for t in TIERS)

    # -- core LRU --------------------------------------------------------------

    def _remove_locked(self, full) -> "tuple | None":
        """Pop ``full`` from the value map and its tier's recency index,
        releasing its bytes (and device-ledger bytes)."""
        ent = self._entries.pop(full, None)
        if ent is None:
            return None
        _v, n, tier, tenant = ent
        self._lru[tier].pop(full, None)
        self._bytes[tier] -= n
        if tenant is not None:
            tb = self._tenant_bytes[tier]
            left = tb.get(tenant, 0) - n
            if left > 0:
                tb[tenant] = left
            else:
                tb.pop(tenant, None)
        if tier == "device":
            self.tracker.release_device(n)
        return ent

    @staticmethod
    def _file_name(full) -> str:
        fk = full[1]
        if isinstance(fk, tuple) and len(fk) >= 2:
            return str(fk[1])
        return str(fk)

    def _note_evict_locked(self, tier: str, full) -> None:
        files = self._evict_files[tier]
        name = self._file_name(full)
        if name not in files and len(files) >= _EVICT_FILES_CAP:
            return
        files[name] = files.get(name, 0) + 1

    def get(self, full: tuple):
        with self._lock:
            ent = self._entries.get(full)
            if ent is not None:
                self._lru[ent[2]].move_to_end(full)
                self.stats[ent[2]].hits += 1
                return ent[0]
            # an absent key's tier comes from its signature
            self.stats[self._tier_of_key(full)].misses += 1
            return None

    @staticmethod
    def _tier_of_key(full) -> str:
        sig = full[4] if len(full) > 4 else None
        return ("device" if isinstance(sig, tuple) and sig
                and sig[0] == "dev" else "host")

    def put(self, full: tuple, value, nbytes: int, tier: str = "host",
            tenant: "str | None" = None) -> bool:
        """Insert (shared read-only).  False when rejected: the tier is
        off, the value is bigger than the tier or than the tenant's share,
        or it belongs to a superseded generation.  The bounds hold at every
        instant, so an oversized value is simply not cached."""
        nbytes = max(int(nbytes), 1)
        with self._lock:
            cap = self._caps[tier]
            share = (self._tenant_share.get(tenant)
                     if tenant is not None else None)
            tcap = int(cap * share) if share is not None else None
            if cap <= 0 or nbytes > cap or (tcap is not None
                                            and nbytes > tcap):
                self.stats[tier].rejected += 1
                return False
            if not self._invalidate_stale_locked(full):
                # a stale publisher (a scan bound to a pre-mutation
                # generation): adopting it would wipe the fresh warm set
                self.stats[tier].rejected += 1
                return False
            self._remove_locked(full)
            lru = self._lru[tier]
            # a share-capped tenant over its slice evicts its own oldest
            # entries first
            if tcap is not None:
                tb = self._tenant_bytes[tier]
                while tb.get(tenant, 0) + nbytes > tcap:
                    victim = next((f for f in lru
                                   if self._entries[f][3] == tenant), None)
                    if victim is None:
                        break
                    self._remove_locked(victim)
                    self.stats[tier].evictions += 1
                    self._note_evict_locked(tier, victim)
            # room within this tier only
            while self._bytes[tier] + nbytes > cap and lru:
                victim = next(iter(lru))
                self._remove_locked(victim)
                self.stats[tier].evictions += 1
                self._note_evict_locked(tier, victim)
            self._entries[full] = (value, nbytes, tier, tenant)
            lru[full] = None
            self._bytes[tier] += nbytes
            if tenant is not None:
                tb = self._tenant_bytes[tier]
                tb[tenant] = tb.get(tenant, 0) + nbytes
            if tier == "device":
                self.tracker.register_device(nbytes)
            return True

    @staticmethod
    def _supersedes(new_fk, cur_fk) -> bool:
        """Does ``new_fk`` supersede the adopted generation ``cur_fk``?
        Local keys ``(kind, path, size, mtime_ns)``: a newer mtime does, an
        older one is a stale publisher, an equal mtime with another size is
        a rewrite on a coarse-mtime filesystem.  Store keys carry no order:
        the incoming generation supersedes."""
        if (new_fk[0] == "file" == cur_fk[0] and len(new_fk) >= 4
                and len(cur_fk) >= 4):
            if new_fk[3] != cur_fk[3]:
                return new_fk[3] > cur_fk[3]
        return True

    def _invalidate_stale_locked(self, full) -> bool:
        """Generation bookkeeping for an insert under ``full``: a new
        generation of a file drops every entry of the previous one (each
        counted in ``invalidations``).  False, adopting nothing, when the
        key belongs to a generation the adopted one supersedes."""
        fk = full[1]
        if not (isinstance(fk, tuple) and len(fk) >= 2):
            return True
        ident = fk[:2]
        prev = self._gen.get(ident)
        if prev is None or prev == fk:
            self._gen[ident] = fk
            return True
        if not self._supersedes(fk, prev):
            return False
        stale = [f for f in self._entries
                 if isinstance(f[1], tuple) and f[1][:2] == ident
                 and f[1] != fk]
        for f in stale:
            ent = self._remove_locked(f)
            self.stats[ent[2]].invalidations += 1
        self._gen[ident] = fk
        return True

    def note_generation(self, file_key) -> None:
        """Adopt ``file_key`` as its file's current generation, dropping
        every entry of earlier generations (PlanCache calls this when a
        footer read observes the move, so results invalidate with plans).
        A straggling older generation adopts nothing."""
        if not (isinstance(file_key, tuple) and len(file_key) >= 2):
            return
        with self._lock:
            self._invalidate_stale_locked(("gen", file_key))

    def contains_all(self, keys,
                     count_misses_tier: "str | None" = None) -> bool:
        """Membership probe for the prefetch feed's skip check.  Hits are
        not counted (prepare's probe counts them); a failed probe counts one
        miss per key into ``count_misses_tier`` when given (on the feed it
        is the only probe a cold group gets)."""
        with self._lock:
            ok = all(f in self._entries for f in keys)
            if not ok and count_misses_tier is not None:
                self.stats[count_misses_tier].misses += len(keys)
            return ok

    def get_or_build(self, full: tuple, build, tier: str = "host",
                     tenant: "str | None" = None):
        """Get or decode, single-flight: one builder per key runs (one
        counted miss); concurrent callers wait and adopt the published
        entry (hits and ``single_flight_waits``).  ``build()`` returns
        ``(value, nbytes)``; a build that raises releases its waiters to
        retry (a failed decode is never published)."""
        while True:
            with self._lock:
                ent = self._entries.get(full)
                if ent is not None:
                    self._lru[ent[2]].move_to_end(full)
                    self.stats[ent[2]].hits += 1
                    return ent[0]
                if full in self._uncachable:
                    # too big for its tier: decode in parallel
                    self.stats[tier].misses += 1
                    mine, lock = None, None
                else:
                    lock = self._building.get(full)
                    mine = lock is None
                    if mine:
                        lock = self._building[full] = threading.Lock()
                        lock.acquire()
                    else:
                        self.single_flight_waits += 1
            if mine is None:
                return build()[0]
            if mine:
                try:
                    with self._lock:
                        self.stats[tier].misses += 1
                    value, nbytes = build()
                    if not self.put(full, value, nbytes, tier,
                                    tenant=tenant):
                        # every rejection is permanent for this key: later
                        # callers decode in parallel, not in series
                        with self._lock:
                            if len(self._uncachable) >= 1024:
                                self._uncachable.clear()
                            self._uncachable.add(full)
                    return value
                finally:
                    with self._lock:
                        self._building.pop(full, None)
                    lock.release()
            else:
                with lock:
                    pass  # published (a hit next) or failed (a retry)

    def lookup_units(self, keys, count_misses: bool = False):
        """All-or-nothing probe of several keys: on success each unit's
        recency is touched and one hit counted per unit; a failed probe
        counts nothing unless ``count_misses``.  Returns ``[(value,
        nbytes), ...]`` in key order, or None."""
        with self._lock:
            out = []
            for f in keys:
                ent = self._entries.get(f)
                if ent is None:
                    if count_misses:
                        t = self._tier_of_key(f)
                        self.stats[t].misses += len(keys)
                    return None
                out.append(ent)
            for f, ent in zip(keys, out):
                self._lru[ent[2]].move_to_end(f)
                self.stats[ent[2]].hits += 1
            return [(e[0], e[1]) for e in out]

    # -- reporting -------------------------------------------------------------

    def counters(self) -> dict:
        """Per-tier flows and gauges plus the single-flight wait count.
        ``held_bytes`` / ``capacity_bytes`` / ``entries`` are gauges."""
        with self._lock:
            out: dict = {"single_flight_waits": self.single_flight_waits}
            counts = {t: len(self._lru[t]) for t in TIERS}
            knobs = {
                # in dictionary-fallback mode the host tier's budget is the
                # plan cache's
                "host": ("TPQ_PLAN_CACHE_MB" if self.dict_fallback_active
                         else "TPQ_RESULT_CACHE_MB"),
                "device": "TPQ_RESULT_CACHE_HBM_MB",
            }
            for t in TIERS:
                st = self.stats[t]
                out[t] = {
                    "hits": st.hits,
                    "misses": st.misses,
                    "evictions": st.evictions,
                    "invalidations": st.invalidations,
                    "rejected": st.rejected,
                    "held_bytes": self._bytes[t],
                    "capacity_bytes": self._caps[t],
                    "entries": counts[t],
                    "budget_knob": knobs[t],
                    "evict_files": dict(self._evict_files[t]),
                }
            return out

    sample = counters

    def progress(self) -> dict:
        """Flat monotonic counters (hit, miss and eviction flows)."""
        with self._lock:
            out = {"single_flight_waits": self.single_flight_waits}
            for t in TIERS:
                st = self.stats[t]
                out[f"{t}_hits"] = st.hits
                out[f"{t}_misses"] = st.misses
                out[f"{t}_evictions"] = st.evictions
            return out


class BoundResultCache:
    """A :class:`ResultCache` bound to one (file generation, decode
    signature): the adapter the readers call.  Units are addressed
    ``(row group, column)``; values are shared read-only."""

    __slots__ = ("cache", "key", "sig", "tier", "tenant")

    def __init__(self, cache: ResultCache, key, sig,
                 tenant: "str | None" = None):
        self.cache = cache
        self.key = key
        self.sig = sig
        self.tier = "device" if sig and sig[0] == "dev" else "host"
        self.tenant = tenant

    def _full(self, rg: int, column: str) -> tuple:
        return ResultCache.chunk_key(self.key, rg, column, self.sig)

    def get(self, rg: int, column: str):
        return self.cache.get(self._full(rg, column))

    def put(self, rg: int, column: str, value, nbytes: int) -> bool:
        return self.cache.put(self._full(rg, column), value, nbytes,
                              self.tier, tenant=self.tenant)

    def get_or_build(self, rg: int, column: str, build):
        """``build()`` returns ``(value, nbytes)``; single-flight."""
        return self.cache.get_or_build(self._full(rg, column), build,
                                       self.tier, tenant=self.tenant)

    def has_group(self, rg: int, columns,
                  count_misses: bool = False) -> bool:
        """All-columns membership check for one row group.  Hits are not
        counted; ``count_misses`` charges a failed probe's misses (set it
        where the probe is the group's only cold-path lookup)."""
        return self.cache.contains_all(
            [self._full(rg, c) for c in columns],
            count_misses_tier=self.tier if count_misses else None)

    def lookup_group(self, rg: int, columns) -> "dict | None":
        """All-or-nothing probe of one row group's columns (the device
        reader's hit path): hits counted on success, one miss per column on
        failure.  Returns ``{column: value}`` or None."""
        cols = list(columns)
        tr = current_request_trace()
        t0 = time.perf_counter() if tr is not None else 0.0
        got = self.cache.lookup_units([self._full(rg, c) for c in cols],
                                      count_misses=True)
        if tr is not None:
            tr.add_timed("result_probe", t0, time.perf_counter(), rg=rg,
                         columns=len(cols), hit=got is not None)
        if got is None:
            return None
        return {c: v for c, (v, _n) in zip(cols, got)}
