"""PlanCache: the shared read-through state of repeated scans.

The counterpart of ``tpu_parquet.serve.cache``.  Every one-shot open pays
three metadata costs before the first data byte: the footer's thrift parse,
the ScanPlan (group pruning and the footer walk into chunk byte ranges),
and for dictionary-encoded columns the dictionary page's decompress and
decode, per chunk, per scan.  This module holds all three behind ONE
bounded LRU keyed by file generation:

- **footers** (``FileMetaData`` and a ``Schema``) keyed by ``(path, size,
  mtime_ns)`` for local files, or ``(identity_token, size)`` for
  ``iostore.ByteStore`` objects.  A changed file changes its key, so a
  stale entry is never served, and the previous generation is dropped
  eagerly (``invalidations`` counts them);
- **ScanPlans** (``scanplan``) keyed by ``(file key, projection, filter
  fingerprint)``: replayed, not rebuilt, so their route and pruning memos
  accumulate across scans;
- **decoded dictionaries** keyed by ``(file key, row group, column, decode
  kind)``, stored in the result cache's host tier (``results``) and shared
  read-only with every decoder (:class:`BoundDictCache` is the per-file
  adapter the readers call).

Bounded: cached bytes are capped (``TPQ_PLAN_CACHE_MB``, default 256) with
LRU eviction; ``counters()`` gives hits, misses and evictions per kind.
``reader_kwargs`` hands both readers and ``scan_files`` the ``metadata=``,
``plan=``, ``dict_cache=`` and (with a sized result tier) ``result_cache=``
arguments; pass ``device=True`` (or the reader's device) for the device
reader.

A request trace (``obs.current_request_trace``) gets one ``cache_<kind>``
span per read-through probe, with its hit.
"""

from __future__ import annotations

import copy
import os
import struct
import threading
import time
from collections import OrderedDict

from ..footer import read_file_metadata
from ..iostore import ByteStore
from ..obs import current_request_trace, env_int
from ..scanplan import apply_selection, build_scan_plan, predicate_fingerprint
from ..schema.core import Schema
from .result_cache import ResultCache

__all__ = ["PlanCache", "BoundDictCache", "CacheStats"]

_KINDS = ("footer", "plan", "dict")


class CacheStats:
    """Per-kind hit / miss counters, evictions and invalidations (mutated
    under the owning cache's lock)."""

    __slots__ = ("hits", "misses", "evictions", "invalidations")

    def __init__(self):
        self.hits = {k: 0 for k in _KINDS}
        self.misses = {k: 0 for k in _KINDS}
        self.evictions = 0
        self.invalidations = 0

    def as_dict(self) -> dict:
        return {
            **{f"{k}_hits": self.hits[k] for k in _KINDS},
            **{f"{k}_misses": self.misses[k] for k in _KINDS},
            "evictions": self.evictions,
            "invalidations": self.invalidations,
        }


class PlanCache:
    """Bounded read-through cache over footers, ScanPlans and decoded
    dictionaries.  Thread-safe; one instance is shared by every consumer
    (``scan_files(plan_cache=)``, readers built from ``reader_kwargs``).

    ``results`` shares a :class:`ResultCache`; otherwise one is made with
    ``result_cache_mb`` / ``result_cache_hbm_mb`` (MB, else the
    ``TPQ_RESULT_CACHE_MB`` / ``TPQ_RESULT_CACHE_HBM_MB`` defaults, 0: off).
    With its host tier off, the dictionary store rides this cache's
    budget."""

    def __init__(self, max_bytes: "int | None" = None, results=None,
                 result_cache_mb: "int | None" = None,
                 result_cache_hbm_mb: "int | None" = None):
        if max_bytes is None:
            max_bytes = env_int("TPQ_PLAN_CACHE_MB", 256, lo=1) << 20
        self.max_bytes = int(max_bytes)
        self.results = (results if results is not None else ResultCache(
            max_bytes=(None if result_cache_mb is None
                       else int(result_cache_mb) << 20),
            hbm_bytes=(None if result_cache_hbm_mb is None
                       else int(result_cache_hbm_mb) << 20),
            dict_fallback_bytes=self.max_bytes))
        self.stats = CacheStats()
        self._lock = threading.Lock()
        # full key -> (value, nbytes); insertion order = recency
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._bytes = 0
        # file identity -> current generation key: a file whose generation
        # moved drops its stale entries at once
        self._gen: dict = {}
        # single-flight build locks: N concurrent first touches of one key
        # build once; late arrivals count as hits
        self._building: dict = {}

    # -- identity --------------------------------------------------------------

    @staticmethod
    def file_key(source, store: "ByteStore | None" = None):
        """The file-generation key, or None when the source has no stable
        identity (an anonymous stream: never cached, never stale).  Local
        paths key by ``(abspath, size, mtime_ns)``; stores by their
        ``identity_token`` and ``size()``."""
        if store is not None and isinstance(store, ByteStore):
            tok = store.identity_token
            if tok is None:
                return None
            return ("store", tok, int(store.size()))
        if isinstance(source, (str, os.PathLike)):
            path = os.path.abspath(os.fspath(source))
            try:
                st = os.stat(path)
            except OSError:
                return None
            return ("file", path, int(st.st_size), int(st.st_mtime_ns))
        return None

    # -- the one LRU -----------------------------------------------------------

    def _read_through(self, kind: str, key: tuple, build):
        """Get or build, single-flight: one builder per key runs (one miss
        counted); concurrent callers wait on the build lock and count as
        hits.  ``build()`` returns ``(value, nbytes)``."""
        tr = current_request_trace()
        if tr is None:
            return self._read_through_inner(kind, key, build)
        t0 = time.perf_counter()
        misses0 = self.stats.misses[kind]
        try:
            return self._read_through_inner(kind, key, build)
        finally:
            # best-effort hit attribution: a neighbour's miss may tick
            # between the two reads; a probe span is evidence, not a count
            tr.add_timed(f"cache_{kind}", t0, time.perf_counter(),
                         hit=self.stats.misses[kind] == misses0)

    def _read_through_inner(self, kind: str, key: tuple, build):
        full = (kind, *key)
        with self._lock:
            hit = self._entries.get(full)
            if hit is not None:
                self._entries.move_to_end(full)
                self.stats.hits[kind] += 1
                return hit[0]
            lock = self._building.get(full)
            if lock is None:
                lock = self._building[full] = threading.Lock()
        with lock:
            with self._lock:
                hit = self._entries.get(full)
                if hit is not None:
                    self._entries.move_to_end(full)
                    self.stats.hits[kind] += 1
                    return hit[0]
                self.stats.misses[kind] += 1
            try:
                value, nbytes = build()
                # published before the build lock's registration goes: a
                # thread arriving after the pop finds the entry
                self._put(kind, key, value, nbytes)
            finally:
                with self._lock:
                    self._building.pop(full, None)
            return value

    def _drop_stale_locked(self, ident: tuple, keep) -> int:
        """Drop every entry whose file key shares ``ident`` but is not
        ``keep`` (None drops all of the identity's entries).  The caller
        holds the lock; returns the number dropped."""
        stale = [f for f in self._entries
                 if isinstance(f[1], tuple)
                 and f[1][:2] == ident and f[1] != keep]
        for f in stale:
            _v, n = self._entries.pop(f)
            self._bytes -= n
            self.stats.invalidations += 1
        return len(stale)

    def _put(self, kind: str, key: tuple, value, nbytes: int) -> None:
        with self._lock:
            full = (kind, *key)
            old = self._entries.pop(full, None)
            if old is not None:
                self._bytes -= old[1]
            nbytes = max(int(nbytes), 1)
            self._entries[full] = (value, nbytes)
            self._bytes += nbytes
            # a new generation of a file drops the previous generation's
            # entries in full.  A file key is ("file", path, size,
            # mtime_ns) or ("store", token, size): identity = the first two
            fk = key[0]
            moved = False
            if isinstance(fk, tuple) and len(fk) >= 2:
                ident = fk[:2]
                prev = self._gen.get(ident)
                if prev is not None and prev != fk:
                    moved = True
                    self._drop_stale_locked(ident, fk)
                self._gen[ident] = fk
            # one byte budget: with the result tier unsized the dictionary
            # store rides this budget (a 1/16 slice always kept for
            # footers and plans)
            limit = self.max_bytes
            if self.results.dict_fallback_active:
                limit = max(self.max_bytes - self.results.host_held(),
                            self.max_bytes // 16, 1)
            while self._bytes > limit and len(self._entries) > 1:
                _f, (_v, n) = self._entries.popitem(last=False)
                self._bytes -= n
                self.stats.evictions += 1
        if moved:
            # decoded results invalidate at the same moment plans do
            self.results.note_generation(fk)

    # -- footers ---------------------------------------------------------------

    def footer(self, source, store: "ByteStore | None" = None):
        """Read-through footer: ``(FileMetaData, Schema)`` for a path or a
        ``ByteStore`` object.  Sources without a key load fresh every time
        (counted as misses)."""
        def build():
            if store is not None and isinstance(store, ByteStore):
                meta = read_file_metadata(_StoreFile(store),
                                          validate_head_magic=False)
                nbytes = _footer_len(store=store)
            else:
                meta = read_file_metadata(source)
                nbytes = _footer_len(path=source)
            return (meta, Schema.from_file_metadata(meta)), nbytes + 4096

        key = self.file_key(source, store)
        if key is None:
            with self._lock:
                self.stats.misses["footer"] += 1
            return build()[0]
        return self._read_through("footer", (key,), build)

    # -- plans -----------------------------------------------------------------

    def plan(self, key, columns, row_filter, meta=None, schema=None,
             source=None, store=None):
        """Read-through ScanPlan for ``(file key, projection, filter)``.
        ``meta`` / ``schema`` skip the footer lookup when the caller holds
        them.  Returns the shared plan object: its route and pruning memos
        accumulate across every consumer."""
        fp = predicate_fingerprint(row_filter)
        cols_sig = _columns_sig(columns)

        def build():
            m, s = ((meta, schema) if meta is not None and schema is not None
                    else self.footer(source, store))
            sel = _selected_schema(s, columns)
            plan = build_scan_plan(m, sel, file_key=key,
                                   row_filter=row_filter, filter_fp=fp)
            return plan, plan.nbytes()

        cacheable = key is not None and (row_filter is None or fp is not None)
        if not cacheable:
            with self._lock:
                self.stats.misses["plan"] += 1
            return build()[0]
        return self._read_through("plan", (key, cols_sig, fp), build)

    # -- decoded dictionaries --------------------------------------------------
    # held in the result cache's host tier (one LRU, one byte budget with
    # the decoded chunks); counted here under the "dict" kind

    def dict_get(self, key, rg, column, kind):
        if key is None:
            return None
        hit = self.results.get(ResultCache.dict_key(key, rg, column, kind))
        with self._lock:
            if hit is not None:
                self.stats.hits["dict"] += 1
            else:
                self.stats.misses["dict"] += 1
        return hit

    def dict_put(self, key, rg, column, kind, value, nbytes) -> None:
        if key is None:
            return
        self.results.put(ResultCache.dict_key(key, rg, column, kind),
                         value, nbytes, "host")

    # -- writer integration ----------------------------------------------------

    def note_mutation(self, source, store: "ByteStore | None" = None) -> int:
        """Invalidate a file the caller just replaced or removed, at once
        rather than at the next footer read: compute its new generation
        key, drop every entry of earlier generations (footers, plans,
        dictionaries) and notify the result tier.  A file that no longer
        exists drops by identity (its decoded results can never be reached
        again and age out of the LRU).  Returns the number of plan-cache
        entries dropped."""
        fk = self.file_key(source, store)
        with self._lock:
            if fk is None:
                if not isinstance(source, (str, os.PathLike)):
                    return 0
                ident = ("file", os.path.abspath(os.fspath(source)))
                dropped = self._drop_stale_locked(ident, None)
                self._gen.pop(ident, None)
                return dropped
            ident = fk[:2]
            dropped = 0
            if self._gen.get(ident) != fk:
                dropped = self._drop_stale_locked(ident, fk)
                self._gen[ident] = fk
        self.results.note_generation(fk)
        return dropped

    # -- reader integration ----------------------------------------------------

    def bind_results(self, key, plan, row_filter=None, device=False,
                     validate_crc=None, tenant: "str | None" = None):
        """The one bind gate for the result tier: a filtered device scan
        whose predicate has no stable fingerprint gets no result cache (two
        such predicates must never share page-pruned output).  ``device``
        as in ``ResultCache.bind``.  Returns a ``BoundResultCache`` or
        None."""
        is_dev = device is not False and device is not None
        if is_dev and row_filter is not None and plan.filter_fp is None:
            return None
        return self.results.bind(key, device=device,
                                 validate_crc=validate_crc,
                                 filter_fp=plan.filter_fp, tenant=tenant)

    def reader_kwargs(self, source, columns=None, row_filter=None,
                      store: "ByteStore | None" = None, device=False,
                      validate_crc=None) -> dict:
        """The ``metadata=`` / ``plan=`` / ``dict_cache=`` (and, with a
        sized result tier, ``result_cache=``) arguments that run a
        ``FileReader``, a ``DeviceFileReader`` or ``scan_files`` over this
        cache's shared state.  ``device`` and ``validate_crc`` sign the
        result tier's entries and must match the consuming reader: False
        (the host shape) for a ``FileReader``; True (the default device)
        or the reader's device for a ``DeviceFileReader``.  A reader drops
        an adapter signed for another shape rather than serve it: a
        mismatch costs the caching, never correctness."""
        key = self.file_key(source, store)
        meta, schema = self.footer(source, store)
        plan = self.plan(key, columns, row_filter, meta=meta, schema=schema)
        kw = {"metadata": meta, "plan": plan,
              "dict_cache": BoundDictCache(self, key)}
        rc = self.bind_results(key, plan, row_filter=row_filter,
                               device=device, validate_crc=validate_crc)
        if rc is not None:
            kw["result_cache"] = rc
        return kw

    # -- reporting -------------------------------------------------------------

    def counters(self) -> dict:
        with self._lock:
            return {
                **self.stats.as_dict(),
                "held_bytes": self._bytes,
                "capacity_bytes": self.max_bytes,
                "entries": len(self._entries),
            }

    sample = counters


class BoundDictCache:
    """A :class:`PlanCache` bound to one file generation: the adapter the
    chunk decoders call (``get(rg, column, kind)`` / ``put(rg, column,
    kind, value, nbytes)``).  ``kind`` separates the decode shapes
    (``"host:v*"``: plain-decoded arrays; ``"dev:v*"``: the device
    assembler's table entry) and the CRC tiers."""

    __slots__ = ("cache", "key")

    def __init__(self, cache: PlanCache, key):
        self.cache = cache
        self.key = key

    def get(self, rg, column, kind):
        return self.cache.dict_get(self.key, rg, column, kind)

    def put(self, rg, column, kind, value, nbytes) -> None:
        self.cache.dict_put(self.key, rg, column, kind, value, nbytes)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

class _StoreFile:
    """A seek/read file view over a ByteStore (whence-aware, unlike the
    ``SharedReader`` positioned view): enough for ``read_file_metadata``."""

    __slots__ = ("_s", "_pos")

    def __init__(self, store: ByteStore):
        self._s = store
        self._pos = 0

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == os.SEEK_END:
            self._pos = self._s.size() + pos
        elif whence == os.SEEK_CUR:
            self._pos += pos
        else:
            self._pos = pos
        return self._pos

    def read(self, size: int = -1) -> bytes:
        if size < 0:
            size = max(self._s.size() - self._pos, 0)
        b = self._s.read_range(self._pos, size)
        self._pos += len(b)
        return b


def _footer_len(path=None, store: "ByteStore | None" = None) -> int:
    """The footer's thrift length from the 8-byte tail (accounting only):
    0 on any failure."""
    try:
        if store is not None:
            size = store.size()
            tail = store.read_range(size - 8, 8)
        else:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(size - 8)
                tail = f.read(8)
        return struct.unpack("<I", tail[:4])[0]
    except Exception:  # noqa: BLE001 — accounting only
        return 0


def _columns_sig(columns) -> "tuple | None":
    if columns is None:
        return None
    return tuple(sorted(c if isinstance(c, str) else ".".join(c)
                        for c in columns))


def _selected_schema(schema, columns):
    """A fresh Schema with ``columns`` applied: the shared cached Schema is
    never mutated (selection is per-consumer state)."""
    if columns is None:
        return schema
    sel = copy.deepcopy(schema)
    apply_selection(sel, columns)
    return sel
