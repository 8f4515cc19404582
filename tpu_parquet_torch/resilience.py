"""Request-lifecycle primitives: cancel tokens, circuit breakers, and the
seeded chaos schedule.

The counterpart of ``tpu_parquet.resilience``, whole: pure host code that
imports no store and no reader, so every layer can use it.

- :class:`CancelToken` — one per request: an optional absolute deadline
  plus a caller-cancel flag.  ``check()`` is the unit-boundary gate the
  prefetch pipeline, the readers and the IO retry loop call; it raises the
  typed verdict (:class:`~tpu_parquet_torch.errors.DeadlineExceededError`
  / :class:`~tpu_parquet_torch.errors.CancelledError`).
- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-file failure
  memory: N classified failures inside a window open the circuit, requests
  fast-fail with :class:`~tpu_parquet_torch.errors.CircuitOpenError`
  naming the file and cooldown, and a half-open probe closes it again.  No
  reader wires these in: the scan service does (Queue 1 item 6).
- :class:`ChaosSchedule` — a seeded, serializable plan of fault phases
  (stall storms, transient bursts, torn reads, per-file blackouts) over a
  read-ordinal axis, driving
  :class:`~tpu_parquet_torch.iostore.FaultInjectingStore` through its
  ``_spec_for`` hook.  Its blob is the reference's, byte for byte.

A request's ``obs.RequestTrace`` rides its ``CancelToken`` (``trace``):
the token already flows through the readers, the prefetch workers and both
stores, so every span site guards on ``token.trace is not None``.
"""

from __future__ import annotations

import random
import struct
import threading
import time
from dataclasses import dataclass

from .errors import (CancelledError, CircuitOpenError, DeadlineExceededError,
                     ParquetError)
from .obs import env_float, env_int

__all__ = [
    "BreakerBoard", "CancelToken", "ChaosPhase", "ChaosSchedule",
    "CircuitBreaker", "MAX_CHAOS_STALL_S", "PHASE_KINDS",
]


# ---------------------------------------------------------------------------
# cancel tokens: the per-request deadline + cancellation contract
# ---------------------------------------------------------------------------

class CancelToken:
    """Per-request cancellation + deadline state, checked at unit boundaries.

    ``deadline`` is an absolute ``time.monotonic()`` point (None = no
    deadline).  ``cancel(exc)`` flips the token from any thread; the next
    ``check()`` in the request's pipeline raises that exception (default: a
    :class:`~tpu_parquet_torch.errors.CancelledError`).  An expired deadline
    raises :class:`~tpu_parquet_torch.errors.DeadlineExceededError` — and LATCHES
    it, so every subsequent check in the same request reports the same
    verdict object (one request, one cause).

    Thread-safe and cheap on the hot path: an un-cancelled, deadline-less
    token's ``check()`` is two attribute reads.
    """

    __slots__ = ("deadline", "deadline_s", "_exc", "_lock", "_callbacks",
                 "trace")

    def __init__(self, deadline: "float | None" = None,
                 deadline_s: "float | None" = None):
        # deadline_s (the caller's relative budget) rides along purely for
        # the error message — the absolute point is what gets compared
        self.deadline = deadline
        self.deadline_s = deadline_s
        self._exc: "BaseException | None" = None
        self._lock = threading.Lock()
        self._callbacks: "list | None" = None
        # the request's obs.RequestTrace (None: tracing off, span sites
        # pay one attribute read)
        self.trace = None

    @classmethod
    def with_timeout(cls, seconds: "float | None") -> "CancelToken":
        """A token whose deadline is ``seconds`` from now (None = none)."""
        if seconds is None:
            return cls()
        return cls(deadline=time.monotonic() + float(seconds),
                   deadline_s=float(seconds))

    def cancel(self, exc: "BaseException | None" = None) -> None:
        """Flip the token: every subsequent ``check()`` raises ``exc``.
        First cause wins — a cancel landing after a deadline expiry (or a
        second cancel) never rewrites the verdict."""
        with self._lock:
            if self._exc is not None:
                return
            self._exc = exc if exc is not None else CancelledError(
                "request cancelled by caller")
            cbs, self._callbacks = self._callbacks, None
            verdict = self._exc
        self._fire(cbs, verdict)

    def on_cancel(self, callback) -> None:
        """Register ``callback(exc)`` to fire once when the token flips
        (cancel OR a deadline verdict latching in ``check()``); fires
        immediately if it already has.  Callbacks run outside the token
        lock and must not raise — a raising observer would steal the
        verdict from the request that owns it, so exceptions are
        swallowed.  Streaming sessions use this to deliver their terminal
        verdict to a blocked consumer promptly instead of at the next
        producer boundary."""
        with self._lock:
            exc = self._exc
            if exc is None:
                if self._callbacks is None:
                    self._callbacks = []
                self._callbacks.append(callback)
                return
        self._fire([callback], exc)

    @staticmethod
    def _fire(cbs, exc) -> None:
        for cb in cbs or ():
            try:
                cb(exc)
            except Exception:  # noqa: BLE001 — observers never own verdicts
                pass

    @property
    def cancelled(self) -> bool:
        return self._exc is not None

    def expired(self, now: "float | None" = None) -> bool:
        return (self.deadline is not None
                and (time.monotonic() if now is None else now)
                >= self.deadline)

    def remaining(self, now: "float | None" = None) -> "float | None":
        """Seconds left under the deadline (None = unbounded; floored at
        0.0 so callers can pass it straight to a wait timeout)."""
        if self.deadline is None:
            return None
        left = self.deadline - (time.monotonic() if now is None else now)
        return max(left, 0.0)

    def check(self) -> None:
        """The unit-boundary gate: raise the typed verdict if this request
        is cancelled or past its deadline; no-op otherwise."""
        exc = self._exc
        if exc is not None:
            raise exc
        if self.deadline is not None and time.monotonic() >= self.deadline:
            cbs = None
            with self._lock:
                if self._exc is None:
                    budget = (f" of {self.deadline_s:g}s"
                              if self.deadline_s is not None else "")
                    self._exc = DeadlineExceededError(
                        f"request deadline{budget} exceeded",
                        deadline_s=self.deadline_s)
                    cbs, self._callbacks = self._callbacks, None
                exc = self._exc
            self._fire(cbs, exc)
            raise exc


# ---------------------------------------------------------------------------
# circuit breakers: per-file failure memory
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """One file's breaker: closed → open after ``fails`` classified
    failures inside ``window_s`` → half-open after ``cooldown_s`` (ONE
    probe admitted) → closed on probe success, re-open on probe failure.

    Not thread-safe on its own — :class:`BreakerBoard` serializes access;
    the ``clock`` injection keeps the state machine unit-testable without
    sleeps.
    """

    __slots__ = ("fails", "window_s", "cooldown_s", "clock", "failures",
                 "opened_at", "probing", "probe_at", "state")

    def __init__(self, fails: int, window_s: float, cooldown_s: float,
                 clock=time.monotonic):
        self.fails = int(fails)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self.failures: list[float] = []  # classified-failure timestamps
        self.opened_at = 0.0
        self.probing = False  # half-open: the one admitted probe is out
        self.probe_at = 0.0
        self.state = "closed"

    def admit(self) -> "float | None":
        """Gate one request: None = admitted; a float = fast-fail, that
        many seconds until the next half-open probe slot."""
        if self.state == "closed":
            return None
        now = self.clock()
        remaining = self.opened_at + self.cooldown_s - now
        if self.state == "open" and remaining <= 0:
            self.state = "half_open"
            self.probing = False
        if self.state == "half_open":
            # a probe that never reported (it died with an UNCLASSIFIED
            # error — deadline expiry, caller cancel — which deliberately
            # never calls note()) must not wedge the breaker open forever:
            # after a full cooldown of silence the probe slot is forfeit
            if self.probing and now - self.probe_at >= self.cooldown_s:
                self.probing = False
            if not self.probing:
                self.probing = True  # this caller IS the probe
                self.probe_at = now
                return None
            # a probe is already out: hold the line until it reports
            return max(self.probe_at + self.cooldown_s - now, 0.0) \
                or self.cooldown_s
        return max(remaining, 0.0)

    def note(self, ok: bool) -> "str | None":
        """Record a request outcome; returns the transition that happened
        (``"opened"`` / ``"reopened"`` / ``"closed"``) or None."""
        now = self.clock()
        if ok:
            self.failures.clear()
            if self.state != "closed":
                self.state = "closed"
                self.probing = False
                return "closed"
            return None
        if self.state == "half_open":
            # the probe failed: straight back to open, fresh cooldown
            self.state = "open"
            self.probing = False
            self.opened_at = now
            return "reopened"
        if self.state == "open":
            return None  # already open; in-flight stragglers don't re-trip
        self.failures.append(now)
        cutoff = now - self.window_s
        self.failures = [t for t in self.failures if t >= cutoff]
        if len(self.failures) >= self.fails:
            self.state = "open"
            self.opened_at = now
            self.failures.clear()
            return "opened"
        return None


class BreakerBoard:
    """The serve tier's breaker registry: one :class:`CircuitBreaker` per
    file generation key (so a REWRITTEN file starts with a clean breaker),
    thread-safe, with the transition counters a scan service reports.

    Knobs (env-resolved once at construction): ``TPQ_CIRCUIT_FAILS``
    (default 5 classified failures), ``TPQ_CIRCUIT_WINDOW_S`` (default 30s
    sliding window), ``TPQ_CIRCUIT_COOLDOWN_S`` (default 5s before a
    half-open probe).  ``fails <= 0`` disables the board entirely.
    """

    def __init__(self, fails: "int | None" = None,
                 window_s: "float | None" = None,
                 cooldown_s: "float | None" = None, clock=time.monotonic):
        self.fails = (env_int("TPQ_CIRCUIT_FAILS", 5, lo=0)
                      if fails is None else int(fails))
        self.window_s = (env_float("TPQ_CIRCUIT_WINDOW_S", 30.0, lo=0.0)
                         if window_s is None else float(window_s))
        self.cooldown_s = (env_float("TPQ_CIRCUIT_COOLDOWN_S", 5.0, lo=0.0)
                           if cooldown_s is None else float(cooldown_s))
        self.clock = clock
        self._lock = threading.Lock()
        self._breakers: dict = {}  # key -> (CircuitBreaker, display name)
        self.opened = 0
        self.reopened = 0
        self.closed = 0
        self.fast_fails = 0

    @property
    def enabled(self) -> bool:
        return self.fails > 0

    def admit(self, key, name: str) -> None:
        """Gate one request's file: raises
        :class:`~tpu_parquet_torch.errors.CircuitOpenError` naming the file and
        cooldown when its circuit is open."""
        if not self.enabled or key is None:
            return
        with self._lock:
            entry = self._breakers.get(key)
            if entry is None:
                return
            wait = entry[0].admit()
            if wait is None:
                return
            self.fast_fails += 1
        raise CircuitOpenError(
            f"circuit open for {name!r}: {self.fails} classified failures "
            f"within {self.window_s:g}s; next probe in {wait:.3f}s",
            file=name, retry_after_s=wait)

    def note(self, key, name: str, ok: bool) -> None:
        """Record one request's outcome against its file's breaker."""
        if not self.enabled or key is None:
            return
        with self._lock:
            entry = self._breakers.get(key)
            if entry is None:
                if ok:
                    return  # never create a breaker for a healthy file
                entry = self._breakers[key] = (
                    CircuitBreaker(self.fails, self.window_s,
                                   self.cooldown_s, clock=self.clock), name)
            transition = entry[0].note(ok)
            if transition == "opened":
                self.opened += 1
            elif transition == "reopened":
                self.reopened += 1
            elif transition == "closed":
                self.closed += 1
            # a closed breaker with no failure memory is dead weight —
            # drop it (whether the success closed an open circuit or just
            # wiped a closed one's failure window) so the board never
            # grows past the currently-failing set
            if ok and entry[0].state == "closed":
                self._breakers.pop(key, None)

    def open_files(self) -> "list[dict]":
        """The currently-open circuits, oldest first: ``{file,
        retry_after_s}`` — the doctor/autopsy ``circuit-open`` evidence."""
        now = self.clock()
        out = []
        with self._lock:
            for br, name in self._breakers.values():
                if br.state in ("open", "half_open"):
                    left = max(br.opened_at + br.cooldown_s - now, 0.0)
                    out.append({"file": name,
                                "retry_after_s": round(left, 3),
                                "state": br.state,
                                "opened_at": br.opened_at})
        out.sort(key=lambda d: d["opened_at"])
        for d in out:
            d.pop("opened_at")
        return out

    def counters(self) -> dict:
        """The circuit counters: transition flows +
        the ``open_now`` gauge + the open files' names."""
        open_entries = self.open_files()
        with self._lock:
            return {
                "opened": self.opened,
                "reopened": self.reopened,
                "closed": self.closed,
                "fast_fails": self.fast_fails,
                "open_now": len(open_entries),
                "open_files": [e["file"] for e in open_entries],
            }


# ---------------------------------------------------------------------------
# chaos schedule: seeded fault phases over a read-ordinal axis
# ---------------------------------------------------------------------------

PHASE_KINDS = ("stall", "transient", "torn", "blackout")
# planner invariant: no phase may stall longer than this per attempt — a
# schedule is a TEST plan, and an unbounded stall would turn a failing
# assertion into a hung suite
MAX_CHAOS_STALL_S = 5.0
# blob bounds (fuzz adoption rejects anything past them: a schedule is a
# few phases, not a DoS vector)
_MAX_PHASES = 64
_MAX_ORDINAL = 1 << 31
_CHAOS_MAGIC = b"TPQC"
_CHAOS_VERSION = 1
_PHASE_FMT = "<IIBBIf"  # start, end, kind, intensity, file_index+1, stall_s


def _f32(x: float) -> float:
    """Round a float through the blob's f32 representation."""
    return struct.unpack("<f", struct.pack("<f", x))[0]


@dataclass(frozen=True)
class ChaosPhase:
    """One fault phase over the read-ordinal axis: fetches whose global
    ordinal lands in ``[start, end)`` see the fault.

    - ``kind``        one of :data:`PHASE_KINDS`;
    - ``intensity``   attempts affected per range (``fail_first``-style:
      the first N attempts at an offset fault, then heal — except
      ``blackout``, which never heals);
    - ``file_index``  which opened file the phase applies to (-1 = all) —
      the per-file blackout that trips exactly one circuit;
    - ``stall_s``     per-attempt stall bound for ``stall`` phases, capped
      at :data:`MAX_CHAOS_STALL_S`.
    """

    start: int
    end: int
    kind: str
    intensity: int = 1
    file_index: int = -1
    stall_s: float = 0.25


class ChaosSchedule:
    """A seeded, serializable plan of fault phases (the chaos harness).

    Invariants (validated on construction AND on blob adoption — the fuzz
    target's contract): phases sorted by ``start``, pairwise DISJOINT,
    ``end > start``, kinds known, intensities in [1, 255], stalls bounded
    by :data:`MAX_CHAOS_STALL_S`, at most ``_MAX_PHASES`` phases.  Equality
    is structural, and ``from_blob(to_blob(s)) == s`` exactly — the
    round-trip determinism the fuzz target asserts.
    """

    def __init__(self, phases, seed: int = 0):
        # stall_s travels as an f32 in the blob: quantize at construction
        # so from_blob(to_blob(s)) == s holds for ANY schedule, not only
        # ones that already round-tripped once
        self.phases = tuple(
            p if p.stall_s == _f32(p.stall_s)
            else ChaosPhase(p.start, p.end, p.kind, p.intensity,
                            p.file_index, _f32(p.stall_s))
            for p in phases)
        self.seed = int(seed)
        self.validate()

    # -- invariants -----------------------------------------------------------

    def validate(self) -> None:
        if len(self.phases) > _MAX_PHASES:
            raise ParquetError(
                f"chaos schedule has {len(self.phases)} phases "
                f"(max {_MAX_PHASES})")
        prev_end = None
        for p in self.phases:
            if p.kind not in PHASE_KINDS:
                raise ParquetError(f"unknown chaos phase kind {p.kind!r}")
            if not (0 <= p.start < p.end <= _MAX_ORDINAL):
                raise ParquetError(
                    f"chaos phase range [{p.start}, {p.end}) is invalid")
            if prev_end is not None and p.start < prev_end:
                raise ParquetError(
                    f"chaos phases overlap at ordinal {p.start} "
                    f"(previous phase ends at {prev_end})")
            if not (1 <= p.intensity <= 255):
                raise ParquetError(
                    f"chaos phase intensity {p.intensity} out of [1, 255]")
            if p.kind == "stall" and not (
                    0.0 < p.stall_s <= MAX_CHAOS_STALL_S):
                raise ParquetError(
                    f"chaos stall_s {p.stall_s!r} out of "
                    f"(0, {MAX_CHAOS_STALL_S}] — unbounded stalls are "
                    f"banned by design")
            if p.file_index < -1 or p.file_index >= (1 << 16):
                raise ParquetError(
                    f"chaos phase file_index {p.file_index} out of range")
            prev_end = p.end

    def __eq__(self, other) -> bool:
        return (isinstance(other, ChaosSchedule)
                and self.seed == other.seed
                and self.phases == other.phases)

    def __hash__(self):
        return hash((self.seed, self.phases))

    # -- generation -----------------------------------------------------------

    @classmethod
    def generate(cls, seed: int, n_phases: int = 4, horizon: int = 256,
                 files: int = 1) -> "ChaosSchedule":
        """A deterministic schedule from a seed: ``n_phases`` disjoint
        phases spread over ``[0, horizon)`` read ordinals, kinds and
        intensities drawn from a seeded PRNG.  Same seed, same schedule —
        byte for byte (the fuzz target proves it)."""
        rng = random.Random(int(seed) & 0xFFFFFFFF)
        n = max(min(int(n_phases), _MAX_PHASES), 0)
        horizon = max(int(horizon), 2 * n or 2)
        # cut the horizon into 2n slots, every other slot a phase: disjoint
        # by construction, with healthy gaps between storms
        edges = sorted(rng.sample(range(horizon), 2 * n)) if n else []
        phases = []
        for i in range(n):
            start, end = edges[2 * i], edges[2 * i + 1]
            if end <= start:
                continue
            kind = rng.choice(PHASE_KINDS)
            phases.append(ChaosPhase(
                start=start, end=end, kind=kind,
                intensity=rng.randint(1, 3),
                file_index=rng.randrange(files) if (
                    kind == "blackout" and files > 0) else -1,
                stall_s=round(rng.uniform(0.05, 0.5), 3),
            ))
        return cls(phases, seed=seed)

    # -- serialization --------------------------------------------------------

    def to_blob(self) -> bytes:
        out = bytearray(_CHAOS_MAGIC)
        out.append(_CHAOS_VERSION)
        out += struct.pack("<IH", self.seed & 0xFFFFFFFF, len(self.phases))
        for p in self.phases:
            out += struct.pack(
                _PHASE_FMT, p.start, p.end, PHASE_KINDS.index(p.kind),
                p.intensity, p.file_index + 1, p.stall_s)
        return bytes(out)

    @classmethod
    def from_blob(cls, blob: bytes) -> "ChaosSchedule":
        """Adopt a serialized schedule; raises
        :class:`~tpu_parquet_torch.errors.ParquetError` for anything malformed
        (truncation, bad magic, unknown kinds, invariant violations) — the
        fuzz oracle's single-type contract."""
        blob = bytes(blob)
        head = 4 + 1 + struct.calcsize("<IH")
        if len(blob) < head or blob[:4] != _CHAOS_MAGIC:
            raise ParquetError("chaos schedule blob: bad magic or truncated")
        if blob[4] != _CHAOS_VERSION:
            raise ParquetError(
                f"chaos schedule blob: unknown version {blob[4]}")
        seed, n = struct.unpack_from("<IH", blob, 5)
        psize = struct.calcsize(_PHASE_FMT)
        if len(blob) != head + n * psize:
            raise ParquetError(
                f"chaos schedule blob: {len(blob)} bytes for {n} phases "
                f"(want {head + n * psize})")
        phases = []
        for i in range(n):
            start, end, kind_i, intensity, fidx, stall_s = struct.unpack_from(
                _PHASE_FMT, blob, head + i * psize)
            if kind_i >= len(PHASE_KINDS):
                raise ParquetError(
                    f"chaos schedule blob: unknown phase kind {kind_i}")
            if not (stall_s == stall_s):  # NaN smuggled through the float
                raise ParquetError("chaos schedule blob: stall_s is NaN")
            phases.append(ChaosPhase(
                start=start, end=end, kind=PHASE_KINDS[kind_i],
                intensity=intensity, file_index=fidx - 1,
                stall_s=stall_s))  # already exact f32 from the unpack
        return cls(phases, seed=seed)

    # -- driving FaultInjectingStore ------------------------------------------

    def phase_at(self, ordinal: int,
                 file_index: int = -1) -> "ChaosPhase | None":
        """The phase covering ``ordinal`` for ``file_index`` (phases are
        sorted + disjoint, so at most one matches)."""
        for p in self.phases:
            if p.start <= ordinal < p.end and (
                    p.file_index == -1 or p.file_index == file_index):
                return p
            if p.start > ordinal:
                break
        return None

    def store_factory(self, paths, config=None, inner_factory=None):
        """A ``store=`` factory driving the schedule over a scan's files.

        ``paths`` orders the files (the ``file_index`` axis); each opened
        file gets a :class:`~tpu_parquet_torch.iostore.FaultInjectingStore` whose
        per-fetch :class:`~tpu_parquet_torch.iostore.FaultSpec` comes from the
        phase covering a SHARED read-ordinal counter — one clock for the
        whole scan, so a stall storm hits every file at once while a
        blackout stays pinned to its one victim.  ``release()`` on the
        returned factory's ``.stores`` unblocks injected stalls in
        teardown.
        """
        import os

        from .iostore import FaultInjectingStore, LocalStore

        index_of = {os.path.abspath(os.fspath(p)): i
                    for i, p in enumerate(paths)}
        counter = _OrdinalClock()
        schedule = self

        class _ChaosStore(FaultInjectingStore):
            """FaultInjectingStore whose spec is phase-driven: the chaos
            schedule IS the spec provider (see ``_spec_for``)."""

            def __init__(self, inner, file_index: int):
                super().__init__(inner, config=config, seed=schedule.seed)
                self._file_index = file_index

            def _spec_for(self, offset, size, attempt):
                from .iostore import FaultSpec

                phase = schedule.phase_at(counter.tick(), self._file_index)
                if phase is None:
                    return FaultSpec()  # healthy: clean passthrough
                if phase.kind == "stall":
                    return FaultSpec(stall_first=phase.intensity,
                                     stall_s=phase.stall_s)
                if phase.kind == "transient":
                    return FaultSpec(fail_first=phase.intensity)
                if phase.kind == "torn":
                    return FaultSpec(torn_first=phase.intensity)
                # blackout: every attempt fails until the phase ends — the
                # circuit breaker's trip wire
                return FaultSpec(fail_first=1 << 30)

        stores: list = []

        def factory(f):
            path = os.path.abspath(getattr(f, "name", "") or "")
            inner = (inner_factory(f) if inner_factory is not None
                     else LocalStore(f))
            st = _ChaosStore(inner, index_of.get(path, -1))
            stores.append(st)
            return st

        factory.stores = stores
        factory.release = lambda: [s.release() for s in stores]
        return factory


class _OrdinalClock:
    """The shared read-ordinal counter a chaos run advances on every
    injected-store fetch attempt (thread-safe; deterministic per-file when
    the test drives one file at a time, monotonic always)."""

    __slots__ = ("_n", "_lock")

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def tick(self) -> int:
        with self._lock:
            n = self._n
            self._n += 1
            return n
