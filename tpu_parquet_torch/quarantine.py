"""Data-error containment: policy engine, error budget, quarantine ledger.

The counterpart of ``tpu_parquet.quarantine``.  A corrupt page, an
out-of-range dictionary index or a truncated chunk raises a
``ParquetError``; under a skip policy the readers contain it to its unit
(one row group of one file) and scan on, with exact accounting:

- **Error policy** (``TPQ_ON_DATA_ERROR`` / ``on_data_error=`` on
  ``FileReader``, ``DeviceFileReader`` and ``scan_files``):

  - ``raise``      the default: the first data error aborts the scan;
  - ``skip_unit``  quarantine the failing (file, row group) unit and keep
    scanning: the readers skip the group;
  - ``skip_file``  quarantine the failing unit AND every later unit of the
    same file.

- **Error budget** (``TPQ_DATA_ERROR_BUDGET``, ``"<count>"`` or
  ``"<count>,<fraction>"``): when the contained errors exceed the absolute
  count, or the fraction of a scan's units,
  :class:`~tpu_parquet_torch.errors.DataIntegrityError` aborts the scan
  carrying every record: a file set failing everywhere fails loudly.

- **Quarantine ledger** (:class:`QuarantineLog`): one structured record per
  failure (file, row group, column, page ordinal, byte offset, exception
  class, message), in memory and optionally appended to a JSONL file
  (``TPQ_QUARANTINE_LOG``); :func:`summarize_quarantine_log` aggregates it.

Only data errors are contained: ``ParquetError`` and its subclasses.  A
kernel build or launch failure, a CUDA error, an exhausted retry
(``RetryExhaustedError``), a deadline (``DeadlineExceededError``) or a
cancel (``CancelledError``) is never a ``ParquetError`` and always
propagates.

The coordinates come from the exception itself: :func:`error_context`
(kept in ``errors``, re-exported here) annotates every ``ParquetError``
crossing a decode site.  :func:`resolve_validate` resolves the readers'
``validate_crc=None`` default through ``TPQ_VALIDATE`` (default ``crc``:
page CRCs are verified when the writer recorded them).

Observability: each engine is a flight source (``quarantine[<n>]``, its
counters and first record: the file, column and page a data-corruption
autopsy names), and each record is a ``quarantine`` instant on the process
tracer.
"""

from __future__ import annotations

import json
import os
import threading
from .errors import (_CTX_KEYS, DataIntegrityError, annotate_data_error,
                     error_context)
from .obs import current_tracer, register_flight_source, warn_env_once

__all__ = [
    "ErrorBudget", "Quarantine", "QuarantineLog", "annotate_data_error",
    "corrupt_bytes", "error_context", "resolve_policy", "resolve_validate",
    "summarize_quarantine_log",
]

POLICIES = ("raise", "skip_unit", "skip_file")

# flight-source labels: quarantine[1], quarantine[2], ...
_engine_seq = iter(range(1, 1 << 62))


def resolve_policy(policy=None) -> str:
    """Resolve an ``on_data_error=`` kwarg (strict) or the
    ``TPQ_ON_DATA_ERROR`` env (degrades to ``raise`` with one warning —
    an env typo must never change every reader construction into a raise,
    the TPQ_HANG_POLICY contract)."""
    if policy is not None:
        p = str(policy)
        if p not in POLICIES:
            raise ValueError(
                f"on_data_error must be one of {POLICIES}, got {policy!r}")
        return p
    raw = os.environ.get("TPQ_ON_DATA_ERROR", "")
    if not raw:
        return "raise"
    if raw not in POLICIES:
        warn_env_once("TPQ_ON_DATA_ERROR", raw, "raise")
        return "raise"
    return raw


_VALIDATE_ON = ("crc", "on", "1", "true")
_VALIDATE_OFF = ("off", "0", "false", "none")


def resolve_validate(validate_crc=None) -> bool:
    """Resolve a reader's ``validate_crc`` option to a bool.

    ``None`` (every reader's default) resolves through
    ``TPQ_VALIDATE``, whose default is ``crc`` — page CRCs are verified
    *when present* (files written without ``write_crc=True`` carry none
    and pay one attribute check per page).  Explicit ``False``/``"off"``
    opts out; ``True``/``"crc"`` forces the historical opt-in value.
    Kwarg strings are strict; a malformed env degrades to the default
    with one warning.
    """
    if validate_crc is None:
        raw = os.environ.get("TPQ_VALIDATE", "crc").lower()
        if raw in _VALIDATE_ON:
            return True
        if raw in _VALIDATE_OFF:
            return False
        warn_env_once("TPQ_VALIDATE", raw, "crc")
        return True
    if isinstance(validate_crc, bool):
        return validate_crc
    v = str(validate_crc).lower()
    if v in _VALIDATE_ON:
        return True
    if v in _VALIDATE_OFF:
        return False
    raise ValueError(
        f"validate_crc must be a bool, 'crc', or 'off'; got {validate_crc!r}")


# ---------------------------------------------------------------------------
# budget + ledger + the engine
# ---------------------------------------------------------------------------

class ErrorBudget:
    """Bounds on contained data errors per scan.

    ``max_errors`` is an absolute record count; ``max_fraction`` bounds
    records as a fraction of the scan's unit total (only enforced when the
    seam knows its total — multi-file streaming scans may not).  A scan
    exceeding either raises :class:`~tpu_parquet.errors.DataIntegrityError`
    from the containment seam, carrying the record list.
    """

    def __init__(self, max_errors: int = 64, max_fraction: float = 0.5):
        self.max_errors = int(max_errors)
        self.max_fraction = float(max_fraction)

    @classmethod
    def from_env(cls) -> "ErrorBudget":
        raw = os.environ.get("TPQ_DATA_ERROR_BUDGET", "")
        if not raw:
            return cls()
        parts = raw.replace(":", ",").split(",")
        try:
            max_errors = int(parts[0])
            max_fraction = float(parts[1]) if len(parts) > 1 else 0.5
            if max_errors < 0 or not 0.0 <= max_fraction <= 1.0:
                raise ValueError(raw)
        except (TypeError, ValueError):
            warn_env_once("TPQ_DATA_ERROR_BUDGET", raw, "64,0.5")
            return cls()
        return cls(max_errors, max_fraction)

    def allowed(self, total_units: "int | None") -> int:
        """The record count a scan over ``total_units`` may reach.

        The fraction bound rounds UP: a 1-unit scan under the default
        0.5 fraction may still contain its one error (flooring to zero
        would make small scans un-containable under every skip policy —
        only an explicit ``max_fraction=0`` means "contain nothing").
        """
        import math

        cap = self.max_errors
        if total_units is not None and total_units > 0:
            cap = min(cap, math.ceil(self.max_fraction * total_units))
        return max(cap, 0)


class QuarantineLog:
    """Structured record per contained failure (thread-safe, append-only).

    Records are JSON-safe dicts: file, row_group, column, page, offset,
    error (exception class), message — plus whatever the seam adds (unit,
    epoch).  With a path (``TPQ_QUARANTINE_LOG`` or explicit) each record
    is ALSO appended to a JSONL file as it happens, so a crashed run's
    ledger survives.
    """

    def __init__(self, path: "str | None" = None):
        self.path = (path if path is not None
                     else os.environ.get("TPQ_QUARANTINE_LOG") or None)
        self.records: list[dict] = []
        self._lock = threading.Lock()

    def append(self, record: dict) -> None:
        line = None
        if self.path:
            line = json.dumps(record, sort_keys=True, default=repr)
        with self._lock:
            self.records.append(record)
            if line is not None:
                parent = os.path.dirname(self.path)
                if parent:
                    os.makedirs(parent, exist_ok=True)
                with open(self.path, "a") as f:
                    f.write(line + "\n")

    def __len__(self) -> int:
        with self._lock:
            return len(self.records)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self.records)


class Quarantine:
    """The containment engine one scan surface shares: policy + budget +
    ledger + counters.

    Seams call :meth:`note` with the caught ``ParquetError`` (context
    already attached by :func:`error_context`); it appends the record
    and raises ``DataIntegrityError``
    when the budget is exhausted.  :meth:`note_unit_skipped` /
    :meth:`note_file_skipped` account the *collateral* skips (units
    dropped by ``skip_file`` without their own failure) — accounting,
    never new records, so "every injected corruption appears in the log,
    nothing else does" holds exactly.

    Shareable: ``scan_files`` passes ONE engine to every per-file reader;
    a ``DeviceFileReader`` shares its engine with the host ``FileReader``
    it holds.
    """

    def __init__(self, policy=None, budget: "ErrorBudget | None" = None,
                 log: "QuarantineLog | None" = None,
                 log_path: "str | None" = None):
        self.policy = resolve_policy(policy)
        self.budget = budget if budget is not None else ErrorBudget.from_env()
        self.log = log if log is not None else QuarantineLog(log_path)
        self._lock = threading.Lock()
        self._scan_errors = 0
        self._scan_records: list[dict] = []
        self._total_units: "int | None" = None
        self.units_skipped = 0
        self.rows_skipped = 0
        self.files_skipped = 0
        self.by_class: dict[str, int] = {}
        # a wedge or crash dump carries the quarantine state, the first bad
        # (file, column, page) included
        register_flight_source(f"quarantine[{next(_engine_seq)}]", self,
                               "sample")

    @property
    def contains(self) -> bool:
        """True when data errors are contained (any policy but ``raise``)."""
        return self.policy != "raise"

    def begin_scan(self, total_units: "int | None" = None) -> None:
        """Scan boundary: reset the per-scan budget accounting and (when
        known) pin the fraction denominator.  The cumulative ledger and
        skip counters survive — they are the run's history."""
        with self._lock:
            self._scan_errors = 0
            self._scan_records = []
            self._total_units = (int(total_units)
                                 if total_units is not None else None)

    def note(self, exc: BaseException, **ctx) -> dict:
        """Record one contained failure; raises ``DataIntegrityError`` when
        the scan's budget is exhausted.  ``ctx`` fills record fields the
        exception's own ``data_context`` did not already carry."""
        dc = dict(getattr(exc, "data_context", None) or {})
        for k, v in ctx.items():
            if v is not None and k not in dc:
                dc[k] = v
        record = {k: dc[k] for k in _CTX_KEYS if k in dc}
        record["error"] = type(exc).__name__
        record["message"] = str(exc)[:500]
        self.log.append(record)
        with self._lock:
            self._scan_errors += 1
            self._scan_records.append(record)
            errors, records = self._scan_errors, list(self._scan_records)
            total = self._total_units
            cls = record["error"]
            self.by_class[cls] = self.by_class.get(cls, 0) + 1
        tr = current_tracer()
        if tr.active:
            tr.instant("quarantine", **{k: v for k, v in record.items()
                                        if k != "message"})
        allowed = self.budget.allowed(total)
        if errors > allowed:
            raise DataIntegrityError(
                f"data-error budget exhausted: {errors} contained "
                f"error(s) exceed the allowed {allowed} "
                f"(TPQ_DATA_ERROR_BUDGET={self.budget.max_errors},"
                f"{self.budget.max_fraction:g}"
                + (f" over {total} units" if total is not None else "")
                + f"); last: {record['message']}",
                records=records,
            ) from exc
        return record

    def note_unit_skipped(self, rows: int = 0) -> None:
        with self._lock:
            self.units_skipped += 1
            self.rows_skipped += int(rows)

    def note_file_skipped(self) -> None:
        with self._lock:
            self.files_skipped += 1

    def progress(self) -> dict:
        """Monotonic counters for the ``data_errors`` sampler track."""
        with self._lock:
            return {
                "errors": len(self.log),
                "units_skipped": self.units_skipped,
                "rows_skipped": self.rows_skipped,
                "files_skipped": self.files_skipped,
            }

    def sample(self) -> dict:
        """Flight-source snapshot: the counters and the first record."""
        out = self.progress()
        recs = self.log.snapshot()
        if recs:
            out["first"] = recs[0]
        return out

    def as_dict(self) -> dict:
        """The counters plus ``by_class`` (multi-engine scans compose by
        addition; the records live in the log)."""
        d = self.progress()
        with self._lock:
            d["by_class"] = dict(self.by_class)
        return d


# ---------------------------------------------------------------------------
# deterministic corruption (test/fault-injection helpers)
# ---------------------------------------------------------------------------

_M64 = (1 << 64) - 1

CORRUPT_MODES = ("bitflip", "zero", "truncate")


def _mix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def corrupt_bytes(data: bytes, mode: str, seed: int = 0) -> bytes:
    """Deterministically corrupt ``data`` — the payload mutator behind
    ``writer.corrupt_page``.

    Length-preserving by design: the corruption must ride THROUGH the
    transport layer (a short buffer would read as a torn fetch and be
    retried/re-classified as an IO fault) and be caught by the *integrity*
    tier.  Modes:

    - ``bitflip``   flip ``1 + len//512`` seeded bits (always changes);
    - ``zero``      zero a seeded span of up to half the payload;
    - ``truncate``  zero from a seeded point to the end (a truncated-then-
      padded page — the declared sizes stop matching the content).

    Pure in ``(data, mode, seed)``; key the seed per range (e.g.
    ``seed ^ offset``) for per-range determinism under concurrency.
    """
    if mode not in CORRUPT_MODES:
        raise ValueError(
            f"corrupt mode must be one of {CORRUPT_MODES}, got {mode!r}")
    n = len(data)
    if n == 0:
        return bytes(data)
    out = bytearray(data)
    h = _mix64((int(seed) & _M64) ^ 0xD6E8FEB86659FD93)
    if mode == "bitflip":
        for _ in range(1 + n // 512):
            h = _mix64(h)
            pos = h % n
            out[pos] ^= 1 << ((h >> 32) % 8)
    elif mode == "zero":
        h = _mix64(h)
        start = h % n
        length = 1 + (h >> 32) % (max(n // 2, 1))
        out[start : start + length] = b"\x00" * len(out[start : start + length])
    else:  # truncate
        h = _mix64(h)
        start = h % n
        out[start:] = b"\x00" * (n - start)
    return bytes(out)


# ---------------------------------------------------------------------------
# ledger summarization
# ---------------------------------------------------------------------------

def summarize_quarantine_log(records: list[dict]) -> dict:
    """Aggregate quarantine records into a report: totals, per-file / per-column / per-error-class counts, and
    the first record (the first bad file/column/page of the run)."""
    by_file: dict[str, int] = {}
    by_column: dict[str, int] = {}
    by_class: dict[str, int] = {}
    for r in records:
        if not isinstance(r, dict):
            continue
        by_file[str(r.get("file"))] = by_file.get(str(r.get("file")), 0) + 1
        if r.get("column") is not None:
            c = str(r["column"])
            by_column[c] = by_column.get(c, 0) + 1
        cls = str(r.get("error", "?"))
        by_class[cls] = by_class.get(cls, 0) + 1
    return {
        "records": len(records),
        "files": len(by_file),
        "by_file": dict(sorted(by_file.items(),
                               key=lambda kv: -kv[1])),
        "by_column": dict(sorted(by_column.items(),
                                 key=lambda kv: -kv[1])),
        "by_class": dict(sorted(by_class.items(),
                                key=lambda kv: -kv[1])),
        "first": (records[0] if records
                  and isinstance(records[0], dict) else None),
    }
