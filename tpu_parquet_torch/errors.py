"""Unified error hierarchy: every malformed-input failure is a ParquetError.

The reference turns every internal panic into one error type at its public
boundary (FileReader.recover, file_reader.go:177-184; schemaParser.recover,
schema_parser.go:285-298).  The Python equivalent is subclassing: each layer
keeps its specific error (ThriftError, RLEError, ...), all rooted here, so
callers — and the fuzz harness's crash oracle — catch exactly one type.
:func:`error_context` stamps the decode site onto every such raise.
"""

from contextlib import contextmanager


class ParquetError(ValueError):
    """Malformed parquet input."""


class DataIntegrityError(ParquetError):
    """A scan's data-error budget is exhausted: corruption is no longer
    containable.

    Raised by :class:`tpu_parquet_torch.quarantine.Quarantine` when the
    number of contained data errors exceeds the budget
    (``TPQ_DATA_ERROR_BUDGET``: absolute count and fraction of units): a
    file set failing everywhere aborts the run with the evidence instead of
    skipping itself to an empty result.  ``records`` carries the structured
    quarantine records (file, row group, column, page, offset, error class,
    message) noted during the scan."""

    def __init__(self, message: str, records: "list | None" = None):
        super().__init__(message)
        self.records = list(records or [])


class HangError(RuntimeError):
    """A watched pipeline made no progress within the watchdog's deadline.

    Raised by :class:`tpu_parquet_torch.obs.Watchdog` (policy ``raise``)
    in the submitting thread (the one blocked on an
    :class:`~tpu_parquet_torch.alloc.InFlightBudget`, or on a stalled
    store fetch) after a flight-recorder dump was written.  Not a
    ParquetError: the file is not malformed, the pipeline is stuck.
    ``dump_path`` names the dump to give ``obs.autopsy_dump``."""

    def __init__(self, message: str, dump_path: "str | None" = None):
        super().__init__(message)
        self.dump_path = dump_path


class TransientIOError(IOError):
    """A single range-read attempt failed in a way that is worth retrying.

    Raised by :class:`tpu_parquet_torch.iostore.ByteStore` implementations
    (and the fault injector) for what real object stores do: connection
    resets, throttling, torn or short responses, per-attempt deadline
    overruns.  ``GenericRangeStore.read_range`` catches it and retries with
    backoff; it only reaches callers wrapped in a
    :class:`RetryExhaustedError`.  Rooted at ``IOError``, not ParquetError:
    the file is fine, the transport hiccuped, and quarantine never contains
    it."""


class RetryExhaustedError(IOError):
    """A range read failed after exhausting its retries, deadline or budget.

    Raised by :class:`tpu_parquet_torch.iostore.GenericRangeStore` when a
    read's bounded retries, its per-request deadline
    (``TPQ_IO_DEADLINE_S``) or the per-scan retry budget
    (``TPQ_IO_RETRY_BUDGET``) runs out.  ``attempts`` carries the attempt
    log (one dict per try: error, elapsed, backoff); ``offset`` / ``size``
    name the range that could not be read.  Rooted at ``IOError``, not
    ParquetError: the bytes were never readable, nothing was malformed."""

    def __init__(self, message: str, attempts: "list | None" = None,
                 offset: "int | None" = None, size: "int | None" = None):
        super().__init__(message)
        self.attempts = list(attempts or [])
        self.offset = offset
        self.size = size


class OverloadError(RuntimeError):
    """A scan service refused a request: its admission queue is full, or
    brownout (``TPQ_SERVE_BROWNOUT``) shed the request's priority band.

    Raised by :class:`tpu_parquet_torch.serve.ScanService` at submission,
    at once: the caller is never blocked, so it can back off or go
    elsewhere.  Not a ParquetError (nothing is malformed) and not an
    IOError (nothing was read).  ``queue_depth`` and ``in_flight`` give the
    admission state at the refusal, ``retry_after_s`` the service's
    back-off hint from its drain rate, and ``shed_priority`` the band that
    was shed (None for a plain queue-full refusal)."""

    def __init__(self, message: str, queue_depth: "int | None" = None,
                 in_flight: "int | None" = None,
                 retry_after_s: "float | None" = None,
                 shed_priority: "int | None" = None):
        super().__init__(message)
        self.queue_depth = queue_depth
        self.in_flight = in_flight
        self.retry_after_s = retry_after_s
        self.shed_priority = shed_priority


class DeadlineExceededError(TimeoutError):
    """A request's end-to-end deadline expired before it finished.

    Raised through a :class:`tpu_parquet_torch.resilience.CancelToken`
    whose deadline passed: it rides the scan into every
    ``ByteStore.read_range`` and is checked at unit boundaries in the
    prefetch pipeline, so the request stops issuing IO, releases what it
    held and surfaces here.  Rooted at TimeoutError, not ParquetError
    (nothing is malformed) and not IOError (the transport is fine; the
    caller's clock ran out).  ``deadline_s`` echoes the budget the request
    was given."""

    def __init__(self, message: str, deadline_s: "float | None" = None):
        super().__init__(message)
        self.deadline_s = deadline_s


class CancelledError(RuntimeError):
    """The caller cancelled its own request (``CancelToken.cancel()``).

    The same containment contract as :class:`DeadlineExceededError`: the
    request stops issuing IO at the next unit boundary and releases what it
    held.  A type distinct from ``concurrent.futures.CancelledError`` on
    purpose: this is an application-level verdict, never a pool internal."""


class CheckpointError(ParquetError):
    """Malformed, incompatible or version-mismatched loader checkpoint
    state.

    Raised by ``tpu_parquet_torch.data.checkpoint`` for any state blob that
    cannot be adopted safely: truncation, bad magic, an unknown version,
    type or range violations and dataset-fingerprint mismatches all land
    here rather than silently mis-seeking the loader.  Rooted at
    ParquetError, so one type covers the checkpoint surface too."""


class CircuitOpenError(RuntimeError):
    """A per-file circuit breaker is open: the file keeps failing and
    requests touching it fast-fail instead of paying the full retry and
    deadline cost again.

    Raised by :class:`tpu_parquet_torch.resilience.BreakerBoard` once it
    has seen N classified failures inside its window
    (``TPQ_CIRCUIT_FAILS`` / ``TPQ_CIRCUIT_WINDOW_S``).  ``file`` names the
    file, ``retry_after_s`` the cooldown left until a half-open probe is
    admitted.  Not a ParquetError: it reports the breaker's memory of
    earlier failures, not a fresh diagnosis."""

    def __init__(self, message: str, file: "str | None" = None,
                 retry_after_s: "float | None" = None):
        super().__init__(message)
        self.file = file
        self.retry_after_s = retry_after_s


# ---------------------------------------------------------------------------
# decode-site context on every raise (re-exported by ``quarantine``, whose
# policy engine reads it)
# ---------------------------------------------------------------------------

# record keys in report order
_CTX_KEYS = ("file", "column", "row_group", "page", "offset", "unit",
             "epoch")


def annotate_data_error(exc: BaseException, **ctx) -> BaseException:
    """Attach decode-site coordinates to ``exc`` and rewrite its message.

    Inner frames win: a field already present (set closer to the failure)
    is never overwritten by an outer, vaguer one.  The original message is
    kept on the exception and recomposed, so nesting N contexts yields ONE
    ``[file=... column=...]`` suffix, not N.
    """
    dc = getattr(exc, "data_context", None)
    if dc is None:
        dc = {}
        exc.data_context = dc
        exc._tpq_base_msg = str(exc)
    for k, v in ctx.items():
        if v is not None and k not in dc:
            dc[k] = v
    suffix = " ".join(f"{k}={dc[k]}" for k in _CTX_KEYS if k in dc)
    if suffix and exc.args:
        exc.args = (f"{exc._tpq_base_msg} [{suffix}]",) + exc.args[1:]
    return exc


@contextmanager
def error_context(**ctx):
    """Re-raise any ``ParquetError`` crossing this block annotated with
    ``ctx`` (see :func:`annotate_data_error`): file, column, row group,
    page and byte offset on every decode raise, CRC mismatches included."""
    try:
        yield
    except ParquetError as e:
        raise annotate_data_error(e, **ctx)
