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
