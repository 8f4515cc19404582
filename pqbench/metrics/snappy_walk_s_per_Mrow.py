"""Host seconds per million rows in the snappy tag walk
(``native.snappy_plan``, every attempt) that plans the device-side
snappy resolve.

The program's process-wide host-phase counters
(``tpu_parquet_torch.obs.host_phase_totals()``: self time per part, summed
over every device reader of the process, the warm-up pass included) give
the part's share of the host phase; that share of the window's
``host_s_per_Mrow`` (``ReaderStats.host_seconds`` over the window's
complete passes, per million rows) is the metric, so the parts split that
metric exactly and the warm-up weighs only as its share of the passes.
Parts: ``snappy_walk``.
"""

PARTS = ("snappy_walk",)


def _totals():
    """The program's process-wide host-phase counters, or None where the
    program has none (``obs.host_phase_totals`` is missing or empty)."""
    try:
        from tpu_parquet_torch import obs
        totals = obs.host_phase_totals()
    except (ImportError, AttributeError):
        return None
    return totals if totals and totals.get("host_seconds") else None


def read(run, totals=None):
    r = run["layer"].get("reader")
    totals = _totals() if totals is None else totals
    if not r or not r["rows"] or not totals or not totals["host_seconds"]:
        return None
    share = sum(totals["parts"][p] for p in PARTS) / totals["host_seconds"]
    return share * r["host_seconds"] / (r["rows"] / 1e6)
