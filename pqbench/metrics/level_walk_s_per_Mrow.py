"""Host seconds per million rows in the walks of def and rep level streams.

The program's host phase keeps these in a part of their own,
``level_walk``: the run-header walk of each data page's def stream in the
page parse (``parse_level_meta``, which also counts the defined values),
the rep streams' walks when a chunk's level plans are made, the host
decodes of level streams, and the native walks under them.  The
dictionary-index, DELTA and byte-array walks stay in ``run_walk``.

The program's process-wide host-phase counters
(``tpu_parquet_torch.obs.host_phase_totals()``: self time per part, summed
over every device reader of the process, the warm-up pass included) give
the part's share of the host phase; that share of the window's
``host_s_per_Mrow`` (``ReaderStats.host_seconds`` over the window's
complete passes, per million rows) is the metric, as for the other parts.
A program whose host phase has no such part gives no reading.
"""

PART = "level_walk"


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
    part = totals.get("parts", {}).get(PART)
    if part is None:
        return None
    return part / totals["host_seconds"] * r["host_seconds"] / (r["rows"]
                                                                / 1e6)
