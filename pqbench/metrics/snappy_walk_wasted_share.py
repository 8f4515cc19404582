"""The snappy tag walk's seconds thrown away, in % of its seconds: attempts
restarted on the op-table cap (``retries``) and streams walked for a
shipment the planner then declined (``declined``: over the op-table cap,
the worth-it gate, the fused kernel's caps), over every walk's seconds.
From the program's process-wide host-phase counters
(``tpu_parquet_torch.obs.host_phase_totals()``).  None where nothing was
walked.
"""


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
    totals = _totals() if totals is None else totals
    if not run["layer"].get("reader") or not totals \
            or not totals["host_seconds"]:
        return None
    walked = totals["parts"]["snappy_walk"]
    if not walked:
        return None
    return 100.0 * totals["snappy_walk"]["wasted_seconds"] / walked
