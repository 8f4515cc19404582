"""The host phase's time off the CPU, in %: 100 x (host seconds - host CPU
seconds) / host seconds, from the program's process-wide host-phase
counters (``tpu_parquet_torch.obs.host_phase_totals()``: wall and
``time.thread_time`` over each row group's host phase on the caller).  The
reads are page-cache hits, so this is mostly the caller waiting for the
GIL while the staging worker or the device-timer thread holds it.
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
    return 100.0 * (totals["host_seconds"] - totals["host_cpu_seconds"]) \
        / totals["host_seconds"]
