"""The share of the level slots the program planned through the fused K1.

Each def or rep level stream of a column chunk is expanded on the device
through the fused K1 (``hybrid_unpack_combine``) where the stream has
bit-packed runs, else through the run-table expand; the host-decode path
decodes its levels on the host.  The program counts the slots each route
took, by kind and by route (``tpu_parquet_torch.obs.level_totals()``:
process-wide, the warm-up pass included); the metric is 100 × the slots of
route ``k1`` over the slots of every route.  A program without the counters,
or a process that planned no level stream, gives no reading.
"""


def _totals():
    """The program's process-wide level counters, or None where the program
    has none (``obs.level_totals`` is missing)."""
    try:
        from tpu_parquet_torch import obs
        return obs.level_totals()
    except (ImportError, AttributeError):
        return None


def read(run, totals=None):
    totals = _totals() if totals is None else totals
    if not totals:
        return None
    routes = totals["slots"]["by_route"]
    slots = sum(routes.values())
    if not slots:
        return None
    return 100.0 * routes.get("k1", 0) / slots
