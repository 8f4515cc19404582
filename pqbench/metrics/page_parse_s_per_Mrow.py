"""Host seconds per million rows in the page and run walks.

On a flat leaf's chunk of v1 pages, UNCOMPRESSED or SNAPPY, the program
walks the chunk natively (``chunk_walk``): ``page_parse`` holds the header
call and the materialise call's own time (its CRC and decompression
nanoseconds go to the ``crc`` and ``decompress`` parts), and ``run_walk``
the index-run call, range max included.  Only the chunks the walk declines
(counted by reason in ``chunk_walk_fallbacks``: levels, codec, v2 pages,
budget, no native library) take the page loop, whose page-header walk and
data-page parse (``walk_pages``, ``parse_data_page``) land in
``page_parse`` and whose level, index and length structure walks
(``hybrid_meta``, ``delta_meta``, ``bytearray_walk``,
``bytearray_lengths``) in ``run_walk``; the DELTA and byte-array walks are
``run_walk``'s on either path.

The program's process-wide host-phase counters
(``tpu_parquet_torch.obs.host_phase_totals()``: self time per part, summed
over every device reader of the process, the warm-up pass included) give
the part's share of the host phase; that share of the window's
``host_s_per_Mrow`` (``ReaderStats.host_seconds`` over the window's
complete passes, per million rows) is the metric, so the parts split that
metric exactly and the warm-up weighs only as its share of the passes.
Parts: ``page_parse``, ``run_walk``.
"""

PARTS = ("page_parse", "run_walk")


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
