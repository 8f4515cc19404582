"""Link-byte ship planner, cut to the routes of the flat-column slice.

The counterpart of ``tpu_parquet.ship``.  A chunk's PLAIN fixed-width value
stream reaches device memory on one of two routes:

===============  ============================================================
route            what ships over the link, and the device half
===============  ============================================================
plain            the decompressed host bytes; slice + bitcast on the device
fused_plain      the same bytes; one CUDA kernel pass (``cuda_kernels``
                 ``fused_plain_words``) assembles the words and zeroes the
                 tail past the real value count
===============  ============================================================

The reference offers five more routes (narrow transcodes, device-side snappy,
link recompression); they belong to the compressed-shipping slice and are not
offered here.

The reference ranks routes by a cost model and offers its fused routes when
``TPQ_FUSE`` and its backend allow.  For these two routes its model always
ties (same link bytes; the fused device pass is never the bottleneck lane)
and the tie goes to the fused route.  Here the gate is the port's own: the
fused kernel exists on every device the reader accepts (the CUDA kernel on
the card, its plain version on the CPU), so an eligible stream ranks
``fused_plain`` first, exactly as the reference does where it offers it.
``TPQ_FORCE_ROUTE`` pins the choice as in the reference, so that forced
route choices and link-byte counters can be compared on the same file.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

ROUTE_PLAIN = "plain"
ROUTE_FUSED_PLAIN = "fused_plain"
# the routes this package builds; TPQ_FORCE_ROUTE accepts these names only
ROUTES = (ROUTE_PLAIN, ROUTE_FUSED_PLAIN)
FUSED_ROUTES = (ROUTE_FUSED_PLAIN,)


def parse_route(raw, *, source: str = "TPQ_FORCE_ROUTE") -> "str | None":
    """Validate a route name from the environment against ``ROUTES``.
    Malformed values and routes of other slices degrade to unforced routing
    with one warning line instead of a raise."""
    v = (raw or "").strip()
    if not v:
        return None
    if v not in ROUTES:
        logging.getLogger(__name__).warning(
            "%s=%r is not valid; using %r", source, v, "unforced routes")
        return None
    return v


@dataclass(frozen=True)
class ChunkFacts:
    """What the planner needs for one chunk: ``logical`` is the value-stream
    byte count (what ``plain`` ships), ``width`` the fixed value width, and
    ``flat`` whether the column is required and unrepeated (no level lanes:
    the fused route claims only flat streams)."""

    logical: int
    width: int = 0
    flat: bool = True


def fused_eligible(f: ChunkFacts) -> "tuple[str, ...]":
    """The fused routes these facts admit (the reference's predicate, cut
    to this slice's one fused route)."""
    if not f.flat or f.width not in (4, 8) or f.logical <= 0:
        return ()
    return (ROUTE_FUSED_PLAIN,)


class ShipPlanner:
    """Orders a chunk's candidate routes; the assembler tries them in order,
    falling through on infeasibility, ``plain`` last.  Reads
    ``TPQ_FORCE_ROUTE`` at construction (one planner per reader)."""

    def __init__(self, force: "str | None" = None):
        if force is None:
            force = parse_route(os.environ.get("TPQ_FORCE_ROUTE", ""))
        elif force not in ROUTES:
            raise ValueError(f"forced route {force!r} not one of {ROUTES}")
        self.force = force

    def routes(self, f: ChunkFacts) -> list:
        """Candidate routes, first choice first: a forced route leads with
        ``plain`` behind it; otherwise the fused route where eligible."""
        if self.force is not None:
            return ([self.force, ROUTE_PLAIN] if self.force != ROUTE_PLAIN
                    else [ROUTE_PLAIN])
        return [*fused_eligible(f), ROUTE_PLAIN]
