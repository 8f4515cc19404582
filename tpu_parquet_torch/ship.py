"""Cost-based link-byte ship planner: choose HOW a chunk's bytes reach the card.

The counterpart of ``tpu_parquet.ship``, with all seven routes.  A chunk's
value stream (or a dictionary's value table) can reach device memory as:

===================  ==========================================================
route                what ships over the link, and the device half
===================  ==========================================================
plain                the decompressed host bytes; slice + view on the device
narrow               ``(v - min)`` truncated to k bytes/value (PLAIN INT
                     only); widen + re-bias on the device
narrow_snappy        the narrow transcode, then snappy over the truncated
                     bytes; snappy resolve + gather + widen on the device
device_snappy        the file's own snappy page payloads; snappy resolve +
                     gather + decode on the device
recompress           the host re-compresses the stream to snappy; the same
                     device half as device_snappy
fused_plain          plain's bytes; ONE CUDA kernel pass (K2,
                     ``cuda_kernels.fused_plain_words``)
fused_narrow_snappy  narrow_snappy's bytes; ONE CUDA kernel pass (K3,
                     ``cuda_kernels.fused_narrow_words``) resolves, gathers,
                     widens, re-biases and zeroes the tail
===================  ==========================================================

Cost per route = max(host lane, link lane, device lane), each a
bytes/throughput term, exactly as the reference models it.  The constants
are the reference's (a TPU's link planning point): they are kept so that
route choices match the reference and can be tested against it.  Link
bandwidth comes from ``TPQ_LINK_MBPS`` and the device resolve rate from
``TPQ_DEVICE_MBPS`` when set.  The model only ROUTES — every route decodes
bit-identically, so a mis-ranked route costs time, never correctness.

The reference offers its fused routes only when ``TPQ_FUSE`` and its backend
allow.  Here a fused kernel exists on every device the reader accepts (the
CUDA kernel on the card, its plain version on the CPU), so the planner
always ranks as the reference does under ``TPQ_FUSE=1``.
``TPQ_FORCE_ROUTE=<route>`` pins the choice for any of the seven names;
infeasible forces fall back to ``plain``.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

ROUTE_PLAIN = "plain"
ROUTE_NARROW = "narrow"
ROUTE_NARROW_SNAPPY = "narrow_snappy"
ROUTE_DEVICE_SNAPPY = "device_snappy"
ROUTE_RECOMPRESS = "recompress"
ROUTE_FUSED_PLAIN = "fused_plain"
ROUTE_FUSED_NARROW_SNAPPY = "fused_narrow_snappy"
# the route-name registry: planner ranking, device_reader dispatch and the
# TPQ_FORCE_ROUTE validation share this one table
ROUTES = (ROUTE_PLAIN, ROUTE_NARROW, ROUTE_NARROW_SNAPPY,
          ROUTE_DEVICE_SNAPPY, ROUTE_RECOMPRESS,
          ROUTE_FUSED_PLAIN, ROUTE_FUSED_NARROW_SNAPPY)
# fused route -> the unfused twin whose link bytes / host work it shares
UNFUSED_OF = {ROUTE_FUSED_PLAIN: ROUTE_PLAIN,
              ROUTE_FUSED_NARROW_SNAPPY: ROUTE_NARROW_SNAPPY}
FUSED_OF = {v: k for k, v in UNFUSED_OF.items()}
FUSED_ROUTES = tuple(UNFUSED_OF)

# the reference's planning point for the link (a tunnelled TPU link), kept
# so that route choices match it; TPQ_LINK_MBPS overrides
DEFAULT_LINK_MBPS = 350.0
# host-side throughputs of the native passes
HOST_TRANSCODE_MBPS = 2500.0   # min/max + truncating copy (native)
HOST_COMPRESS_MBPS = 1500.0    # native snappy_compress
HOST_DECOMPRESS_MBPS = 1400.0  # native snappy_decompress (lazy pages only)
# device-side op-table resolve, charged per OUTPUT byte; TPQ_DEVICE_MBPS
# overrides
DEVICE_RESOLVE_MBPS = 3000.0
# a compressed route must beat plain shipping by at least this ratio or the
# plan function falls through (the op tables + resolve cost eat thin wins)
SNAPPY_WORTH_RATIO = 0.92
# streams smaller than this never pay a recompression attempt
MIN_COMPRESS_BYTES = 1 << 16
# assumed compression ratios used only for RANKING (the plan functions
# measure the real ratio and fall back when the estimate was wrong)
EST_NARROW_SNAPPY_RATIO = 0.6
EST_RECOMPRESS_RATIO = 0.5
# inter-stage spill the unfused decode chain pays beyond its resolve term
# (the reference's fused-vs-unfused device prediction; kept for parity of
# the constants, unused by the ranking)
HBM_SPILL_PASSES = 2


def parse_route(raw, *, source: str = "TPQ_FORCE_ROUTE") -> "str | None":
    """Validate a route name from the environment against ``ROUTES``.
    Malformed values degrade to unforced routing with one warning line
    instead of a raise."""
    v = (raw or "").strip()
    if not v:
        return None
    if v not in ROUTES:
        logging.getLogger(__name__).warning(
            "%s=%r is not valid; using %r", source, v,
            "cost-ranked routes (unforced)")
        return None
    return v


def _env_float(name: str, default: float) -> float:
    """``float(os.environ[name])``: unset or blank gives ``default``; a
    malformed value gives ``default`` and one warning line (an environment
    typo never turns a reader construction into a raise)."""
    raw = os.environ.get(name, "").strip()
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        logging.getLogger(__name__).warning(
            "%s=%r is not valid; using %r", name, raw, default)
        return default


@dataclass(frozen=True)
class ChunkFacts:
    """Everything the cost model needs to rank routes for one chunk.

    ``logical`` is the decompressed value-stream byte count (what ``plain``
    would ship); ``width`` the fixed value width (0 for a dictionary value
    table); ``narrow_k`` the stats-hinted narrow byte width when chunk
    Statistics prove the span fits (0 = unknown or infeasible);
    ``narrow_possible`` whether a narrow PROBE is allowed when no hint
    exists (int column + native library); ``comp_bytes`` the file's own
    snappy payload bytes available to ship as-is (0 = none);
    ``host_bytes_ready`` whether the decompressed host bytes already exist —
    when False and ``comp_bytes`` > 0, every host-bytes route additionally
    pays the decompress the lazy pages skipped.  ``flat`` whether the
    column is required and unrepeated (no level lanes) — the fused routes
    claim only flat streams."""

    logical: int
    width: int = 0
    narrow_k: int = 0
    narrow_possible: bool = False
    comp_bytes: int = 0
    native: bool = True
    host_bytes_ready: bool = False
    flat: bool = True


def fused_eligible(f: ChunkFacts) -> "tuple[str, ...]":
    """The fused routes these facts admit (the reference's predicate).  A
    fused row additionally requires its unfused twin to be priced feasible
    (the planner checks that; a forced fused route on a stream its plan
    function cannot claim degrades with a counter)."""
    if not f.flat or f.width not in (4, 8) or f.logical <= 0:
        return ()
    return (ROUTE_FUSED_PLAIN, ROUTE_FUSED_NARROW_SNAPPY)


class ShipPlanner:
    """Ranks ship routes by modelled wall cost; plan functions run in order.

    One instance per reader: reads ``TPQ_LINK_MBPS``, ``TPQ_DEVICE_MBPS`` and
    ``TPQ_FORCE_ROUTE`` at construction."""

    def __init__(self, link_mbps: "float | None" = None,
                 force: "str | None" = None,
                 device_mbps: "float | None" = None):
        if link_mbps is None:
            link_mbps = _env_float("TPQ_LINK_MBPS", DEFAULT_LINK_MBPS)
        self.link_mbps = max(float(link_mbps), 1.0)
        if device_mbps is None:
            device_mbps = _env_float("TPQ_DEVICE_MBPS", DEVICE_RESOLVE_MBPS)
        self.device_mbps = max(float(device_mbps), 1.0)
        if force is None:
            force = parse_route(os.environ.get("TPQ_FORCE_ROUTE", ""))
        elif force not in ROUTES:
            raise ValueError(f"forced route {force!r} not one of {ROUTES}")
        self.force = force

    # -- cost terms (seconds) -------------------------------------------------

    @staticmethod
    def _t(nbytes: float, mbps: float) -> float:
        return nbytes / (mbps * 1e6)

    def _link(self, nbytes: float) -> float:
        return self._t(nbytes, self.link_mbps)

    def costs(self, f: ChunkFacts) -> dict:
        """Modelled seconds per FEASIBLE route (infeasible routes absent).

        Each route costs ``max(host lane, link lane, device lane)``.
        ``plain`` is always present.  The narrow guess (no stats hint) only
        enters when no compressed payload exists."""
        L = float(f.logical)
        mat = (self._t(L, HOST_DECOMPRESS_MBPS)
               if f.comp_bytes and not f.host_bytes_ready else 0.0)
        resolve = self._t(L, self.device_mbps)
        out = {ROUTE_PLAIN: max(mat, self._link(L))}
        if L <= 0:
            return out
        k = f.narrow_k
        if not k and f.narrow_possible and not f.comp_bytes:
            k = max(f.width // 2, 1)  # optimistic probe guess
        if k and f.width in (4, 8) and k < f.width:
            narrowed = L * k / f.width
            out[ROUTE_NARROW] = max(
                mat + self._t(L, HOST_TRANSCODE_MBPS),
                self._link(narrowed),
                self._t(L, self.device_mbps),
            )
            if f.native and narrowed >= MIN_COMPRESS_BYTES:
                out[ROUTE_NARROW_SNAPPY] = max(
                    mat + self._t(L, HOST_TRANSCODE_MBPS)
                    + self._t(narrowed, HOST_COMPRESS_MBPS),
                    self._link(narrowed * EST_NARROW_SNAPPY_RATIO),
                    self._t(L + narrowed, self.device_mbps),
                )
        if f.comp_bytes and f.native:
            out[ROUTE_DEVICE_SNAPPY] = max(
                self._link(float(f.comp_bytes)), resolve)
        if (not f.comp_bytes and f.native and L >= MIN_COMPRESS_BYTES):
            out[ROUTE_RECOMPRESS] = max(
                self._t(L, HOST_COMPRESS_MBPS),
                self._link(L * EST_RECOMPRESS_RATIO),
                resolve,
            )
        # fused rows (always offered: the kernels exist on every device the
        # port accepts): the twin's host and link terms, one single-pass
        # device term; priced only where the twin is feasible
        for fr in fused_eligible(f):
            if UNFUSED_OF[fr] not in out:
                continue
            if fr == ROUTE_FUSED_PLAIN:
                out[fr] = max(mat, self._link(L), resolve)
            else:
                narrowed = L * k / f.width
                out[fr] = max(
                    mat + self._t(L, HOST_TRANSCODE_MBPS)
                    + self._t(narrowed, HOST_COMPRESS_MBPS),
                    self._link(narrowed * EST_NARROW_SNAPPY_RATIO),
                    resolve,
                )
        return out

    def device_costs(self, f: ChunkFacts, routes=None) -> dict:
        """Modelled DEVICE-lane seconds per feasible route (keys match
        :meth:`costs`; ``routes`` skips re-running the feasibility walk).
        ``plain`` models 0; ``narrow_snappy`` resolves over the narrowed
        stream and widens to L; every other route is one output-sized
        pass."""
        c = routes if routes is not None else self.costs(f)
        L = float(f.logical)
        k = f.narrow_k
        if not k and f.narrow_possible and not f.comp_bytes:
            k = max(f.width // 2, 1)
        narrowed = L * k / f.width if (k and f.width) else L
        out = {}
        for r in c:
            if r == ROUTE_PLAIN:
                out[r] = 0.0
            elif r == ROUTE_NARROW_SNAPPY:
                out[r] = self._t(L + narrowed, self.device_mbps)
            else:
                out[r] = self._t(L, self.device_mbps)
        return out

    def routes(self, f: ChunkFacts) -> list:
        """Ordered candidate routes, cheapest modelled cost first; the plan
        functions fall through on infeasibility and ``plain`` ends the
        walk."""
        return self.plan(f)[0]

    def plan(self, f: ChunkFacts) -> "tuple[list, dict]":
        """``(routes, costs)``: the ordered candidates of :meth:`routes`
        plus the modelled seconds per feasible route.  A forced route leads
        with ``plain`` behind it; otherwise the order is by cost, the fused
        variant winning an equal-cost tie."""
        c = self.costs(f)
        if self.force is not None:
            order = ([self.force, ROUTE_PLAIN] if self.force != ROUTE_PLAIN
                     else [ROUTE_PLAIN])
            return order, c
        return sorted(c, key=lambda r: (c[r], r not in UNFUSED_OF,
                                        ROUTES.index(r))), c
