"""WriteStats: the write-side twin of pipeline.PipelineStats.

The read path attributes a slow scan to a lane (io / decompress / stage /
...) through the registry ``pipeline`` section; until this module a slow
WRITE was a black box — encode, compress, and sink flushes all hid inside
one wall clock.  WriteStats splits the writer into the three lanes the
sharded writer actually overlaps, plus the two dataset-level passes:

- ``encode``    value encoding + page cutting + dictionary build (CPU,
                compress excluded — the ChunkEncoder subtracts it)
- ``compress``  the codec passes over page payloads (GIL-released for
                snappy/zlib, so worker threads genuinely overlap here)
- ``flush``     sink writes: page parts, footers, fsync at publish
- ``merge``     footer-merge stitching (relocation + span copies)
- ``compact``   compaction passes (decode + re-batch bookkeeping)

``as_dict()`` feeds ``StatsRegistry.add_write`` (the registry ``write``
section, under the same keys as the JAX package's) so
``obs.doctor_registry`` can attribute a slow write the way it already
attributes a slow read.  Each ``timed`` stage also emits a ``write.<stage>`` span on the
process tracer, so ``TPQ_TRACE`` artifacts show writer lanes in Perfetto.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager

from ..obs import (LatencyHistogram, current_tracer, register_flight_source)

__all__ = ["WriteStats", "WRITE_STAGES"]

WRITE_STAGES = ("encode", "compress", "flush", "merge", "compact")

# per-instance flight-source token (several writers can be live at once —
# a dump must show each one's lanes, same discipline as PipelineStats)
_wstats_ids = itertools.count(1)


class WriteStats:
    """Per-stage timing + throughput counters for the write path.

    Thread-safe: the sharded writer's encode workers and its file-writer
    consumer add concurrently.  ``stall_seconds`` counts submitter time
    blocked on the in-flight memory budget (backpressure, exactly the
    read pipeline's meaning).  ``merge_from`` composes (a compaction run
    folds its member writers' stats into one report).
    """

    def __init__(self, workers: int = 0, tracer=None):
        self.workers = int(workers)
        self.rows = 0
        self.row_groups = 0
        self.chunks = 0
        self.files = 0
        self.bytes_written = 0
        self.stall_seconds = 0.0
        self.wall_seconds = 0.0
        self._stage_seconds = {s: 0.0 for s in WRITE_STAGES}
        self._stage_hist = {s: LatencyHistogram() for s in WRITE_STAGES}
        self.tracer = tracer if tracer is not None else current_tracer()
        self._lock = threading.Lock()
        self._t0 = None
        register_flight_source(f"write[{next(_wstats_ids)}]", self, "sample")

    # -- accumulation ---------------------------------------------------------

    def add(self, stage: str, seconds: float) -> None:
        if stage not in self._stage_seconds:
            raise ValueError(
                f"unknown write stage {stage!r}; valid stages: "
                f"{', '.join(WRITE_STAGES)}")
        with self._lock:
            self._stage_seconds[stage] += seconds
        self._stage_hist[stage].record(seconds)

    @contextmanager
    def timed(self, stage: str, **span_args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.add(stage, t1 - t0)
            tr = self.tracer
            if tr is not None and tr.active:
                tr.complete(f"write.{stage}", t0, t1, **span_args)

    def add_stall(self, seconds: float) -> None:
        with self._lock:
            self.stall_seconds += seconds

    def count_row_group(self, rows: int, chunks: int = 0) -> None:
        with self._lock:
            self.row_groups += 1
            self.rows += int(rows)
            self.chunks += int(chunks)

    def count_file(self, nbytes: int) -> None:
        with self._lock:
            self.files += 1
            self.bytes_written += int(nbytes)

    def touch_wall(self) -> None:
        now = time.perf_counter()
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self.wall_seconds = now - self._t0

    # -- composition ----------------------------------------------------------

    def merge_from(self, other: "WriteStats") -> None:
        """Fold another writer's counters in: seconds/counts add, workers
        max (the compose case is member writers of one dataset run), the
        wall clock stays this object's own."""
        with other._lock:
            stages = dict(other._stage_seconds)
            vals = (other.rows, other.row_groups, other.chunks, other.files,
                    other.bytes_written, other.stall_seconds, other.workers)
        with self._lock:
            for s, v in stages.items():
                self._stage_seconds[s] += v
            (rows, rgs, chunks, files, bw, stall, workers) = vals
            self.rows += rows
            self.row_groups += rgs
            self.chunks += chunks
            self.files += files
            self.bytes_written += bw
            self.stall_seconds += stall
            self.workers = max(self.workers, workers)
        for s in WRITE_STAGES:
            self._stage_hist[s].merge_from(other._stage_hist[s])

    # -- reporting ------------------------------------------------------------

    def stage_seconds(self, stage: str) -> float:
        with self._lock:
            return self._stage_seconds[stage]

    @property
    def busy_seconds(self) -> float:
        with self._lock:
            return sum(self._stage_seconds.values())

    def sample(self) -> dict:
        """Point-in-time snapshot for the flight recorder / Sampler: the
        cumulative per-stage seconds plus live progress counters."""
        with self._lock:
            out = {s: round(v, 6) for s, v in self._stage_seconds.items()}
            out["rows"] = self.rows
            out["row_groups"] = self.row_groups
            out["bytes_written"] = self.bytes_written
        return out

    def as_dict(self) -> dict:
        with self._lock:
            stages = {f"{s}_seconds": round(v, 6)
                      for s, v in self._stage_seconds.items()}
            out = {
                "workers": self.workers,
                "rows": self.rows,
                "row_groups": self.row_groups,
                "chunks": self.chunks,
                "files": self.files,
                "bytes_written": self.bytes_written,
                **stages,
                "stall_seconds": round(self.stall_seconds, 6),
                "wall_seconds": round(self.wall_seconds, 6),
            }
        out["busy_seconds"] = round(self.busy_seconds, 6)
        # only the stages that saw work (same artifact-size discipline as
        # PipelineStats.as_dict)
        out["stage_histograms"] = {s: h.as_dict()
                                   for s, h in self._stage_hist.items()
                                   if h.count}
        return out
