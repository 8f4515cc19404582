"""Compaction: many small files → few large, re-planned for cheap shipping.

A loader-output → transform → write-back workload leaves datasets shaped
like their producers: hundreds of small files with small row groups, each
paying footer/plan/open overhead per scan and defeating the ship planner's
per-chunk routes (tiny chunks never amortize an op table).  Compaction
rewrites such a dataset into few large files with large row groups:

- the output **codec is re-planned through the ship planner's cost table**
  (:class:`~tpu_parquet_torch.ship.ShipPlanner`): per column, the modeled
  bottleneck-lane cost of shipping a snappy-paged file (the
  ``device_snappy`` route decompresses on device, shipping only the
  compressed bytes) is compared against shipping plain host bytes, using
  a measured compression-ratio sample of the actual data — so compacted
  output is cheap to ship back to the device, not just small on disk;
- **CRCs are always written** (``write_crc=True``, overriding even
  ``TPQ_WRITE_CRC=0``) so the readers' default-on validation covers the
  output;
- publish is **atomic and generation-bumped**: members land by temp +
  ``os.replace``, the manifest flips last
  (:func:`~tpu_parquet_torch.write.manifest.write_manifest`), and a
  :class:`~tpu_parquet_torch.serve.PlanCache` passed in is notified of every
  replaced path — a reader or serve sweep running concurrently never
  sees a torn or stale dataset.

:class:`CompactionService` wraps the policy half: "compact when the
dataset has accumulated more than N undersized files", the run-once unit
a maintenance loop calls.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..errors import ParquetError
from ..footer import read_file_metadata
from ..format import CompressionCodec, Type
from ..schema.core import Schema
from ..ship import (ChunkFacts, EST_NARROW_SNAPPY_RATIO,
                    EST_RECOMPRESS_RATIO, ROUTE_DEVICE_SNAPPY, ROUTE_NARROW,
                    ROUTE_NARROW_SNAPPY, ROUTE_PLAIN, ROUTE_RECOMPRESS,
                    ShipPlanner, UNFUSED_OF)
from .manifest import expand_dataset
from .merge import _schema_sig
from .sharded import DEFAULT_TARGET_FILE_BYTES, write_sharded
from .stats import WriteStats

__all__ = ["compact", "CompactionReport", "CompactionService",
           "plan_codec", "modeled_link_bytes", "column_facts"]

_WIDTHS = {Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4, Type.DOUBLE: 8}
_SAMPLE_BYTES = 1 << 20


@dataclass
class CompactionReport:
    files_before: int = 0
    files_after: int = 0
    bytes_before: int = 0
    bytes_after: int = 0
    row_groups_before: int = 0
    row_groups_after: int = 0
    rows: int = 0
    codec: int = int(CompressionCodec.SNAPPY)
    link_bytes_before: int = 0
    link_bytes_after: int = 0
    manifest_path: "str | None" = None
    generation: "int | None" = None
    out_paths: list = field(default_factory=list)
    stats: "WriteStats | None" = None

    @property
    def link_bytes_ratio(self) -> float:
        """Planner-modeled shipped bytes, after/before — <1 means the
        compacted dataset is cheaper to put on the device link."""
        if not self.link_bytes_before:
            return 1.0
        return self.link_bytes_after / self.link_bytes_before

    def as_dict(self) -> dict:
        return {
            "files_before": self.files_before,
            "files_after": self.files_after,
            "bytes_before": self.bytes_before,
            "bytes_after": self.bytes_after,
            "row_groups_before": self.row_groups_before,
            "row_groups_after": self.row_groups_after,
            "rows": self.rows,
            "codec": self.codec,
            "link_bytes_before": self.link_bytes_before,
            "link_bytes_after": self.link_bytes_after,
            "link_bytes_ratio": round(self.link_bytes_ratio, 4),
            "generation": self.generation,
        }


# ---------------------------------------------------------------------------
# ship-planner replanning
# ---------------------------------------------------------------------------

def column_facts(metas, schema: Schema, leaf, *,
                 snappy_paged: bool) -> ChunkFacts:
    """Whole-DATASET ChunkFacts for one column, from the footers alone
    (``metas`` is one FileMetaData or a list of them): ``logical`` is the
    uncompressed value-stream total, ``comp_bytes`` the files' own
    compressed payload total when their pages are snappy (the
    ``device_snappy`` route's input)."""
    if not isinstance(metas, (list, tuple)):
        metas = [metas]
    logical = comp = 0
    path = leaf.path
    for meta in metas:
        for rg in meta.row_groups or []:
            for cc in rg.columns or []:
                md = cc.meta_data
                if md is None or tuple(md.path_in_schema or ()) != path:
                    continue
                logical += int(md.total_uncompressed_size or 0)
                comp += int(md.total_compressed_size or 0)
    width = _WIDTHS.get(leaf.physical_type, 0)
    return ChunkFacts(
        logical=logical,
        width=width,
        narrow_possible=width in (4, 8),
        comp_bytes=comp if snappy_paged else 0,
        host_bytes_ready=not snappy_paged,
        flat=(leaf.max_rep == 0 and leaf.max_def == 0),
    )


def modeled_link_bytes(planner: ShipPlanner, f: ChunkFacts) -> int:
    """The link bytes the planner's BEST route for ``f`` would ship — the
    per-route shipped-byte terms of :meth:`ShipPlanner.costs`, applied to
    the winning route (estimates where costs() estimates: the compressed
    routes use the same assumed ratios the ranking used)."""
    routes, _costs = planner.plan(f)
    best = UNFUSED_OF.get(routes[0], routes[0]) if routes else ROUTE_PLAIN
    L = float(f.logical)
    k = f.narrow_k
    if not k and f.narrow_possible and not f.comp_bytes:
        k = max(f.width // 2, 1)
    narrowed = L * k / f.width if (k and f.width) else L
    if best == ROUTE_NARROW:
        return int(narrowed)
    if best == ROUTE_NARROW_SNAPPY:
        return int(narrowed * EST_NARROW_SNAPPY_RATIO)
    if best == ROUTE_DEVICE_SNAPPY:
        return int(f.comp_bytes)
    if best == ROUTE_RECOMPRESS:
        return int(L * EST_RECOMPRESS_RATIO)
    return int(L)


def _sample_snappy_ratio(columns: dict) -> float:
    """Measured compression ratio over a bounded sample of the decoded
    first batch (the honest input to the codec decision — assumed ratios
    are for ranking, the codec choice gets real bytes)."""
    from ..column import ByteArrayData, ColumnData
    from ..compress import compress_block

    raw_total = comp_total = 0
    for v in columns.values():
        vals = v.values if hasattr(v, "values") else v
        if isinstance(vals, ByteArrayData):
            raw = bytes(vals.heap[:_SAMPLE_BYTES])
        elif hasattr(vals, "tobytes"):
            raw = vals.tobytes()[:_SAMPLE_BYTES]
        else:
            continue
        if not raw:
            continue
        try:
            comp = compress_block(raw, int(CompressionCodec.SNAPPY))
        except Exception:  # noqa: BLE001 — no snappy on this host
            return 1.0
        raw_total += len(raw)
        comp_total += len(comp)
    return (comp_total / raw_total) if raw_total else 1.0


def plan_codec(planner: ShipPlanner, metas, schema: Schema,
               ratio: float) -> "tuple[int, int, int]":
    """The compacted output's codec, re-planned through the ship cost
    table over the WHOLE dataset's footers (``metas``): per column,
    modeled bottleneck-lane seconds for a snappy-paged output
    (``comp_bytes`` = measured-ratio estimate) vs a plain one; the
    cheaper total wins.  Returns ``(codec, link_bytes_snappy,
    link_bytes_plain)`` — the modeled link bytes ride the report."""
    cost_snappy = cost_plain = 0.0
    link_snappy = link_plain = 0
    for leaf in schema.leaves:
        base = column_facts(metas, schema, leaf, snappy_paged=False)
        if base.logical <= 0:
            continue
        est_comp = max(int(base.logical * min(ratio, 1.0)), 1)
        fs = ChunkFacts(
            logical=base.logical, width=base.width,
            narrow_possible=base.narrow_possible, comp_bytes=est_comp,
            host_bytes_ready=False, flat=base.flat)
        cs, cp = planner.costs(fs), planner.costs(base)
        cost_snappy += min(cs.values())
        cost_plain += min(cp.values())
        link_snappy += modeled_link_bytes(planner, fs)
        link_plain += modeled_link_bytes(planner, base)
    codec = (int(CompressionCodec.SNAPPY) if cost_snappy <= cost_plain
             else int(CompressionCodec.UNCOMPRESSED))
    return codec, link_snappy, link_plain


# ---------------------------------------------------------------------------
# the compaction pass
# ---------------------------------------------------------------------------

def _batches(paths, target_rg_bytes, stats):
    """Re-batch the inputs' decoded row groups into target-sized output
    row groups (the column-layout half of replanning: many tiny groups
    in, few large groups out).  Decode runs in the consumer thread of the
    sharded writer's pool — encode overlaps it."""
    from ..reader import FileReader, _concat_column_data

    pending: "dict[str, list] | None" = None
    pending_bytes = 0

    def est_bytes(cols: dict) -> int:
        total = 0
        for cd in cols.values():
            vals = cd.values
            if hasattr(vals, "heap"):
                total += len(vals.heap) + 8 * len(vals)
            elif hasattr(vals, "nbytes"):
                total += int(vals.nbytes)
        return total

    def flush(parts: dict) -> dict:
        # ONE concat per output group: pairwise concatenation per input
        # group would copy the growing pending set O(G^2) times over —
        # exactly wrong for the many-tiny-groups workload compaction is for
        return {k: v[0] if len(v) == 1 else _concat_column_data(v)
                for k, v in parts.items()}

    for path in paths:
        with FileReader(path) as r:
            for gi in range(r.num_row_groups):
                with stats.timed("compact", file=os.path.basename(path),
                                 row_group=gi):
                    cols = r.read_row_group(gi)
                if pending is None:
                    pending = {k: [v] for k, v in cols.items()}
                else:
                    for k, v in cols.items():
                        pending[k].append(v)
                pending_bytes += est_bytes(cols)
                if pending_bytes >= target_rg_bytes:
                    yield flush(pending)
                    pending, pending_bytes = None, 0
    if pending is not None:
        yield flush(pending)


def compact(dataset, out=None, *, target_file_bytes: "int | None" = None,
            target_row_group_bytes: "int | None" = None, workers=None,
            planner: "ShipPlanner | None" = None, plan_cache=None,
            codec: "int | None" = None, remove_inputs: bool = False,
            stats: "WriteStats | None" = None) -> CompactionReport:
    """Compact ``dataset`` (a manifest path/directory, or an iterable of
    parquet paths) into few large files under ``out`` (default: the
    dataset's own directory), publishing a bumped-generation manifest.

    ``codec=None`` re-plans the output codec through ``planner``'s cost
    table (:func:`plan_codec`); CRCs are always written.  With
    ``remove_inputs=True`` superseded member files are unlinked AFTER the
    manifest flip (readers holding the previous manifest generation
    should be drained first — the default leaves them in place).
    ``plan_cache`` receives :meth:`~tpu_parquet_torch.serve.PlanCache.
    note_mutation` for every path this pass replaces or removes.
    """
    paths, manifest = expand_dataset(dataset)
    if not paths:
        raise ParquetError("compact: empty dataset")
    if out is None:
        out = (os.path.dirname(manifest.path) if manifest is not None
               else os.path.dirname(os.path.abspath(paths[0])))
    out = os.fspath(out)
    if not os.path.isdir(out):
        raise ParquetError(f"compact: output {out!r} is not a directory")
    st = stats if stats is not None else WriteStats()
    st.touch_wall()
    target = int(target_file_bytes or DEFAULT_TARGET_FILE_BYTES)
    rg_target = int(target_row_group_bytes or min(target, 128 << 20))
    pl = planner if planner is not None else ShipPlanner()

    metas = [read_file_metadata(p) for p in paths]
    sig0 = _schema_sig(metas[0])
    for i, m in enumerate(metas[1:], 1):
        if _schema_sig(m) != sig0:
            raise ParquetError(
                f"compact: {paths[i]!r} schema does not match {paths[0]!r}")
    schema = Schema.from_file_metadata(metas[0])
    report = CompactionReport(stats=st)
    report.files_before = len(paths)
    report.bytes_before = sum(os.path.getsize(p) for p in paths)
    report.row_groups_before = sum(len(m.row_groups or []) for m in metas)

    # the planner's view of the INPUT dataset: best-route link bytes per
    # column per file, from the footers alone
    for m, p in zip(metas, paths):
        snappy_paged = all(
            int(cc.meta_data.codec or 0) == int(CompressionCodec.SNAPPY)
            for rg in (m.row_groups or []) for cc in (rg.columns or [])
            if cc.meta_data is not None)
        for leaf in schema.leaves:
            f = column_facts(m, schema, leaf, snappy_paged=snappy_paged)
            if f.logical > 0:
                report.link_bytes_before += modeled_link_bytes(pl, f)

    # codec replanning needs a measured ratio: decode the first group once
    # (cheap relative to the full pass, and the decode is re-used as the
    # sample only — the batch generator re-reads it through the reader)
    from ..reader import FileReader

    # the ratio sample comes from the first NON-EMPTY member (a valid
    # footer-only file contributes no groups and must not abort the pass)
    sample_path = next(
        (p for p, m in zip(paths, metas) if m.row_groups), None)
    if sample_path is None:
        raise ParquetError("compact: dataset has no row groups")
    with FileReader(sample_path) as r0:
        sample = r0.read_row_group(0)
    ratio = _sample_snappy_ratio(sample)
    if codec is None:
        # planned over the WHOLE dataset's footers (the first file alone
        # could be an unrepresentative runt); the ratio sample is bounded
        # to the first group by design — it feeds an estimate, the cost
        # table weighs it against every column's real byte totals
        codec, _ls, _lp = plan_codec(pl, metas, schema, ratio)
    report.codec = int(codec)

    # member names are generation-unique (write_sharded's default prefix),
    # so this pass never replaces a live generation's members — the
    # manifest flip is the only visible transition
    res = write_sharded(
        out, schema,
        _batches(paths, rg_target, st),
        workers=workers, layout="manifest", target_file_bytes=target,
        stats=st, plan_cache=plan_cache,
        codec=int(codec), write_crc=True,  # ALWAYS: the integrity tier
                                           # must cover compacted output
    )
    report.files_after = res.files
    report.bytes_after = res.bytes_written
    report.rows = res.rows
    report.row_groups_after = res.row_groups
    report.out_paths = list(res.paths)
    report.manifest_path = res.manifest_path
    report.generation = res.generation

    for p in res.paths:
        m = read_file_metadata(p)
        snappy_paged = int(codec) == int(CompressionCodec.SNAPPY)
        for leaf in schema.leaves:
            f = column_facts(m, schema, leaf, snappy_paged=snappy_paged)
            if f.logical > 0:
                report.link_bytes_after += modeled_link_bytes(pl, f)

    if remove_inputs:
        survivors = set(os.path.abspath(p) for p in res.paths)
        for p in paths:
            if os.path.abspath(p) in survivors:
                continue
            try:
                os.unlink(p)
            except OSError:
                continue
            if plan_cache is not None:
                plan_cache.note_mutation(p)
    st.touch_wall()
    return report


class CompactionService:
    """The policy half: compact a dataset when it has fragmented.

    ``run_once`` is the maintenance-loop unit: it inspects the dataset,
    and when more than ``max_small_files`` members are under
    ``min_file_bytes`` it runs one :func:`compact` pass (atomic publish,
    generation bump) and returns the report — else ``None``.  Stateless
    between calls; safe to run while readers and a serve tier sweep the
    same dataset (that concurrency is exactly the compaction contract)."""

    def __init__(self, *, min_file_bytes: int = 4 << 20,
                 max_small_files: int = 16, target_file_bytes=None,
                 workers=None, planner=None, plan_cache=None,
                 remove_inputs: bool = False):
        self.min_file_bytes = int(min_file_bytes)
        self.max_small_files = int(max_small_files)
        self.target_file_bytes = target_file_bytes
        self.workers = workers
        self.planner = planner
        self.plan_cache = plan_cache
        self.remove_inputs = remove_inputs

    def should_compact(self, dataset) -> bool:
        try:
            paths, _m = expand_dataset(dataset)
        except ParquetError:
            return False
        small = sum(1 for p in paths
                    if os.path.getsize(p) < self.min_file_bytes)
        return small > self.max_small_files

    def run_once(self, dataset, **kw) -> "CompactionReport | None":
        if not self.should_compact(dataset):
            return None
        return compact(
            dataset,
            target_file_bytes=self.target_file_bytes,
            workers=self.workers, planner=self.planner,
            plan_cache=self.plan_cache,
            remove_inputs=self.remove_inputs, **kw)
