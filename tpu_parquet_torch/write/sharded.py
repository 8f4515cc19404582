"""Sharded writer: N workers encode disjoint row groups, one footer merge.

The write-side mirror of the read pipeline, shaped by the split between
chunk writers and one file writer: encoding a row group —
dictionary build, page cutting, value encoding, compression — is pure CPU
over private data, so N workers do it in parallel; laying the bytes into
the output file and owning the footer is inherently serial, so ONE
file-writer consumer does that.  The seam between them is a position-
independent encoded row group (a complete mini parquet blob), relocated
into place by the footer-merge machinery (:mod:`.merge`).

Mechanics ride the existing spine end to end:

- workers run on :func:`~tpu_parquet_torch.pipeline.prefetch_map`'s bounded,
  ORDERED pool — results arrive in submission order, so the output file's
  row-group order is the input batch order at every worker count (the
  bit-faithfulness acceptance: N-worker output == the single-writer file);
- memory is bounded by :class:`~tpu_parquet_torch.alloc.InFlightBudget`
  (``max_memory``): each batch's estimated bytes are acquired before
  submission and released as the file writer drains it — backpressure,
  not OOM, with stalls booked into :class:`~tpu_parquet_torch.write.WriteStats`;
- every output is published atomically (same-directory temp + fsync +
  ``os.replace``), and the manifest layout flips its generation last, so
  a concurrent reader never sees a torn dataset;
- CRCs follow the ``TPQ_WRITE_CRC`` contract (default ON, mirroring the
  reader's default-on ``TPQ_VALIDATE``) so freshly written files are
  covered by the cheap integrity tier out of the box.

Layouts:

- ``"file"``  — one merged parquet file at ``out`` (row-group relocation
  with corrected offsets; byte-identical to a single ``FileWriter`` run
  over the same batches);
- ``"manifest"`` — ``out`` is a directory: members cut at
  ``target_file_bytes``, then a versioned manifest publish
  (:mod:`.manifest`) makes the set one dataset for ``scan_files`` /
  ``DataLoader``.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass, field

from ..alloc import InFlightBudget
from ..column import ByteArrayData, ColumnData
from ..errors import ParquetError
from ..footer import MAGIC, read_file_metadata, serialize_footer
from ..format import ColumnOrder, FileMetaData, KeyValue, TypeDefinedOrder
from ..obs import env_int
from ..pipeline import prefetch_map
from .manifest import MANIFEST_NAME, write_manifest
from .merge import validate_shard_footer, relocate_row_group
from .stats import WriteStats

__all__ = ["write_sharded", "encode_row_group", "ShardedWriteResult",
           "resolve_write_workers", "DEFAULT_TARGET_FILE_BYTES"]

DEFAULT_TARGET_FILE_BYTES = 128 << 20


def resolve_write_workers(workers=None) -> int:
    """Worker count for the sharded encode pool: explicit argument, else
    ``TPQ_WRITE_WORKERS``, else ``min(cpu_count, 8)``."""
    if workers is not None:
        n = int(workers)
        if n < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        return n
    return env_int("TPQ_WRITE_WORKERS",
                   min(os.cpu_count() or 1, 8), lo=1)


@dataclass
class ShardedWriteResult:
    """What a sharded write produced: the published paths (one for the
    file layout), the manifest (manifest layout), and the totals."""

    paths: list = field(default_factory=list)
    manifest_path: "str | None" = None
    generation: "int | None" = None
    layout: str = "file"
    rows: int = 0
    row_groups: int = 0
    files: int = 0
    bytes_written: int = 0
    stats: "WriteStats | None" = None

    def as_dict(self) -> dict:
        return {
            "layout": self.layout, "rows": self.rows,
            "row_groups": self.row_groups, "files": self.files,
            "bytes_written": self.bytes_written,
            "generation": self.generation,
        }


def _batch_cost(batch: dict) -> int:
    """Estimated in-flight bytes of one batch: raw values + the encoded
    copy the worker materializes (budget accounting, never correctness)."""
    total = 0
    for v in batch.values():
        vals = v.values if isinstance(v, ColumnData) else v
        if isinstance(vals, ByteArrayData):
            total += int(vals.offsets[-1]) if len(vals) else 0
            total += 8 * len(vals)
        elif hasattr(vals, "nbytes"):
            total += int(vals.nbytes)
        else:
            total += 8 * len(vals)
        if isinstance(v, ColumnData):
            total += 8 * v.num_leaf_slots
    return 2 * total + 4096


def encode_row_group(schema, batch: dict, *, stats: "WriteStats | None" = None,
                     **writer_opts) -> "tuple[bytes, FileMetaData]":
    """Encode ONE batch as a complete position-independent parquet blob
    (magic + row group(s) + footer) — the sharded writer's work unit.

    Returns ``(blob, footer)``; the footer has been re-read from the blob
    through :func:`~tpu_parquet_torch.footer.read_file_metadata`, so every
    worker's output passes the same validation a reader would apply
    before the merge trusts its offsets.
    """
    from ..writer import FileWriter

    buf = io.BytesIO()
    with FileWriter(buf, schema, stats=stats, **writer_opts) as w:
        w.write_columns(batch)
    blob = buf.getvalue()
    return blob, read_file_metadata(io.BytesIO(blob))


class _BudgetHooks:
    """The 3-method stats duck prefetch_map feeds (stall/peak/queue-depth),
    adapted onto WriteStats."""

    __slots__ = ("stats",)

    def __init__(self, stats: WriteStats):
        self.stats = stats

    def add_stall(self, seconds: float, t0=None) -> None:
        self.stats.add_stall(seconds)

    def note_peak(self, budget) -> None:
        pass

    def set_queue_depth(self, n: int) -> None:
        pass


class _FilePart:
    """One output file being laid down: MAGIC, relocated row-group spans,
    footer at close.  Writes to a same-directory temp; ``close()``
    publishes via ``os.replace`` (atomic) and returns the final size."""

    def __init__(self, final_path: str, schema, created_by: str,
                 kv_metadata: dict, stats: WriteStats):
        self.final_path = final_path
        self.tmp_path = f"{final_path}.tmp-{os.getpid()}"
        self.schema = schema
        self.created_by = created_by
        self.kv_metadata = dict(kv_metadata or {})
        self.stats = stats
        self._f = open(self.tmp_path, "wb")
        self._f.write(MAGIC)
        self.pos = len(MAGIC)
        self.row_groups: list = []
        self.rows = 0

    def append(self, blob: bytes, meta: FileMetaData) -> None:
        with self.stats.timed("merge"):
            spans = validate_shard_footer(meta, len(blob), label="shard")
        with self.stats.timed("flush", nbytes=len(blob)):
            for rg, (start, end) in spans:
                delta = self.pos - start
                self.row_groups.append(
                    relocate_row_group(rg, delta, len(self.row_groups)))
                self._f.write(blob[start:end])
                self.pos += end - start
                # row/row-group counting happened in the worker's
                # FileWriter (the encode side books the stats); the part
                # only books the file-level publish
                self.rows += int(rg.num_rows or 0)

    def close(self) -> int:
        meta = FileMetaData(
            version=1,
            schema=self.schema.to_flat_elements(),
            num_rows=self.rows,
            row_groups=self.row_groups,
            created_by=self.created_by,
            key_value_metadata=[KeyValue(key=k, value=v)
                                for k, v in self.kv_metadata.items()]
            or None,
            column_orders=[ColumnOrder(TYPE_ORDER=TypeDefinedOrder())
                           for _ in self.schema.leaves],
        )
        with self.stats.timed("flush"):
            self._f.write(serialize_footer(meta))
            self._f.flush()
            os.fsync(self._f.fileno())
            self._f.close()
        os.replace(self.tmp_path, self.final_path)
        size = os.path.getsize(self.final_path)
        self.stats.count_file(size)
        return size

    def abort(self) -> None:
        try:
            self._f.close()
        finally:
            try:
                os.unlink(self.tmp_path)
            except OSError:
                pass


def write_sharded(out, schema, row_groups, *, workers=None, layout=None,
                  target_file_bytes: "int | None" = None,
                  max_memory: int = 0, member_prefix: "str | None" = None,
                  stats: "WriteStats | None" = None, plan_cache=None,
                  **writer_opts) -> ShardedWriteResult:
    """Write ``row_groups`` (an iterable of columnar batches — each batch
    becomes one output row group, ``FileWriter.write_columns`` shapes)
    through ``workers`` parallel encoders into ``out``.

    ``layout`` defaults to ``"manifest"`` when ``out`` is a directory,
    else ``"file"``.  ``writer_opts`` are the :class:`FileWriter` options
    (codec, page_size, write_crc, ...) applied identically by every
    worker; ``write_crc`` follows the ``TPQ_WRITE_CRC`` default-on
    contract.  ``plan_cache`` (a :class:`~tpu_parquet_torch.serve.PlanCache`)
    is notified of every path this write REPLACES — the writer-driven
    generation bump that drops stale cached plans/results the moment the
    publish lands, instead of whenever the next footer open happens by.
    """
    from ..writer import DEFAULT_CREATED_BY, resolve_write_crc

    out = os.fspath(out)
    if layout is None:
        layout = "manifest" if os.path.isdir(out) else "file"
    if layout not in ("file", "manifest"):
        raise ValueError(f"layout must be 'file' or 'manifest', not {layout!r}")
    if layout == "manifest" and not os.path.isdir(out):
        raise ParquetError(f"manifest layout needs a directory, got {out!r}")
    n_workers = resolve_write_workers(workers)
    target = int(target_file_bytes or DEFAULT_TARGET_FILE_BYTES)
    generation = None
    if layout == "manifest":
        # the upcoming generation is fixed BEFORE any member lands so the
        # default member names are generation-unique: a re-write into a
        # live dataset directory must never os.replace the PREVIOUS
        # generation's members before the manifest flips — a reader
        # holding the old manifest would see a mixed-generation dataset
        from .manifest import load_manifest

        mpath = os.path.join(out, MANIFEST_NAME)
        prev_gen = (load_manifest(mpath).generation
                    if os.path.isfile(mpath) else 0)
        generation = prev_gen + 1
        if member_prefix is None:
            member_prefix = f"part-g{generation:04d}"
    elif member_prefix is None:
        member_prefix = "part"
    writer_opts = dict(writer_opts)
    writer_opts["write_crc"] = resolve_write_crc(writer_opts.get("write_crc"))
    created_by = writer_opts.get("created_by", DEFAULT_CREATED_BY)
    kv_metadata = writer_opts.get("kv_metadata") or {}
    st = stats if stats is not None else WriteStats()
    st.touch_wall()
    budget = InFlightBudget(max_memory)

    # fleet seam: adopt the originating request's trace context (if the
    # caller exported one across the process boundary) so encode spans
    # land in a child trace that stitches back under the parent, and arm
    # a writer-role spool snapshot (inert unless TPQ_OBS_SPOOL is set)
    from ..obs_fleet import SpoolWriter, ambient_request_trace

    tr = ambient_request_trace()

    def _spool_tree():
        from ..obs import StatsRegistry

        reg = StatsRegistry()
        reg.add_write(st)
        return reg

    spool = SpoolWriter(
        _spool_tree, role="writer",
        sampler=lambda: [tr.as_dict()] if tr is not None else [])

    def encode(batch):
        if tr is not None:
            with tr.span("encode", role="writer"):
                return encode_row_group(schema, batch, stats=st,
                                        **writer_opts)
        return encode_row_group(schema, batch, stats=st, **writer_opts)

    # prefetch == requested worker count, so the pool never exceeds it (a
    # deeper window would double the thread count behind the caller's
    # back); prefetch_map additionally caps the POOL at cpu_count (its
    # GIL-convoy guard) while keeping the window's lookahead — WriteStats
    # reports the EFFECTIVE pool size, never a count that didn't run
    st.workers = max(st.workers,
                     max(1, min(n_workers, os.cpu_count() or 1)))
    results = prefetch_map(
        row_groups, encode, prefetch=n_workers if n_workers > 1 else 0,
        budget=budget if max_memory else None,
        cost=_batch_cost if max_memory else None,
        stats=_BudgetHooks(st))

    res = ShardedWriteResult(layout=layout, stats=st)
    part: "_FilePart | None" = None
    member_paths: list = []
    replaced: list = []
    total_rows = total_rgs = 0

    def open_part(path: str) -> _FilePart:
        if os.path.exists(path):
            replaced.append(path)
        return _FilePart(path, schema, created_by, kv_metadata, st)

    spool.start()
    try:
        for blob, meta in results:
            if part is None:
                if layout == "file":
                    part = open_part(out)
                else:
                    path = os.path.join(
                        out, f"{member_prefix}-{len(member_paths):05d}"
                             ".parquet")
                    part = open_part(path)
            part.append(blob, meta)
            if layout == "manifest" and part.pos >= target:
                member_paths.append(part.final_path)
                total_rows += part.rows
                total_rgs += len(part.row_groups)
                part.close()
                part = None
        if part is None and layout == "file":
            raise ParquetError("write_sharded: no row groups to write")
        if part is not None:
            member_paths.append(part.final_path)
            total_rows += part.rows
            total_rgs += len(part.row_groups)
            part.close()
            part = None
    except BaseException:
        if part is not None:
            part.abort()
        raise
    finally:
        spool.stop()  # publishes a final generation, joins (no leak)

    res.paths = member_paths
    if layout == "manifest":
        if not member_paths:
            raise ParquetError("write_sharded: no row groups to write")
        m = write_manifest(out, member_paths, generation=generation,
                           created_by=created_by)
        res.manifest_path = os.path.join(out, MANIFEST_NAME)
        res.generation = m.generation
    if plan_cache is not None:
        for p in replaced:
            plan_cache.note_mutation(p)
    st.touch_wall()
    res.rows = total_rows
    res.row_groups = total_rgs
    res.files = len(member_paths)
    res.bytes_written = sum(os.path.getsize(p) for p in member_paths)
    return res
