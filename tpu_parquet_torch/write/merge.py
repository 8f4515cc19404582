"""Footer merge: stitch N shard parquet files into one, data bytes untouched.

A parquet writer splits into chunk writers that own the bytes and a file
writer that owns the footer; this module is that seam at dataset scale.  A shard's encoded row group is position-independent — page
headers carry no absolute offsets — so merging N shards is a *metadata*
operation: copy each row group's contiguous byte span into the output in
order and shift every footer offset by the relocation delta.  No re-encode,
no re-compress, no CRC recompute (the page CRCs ride along byte-identical).

Two layers, deliberately separated so the math is testable without IO:

- :func:`merge_footers` — pure: ``[(FileMetaData, file_size), ...]`` in,
  ``(merged FileMetaData, copy spans)`` out.  Validates every shard footer
  through the SAME :func:`~tpu_parquet_torch.scanplan.row_group_byte_span` walk
  the readers use, so a truncated or lying shard (chunk spans past EOF,
  overlapping row groups, ``num_rows`` disagreeing with its groups, a
  schema that doesn't match shard 0's) is rejected with a typed
  :class:`~tpu_parquet_torch.errors.ParquetError` — never silently merged.
- :func:`merge_files` — the IO half: stream the spans (1 MiB blocks) and
  write the merged footer.

Merged output invariants (held by construction): row count is the sum of the shards', row groups keep shard order
with globally renumbered ordinals, relocated chunk spans are ascending and
disjoint, and every relocated offset lands inside the output data segment.
"""

from __future__ import annotations

import copy
import os
from typing import BinaryIO, Union

from ..errors import ParquetError
from ..footer import FOOTER_TAIL, MAGIC, read_file_metadata, serialize_footer
from ..format import ColumnOrder, FileMetaData, KeyValue, TypeDefinedOrder
from ..scanplan import row_group_byte_span
from ..schema.core import Schema
from ..thrift import serialize

__all__ = ["merge_footers", "merge_files", "relocate_row_group",
           "validate_shard_footer"]

_COPY_BLOCK = 1 << 20


def _schema_sig(meta: FileMetaData) -> tuple:
    """Byte-stable signature of a footer's flat schema element list (thrift
    serialization per element — field-for-field equality, no name games)."""
    return tuple(serialize(se) for se in (meta.schema or []))


def validate_shard_footer(meta: FileMetaData, file_size: int,
                          *, label: str = "shard") -> list:
    """Validate one shard's footer for merging; returns its row groups'
    ``(row_group, (start, end))`` spans in footer order.

    Typed rejections (all :class:`ParquetError`): chunk spans that start
    before the head magic or run past the data segment (a truncated or
    lying shard), row groups whose spans overlap (double-counted bytes),
    and a footer ``num_rows`` that disagrees with its groups' sum.
    """
    schema = Schema.from_file_metadata(meta)
    leaves = {l.path: l for l in schema.leaves}
    data_end = int(file_size) - FOOTER_TAIL
    spans = []
    rows = 0
    for i, rg in enumerate(meta.row_groups or []):
        start, end = row_group_byte_span(rg, leaves)
        if start < len(MAGIC):
            raise ParquetError(
                f"{label}: row group {i} chunk span starts at {start}, "
                f"inside the head magic")
        if end > data_end:
            raise ParquetError(
                f"{label}: row group {i} chunk span ends at {end}, past "
                f"the data segment end {data_end} (truncated or lying "
                f"shard footer)")
        if int(rg.num_rows or 0) < 0:
            raise ParquetError(
                f"{label}: row group {i} has negative num_rows")
        rows += int(rg.num_rows or 0)
        spans.append((rg, (start, end)))
    ordered = sorted(s for _rg, s in spans)
    for (_s0, e0), (s1, _e1) in zip(ordered, ordered[1:]):
        if s1 < e0:
            raise ParquetError(
                f"{label}: row group byte spans overlap "
                f"([..{e0}) vs [{s1}..))")
    if meta.num_rows is not None and int(meta.num_rows) != rows:
        raise ParquetError(
            f"{label}: footer num_rows {meta.num_rows} != row-group sum "
            f"{rows} (lying shard footer)")
    return spans


def relocate_row_group(rg, delta: int, ordinal: int):
    """A deep copy of ``rg`` with every absolute file offset shifted by
    ``delta`` and the ordinal renumbered.  Page/column index and bloom
    filter offsets are CLEARED, not shifted — the merge copies only the
    row groups' chunk spans, so bytes those offsets point at are not in
    the output."""
    out = copy.deepcopy(rg)
    out.ordinal = ordinal
    if out.file_offset is not None:
        out.file_offset += delta
    for chunk in out.columns or []:
        if chunk.file_offset is not None:
            chunk.file_offset += delta
        chunk.offset_index_offset = None
        chunk.offset_index_length = None
        chunk.column_index_offset = None
        chunk.column_index_length = None
        md = chunk.meta_data
        if md is None:
            continue
        if md.data_page_offset is not None:
            md.data_page_offset += delta
        if md.dictionary_page_offset is not None:
            md.dictionary_page_offset += delta
        md.index_page_offset = None
        md.bloom_filter_offset = None
    return out


def merge_footers(parts, *, created_by=None, kv_metadata=None):
    """The pure footer-merge: ``parts`` is ``[(FileMetaData, file_size)]``.

    Returns ``(merged FileMetaData, spans)`` where ``spans`` is the copy
    plan ``[(part_index, src_start, src_end), ...]`` in output order —
    the caller lays the output down as ``MAGIC + spans' bytes + footer``.

    Every shard is validated (:func:`validate_shard_footer`); shards after
    the first must carry a byte-identical flat schema (a column added or
    retyped between shards is a merge error, not a cast).  ``created_by``
    defaults to the shards' common value when they agree, else the
    writer's own; key-value metadata is the union in part order (later
    shards win), overridable via ``kv_metadata``.
    """
    if not parts:
        raise ParquetError("merge needs at least one input file")
    sig0 = None
    merged_rgs = []
    spans = []
    kv: dict = {}
    creators = set()
    total_rows = 0
    pos = len(MAGIC)
    version = 1
    for idx, (meta, size) in enumerate(parts):
        if not isinstance(meta, FileMetaData):
            raise ParquetError(f"part {idx}: not a parquet footer")
        sig = _schema_sig(meta)
        if not sig:
            raise ParquetError(f"part {idx}: footer has no schema elements")
        if sig0 is None:
            sig0 = sig
        elif sig != sig0:
            raise ParquetError(
                f"part {idx}: schema does not match part 0's (merge "
                f"requires byte-identical flat schemas)")
        rg_spans = validate_shard_footer(meta, size, label=f"part {idx}")
        for rg, (start, end) in rg_spans:
            delta = pos - start
            merged_rgs.append(relocate_row_group(rg, delta,
                                                 len(merged_rgs)))
            spans.append((idx, start, end))
            pos += end - start
            total_rows += int(rg.num_rows or 0)
        for pair in meta.key_value_metadata or []:
            kv[pair.key] = pair.value
        if meta.created_by:
            creators.add(meta.created_by)
        version = max(version, int(meta.version or 1))
    if kv_metadata:
        kv.update(kv_metadata)
    if created_by is None:
        from ..writer import DEFAULT_CREATED_BY

        created_by = (creators.pop() if len(creators) == 1
                      else DEFAULT_CREATED_BY)
    first_meta = parts[0][0]
    n_leaves = len(Schema.from_file_metadata(first_meta).leaves)
    merged = FileMetaData(
        version=version,
        schema=copy.deepcopy(first_meta.schema),
        num_rows=total_rows,
        row_groups=merged_rgs,
        created_by=created_by,
        key_value_metadata=[KeyValue(key=k, value=v)
                            for k, v in kv.items()] or None,
        column_orders=[ColumnOrder(TYPE_ORDER=TypeDefinedOrder())
                       for _ in range(n_leaves)],
    )
    return merged, spans


def _copy_span(src: BinaryIO, dst: BinaryIO, start: int, end: int) -> int:
    src.seek(start)
    left = end - start
    while left > 0:
        block = src.read(min(left, _COPY_BLOCK))
        if not block:
            raise ParquetError(
                f"short read copying span [{start}, {end}): file truncated "
                f"under the merge")
        dst.write(block)
        left -= len(block)
    return end - start


def merge_files(out: Union[str, os.PathLike], inputs, *, created_by=None,
                kv_metadata=None, stats=None) -> FileMetaData:
    """Merge ``inputs`` (paths) into one parquet file at ``out`` — data
    bytes relocated, never re-encoded; published atomically (temp +
    ``os.replace``).  Returns the merged footer.  ``stats`` (a
    :class:`~tpu_parquet_torch.write.WriteStats`) books the wall into the
    ``merge`` lane."""
    from .stats import WriteStats

    st = stats if stats is not None else WriteStats()
    paths = [os.fspath(p) for p in inputs]
    if not paths:
        raise ParquetError("merge needs at least one input file")
    parts = []
    for p in paths:
        size = os.path.getsize(p)
        parts.append((read_file_metadata(p), size))
    with st.timed("merge", files=len(paths)):
        merged, spans = merge_footers(parts, created_by=created_by,
                                      kv_metadata=kv_metadata)
    out = os.fspath(out)
    tmp = f"{out}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as dst:
            dst.write(MAGIC)
            handles = {}
            try:
                with st.timed("flush"):
                    for idx, start, end in spans:
                        f = handles.get(idx)
                        if f is None:
                            f = handles[idx] = open(paths[idx], "rb")
                        _copy_span(f, dst, start, end)
                    dst.write(serialize_footer(merged))
                    dst.flush()
                    os.fsync(dst.fileno())
            finally:
                for f in handles.values():
                    f.close()
        os.replace(tmp, out)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    st.count_file(os.path.getsize(out))
    st.touch_wall()
    return merged
