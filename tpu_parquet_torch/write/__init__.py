"""tpu_parquet_torch.write: the write side at dataset scale.

Three layers over the low-level :class:`~tpu_parquet_torch.writer.FileWriter`:

- :func:`write_sharded` — N workers encode disjoint row-group sets
  through the existing ``FileWriter``/``chunk_encode`` path (the chunk
  writers), one footer-merge consumer stitches a single file or a
  manifest-indexed file set (the file writer);
- :mod:`~tpu_parquet_torch.write.merge` /
  :mod:`~tpu_parquet_torch.write.manifest` — the footer-merge math (pure,
  no IO) and the versioned atomic-publish manifest readers consume as one
  dataset;
- :func:`compact` / :class:`CompactionService` — many small files → few
  large, codec re-planned through the ship planner so compacted output
  is cheap to ship back to the device, CRCs always written, atomic
  publish + generation bump so concurrent readers never see a torn or
  stale dataset.

Observability rides :class:`WriteStats` into the registry ``write``
section (``obs.doctor_registry`` attributes slow writes);
``TPQ_WRITE_CRC`` (default ON) mirrors the reader's ``TPQ_VALIDATE``
contract.
"""

from .compact import (CompactionReport, CompactionService, compact,
                      modeled_link_bytes, plan_codec)
from .manifest import (MANIFEST_NAME, MANIFEST_VERSION, Manifest,
                       ManifestEntry, expand_dataset, find_manifest,
                       load_manifest, write_manifest)
from .merge import merge_files, merge_footers, validate_shard_footer
from .sharded import (ShardedWriteResult, encode_row_group,
                      resolve_write_workers, write_sharded)
from .stats import WRITE_STAGES, WriteStats

__all__ = [
    "WriteStats", "WRITE_STAGES",
    "write_sharded", "encode_row_group", "ShardedWriteResult",
    "resolve_write_workers",
    "merge_files", "merge_footers", "validate_shard_footer",
    "Manifest", "ManifestEntry", "MANIFEST_NAME", "MANIFEST_VERSION",
    "write_manifest", "load_manifest", "find_manifest", "expand_dataset",
    "compact", "CompactionReport", "CompactionService",
    "plan_codec", "modeled_link_bytes",
]
