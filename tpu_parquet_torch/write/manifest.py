"""Versioned multi-file manifest: N parquet files read as ONE dataset.

The counterpart of ``tpu_parquet.write.manifest``, cut to its read half.
A manifest is one JSON document (``tpq_manifest.json``) listing the member
files of a dataset with their row, byte and row-group counts, under a
monotonically increasing generation number; the writer publishes it
atomically, so a reader sees one complete file set.  ``scan_files`` accepts
a manifest path (or a directory holding one) and expands it to the member
list through :func:`expand_dataset`.

The document is validated strictly: wrong magic or version, missing or
negative fields, and member paths that escape the dataset directory are
:class:`~tpu_parquet_torch.errors.ParquetError` rejections.

Left out: the writing half (``write_manifest``, ``atomic_publish``), the
sharded writer and compaction.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Union

from ..errors import ParquetError

__all__ = ["Manifest", "ManifestEntry", "MANIFEST_NAME", "MANIFEST_VERSION",
           "load_manifest", "find_manifest", "expand_dataset"]

MANIFEST_VERSION = 1
MANIFEST_MAGIC = "TPQM"
MANIFEST_NAME = "tpq_manifest.json"


@dataclass
class ManifestEntry:
    """One member file, its path relative to the manifest's directory."""

    path: str
    rows: int
    nbytes: int
    row_groups: int

    def as_dict(self) -> dict:
        return {"path": self.path, "rows": self.rows,
                "bytes": self.nbytes, "row_groups": self.row_groups}


@dataclass
class Manifest:
    generation: int
    files: list = field(default_factory=list)  # [ManifestEntry]
    created_by: str = ""
    path: str = ""  # where it was loaded from

    @property
    def total_rows(self) -> int:
        return sum(e.rows for e in self.files)

    @property
    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self.files)

    def member_paths(self) -> list:
        """Member paths resolved against the manifest's own directory."""
        base = os.path.dirname(os.path.abspath(self.path))
        return [os.path.join(base, e.path) for e in self.files]

    def as_dict(self) -> dict:
        return {
            "magic": MANIFEST_MAGIC,
            "manifest_version": MANIFEST_VERSION,
            "generation": self.generation,
            "created_by": self.created_by,
            "total_rows": self.total_rows,
            "files": [e.as_dict() for e in self.files],
        }


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ParquetError(f"bad manifest: {msg}")


def load_manifest(path: Union[str, os.PathLike]) -> Manifest:
    """Load and validate a manifest document (the file itself, or a
    directory containing ``tpq_manifest.json``)."""
    path = os.fspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, MANIFEST_NAME)
    try:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    except OSError as e:
        raise ParquetError(f"cannot read manifest {path!r}: {e}") from e
    except ValueError as e:
        raise ParquetError(f"manifest {path!r} is not JSON: {e}") from e
    _require(isinstance(doc, dict), "document is not an object")
    _require(doc.get("magic") == MANIFEST_MAGIC,
             f"magic {doc.get('magic')!r} != {MANIFEST_MAGIC!r}")
    _require(doc.get("manifest_version") == MANIFEST_VERSION,
             f"manifest_version {doc.get('manifest_version')!r} != "
             f"{MANIFEST_VERSION}")
    gen = doc.get("generation")
    _require(isinstance(gen, int) and gen >= 1,
             f"generation {gen!r} must be an int >= 1")
    files = doc.get("files")
    _require(isinstance(files, list) and files, "empty or missing file list")
    entries = []
    for i, e in enumerate(files):
        _require(isinstance(e, dict), f"files[{i}] is not an object")
        p = e.get("path")
        _require(isinstance(p, str) and p, f"files[{i}] missing path")
        _require(not os.path.isabs(p) and ".." not in p.split("/"),
                 f"files[{i}] path {p!r} escapes the dataset directory")
        for k in ("rows", "bytes", "row_groups"):
            v = e.get(k)
            _require(isinstance(v, int) and v >= 0,
                     f"files[{i}].{k} {v!r} must be a non-negative int")
        entries.append(ManifestEntry(path=p, rows=e["rows"],
                                     nbytes=e["bytes"],
                                     row_groups=e["row_groups"]))
    m = Manifest(generation=gen, files=entries,
                 created_by=str(doc.get("created_by") or ""), path=path)
    declared = doc.get("total_rows")
    if declared is not None:
        _require(declared == m.total_rows,
                 f"total_rows {declared} != member sum {m.total_rows}")
    return m


def find_manifest(source) -> "str | None":
    """The manifest path ``source`` denotes, or None when it is a plain
    file or anything else: a path ending in the manifest name, or a
    directory containing one."""
    if not isinstance(source, (str, os.PathLike)):
        return None
    p = os.fspath(source)
    if os.path.basename(p) == MANIFEST_NAME and os.path.isfile(p):
        return p
    if os.path.isdir(p) and os.path.isfile(os.path.join(p, MANIFEST_NAME)):
        return os.path.join(p, MANIFEST_NAME)
    return None


def expand_dataset(files) -> "tuple[list, Manifest | None]":
    """Resolve a reader's ``files`` argument: a manifest path (or a
    directory holding one) expands to its member list; a plain path or an
    iterable of paths passes through.  Returns ``(paths,
    manifest_or_None)``."""
    if isinstance(files, (str, os.PathLike)):
        mp = find_manifest(files)
        if mp is not None:
            m = load_manifest(mp)
            return m.member_paths(), m
        return [os.fspath(files)], None
    out = []
    for f in files:
        mp = find_manifest(f)
        if mp is not None:
            out.extend(load_manifest(mp).member_paths())
        else:
            out.append(os.fspath(f))
    return out, None
