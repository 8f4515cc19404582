"""Versioned multi-file manifest: N parquet files published as ONE dataset.

The sharded writer's manifest layout and the compaction service both need a
commit point: a reader that opens the dataset mid-write (or mid-compaction)
must see either the previous complete file set or the next one — never a
half-renamed mixture.  The manifest is that commit point:

- a single JSON document (``tpq_manifest.json``) listing the member files
  with their row/byte/row-group counts, under a monotonically increasing
  **generation** number;
- written atomically (temp file in the same directory + ``fsync`` +
  ``os.replace``), so the flip from generation G to G+1 is one rename —
  POSIX guarantees readers see exactly one of the two documents;
- member files are themselves published by rename before the manifest
  flips, so every path a manifest references is complete the instant the
  manifest is visible.

Readers consume a manifest transparently: ``DataLoader(files=...)`` and
``scan_files(paths=...)`` accept a manifest path (or a directory holding
one) and expand it to the member list via :func:`expand_dataset` — one
dataset handle for the training job, however many files the writer cut.

The document is versioned and validated with the same strictness as the
loader checkpoint blob: wrong magic/version, non-monotonic or missing
fields, and absolute-path escapes are typed
:class:`~tpu_parquet_torch.errors.ParquetError` rejections, never best-effort
parses.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Union

from ..errors import ParquetError

__all__ = ["Manifest", "ManifestEntry", "MANIFEST_NAME", "MANIFEST_VERSION",
           "write_manifest", "load_manifest", "find_manifest",
           "expand_dataset", "atomic_publish"]

MANIFEST_VERSION = 1
MANIFEST_MAGIC = "TPQM"
MANIFEST_NAME = "tpq_manifest.json"


@dataclass
class ManifestEntry:
    """One member file, path relative to the manifest's directory."""

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
    path: str = ""  # where it was loaded from / written to

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
    """Load + validate a manifest document (the file itself, or a directory
    containing ``tpq_manifest.json``)."""
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


def atomic_publish(data: bytes, final_path: str) -> None:
    """Write ``data`` to ``final_path`` atomically: same-directory temp +
    ``fsync`` + ``os.replace`` — a reader sees the old document or the new
    one, never a torn one."""
    tmp = f"{final_path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final_path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_manifest(dirpath: Union[str, os.PathLike], entries,
                   generation: "int | None" = None,
                   created_by: str = "") -> Manifest:
    """Publish a manifest over ``entries`` in ``dirpath``, atomically.

    ``generation=None`` bumps the existing manifest's generation (1 for a
    fresh dataset) — the monotonic counter the plan/result caches key
    invalidation on.  An explicit ``generation`` must still move forward.
    """
    dirpath = os.fspath(dirpath)
    path = os.path.join(dirpath, MANIFEST_NAME)
    prev_gen = 0
    if os.path.exists(path):
        prev_gen = load_manifest(path).generation
    if generation is None:
        generation = prev_gen + 1
    elif generation <= prev_gen:
        raise ParquetError(
            f"manifest generation must advance: {generation} <= current "
            f"{prev_gen}")
    ents = []
    for e in entries:
        if isinstance(e, ManifestEntry):
            ents.append(e)
        else:  # a member path: stat it for the counts
            p = os.fspath(e)
            from ..footer import read_file_metadata

            md = read_file_metadata(p)
            ents.append(ManifestEntry(
                path=os.path.relpath(p, dirpath),
                rows=int(md.num_rows or 0),
                nbytes=os.path.getsize(p),
                row_groups=len(md.row_groups or [])))
    if not ents:
        raise ParquetError("manifest needs at least one member file")
    m = Manifest(generation=generation, files=ents,
                 created_by=created_by, path=path)
    doc = json.dumps(m.as_dict(), indent=1, sort_keys=True)
    atomic_publish(doc.encode("utf-8"), path)
    return m


def find_manifest(source) -> "str | None":
    """The manifest path ``source`` denotes, or None when it is a plain
    file/anything else: a path ending in the manifest name, or a directory
    containing one."""
    if not isinstance(source, (str, os.PathLike)):
        return None
    p = os.fspath(source)
    if os.path.basename(p) == MANIFEST_NAME and os.path.isfile(p):
        return p
    if os.path.isdir(p) and os.path.isfile(os.path.join(p, MANIFEST_NAME)):
        return os.path.join(p, MANIFEST_NAME)
    return None


def expand_dataset(files) -> "tuple[list, Manifest | None]":
    """Resolve a reader's ``files`` argument against the manifest contract:
    a manifest path (or a directory holding one) expands to its member
    list; a plain path or an iterable of paths passes through unchanged.
    Returns ``(paths, manifest_or_None)``."""
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
            m = load_manifest(mp)
            out.extend(m.member_paths())
        else:
            out.append(os.fspath(f))
    return out, None
