"""DataLoader: checkpointable, deterministically-shuffled training input.

The layer between "parquet reader" and "training data service" (tf.data /
Grain shaped): iterate a directory of parquet files as shuffled, sharded,
resumable fixed-shape batches, epoch after epoch, with the decode overlapped
behind the consumer by the prefetch pipeline.  The port's copy of
``tpu_parquet.data.loader``: batches, order, checkpoints and statistics are
the reference's; ``to_device=True`` ships each batch to a torch ``device=``
(``"cuda"`` by default, never the CPU unless asked) instead of a JAX array.

Structure (all order decisions live in data/sampler.py as pure functions of
(seed, epoch, position) — nothing here owns mutable RNG state):

- the dataset is a list of **(file, row_group) units** read once from the
  footers; per-host sharding assigns units with ``parallel.plan_shards``
  (byte-balanced LPT, identical on every host from the shared footers — no
  coordination traffic, same plan every epoch so shard-union == dataset);
- each epoch permutes the shard's units (global shuffle component) and
  window-shuffles the decoded row stream in ``shuffle_window``-row blocks
  (local component); each unit decodes through the reader's ``prefetch``-deep
  chunk pipeline with one unit of lookahead on
  :func:`~tpu_parquet_torch.pipeline.prefetch_map` — ORDERED overlap, so the
  emitted order is bit-identical at every prefetch depth;
- the cursor is a single row offset into the epoch's shuffled stream:
  ``state()``/``restore()`` (data/checkpoint.py) carry (seed, epoch, cursor)
  plus a config fingerprint, and restore re-decodes only the units the
  cursor's shuffle block overlaps.

Columns must be flat (no repetition) fixed-width null-free — the same
contract as ``DeviceFileReader.iter_batches``, because a training batch needs
a static shape.  The ragged TAIL of an epoch is handled by pad+mask: the last
short batch is zero-padded to ``batch_size`` and carries a boolean mask row
validity column (``drop_remainder=True`` drops it instead, tf.data style).
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional, Sequence, Union

import numpy as np

from ..alloc import InFlightBudget
from ..column import ByteArrayData
from ..errors import CheckpointError, ParquetError
from ..footer import read_file_metadata
from ..format import Type
from ..pipeline import PipelineStats, prefetch_map
from ..schema.core import Schema
from . import checkpoint as _ck
from .sampler import block_permutation, plan_epoch

__all__ = ["DataLoader", "LoaderStats", "pad_and_mask", "ship_to_device"]

# the batch contract needs a static row shape: fixed-width physical types
# only (ragged byte arrays and repeated columns have none)
_FIXED_TYPES = (Type.INT32, Type.INT64, Type.FLOAT, Type.DOUBLE, Type.BOOLEAN)


def pad_and_mask(cols: dict, n: int, batch_size: int,
                 mask_key: "str | None" = "mask") -> dict:
    """THE fixed-shape batch contract, shared by :class:`DataLoader` and
    the serve tier's streaming sessions: ``n`` valid rows zero-padded to
    ``batch_size`` plus a boolean row-validity column under ``mask_key``
    (None skips the mask — the loader's ``drop_remainder`` shape).
    Object-dtype columns (streamed byte arrays) pad with ``b""`` — a
    zero there would change the column's value type."""
    batch = {}
    for c, a in cols.items():
        if n < batch_size:
            if a.dtype == object:
                pad = np.empty((batch_size - n,), dtype=object)
                pad[:] = b""
            else:
                pad = np.zeros((batch_size - n,) + a.shape[1:],
                               dtype=a.dtype)
            a = np.concatenate([a, pad])
        batch[c] = a
    if mask_key is not None:
        m = np.zeros(batch_size, dtype=bool)
        m[:n] = True
        batch[mask_key] = m
    return batch


def ship_to_device(batch: dict, device) -> dict:
    """Stage one host batch onto ``device`` as torch tensors, preserving
    64-bit lanes (int64 and float64 keep their width; the mask is
    ``torch.bool``)."""
    import torch

    return {c: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for c, v in batch.items()}


def _batch_device(device):
    """``to_device=True``'s target: ``"cuda"`` unless the caller names
    another; without a CUDA device the default raises."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "DataLoader(to_device=True) ships batches to the CUDA device by "
            "default and no CUDA device is available; pass device='cpu' for "
            "CPU tensors")
    return dev


class LoaderStats:
    """Loader observability, layered on the decode pipeline's PipelineStats.

    ``decode_wait_seconds`` is consumer time blocked on the decode stream —
    the whole decode cost at ``prefetch=0``, shrinking toward zero as the
    prefetch pool hides it.  ``window_peak_rows`` is the shuffle-window
    high-water mark (buffered rows awaiting a full block).  ``pipeline`` is
    the underlying :class:`~tpu_parquet_torch.pipeline.PipelineStats`
    (decompress time on the worker pool, budget stalls, in-flight peak).
    """

    def __init__(self, pipeline: PipelineStats):
        self.pipeline = pipeline
        self.batches = 0
        self.rows = 0
        self.epochs_completed = 0
        self.padded_batches = 0
        self.decode_wait_seconds = 0.0
        self.window_peak_rows = 0
        self.wall_seconds = 0.0
        # data-error containment accounting (quarantine.py): quarantined
        # failures and the units/rows the skip policy dropped for them
        self.data_errors = 0
        self.units_skipped = 0
        self.rows_skipped = 0
        self._t0: Optional[float] = None

    def touch_wall(self) -> None:
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
        self.wall_seconds = now - self._t0

    @property
    def rows_per_sec(self) -> float:
        return self.rows / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def batches_per_sec(self) -> float:
        return self.batches / self.wall_seconds if self.wall_seconds else 0.0

    def as_dict(self) -> dict:
        return {
            "batches": self.batches,
            "rows": self.rows,
            "epochs_completed": self.epochs_completed,
            "padded_batches": self.padded_batches,
            "wall_seconds": round(self.wall_seconds, 6),
            "decode_wait_seconds": round(self.decode_wait_seconds, 6),
            "window_peak_rows": self.window_peak_rows,
            "data_errors": self.data_errors,
            "units_skipped": self.units_skipped,
            "rows_skipped": self.rows_skipped,
            "rows_per_sec": round(self.rows_per_sec, 1),
            "batches_per_sec": round(self.batches_per_sec, 3),
            "pipeline": self.pipeline.as_dict(),
        }


def _as_dotted(col: Union[str, Sequence[str]]) -> str:
    return col if isinstance(col, str) else ".".join(col)


class _UnitSkipped:
    """In-band marker for a quarantined unit riding the ordered decode
    stream (a worker raise would kill the epoch's prefetch pool).  Carries
    the annotated exception; the consumer notes the quarantine record —
    once, in stream order — so the ledger and the skip set are identical
    at every prefetch depth."""

    __slots__ = ("unit", "exc")

    def __init__(self, unit: int, exc: BaseException):
        self.unit = unit
        self.exc = exc


class DataLoader:
    """Epoch iterator over parquet files as fixed-shape training batches.

    ``for batch in loader`` yields the CURRENT epoch from the current cursor
    (dicts of numpy arrays, or torch tensors on ``device`` with
    ``to_device=True``), then
    advances to the next epoch — so ``loader.epochs(n)`` chains n epochs and
    a restored loader resumes mid-epoch transparently.

    - ``shard=(i, n)``: decode only shard i of an n-way byte-balanced LPT
      split of the row groups (``parallel.plan_shards``); every host computes
      the identical plan from the footers.  Compose with
      ``torch.distributed`` via ``shard=parallel.process_shard()``.
    - ``shuffle=True``: seeded epoch-wise unit permutation + windowed row
      shuffle (see data/sampler.py).  Bit-identical across runs and across
      ``prefetch`` values.
    - ``prefetch=K``: each unit decodes through the chunk pipeline
      (its chunks' IO + decompress + decode K-deep on a bounded pool) with
      one unit of lookahead ahead of the shuffle window; ``max_memory``
      bounds cross-unit in-flight bytes with backpressure.
    - ``state()`` / ``restore(state)``: resumable at any batch boundary,
      bit-identically (data/checkpoint.py).
    - ``to_device=True``: each batch becomes torch tensors on ``device``,
      ``"cuda"`` (the current card) by default; without a card that raises
      unless ``device="cpu"`` is passed.  ``device`` is ignored otherwise.
    """

    def __init__(
        self,
        files: Union[str, os.PathLike, Iterable[Union[str, os.PathLike]]],
        batch_size: int,
        *,
        columns: Optional[Iterable[Union[str, Sequence[str]]]] = None,
        shuffle: bool = True,
        seed: int = 0,
        shard: tuple[int, int] = (0, 1),
        drop_remainder: bool = False,
        shuffle_window: int = 4096,
        prefetch: int = 0,
        to_device: bool = False,
        mask_key: str = "mask",
        max_memory: int = 0,
        validate_crc=None,
        trace=None,
        sample_ms=None,
        hang_s=None,
        hang_policy=None,
        on_data_error=None,
        quarantine=None,
        device=None,
    ):
        from ..obs import (register_flight_registry, resolve_hang_s,
                           resolve_sample_ms, resolve_tracer)
        from ..quarantine import Quarantine, resolve_validate

        # span tracer (obs.py): batch/decode-wait spans + window-occupancy
        # counters; None = the TPQ_TRACE process tracer (no-op without the
        # env), a path = per-loader tracer written (with the registry
        # embedded) every time an epoch iterator finishes or is abandoned —
        # the loader has no close(), so iteration end is its close
        self._tracer, self._owns_tracer = resolve_tracer(trace)
        # counter-sampling cadence (obs.Sampler): each __iter__ runs one
        # sampler for the epoch — throughput/queue-depth curves on the trace
        self._sample_ms = resolve_sample_ms(sample_ms)
        # hang watchdog deadline (obs.Watchdog, TPQ_HANG_S / hang_s=): each
        # __iter__ arms one watchdog for the epoch, watching batch/row
        # progress and the decode pipeline's lanes; on a wedge it dumps the
        # flight recorder and (policy "raise") aborts the unit budget so
        # the submitter raises errors.HangError
        self._hang_s = resolve_hang_s(hang_s)
        self._hang_policy = hang_policy
        self._watchdog = None
        self._budget = None  # the live epoch budget (_blocks sets it)
        register_flight_registry(self, "obs_registry")
        # a manifest path (or a directory holding tpq_manifest.json, the
        # sharded writer's multi-file layout) expands to its member list —
        # one dataset handle however many files the writer cut
        from ..write.manifest import expand_dataset

        self._paths, _manifest = expand_dataset(files)
        if not self._paths:
            raise ValueError("DataLoader needs at least one file")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        if shuffle_window <= 0:
            raise ValueError(
                f"shuffle_window must be positive, got {shuffle_window}")
        si, sn = int(shard[0]), int(shard[1])
        if not (sn >= 1 and 0 <= si < sn):
            raise ValueError(f"shard {shard} out of range")
        self._batch_size = int(batch_size)
        self._shuffle = bool(shuffle)
        self._seed = int(seed) & ((1 << 64) - 1)
        self._shard = (si, sn)
        self._drop_remainder = bool(drop_remainder)
        self._shuffle_window = int(shuffle_window)
        self._prefetch = int(prefetch)
        self._to_device = bool(to_device)
        # resolved up front: a loader that cannot reach its device fails at
        # construction, never quietly ships to the CPU
        self._device = _batch_device(device) if self._to_device else None
        self._mask_key = mask_key
        self._max_memory = int(max_memory)
        self._validate_crc = resolve_validate(validate_crc)
        # data-error containment (quarantine.py, TPQ_ON_DATA_ERROR):
        # under skip_unit/skip_file a corrupt unit is quarantined and
        # DROPPED from the epoch stream deterministically — the skip set
        # rides the checkpoint blob so save→restore→iterate replays the
        # identical batch stream, skips included
        self._quarantine = (quarantine if quarantine is not None
                            else Quarantine(on_data_error))
        # ONE inert raise-policy engine shared by every per-unit inner
        # reader (a fresh engine per unit would re-parse the env and take
        # the flight-registry lock thousands of times per epoch)
        self._inner_quarantine = Quarantine("raise")
        self._skipped_units: set[int] = set()  # this epoch's quarantined units
        self._columns = (None if columns is None
                         else [_as_dotted(c) for c in columns])

        # -- dataset inventory: footers only, no data bytes -------------------
        self._metas = []
        self._unit_map: list[tuple[int, int]] = []  # unit -> (file, row group)
        unit_rows, unit_sizes, unit_costs = [], [], []
        for fi, path in enumerate(self._paths):
            with open(path, "rb") as f:
                md = read_file_metadata(f)
            self._metas.append(md)
            for gi, rg in enumerate(md.row_groups):
                self._unit_map.append((fi, gi))
                unit_rows.append(int(rg.num_rows or 0))
                comp = sum(cc.meta_data.total_compressed_size or 0
                           for cc in (rg.columns or [])
                           if cc.meta_data is not None)
                unc = sum(cc.meta_data.total_uncompressed_size or 0
                          for cc in (rg.columns or [])
                          if cc.meta_data is not None)
                unit_sizes.append(comp)
                unit_costs.append(comp + max(unc, comp))
        if not self._unit_map:
            raise ParquetError("DataLoader: no row groups in the file set")
        self._unit_rows_all = unit_rows
        self._unit_cost_all = unit_costs
        # dataset identity for the checkpoint fingerprint: the ordered
        # per-unit (rows, compressed bytes, first byte offset) sequence —
        # path-independent (the same files restore from any mount point),
        # but a reordered/substituted file set changes it, so a stale blob
        # refuses instead of silently yielding wrong rows
        import hashlib

        h = hashlib.sha256()
        for (fi, gi), r, s in zip(self._unit_map, unit_rows, unit_sizes):
            rg = self._metas[fi].row_groups[gi]
            off = min((cc.meta_data.data_page_offset or 0
                       for cc in (rg.columns or [])
                       if cc.meta_data is not None), default=0)
            h.update(f"{r},{s},{off};".encode())
        self._dataset_digest = h.hexdigest()[:16]
        self._colnames = self._check_schemas()
        if (not self._drop_remainder and self._mask_key is not None
                and self._mask_key in self._colnames):
            raise ValueError(
                f"mask_key {self._mask_key!r} collides with a selected "
                f"column; pass a different mask_key (or None)"
            )

        # -- per-host sharding: identical byte-balanced plan on every host ----
        from ..parallel import plan_shards  # deferred: torch.distributed

        plan = plan_shards(unit_sizes, sn)
        self._my_units = plan[si]  # global unit ids, ascending
        self._shard_unit_rows = np.array(
            [unit_rows[u] for u in self._my_units], dtype=np.int64)
        self._shard_rows = int(self._shard_unit_rows.sum())
        self._total_rows = int(sum(unit_rows))

        # -- cursor + stats ---------------------------------------------------
        self._epoch = 0
        self._rows_taken = 0
        self._bad_files: set[int] = set()  # skip_file marks, this epoch
        self._pstats = PipelineStats(prefetch=self._prefetch,
                                     budget_bytes=self._max_memory,
                                     tracer=self._tracer)
        self._stats = LoaderStats(self._pstats)

    # -- schema validation ----------------------------------------------------

    def _check_schemas(self) -> list[str]:
        """Selected columns exist in EVERY file, flat and fixed-width, with
        matching physical types; returns their dotted names (file-0 order)."""
        names = None
        types = {}
        for fi, md in enumerate(self._metas):
            schema = Schema.from_file_metadata(md)
            if self._columns is not None:
                paths = [tuple(c.split(".")) for c in self._columns]
                if not schema.selection_matches(paths):
                    known = [".".join(l.path) for l in schema.leaves]
                    raise ParquetError(
                        f"columns {self._columns} match no columns of "
                        f"{self._paths[fi]}; available: {known}"
                    )
                schema.set_selected(paths)
            leaves = schema.selected_leaves()
            here = [".".join(l.path) for l in leaves]
            # column-SET mismatch first: a later file with an extra column
            # must say so, not fall through to a bogus changed-type error
            if names is None:
                names = here
            elif set(names) != set(here):
                raise ParquetError(
                    f"file {self._paths[fi]} has columns {sorted(here)}, "
                    f"expected {sorted(names)}"
                )
            for leaf, name in zip(leaves, here):
                if leaf.max_rep > 0:
                    raise TypeError(
                        f"DataLoader needs flat columns; {name!r} is repeated"
                    )
                if leaf.physical_type not in _FIXED_TYPES:
                    raise TypeError(
                        f"DataLoader needs fixed-width columns; {name!r} is "
                        f"{leaf.physical_type!r} (project it out with "
                        f"columns=[...])"
                    )
                if fi == 0:
                    types[name] = leaf.physical_type
                elif types[name] != leaf.physical_type:
                    raise ParquetError(
                        f"column {name!r} changes physical type across files"
                    )
        return names

    # -- inventory accessors ---------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self._batch_size

    @property
    def column_names(self) -> list[str]:
        return list(self._colnames)

    @property
    def num_rows(self) -> int:
        """Rows this shard yields per epoch (before drop_remainder)."""
        return self._shard_rows

    @property
    def num_batches(self) -> int:
        """Batches per epoch for this shard."""
        full, rem = divmod(self._shard_rows, self._batch_size)
        return full + (1 if rem and not self._drop_remainder else 0)

    @property
    def epoch(self) -> int:
        return self._epoch

    def stats(self) -> LoaderStats:
        return self._stats

    def obs_registry(self):
        """This loader's unified metrics tree (obs.StatsRegistry): loader
        counters + the decode pipeline's per-stage sums and histograms."""
        from ..obs import StatsRegistry

        reg = StatsRegistry()
        reg.add_loader(self._stats)
        if (len(self._quarantine.log)
                or self._quarantine.units_skipped):
            reg.add_data_errors(self._quarantine)
        return reg

    # -- checkpoint ------------------------------------------------------------

    def state(self) -> dict:
        """The loader's position as a small JSON-safe dict (see
        data/checkpoint.py for the versioned blob form)."""
        return {
            "version": _ck.STATE_VERSION,
            "seed": self._seed,
            "epoch": self._epoch,
            "rows_taken": self._rows_taken,
            "batch_size": self._batch_size,
            "shuffle": self._shuffle,
            "shuffle_window": self._shuffle_window,
            "drop_remainder": self._drop_remainder,
            "shard": list(self._shard),
            "n_units": len(self._unit_map),
            "total_rows": self._total_rows,
            "shard_rows": self._shard_rows,
            "dataset_digest": self._dataset_digest,
            # the CURRENT epoch's quarantine skips: restore replays them
            # proactively, so the resumed batch stream is bit-identical to
            # the uninterrupted one — skips included (quarantine.py)
            "skipped_units": sorted(self._skipped_units),
            "skipped_rows": sum(int(self._unit_rows_all[u])
                                for u in self._skipped_units),
            "skipped_files": sorted(self._bad_files),
        }

    def state_blob(self) -> bytes:
        return _ck.pack_state(self.state())

    def restore(self, state) -> "DataLoader":
        """Adopt a saved cursor (dict or packed blob); returns self.

        Raises :class:`~tpu_parquet_torch.errors.CheckpointError` unless the
        state's config fingerprint matches this loader exactly — a cursor
        into a different dataset/sharding/batch geometry must never be
        adopted silently.
        """
        st = _ck.unpack_state(state)
        own = self.state()
        _ck.check_compatible(st, {k: own[k] for k in
                                  ("batch_size", "shuffle", "shuffle_window",
                                   "drop_remainder", "shard", "n_units",
                                   "total_rows", "shard_rows",
                                   "dataset_digest")})
        # quarantine skips (absent in older blobs: no skips then).
        # Cross-checks beyond validate_state's structural ones: the units
        # must belong to THIS shard and their rows must sum to the blob's
        # skipped_rows — a tampered skip set must never silently mis-seek.
        skipped = st.get("skipped_units", [])
        mine = set(int(u) for u in self._my_units)
        bad = [u for u in skipped if u not in mine]
        if bad:
            raise CheckpointError(
                f"loader state skipped_units {bad[:8]} not in this "
                f"loader's shard")
        rows = sum(int(self._unit_rows_all[u]) for u in skipped)
        if rows != st.get("skipped_rows", 0):
            raise CheckpointError(
                f"loader state skipped_rows {st.get('skipped_rows', 0)} "
                f"does not match the named units' {rows} rows")
        n_files = len(self._paths)
        bad_files = [f for f in st.get("skipped_files", [])
                     if not 0 <= f < n_files]
        if bad_files:
            raise CheckpointError(
                f"loader state skipped_files {bad_files[:8]} out of range "
                f"({n_files} files)")
        self._seed = st["seed"]
        self._epoch = st["epoch"]
        self._rows_taken = st["rows_taken"]
        self._skipped_units = set(int(u) for u in skipped)
        self._bad_files = set(int(f) for f in st.get("skipped_files", []))
        return self

    # -- decode ----------------------------------------------------------------

    def _note_unit_skip(self, unit: int) -> None:
        """Account one quarantined/dropped unit (idempotent): the skip set
        (checkpointed), LoaderStats, the engine's counters, and a
        flight-recorder instant naming the unit."""
        if unit in self._skipped_units:
            return
        self._skipped_units.add(unit)
        rows = int(self._unit_rows_all[unit])
        self._stats.units_skipped += 1
        self._stats.rows_skipped += rows
        self._quarantine.note_unit_skipped(rows)
        tr = self._tracer
        if tr.active:
            fi, gi = self._unit_map[unit]
            tr.instant("unit_skipped", unit=unit, file=self._paths[fi],
                       row_group=gi, rows=rows)

    def _adjusted_plan(self, plan):
        """Zero the quarantined units' rows in an epoch plan, so the cursor
        math (locate/starts) matches the stream that will actually flow —
        the restore half of the deterministic-skip contract."""
        if not self._skipped_units:
            return plan
        gids = np.asarray([int(self._my_units[o]) for o in plan.order],
                          dtype=np.int64)
        rows = plan.unit_rows.copy()
        rows[np.isin(gids, np.fromiter(self._skipped_units, dtype=np.int64))] = 0
        starts = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(rows, out=starts[1:])
        return plan.__class__(epoch=plan.epoch, order=plan.order,
                              unit_rows=rows, starts=starts)

    def _decode_unit(self, unit: int) -> dict[str, np.ndarray]:
        """One (file, row group) unit -> {column: np.ndarray} host arrays.

        ``prefetch=K`` routes the unit through the chunk pipeline
        (FileReader's io+CRC+decompress+decode of the unit's chunks, K-deep
        on a bounded pool) — on a 2-core host that is where the overlap
        actually pays (measured 1.3x vs 0.95x for unit-level threading,
        which just oversubscribes the cores against the consumer's shuffle
        work).  Output is bit-identical at every depth (the pipeline's
        contract).
        Each call opens its own fd; the cached footer skips the reparse.
        """
        from ..errors import DataIntegrityError
        from ..quarantine import annotate_data_error
        from ..reader import FileReader  # deferred: reader pulls numpy chains

        fi, gi = self._unit_map[unit]
        if fi in self._bad_files:
            # fast path for a skip_file-marked file: the consumer would
            # drop this unit's rows regardless (consumer-order decision),
            # so don't pay its decode.  Safe under lookahead: the flag is
            # only ever SET by the consumer, so a worker seeing it implies
            # the consumer will see it too.
            return _UnitSkipped(unit, None)
        try:
            # the inner reader must RAISE (never skip internally): the
            # loader's own seam owns unit granularity, the checkpointed
            # skip set, and the one shared budget/ledger
            with FileReader(self._paths[fi], columns=self._columns,
                            metadata=self._metas[fi],
                            validate_crc=self._validate_crc,
                            prefetch=self._prefetch,
                            quarantine=self._inner_quarantine) as r:
                if self._prefetch > 0:
                    cols = r.read_row_group(gi)
                    self._pstats.merge_from(r.pipeline_stats())
                else:
                    # the sequential path has no per-stage instrumentation, so
                    # the WHOLE read (IO included) books under "decompress" —
                    # loader-level timing lives in LoaderStats.decode_wait_seconds
                    # either way; the io/decompress split is only meaningful at
                    # prefetch > 0 (PipelineStats contract)
                    with self._pstats.timed("decompress"):
                        cols = r.read_row_group(gi, prefetch=0)
                    # the pipelined branch counts groups/chunks via the merge
                    self._pstats.count_row_group()
            n = self._unit_rows_all[unit]
            out = {}
            for name in self._colnames:
                cd = cols[name]
                if isinstance(cd.values, ByteArrayData) or cd.max_rep > 0:
                    # construction validates the schema; reaching here means
                    # the file's data contradicts its own footer
                    raise ParquetError(
                        f"column {name!r} is not fixed-width flat")
                if (cd.def_levels is not None
                        and cd.num_defined != cd.num_leaf_slots):
                    raise TypeError(
                        f"DataLoader needs null-free columns; {name!r} has "
                        f"{cd.num_leaf_slots - cd.num_defined} nulls"
                    )
                arr = np.asarray(cd.values)
                if len(arr) != n:
                    raise ParquetError(
                        f"column {name!r} decoded {len(arr)} rows, footer "
                        f"declares {n}"
                    )
                out[name] = arr
            return out
        except (ParquetError, TypeError) as e:
            # containment seam (quarantine.py): the unit becomes an in-band
            # skip marker instead of an epoch-killing raise; the CONSUMER
            # (_blocks) notes the record in stream order.  TypeError is
            # included because a corruption the CRC tier cannot see (no
            # checksum written) can surface as the null-free/fixed-width
            # contract check above.  Budget exhaustion (DataIntegrityError)
            # always propagates.
            if not self._quarantine.contains or isinstance(
                    e, DataIntegrityError):
                raise
            return _UnitSkipped(unit, annotate_data_error(
                e, file=self._paths[fi], row_group=gi, unit=unit,
                epoch=self._epoch))

    def _blocks(self, plan, first_block: int, skip_rows: int):
        """Yield (block_index, {col: raw rows}, permutation|None) shuffle
        blocks from ``first_block`` on; ``skip_rows`` rows of the first unit
        belong to earlier blocks and are dropped before buffering.

        Blocks are yielded UNPERMUTED with their seeded permutation: the
        batcher gathers each batch's rows straight through the permutation
        slice (one copy per row) instead of materializing a permuted block
        and copying batch slices out of it (two).

        Containment (quarantine.py): a unit arriving as a
        :class:`_UnitSkipped` marker is recorded and dropped — the block
        stream simply never sees its rows, so blocking/permutation over the
        SURVIVING rows is identical whether the skip was discovered live or
        replayed proactively from a restored checkpoint.  ``skip_file``
        marks the file bad; later units of a bad file are dropped on
        arrival even when their own decode succeeded in the lookahead (the
        decision is made in CONSUMER order, so it is deterministic at every
        prefetch depth)."""
        window = self._shuffle_window
        q = self._quarantine
        unit_ids = [int(self._my_units[plan.order[k]])
                    for k in range(len(plan.order))]
        # proactive skips: units already quarantined this epoch (a restored
        # skip set, or a bad file's not-yet-reached units) are never decoded
        # — their rows are zeroed in the caller's plan, so the cursor math
        # and this stream agree
        decode_ids = []
        for u in unit_ids:
            if u in self._skipped_units:
                continue
            if self._unit_map[u][0] in self._bad_files:
                self._note_unit_skip(u)
                continue
            decode_ids.append(u)
        # locate() already skipped fully-consumed units via first_block's
        # start row; the caller passes the permuted ordinal to start at
        budget = (InFlightBudget(self._max_memory)
                  if self._max_memory > 0 else None)
        cost = ((lambda u: self._unit_cost_all[u])
                if budget is not None else None)
        if budget is not None:
            self._budget = budget  # sampler's budget_waiters track
            wd = self._watchdog
            if wd is not None and wd.enabled:
                wd.add_abort_hook(budget.abort)
        # ONE unit of lookahead: the next unit's chunk pipeline runs while
        # the consumer permutes/batches the current one.  Deeper unit-level
        # fan-out only oversubscribes the cores the chunk pipeline already
        # uses (0.95x measured at depth 4 on 2 cores); the real depth knob
        # is the chunk pipeline inside _decode_unit.
        stream = prefetch_map(iter(decode_ids), self._decode_unit,
                              min(self._prefetch, 1), budget=budget,
                              cost=cost, stats=self._pstats)
        names = self._colnames
        parts: dict[str, list] = {c: [] for c in names}
        buffered = 0
        bidx = first_block
        pos = 0  # index into decode_ids, so each result names its unit
        tr = self._tracer
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    arrays = next(stream)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                uid = decode_ids[pos]
                pos += 1
                self._stats.decode_wait_seconds += t1 - t0
                if tr.active:
                    # consumer time blocked on the decode stream — the span
                    # that shrinks toward zero as prefetch hides the decode
                    tr.complete("decode_wait", t0, t1)
                if self._unit_map[uid][0] in self._bad_files:
                    # collateral skip of an already-bad file's unit —
                    # whether its decode succeeded in the lookahead, failed,
                    # or was fast-pathed away: dropped with NO new record
                    # and no budget charge (consumer-order decision =
                    # deterministic at every prefetch depth)
                    self._note_unit_skip(uid)
                    continue
                if isinstance(arrays, _UnitSkipped):
                    # quarantined: record (budget may raise), drop the unit
                    q.note(arrays.exc)
                    self._stats.data_errors += 1
                    self._note_unit_skip(uid)
                    if q.policy == "skip_file":
                        q.note_file_skipped()
                        self._bad_files.add(self._unit_map[uid][0])
                    continue
                if skip_rows:
                    arrays = {c: a[skip_rows:] for c, a in arrays.items()}
                    skip_rows = 0
                n = len(arrays[names[0]])
                if n == 0:
                    continue
                for c in names:
                    parts[c].append(arrays[c])
                buffered += n
                self._stats.window_peak_rows = max(
                    self._stats.window_peak_rows, buffered)
                if tr.enabled:  # counter track only: the ring wants spans
                    tr.counter("shuffle_window_rows", rows=buffered)
                while buffered >= window:
                    cat = {c: (np.concatenate(parts[c])
                               if len(parts[c]) > 1 else parts[c][0])
                           for c in names}
                    yield bidx, {c: a[:window] for c, a in cat.items()}, (
                        block_permutation(self._seed, plan.epoch,
                                          self._shard[0], bidx, window)
                        if self._shuffle else None)
                    bidx += 1
                    buffered -= window
                    parts = {c: ([cat[c][window:]] if buffered else [])
                             for c in names}
            if buffered:
                tail = {c: (np.concatenate(parts[c])
                            if len(parts[c]) > 1 else parts[c][0])
                        for c in names}
                yield bidx, tail, (
                    block_permutation(self._seed, plan.epoch, self._shard[0],
                                      bidx, buffered)
                    if self._shuffle else None)
        finally:
            self._budget = None
            wd = self._watchdog
            if budget is not None and wd is not None and wd.enabled:
                wd.remove_abort_hook(budget.abort)
            stream.close()

    def _emit(self, cols: dict, n: int):
        """Assemble one yielded batch: pad+mask the ragged tail, optionally
        ship to device."""
        mask_key = (self._mask_key
                    if not self._drop_remainder else None)
        batch = pad_and_mask(cols, n, self._batch_size, mask_key=mask_key)
        if self._to_device:
            batch = ship_to_device(batch, self._device)
        return batch

    def _batches(self, epoch: int, start_row: int):
        """Yield (batch, rows_consumed) for one epoch from ``start_row``."""
        plan = self._adjusted_plan(
            plan_epoch(self._seed, epoch, self._shard[0],
                       self._shard_unit_rows, self._shuffle))
        total = plan.total_rows
        if start_row >= total:
            return
        window = self._shuffle_window
        bs = self._batch_size
        first_block = start_row // window
        drop = start_row - first_block * window  # rows already consumed
        k0, skip = plan.locate(first_block * window)
        names = self._colnames
        # re-aim the unit stream at the first block's first unit
        sub = plan.__class__(epoch=plan.epoch, order=plan.order[k0:],
                             unit_rows=plan.unit_rows[k0:],
                             starts=plan.starts[k0:] - plan.starts[k0])
        pend: dict[str, list] = {c: [] for c in names}
        pend_n = 0
        blocks = self._blocks(sub, first_block, skip)
        try:
            for _bidx, block, perm in blocks:
                n = len(block[names[0]])
                pos = drop  # resume mid-block: emitted order == permuted order
                drop = 0
                while pos < n:
                    take = min(bs - pend_n, n - pos)
                    if perm is not None:
                        # fused shuffle+cut: each row gathers once, straight
                        # into its batch (take beats fancy indexing ~10%
                        # here and tolerates the idx slice being non-owned)
                        idx = perm[pos : pos + take]
                        piece = {c: np.take(block[c], idx, axis=0)
                                 for c in names}
                    else:
                        piece = {c: block[c][pos : pos + take].copy()
                                 for c in names}
                    pos += take
                    pend_n += take
                    for c in names:
                        pend[c].append(piece[c])
                    if pend_n == bs:
                        yield self._emit(
                            {c: (np.concatenate(pend[c])
                                 if len(pend[c]) > 1 else pend[c][0])
                             for c in names}, bs), bs
                        pend = {c: [] for c in names}
                        pend_n = 0
            if pend_n and not self._drop_remainder:
                tail = {c: (np.concatenate(pend[c])
                            if len(pend[c]) > 1 else pend[c][0])
                        for c in names}
                yield self._emit(tail, pend_n), pend_n
        finally:
            blocks.close()

    def __iter__(self):
        """Iterate the CURRENT epoch from the current cursor, then advance
        the epoch.  ``state()`` between batches is a valid resume point."""
        from ..obs import Sampler, Watchdog

        epoch = self._epoch
        stats = self._stats
        tr = self._tracer
        sampler = Sampler(tr, self._sample_ms,
                          track_id=self._pstats._obs_id)
        if sampler.enabled:
            sampler.add_source("loader_progress", lambda: {
                "rows": stats.rows, "batches": stats.batches,
                "decode_wait_seconds": round(stats.decode_wait_seconds, 6),
            })
            sampler.add_source("pipeline_lanes", self._pstats.sample)
            sampler.add_source("budget_waiters", lambda: (
                self._budget.snapshot() if self._budget is not None else {}))
            # quarantined-unit accounting as a live curve: a corruption
            # burst is visible next to the lanes it degraded
            sampler.add_source("data_errors", self._quarantine.progress)
            sampler.start()
        watchdog = Watchdog(self._hang_s, policy=self._hang_policy)
        lane = None
        if watchdog.enabled:
            watchdog.watch("loader", lambda: {
                "batches": stats.batches, "rows": stats.rows,
            })
            watchdog.watch("pipeline", self._pstats.sample)
            # consumer gate: a training loop pausing between batches (eval,
            # checkpoint) freezes every lane above — only a consumer
            # genuinely blocked in next() may read as a hang
            lane = watchdog.watch_consumer()
            self._watchdog = watchdog  # _blocks registers its budget's abort
            watchdog.start()
        # fleet spool (TPQ_OBS_SPOOL; inert when unset): this loader
        # process's registry + any cross-process request trace it adopted
        # (TPQ_TRACE_CONTEXT) become visible to the FleetAggregator
        from ..obs_fleet import SpoolWriter, ambient_request_trace

        spool_tr = ambient_request_trace()
        spool = SpoolWriter(
            self.obs_registry, role="loader",
            sampler=lambda: [spool_tr.as_dict()] if spool_tr else [])
        spool.start()
        # per-epoch error-budget scope: the fraction denominator is this
        # shard's unit count; the ledger and skip counters are cumulative
        self._quarantine.begin_scan(len(self._my_units))
        gen = self._batches(epoch, self._rows_taken)
        try:
            while True:
                if watchdog.enabled:
                    watchdog.check()  # surface a fired HangError even when
                    # no budget wait existed for the abort hook to interrupt
                # time each batch's PRODUCTION (decode + shuffle + assembly,
                # consumer wait excluded) as a "batch" span
                t0 = time.perf_counter()
                if lane is not None:
                    lane.producing()
                try:
                    batch, consumed = next(gen)
                except StopIteration:
                    break
                finally:
                    if lane is not None:
                        lane.idle()
                if tr.active:
                    tr.complete("batch", t0, time.perf_counter(),
                                rows=consumed)
                self._rows_taken += consumed
                stats.touch_wall()
                self._pstats.touch_wall()
                stats.batches += 1
                stats.rows += consumed
                if consumed < self._batch_size:
                    stats.padded_batches += 1
                yield batch
                stats.touch_wall()
        finally:
            watchdog.stop()  # thread-leak-safe even on early abandon
            self._watchdog = None
            sampler.stop()
            spool.stop()  # publishes a final generation, joins (no leak)
            gen.close()
            if self._owns_tracer:
                # per-loader trace artifact: rewrite (cumulatively) at every
                # epoch end or early abandon so the file exists without
                # waiting for interpreter exit
                self._tracer.write(registry=self.obs_registry())
        # epoch complete (also when resumed exactly at its end)
        self._epoch = epoch + 1
        self._rows_taken = 0
        # the skip set is an EPOCH fact: the next epoch re-attempts every
        # unit (a transient corruption heals; a persistent one re-records
        # under the fresh per-epoch budget)
        self._skipped_units = set()
        self._bad_files = set()
        stats.epochs_completed += 1

    def epochs(self, n: int):
        """Chain ``n`` epochs (continuing from the current cursor)."""
        for _ in range(int(n)):
            yield from self
