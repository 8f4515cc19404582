"""Multi-GPU / multi-host parallel decode over ``torch.distributed``.

The counterpart of ``tpu_parquet.parallel``.  The file's block hierarchy
(file → row group → column chunk → page) becomes parallel axes:

- **pages** of identical geometry batch into a :class:`PageBatch` and shard
  over the mesh's ``data`` axis: each rank decodes its contiguous slice of
  the page batch on its own device with the port's ``torch_kernels``
  functions, and the result is a ``DTensor`` sharded on dim 0
  (``Shard(0)``).  Cross-rank reductions (global stats) are
  ``dist.all_reduce`` in int64 on the axis's process group, never a host
  round trip;
- **row groups** are embarrassingly parallel and are *assigned*, not
  exchanged: a greedy LPT plan balances compressed bytes across shards
  (hosts or cards), identical on every rank from the shared footers;
- **multi-host**: each process decodes the row groups or the row span its
  shard owns.

How the reference's constructs map here:

- ``make_mesh`` is a ``DeviceMesh`` (``init_device_mesh`` with the axis as
  ``mesh_dim_names``) over a process group the caller initialized: NCCL
  for ``"cuda"`` (the default), gloo for ``"cpu"``.  A CUDA tensor never
  goes through gloo, a CPU mesh never through NCCL; a collective that
  fails raises (there is no fallback);
- each ``shard_map`` body is the rank's own decode of its slice; the
  batch (host tensors, identical on every rank) is the replicated input;
- ``psum`` / ``pmin`` / ``pmax`` are ``all_reduce`` with ``SUM`` / ``MIN``
  / ``MAX``; the 2-D variant's masked gather is summed over the
  ``"model"`` group the same way;
- ``process_shard`` is ``(dist.get_rank(), dist.get_world_size())`` once a
  group is initialized, else ``(0, 1)``.

Shapes are the reference's: the page count must divide by the data axis
(the reference's ``shard_map`` refuses the same batches), a short tail page
pads with a zero run, and the stats are the reference's triple ``[count,
min, max]``, int64, identical on every rank.

**The two global-array forms.**  The reference's
:func:`global_column_array` is one process placing every span of the work
list on its own device (``jax.make_array_from_single_device_arrays``);
in torch one rank drives one device, so no process can place another's
span.  Here both forms return ``(DTensor, valid_rows)`` whose
``full_tensor()`` equals the reference's global array, padding included:
:func:`global_column_array` spans the rows over the mesh's named axis and
each rank decodes the span of its own coordinate on that axis (the ranks
that share it on other axes decode the same span, which is replicated
there), so the decode is spread over the ranks instead of run in one
process; :func:`process_local_column` spans over the processes of the
world, each decoding its own, as the reference's multi-host form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..format import Type
from .. import torch_kernels as K
from ..torch_decode import _SLACK, _bucket, parse_delta_meta, parse_hybrid_meta

__all__ = [
    "make_mesh",
    "plan_shards",
    "process_shard",
    "shard_scan_row_groups",
    "PageBatch",
    "pack_hybrid_pages",
    "pack_delta_pages",
    "sharded_dict_decode",
    "sharded_dict_decode_2d",
    "sharded_delta_decode",
    "sharded_plain_decode",
    "column_stats",
    "shard_row_ranges",
    "decode_row_span",
    "global_column_array",
    "process_local_column",
]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(device_type: str = "cuda", axis: str = "data"):
    """1-D data mesh over every rank of the initialized default process
    group — the decode path needs no model axis; a 2-D mesh for
    :func:`sharded_dict_decode_2d` is ``init_device_mesh(device_type,
    (n_data, n_model), mesh_dim_names=("data", "model"))``.

    ``device_type`` ``"cuda"`` (the default) needs a card and an NCCL
    group, ``"cpu"`` a gloo group; the caller initializes the group
    (``dist.init_process_group``).  Without a card the default raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type not in _BACKENDS:
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh builds a CUDA mesh by default and no CUDA device is "
            "available; pass device_type='cpu' over a gloo process group")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group("
            f"{_BACKENDS[device_type]!r}, ...) first")
    _check_backend(device_type, None)
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def _check_backend(device_type: str, group) -> None:
    """The backend that carries this mesh's collectives must be the one for
    its device: a CUDA tensor never goes through gloo, a CPU tensor never
    through NCCL."""
    backend = str(dist.get_backend(group))
    want = _BACKENDS[device_type]
    if want not in backend:
        raise RuntimeError(
            f"a {device_type} mesh needs a {want} process group; the group's "
            f"backend is {backend!r}")


def _rank_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis_slice(mesh, axis: str, n_rows: int) -> tuple[int, int]:
    """This rank's contiguous ``[lo, hi)`` of ``n_rows`` leading rows along
    the named axis; the rows must divide evenly, as ``shard_map`` wants."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n_rows % n:
        raise ValueError(
            f"{n_rows} pages do not divide over the {n} ranks of mesh axis "
            f"{axis!r}")
    per = n_rows // n
    i = mesh.get_local_rank(axis)
    return i * per, (i + 1) * per


def _placements(mesh, axis: str) -> list:
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _sharded(local: torch.Tensor, mesh, axis: str):
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, _placements(mesh, axis),
                              run_check=False)


def _all_reduce(t: torch.Tensor, op, mesh, axis: str) -> torch.Tensor:
    _check_backend(mesh.device_type, mesh.get_group(axis))
    dist.all_reduce(t, op=op, group=mesh.get_group(axis))
    return t


def _global_stats(values: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``[count, min, max]`` over every rank's ``values`` (int64)."""
    v = values.to(torch.int64)
    dev = v.device
    count = torch.tensor([v.numel()], dtype=torch.int64, device=dev)
    lo = v.min().reshape(1)
    hi = v.max().reshape(1)
    _all_reduce(count, dist.ReduceOp.SUM, mesh, axis)
    _all_reduce(lo, dist.ReduceOp.MIN, mesh, axis)
    _all_reduce(hi, dist.ReduceOp.MAX, mesh, axis)
    return torch.cat([count, lo, hi])


# ---------------------------------------------------------------------------
# Work-list sharding (row groups → shards)
# ---------------------------------------------------------------------------

def plan_shards(sizes: Sequence[int], n_shards: int) -> list[list[int]]:
    """Greedy LPT assignment of row groups to shards, balanced by byte size.

    ``sizes[i]`` is row group i's total_compressed_size (or total_byte_size).
    Returns per-shard lists of row-group indices.  Deterministic, so every
    host computes the identical plan from the shared footer — no coordination
    traffic.
    """
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    order = sorted(range(len(sizes)), key=lambda i: -int(sizes[i]))
    loads = [0] * n_shards
    plan: list[list[int]] = [[] for _ in range(n_shards)]
    for i in order:
        s = loads.index(min(loads))
        plan[s].append(i)
        loads[s] += int(sizes[i])
    for shard in plan:
        shard.sort()
    return plan


def process_shard() -> tuple[int, int]:
    """This process's ``(shard_index, n_shards)`` under ``torch.distributed``.

    The shard tuple ``data.DataLoader`` (and any plan_shards caller) wants on
    a multi-host job: every host derives the identical LPT plan from the
    shared footers, so the only coordination is the process group's own
    rank enumeration.  Without an initialized group this is ``(0, 1)`` —
    the same code serves tests and clusters.
    """
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def _reader_prefetch(reader) -> int:
    """A reader's configured pipeline depth: FileReader exposes ``prefetch``,
    DeviceFileReader ``_prefetch``; any other reader defaults to 0."""
    return int(getattr(reader, "prefetch", None)
               or getattr(reader, "_prefetch", 0) or 0)


def shard_scan_row_groups(reader, shard_index: int, n_shards: int,
                          prefetch: Optional[int] = None):
    """Decode the row groups LPT-assigned to ``shard_index``, pipelined.

    The per-SHARD pipeline form of the work-list split: every shard computes
    the identical byte-balanced plan from the shared footer (plan_shards —
    no coordination traffic) and decodes only its own groups, each through
    the reader's overlapped chunk pipeline (``prefetch`` per-call override;
    the reader's own setting otherwise).  Shards run in different
    processes/hosts, so pipelines are deliberately per-shard rather than
    one global pool.  Yields ``(row_group_index, {column: ColumnData})``.
    """
    sizes = [
        sum(cc.meta_data.total_compressed_size or 0
            for cc in (rg.columns or []) if cc.meta_data is not None)
        for rg in reader.metadata.row_groups
    ]
    plan = plan_shards(sizes, n_shards)
    if not 0 <= shard_index < n_shards:
        raise ValueError(f"shard {shard_index} of {n_shards}")
    mine = plan[shard_index]
    k = _reader_prefetch(reader) if prefetch is None else int(prefetch)
    if k > 0 and hasattr(reader, "_decode_row_groups"):
        # ONE pipeline over the whole shard: the window spans group
        # boundaries (per-group read_row_group calls would build and drain
        # a pool at every boundary — exactly the stall this exists to hide)
        yield from reader._decode_row_groups(mine, k)
        return
    for i in mine:
        # bare call: the generic reader contract (a DeviceFileReader's
        # read_row_group has no prefetch kwarg)
        yield i, reader.read_row_group(i)


# ---------------------------------------------------------------------------
# Page batching: N same-geometry pages → stacked host tensors
# ---------------------------------------------------------------------------

@dataclass
class PageBatch:
    """A batch of same-geometry encoded pages, stacked for a sharded decode.

    ``bufs`` uint8[B, S]: padded page bytes.  Hybrid (dictionary-index)
    batches carry run tables [B, R]; delta batches carry miniblock tables
    [B, M].  ``count`` values per page is uniform; a short tail page is
    padded with a synthetic zero run via pack_hybrid_pages(counts=...) and
    callers slice the decoded tail back (delta batches require equal counts
    — pack_delta_pages raises otherwise).  The tensors are host tensors,
    the same on every rank; each rank moves its own slice to its device.
    Unsigned tables hold their bits in int64 (``run_values``,
    ``mini_min_delta``), as ``torch_kernels`` takes them.
    """

    bufs: torch.Tensor
    count: int
    width: int = 0                      # hybrid: index bit width
    run_ends: Optional[torch.Tensor] = None
    run_is_rle: Optional[torch.Tensor] = None
    run_values: Optional[torch.Tensor] = None
    run_bit_starts: Optional[torch.Tensor] = None
    first_values: Optional[torch.Tensor] = None    # delta: per-page seed
    mini_bit_starts: Optional[torch.Tensor] = None
    mini_widths: Optional[torch.Tensor] = None
    mini_min_delta: Optional[torch.Tensor] = None
    values_per_mini: int = 0
    max_width: int = 0

    @property
    def num_pages(self) -> int:
        return int(self.bufs.shape[0])


def _stack_padded_bufs(raws: list[bytes]) -> np.ndarray:
    size = _bucket(max(len(r) for r in raws) + _SLACK, 64)
    out = np.zeros((len(raws), size), dtype=np.uint8)
    for i, r in enumerate(raws):
        out[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    return out


def pack_hybrid_pages(
    raws: list[bytes],
    width: int,
    count: int,
    pos: int = 0,
    counts: Optional[Sequence[int]] = None,
) -> PageBatch:
    """Parse + stack N hybrid (RLE/bit-packed) streams of ``count`` values each.

    ``counts`` gives per-page actual value counts when they differ (the usual
    short tail page): shorter pages are padded to ``count`` with a synthetic
    zero-value RLE run, and callers slice the decoded tail back to its real
    length.  Host cost is O(total run headers); run tables are padded to the
    batch max (power-of-two bucketed).
    """
    per_page = list(counts) if counts is not None else [count] * len(raws)
    if len(per_page) != len(raws):
        raise ValueError(f"{len(per_page)} counts for {len(raws)} pages")
    if any(c > count for c in per_page):
        raise ValueError(f"page count exceeds batch count {count}")
    metas = [
        parse_hybrid_meta(r, width, c, pos=pos) for r, c in zip(raws, per_page)
    ]
    for m, c in zip(metas, per_page):
        if c < count:  # pad: one RLE run of zeros fills the tail
            # run_ends stays sorted: real runs end ≤ c, bucket padding == c,
            # the synthetic run == count, so searchsorted routes tail slots here
            m.run_ends = np.concatenate([m.run_ends, [count]]).astype(np.int64)
            m.run_is_rle = np.concatenate([m.run_is_rle, [True]])
            m.run_values = np.concatenate([m.run_values, [0]]).astype(np.uint32)
            m.run_bit_starts = np.concatenate([m.run_bit_starts, [0]]).astype(np.int64)
    r_max = max(m.run_ends.shape[0] for m in metas)
    ends = np.full((len(metas), r_max), count, dtype=np.int64)
    is_rle = np.zeros((len(metas), r_max), dtype=bool)
    vals = np.zeros((len(metas), r_max), dtype=np.int64)
    starts = np.zeros((len(metas), r_max), dtype=np.int64)
    for i, m in enumerate(metas):
        r = m.run_ends.shape[0]
        ends[i, :r] = m.run_ends
        is_rle[i, :r] = m.run_is_rle
        vals[i, :r] = m.run_values
        starts[i, :r] = m.run_bit_starts
    return PageBatch(
        bufs=torch.from_numpy(_stack_padded_bufs(raws)),
        count=count,
        width=width,
        run_ends=torch.from_numpy(ends),
        run_is_rle=torch.from_numpy(is_rle),
        run_values=torch.from_numpy(vals),
        run_bit_starts=torch.from_numpy(starts),
    )


def pack_delta_pages(raws: list[bytes], bits: int, count: int) -> PageBatch:
    """Parse + stack N DELTA_BINARY_PACKED streams of ``count`` values each."""
    metas = [parse_delta_meta(r, bits) for r in raws]
    for m in metas:
        if m.count != count:
            raise ValueError(f"page holds {m.count} values, batch expects {count}")
    m_max = max(m.mini_bit_starts.shape[0] for m in metas)
    starts = np.zeros((len(metas), m_max), dtype=np.int64)
    widths = np.zeros((len(metas), m_max), dtype=np.int32)
    mins = np.zeros((len(metas), m_max), dtype=np.uint64)
    firsts = np.zeros(len(metas), dtype=np.int64)
    for i, m in enumerate(metas):
        k = m.mini_bit_starts.shape[0]
        starts[i, :k] = m.mini_bit_starts
        widths[i, :k] = m.mini_widths
        mins[i, :k] = m.mini_min_delta
        firsts[i] = m.first_value
    return PageBatch(
        bufs=torch.from_numpy(_stack_padded_bufs(raws)),
        count=count,
        first_values=torch.from_numpy(firsts),
        mini_bit_starts=torch.from_numpy(starts),
        mini_widths=torch.from_numpy(widths),
        mini_min_delta=torch.from_numpy(mins.view(np.int64)),
        values_per_mini=metas[0].values_per_mini,
        max_width=max(1, *(int(m.mini_widths.max(initial=0)) for m in metas)),
    )


# ---------------------------------------------------------------------------
# Sharded decode steps (each rank decodes its slice of the pages)
# ---------------------------------------------------------------------------

def _local_indices(batch: PageBatch, lo: int, hi: int,
                   dev: torch.device) -> torch.Tensor:
    """The dictionary indices of pages ``[lo, hi)`` on ``dev``: int32[b,
    count] holding uint32 bits (the reference's vmapped expand)."""
    t = [x[lo:hi].to(dev) for x in (batch.bufs, batch.run_ends,
                                    batch.run_is_rle, batch.run_values,
                                    batch.run_bit_starts)]
    return torch.stack([
        K.expand_rle_hybrid(b, e, r, v, s, batch.width, batch.count)
        for b, e, r, v, s in zip(*t)])


def sharded_dict_decode(
    batch: PageBatch, dict_u8: torch.Tensor, dtype: str, mesh,
    axis: str = "data", with_stats: bool = False,
):
    """Decode a batch of dictionary-index pages and gather values, sharded.

    Pages shard across ``axis``; the dictionary replicates (it is per-chunk
    and small — ≤ 32767 entries by the format's own fallback rule).  Returns
    ``(values, stats)``: the decoded values [B, count, ...] as a DTensor
    sharded on dim 0 over ``axis``, and ``stats``, int64 ``[count, min,
    max]`` of the indices over every rank (all_reduce on the axis's group;
    zeros without ``with_stats``), the same tensor on every rank.
    """
    dev = _rank_device(mesh)
    lo, hi = _axis_slice(mesh, axis, batch.num_pages)
    idx = _local_indices(batch, lo, hi, dev)
    flat = K.dict_gather_bytes(dict_u8.to(dev), idx.reshape(-1), dtype)
    out = flat.reshape(idx.shape + flat.shape[1:])
    if with_stats:
        stats = _global_stats(idx.to(torch.int64) & 0xFFFFFFFF, mesh, axis)
    else:
        stats = torch.zeros(3, dtype=torch.int64, device=dev)
    return _sharded(out, mesh, axis), stats


def sharded_dict_decode_2d(
    batch: PageBatch, dict_u8: torch.Tensor, dtype: str, mesh,
    data_axis: str = "data", model_axis: str = "model",
):
    """Dict decode on a 2-D mesh: pages shard over ``data``, the *dictionary*
    shards over ``model`` — the expert-parallel-shaped variant for
    dictionaries too large to replicate.

    Each rank moves only its dictionary shard to its device, gathers the
    indices that fall in it (masked local gather), and an all_reduce SUM
    over the ``model`` group assembles full values: the index-routing
    pattern of MoE dispatch.  Requires an integer ``dtype`` (the sum
    assembles words exactly; float dicts replicate via
    :func:`sharded_dict_decode` instead).  Returns the values as a DTensor
    sharded on dim 0 over ``data``, replicated over ``model``.
    """
    dev = _rank_device(mesh)
    n_model = mesh.size(mesh.mesh_dim_names.index(model_axis))
    k = int(dict_u8.shape[0])
    shard_rows = (k + n_model - 1) // n_model
    pad_rows = shard_rows * n_model - k
    if pad_rows:
        dict_u8 = torch.cat(
            [dict_u8, torch.zeros((pad_rows, dict_u8.shape[1]),
                                  dtype=torch.uint8, device=dict_u8.device)])
    m = mesh.get_local_rank(model_axis)
    d_local = dict_u8[m * shard_rows:(m + 1) * shard_rows].to(dev)
    lo, hi = _axis_slice(mesh, data_axis, batch.num_pages)
    idx = _local_indices(batch, lo, hi, dev)
    flat = idx.reshape(-1).to(torch.int64) & 0xFFFFFFFF
    local = flat - m * shard_rows
    mine = (local >= 0) & (local < shard_rows)
    safe = torch.clamp(local, 0, shard_rows - 1)
    gathered = K.dict_gather_bytes(d_local, safe, dtype)
    gathered = torch.where(
        mine.reshape(mine.shape + (1,) * (gathered.dim() - 1)),
        gathered, torch.zeros((), dtype=gathered.dtype, device=dev))
    _all_reduce(gathered, dist.ReduceOp.SUM, mesh, model_axis)
    return _sharded(gathered.reshape(idx.shape + gathered.shape[1:]), mesh,
                    data_axis)


def sharded_delta_decode(
    batch: PageBatch, bits: int, mesh, axis: str = "data",
):
    """Decode a batch of DELTA_BINARY_PACKED pages, sharded over the mesh:
    a DTensor [B, count] (int32 holding the low 32 bits for ``bits`` 32,
    else int64) sharded on dim 0 over ``axis``."""
    dev = _rank_device(mesh)
    lo, hi = _axis_slice(mesh, axis, batch.num_pages)
    bufs = batch.bufs[lo:hi].to(dev)
    b, size = bufs.shape
    # the pages' buffers laid end to end: each page's miniblock offsets
    # move by its start, and the batched reconstruction reads them all
    starts = (batch.mini_bit_starts[lo:hi].to(dev)
              + (torch.arange(b, dtype=torch.int64, device=dev)
                 * (size * 8))[:, None])
    out = K.delta_reconstruct(
        bufs.reshape(-1), batch.first_values[lo:hi].to(dev), starts,
        batch.mini_widths[lo:hi].to(dev),
        batch.mini_min_delta[lo:hi].to(dev), batch.values_per_mini,
        batch.count, bits, batch.max_width)
    return _sharded(out, mesh, axis)


def sharded_plain_decode(
    bufs: torch.Tensor, dtype: str, count: int, mesh, axis: str = "data",
):
    """PLAIN fixed-width pages [B, S] → values [B, count], a DTensor sharded
    on dim 0 over ``axis``."""
    dev = _rank_device(mesh)
    lo, hi = _axis_slice(mesh, axis, int(bufs.shape[0]))
    out = torch.stack([K.plain_decode_fixed(x, dtype, count)
                       for x in bufs[lo:hi].to(dev)])
    return _sharded(out, mesh, axis)


def column_stats(values, mesh, axis: str = "data"):
    """Global ``[count, min, max]`` (int64) over a sharded int column — one
    reduction per statistic on the axis's group.

    ``values`` is a DTensor sharded on dim 0 (each rank reads its own local
    shard) or a whole tensor, identical on every rank, of which each rank
    takes its slice of dim 0.  Every shard computes local extrema; the
    all_reduces make them global without gathering the data anywhere.
    """
    from torch.distributed.tensor import DTensor

    dev = _rank_device(mesh)
    if isinstance(values, DTensor):
        local = values.to_local()
    else:
        lo, hi = _axis_slice(mesh, axis, int(values.shape[0]))
        local = values[lo:hi]
    return _global_stats(local.to(dev), mesh, axis)


# ---------------------------------------------------------------------------
# Multi-host work list → global sharded tensor
# ---------------------------------------------------------------------------

def shard_row_ranges(total_rows: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous, equal-size row spans, one per shard (last may be short).

    Equal spans are what an even ``Shard(0)`` over the row axis requires;
    each shard decodes only the row groups its span touches (boundary groups
    are decoded by both neighbors and sliced — the standard input-pipeline
    trade against cross-host exchange).  Deterministic from (total_rows,
    n_shards), so every host derives the identical plan from the footer
    alone.
    """
    if n_shards <= 0:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    per = -(-total_rows // n_shards) if total_rows else 0
    return [
        (min(i * per, total_rows), min((i + 1) * per, total_rows))
        for i in range(n_shards)
    ]


_FIXED_DTYPES = {
    Type.INT32: np.dtype(np.int32),
    Type.INT64: np.dtype(np.int64),
    Type.FLOAT: np.dtype(np.float32),
    Type.DOUBLE: np.dtype(np.float64),
    Type.BOOLEAN: np.dtype(bool),
}


def column_span_dtype(reader, column: str) -> np.dtype:
    """The numpy dtype a flat column decodes to — derivable from the schema
    alone, so shards with EMPTY spans pad with the right dtype without
    decoding anything."""
    leaf = reader.schema.leaf_by_path(tuple(column.split(".")))
    if leaf is None:
        raise KeyError(f"no such column {column!r}")
    dt = _FIXED_DTYPES.get(leaf.physical_type)
    if dt is None:
        raise TypeError(
            f"global span decode needs a fixed-width column; {column!r} is "
            f"{leaf.physical_type!r}"
        )
    return dt


def decode_row_span(reader, column: str, row_start: int, row_end: int,
                    prefetch: Optional[int] = None) -> np.ndarray:
    """Decode exactly rows [row_start, row_end) of a flat column on host.

    Touches only the row groups the span intersects (others are never read)
    and slices boundary groups.  Column selection is narrowed to the one
    requested column for the duration of the call, so sibling chunks in
    touched row groups are seeked past, not decoded.

    ``prefetch`` > 0 routes each touched group through the reader's chunk
    pipeline (reader.FileReader prefetch semantics) — the per-SHARD decode
    pipeline: every shard of a work list overlaps its own IO and
    decompression independently, so a multi-host scan pipelines on every
    host without coordination.
    """
    dtype = column_span_dtype(reader, column)
    parts = []
    base = 0
    # touched groups + their row slices, planned up front so the pipelined
    # path can run ONE window across all of them (a per-group
    # read_row_group call would drain the pool at every boundary)
    touched = []  # (index, lo, hi, n)
    for i, rg in enumerate(reader.metadata.row_groups):
        n = rg.num_rows
        lo, hi = max(row_start - base, 0), min(row_end - base, n)
        if lo < hi:
            touched.append((i, lo, hi, n))
        base += n
        if base >= row_end:
            break
    k = _reader_prefetch(reader) if prefetch is None else int(prefetch)
    prev_selected = [tuple(l.path) for l in reader.schema.selected_leaves()]
    reader.schema.set_selected([tuple(column.split("."))])
    try:
        spans = {i: (lo, hi, n) for i, lo, hi, n in touched}
        if k > 0 and hasattr(reader, "_decode_row_groups"):
            groups = reader._decode_row_groups(sorted(spans), k)
        elif hasattr(reader, "_decode_row_groups"):
            # our FileReader: honor an explicit prefetch=0 even when the
            # reader's own setting is pipelined
            groups = ((i, reader.read_row_group(i, prefetch=0))
                      for i in sorted(spans))
        else:
            # generic reader contract: bare call only
            groups = ((i, reader.read_row_group(i)) for i in sorted(spans))
        for i, cols in groups:
            lo, hi, n = spans[i]
            cd = cols[column]
            vals = cd.values
            if len(vals) != n:
                raise ValueError(
                    f"decode_row_span requires a flat required column; "
                    f"{column!r} has {len(vals)} values for {n} rows"
                )
            parts.append(np.asarray(vals)[lo:hi])
    finally:
        reader.schema.set_selected(prev_selected)
    if not parts:
        return np.zeros(0, dtype=dtype)
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _pad_span(local: np.ndarray, per: int, dtype: np.dtype) -> np.ndarray:
    """Zero-pad a decoded span to the uniform shard size (tail/empty shards)."""
    if len(local) >= per:
        return local
    return np.concatenate(
        [local.astype(dtype), np.zeros(per - len(local), dtype=dtype)]
    )


def _span_tensor(reader, column: str, spans, i: int, per: int, mesh,
                 axis: str, prefetch):
    lo, hi = spans[i]
    local = _pad_span(decode_row_span(reader, column, lo, hi,
                                      prefetch=prefetch), per,
                      column_span_dtype(reader, column))
    dev = _rank_device(mesh)
    return _sharded(torch.from_numpy(np.ascontiguousarray(local)).to(dev),
                    mesh, axis)


def global_column_array(
    reader, column: str, mesh, axis: str = "data",
    prefetch: Optional[int] = None,
):
    """Work list → one global row-sharded tensor over the mesh's ``axis``.

    The rows split into ``mesh.size(axis)`` equal spans; each rank decodes
    on host the span of its own coordinate on ``axis`` and places it on its
    device, and the DTensor (``Shard(0)`` on ``axis``, replicated on any
    other mesh axis — a 2-D mesh's ``model`` ranks hold their data
    coordinate's span) stitches the global view without exchanging rows.
    Returns ``(DTensor, valid_rows)``: the tail span is zero-padded to the
    uniform span size, so the global length is ``per * n`` — consumers mask
    with valid_rows.  See the module docstring for how this differs from
    the reference's single-process form.
    """
    total = int(reader.metadata.num_rows)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    spans = shard_row_ranges(total, n)
    per = spans[0][1] - spans[0][0] if total else 0
    return (_span_tensor(reader, column, spans, mesh.get_local_rank(axis),
                         per, mesh, axis, prefetch), total)


def process_local_column(
    reader, column: str, mesh, axis: str = "data",
    prefetch: Optional[int] = None,
):
    """True multi-host form: this process decodes only ITS span of the work
    list (spans over the processes of the world, ``process_shard()``) and
    contributes it as its shard of a DTensor over ``axis``.

    Each host computes the identical plan from the shared footer, decodes
    the rows owned by its process, and the global tensor is assembled only
    when a consumer asks (``full_tensor()``, or a collective of its own).
    The mesh's ``axis`` must span the world (one rank per span).  Without an
    initialized group this is one process decoding everything.  Returns
    ``(DTensor, valid_rows)``.
    """
    total = int(reader.metadata.num_rows)
    rank, nproc = process_shard()
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if n != nproc:
        raise ValueError(
            f"mesh axis {axis!r} has {n} ranks; process_local_column needs "
            f"one per process ({nproc})")
    spans = shard_row_ranges(total, nproc)
    per = spans[0][1] - spans[0][0] if total else 0
    return (_span_tensor(reader, column, spans, rank, per, mesh, axis,
                         prefetch), total)
