"""Hand-written CUDA kernels for the decode hot path, with their plain versions.

The counterpart of ``tpu_parquet.pallas_kernels``.  Each Pallas TPU kernel
is a CUDA C++ kernel for Hopper (``sm_90a``) under ``csrc/``:

- **K1** ``hybrid_unpack_combine`` (``csrc/bp_unpack.cu``): one
  RLE/bit-packed hybrid stream in stream order, the unpack of its
  bit-packed runs fused with the run-table combine — every
  dictionary-index and def-level stream with bit-packed runs goes through
  it.  ``unpack_bp_groups`` (the same source) is K1 alone, the LSB-first
  fixed-width unpack of 8-value groups, reached through ``unpack_bits``.
- **K2** ``fused_plain_words`` (``csrc/fused_plain.cu``): PLAIN 4/8-byte
  values to finished little-endian words with the validity tail zeroed —
  the ``fused_plain`` ship route.
- **K3** ``fused_narrow_words`` (``csrc/fused_narrow.cu``): a snappy stream
  over the k-byte narrow transcode to finished, re-biased words with the
  validity tail zeroed — the ``fused_narrow_snappy`` ship route.

The sources are compiled with ``nvcc`` at first use into shared libraries
with a plain C interface (one ``nvcc`` per source, started together; one
source may hold several kernels), under
``build/tpu_parquet_torch/`` beside the package, and loaded with
``ctypes``.  Each wrapper launches its kernel on PyTorch's current stream
for a CUDA tensor, or raises; it takes the plain PyTorch version only for a
tensor on the CPU.  The plain versions compute in ``int64`` and mask
(``uint32`` tensors have no shifts here) and are what the CPU tests and the
on-card comparison run.  ``launches`` counts the kernel launches of each
wrapper.

Padding follows the reference's tiles (1024 groups, 1024 values, 256
values), so padded shapes and the read extents the stager must cover match
the reference's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .torch_decode import _bucket_count
from .torch_kernels import narrow_widen_words, u32_bits

__all__ = ["unpack_bp_groups", "unpack_bp_groups_plain", "unpack_bits",
           "bp_groups_pad", "hybrid_unpack_combine",
           "hybrid_unpack_combine_plain", "hybrid_combine_plain",
           "HYBRID_TILE", "HYBRID_WINDOW", "HYBRID_SPAN_VALUES",
           "fused_plain_words", "fused_plain_words_plain",
           "fused_count_pad", "fused_narrow_words",
           "fused_narrow_words_plain", "fused_narrow_count_pad",
           "fused_narrow_geometry", "fused_plain_geometry",
           "FUSED_MAX_OPS", "FUSED_MAX_DEPTH", "FUSED_MAX_PAYLOAD",
           "SNAPPY_OPS_BYTES",
           "launches", "reset_launches", "build", "kernel_mode", "KERNELS"]

_GROUPS_PER_TILE = 1024  # K1 tile: 8192 values (the reference's tile)
# the fused K1's geometry, as csrc/bp_unpack.cu lays it out: positions per
# block, run-table rows of a tile's window it keeps in shared memory, the
# bit-packed values it stages there (a tile over a cap reads global memory
# instead)
HYBRID_TILE = 2048
HYBRID_WINDOW = 1024
HYBRID_SPAN_VALUES = 2 * HYBRID_TILE
_FUSED_TILE = 1024       # K2 tile: values per tile (the reference's tile)
_FUSED_NS_TILE = 256     # K3 tile: values per tile (the reference's tile)
# K3 eligibility caps, the reference's: the planner declines exactly the
# streams the reference declines (those keep the unfused resolve chain)
FUSED_MAX_OPS = 4096         # padded op-table rows
FUSED_MAX_DEPTH = 16         # copy-chain depth chased per byte
FUSED_MAX_PAYLOAD = 4 << 20  # compressed payload bytes

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# kernel name -> (source under csrc/, C entry point, argtypes)
_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ULL = ctypes.c_ulonglong
KERNELS = {
    "unpack_bp_groups": ("bp_unpack.cu", "tpq_unpack_bp_groups",
                         [_VP, _LL, _LL, _INT, _LL, _VP, _VP]),
    "hybrid_unpack_combine": ("bp_unpack.cu", "tpq_hybrid_unpack_combine",
                              [_VP, _LL, _LL, _LL, _LL, _INT, _LL, _LL, _INT,
                               _VP, _VP]),
    "fused_plain_words": ("fused_plain.cu", "tpq_fused_plain_words",
                          [_VP, _LL, _LL, _INT, _LL, _LL, _INT, _INT, _VP,
                           _VP]),
    "fused_narrow_words": ("fused_narrow.cu", "tpq_fused_narrow_words",
                           [_VP, _LL, _LL, _LL, _INT, _LL, _ULL, _LL, _INT,
                            _INT, _INT, _LL, _LL, _INT, _INT, _INT, _VP,
                            _VP]),
}
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches per wrapper (plain-version calls on CPU tensors never
# count); reset_launches() zeroes them
launches = {name: 0 for name in KERNELS}

_build_lock = threading.Lock()
_libs: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def kernel_mode() -> str:
    """``"cuda"`` when a CUDA card is present: the entry points decode on
    it by default and each wrapper launches its kernel (built from
    ``csrc/`` at first use); ``"plain"`` when only CPU tensors can be
    decoded, by the kernels' plain versions.  The ledger's environment
    fingerprint records it (the counterpart of the reference's
    ``pallas_mode``): a ``plain`` run's device numbers are not kernel
    measurements."""
    return "cuda" if torch.cuda.is_available() else "plain"


def build_dir() -> str:
    """Where the kernel libraries are built: ``build/tpu_parquet_torch``
    beside the package directory."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "build", "tpu_parquet_torch")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "tpu_parquet_torch/csrc at first use")
    return found


def _lib_path(src: str) -> str:
    h = hashlib.sha256()
    with open(os.path.join(_CSRC, src), "rb") as f:
        h.update(f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    stem = os.path.splitext(src)[0]
    return os.path.join(build_dir(), f"libtpq_{stem}.{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile (if not already built) and load the kernel libraries.

    One ``nvcc`` process per source, all started together, however many
    kernels a source holds; returns ``{name: ctypes library}``.  Raises
    ``RuntimeError`` with the compiler's output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        os.makedirs(build_dir(), exist_ok=True)
        procs = []
        for src in sorted({KERNELS[n][0] for n in todo}):
            path = _lib_path(src)
            if os.path.exists(path):
                continue
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, src)]
            procs.append((src, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, path, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src}: {out.decode(errors='replace')}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        loaded = {}
        for n in todo:
            path = _lib_path(KERNELS[n][0])
            if path not in loaded:
                loaded[path] = ctypes.CDLL(path)
            lib = loaded[path]
            fn = getattr(lib, KERNELS[n][1])
            fn.argtypes = KERNELS[n][2]
            fn.restype = ctypes.c_int
            _libs[n] = lib
        return {n: _libs[n] for n in names}


def _entry(name: str):
    return getattr(build([name])[name], KERNELS[name][1])


def _check_buf(buf: torch.Tensor) -> None:
    if not isinstance(buf, torch.Tensor):
        raise TypeError("expected a torch.Tensor staged buffer")
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("the staged buffer must be a contiguous 1-D uint8 "
                         f"tensor, got {buf.dtype} {tuple(buf.shape)}")


def _device_kind(buf: torch.Tensor) -> str:
    kind = buf.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {buf.device}")
    return kind


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _profiled(name: str):
    """A ``record_function`` span named as the wrapper while a
    ``torch.profiler`` capture runs (a trace then names the kernel by its
    wrapper, beside its CUDA symbol); nothing otherwise."""
    if (getattr(torch.autograd.profiler, "_is_profiler_enabled", False)
            or torch._C._autograd._profiler_enabled()):
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _launch(name: str, buf: torch.Tensor, *args) -> None:
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device), _profiled(name):
        rc = _entry(name)(buf.data_ptr(), buf.numel(), *args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {rc})")
    launches[name] += 1


# ---------------------------------------------------------------------------
# K1: BP-group unpack
# ---------------------------------------------------------------------------

def bp_groups_pad(groups: int) -> int:
    """Pad a group count to whole K1 tiles (bucketed first, as the
    reference pads: the read extent is ``bp_groups_pad(g) * width``)."""
    b = _bucket_count(max(groups, 1))
    return -(-b // _GROUPS_PER_TILE) * _GROUPS_PER_TILE


def unpack_bp_groups_plain(buf: torch.Tensor, bp_base: int, width: int,
                           groups_pad: int) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments and result)."""
    rows = buf[bp_base : bp_base + groups_pad * width].to(torch.int64)
    rows = rows.reshape(groups_pad, width)
    mask = (1 << width) - 1
    cols = []
    for j in range(8):
        start, shift = (j * width) // 8, (j * width) % 8
        nbytes = (shift + width + 7) // 8
        acc = torch.zeros(groups_pad, dtype=torch.int64, device=buf.device)
        for k in range(nbytes):
            acc = acc | (rows[:, start + k] << (8 * k))
        cols.append((acc >> shift) & mask)
    return u32_bits(torch.stack(cols, dim=1).reshape(-1))


def unpack_bp_groups(buf: torch.Tensor, bp_base: int, width: int,
                     groups_pad: int) -> torch.Tensor:
    """Unpack ``groups_pad`` 8-value groups of ``width``-bit values starting
    at byte ``bp_base`` of the staged buffer ``buf``.

    Returns ``int32[groups_pad * 8]`` holding the ``uint32`` values; groups
    past the real payload decode whatever bytes follow it (callers select
    only real positions).  ``groups_pad`` must come from
    :func:`bp_groups_pad`, and the buffer must cover
    ``bp_base + groups_pad * width`` bytes (the stager's read extent)."""
    _check_buf(buf)
    if not 1 <= width <= 32:
        raise ValueError(f"unpack_bp_groups supports widths 1..32, got {width}")
    if groups_pad <= 0 or groups_pad % _GROUPS_PER_TILE:
        raise ValueError(f"groups_pad {groups_pad} not a positive multiple "
                         f"of {_GROUPS_PER_TILE}")
    bp_base = int(bp_base)
    if bp_base < 0 or bp_base + groups_pad * width > buf.numel():
        raise ValueError(
            f"unpack_bp_groups reads [{bp_base}, "
            f"{bp_base + groups_pad * width}) past a {buf.numel()}-byte buffer")
    if _device_kind(buf) == "cpu":
        return unpack_bp_groups_plain(buf, bp_base, width, groups_pad)
    out = torch.empty(groups_pad * 8, dtype=torch.int32, device=buf.device)
    _launch("unpack_bp_groups", buf, bp_base, int(width), groups_pad,
            out.data_ptr())
    return out


def unpack_bits(buf: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Fixed-width LSB-first unpack of ``count`` values from the start of
    ``buf`` through K1 (the counterpart of ``unpack_bits_pallas``): the
    bytes are padded to whole tiles, unpacked, and cut to ``count``.
    Returns ``int32[count]`` holding the ``uint32`` values."""
    _check_buf(buf)
    if not 1 <= width <= 32:
        raise ValueError(f"unpack_bits supports widths 1..32, got {width}")
    groups = -(-count // 8)
    gpad = -(-max(groups, 1) // _GROUPS_PER_TILE) * _GROUPS_PER_TILE
    need = gpad * width
    padded = torch.zeros(need, dtype=torch.uint8, device=buf.device)
    n = min(buf.numel(), need)
    padded[:n] = buf[:n]
    return unpack_bp_groups(padded, 0, width, gpad)[:count]


# ---------------------------------------------------------------------------
# K1 fused with the run-table combine: one hybrid stream in stream order
# ---------------------------------------------------------------------------

_I32_MAX = (1 << 31) - 1
HYBRID_TABLE_BYTES = 13  # ends i32 + is_rle u8 + values u32 + bp_idx_base i32


def hybrid_combine_plain(vals: torch.Tensor, buf: torch.Tensor, tbase: int,
                         n_valid: int, *, count: int, rp: int) -> torch.Tensor:
    """Combine unpacked BP values ``vals`` with the RLE runs into stream
    order: the counterpart of the reference's ``_hybrid_combine_staged_jit``.

    Every output position finds its run with one searchsorted, then either
    broadcasts the RLE value or picks its BP element at
    ``bp_idx_base[run] + pos``.  The run table rides the staged buffer at
    ``tbase`` (layout [ends i32 | is_rle u8 | values u32 | bp_idx_base i32]
    x rp); the index math is int32 like the reference's.  Lanes at or past
    ``n_valid`` are zeroed."""
    tab = buf[tbase : tbase + HYBRID_TABLE_BYTES * rp]
    ends = tab[: 4 * rp].view(torch.int32)
    isr = tab[4 * rp : 5 * rp] != 0
    rvals = tab[5 * rp : 9 * rp].view(torch.int32)
    bib = tab[9 * rp :].view(torch.int32)
    pos = torch.arange(count, dtype=torch.int32, device=buf.device)
    r = torch.searchsorted(ends, pos, right=True)
    r = torch.clamp(r, max=rp - 1)
    bp_idx = torch.clamp(bib[r] + pos, 0, vals.shape[0] - 1)
    out = torch.where(isr[r], rvals[r], vals[bp_idx.long()])
    return torch.where(pos < n_valid, out, torch.zeros_like(out))


def hybrid_unpack_combine_plain(buf: torch.Tensor, bp_base: int, tbase: int,
                                n_valid: int, *, width: int, gpad: int,
                                count: int, rp: int) -> torch.Tensor:
    """Plain PyTorch version of the fused K1 (same arguments and result):
    the unfused chain, K1's plain version then the combine."""
    vals = unpack_bp_groups_plain(buf, bp_base, width, gpad)
    return hybrid_combine_plain(vals, buf, tbase, n_valid, count=count,
                                rp=rp)


def hybrid_unpack_combine(buf: torch.Tensor, bp_base: int, tbase: int,
                          n_valid: int, *, width: int, gpad: int, count: int,
                          rp: int) -> torch.Tensor:
    """Decode one RLE/bit-packed hybrid stream in ONE pass: K1's unpack of
    the bit-packed runs fused with the run-table combine.

    The staged buffer ``buf`` holds the stream's bit-packed payload,
    contiguous in stream order, at ``bp_base`` (any byte offset;
    ``gpad`` 8-value groups of ``width`` bits are readable from there) and
    its run table at ``tbase`` (4-byte aligned, ``rp`` rows of [ends i32 |
    is_rle u8 | values u32 | bp_idx_base i32], ``ends`` non-decreasing).
    Position ``pos < count`` takes its run's RLE value or the bit-packed
    value at ``clamp(bp_idx_base[run] + pos, 0, gpad * 8 - 1)``; positions
    at or past ``n_valid`` are 0.  Returns ``int32[count]`` holding the
    ``uint32`` values.  ``gpad`` must come from :func:`bp_groups_pad`."""
    _check_buf(buf)
    if not 1 <= width <= 32:
        raise ValueError(f"hybrid_unpack_combine supports widths 1..32, got "
                         f"{width}")
    if rp < 8 or rp & (rp - 1):
        raise ValueError(f"rp {rp} is not a power of two >= 8")
    if gpad <= 0 or gpad % _GROUPS_PER_TILE or gpad * 8 > _I32_MAX + 1:
        raise ValueError(f"gpad {gpad} not a positive multiple of "
                         f"{_GROUPS_PER_TILE} within int32 positions")
    if not 0 < count <= _I32_MAX - HYBRID_TILE:
        raise ValueError(f"count {count} outside 1..2**31 - 1 - "
                         f"{HYBRID_TILE} (int32 positions)")
    bp_base, tbase, n_valid = int(bp_base), int(tbase), int(n_valid)
    tend = tbase + HYBRID_TABLE_BYTES * rp
    if tbase < 0 or tend > buf.numel():
        raise ValueError(f"hybrid_unpack_combine tables [{tbase}, {tend}) "
                         f"past a {buf.numel()}-byte buffer")
    if (buf.data_ptr() + tbase) % 4:
        raise ValueError(f"hybrid_unpack_combine tables at {tbase} are not "
                         f"4-byte aligned")
    if bp_base < 0 or bp_base + gpad * width > buf.numel():
        raise ValueError(
            f"hybrid_unpack_combine reads [{bp_base}, "
            f"{bp_base + gpad * width}) past a {buf.numel()}-byte buffer")
    if _device_kind(buf) == "cpu":
        return hybrid_unpack_combine_plain(buf, bp_base, tbase, n_valid,
                                           width=width, gpad=gpad,
                                           count=count, rp=rp)
    out = torch.empty(count, dtype=torch.int32, device=buf.device)
    _launch("hybrid_unpack_combine", buf, bp_base, tbase, n_valid,
            int(width), int(gpad), int(count), int(rp), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K2: fused PLAIN decode
# ---------------------------------------------------------------------------

def fused_count_pad(count: int) -> int:
    """Pad a value count to whole K2 tiles (bucketed first, as the
    reference pads: the read extent is ``fused_count_pad(n) * width``)."""
    b = _bucket_count(max(count, 1))
    return -(-b // _FUSED_TILE) * _FUSED_TILE


_K2_THREADS = 256  # threads per block: 8 warps
_K2_TILE = 32      # 16-byte chunks per warp span, one per lane


def fused_plain_geometry(count_pad: int, width: int, sm_count: int) -> tuple:
    """One K2 launch's ``(grid, steps)``: a warp moves ``steps`` spans of
    32 16-byte chunks at once.  Four spans in flight where the data fills
    every SM with blocks of such tiles, else one, so that a small page
    still spreads over the SMs; the grid is at most four blocks per SM,
    striding over the tiles."""
    chunks = count_pad * width // 16
    warps_per_block = _K2_THREADS // 32
    steps = 4 if chunks // (_K2_TILE * 4 * warps_per_block) >= sm_count else 1
    tiles = chunks // (_K2_TILE * steps)
    grid = min(-(-tiles // warps_per_block), 4 * sm_count)
    return grid, steps


def fused_plain_words_plain(buf: torch.Tensor, vbase: int, n_valid: int, *,
                            width: int, count_pad: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (same arguments and result)."""
    raw = buf[vbase : vbase + count_pad * width].to(torch.int64)
    raw = raw.reshape(count_pad, width // 4, 4)
    words = (raw[..., 0] | (raw[..., 1] << 8) | (raw[..., 2] << 16)
             | (raw[..., 3] << 24))
    keep = torch.arange(count_pad, device=buf.device) < n_valid
    return u32_bits(torch.where(keep[:, None], words,
                                torch.zeros_like(words)))


def fused_plain_words(buf: torch.Tensor, vbase: int, n_valid: int, *,
                      width: int, count_pad: int) -> torch.Tensor:
    """Fused PLAIN fixed-width decode: the value bytes at ``vbase`` (any
    byte offset) of the staged buffer become finished little-endian words,
    ``int32[count_pad, width // 4]`` holding ``uint32`` bits, with rows at
    or past ``n_valid`` zeroed — decode and validity in one pass.

    ``count_pad`` must come from :func:`fused_count_pad`, and the buffer must
    cover ``vbase + count_pad * width`` bytes (the stager's read extent)."""
    _check_buf(buf)
    if width not in (4, 8):
        raise ValueError(f"fused plain supports widths 4/8, got {width}")
    if count_pad <= 0 or count_pad % _FUSED_TILE:
        raise ValueError(f"count_pad {count_pad} not a positive multiple of "
                         f"{_FUSED_TILE}")
    vbase = int(vbase)
    if vbase < 0 or vbase + count_pad * width > buf.numel():
        raise ValueError(
            f"fused_plain_words reads [{vbase}, {vbase + count_pad * width}) "
            f"past a {buf.numel()}-byte buffer")
    n_valid = int(n_valid)
    if _device_kind(buf) == "cpu":
        return fused_plain_words_plain(buf, vbase, n_valid, width=width,
                                       count_pad=count_pad)
    out = torch.empty((count_pad, width // 4), dtype=torch.int32,
                      device=buf.device)
    grid, steps = fused_plain_geometry(count_pad, width,
                                       _sm_count(buf.device.index))
    _launch("fused_plain_words", buf, vbase, int(width), n_valid, count_pad,
            steps, grid, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K3: fused narrow+snappy decode
# ---------------------------------------------------------------------------

# packed op-table bytes per op row: ends/asrc/offs int32 + islit uint8
SNAPPY_OPS_BYTES = 13
_K3_THREADS = 512         # threads per block, one value each per stride
_K3_BLOCKS_PER_SM = 1     # blocks per SM: each copies the tables once
_K3_INDEX_ENTRIES = 4096  # coarse op index entries (uint16): buckets + 1


def fused_narrow_count_pad(count: int) -> int:
    """Pad a value count to whole K3 tiles (bucketed first, as the
    reference pads)."""
    b = _bucket_count(max(count, 1))
    return -(-b // _FUSED_NS_TILE) * _FUSED_NS_TILE


def fused_narrow_geometry(count_pad: int, n_ops_pad: int, out_pad: int,
                          sm_count: int) -> tuple:
    """One K3 launch's ``(grid, shift, smem_bytes)``.

    The coarse op index has one entry per bucket of ``2**shift`` output
    bytes plus one, at most ``_K3_INDEX_ENTRIES``: ``shift`` is the least
    that fits ``out_pad``.  The block's shared memory holds the op tables
    as staged (at their address modulo 16, so 16 spare bytes), the uint16
    index and 32 ints of scan scratch, each part rounded to 16 bytes, as
    ``fused_narrow.cu`` lays them out.  The grid is at most
    ``_K3_BLOCKS_PER_SM`` blocks per SM, striding over the values."""
    shift = 0
    while ((out_pad + (1 << shift) - 1) >> shift) + 1 > _K3_INDEX_ENTRIES:
        shift += 1
    entries = ((out_pad + (1 << shift) - 1) >> shift) + 1
    smem = (((SNAPPY_OPS_BYTES * n_ops_pad + 31) & ~15)
            + ((2 * entries + 15) & ~15) + 32 * 4)
    grid = min(-(-count_pad // _K3_THREADS), _K3_BLOCKS_PER_SM * sm_count)
    return grid, shift, smem


def fused_narrow_words_plain(buf: torch.Tensor, tbase: int, pbase: int,
                             bias: int, n_valid: int, *, k: int, width: int,
                             depth: int, count_pad: int, out_pad: int,
                             n_ops_pad: int, ppad: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (same arguments and result): every
    output byte's op by a searchsorted, the copy chain chased ``depth + 1``
    rounds, then widen, re-bias and the tail mask."""
    n = n_ops_pad
    tab = buf[tbase : tbase + SNAPPY_OPS_BYTES * n]
    ends = tab[: 4 * n].view(torch.int32)
    asrc = tab[4 * n : 8 * n].view(torch.int32)
    offs = tab[8 * n : 12 * n].view(torch.int32)
    islit = tab[12 * n :] != 0
    payload = buf[pbase : pbase + ppad]
    dev = buf.device
    p = torch.clamp(torch.arange(count_pad * k, dtype=torch.int32,
                                 device=dev), 0, out_pad - 1)
    src = torch.zeros_like(p)
    done = torch.zeros(p.shape, dtype=torch.bool, device=dev)
    for _ in range(depth + 1):
        op = torch.clamp(torch.searchsorted(ends, p, right=True), max=n - 1)
        prev = ends[torch.clamp(op - 1, min=0)]
        within = p - torch.where(op > 0, prev, torch.zeros_like(prev))
        lit = islit[op]
        a = asrc[op]
        src = torch.where(lit & ~done, a + within, src)
        done = done | lit
        p = torch.where(lit, p, a + torch.remainder(
            within, torch.clamp(offs[op], min=1)))
    idx = torch.clamp(src, 0, payload.shape[0] - 1).long()
    raw = payload[idx].reshape(count_pad, k)
    words = narrow_widen_words(raw, bias, width=width)
    keep = torch.arange(count_pad, device=dev) < n_valid
    return torch.where(keep[:, None], words, torch.zeros_like(words))


def fused_narrow_words(buf: torch.Tensor, tbase: int, pbase: int, bias: int,
                       n_valid: int, *, k: int, width: int, depth: int,
                       count_pad: int, out_pad: int, n_ops_pad: int,
                       ppad: int) -> torch.Tensor:
    """Fused narrow+snappy decode in ONE pass: resolve each output byte of a
    snappy stream over the ``k``-byte narrow transcode through its op
    tables, widen, add ``bias`` (the column minimum, modulo
    ``2**(8*width)``) and zero the rows at or past ``n_valid``.

    The staged buffer ``buf`` holds the padded op tables at ``tbase``
    (``ends``/``asrc``/``offs`` int32 then ``islit`` uint8, ``n_ops_pad``
    rows each; literal sources PAYLOAD-relative) and the compressed payload
    at ``pbase`` (``ppad`` bytes).  ``depth`` is the exact max copy-chain
    depth from the host's tag walk; ``out_pad`` the stream's padded output
    space.  Returns ``int32[count_pad, width // 4]`` holding ``uint32``
    words; ``count_pad`` must come from :func:`fused_narrow_count_pad`."""
    _check_buf(buf)
    if width not in (4, 8) or not 1 <= k <= width:
        raise ValueError(f"fused narrow: bad k={k}/width={width}")
    if count_pad <= 0 or count_pad % _FUSED_NS_TILE:
        raise ValueError(f"count_pad {count_pad} not a positive multiple of "
                         f"{_FUSED_NS_TILE}")
    if not 0 <= depth <= FUSED_MAX_DEPTH:
        raise ValueError(f"depth {depth} outside 0..FUSED_MAX_DEPTH")
    if n_ops_pad <= 0 or out_pad <= 0 or ppad <= 0:
        raise ValueError("fused narrow: n_ops_pad, out_pad and ppad must be "
                         "positive")
    if n_ops_pad > FUSED_MAX_OPS:
        raise ValueError(f"n_ops_pad {n_ops_pad} over FUSED_MAX_OPS")
    tbase, pbase = int(tbase), int(pbase)
    tend = tbase + SNAPPY_OPS_BYTES * n_ops_pad
    if tbase < 0 or tend > buf.numel():
        raise ValueError(f"fused_narrow_words tables [{tbase}, {tend}) past "
                         f"a {buf.numel()}-byte buffer")
    if (buf.data_ptr() + tbase) % 4:
        raise ValueError(f"fused_narrow_words tables at {tbase} are not "
                         f"4-byte aligned")
    if pbase < 0 or pbase + ppad > buf.numel():
        raise ValueError(f"fused_narrow_words payload [{pbase}, "
                         f"{pbase + ppad}) past a {buf.numel()}-byte buffer")
    n_valid = int(n_valid)
    bias = int(bias) % (1 << 64)
    if _device_kind(buf) == "cpu":
        return fused_narrow_words_plain(
            buf, tbase, pbase, bias, n_valid, k=k, width=width, depth=depth,
            count_pad=count_pad, out_pad=out_pad, n_ops_pad=n_ops_pad,
            ppad=ppad)
    out = torch.empty((count_pad, width // 4), dtype=torch.int32,
                      device=buf.device)
    grid, shift, smem = fused_narrow_geometry(
        count_pad, n_ops_pad, out_pad, _sm_count(buf.device.index))
    _launch("fused_narrow_words", buf, tbase, pbase, int(n_ops_pad),
            int(ppad), bias, n_valid, int(k), int(width), int(depth),
            int(out_pad), int(count_pad), shift, smem, grid, out.data_ptr())
    return out
