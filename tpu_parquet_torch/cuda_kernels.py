"""Hand-written CUDA kernels for the decode hot path, with their plain versions.

The counterpart of ``tpu_parquet.pallas_kernels``.  Each Pallas TPU kernel
of the flat-column slice is a CUDA C++ kernel for Hopper (``sm_90a``) under
``csrc/``:

- **K1** ``unpack_bp_groups`` (``csrc/bp_unpack.cu``): LSB-first
  fixed-width unpack of 8-value bit-packed groups — every dictionary-index
  and def-level stream with bit-packed runs goes through it.
- **K2** ``fused_plain_words`` (``csrc/fused_plain.cu``): PLAIN 4/8-byte
  values to finished little-endian words with the validity tail zeroed —
  the ``fused_plain`` ship route.

The sources are compiled with ``nvcc`` at first use into shared libraries
with a plain C interface (one ``nvcc`` per source, started together), under
``build/tpu_parquet_torch/`` beside the package, and loaded with
``ctypes``.  Each wrapper launches its kernel on PyTorch's current stream
for a CUDA tensor, or raises; it takes the plain PyTorch version only for a
tensor on the CPU.  The plain versions compute in ``int64`` and mask
(``uint32`` tensors have no shifts here) and are what the CPU tests and the
on-card comparison run.  ``launches`` counts the kernel launches of each
wrapper.

Padding follows the reference's tiles (1024 groups, 1024 values), so padded
shapes and the read extents the stager must cover match the reference's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .torch_decode import _bucket_count
from .torch_kernels import u32_bits

__all__ = ["unpack_bp_groups", "unpack_bp_groups_plain", "unpack_bits",
           "bp_groups_pad", "fused_plain_words", "fused_plain_words_plain",
           "fused_count_pad", "launches", "reset_launches", "build",
           "KERNELS"]

_GROUPS_PER_TILE = 1024  # K1 tile: 8192 values (the reference's tile)
_FUSED_TILE = 1024       # K2 tile: values per tile (the reference's tile)

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
# kernel name -> (source under csrc/, C entry point, argtypes)
_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
KERNELS = {
    "unpack_bp_groups": ("bp_unpack.cu", "tpq_unpack_bp_groups",
                         [_VP, _LL, _LL, _INT, _LL, _VP, _VP]),
    "fused_plain_words": ("fused_plain.cu", "tpq_fused_plain_words",
                          [_VP, _LL, _LL, _INT, _LL, _LL, _VP, _VP]),
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


def _lib_path(name: str) -> str:
    src = os.path.join(_CSRC, KERNELS[name][0])
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"libtpq_{name}.{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile (if not already built) and load the kernel libraries.

    One ``nvcc`` process per source, all started together; returns
    ``{name: ctypes library}``.  Raises ``RuntimeError`` with the compiler's
    output when a build fails."""
    names = list(KERNELS) if names is None else list(names)
    with _build_lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return {n: _libs[n] for n in names}
        os.makedirs(build_dir(), exist_ok=True)
        procs = []
        for n in todo:
            path = _lib_path(n)
            if os.path.exists(path):
                continue
            tmp = f"{path}.tmp{os.getpid()}"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
                   os.path.join(_CSRC, KERNELS[n][0])]
            procs.append((n, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for n, path, tmp, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}: {out.decode(errors='replace')}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(_lib_path(n))
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


def _launch(name: str, buf: torch.Tensor, *args) -> None:
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
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
# K2: fused PLAIN decode
# ---------------------------------------------------------------------------

def fused_count_pad(count: int) -> int:
    """Pad a value count to whole K2 tiles (bucketed first, as the
    reference pads: the read extent is ``fused_count_pad(n) * width``)."""
    b = _bucket_count(max(count, 1))
    return -(-b // _FUSED_TILE) * _FUSED_TILE


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
    _launch("fused_plain_words", buf, vbase, int(width), n_valid, count_pad,
            out.data_ptr())
    return out
