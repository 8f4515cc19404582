"""The PyTorch port's kernels and tensor code against the JAX package.

Each CUDA kernel of ``tpu_parquet_torch.cuda_kernels`` has a plain PyTorch
version; on a CPU tensor the wrapper runs that version.  Here it is held
against the Pallas kernel it replaces, run as the JAX package's own tests run
it on the CPU (``interpret=True``), and the port's ``torch_kernels`` are held
against ``jax_kernels``.  Inputs are made with numpy from a seed and handed
to both sides; every comparison is exact (decoding is a byte-exact
transform).  The CUDA kernels themselves run only on the card, where
``chip_smoke.py`` holds them against these plain versions.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_parquet import jax_decode as jd
from tpu_parquet import jax_kernels as JK
from tpu_parquet import pallas_kernels as PK
from tpu_parquet.kernels import bitpack, rle
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import torch_decode as TD
from tpu_parquet_torch import torch_kernels as TK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side, and PyTorch's default of one thread per
    core would oversubscribe the host for the tests next to these."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _u32(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor of uint32 bits as the reference's uint32 array."""
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# K1: BP-group unpack
# ---------------------------------------------------------------------------

def _k1_case(width, groups, base, seed):
    rng = np.random.default_rng(seed)
    gpad = CK.bp_groups_pad(groups)
    assert gpad == PK.bp_groups_pad(groups)  # same tiles, same read extent
    buf = rng.integers(0, 256, base + gpad * width + 16, dtype=np.uint8)
    want = np.asarray(PK.unpack_bp_groups(jnp.asarray(buf), base, width, gpad,
                                          interpret=True))
    got = CK.unpack_bp_groups(torch.from_numpy(buf), base, width, gpad)
    assert got.dtype == torch.int32 and got.shape == (gpad * 8,)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_bp_groups_matches_pallas(width):
    _k1_case(width, 700, 0, width)


@pytest.mark.parametrize("groups", [1024, 1025, 2048])
def test_unpack_bp_groups_tile_boundary(groups):
    _k1_case(13, groups, 0, groups)


@pytest.mark.parametrize("base", [64, 7, 191])
def test_unpack_bp_groups_nonzero_base(base):
    _k1_case(11, 1500, base, base)


@pytest.mark.parametrize("width,count", [(5, 8192), (5, 8193), (17, 5000),
                                         (32, 100)])
def test_unpack_bits_matches_pallas(width, count):
    rng = np.random.default_rng(count)
    vals = rng.integers(0, 1 << 32, count, dtype=np.uint64) & ((1 << width) - 1)
    packed = np.frombuffer(bitpack.pack(vals, width), np.uint8)
    want = np.asarray(PK.unpack_bits_pallas(packed, width, count,
                                            interpret=True))
    got = CK.unpack_bits(torch.from_numpy(packed.copy()), width, count)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, vals.astype(np.uint32))


def test_unpack_bp_groups_rejects_bad_arguments():
    buf = torch.zeros(4096 * 4, dtype=torch.uint8)
    with pytest.raises(ValueError):
        CK.unpack_bp_groups(buf, 0, 0, 1024)
    with pytest.raises(ValueError):
        CK.unpack_bp_groups(buf, 0, 33, 1024)
    with pytest.raises(ValueError):
        CK.unpack_bp_groups(buf, 0, 4, 1000)  # not whole tiles
    with pytest.raises(ValueError):
        CK.unpack_bp_groups(buf, 8, 16, 1024)  # reads past the buffer
    with pytest.raises(ValueError):
        CK.unpack_bp_groups(buf.to(torch.int32), 0, 1, 1024)


# ---------------------------------------------------------------------------
# K2: fused PLAIN decode
# ---------------------------------------------------------------------------

def _k2_case(width, count, vbase, n_valid, seed):
    rng = np.random.default_rng(seed)
    count_pad = CK.fused_count_pad(count)
    assert count_pad == PK.fused_count_pad(count)
    buf = rng.integers(0, 256, vbase + count_pad * width + 16, dtype=np.uint8)
    want = np.asarray(PK.fused_plain_words(
        jnp.asarray(buf), vbase, n_valid, width=width, count_pad=count_pad,
        interpret=True))
    got = CK.fused_plain_words(torch.from_numpy(buf), vbase, n_valid,
                               width=width, count_pad=count_pad)
    assert got.dtype == torch.int32 and got.shape == (count_pad, width // 4)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n_valid", [0, 1, 1023, 1024, 1025, 2048])
def test_fused_plain_words_matches_pallas(width, n_valid):
    _k2_case(width, 2048, 0, n_valid, n_valid)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("vbase", [1, 3, 13])
def test_fused_plain_words_odd_base(width, vbase):
    _k2_case(width, 3000, vbase, 2999, vbase)


def test_fused_plain_words_rejects_bad_arguments():
    buf = torch.zeros(1024 * 8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        CK.fused_plain_words(buf, 0, 1, width=2, count_pad=1024)
    with pytest.raises(ValueError):
        CK.fused_plain_words(buf, 0, 1, width=8, count_pad=1000)
    with pytest.raises(ValueError):
        CK.fused_plain_words(buf, 1, 1, width=8, count_pad=1024)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    CK.reset_launches()
    buf = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, 8192 * 8, dtype=np.uint8))
    CK.unpack_bp_groups(buf, 0, 7, 1024)
    CK.fused_plain_words(buf, 3, 100, width=8, count_pad=1024)
    CK.unpack_bits(buf, 3, 1000)
    assert CK.launches == {"unpack_bp_groups": 0, "fused_plain_words": 0}


# ---------------------------------------------------------------------------
# torch_kernels against jax_kernels
# ---------------------------------------------------------------------------

def _hybrid_inputs(values, width):
    encoded = rle.encode(np.asarray(values, dtype=np.uint64), width)
    meta = jd.parse_hybrid_meta(encoded, width, len(values))
    tmeta = TD.parse_hybrid_meta(encoded, width, len(values))
    for a in ("run_ends", "run_is_rle", "run_values", "run_bit_starts"):
        np.testing.assert_array_equal(getattr(meta, a), getattr(tmeta, a))
    padded = np.array(jd.pad_buffer(encoded))
    return padded, meta


@pytest.mark.parametrize("width", [1, 3, 8, 13, 20, 32])
@pytest.mark.parametrize("shape", ["random", "rle_heavy"])
def test_expand_rle_hybrid_matches_jax(width, shape):
    rng = np.random.default_rng(width)
    n = 3000
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64)
    if shape == "rle_heavy":
        for x in rng.integers(0, n - 600, 4):
            vals[x : x + 500] = vals[x]
    buf, m = _hybrid_inputs(vals, width)
    count = jd._bucket_count(n)
    want = np.asarray(JK.expand_rle_hybrid(
        jnp.asarray(buf), jnp.asarray(m.run_ends), jnp.asarray(m.run_is_rle),
        jnp.asarray(m.run_values), jnp.asarray(m.run_bit_starts), width,
        count, n_valid=n))
    got = TK.expand_rle_hybrid(
        torch.from_numpy(buf), torch.from_numpy(m.run_ends),
        torch.from_numpy(m.run_is_rle),
        torch.from_numpy(m.run_values.astype(np.int64)),
        torch.from_numpy(m.run_bit_starts), width, count, n_valid=n)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want[:n], vals.astype(np.uint32))


def test_expand_rle_hybrid_vw_matches_jax():
    """Two pages whose index width grows (3 bits, then 9): one merged run
    table with per-run widths, the dictionary-growth case."""
    rng = np.random.default_rng(5)
    pages = [(rng.integers(0, 8, 900, dtype=np.uint64), 3),
             (rng.integers(0, 512, 1100, dtype=np.uint64), 9)]
    raw, ends_l, rle_l, vals_l, starts_l, widths_l = b"", [], [], [], [], []
    pos0 = 0
    for vals, w in pages:
        enc = rle.encode(vals, w)
        m = jd.parse_hybrid_meta(enc, w, len(vals))
        k = m.n_runs
        ends_l.append(m.run_ends[:k] + pos0)
        rle_l.append(m.run_is_rle[:k])
        vals_l.append(m.run_values[:k])
        starts_l.append(m.run_bit_starts[:k] + len(raw) * 8 - pos0 * w)
        widths_l.append(np.full(k, w, dtype=np.uint32))
        raw += enc
        pos0 += len(vals)
    from tpu_parquet.device_reader import _merge_run_tables

    ends, isr, rv, st, rw = _merge_run_tables(
        ends_l, rle_l, vals_l, starts_l, fill_end=pos0, widths_l=widths_l)
    buf = np.array(jd.pad_buffer(raw))
    count = jd._bucket_count(pos0)
    want = np.asarray(JK.expand_rle_hybrid_vw(
        jnp.asarray(buf), jnp.asarray(ends), jnp.asarray(isr),
        jnp.asarray(rv), jnp.asarray(st), jnp.asarray(rw), 16, count,
        n_valid=pos0))
    got = TK.expand_rle_hybrid_vw(
        torch.from_numpy(buf), torch.from_numpy(ends), torch.from_numpy(isr),
        torch.from_numpy(rv.astype(np.int64)), torch.from_numpy(st),
        torch.from_numpy(rw.astype(np.int64)), 16, count, n_valid=pos0)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        want[:pos0], np.concatenate([v for v, _ in pages]).astype(np.uint32))


@pytest.mark.parametrize("max_width", [5, 25, 32])
def test_extract_bits_matches_jax(max_width):
    rng = np.random.default_rng(max_width)
    buf = rng.integers(0, 256, 400, dtype=np.uint8)
    widths = rng.integers(0, max_width + 1, 300).astype(np.int32)
    pos = rng.integers(0, 400 * 8, 300).astype(np.int64)
    want = np.asarray(JK.extract_bits(jnp.asarray(buf), jnp.asarray(pos),
                                      jnp.asarray(widths), max_width))
    got = TK.extract_bits(torch.from_numpy(buf), torch.from_numpy(pos),
                          torch.from_numpy(widths), max_width)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint32])
def test_dict_gather_matches_jax(dtype):
    rng = np.random.default_rng(1)
    dictionary = rng.integers(0, 1 << 30, 37).astype(dtype)
    idx = rng.integers(0, 37, 500).astype(np.uint32)
    with JK.enable_x64():
        want = np.asarray(JK.dict_gather(jnp.asarray(dictionary),
                                         jnp.asarray(idx)))
    assert want.dtype == dtype
    tdict = torch.from_numpy(dictionary.view(np.int32)
                             if dtype == np.uint32 else dictionary)
    got = TK.dict_gather(tdict, torch.from_numpy(idx.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(dtype), want)


def test_dict_gather_float_bits_survive():
    vals = np.array([np.nan, -0.0, 5e-324, np.inf, 1.5], dtype=np.float64)
    vals.view(np.uint64)[0] |= 0x5  # a NaN payload
    idx = np.array([0, 1, 2, 3, 4, 0, 2], dtype=np.uint32)
    want = np.asarray(JK.dict_gather_bytes(
        jnp.asarray(vals.view(np.uint8).reshape(5, 8)), jnp.asarray(idx),
        "float64")).view("<f8").reshape(-1)
    got = TK.dict_gather(torch.from_numpy(vals.view(np.int64)),
                         torch.from_numpy(idx.view(np.int32)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  want.view(np.uint64))


def test_levels_to_validity_matches_jax():
    levels = np.random.default_rng(2).integers(0, 3, 1000).astype(np.uint32)
    want = np.asarray(JK.levels_to_validity(jnp.asarray(levels), 2))
    got = TK.levels_to_validity(torch.from_numpy(levels.view(np.int32)), 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_plain_decode_fixed_matches_jax(dtype):
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 256, 8 * 257, dtype=np.uint8)
    want = np.asarray(JK.plain_decode_fixed(jnp.asarray(buf), dtype, 257))
    if dtype == "float64":  # the reference keeps u32 word pairs on device
        want = np.ascontiguousarray(want).view("<f8").reshape(-1)
    got = TK.plain_decode_fixed(torch.from_numpy(buf), dtype, 257).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_buckets_match_reference():
    for n in [0, 1, 7, 8, 9, 63, 64, 65, 1000, 4097, 123_457, 1_000_000]:
        assert TD._bucket(n) == jd._bucket(n)
        assert TD._bucket_bytes(n) == jd._bucket_bytes(n)
        assert TD._bucket_count(n) == jd._bucket_count(n)
        assert CK.bp_groups_pad(n) == PK.bp_groups_pad(n)
        assert CK.fused_count_pad(n) == PK.fused_count_pad(n)


# ---------------------------------------------------------------------------
# the port imports nothing of JAX and nothing of the JAX package
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_no_reference_module():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys

        class RefuseJax:
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith("jax."):
                    raise ImportError("jax import refused: " + name)
                return None

        sys.meta_path.insert(0, RefuseJax())
        import tpu_parquet_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpu_parquet_torch.__path__, "tpu_parquet_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "tpu_parquet" or m.startswith("tpu_parquet."))
        print(len(names), bad)
        assert not bad, bad
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split()[0])
    assert n >= 20  # every module of the package was imported
