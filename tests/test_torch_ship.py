"""The port's ship planner and the device halves of its compressed routes,
against the JAX package.

- The planner: for a grid of ``ChunkFacts`` the port's
  ``tpu_parquet_torch.ship.ShipPlanner`` gives the same route order and the
  same modelled costs as the reference's ``ShipPlanner(fuse=True)``,
  unforced and under every forced route, at the reference's planning point
  (350 MB/s) and at 50,000 MB/s.
- K3: ``cuda_kernels.fused_narrow_words`` on CPU tensors (its plain PyTorch
  version) against ``pallas_kernels.fused_narrow_words(..., interpret=True)``
  on op tables built from a seed by ``chip_smoke.synth_ops`` (the generator
  the card's check uses), staged as ``chip_smoke.stage_k3`` stages them: every k at widths 4 and 8, chain depths 0,
  1, 12 and 16, overlapping copies and literal-only streams, 8 and 4096 op
  rows, a bias whose low word carries and negative minima, ``n_valid`` at
  and beside a 256-value tile edge, and payloads at odd offsets.
- The unfused chain: ``torch_kernels.snappy_resolve`` against
  ``jax_kernels.snappy_resolve`` on tables that the port's own host code
  (``device_reader._plan_snappy_ops``) builds from real snappy streams, with
  copy chains deep enough for 0, 2, 4 and 8 pointer-doubling rounds.

Every comparison is exact: decoding is a byte-exact transform.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import stage_k3, synth_ops
from tpu_parquet import jax_kernels as JK
from tpu_parquet import pallas_kernels as PK
from tpu_parquet import ship as RS
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import native
from tpu_parquet_torch import ship as TS
from tpu_parquet_torch import torch_kernels as TK
from tpu_parquet_torch.torch_decode import _bucket, _bucket_bytes


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_env(monkeypatch):
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_route_registry_and_constants_match_reference():
    assert TS.ROUTES == RS.ROUTES
    assert TS.UNFUSED_OF == RS.UNFUSED_OF
    assert TS.FUSED_OF == RS.FUSED_OF
    assert TS.FUSED_ROUTES == RS.FUSED_ROUTES
    for name in ("DEFAULT_LINK_MBPS", "HOST_TRANSCODE_MBPS",
                 "HOST_COMPRESS_MBPS", "HOST_DECOMPRESS_MBPS",
                 "DEVICE_RESOLVE_MBPS", "SNAPPY_WORTH_RATIO",
                 "MIN_COMPRESS_BYTES", "EST_NARROW_SNAPPY_RATIO",
                 "EST_RECOMPRESS_RATIO", "HBM_SPILL_PASSES"):
        assert getattr(TS, name) == getattr(RS, name), name


def _facts_grid(width):
    for (logical, narrow_k, narrow_possible, comp, ready, flat,
         native_ok) in itertools.product(
            (0, 4_000, 160_000, 8_000_000), range(6), (False, True),
            (False, True), (False, True), (False, True), (False, True)):
        kw = dict(logical=logical, width=width, narrow_k=narrow_k,
                  narrow_possible=narrow_possible,
                  comp_bytes=logical * 3 // 10 if comp else 0,
                  native=native_ok, host_bytes_ready=ready, flat=flat)
        yield TS.ChunkFacts(**kw), RS.ChunkFacts(**kw)


@pytest.mark.parametrize("link_mbps", [350.0, 50_000.0])
@pytest.mark.parametrize("width", [0, 4, 8])
def test_planner_matches_reference(no_env, width, link_mbps):
    port = TS.ShipPlanner(link_mbps=link_mbps)
    ref = RS.ShipPlanner(link_mbps=link_mbps, fuse=True)
    n = 0
    for tf, rf in _facts_grid(width):
        assert TS.fused_eligible(tf) == RS.fused_eligible(rf)
        order, costs = port.plan(tf)
        r_order, r_costs = ref.plan(rf)
        assert order == r_order, tf
        assert costs == r_costs, tf
        assert port.device_costs(tf) == ref.device_costs(rf), tf
        n += 1
    assert n == 4 * 6 * 2 ** 5


@pytest.mark.parametrize("route", TS.ROUTES)
def test_forced_planner_matches_reference(no_env, route):
    no_env.setenv("TPQ_FORCE_ROUTE", route)
    port, ref = TS.ShipPlanner(), RS.ShipPlanner(fuse=True)
    assert port.force == ref.force == route
    for tf, rf in _facts_grid(8):
        assert port.plan(tf) == ref.plan(rf), tf


def test_planner_reads_the_environment_as_the_reference(no_env):
    no_env.setenv("TPQ_LINK_MBPS", "50000")
    no_env.setenv("TPQ_DEVICE_MBPS", " 1234.5 ")
    port, ref = TS.ShipPlanner(), RS.ShipPlanner(fuse=True)
    assert (port.link_mbps, port.device_mbps) == (50_000.0, 1234.5)
    assert (ref.link_mbps, ref.device_mbps) == (50_000.0, 1234.5)
    no_env.setenv("TPQ_LINK_MBPS", "fast")
    no_env.setenv("TPQ_DEVICE_MBPS", "0")
    no_env.setenv("TPQ_FORCE_ROUTE", "warp")
    port, ref = TS.ShipPlanner(), RS.ShipPlanner(fuse=True)
    assert port.link_mbps == ref.link_mbps == TS.DEFAULT_LINK_MBPS
    assert port.device_mbps == ref.device_mbps == 1.0  # clamped
    assert port.force is None and ref.force is None
    with pytest.raises(ValueError):
        TS.ShipPlanner(force="warp")


# ---------------------------------------------------------------------------
# K3: fused narrow+snappy
# ---------------------------------------------------------------------------

# (width, k, depth, n_ops, count, n_valid, bias, pbase offset, literal only)
K3_CASES = [
    (4, 1, 16, 40, 300, 256, -(1 << 31), 1, False),
    (4, 2, 12, 500, 2048, 257, (1 << 31) + 12345, 3, False),
    (4, 3, 1, 3, 1000, 255, -5, 0, False),
    (4, 4, 0, 40, 1024, 1024, 0xFFFFFF00, 7, True),
    (8, 1, 16, 700, 1500, 1500, -(1 << 63), 5, False),
    (8, 2, 12, 900, 2048, 2000, 19_000, 0, False),
    (8, 3, 1, 3, 600, 512, (1 << 40) + 0xFFFFFFF0, 9, False),
    (8, 4, 0, 64, 700, 513, -1, 2, True),
    (8, 5, 1, 3500, 512, 511, 0xFFFFFFFF, 11, False),
    (8, 6, 0, 3500, 512, 257, (1 << 63) - 3, 1, True),
    (8, 7, 1, 300, 256, 256, -(1 << 40), 13, False),
    (8, 8, 0, 3, 256, 100, 0x7FFFFFFFFFFFFFFF, 3, True),
    # the redesign's edges: a literal-only stream of a handful of ops over
    # a 1 MiB output (the coarse index's large buckets), 4096 op rows at
    # depth 16, and k = 8 at width 8 with every row valid
    (4, 2, 0, 4, 1 << 19, (1 << 19) - 3, 8035, 6, True),
    (8, 3, 16, 3500, 2048, 2048, -(1 << 35), 4, False),
    (8, 8, 12, 600, 1024, 1024, (1 << 64) - 1, 10, False),
]


@pytest.mark.parametrize(
    "width,k,depth,n_ops,count,n_valid,bias,podd,literal_only", K3_CASES,
    ids=[f"w{c[0]}-k{c[1]}-d{c[2]}" for c in K3_CASES])
def test_fused_narrow_words_matches_pallas(width, k, depth, n_ops, count,
                                           n_valid, bias, podd,
                                           literal_only):
    rng = np.random.default_rng(width * 100 + k * 10 + depth)
    count_pad = CK.fused_narrow_count_pad(count)
    assert count_pad == PK.fused_narrow_count_pad(count)
    out_len = count * k
    tables, payload = synth_ops(rng, out_len, depth, n_ops, literal_only)
    n_ops_pad = _bucket(len(tables[0]))
    if n_ops <= 8 or n_ops >= 3000:  # the table-size edges: 8 and 4096 rows
        assert n_ops_pad == (8 if n_ops <= 8 else CK.FUSED_MAX_OPS)
    out_pad = _bucket_bytes(out_len + 8, 8)
    buf, tbase, pbase, ppad = stage_k3(torch, tables, payload, n_ops_pad,
                                       out_pad, podd, torch.device("cpu"))
    host = buf.numpy()
    tabs = [host[tbase + 4 * i * n_ops_pad : tbase + 4 * (i + 1) * n_ops_pad]
            .view(np.int32) for i in range(3)]
    tabs.append(host[tbase + 12 * n_ops_pad : tbase + 13 * n_ops_pad])
    bu = bias % (1 << 64)
    bias2 = np.array([[bu & 0xFFFFFFFF, bu >> 32]], np.uint32)
    want = np.asarray(PK.fused_narrow_words(
        jnp.asarray(host[pbase : pbase + ppad]), *map(jnp.asarray, tabs),
        jnp.asarray(bias2), n_valid, k=k, width=width, depth=depth,
        count_pad=count_pad, out_pad=out_pad, interpret=True))
    got = CK.fused_narrow_words(
        buf, tbase, pbase, bias, n_valid, k=k, width=width, depth=depth,
        count_pad=count_pad, out_pad=out_pad, n_ops_pad=n_ops_pad, ppad=ppad)
    assert got.dtype == torch.int32 and got.shape == (count_pad, width // 4)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not want[n_valid:].any() and want[:n_valid].any()


def test_fused_narrow_words_rejects_bad_arguments():
    buf = torch.zeros(4096, dtype=torch.uint8)
    ok = dict(k=2, width=8, depth=3, count_pad=256, out_pad=512,
              n_ops_pad=8, ppad=64)
    CK.fused_narrow_words(buf, 0, 1024, 0, 10, **ok)
    for bad in (dict(k=0), dict(k=5, width=4), dict(width=2),
                dict(count_pad=1000), dict(depth=CK.FUSED_MAX_DEPTH + 1),
                dict(ppad=4096)):
        with pytest.raises(ValueError):
            CK.fused_narrow_words(buf, 0, 1024, 0, 10, **{**ok, **bad})
    with pytest.raises(ValueError):
        CK.fused_narrow_words(buf, 2, 1024, 0, 10, **ok)  # tables unaligned
    with pytest.raises(ValueError):
        CK.fused_narrow_words(buf, 4000, 1024, 0, 10, **ok)  # tables past
    with pytest.raises(ValueError):
        CK.fused_narrow_words(buf.to(torch.int32), 0, 1024, 0, 10, **ok)


def test_fused_narrow_words_rejects_tables_over_the_cap():
    buf = torch.zeros(1 << 17, dtype=torch.uint8)
    n = 2 * CK.FUSED_MAX_OPS
    with pytest.raises(ValueError):
        CK.fused_narrow_words(buf, 0, 13 * n, 0, 10, k=2, width=8, depth=3,
                              count_pad=256, out_pad=512, n_ops_pad=n,
                              ppad=64)


@pytest.mark.parametrize("out_pad", [8, 520, 8192, 163_840, (1 << 20) + 8,
                                     (1 << 24) + 8])
@pytest.mark.parametrize("n_ops_pad", [8, 512, 4096])
def test_fused_narrow_geometry(out_pad, n_ops_pad):
    count_pad = CK.fused_narrow_count_pad(max(out_pad // 4, 1))
    grid, shift, smem = CK.fused_narrow_geometry(count_pad, n_ops_pad,
                                                 out_pad, 132)
    # the coarse index fits its 4096 entries with the least bucket that does
    entries = lambda s: -(-out_pad >> s) + 1  # noqa: E731
    assert entries(shift) <= 4096
    assert shift == 0 or entries(shift - 1) > 4096
    # shared memory as the kernel lays it out: tables (+16 for their
    # alignment), index, scan scratch; within one block's limit
    assert smem == (-(-(13 * n_ops_pad + 16) // 16) * 16
                    + -(-2 * entries(shift) // 16) * 16 + 128)
    assert smem <= 61_584 < 227 * 1024
    # one 512-thread block per SM at most, every value covered by a stride
    assert grid == min(-(-count_pad // 512), 132)


def test_fused_narrow_geometry_at_the_main_path_shape():
    # the first row group of the K3 file's dates: 65,536 values, k = 2,
    # 4,096 op rows, out_pad 163,840: 64-byte buckets, 128 blocks
    assert CK.fused_narrow_geometry(65_536, 4096, 163_840, 132) == (
        128, 6, 58_528)


def test_k3_caps_match_reference():
    assert CK.FUSED_MAX_OPS == PK.FUSED_MAX_OPS
    assert CK.FUSED_MAX_DEPTH == PK.FUSED_MAX_DEPTH
    assert CK.FUSED_MAX_PAYLOAD == PK.FUSED_MAX_PAYLOAD
    for n in (1, 255, 256, 257, 20_000, 65_536, 36_224):
        assert CK.fused_narrow_count_pad(n) == PK.fused_narrow_count_pad(n)


# ---------------------------------------------------------------------------
# the unfused chain: snappy_resolve
# ---------------------------------------------------------------------------

def _stream(kind, rng):
    if kind == "literal":
        return rng.integers(0, 256, 5000, dtype=np.uint8)
    run = {"short": 3, "runs": 300, "deep": 2400}[kind]
    vals = rng.integers(0, 256, 12_000 // run + 1, dtype=np.uint8)
    return np.repeat(vals, run)[:12_000]


@pytest.mark.parametrize("kind,iters", [("literal", 0), ("short", 2),
                                        ("runs", 4), ("deep", 8)])
def test_snappy_resolve_matches_jax(kind, iters):
    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(len(kind))
    data = _stream(kind, rng)
    comp = native.snappy_compress(data)
    # a second, raw stream behind it: a synthetic literal op
    raw = rng.integers(0, 256, 700, dtype=np.uint8)
    stager = DR._RowGroupStager()
    info = DR._plan_snappy_ops(stager, [("comp", comp, len(data)),
                                        ("raw", raw, 0, len(raw))])
    assert info is not None and info.iters == iters
    host = np.zeros(stager.size(), np.uint8)
    stager.fill(host)
    buf = torch.from_numpy(host)
    n = info.n_ops
    tabs = [DR._tslice(buf, info.tbase, 4 * i * n, n, torch.int32)
            for i in range(3)]
    tabs.append(DR._tslice(buf, info.tbase, 12 * n, n, torch.uint8))
    want = np.asarray(JK.snappy_resolve(
        *(jnp.asarray(t.numpy()) for t in tabs), out_pad=info.out_pad,
        iters=iters))
    got = TK.snappy_resolve(*tabs, out_pad=info.out_pad, iters=iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the map really decompresses: staged bytes through it are the streams
    total = len(data) + len(raw)
    out = host[got.numpy()[:total]]
    np.testing.assert_array_equal(out, np.concatenate([data, raw]))


def test_narrow_widen_words_wraps_like_the_reference():
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (512, 8), dtype=np.uint8)
    for width, k in ((4, 1), (4, 4), (8, 3), (8, 8)):
        for bias in (0, -1, -(1 << 63), (1 << 32) - 7, (1 << 64) - 1):
            got = TK.narrow_widen_words(torch.from_numpy(raw[:, :k].copy()),
                                        bias, width=width)
            r = raw[:, :k].astype(np.uint64)
            u = sum(r[:, i] << np.uint64(8 * i) for i in range(k))
            with np.errstate(over="ignore"):
                want = u + np.uint64(bias % (1 << 64))
            if width == 4:
                want = (want & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            np.testing.assert_array_equal(
                got.numpy().reshape(-1).view(want.dtype), want)
