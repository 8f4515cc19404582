"""The fused K1 (BP unpack + run-table combine) against the JAX package.

``tpu_parquet_torch.cuda_kernels.hybrid_unpack_combine`` decodes one
RLE/bit-packed hybrid stream in one pass; on a CPU tensor it runs its plain
version.  Here each side plans the same pages with its own
``_plan_hybrid_pallas`` into its own stager: the staged bytes, the payload
and table bases and the declared read extent must be equal, and the port's
``int32[count]`` must equal the reference's Pallas unpack (interpret mode)
followed by its ``_hybrid_combine_staged_jit``, bit for bit, and the values
the pages were encoded from.  Pages are encoded here run by run from a
seeded numpy generator, so that the shapes are the ones named: one
bit-packed run, odd-length RLE runs between bit-packed runs (bit-packed runs
that start off group boundaries), many pages with ragged counts, a padded
run table with ``n_valid < count``, and an RLE-only tail.  The CUDA kernel
itself runs only on the card, where ``chip_smoke.py`` holds it against this
plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_parquet import device_reader as RD
from tpu_parquet import jax_decode as jd
from tpu_parquet import pallas_kernels as PK
from tpu_parquet.kernels import bitpack
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import torch_decode as TD

WIDTHS = [1, 3, 4, 6, 8, 13, 14, 20, 32]
SHAPES = ["one_bp_run", "odd_rle_between_bp", "many_ragged_pages",
          "padded_table_short_valid", "rle_only_tail"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# a hybrid encoder that emits the runs it is given
# ---------------------------------------------------------------------------

def _uleb(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _encode_page(runs, width: int) -> bytes:
    """``runs``: [("rle", length, value) | ("bp", values)]; a bit-packed
    run is padded with zeros to whole 8-value groups."""
    out = bytearray()
    for run in runs:
        if run[0] == "rle":
            _, length, value = run
            out += _uleb(length << 1)
            out += int(value).to_bytes((width + 7) // 8, "little")
        else:
            vals = np.asarray(run[1], dtype=np.uint64)
            groups = -(-len(vals) // 8)
            padded = np.zeros(groups * 8, dtype=np.uint64)
            padded[: len(vals)] = vals
            out += _uleb(groups << 1 | 1)
            out += bitpack.pack(padded, width)
    return bytes(out)


def _page(rng, width: int, n_runs: int, ragged_end: bool):
    """Alternate odd-length RLE runs and bit-packed runs of whole groups;
    the last run is a ragged bit-packed run (any length) or RLE."""
    top = 1 << width
    runs, values = [], []
    for i in range(n_runs):
        last = i == n_runs - 1
        if i % 2 == 0:
            n = int(rng.integers(1, 40)) if last and ragged_end else \
                8 * int(rng.integers(1, 6))
            v = rng.integers(0, top, n, dtype=np.uint64)
            runs.append(("bp", v))
        else:
            n = 2 * int(rng.integers(0, 9)) + 1
            v = np.full(n, int(rng.integers(0, top)), dtype=np.uint64)
            runs.append(("rle", n, int(v[0])))
        values.append(v)
    return runs, np.concatenate(values)


def _pages(shape: str, width: int, seed: int):
    """[(encoded page, value count)] and the values they hold."""
    rng = np.random.default_rng(seed)
    top = 1 << width
    if shape == "one_bp_run":
        v = rng.integers(0, top, 1000 + width, dtype=np.uint64)
        pages = [([("bp", v)], v)]
    elif shape == "odd_rle_between_bp":
        pages = [_page(rng, width, 15, ragged_end=True)]
    elif shape == "many_ragged_pages":
        pages = [_page(rng, width, int(rng.integers(1, 8)),
                       ragged_end=bool(i % 3)) for i in range(7)]
    elif shape == "padded_table_short_valid":
        # 5 runs: a table padded to 8 rows; 1,001 values, bucketed to more
        bp1 = rng.integers(0, top, 400, dtype=np.uint64)
        bp2 = rng.integers(0, top, 296, dtype=np.uint64)
        bp3 = rng.integers(0, top, 3, dtype=np.uint64)
        r1 = np.full(201, int(rng.integers(0, top)), dtype=np.uint64)
        r2 = np.full(101, int(rng.integers(0, top)), dtype=np.uint64)
        runs = [("bp", bp1), ("rle", 201, int(r1[0])), ("bp", bp2),
                ("rle", 101, int(r2[0])), ("bp", bp3)]
        pages = [(runs, np.concatenate([bp1, r1, bp2, r2, bp3]))]
    else:  # rle_only_tail: BP pages, then pages of RLE runs only
        pages = [_page(rng, width, 6, ragged_end=False) for _ in range(2)]
        tail = []
        for _ in range(3):
            n = int(rng.integers(1, 30))
            tail.append(("rle", n, int(rng.integers(0, top))))
        pages.append((tail, np.concatenate(
            [np.full(n, v, dtype=np.uint64) for _, n, v in tail])))
        v = int(rng.integers(0, top))
        pages.append(([("rle", 77, v)], np.full(77, v, dtype=np.uint64)))
    encoded = [(_encode_page(runs, width), len(v)) for runs, v in pages]
    return encoded, np.concatenate([v for _, v in pages]).astype(np.uint32)


def _plan_both(encoded, width: int, lead: int):
    """Each package's planner over the same pages, each into its own stager
    (``lead`` bytes registered first, so that the bases are not 0)."""
    total = sum(n for _, n in encoded)
    count = TD._bucket_count(total)
    assert count == jd._bucket_count(total)
    ref_st, port_st = RD._RowGroupStager(), DR._RowGroupStager()
    head = np.arange(lead, dtype=np.uint8)
    assert ref_st.add(head) == port_st.add(head) == 0
    ref_info = [(jd.parse_hybrid_meta(b, width, n), b, n) for b, n in encoded]
    port_info = [(TD.parse_hybrid_meta(b, width, n), b, n) for b, n in encoded]
    ref = RD._plan_hybrid_pallas(ref_st, ref_info, width, total, count,
                                 interpret=True)
    port = DR._plan_hybrid_pallas(port_st, port_info, width, total, count)
    return ref, ref_st, port, port_st, total, count


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width", WIDTHS)
def test_hybrid_plan_and_decode_match_the_reference(width, shape):
    encoded, values = _pages(shape, width, seed=width * 31 + len(shape))
    ref, ref_st, port, port_st, total, count = _plan_both(
        encoded, width, lead=37 + width)
    assert ref is not None and port is not None
    # the same staging: bases, extent, bytes
    assert [int(x) for x in port.dyn] == [int(x) for x in ref.dyn]
    assert port_st.total == ref_st.total
    assert port_st._max_read_end == ref_st._max_read_end
    ref_buf = np.asarray(ref_st.stage())
    port_buf = port_st.stage(torch.device("cpu"))
    np.testing.assert_array_equal(port_buf.numpy(), ref_buf)
    # the same decode
    want = np.asarray(ref.fn(jnp.asarray(ref_buf), *ref.dyn))
    got = port.fn(port_buf, *port.dyn)
    assert got.dtype == torch.int32 and got.shape == (count,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(want[:total], values)
    assert not want[total:].any()
    if shape == "padded_table_short_valid":
        assert port.fn.keywords["rp"] > 5 and count > total


def _one_run(width: int, n: int, base: int, seed: int):
    """A buffer with a one-run table (a bit-packed run over every position,
    padded to 8 rows) at 64 and the payload at ``base``."""
    rng = np.random.default_rng(seed)
    gpad = CK.bp_groups_pad(-(-n // 8))
    host = rng.integers(0, 256, base + gpad * width, dtype=np.uint8)
    rp = 8
    ends = np.full(rp, n, np.int32)
    table = np.concatenate([ends.view(np.uint8), np.zeros(rp, np.uint8),
                            np.zeros(4 * rp, np.uint8),
                            np.zeros(4 * rp, np.uint8)])
    host[64 : 64 + 13 * rp] = table
    return torch.from_numpy(host), gpad, rp


@pytest.mark.parametrize("width,base", [(1, 256), (7, 333), (14, 257),
                                        (32, 1001)])
def test_unpack_bp_groups_is_a_one_run_hybrid(width, base):
    # standalone K1 and the fused K1 share their extraction: over a one-run
    # table the fused result is K1's, cut at n_valid, and both are the
    # Pallas kernel's
    n = 3000 + width
    buf, gpad, rp = _one_run(width, n, base, seed=width)
    count = TD._bucket_count(n)
    k1 = CK.unpack_bp_groups(buf, base, width, gpad)
    want = np.asarray(PK.unpack_bp_groups(jnp.asarray(buf.numpy()), base,
                                          width, gpad, interpret=True))
    np.testing.assert_array_equal(k1.numpy().view(np.uint32), want)
    fused = CK.hybrid_unpack_combine(buf, base, 64, n, width=width,
                                     gpad=gpad, count=count, rp=rp)
    expect = np.zeros(count, np.uint32)
    expect[:n] = want[:n]
    np.testing.assert_array_equal(fused.numpy().view(np.uint32), expect)


def test_hybrid_unpack_combine_rejects_bad_arguments():
    buf, gpad, rp = _one_run(5, 2000, 128, seed=0)
    kw = dict(width=5, gpad=gpad, count=2048, rp=rp)
    CK.hybrid_unpack_combine(buf, 128, 64, 2000, **kw)  # the good call
    bad = [
        ((buf, 128, 64, 2000), dict(kw, width=0)),
        ((buf, 128, 64, 2000), dict(kw, width=33)),
        ((buf, 128, 64, 2000), dict(kw, rp=12)),     # not a power of two
        ((buf, 128, 64, 2000), dict(kw, rp=4)),      # under the floor of 8
        ((buf, 128, 64, 2000), dict(kw, gpad=1000)),  # not whole tiles
        ((buf, 128, 64, 2000), dict(kw, count=0)),
        ((buf, 128, buf.numel() - 8, 2000), kw),      # tables past the end
        ((buf, 128, 66, 2000), kw),                   # tables not aligned
        ((buf, 129, 64, 2000), kw),                   # BP extent past the end
        ((buf, -1, 64, 2000), kw),
        ((buf.to(torch.int32), 128, 64, 2000), kw),
    ]
    for args, kwargs in bad:
        with pytest.raises(ValueError):
            CK.hybrid_unpack_combine(*args, **kwargs)


def test_hybrid_cpu_tensor_counts_no_launch():
    CK.reset_launches()
    buf, gpad, rp = _one_run(9, 5000, 200, seed=1)
    CK.hybrid_unpack_combine(buf, 200, 64, 5000, width=9, gpad=gpad,
                             count=5120, rp=rp)
    assert CK.launches["hybrid_unpack_combine"] == 0


def test_hybrid_plan_runs_the_fused_wrapper():
    # the plan's device call is the fused wrapper, nothing else
    encoded, values = _pages("odd_rle_between_bp", 13, seed=5)
    st = DR._RowGroupStager()
    info = [(TD.parse_hybrid_meta(b, 13, n), b, n) for b, n in encoded]
    total = len(values)
    plan = DR._plan_hybrid_pallas(st, info, 13, total,
                                  TD._bucket_count(total))
    assert plan.fn.func is CK.hybrid_unpack_combine
    got = plan.fn(st.stage(torch.device("cpu")), *plan.dyn)
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[:total], values)
