"""The device digests (torch, here on the CPU) against the NumPy
reference's, and the reference's loader order against the program's
sampler."""

import numpy as np
import pytest
import torch

import pqbench_support  # noqa: F401  (puts the checkout on sys.path)
from pqbench import digest, lineitem, reference


def pos():
    return digest.Positions(torch.device("cpu"))


def column(dtype, seed=1, n=5000):
    rng = np.random.default_rng(seed)
    if dtype == np.float64:
        return rng.uniform(-1e18, 1e18, n)
    return rng.integers(np.iinfo(dtype).min, np.iinfo(dtype).max, n,
                        dtype=dtype)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_fixed_digest_matches_reference(dtype):
    a = column(dtype)
    got = digest.fixed_digest(torch.from_numpy(a), pos()).numpy()
    assert list(got) == reference.fixed_digest(a)


def test_fixed_digests_fold_many_columns_in_steps():
    cols = [column(d, seed=i) for i, d in enumerate(
        [np.int64, np.int32, np.float64] * 3)]
    got = digest.fixed_digests([torch.from_numpy(a) for a in cols], pos())
    assert np.array_equal(got.numpy(),
                          np.array([reference.fixed_digest(a)
                                    for a in cols]))


def test_a_sum_of_the_words_is_the_digests_sum():
    for i, dtype in enumerate([np.int64, np.int32, np.float64]):
        a = column(dtype, seed=i)
        w = digest.words_view(torch.from_numpy(a))
        assert int(torch.sum(w, dtype=torch.int64)) == \
            reference.fixed_digest(a)[2]


def test_the_host_store_keeps_every_row_across_blocks(monkeypatch):
    monkeypatch.setattr(digest.HostStore, "ROWS", 3)
    store = digest.HostStore((2,), torch.device("cpu"))
    assert store.array().shape == (0, 2)
    for i in range(7):
        store.put(torch.tensor([i, -i]))
    assert store.array().tolist() == [[i, -i] for i in range(7)]


def test_fixed_digest_sees_one_changed_value_and_a_swap():
    a = np.arange(1000, dtype=np.int64) * 7919
    base = reference.fixed_digest(a)
    b = a.copy()
    b[500] += 1
    assert reference.fixed_digest(b) != base
    c = a.copy()
    c[[3, 700]] = c[[700, 3]]
    assert reference.fixed_digest(c) != base


def strings(seed=2, n=3000):
    g = lineitem.draw(seed, n, n)[0]
    return g["l_comment"], g["l_shipmode"]


def test_plain_string_digest_matches_reference():
    from tpu_parquet_torch.column import ByteArrayData

    for pool, idx in strings():
        ba = ByteArrayData.from_list(pool).take(idx)
        heap = np.concatenate([ba.heap, np.full(37, 99, np.uint8)])
        offsets = np.asarray(ba.offsets, dtype=np.int64)
        got = digest.plain_string_digest(
            torch.from_numpy(offsets), torch.from_numpy(heap), len(idx),
            pos())
        assert list(got.numpy()) == reference.string_digest(pool, idx)


def test_plain_string_digest_in_chunks(monkeypatch):
    monkeypatch.setattr(digest, "HEAP_CHUNK", 64)
    test_plain_string_digest_matches_reference()


def test_plain_string_digest_with_offsets_not_from_zero():
    from tpu_parquet_torch.column import ByteArrayData

    pool, idx = strings()[0]
    ba = ByteArrayData.from_list(pool).take(idx)
    heap = np.concatenate([np.full(11, 5, np.uint8), ba.heap])
    offsets = np.asarray(ba.offsets, dtype=np.int64) + 11
    got = digest.plain_string_digest(torch.from_numpy(offsets),
                                     torch.from_numpy(heap), len(idx), pos())
    assert list(got.numpy()) == reference.string_digest(pool, idx)


def test_dictionary_string_digest_matches_reference():
    for pool, idx in strings():
        lens = np.array([len(s) for s in pool], dtype=np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)])
        heap = np.frombuffer(b"".join(pool), dtype=np.uint8)
        # padding past the real dictionary is garbage no index reads
        doff = np.concatenate([offsets, [-7, 10**9, 3]]).astype(np.int64)
        dheap = np.concatenate([heap, np.full(50, 200, np.uint8)])
        ind = np.concatenate([idx, np.zeros(13, np.int64)]).astype(np.int32)
        got = digest.dict_string_digest(
            torch.from_numpy(ind), torch.from_numpy(doff),
            torch.from_numpy(dheap), len(idx), pos())
        assert list(got.numpy()) == reference.string_digest(pool, idx)


def test_the_control_differs_on_every_double_column_only():
    groups = lineitem.draw(6, 20_000, 10_000)
    want = reference.group_digests(groups, lineitem.COLUMNS)
    got = reference.group_digests(groups, lineitem.COLUMNS, control=True)
    differs = np.any(got != want, axis=2)
    doubles = [lineitem.PHYSICAL[c] == "DOUBLE" for c in lineitem.COLUMNS]
    assert np.array_equal(differs, np.array([doubles] * len(groups)))


@pytest.mark.parametrize("seed", [0, 11, 2_147_483_901])
def test_loader_order_is_the_samplers(seed):
    from tpu_parquet_torch.data import sampler

    rows = [50_000, 50_000, 20_000]
    order = reference.LoaderOrder(seed, rows, 65_536, 8_192)
    for epoch in (0, 3):
        plan = sampler.plan_epoch(seed, epoch, 0, rows, True)
        stream = np.concatenate([np.arange(sum(rows[:u]), sum(rows[:u + 1]))
                                 for u in plan.order])
        blocks = []
        for k in range(0, len(stream), 65_536):
            part = stream[k : k + 65_536]
            blocks.append(part[sampler.block_permutation(
                seed, epoch, 0, k // 65_536, len(part))])
        permuted = np.concatenate(blocks)
        for j in (0, 7, 8, order.batches - 1):
            assert np.array_equal(order.batch_rows(epoch, j),
                                  permuted[j * 8192 : (j + 1) * 8192])
        assert np.array_equal(order.dropped_rows(epoch),
                              permuted[order.batches * 8192:])


def test_wrap_is_int64_arithmetic():
    assert reference.wrap(2**63) == -(2**63)
    assert reference.wrap(-1) == -1
    assert reference.wrap(2**64 + 5) == 5


# ---------------------------------------------------------------------------
# leaves that carry def and rep levels
# ---------------------------------------------------------------------------

def nested_group():
    from pqbench import tables

    return tables.load("orders_nested").draw(
        9, {"lineitems": 4_000, "rows_per_group": 2_000})[0]


def program_column(leaf):
    """The program's form of a drawn leaf with levels, as a read returns
    it: the defined values, the levels as ``int32`` padded past the
    slots."""
    from tpu_parquet_torch.torch_decode import DeviceColumnData

    pad = np.zeros(5, np.int32)
    common = dict(def_levels=torch.from_numpy(np.concatenate(
        [leaf.def_levels, pad])), rep_levels=torch.from_numpy(np.concatenate(
            [leaf.rep_levels, pad])), max_def=leaf.max_def,
        max_rep=leaf.max_rep, num_leaf_slots=len(leaf.def_levels))
    if isinstance(leaf.values, tuple):
        from tpu_parquet_torch.column import ByteArrayData

        ba = ByteArrayData.from_list(leaf.values[0]).take(leaf.values[1])
        return DeviceColumnData(
            offsets=torch.from_numpy(np.asarray(ba.offsets, np.int64)),
            heap=torch.from_numpy(ba.heap), **common)
    return DeviceColumnData(values=torch.from_numpy(leaf.values.copy()),
                            **common)


def device_leaf_digest(col) -> list:
    p = pos()
    g = {"x": col}
    return (list(digest.group_digest(g, ["x"], p)[0].numpy())
            + list(digest.level_digests(g, ["x"], p)[0].numpy()))


@pytest.mark.parametrize("leaf", ["o_orderkey",
                                  "lines.list.element.l_quantity",
                                  "lines.list.element.l_extendedprice",
                                  "lines.list.element.l_shipdate",
                                  "lines.list.element.l_comment"])
def test_level_digests_match_reference(leaf):
    g = nested_group()
    want = reference.leaf_digest(g[leaf])
    if leaf == "o_orderkey":
        col = torch.from_numpy(g[leaf])
        p = pos()
        got = {"x": type("Flat", (), {"values": col, "max_def": 0,
                                      "max_rep": 0, "num_values": len(col),
                                      "indices": None})()}
        assert digest.level_digests(got, ["x"], p) is None
        assert want[5:] == [0] * reference.LEVEL_WIDTH
        return
    assert want[5:8] == [len(g[leaf].def_levels),
                         2 * len(g[leaf].def_levels), want[7]]
    assert device_leaf_digest(program_column(g[leaf])) == want


def move_rep(col):
    """An order's first lineitem made the last of the order before it."""
    r = col.rep_levels
    i = int(np.flatnonzero((r[1:].numpy() == 0) & (r[:-1].numpy() == 1))[0])
    r[i], r[i + 1] = 0, 1


def drop_one(col):
    """One element dropped: its slot, levels and value."""
    n = col.num_leaf_slots
    keep = torch.arange(n) != n // 2
    col.def_levels = col.def_levels[:n][keep]
    col.rep_levels = col.rep_levels[:n][keep]
    col.values = col.values[:n][keep]
    col.num_leaf_slots = n - 1


def change_value(col):
    col.values[7] += 1


def change_def(col):
    col.def_levels[11] = 1


def swap_values(col):
    col.values[[3, 9]] = col.values[[9, 3]]


@pytest.mark.parametrize("fault", [change_value, change_def, move_rep,
                                   drop_one, swap_values],
                         ids=lambda f: f.__name__)
def test_level_digests_see_each_fault(fault):
    leaf = nested_group()["lines.list.element.l_partkey"]
    want = reference.leaf_digest(leaf)
    col = program_column(leaf)
    assert not torch.equal(col.values[3], col.values[9])
    fault(col)
    assert device_leaf_digest(col) != want
