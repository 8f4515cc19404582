"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have; the control comes out not correct; the same
runs unbroken come out correct.  The look for a card is skipped (the
program's plain versions run on the CPU)."""

import pytest

from pqbench_support import NESTED_CELL, run_cell
from pqbench import control


def alter(col) -> None:
    """An answer altered where it is produced: every value moved."""
    if getattr(col, "indices", None) is not None and col.dict_u8 is not None:
        col.dict_u8[0, 0] ^= 1
    elif col.values is not None:
        col.values.add_(1)
    else:
        col.heap[col.heap.numel() // 2] ^= 1


def halve(col) -> None:
    """Half of the rows left out."""
    col.n_values = col.num_values // 2


@pytest.fixture
def break_scan(monkeypatch):
    from tpu_parquet_torch import device_reader

    def broken(fault):
        real = device_reader.DeviceFileReader.iter_row_groups

        def it(self, *a, **k):
            for out in real(self, *a, **k):
                for name, col in out.items():
                    if fault is halve or name == "l_extendedprice":
                        fault(col)
                yield out

        monkeypatch.setattr(device_reader.DeviceFileReader,
                            "iter_row_groups", it)

    return broken


@pytest.fixture
def break_loader(monkeypatch):
    from tpu_parquet_torch.data import loader

    def broken(fault):
        real = loader.ship_to_device

        def ship(batch, device):
            out = real(batch, device)
            if fault is halve:
                return {c: v[: len(v) // 2] for c, v in out.items()}
            out["l_tax"].add_(1)
            return out

        monkeypatch.setattr(loader, "ship_to_device", ship)

    return broken


CELLS = {"lineitem_scan": "break_scan", "pyarrow_scan": "break_scan",
         "lineitem_loader": "break_loader"}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_an_unbroken_run_is_correct(tiny_root, cell):
    res = run_cell(tiny_root, cell, seconds=1.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", [alter, halve], ids=["altered", "half"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(tiny_root, request, cell,
                                            fault):
    request.getfixturevalue(CELLS[cell])(fault)
    res = run_cell(tiny_root, cell, seconds=1.5)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(tiny_root, cell):
    r = control.readings(tiny_root, cell, seed=17, seconds=2.0)
    bad = {k: v for k, v in r.items() if "mismatch" in k or "wrong" in k}
    assert bad and all(v > 0 for v in bad.values()), r


def move_rep(col) -> None:
    """One rep level moved: an order's first lineitem made the last of
    the order before it."""
    r = col.rep_levels
    n = col.num_leaf_slots
    i = int(((r[1:n] == 0) & (r[: n - 1] == 1)).nonzero()[0])
    r[i], r[i + 1] = 0, 1


def halve_orders(rg: dict) -> None:
    """Half of the row group's orders left out: the order keys and every
    lineitem leaf's slots, levels and values cut where the second half of
    the orders starts."""
    key = rg["o_orderkey"]
    orders = key.num_values // 2
    key.n_values = orders
    for name, col in rg.items():
        if col.max_rep:
            starts = (col.rep_levels[: col.num_leaf_slots] == 0).nonzero()
            col.num_leaf_slots = int(starts[orders])
            col.n_values = col.num_leaf_slots


NESTED_FAULTS = {"value_moved": "l_extendedprice", "rep_moved": "l_quantity",
                 "half_the_orders": None}


@pytest.fixture
def break_nested(monkeypatch):
    from tpu_parquet_torch import device_reader

    def broken(fault):
        real = device_reader.DeviceFileReader.iter_row_groups

        def it(self, *a, **k):
            for out in real(self, *a, **k):
                if fault == "half_the_orders":
                    halve_orders(out)
                for name, col in out.items():
                    if name.endswith("." + str(NESTED_FAULTS[fault])):
                        (alter if fault == "value_moved" else move_rep)(col)
                yield out

        monkeypatch.setattr(device_reader.DeviceFileReader,
                            "iter_row_groups", it)

    return broken


def test_the_nested_cell_unbroken_is_correct(nested_root):
    res = run_cell(nested_root, NESTED_CELL, seconds=1.5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(NESTED_FAULTS))
def test_the_nested_cell_broken_is_not_correct(nested_root, break_nested,
                                               fault):
    break_nested(fault)
    res = run_cell(nested_root, NESTED_CELL, seconds=1.5)
    assert not res["correct"], res["checks"]


def test_the_nested_control_is_not_correct(nested_root):
    r = control.readings(nested_root, NESTED_CELL, seed=17, seconds=2.0)
    assert r["digest_mismatches"] > 0, r
