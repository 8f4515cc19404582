"""The frozen generators: the same draw from the same seed, the copies
equal to ``chip_smoke.py``'s originals, and the layout pin."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from pqbench_support import ROOT, run_cell
from pqbench import harness, lineitem, write


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_original", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def same_groups(a, b) -> bool:
    for ga, gb in zip(a, b, strict=True):
        for c in lineitem.COLUMNS:
            va, vb = ga[c], gb[c]
            if isinstance(va, tuple):
                if list(va[0]) != list(vb[0]) or not np.array_equal(va[1],
                                                                    vb[1]):
                    return False
            elif va.dtype != vb.dtype or not np.array_equal(va, vb):
                return False
    return True


@pytest.mark.parametrize("seed", [0, 4, 2_147_483_901, 2**33 + 17])
def test_same_seed_same_draw(seed):
    a = lineitem.draw(seed, 25_000, 10_000)
    b = lineitem.draw(seed, 25_000, 10_000)
    assert same_groups(a, b)
    assert [len(g["l_orderkey"]) for g in a] == [10_000, 10_000, 5_000]
    keys = lineitem.column(a, "l_orderkey")
    assert np.all(np.diff(keys) > 0)


def test_other_seed_other_draw():
    a = lineitem.draw(1, 5_000, 5_000)
    b = lineitem.draw(2, 5_000, 5_000)
    assert not np.array_equal(a[0]["l_partkey"], b[0]["l_partkey"])


def test_frozen_draw_is_chip_smokes():
    orig = list(chip_smoke().draw_lineitem16(30_000, 12_000, seed=4))
    assert same_groups(lineitem.draw(4, 30_000, 12_000), orig)


def test_frozen_fallback_layout_is_chip_smokes():
    cs = chip_smoke()
    g = write.strings_group(lineitem.draw(3, 40_000, 40_000)[0])
    for c, limit in (("l_orderkey", 1 << 14), ("l_comment", 1 << 10),
                     ("l_extendedprice", 1 << 20)):
        mine = write.fallback_layout(g[c], limit)
        theirs = cs.fallback_layout(g[c], limit)
        assert all(np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(mine, theirs, strict=True))


def test_pinned_layout_differences_are_named():
    pinned = {"row_group_rows": [10, 5],
              "chunk_encodings": {"a": [["PLAIN"], ["PLAIN"]]}}
    same = {"row_group_rows": [10, 5],
            "chunk_encodings": {"a": [["PLAIN"], ["PLAIN"]]}}
    assert write.layout_differences(pinned, same) == []
    other = {"row_group_rows": [15],
             "chunk_encodings": {"a": [["PLAIN", "RLE"]], "b": [["X"]]}}
    diffs = write.layout_differences(pinned, other)
    assert len(diffs) == 3


def test_a_run_refuses_a_file_that_is_not_pinned(tiny_root, tmp_path):
    import shutil

    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    path = os.path.join(root, "pqbench/configs/tpch_lineitem_sf1.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["pinned_layout"]["chunk_encodings"]["l_orderkey"][0] = ["PLAIN"]
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(harness.NoResult, match="not the pinned one"):
        run_cell(root, "lineitem_scan", seconds=0.5)


@pytest.mark.parametrize("name", ["tpch_lineitem_sf1",
                                  "tpch_lineitem_sf1_pyarrow"])
def test_configuration_files_state_their_deployment(name):
    with open(os.path.join(ROOT, "pqbench/configs", name + ".json")) as f:
        cfg = json.load(f)
    assert cfg["name"] == name
    assert cfg["rows"] == 6_001_215 and cfg["rows_per_group"] == 1_000_000
    assert cfg["reduced"] == []
    assert cfg["assumed"] and cfg["source"] and cfg["guarantees"]
    pin = cfg["pinned_layout"]
    assert sum(pin["row_group_rows"]) == cfg["rows"]
    assert sorted(pin["chunk_encodings"]) == sorted(lineitem.COLUMNS)
    assert all(len(v) == len(pin["row_group_rows"])
               for v in pin["chunk_encodings"].values())
