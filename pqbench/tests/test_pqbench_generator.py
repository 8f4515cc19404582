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


def test_frozen_nested_orders_is_chip_smokes():
    from tpu_parquet_torch.column import ByteArrayData

    from pqbench import tables

    cs = chip_smoke()
    orig = cs.nested_orders(list(cs.draw_lineitem16(30_000, seed=4)))
    t = tables.load("orders_nested")
    mine = t.draw(4, {"lineitems": 30_000, "rows_per_group": 250_000})
    assert len(mine) == len(orig) == 1
    g, o = mine[0], orig[0]
    assert np.array_equal(g["o_orderkey"], o["o_orderkey"])
    d, r = cs.list_levels(o["lens"], np.zeros(len(o["lens"]), bool))
    for c in t.NESTED_LINE_COLUMNS:
        leaf = g[t.LINE_PATH + c]
        assert (leaf.max_def, leaf.max_rep) == (2, 1)
        for mine_lv, orig_lv, listed in ((leaf.def_levels, o["def"], d),
                                         (leaf.rep_levels, o["rep"], r)):
            assert np.array_equal(mine_lv, orig_lv)
            assert np.array_equal(mine_lv, listed)
        if isinstance(leaf.values, tuple):
            ba = ByteArrayData.from_list(leaf.values[0]).take(leaf.values[1])
            assert np.array_equal(ba.offsets, o[c].offsets)
            assert np.array_equal(ba.heap, o[c].heap)
        else:
            assert np.array_equal(leaf.values, o[c])


def test_the_nested_order_structure_is_the_same_for_every_seed():
    from pqbench import tables

    t = tables.load("orders_nested")
    cfg = {"lineitems": 10_000, "rows_per_group": 1_000}
    a, b = t.draw(1, cfg), t.draw(2_147_483_901, cfg)
    leaf = t.LINE_PATH + "l_partkey"
    for ga, gb in zip(a, b, strict=True):
        assert np.array_equal(ga["o_orderkey"], gb["o_orderkey"])
        assert np.array_equal(ga[leaf].rep_levels, gb[leaf].rep_levels)
    assert not np.array_equal(a[0][leaf].values, b[0][leaf].values)


def draw_sha(groups) -> str:
    """SHA-256 of every drawn array of a flat table, in draw order."""
    import hashlib

    h = hashlib.sha256()
    for g in groups:
        for c, v in g.items():
            h.update(c.encode())
            if isinstance(v, tuple):
                h.update(b"\0".join(v[0]))
                v = v[1]
            h.update(str(v.dtype).encode())
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


# recorded from the benchmark before configurations named their table and
# writer (its lineitem.draw and write.write_file at TINY_ROWS in groups of
# TINY_GROUP); "digest0" is row group 0's group_digest of all 16 columns
# as read back on the CPU
BEFORE = {
    ("tpch_lineitem_sf1", 5): (
        "aaa69f1470388d1a6f66a56373459bba5cdc678bf49fcf7b301add96a2448699",
        "296a7bcdb51f32287ca5b8e21082e14fa962f7c18b5f76cb8991f03322e1ed68",
        "e60b69240ed896a78061c76e81df855a948f5779df132b2b9a4cdf3ff51ef0cf"),
    ("tpch_lineitem_sf1", 2_147_483_901): (
        "96a6b6653c3a027344f49e457bfeaeae6b555ebd7491c86bc7efb91a1abfc579",
        "4c1422de582655278d9e5c4f8ac0364434b098a185f045357be1e4d4f2d039ce",
        "4d250718940b356826dedef1e148d9315d7094174aa46fbf114ddef28493b380"),
    ("tpch_lineitem_sf1_pyarrow", 5): (
        "aaa69f1470388d1a6f66a56373459bba5cdc678bf49fcf7b301add96a2448699",
        "85906432f72ff9c4b7008068c81beef2300fdf83253de11dfce5973476e80d60",
        "e60b69240ed896a78061c76e81df855a948f5779df132b2b9a4cdf3ff51ef0cf"),
    ("tpch_lineitem_sf1_pyarrow", 2_147_483_901): (
        "96a6b6653c3a027344f49e457bfeaeae6b555ebd7491c86bc7efb91a1abfc579",
        "6c5b7a6dd98535ee2377c3716bea051acc81c472ee829ab82cca55fabab015c3",
        "4d250718940b356826dedef1e148d9315d7094174aa46fbf114ddef28493b380"),
}


@pytest.mark.parametrize("name,seed", sorted(BEFORE))
def test_the_flat_configurations_draw_write_and_digest_as_before(
        name, seed, tmp_path):
    import hashlib

    import torch

    from pqbench_support import TINY_GROUP, TINY_ROWS
    from pqbench import digest, tables
    from tpu_parquet_torch import device_reader

    with open(os.path.join(ROOT, "pqbench/configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["rows"], cfg["rows_per_group"] = TINY_ROWS, TINY_GROUP
    table = tables.load(cfg["table"])
    groups = table.draw(seed, cfg)
    want_draw, want_file, want_digest = BEFORE[(name, seed)]
    assert draw_sha(groups) == want_draw
    path = str(tmp_path / "f.parquet")
    write.write_file(cfg, groups, path)
    with open(path, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == want_file
    cpu = torch.device("cpu")
    r = device_reader.DeviceFileReader(path, columns=list(table.LEAVES),
                                       device=cpu, prefetch=0)
    it = r.iter_row_groups()
    g0 = next(it)
    it.close()
    r.close()
    pos = digest.Positions(cpu)
    d = digest.group_digest(g0, table.LEAVES, pos).numpy()
    assert hashlib.sha256(np.ascontiguousarray(d).tobytes()).hexdigest() \
        == want_digest
    assert digest.level_digests(g0, table.LEAVES, pos) is None
