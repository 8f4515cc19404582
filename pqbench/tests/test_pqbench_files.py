"""Every configuration, traffic mix and per-layer metric is found by its
name; ``BENCHMARK.json`` keeps to the limits of its format; a new cell,
mix and metric are added by adding files alone."""

import json
import os
import re
import shutil

import pytest

from pqbench_support import NESTED_CELL, ROOT, add_nested, run_cell
from pqbench import harness, reference

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "pqbench/run.py"]
    assert BENCH["paths"] == ["pqbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43_200


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and c["file"].startswith("pqbench/")
        assert one_line(c["why"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert one_line(w["why"]) and w["chips"] == 1
        assert NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for cell in CELLS:
        ends = {m["name"] for m in harness.cell_metrics(BENCH, cell, False)}
        assert "setup_s" in ends and len(ends) >= 2
        layers = harness.cell_metrics(BENCH, cell, True)
        assert layers
        # each per-layer metric moves an end-to-end metric the cell reports
        assert all(m["moves"] in ends for m in layers)


@pytest.mark.parametrize("cell", CELLS)
def test_every_file_of_a_cell_is_found_by_name(cell):
    w = harness.cell_of(BENCH, cell)
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    config = harness.load_data(os.path.join(ROOT, entry["file"]))
    assert config["name"] == w["config"]
    traffic = harness.load_data(harness.find(ROOT, BENCH, "traffic",
                                             w["traffic"]))
    assert os.path.isfile(os.path.join(ROOT, "pqbench", "drivers",
                                       traffic["kind"] + ".py"))
    for m in harness.cell_metrics(BENCH, cell, True):
        assert callable(harness.load_metric(ROOT, BENCH, m["name"]).read)


FACTS = {
    "layer": {"reader": {"rows": 2_000_000, "host_seconds": 0.1,
                         "stage_seconds": 0.01, "dispatch_seconds": 0.03,
                         "pool_lane_seconds": 0.5},
              "decode_bytes": {"read": 335_000_000_000, "written": 0},
              "loader": {"decode_wait_seconds": 3.0},
              "window_rows": 2_000_000},
    "device": {"window_s": 10.0, "busy_s": 0.5, "program_busy_s": 0.2},
    "window_s": 10.0, "peak_bytes_per_s": 3.35e12}
WANT = {"host_s_per_Mrow": 0.05, "enqueue_s_per_Mrow": 0.02,
        "decode_roofline_share": 50.0,
        "device_idle_share.scan": 98.0, "decode_wait_share": 30.0,
        "rows_per_s.pyarrow": 200_000.0, "rows_per_s.loader": 200_000.0,
        "host_s_per_Mrow.pyarrow": 0.05, "enqueue_s_per_Mrow.pyarrow": 0.02,
        "decode_roofline_share.pyarrow": 50.0,
        "device_idle_share.pyarrow": 98.0, "device_idle_share.loader": 98.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_every_metric_reader_computes_its_number(name):
    mod = harness.load_metric(ROOT, {"paths": ["pqbench"]}, name)
    assert mod.read(FACTS) == pytest.approx(WANT[name])
    empty = {"layer": {}, "device": None, "window_s": 10.0,
             "peak_bytes_per_s": 3.35e12}
    if name not in ("decode_wait_share",):
        assert mod.read(empty) is None


def test_the_roofline_byte_counts():
    import numpy as np
    import torch

    from pqbench import digest

    flat = {"max_def": 0, "max_rep": 0, "num_leaf_slots": 10}
    g = {"a": np.zeros(10, np.int64), "b": np.zeros(10, np.int32),
         "s": ([b"xy", b"abcd"], np.array([0, 1, 1, 0]))}
    plain = reference.decoded_bytes([g])[0]
    assert plain == {"a": 80, "b": 40, "s": 5 * 8 + 12}
    # a column returned in full writes its values as the reference counts
    col = type("Col", (), {"indices": None})()
    assert digest.output_bytes(col, plain["a"]) == 80
    # one returned as a dictionary writes its indices (the real count, not
    # the padding) and its tables
    dcol = type("Dict", (), {
        "indices": torch.zeros(16, dtype=torch.int32), "num_values": 10,
        "dict_u8": torch.zeros((8, 4), dtype=torch.uint8),
        "dict_offsets": None, "dict_heap": None, **flat})()
    assert digest.output_bytes(dcol, plain["b"]) == 10 * 4 + 32
    scol = type("Dict", (), {
        "indices": torch.zeros(4, dtype=torch.int32), "num_values": 4,
        "dict_u8": None, "dict_offsets": torch.zeros(3, dtype=torch.int64),
        "dict_heap": torch.zeros(6, dtype=torch.uint8), **flat})()
    assert digest.output_bytes(scol, plain["s"]) == 4 * 4 + 24 + 6
    # a leaf with levels adds one byte a slot for each level stream, in
    # either form: 7 slots, 6 of them defined
    d = np.array([2, 2, 1, 2, 2, 2, 2], np.int32)
    r = np.array([0, 1, 0, 0, 1, 1, 0], np.int32)
    nested = reference.decoded_bytes([{
        "n": reference.Leaf(np.zeros(6, np.int64), d, r, 2, 1),
        "o": reference.Leaf(np.zeros(6, np.int64), d, None, 2, 0)}])[0]
    assert nested == {"n": 48 + 2 * 7, "o": 48 + 7}
    lcol = type("Dict", (), {
        "indices": torch.zeros(8, dtype=torch.int32), "num_values": 6,
        "dict_u8": torch.zeros((2, 8), dtype=torch.uint8),
        "dict_offsets": None, "dict_heap": None, "max_def": 2,
        "max_rep": 1, "num_leaf_slots": 7})()
    assert digest.output_bytes(lcol, nested["n"]) == 6 * 4 + 16 + 2 * 7


def test_a_cell_mix_and_metric_are_added_by_adding_files(tiny_root,
                                                         tmp_path):
    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    b = os.path.join(root, "pqbench")
    shutil.copy(os.path.join(b, "configs/tpch_lineitem_sf1.json"),
                os.path.join(b, "configs/tiny_copy.json"))
    with open(os.path.join(b, "configs/tiny_copy.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_copy"
    with open(os.path.join(b, "configs/tiny_copy.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic/three_columns.json"), "w") as f:
        json.dump({"kind": "scan", "columns": ["l_orderkey", "l_tax",
                                               "l_comment"],
                   "prefetch": 0}, f)
    with open(os.path.join(b, "metrics/rows_in_passes.py"), "w") as f:
        f.write("def read(run):\n"
                "    r = run['layer'].get('reader')\n"
                "    return None if not r else float(r['rows'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_copy", "source": "a test",
                             "file": "pqbench/configs/tiny_copy.json",
                             "reduced": [], "why": "a throwaway layout"})
    bench["workloads"].append({"name": "tiny_three", "config": "tiny_copy",
                               "traffic": "three_columns", "chips": 1,
                               "why": "a throwaway cell"})
    bench["end_to_end"][0]["workloads"].append("tiny_three")
    bench["per_layer"].append({"name": "rows_in_passes", "unit": "rows",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "host phase", "moves": "rows_per_s",
                               "workloads": ["tiny_three"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    res = run_cell(root, "tiny_three", seconds=1.5)
    assert res["correct"] and set(res["metrics"]) == {
        "rows_per_s", "peak_device_mib", "setup_s"}
    traced = run_cell(root, "tiny_three", seconds=1.5, trace=1)
    assert traced["correct"]
    assert traced["metrics"]["rows_in_passes"]["value"] > 0
    assert traced["metrics"]["rows_in_passes"]["unit"] == "rows"


def tree(root: str) -> dict:
    """Every file under ``root`` and its bytes."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_a_configuration_with_its_own_table_is_added_by_files(tiny_root,
                                                              tmp_path):
    import io

    from pqbench import tables

    root = str(tmp_path / "root")
    shutil.copytree(tiny_root, root)
    before = tree(root)
    cfg = add_nested(root)
    after = tree(root)
    # new files and BENCHMARK.json's new entries alone
    changed = {k for k in before if after[k] != before[k]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {"pqbench/configs/tiny_orders_nested"
                                        ".json"}
    res = run_cell(root, NESTED_CELL, seconds=1.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"rows_per_s", "peak_device_mib",
                                   "setup_s"}
    out = io.StringIO()
    traced = run_cell(root, NESTED_CELL, seconds=1.5, trace=1, out=out)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["host_s_per_Mrow"]["value"] > 0
    # the roofline's bytes written hold one byte a slot for each of a
    # lineitem leaf's two level streams
    side = json.loads(out.getvalue().splitlines()[-2])
    groups = tables.load(cfg["table"]).draw(2_147_483_901, cfg)
    slots = [len(g["lines.list.element.l_partkey"].def_levels)
             for g in groups]
    compared = traced["checks"]["row_groups_compared"]["value"]
    passes = compared // len(groups)
    levels = 6 * 2 * sum(slots) * passes
    values = sum(8 * len(g["o_orderkey"]) for g in groups) * passes
    assert side["layer"]["decode_bytes"]["written"] > levels + values
