"""The nested ORDERS configuration (``tpch_orders_nested_sf1``) and its cell
(``orders_nested_scan``): the file states the deployment and pins the SF1
layout; a run of the cell on the CPU, at fewer lineitems, comes out correct
and computes every per-layer metric the cell lists."""

import json
import os
import shutil

import pytest

from pqbench_support import ROOT, run_cell, write_pinned
from pqbench import harness
from pqbench.tables import orders_nested_full

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CONFIG = "tpch_orders_nested_sf1"
CELL = "orders_nested_scan"
ENTRY = next(c for c in BENCH["configs"] if c["name"] == CONFIG)
with open(os.path.join(ROOT, ENTRY["file"])) as f:
    FILE = json.load(f)
# what the cell's per-layer entries list
NEW = ["rows_per_s.nested", "host_s_per_Mrow.nested",
       "page_parse_s_per_Mrow.nested", "level_walk_s_per_Mrow",
       "decode_roofline_share.nested", "decompress_s_per_Mrow.nested",
       "host_python_s_per_Mrow.nested", "host_offcpu_share.nested",
       "snappy_walk_s_per_Mrow.nested", "snappy_walk_wasted_share.nested",
       "enqueue_s_per_Mrow.nested", "device_idle_share.nested",
       "level_k1_slot_share"]
# what each ``.nested`` reader copies
COPIES = {n: n[: -len(".nested")] for n in NEW if n.endswith(".nested")}
COPIES.update({"rows_per_s.nested": "rows_per_s.pyarrow",
               "device_idle_share.nested": "device_idle_share.scan"})


def test_the_file_states_its_deployment():
    assert FILE["name"] == CONFIG and FILE["source"] == ENTRY["source"]
    assert "TPC-H" in FILE["source"] and "LogicalTypes.md" in FILE["source"]
    assert FILE["table"] == "orders_nested_full"
    assert FILE["layout"] == "port_writer"
    assert FILE["lineitems"] == 6_001_215
    assert FILE["rows_per_group"] == 250_000
    # nothing is cut: ORDERS' 9 columns and LINEITEM's 15 but its key
    assert FILE["reduced"] == ENTRY["reduced"] == []
    assert FILE["orders_columns"] == orders_nested_full.ORDER_COLUMNS
    assert len(FILE["orders_columns"]) == 9
    assert FILE["lineitem_columns"] == orders_nested_full.LINE_COLUMNS
    assert len(FILE["lineitem_columns"]) == 15
    assert len(FILE["assumed"]) >= 5
    assert "ORDER_SEED 7" in " ".join(FILE["assumed"])
    assert "1,500,153" in " ".join(FILE["assumed"])
    assert "def level" in FILE["guarantees"]
    assert "rep level" in FILE["guarantees"]
    assert "CRC" in FILE["guarantees"]


def test_the_pin_is_the_sf1_write():
    pin = FILE["pinned_layout"]
    assert sum(pin["row_group_rows"]) == 1_500_153
    assert pin["row_group_rows"] == [250_000] * 6 + [153]
    assert set(pin["chunk_encodings"]) == set(orders_nested_full.LEAVES)
    assert len(pin["chunk_encodings"]) == 24
    assert all(len(v) == 7 for v in pin["chunk_encodings"].values())


def test_the_cell_and_its_metrics():
    cell = harness.cell_of(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "full_scan", 1)
    ends = {m["name"] for m in harness.cell_metrics(BENCH, CELL, False)}
    assert ends == {"peak_device_mib", "setup_s"}
    layers = [m["name"] for m in harness.cell_metrics(BENCH, CELL, True)]
    assert layers == NEW
    for m in BENCH["per_layer"]:
        if m["name"] in NEW:
            assert m["workloads"] == [CELL]
            assert m["moves"] == "peak_device_mib"


FACTS = {"layer": {"reader": {"rows": 2_000_000, "host_seconds": 0.4,
                              "stage_seconds": 0.01,
                              "dispatch_seconds": 0.03},
                   "decode_bytes": {"read": 335_000_000_000, "written": 0},
                   "window_rows": 2_000_000},
         "device": {"window_s": 10.0, "busy_s": 0.5, "program_busy_s": 0.2},
         "window_s": 10.0, "peak_bytes_per_s": 3.35e12}
TOTALS = {"host_seconds": 4.0, "host_cpu_seconds": 3.5,
          "parts": {"page_parse": 0.2, "run_walk": 0.2, "level_walk": 0.5,
                    "decompress": 1.0, "python": 0.8, "snappy_walk": 0.1},
          "snappy_walk": {"wasted_seconds": 0.04}}
WANT = {"rows_per_s.nested": 200_000.0, "host_s_per_Mrow.nested": 0.2,
        "decode_roofline_share.nested": 50.0,
        "page_parse_s_per_Mrow.nested": 0.02,
        "decompress_s_per_Mrow.nested": 0.05,
        "host_python_s_per_Mrow.nested": 0.04,
        "host_offcpu_share.nested": 12.5,
        "snappy_walk_s_per_Mrow.nested": 0.005,
        "snappy_walk_wasted_share.nested": 40.0,
        "enqueue_s_per_Mrow.nested": 0.02,
        "device_idle_share.nested": 98.0}


def _read(mod, facts):
    """A reader's number, given :data:`TOTALS` where it reads the host
    phase's counters."""
    try:
        return mod.read(facts, TOTALS)
    except TypeError:
        return mod.read(facts)


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_reads_as_the_metric_it_copies(name):
    mod = harness.load_metric(ROOT, BENCH, name)
    assert _read(mod, FACTS) == pytest.approx(WANT[name])
    orig = harness.load_metric(ROOT, BENCH, COPIES[name])
    assert _read(mod, FACTS) == _read(orig, FACTS)
    assert _read(mod, {"layer": {}, "device": None, "window_s": 10.0,
                       "peak_bytes_per_s": 3.35e12}) is None


def test_the_level_walk_reader():
    mod = harness.load_metric(ROOT, BENCH, "level_walk_s_per_Mrow")
    # its share of the host phase times host_s_per_Mrow (0.2 here)
    assert mod.read(FACTS, TOTALS) == pytest.approx(0.025)
    # a program whose host phase has no level_walk part gives no reading
    parts = {k: v for k, v in TOTALS["parts"].items() if k != "level_walk"}
    assert mod.read(FACTS, {**TOTALS, "parts": parts}) is None
    assert mod.read(FACTS, {**TOTALS, "host_seconds": 0.0}) is None


def test_the_level_route_reader():
    mod = harness.load_metric(ROOT, BENCH, "level_k1_slot_share")
    by_route = {"k1": 300, "run_table": 600, "host": 100}
    totals = {"streams": {}, "slots": {"by_kind": {"def": 500, "rep": 500},
                                       "by_route": by_route}}
    assert mod.read(FACTS, totals) == pytest.approx(30.0)
    # no level stream planned: no reading
    none = {"streams": {}, "slots": {"by_kind": {}, "by_route": dict.fromkeys(
        by_route, 0)}}
    assert mod.read(FACTS, none) is None


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """The benchmark's files with the nested configuration cut to 40,000
    lineitems in groups of 2,500 orders, its layout pinned at that size."""
    root = str(tmp_path_factory.mktemp("pqbench_orders") / "root")
    shutil.copytree(os.path.join(ROOT, "pqbench"),
                    os.path.join(root, "pqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    cfg = dict(FILE, lineitems=40_000, rows_per_group=2_500)
    cfg.pop("pinned_layout", None)
    write_pinned(root, ENTRY["file"], cfg)
    return root


def test_a_run_of_the_cell_on_the_cpu(small_root):
    res = run_cell(small_root, CELL, seconds=1.5)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"peak_device_mib", "setup_s"}
    assert res["checks"]["row_groups_compared"]["value"] >= 1
    assert res["checks"]["digest_mismatches"]["value"] == 0
    # a window long enough for complete passes on a loaded machine
    traced = run_cell(small_root, CELL, seconds=4.0, trace=1,
                      seed=2_147_493_977)
    assert traced["correct"], traced["checks"]
    got = traced["metrics"]
    # the roofline and the idle share read the card's trace: a CPU run has
    # none
    assert set(got) == set(NEW) - {"decode_roofline_share.nested",
                                   "device_idle_share.nested"}
    assert all(got[n]["value"] > 0 for n in got)
    assert got["level_walk_s_per_Mrow"]["value"] < got[
        "host_s_per_Mrow.nested"]["value"]
    # every rep stream has bit-packed runs (the fused K1), every def stream
    # is one value (the run-table expand): as many slots each way
    assert got["level_k1_slot_share"]["value"] == pytest.approx(50.0)
