"""Helpers of the benchmark's CPU tests (imported by name, so the name is
one ``tests/`` does not use)."""

import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

TINY_ROWS = 150_000
TINY_GROUP = 50_000
# the nested configuration a test adds by files: lineitems, orders a group
NESTED_LINES = 12_000
NESTED_GROUP = 1_000
NESTED_CELL = "tiny_orders_scan"


def make_root(dest: str, rows: int = TINY_ROWS,
              group: int = TINY_GROUP) -> str:
    """A copy of the benchmark's files under ``dest`` with every
    configuration at ``rows`` rows in groups of ``group``."""
    from pqbench import write

    shutil.copytree(os.path.join(ROOT, "pqbench"),
                    os.path.join(dest, "pqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["rows"], cfg["rows_per_group"] = rows, group
        write_pinned(dest, c["file"], cfg)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def write_pinned(dest: str, file: str, cfg: dict) -> None:
    """Write configuration ``cfg`` to ``dest/file`` with its layout pinned
    from a write of its table (seed 7) through its layout's writer."""
    from pqbench import tables, write

    groups = tables.load(cfg["table"]).draw(7, cfg)
    path = os.path.join(dest, "pin.parquet")
    write.write_file(cfg, groups, path)
    lay = write.file_layout(path)
    os.remove(path)
    cfg["pinned_layout"] = {"row_group_rows": lay["row_group_rows"],
                            "chunk_encodings": lay["chunk_encodings"]}
    with open(os.path.join(dest, file), "w") as f:
        json.dump(cfg, f)


def add_nested(root: str) -> dict:
    """Add to the benchmark under ``root``, by a new configuration file and
    new entries alone, the nested table ``orders_nested`` in the port
    writer's layout at :data:`NESTED_LINES` lineitems in groups of
    :data:`NESTED_GROUP` orders, and the cell :data:`NESTED_CELL`, a full
    scan of it.  Returns the configuration."""
    cfg = {"name": "tiny_orders_nested", "source": "a test",
           "table": "orders_nested", "lineitems": NESTED_LINES,
           "rows_per_group": NESTED_GROUP, "layout": "port_writer",
           "reduced": []}
    file = "pqbench/configs/tiny_orders_nested.json"
    assert not os.path.exists(os.path.join(root, file))
    write_pinned(root, file, cfg)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": cfg["name"], "source": "a test",
                             "file": file, "reduced": [],
                             "why": "orders with their lineitems nested"})
    bench["workloads"].append({"name": NESTED_CELL, "config": cfg["name"],
                               "traffic": "full_scan", "chips": 1,
                               "why": "a full scan of the nested table"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lineitem_scan" in m.get("workloads", []):
            m["workloads"].append(NESTED_CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return cfg


def on_the_cpu(harness) -> None:
    """Make ``harness`` run its cells on the CPU, the look for a card
    skipped: the program's plain versions run, and the numbers are no
    device measurement.  For these tests alone."""
    import torch

    harness.open_device = lambda cell: torch.device("cpu")


def run_cell(root: str, workload: str, seconds: float = 2.0,
             seed: int = 2_147_483_901, trace: int = 0, out=None) -> dict:
    """One run of a cell on the CPU (the program's plain versions), its
    result line's object; what it prints goes to ``out`` where given."""
    import io

    from pqbench import harness

    real = harness.open_device
    on_the_cpu(harness)
    try:
        out, err = out or io.StringIO(), io.StringIO()
        return harness.run(["--workload", workload, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace",
                            str(trace)], root=root, out=out, err=err)
    finally:
        harness.open_device = real
