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


def make_root(dest: str, rows: int = TINY_ROWS,
              group: int = TINY_GROUP) -> str:
    """A copy of the benchmark's files under ``dest`` with every
    configuration at ``rows`` rows in groups of ``group``."""
    from pqbench import lineitem, write

    shutil.copytree(os.path.join(ROOT, "pqbench"),
                    os.path.join(dest, "pqbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["rows"], cfg["rows_per_group"] = rows, group
        groups = lineitem.draw(7, rows, group)
        path = os.path.join(dest, "pin.parquet")
        write.write_file(cfg, groups, path)
        lay = write.file_layout(path)
        os.remove(path)
        cfg["pinned_layout"] = {"row_group_rows": lay["row_group_rows"],
                                "chunk_encodings": lay["chunk_encodings"]}
        with open(os.path.join(dest, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def on_the_cpu(harness) -> None:
    """Make ``harness`` run its cells on the CPU, the look for a card
    skipped: the program's plain versions run, and the numbers are no
    device measurement.  For these tests alone."""
    import torch

    harness.open_device = lambda cell: torch.device("cpu")


def run_cell(root: str, workload: str, seconds: float = 2.0,
             seed: int = 2_147_483_901, trace: int = 0) -> dict:
    """One run of a cell on the CPU (the program's plain versions), its
    result line's object."""
    import io

    from pqbench import harness

    real = harness.open_device
    on_the_cpu(harness)
    try:
        out, err = io.StringIO(), io.StringIO()
        return harness.run(["--workload", workload, "--seed", str(seed),
                            "--seconds", str(seconds), "--trace",
                            str(trace)], root=root, out=out, err=err)
    finally:
        harness.open_device = real
