#!/usr/bin/env python3
"""The control of each cell's correctness check, at the cell's own size.

The control is the reference put in the program's place and computed in
the nearest precision below the one the schema states: every DOUBLE
column in float32.  For each seed this prints what the cell's check would
read if the control had produced the window's answers:

- ``full_scan``: mismatched row-group digests in one pass of every row
  group (a window holds one pass or more);
- ``shuffled_epochs``: mismatched epoch sums over one epoch, and
  mismatched batches among the ones sampled in an epoch.

    python3 pqbench/control.py --workload <cell> --seconds <s> \
        --seed <n> [--seed <n> ...]

NumPy only, like the reference: it needs no card and no program.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pqbench import harness, reference, tables  # noqa: E402


def readings(root: str, workload: str, seed: int, seconds: float) -> dict:
    bench = harness.load_benchmark(root)
    cell = harness.cell_of(bench, workload)
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = harness.load_data(os.path.join(root, entry["file"]))
    traffic = harness.load_data(harness.find(root, bench, "traffic",
                                             cell["traffic"]))
    table = tables.load(config["table"])
    groups = table.draw(seed, config)
    kind = traffic["kind"]
    if kind == "scan":
        names = traffic.get("columns") or table.LEAVES
        want = reference.group_digests(groups, names)
        got = reference.group_digests(groups, names, control=True)
        return {"digest_mismatches": int(np.any(got != want, axis=2).sum()),
                "row_groups_compared": len(groups)}
    if kind == "loader":
        names = traffic["columns"]
        rows = [len(g[names[0]]) for g in groups]
        order = reference.LoaderOrder(seed, rows, int(
            traffic["shuffle_window"]), int(traffic["batch_size"]))
        want = reference.LoaderAnswers(groups, names, order)
        got = reference.LoaderAnswers(groups, names, order, control=True)
        rng = random.Random(seed)
        picks = rng.sample(range(order.batches), min(
            int(traffic["check_batches_per_epoch"]), order.batches))
        bad = sum(int(np.any(want.batch(1, j) != got.batch(1, j)))
                  for j in picks)
        return {"epoch_sum_mismatches": int(np.any(
            want.epoch_sums(1) != got.epoch_sums(1))),
            "sampled_batch_mismatches": bad, "batches_compared": len(picks)}
    raise ValueError(f"no control for traffic kind {kind!r}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args()
    for seed in args.seed:
        r = readings(harness.ROOT, args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
