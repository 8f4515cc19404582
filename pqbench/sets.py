#!/usr/bin/env python3
"""Run cells several times, one process per run, and summarise the spread.

    python3 pqbench/sets.py --workload <cell> [--workload <cell> ...] \
        --seeds <n,n,...> [--sets 2] [--seconds <s>] [--trace 0|1] \
        [--out <file.jsonl>]

Each set runs every seed once, in order; the sets use the same seeds.  For
each cell and metric it prints every value, the median and the spread
(third quartile less first, over the median, as
``statistics.quantiles(values, n=4)`` gives the quartiles) of each set,
also with the run farthest from the median left out, and
appends every result line to ``--out``.  The runs of a call run one after
another, so one process uses the card at a time.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from pqbench import timing  # noqa: E402


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    out = {"workload": workload, "seed": seed, "rc": p.returncode,
           "wall_s": time.perf_counter() - t0, "trace": trace}
    if p.returncode == 0 and len(lines) >= 2:
        out["result"] = json.loads(lines[-1])
        out["side"] = json.loads(lines[-2])
    else:
        out["stderr"] = p.stderr[-3000:]
    return out


def summary(runs: list) -> dict:
    out: dict = {}
    for r in runs:
        if "result" not in r:
            continue
        for name, m in r["result"]["metrics"].items():
            out.setdefault(name, []).append(m["value"])
    return {n: {"values": v, "median": statistics.median(v),
                "spread": (timing.quartile_spread(v) if len(v) >= 2
                           else None),
                "trimmed": (timing.trimmed_spread(v) if len(v) >= 3
                            else None)} for n, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        seconds = (args.seconds if args.seconds is not None
                   else json.load(f)["run_seconds"])
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    for w in args.workload:
        sets = []
        for k in range(args.sets):
            runs = []
            for seed in seeds:
                r = one(w, seed, seconds, args.trace)
                r["set"] = k
                runs.append(r)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(r) + "\n")
                res = r.get("result", {})
                print(json.dumps({
                    "workload": w, "set": k, "seed": seed, "rc": r["rc"],
                    "wall_s": round(r["wall_s"], 1),
                    "correct": res.get("correct"),
                    "metrics": {n: m["value"] for n, m in
                                res.get("metrics", {}).items()},
                    "checks": res.get("checks"),
                    "err": r.get("stderr", "")[-600:]}), flush=True)
            sets.append(summary(runs))
        print(json.dumps({"workload": w, "sets": sets}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
