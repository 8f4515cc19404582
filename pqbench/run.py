#!/usr/bin/env python3
"""Run one cell of the benchmark once on the card.

    python3 pqbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The last line of standard output is the
result (one JSON object); the line before it gives the split of set-up;
the last lines of standard error give each number the correctness check
compared, beside its limit.  Without a CUDA card (or with fewer than the
cell asks for) it exits non-zero and prints no result.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pqbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
