"""On the card: one short run of a cell, correct, on the GPU platform."""

import json
import subprocess
import sys

import pytest

from pqbench_support import ROOT


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "pqbench/run.py", "--workload", "lineitem_scan",
         "--seed", "3", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
