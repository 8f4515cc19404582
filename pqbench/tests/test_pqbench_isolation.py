"""What the harness and the reference load, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest

from pqbench_support import ROOT

REFUSE = """
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "tpu_parquet"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {root!r})
"""


def run_py(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, **env})


@pytest.mark.parametrize("cell", ["lineitem_scan", "pyarrow_scan",
                                  "lineitem_loader"])
def test_a_run_loads_nothing_of_jax_or_the_jax_package(tiny_root, cell):
    code = REFUSE.format(root=ROOT) + f"""
import io, json
from pqbench import harness
import torch
harness.open_device = lambda cell: torch.device("cpu")
res = harness.run(["--workload", {cell!r}, "--seed", "5", "--seconds", "1",
                   "--trace", "1"], root={tiny_root!r},
                  out=io.StringIO(), err=io.StringIO())
print(json.dumps({{"correct": res["correct"],
                  "held": harness.forbidden_modules(),
                  "port": "tpu_parquet_torch" in sys.modules}}))
"""
    p = run_py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"correct": True, "held": [], "port": True}


def test_the_reference_loads_nothing_of_the_program():
    code = REFUSE.format(root=ROOT) + """
import json
from pqbench import lineitem, reference
g = lineitem.draw(3, 20_000, 10_000)
reference.group_digests(g, lineitem.COLUMNS)
o = reference.LoaderOrder(3, [10_000, 10_000], 4096, 1024)
reference.LoaderAnswers(g, ["l_tax"], o).batch(0, 3)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""
    p = run_py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "tpu_parquet_torch" not in tops and "torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_parquet"}


def test_the_nested_tables_reference_loads_nothing_of_the_program():
    code = REFUSE.format(root=ROOT) + """
import json
from pqbench import reference, tables
t = tables.load("orders_nested")
g = t.draw(3, {"lineitems": 9_000, "rows_per_group": 1_000})
reference.group_digests(g, t.LEAVES)
reference.group_digests(g, t.LEAVES, control=True)
reference.decoded_bytes(g)
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""
    p = run_py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "tpu_parquet_torch" not in tops and "torch" not in tops
    assert not tops & {"jax", "jaxlib", "flax", "tpu_parquet"}


def test_a_process_holding_jax_gives_no_result(monkeypatch):
    from pqbench import harness

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "tpu_parquet_torch_x", object())
    assert harness.forbidden_modules() == []


def test_no_card_exits_non_zero_with_no_result():
    p = subprocess.run(
        [sys.executable, "pqbench/run.py", "--workload", "lineitem_scan",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]


def test_without_the_program_a_run_fails(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "pqbench"), tmp_path / "pqbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "pqbench/run.py", "--workload", "lineitem_scan",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, env=env)
    assert p.returncode != 0
    assert not [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
