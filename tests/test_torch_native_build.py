"""The port's g++ native library builds safely when many processes load it
at once.

A fresh copy of ``tpu_parquet_torch/native/`` (sources only, nothing built)
goes into a temporary directory; eight processes import that copy and call
``load()`` at the same moment, as the workers of a parallel test run do.
Every one must end with the library available: none may open a file that
another process is still writing, or delete one it is building.
"""

import os
import shutil
import subprocess
import sys
import time

import pytest

import tpu_parquet_torch.native as native

PROCESSES = 8

_CHILD = """
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location(
    "tpq_native_copy", sys.argv[1] + "/__init__.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
start = float(sys.argv[2])
while time.time() < start:
    time.sleep(0.0005)
mod.load()
print("available" if mod.available() else "unavailable")
"""


def _fresh_copy(dst) -> str:
    src = os.path.dirname(os.path.abspath(native.__file__))
    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith((".py", ".cpp")):
            shutil.copy(os.path.join(src, name), dst)
    return str(dst)


@pytest.mark.parametrize("rep", range(2))
def test_concurrent_first_load_is_available_everywhere(tmp_path, rep):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot build")
    copy = _fresh_copy(tmp_path / "native")
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, copy, str(start)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(PROCESSES)]
    results = [p.communicate(timeout=240) for p in procs]
    said = [out.strip() for out, _ in results]
    assert said == ["available"] * PROCESSES, [err for _, err in results]
    built = [f for f in os.listdir(copy) if f.startswith("_libtpq_native.so")]
    # one finished library, and no temporary file left behind
    assert len(built) == 1 and ".tmp" not in built[0], built
