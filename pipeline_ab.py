#!/usr/bin/env python3
"""A/B timing of the port's device reads across two checkouts, on one GPU.

    python3 pipeline_ab.py PARENT_DIR [--passes N] [--rounds R]

``PARENT_DIR`` holds another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  The script writes, once, under
``build/pipeline_ab/``, two of ``chip_smoke.py``'s files with this
checkout's writer: phase 5's K3 file (GZIP, 92 row groups) and phase 6's
lineitem16 SF1 (16 columns, 7 row groups).  Then it times warm
``DeviceFileReader(path).iter_row_groups()`` passes of each file (ending in
``torch.cuda.synchronize()``), each variant in a child process of its own,
in the order A B C D ... D C B A for ``R`` rounds:

- ``parent``: ``PARENT_DIR``'s package;
- ``p0``: this checkout's, prefetch 0 (the staging worker on);
- ``p0-inline``: this checkout's, prefetch 0 with every staging job run on
  the consumer thread at submission (no staging worker, no strips);
- ``p0-switch``: ``p0`` with the interpreter's thread switch interval cut
  from 5 ms to 0.2 ms (``sys.setswitchinterval``), which shortens the
  waits of a thread that wants the GIL back from a thread running Python;
- ``p2``: this checkout's, prefetch 2.

Each child builds its checkout's kernels, reads each file once to warm up,
then ``N`` timed passes, and prints one JSON line per pass with the
reader's lanes (``host_seconds``, ``stage_seconds``,
``dispatch_seconds``).  The parent prints each variant's median rows/s per
file beside the card's name and power limit.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VARIANTS = ("parent", "p0", "p0-inline", "p0-switch", "p2")


def _files(work: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    os.makedirs(work, exist_ok=True)
    k3 = os.path.join(work, "k3_file_gzip.parquet")
    l16 = os.path.join(work, "lineitem16_sf1.parquet")
    if not os.path.exists(k3):
        cs.write_k3_file(k3, cs.gen_k3_groups())
    if not os.path.exists(l16):
        groups = [cs.lineitem_strings(g)
                  for g in cs.draw_lineitem16(cs.SF1_ROWS)]
        cs.write_lineitem16(l16, groups)
    return {"k3": (k3, cs.K3_COLUMNS), "lineitem16": (l16, cs.L16_COLUMNS)}


class _InlineExecutor:
    """Runs each job at submission on the calling thread."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args, **kwargs):
        from concurrent.futures import Future

        fut = Future()
        fut.set_result(fn(*args, **kwargs))
        return fut


def child(root: str, variant: str, passes: int, files: dict) -> None:
    sys.path.insert(0, root)
    import torch

    from tpu_parquet_torch import cuda_kernels as ck
    from tpu_parquet_torch import device_reader as DR

    ck.build()
    kw = {"prefetch": 2} if variant == "p2" else {}
    if variant == "p0-switch":
        sys.setswitchinterval(2e-4)
    if variant == "p0-inline":
        DR.ThreadPoolExecutor = _InlineExecutor
        DR._RowGroupStager.STRIP = 1 << 62
    for name, (path, columns) in files.items():
        for i in range(passes + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with DR.DeviceFileReader(path, columns=columns, **kw) as r:
                keep = list(r.iter_row_groups())
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                st = r.stats().as_dict()
            del keep
            if i:
                print(json.dumps({
                    "variant": variant, "file": name, "seconds": seconds,
                    "rows": st["rows"], "host": st["host_seconds"],
                    "stage": st["stage_seconds"],
                    "dispatch": st["dispatch_seconds"]}), flush=True)


def main() -> int:
    if "--child" in sys.argv:
        i = sys.argv.index("--child")
        root, variant, passes, spec = sys.argv[i + 1 : i + 5]
        child(root, variant, int(passes), json.loads(spec))
        return 0
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("pipeline_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    files = _files(os.path.join(HERE, "build", "pipeline_ab"))
    spec = json.dumps(files)
    order = []
    for r in range(args.rounds):
        order += list(VARIANTS) if r % 2 == 0 else list(VARIANTS)[::-1]
    rows: list = []
    for variant in order:
        root = os.path.abspath(args.parent) if variant == "parent" else HERE
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", root,
             variant, str(args.passes), spec],
            capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            if line.startswith("{"):
                rec = json.loads(line)
                rows.append(rec)
                print(line, flush=True)
    for name in files:
        for variant in VARIANTS:
            got = [r for r in rows
                   if r["file"] == name and r["variant"] == variant]
            rps = [r["rows"] / r["seconds"] for r in got]
            med = {k: statistics.median(r[k] for r in got)
                   for k in ("seconds", "host", "stage", "dispatch")}
            print(f"{name} {variant}: median {statistics.median(rps):.1f} "
                  f"rows/s over {len(got)} passes (min {min(rps):.1f}, max "
                  f"{max(rps):.1f}); median seconds {med['seconds']:.4f}, "
                  f"host {med['host']:.4f}, stage {med['stage']:.4f}, "
                  f"dispatch {med['dispatch']:.4f} ({smi})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
