"""The port's CLI (``tpu_parquet_torch.cli``: ``pq_tool`` and
``csv2parquet``) against the reference's.

Three parts:

- ``tests/test_cli.py`` case for case against the port, its subprocess
  cases run as ``python -m tpu_parquet_torch.cli.pq_tool`` and
  ``python -m tpu_parquet_torch.cli.csv2parquet``;
- one parametrised parity test over the 19 subcommands (``trace`` and
  ``trace --request`` counted apart, ``bench diff`` and ``bench history``
  too): on the same input both packages' commands print the same text
  (paths of each package's outputs normalized) and return the same code;
  ``split``, ``merge`` and ``compact`` write byte-identical files, and
  ``csv2parquet`` does over several flag sets.  The inputs are files,
  registry trees, trace documents, flight dumps, a quarantine ledger, a run
  ledger and fleet spools, most of them made by the port (a read on
  ``device="cpu"``, a ``ScanService``, a watchdog's dump, spool writers);
- the reference's CLI cases that waited for the port's ``pq_tool``
  (``tests/test_write_scale.py``, ``tests/test_serve.py``,
  ``tests/test_result_cache.py``, ``tests/test_request_trace.py``,
  ``tests/test_resilience.py``, ``tests/test_obs_fleet.py``), each on the
  port's own artifacts: its write stats, its ``ScanService``, its spool
  members from three port processes.

The port's registry trees keep the reference's keys and kernel families
(``DeviceStats.cuda_kernels()`` is not part of the tree), so ``doctor``
and ``trace`` render a port read exactly as the reference renders it;
``test_doctor_and_trace_on_a_port_read`` pins that text.
"""

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)
from tpu_parquet import errors as ref_errors
from tpu_parquet.cli import csv2parquet as ref_csv2parquet
from tpu_parquet.cli import pq_tool as ref_pq_tool
from tpu_parquet_torch import errors
from tpu_parquet_torch.cli import csv2parquet, pq_tool
from tpu_parquet_torch.cli.pq_tool import parse_human_size

ensure_reference_native()

REPO_ROOT = str(pathlib.Path(__file__).resolve().parent.parent)


@pytest.fixture(autouse=True)
def _parity_env(io_env, no_reference_crashes, reference_env_warnings):
    """Both packages' engines stopped and no ``tpq-`` thread left
    (``io_env``), the reference's crash rings and env warnings as found,
    and the planner knobs pinned so ``compact`` plans alike."""
    io_env.setenv("TPQ_LINK_MBPS", "350")
    for name in ("TPQ_OBS_SPOOL", "TPQ_TRACE", "TPQ_LEDGER",
                 "TPQ_QUARANTINE_LOG", "TPQ_FORCE_ROUTE"):
        io_env.delenv(name, raising=False)
    yield io_env


# ---------------------------------------------------------------------------
# tests/test_cli.py, case for case
# ---------------------------------------------------------------------------

def _sample_table():
    return pa.table({
        "id": pa.array(range(100), pa.int64()),
        "name": pa.array([f"n{i}" for i in range(100)]),
        "lst": pa.array([[i, i + 1] for i in range(100)],
                        pa.list_(pa.int64())),
    })


@pytest.fixture()
def sample(tmp_path):
    p = tmp_path / "s.parquet"
    pq.write_table(_sample_table(), p, row_group_size=40)
    return p


def run_tool(args, tool=pq_tool):
    out = io.StringIO()
    parsed = tool.build_parser().parse_args(args)
    rc = parsed.func(parsed, out=out)
    return rc, out.getvalue()


def test_rowcount(sample):
    rc, out = run_tool(["rowcount", str(sample)])
    assert rc == 0 and out.strip() == "100"


def test_cat_and_head(sample):
    rc, out = run_tool(["head", "-n", "3", str(sample)])
    assert rc == 0
    lines = [json.loads(line) for line in out.splitlines()]
    assert lines[0] == {"id": 0, "name": "n0", "lst": [0, 1]}
    assert len(lines) == 3
    rc, out = run_tool(["cat", str(sample)])
    assert len(out.splitlines()) == 100


def test_meta(sample):
    rc, out = run_tool(["meta", str(sample)])
    assert rc == 0
    assert "rows: 100" in out
    assert "row groups: 3" in out
    assert "R=1 D=3" in out  # lst.list.element levels
    assert "codec=" in out


def test_schema(sample):
    rc, out = run_tool(["schema", str(sample)])
    assert rc == 0
    assert out.startswith("message")
    assert "optional int64 id" in out  # pyarrow writes columns optional
    # output must be parseable by the port's own DSL
    from tpu_parquet_torch.schema.dsl import parse_schema_definition

    assert parse_schema_definition(out).num_columns == 3


def test_split(sample, tmp_path):
    pattern = str(tmp_path / "part_{}.parquet")
    rc, out = run_tool(
        ["split", "--size", "2KiB", "--output-pattern", pattern, str(sample)]
    )
    assert rc == 0
    parts = sorted(tmp_path.glob("part_*.parquet"))
    assert len(parts) >= 2
    total = 0
    for part in parts:
        t = pq.read_table(part)
        total += t.num_rows
    assert total == 100


def test_parse_human_size():
    assert parse_human_size("4096") == 4096
    assert parse_human_size("100MB") == 100_000_000
    assert parse_human_size("1GiB") == 1 << 30
    assert parse_human_size("1.5KiB") == 1536
    with pytest.raises(ValueError):
        parse_human_size("ten bytes")


def _no_jax_env():
    env = dict(os.environ)
    env.pop("TPQ_OBS_SPOOL", None)
    return env


def test_cli_subprocess(sample):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_parquet_torch.cli.pq_tool", "rowcount",
         str(sample)],
        capture_output=True, text=True, cwd=REPO_ROOT, env=_no_jax_env(),
    )
    assert r.returncode == 0 and r.stdout.strip() == "100", r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "tpu_parquet_torch.cli.pq_tool", "meta",
         "/nonexistent"],
        capture_output=True, text=True, cwd=REPO_ROOT, env=_no_jax_env(),
    )
    assert r.returncode == 1
    assert "pq-tool:" in r.stderr


def test_csv2parquet_basic(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text(
        "id,name,price,ok,when\n"
        "1,apple,1.5,true,2024-01-01T10:00:00Z\n"
        "2,banana,0.75,false,2024-06-15T20:30:00Z\n"
    )
    out_path = tmp_path / "out.parquet"
    n = csv2parquet.convert(
        str(csv_path), str(out_path),
        csv2parquet.parse_type_hints(
            "id=int64,price=double,ok=boolean,when=timestamp"),
    )
    assert n == 2
    t = pq.read_table(out_path)
    assert t.column("id").to_pylist() == [1, 2]
    assert t.column("name").to_pylist() == ["apple", "banana"]
    assert t.column("ok").to_pylist() == [True, False]
    assert t.column("price").to_pylist() == [1.5, 0.75]


def test_csv2parquet_optional_nulls(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text("a,b\n1,\n,x\n")
    out_path = tmp_path / "out.parquet"
    csv2parquet.convert(
        str(csv_path), str(out_path),
        csv2parquet.parse_type_hints("a=int64"), wrap="optional",
    )
    t = pq.read_table(out_path)
    assert t.column("a").to_pylist() == [1, None]
    assert t.column("b").to_pylist() == [None, "x"]


def test_csv2parquet_errors(tmp_path):
    with pytest.raises(ValueError, match="invalid type hint"):
        csv2parquet.parse_type_hints("justaname")
    with pytest.raises(ValueError, match="unknown type"):
        csv2parquet.parse_type_hints("a=quux")
    csv_path = tmp_path / "bad.csv"
    csv_path.write_text("a,b\n1\n")
    with pytest.raises(ValueError, match="line 2"):
        csv2parquet.convert(str(csv_path), str(tmp_path / "o.parquet"), {})
    csv_path2 = tmp_path / "bad2.csv"
    csv_path2.write_text("a\nnot_an_int\n")
    with pytest.raises(ValueError, match="column 'a'"):
        csv2parquet.convert(
            str(csv_path2), str(tmp_path / "o2.parquet"),
            {"a": "int64"},
        )


def test_csv2parquet_hint_for_unknown_column(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text("a\n1\n")
    with pytest.raises(ValueError, match="unknown column"):
        csv2parquet.convert(
            str(csv_path), str(tmp_path / "o.parquet"), {"zzz": "int64"}
        )


def test_csv2parquet_cli(tmp_path):
    csv_path = tmp_path / "in.csv"
    csv_path.write_text("x,y\n1,hello\n2,world\n")
    out_path = tmp_path / "out.parquet"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_parquet_torch.cli.csv2parquet",
         "-i", str(csv_path), "-o", str(out_path), "--type-hints", "x=int32"],
        capture_output=True, text=True, cwd=REPO_ROOT, env=_no_jax_env(),
    )
    assert r.returncode == 0, r.stderr
    assert "wrote 2 rows" in r.stdout
    assert pq.read_table(out_path).num_rows == 2


def test_the_cli_modules_load_no_jax_and_no_reference():
    code = textwrap.dedent("""
        import sys
        import tpu_parquet_torch.cli.pq_tool, tpu_parquet_torch.cli.csv2parquet
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith(("jax.", "tpu_parquet."))
               or m == "tpu_parquet"]
        assert not bad, bad
    """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO_ROOT, env=_no_jax_env())
    assert r.returncode == 0, r.stderr


# ---------------------------------------------------------------------------
# the artifacts both CLIs read
# ---------------------------------------------------------------------------

def _port_file(path, groups=3, rows=400, seed=0):
    """Two INT64 columns and a dictionary string column, SNAPPY."""
    from tpu_parquet_torch.column import ByteArrayData, ColumnData
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    schema = build_schema([data_column("a", Type.INT64, FRT.REQUIRED),
                           data_column("b", Type.INT64, FRT.REQUIRED),
                           data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED)])
    rng = np.random.default_rng(seed)
    pool = [b"alpha", b"beta", b"gamma", b""]
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY) as w:
        for _ in range(groups):
            w.write_columns({
                "a": rng.integers(0, 1 << 30, rows),
                "b": rng.integers(0, 1 << 30, rows),
                "s": ColumnData(values=ByteArrayData.from_list(
                    [pool[i] for i in rng.integers(0, 4, rows)]))})
            w.flush_row_group()
    return path


def _third_fetch():
    seen = []
    lock = threading.Lock()

    def match(offset, size):
        with lock:
            seen.append(offset)
            return len(seen) == 3

    return match


def _hang_dump(path, dump, monkeypatch):
    """A port read through a store stalling on its third fetch, under
    ``hang_s=0.3`` and ``hang_policy="raise"``: the watchdog's dump."""
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)

    monkeypatch.setenv("TPQ_FLIGHT", dump)
    stores = []

    def make(f):
        st = FaultInjectingStore(
            LocalStore(f), FaultSpec(stall_first=1, stall_s=60.0,
                                     match=_third_fetch()),
            config=IOConfig(retries=0, backoff_ms=1.0))
        stores.append(st)
        return st

    r = DeviceFileReader(path, device="cpu", prefetch=2, hang_s=0.3,
                         hang_policy="raise", store=make)
    try:
        with pytest.raises(errors.HangError) as ei:
            for _ in r.iter_row_groups():
                pass
        assert ei.value.dump_path == dump
    finally:
        for st in stores:
            st.release()
        r.close()
        monkeypatch.delenv("TPQ_FLIGHT")
    del ei
    return dump


def _serve_artifacts(files, d, monkeypatch):
    """A port ``ScanService`` on the CPU: a tenant with an SLO, a host
    and a device request, a stream, the result cache, every request's
    trace retained; its registry tree and its trace dump."""
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    monkeypatch.setenv("TPQ_TRACE_TAIL", "1")
    with ScanService(concurrency=1, device="cpu",
                     result_cache_mb=64) as svc:
        svc.register_tenant("team-a", weight=2, slo_p99_ms=75.0)
        for _ in range(2):
            svc.scan(ScanRequest(files[0], tenant="team-a"), timeout=60)
        svc.scan(ScanRequest(files[1], device=True), timeout=60)
        list(svc.scan(ScanRequest(files[0], stream=True, batch_rows=256)))
        tree = svc.obs_registry().as_dict()
        docs = svc.sampler.traces()
        svc.trace_dump(str(d / "traces.json"))
    monkeypatch.delenv("TPQ_TRACE_TAIL")
    with open(d / "reg_serve.json", "w") as f:
        json.dump(tree, f)
    return docs[0]["trace_id"]


def _quarantine_log(path, d):
    """A ``skip_unit`` host read over a copy with two corrupt pages: the
    ledger ``TPQ_QUARANTINE_LOG`` would hold."""
    from tpu_parquet_torch.quarantine import Quarantine
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.writer import corrupt_page

    bad = str(d / "bad.parquet")
    shutil.copyfile(path, bad)
    for gi in (0, 2):
        corrupt_page(bad, row_group=gi, column=0, page=0, mode="zero",
                     seed=gi)
    log = str(d / "quarantine.jsonl")
    q = Quarantine("skip_unit", log_path=log)
    with FileReader(bad, on_data_error="skip_unit", quarantine=q,
                    validate_crc=True) as r:
        for _ in r.iter_row_groups():
            pass
    return log


def _ledger(d):
    from tests.test_torch_ledger import _record_pair
    from tpu_parquet_torch import ledger

    path = str(d / "ledger.jsonl")
    sides = []
    for seed in (0, 3):
        a, b = _record_pair(seed)
        for rec in (a, b):
            ledger.append(path, ledger.make_record(rec, ts=rec["ts"]))
        sides.append((a, b))
    a, b = sides[1]
    for name, rec in (("a", a), ("b", b)):
        with open(d / f"bench_{name}.json", "w") as f:
            json.dump(rec, f)
    return path


def _trace_spool(d, tid):
    """A spool of two port processes whose sampled traces join the
    service's retained request ``tid``."""
    from tpu_parquet_torch.obs import RequestTrace, StatsRegistry
    from tpu_parquet_torch.obs_fleet import SpoolWriter

    spool = d / "trace_spool"
    ctx = RequestTrace(trace_id=tid).trace_context()
    for pid in (4101, 4102):
        child = RequestTrace.adopt_context(ctx)
        with child.span("child-work", pid=pid):
            pass
        child.finish()
        SpoolWriter(StatsRegistry(), role="loader", spool_dir=str(spool),
                    interval_s=999.0, keep=2, host="nodeB", pid=pid,
                    sampler=lambda c=child: [c.as_dict()]).publish_once()
    return spool


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    from tests.test_torch_obs_fleet import _mixed_spool
    from tests.test_torch_serve_resilience import _reg_tree_with_everything
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.iostore_async import shutdown_default_engine

    d = tmp_path_factory.mktemp("torch_cli")
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("TPQ_LINK_MBPS", "350")
        a = argparse.Namespace(dir=d)
        a.sample = str(d / "sample.parquet")
        pq.write_table(_sample_table(), a.sample, row_group_size=40)
        a.files = [_port_file(str(d / f"f{i}.parquet"), seed=i)
                   for i in range(3)]
        a.trace = str(d / "trace.json")
        with DeviceFileReader(a.files[0], device="cpu",
                              trace=a.trace) as r:
            for _ in r.iter_row_groups():
                pass
            tree = r.obs_registry().as_dict()
        a.reg_read = str(d / "reg_read.json")
        with open(a.reg_read, "w") as f:
            json.dump(tree, f)
        a.hang = _hang_dump(a.files[1], str(d / "hang.json"), mp)
        a.tid = _serve_artifacts(a.files, d, mp)
        a.reg_serve = str(d / "reg_serve.json")
        a.traces = str(d / "traces.json")
        a.everything = str(d / "everything.json")
        with open(a.everything, "w") as f:
            json.dump(_reg_tree_with_everything(), f)
        a.circuit = str(d / "circuit.json")
        with open(a.circuit, "w") as f:
            json.dump(_circuit_doc(a.files[2]), f)
        a.quarantine = _quarantine_log(a.files[2], d)
        a.ledger = _ledger(d)
        a.bench = (str(d / "bench_a.json"), str(d / "bench_b.json"))
        a.spool = str(_mixed_spool(d))
        a.trace_spool = str(_trace_spool(d, a.tid))
    finally:
        shutdown_default_engine()
        mp.undo()
    return a


def _circuit_doc(path):
    return {
        "flight_version": 1, "reason": "explicit", "pid": 1234,
        "threads": {}, "stacks": {}, "budgets": [], "samples": {
            "serve": {
                "queue_depth": 0, "in_flight": 0, "requests": {},
                "circuit_open": [{"file": str(path), "retry_after_s": 4.5,
                                  "state": "open"}],
            },
        },
    }


# ---------------------------------------------------------------------------
# parity: every subcommand prints the reference's text
# ---------------------------------------------------------------------------

_AGE = re.compile(r"\b\d+\.\ds\b")


def _run_pkg(tool, err_type, argv):
    """What ``main`` does, with stdout and stderr captured: the command's
    code, or 1 and the ``pq-tool:`` line for a refused input."""
    out, err = io.StringIO(), io.StringIO()
    parsed = tool.build_parser().parse_args(argv)
    with contextlib.redirect_stderr(err):
        try:
            rc = parsed.func(parsed, out=out)
        except (err_type, ValueError, OSError) as e:
            print(f"pq-tool: {e}", file=sys.stderr)
            rc = 1
    return rc, out.getvalue(), err.getvalue()


def _both(argv_for, tmp_path, norm=None):
    """Run ``argv_for(outdir)`` through the port's and the reference's
    ``pq_tool``, each writing under its own directory; returns the two
    results with each output directory replaced by ``<out>``."""
    res = {}
    for name, tool, err_type in (
            ("port", pq_tool, errors.ParquetError),
            ("reference", ref_pq_tool, ref_errors.ParquetError)):
        outdir = tmp_path / name
        outdir.mkdir(exist_ok=True)
        rc, out, err = _run_pkg(tool, err_type, argv_for(outdir))
        texts = []
        for t in (out, err):
            t = t.replace(str(outdir), "<out>")
            texts.append(norm(t) if norm else t)
        res[name] = (rc, *texts)
    return res["port"], res["reference"]


def _same_files(tmp_path, pattern="*"):
    port = sorted(p.relative_to(tmp_path / "port")
                  for p in (tmp_path / "port").rglob(pattern) if p.is_file())
    ref = sorted(p.relative_to(tmp_path / "reference")
                 for p in (tmp_path / "reference").rglob(pattern)
                 if p.is_file())
    assert port == ref and port
    for rel in port:
        assert ((tmp_path / "port" / rel).read_bytes()
                == (tmp_path / "reference" / rel).read_bytes()), rel
    return port


def _copy_inputs(tmp_path, paths):
    """The same inputs under each package's directory (``compact`` writes
    beside its dataset)."""
    for name in ("port", "reference"):
        (tmp_path / name).mkdir(exist_ok=True)
        for i, p in enumerate(paths):
            shutil.copyfile(p, tmp_path / name / f"m{i}.parquet")


# (name, argv from the artifacts and the output directory, output files
# compared byte for byte, normalization)
SUBCOMMANDS = {
    "cat": (lambda a, o: ["cat", "--filter", "id > 50", a.sample], None,
            None),
    "head": (lambda a, o: ["head", "-n", "7", a.files[0]], None, None),
    "meta": (lambda a, o: ["meta", a.sample], None, None),
    "schema": (lambda a, o: ["schema", a.files[0]], None, None),
    "rowcount": (lambda a, o: ["rowcount", "--filter", "id < 30",
                               a.sample], None, None),
    "stats": (lambda a, o: ["stats", a.files[0]], None, None),
    "trace": (lambda a, o: ["trace", a.trace], None, None),
    "trace --request": (lambda a, o: ["trace", a.traces, "--request",
                                      a.tid, "--spool", a.trace_spool],
                        None, None),
    "doctor": (lambda a, o: ["doctor", a.everything], None, None),
    "autopsy": (lambda a, o: ["autopsy", a.circuit], None, None),
    "quarantine": (lambda a, o: ["quarantine", a.quarantine], None, None),
    "serve-stats": (lambda a, o: ["serve-stats", a.reg_serve], None, None),
    "top": (lambda a, o: ["top", "--once", "--stale", "30", a.spool], None,
            lambda t: _AGE.sub("<age>s", t)),
    "metrics": (lambda a, o: ["metrics", a.reg_serve], None, None),
    "bench diff": (lambda a, o: ["bench", "diff", *a.bench], None, None),
    "bench history": (lambda a, o: ["bench", "history", "-n", "3",
                                    a.ledger], None, None),
    "split": (lambda a, o: ["split", "--size", "4KiB", "--output-pattern",
                            str(o / "part_{}.parquet"), a.files[0]],
              "part_*.parquet", None),
    "merge": (lambda a, o: ["merge", str(o / "merged.parquet"),
                            *a.files], "merged.parquet", None),
    "compact": (lambda a, o: ["compact", str(o / "m0.parquet"),
                              str(o / "m1.parquet"), "--out", str(o),
                              "--target-size", "64MB"], "*.parquet", None),
}


def test_nineteen_subcommands():
    assert len(SUBCOMMANDS) == 19
    p = pq_tool.build_parser()
    names = set(p._subparsers._group_actions[0].choices)
    assert names == {n.split()[0] for n in SUBCOMMANDS}
    assert names == set(
        ref_pq_tool.build_parser()._subparsers._group_actions[0].choices)


@pytest.mark.parametrize("name", list(SUBCOMMANDS))
def test_subcommand_prints_the_references_text(name, art, tmp_path):
    argv_for, files, norm = SUBCOMMANDS[name]
    if name == "compact":
        _copy_inputs(tmp_path, art.files[:2])
    got, want = _both(lambda o: argv_for(art, o), tmp_path, norm)
    assert got == want
    # bench diff exits 1 on a regression beyond noise: the pair has some
    assert got[0] == (1 if name == "bench diff" else 0) and got[1], got
    if name == "bench diff":
        assert "REGRESSION" in got[1].upper()
    if files:
        written = _same_files(tmp_path, files)
        if name == "split":
            assert len(written) >= 3


_HB_AGE = re.compile(r"(heartbeat_age_seconds\{[^}]*\}) [0-9.]+")


@pytest.mark.parametrize("argv_for", [
    lambda a, o: ["metrics", a.reg_serve, a.everything],
    lambda a, o: ["metrics", "--spool", a.spool],
    lambda a, o: ["doctor", a.reg_serve],
    lambda a, o: ["serve-stats", a.everything],
    lambda a, o: ["trace", a.traces, "--request", "tpq-nope"],
    lambda a, o: ["meta", str(o / "absent.parquet")],
    lambda a, o: ["quarantine", str(o / "absent.jsonl")],
    lambda a, o: ["top", "--once", str(o / "no_spool")],
    lambda a, o: ["serve-stats", a.trace],
], ids=["metrics-diff", "metrics-spool", "doctor-serve",
        "serve-stats-everything", "trace-unknown-request", "meta-absent",
        "quarantine-absent", "top-empty", "serve-stats-no-section"])
def test_more_inputs_print_the_references_text(argv_for, art, tmp_path):
    """Diffs, the fleet exposition (heartbeat ages are the clock's), other
    trees and refusals."""
    got, want = _both(lambda o: argv_for(art, o), tmp_path,
                      lambda t: _HB_AGE.sub(r"\1 <age>", t))
    assert got == want


def test_doctor_and_trace_on_a_port_read(art, tmp_path):
    """A port read's registry keeps the reference's kernel families, so
    both doctors print the same text; its lines are pinned here."""
    tree = json.loads(pathlib.Path(art.reg_read).read_text())
    assert set(tree["device"]) == {"dispatches", "device_seconds", "routes",
                                   "kernels", "h2d"}
    assert set(tree["device"]["kernels"]) <= {
        "snappy_resolve", "unpack", "gather", "narrow", "levels", "plain",
        "fused"}
    for argv in (["doctor", art.reg_read], ["trace", art.trace]):
        got, want = _both(lambda o: argv, tmp_path)
        assert got == want and got[0] == 0
    _, text, _ = _both(lambda o: ["doctor", art.reg_read], tmp_path)[0]
    assert text.startswith(f"doctor: {art.reg_read}\nlanes: ")
    assert "\nverdict: " in text
    dev = [ln for ln in text.splitlines() if ln.startswith("device: ")]
    assert len(dev) == 1 and "dominant route" in dev[0]
    kern = re.search(r"\(kernel (\w+)\)", dev[0])
    assert kern and kern.group(1) in tree["device"]["kernels"]
    _, text, _ = _both(lambda o: ["trace", art.trace], tmp_path)[0]
    assert text.startswith(f"trace: {art.trace}\nevents: ")
    for stage in ("stage", "dispatch", "finalize", "device.h2d"):
        assert re.search(rf"^{re.escape(stage)} +\d+ ", text, re.M), stage
    assert "embedded registry: obs_version=1" in text


_CSV_ROWS = [
    ["id", "name", "price", "ok", "when", "day", "doc"],
    ["1", "apple", "1.5", "true", "2024-01-01T10:00:00Z", "2024-01-01",
     '{"a": 1}'],
    ["2", "", "0.75", "false", "2024-06-15T20:30:00Z", "2024-06-15",
     "[1, 2]"],
    ["3", "cherry", "2.25", "yes", "2023-12-31T23:59:59Z", "1999-12-31",
     "null"],
]


@pytest.mark.parametrize("flags", [
    ["--type-hints", "id=int64,price=double,ok=boolean,when=timestamp,"
                     "day=date,doc=json"],
    ["--type-hints", "id=int32,price=float", "--codec", "gzip",
     "--wrap", "optional"],
    ["--delimiter", ";", "--codec", "uncompressed", "--creator", "me"],
], ids=["hints", "optional-gzip", "delimiter"])
def test_csv2parquet_writes_the_references_bytes(flags, tmp_path):
    import csv

    sep = flags[flags.index("--delimiter") + 1] if "--delimiter" in flags \
        else ","
    src = tmp_path / "in.csv"
    with open(src, "w", newline="") as f:
        csv.writer(f, delimiter=sep).writerows(_CSV_ROWS)
    outs = {}
    for name, mod in (("port", csv2parquet), ("reference", ref_csv2parquet)):
        dst = tmp_path / f"{name}.parquet"
        buf, sch = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mod.main(["-i", str(src), "-o", str(dst), *flags])
        with contextlib.redirect_stdout(sch):
            rc2 = mod.main(["-i", str(src), "-o", str(dst),
                            "--print-schema", *flags])
        assert rc == rc2 == 0
        outs[name] = (buf.getvalue().replace(str(dst), "<out>"),
                      dst.read_bytes(), sch.getvalue())
    assert outs["port"] == outs["reference"]
    assert "wrote 3 rows" in outs["port"][0]


def test_csv2parquet_refusals_print_the_references_text(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text("a,b\n1\n")
    for argv in (["--type-hints", "a=quux"], ["--delimiter", ";;"], []):
        got = []
        for mod in (csv2parquet, ref_csv2parquet):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = mod.main(["-i", str(src), "-o",
                               str(tmp_path / "o.parquet"), *argv])
            got.append((rc, err.getvalue()))
        assert got[0] == got[1] and got[0][0] == 1, got


# ---------------------------------------------------------------------------
# the reference's CLI cases that waited for the port's pq_tool
# ---------------------------------------------------------------------------

def _ns(**kw):
    return argparse.Namespace(**kw)


def test_pq_tool_merge_and_compact(tmp_path):
    """``tests/test_write_scale.py::test_pq_tool_merge_and_compact``."""
    from tests.test_torch_write import (PORT, _batches, _schema,
                                        _single_writer_file)
    from tpu_parquet_torch.reader import FileReader
    from tpu_parquet_torch.write import load_manifest

    schema, batches = _schema(PORT), _batches(PORT, n_rgs=4)
    parts = []
    for i in range(2):
        p = str(tmp_path / f"p{i}.parquet")
        _single_writer_file(PORT, p, schema, batches[2 * i: 2 * i + 2])
        parts.append(p)
    out = str(tmp_path / "merged.parquet")
    rc, text = run_tool(["merge", out, *parts])
    assert rc == 0 and "merged 2 file(s)" in text
    with FileReader(out) as r:
        assert r.metadata.num_rows == 3200

    d = tmp_path / "ds"
    d.mkdir()
    for i, p in enumerate(parts):
        os.link(p, str(d / f"m{i}.parquet"))
    rc, text = run_tool(["compact", str(d / "m0.parquet"),
                         str(d / "m1.parquet"),
                         "--out", str(d), "--target-size", "64MB"])
    assert rc == 0
    assert "compacted 2 file(s)" in text and "link bytes" in text
    m = load_manifest(str(d))
    assert m.total_rows == 3200


def test_doctor_attributes_slow_write(tmp_path):
    """The ``cmd_doctor`` lines of
    ``tests/test_write_scale.py::test_doctor_attributes_slow_write``."""
    from tests.test_torch_write import PORT, _batches, _schema
    from tpu_parquet_torch.obs import StatsRegistry, doctor_registry
    from tpu_parquet_torch.write import WriteStats, write_sharded

    schema, batches = _schema(PORT), _batches(PORT, n_rgs=3)
    st = WriteStats()
    write_sharded(str(tmp_path / "w.parquet"), schema, batches,
                  workers=2, stats=st)
    reg = StatsRegistry()
    reg.add_write(st)
    rep = doctor_registry(reg.as_dict())
    assert rep["write"]["verdict"].startswith("write-")
    p = str(tmp_path / "reg.json")
    with open(p, "w") as f:
        json.dump(reg.as_dict(), f)
    out = io.StringIO()
    assert pq_tool.cmd_doctor(_ns(file=p, config=None), out=out) == 0
    text = out.getvalue()
    assert "write verdict: write-" in text and "write:" in text


def _serve_tree(tmp_path, files, **svc_kw):
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    with ScanService(device="cpu", **svc_kw) as svc:
        for _ in range(3):
            svc.scan(ScanRequest(files[0]))
        tree = svc.obs_registry().as_dict()
    path = str(tmp_path / "reg.json")
    with open(path, "w") as f:
        json.dump(tree, f)
    return path


def test_serve_stats_cli(art, tmp_path):
    """``tests/test_serve.py::test_serve_stats_cli``."""
    path = _serve_tree(tmp_path, art.files, concurrency=2)
    buf = io.StringIO()
    rc = pq_tool.cmd_serve_stats(_ns(file=path, config=None), out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "3 submitted" in out and "cache hits" in out and "p95" in out
    # a registry with no serve section is a one-line diagnosis, not a crash
    with open(path, "w") as f:
        json.dump({"obs_version": 1}, f)
    buf2 = io.StringIO()
    rc2 = pq_tool.cmd_serve_stats(_ns(file=path, config=None), out=buf2)
    assert rc2 == 1 and "no `serve` section" in buf2.getvalue()


def test_serve_stats_cli_tenants(art):
    """``tests/test_serve.py::test_serve_stats_cli_tenants``, and the
    tracing and exemplar lines of
    ``tests/test_request_trace.py::
    test_serve_stats_exemplar_rows_and_tracing_line`` (the artifacts'
    service retained every trace)."""
    buf = io.StringIO()
    rc = pq_tool.cmd_serve_stats(_ns(file=art.reg_serve, config=None),
                                 out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "tenants:" in out and "team-a" in out and "slo 75" in out
    assert "streaming: 1 session(s)" in out
    assert "tenant.team-a" in out  # the per-tenant SLO histogram row
    assert "tracing:" in out and "retained" in out
    assert "exemplars (bucket -> retained trace):" in out
    tree = json.loads(pathlib.Path(art.reg_serve).read_text())
    ex_ids = [ex[0] for hd in tree["histograms"].values()
              for ex in (hd.get("exemplars") or {}).values()]
    assert ex_ids and any(t in out for t in ex_ids)


def test_serve_stats_cli_result_cache_lines(art, tmp_path):
    """``tests/test_result_cache.py::
    test_serve_stats_cli_result_cache_lines``."""
    path = _serve_tree(tmp_path, art.files, concurrency=2,
                       result_cache_mb=64)
    buf = io.StringIO()
    rc = pq_tool.cmd_serve_stats(_ns(file=path, config=None), out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "result cache [host]" in out
    assert "cache hits" in out  # the plan-cache line survives unchanged


def _metrics_ns(file, file2=None, **kw):
    kw.setdefault("config", None)
    kw.setdefault("watch", False)
    kw.setdefault("interval", 2.0)
    kw.setdefault("count", None)
    return argparse.Namespace(file=file, file2=file2, **kw)


def _slo_burn_tree(trace_id="tpq-feed-1"):
    from tpu_parquet_torch.obs import LatencyHistogram

    h = LatencyHistogram()
    for _ in range(200):
        h.record(0.002)
    for _ in range(10):
        h.record(0.5, exemplar=trace_id)  # tail way past the 10ms SLO
    return {
        "obs_version": 1,
        "serve": {"requests": 210,
                  "tenants": {"acme": {"weight": 1, "slo_p99_ms": 10.0}}},
        "histograms": {"serve.tenant.acme": h.as_dict()},
    }


def test_metrics_cli_render_diff_watch(tmp_path):
    """``tests/test_request_trace.py::test_metrics_cli_render_diff_watch``,
    and the doctor's slo-burn lines."""
    a = _slo_burn_tree()
    b = json.loads(json.dumps(a))
    b["serve"]["requests"] = 250
    pa_, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    with open(pa_, "w") as f:
        json.dump(a, f)
    with open(pb, "w") as f:
        json.dump(b, f)

    buf = io.StringIO()
    assert pq_tool.cmd_metrics(_metrics_ns(pa_), out=buf) == 0
    text = buf.getvalue()
    assert "tpq_serve_requests 210" in text and "# EOF" in text
    assert 'trace_id="tpq-feed-1"' in text

    buf = io.StringIO()
    assert pq_tool.cmd_metrics(_metrics_ns(pa_, pb), out=buf) == 0
    assert "serve.requests" in buf.getvalue()
    assert "210 -> 250" in buf.getvalue()

    buf = io.StringIO()  # --watch bounded by --count exits cleanly
    assert pq_tool.cmd_metrics(
        _metrics_ns(pa_, watch=True, interval=0.01, count=2), out=buf) == 0
    assert "watching" in buf.getvalue()

    buf = io.StringIO()
    assert pq_tool.cmd_metrics(_metrics_ns(str(tmp_path / "nope.json")),
                               out=buf) == 1

    buf = io.StringIO()
    assert pq_tool.cmd_doctor(_ns(file=pa_, config=None), out=buf) == 0
    assert "slo-burn:" in buf.getvalue() and "'acme'" in buf.getvalue()
    assert "tpq-feed-1" in buf.getvalue()


def test_errored_request_trace_reconstructable(art, tmp_path,
                                               monkeypatch):
    """The ``cmd_trace`` lines of
    ``tests/test_request_trace.py::test_errored_request_trace_
    reconstructable``: a request that died on its store is retained and
    ``trace --request`` prints its span tree with the error."""
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           IOConfig, LocalStore)
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    monkeypatch.setenv("TPQ_TRACE_TAIL", "128")

    def factory(f):
        return FaultInjectingStore(LocalStore(f),
                                   FaultSpec(fail_first=10 ** 6),
                                   config=IOConfig(backoff_ms=1.0))

    svc = ScanService(concurrency=1, device="cpu", store=factory)
    try:
        with pytest.raises(Exception):
            svc.scan(ScanRequest(art.files[0]), timeout=60)
        docs = svc.sampler.traces()
        assert len(docs) == 1 and docs[0]["error"] is not None
        tid = docs[0]["trace_id"]
        dump = str(tmp_path / "traces.json")
        svc.trace_dump(dump)
    finally:
        svc.close()
    buf = io.StringIO()
    rc = pq_tool.cmd_trace(_ns(file=dump, request=tid, config=None),
                           out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert tid in out and "error:" in out and "fetch" in out
    buf = io.StringIO()
    rc = pq_tool.cmd_trace(_ns(file=dump, request="tpq-nope", config=None),
                           out=buf)
    assert rc == 1
    assert "TPQ_TRACE_TAIL" in buf.getvalue()


def test_doctor_cli_prints_circuit_and_hedge(art):
    """``tests/test_resilience.py::test_doctor_cli_prints_circuit_and_hedge``
    (the tree of ``tests/test_torch_serve_resilience.py``)."""
    buf = io.StringIO()
    rc = pq_tool.cmd_doctor(_ns(file=art.everything, config=None), out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "circuit-open: /data/bad.parquet" in out
    assert "hedge-ineffective" in out and "TPQ_IO_HEDGE_MS" in out


def test_serve_stats_cli_lifecycle_circuit_hedge_lines(art):
    """``tests/test_resilience.py::
    test_serve_stats_cli_lifecycle_circuit_hedge_lines``."""
    buf = io.StringIO()
    rc = pq_tool.cmd_serve_stats(_ns(file=art.everything, config=None),
                                 out=buf)
    out = buf.getvalue()
    assert rc == 0
    assert "lifecycle: 1 deadline-exceeded, 1 cancelled, shed 3 low" in out
    assert "circuit: 1 open now (/data/bad.parquet)" in out
    assert "hedges: 10 issued, 1 won (10%)" in out


def test_autopsy_names_open_circuit(art):
    """The ``cmd_autopsy`` lines of
    ``tests/test_resilience.py::test_autopsy_names_open_circuit``."""
    from tpu_parquet_torch.obs import autopsy_dump

    doc = json.loads(pathlib.Path(art.circuit).read_text())
    rep = autopsy_dump(doc)
    assert rep["verdict"] == "circuit-open"
    assert art.files[2] in rep["probable_cause"]
    buf = io.StringIO()
    assert pq_tool.cmd_autopsy(_ns(file=art.circuit), out=buf) == 0
    assert f"circuit: OPEN for {art.files[2]!r}" in buf.getvalue()


def test_autopsy_of_a_port_hang_dump(art, tmp_path):
    """The watchdog's dump of a port read stalled on its third fetch.  The
    port classifies a thread by its own modules' frames where the
    reference looks for its own (``obs._classify_frames``): the worker
    blocked in the port's store is ``io-wait`` in the port's text and
    ``worker-idle`` in the reference's; every other line is the same, and
    the verdict is the network stall."""
    from tpu_parquet_torch.obs import autopsy_dump

    rep = autopsy_dump(json.loads(pathlib.Path(art.hang).read_text()))
    assert rep["verdict"] == "network-stall"
    got, want = _both(lambda o: ["autopsy", art.hang], tmp_path)
    assert got[0] == want[0] == 0
    g, w = got[1].splitlines(), want[1].splitlines()
    assert len(g) == len(w)
    differ = [(a, b) for a, b in zip(g, w) if a != b]
    assert differ and all(
        re.sub(r"\bio-wait\b", "worker-idle", a) == b and "io-wait" in a
        for a, b in differ), differ
    assert any(ln.startswith("verdict: network-stall") or
               "network-stall" in ln for ln in g)


def test_stalled_request_watchdog_autopsy(art, tmp_path, monkeypatch):
    """The ``cmd_autopsy`` lines of
    ``tests/test_serve.py::test_stalled_request_watchdog_autopsy``: a
    stalled request's dump names it under ``stuck request``."""
    from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                           LocalStore)
    from tpu_parquet_torch.serve import ScanRequest, ScanService

    monkeypatch.setenv("TPQ_FLIGHT", str(tmp_path / "serve_hang.json"))
    stall_target = art.files[0]
    stores = []

    def factory(f):
        if getattr(f, "name", "") == stall_target:
            st = FaultInjectingStore(
                LocalStore(f), FaultSpec(stall_first=64, stall_s=60.0))
            stores.append(st)
            return st
        return LocalStore(f)

    svc = ScanService(concurrency=2, queue_depth=8, store=factory,
                      hang_s=0.5, device="cpu")
    try:
        stuck = svc.submit(ScanRequest(stall_target))
        with pytest.raises(errors.HangError) as ei:
            stuck.result(timeout=120)
        dump = ei.value.dump_path
        del ei
    finally:
        for st in stores:
            st.release()
        svc.close()
    buf = io.StringIO()
    assert pq_tool.cmd_autopsy(_ns(file=dump), out=buf) == 0
    assert "stuck request" in buf.getvalue()
    assert stall_target in buf.getvalue()


_WORKER_SRC = textwrap.dedent("""
    import json, os, sys, time

    from tpu_parquet_torch.obs import StatsRegistry
    from tpu_parquet_torch.obs_fleet import SpoolWriter, ambient_request_trace

    assert "jax" not in sys.modules and "tpu_parquet" not in sys.modules
    spool, idx, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    reg = StatsRegistry()
    reg.add_write({"rows": 100 * (idx + 1), "workers": idx + 1,
                   "encode_seconds": 10.0 if mode == "slow" else 1.0})
    reg.histogram("serve.request").record(1e-3 * (idx + 1),
                                          exemplar="t-w%d" % idx)
    tr = ambient_request_trace()  # adopts TPQ_TRACE_CONTEXT
    if tr is not None:
        with tr.span("child-work", idx=idx):
            pass
        tr.finish()
    w = SpoolWriter(reg, role="loader", spool_dir=spool, interval_s=999.0,
                    sampler=lambda: [tr.as_dict()] if tr else [])
    if mode == "dead":
        w.publish_once()
        print(json.dumps({"pid": os.getpid(), "host": w.host}), flush=True)
        time.sleep(600)  # parent kills us; our heartbeat goes stale
        sys.exit(0)
    print(json.dumps({"pid": os.getpid(), "host": w.host}), flush=True)
    sys.stdin.readline()  # parent's go signal: publish a FRESH heartbeat
    path = w.publish_once()
    assert path is not None
    sys.exit(0)
""")


def test_three_process_fleet_e2e(tmp_path):
    """``tests/test_obs_fleet.py::test_three_process_fleet_e2e`` with port
    processes, then ``pq_tool top`` over their spool."""
    from tpu_parquet_torch.obs import RequestTrace, StatsRegistry
    from tpu_parquet_torch.obs_fleet import (FleetAggregator, SpoolWriter,
                                             doctor_fleet)

    spool = str(tmp_path / "spool")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER_SRC)
    parent = RequestTrace(trace_id="req-e2e-fleet")
    with parent.span("orchestrate"):
        pass
    parent.finish()
    env = dict(os.environ, PYTHONPATH=REPO_ROOT,
               TPQ_TRACE_CONTEXT=json.dumps(parent.trace_context()))
    env.pop("TPQ_OBS_SPOOL", None)
    modes = ["live", "live", "slow", "dead"]
    procs, info = [], []
    try:
        for idx, mode in enumerate(modes):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), spool, str(idx), mode],
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for p in procs:
            line = p.stdout.readline()
            assert line.strip(), "worker died before publishing"
            info.append(json.loads(line))
        dead_pid, dead_host = info[3]["pid"], info[3]["host"]
        slow_pid, slow_host = info[2]["pid"], info[2]["host"]
        time.sleep(0.9)  # the dead worker's heartbeat ages past stale_s
        procs[3].kill()
        for p in procs[:3]:  # live workers republish fresh heartbeats
            p.stdin.write("go\n")
            p.stdin.flush()
            assert p.wait(timeout=60) == 0, p.stdout.read()
        preg = StatsRegistry()
        preg.add_serve({"submitted": 1, "done": 1})
        pw = SpoolWriter(preg, role="serve", spool_dir=spool,
                         interval_s=999.0,
                         sampler=lambda: [parent.as_dict()])
        assert pw.publish_once() is not None
    finally:
        for p in procs:
            p.kill()
            if p.stdin:
                p.stdin.close()
            if p.stdout:
                p.stdout.close()
            p.wait(timeout=30)

    snap = FleetAggregator(spool_dir=spool, stale_s=0.5).scan()
    assert snap["rejected"] == 0, snap
    assert len(snap["processes"]) == 5  # 4 workers + the parent
    merged = snap["registry"]
    assert merged["write"]["rows"] == 100 + 200 + 300 + 400
    assert merged["histograms"]["serve.request"]["count"] == 4
    rep = doctor_fleet(snap)
    strag = [b for b in rep["verdicts"] if b["verdict"] == "straggler"]
    assert [b["process"] for b in strag] == [f"{slow_host}:{slow_pid}"]

    rc, out = run_tool(["trace", "--request", "req-e2e-fleet",
                        "--spool", spool])
    assert rc == 0, out
    assert "orchestrate" in out and "child-work" in out
    child_pids = {int(ln.split(":")[1].split("]")[0])
                  for ln in out.splitlines() if ln.startswith("  child [")}
    assert len(child_pids) >= 2
    assert os.getpid() not in child_pids

    rc, out = run_tool(["top", "--once", "--stale", "0.5", spool])
    assert rc == 0, out
    assert "5 process(es), 1 stale" in out
    assert f"straggler: {slow_host}:{slow_pid} (loader)" in out
    assert "dominant lane write_encode" in out
    assert f"dead-process: {dead_host}:{dead_pid} (loader)" in out
    # top --count refreshes in place, one frame per poll
    rc, out = run_tool(["top", "--count", "2", "--interval", "0.05",
                        "--stale", "0.5", spool])
    assert rc == 0 and out.count("\x1b[2J\x1b[H") == 2
