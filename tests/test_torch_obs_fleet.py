"""The port's fleet observability (``tpu_parquet_torch.obs_fleet``) against
the JAX package's (``tpu_parquet.obs_fleet``) on the same documents.

One spool directory holds members written by both packages'
``SpoolWriter``s (simulated processes: ``host``/``pid`` overrides, driven by
``publish_once``).  Each package's ``FleetAggregator`` folds it into the
same snapshot (the same registry sums and maxima, processes, traces and
counts), and the readers of a snapshot agree on it: ``doctor_fleet`` (a
straggler among at least three live processes, a dead member, a fleet
SLO burn), ``render_fleet_openmetrics``, ``process_lanes`` and
``stitch_traces``.  The port's ``ambient_request_trace`` adopts a context
the reference exported, and a port ``DataLoader`` with ``TPQ_OBS_SPOOL``
set publishes a loader member that the reference's aggregator reads.
Exact everywhere.
"""

import json
import threading
import time

import numpy as np
import pytest

from tpu_parquet import obs as RO
from tpu_parquet import obs_fleet as RF
from tpu_parquet_torch import obs as PO
from tpu_parquet_torch import obs_fleet as PF

PKGS = {"port": (PO, PF), "reference": (RO, RF)}


def _member(pkg, spool, host, pid, role="writer", fill=None, traces=()):
    obs, fleet = PKGS[pkg]
    reg = obs.StatsRegistry()
    if fill is not None:
        fill(reg)
    w = fleet.SpoolWriter(reg, role=role, spool_dir=str(spool),
                          interval_s=999.0, keep=2, host=host, pid=pid,
                          sampler=lambda: list(traces))
    assert w.publish_once() is not None
    return w


def _write_lanes(encode, rows=10):
    def fill(reg):
        reg.add_write({"rows": rows, "workers": 2, "encode_seconds": encode,
                       "flush_seconds": encode / 4})
    return fill


def _pipeline_lanes(seconds):
    def fill(reg):
        reg.histogram("serve.request").record(seconds / 10,
                                              exemplar=f"t-{seconds}")
        reg.add_write({"rows": 3, "compress_seconds": seconds})
    return fill


def _mixed_spool(tmp_path, slow=10.0, dead=True):
    """Five members, alternating packages: four live writers (one slow),
    one loader whose heartbeat is an hour old."""
    spool = tmp_path / "spool"
    for i, (pkg, host, pid) in enumerate([
            ("port", "h0", 1), ("reference", "h0", 2), ("port", "h1", 3),
            ("reference", "h1", 4)]):
        _member(pkg, spool, host, pid, fill=_write_lanes(
            slow if pid == 3 else 1.0 + 0.05 * i))
    # one process arming two entry points: folds into one process entry
    _member("reference", spool, "h1", 4, role="loader",
            fill=_pipeline_lanes(0.5))
    if dead:
        doc = {"spool_version": 1, "host": "gone", "pid": 9,
               "role": "loader", "seq": 3,
               "heartbeat_ts": time.time() - 3600,
               "registry": PO.StatsRegistry().as_dict(), "traces": []}
        (spool / "gone-9-loader.00000003.json").write_text(json.dumps(doc))
    (spool / "torn-1-x.00000001.json").write_text('{"spool_version": 1, ')
    return spool


def _scan(fleet, spool, now):
    return fleet.FleetAggregator(spool_dir=str(spool), stale_s=30.0).scan(
        now=now)


def test_spool_documents_are_the_references(tmp_path):
    for pkg in PKGS:
        w = _member(pkg, tmp_path / pkg, "nodeA", 101,
                    fill=_write_lanes(2.0))
        (name,) = sorted(p.name for p in (tmp_path / pkg).iterdir())
        assert name == "nodeA-101-writer.00000001.json"
        doc = json.loads((tmp_path / pkg / name).read_text())
        assert doc["spool_version"] == 1 and w.written == 1
    a = json.loads(next((tmp_path / "port").iterdir()).read_text())
    b = json.loads(next((tmp_path / "reference").iterdir()).read_text())
    a.pop("heartbeat_ts"), b.pop("heartbeat_ts")
    assert a == b
    assert PF.SPOOL_VERSION == RF.SPOOL_VERSION
    assert PF.FLEET_VERSION == RF.FLEET_VERSION


@pytest.mark.parametrize("aggregator", ["port", "reference"])
def test_mixed_spool_aggregates_as_one_fleet(tmp_path, aggregator):
    spool = _mixed_spool(tmp_path)
    now = time.time()
    snap = _scan(PKGS[aggregator][1], spool, now)
    other = _scan(PKGS["reference" if aggregator == "port" else "port"][1],
                  spool, now)
    assert snap == other
    assert sorted(snap["processes"]) == ["gone:9", "h0:1", "h0:2", "h1:3",
                                         "h1:4"]
    assert snap["processes"]["h1:4"]["role"] == "loader+writer"
    assert snap["processes"]["gone:9"]["stale"]
    assert snap["rejected"] == 1 and snap["files_scanned"] == 7
    # counters sum over both packages' members, gauges take the max
    assert snap["registry"]["write"]["rows"] == 4 * 10 + 3
    assert snap["registry"]["write"]["workers"] == 2


def test_doctor_fleet_equal_straggler_and_dead(tmp_path):
    spool = _mixed_spool(tmp_path)
    snap = _scan(PF, spool, time.time())
    rep = PF.doctor_fleet(snap)
    assert rep == RF.doctor_fleet(snap)
    kinds = {b["verdict"]: b for b in rep["verdicts"]}
    assert kinds["straggler"]["process"] == "h1:3"
    assert kinds["straggler"]["dominant_lane"] == "write_encode"
    assert kinds["dead-process"]["process"] == "gone:9"
    for key, p in snap["processes"].items():
        assert PF.process_lanes(p["registry"]) == RF.process_lanes(
            p["registry"]), key


def test_doctor_fleet_quiet_fleet_equal(tmp_path):
    spool = _mixed_spool(tmp_path, slow=1.1, dead=False)
    snap = _scan(RF, spool, time.time())
    rep = PF.doctor_fleet(snap)
    assert rep == RF.doctor_fleet(snap)
    assert not [b for b in (rep or {}).get("verdicts", [])
                if b["verdict"] in ("straggler", "dead-process")]
    assert PF.doctor_fleet("not a snapshot") is None


def test_fleet_slo_burn_equal(tmp_path):
    spool = tmp_path / "spool"

    def burn(reg):
        reg.add_serve({"tenants": {"gold": {"weight": 2, "slo_p99_ms": 1.0}},
                       "submitted": 5, "done": 5})
        reg.histogram("serve.tenant.gold").record(0.05,
                                                  exemplar="t-gold-slow")
    _member("port", spool, "h0", 1, role="serve", fill=burn)
    _member("reference", spool, "h1", 2, fill=_write_lanes(1.0))
    snap = _scan(PF, spool, time.time())
    rep = PF.doctor_fleet(snap)
    assert rep == RF.doctor_fleet(snap)
    (b,) = [b for b in rep["verdicts"] if b["verdict"] == "slo-burn"]
    assert b["exemplar_process"] == "h0:1"


def test_render_fleet_openmetrics_equal(tmp_path):
    spool = _mixed_spool(tmp_path)
    snap = _scan(PF, spool, time.time())
    text = PF.render_fleet_openmetrics(snap)
    assert text == RF.render_fleet_openmetrics(snap)
    assert text.endswith("# EOF\n")
    assert 'host="h1",pid="3",role="writer"' in text
    assert 'trace_id="t-0.5"' in text
    with pytest.raises(ValueError):
        PF.render_fleet_openmetrics([])


def test_stitch_traces_equal():
    rng = np.random.default_rng(5)
    docs = [{"trace_id": "R", "spans": []}]
    for i in rng.permutation(8):
        docs.append({"trace_id": f"c{i % 5}", "host": f"h{i % 3}",
                     "pid": int(i), "origin": {"trace_id": "R"},
                     "spans": []})
    docs.append({"trace_id": "other", "origin": {"trace_id": "X"}})
    for tid in ("R", "X", "nope"):
        assert PF.stitch_traces(docs, tid) == RF.stitch_traces(docs, tid)
    assert PF.stitch_traces(docs[1:], "R") == RF.stitch_traces(docs[1:], "R")


def test_ambient_request_trace_adopts_the_references_context(monkeypatch):
    parent = RO.RequestTrace(trace_id="req-parent")
    monkeypatch.setenv("TPQ_TRACE_CONTEXT", json.dumps(parent.trace_context()))
    out = {}

    def child():  # a fresh thread: no current trace of its own
        tr = PF.ambient_request_trace()
        out["origin"] = tr.origin
        out["same"] = PO.current_request_trace() is tr
        tr.finish()
        out["doc"] = tr.as_dict()

    t = threading.Thread(target=child)
    t.start()
    t.join()
    assert out["origin"]["trace_id"] == "req-parent" and out["same"]
    st = RF.stitch_traces([parent.as_dict(), out["doc"]], "req-parent")
    assert [c["trace_id"] for c in st["children"]] == [out["doc"]["trace_id"]]
    monkeypatch.setenv("TPQ_TRACE_CONTEXT", "{not json")
    t = threading.Thread(
        target=lambda: out.update(bad=PF.ambient_request_trace()))
    t.start()
    t.join()
    assert out["bad"] is None


def test_resolve_spool_dir_and_disabled_writer(monkeypatch):
    monkeypatch.delenv("TPQ_OBS_SPOOL", raising=False)
    assert PF.resolve_spool_dir() is None is RF.resolve_spool_dir()
    w = PF.SpoolWriter(PO.StatsRegistry(), role="loader")
    assert not w.enabled and w.start() is w and w.publish_once() is None
    monkeypatch.setenv("TPQ_OBS_SPOOL", "/x/y")
    assert PF.resolve_spool_dir() == RF.resolve_spool_dir() == "/x/y"
    assert PF.resolve_spool_dir("") is None


def test_port_loader_publishes_a_member_the_reference_reads(tmp_path,
                                                            monkeypatch):
    from tpu_parquet_torch.data import DataLoader
    from tpu_parquet_torch.format import FieldRepetitionType as FRT, Type
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    path = str(tmp_path / "a.parquet")
    schema = build_schema([data_column("a", Type.INT64, FRT.REQUIRED)])
    with FileWriter(path, schema) as w:
        for n in (300, 200):
            w.write_columns({"a": np.arange(n, dtype=np.int64)})
            w.flush_row_group()
    spool = tmp_path / "spool"
    monkeypatch.setenv("TPQ_OBS_SPOOL", str(spool))
    loader = DataLoader([path], 128, seed=2)
    assert sum(int(b["mask"].sum()) for b in loader) == 500
    assert not [t.name for t in threading.enumerate()
                if t.name.startswith("tpq-spool")]
    now = time.time()
    snap = _scan(RF, spool, now)
    assert snap == _scan(PF, spool, now)
    (proc,) = snap["processes"].values()
    assert proc["role"] == "loader"
    assert snap["registry"]["loader"]["rows"] == 500
