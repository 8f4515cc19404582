"""The port's ``scanplan`` IR against the JAX package's.

- ``build_scan_plan`` gives the same plan in both packages: ``serialize()``
  is byte-equal, and each package deserializes the other's blob (the one
  exception: the reference's deserializer rejects the ``fused`` kernel
  family its own readers record for ``fused_plain`` and
  ``fused_narrow_snappy`` chunks; the port takes it).
- The port rejects every lying blob of the reference's
  ``tpu_parquet.fuzz.crafted_scan_plan_blobs()`` with ``ParquetError`` and
  the reference's text.
- ``predicate_fingerprint`` equals the reference's.
- A plan built for another projection or filter is not adopted.
- After one read of a file, ``routes_table()`` equals the reference's,
  kernel families included, and a ``plan=`` replay (after a serialize /
  deserialize round trip) is bit-equal with equal routes and pruning and
  walks no page header, unforced and under each ``TPQ_FORCE_ROUTE`` name.
"""

import threading

import pytest
import torch

from tests.test_torch_pruning import FILES, WINDOW, _host, _same_outs
from tpu_parquet import device_reader as RDR
from tpu_parquet import predicate as RP
from tpu_parquet import scanplan as RSP
from tpu_parquet.errors import ParquetError as RefParquetError
from tpu_parquet.fuzz import crafted_scan_plan_blobs
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import predicate as P
from tpu_parquet_torch import scanplan as SP
from tpu_parquet_torch.errors import ParquetError
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.ship import ROUTES
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

NAMES = ("plain", "dict", "strings_plain", "optional")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_thread_outlives_a_test():
    before = set(threading.enumerate())
    yield
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


@pytest.fixture
def reference_env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_scanplan")
    out = {}
    for name in NAMES:
        path = str(root / f"{name}.parquet")
        FILES[name](path)
        out[name] = path
    return out


def _window(M):
    return M.col("k").between(*WINDOW)


@pytest.mark.parametrize("columns", [None, ["k"], ["w", "k"]])
@pytest.mark.parametrize("filtered", [False, True])
def test_build_scan_plan_serializes_byte_equal(files, columns, filtered):
    path = files["plain"]
    key = ("file", path, 1234, 5678)
    with RefReader(path, columns=columns) as ref, \
            FileReader(path, columns=columns) as r:
        want = RSP.build_scan_plan(
            ref.metadata, ref.schema, file_key=key,
            row_filter=_window(RP) if filtered else None)
        got = SP.build_scan_plan(
            r.metadata, r.schema, file_key=key,
            row_filter=_window(P) if filtered else None)
    blob = got.serialize()
    assert blob == want.serialize()
    assert got.cache_key() == want.cache_key()
    assert got.estimated_bytes() == want.estimated_bytes()
    assert got.selected_ordinals() == want.selected_ordinals()
    # each package takes the other's blob
    assert RSP.ScanPlan.deserialize(blob).serialize() == blob
    assert SP.ScanPlan.deserialize(want.serialize()).serialize() == blob


def test_crafted_blobs_are_rejected_with_the_reference_text():
    blobs = crafted_scan_plan_blobs()
    good = SP.ScanPlan.deserialize(blobs[0])
    assert good.serialize() == blobs[0]
    assert good.routes_table() == RSP.ScanPlan.deserialize(
        blobs[0]).routes_table()
    for blob in blobs[1:]:
        with pytest.raises(RefParquetError) as want:
            RSP.ScanPlan.deserialize(blob)
        with pytest.raises(ParquetError) as got:
            SP.ScanPlan.deserialize(blob)
        assert str(got.value) == str(want.value)
    for bad in (None, "TPQP", 17):
        with pytest.raises(ParquetError, match="not bytes"):
            SP.ScanPlan.deserialize(bad)


def test_the_fused_family_is_taken_by_the_port_only():
    """The reference records ``fused`` for K2/K3 chunks but its
    deserializer's family list lacks it: the port's list has it."""
    plan = SP.ScanPlan(columns=("a",), row_groups=[])
    plan.note_route(0, "a", "fused_plain", "fused")
    blob = plan.serialize()
    assert SP.ScanPlan.deserialize(blob).routes_table() == {
        (0, "a"): ("fused_plain", "fused")}
    with pytest.raises(RefParquetError, match="unknown kernel family"):
        RSP.ScanPlan.deserialize(blob)
    with pytest.raises(ParquetError, match="unknown kernel family"):
        SP.ScanPlan.deserialize(blob.replace(b'"fused"]', b'"fusion"]'))


@pytest.mark.parametrize("spec", [
    lambda M: M.col("a") > 5,
    lambda M: (M.col("a") > 5) & (M.col("s") == "x"),
    lambda M: ~(M.col("a").between(1, 2) | M.col("b").is_null()),
    lambda M: M.col("x.y") != 2.5,
    lambda M: M.parse_filter("a >= -1 and not b == None"),
])
def test_predicate_fingerprint_matches(spec):
    assert (SP.predicate_fingerprint(spec(P))
            == RSP.predicate_fingerprint(spec(RP)))
    assert SP.predicate_fingerprint(None) is None


def test_mismatched_plan_falls_back_to_a_fresh_build(files):
    path = files["plain"]
    with FileReader(path, columns=["k"]) as r:
        narrow = r._plan
    with FileReader(path, columns=["k", "v"], plan=narrow) as r2:
        assert r2._plan is not narrow
        assert set(r2.read_all()) == {"k", "v"}
    with FileReader(path, row_filter=_window(P)) as r:
        filtered = r._plan
    other = P.col("k") < 10
    with FileReader(path, row_filter=other, plan=filtered) as r3:
        assert r3._plan is not filtered
        assert r3.num_selected_rows < r3.num_rows
    with FileReader(path, row_filter=_window(P), plan=filtered) as r4:
        assert r4._plan is filtered


def _dev_read(reader):
    with reader as r:
        outs = [{k: _host(v) for k, v in g.items()}
                for g in r.iter_row_groups()]
        st = r.stats().as_dict()
        return outs, st, r._plan


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", NAMES)
def test_route_memo_and_replay_match_the_reference(files, reference_env,
                                                   monkeypatch, name, route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    path = files[name]
    ref_outs, ref_st, ref_plan = _dev_read(
        RDR.DeviceFileReader(path, row_filter=_window(RP)))
    outs, st, plan = _dev_read(DR.DeviceFileReader(
        path, row_filter=_window(P), device="cpu"))
    _same_outs(outs, ref_outs)
    assert plan.routes_table() == ref_plan.routes_table()
    assert plan.routes_table()  # the read memoized its routes
    blob = plan.serialize()
    assert blob == ref_plan.serialize()
    walks = []
    real = DR.plan_page_pruning
    monkeypatch.setattr(DR, "plan_page_pruning",
                        lambda *a, **kw: walks.append(1) or real(*a, **kw))
    for k in (0, 4):
        replay = SP.ScanPlan.deserialize(blob)
        with DR.DeviceFileReader(path, row_filter=_window(P), plan=replay,
                                 device="cpu", prefetch=k) as r:
            assert r._plan is replay
            again = [{n: _host(c) for n, c in g.items()}
                     for g in r.iter_row_groups()]
            st2 = r.stats().as_dict()
        _same_outs(again, outs)
        assert replay.routes_table() == plan.routes_table()
        for key in ("pages_pruned", "rows", "pages", "ship_routes",
                    "staged_bytes", "link_bytes_shipped"):
            assert st2[key] == st[key], (k, key)
    assert walks == []  # the replays adopted the pruning memo


@pytest.mark.parametrize("route", ["plain", "fused_plain", "recompress"])
def test_a_forced_route_wins_over_the_memo(files, reference_env, route):
    """A plan memoized unforced, replayed under ``TPQ_FORCE_ROUTE``: the
    forced route decides, as in a fresh forced read (and the reference's
    replay)."""
    path = files["plain"]
    _, _, plan = _dev_read(DR.DeviceFileReader(path, device="cpu"))
    _, _, ref_plan = _dev_read(RDR.DeviceFileReader(path))
    reference_env.setenv("TPQ_FORCE_ROUTE", route)
    fresh = _dev_read(DR.DeviceFileReader(path, device="cpu"))
    replay = _dev_read(DR.DeviceFileReader(
        path, device="cpu", plan=SP.ScanPlan.deserialize(plan.serialize())))
    ref_replay = _dev_read(RDR.DeviceFileReader(path, plan=ref_plan))
    _same_outs(replay[0], fresh[0])

    def routes(st):
        return {r: (v["streams"], v["logical"], v["shipped"])
                for r, v in st["ship_routes"].items()}

    assert routes(replay[1]) == routes(fresh[1]) == routes(ref_replay[1])
    assert set(routes(replay[1])) <= {route, "plain"}
    assert replay[2].routes_table() == ref_replay[2].routes_table()
