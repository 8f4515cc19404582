"""The port's registry tree and device lane against the JAX package's
(mirroring ``tests/test_device_obs.py``).

Both packages read the same files: lineitem16 (dictionary, DELTA and PLAIN
chunks, strings), the K3 file (``fused_narrow_snappy``), a dictionary file
shipped compressed, a nested file and a pyarrow file, at prefetch 0 (and
4 on lineitem16 and the K3 file), and the K3 file forced onto each fused
route and its unfused twin.  Their ``obs_registry()`` trees
have the same keys (the port adds ``reader.prune_seconds``) and equal
values at every counter that is not a time (the arena bytes of files
whose level streams take the run-table expand excepted: there the port
stages the run tables in the arena, and its count is the larger): rows,
chunks, pages, ship
routes with logical and shipped bytes, link and staged bytes, the device
lane's dispatches, ``bytes_in``, ``bytes_staged`` and ``device_passes`` per
route, its dispatches per kernel family, its ``h2d`` transfers and bytes,
the ``io`` section (and ``io.engine`` on the host reader), and
``data_errors``.  Histograms are held to equal counts; seconds, rates,
ratios and the fetch engine's in-flight peak (a gauge of the threads'
timing) are never compared.

Then: a read with every option on (trace, sampler, watchdog, profile
directory, device lane) is bit-equal to the plain read; the lane off
(``TPQ_DEVICE_TIMING=0``) drops the section in both packages; and a scan
cancelled at prefetch 4, or aborted by the watchdog, frees its staged
tensors with the garbage collector off (the port's departure from the
reference: ``device_reader._drop_scan_frames``).
"""

import gc
import json
import os
import shutil
import threading
import weakref

import numpy as np
import pytest

import bench
from tpu_parquet import device_reader as RDR
from tpu_parquet import reader as RR
from tpu_parquet import iostore as RS
from tpu_parquet.iostore_async import \
    shutdown_default_engine as ref_shutdown_engine
from tpu_parquet.writer import corrupt_page as ref_corrupt_page
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import resilience as PRES
from tpu_parquet_torch.errors import CancelledError, HangError
from tpu_parquet_torch.format import CompressionCodec
from tpu_parquet_torch.iostore import (FaultInjectingStore, FaultSpec,
                                       IOConfig, LocalStore)
from tpu_parquet_torch.iostore_async import shutdown_default_engine
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.ship import ROUTES
from tests.test_torch_compressed import _dict_file, _write as write_k3
from tests.test_torch_host_prefetch import _make_flat, _make_nested
from tests.test_torch_ref_native import ensure_reference_native
from tests.test_torch_watchdog import _Port, _stall_factory, _write_file

ensure_reference_native()

S = CompressionCodec.SNAPPY
FILES = {
    "lineitem16": lambda p: bench.gen_lineitem16(p, 6_000, 2_000),
    # one group of 32,768 rows: the smallest that still ranks K3's route
    "k3_snappy": lambda p: write_k3(p, rows=32_768, group=32_768, codec=S),
    "dict_snappy": lambda p: _dict_file(p, S),
    "nested": lambda p: _make_nested(p, rows=2_000),
    "pyarrow": lambda p: _make_flat(p, rows=6_000, row_group_size=2_000),
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("device_obs")
    out = {}
    for name, make in FILES.items():
        out[name] = str(root / f"{name}.parquet")
        make(out[name])
    return out


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS",
                 "TPQ_TRACE", "TPQ_DEVICE_TIMING"):
        monkeypatch.delenv(name, raising=False)
    yield monkeypatch
    shutdown_default_engine()
    ref_shutdown_engine()


_TIME_WORDS = ("seconds", "per_sec", "efficiency", "_s", "mbps", "ratio",
               "p50", "p95", "wait_ms")


def _is_time(path: str) -> bool:
    """A time, a rate, or a gauge that follows the threads' timing (the
    fetch engine's in-flight peak)."""
    last = path.rsplit(".", 1)[-1]
    if "per_sec" in last or last == "inflight_peak":
        return True
    if path.startswith("reader.ship_feedback"):
        return "bytes" not in last and last != "streams"
    if path.startswith("histograms."):
        return ".buckets." in path or last not in ("count",)
    return any(w in last for w in _TIME_WORDS) and last != "planner_link_mbps"


def _flat(tree, pre=""):
    out = {}
    for k, v in (tree or {}).items():
        key = f"{pre}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = v
    return out


# the arena bytes: where a level stream takes the run-table expand, the
# port stages its run tables in the arena (the reference passes them as
# separate arrays), so on such files the port's are larger
_ARENA = ("reader.staged_bytes", "device.h2d.bytes",
          "alloc.device_peak_bytes")


def _same_counters(got: dict, want: dict, arena_exact: bool = True) -> dict:
    """Assert the trees' keys and non-time values equal; returns the port's
    flat tree."""
    g, w = _flat(got), _flat(want)
    bucket = lambda k: ".buckets." in k or k.startswith(  # noqa: E731
        "histograms.") and k.endswith(".exemplars")
    gk = {k for k in g if not bucket(k)}
    wk = {k for k in w if not bucket(k)}
    assert gk - wk == {"reader.prune_seconds"} & gk, sorted(gk - wk)
    assert wk <= gk, sorted(wk - gk)
    diff = {k: (g[k], w[k]) for k in wk
            if not _is_time(k) and g[k] != w[k]
            and (arena_exact or k not in _ARENA)}
    assert not diff, diff
    for k in _ARENA:
        assert (k in g) == (k in w)
        if k in g:
            assert g[k] >= w[k], k
    return g


def _read_tree(reader):
    for _ in reader.iter_row_groups():
        pass
    reader.finalize()
    tree = reader.obs_registry().as_dict()
    reader.close()
    return tree


# every file sequentially; the chunk pool on the files with the most
# chunks and routes
@pytest.mark.parametrize("name,prefetch", [
    (name, 0) for name in sorted(FILES)] + [("k3_snappy", 4),
                                             ("lineitem16", 4)])
def test_registry_counters_equal_the_reference(files, env, name, prefetch):
    path = files[name]
    got = _read_tree(DR.DeviceFileReader(path, device="cpu",
                                         prefetch=prefetch))
    want = _read_tree(RDR.DeviceFileReader(path, prefetch=prefetch))
    # the nullable files' def levels take the run-table expand
    g = _same_counters(got, want,
                       arena_exact=name not in ("nested", "pyarrow"))
    dev = got["device"]
    assert dev["dispatches"] > 0
    assert dev["h2d"]["transfers"] == got["pipeline"]["row_groups"]
    assert dev["h2d"]["bytes"] == got["reader"]["staged_bytes"]
    assert set(dev["routes"]) <= set(got["reader"]["ship_routes"]) | {
        "plain"}
    assert g["reader.ship_feedback.routes." + next(iter(
        got["reader"]["ship_routes"])) + ".streams"] > 0


# the fused routes and their unfused twins: one device pass per dispatch
# against a chain (the other routes run unforced on the files above)
@pytest.mark.parametrize("route", [r for r in ROUTES if r in (
    "plain", "narrow_snappy", "fused_plain", "fused_narrow_snappy")])
def test_forced_routes_device_lane_equals_the_reference(files, env, route):
    env.setenv("TPQ_FORCE_ROUTE", route)
    path = files["k3_snappy"]
    got = _read_tree(DR.DeviceFileReader(path, device="cpu"))
    want = _read_tree(RDR.DeviceFileReader(path))
    _same_counters(got, want)
    for r, c in got["device"]["routes"].items():
        if r in ("fused_plain", "fused_narrow_snappy"):
            assert c["device_passes"] == c["dispatches"]  # one pass each
        else:
            assert c["device_passes"] >= 2 * c["dispatches"]


@pytest.mark.parametrize("engine", ["0", "1"])
def test_io_sections_equal_the_reference(files, env, engine):
    env.setenv("TPQ_IO_ASYNC", engine)
    path = files["lineitem16"]

    def port_store(f):
        return FaultInjectingStore(LocalStore(f), FaultSpec(fail_first=1),
                                   config=IOConfig(backoff_ms=1.0,
                                                   retry_budget=0))

    def ref_store(f):
        return RS.FaultInjectingStore(RS.LocalStore(f),
                                      RS.FaultSpec(fail_first=1),
                                      config=RS.IOConfig(backoff_ms=1.0,
                                                         retry_budget=0))

    got = _read_tree(DR.DeviceFileReader(path, device="cpu", prefetch=4,
                                         store=port_store))
    want = _read_tree(RDR.DeviceFileReader(path, prefetch=4,
                                           store=ref_store))
    _same_counters(got, want)
    assert got["io"]["retries"] > 0
    trees = []
    for make, stop in ((lambda: FileReader(path, prefetch=4,
                                           store=port_store),
                        shutdown_default_engine),
                       (lambda: RR.FileReader(path, prefetch=4,
                                              store=ref_store),
                        ref_shutdown_engine)):
        stop()
        r = make()
        for _ in r.iter_row_groups():
            pass
        trees.append(r.obs_registry().as_dict())
        r.close()
    _same_counters(*trees)
    assert ("engine" in trees[0]["io"]) == (engine == "1")


def test_data_errors_section_equals_the_reference(files, env, tmp_path):
    bad = str(tmp_path / "bad.parquet")
    shutil.copyfile(_write_file(str(tmp_path / "clean.parquet"), groups=4),
                    bad)
    ref_corrupt_page(bad, row_group=2, column=0, page=0, mode="truncate",
                     seed=2)
    got = _read_tree(DR.DeviceFileReader(bad, device="cpu", prefetch=4,
                                         on_data_error="skip_unit"))
    want = _read_tree(RDR.DeviceFileReader(bad, prefetch=4,
                                           on_data_error="skip_unit"))
    _same_counters(got, want)
    assert got["data_errors"]["units_skipped"] == 1


def _host_bytes(groups):
    return [{n: np.asarray(c.to_host()).tobytes() if not hasattr(
        c.to_host(), "heap") else bytes(c.to_host().heap) for n, c in
        g.items()} for g in groups]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_every_option_on_leaves_the_read_unchanged(files, env, tmp_path,
                                                   prefetch):
    path = files["lineitem16"]
    plain = list(DR.DeviceFileReader(path, device="cpu",
                                     prefetch=prefetch).iter_row_groups())
    r = DR.DeviceFileReader(path, device="cpu", prefetch=prefetch,
                            trace=str(tmp_path / "t.json"), sample_ms=5,
                            hang_s=30, profile_dir=str(tmp_path / "prof"))
    traced = list(r.iter_row_groups())
    r.finalize()
    assert _host_bytes(traced) == _host_bytes(plain)
    assert r.profile_path and os.path.exists(r.profile_path)
    with open(r.profile_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"stage", "dispatch", "finalize"} <= names
    r.close()
    with open(tmp_path / "t.json") as f:
        doc = json.load(f)
    assert doc["otherData"]["registry"]["device"]["dispatches"] > 0
    assert any(e["name"].startswith("device.") for e in doc["traceEvents"])
    assert not [t for t in threading.enumerate() if t.name.startswith(
        ("tpq-sampler", "tpq-watchdog", "tpq-devtimer"))]


def test_device_timing_off_drops_the_section(files, env):
    env.setenv("TPQ_DEVICE_TIMING", "0")
    path = files["k3_snappy"]
    r = DR.DeviceFileReader(path, device="cpu")
    got = _read_tree(r)
    want = _read_tree(RDR.DeviceFileReader(path))
    assert got["device"] is None and want["device"] is None
    assert r._device_timer.enabled is False
    env.setenv("TPQ_DEVICE_TIMING", "abc")  # malformed: one warning, on
    assert _read_tree(DR.DeviceFileReader(path, device="cpu"))["device"]


def test_cuda_kernel_view_of_the_lane_on_the_cpu(files, env):
    """On a CPU reader no CUDA kernel launches: every timed plan is the
    tensor-code family, and the view counts the lane's dispatches."""
    r = DR.DeviceFileReader(files["lineitem16"], device="cpu")
    tree = _read_tree(r)
    view = r.device_stats().cuda_kernels()
    assert set(view) == {"tensor_code"}
    assert view["tensor_code"]["plans"] == tree["device"]["dispatches"]
    assert view["tensor_code"]["launches"] == 0


def _staged_refs(monkeypatch):
    refs = []
    stage = DR._RowGroupStager.stage

    def spy(self, *a, **kw):
        buf = stage(self, *a, **kw)
        refs.append(weakref.ref(buf))
        return buf

    monkeypatch.setattr(DR._RowGroupStager, "stage", spy)
    return refs


def test_cancelled_scan_frees_its_staged_tensors_without_a_collection(
        files, env):
    refs = _staged_refs(env)
    gc.collect()
    gc.disable()
    try:
        tok = PRES.CancelToken()  # this frame holds the token
        r = DR.DeviceFileReader(files["lineitem16"], device="cpu",
                                prefetch=4, cancel=tok)
        it = r.iter_row_groups()
        next(it)  # group 0 yielded and dropped; group 1 staged behind it
        tok.cancel()
        with pytest.raises(CancelledError) as ei:
            next(it)
        assert tok._exc is ei.value  # the latched verdict, tracebacks on
        assert len(refs) >= 2
        dead = [w() is None for w in refs]
        assert all(dead), dead
    finally:
        gc.enable()
    r.close()


def test_hung_scan_frees_its_staged_tensors_without_a_collection(
        tmp_path, env):
    env.setenv("TPQ_FLIGHT", str(tmp_path / "dump.json"))
    path = _write_file(str(tmp_path / "hang.parquet"), groups=4)
    refs = _staged_refs(env)
    stores = []
    gc.collect()
    gc.disable()
    try:
        r = DR.DeviceFileReader(path, device="cpu", prefetch=4, hang_s=0.3,
                                hang_policy="raise",
                                store=_stall_factory(_Port, stores))
        with pytest.raises(HangError) as ei:
            for _ in r.iter_row_groups():
                pass
        assert r._watchdog.error is ei.value  # held by the reader
        dead = [w() is None for w in refs]
        assert all(dead), dead
    finally:
        gc.enable()
        for st in stores:
            st.release()
    r.close()
