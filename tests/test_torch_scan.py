"""The port's device-reader pipeline and ``scan_files`` against the JAX
package's.

``tpu_parquet_torch.device_reader.DeviceFileReader(path, device="cpu",
prefetch=K).iter_row_groups()`` and ``scan_files(..., prefetch=K)`` run
beside ``tpu_parquet.device_reader``'s under ``TPQ_PALLAS=1 TPQ_FUSE=1``
(its Pallas kernels in interpret mode; the port runs its kernels' plain
versions).  The port's one-deep stage/dispatch pipeline runs on every path
(a one-thread staging worker), and at K > 0 the chunk feed collects and
ship-plans chunks on a pool.  The files, made from numpy seeds: the
reference's K3 columns in SNAPPY and GZIP (``tests/test_torch_compressed``,
REQUIRED, no dictionary), a pyarrow file with nulls, strings and
dictionaries, and a nested pyarrow file (a list of structs and a map).
Each is read unforced and under each of the seven ``TPQ_FORCE_ROUTE``
names, and must agree exactly at every depth on ``to_host()``,
``levels_to_host()``, the column class, ``ship_routes``, the link-byte
counters and ``PipelineStats.chunks`` / ``row_groups``; ``staged_bytes`` is
equal across depths, and equal to the reference's on the REQUIRED files
(the port stages the run tables of a level stream's run-table expand in
the arena, where the reference passes them on their own).

Also: ``with_path``, a dataset directory with a manifest written by the
reference's ``write_manifest``, finished files closed at the boundary, an
early ``break`` closing every reader, the corrupt dictionary index of
``tests/test_torch_host_decode.py`` (eager with the native run walk;
deferred past the last yield without it), ``max_memory`` raising the
reference's budget error on a decompression bomb, and
``_RowGroupStager``'s strip streaming at a small ``STRIP``.
"""

import gc
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from tests.test_torch_compressed import _write as write_k3
from tests.test_torch_host_decode import _corrupt_index_page, _tpq_dict_file
from tests.test_torch_host_prefetch import _make_flat, _make_nested
from tpu_parquet import device_reader as RDR
from tpu_parquet import native as ref_native
from tpu_parquet.write.manifest import write_manifest
from tpu_parquet_torch import cuda_kernels as CK
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import native
from tpu_parquet_torch.alloc import MemoryBudgetExceeded
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.errors import ParquetError
from tpu_parquet_torch.format import CompressionCodec
from tpu_parquet_torch.ship import ROUTES
from tpu_parquet_torch.torch_decode import _SLACK
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process)."""
    yield


DEPTHS = [0, 1, 4]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run this module's tensor code on one thread: the suite runs several
    test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_thread_outlives_a_test():
    """No ``tpq-`` thread (the pools and the staging worker) that a test
    started is alive after it."""
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


S, G = CompressionCodec.SNAPPY, CompressionCodec.GZIP
FILES = {
    "k3_snappy": lambda p: write_k3(p, rows=40_000, group=20_000, codec=S),
    "k3_gzip": lambda p: write_k3(p, rows=40_000, group=20_000, codec=G),
    "pyarrow_dict": lambda p: _make_flat(p, rows=12_000,
                                         row_group_size=4_000),
    "nested": _make_nested,
}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_scan")
    out = {}
    for name, make in FILES.items():
        path = str(root / f"{name}.parquet")
        make(path)
        out[name] = path
    return out


def _host(col):
    """(class name, values, (def, rep)) of a device column on the host."""
    v = col.to_host()
    if isinstance(v, ByteArrayData) or hasattr(v, "heap"):
        v = (np.asarray(v.offsets), np.asarray(v.heap))
    else:
        v = (np.asarray(v),)
    return type(col).__name__, v, col.levels_to_host()


def _same(got, want, where):
    (gcls, gv, (gd, gr)), (wcls, wv, (wd, wr)) = got, want
    assert gcls == wcls, where
    assert len(gv) == len(wv), where
    for g, w in zip(gv, wv):
        assert g.dtype == w.dtype and g.shape == w.shape, where
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), where
    for g, w in ((gd, wd), (gr, wr)):
        assert (g is None) == (w is None), where
        if w is not None:
            assert np.array_equal(np.asarray(g), np.asarray(w)), where


def _read(reader):
    with reader as r:
        outs = [{k: _host(v) for k, v in g.items()}
                for g in r.iter_row_groups()]
        return outs, r.stats().as_dict(), r.pipeline_stats().as_dict()


def _counters(stats):
    routes = {r: (v["streams"], v["logical"], v["shipped"])
              for r, v in stats["ship_routes"].items()}
    return routes, {k: stats[k] for k in (
        "link_bytes_logical", "link_bytes_shipped", "fused_fallbacks",
        "pages_device_expanded", "row_groups", "chunks", "pages", "rows",
        "compressed_bytes")}


def _same_outs(got, want):
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert list(g) == list(w)
        for name in w:
            _same(g[name], w[name], (i, name))


@pytest.mark.parametrize("route", ["unforced", *ROUTES])
@pytest.mark.parametrize("name", list(FILES))
def test_iter_row_groups_matches_the_reference_at_every_depth(
        files, reference_env, name, route):
    if route != "unforced":
        reference_env.setenv("TPQ_FORCE_ROUTE", route)
    path = files[name]
    want, ref_st, ref_pipe = _read(RDR.DeviceFileReader(path, prefetch=4))
    staged = set()
    for k in DEPTHS:
        CK.reset_launches()
        got, st, pipe = _read(DR.DeviceFileReader(path, device="cpu",
                                                  prefetch=k))
        assert set(CK.launches.values()) == {0}  # CPU tensors launch nothing
        _same_outs(got, want)
        assert _counters(st) == _counters(ref_st), k
        staged.add(st["staged_bytes"])
        assert pipe["row_groups"] == ref_pipe["row_groups"] == len(want)
        # the chunk pool counts what it collected; the sequential host
        # phase counts nothing, as the reference's
        assert pipe["chunks"] == (ref_pipe["chunks"] if k else 0)
        assert pipe["prefetch"] == k
        assert set(ref_pipe) == set(pipe)
    assert len(staged) == 1


def test_staged_bytes_equal_the_reference_on_required_columns(
        files, reference_env):
    for name in ("k3_snappy", "k3_gzip"):
        _, ref_st, _ = _read(RDR.DeviceFileReader(files[name]))
        _, st, _ = _read(DR.DeviceFileReader(files[name], device="cpu",
                                             prefetch=2))
        assert st["staged_bytes"] == ref_st["staged_bytes"], name


@pytest.mark.parametrize("k", DEPTHS)
def test_read_row_group_through_a_one_item_feed(files, reference_env, k):
    path = files["pyarrow_dict"]
    with RDR.DeviceFileReader(path) as ref, \
            DR.DeviceFileReader(path, device="cpu", prefetch=k) as r:
        for i in (2, 0):
            want = {n: _host(c) for n, c in ref.read_row_group(i).items()}
            got = {n: _host(c) for n, c in r.read_row_group(i).items()}
            _same_outs([got], [want])
        assert r.pipeline_stats().chunks == (8 if k else 0)


@pytest.mark.parametrize("k", DEPTHS)
def test_scan_files_matches_the_reference(files, reference_env, k):
    paths = [files["k3_gzip"], files["pyarrow_dict"], files["k3_snappy"]]
    want = [(p, {n: _host(c) for n, c in g.items()})
            for p, g in RDR.scan_files(paths, prefetch=k, with_path=True)]
    got = [(p, {n: _host(c) for n, c in g.items()})
           for p, g in DR.scan_files(paths, prefetch=k, with_path=True,
                                     device="cpu")]
    assert [p for p, _ in got] == [p for p, _ in want] == (
        [paths[0]] * 2 + [paths[1]] * 3 + [paths[2]] * 2)
    _same_outs([g for _, g in got], [w for _, w in want])
    plain = list(DR.scan_files(paths, prefetch=k, device="cpu"))
    _same_outs([{n: _host(c) for n, c in g.items()} for g in plain],
               [w for _, w in want])


def test_scan_files_reads_a_manifest_dataset(files, reference_env, tmp_path):
    root = tmp_path / "dataset"
    root.mkdir()
    members = []
    for i, name in enumerate(("k3_snappy", "pyarrow_dict")):
        dst = root / f"part-{i:05d}.parquet"
        shutil.copy(files[name], dst)
        members.append(str(dst))
    write_manifest(str(root), members)
    want = [{n: _host(c) for n, c in g.items()}
            for g in RDR.scan_files(str(root))]
    for k in (0, 3):
        for source in (str(root), str(root / "tpq_manifest.json")):
            got = [(p, {n: _host(c) for n, c in g.items()})
                   for p, g in DR.scan_files(source, prefetch=k,
                                             with_path=True, device="cpu")]
            assert [os.path.basename(p) for p, _ in got] == (
                ["part-00000.parquet"] * 2 + ["part-00001.parquet"] * 3)
            _same_outs([g for _, g in got], want)


def _spy_readers(monkeypatch):
    """Every DeviceFileReader the scan opens, in order."""
    made = []
    real = DR.DeviceFileReader.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(DR.DeviceFileReader, "__init__", init)
    return made


@pytest.mark.parametrize("k", [0, 2])
def test_finished_files_close_at_the_boundary(files, monkeypatch, k):
    made = _spy_readers(monkeypatch)
    paths = [files["k3_gzip"], files["pyarrow_dict"], files["k3_snappy"]]
    seen = []
    for p, _g in DR.scan_files(paths, prefetch=k, with_path=True,
                               device="cpu"):
        j = paths.index(p)
        if j and (not seen or seen[-1] != j):
            # the first group of file j: every earlier file is closed
            assert all(r._f.closed for r in made[:j])
        seen.append(j)
    assert all(r._f.closed for r in made) and len(made) == 3


@pytest.mark.parametrize("k", [0, 3])
def test_early_break_closes_every_reader(files, monkeypatch, k):
    made = _spy_readers(monkeypatch)
    paths = [files["k3_gzip"], files["pyarrow_dict"], files["k3_snappy"]]
    gen = DR.scan_files(paths, prefetch=k, device="cpu")
    for i, _g in enumerate(gen):
        if i == 2:
            break
    gen.close()
    assert made and all(r._f.closed for r in made)


def _reference_error(run) -> str:
    """The text of the reference's raise, its traceback dropped (it holds
    the reference's suspended pipeline, whose pool would outlive the
    test)."""
    try:
        run()
    except Exception as e:  # noqa: BLE001 — any raise is the finding
        text = str(e)
    else:
        raise AssertionError("the reference did not raise")
    gc.collect()
    return text


def _corrupt_dict_file(tmp_path):
    path = str(tmp_path / "idx.parquet")
    _tpq_dict_file(path, codec=CompressionCodec.UNCOMPRESSED, crc=False)
    _corrupt_index_page(path, 0, "k", 1)
    return path


@pytest.mark.parametrize("k", DEPTHS)
def test_corrupt_dictionary_index_raises_eagerly(tmp_path, reference_env, k):
    path = _corrupt_dict_file(tmp_path)
    want = _reference_error(lambda: list(RDR.scan_files([path], prefetch=k)))
    got_groups = []
    with pytest.raises(ParquetError) as got:
        for g in DR.scan_files([path], prefetch=k, device="cpu"):
            got_groups.append(g)
    assert str(got.value) == want
    assert "out of range" in want
    assert got_groups == []  # row group 0 is the corrupt one
    with pytest.raises(ParquetError) as it:
        list(DR.DeviceFileReader(path, device="cpu",
                                 prefetch=k).iter_row_groups())
    assert str(it.value) == want


@pytest.mark.parametrize("k", DEPTHS)
def test_corrupt_dictionary_index_deferred_without_native(
        tmp_path, reference_env, k):
    """Without the native run walk the range check waits for the device:
    every group is yielded, then the scan raises, as the reference's."""
    path = _corrupt_dict_file(tmp_path)
    reference_env.setattr(native, "hybrid_meta", lambda *a, **kw: None)
    reference_env.setattr(native, "chunk_runs", lambda *a, **kw: None)
    reference_env.setattr(ref_native, "hybrid_meta", lambda *a, **kw: None)
    ref_groups = []

    def run():
        for g in RDR.scan_files([path, path], prefetch=k):
            ref_groups.append(g)

    want = _reference_error(run)
    got_groups = []
    with pytest.raises(ParquetError) as got:
        for g in DR.scan_files([path, path], prefetch=k, device="cpu"):
            got_groups.append(g)
    assert str(got.value) == want
    assert "out of range" in want
    assert len(got_groups) == len(ref_groups) == 4
    # one reader: yielded first, raised at the end of the iteration
    groups = []
    with pytest.raises(ParquetError) as it:
        for g in DR.DeviceFileReader(path, device="cpu",
                                     prefetch=k).iter_row_groups():
            groups.append(g)
    assert len(groups) == 2 and str(it.value) == want


@pytest.mark.parametrize("k", DEPTHS)
def test_max_memory_raises_on_a_decompression_bomb(files, reference_env, k):
    path = files["k3_gzip"]
    want = _reference_error(lambda: list(
        RDR.scan_files([path], max_memory=64 << 10, prefetch=k)))
    assert want.startswith("memory budget exceeded")
    with pytest.raises(MemoryBudgetExceeded) as got:
        list(DR.scan_files([path], max_memory=64 << 10, prefetch=k,
                           device="cpu"))
    assert str(got.value) == want
    with pytest.raises(MemoryBudgetExceeded) as got:
        list(DR.DeviceFileReader(path, device="cpu", max_memory=64 << 10,
                                 prefetch=k).iter_row_groups())
    assert str(got.value) == want


def test_max_memory_bounds_the_chunk_feed(files, reference_env):
    path = files["pyarrow_dict"]
    r = DR.DeviceFileReader(path, device="cpu")
    costs = [c.meta_data.total_compressed_size
             + max(c.meta_data.total_uncompressed_size,
                   c.meta_data.total_compressed_size)
             for rg in r.metadata.row_groups for c in rg.columns]
    r.close()
    budget = 2 * max(costs) + 1024
    assert budget < sum(costs)
    want, _, _ = _read(RDR.DeviceFileReader(path))
    with DR.DeviceFileReader(path, device="cpu", prefetch=4,
                             max_memory=budget) as r:
        got = [{n: _host(c) for n, c in g.items()}
               for g in r.iter_row_groups()]
        pipe = r.pipeline_stats().as_dict()
        assert r.alloc.device_snapshot()[0] == 0  # finalize released it
        assert r.alloc.device_snapshot()[1] > 0
    _same_outs(got, want)
    assert 0 < pipe["peak_in_flight_bytes"] <= budget
    assert pipe["budget_bytes"] == budget


def test_stage_lanes_fill_on_the_worker(files):
    with DR.DeviceFileReader(files["k3_gzip"], device="cpu",
                             prefetch=2) as r:
        list(r.iter_row_groups())
        st, pipe = r.stats(), r.pipeline_stats()
    assert st.stage_seconds > 0 and st.dispatch_seconds > 0
    for lane in ("io", "decompress", "stage", "dispatch", "finalize"):
        assert pipe.stage_seconds(lane) > 0, lane
    assert pipe.row_groups == 2 and pipe.chunks == 12


def _stage_both(monkeypatch, parts, extent):
    """One registration sequence staged with and without a worker."""
    monkeypatch.setattr(DR._RowGroupStager, "STRIP", 4096)
    out = []
    for ex in (None, ThreadPoolExecutor(1, thread_name_prefix="tpq-stage")):
        st = DR._RowGroupStager(ex, torch.device("cpu"))
        for kind, payload in parts:
            if kind == "arr":
                st.add(payload)
            elif kind == "reserve":
                st.add(payload, reserve=payload.nbytes + 1000)
            else:
                st.add_segments(payload)
        if extent:
            st.note_read_extent(st.total - 100, extent)
        streamed = len(st._strip_futs)
        buf = st.stage().numpy()
        if ex is not None:
            ex.shutdown(wait=True)
        out.append((buf, st.total, max(st.total, st._max_read_end),
                    streamed))
    return out


@pytest.mark.parametrize("extent", [0, 9000])
def test_stager_strips_equal_the_single_buffer(monkeypatch, extent):
    rng = np.random.default_rng(31)
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in (5000, 7000, 300)]
    parts = [("arr", rng.integers(0, 1 << 30, 900).astype(np.int64)),
             ("segs", [(blobs[0], 10, 4000), (blobs[1], 0, 7000)]),
             ("reserve", rng.integers(0, 255, 333).astype(np.uint8)),
             ("arr", rng.uniform(0, 1, 2500)),
             ("segs", [(blobs[2], 5, 295)])]
    (single, total, need, n0), (streamed, total2, need2, n1) = _stage_both(
        monkeypatch, parts, extent)
    assert total == total2 and need == need2
    assert n0 == 0 and n1 == total // 4096 > 0
    assert len(single) >= need + _SLACK and len(streamed) >= need + _SLACK
    assert np.array_equal(single[:need], streamed[:need])


def test_small_stager_keeps_the_single_buffer(monkeypatch):
    parts = [("arr", np.arange(100, dtype=np.int32))]
    (single, _, need, _), (other, _, _, n1) = _stage_both(monkeypatch, parts,
                                                           0)
    assert n1 == 0  # under one strip: no strip job, the same bytes
    assert np.array_equal(single, other)
