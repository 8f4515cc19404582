"""The port's parallel decode (``tpu_parquet_torch.parallel``, on
``torch.distributed``) against the JAX package's (``tpu_parquet.parallel``,
on its 8-device virtual CPU mesh from ``tests/conftest.py``).

The same pages, dictionaries and files, made from a seed with numpy, go
through both packages:

- the host halves, in this process: ``plan_shards``, ``shard_row_ranges``
  and ``pack_hybrid_pages`` / ``pack_delta_pages`` (every table, by bits);
- a world of one, in this process, on gloo: ``make_mesh("cpu")`` and the
  sharded decodes, ``column_stats`` and both global-array forms;
- a world of four: ONE module-scoped ``torch.multiprocessing.spawn`` of four
  gloo ranks (a ``file://`` rendezvous under ``tmp_path``, joined within
  120 s so a hung rendezvous fails instead of stalling the suite) runs the
  1-D decodes with stats, the 2x2 ``("data", "model")`` dictionary variant,
  ``column_stats``, both global-array forms (1-D and 2x2),
  ``shard_scan_row_groups``, and the two cases of the reference's
  ``tests/test_training_pipeline.py``: ``iter_batches`` feeding a row-sharded
  SGD step whose gradient is an all_reduce, and the pushdown reads.

Each result is compared with the reference's on the same inputs (the
reference on a 4-device mesh, or 2x2): bit-equal arrays, equal stats and
counts, each rank's local shard equal to the reference's shard on the
device of the same coordinate.  The one float comparison is the SGD
weights, computed by two frameworks: both must reach the generating
weights within the reference test's own 0.1, and each other within 1e-5;
the four ranks' weights are bit-equal.

The worker function lives in this module, whose top level imports neither
``jax`` nor the JAX package, so the spawned ranks load the port only.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from tpu_parquet_torch import parallel as par
from tpu_parquet_torch.kernels import delta as delta_host, rle as rle_host

WORLD = 4
JOIN_S = 120
SPAN_GROUP = 137
FEATS = [f"f{j}" for j in range(8)]
TRAIN_BATCH = 4096
EPOCHS = 4


def _inputs():
    """Every page batch of the module, the same in each process."""
    rng = np.random.default_rng(11)

    def hybrid(n_pages, count, width, dict_len, counts=None):
        vals = [rng.integers(0, dict_len, c).astype(np.uint64)
                for c in (counts or [count] * n_pages)]
        return [rle_host.encode(v, width) for v in vals], vals

    out = {}
    raws, vals = hybrid(16, 500, 7, 100)
    out["dict"] = dict(raws=raws, vals=vals, width=7, count=500,
                       dictionary=rng.integers(-(1 << 40), 1 << 40, 100))
    raws, vals = hybrid(8, 200, 5, 20, counts=[200] * 7 + [57])
    out["tail"] = dict(raws=raws, vals=vals, width=5, count=200,
                       counts=[200] * 7 + [57],
                       dictionary=rng.integers(0, 1 << 30, 20))
    raws, vals = hybrid(8, 256, 6, 37)
    out["dict2d"] = dict(raws=raws, vals=vals, width=6, count=256,
                         dictionary=rng.integers(0, 1 << 20, 37))
    for bits in (32, 64):
        dt = np.int32 if bits == 32 else np.int64
        vals = [np.cumsum(rng.integers(-40, 40, 384)).astype(dt)
                for _ in range(16)]
        out[f"delta{bits}"] = dict(
            raws=[delta_host.encode(v, bits=bits) for v in vals], vals=vals,
            bits=bits, count=384)
    vals = [rng.integers(-(1 << 50), 1 << 50, 512) for _ in range(8)]
    bufs = np.zeros((8, par._bucket(512 * 8 + par._SLACK, 64)), np.uint8)
    for i, v in enumerate(vals):
        bufs[i, : 512 * 8] = v.view(np.uint8)
    out["plain"] = dict(bufs=bufs, vals=vals, count=512)
    out["stats"] = rng.integers(-1000, 1000, (8, 256))
    return out


def _dict_u8(d):
    return d["dictionary"].view(np.uint8).reshape(len(d["dictionary"]), 8)


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


# ---------------------------------------------------------------------------
# the port's side: one function per world, run by every rank
# ---------------------------------------------------------------------------

def _decode_results(mesh, inp) -> dict:
    """The 1-D mesh's decodes on this rank: full tensors and local shards."""
    res = {}
    d = inp["dict"]
    batch = par.pack_hybrid_pages(d["raws"], d["width"], d["count"])
    vals, stats = par.sharded_dict_decode(
        batch, torch.from_numpy(_dict_u8(d)), "int64", mesh,
        with_stats=True)
    res["dict"] = (vals.full_tensor().numpy(), vals.to_local().numpy(),
                   stats.numpy())
    t = inp["tail"]
    batch = par.pack_hybrid_pages(t["raws"], t["width"], t["count"],
                                  counts=t["counts"])
    vals, stats = par.sharded_dict_decode(
        batch, torch.from_numpy(_dict_u8(t)), "int64", mesh)
    res["tail"] = (vals.full_tensor().numpy(), stats.numpy())
    for bits in (32, 64):
        dl = inp[f"delta{bits}"]
        batch = par.pack_delta_pages(dl["raws"], bits, dl["count"])
        vals = par.sharded_delta_decode(batch, bits, mesh)
        res[f"delta{bits}"] = (vals.full_tensor().numpy(),
                               vals.to_local().numpy())
    p = inp["plain"]
    vals = par.sharded_plain_decode(torch.from_numpy(p["bufs"]), "int64",
                                    p["count"], mesh)
    res["plain"] = (vals.full_tensor().numpy(), vals.to_local().numpy())
    st = torch.from_numpy(inp["stats"])
    res["stats"] = par.column_stats(st, mesh).numpy()
    res["stats_dtensor"] = par.column_stats(
        par.sharded_plain_decode(torch.from_numpy(p["bufs"]), "int64",
                                 p["count"], mesh), mesh).numpy()
    return res


def _global_results(mesh, paths, prefix="") -> dict:
    from tpu_parquet_torch.reader import FileReader

    res = {}
    for name, path in paths.items():
        with FileReader(path) as r:
            arr, valid = par.global_column_array(r, "v", mesh)
            res[f"{prefix}global_{name}"] = (arr.full_tensor().numpy(),
                                             arr.to_local().numpy(), valid)
            if prefix == "":
                arr, valid = par.process_local_column(r, "v", mesh,
                                                      prefetch=2)
                res[f"local_{name}"] = (arr.full_tensor().numpy(),
                                        arr.to_local().numpy(), valid)
    return res


def _train(mesh, train_path, rank, world) -> dict:
    """The reference's training-pipeline test on the port: each rank reads
    the batches, takes its rows, and the gradient is an all_reduce over the
    mesh's group."""
    from tpu_parquet_torch.device_reader import DeviceFileReader
    from tpu_parquet_torch.predicate import col

    w = torch.zeros(8, dtype=torch.float32)
    group = mesh.get_group("data")
    per = TRAIN_BATCH // world
    lo, hi = rank * per, (rank + 1) * per
    batches, shapes, steps = [], set(), 0
    for epoch in range(EPOCHS):
        with DeviceFileReader(train_path, device="cpu") as r:
            for batch in r.iter_batches(TRAIN_BATCH):
                if epoch == 0 and rank == 0:
                    batches.append({k: v.numpy().copy()
                                    for k, v in batch.items()})
                feats = torch.stack([batch[k] for k in FEATS], dim=1)
                x, y = feats[lo:hi], batch["label"][lo:hi]
                grad = x.T @ (x @ w - y) * (2.0 / TRAIN_BATCH)
                dist.all_reduce(grad, group=group)
                w = w - 0.1 * grad
                shapes.add((tuple(feats.shape), tuple(batch["label"].shape)))
                steps += 1
    res = {"w": w.numpy(), "steps": steps, "shapes": shapes,
           "batches": batches}
    if rank == 0:
        with DeviceFileReader(train_path, row_filter=col("fold") < 3,
                              device="cpu") as r:
            res["kept"] = (sum(int(c["label"].num_values)
                               for c in r.iter_row_groups()),
                           r._host.num_selected_rows)
        with DeviceFileReader(train_path, row_filter=col("label") > 1e9,
                              device="cpu") as r:
            res["pruned_groups"] = sum(1 for _ in r.iter_row_groups())
    return res


def _world(rank, world, init, paths, out_dir):
    """One rank of the spawned gloo world: every check's raw results,
    pickled for the parent to compare with the reference's."""
    from torch.distributed.device_mesh import init_device_mesh

    from tpu_parquet_torch.reader import FileReader

    os.environ["GLOO_SOCKET_IFNAME"] = "lo"  # loopback only
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = par.make_mesh("cpu")
        inp = _inputs()
        res = _decode_results(mesh, inp)
        res.update(_global_results(
            mesh, {"even": paths["even"], "odd": paths["odd"]}))
        mesh2 = init_device_mesh("cpu", (2, 2),
                                 mesh_dim_names=("data", "model"))
        d = inp["dict2d"]
        batch = par.pack_hybrid_pages(d["raws"], d["width"], d["count"])
        vals = par.sharded_dict_decode_2d(
            batch, torch.from_numpy(_dict_u8(d)), "int64", mesh2)
        res["dict2d"] = (vals.full_tensor().numpy(), vals.to_local().numpy())
        res.update(_global_results(mesh2, {"odd": paths["odd"]},
                                   prefix="2d_"))
        with FileReader(paths["odd"], prefetch=2) as r:
            res["shard_scan"] = [
                (i, np.asarray(cols["v"].values))
                for i, cols in par.shard_scan_row_groups(r, rank, world)]
        res["train"] = _train(mesh, paths["train"], rank, world)
        res["process_shard"] = par.process_shard()
        try:  # 6 pages over 4 ranks: the reference's shard_map refuses too
            par.sharded_plain_decode(
                torch.from_numpy(inp["plain"]["bufs"][:6]), "int64", 512,
                mesh)
        except ValueError as e:
            res["indivisible"] = str(e)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# fixtures: the files, the reference's results, the worlds
# ---------------------------------------------------------------------------

def _write_span_file(path, rows):
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    vals = np.arange(rows, dtype=np.int64) * 3 - 500
    schema = build_schema([data_column("v", Type.INT64, FRT.REQUIRED)])
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY,
                    use_dictionary=False) as w:
        for lo in range(0, rows, SPAN_GROUP):
            w.write_columns({"v": vals[lo : lo + SPAN_GROUP]})
            w.flush_row_group()
    return vals


def _write_train_file(path):
    """The reference test's dataset: 40,000 rows, 8 float32 features, a
    label and an int32 fold, pyarrow-written in 5,000-row groups."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    n = 40_000
    x = rng.normal(size=(n, 8)).astype(np.float32)
    w_true = np.arange(1, 9, dtype=np.float32)
    y = x @ w_true + 0.01 * rng.normal(size=n).astype(np.float32)
    cols = {f"f{j}": x[:, j] for j in range(8)}
    cols["label"] = y.astype(np.float32)
    cols["fold"] = rng.integers(0, 10, n).astype(np.int32)
    pq.write_table(pa.table(cols), path, row_group_size=5000,
                   use_dictionary=False, compression="snappy")
    return w_true


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from tests.test_torch_ref_native import ensure_reference_native

    ensure_reference_native()
    d = tmp_path_factory.mktemp("torch_parallel")
    paths = {"even": str(d / "span1000.parquet"),
             "odd": str(d / "span997.parquet"),
             "train": str(d / "train.parquet")}
    vals = {"even": _write_span_file(paths["even"], 1000),
            "odd": _write_span_file(paths["odd"], 997)}
    w_true = _write_train_file(paths["train"])
    return paths, vals, w_true


@pytest.fixture(scope="module")
def reference(files):
    """Every result of the JAX package on the same inputs."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from tpu_parquet import parallel as R
    from tpu_parquet.device_reader import DeviceFileReader as RefDevReader
    from tpu_parquet.jax_kernels import enable_x64
    from tpu_parquet.predicate import col as ref_col
    from tpu_parquet.reader import FileReader as RefReader

    paths, _vals, _w = files
    inp = _inputs()
    mesh4 = R.make_mesh(jax.devices()[:WORLD])
    mesh2 = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                 ("data", "model"))
    out = {"mesh4": mesh4, "mesh2": mesh2, "inp": inp}

    def jitted(fn, batch, *args, **kw):
        """``fn(batch, *args)`` traced and compiled as one program: the
        same function, without an eager dispatch (and compile) per op."""
        arrays = {k: v for k, v in vars(batch).items()
                  if isinstance(v, jax.Array)}
        static = {k: v for k, v in vars(batch).items() if k not in arrays}

        def run(arrs, *xs):
            return fn(R.PageBatch(**arrs, **static), *xs, *args[len(xs):],
                      **kw)

        n_arr = sum(1 for a in args if isinstance(a, jax.Array))
        with enable_x64():
            return jax.jit(run)(arrays, *args[:n_arr])

    d = inp["dict"]
    batch = R.pack_hybrid_pages(d["raws"], d["width"], d["count"])
    vals, stats = jitted(R.sharded_dict_decode, batch,
                         jnp.asarray(_dict_u8(d)), "int64", mesh4,
                         with_stats=True)
    out["dict"] = (np.asarray(vals), np.asarray(stats))
    t = inp["tail"]
    batch = R.pack_hybrid_pages(t["raws"], t["width"], t["count"],
                                counts=t["counts"])
    vals, stats = jitted(R.sharded_dict_decode, batch,
                         jnp.asarray(_dict_u8(t)), "int64", mesh4)
    out["tail"] = (np.asarray(vals), np.asarray(stats))
    d = inp["dict2d"]
    batch = R.pack_hybrid_pages(d["raws"], d["width"], d["count"])
    out["dict2d"] = np.asarray(jitted(
        R.sharded_dict_decode_2d, batch, jnp.asarray(_dict_u8(d)), "int64",
        mesh2))
    for bits in (32, 64):
        dl = inp[f"delta{bits}"]
        batch = R.pack_delta_pages(dl["raws"], bits, dl["count"])
        out[f"delta{bits}"] = np.asarray(jitted(R.sharded_delta_decode,
                                                batch, bits, mesh4))
    p = inp["plain"]
    out["plain"] = np.asarray(R.sharded_plain_decode(
        jnp.asarray(p["bufs"]), "int64", p["count"], mesh4))
    out["stats"] = np.asarray(R.column_stats(jnp.asarray(inp["stats"]),
                                             mesh4))
    def arr(pair):
        return np.asarray(pair[0]), pair[1]

    for name in ("even", "odd"):
        with RefReader(paths[name]) as r:
            out[f"global_{name}"] = arr(R.global_column_array(r, "v", mesh4))
    with RefReader(paths["even"]) as r:
        # one process: its span is every row (997 would not divide over
        # the mesh, so the reference's single-process form has no odd case)
        out["local_even"] = arr(R.process_local_column(r, "v", mesh4))
    with RefReader(paths["odd"]) as r:
        out["2d_global_odd"] = arr(R.global_column_array(r, "v", mesh2))
        out["shard_scan"] = [
            [(i, np.asarray(cols["v"].values))
             for i, cols in R.shard_scan_row_groups(r, s, WORLD, prefetch=2)]
            for s in range(WORLD)]
    # the training pipeline: the batches, a jitted SGD step over the mesh
    with RefDevReader(paths["train"]) as r:
        batches = [{k: np.asarray(v) for k, v in b.items()}
                   for b in r.iter_batches(TRAIN_BATCH)]
    out["batches"] = batches
    sharding = NamedSharding(mesh4, P("data"))

    @jax.jit
    def train_step(w, feats, label):
        def loss(w):
            return jnp.mean((feats @ w - label) ** 2)
        return w - 0.1 * jax.grad(loss)(w)

    w = jax.device_put(jnp.zeros(8, dtype=jnp.float32),
                       NamedSharding(mesh4, P()))
    for _ in range(EPOCHS):
        for b in batches:
            feats = np.stack([b[k] for k in FEATS], axis=1)
            w = train_step(w, jax.device_put(feats, sharding),
                           jax.device_put(b["label"], sharding))
    out["w"] = np.asarray(w)
    with RefDevReader(paths["train"], row_filter=ref_col("fold") < 3) as r:
        out["kept"] = (sum(int(c["label"].num_values)
                           for c in r.iter_row_groups()),
                       r._host.num_selected_rows)
    with RefDevReader(paths["train"],
                      row_filter=ref_col("label") > 1e9) as r:
        out["pruned_groups"] = sum(1 for _ in r.iter_row_groups())
    return out


@pytest.fixture(scope="module")
def world4(files, tmp_path_factory):
    """Spawn the gloo world of four once; returns each rank's results."""
    paths, _vals, _w = files
    d = tmp_path_factory.mktemp("world4")
    init = f"file://{d}/rendezvous"
    t0 = time.monotonic()
    ctx = mp.spawn(_world, args=(WORLD, init, paths, str(d)), nprocs=WORLD,
                   join=False)
    try:
        while not ctx.join(timeout=max(JOIN_S - (time.monotonic() - t0), 1)):
            if time.monotonic() - t0 >= JOIN_S:
                raise AssertionError(
                    f"the gloo world of {WORLD} did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    out = []
    for rank in range(WORLD):
        with open(d / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A world of one in this process, on gloo; destroyed after the
    module."""
    d = tmp_path_factory.mktemp("world1")
    prev = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield par.make_mesh("cpu")
    finally:
        dist.destroy_process_group()
        if prev is None:
            os.environ.pop("GLOO_SOCKET_IFNAME", None)
        else:
            os.environ["GLOO_SOCKET_IFNAME"] = prev


# ---------------------------------------------------------------------------
# host halves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_plan_shards_and_row_ranges_equal(seed):
    from tpu_parquet import parallel as R

    rng = np.random.default_rng(seed)
    n_groups = int(rng.integers(0, 40))
    sizes = [int(s) for s in rng.integers(1, 1 << 20, n_groups)]
    for n in (1, 2, 3, 8, 16):
        assert par.plan_shards(sizes, n) == R.plan_shards(sizes, n)
        for total in (0, 1, 997, 1000, int(rng.integers(0, 1 << 30))):
            assert par.shard_row_ranges(total, n) == R.shard_row_ranges(
                total, n)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            par.plan_shards(sizes, bad)
        with pytest.raises(ValueError):
            par.shard_row_ranges(10, bad)


@pytest.mark.parametrize("case", ["dict", "tail", "dict2d", "delta32",
                                  "delta64"])
def test_pack_pages_equal(case):
    from tpu_parquet import parallel as R

    c = _inputs()[case]
    if case.startswith("delta"):
        got = par.pack_delta_pages(c["raws"], c["bits"], c["count"])
        want = R.pack_delta_pages(c["raws"], c["bits"], c["count"])
        fields = ("bufs", "first_values", "mini_bit_starts", "mini_widths",
                  "mini_min_delta")
        assert (got.values_per_mini, got.max_width) == (
            want.values_per_mini, want.max_width)
    else:
        got = par.pack_hybrid_pages(c["raws"], c["width"], c["count"],
                                    counts=c.get("counts"))
        want = R.pack_hybrid_pages(c["raws"], c["width"], c["count"],
                                   counts=c.get("counts"))
        fields = ("bufs", "run_ends", "run_is_rle", "run_bit_starts")
        # run values: uint32 in the reference, int64 here, the same numbers
        assert np.array_equal(got.run_values.numpy(),
                              np.asarray(want.run_values).astype(np.int64))
    assert (got.count, got.width, got.num_pages) == (
        want.count, want.width, want.num_pages)
    for f in fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape, f
        assert np.array_equal(_bits(a), _bits(b)), f


def test_make_mesh_refuses_without_card_or_group(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        par.make_mesh()  # the default is "cuda": never a quiet fallback
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            par.make_mesh("cpu")
    with pytest.raises(ValueError):
        par.make_mesh("tpu")
    assert par.process_shard() == (0, 1)


# ---------------------------------------------------------------------------
# a world of one, in process
# ---------------------------------------------------------------------------

def test_world_of_one_refuses_cuda_through_gloo(world1, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="nccl"):
        par.make_mesh("cuda")


def test_world_of_one_decodes(world1, reference):
    res = _decode_results(world1, _inputs())
    ref = reference
    assert np.array_equal(res["dict"][0], ref["dict"][0])
    assert np.array_equal(res["dict"][1], ref["dict"][0])  # one rank: all
    assert np.array_equal(res["dict"][2], ref["dict"][1])
    assert np.array_equal(res["tail"][0], ref["tail"][0])
    assert np.array_equal(res["tail"][1], ref["tail"][1])  # zeros
    for bits in (32, 64):
        assert np.array_equal(_bits(res[f"delta{bits}"][0]),
                              _bits(ref[f"delta{bits}"]))
    assert np.array_equal(res["plain"][0], ref["plain"])
    assert np.array_equal(res["stats"], ref["stats"])
    assert par.process_shard() == (0, 1)


def test_world_of_one_global_arrays(world1, reference, files):
    res = _global_results(world1, {n: files[0][n] for n in ("even", "odd")})
    # the reference's arrays over 4 devices; over one rank the spans are
    # one, so compare against the file itself, padding-free
    for name in ("even", "odd"):
        vals = files[1][name]
        for form in ("global", "local"):
            full, local, valid = res[f"{form}_{name}"]
            assert valid == len(vals) == reference[f"global_{name}"][1]
            assert np.array_equal(full, vals) and np.array_equal(local, vals)
    assert np.array_equal(res["local_even"][0], reference["local_even"][0])


def test_world_of_one_takes_any_page_count(world1):
    c = _inputs()["dict"]
    batch = par.pack_hybrid_pages(c["raws"][:3], c["width"], c["count"])
    res, _ = par.sharded_dict_decode(batch, torch.from_numpy(_dict_u8(c)),
                                     "int64", world1)  # 3 pages, 1 rank
    want = np.stack([c["dictionary"][v.astype(np.int64)]
                     for v in c["vals"][:3]])
    assert np.array_equal(res.full_tensor().numpy(), want)


# ---------------------------------------------------------------------------
# a world of four, spawned once
# ---------------------------------------------------------------------------

def _shard(a, rank, n=WORLD):
    per = a.shape[0] // n
    return a[rank * per:(rank + 1) * per]


def test_world_of_four_decodes_with_stats(world4, reference):
    ref = reference
    for rank, res in enumerate(world4):
        full, local, stats = res["dict"]
        assert np.array_equal(full, ref["dict"][0])
        assert np.array_equal(local, _shard(ref["dict"][0], rank))
        assert np.array_equal(stats, ref["dict"][1])
        assert np.array_equal(res["tail"][0], ref["tail"][0])
        assert np.array_equal(res["tail"][1], ref["tail"][1])
        for bits in (32, 64):
            full, local = res[f"delta{bits}"]
            assert np.array_equal(_bits(full), _bits(ref[f"delta{bits}"]))
            assert np.array_equal(_bits(local),
                                  _bits(_shard(ref[f"delta{bits}"], rank)))
        assert np.array_equal(res["plain"][0], ref["plain"])
        assert np.array_equal(res["plain"][1], _shard(ref["plain"], rank))
        assert res["process_shard"] == (rank, WORLD)
    # the stats are global: count over every rank's pages
    assert world4[0]["dict"][2][0] == 16 * 500


def test_world_of_four_page_count_must_divide(world4, reference):
    import jax.numpy as jnp

    from tpu_parquet import parallel as R

    for res in world4:
        assert "do not divide" in res["indivisible"]
    with pytest.raises(ValueError):
        R.sharded_plain_decode(jnp.asarray(
            reference["inp"]["plain"]["bufs"][:6]), "int64", 512,
            reference["mesh4"])


def test_world_of_four_column_stats(world4, reference):
    for res in world4:
        assert np.array_equal(res["stats"], reference["stats"])
        p = np.stack(reference["inp"]["plain"]["vals"])
        assert list(res["stats_dtensor"]) == [p.size, p.min(), p.max()]


def test_world_of_four_2x2_dictionary_variant(world4, reference):
    ref = reference["dict2d"]
    vals = reference["inp"]["dict2d"]
    want = np.stack([vals["dictionary"][v.astype(np.int64)]
                     for v in vals["vals"]])
    assert np.array_equal(ref, want)
    for rank, res in enumerate(world4):
        full, local = res["dict2d"]
        assert np.array_equal(full, ref)
        # ranks (d, m): data coordinate d = rank // 2 holds pages of d
        assert np.array_equal(local, _shard(ref, rank // 2, 2))


@pytest.mark.parametrize("form", ["global_even", "global_odd", "local_even",
                                  "local_odd", "2d_global_odd"])
def test_world_of_four_global_arrays(world4, reference, files, form):
    ref = reference
    if form == "local_odd":
        # the reference's single process holds every row unpadded; the
        # world's four processes pad the tail span as the reference's
        # multi-host form would: equal to its 4-device global array
        want, valid = ref["global_odd"]
    else:
        want, valid = ref[form]
    n = 2 if form.startswith("2d") else WORLD
    for rank, res in enumerate(world4):
        full, local, got_valid = res[form]
        assert got_valid == valid
        assert np.array_equal(full, want)
        coord = rank // 2 if n == 2 else rank
        assert np.array_equal(local, _shard(want, coord, n))
    vals = files[1]["odd" if form.endswith("odd") else "even"]
    assert np.array_equal(want[:len(vals)], vals)
    assert not want[len(vals):].any()


def test_world_of_four_shard_scan_row_groups(world4, reference):
    union = []
    for rank, res in enumerate(world4):
        got, want = res["shard_scan"], reference["shard_scan"][rank]
        assert [i for i, _ in got] == [i for i, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert np.array_equal(a, b)
        union += [i for i, _ in got]
    assert sorted(union) == list(range(-(-997 // SPAN_GROUP)))


def test_world_of_four_training_pipeline(world4, reference, files):
    w_true = files[2]
    ref_w = reference["w"]
    r0 = world4[0]["train"]
    # the batches the step consumed are the reference's, bit for bit
    assert len(r0["batches"]) == len(reference["batches"]) == 40_000 // 4096
    for got, want in zip(r0["batches"], reference["batches"]):
        assert set(got) == set(want)
        for k in got:
            assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    for res in world4:
        tr = res["train"]
        assert tr["steps"] == EPOCHS * (40_000 // 4096)
        assert len(tr["shapes"]) == 1  # fixed shapes
        assert np.array_equal(_bits(tr["w"]), _bits(r0["w"]))  # all ranks
    assert np.allclose(ref_w, w_true, atol=0.1), ref_w
    assert np.allclose(r0["w"], w_true, atol=0.1), r0["w"]
    assert np.allclose(r0["w"], ref_w, rtol=0, atol=1e-5)
    # pushdown: a conservative predicate keeps every group, a selective
    # one prunes them all, as in the reference
    assert r0["kept"] == reference["kept"]
    assert r0["kept"][0] == r0["kept"][1] == 40_000
    assert r0["pruned_groups"] == reference["pruned_groups"] == 0
