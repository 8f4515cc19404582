"""The port's training-input loader (``tpu_parquet_torch.data``) against the
JAX package's (``tpu_parquet.data``), case for case with
``tests/test_data_loader.py`` on its fixture: two files, ten row groups of
uneven sizes, three fixed-width dtypes plus a string column to project out,
and a ragged epoch tail (``total % BS != 0``).

Every case runs through both packages on the same files and compares them:
with the same seed the port's batches equal the reference's, batch by
batch and bit for bit; prefetch 0 and 4 give the same stream; shards
partition the rows; save/restore at several cuts and across an epoch
boundary re-enters the stream exactly; each package restores the other's
state blob; garbage, mismatched and reordered states raise
``CheckpointError``; pad/mask, ``drop_remainder`` and the mask-key
collision behave alike; ``to_device=True, device="cpu"`` gives torch
tensors equal to the reference's arrays, and ``to_device=True`` with no card
and no ``device=`` raises; ``LoaderStats`` carries the reference's keys; the
sampler's ``epoch_unit_order``, ``block_permutation`` and ``plan_epoch`` are
the reference's.  Exact everywhere.
"""

import numpy as np
import pytest
import torch

from tpu_parquet import data as RD
from tpu_parquet.data import checkpoint as RCK
from tpu_parquet.data import loader as RL
from tpu_parquet.data import sampler as RS
from tpu_parquet.errors import CheckpointError as RefCheckpointError
from tpu_parquet_torch import data as PD
from tpu_parquet_torch.data import checkpoint as PCK
from tpu_parquet_torch.data import loader as PL
from tpu_parquet_torch.data import sampler as PS
from tpu_parquet_torch.errors import CheckpointError, ParquetError
from tests.test_torch_ref_native import ensure_reference_native

ensure_reference_native()

BS = 256
COLS = ["a", "b", "c"]
PKGS = {"port": PD, "reference": RD}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """The reference test's fixture, written by the port's writer."""
    from tpu_parquet_torch.column import ByteArrayData, ColumnData
    from tpu_parquet_torch.format import (CompressionCodec,
                                          FieldRepetitionType as FRT, Type)
    from tpu_parquet_torch.schema.core import build_schema, data_column
    from tpu_parquet_torch.writer import FileWriter

    d = tmp_path_factory.mktemp("torch_loader")
    rng = np.random.default_rng(0)
    schema = build_schema([
        data_column("a", Type.INT64, FRT.REQUIRED),
        data_column("b", Type.DOUBLE, FRT.REQUIRED),
        data_column("c", Type.INT32, FRT.REQUIRED),
        data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED),
    ])
    paths, sizes = [], []
    for fi, groups in enumerate([(900, 1100, 500, 1000, 700),
                                 (1000, 300, 1300, 800, 411)]):
        p = str(d / f"part{fi}.parquet")
        with FileWriter(p, schema, codec=CompressionCodec.SNAPPY) as w:
            for n in groups:
                strs = [b"s%d" % i for i in range(n)]
                w.write_columns({
                    "a": rng.integers(0, 1 << 50, n),
                    "b": rng.uniform(-1, 1, n),
                    "c": rng.integers(0, 1 << 20, n).astype(np.int32),
                    "s": ColumnData(values=ByteArrayData.from_list(strs)),
                })
                w.flush_row_group()
            sizes.extend(groups)
        paths.append(p)
    return paths, sum(sizes)


def _loader(pkg, paths, **kw):
    kw.setdefault("columns", COLS)
    kw.setdefault("seed", 3)
    kw.setdefault("shuffle", True)
    kw.setdefault("shuffle_window", 1000)
    return PKGS[pkg].DataLoader(paths, BS, **kw)


def _host(v) -> np.ndarray:
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for c in g:
            a, b = _host(g[c]), _host(w[c])
            assert a.dtype == b.dtype and a.shape == b.shape, c
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), c


def _take(loader, n):
    it = iter(loader)
    out = []
    for batch in it:
        out.append(batch)
        if len(out) == n:
            it.close()
            break
    return out


def _both(paths, **kw):
    return (list(iter(_loader("port", paths, **kw))),
            list(iter(_loader("reference", paths, **kw))))


# ---------------------------------------------------------------------------
# the stream: equal to the reference's, at every depth
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"seed": 4}, {"shuffle": False}, {"shuffle_window": 4096},
    {"drop_remainder": True}, {"columns": ["c", "a"]},
], ids=["default", "seed4", "unshuffled", "window4096", "drop", "proj"])
def test_same_seed_same_batches_as_the_reference(dataset, kw):
    paths, _ = dataset
    port, ref = _both(paths, **kw)
    _assert_batches_equal(port, ref)


def test_prefetch_depth_never_changes_the_stream(dataset):
    paths, _ = dataset
    runs = {k: list(iter(_loader("port", paths, prefetch=k)))
            for k in (0, 4)}
    _assert_batches_equal(runs[4], runs[0])
    _assert_batches_equal(runs[0],
                          list(iter(_loader("reference", paths, prefetch=4))))


def test_epochs_reshuffle_as_the_reference(dataset):
    paths, total = dataset
    got = list(_loader("port", paths, prefetch=2).epochs(2))
    want = list(_loader("reference", paths).epochs(2))
    _assert_batches_equal(got, want)
    n = len(got) // 2
    e0 = np.concatenate([b["a"][b["mask"]] for b in got[:n]])
    e1 = np.concatenate([b["a"][b["mask"]] for b in got[n:]])
    assert not np.array_equal(e0, e1)
    assert np.array_equal(np.sort(e0), np.sort(e1)) and len(e0) == total


@pytest.mark.parametrize("n_shards", [2, 8])
def test_shard_union_equals_whole(dataset, n_shards):
    paths, total = dataset
    parts = []
    for i in range(n_shards):
        port, ref = _both(paths, shard=(i, n_shards))
        _assert_batches_equal(port, ref)
        parts += [b["a"][b["mask"]] for b in port]
    whole = np.concatenate([b["a"][b["mask"]]
                            for b in _loader("port", paths)])
    got = np.sort(np.concatenate(parts))
    assert len(got) == total and np.array_equal(got, np.sort(whole))


def test_empty_shard_is_a_clean_noop(dataset):
    paths, _ = dataset
    l = _loader("port", paths, shard=(15, 16))
    r = _loader("reference", paths, shard=(15, 16))
    assert l.num_rows == r.num_rows and l.num_batches == r.num_batches
    _assert_batches_equal(list(iter(l)), list(iter(r)))
    assert l.epoch == r.epoch == 1


# ---------------------------------------------------------------------------
# checkpoint / resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("cut", [1, 7, 13])
def test_save_restore_bit_identical(dataset, prefetch, cut, shard):
    paths, _ = dataset
    want = list(iter(_loader("reference", paths, prefetch=prefetch,
                             shard=shard)))
    l = _loader("port", paths, prefetch=0, shard=shard)
    first = _take(l, cut)
    assert len(first) == cut
    blob = l.state_blob()
    resumed = _loader("port", paths, prefetch=prefetch,
                      shard=shard).restore(blob)
    rest = list(iter(resumed))
    _assert_batches_equal(first + rest, want)
    assert resumed.epoch == 1


def test_restore_across_epoch_boundary(dataset):
    paths, _ = dataset
    want = list(_loader("reference", paths, prefetch=2).epochs(3))
    l = _loader("port", paths, prefetch=0)
    first = list(iter(l)) + _take(l, 5)
    resumed = _loader("port", paths, prefetch=4).restore(l.state())
    rest = list(resumed.epochs(2))
    _assert_batches_equal(first + rest, want)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_restores_the_others_blob(dataset, writer):
    paths, _ = dataset
    reader = "reference" if writer == "port" else "port"
    w = _loader(writer, paths, shard=(1, 2))
    _take(w, 6)
    blob = w.state_blob()
    assert blob[:4] == PCK.MAGIC == RCK.MAGIC
    assert PCK.unpack_state(blob) == RCK.unpack_state(blob) == w.state()
    assert PCK.pack_state(w.state()) == RCK.pack_state(w.state()) == blob
    rest = list(iter(_loader(reader, paths, shard=(1, 2)).restore(blob)))
    want = list(iter(_loader(writer, paths, shard=(1, 2)).restore(blob)))
    _assert_batches_equal(rest, want)


def test_state_blob_roundtrip(dataset):
    paths, _ = dataset
    l, r = _loader("port", paths), _loader("reference", paths)
    _take(l, 3), _take(r, 3)
    st = l.state()
    assert st == r.state()
    assert PD.unpack_state(PD.pack_state(st)) == st
    assert st["rows_taken"] == 3 * BS and st["version"] == PD.STATE_VERSION


def _refusals(loader, blob, state):
    bad = [b"", b"NOPE" + blob[4:], blob[:-10],
           PCK.MAGIC + (99).to_bytes(2, "big") + blob[6:],
           PCK.MAGIC + blob[4:6] + b"{not json"]
    for key, val in (("batch_size", BS + 1), ("shuffle", False),
                     ("shuffle_window", 999), ("shard", [1, 2]),
                     ("n_units", 11), ("total_rows", 1),
                     ("drop_remainder", True)):
        st = dict(state)
        st[key] = val
        if key == "total_rows":
            st["shard_rows"] = st["rows_taken"] = 0
        bad.append(st)
    for key, val in (("rows_taken", state["shard_rows"] + 1),
                     ("rows_taken", BS + 1), ("epoch", 1.0),
                     ("skipped_units", [3, 3]), ("skipped_rows", 5)):
        st = dict(state)
        st[key] = val
        bad.append(st)
    out = []
    for b in bad:
        try:
            loader.restore(b)
        except Exception as e:  # noqa: BLE001 — the class and text compare
            out.append((type(e).__name__, str(e)))
        else:
            out.append(None)
    return out


def test_checkpoint_refuses_what_the_reference_refuses(dataset):
    paths, _ = dataset
    l, r = _loader("port", paths), _loader("reference", paths)
    blob = l.state_blob()
    got = _refusals(l, blob, l.state())
    assert got == _refusals(r, blob, r.state())
    assert all(g is not None and g[0] == "CheckpointError" for g in got)
    assert issubclass(CheckpointError, ParquetError)
    assert CheckpointError.__name__ == RefCheckpointError.__name__


def test_checkpoint_rejects_reordered_dataset(dataset):
    paths, _ = dataset
    blob = _loader("port", paths).state_blob()
    with pytest.raises(CheckpointError, match="dataset_digest"):
        _loader("port", list(reversed(paths))).restore(blob)
    with pytest.raises(RefCheckpointError, match="dataset_digest"):
        _loader("reference", list(reversed(paths))).restore(blob)


# ---------------------------------------------------------------------------
# batch geometry
# ---------------------------------------------------------------------------

def test_ragged_tail_pads_and_masks(dataset):
    paths, total = dataset
    batches = list(iter(_loader("port", paths)))
    assert total % BS != 0 and len(batches) == -(-total // BS)
    tail = batches[-1]
    assert tail["mask"].sum() == total % BS
    for c in COLS:
        assert len(tail[c]) == BS and not tail[c][~tail["mask"]].any()
    host = {c: np.arange(5, dtype=np.int64) for c in ("x", "y")}
    for mod in (PL, RL):
        b = mod.pad_and_mask(host, 5, 8, mask_key="m")
        assert list(b["m"]) == [True] * 5 + [False] * 3
        assert list(b["x"]) == [0, 1, 2, 3, 4, 0, 0, 0]
    assert PL.pad_and_mask(host, 5, 8, mask_key=None).keys() == {"x", "y"}
    dev = PL.ship_to_device(b, "cpu")
    assert dev["x"].dtype == torch.int64 and dev["m"].dtype == torch.bool


def test_drop_remainder(dataset):
    paths, total = dataset
    batches = list(iter(_loader("port", paths, drop_remainder=True)))
    assert len(batches) == total // BS
    assert all("mask" not in b and len(b["a"]) == BS for b in batches)


def test_mask_key_collision_and_rename(dataset):
    paths, _ = dataset
    for pkg in PKGS.values():
        with pytest.raises(ValueError, match="collides"):
            pkg.DataLoader(paths, BS, columns=COLS, mask_key="a")
    port, ref = _both(paths, mask_key="valid")
    _assert_batches_equal(port, ref)
    assert "valid" in port[0] and "mask" not in port[0]


def test_to_device_cpu_tensors_equal_the_references_arrays(dataset):
    paths, _ = dataset
    ref = list(iter(_loader("reference", paths)))
    dev = list(iter(_loader("port", paths, to_device=True, device="cpu",
                            prefetch=2)))
    for b in dev:
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in b.values())
        assert b["a"].dtype == torch.int64 and b["b"].dtype == torch.float64
        assert b["c"].dtype == torch.int32 and b["mask"].dtype == torch.bool
    _assert_batches_equal(dev, ref)


def test_to_device_without_a_card_raises(dataset):
    paths, _ = dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _loader("port", paths, to_device=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _loader("port", paths, to_device=True, device="cuda")
    # without to_device the device is never consulted
    assert _loader("port", paths, device="cuda").num_rows > 0


# ---------------------------------------------------------------------------
# validation, observability, the sampler
# ---------------------------------------------------------------------------

def _error(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", [
    dict(columns=["a", "s"]), dict(), dict(columns=["nope"]),
    dict(batch_size=0), dict(shard=(2, 2)), dict(shuffle_window=0),
], ids=["bytes", "default_selection", "missing", "batch0", "shard",
        "window0"])
def test_column_and_argument_validation(dataset, case):
    paths, _ = dataset
    case = dict(case)
    bs = case.pop("batch_size", BS)
    cols = case.pop("columns", COLS if case else None)
    got = _error(lambda: PD.DataLoader(paths, bs, columns=cols, **case))
    want = _error(lambda: RD.DataLoader(paths, bs, columns=cols, **case))
    assert got is not None and got == want


def test_loader_stats(dataset):
    paths, total = dataset
    l, r = (_loader(p, paths, prefetch=2) for p in PKGS)
    list(iter(l)), list(iter(r))
    st = l.stats()
    assert st.rows == total and st.batches == -(-total // BS)
    assert st.epochs_completed == 1 and st.padded_batches == 1
    d, rd = st.as_dict(), r.stats().as_dict()
    assert set(d) == set(rd) and set(d["pipeline"]) == set(rd["pipeline"])
    for k in ("batches", "rows", "epochs_completed", "padded_batches",
              "window_peak_rows", "data_errors", "units_skipped",
              "rows_skipped"):
        assert d[k] == rd[k], k
    assert d["pipeline"]["row_groups"] == rd["pipeline"]["row_groups"] == 10
    assert d["pipeline"]["chunks"] == rd["pipeline"]["chunks"] == 30
    reg, rreg = l.obs_registry().as_dict(), r.obs_registry().as_dict()
    assert set(reg) == set(rreg) and reg["loader"]["rows"] == total


@pytest.mark.parametrize("seed", [0, 7, (1 << 64) - 1])
def test_sampler_equal(seed):
    for epoch in (0, 3):
        for shard in (0, 5):
            for n in (0, 1, 2, 10, 1000):
                assert np.array_equal(
                    PS.epoch_unit_order(seed, epoch, shard, n),
                    RS.epoch_unit_order(seed, epoch, shard, n))
                assert np.array_equal(
                    PS.block_permutation(seed, epoch, shard, 4, n),
                    RS.block_permutation(seed, epoch, shard, 4, n))
    rows = [900, 0, 1100, 500, 0, 411]
    for shuffle in (True, False):
        a = PS.plan_epoch(seed, 2, 1, rows, shuffle)
        b = RS.plan_epoch(seed, 2, 1, rows, shuffle)
        for f in ("order", "unit_rows", "starts"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        for row in (0, 899, 900, 2000, a.total_rows - 1):
            assert a.locate(row) == b.locate(row)


def test_import_isolation_walk_covers_this_slice():
    """``tests/test_torch_kernels.py`` imports every module that this walk
    finds with ``jax`` refused; the slice's modules are among them."""
    import pkgutil

    import tpu_parquet_torch

    names = {m.name for m in pkgutil.walk_packages(
        tpu_parquet_torch.__path__, "tpu_parquet_torch.")}
    for name in ("ledger", "obs_fleet", "parallel", "data", "data.sampler",
                 "data.checkpoint", "data.loader"):
        assert "tpu_parquet_torch." + name in names, name
