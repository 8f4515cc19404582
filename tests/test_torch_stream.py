"""The port's streaming scan sessions (``tpu_parquet_torch.serve.stream``)
against the JAX package's, case for case with ``tests/test_stream.py``.

The same files (the reference test's fixture: two files of three row
groups, from its seeds) and the same calls go through both packages: the
port's ``ScanService(device="cpu")``, the reference's service under
``TPQ_PALLAS=1 TPQ_FUSE=1``.  Held exactly: every batch bit for bit (the
port's device batches are torch tensors on the service's device, the
reference's JAX arrays), the batch counts, ``rows_emitted``, the warm and
cold group counters, the ``serve`` section's stream counters, every typed
error's class and text, and each ``b"TPQS"`` cursor blob byte for byte,
resumed in both directions (a cursor of either package resumes in the
other).

Held on the port alone: ``_batch_nbytes`` charges a shipped torch batch
exactly what it charges the host batch it came from (the stream's budget
charges rest on it), object columns counted by their payload.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tests.test_serve import _write_file
from tests.test_torch_serve import BOTH, PORT, REF, counts, outcome
from tpu_parquet_torch.column import ByteArrayData
from tpu_parquet_torch.data.loader import pad_and_mask, ship_to_device
from tpu_parquet_torch.serve import stream as ST
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_ref_native import (ensure_reference_native,
                                        no_reference_crashes)  # noqa: F401

ensure_reference_native()


@pytest.fixture(autouse=True)
def _parity_env(io_env, no_reference_crashes):
    """``io_env``: the reference's device reads in Pallas interpret mode,
    no IO knob set, both packages' default fetch engines (process-wide,
    both threads named ``tpq-fetch``) stopped around the test and no
    ``tpq-`` thread left by it; the reference's ``worker_crash`` events
    leave with the test."""
    yield


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream")
    return [_write_file(str(d / f"f{i}.parquet"), seed=10 + i, groups=3,
                        rows=400) for i in range(2)]


def _host(a) -> np.ndarray:
    """A batch column on the host: numpy as is, a torch tensor through
    ``.cpu()``, a JAX array through ``np.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _batch(b) -> list:
    """One batch as comparable (name, dtype, shape, bytes) entries."""
    out = []
    for name, a in b.items():
        h = _host(a)
        data = (h.tolist() if h.dtype == object
                else h.view(np.uint8).tobytes())
        out.append((name, str(h.dtype), h.shape, data))
    return out


def _oneshot_columns(pkg, svc, paths, columns=None):
    out = {}
    res = svc.scan(pkg.Request(paths, columns=columns), timeout=60)
    for p in paths:
        for name, cd in res[p].items():
            parts = cd if isinstance(cd, list) else [cd]
            for part in parts:
                vals = part.values
                if hasattr(vals, "heap"):
                    out.setdefault(name, []).extend(vals.to_list())
                else:
                    out.setdefault(name, []).extend(np.asarray(vals))
    return {n: np.asarray(v, dtype=object if isinstance(v[0], bytes)
                          else None) for n, v in out.items()}


def _drain(session):
    cols, batches = {}, []
    for batch in session:
        batches.append(_batch(batch))
        mask = _host(batch["mask"])
        for name, arr in batch.items():
            if name != "mask":
                cols.setdefault(name, []).append(_host(arr)[mask])
    return {n: np.concatenate(v) for n, v in cols.items()}, batches


# ---------------------------------------------------------------------------
# bit-identity: streamed == one-shot, host and device (reference :84, :99)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
def test_stream_matches_oneshot_host(files, prefetch):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            want = _oneshot_columns(pkg, svc, files)
            session = svc.scan(pkg.Request(files, stream=True,
                                           batch_rows=128,
                                           prefetch=prefetch), timeout=60)
            assert isinstance(session, pkg.sv.StreamingScan)
            got, batches = _drain(session)
            assert len(batches) == 20
            for name in ("a", "s"):
                assert np.array_equal(got[name], want[name]), name
            assert session.rows_emitted == 2400
            out[pkg.name] = (batches, session.cold_groups,
                             session.warm_batches)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_stream_matches_oneshot_device(files, prefetch):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            want = _oneshot_columns(pkg, svc, files, columns=["a"])
            session = svc.scan(pkg.Request(files, columns=["a"], stream=True,
                                           batch_rows=256, device=True,
                                           prefetch=prefetch), timeout=60)
            got, batches = [], []
            for batch in session:
                assert type(batch["a"]).__name__ != "ndarray"  # shipped
                if pkg is PORT:
                    assert all(isinstance(t, torch.Tensor)
                               and t.device == svc.device
                               for t in batch.values())
                    assert batch["mask"].dtype == torch.bool
                arr = _host(batch["a"])
                assert arr.shape == (256,)
                got.append(arr[_host(batch["mask"])])
                batches.append(_batch(batch))
            got = np.concatenate(got)
            assert got.dtype == np.int64
            assert np.array_equal(got, want["a"])
            out[pkg.name] = batches
    assert out["port"] == out["ref"]


def test_device_stream_refuses_object_columns(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            session = svc.scan(pkg.Request([files[0]], stream=True,
                                           batch_rows=100, device=True),
                               timeout=60)
            err = outcome(lambda s=session: list(s))
        assert err[0] == "ParquetError" and "device-shippable" in err[1]
        # the message's tail is the shipping library's own TypeError text
        out[pkg.name] = err[1].split(" (object-dtype column?)")[0]
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# cursors: save, resume, identical suffix, in both packages (reference :132)
# ---------------------------------------------------------------------------

def test_cursor_resume_bit_identical(files):
    out, blobs = {}, {}
    for pkg in BOTH:
        with pkg.Service(concurrency=2) as svc:
            ref = svc.scan(pkg.Request(files, stream=True, batch_rows=128),
                           timeout=60)
            ref_batches = [_batch(b) for b in ref]
            s1 = svc.scan(pkg.Request(files, stream=True, batch_rows=128),
                          timeout=60)
            taken = [_batch(next(s1)) for _ in range(5)]
            blob = s1.cursor()
            s1.close()
            assert isinstance(blob, bytes) and blob[:4] == b"TPQS"
            s2 = svc.scan(pkg.Request(files, stream=True, batch_rows=128,
                                      cursor=blob), timeout=60)
            rest = [_batch(b) for b in s2]
            assert taken + rest == ref_batches
            end = s2.cursor()
            done = svc.scan(pkg.Request(files, stream=True, batch_rows=128,
                                        cursor=end), timeout=60)
            assert list(done) == []
        out[pkg.name] = ref_batches
        blobs[pkg.name] = (blob, end)
    assert out["port"] == out["ref"]
    assert blobs["port"] == blobs["ref"]


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
def test_cursor_resumes_across_packages(files, device):
    """A cursor taken in one package resumes in the other: the remaining
    batches are the uninterrupted stream's, bit for bit."""
    cols = ["a"] if device else None
    full, mid = {}, {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            req = dict(columns=cols, stream=True, batch_rows=128,
                       device=device)
            full[pkg.name] = [_batch(b) for b in svc.scan(
                pkg.Request(files, **req), timeout=60)]
            s = svc.scan(pkg.Request(files, **req), timeout=60)
            for _ in range(7):
                next(s)
            mid[pkg.name] = s.cursor()
            s.close()
    assert full["port"] == full["ref"]
    assert mid["port"] == mid["ref"]
    for pkg, other in ((PORT, REF), (REF, PORT)):
        with pkg.Service(concurrency=1) as svc:
            rest = [_batch(b) for b in svc.scan(pkg.Request(
                files, columns=cols, stream=True, batch_rows=128,
                device=device, cursor=mid[other.name]), timeout=60)]
        assert rest == full[pkg.name][7:]


def test_cursor_rejects_hostile_blobs(files):
    out = {}
    for pkg in BOTH:
        E = pkg.E
        with pkg.Service(concurrency=1) as svc:
            s = svc.scan(pkg.Request(files, stream=True, batch_rows=128),
                         timeout=60)
            next(s)
            blob = s.cursor()
            s.close()
            state = pkg.sv.unpack_cursor(blob)
            errs = []
            for bad in (blob[:10], b"NOPE" + blob[4:],
                        blob[:4] + (99).to_bytes(2, "big") + blob[6:],
                        blob[:6] + b"{", "not bytes"):
                errs.append(outcome(lambda b=bad: pkg.sv.unpack_cursor(b),
                                    collect=False))
            lying = dict(state, rows_done=state["rows_done"] + 7)
            errs.append(outcome(lambda: pkg.sv.pack_cursor(lying),
                                collect=False))
            errs.append(outcome(lambda: pkg.sv.pack_cursor(
                dict(state, device=1)), collect=False))
            errs.append(outcome(lambda: svc.scan(pkg.Request(
                files, stream=True, batch_rows=64, cursor=blob),
                timeout=60)))
            errs.append(outcome(lambda: svc.scan(pkg.Request(
                files, columns=["a"], stream=True, batch_rows=128,
                cursor=blob), timeout=60)))
            assert all(e[0] == "CheckpointError" for e in errs), errs
            assert "batch_rows" in errs[-2][1]
            assert "request_digest" in errs[-1][1]
            assert issubclass(E.CheckpointError, E.ParquetError)
            pkg.sv.check_cursor_compatible(state, {
                "batch_rows": 128, "device": False, "n_paths": len(files),
                "request_digest": pkg.sv.request_digest(
                    pkg.Request(files, stream=True, batch_rows=128))})
            out[pkg.name] = (state, errs, counts(svc.serve_stats()))
    assert out["port"] == out["ref"]


def test_request_digest_is_the_references(files):
    from tpu_parquet import predicate as RP
    from tpu_parquet_torch import predicate as P

    shapes = [dict(), dict(columns=["a"]), dict(filter="a > 0"),
              dict(device=True, batch_rows=7), dict(columns=["s", "a"])]
    for kw in shapes:
        assert (PORT.sv.request_digest(PORT.Request(files, **kw))
                == REF.sv.request_digest(REF.Request(files, **kw))), kw
    assert (PORT.sv.request_digest(PORT.Request(
        files, filter=P.col("a") > 5))
        == REF.sv.request_digest(REF.Request(files,
                                             filter=RP.col("a") > 5)))


# ---------------------------------------------------------------------------
# the warm path: a fully cached stream reads nothing (reference :191)
# ---------------------------------------------------------------------------

def test_warm_stream_zero_store_reads(files):
    out = {}
    for pkg in BOTH:
        opens, reads = [], []

        def factory(path, pkg=pkg, opens=opens, reads=reads):
            store = pkg.S.LocalStore(path)
            opens.append(path)
            orig = store.read_range

            def counting_read(offset, size, **kw):
                reads.append((offset, size))
                return orig(offset, size, **kw)

            store.read_range = counting_read
            return store

        with pkg.Service(concurrency=1, store=factory,
                         result_cache_mb=64) as svc:
            cold, cold_b = _drain(svc.scan(pkg.Request(
                [files[0]], stream=True, batch_rows=100), timeout=60))
            assert opens and reads
            o0, r0 = len(opens), len(reads)
            warm_session = svc.scan(pkg.Request([files[0]], stream=True,
                                                batch_rows=100), timeout=60)
            warm, warm_b = _drain(warm_session)
            assert len(opens) == o0 and len(reads) == r0
            assert warm_session.warm_batches == len(warm_b)
            assert warm_session.cold_groups == 0
            assert warm_b == cold_b
            out[pkg.name] = (cold_b, o0, r0, warm_session.warm_groups,
                             svc.cache.results.counters()["host"])
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# lifecycle: close, cancel and deadline reach a blocked consumer
# (reference :228, :258, :287)
# ---------------------------------------------------------------------------

def test_close_drains_blocked_consumer(files):
    out = {}
    for pkg in BOTH:
        before = {t.name for t in threading.enumerate()
                  if t.name.startswith("tpq-serve")}
        svc = pkg.Service(concurrency=1)
        session = svc.scan(pkg.Request(files, stream=True, batch_rows=128),
                           timeout=60)
        got, errs = [], []

        def consume(session=session, got=got, errs=errs, pkg=pkg):
            try:
                for batch in session:
                    got.append(batch)
                    time.sleep(0.2)
            except pkg.E.CancelledError as e:
                errs.append((type(e).__name__, str(e)))

        t = threading.Thread(target=consume)
        t.start()
        time.sleep(0.3)
        svc.close()
        t.join(timeout=10)
        assert not t.is_alive()
        assert errs and "closed" in errs[0][1]
        time.sleep(0.05)
        after = {t.name for t in threading.enumerate()
                 if t.name.startswith("tpq-serve")}
        assert after <= before
        assert svc._budget.held == 0
        out[pkg.name] = errs[0]
    assert out["port"] == out["ref"]


def _reconciled(svc) -> dict:
    deadline = time.time() + 5
    while time.time() < deadline:
        st = svc.serve_stats()
        if st["submitted"] == st["completed"] + st["failed"]:
            break
        time.sleep(0.01)
    return st


def test_session_cancel_and_deadline(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            s = svc.scan(pkg.Request(files, stream=True, batch_rows=128),
                         timeout=60)
            next(s)
            s.cancel()
            cancel = outcome(lambda s=s: list(s))
            st = _reconciled(svc)
            assert st["submitted"] == st["completed"] + st["failed"]
            assert svc._budget.held == 0

        def expire(svc, pkg):
            s = svc.scan(pkg.Request(files, stream=True, batch_rows=64,
                                     deadline_s=0.001), timeout=60)
            while True:
                next(s)

        with pkg.Service(concurrency=1) as svc:
            deadline = outcome(lambda svc=svc, pkg=pkg: expire(svc, pkg))
            st2 = _reconciled(svc)
        assert cancel[0] == "CancelledError"
        assert deadline[0] == "DeadlineExceededError"
        out[pkg.name] = (cancel, deadline, st["cancelled"], st["failed"],
                         st2["deadline_exceeded"], st2["failed"])
    assert out["port"] == out["ref"]


def test_stream_registry_accounting(files):
    out = {}
    for pkg in BOTH:
        with pkg.Service(concurrency=1) as svc:
            session = svc.scan(pkg.Request([files[0]], stream=True,
                                           batch_rows=200), timeout=60)
            n = len(list(session))
            sv = svc.obs_registry().as_dict()["serve"]
        assert sv["stream_sessions"] == 1
        assert sv["stream_batches"] == n == 6
        assert sv["submitted"] == sv["completed"] == 1
        out[pkg.name] = counts(sv)
    assert out["port"] == out["ref"]


# ---------------------------------------------------------------------------
# the port's batch accounting
# ---------------------------------------------------------------------------

def test_batch_nbytes_of_a_shipped_batch_is_the_host_batch():
    from tpu_parquet.serve import stream as RST

    rng = np.random.default_rng(0)
    cols = {"i64": rng.integers(0, 1 << 40, 100),
            "f32": rng.random(100).astype(np.float32),
            "i32": rng.integers(0, 1 << 20, 100).astype(np.int32)}
    host = pad_and_mask(cols, 100, 128, mask_key="mask")
    shipped = ship_to_device(host, "cpu")
    assert host["mask"].nbytes == shipped["mask"].nbytes == 128
    assert ST._batch_nbytes(shipped) == ST._batch_nbytes(host) \
        == RST._batch_nbytes(host) == 128 * (8 + 4 + 4 + 1)
    # object columns (host streams of strings) count their payload
    strs = {"s": np.array([b"alpha", b"", b"gamma"], dtype=object)}
    sb = pad_and_mask(strs, 3, 4, mask_key="mask")
    assert ST._batch_nbytes(sb) == RST._batch_nbytes(sb)
    assert ST._batch_nbytes(sb) == sb["s"].nbytes + 10 + 4
    assert ST._batch_nbytes({}) == RST._batch_nbytes({}) == 1
    # and one cannot ship: the TypeError the stream turns into its
    # ParquetError
    with pytest.raises(TypeError):
        ship_to_device(sb, "cpu")


def test_column_rows_is_the_references():
    from tpu_parquet.column import ByteArrayData as RBA
    from tpu_parquet.column import ColumnData as RCD
    from tpu_parquet.serve import stream as RST
    from tpu_parquet_torch.column import ColumnData

    vals = [b"x", b"yy", b""]
    port = ST._column_rows(ColumnData(
        values=ByteArrayData.from_list(vals)), "s")
    ref = RST._column_rows(RCD(values=RBA.from_list(vals)), "s")
    assert port.dtype == ref.dtype == object
    assert port.tolist() == ref.tolist() == vals
    for mod, cd in ((ST, ColumnData), (RST, RCD)):
        with pytest.raises(Exception) as ei:
            mod._column_rows(cd(values=np.arange(3),
                                def_levels=np.ones(2, np.int16)), "n")
        assert "has nulls" in str(ei.value)
