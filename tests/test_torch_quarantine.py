"""The port's data-error containment against the JAX package's.

``tpu_parquet_torch.quarantine`` is a copy of ``tpu_parquet.quarantine``
(the policy engine, the error budget, the ledger, ``corrupt_bytes``), and
both port readers and ``scan_files`` contain data errors as the
reference's do.  Files corrupted by each of ``corrupt_bytes``' modes (SNAPPY
with page CRCs, and GZIP without them so decompression catches the damage),
plus a dictionary index past its dictionary, are read through both
packages' ``FileReader``, ``DeviceFileReader`` (the port with
``device="cpu"``, the reference under ``TPQ_PALLAS=1 TPQ_FUSE=1``) and
``scan_files``, under each policy, at ``prefetch`` 0 and 4.  Compared
exactly: the quarantine records, ``units_skipped``, ``rows_skipped``,
``files_skipped``, ``by_class``, the surviving units' outputs, the error
class and text under ``raise``, and the budget's ``DataIntegrityError``.
Also: ``TPQ_ON_DATA_ERROR`` / ``TPQ_DATA_ERROR_BUDGET`` / ``TPQ_VALIDATE``
resolution and the one-time warning, no pool thread outliving a test, the
device ledger back to zero after a contained scan, and a stager whose
strips were in flight when its row group failed.
"""

import gc
import logging
import shutil
import threading
import uuid

import numpy as np
import pytest
import torch

from tests.test_torch_host_decode import _corrupt_index_page, _tpq_dict_file
from tests.test_torch_pruning import _host
from tpu_parquet import device_reader as RDR
from tpu_parquet import quarantine as RQ
from tpu_parquet.errors import DataIntegrityError as RefDataIntegrityError
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet.writer import corrupt_page as ref_corrupt_page
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import quarantine as Q
from tpu_parquet_torch.errors import DataIntegrityError, ParquetError
from tpu_parquet_torch.format import (CompressionCodec,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter, corrupt_page
from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes, reference_env_warnings):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process), and so
    do the once-per-value env warnings it spent."""
    yield


N_GROUPS, ROWS = 5, 400
POLICIES = ["raise", "skip_unit", "skip_file"]
DEPTHS = [0, 4]


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
    gc.collect()
    assert not [t for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


@pytest.fixture(autouse=True)
def reference_env(monkeypatch):
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in ("TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS",
                 "TPQ_ON_DATA_ERROR", "TPQ_DATA_ERROR_BUDGET",
                 "TPQ_QUARANTINE_LOG", "TPQ_VALIDATE"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _write(path, crc=True):
    """Five groups of two columns: SNAPPY with page CRCs, or GZIP without
    them (the deflate stream's own checks then catch the damage)."""
    rng = np.random.default_rng(0)
    schema = build_schema([data_column("a", Type.INT64, FRT.REQUIRED),
                           data_column("b", Type.INT32, FRT.REQUIRED)])
    codec = CompressionCodec.SNAPPY if crc else CompressionCodec.GZIP
    with FileWriter(path, schema, codec=codec, write_crc=crc,
                    use_dictionary=False) as w:
        for _ in range(N_GROUPS):
            w.write_columns({
                "a": rng.integers(0, 1 << 50, ROWS),
                "b": rng.integers(0, 1 << 20, ROWS).astype(np.int32)})
            w.flush_row_group()
    return path


CASES = ["bitflip", "zero", "truncate", "bitflip_nocrc", "zero_nocrc",
         "truncate_nocrc", "dict_index"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{case: (clean path, corrupted path, corrupted groups)}."""
    root = tmp_path_factory.mktemp("torch_quarantine")
    out = {}
    clean = {True: _write(str(root / "clean.parquet")),
             False: _write(str(root / "clean_nocrc.parquet"), crc=False)}
    for case in CASES[:6]:
        mode, _, nocrc = case.partition("_")
        src = clean[not nocrc]
        dst = str(root / f"{case}.parquet")
        ref = str(root / f"{case}.ref.parquet")
        for path, fn in ((dst, corrupt_page), (ref, ref_corrupt_page)):
            shutil.copyfile(src, path)
            for gi in (2, 3):
                fn(path, row_group=gi, column=0, page=0, mode=mode, seed=gi)
        with open(dst, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()  # the same corruption, byte for byte
        out[case] = (src, dst, (2, 3))
    dclean = str(root / "dict_clean.parquet")
    _tpq_dict_file(dclean, codec=CompressionCodec.UNCOMPRESSED, crc=False)
    dbad = str(root / "dict_bad.parquet")
    shutil.copyfile(dclean, dbad)
    _corrupt_index_page(dbad, 1, "k", 0)
    out["dict_index"] = (dclean, dbad, (1,))
    return out


def _values(group):
    """Host view of one row group's output, either package, either
    reader (host ``ColumnData`` or device columns)."""
    out = {}
    for name, c in group.items():
        if hasattr(c, "to_host"):
            cls, v, lv = _host(c)
            out[name] = (tuple(np.asarray(x).view(np.uint8).tobytes()
                               for x in v),
                         tuple(None if x is None else np.asarray(x).tobytes()
                               for x in lv))
        else:
            out[name] = (np.asarray(c.values).view(np.uint8).tobytes(),
                         None if c.def_levels is None
                         else np.asarray(c.def_levels).tobytes())
    return out


def _run(fn):
    """(outputs, engine, error) of one read; the traceback is dropped so a
    suspended pipeline does not outlive the test."""
    try:
        outs, q = fn()
        return outs, q, None
    except ParquetError as e:
        err = (type(e).__name__, str(e), list(getattr(e, "records", [])))
    except Exception as e:  # the reference's ParquetError  # noqa: BLE001
        err = (type(e).__name__, str(e), list(getattr(e, "records", [])))
    gc.collect()
    return None, None, err


def _host_read(Reader, path, policy, k, quarantine=None):
    def fn():
        with Reader(path, prefetch=k, on_data_error=policy,
                    quarantine=quarantine) as r:
            return [_values(g) for g in r.iter_row_groups()], r.quarantine
    return fn


def _device_read(mod, path, policy, k, quarantine=None):
    kw = {"device": "cpu"} if mod is DR else {}

    def fn():
        with mod.DeviceFileReader(path, prefetch=k, on_data_error=policy,
                                  quarantine=quarantine, **kw) as r:
            outs = [_values(g) for g in r.iter_row_groups()]
            if mod is DR:
                assert r.alloc.device_snapshot()[0] == 0
            return outs, r.quarantine
    return fn


def _scan_read(mod, paths, policy, k, QM):
    kw = {"device": "cpu"} if mod is DR else {}

    def fn():
        q = QM.Quarantine(policy)
        outs = [(p, _values(g)) for p, g in mod.scan_files(
            paths, prefetch=k, with_path=True, quarantine=q, **kw)]
        return outs, q
    return fn


def _same_engine(got, want):
    assert got.log.snapshot() == want.log.snapshot()
    for key in ("units_skipped", "rows_skipped", "files_skipped"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.as_dict() == want.as_dict()


def _compare(got, want, policy):
    g_outs, g_q, g_err = got
    w_outs, w_q, w_err = want
    assert g_err == w_err
    if w_err is not None:
        assert policy == "raise"
        return
    assert g_outs == w_outs
    _same_engine(g_q, w_q)


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", CASES)
def test_host_reader_contains_as_the_reference(files, case, policy, k):
    _clean, bad, groups = files[case]
    want = _run(_host_read(RefReader, bad, policy, k))
    got = _run(_host_read(FileReader, bad, policy, k))
    _compare(got, want, policy)
    if policy != "raise":
        recs = got[1].log.snapshot()
        assert len(recs) == (1 if policy == "skip_file" else len(groups))
        assert recs[0]["row_group"] == groups[0]


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", CASES)
def test_device_reader_contains_as_the_reference(files, case, policy, k):
    clean, bad, groups = files[case]
    want = _run(_device_read(RDR, bad, policy, k))
    got = _run(_device_read(DR, bad, policy, k))
    _compare(got, want, policy)
    if policy == "raise":
        assert isinstance(got[2], tuple)  # raised, with the reference's text
        return
    # the surviving units are the clean file's
    clean_outs, _, _ = _run(_device_read(DR, clean, policy, k))
    kept = [g for g in range(len(clean_outs))
            if g not in groups and (policy == "skip_unit" or g < groups[0])]
    assert got[0] == [clean_outs[g] for g in kept]


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("case", ["bitflip", "truncate_nocrc", "dict_index"])
def test_scan_files_shares_one_engine(files, case, policy, k):
    clean, bad, _groups = files[case]
    paths = [bad, clean]
    want = _run(_scan_read(RDR, paths, policy, k, RQ))
    got = _run(_scan_read(DR, paths, policy, k, Q))
    _compare(got, want, policy)
    if policy == "skip_file":
        assert got[1].files_skipped == 1 and len(got[1].log) == 1
        assert sum(p == clean for p, _ in got[0]) == len(
            [1 for p, _ in want[0] if p == clean]) > 0


@pytest.mark.parametrize("k", DEPTHS)
def test_scan_files_on_data_error_kwarg(files, k):
    clean, bad, _ = files["zero"]
    ref = [p for p, _ in RDR.scan_files([bad, clean], prefetch=k,
                                        with_path=True,
                                        on_data_error="skip_unit")]
    got = [p for p, _ in DR.scan_files([bad, clean], prefetch=k,
                                       with_path=True, device="cpu",
                                       on_data_error="skip_unit")]
    assert got == ref and len(got) == 2 * N_GROUPS - 2


@pytest.mark.parametrize("api", ["host", "device", "scan"])
@pytest.mark.parametrize("k", DEPTHS)
def test_budget_exhaustion_raises_the_reference_error(files, api, k):
    _clean, bad, _ = files["bitflip"]

    def budget(M):
        return M.Quarantine("skip_unit", budget=M.ErrorBudget(1, 1.0))

    if api == "host":
        w = _run(_host_read(RefReader, bad, None, k, budget(RQ)))
        g = _run(_host_read(FileReader, bad, None, k, budget(Q)))
    elif api == "device":
        w = _run(_device_read(RDR, bad, None, k, budget(RQ)))
        g = _run(_device_read(DR, bad, None, k, budget(Q)))
    else:
        def scan(mod, M):
            def fn():
                kw = {"device": "cpu"} if mod is DR else {}
                return list(mod.scan_files([bad], prefetch=k,
                                           quarantine=budget(M), **kw)), None
            return fn
        w, g = _run(scan(RDR, RQ)), _run(scan(DR, Q))
    assert w[2] is not None and w[2][0] == "DataIntegrityError"
    assert g[2] == w[2]
    assert [r["row_group"] for r in g[2][2]] == [2, 3]


def test_explicit_read_row_group_always_raises(files):
    _clean, bad, _ = files["bitflip"]
    for k in DEPTHS:
        with FileReader(bad, on_data_error="skip_unit", prefetch=k) as r:
            assert len(r.read_row_group(1)["a"].values) == ROWS
            with pytest.raises(ParquetError, match="row_group=2"):
                r.read_row_group(2)
        with DR.DeviceFileReader(bad, on_data_error="skip_unit", prefetch=k,
                                 device="cpu") as r:
            with pytest.raises(ParquetError, match="row_group=2"):
                r.read_row_group(2)


def test_a_failed_group_joins_its_streamed_strips(files, monkeypatch):
    """The corrupt chunk is the group's LAST: the earlier chunk's strips
    are already on the staging worker when the group fails."""
    clean, _, _ = files["bitflip"]
    monkeypatch.setattr(DR._RowGroupStager, "STRIP", 1024)
    joined = []
    real = DR._RowGroupStager.abandon

    def spy(self):
        joined.append(len(self._strip_futs))
        real(self)

    monkeypatch.setattr(DR._RowGroupStager, "abandon", spy)
    bad = clean.replace("clean.parquet", "last_col.parquet")
    shutil.copyfile(clean, bad)
    corrupt_page(bad, row_group=2, column="b", page=0, seed=4)
    want = _run(_device_read(RDR, bad, "skip_unit", 0))
    got = _run(_device_read(DR, bad, "skip_unit", 0))
    _compare(got, want, "skip_unit")
    assert joined and joined[0] > 0


def test_policy_resolution_matches_the_reference(monkeypatch, caplog):
    for v in Q.POLICIES:
        assert Q.resolve_policy(v) == RQ.resolve_policy(v) == v
        monkeypatch.setenv("TPQ_ON_DATA_ERROR", v)
        assert Q.resolve_policy() == RQ.resolve_policy() == v
    with pytest.raises(ValueError) as got:
        Q.resolve_policy("skip_all")
    with pytest.raises(ValueError) as want:
        RQ.resolve_policy("skip_all")
    assert str(got.value) == str(want.value)
    bad = f"skip-{uuid.uuid4().hex[:8]}"
    monkeypatch.setenv("TPQ_ON_DATA_ERROR", bad)
    texts = []
    for M in (Q, RQ):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert M.resolve_policy() == "raise"
            assert M.resolve_policy() == "raise"  # warned once
        texts.append([r.getMessage() for r in caplog.records])
    assert texts[0] == texts[1] and len(texts[0]) == 1
    monkeypatch.delenv("TPQ_ON_DATA_ERROR")
    assert Q.Quarantine().policy == "raise"


@pytest.mark.parametrize("raw", ["", "3", "3,0.25", "7:1", "x", "-1",
                                 "2,1.5"])
def test_budget_env_matches_the_reference(monkeypatch, raw):
    monkeypatch.setenv("TPQ_DATA_ERROR_BUDGET", raw)
    got, want = Q.ErrorBudget.from_env(), RQ.ErrorBudget.from_env()
    assert (got.max_errors, got.max_fraction) == (want.max_errors,
                                                  want.max_fraction)
    for total in (None, 0, 1, 3, 100):
        assert got.allowed(total) == want.allowed(total)


@pytest.mark.parametrize("raw", [None, "crc", "on", "off", "0", "none",
                                 "TRUE", "bogus"])
def test_validate_resolution_matches_the_reference(monkeypatch, raw):
    if raw is not None:
        monkeypatch.setenv("TPQ_VALIDATE", raw)
    assert Q.resolve_validate() == RQ.resolve_validate()
    for kw in (True, False, "crc", "off", "on"):
        assert Q.resolve_validate(kw) == RQ.resolve_validate(kw)
    with pytest.raises(ValueError):
        Q.resolve_validate("maybe")


def test_corrupt_bytes_and_summary_match_the_reference():
    rng = np.random.default_rng(3)
    for n in (0, 1, 100, 5000):
        data = rng.integers(0, 256, n).astype(np.uint8).tobytes()
        for mode in Q.CORRUPT_MODES:
            for seed in (0, 7, 1 << 40):
                got = Q.corrupt_bytes(data, mode, seed)
                assert got == RQ.corrupt_bytes(data, mode, seed)
                assert len(got) == n
    with pytest.raises(ValueError):
        Q.corrupt_bytes(b"x", "nuke")
    recs = [{"file": "f1", "column": "a", "error": "ParquetError"},
            {"file": "f2", "column": "a", "error": "RLEError"},
            {"file": "f1", "error": "ParquetError"}, "junk"]
    assert (Q.summarize_quarantine_log(recs)
            == RQ.summarize_quarantine_log(recs))


def test_ledger_jsonl_and_annotation(tmp_path):
    log = str(tmp_path / "q" / "log.jsonl")
    q = Q.Quarantine("skip_unit", log_path=log)
    e = Q.annotate_data_error(ParquetError("bad page"), file="f",
                              column="a", row_group=1, page=0)
    rec = q.note(e)
    with open(log) as f:
        assert f.read().count("\n") == 1
    rq = RQ.Quarantine("skip_unit")
    from tpu_parquet.errors import ParquetError as RefParquetError

    re_ = RQ.annotate_data_error(RefParquetError("bad page"), file="f",
                                 column="a", row_group=1, page=0)
    assert rec == rq.note(re_)
    assert Q.error_context is DR.error_context  # one copy, re-exported
    with pytest.raises(DataIntegrityError) as got:
        Q.Quarantine("skip_unit", budget=Q.ErrorBudget(0, 1.0)).note(e)
    with pytest.raises(RefDataIntegrityError) as want:
        RQ.Quarantine("skip_unit", budget=RQ.ErrorBudget(0, 1.0)).note(re_)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("k", DEPTHS)
@pytest.mark.parametrize("exc", [RuntimeError("CUDA error: an illegal "
                                              "memory access"),
                                 ValueError("fused plain: bad geometry")])
def test_a_kernel_failure_is_never_contained(files, monkeypatch, k, exc):
    """Only ``ParquetError`` is a data error: a launch failure or a CUDA
    error in a row group's host phase ends the scan under every policy."""
    clean, _, _ = files["bitflip"]
    real = DR._ChunkAssembler.finish

    def finish(self, stager):
        if len(self.pages) and self.leaf.path == ("b",):
            raise exc
        return real(self, stager)

    monkeypatch.setattr(DR._ChunkAssembler, "finish", finish)
    for policy in ("skip_unit", "skip_file"):
        with pytest.raises(type(exc)) as got:
            with DR.DeviceFileReader(clean, on_data_error=policy, prefetch=k,
                                     device="cpu") as r:
                list(r.iter_row_groups())
        assert got.value is exc and len(r.quarantine.log) == 0
        with pytest.raises(type(exc)):
            list(DR.scan_files([clean], on_data_error=policy, prefetch=k,
                               device="cpu"))


@pytest.mark.parametrize("k", DEPTHS)
def test_a_deferred_range_check_is_not_contained(files, monkeypatch, k):
    """Without the native run walk the dictionary-index range check waits
    for the device and runs after the last yield, outside any unit: it
    raises under a skip policy, in both packages, with one text."""
    from tpu_parquet import native as ref_native
    from tpu_parquet_torch import native

    monkeypatch.setattr(native, "hybrid_meta", lambda *a, **kw: None)
    monkeypatch.setattr(ref_native, "hybrid_meta", lambda *a, **kw: None)
    _clean, bad, _ = files["dict_index"]
    want = _run(_scan_read(RDR, [bad], "skip_unit", k, RQ))
    got = _run(_scan_read(DR, [bad], "skip_unit", k, Q))
    assert got[2] == want[2] and "out of range" in want[2][1]
