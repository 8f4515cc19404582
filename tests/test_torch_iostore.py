"""The port's byte stores (``tpu_parquet_torch.iostore``) against the JAX
package's, case for case with ``tests/test_iostore.py``.

The same file (written by the port's writer from a numpy seed), the same
``FaultSpec``, the same ``IOConfig`` and the same seed go through both
packages' host ``FileReader`` (and ``scan_files``, the port's on
``device="cpu"``, the reference's under ``TPQ_PALLAS=1 TPQ_FUSE=1``).
Compared exactly: the decoded rows, every ``IOStats`` counter but
``backoff_seconds`` (jittered sleeps drawn in thread order), the error
class, text and attempt log of an exhausted read, and the coalescing plan.
Backoffs are 1 ms (``IOConfig(backoff_ms=1)``), as in the reference's
tests, so nothing sleeps for long.

Left out of the reference's cases: the watchdog's stall tests (the
watchdog is not ported yet) and the registry's ``io`` section (the
registry neither); the stores' own counters stand in for the latter.
"""

import gc
import io
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from tpu_parquet import iostore as RS
from tpu_parquet import device_reader as RDR
from tpu_parquet.iostore_async import (
    shutdown_default_engine as ref_shutdown_default_engine)
from tpu_parquet.reader import FileReader as RefReader
from tpu_parquet_torch import device_reader as DR
from tpu_parquet_torch import iostore as S
from tpu_parquet_torch.errors import (ParquetError, RetryExhaustedError,
                                      TransientIOError)
from tpu_parquet_torch.format import (CompressionCodec,
                                      FieldRepetitionType as FRT, Type)
from tpu_parquet_torch.iostore import (CoalescedFetcher, FaultInjectingStore,
                                       FaultSpec, GenericRangeStore,
                                       IOConfig, LocalStore, plan_coalesced,
                                       require_full, resolve_store)
from tpu_parquet_torch.iostore_async import shutdown_default_engine
from tpu_parquet_torch.reader import FileReader
from tpu_parquet_torch.schema.core import build_schema, data_column
from tpu_parquet_torch.writer import FileWriter
from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)

ensure_reference_native()


@pytest.fixture(autouse=True)
def _drop_reference_crashes(no_reference_crashes, reference_env_warnings):
    """The reference half's ``worker_crash`` events leave with the test
    (``tests/test_autopsy.py`` reads the last one of the process), and so
    do the once-per-value env warnings it spent."""
    yield


IO_ENV = ("TPQ_IO_ASYNC", "TPQ_IO_INFLIGHT", "TPQ_IO_DEADLINE_S",
          "TPQ_IO_RETRIES", "TPQ_IO_BACKOFF_MS", "TPQ_IO_RETRY_BUDGET",
          "TPQ_IO_COALESCE_GAP", "TPQ_IO_HEDGE_MS", "TPQ_IO_HEDGE_MAX",
          "TPQ_FORCE_ROUTE", "TPQ_LINK_MBPS", "TPQ_DEVICE_MBPS",
          "TPQ_ON_DATA_ERROR", "TPQ_VALIDATE")


def _write_file(path, groups=3, rows=400, seed=0):
    """``tests/test_iostore.py``'s file: two REQUIRED INT64 columns,
    SNAPPY, ``groups`` row groups."""
    schema = build_schema([data_column("a", Type.INT64, FRT.REQUIRED),
                           data_column("b", Type.INT64, FRT.REQUIRED)])
    rng = np.random.default_rng(seed)
    with FileWriter(path, schema, codec=CompressionCodec.SNAPPY) as w:
        for _ in range(groups):
            w.write_columns({"a": rng.integers(0, 1 << 30, rows),
                             "b": rng.integers(0, 1 << 30, rows)})
            w.flush_row_group()
    return path


@pytest.fixture(autouse=True)
def io_env(monkeypatch):
    """The reference's Pallas kernels in interpret mode, no IO knob set,
    both packages' default fetch engines stopped around the test, and no
    ``tpq-`` thread a test started alive after it."""
    monkeypatch.setenv("TPQ_PALLAS", "1")
    monkeypatch.setenv("TPQ_FUSE", "1")
    for name in IO_ENV:
        monkeypatch.delenv(name, raising=False)
    before = set(threading.enumerate())
    shutdown_default_engine()
    ref_shutdown_default_engine()
    yield monkeypatch
    shutdown_default_engine()
    ref_shutdown_default_engine()
    gc.collect()
    assert not [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


@pytest.fixture(scope="module")
def pq_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_iostore") / "faulty.parquet")
    _write_file(path)
    with FileReader(path) as r:
        base = r.read_pylist()
    return path, base


def _cfg(M=S, **kw):
    kw.setdefault("retries", 4)
    kw.setdefault("backoff_ms", 1.0)
    return M.IOConfig(**kw)


def _fault_factory(spec, config=None, stores=None, seed=0, M=S):
    """A ``store=`` factory over ``M``'s ``FaultInjectingStore``; ``spec``
    and ``config`` are keyword dicts, so one call site makes both
    packages' stores."""
    def make(f):
        st = M.FaultInjectingStore(M.LocalStore(f), M.FaultSpec(**spec),
                                   config=_cfg(M, **(config or {})),
                                   seed=seed)
        if stores is not None:
            stores.append(st)
        return st

    return make


def _io(stores):
    """Every store's counters summed, less ``backoff_seconds`` (jittered
    sleeps drawn in thread order)."""
    out: dict = {}
    for st in stores:
        for k, v in st.stats.as_dict().items():
            if k != "backoff_seconds":
                out[k] = out.get(k, 0) + v
    return out


def _error(fn):
    """(class, text, attempt errors, offset, size) of what ``fn`` raised."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — either package's error
        return (type(e).__name__, str(e),
                [a["error"] for a in getattr(e, "attempts", [])],
                getattr(e, "offset", None), getattr(e, "size", None))
    raise AssertionError("no error raised")


def _both(path, spec, k, config=None, **kw):
    """Read ``path`` through both packages' host readers over the same
    faults: ((port rows, port counters), (reference rows, counters))."""
    out = []
    for M, Reader in ((S, FileReader), (RS, RefReader)):
        stores = []
        with Reader(path, prefetch=k,
                    store=_fault_factory(spec, config, stores, M=M),
                    **kw) as r:
            rows = r.read_pylist()
        out.append((rows, _io(stores)))
    return out


# ---------------------------------------------------------------------------
# the fault matrix: recoverable faults are invisible in the output
# ---------------------------------------------------------------------------

RECOVERABLE = {
    "latency_spike": {"latency_s": 0.005},
    "transient_errors": {"fail_first": 2},
    "torn_read": {"torn_first": 1},
    "torn_then_error": {"torn_first": 1, "fail_first": 2},
}


@pytest.mark.parametrize("prefetch", [0, 4])
@pytest.mark.parametrize("fault", sorted(RECOVERABLE))
def test_fault_matrix_recovers_bit_identical(pq_file, fault, prefetch):
    path, base = pq_file
    (rows, d), (ref_rows, ref_d) = _both(path, RECOVERABLE[fault], prefetch)
    assert rows == ref_rows == base
    assert d == ref_d
    assert d["exhausted"] == 0
    if "transient" in fault or "error" in fault:
        assert d["retries"] > 0 and d["transient_errors"] > 0
    if fault.startswith("torn"):
        assert d["short_reads"] > 0


@pytest.mark.parametrize("prefetch", [0, 4])
def test_retries_exhausted_raises_with_attempt_log(pq_file, prefetch):
    path, _base = pq_file
    errs = []
    for M, Reader in ((S, FileReader), (RS, RefReader)):
        def run():
            with Reader(path, prefetch=prefetch,
                        store=_fault_factory({"fail_first": 99},
                                             {"retries": 2}, M=M)) as r:
                r.read_all()
        errs.append(_error(run))
    got, want = errs
    assert got == want
    cls, _text, attempts, offset, size = got
    assert cls == "RetryExhaustedError"
    assert len(attempts) == 3  # the first try and 2 retries
    assert offset is not None and size
    assert all("injected transient" in a for a in attempts)


def test_per_scan_retry_budget_exhausts(pq_file):
    path, _base = pq_file
    errs = []
    for M, Reader in ((S, FileReader), (RS, RefReader)):
        def run():
            with Reader(path, prefetch=0,
                        store=_fault_factory(
                            {"fail_first": 2},
                            {"retries": 4, "retry_budget": 1}, M=M)) as r:
                r.read_all()
        errs.append(_error(run))
    assert errs[0] == errs[1]
    assert errs[0][0] == "RetryExhaustedError"
    assert "retry budget" in errs[0][1]


def test_retry_budget_resets_per_scan(pq_file):
    path, base = pq_file
    stores = []
    # 6 chunk reads x 1 transient each = 6 retries per scan: an 8-retry
    # budget survives one scan and would die on the second if it leaked
    fac = _fault_factory({"fail_first": 1},
                         {"retries": 2, "retry_budget": 8}, stores)
    with FileReader(path, prefetch=4, store=fac) as r:
        assert r.read_pylist() == base
        stores[0].spec = FaultSpec(fail_first=2)  # fresh faults, scan 2
        stores[0]._attempts.clear()
        assert r.read_pylist() == base


def test_deadline_bounds_a_slow_store(pq_file):
    path, _base = pq_file
    errs = []
    for M, Reader in ((S, FileReader), (RS, RefReader)):
        def run():
            with Reader(path, prefetch=0,
                        store=_fault_factory(
                            {"latency_s": 0.2},
                            {"retries": 3, "deadline_s": 0.05}, M=M)) as r:
                r.read_all()
        errs.append(_error(run))
    assert errs[0] == errs[1]
    assert errs[0][0] == "RetryExhaustedError"
    assert "deadline exceeded" in errs[0][1]


def test_deadline_env_knob(pq_file, io_env):
    io_env.setenv("TPQ_IO_DEADLINE_S", "0.04")
    path, _base = pq_file
    hits = []
    for M, Reader in ((S, FileReader), (RS, RefReader)):
        stores = []

        def make(f, M=M, stores=stores):
            st = M.FaultInjectingStore(M.LocalStore(f),
                                       M.FaultSpec(latency_s=0.2),
                                       config=M.IOConfig.from_env())
            stores.append(st)
            return st

        with pytest.raises(Exception) as ei:
            with Reader(path, prefetch=0, store=make) as r:
                r.read_all()
        assert type(ei.value).__name__ == "RetryExhaustedError"
        hits.append(stores[0].stats.deadline_hits)
    assert hits[0] == hits[1] > 0


def test_scan_files_through_fault_store(pq_file, tmp_path):
    path, base = pq_file
    path2 = _write_file(str(tmp_path / "second.parquet"), seed=7)
    got = {"a": [], "b": []}
    want = {"a": [], "b": []}
    for mod, M, rows in ((DR, S, got), (RDR, RS, want)):
        kw = {"device": "cpu"} if mod is DR else {}
        for cols in mod.scan_files([path, path2], prefetch=2,
                                   store=_fault_factory({"fail_first": 1},
                                                        M=M), **kw):
            for k, v in cols.items():
                rows[k].extend(np.asarray(v.to_host()).tolist())
    with FileReader(path2) as r:
        base2 = r.read_pylist()
    assert got == want
    assert got["a"] == base["a"] + base2["a"]


# ---------------------------------------------------------------------------
# coalescing: planner + ladder
# ---------------------------------------------------------------------------

def test_plan_coalesced_merges_within_gap():
    ranges = [(0, 100), (110, 50), (1000, 20)]
    plan = plan_coalesced(ranges, gap=16)
    assert [(g.offset, g.size) for g in plan] == [(0, 160), (1000, 20)]
    assert plan[0].members == {(0, 100): 1, (110, 50): 1}
    assert ([g.key() for g in plan]
            == [g.key() for g in RS.plan_coalesced(ranges, gap=16)])


@pytest.mark.parametrize("gap,max_span,overlap", [
    (64, 300, False), (0, 1 << 20, False), (19, 220, False),
    (1 << 20, 100, False), (64, 300, True)])
def test_plan_coalesced_respects_cap_and_determinism(gap, max_span,
                                                     overlap):
    ranges = [(i * 120, 100) for i in range(8)]
    if overlap:
        # overlapping and repeated ranges always join one group
        ranges += [(240, 100), (250, 30), (250, 30)]
    plan = plan_coalesced(ranges, gap=gap, max_span=max_span)
    if not overlap:
        assert all(g.size <= max(max_span, 100) for g in plan)
    assert all(a.offset + a.size <= b.offset
               for a, b in zip(plan, plan[1:]))  # sorted and disjoint
    again = plan_coalesced(list(reversed(ranges)), gap=gap,
                           max_span=max_span)
    assert [g.key() for g in plan] == [g.key() for g in again]
    assert ([g.key() for g in plan]
            == [g.key() for g in RS.plan_coalesced(ranges, gap=gap,
                                                   max_span=max_span)])
    # full coverage, with multiplicity: no member lost to the splits
    members = sorted((m, n) for g in plan for m, n in g.members.items())
    want: dict = {}
    for r in ranges:
        want[r] = want.get(r, 0) + 1
    assert members == sorted(want.items())


def test_coalesced_reads_used_on_fault_store(pq_file):
    path, base = pq_file
    (rows, d), (_ref_rows, ref_d) = _both(path, {}, 4)
    assert rows == base
    assert d == ref_d
    assert d["coalesced_spans"] > 0
    # fewer store round trips than chunks: that is the point
    assert d["reads"] <= d["coalesced_spans"] + 1


def test_coalesced_failure_degrades_to_single_ranges(pq_file):
    path, base = pq_file
    stores = {}

    for M, Reader in ((S, FileReader), (RS, RefReader)):
        stores[M] = []
        with Reader(path, prefetch=4,
                    store=_fault_factory(
                        {"fail_first": 99,
                         # spans only: the members stay healthy
                         "match": lambda offset, size: size > 6000},
                        {"retries": 1}, stores[M], M=M)) as r:
            assert r.read_pylist() == base  # span fails, singles serve
    d = _io(stores[S])
    assert d == _io(stores[RS])
    assert d["coalesce_fallbacks"] > 0
    assert stores[S][0].coalesce_disabled  # 2+ span failures: stop trying


def _lying_store(M, data):
    class Lying(M.GenericRangeStore):
        def size(self):
            return len(data)

        def _fetch_once(self, offset, size, timeout):
            buf = data[offset: offset + size]
            return buf[:-5] if size > 120 else buf

    return Lying(config=_cfg(M, retries=1, coalesce_gap=64))


def test_lying_span_size_degrades_not_corrupts():
    data = bytes(range(256)) * 8
    st, ref = _lying_store(S, data), _lying_store(RS, data)
    fetcher = CoalescedFetcher(st, [(0, 100), (100, 100)])
    assert fetcher.groups == 1
    assert fetcher.read(0, 100) == data[:100]
    assert fetcher.read(100, 100) == data[100:200]
    assert st.stats.coalesce_fallbacks == 1
    rf = RS.CoalescedFetcher(ref, [(0, 100), (100, 100)])
    rf.read(0, 100)
    rf.read(100, 100)
    assert _io([st]) == _io([ref])


def _padding_store(M, data):
    class Padding(M.GenericRangeStore):
        def size(self):
            return len(data)

        def _fetch_once(self, offset, size, timeout):
            buf = data[offset: offset + size]
            if len(buf) < size and size > 120:
                return buf + b"\x00" * (size - len(buf))  # a padded EOF
            return buf

    return Padding(config=_cfg(M, retries=1, coalesce_gap=64))


def test_eof_padded_full_length_lie_is_rejected():
    """A store padding its EOF reads to full length fabricates bytes: the
    provably-past-EOF answer is rejected and the members are served by
    honest single reads."""
    data = bytes(range(200)) * 2  # a 400-byte object
    st = _padding_store(S, data)
    fetcher = CoalescedFetcher(st, [(250, 100), (350, 100)])
    assert fetcher.read(250, 100) == data[250:350]
    assert fetcher.read(350, 100) == data[350:]  # an honest short EOF read
    assert st.stats.coalesce_fallbacks == 1
    with pytest.raises(RetryExhaustedError, match="past EOF"):
        st.read_range(300, 150)
    ref = _padding_store(RS, data)
    assert _error(lambda: st.read_range(300, 150)) == _error(
        lambda: ref.read_range(300, 150))


def test_local_store_never_coalesces(pq_file):
    path, base = pq_file
    with FileReader(path, prefetch=4) as r:
        assert r.read_pylist() == base
        assert r._store.stats is None
        assert not r._store.prefers_coalescing
        assert isinstance(r._store, LocalStore)


# ---------------------------------------------------------------------------
# truncation: a short file is named as such
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [0, 4])
def test_truncated_file_names_offset_got_want(pq_file, prefetch):
    path, _base = pq_file
    with open(path, "rb") as f:
        whole = f.read()
    from tpu_parquet.footer import read_file_metadata as ref_md
    from tpu_parquet_torch.footer import read_file_metadata

    errs = []
    for Reader, md in ((FileReader, read_file_metadata(io.BytesIO(whole))),
                       (RefReader, ref_md(io.BytesIO(whole)))):
        def run():
            with Reader(io.BytesIO(whole[:200]), metadata=md,
                        prefetch=prefetch) as r:
                r.read_all()
        errs.append(_error(run))
    assert errs[0][1] == errs[1][1]
    assert errs[0][0] == "ParquetError"
    with pytest.raises(ParquetError, match=r"truncated file.*wanted \d+ "
                       r"bytes at offset \d+, got \d+"):
        with FileReader(io.BytesIO(whole[:200]),
                        metadata=read_file_metadata(io.BytesIO(whole)),
                        prefetch=prefetch) as r:
            r.read_all()


def test_truncated_sequential_read_chunk_names_offset(pq_file):
    """The sequential ``read_row_group`` (``chunk_decode.read_chunk``)
    names the truncation too."""
    from tpu_parquet_torch.footer import read_file_metadata

    path, _base = pq_file
    with open(path, "rb") as f:
        whole = f.read()
    md = read_file_metadata(io.BytesIO(whole))
    with pytest.raises(ParquetError, match="truncated file reading column"):
        with FileReader(io.BytesIO(whole[:150]), metadata=md) as r:
            r.read_row_group(0)


def test_require_full_passthrough():
    from tpu_parquet_torch import chunk_decode

    assert chunk_decode.require_full is require_full  # one home: iostore
    assert require_full(b"abcd", 0, 4) == b"abcd"
    with pytest.raises(ParquetError, match="column x.y") as got:
        require_full(b"ab", 10, 4, context="column x.y")
    with pytest.raises(Exception) as want:
        RS.require_full(b"ab", 10, 4, context="column x.y")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# env hardening: malformed numeric knobs degrade with one warning
# ---------------------------------------------------------------------------

def _knobs():
    from tpu_parquet import resilience as RR
    from tpu_parquet import iostore_async as RA
    from tpu_parquet_torch import iostore_async as A
    from tpu_parquet_torch import resilience as R

    def cfg(field):
        return (lambda: getattr(IOConfig.from_env(), field),
                lambda: getattr(RS.IOConfig.from_env(), field))

    return [
        ("TPQ_IO_DEADLINE_S", *cfg("deadline_s"), 0.0),
        ("TPQ_IO_RETRIES", *cfg("retries"), 4),
        ("TPQ_IO_BACKOFF_MS", *cfg("backoff_ms"), 25.0),
        ("TPQ_IO_RETRY_BUDGET", *cfg("retry_budget"), 64),
        ("TPQ_IO_COALESCE_GAP", *cfg("coalesce_gap"), 1 << 16),
        ("TPQ_IO_HEDGE_MS", *cfg("hedge_ms"), 0.0),
        ("TPQ_IO_HEDGE_MAX", *cfg("hedge_max"), 4),
        ("TPQ_IO_INFLIGHT", lambda: A.FetchEngine().max_inflight,
         lambda: RA.FetchEngine().max_inflight, 256),
        ("TPQ_CIRCUIT_FAILS", lambda: R.BreakerBoard().fails,
         lambda: RR.BreakerBoard().fails, 5),
        ("TPQ_CIRCUIT_WINDOW_S", lambda: R.BreakerBoard().window_s,
         lambda: RR.BreakerBoard().window_s, 30.0),
        ("TPQ_CIRCUIT_COOLDOWN_S", lambda: R.BreakerBoard().cooldown_s,
         lambda: RR.BreakerBoard().cooldown_s, 5.0),
    ]


KNOB_NAMES = [k[0] for k in _knobs()]


@pytest.mark.parametrize("name", KNOB_NAMES)
def test_malformed_env_degrades_with_warning(name, io_env, caplog):
    _n, resolve, ref_resolve, default = dict(
        (k[0], k) for k in _knobs())[name]
    # unique per knob, so the once-per-value warning fires, and never the
    # value ``tests/test_iostore.py`` sets for the same knob
    bad = f"torch-abc-{name}"
    io_env.setenv(name, bad)
    texts = []
    for fn in (resolve, ref_resolve):
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert fn() == default  # degraded, not raised
            assert fn() == default  # and warned once
        texts.append([r.getMessage() for r in caplog.records
                      if bad in r.getMessage()])
    assert texts[0] == texts[1] and len(texts[0]) == 1


def test_the_references_env_warning_test_passes_after_this_file():
    """The reference warns once per ``(name, raw)`` pair in a process: this
    file's malformed-knob cases must not spend the pairs that
    ``tests/test_iostore.py`` later looks for in the same worker."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:xdist",
         "-p", "no:cacheprovider", "-p", "no:randomly",
         "tests/test_torch_iostore.py::test_malformed_env_degrades_with_warning",
         "tests/test_torch_iostore.py::test_valid_env_still_parses",
         "tests/test_iostore.py::test_malformed_env_degrades_with_warning"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]


@pytest.mark.parametrize("name", KNOB_NAMES)
def test_valid_env_still_parses(name, io_env):
    _n, resolve, ref_resolve, _default = dict(
        (k[0], k) for k in _knobs())[name]
    io_env.setenv(name, "7")
    assert resolve() == pytest.approx(7) == ref_resolve()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_latency_histogram_matches_the_reference(seed):
    """The learned hedge delay reads this p90: equal buckets, counts and
    quantiles to the reference's on the same durations."""
    from tpu_parquet.obs import LatencyHistogram as RefHistogram
    from tpu_parquet_torch.obs import LatencyHistogram

    rng = np.random.default_rng(seed)
    got, want = LatencyHistogram(), RefHistogram()
    for d in np.concatenate([rng.exponential(0.02, 300), [0.0, 1e-9, 5.0]]):
        got.record(float(d))
        want.record(float(d))
    assert got.buckets == want.buckets and got.count == want.count
    assert got.max_seconds == want.max_seconds
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q)
    assert LatencyHistogram().quantile(0.9) == 0.0


def test_negative_numeric_env_clamps(io_env):
    io_env.setenv("TPQ_IO_RETRIES", "-3")
    assert IOConfig.from_env().retries == 0 == RS.IOConfig.from_env().retries
    io_env.setenv("TPQ_IO_HEDGE_MS", "auto")
    assert IOConfig.from_env().hedge_ms == -1.0


# ---------------------------------------------------------------------------
# store plumbing details
# ---------------------------------------------------------------------------

def test_local_store_bytesio_and_size():
    st = LocalStore(io.BytesIO(b"0123456789"))
    assert not st.parallel  # no usable descriptor: the locked path
    assert st.size() == 10
    assert st.read_range(2, 4) == b"2345"
    assert st.read_range(8, 10) == b"89"  # short at EOF, no raise


def test_resolve_store_forms(pq_file):
    path, _base = pq_file
    f = open(path, "rb")
    try:
        assert isinstance(resolve_store(f, None), LocalStore)
        st = FaultInjectingStore(LocalStore(f))
        assert resolve_store(f, st) is st
        assert isinstance(resolve_store(f, lambda g: LocalStore(g)),
                          LocalStore)
        got = []
        for M, bad in ((S, lambda g: object()), (S, 42),
                       (RS, lambda g: object()), (RS, 42)):
            with pytest.raises(TypeError) as ei:
                M.resolve_store(f, bad)
            got.append(str(ei.value))
        assert got[:2] == got[2:]
    finally:
        f.close()


def _unstable_store(M, flips):
    class Unstable(M.GenericRangeStore):
        def size(self):
            return 1 << 20

        def _fetch_once(self, offset, size, timeout):
            flips["n"] += 1
            if flips["n"] == 1:
                return b"\xAA" * (size // 2)  # torn
            return (b"\xBB" if flips["n"] == 2 else b"\xAA") * size

    return Unstable(config=_cfg(M, retries=5))


def test_torn_reread_verification_mismatch_costs_a_retry():
    """A full re-read that disagrees with the torn attempt's prefix is a
    transient fault and retried; a later consistent read is accepted."""
    flips = {"n": 0}
    st = _unstable_store(S, flips)
    out = st.read_range(0, 100)
    # attempt 1 torn, attempt 2 full but mismatched (rejected), attempt 3
    # matches the torn prefix and is accepted
    assert flips["n"] == 3
    assert out == b"\xAA" * 100
    assert st.stats.short_reads == 1
    assert st.stats.transient_errors == 2
    ref = _unstable_store(RS, {"n": 0})
    ref.read_range(0, 100)
    assert _io([st]) == _io([ref])


def test_abort_poisons_inflight_and_future_reads():
    boom = RuntimeError("wedged")

    class Flaky(GenericRangeStore):
        def size(self):
            return 1 << 20

        def _fetch_once(self, offset, size, timeout):
            raise TransientIOError("flaky")

    st = Flaky(config=_cfg(retries=50, backoff_ms=5))
    done = {}

    def reader():
        try:
            st.read_range(0, 64)
        except BaseException as e:  # noqa: BLE001
            done["exc"] = e

    t = threading.Thread(target=reader)
    t.start()
    st.abort(boom)
    t.join(timeout=10)
    assert not t.is_alive()
    assert done["exc"] is boom
    with pytest.raises(RuntimeError, match="wedged"):
        st.read_range(64, 64)
    st.begin_scan()  # a new scan clears the poison
    with pytest.raises(RetryExhaustedError):
        st.read_range(64, 64)
