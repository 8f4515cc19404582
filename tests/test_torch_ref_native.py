"""Both packages' native libraries are whole and loaded before a parity test
runs.

The reference's loader (``tpu_parquet.native.load``) compiles straight onto
its stamped file name.  Under a parallel test run another worker can find
that file half written, fail to open it and latch ``_load_failed`` for the
rest of its session; the reference then runs its Python fallbacks, whose
routes, counters and error texts differ from the native path's, and the
port's parity tests fail against them.  The reference stays as it is, so
the repair lives here: :func:`ensure_reference_native` builds the
reference's stamped library atomically when it is absent (a temporary name
that the reference's stale-build sweep never matches, then ``os.replace``),
clears a latched failure once the file is whole, loads again, and asserts
that both libraries are available.  Every ``tests/test_torch_*.py`` that
imports the reference calls it at import: the workers of a parallel run
collect every file before they run a test, so each worker holds a whole
library before any test reads through it.

The same module holds :class:`ReferenceCrashes` and its fixture
``no_reference_crashes``: the ``worker_crash`` events a parity test's
reference half leaves in the reference's process-global flight rings are
removed after the test, so ``tests/test_autopsy.py``, which reads the last
crash of those rings, never finds one of them in its place.

The tests: the helper drops only the crash events added since its mark; a
latched failure recovers over a whole file; the reference's
sweep, run while a build is in flight, leaves the build whole; and the
eight port tests that failed when a worker latched pass in a fresh pytest
process whose plugin forces the latch before collection.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import textwrap
import threading

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_lib_path(ref) -> str:
    return os.path.join(ref._DIR, f"{ref._LIB_BASENAME}.{ref._source_hash()}")


def build_atomic(src_dir: str, sources, lib_path: str, attempt: int = 0):
    """Compile ``sources`` (in ``src_dir``) with the reference's ``g++``
    command into a temporary file of this process, then rename it onto
    ``lib_path`` in one step.  The temporary name does not start with the
    library's base name, so the reference's sweep of stale builds never
    deletes it mid-build."""
    tmp = os.path.join(os.path.dirname(lib_path),
                       f".tpqbuild-{os.getpid()}-{attempt}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
           "-o", tmp] + [os.path.join(src_dir, s) for s in sources]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _whole(path: str) -> bool:
    try:
        ctypes.CDLL(path)
    except OSError:
        return False
    return True


def ensure_reference_native() -> None:
    """Make ``tpu_parquet.native`` and ``tpu_parquet_torch.native`` both
    loaded, or fail: a parity test never runs against the Python
    fallbacks."""
    import tpu_parquet.native as ref
    import tpu_parquet_torch.native as port

    lib_path = _ref_lib_path(ref)
    for attempt in range(3):
        if ref._lib is not None:
            break
        if not os.path.exists(lib_path) or (attempt and not _whole(lib_path)):
            build_atomic(ref._DIR, ref._SOURCES, lib_path, attempt)
        if ref._load_failed and _whole(lib_path):
            # the latch was set by a half-written file that is whole now
            with ref._lock:
                ref._load_failed = False
        ref.load()
    assert ref.available(), (
        f"the reference's native library at {lib_path} does not load")
    assert port.available(), "the port's native library does not load"


ensure_reference_native()


def _ring_events(ring) -> list:
    """A copy of one flight ring; a worker thread may still be appending."""
    while True:
        try:
            return list(ring)
        except RuntimeError:  # deque mutated during iteration
            continue


class ReferenceCrashes:
    """The ``worker_crash`` events that a test's reference half leaves in
    the reference's process-global flight rings
    (``tpu_parquet.obs.flight_recorder()``).

    ``tests/test_autopsy.py`` takes the last ``worker_crash`` of all rings
    as the one its own test raised, so a crash that an earlier test left in
    the same process (a ``CancelledError``, a ``DeadlineExceededError``, a
    ``HangError`` through a worker) must not stay there.  ``mark()`` records
    every ring's events before a test; ``drop_new()`` then removes the
    ``worker_crash`` events that appeared since, whatever their error type,
    and never an event that was there before the mark."""

    def __init__(self):
        import tpu_parquet.obs as ref_obs

        self._recorder = ref_obs.flight_recorder()
        self._before: dict = {}

    def _rings(self) -> list:
        with self._recorder._lock:
            return [ring for _name, ring in self._recorder._threads.values()]

    def mark(self) -> None:
        # the events themselves are kept, so their ids stay unique
        self._before = {id(ring): (ring, _ring_events(ring))
                        for ring in self._rings()}

    def drop_new(self) -> int:
        """Remove the crash events added since ``mark()``; returns how
        many were removed."""
        dropped = 0
        for ring in self._rings():
            old = self._before.get(id(ring))
            known = ({id(e) for e in old[1]}
                     if old is not None and old[0] is ring else set())
            events = _ring_events(ring)
            kept = [e for e in events
                    if id(e) in known or e[1] != "worker_crash"]
            if len(kept) != len(events):
                dropped += len(events) - len(kept)
                ring.clear()
                ring.extend(kept)
        self._before = {}
        return dropped


@pytest.fixture
def reference_env_warnings():
    """Autouse it in a parity file that calls a reference env resolver
    under a malformed value: the reference warns once per ``(name, raw)``
    pair for the whole process (``tpu_parquet.obs._env_warned``), so a pair
    spent here would silence the warning a later reference test in the same
    worker looks for.  The set is restored as the test found it."""
    from tpu_parquet import obs as ref_obs

    saved = set(ref_obs._env_warned)
    yield
    ref_obs._env_warned.clear()
    ref_obs._env_warned.update(saved)


@pytest.fixture
def no_reference_crashes():
    """Autouse it in a parity file whose reference half raises through a
    worker: each test's new reference ``worker_crash`` events are removed
    after it."""
    crashes = ReferenceCrashes()
    crashes.mark()
    yield crashes
    crashes.drop_new()


def test_reference_crashes_drops_only_new_crash_events():
    import tpu_parquet.obs as ref_obs

    rec = ref_obs.flight_recorder()
    outer = ReferenceCrashes()
    outer.mark()
    rec.record("i", "worker_crash", 1.0, 0.0, {"type": "Before"})
    crashes = ReferenceCrashes()
    crashes.mark()
    rec.record("i", "worker_crash", 3.0, 0.0, {"type": "ValueError"})
    rec.record("i", "after", 4.0, 0.0, {})
    worker = threading.Thread(target=lambda: rec.record(
        "i", "worker_crash", 5.0, 0.0, {"type": "CancelledError"}))
    worker.start()
    worker.join()
    assert crashes.drop_new() == 2
    events = [(e["name"], (e.get("args") or {}).get("type"))
              for t in rec.snapshot()["threads"].values()
              for e in t["events"]]
    assert ("worker_crash", "Before") in events
    assert ("after", None) in events
    assert not [e for e in events if e[1] in ("ValueError", "CancelledError")]
    assert outer.drop_new() == 1  # this test leaves no crash behind


def test_latched_failure_recovers_over_a_whole_file(monkeypatch):
    import tpu_parquet.native as ref

    assert os.path.exists(_ref_lib_path(ref))
    monkeypatch.setattr(ref, "_lib", None)
    monkeypatch.setattr(ref, "_load_failed", True)
    assert not ref.available()  # the latch holds by itself
    ensure_reference_native()
    assert ref.available() and not ref._load_failed
    # the recovered library is the native one: a round trip through it
    data = bytes(range(256)) * 64
    assert bytes(ref.snappy_decompress(ref.snappy_compress(data))[
        :len(data)]) == data


def test_reference_sweep_leaves_a_build_in_flight_whole(tmp_path,
                                                        monkeypatch):
    """The reference's sweep (every ``_libtpq_native.so*`` not ending with
    the new stamp is unlinked) runs while the helper's compiler is writing:
    the helper's temporary file survives it and lands whole."""
    import tpu_parquet.native as ref

    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native library cannot build")
    src = tmp_path / "native"
    src.mkdir()
    for s in ref._SOURCES:
        shutil.copy(os.path.join(ref._DIR, s), src)
    lib_path = str(src / f"{ref._LIB_BASENAME}.0123456789abcdef")
    stale = src / f"{ref._LIB_BASENAME}.ffffffffffffffff"
    stale.write_bytes(b"stale")
    real_run = subprocess.run
    swept = []

    def run_then_sweep(cmd, **kw):
        res = real_run(cmd, **kw)
        # the reference's sweep for another stamp, verbatim in effect,
        # while this build's output sits under its temporary name
        for f in os.listdir(src):
            if f.startswith(ref._LIB_BASENAME) and not f.endswith("beef"):
                os.unlink(src / f)
                swept.append(f)
        return res

    monkeypatch.setattr(subprocess, "run", run_then_sweep)
    build_atomic(str(src), ref._SOURCES, lib_path)
    assert swept == [stale.name]
    assert os.path.exists(lib_path) and _whole(lib_path)
    assert [f for f in os.listdir(src) if f.startswith(".tpqbuild")] == []


_EIGHT = [
    "tests/test_torch_reader.py::test_cpu_read_launches_no_kernel",
    "tests/test_torch_host_prefetch.py::"
    "test_corrupt_mid_file_page_raises_the_reference_text",
    "tests/test_torch_fallback.py::test_chip_smoke_pyarrow_layout_file",
]


def test_the_eight_pass_with_the_latch_forced_before_collection(tmp_path):
    plugin = tmp_path / "force_native_latch.py"
    plugin.write_text(textwrap.dedent("""
        def pytest_configure(config):
            import tpu_parquet.native as ref
            ref._load_failed = True
    """))
    # one thread per runtime: the subprocess runs beside a parallel suite
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(tmp_path), _REPO, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "force_native_latch", *_EIGHT],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=600)
    tail = res.stdout[-3000:] + res.stderr[-2000:]
    assert res.returncode == 0, tail
    assert "8 passed" in res.stdout, tail
