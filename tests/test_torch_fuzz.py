"""The port's fuzz harness (``tpu_parquet_torch.fuzz``) against the corpus
and the reference's.

``tests/test_fuzz.py`` case for case against the port, with the device
targets on ``device="cpu"`` (the kernels' plain versions): every file of
both corpus directories (``tests/fuzz_corpus/``, the reference's, and
``tests/fuzz_corpus_torch/``, the port's own) replayed through its target,
the populated check, and the deterministic smoke batch per target (seed
1234, 120 runs of ``file_reader``, 400 of every other).  Beside them: for
every corpus file the port's target and the reference's agree on returning
or raising their package's ``ParquetError``; the device targets raise
without a card when no device is named; and ``main`` replays, fuzzes and
writes its summary.
"""

import gc
import json
import os
import threading

import pytest
import torch

from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)
from tpu_parquet_torch import fuzz
from tpu_parquet_torch.errors import ParquetError

ensure_reference_native()

_TESTS = os.path.dirname(os.path.abspath(__file__))
CORPUS_DIRS = (os.path.join(_TESTS, "fuzz_corpus"),
               os.path.join(_TESTS, "fuzz_corpus_torch"))


def _corpus_files():
    out = []
    for d in CORPUS_DIRS:
        if os.path.isdir(d):
            out += [os.path.join(os.path.basename(d), n)
                    for n in sorted(os.listdir(d)) if not n.startswith(".")]
    return out


def _read(rel: str) -> bytes:
    with open(os.path.join(_TESTS, rel), "rb") as f:
        return f.read()


def _target(rel: str) -> str:
    return os.path.basename(rel).rsplit("-", 1)[0]


@pytest.fixture(autouse=True)
def _process_state(no_reference_crashes, reference_env_warnings):
    """The reference's targets leave crash events and spent env warnings
    in its process-global state, both restored after each test; both
    packages' default fetch engines are stopped and no ``tpq-`` thread a
    test started outlives it."""
    from tpu_parquet.iostore_async import (
        shutdown_default_engine as ref_shutdown_default_engine)
    from tpu_parquet_torch.iostore_async import shutdown_default_engine

    before = set(threading.enumerate())
    yield
    shutdown_default_engine()
    ref_shutdown_default_engine()
    gc.collect()
    assert not [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("tpq-")
                and t not in before]


def test_corpus_dirs_are_the_harness_dirs():
    assert tuple(fuzz.REPLAY_DIRS) == CORPUS_DIRS
    assert fuzz._CORPUS_DIR == CORPUS_DIRS[1]


@pytest.mark.parametrize("name", _corpus_files())
def test_corpus_replay(name):
    fn = fuzz.target_fn(_target(name), device="cpu")
    fn(_read(name))  # must return or raise ParquetError


def test_corpus_is_populated():
    names = _corpus_files()
    assert len(names) >= 102, names
    assert all(_target(n) in fuzz.TARGETS for n in names)


def test_the_port_has_every_reference_target():
    from tpu_parquet import fuzz as ref_fuzz

    ref = list(ref_fuzz.TARGETS)
    assert list(fuzz.TARGETS)[: len(ref)] == ref
    # then the port's own: the chunk walk against the page loop
    assert list(fuzz.TARGETS)[len(ref):] == ["chunk_walk"]
    assert len(fuzz.TARGETS) == 25
    assert fuzz.DEVICE_TARGETS <= set(fuzz.TARGETS)


@pytest.mark.parametrize("target", sorted(fuzz.TARGETS))
def test_smoke_fuzz(target):
    """Deterministic short fuzz batch per target — no crashers allowed."""
    runs = 120 if target == "file_reader" else 400
    crashers = fuzz.run_fuzz(target, runs=runs, seed=1234,
                             save_crashers=False, device="cpu")
    assert not crashers, crashers[0][1]


def _outcome(fn, data, error_type) -> str:
    try:
        fn(data)
    except error_type:
        return "reject"
    return "return"


def test_accept_and_reject_agree_with_the_reference_on_every_corpus_file():
    """The reference's targets as ``tests/test_fuzz.py`` runs them (its
    device reader on JAX's CPU backend), the port's with ``device="cpu"``:
    the same outcome for every file of both directories."""
    from tpu_parquet import fuzz as ref_fuzz
    from tpu_parquet.errors import ParquetError as RefParquetError

    diff = []
    for name in _corpus_files():
        data = _read(name)
        t = _target(name)
        got = _outcome(fuzz.target_fn(t, device="cpu"), data, ParquetError)
        want = _outcome(ref_fuzz.TARGETS[t], data, RefParquetError)
        if got != want:
            diff.append((name, got, want))
    assert not diff, diff


@pytest.mark.parametrize("target", sorted(fuzz.DEVICE_TARGETS))
def test_device_targets_raise_without_a_card_unless_asked(target):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    seed = fuzz._seed_inputs(target)[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.TARGETS[target](seed)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.target_fn(target)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.run_fuzz(target, runs=1, save_crashers=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fuzz.main(["--target", target, "--runs", "1", "--no-save"])
    fuzz.target_fn(target, device="cpu")(seed)


def test_main_replays_fuzzes_and_writes_its_summary(tmp_path, monkeypatch):
    crash_dir = tmp_path / "corpus"
    crash_dir.mkdir()
    (crash_dir / "thrift-000000000000").write_bytes(b"\x15\x00")
    monkeypatch.setattr(fuzz, "_CORPUS_DIR", str(tmp_path / "new"))
    out = tmp_path / "summary.json"
    rc = fuzz.main(["--device", "cpu", "--replay", str(crash_dir),
                    "--replay", str(tmp_path / "absent"),
                    "--target", "device_reader", "--runs", "5",
                    "--target-runs", "device_reader=7", "--seed", "3",
                    "--no-save", "--json", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["replay"]["files"] == 1 and doc["replay"]["crashers"] == 0
    assert doc["targets"]["device_reader"]["runs"] == 7
    assert doc["targets"]["device_reader"]["crashers"] == 0
    assert doc["crashers"] == 0
    # CPU tensors never count as kernel launches
    assert set(doc["launches"]) == {"unpack_bp_groups",
                                    "hybrid_unpack_combine",
                                    "fused_plain_words",
                                    "fused_narrow_words"}
    assert not any(doc["launches"].values())
    assert not os.path.exists(tmp_path / "new")
    with pytest.raises(SystemExit):
        fuzz.main(["--target-runs", "nope=3"])


def test_a_crasher_is_saved_to_the_ports_corpus(tmp_path, monkeypatch):
    """A crasher lands minimized in the port's own corpus directory, never
    in the reference's."""
    def crash(data: bytes) -> None:
        if b"\xff" in data:
            raise IndexError("hostile byte")

    monkeypatch.setitem(fuzz.TARGETS, "thrift", crash)
    monkeypatch.setattr(fuzz, "_CORPUS_DIR", str(tmp_path / "torch_corpus"))
    found = fuzz.run_fuzz("thrift", runs=60, seed=0)
    assert found and all(small == b"\xff" for small, _ in found)
    saved = os.listdir(tmp_path / "torch_corpus")
    assert saved and all(n.startswith("thrift-") for n in saved)
    assert (tmp_path / "torch_corpus" / saved[0]).read_bytes() == b"\xff"
