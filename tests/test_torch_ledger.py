"""The port's run ledger (``tpu_parquet_torch.ledger``) against the JAX
package's (``tpu_parquet.ledger``) on the same records.

Records are drawn from a seed with numpy: configs with the gated metrics,
their rep lists (nested windows, short and long, noisy and quiet), registry
stage seconds and per-route device seconds, rows that match or do not.
Each function of the ledger returns the same value in both packages
(``rel_noise``, ``attribute_stages``, ``diff``, ``check``, ``format_diff``,
``format_history``); a ledger file appended by either package reads back
whole in the other and diffs with the same verdicts; the port's fingerprint
carries ``kernel_mode`` (and ``CUDA_VISIBLE_DEVICES``) where the
reference's carries ``pallas_mode`` (and ``JAX_PLATFORMS``).  Exact
everywhere: equal floats, dicts and strings.
"""

import numpy as np
import pytest

from tpu_parquet import ledger as RL
from tpu_parquet_torch import ledger as L

_METRIC_KEYS = sorted(RL._METRICS)


def _reps(rng, n, base, noise):
    return [round(float(base * (1 + noise * rng.standard_normal())), 6)
            for _ in range(n)]


def _cfg(rng, rows):
    cfg = {"rows": rows}
    for key in rng.choice(_METRIC_KEYS, size=6, replace=False):
        cfg[str(key)] = float(rng.uniform(1e3, 5e7))
        rep_key = RL._METRICS[key][0]
        if rep_key is not None and rng.random() < 0.8:
            n = int(rng.integers(1, 8))
            noise = float(rng.choice([0.0, 0.01, 0.2]))
            reps = _reps(rng, n, float(rng.uniform(0.05, 2.0)), noise)
            if rep_key == "device_windows_s" and rng.random() < 0.5:
                reps = [reps, _reps(rng, 3, reps[0], noise)]
            cfg[rep_key] = reps
    if rng.random() < 0.7:
        cfg["obs"] = {
            "obs_version": 1,
            "pipeline": {k: float(rng.uniform(0, 3)) * (rng.random() < 0.8)
                         for k in RL._STAGE_KEYS},
        }
        if rng.random() < 0.6:
            cfg["obs"]["device"] = {"routes": {
                r: {"device_seconds": float(rng.uniform(0, 1))}
                for r in ("plain", "narrow", "fused_plain")
                if rng.random() < 0.7}}
    return cfg


def _record_pair(seed):
    rng = np.random.default_rng(seed)
    a, b = {"configs": {}}, {"configs": {}}
    for name in ("lineitem16", "plain_int64", "k3_file", "strings"):
        rows = int(rng.choice([1000, 6_001_215]))
        a["configs"][name] = _cfg(rng, rows)
        cb = _cfg(rng, rows if rng.random() < 0.8 else rows + 1)
        # keep some metrics shared, moved by a factor in or out of noise
        for key, v in a["configs"][name].items():
            if key in RL._METRICS and rng.random() < 0.7:
                cb[key] = v * float(rng.choice([0.4, 0.95, 1.0, 1.05, 2.5]))
        b["configs"][name] = cb
    for rec in (a, b):
        rec.update(metric="device_rows_per_sec",
                   value=float(rng.uniform(1e6, 1e7)), unit="rows/s",
                   vs_baseline=float(rng.uniform(0.5, 2)),
                   ts=float(rng.uniform(1.7e9, 1.8e9)),
                   git_rev=f"{int(rng.integers(1 << 40)):012x}")
    return a, b


SEEDS = list(range(6))


@pytest.mark.parametrize("seed", SEEDS)
def test_rel_noise_equal(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 4, 7, 12):
        reps = _reps(rng, n, 1.0, 0.1)
        assert L.rel_noise(reps) == RL.rel_noise(reps)


@pytest.mark.parametrize("seed", SEEDS)
def test_attribute_stages_equal(seed):
    a, b = _record_pair(seed)
    for name in a["configs"]:
        ca, cb = a["configs"][name], b["configs"][name]
        assert L.attribute_stages(ca, cb) == RL.attribute_stages(ca, cb)
        assert L.attribute_stages(cb, ca) == RL.attribute_stages(cb, ca)


@pytest.mark.parametrize("seed", SEEDS)
def test_diff_check_and_renderings_equal(seed):
    a, b = _record_pair(seed)
    for z, floor in ((3.0, 0.10), (1.0, 0.0), (5.0, 0.5)):
        d = L.diff(a, b, z=z, floor=floor)
        assert d == RL.diff(a, b, z=z, floor=floor)
        assert L.format_diff(d, "A", "B") == RL.format_diff(d, "A", "B")
    assert L.check(a, b) == RL.check(a, b)
    assert L.check(b, a, z=2.0, floor=0.2) == RL.check(b, a, z=2.0,
                                                         floor=0.2)
    assert (L.format_history([a, b, {}], "x.jsonl", start=3)
            == RL.format_history([a, b, {}], "x.jsonl", start=3))


def test_diff_verdicts_cover_every_kind():
    """The seeded records exercise each verdict, so the equalities above
    compare regressions, improvements, noise and incomparable configs."""
    seen = set()
    for seed in SEEDS:
        d = RL.diff(*_record_pair(seed))
        seen |= {e["verdict"] for e in d["metrics"].values()}
        if d["incomparable"]:
            seen.add("incomparable")
        if any(e["attribution"] for e in d["regressions"]):
            seen.add("attributed")
    assert seen == {"regression", "improvement", "within_noise",
                    "incomparable", "attributed"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ledger_file_read_by_the_other_package(tmp_path, writer):
    w, r = (L, RL) if writer == "port" else (RL, L)
    path = str(tmp_path / "runs" / "ledger.jsonl")
    records = []
    for seed in (0, 1):
        a, b = _record_pair(seed)
        for rec in (a, b):
            full = w.make_record(rec, ts=rec["ts"])
            assert w.append(path, full) == len(records)
            records.append(full)
    with open(path, "a") as f:
        f.write('{"torn": ')  # a writer died mid-append
    assert r.read(path) == records == w.read(path)
    assert r.load_side(path) == records[-1]
    assert r.load_side(f"{path}#-2") == records[-2]
    assert r.append(path, {"v": 1}) == len(records)  # the torn tail healed
    back = r.read(path)
    assert back[:-1] == records and back[-1] == {"v": 1}
    a, b = r.load_side(f"{path}#0"), r.load_side(f"{path}#1")
    assert L.diff(a, b) == RL.diff(a, b)
    assert L.check(a, b) == RL.check(a, b)


def test_fingerprint_carries_kernel_mode(monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    monkeypatch.setenv("TPQ_LINK_MBPS", "350")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    fp = L.env_fingerprint()
    assert fp["kernel_mode"] == "plain"  # no card in this test process
    assert "kernel_device" not in fp
    assert "pallas_mode" not in fp
    assert fp["CUDA_VISIBLE_DEVICES"] == "0"
    assert fp["TPQ_LINK_MBPS"] == "350"
    assert "JAX_PLATFORMS" not in fp
    ref = RL.env_fingerprint()
    assert "pallas_mode" in ref and "kernel_mode" not in ref
    # every other key is the reference's
    shared = (set(fp) | set(ref)) - {"kernel_mode", "pallas_mode",
                                     "CUDA_VISIBLE_DEVICES", "JAX_PLATFORMS"}
    assert {k: fp[k] for k in shared} == {k: ref[k] for k in shared}
    rec = L.make_record({"configs": {}}, ts=5.0)
    assert rec["ledger_version"] == RL.LEDGER_VERSION == L.LEDGER_VERSION
    assert rec["env"]["kernel_mode"] == "plain"


def test_fingerprint_names_the_card(monkeypatch):
    import torch

    from tpu_parquet_torch import cuda_kernels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert cuda_kernels.kernel_mode() == "cuda"
    fp = L.env_fingerprint()
    assert fp["kernel_mode"] == "cuda"
    assert fp["kernel_device"] == "NVIDIA H100 80GB HBM3"


def test_env_keys_are_the_references_with_the_port_knobs():
    dropped = {"TPQ_PALLAS", "TPQ_FUSE", "TPQ_FUSE_RG", "TPQ_COMPILE_CACHE",
               "TPQ_DEVICE_SNAPPY", "TPQ_DEFER_DICT_CHECK", "JAX_PLATFORMS"}
    assert set(L._ENV_KEYS) == (set(RL._ENV_KEYS) - dropped) | {
        "CUDA_VISIBLE_DEVICES"}
    assert L._METRICS == RL._METRICS and L._STAGE_KEYS == RL._STAGE_KEYS
