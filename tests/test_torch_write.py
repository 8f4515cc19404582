"""The port's write side (``tpu_parquet_torch.write``: ``write_sharded``,
``merge_files``, the manifest's write half, ``compact``, ``WriteStats``,
and the writer's ``stats=`` hooks) against the JAX package's, case for case
with ``tests/test_write_scale.py``.

Each case runs both packages on the same seeded batches and holds them
byte for byte: the single writer, the sharded writer in both layouts, the
merged file, the manifest document, the encoded row-group blob and the
compacted members are equal files.  Compaction's report (codec, file, row
and modeled link-byte counts) is equal with ``TPQ_FUSE=1`` and a pinned
``TPQ_LINK_MBPS``, since the port's planner always ranks the fused routes.
Errors compare by class name and text.  Reads go through the port's host
``FileReader``, ``scan_files(device="cpu")``, ``DataLoader`` and
``ScanService``, held against the reference's host reads of the same bytes.

Left out until ``cli/`` is ported: ``test_pq_tool_merge_and_compact`` and
the ``cmd_doctor`` lines of ``test_doctor_attributes_slow_write`` (the
doctor's verdict on the same registry tree stands in).
"""

import io
import json
import logging
import os
import threading
import types

import numpy as np
import pytest

import tpu_parquet as RPKG
import tpu_parquet_torch as PPKG
from tests.test_torch_iostore import io_env  # noqa: F401 — the fixture
from tests.test_torch_ref_native import (  # noqa: F401 — the fixtures
    ensure_reference_native, no_reference_crashes, reference_env_warnings)

ensure_reference_native()


def _pkg(root, name):
    import importlib

    mods = {m: importlib.import_module(f"{root.__name__}.{m}") for m in (
        "column", "chunk_decode", "errors", "footer", "format", "obs",
        "obs_fleet", "reader", "schema.core", "serve", "ship", "write",
        "write.merge", "write.sharded", "write.compact", "writer",
        "data")}
    return types.SimpleNamespace(name=name, **{
        k.replace(".", "_"): v for k, v in mods.items()})


PORT = _pkg(PPKG, "port")
REF = _pkg(RPKG, "reference")
BOTH = (PORT, REF)


@pytest.fixture(autouse=True)
def _parity_env(io_env, no_reference_crashes, reference_env_warnings):
    """``io_env``: ``TPQ_FUSE=1`` and no IO or planner knob set, both
    packages' default fetch engines stopped around the test and no ``tpq-``
    thread left by it; the reference's ``worker_crash`` events and the
    once-per-value env warnings it spent leave with the test."""
    io_env.delenv("TPQ_WRITE_CRC", raising=False)
    io_env.delenv("TPQ_OBS_SPOOL", raising=False)
    yield


def _schema(P):
    S, F = P.schema_core, P.format
    return S.build_schema([
        S.data_column("a", F.Type.INT64, F.FieldRepetitionType.REQUIRED),
        S.data_column("b", F.Type.DOUBLE, F.FieldRepetitionType.REQUIRED),
        S.data_column("s", F.Type.BYTE_ARRAY, F.FieldRepetitionType.REQUIRED),
    ])


def _batches(P, n_rgs=6, rows=800, seed=0):
    """``tests/test_write_scale.py``'s batches, built with ``P``'s own
    column classes from the same seeded draws."""
    C = P.column
    rng = np.random.default_rng(seed)
    pool = [b"alpha", b"beta", b"gamma-gamma", b"", b"delta"]
    out = []
    for _ in range(n_rgs):
        svals = [pool[i] for i in rng.integers(0, len(pool), rows)]
        out.append({
            "a": rng.integers(0, 1 << 40, rows).astype(np.int64),
            "b": rng.random(rows),
            "s": C.ColumnData(values=C.ByteArrayData(
                offsets=np.cumsum([0] + [len(v) for v in svals]),
                heap=np.frombuffer(b"".join(svals), np.uint8).copy())),
        })
    return out


def _single_writer_file(P, path, schema, batches, **kw):
    with P.writer.FileWriter(path, schema, **kw) as w:
        for b in batches:
            w.write_columns(b)
            w.flush_row_group()
    return path


def _read_all_concat(P, paths, prefetch=0):
    cols: dict = {}
    for p in paths:
        with P.reader.FileReader(p, prefetch=prefetch) as r:
            for k, v in r.read_all().items():
                cols.setdefault(k, []).append(v)
    return {k: P.reader._concat_column_data(v) for k, v in cols.items()}


def _arrays(cols):
    """Each column's values as numpy arrays (offsets and heap for strings),
    comparable across packages."""
    out = {}
    for k, cd in cols.items():
        v = cd.values
        out[k] = ((np.asarray(v.offsets), np.asarray(v.heap))
                  if hasattr(v, "heap") else (np.asarray(v),))
    return out


def _same_cols(got, want):
    g, w = _arrays(got), _arrays(want)
    assert list(g) == list(w)
    for k in w:
        assert len(g[k]) == len(w[k])
        for x, y in zip(g[k], w[k]):
            assert x.dtype == y.dtype and np.array_equal(x, y), k


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 — the class is the comparison
        return ("raise", type(e).__name__, str(e))


def _dirs(tmp_path, *names):
    out = []
    for P in BOTH:
        d = tmp_path / P.name
        d.mkdir(exist_ok=True)
        for n in names:
            (d / n).mkdir(parents=True, exist_ok=True)
        out.append(d)
    return out


def _no_temp(d):
    return not [f for f in os.listdir(d) if ".tmp-" in f]


# ---------------------------------------------------------------------------
# bit-faithfulness: merged file == single-writer file, across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 3])
def test_sharded_file_bit_identical_to_single_writer(tmp_path, workers):
    files = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema, batches = _schema(P), _batches(P)
        single = _single_writer_file(P, str(d / "single.parquet"), schema,
                                     batches)
        merged = str(d / "merged.parquet")
        res = P.write.write_sharded(merged, schema, batches, workers=workers)
        assert res.layout == "file" and res.files == 1
        assert res.rows == sum(len(b["b"]) for b in batches)
        assert _bytes(single) == _bytes(merged)
        files.append((_bytes(single), res.as_dict()))
    assert files[0] == files[1]


@pytest.mark.parametrize("prefetch", [0, 4])
def test_sharded_outputs_read_back_bit_identical(tmp_path, prefetch):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path, "ds")):
        schema, batches = _schema(P), _batches(P)
        single = _single_writer_file(P, str(d / "single.parquet"), schema,
                                     batches)
        merged = str(d / "merged.parquet")
        P.write.write_sharded(merged, schema, batches, workers=2)
        res = P.write.write_sharded(str(d / "ds"), schema, batches,
                                    workers=2, target_file_bytes=20_000)
        assert res.files > 1, "target_file_bytes must cut several members"
        paths, m = P.write.expand_dataset(str(d / "ds"))
        assert m is not None and m.generation == 1
        assert all(os.path.isabs(p) for p in paths)
        out.append((single, merged, paths, res))
    (p_single, p_merged, p_paths, p_res), (r_single, _m, r_paths, r_res) = out
    assert p_res.as_dict() == r_res.as_dict()
    assert ([os.path.basename(p) for p in p_paths]
            == [os.path.basename(p) for p in r_paths])
    for a, b in zip(p_paths, r_paths):
        assert _bytes(a) == _bytes(b)
    assert (_bytes(os.path.dirname(p_paths[0]) + "/tpq_manifest.json")
            == _bytes(os.path.dirname(r_paths[0]) + "/tpq_manifest.json"))
    want = _read_all_concat(REF, [r_single], prefetch=prefetch)
    for paths in ([p_merged], p_paths):
        _same_cols(_read_all_concat(PORT, paths, prefetch=prefetch), want)


def _device_groups(src, prefetch):
    from tpu_parquet_torch.device_reader import scan_files

    out = []
    for cols in scan_files(src, prefetch=prefetch, device="cpu"):
        g = {}
        for k, v in cols.items():
            h = v.to_host()
            g[k] = ((np.asarray(h.offsets), np.asarray(h.heap))
                    if hasattr(h, "heap") else (np.asarray(h),))
        out.append(g)
    return out


@pytest.mark.parametrize("prefetch", [0, 4])
def test_manifest_scans_as_one_device_dataset(tmp_path, prefetch):
    """The port's ``scan_files`` takes the manifest (path or directory) and
    yields the same groups, in order, as the single-writer file, and those
    equal the reference's host read of its own single-writer file."""
    (d,) = _dirs(tmp_path, "ds")[:1]
    schema, batches = _schema(PORT), _batches(PORT, n_rgs=4)
    single = _single_writer_file(PORT, str(d / "single.parquet"), schema,
                                 batches)
    PORT.write.write_sharded(str(d / "ds"), schema, batches, workers=2,
                             target_file_bytes=20_000)
    ref_single = _single_writer_file(
        REF, str(tmp_path / "ref_single.parquet"), _schema(REF),
        _batches(REF, n_rgs=4))
    assert _bytes(ref_single) == _bytes(single)
    with REF.reader.FileReader(ref_single) as r:
        want = [_arrays(r.read_row_group(i)) for i in range(4)]
    for src in (str(d / "ds"), str(d / "ds" / "tpq_manifest.json"),
                [single]):
        got = _device_groups(src, prefetch)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                for x, y in zip(g[k], w[k]):
                    assert np.array_equal(x, y), k


@pytest.mark.parametrize("prefetch", [0, 4])
def test_dataloader_consumes_manifest_as_one_dataset(tmp_path, prefetch):
    streams = []
    for P, d in zip(BOTH, _dirs(tmp_path, "ds")):
        S, F = P.schema_core, P.format
        schema = S.build_schema([
            S.data_column("a", F.Type.INT64, F.FieldRepetitionType.REQUIRED),
            S.data_column("b", F.Type.DOUBLE, F.FieldRepetitionType.REQUIRED),
        ])
        batches = [{k: v for k, v in b.items() if k != "s"}
                   for b in _batches(P, n_rgs=4, rows=500)]
        single = _single_writer_file(P, str(d / "single.parquet"), schema,
                                     batches)
        P.write.write_sharded(str(d / "ds"), schema, batches, workers=2,
                              target_file_bytes=10_000)
        for src in (str(d / "ds"), single):
            dl = P.data.DataLoader(src, batch_size=128, shuffle=False,
                                   drop_remainder=True, prefetch=prefetch)
            streams.append([{k: np.asarray(v) for k, v in b.items()}
                            for b in dl])
    assert len(streams[0]) > 0
    for s in streams[1:]:
        assert len(s) == len(streams[0])
        for g, w in zip(s, streams[0]):
            assert list(g) == list(w)
            for k in w:
                assert np.array_equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# TPQ_WRITE_CRC: default-on CRCs, validated by the default reader tier
# ---------------------------------------------------------------------------

def _first_page_has_crc(P, path) -> bool:
    with open(path, "rb") as f:
        md = P.footer.read_file_metadata(f)
        schema = P.schema_core.Schema.from_file_metadata(md)
        chunk = md.row_groups[0].columns[0]
        cmd, offset = P.chunk_decode.validate_chunk_meta(chunk,
                                                         schema.leaves[0])
        f.seek(offset)
        buf = f.read(cmd.total_compressed_size)
    for ps in P.chunk_decode.walk_pages(buf, cmd.num_values):
        return ps.header.crc is not None
    return False


def _read_error(P, path):
    with P.reader.FileReader(path) as r:
        return _outcome(r.read_all)


def test_write_crc_defaults_on_and_validates(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        merged = str(d / "m.parquet")
        P.write.write_sharded(merged, _schema(P), _batches(P, n_rgs=2),
                              workers=2)
        assert _first_page_has_crc(P, merged), "default-on CRCs missing"
        P.writer.corrupt_page(merged, 0, 0, 0, mode="bitflip", seed=3)
        err = _read_error(P, merged)
        assert err[:2] == ("raise", "ParquetError") and "crc" in err[2].lower()
        out.append((_bytes(merged), err[2].replace(str(d), "<d>")))
    assert out[0] == out[1]


@pytest.mark.parametrize("raw", ["0", "1", "off", "bananas", None])
def test_write_crc_env_knob_contract(tmp_path, io_env, raw):
    if raw is None:
        io_env.delenv("TPQ_WRITE_CRC", raising=False)
    else:
        io_env.setenv("TPQ_WRITE_CRC", raw)
    got = [P.writer.resolve_write_crc(None) for P in BOTH]
    assert got[0] == got[1] == (raw in (None, "1", "bananas"))
    files = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema, batches = _schema(P), _batches(P, n_rgs=1)
        env = _single_writer_file(P, str(d / "env.parquet"), schema, batches)
        on = _single_writer_file(P, str(d / "on.parquet"), schema, batches,
                                 write_crc=True)
        assert _first_page_has_crc(P, env) == got[0]
        assert _first_page_has_crc(P, on)  # the kwarg wins over the env
        files.append((_bytes(env), _bytes(on)))
        strict = _outcome(P.writer.resolve_write_crc, "bananas")
        assert strict[:2] == ("raise", "ValueError")
        assert P.writer.resolve_write_crc("off") is False
        assert P.writer.resolve_write_crc("on") is True
    assert files[0] == files[1]


def test_malformed_write_crc_warns_once_per_value(io_env, caplog):
    """A malformed ``TPQ_WRITE_CRC`` degrades to CRCs on with one warning
    per value for the process, as the reference's, however many writers
    resolve it (the sharded writer resolves it once per batch)."""
    bad = "torch-bananas"
    io_env.setenv("TPQ_WRITE_CRC", bad)
    texts = []
    for P in BOTH:
        io_env.setattr(P.obs, "_env_warned", set())
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            assert P.writer.resolve_write_crc(None) is True
            assert P.writer.resolve_write_crc(None) is True
        texts.append([r.getMessage() for r in caplog.records
                      if bad in r.getMessage()])
    assert texts[0] == texts[1] and len(texts[0]) == 1


# ---------------------------------------------------------------------------
# footer merge: typed rejections
# ---------------------------------------------------------------------------

def test_merge_files_roundtrip_and_rejections(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema, batches = _schema(P), _batches(P, n_rgs=4)
        parts = []
        for i in range(2):
            p = str(d / f"part{i}.parquet")
            _single_writer_file(P, p, schema, batches[2 * i: 2 * i + 2])
            parts.append(p)
        single = _single_writer_file(P, str(d / "single.parquet"), schema,
                                     batches)
        merged_path = str(d / "merged.parquet")
        merged = P.write.merge_files(merged_path, parts)
        assert merged.num_rows == 3200
        assert _bytes(merged_path) == _bytes(single)
        S, F = P.schema_core, P.format
        alien = str(d / "alien.parquet")
        with P.writer.FileWriter(alien, S.build_schema([S.data_column(
                "z", F.Type.INT64, F.FieldRepetitionType.REQUIRED)])) as w:
            w.write_columns({"z": np.arange(5, dtype=np.int64)})
        errs = [_outcome(P.write.merge_files, str(d / "x.parquet"),
                         [parts[0], alien])]
        meta = P.footer.read_file_metadata(parts[0])
        meta.num_rows += 1
        errs.append(_outcome(P.write.merge_footers,
                             [(meta, os.path.getsize(parts[0]))]))
        good = P.footer.read_file_metadata(parts[0])
        errs.append(_outcome(P.write.merge_footers, [(good, 128)]))
        errs.append(_outcome(P.write.merge_files, str(d / "y.parquet"), []))
        for e, pat in zip(errs, ("schema does not match",
                                 "lying shard footer",
                                 "past the data segment",
                                 "at least one input")):
            assert e[:2] == ("raise", "ParquetError") and pat in e[2], e
        assert _no_temp(d)
        out.append((_bytes(merged_path), [e[1:] for e in errs]))
    assert out[0] == out[1]


def test_merge_footers_plan_matches_the_reference(tmp_path):
    """The pure merge over several shards: the same copy plan and the same
    footer bytes from both packages."""
    plans = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema = _schema(P)
        parts = []
        for i, b in enumerate(_batches(P, n_rgs=5, rows=300, seed=4)):
            p = str(d / f"s{i}.parquet")
            _single_writer_file(P, p, schema, [b] * (1 + i % 2))
            parts.append((P.footer.read_file_metadata(p),
                          os.path.getsize(p)))
        merged, spans = P.write.merge_footers(parts,
                                              kv_metadata={"k": "v"})
        plans.append((spans, P.footer.serialize_footer(merged)))
    assert plans[0] == plans[1]


# ---------------------------------------------------------------------------
# manifest: versioned, atomic, monotonic
# ---------------------------------------------------------------------------

MUTATIONS = [
    (lambda x: x.update(magic="NOPE"), "magic"),
    (lambda x: x.update(manifest_version=99), "manifest_version"),
    (lambda x: x.update(generation=0), "generation"),
    (lambda x: x.update(files=[]), "file list"),
    (lambda x: x["files"][0].update(path="/abs/path.parquet"), "escapes"),
    (lambda x: x["files"][0].update(rows=-1), "non-negative"),
    (lambda x: x.update(total_rows=7), "member sum"),
]


def test_manifest_round_trip_generation_and_rejections(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path, "ds")):
        ds = d / "ds"
        P.write.write_sharded(str(ds), _schema(P), _batches(P, n_rgs=2),
                              workers=1, target_file_bytes=10_000)
        m = P.write.load_manifest(str(ds))
        assert m.generation == 1 and m.total_rows == 1600
        doc1 = _bytes(str(ds / "tpq_manifest.json"))
        m2 = P.write.write_manifest(str(ds), m.member_paths())
        assert m2.generation == 2
        doc2 = _bytes(str(ds / "tpq_manifest.json"))
        back = _outcome(P.write.write_manifest, str(ds), m.member_paths(),
                        generation=1)
        assert back[:2] == ("raise", "ParquetError")
        assert "must advance" in back[2]
        empty = _outcome(P.write.write_manifest, str(ds), [],
                         generation=5)
        mp = str(ds / "tpq_manifest.json")
        doc = json.load(open(mp))
        errs = []
        for mutate, pat in MUTATIONS:
            bad = json.loads(json.dumps(doc))
            mutate(bad)
            with open(mp, "w") as f:
                json.dump(bad, f)
            e = _outcome(P.write.load_manifest, str(ds))
            assert e[:2] == ("raise", "ParquetError") and pat in e[2], e
            errs.append(e[1:])
        assert _no_temp(ds)
        out.append((doc1, doc2, back[1:], empty[1:], errs))
    assert out[0] == out[1]


def test_atomic_publish_leaves_no_temp_on_failure(tmp_path):
    for P, d in zip(BOTH, _dirs(tmp_path)):
        target = str(d / "doc.json")
        P.write.manifest.atomic_publish(b"one", target)
        assert _bytes(target) == b"one"
        with pytest.raises(IsADirectoryError):
            P.write.manifest.atomic_publish(b"two", str(d))
        assert _bytes(target) == b"one" and _no_temp(d)


# ---------------------------------------------------------------------------
# compaction: many small -> few large, CRCs always, atomic + coherent
# ---------------------------------------------------------------------------

LINK_MBPS = "350"


def _fragmented_dataset(P, root, n_files=8, rows=300, seed=0):
    schema = _schema(P)
    d = root / "frag"
    d.mkdir(parents=True)
    paths = []
    for i, b in enumerate(_batches(P, n_rgs=n_files, rows=rows, seed=seed)):
        p = str(d / f"in-{i:03d}.parquet")
        _single_writer_file(P, p, schema, [b])
        paths.append(p)
    P.write.write_manifest(str(d), paths)
    return d, schema, paths


def _members(P, d):
    return [_bytes(p) for p in P.write.load_manifest(str(d)).member_paths()]


def test_compaction_end_to_end(tmp_path, io_env):
    io_env.setenv("TPQ_WRITE_CRC", "0")  # compaction must override
    io_env.setenv("TPQ_LINK_MBPS", LINK_MBPS)
    out = []
    for P, root in zip(BOTH, _dirs(tmp_path)):
        d, _schema_, paths = _fragmented_dataset(P, root)
        want = _read_all_concat(P, paths)
        rep = P.write.compact(str(d), target_file_bytes=1 << 20, workers=2)
        assert rep.files_before == 8 and rep.files_after < 8
        assert rep.rows == 2400 and rep.generation == 2
        assert rep.row_groups_after < rep.row_groups_before
        assert 0 < rep.link_bytes_ratio <= 1.1
        m = P.write.load_manifest(str(d))
        assert m.generation == 2
        assert ([os.path.basename(p) for p in m.member_paths()]
                == [os.path.basename(p) for p in rep.out_paths])
        _same_cols(_read_all_concat(P, m.member_paths()), want)
        for p in m.member_paths():
            assert _first_page_has_crc(P, p)
        assert all(os.path.exists(p) for p in paths)
        gen2 = (rep.as_dict(), _members(P, d))
        rep2 = P.write.compact(str(d), target_file_bytes=1 << 20, workers=1,
                               remove_inputs=True)
        assert rep2.generation == 3
        _same_cols(_read_all_concat(
            P, P.write.load_manifest(str(d)).member_paths()), want)
        assert all(not os.path.exists(p) for p in rep.out_paths)
        out.append((gen2, rep2.as_dict(), _members(P, d),
                    _bytes(str(d / "tpq_manifest.json"))))
    assert out[0] == out[1]


@pytest.mark.parametrize("codec", ["SNAPPY", "UNCOMPRESSED"])
def test_compaction_codec_and_link_bytes_match_the_reference(tmp_path,
                                                             io_env, codec):
    """The codec re-plan over the whole dataset: the same ratio sample, the
    same ``plan_codec`` triple and the same modeled link bytes before and
    after, on inputs paged in either codec."""
    io_env.setenv("TPQ_LINK_MBPS", LINK_MBPS)
    out = []
    for P, root in zip(BOTH, _dirs(tmp_path)):
        schema = _schema(P)
        d = root / "in"
        d.mkdir()
        paths = []
        for i, b in enumerate(_batches(P, n_rgs=4, rows=2000, seed=7)):
            p = str(d / f"f{i}.parquet")
            _single_writer_file(
                P, p, schema, [b],
                codec=int(getattr(P.format.CompressionCodec, codec)))
            paths.append(p)
        C = P.write_compact
        metas = [P.footer.read_file_metadata(p) for p in paths]
        with P.reader.FileReader(paths[0]) as r:
            ratio = C._sample_snappy_ratio(r.read_row_group(0))
        planner = P.ship.ShipPlanner()
        triple = C.plan_codec(planner, metas,
                              P.schema_core.Schema.from_file_metadata(
                                  metas[0]), ratio)
        rep = P.write.compact(paths, out=str(d), target_file_bytes=1 << 20,
                              workers=1)
        assert rep.codec == triple[0]
        out.append((ratio, triple, rep.as_dict(), _members(P, d)))
    assert out[0] == out[1]


def test_modeled_link_bytes_grid_matches_the_reference(io_env):
    io_env.setenv("TPQ_LINK_MBPS", LINK_MBPS)
    planners = [P.ship.ShipPlanner() for P in BOTH]
    for logical in (0, 1000, 70_000, 1 << 20, 50 << 20):
        for width in (0, 4, 8):
            for comp in (0, logical // 3, logical):
                for flat in (True, False):
                    got = []
                    for P, pl in zip(BOTH, planners):
                        f = P.ship.ChunkFacts(
                            logical=logical, width=width,
                            narrow_possible=width in (4, 8),
                            comp_bytes=comp, host_bytes_ready=not comp,
                            flat=flat)
                        got.append((P.write.modeled_link_bytes(pl, f),
                                    min(pl.costs(f).values())
                                    if logical else None))
                    assert got[0] == got[1], (logical, width, comp, flat)


def test_rewrite_never_touches_previous_generation_members(tmp_path):
    out = []
    for P, root in zip(BOTH, _dirs(tmp_path, "live")):
        d, schema = root / "live", _schema(P)
        r1 = P.write.write_sharded(str(d), schema, _batches(P, n_rgs=3),
                                   workers=2, target_file_bytes=10_000)
        gen1 = {p: _bytes(p) for p in r1.paths}
        r2 = P.write.write_sharded(str(d), schema,
                                   _batches(P, n_rgs=3, seed=9), workers=2,
                                   target_file_bytes=10_000)
        assert r1.generation == 1 and r2.generation == 2
        assert not (set(r1.paths) & set(r2.paths)), "member names collided"
        for p, data in gen1.items():
            assert _bytes(p) == data
        assert P.write.load_manifest(str(d)).generation == 2
        out.append(([os.path.basename(p) for p in r2.paths],
                    [_bytes(p) for p in r2.paths]))
    assert out[0] == out[1]


def test_compaction_service_policy(tmp_path, io_env):
    io_env.setenv("TPQ_LINK_MBPS", LINK_MBPS)
    out = []
    for P, root in zip(BOTH, _dirs(tmp_path)):
        d, _schema_, _paths = _fragmented_dataset(P, root)
        svc = P.write.CompactionService(min_file_bytes=1 << 20,
                                        max_small_files=4,
                                        target_file_bytes=1 << 20)
        assert svc.should_compact(str(d))
        assert not svc.should_compact(str(root / "frag" / "in-000.parquet"))
        broken = root / "broken"
        broken.mkdir()
        (broken / "tpq_manifest.json").write_text("{")
        assert not svc.should_compact(str(broken))  # a typed rejection
        rep = svc.run_once(str(d))
        assert rep is not None and rep.files_after < rep.files_before
        assert svc.run_once(str(d)) is None
        out.append((rep.as_dict(), _members(P, d)))
    assert out[0] == out[1]


def _service(P, **kw):
    if P is PORT:
        kw["device"] = "cpu"
    return P.serve.ScanService(**kw)


def test_writer_driven_generation_bump_exact_invalidation(tmp_path):
    """A real writer rewrite onto a live path drops every cached entry of
    the old generation the moment the publish returns, with the same
    counts in both packages, and the next response is the new file's."""
    seen = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema = _schema(P)
        path = str(d / "live.parquet")
        P.write.write_sharded(path, schema, _batches(P, n_rgs=2, seed=1),
                              workers=2)
        cache = P.serve.PlanCache(result_cache_mb=64)
        with _service(P, concurrency=1, cache=cache) as svc:
            first = svc.scan(P.serve.ScanRequest(path))[path]
            svc.scan(P.serve.ScanRequest(path))
            plan_entries = cache.counters()["entries"]
            res_entries = cache.results.counters()["host"]["entries"]
            inv0_plan = cache.counters()["invalidations"]
            inv0_res = cache.results.counters()["host"]["invalidations"]
            assert plan_entries > 0 and res_entries > 0
            P.write.write_sharded(path, schema, _batches(P, n_rgs=2, seed=2),
                                  workers=2, plan_cache=cache)
            dropped = (cache.counters()["invalidations"] - inv0_plan,
                       cache.results.counters()["host"]["invalidations"]
                       - inv0_res)
            assert dropped == (plan_entries, res_entries)
            after = svc.scan(P.serve.ScanRequest(path))[path]
        with P.reader.FileReader(path) as r:
            fresh = r.read_all()
        _same_cols(after, fresh)
        assert not np.array_equal(np.asarray(first["a"].values),
                                  np.asarray(after["a"].values))
        seen.append((plan_entries, res_entries, dropped))
    assert seen[0] == seen[1]


def test_compaction_mid_sweep_never_torn_or_stale(tmp_path, io_env):
    """The port's serve sweep running while the port compacts twice: every
    response equals the reference's read of the same canonical rows."""
    io_env.setenv("TPQ_LINK_MBPS", LINK_MBPS)
    (root,) = _dirs(tmp_path)[:1]
    d, _schema_, paths = _fragmented_dataset(PORT, root, n_files=6)
    ref_root = tmp_path / "ref_copy"
    _rd, _rs, ref_paths = _fragmented_dataset(REF, ref_root, n_files=6)
    want = _arrays(_read_all_concat(REF, ref_paths))
    cache = PORT.serve.PlanCache(result_cache_mb=32)
    errors: list = []
    stop = threading.Event()
    sweeps = [0]

    def sweep():
        try:
            with _service(PORT, concurrency=2, cache=cache) as svc:
                while not stop.is_set():
                    members = PORT.write.load_manifest(str(d)).member_paths()
                    got: dict = {}
                    for p in members:
                        resp = svc.scan(PORT.serve.ScanRequest(p))[p]
                        for k, v in resp.items():
                            got.setdefault(k, []).append(v)
                    cat = _arrays({k: PORT.reader._concat_column_data(v)
                                   for k, v in got.items()})
                    for k in want:
                        for x, y in zip(cat[k], want[k]):
                            assert np.array_equal(x, y), k
                    sweeps[0] += 1
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    t = threading.Thread(target=sweep)
    t.start()
    try:
        rep = PORT.write.compact(str(d), target_file_bytes=1 << 20,
                                 workers=2, plan_cache=cache)
        assert rep.files_after < rep.files_before
        PORT.write.compact(str(d), target_file_bytes=1 << 20, workers=1,
                           plan_cache=cache)
    finally:
        stop.set()
        t.join(30)
    assert not t.is_alive()
    assert not errors, errors[0]
    assert sweeps[0] >= 1


# ---------------------------------------------------------------------------
# observability: the write section + the doctor's write verdict
# ---------------------------------------------------------------------------

WRITE_KEYS = {
    "workers", "rows", "row_groups", "chunks", "files", "bytes_written",
    "encode_seconds", "compress_seconds", "flush_seconds", "merge_seconds",
    "compact_seconds", "stall_seconds", "wall_seconds", "busy_seconds",
    "rows_per_sec", "bytes_per_sec",
}


def _fill(P, workers, lanes, rows, chunks, files=0):
    st = P.write.WriteStats(workers=workers)
    for stage, s in lanes.items():
        st.add(stage, s)
    st.count_row_group(rows, chunks=chunks)
    for _ in range(files):
        st.count_file(4096)
    st.touch_wall()
    return st


def _no_clock(tree):
    w = dict(tree["write"])
    for k in ("wall_seconds", "rows_per_sec", "bytes_per_sec"):
        w.pop(k, None)
    return w


def test_write_stats_registry_golden_keys_and_merge():
    trees = []
    for P in BOTH:
        st = _fill(P, 3, {"encode": 0.2, "compress": 0.05, "flush": 0.01},
                   100, 2, files=1)
        reg = P.obs.StatsRegistry()
        reg.add_write(st)
        tree = reg.as_dict()
        assert set(tree["write"]) == WRITE_KEYS
        assert "write.encode" in tree["histograms"]
        json.dumps(tree)
        st2 = _fill(P, 2, {"encode": 0.1}, 50, 1)
        reg.add_write(st2)
        t2 = reg.as_dict()
        assert t2["write"]["rows"] == 150 and t2["write"]["workers"] == 3
        assert t2["write"]["encode_seconds"] == pytest.approx(0.3)
        reg2 = P.obs.StatsRegistry()
        reg2.merge_dict(t2)
        assert reg2.as_dict()["write"]["rows"] == 150
        st.merge_from(st2)
        assert st.rows == 150 and st.workers == 3
        sample = st.sample()
        trees.append((_no_clock(tree), _no_clock(t2),
                      sorted(t2["histograms"]), sample))
    assert trees[0] == trees[1]


def test_write_stats_unknown_stage_raises():
    got = [_outcome(P.write.WriteStats().add, "teleport", 1.0) for P in BOTH]
    assert got[0] == got[1]
    assert got[0][1] == "ValueError" and "unknown write stage" in got[0][2]


def test_doctor_attributes_slow_write(tmp_path):
    """Both packages' doctors give the same write verdict on the port's
    registry tree, and the port's on the reference's tree."""
    trees = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        st = P.write.WriteStats()
        P.write.write_sharded(str(d / "w.parquet"), _schema(P),
                              _batches(P, n_rgs=3), workers=2, stats=st)
        reg = P.obs.StatsRegistry()
        reg.add_write(st)
        trees.append(reg.as_dict())
    for tree in trees:
        reps = [P.obs.doctor_registry(tree) for P in BOTH]
        assert reps[0]["write"] == reps[1]["write"]
        w = reps[0]["write"]
        assert w["verdict"].startswith("write-")
        assert w["dominant_lane"] in ("encode", "compress", "flush", "merge",
                                      "compact", "stall")


def test_filewriter_books_write_lanes(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        st = P.write.WriteStats()
        plain = _single_writer_file(
            P, str(d / "plain.parquet"), _schema(P), _batches(P, n_rgs=1),
            codec=P.format.CompressionCodec.SNAPPY)
        booked = _single_writer_file(
            P, str(d / "x.parquet"), _schema(P), _batches(P, n_rgs=1),
            stats=st, codec=P.format.CompressionCodec.SNAPPY)
        assert _bytes(plain) == _bytes(booked)  # stats never change bytes
        dd = st.as_dict()
        assert (dd["rows"], dd["row_groups"], dd["chunks"]) == (800, 1, 3)
        assert dd["encode_seconds"] > 0 and dd["compress_seconds"] > 0
        assert dd["flush_seconds"] > 0
        assert dd["busy_seconds"] <= dd["wall_seconds"] + 0.05
        assert st._stage_hist["encode"].count == 3
        out.append(_bytes(booked))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# budget/backpressure + worker-encode helpers
# ---------------------------------------------------------------------------

def test_sharded_write_respects_memory_budget(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        st = P.write.WriteStats()
        res = P.write.write_sharded(str(d / "b.parquet"), _schema(P),
                                    _batches(P, n_rgs=6), workers=3,
                                    max_memory=1 << 20, stats=st)
        assert res.rows == 4800
        single = _single_writer_file(P, str(d / "s.parquet"), _schema(P),
                                     _batches(P, n_rgs=6))
        assert _bytes(single) == _bytes(str(d / "b.parquet"))
        out.append((_bytes(single),
                    P.write_sharded._batch_cost(_batches(P, n_rgs=1)[0])))
    assert out[0] == out[1]


def test_encode_row_group_blob_is_a_valid_file():
    blobs = []
    for P in BOTH:
        blob, meta = P.write.encode_row_group(_schema(P),
                                              _batches(P, n_rgs=1)[0])
        assert meta.num_rows == 800 and len(meta.row_groups) == 1
        with P.reader.FileReader(io.BytesIO(blob)) as r:
            got = r.read_all()
        assert len(np.asarray(got["a"].values)) == 800
        blobs.append(blob)
    assert blobs[0] == blobs[1]


@pytest.mark.parametrize("workers", [None, "1", "0", "x"])
def test_resolve_write_workers_matches_the_reference(io_env, workers):
    if workers is None:
        io_env.delenv("TPQ_WRITE_WORKERS", raising=False)
    else:
        io_env.setenv("TPQ_WRITE_WORKERS", workers)
    got = [P.write.resolve_write_workers() for P in BOTH]
    assert got[0] == got[1] >= 1
    for arg in (1, 5, 0):
        assert (_outcome(PORT.write.resolve_write_workers, arg)
                == _outcome(REF.write.resolve_write_workers, arg))


def test_write_sharded_rejects_empty_and_bad_layout(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        schema = _schema(P)
        errs = [
            _outcome(P.write.write_sharded, str(d / "e.parquet"), schema, []),
            _outcome(P.write.write_sharded, str(d / "e.parquet"), schema,
                     _batches(P, 1), layout="zipfile"),
            _outcome(P.write.write_sharded, str(d / "nodir"), schema,
                     _batches(P, 1), layout="manifest"),
        ]
        (d / "emptyds").mkdir()
        errs.append(_outcome(P.write.write_sharded, str(d / "emptyds"),
                             schema, []))
        assert [e[:2] for e in errs] == [
            ("raise", "ParquetError"), ("raise", "ValueError"),
            ("raise", "ParquetError"), ("raise", "ParquetError")]
        assert "no row groups" in errs[0][2] and "layout" in errs[1][2]
        assert "directory" in errs[2][2]
        assert _no_temp(d) and _no_temp(d / "emptyds")
        out.append([(e[1], e[2].replace(str(d), "<d>")) for e in errs])
    assert out[0] == out[1]


def test_worker_failure_leaves_no_temp_and_joins_pool(tmp_path):
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        good = _batches(P, n_rgs=2)

        def gen():
            yield good[0]
            raise RuntimeError("producer died")

        e = _outcome(P.write.write_sharded, str(d / "dead.parquet"),
                     _schema(P), gen(), workers=2)
        assert e == ("raise", "RuntimeError", "producer died")
        assert _no_temp(d) and not os.path.exists(d / "dead.parquet")
        out.append(e)
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("tpq-")]
    assert not leaked, leaked
    assert out[0] == out[1]


def test_encode_failure_in_a_worker_leaves_no_temp(tmp_path):
    """A batch the encoder refuses (a column missing) raises through the
    pool: the same error in both packages, no temp file, no thread."""
    out = []
    for P, d in zip(BOTH, _dirs(tmp_path)):
        batches = _batches(P, n_rgs=3)
        del batches[1]["b"]
        e = _outcome(P.write.write_sharded, str(d / "bad.parquet"),
                     _schema(P), batches, workers=2)
        assert e[0] == "raise"
        assert _no_temp(d) and not os.path.exists(d / "bad.parquet")
        out.append(e[1:])
    assert out[0] == out[1]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-")]


# ---------------------------------------------------------------------------
# the spool auto-arm (tests/test_obs_fleet.py)
# ---------------------------------------------------------------------------

def test_loader_and_writer_auto_arm_spool(tmp_path, io_env):
    """The port's ``write_sharded`` and ``DataLoader`` under
    ``TPQ_OBS_SPOOL`` publish a writer and a loader member of one process;
    both packages' aggregators fold them the same way."""
    spool = tmp_path / "spool"
    io_env.setenv("TPQ_OBS_SPOOL", str(spool))
    io_env.setenv("TPQ_OBS_SPOOL_S", "60")
    S, F = PORT.schema_core, PORT.format
    schema = S.build_schema([S.data_column("a", F.Type.INT64,
                                           F.FieldRepetitionType.REQUIRED)])
    rng = np.random.default_rng(0)
    batches = [{"a": rng.integers(0, 1 << 20, 400)} for _ in range(3)]
    out = str(tmp_path / "data.parquet")
    PORT.write.write_sharded(out, schema, batches, workers=2)
    roles = {json.load(open(spool / f))["role"]
             for f in os.listdir(spool) if f.endswith(".json")}
    assert "writer" in roles
    n = 0
    for batch in PORT.data.DataLoader([out], 300, columns=["a"],
                                      shuffle=False):
        n += len(batch["a"])
    assert n == 1200
    assert not [t for t in threading.enumerate()
                if t.name.startswith("tpq-spool")]
    snaps = [P.obs_fleet.FleetAggregator(spool_dir=str(spool)).scan()
             for P in BOTH]
    for snap in snaps:
        assert snap["rejected"] == 0
        assert snap["registry"]["write"]["rows"] == 1200
        assert len(snap["processes"]) == 1
        (proc,) = snap["processes"].values()
        assert proc["role"] == "loader+writer"
        assert proc["registry"]["write"]["rows"] == 1200
        assert proc["registry"]["loader"]["batches"] == 4
    assert (snaps[0]["registry"]["write"]["rows"],
            sorted(snaps[0]["processes"]))== (
        snaps[1]["registry"]["write"]["rows"], sorted(snaps[1]["processes"]))
