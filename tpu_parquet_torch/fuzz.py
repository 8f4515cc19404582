"""Mutation fuzzing for the host-side parse surface.

The reference fuzzes four surfaces with go-fuzz (reader_fuzz.go:12-31,
hybrid_fuzz.go:12-35, deltabp_fuzz.go:10-25, types_fuzz.go) and replays every
crasher as a regression test (fuzz_test.go:11-28).  The contract here is the
same, adapted to Python: feeding ANY bytes to a target may raise
``ParquetError`` (the unified malformed-input error, errors.py) or return
normally — any other exception, a hang, or a crash is a finding.  The native
C walkers are additionally held to *differential* parity: where both the C
and the pure-Python walk accept an input, their outputs must match, and they
must agree on rejection.

Two targets touch the device: ``device_reader`` decodes through
``DeviceFileReader`` and ``result_cache`` keeps its device tier's entries as
tensors there.  Their device is ``cuda`` unless ``run_fuzz(device=)`` or
``--device`` names another; without a card the default raises, and nothing
falls back to the CPU.

Run:  ``python -m tpu_parquet_torch.fuzz --runs 20000 [--target all]
[--seed 0] [--device cuda|cpu] [--replay DIR ...] [--no-save]
[--target-runs NAME=N ...] [--json PATH]``.
Crashers are minimized (greedy chunk deletion) and written to
``tests/fuzz_corpus_torch/<target>-<sha>`` for check-in (the package's own
corpus; ``tests/fuzz_corpus/`` is the JAX package's, whose targets replay
it).  ``tests/test_torch_fuzz.py`` replays both directories and runs a
deterministic smoke batch.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import sys
import time

import numpy as np

from .errors import ParquetError

__all__ = ["TARGETS", "DEVICE_TARGETS", "target_fn", "corpus_files", "replay",
           "run_fuzz", "minimize", "mutate"]

_TESTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests")
# where new crashers go; REPLAY_DIRS are every corpus the targets hold
_CORPUS_DIR = os.path.join(_TESTS_DIR, "fuzz_corpus_torch")
REPLAY_DIRS = (os.path.join(_TESTS_DIR, "fuzz_corpus"), _CORPUS_DIR)


# ---------------------------------------------------------------------------
# targets: bytes -> None (raise ParquetError for malformed input, nothing else)
# ---------------------------------------------------------------------------

def fuzz_file_reader(data: bytes) -> None:
    """Whole-file surface: footer thrift → schema → pages → rows
    (FuzzFileReader, reader_fuzz.go:12-31)."""
    from .reader import FileReader

    try:
        r = FileReader(io.BytesIO(data))
    except ParquetError:
        return
    try:
        for _ in r.iter_rows():
            pass
    except ParquetError:
        pass
    finally:
        r.close()


def fuzz_thrift(data: bytes) -> None:
    """Bare compact-protocol struct decode (the fuzz_test.go:11-28 bombs
    attack exactly this layer)."""
    from .format import FileMetaData
    from .thrift import read_struct

    try:
        read_struct(FileMetaData, data)
    except ParquetError:
        pass


def fuzz_hybrid(data: bytes) -> None:
    """RLE/bit-packed hybrid: host decode + native/Python walk parity
    (FuzzHybrid, hybrid_fuzz.go:12-35)."""
    from . import torch_decode as jd
    from .kernels import rle

    if not data:
        return
    width = data[0] % 33
    count = (data[1] if len(data) > 1 else 0) % 512
    payload = data[2:]
    try:
        rle.decode(payload, width, count)
    except ParquetError:
        pass
    _walk_parity(
        lambda: jd._native_hybrid_meta(payload, len(payload), 0, width, count, True)
        if count else None,
        lambda: jd._parse_hybrid_meta_py(payload, width, count, 0, len(payload)),
        ("run_ends", "run_is_rle", "run_values", "run_bit_starts"),
        note=f"hybrid width={width} count={count}",
    )


def fuzz_delta(data: bytes) -> None:
    """DELTA_BINARY_PACKED: host decode + native/Python walk parity
    (FuzzDelta, deltabp_fuzz.go:10-25)."""
    from . import torch_decode as jd
    from .kernels import delta

    if not data:
        return
    bits = 32 if data[0] & 1 else 64
    payload = data[1:]
    try:
        delta.decode(payload, bits=bits)
    except ParquetError:
        pass
    _walk_parity(
        lambda: jd._native_delta_meta(payload, 0),
        lambda: jd._parse_delta_meta_py(payload, bits, 0),
        ("mini_bit_starts", "mini_widths", "mini_min_delta"),
        note=f"delta bits={bits}",
    )


def _walk_parity(native_fn, py_fn, array_fields, note=""):
    try:
        a = native_fn()
    except ParquetError:
        a = ParquetError
    try:
        b = py_fn()
    except ParquetError:
        b = ParquetError
    if a is None:  # native library unavailable / skipped
        return
    if (a is ParquetError) != (b is ParquetError):
        raise AssertionError(
            f"native/python rejection mismatch ({note}): "
            f"native={'reject' if a is ParquetError else 'accept'} "
            f"python={'reject' if b is ParquetError else 'accept'}"
        )
    if a is ParquetError:
        return
    for f in array_fields:
        av, bv = getattr(a, f), getattr(b, f)
        if not np.array_equal(av, bv):
            raise AssertionError(f"native/python {f} mismatch ({note})")
    if a.consumed != b.consumed:
        raise AssertionError(f"native/python consumed mismatch ({note})")


def fuzz_plain(data: bytes) -> None:
    """Per-type PLAIN decoders (FuzzBooleanPlain & friends, types_fuzz.go)."""
    from .format import Type
    from .kernels import plain

    if len(data) < 2:
        return
    types = [Type.BOOLEAN, Type.INT32, Type.INT64, Type.INT96, Type.FLOAT,
             Type.DOUBLE, Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY]
    ptype = types[data[0] % len(types)]
    count = data[1] % 256
    try:
        plain.decode(data[2:], ptype, count, type_length=5)
    except ParquetError:
        pass


def fuzz_schema_dsl(data: bytes) -> None:
    """Schema-definition parser (schemaParser.recover surface,
    schema_parser.go:285-298)."""
    from .schema.dsl import parse_schema_definition

    try:
        parse_schema_definition(data.decode("utf-8", errors="replace"))
    except ParquetError:
        pass


def fuzz_device_reader(data: bytes, device=None) -> None:
    """Differential: batched device decoder vs host reader on the same bytes.

    The staging/bucketing/fused-dispatch logic (device_reader.py) and the
    kernel wrappers' checks are attack surface none of the host targets
    touch.  Contract: the two paths must agree on acceptance, and for
    accepted files every column's values and def levels must match bit for
    bit.  ``device`` is the device reader's: ``cuda`` (the hand-written
    kernels) unless the caller names another; ``"cpu"`` runs their plain
    versions.
    """
    from .device_reader import DeviceFileReader
    from .reader import FileReader
    from .torch_decode import _resolve_device

    device = _resolve_device(device, "fuzz_device_reader")

    try:
        host_cols: dict = {}
        with FileReader(io.BytesIO(data)) as r:
            for rg in r.iter_row_groups():
                for k, v in rg.items():
                    host_cols.setdefault(k, []).append(v)
        host_err = None
    except ParquetError as e:
        host_err = e
    try:
        dev_cols: dict = {}
        with DeviceFileReader(io.BytesIO(data), device=device) as r:
            for rg in r.iter_row_groups():
                for k, v in rg.items():
                    dev_cols.setdefault(k, []).append(v)
        dev_err = None
    except ParquetError as e:
        dev_err = e
    if (host_err is None) != (dev_err is None):
        h = repr(host_err) if host_err else "accept"
        d = repr(dev_err) if dev_err else "accept"
        raise AssertionError(f"host/device acceptance mismatch: host={h} device={d}")
    if host_err is not None:
        return
    if set(host_cols) != set(dev_cols):
        raise AssertionError(
            f"column sets differ: {sorted(host_cols)} vs {sorted(dev_cols)}"
        )
    from .column import ByteArrayData

    for k, hlist in host_cols.items():
        dlist = dev_cols[k]
        if len(hlist) != len(dlist):
            raise AssertionError(
                f"row group count differs in {k}: {len(hlist)} vs {len(dlist)}"
            )
        for h, d in zip(hlist, dlist):
            dh = d.to_host()
            hv = h.values
            if isinstance(hv, ByteArrayData):
                if not (np.array_equal(hv.offsets, dh.offsets)
                        and np.array_equal(hv.heap, dh.heap)):
                    raise AssertionError(f"byte-array values differ in {k}")
            elif not np.array_equal(np.asarray(hv), np.asarray(dh)):
                raise AssertionError(f"values differ in {k}")
            dd, dr = d.levels_to_host()
            for name, hl, dl in (("def", h.def_levels, dd),
                                 ("rep", h.rep_levels, dr)):
                if (hl is None) != (dl is None) or (
                    hl is not None and not np.array_equal(hl, dl)
                ):
                    raise AssertionError(f"{name} levels differ in {k}")


# the leaves a ``chunk_walk`` blob may name (its byte 1, modulo their count)
_WALK_TYPES = ("INT64", "DOUBLE", "BYTE_ARRAY", "INT32")


def _walk_frame(codec: int, kind: int, total: int, chunk: bytes,
                crc: bool = True) -> bytes:
    """A ``chunk_walk`` blob: the codec and the CRC check (byte 0: bit 0
    SNAPPY, else UNCOMPRESSED; bit 1 set, page CRCs not checked, so the
    mutants of a payload reach the decompression and the run walks), the
    leaf's type (byte 1, an index into ``_WALK_TYPES``), the chunk's value
    count (bytes 2-5, little-endian) and the chunk's bytes."""
    return (bytes([codec | (0 if crc else 2), kind])
            + int(total).to_bytes(4, "little") + chunk)


@functools.lru_cache(maxsize=None)
def _walk_leaf(kind: int):
    from .format import FieldRepetitionType as FRT, Type
    from .schema.core import build_schema, data_column

    return build_schema([data_column(
        "c", Type[_WALK_TYPES[kind]], FRT.REQUIRED)]).leaves[0]


def _walk_outcome(walk: bool, codec: int, total: int, leaf, chunk: bytes,
                  crc: bool = True):
    """One collection of a chunk (``device_reader._collect_chunk_as``) and
    its plan, as comparable values: the pages, the dictionary and the
    pruning count, then the staged bytes, the plan's arguments and the ship
    records — or the ParquetError either step raised."""
    import torch

    from . import device_reader as DR
    from .ship import default_planner

    def b(x):
        return None if x is None else bytes(np.frombuffer(x, np.uint8))

    try:
        asm = DR._collect_chunk_as(walk, chunk, codec, total, leaf, [],
                                   validate_crc=crc,
                                   device=torch.device("cpu"))
    except ParquetError as e:
        return "collect", type(e).__name__, str(e)
    pages = [(p.num_values, p.defined, p.encoding, p.value_pos, b(p.raw),
              None if p.comp is None else (b(p.comp[0]), p.comp[2]))
             for p in asm.pages]
    rag = asm.dict_ragged
    state = (pages, asm.pages_pruned, asm.dict_len, b(asm.dict_u8),
             None if rag is None else (b(rag.offsets), b(rag.heap)),
             None if asm.dict_comp is None else b(asm.dict_comp[0]))
    if not asm.pages:
        return "collected", state
    try:
        asm.preship(default_planner())
        stager = DR._RowGroupStager()
        plan = asm.finish(stager)
        buf = np.zeros(stager.size(), np.uint8)
        stager.fill(buf)
        return ("planned", state, buf.tobytes(), repr(plan.dyn),
                asm.ship_records, asm._deferred)
    except ParquetError as e:
        return "finish", state, type(e).__name__, str(e)


def fuzz_chunk_walk(data: bytes) -> None:
    """Differential: the device reader's chunk walk (``chunk_walk``: a
    column chunk's page headers, CRCs, decompression and dictionary-index
    run walks in a few native calls) against the page loop it replaces, on
    one framed column chunk (``_walk_frame``).  The two must raise the same
    error, or give the same pages, dictionary, staged bytes and plan."""
    if len(data) < 6:
        raise ParquetError("chunk_walk blob shorter than its frame")
    codec, crc = data[0] & 1, not data[0] & 2
    leaf = _walk_leaf(data[1] % len(_WALK_TYPES))
    total = int.from_bytes(data[2:6], "little") & 0xFFFFF
    chunk = data[6:]
    want = _walk_outcome(False, codec, total, leaf, chunk, crc)
    got = _walk_outcome(True, codec, total, leaf, chunk, crc)
    if got != want:
        raise AssertionError(f"chunk walk differs from the page loop: "
                             f"{got!r:.300} != {want!r:.300}")
    if want[0] in ("collect", "finish"):
        raise ParquetError(want[-1])


def _chunk_walk_seeds() -> "list[bytes]":
    """Column chunks of the port writer's files, framed for ``chunk_walk``:
    dictionary and PLAIN INT64, PLAIN DOUBLE and dictionary strings, in
    SNAPPY and UNCOMPRESSED, small pages, page CRCs checked and not."""
    import io as _io

    from .column import ByteArrayData, ColumnData
    from .footer import read_file_metadata
    from .format import CompressionCodec, FieldRepetitionType as FRT, Type
    from .schema.core import build_schema, data_column
    from .writer import FileWriter

    rng = np.random.default_rng(0)
    n = 600
    words = [b"alpha", b"", b"bb", b"gamma-gamma", b"x"]
    svals = [words[i] for i in rng.integers(0, len(words), n)]
    files = [  # (dictionary on, {name: (type, values)})
        (True, {"d": (Type.INT64, rng.integers(0, 40, n)),
                "s": (Type.BYTE_ARRAY, ColumnData(values=ByteArrayData(
                    offsets=np.cumsum([0] + [len(v) for v in svals]),
                    heap=np.frombuffer(b"".join(svals), np.uint8).copy())))}),
        (False, {"p": (Type.INT64, rng.integers(-(1 << 50), 1 << 50, n)),
                 "f": (Type.DOUBLE, rng.random(n))}),
    ]
    out = []
    for codec in (CompressionCodec.SNAPPY, CompressionCodec.UNCOMPRESSED):
        for use_dict, cols in files:
            sink = _io.BytesIO()
            schema = build_schema([data_column(k, t, FRT.REQUIRED)
                                   for k, (t, _) in cols.items()])
            with FileWriter(sink, schema, codec=codec, page_size=1024,
                            use_dictionary=use_dict, write_crc=True) as w:
                w.write_columns({k: v for k, (_, v) in cols.items()})
            whole = sink.getvalue()
            for c in read_file_metadata(whole).row_groups[0].columns:
                m = c.meta_data
                start = min(x for x in (m.dictionary_page_offset,
                                        m.data_page_offset)
                            if x is not None)
                kind = _WALK_TYPES.index(Type(m.type).name)
                for crc in (True, False):
                    out.append(_walk_frame(
                        int(codec), kind, m.num_values,
                        whole[start : start + m.total_compressed_size],
                        crc))
    return out


def fuzz_page_header(data: bytes) -> None:
    """Native vs python PageHeader parse parity (the C parser replicates
    thrift.py's compact-protocol semantics byte for byte — same
    accept/reject set, same consumed length, same extracted fields,
    INCLUDING each data page header's Statistics sub-struct)."""
    from . import native
    from .format import PageHeader
    from .thrift import ThriftError, read_struct

    res = native.page_header(data, 0)
    if res is None:
        return  # no native library: nothing to differentiate
    try:
        py, py_end = read_struct(PageHeader, data, 0)
    except ThriftError:
        py = ThriftError
    if isinstance(res, int):
        if py is not ThriftError:
            raise AssertionError(
                f"native rejected ({res}) where python accepted"
            )
        return
    if py is ThriftError:
        raise AssertionError("native accepted where python rejected")
    c, c_end = res
    if c_end != py_end:
        raise AssertionError(f"consumed mismatch: {c_end} != {py_end}")
    if c != py:
        raise AssertionError(f"field mismatch: {c!r} != {py!r}")


def fuzz_snappy(data: bytes) -> None:
    """Native vs pure-Python raw-snappy differential: identical accept/reject
    set and identical output bytes (the C fast paths — blind 16-byte literal
    stores, 8-byte stride copies — must be invisible)."""
    from . import native
    from .compress import CompressionError, _py_snappy_decompress

    if not native.available():
        return
    try:
        want = _py_snappy_decompress(data, max_size=1 << 22)
        py_ok = True
    except CompressionError:
        py_ok = False
    try:
        got = native.snappy_decompress(data, max_size=1 << 22)
        c_ok = True
    except (ValueError, RuntimeError):
        c_ok = False
    if py_ok != c_ok:
        raise AssertionError(f"snappy acceptance mismatch: py={py_ok} c={c_ok}")
    if py_ok and bytes(got) != want:
        raise AssertionError("snappy output mismatch")


def fuzz_snappy_plan(data: bytes) -> None:
    """Device-snappy PLANNER differential (the round-4 native surface the
    compressed-page shipping path trusts): ``tpq_snappy_plan``'s op tables,
    resolved sequentially on host with the device resolver's copy semantics
    (out[dst+j] = out[dst - off + (j % off)]), must reproduce
    ``tpq_snappy_decompress`` byte for byte — and the two must agree on the
    accept/reject set."""
    from . import native

    if not native.available():
        return
    try:
        out = native.snappy_decompress(data, max_size=1 << 20)
        dec_ok = True
    except (ValueError, RuntimeError):
        dec_ok = False
    plan = native.snappy_plan(data, len(out) if dec_ok else (1 << 20))
    if plan is None:
        return
    plan_ok = not isinstance(plan, int)
    if plan_ok != dec_ok:
        raise AssertionError(
            f"plan/decompress acceptance mismatch: plan={plan} dec={dec_ok}")
    if not dec_ok:
        return
    dst_end, op_src, is_lit, depth = plan
    res = np.zeros(len(out), dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    pos = 0
    for e, s, lit in zip(dst_end, op_src, is_lit):
        e = int(e)
        n = e - pos
        if lit:
            res[pos:e] = src[int(s) : int(s) + n]
        else:
            off = int(s)
            # a plan op with off=0 or off>pos is itself a planner bug (the
            # decompressor rejects those streams); assert rather than let
            # numpy negative-index wraparound mask it against zero tails
            if not 1 <= off <= pos:
                raise AssertionError(f"plan copy offset {off} at pos {pos}")
            # device copy semantics: j-th byte reads dst_start - off + j%off
            idx = pos - off + (np.arange(n) % off)
            res[pos:e] = res[idx]
        pos = e
    if depth < 0 or pos != len(out):
        raise AssertionError(f"plan shape bad: end={pos} depth={depth}")
    if res.tobytes() != bytes(out):
        raise AssertionError("plan resolution diverges from decompress")


def fuzz_snappy_ops(data: bytes) -> None:
    """Fuzz target #13: hostile compressed streams against the op-table ship
    planner (the surface every compressed-shipping route trusts — ship.py).

    Beyond fuzz_snappy_plan's host-resolver output differential, this target
    asserts the STRUCTURAL invariants the device resolver
    (jax_kernels.snappy_resolve) assumes of every ACCEPTED plan:

    - ``dst_end`` strictly increasing, ending exactly at the stream's
      declared output size (monotonicity is what searchsorted needs);
    - literal sources within the compressed payload;
    - copy offsets ``1 <= off <= dst_start`` (overlapping RLE-style copies
      included — the mod-form source math relies on it);
    - chain depth within [0, n_ops] and op count within the n/2+2 bound
      (the cap-retry path in native.snappy_plan);
    - a DECLARED-SIZE LIE (first fuzz byte perturbs the expect argument)
      must be rejected exactly like the decompressor's bomb guard.

    Any violated invariant would make the device expansion read garbage
    silently — the resolver has no bounds it can raise from.
    """
    from . import native

    if not native.available() or len(data) < 1:
        return
    bias = data[0] % 5 - 2  # perturb the declared size by -2..+2
    payload = data[1:]
    try:
        out = native.snappy_decompress(payload, max_size=1 << 20)
        ulen = len(out)
        dec_ok = True
    except (ValueError, RuntimeError):
        ulen = 1 << 10
        dec_ok = False
    expect = max(ulen + bias, 0)  # clamped: what the planner is actually told
    plan = native.snappy_plan(payload, expect)
    plan_ok = not isinstance(plan, int) and plan is not None
    # a negative bias on an empty stream clamps back to the true size — the
    # planner legitimately accepts that call, so the oracle must too
    want_ok = dec_ok and expect == ulen
    if plan_ok != want_ok:
        raise AssertionError(
            f"plan acceptance mismatch: plan_ok={plan_ok} dec_ok={dec_ok} "
            f"bias={bias}")
    if not plan_ok:
        return
    dst_end, op_src, is_lit, depth = plan
    n_ops = len(dst_end)
    if n_ops > len(payload) // 2 + 2:
        raise AssertionError(f"op count {n_ops} above the n/2+2 bound")
    if not 0 <= depth <= max(n_ops, 1):
        raise AssertionError(f"chain depth {depth} outside [0, {n_ops}]")
    pos = 0
    for e, s, lit in zip(dst_end, op_src, is_lit):
        e, s = int(e), int(s)
        if e <= pos:
            raise AssertionError(f"dst_end not increasing at {pos}: {e}")
        run = e - pos
        if lit:
            if s < 0 or s + run > len(payload):
                raise AssertionError(
                    f"literal source [{s}, {s + run}) outside payload")
        else:
            if not 1 <= s <= pos:
                raise AssertionError(f"copy offset {s} at pos {pos}")
        pos = e
    if pos != ulen:
        raise AssertionError(f"plan output {pos} != declared {ulen}")


def fuzz_narrow(data: bytes) -> None:
    """Narrow-int transcode differential (the round-4 transfer-cut path):
    minmax + k-byte truncate + widen-and-rebias must reconstruct the source
    values exactly, for both widths, at every alignment the planner uses."""
    from . import native
    from .device_reader import _narrow_max_k, _span_bytes

    if not native.available() or len(data) < 8:
        return
    for width, dt in ((8, np.int64), (4, np.int32)):
        n = len(data) // width
        if n == 0:
            continue
        vals = np.frombuffer(data[: n * width], dtype=dt)
        mm = native.int_minmax(data, 0, n, width)
        mn, mx = int(vals.min()), int(vals.max())
        if mm != (mn, mx):
            raise AssertionError(f"minmax mismatch w{width}: {mm} != {(mn, mx)}")
        k = _span_bytes(mn, mx)
        if k > _narrow_max_k(width):
            continue  # planner would decline; nothing to transcode
        out = np.empty(n * k, dtype=np.uint8)
        assert native.int_truncate(data, 0, n, width, mn, k, out)
        # widen: little-endian k-byte rows -> u64 -> + bias -> dtype wrap
        rows = out.reshape(n, k).astype(np.uint64)
        acc = np.zeros(n, dtype=np.uint64)
        for b in range(k):
            acc |= rows[:, b] << np.uint64(8 * b)
        got = (acc + np.uint64(mn % (1 << 64))).astype(np.uint64).astype(dt)
        if not np.array_equal(got, vals):
            raise AssertionError(f"narrow roundtrip diverges (w{width}, k={k})")


_FUZZ_LOADER = None


def _loader_for_fuzz():
    """A tiny two-row-group DataLoader over a temp file, built once.

    The restore surface is pure cursor math, so one canned loader covers it;
    mutated states that survive unpack mostly die on the config fingerprint,
    and the few that are genuinely compatible drive a real one-batch pull.
    """
    global _FUZZ_LOADER
    if _FUZZ_LOADER is None:
        import tempfile

        from .data import DataLoader
        from .format import CompressionCodec, FieldRepetitionType as FRT, Type
        from .schema.core import build_schema, data_column
        from .writer import FileWriter

        path = os.path.join(tempfile.mkdtemp(prefix="tpq_fuzz_loader_"),
                            "tiny.parquet")
        schema = build_schema([data_column("v", Type.INT64, FRT.REQUIRED)])
        rng = np.random.default_rng(0)
        with FileWriter(path, schema,
                        codec=CompressionCodec.UNCOMPRESSED) as w:
            for _ in range(2):
                w.write_columns({"v": rng.integers(0, 1 << 30, 60)})
                w.flush_row_group()
        _FUZZ_LOADER = DataLoader(path, 16, shuffle=True, seed=7,
                                  shuffle_window=32)
    return _FUZZ_LOADER


def fuzz_loader_state(data: bytes) -> None:
    """Checkpoint-blob surface (data/checkpoint.py): ANY bytes must either
    unpack+restore cleanly or raise a tpu_parquet_torch.errors type —
    truncated, bit-flipped, and version-bumped blobs must never crash or
    silently mis-seek the loader."""
    from .data import checkpoint as ck

    try:
        st = ck.unpack_state(data)
    except ParquetError:
        return
    # accepted: the state must round-trip the pack/unpack pair exactly
    st2 = ck.unpack_state(ck.pack_state(st))
    if st2 != st:
        raise AssertionError(f"state round-trip diverges: {st} != {st2}")
    loader = _loader_for_fuzz()
    pristine = loader.state()  # FULL reset below, seed included: a seed
    # adopted from one input must never leak into the next input's run, or
    # corpus replays of a single crasher stop reproducing
    try:
        loader.restore(st)
    except ParquetError:
        return
    try:
        # a state the loader ADOPTED must be iterable: a crash (or a yielded
        # batch of the wrong shape) here is a mis-seek the validator missed
        batch = next(iter(loader), None)
        if batch is not None and len(batch["v"]) != loader.batch_size:
            raise AssertionError(f"restored batch shape {len(batch['v'])}")
    finally:
        loader.restore(pristine)


def fuzz_io_ranges(data: bytes) -> None:
    """Fuzz target #14: the range-coalescing planner + a store that lies.

    Blob layout: byte 0 picks the gap threshold, byte 1 the span cap, byte
    2 the store's lie mode, then 5-byte records (3-byte offset, 2-byte
    size) describe the ranges.  Invariants of ``plan_coalesced`` (the
    surface every coalesced fetch trusts):

    - deterministic: two plans over the same inputs are identical;
    - covering: every nonzero input range lands in exactly one group, with
      multiplicity, and inside its group's span;
    - bounded: groups are sorted and disjoint, no group bridges a hole
      wider than the gap threshold, and a group merged across HOLES never
      exceeds the span cap (only overlap-forced merges may — disjointness
      outranks the cap);

    then every member is read through a :class:`CoalescedFetcher` over a
    deterministic store whose span responses may lie about size (short or
    overlong): each read must either return the exact true bytes (the
    degradation ladder recovered via single-range fetches) or raise an
    IOError-rooted retry error — never crash, never silently return wrong
    bytes.
    """
    from .errors import RetryExhaustedError, TransientIOError
    from .iostore import (CoalescedFetcher, GenericRangeStore, IOConfig,
                          plan_coalesced)

    if len(data) < 3:
        return
    gap = [0, 1, 16, 256, 1 << 16][data[0] % 5]
    max_span = [128, 1 << 12, 1 << 20][data[1] % 3]
    lie_mode = data[2] % 3  # 0 honest, 1 short, 2 overlong
    payload = data[3:]
    ranges = []
    for i in range(0, len(payload) - 4, 5):
        off = int.from_bytes(payload[i : i + 3], "little")
        size = int.from_bytes(payload[i + 3 : i + 5], "little")
        ranges.append((off, size))
    if len(ranges) > 64:
        ranges = ranges[:64]

    plan = plan_coalesced(ranges, gap, max_span)
    again = plan_coalesced(list(reversed(ranges)), gap, max_span)
    if [g.key() for g in plan] != [g.key() for g in again]:
        raise AssertionError("coalescing plan is input-order dependent")
    want = {}
    for off, size in ranges:
        if size > 0:
            want[(off, size)] = want.get((off, size), 0) + 1
    got = {}
    prev_end = None
    for g in plan:
        if prev_end is not None and g.offset < prev_end:
            raise AssertionError("groups overlap or are unsorted")
        prev_end = g.offset + g.size
        ends = sorted((o, o + s) for (o, s) in g.members)
        if ends[0][0] != g.offset or max(e for _o, e in ends) != prev_end:
            raise AssertionError("group span does not hug its members")
        cover_end = None
        has_overlap = False
        for o, e in ends:
            if cover_end is not None:
                if o - cover_end > gap:
                    raise AssertionError(
                        f"group bridges a hole wider than {gap}")
                has_overlap = has_overlap or o < cover_end
            cover_end = e if cover_end is None else max(cover_end, e)
        if len(g.members) > 1 and g.size > max_span and not has_overlap:
            raise AssertionError(f"merged span {g.size} exceeds cap {max_span}")
        for m, n in g.members.items():
            if not (g.offset <= m[0] and m[0] + m[1] <= prev_end):
                raise AssertionError("member outside its group span")
            got[m] = got.get(m, 0) + n
    if got != want:
        raise AssertionError(f"coverage broken: {got} != {want}")

    # a store that lies about coalesced-span sizes must degrade, not corrupt
    file_size = 1 << 18
    member_max = max((s for _o, s in want), default=0)

    class _LyingStore(GenericRangeStore):
        def size(self):
            return file_size

        def _fetch_once(self, offset, size, timeout):
            true = bytes((offset + j) % 251 for j in range(
                min(size, max(file_size - offset, 0))))
            if lie_mode == 0 or size <= member_max:
                return true  # honest (single-member reads always are)
            if lie_mode == 1:
                return true[: size // 2]  # short, not at EOF
            return true + b"\x00" * 7  # overlong

    store = _LyingStore(config=IOConfig(retries=1, backoff_ms=0,
                                        retry_budget=0, coalesce_gap=gap))
    fetcher = CoalescedFetcher(store, list(want), gap=gap, max_span=max_span)
    for off, size in want:
        if off >= file_size:
            continue  # fully past EOF: short returns are legitimate
        expect = bytes((off + j) % 251
                       for j in range(min(size, file_size - off)))
        try:
            buf = fetcher.read(off, size)
        except (RetryExhaustedError, TransientIOError):
            continue  # clean failure is an accepted outcome
        if bytes(buf) != expect:
            raise AssertionError(
                f"lying store corrupted range [{off}, {off + size})")


_PAGE_CORRUPT_BASE = None


def _page_corrupt_base():
    """A small CRC'd 2-column × 3-row-group parquet image + oracle, built
    once: (file bytes, per-row-group byte spans, clean per-group decodes).
    The spans let the target tell which row groups a blob's flips touched —
    the untouched ones are the wrong-data oracle."""
    global _PAGE_CORRUPT_BASE
    if _PAGE_CORRUPT_BASE is None:
        import io as _io

        from .chunk_decode import validate_chunk_meta
        from .footer import read_file_metadata
        from .format import CompressionCodec, FieldRepetitionType as FRT, Type
        from .reader import FileReader
        from .schema.core import Schema, build_schema, data_column
        from .writer import FileWriter

        rng = np.random.default_rng(5)
        sink = _io.BytesIO()
        schema = build_schema([
            data_column("a", Type.INT64, FRT.REQUIRED),
            data_column("b", Type.INT32, FRT.REQUIRED),
        ])
        with FileWriter(sink, schema, codec=CompressionCodec.SNAPPY,
                        write_crc=True) as w:
            for _ in range(3):
                w.write_columns({
                    "a": rng.integers(0, 1 << 40, 150),
                    "b": rng.integers(0, 1 << 20, 150).astype(np.int32),
                })
                w.flush_row_group()
        whole = sink.getvalue()
        md = read_file_metadata(_io.BytesIO(whole))
        fschema = Schema.from_file_metadata(md)
        leaves = {l.path: l for l in fschema.leaves}
        spans = []
        for rg in md.row_groups:
            lo, hi = 1 << 62, 0
            for cc in rg.columns:
                cmd, off = validate_chunk_meta(
                    cc, leaves[tuple(cc.meta_data.path_in_schema)])
                lo = min(lo, off)
                hi = max(hi, off + cmd.total_compressed_size)
            spans.append((lo, hi))
        clean = []
        with FileReader(whole) as r:
            for i in range(r.num_row_groups):
                clean.append({k: np.asarray(v.values)
                              for k, v in r.read_row_group(i).items()})
        _PAGE_CORRUPT_BASE = (whole, spans, clean)
    return _PAGE_CORRUPT_BASE


def fuzz_page_corrupt(data: bytes) -> None:
    """Fuzz target #15: crafted page corruption through the policy engine.

    Blob layout: byte 0 picks the error policy, byte 1 the validate mode,
    byte 2 the budget, byte 3 the prefetch depth; then 4-byte records
    (3-byte position, 1-byte xor mask) flip bytes of the DATA region of a
    small CRC'd file (the footer is left alone — the footer's own fuzz
    surface is the file_reader target).  Invariants:

    - no hang, no unclassified crash: every outcome is a clean read, a
      ``ParquetError``-rooted raise (``DataIntegrityError`` included), or
      a clean skip — the crash oracle (run_fuzz) enforces the type;
    - no wrong data: row groups whose byte span is UNTOUCHED decode
      bit-identically to the clean image, under every policy;
    - exact accounting: under a skip policy, every quarantine record names
      a row group whose span was actually touched — nothing else is ever
      quarantined.
    """
    from .errors import DataIntegrityError
    from .quarantine import ErrorBudget, Quarantine
    from .reader import FileReader

    if len(data) < 8:
        return
    whole, spans, clean = _page_corrupt_base()
    policy = ("raise", "skip_unit", "skip_file")[data[0] % 3]
    validate = (None, False)[data[1] % 2]
    tiny_budget = data[2] % 4 == 0
    prefetch = (0, 2)[data[3] % 2]
    payload = data[4:]
    data_lo = min(lo for lo, _hi in spans)
    data_hi = max(hi for _lo, hi in spans)
    buf = bytearray(whole)
    touched: set[int] = set()
    n_flips = 0
    for i in range(0, len(payload) - 3, 4):
        if n_flips >= 32:
            break
        pos = data_lo + (int.from_bytes(payload[i : i + 3], "little")
                         % (data_hi - data_lo))
        xor = payload[i + 3] or 0xFF
        buf[pos] ^= xor
        n_flips += 1
        for gi, (lo, hi) in enumerate(spans):
            if lo <= pos < hi:
                touched.add(gi)
    q = Quarantine(policy, budget=(ErrorBudget(1, 1.0) if tiny_budget
                                   else ErrorBudget()))
    try:
        with FileReader(bytes(buf), validate_crc=validate,
                        prefetch=prefetch, quarantine=q) as r:
            list(r.iter_row_groups())
    except DataIntegrityError as e:
        if not touched:
            raise AssertionError(
                "budget exhausted with no touched row group")
        for rec in e.records:
            if rec.get("row_group") not in touched:
                raise AssertionError(
                    f"quarantined untouched row group {rec}")
        return
    except ParquetError:
        return  # classified raise: the accepted failure mode
    for rec in q.log.snapshot():
        if rec.get("row_group") not in touched:
            raise AssertionError(f"quarantined untouched row group {rec}")
    # untouched row groups must decode bit-identically on a fresh reader
    with FileReader(bytes(buf)) as r:
        for gi in range(r.num_row_groups):
            if gi in touched:
                continue
            out = r.read_row_group(gi, prefetch=0)
            for k, want in clean[gi].items():
                got = np.asarray(out[k].values)
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(
                        f"untouched row group {gi} column {k} diverged")


def crafted_page_corrupt_blobs() -> "list[bytes]":
    """Hand-crafted ``page_corrupt`` inputs (and corpus blobs): one flip in
    a CRC-covered payload (skip_unit), a page-header flip (raise), a
    dictionary/zero-region multi-flip (skip_file), budget exhaustion under
    a tiny budget, and a validate-off single flip (the sanity tier alone)."""
    whole, spans, _clean = _page_corrupt_base()
    data_lo = min(lo for lo, _hi in spans)
    data_hi = max(hi for _lo, hi in spans)

    def rec(pos, xor):
        return (pos - data_lo).to_bytes(3, "little") + bytes([xor])

    mid0 = (spans[0][0] + spans[0][1]) // 2
    mid1 = (spans[1][0] + spans[1][1]) // 2
    mid2 = (spans[2][0] + spans[2][1]) // 2
    return [
        # one payload flip, skip_unit, default validate+budget, prefetch 2
        bytes([1, 0, 1, 1]) + rec(mid1, 0x40),
        # page-header-ish flip right at a span start, raise policy
        bytes([0, 0, 1, 0]) + rec(spans[2][0] + 2, 0xFF),
        # multi-flip across two groups, skip_file
        bytes([2, 0, 1, 1]) + rec(mid0, 0x10) + rec(mid2, 0x20),
        # budget exhaustion: tiny budget, flips in every group
        bytes([1, 0, 0, 0]) + rec(mid0, 0x01) + rec(mid1, 0x02)
        + rec(mid2, 0x04),
        # validate off: only the structural sanity tier stands
        bytes([1, 1, 1, 0]) + rec(mid1, 0x80),
    ]


def fuzz_scan_plan(data: bytes) -> None:
    """Fuzz target #16: ScanPlan IR blob adoption (scanplan.py).

    The serve layer caches serialized plans and replays them across
    requests, so a plan blob is an INPUT like a footer is: deserialize must
    either raise ParquetError or yield a plan whose serialize→deserialize
    round-trip is byte-stable, whose cache key survives the trip (the
    PlanCache's correctness invariant — a round-tripped plan must land on
    the same cache slot), and whose memo/costing surfaces never crash on
    arbitrary coordinates."""
    from .scanplan import ScanPlan

    try:
        p = ScanPlan.deserialize(data)
    except ParquetError:
        return
    blob = p.serialize()
    q = ScanPlan.deserialize(blob)  # our own output must always readopt
    assert q.cache_key() == p.cache_key(), "cache key broke round-trip"
    assert q.serialize() == blob, "serialize not stable across round-trip"
    # the replay surfaces a reader would hit — never a crash, any input
    assert p.estimated_bytes() >= 0
    p.selected_ordinals()
    for rgp in p.row_groups[:8]:
        p.pruning_hint(rgp.ordinal)
        for c in rgp.chunks[:8]:
            p.route_hint(rgp.ordinal, c.column)


def crafted_scan_plan_blobs() -> "list[bytes]":
    """Hand-crafted ``scan_plan`` inputs (and corpus blobs): truncated and
    lying plans around a small valid one."""
    from .scanplan import ChunkPlan, RowGroupPlan, ScanPlan

    plan = ScanPlan(
        file_key=("file", "/tmp/x.parquet", 4096, 1234567890),
        columns=("a", "s"), filter_fp=None, rg_keep=[True, False],
        row_groups=[
            RowGroupPlan(0, 100, [ChunkPlan("a", 4, 800, 1600, 1, 100),
                                  ChunkPlan("s", 804, 900, 2000, 1, 100)]),
            RowGroupPlan(1, 50, [ChunkPlan("a", 1704, 400, 800, 1, 50)]),
        ])
    plan.note_route(0, "a", "device_snappy", "snappy_resolve")
    plan.note_pruning(1, {("a",): {0, 2}}, 30)
    good = plan.serialize()
    lying_route = good.replace(b"device_snappy", b"warp_teleportx")
    neg_offset = good.replace(b'"offset":4,', b'"offset":-4,')
    dup_ordinal = good.replace(b'"ordinal":1}', b'"ordinal":0}')
    # non-string family: must be the typed rejection, never a TypeError
    # out of the frozenset membership test
    bad_family = good.replace(b'"snappy_resolve"]', b"[1714]]")
    assert (lying_route != good and neg_offset != good
            and dup_ordinal != good and bad_family != good)
    return [
        good,
        good[:17],                      # truncated mid-body
        b"TPQX" + good[4:],             # bad magic
        b"TPQP\xff" + good[5:],         # unknown version
        lying_route,
        neg_offset,
        dup_ordinal,
        bad_family,
        b"TPQP\x01" + b'{"row_groups":"no"}',
    ]


def fuzz_chaos_schedule(data: bytes) -> None:
    """Fuzz target #17: chaos-schedule blob adoption + planner invariants
    (resilience.py).

    A chaos schedule is a TEST plan that drives fault injection over live
    services, so a hostile blob must never become a hostile test run:
    ``from_blob`` either raises ParquetError or yields a schedule whose
    invariants hold (phases sorted + disjoint, every stall bounded — no
    schedule may encode an unbounded stall), whose round-trip is exact
    (``from_blob(to_blob(s)) == s``, bytes stable), and whose phase lookup
    never crashes on arbitrary ordinals.  Seeded GENERATION must be
    deterministic too: same seed, same schedule, byte for byte."""
    from .resilience import MAX_CHAOS_STALL_S, ChaosSchedule

    try:
        s = ChaosSchedule.from_blob(data)
    except ParquetError:
        s = None
    if s is not None:
        blob = s.to_blob()
        q = ChaosSchedule.from_blob(blob)  # our own output must readopt
        assert q == s, "schedule broke round-trip"
        assert q.to_blob() == blob, "to_blob not stable across round-trip"
        prev_end = None
        for p in s.phases:
            assert p.end > p.start
            assert prev_end is None or p.start >= prev_end, "overlap"
            assert not (p.kind == "stall"
                        and p.stall_s > MAX_CHAOS_STALL_S), "unbounded stall"
            prev_end = p.end
        # phase lookup over arbitrary coordinates — never a crash
        for ordinal in (0, 1, 17, 1 << 20):
            s.phase_at(ordinal, file_index=ordinal % 3 - 1)
    # seeded generation: deterministic and self-adopting for ANY params
    seed = int.from_bytes(data[:4], "little") if len(data) >= 4 else len(data)
    n = data[4] % 9 if len(data) > 4 else 4
    files = (data[5] % 4) + 1 if len(data) > 5 else 1
    g1 = ChaosSchedule.generate(seed, n_phases=n, horizon=128, files=files)
    g2 = ChaosSchedule.generate(seed, n_phases=n, horizon=128, files=files)
    assert g1 == g2, "generate() is not deterministic"
    assert ChaosSchedule.from_blob(g1.to_blob()) == g1


def crafted_chaos_blobs() -> "list[bytes]":
    """Hand-crafted ``chaos_schedule`` inputs (and corpus blobs): a valid
    generated schedule plus the hostile shapes adoption must reject."""
    import struct as _struct

    from .resilience import ChaosSchedule

    good = ChaosSchedule.generate(7, n_phases=4, horizon=128, files=3) \
        .to_blob()
    head = good[:11]

    def phase(start, end, kind, intensity=1, fidx=0, stall=0.25):
        return _struct.pack("<IIBBIf", start, end, kind, intensity, fidx,
                            stall)

    def blob(*phases):
        return (b"TPQC\x01" + _struct.pack("<IH", 7, len(phases))
                + b"".join(phases))

    return [
        good,
        good[:9],                        # truncated header
        b"TPQX" + good[4:],              # bad magic
        b"TPQC\xff" + good[5:],          # unknown version
        head + b"\x00" * 7,              # length lies about phase count
        blob(phase(10, 5, 0)),           # end <= start
        blob(phase(0, 10, 0), phase(5, 20, 1)),   # overlapping phases
        blob(phase(0, 10, 9)),           # unknown kind
        blob(phase(0, 10, 0, stall=60.0)),        # unbounded stall
        blob(phase(0, 10, 0, intensity=0)),       # zero intensity
        blob(phase(0, 10, 0, stall=float("nan"))),  # NaN smuggle
    ]


def fuzz_fused_plan(data: bytes) -> None:
    """Fuzz target #18: fused-route planner invariants (ship.py).

    The fused megakernel rows ride the same cost table as every other
    route, so a hostile fact set must never break the table's contracts:

    - a fused row is present ⇔ the facts are fused-eligible
      (``ship.fused_eligible`` — the ONE predicate the planner, the
      device_reader builders, and this target share) AND the unfused twin
      is priced feasible (this planner always ranks the fused routes: bit 0
      of the flags byte, the JAX package's fusion switch, is ignored);
    - a fused row never counts the unfused chain's inter-stage HBM term:
      its device cost is the single output-sized pass, <= the twin's
      device cost, and strictly below ``unfused_device_costs`` (the
      spill-inclusive prediction the fusion-win verdict compares against);
    - at equal modeled cost the fused variant outranks its twin — and a
      costlier fused row never jumps the queue;
    - a FORCED fused route on ineligible facts degrades (plan returns
      ``[force, plain]`` and the cost table simply has no fused entry —
      the builder falls through with a counter), never a crash;
    - ``parse_route`` on arbitrary junk warns and returns None, never
      raises (the TPQ_FORCE_ROUTE mid-scan degradation contract).
    """
    from .ship import (
        FUSED_ROUTES, ROUTE_PLAIN as _PLAIN, ROUTES, UNFUSED_OF, ChunkFacts,
        ShipPlanner, fused_eligible, parse_route,
    )

    if len(data) < 14:
        data = data + b"\x00" * (14 - len(data))
    flags = data[0]
    force = (ROUTES[(flags >> 2) % len(ROUTES)] if flags & 2 else None)
    logical = int.from_bytes(data[1:7], "little") % (1 << 33)
    width = (0, 4, 8, 12)[data[7] % 4]
    narrow_k = data[8] % 9
    bits = data[9]
    comp_bytes = int.from_bytes(data[10:14], "little") % (1 << 30)
    f = ChunkFacts(
        logical=logical, width=width, narrow_k=narrow_k,
        narrow_possible=bool(bits & 1), comp_bytes=comp_bytes,
        native=bool(bits & 2), host_bytes_ready=bool(bits & 4),
        flat=bool(bits & 8),
    )
    p = ShipPlanner(link_mbps=1.0 + (data[7] % 97) * 13.0, force=force,
                    device_mbps=1.0 + (data[8] % 89) * 11.0)
    order, costs = p.plan(f)  # never raises, whatever the facts
    assert _PLAIN in costs, "plain anchor missing"
    eligible = set(fused_eligible(f))
    for fr in FUSED_ROUTES:
        present = fr in costs
        expected = fr in eligible and UNFUSED_OF[fr] in costs
        assert present == expected, (fr, present, expected, f)
        if present:
            dev = p.device_costs(f, routes=costs)
            unf = p.unfused_device_costs(f, routes=costs)
            assert dev[fr] <= dev[UNFUSED_OF[fr]] + 1e-12 or \
                UNFUSED_OF[fr] == _PLAIN, (fr, dev)
            assert unf[fr] > dev[fr] - 1e-18, (fr, unf, dev)
            twin = UNFUSED_OF[fr]
            if (force is None and twin in costs
                    and abs(costs[fr] - costs[twin]) < 1e-15):
                assert order.index(fr) < order.index(twin), order
    if force is not None:
        assert order[0] == force and order[-1] == _PLAIN
        # forced-fused on an ineligible stream: no fused cost row, and the
        # infallible plain tail is still there to degrade to
        if force in FUSED_ROUTES and force not in costs:
            assert _PLAIN in order
    # env-validation degradation: junk never raises (candidates are a
    # FIXED set — warn_env_once keys on the value, and a per-blob random
    # string would grow its dedup set without bound over a long campaign)
    junk = ("", "warp", "fusedplain", "FUSED_PLAIN", " plain ",
            *ROUTES)[data[1] % (5 + len(ROUTES))]
    assert parse_route(junk) in (None, *ROUTES)


def crafted_fused_plan_blobs() -> "list[bytes]":
    """Hand-crafted ``fused_plan`` inputs (and corpus blobs): each hits a
    distinct planner branch — eligible, the JAX package's fused-off flag
    (ignored here), non-flat, width-ineligible, forced-fused-ineligible,
    zero logical, huge facts."""

    def blob(flags, logical, width_sel, k, bits, comp):
        return (bytes([flags]) + logical.to_bytes(6, "little")
                + bytes([width_sel, k, bits]) + comp.to_bytes(4, "little"))

    return [
        blob(1, 8 << 20, 2, 3, 0b1011, 0),        # fuse on, flat int64
        blob(0, 8 << 20, 2, 3, 0b1011, 0),        # fuse flag off: same rows
        blob(1, 8 << 20, 2, 3, 0b0011, 0),        # not flat: ineligible
        blob(1, 8 << 20, 0, 0, 0b1011, 0),        # width 0 (byte array)
        # forced fused_narrow_snappy (index of it in ROUTES) on a float
        # column that can never narrow — degrade path
        blob(2 | 1 | (6 << 2), 8 << 20, 1, 0, 0b1010, 0),
        blob(1, 0, 2, 3, 0b1011, 0),              # zero logical
        blob(3 | (5 << 2), (1 << 33) - 1, 2, 8, 0b1111, (1 << 30) - 1),
    ]


def fuzz_result_cache(data: bytes, device=None) -> None:
    """Fuzz target #19: tiered result-cache invariants under arbitrary op
    streams (serve/result_cache.py).

    The input is an op stream (4 bytes per op: opcode, file, row group,
    size) driving a SMALL two-tier ResultCache through puts, gets,
    generation bumps, dictionary traffic, and single-flight builds.  The
    hard invariants hold after EVERY op:

    - the per-tier byte bound is never exceeded (recomputed from the
      entries, compared to the ledger — not trusted from the counters);
    - the device-tier ledger reconciles with the AllocTracker's
      ``device_snapshot`` at all times (the HBM residency accounting);
    - a generation bump always invalidates: once a newer generation of a
      file is cached, NO entry of an older generation is ever served;
    - single-flight never double-builds: a ``get_or_build`` whose key is
      already published must not invoke its builder;
    - key round-trip: the (file key, rg, column, sig) tuple that stored a
      value retrieves exactly that value while it stays resident.

    The device tier's entries are uint8 tensors on ``device`` (``cuda``
    unless the caller names another), keyed by its decode signature.
    """
    import torch

    from .serve.result_cache import ResultCache, decode_signature
    from .torch_decode import _resolve_device

    device = _resolve_device(device, "fuzz_result_cache")
    if len(data) < 2:
        return
    host_cap = (data[0] % 64 + 1) * 16          # 16..1024 bytes
    dev_cap = (data[1] % 64) * 16               # 0 = device tier off
    rc = ResultCache(max_bytes=host_cap, hbm_bytes=dev_cap,
                     chunks_enabled=True)
    gens: dict[int, int] = {}

    def fkey(f: int) -> tuple:
        g = gens.setdefault(f, 0)
        return ("file", f"f{f}", 64 + g, g)

    def check_invariants() -> None:
        with rc._lock:
            by_tier = {"host": 0, "device": 0}
            by_count = {"host": 0, "device": 0}
            by_tenant: dict = {}
            for (_v, n, t, ten) in rc._entries.values():
                by_tier[t] += n
                by_count[t] += 1
                if ten is not None:
                    by_tenant[ten] = by_tenant.get(ten, 0) + n
            # the per-tenant byte ledger (QoS cache shares) reconciles
            # with the entries — drift here silently breaks share caps
            ledger = {}
            for t in ("host", "device"):
                for ten, n in rc._tenant_bytes[t].items():
                    ledger[ten] = ledger.get(ten, 0) + n
            assert by_tenant == ledger, "tenant byte ledger drift"
            for t, total in by_tier.items():
                assert total == rc._bytes[t], "byte ledger drift"
                # the per-tier recency index tracks the value map exactly
                assert by_count[t] == len(rc._lru[t]), "LRU index drift"
                cap = rc._caps[t]
                if cap > 0:
                    assert total <= cap, f"{t} byte bound exceeded"
                else:
                    assert total == 0, "entries admitted to a 0-cap tier"
        dev_in_use, _peak = rc.tracker.device_snapshot()
        assert dev_in_use == rc._bytes["device"], "HBM ledger drift"

    pos = 2
    while pos + 4 <= len(data):
        op, f, rg, size = (data[pos], data[pos + 1] % 4, data[pos + 2] % 4,
                           data[pos + 3])
        pos += 4
        col = f"c{(op >> 4) % 3}"
        dev = bool(op & 0x08) and dev_cap > 0
        sig = decode_signature(device if dev else False, validate_crc=True)
        tier = "device" if dev else "host"
        full = ResultCache.chunk_key(fkey(f), rg, col, sig)
        kind = op % 5
        if kind == 0:
            val = (torch.full((max(size, 1),), 0x78, dtype=torch.uint8,
                              device=device) if dev else b"x" * max(size, 1))
            if rc.put(full, val, max(size, 1), tier):
                assert rc.get(full) is val, "key round-trip broke"
        elif kind == 1:
            rc.get(full)
        elif kind == 2:
            # generation bump: cache a unit under the NEW generation, then
            # prove the old generation can never be served again
            old = full
            gens[f] = gens.get(f, 0) + 1
            rc.put(ResultCache.chunk_key(fkey(f), 0, "c0", ("host", "v1")),
                   b"g", 1, "host")
            assert rc.get(old) is None, "stale generation served after bump"
        elif kind == 3:
            calls = []

            def build(n=max(size, 1)):
                calls.append(1)
                if dev:
                    return torch.full((n,), 0x62, dtype=torch.uint8,
                                      device=device), n
                return b"b" * n, n

            rc.get_or_build(full, build, tier)
            first = len(calls)
            rc.get_or_build(full, build, tier)
            if first == 1 and rc.contains_all([full]):
                assert len(calls) == 1, "single-flight double-built"
        else:
            dk = ResultCache.dict_key(fkey(f), rg, col, "host:v1")
            rc.put(dk, b"d" * max(size, 1), max(size, 1), "host")
            rc.get(dk)
        check_invariants()
    rc.counters()  # reporting must never crash on any reachable state
    rc.progress()


def crafted_result_cache_blobs() -> "list[bytes]":
    """Hand-crafted ``result_cache`` op streams (and corpus blobs): the
    shapes a hot serve tier actually produces plus the hostile ones."""

    def ops(*quads):
        return bytes(b for q in quads for b in q)

    tiny = bytes([0, 4])      # 16B host cap, 64B device cap
    roomy = bytes([63, 63])   # 1024B host, 1008B device
    # opcodes: kind = op % 5 (0 put, 1 get, 2 gen-bump, 3 build, 4 dict);
    # op & 0x08 selects the device tier; bits 4-5 pick the column
    PUT, GET, BUMP, BUILD, DICT = 0, 1, 2, 3, 4
    PUT_DEV, BUILD_DEV = 40, 8  # 40 % 5 == 0 & bit3; 8 % 5 == 3 & bit3

    return [
        # eviction pressure: puts far past the 16B host cap
        tiny + ops(*[(PUT, 0, i % 4, 12) for i in range(12)]),
        # generation churn: put / bump / put / bump on one file
        roomy + ops((PUT, 1, 0, 32), (BUMP, 1, 0, 0), (PUT, 1, 1, 32),
                    (BUMP, 1, 1, 0), (GET, 1, 0, 0)),
        # single-flight + dict traffic interleaved on both tiers
        roomy + ops((BUILD, 0, 0, 64), (DICT, 0, 0, 24),
                    (BUILD_DEV, 0, 1, 64), (BUILD, 0, 0, 64),
                    (DICT, 0, 0, 24)),
        # oversized values: every put must reject, bounds hold
        tiny + ops((PUT, 2, 0, 255), (PUT_DEV, 2, 1, 255), (GET, 2, 0, 0)),
        # device-tier pressure with the host tier idle
        bytes([0, 2]) + ops(*[(PUT_DEV, 3, i % 4, 30) for i in range(8)]),
    ]


def _mini_shard_blob(seed: int = 0, rows: int = 64,
                     kv: "dict | None" = None) -> bytes:
    """One valid single-row-group shard file (the footer_merge seed)."""
    from .format import FieldRepetitionType as FRT, Type
    from .schema.core import build_schema, data_column
    from .write.sharded import encode_row_group

    rng = np.random.default_rng(seed)
    schema = build_schema([
        data_column("a", Type.INT64, FRT.REQUIRED),
        data_column("b", Type.DOUBLE, FRT.REQUIRED),
    ])
    blob, _meta = encode_row_group(
        schema,
        {"a": rng.integers(0, 1000, rows).astype(np.int64),
         "b": rng.random(rows)},
        write_crc=True, kv_metadata=kv)
    return blob


def _frame_merge_parts(parts: "list[tuple[bytes, int]]") -> bytes:
    """Frame (footer_thrift, declared_file_size) pairs as one fuzz blob."""
    out = [bytes([len(parts)])]
    for thrift_bytes, size in parts:
        out.append(len(thrift_bytes).to_bytes(4, "little"))
        out.append(thrift_bytes)
        out.append(int(size).to_bytes(8, "little"))
    return b"".join(out)


def _shard_footer_thrift(blob: bytes) -> bytes:
    flen = int.from_bytes(blob[-8:-4], "little")
    return blob[-8 - flen : -8]


def fuzz_footer_merge(data: bytes) -> None:
    """Fuzz target #20: the write-side footer merge (write/merge.py).

    Input framing: ``[count u8][per part: u32 thrift_len, footer thrift
    bytes, u64 declared file size]``.  Each footer deserializes (or the
    blob is rejected); :func:`~tpu_parquet_torch.write.merge_footers` over the
    parts must either raise ParquetError (truncated/lying/overlapping/
    mismatched shard footers — the typed rejections) or produce a merged
    footer holding the merge invariants: row counts and row-group counts
    sum, shard order is preserved with globally renumbered ordinals, and
    the relocated spans tile the output data segment contiguously from
    the head magic with every chunk offset inside its span."""
    from .format import FileMetaData
    from .scanplan import row_group_byte_span
    from .schema.core import Schema
    from .thrift import ThriftError, deserialize
    from .write.merge import merge_footers

    if len(data) < 1:
        return  # empty merge blob: rejected framing
    count = data[0]
    if not 1 <= count <= 4:
        return  # part count out of range
    pos = 1
    parts = []
    for _ in range(count):
        if pos + 4 > len(data):
            return  # truncated part header
        tlen = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if tlen > len(data) - pos or tlen > (1 << 20):
            return  # part thrift length lies
        try:
            meta = deserialize(FileMetaData, data[pos : pos + tlen])
        except ThriftError:
            return  # bad part footer thrift: rejected
        pos += tlen
        if pos + 8 > len(data):
            return  # truncated part size
        size = int.from_bytes(data[pos : pos + 8], "little")
        pos += 8
        if size > (1 << 40):
            return  # part size lies
        parts.append((meta, size))
    try:
        merged, spans = merge_footers(parts)
    except ParquetError:
        return
    # -- merge invariants (reject was the only other legal outcome) --------
    in_rgs = sum(len(m.row_groups or []) for m, _s in parts)
    in_rows = sum(int(rg.num_rows or 0) for m, _s in parts
                  for rg in (m.row_groups or []))
    assert len(merged.row_groups) == in_rgs, "row-group count not preserved"
    assert len(spans) == in_rgs, "span per row group"
    assert int(merged.num_rows) == in_rows, "row count not preserved"
    assert [rg.ordinal for rg in merged.row_groups] == list(range(in_rgs)), \
        "ordinals not renumbered sequentially"
    schema = Schema.from_file_metadata(merged)
    leaves = {l.path: l for l in schema.leaves}
    pos_out = 4  # spans tile the data segment contiguously from the magic
    order = []
    for rg, (idx, start, end) in zip(merged.row_groups, spans):
        lo, hi = row_group_byte_span(rg, leaves)
        assert lo == pos_out, f"relocated span starts at {lo}, not {pos_out}"
        assert hi - lo == end - start, "relocated span length changed"
        pos_out = pos_out + (end - start)
        order.append(idx)
    assert order == sorted(order), "shard order not preserved"


def crafted_footer_merge_blobs() -> "list[bytes]":
    """Hand-crafted ``footer_merge`` inputs (and corpus blobs): two valid
    shards, then the typed-rejection shapes — truncated footer thrift, a
    declared size that amputates the data segment (lying/truncated
    shard), a footer whose num_rows disagrees with its groups, a schema
    mismatch between shards, and self-overlapping row groups."""
    import copy as _copy

    from .thrift import serialize as _ser

    b1 = _mini_shard_blob(seed=1)
    b2 = _mini_shard_blob(seed=2, rows=32)
    t1, t2 = _shard_footer_thrift(b1), _shard_footer_thrift(b2)
    good = _frame_merge_parts([(t1, len(b1)), (t2, len(b2))])
    # truncated thrift: merge must reject, not crash
    truncated = _frame_merge_parts([(t1[: len(t1) // 2], len(b1))])
    # lying size: the declared file is smaller than the chunk spans need
    amputated = _frame_merge_parts([(t1, 64), (t2, len(b2))])
    # lying num_rows: footer total disagrees with the row groups' sum
    from .format import FileMetaData
    from .thrift import deserialize as _deser

    lying = _deser(FileMetaData, t1)
    lying.num_rows = int(lying.num_rows or 0) + 7
    lying_rows = _frame_merge_parts([(_ser(lying), len(b1))])
    # schema mismatch: shard 2 claims a different column name
    other = _deser(FileMetaData, t2)
    for se in other.schema or []:
        if se.name == "b":
            se.name = "zz"
    mismatch = _frame_merge_parts([(t1, len(b1)), (_ser(other), len(b2))])
    # overlapping row groups: one group duplicated at the same offsets
    dup = _deser(FileMetaData, t1)
    dup.row_groups = [dup.row_groups[0], _copy.deepcopy(dup.row_groups[0])]
    dup.num_rows = 2 * int(dup.row_groups[0].num_rows or 0)
    overlap = _frame_merge_parts([(_ser(dup), len(b1))])
    # single valid shard with kv metadata (the kv-union path)
    b3 = _mini_shard_blob(seed=3, kv={"origin": "fuzz"})
    single = _frame_merge_parts([(_shard_footer_thrift(b3), len(b3))])
    return [good, truncated, amputated, lying_rows, mismatch, overlap,
            single]


def fuzz_stream_cursor(data: bytes) -> None:
    """Streaming-scan cursor surface (serve/stream.py): ANY bytes must
    either unpack to a validated cursor state or raise a tpu_parquet_torch.errors
    type — truncated, bit-flipped, and version-bumped blobs must never
    crash or silently seek a resumed stream.  Accepted cursors must
    round-trip the pack/unpack pair exactly, self-match the compatibility
    fingerprint, and REFUSE a perturbed request digest (the rail that
    keeps a cursor from resuming a different stream)."""
    from .errors import CheckpointError
    from .serve import stream as sc

    try:
        st = sc.unpack_cursor(data)
    except ParquetError:
        return
    st2 = sc.unpack_cursor(sc.pack_cursor(st))
    if st2 != st:
        raise AssertionError(f"cursor round-trip diverges: {st} != {st2}")
    fp = {k: st[k] for k in sc._FINGERPRINT}
    sc.check_cursor_compatible(st, fp)  # self-match must pass
    lying = dict(fp)
    d = str(st["request_digest"])
    lying["request_digest"] = ("0" if d[:1] != "0" else "1") + d[1:]
    try:
        sc.check_cursor_compatible(st, lying)
    except CheckpointError:
        return
    raise AssertionError("cursor accepted a mismatched request digest")


def crafted_stream_cursor_blobs() -> "list[bytes]":
    """Hand-crafted ``stream_cursor`` inputs (and corpus blobs): two valid
    cursors (fresh and mid-stream), then the typed-rejection shapes —
    truncation, bad magic, a bumped version, a ``rows_done`` off the
    batch-boundary rail, ``path_index`` past ``n_paths``, a
    bool-typed int field, and a malformed digest."""
    import json as _json

    from .serve import stream as sc

    def blob(**over):
        st = {"version": sc.CURSOR_VERSION, "batch_rows": 128, "n_paths": 2,
              "path_index": 0, "rows_done": 0, "batches_emitted": 0,
              "device": False, "request_digest": "deadbeefcafe0123"}
        st.update(over)
        payload = _json.dumps(st, sort_keys=True,
                              separators=(",", ":")).encode()
        return (sc.CURSOR_MAGIC
                + int(st.get("version", 1)).to_bytes(2, "big") + payload)

    good = sc.pack_cursor(sc.unpack_cursor(blob()))
    mid = blob(path_index=1, rows_done=384, batches_emitted=3)
    return [
        good, mid,
        good[: len(good) // 2],              # truncated payload
        b"TPQX" + good[4:],                  # bad magic
        blob(version=sc.CURSOR_VERSION + 1),  # unknown version
        blob(rows_done=100),                 # off the batch-boundary rail
        blob(path_index=3),                  # past n_paths
        blob(rows_done=True),                # bool masquerading as int
        blob(request_digest="nope"),         # digest too short
    ]


def fuzz_fetch_engine(data: bytes) -> None:
    """Async fetch-engine op-stream interpreter (iostore_async.py): the
    blob picks the in-flight cap, hedge/fault plan, and an op stream of
    submits / collects / a cancel against a tiny in-memory store.
    Whatever the stream does, the engine's ledger must hold: the in-flight
    gauge never exceeds the cap even transiently, submitted reconciles
    with completed+failed once every future resolves, hedge losers are
    always reaped, cancellation wakes every waiter with a typed verdict,
    and ``close()`` leaves no engine thread behind.  Successful reads must
    return the store's true bytes; failures must be the typed iostore
    verdicts — anything else is a finding."""
    import threading as _threading

    from .errors import (
        CancelledError, DeadlineExceededError, RetryExhaustedError,
        TransientIOError,
    )
    from .iostore import GenericRangeStore, IOConfig, RetryBudget, ScanToken
    from .iostore_async import FetchEngine
    from .resilience import CancelToken

    if len(data) < 2:
        return
    cap = 1 + data[0] % 8
    flags = data[1]
    file_size = 4096
    plan = list(data[2:26])  # per-attempt fault codes, popped in order
    ops = data[26:74]
    lock = _threading.Lock()

    class _Store(GenericRangeStore):
        def size(self):
            return file_size

        async def _fetch_once_async(self, offset, size, timeout):
            import asyncio as _asyncio

            with lock:
                code = (plan.pop(0) % 8) if plan else 0
            if code == 5:
                raise TransientIOError(f"injected fault (code {code})")
            if code == 6:
                await _asyncio.sleep(0.002)  # slow leg: hedge bait
            n = max(min(size, file_size - offset), 0)
            true = bytes((offset + j) % 251 for j in range(n))
            if code == 7 and n > 1:
                return true[: n // 2]  # torn prefix (verified re-read)
            return true

    store = _Store(config=IOConfig(
        retries=3, backoff_ms=0.05, retry_budget=0,
        hedge_ms=(1.0 if flags & 1 else 0.0), deadline_s=10.0))
    cancel = CancelToken()
    scan = ScanToken(budget=RetryBudget(6 if flags & 2 else 0),
                     cancel=cancel)
    eng = FetchEngine(max_inflight=cap, name="tpq-fetch-fuzz")
    outstanding: "list[tuple]" = []

    def collect(fut, off, sz):
        try:
            buf = fut.result(timeout=10.0)
        except (RetryExhaustedError, TransientIOError, CancelledError,
                DeadlineExceededError):
            return
        n = max(min(sz, file_size - off), 0)
        if bytes(buf) != bytes((off + j) % 251 for j in range(n)):
            raise AssertionError(
                f"engine corrupted range [{off}, {off + sz})")

    cancelled = False
    try:
        for b in ops:
            op, arg = b >> 5, b & 31
            if op == 6:
                if outstanding:
                    collect(*outstanding.pop(0))
                continue
            if op == 7:
                cancel.cancel()
                cancelled = True
                continue
            off = (arg * 173) % (file_size + 64)  # may cross or pass EOF
            sz = 1 + (b * 37) % 200
            fut = eng.submit(store, off, sz, scan=scan)
            if eng.stats.inflight > cap:
                raise AssertionError(
                    f"in-flight gauge {eng.stats.inflight} exceeded the "
                    f"cap {cap}")
            outstanding.append((fut, off, sz))
        while outstanding:
            collect(*outstanding.pop(0))
    finally:
        eng.close()
    st = eng.stats
    if st.inflight != 0:
        raise AssertionError(f"in-flight gauge leaked: {st.inflight}")
    if st.inflight_peak > cap:
        raise AssertionError(
            f"in-flight peak {st.inflight_peak} exceeded the cap {cap}")
    if st.completed + st.failed != st.submitted:
        raise AssertionError(
            f"ledger does not reconcile: {st.submitted} submitted != "
            f"{st.completed} completed + {st.failed} failed"
            f" (cancelled={cancelled})")
    if store._hedges_outstanding != 0:
        raise AssertionError(
            f"{store._hedges_outstanding} hedge loser(s) never reaped")
    for t in _threading.enumerate():
        if t.name.startswith("tpq-fetch-fuzz"):
            raise AssertionError("engine thread leaked after close()")


def crafted_fetch_engine_blobs() -> "list[bytes]":
    """Hand-crafted ``fetch_engine`` inputs (and corpus blobs): a deep
    clean burst through a cap-1 engine (every submit queues for the one
    slot), a fault-heavy hedged plan (transient + slow + torn legs racing
    duplicates), a cancel dropped mid-burst with waiters parked on slots,
    a retry-budget-capped scan under pure transient pressure, and an
    interleaved submit/collect stream across EOF."""
    SUB, COLLECT, CANCEL = 0 << 5, 6 << 5, 7 << 5

    def blob(cap_byte, flags, plan, ops):
        return (bytes([cap_byte, flags])
                + bytes(plan[:24]).ljust(24, b"\x00") + bytes(ops))

    deep = blob(0, 0, [], [SUB | (i % 32) for i in range(32)])
    hedged = blob(7, 1, [6, 5, 7, 6, 6, 5, 7, 6] * 3,
                  [SUB | (i % 32) for i in range(16)])
    cancel_mid = blob(0, 0, [6] * 8,
                      [SUB | (i % 32) for i in range(8)] + [CANCEL]
                      + [SUB | 3, SUB | 9] + [COLLECT] * 10)
    budget = blob(3, 2, [5] * 24, [SUB | (i % 32) for i in range(8)])
    interleave = blob(2, 3, [5, 6, 7, 0, 5, 6],
                      [SUB | 31, SUB | 30, COLLECT, SUB | 1, COLLECT,
                       SUB | 29, COLLECT, COLLECT, COLLECT])
    return [deep, hedged, cancel_mid, budget, interleave]


def fuzz_request_trace(data: bytes) -> None:
    """Request-tracing op-stream interpreter (obs.py, ISSUE 19): the blob
    picks the tail sampler's 1-in-N rate, ring size, worker-thread count,
    and per-trace span cap, then drives randomized span open / close /
    error-close / annotate / flag / early-finish ops across threads on
    shared ``RequestTrace`` trees offered to one ``TailSampler``.
    Whatever the stream does: every finished tree is well-nested (a span's
    parent index is always smaller than its own, no null durations after
    ``finish``), the span cap bounds the tree with drops counted, trace
    ids never collide, the export ring honours its byte bound with a
    ledger-consistent retained/evicted count, every retained trace is
    fetchable by id, and every histogram exemplar's raw value re-derives
    the bucket it is stored under — anything else is a finding."""
    import threading as _threading
    import time as _time

    from .obs import LatencyHistogram, RequestTrace, TailSampler

    if len(data) < 6:
        return
    one_in_n = 1 + data[0] % 4
    ring = 4096 + (data[1] & 7) * 1024
    nthreads = 1 + data[2] % 3
    max_spans = 4 + data[3] % 29
    ntraces = 1 + data[4] % 6
    ops = data[5:133]
    sampler = TailSampler(one_in_n=one_in_n, ring_bytes=ring, slow_q=0.95)
    hist = LatencyHistogram()
    ids = []
    for ti in range(ntraces):
        tr = RequestTrace(max_spans=max_spans)
        ids.append(tr.trace_id)

        def run(ops_slice, _tr=tr):
            open_spans = []  # deliberately may leave some open: finish()
            for b in ops_slice:  # must close the orphans
                op, arg = b >> 5, b & 31
                if op in (0, 1):
                    s = _tr.span(f"s{arg}", arg=arg)
                    s.__enter__()
                    open_spans.append(s)
                elif op == 2:
                    if open_spans:
                        open_spans.pop().__exit__(None, None, None)
                elif op == 3:
                    if open_spans:
                        e = ValueError("boom")
                        open_spans.pop().__exit__(ValueError, e, None)
                elif op == 4:
                    t = _time.perf_counter()
                    _tr.add_timed(f"t{arg}", t, t + arg * 1e-6, n=arg)
                elif op == 5:
                    _tr.annotate(bytes=arg)
                elif op == 6:
                    if arg % 3 == 0:
                        _tr.mark_error(ValueError(f"e{arg}"))
                    else:
                        _tr.set_flag(("deadline", "shed")[arg % 2])
                else:
                    _tr.finish()  # racing early finish must stay safe

        threads = [_threading.Thread(target=run, args=(ops[t::nthreads],))
                   for t in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tr.finish()
        if len(tr.spans) > max_spans:
            raise AssertionError(
                f"span cap {max_spans} breached: {len(tr.spans)} spans")
        if tr.dropped and len(tr.spans) != max_spans:
            raise AssertionError(
                f"{tr.dropped} drops counted below the cap "
                f"({len(tr.spans)}/{max_spans} spans)")
        for i, s in enumerate(tr.spans):
            if not (s[3] == -1 or 0 <= s[3] < i):
                raise AssertionError(
                    f"tree not well-nested: span {i} has parent {s[3]}")
            if s[2] is None or s[2] < 0.0:
                raise AssertionError(
                    f"span {i} duration {s[2]!r} after finish()")
        # deterministic synthetic durations spread offers across buckets
        dur = 1e-4 * (ti + 1) + len(tr.spans) * 1e-6
        retained = sampler.offer(tr, duration_s=dur)
        hist.record(dur, exemplar=tr.trace_id if retained else None)
        if retained and sampler.get(tr.trace_id) is None \
                and sampler.counters()["evicted"] == 0:
            raise AssertionError(
                f"retained trace {tr.trace_id} not fetchable by id")
    if len(set(ids)) != len(ids):
        raise AssertionError(f"trace ids collided: {ids}")
    c = sampler.counters()
    if c["retained_bytes"] > c["ring_capacity_bytes"]:
        raise AssertionError(f"export ring over its byte bound: {c}")
    docs = sampler.traces()
    if len(docs) != c["retained"] - c["evicted"]:
        raise AssertionError(
            f"ring ledger does not reconcile: {len(docs)} held vs {c}")
    for doc in docs:
        if sampler.get(doc["trace_id"]) != doc:
            raise AssertionError(
                f"get({doc['trace_id']}) diverged from the ring entry")
    for idx, ex in hist.exemplars.items():
        if LatencyHistogram.bucket_index(ex[1]) != idx:
            raise AssertionError(
                f"exemplar {ex} stored under bucket {idx} but its value "
                f"re-derives bucket {LatencyHistogram.bucket_index(ex[1])}")


def crafted_request_trace_blobs() -> "list[bytes]":
    """Hand-crafted ``request_trace`` inputs (and corpus blobs): a deep
    open chain against a tiny span cap (counted drops + orphan close on
    finish), an interleaved open/error-close/flag storm across 3 threads,
    a retain-all sampler on the smallest ring (eviction churn under the
    byte bound), an early-finish race with ops still arriving, and a
    bucket-spreading run that exercises the exemplar map."""
    OPEN, CLOSE, ERRC, TIMED, ANN, FLAG, FIN = (
        0 << 5, 2 << 5, 3 << 5, 4 << 5, 5 << 5, 6 << 5, 7 << 5)
    deep = bytes([0, 7, 0, 0, 0]) + bytes(
        [OPEN | (i % 32) for i in range(40)])
    storm = bytes([0, 7, 2, 12, 2]) + bytes(
        [OPEN | 1, OPEN | 2, ERRC | 0, CLOSE | 0, TIMED | 9, ANN | 3,
         OPEN | 4, FLAG | 3, CLOSE | 0] * 6)
    churn = bytes([0, 0, 0, 28, 5]) + bytes(
        [(OPEN | (i % 32)) if i % 3 else (TIMED | (i % 32))
         for i in range(64)])
    early = bytes([0, 0, 1, 10, 1]) + bytes(
        [OPEN | 5, FIN, OPEN | 6, TIMED | 2, CLOSE, FIN, OPEN | 7,
         ANN | 1, CLOSE])
    spread = bytes([0, 3, 1, 20, 5]) + bytes(
        [TIMED | (1 + i % 31) for i in range(32)] + [OPEN | 9, CLOSE])
    return [deep, storm, churn, early, spread]


def fuzz_fleet_snapshot(data: bytes) -> None:
    """Fleet-spool op-stream interpreter (obs_fleet.py, ISSUE 20): the
    blob picks the member count, per-member retained generations, and
    staleness threshold, then drives counter bumps / gauge raises /
    histogram records / ``publish_once`` / torn-file injection /
    dead-member injection / full aggregation scans against one spool
    directory.  Whatever the stream does: fleet counters reconcile
    EXACTLY with the sum of each member's last-published model, gauges
    (``workers``) merge as the max, merged histogram counts equal the
    published sum and every exemplar's raw value re-derives its bucket,
    torn/truncated/garbage files are counted rejected (exactly) and are
    never fatal, injected dead members always read stale, per-member
    heartbeats are monotonic across generations, and pruning never
    retains more than ``keep`` generations — anything else is a finding.
    """
    import json
    import shutil as _shutil
    import tempfile as _tempfile
    import time

    from .obs import LatencyHistogram, StatsRegistry
    from .obs_fleet import FleetAggregator, SpoolWriter

    if len(data) < 4:
        return
    n_members = 1 + data[0] % 4
    keep = 1 + data[1] % 3
    stale_s = 0.5 + (data[2] & 3)
    ops = data[3:131]
    tmp = _tempfile.mkdtemp(prefix="tpq-fuzz-spool-")
    try:
        members = []
        for m in range(n_members):
            reg = StatsRegistry()
            members.append({
                "reg": reg,
                "w": SpoolWriter(reg, role=("serve", "loader", "writer")[
                    m % 3], spool_dir=tmp, keep=keep,
                    host=f"h{m % 2}", pid=1000 + m),
                "rows": 0, "workers": 0, "hist": 0,
                "pub": None, "hb": -1.0,
            })
        agg = FleetAggregator(spool_dir=tmp, stale_s=stale_s)
        garbage = dead = 0

        def check_scan():
            snap = agg.scan()
            if snap["rejected"] != garbage:
                raise AssertionError(
                    f"{garbage} garbage file(s) written but "
                    f"{snap['rejected']} rejected")
            pubs = [mm["pub"] for mm in members if mm["pub"] is not None]
            live = len(pubs)
            if len(snap["processes"]) != live + dead:
                raise AssertionError(
                    f"{live} live + {dead} dead member(s) but "
                    f"{len(snap['processes'])} in the fleet snapshot")
            wr = (snap["registry"].get("write") or {})
            want_rows = sum(p["rows"] for p in pubs)
            if int(wr.get("rows", 0)) != want_rows:
                raise AssertionError(
                    f"fleet write.rows {wr.get('rows')} != published sum "
                    f"{want_rows}")
            want_workers = max((p["workers"] for p in pubs), default=0)
            if int(wr.get("workers", 0)) != want_workers:
                raise AssertionError(
                    f"fleet write.workers {wr.get('workers')} != published "
                    f"max {want_workers}")
            hd = (snap["registry"].get("histograms") or {}).get(
                "serve.request") or {}
            want_n = sum(p["hist"] for p in pubs)
            if int(hd.get("count", 0)) != want_n:
                raise AssertionError(
                    f"fleet histogram count {hd.get('count')} != published "
                    f"sum {want_n}")
            for bi, ex in (hd.get("exemplars") or {}).items():
                if LatencyHistogram.bucket_index(float(ex[1])) != int(bi):
                    raise AssertionError(
                        f"merged exemplar {ex} under bucket {bi} re-derives "
                        f"{LatencyHistogram.bucket_index(float(ex[1]))}")
            for key, p in snap["processes"].items():
                if key.startswith("dead") and not p["stale"]:
                    raise AssertionError(
                        f"injected dead member {key} not flagged stale: {p}")

        for i, b in enumerate(ops):
            op, arg = b >> 5, b & 31
            mem = members[arg % n_members]
            if op in (0, 1):
                mem["reg"].add_write({"rows": arg + 1})
                mem["rows"] += arg + 1
            elif op == 2:
                mem["reg"].add_write({"workers": arg})
                mem["workers"] = max(mem["workers"], arg)
            elif op == 3:
                mem["reg"].histogram("serve.request").record(
                    (arg + 1) * 1e-4, exemplar=f"t-{arg}-{i}")
                mem["hist"] += 1
            elif op == 4:
                path = mem["w"].publish_once()
                if path is None:
                    raise AssertionError(
                        f"publish_once failed with a live spool dir "
                        f"({mem['w'].dropped} dropped)")
                with open(path) as f:
                    doc = json.load(f)
                if doc["heartbeat_ts"] < mem["hb"]:
                    raise AssertionError(
                        f"heartbeat went backwards: {doc['heartbeat_ts']} "
                        f"after {mem['hb']}")
                mem["hb"] = doc["heartbeat_ts"]
                mem["pub"] = {"rows": mem["rows"],
                              "workers": mem["workers"],
                              "hist": mem["hist"]}
            elif op == 5:
                kind = arg % 3
                blob = (b"{torn" if kind == 0
                        else b"[1, 2, 3]" if kind == 1
                        else json.dumps({"spool_version": 999, "host": "x",
                                         "pid": 1, "seq": 1,
                                         "heartbeat_ts": 0,
                                         "registry": {}}).encode())
                with open(os.path.join(tmp, f"zz-garbage-{i}.json"),
                          "wb") as f:
                    f.write(blob)
                garbage += 1
            elif op == 6:
                doc = {"spool_version": 1, "host": f"dead{i}", "pid": 9000,
                       "role": "loader", "seq": 1,
                       "heartbeat_ts": time.time() - 3600.0,
                       "registry": StatsRegistry().as_dict(), "traces": []}
                with open(os.path.join(tmp, f"dead{i}-9000.00000001.json"),
                          "w") as f:
                    json.dump(doc, f)
                dead += 1
            else:
                check_scan()
        check_scan()
        for mem in members:
            prefix = f"{mem['w']._member}."
            mine = [fn for fn in os.listdir(tmp) if fn.startswith(prefix)
                    and fn.endswith(".json")]
            if len(mine) > keep:
                raise AssertionError(
                    f"prune kept {len(mine)} generation(s) of "
                    f"{mem['w']._member}, cap {keep}: {sorted(mine)}")
    finally:
        _shutil.rmtree(tmp, ignore_errors=True)


def crafted_fleet_snapshot_blobs() -> "list[bytes]":
    """Hand-crafted ``fleet_snapshot`` inputs (and corpus blobs): a
    publish/scan cadence across 4 members, a garbage storm against one
    publishing member, a keep=1 prune churn with gauge raises, a
    dead-member graveyard, and a histogram/exemplar spread — each ends in
    a full-invariant aggregation scan."""
    BUMP, GAUGE, HIST, PUB, TORN, DEAD, SCAN = (
        0 << 5, 2 << 5, 3 << 5, 4 << 5, 5 << 5, 6 << 5, 7 << 5)
    cadence = bytes([3, 1, 1]) + bytes(
        b for i in range(8)
        for b in (BUMP | (i % 4), HIST | (i % 4), PUB | (i % 4), SCAN))
    storm = bytes([0, 1, 0]) + bytes(
        b for i in range(10)
        for b in (BUMP | 0, TORN | (i % 3), PUB | 0, SCAN))
    churn = bytes([0, 0, 2]) + bytes(
        b for i in range(12)
        for b in (GAUGE | (i % 8), BUMP | 0, PUB | 0)) + bytes([SCAN])
    graveyard = bytes([1, 1, 3]) + bytes(
        b for i in range(6) for b in (DEAD | 0, PUB | 0)) + bytes(
        [SCAN, DEAD | 0, SCAN])
    spread = bytes([2, 2, 0]) + bytes(
        b for i in range(20) for b in (HIST | (i % 32 & 31), PUB | (i % 2))
    ) + bytes([SCAN])
    return [cadence, storm, churn, graveyard, spread]


TARGETS = {
    "file_reader": fuzz_file_reader,
    "thrift": fuzz_thrift,
    "hybrid": fuzz_hybrid,
    "delta": fuzz_delta,
    "plain": fuzz_plain,
    "schema_dsl": fuzz_schema_dsl,
    "device_reader": fuzz_device_reader,
    "page_header": fuzz_page_header,
    "snappy": fuzz_snappy,
    "snappy_plan": fuzz_snappy_plan,
    "snappy_ops": fuzz_snappy_ops,
    "narrow": fuzz_narrow,
    "loader_state": fuzz_loader_state,
    "io_ranges": fuzz_io_ranges,
    "page_corrupt": fuzz_page_corrupt,
    "scan_plan": fuzz_scan_plan,
    "chaos_schedule": fuzz_chaos_schedule,
    "fused_plan": fuzz_fused_plan,
    "result_cache": fuzz_result_cache,
    "footer_merge": fuzz_footer_merge,
    "stream_cursor": fuzz_stream_cursor,
    "fetch_engine": fuzz_fetch_engine,
    "request_trace": fuzz_request_trace,
    "fleet_snapshot": fuzz_fleet_snapshot,
    # the port's own: no counterpart in the reference's harness
    "chunk_walk": fuzz_chunk_walk,
}


def crafted_io_range_blobs() -> "list[bytes]":
    """Hand-crafted ``io_ranges`` inputs (and corpus blobs): the planner
    shapes a real footer produces plus the hostile ones it doesn't."""

    def rec(off, size):
        return off.to_bytes(3, "little") + size.to_bytes(2, "little")

    # adjacent column chunks with small header gaps (the real row-group
    # shape coalescing exists for), generous gap + span
    adjacent = bytes([4, 2, 0]) + b"".join(
        rec(o, 1000) for o in range(64, 16064, 1040))
    # duplicate + overlapping ranges (a re-read of a dict page overlaps its
    # chunk), short-lie mode
    overlap = bytes([2, 2, 1]) + rec(100, 500) + rec(100, 500) + \
        rec(300, 800) + rec(2000, 100)
    # span-cap pressure: members that would merge but for the 128-byte cap,
    # overlong-lie mode
    capped = bytes([1, 0, 2]) + b"".join(rec(o, 100) for o in range(0, 1200, 101))
    # zero-size + EOF-straddling + past-EOF ranges, zero gap
    edges = bytes([0, 1, 1]) + rec(50, 0) + rec((1 << 18) - 40, 200) + \
        rec(1 << 18, 100) + rec(10, 7)
    return [adjacent, overlap, capped, edges]


# ---------------------------------------------------------------------------
# seeds + mutation
# ---------------------------------------------------------------------------

def _uvarint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def crafted_snappy_streams() -> "list[bytes]":
    """Hand-crafted raw-snappy streams for the snappy_ops target (and its
    checked-in corpus blobs): the hostile shapes the op-table planner must
    survive — no compressor in this repo emits them, so only crafting
    covers them."""
    # deep offset-1 overlap chain: 1 literal byte then 50 copies each
    # reading the bytes the PREVIOUS copy just wrote (max chain depth ~50,
    # the pointer-doubling resolver's worst shape per op count)
    deep = bytearray(_uvarint(1 + 50 * 60))
    deep += b"\x00x"  # literal len 1: 'x'
    for _ in range(50):
        deep += bytes([((60 - 1) << 2) | 2, 1, 0])  # kind-2 copy len 60 off 1
    # out-of-range copy: offset 5 with only 1 output byte written — the
    # decompressor rejects; the planner must reject identically
    oor = _uvarint(5) + b"\x00x" + bytes([((4 - 1) << 2) | 2, 5, 0])
    # kind-3 copy (4-byte little-endian offset, > 64 KiB back): a tag no
    # in-tree compressor emits
    lit = (bytes(range(256)) * 274)[:70000]
    big = bytearray(_uvarint(70064))
    big += bytes([62 << 2]) + (70000 - 1).to_bytes(3, "little") + lit
    big += bytes([((64 - 1) << 2) | 3]) + (65540).to_bytes(4, "little")
    # op-count pressure: 2000 one-byte literals — far past the planner's
    # starting table cap (max(n/32, 64)), forcing the ERR_CAP retry path
    many = bytearray(_uvarint(2000))
    for i in range(2000):
        many += bytes([0x00, i & 0xFF])
    return [bytes(deep), oor, bytes(big), bytes(many)]


def _seed_inputs(target: str) -> list[bytes]:
    """Valid inputs for the target, built in-process (corpus seeds)."""
    rng = np.random.default_rng(0)
    if target in ("file_reader", "thrift", "device_reader"):
        import io as _io

        from .format import (
            CompressionCodec, FieldRepetitionType as FRT, Type,
        )
        from .schema.core import build_schema, data_column
        from .writer import FileWriter

        sink = _io.BytesIO()
        schema = build_schema([
            data_column("a", Type.INT64, FRT.REQUIRED),
            data_column("b", Type.BYTE_ARRAY, FRT.OPTIONAL),
        ])
        with FileWriter(sink, schema, codec=CompressionCodec.SNAPPY) as w:
            from .column import ByteArrayData, ColumnData

            vals = [b"x", None, b"yz", b"", None, b"abc"] * 4
            heap = b"".join(v or b"" for v in vals)
            offs = np.cumsum([0] + [len(v or b"") for v in vals])
            dl = np.array([0 if v is None else 1 for v in vals], np.uint32)
            w.write_columns({
                "a": rng.integers(-(1 << 50), 1 << 50, len(vals)),
                "b": ColumnData(
                    values=ByteArrayData(
                        offsets=offs[np.r_[0, 1 + np.flatnonzero(dl)]],
                        heap=np.frombuffer(heap, np.uint8).copy(),
                    ),
                    def_levels=dl, max_def=1,
                ),
            })
        whole = sink.getvalue()
        if target == "thrift":
            # footer thrift bytes only (between data end and trailing len+magic)
            flen = int.from_bytes(whole[-8:-4], "little")
            return [whole[-8 - flen : -8]]
        if target == "device_reader":
            # second seed: PLAIN (non-dictionary) strings — the device-side
            # lengths/heap-compaction path has no dict analogue
            sink2 = _io.BytesIO()
            schema2 = build_schema([
                data_column("s", Type.BYTE_ARRAY, FRT.REQUIRED),
            ])
            from .column import ByteArrayData, ColumnData

            svals = [b"alpha", b"", b"bb", b"gamma-gamma", b"x"] * 8
            with FileWriter(sink2, schema2, codec=CompressionCodec.SNAPPY,
                            use_dictionary=False) as w2:
                w2.write_columns({"s": ColumnData(values=ByteArrayData(
                    offsets=np.cumsum([0] + [len(v) for v in svals]),
                    heap=np.frombuffer(b"".join(svals), np.uint8).copy(),
                ))})
            return [whole, sink2.getvalue()]
        return [whole]
    if target == "chunk_walk":
        return _chunk_walk_seeds()
    if target == "hybrid":
        from .kernels import rle

        vals = rng.integers(0, 8, 300, dtype=np.uint64)
        enc = rle.encode(vals, 3)
        return [bytes([3, 300 % 256]) + enc]
    if target == "delta":
        from .kernels import delta

        vals = np.cumsum(rng.integers(-50, 50, 300)).astype(np.int64)
        return [b"\x00" + delta.encode(vals, bits=64)]
    if target == "plain":
        return [bytes([6, 20]) + b"".join(
            len(s).to_bytes(4, "little") + s
            for s in (b"alpha", b"", b"beta") * 7
        )]
    if target == "page_header":
        from .format import (
            DataPageHeader, DataPageHeaderV2, DictionaryPageHeader, PageHeader,
        )
        from .thrift import write_struct

        v1 = PageHeader(
            type=0, uncompressed_page_size=1000, compressed_page_size=600,
            crc=123456, data_page_header=DataPageHeader(
                num_values=300, encoding=3, definition_level_encoding=3,
                repetition_level_encoding=3,
            ),
        )
        v2 = PageHeader(
            type=3, uncompressed_page_size=2048, compressed_page_size=900,
            data_page_header_v2=DataPageHeaderV2(
                num_values=128, num_nulls=5, num_rows=100, encoding=8,
                definition_levels_byte_length=17,
                repetition_levels_byte_length=0, is_compressed=True,
            ),
        )
        d = PageHeader(
            type=2, uncompressed_page_size=64, compressed_page_size=64,
            dictionary_page_header=DictionaryPageHeader(
                num_values=16, encoding=0, is_sorted=False,
            ),
        )
        return [write_struct(x) for x in (v1, v2, d)]
    if target == "schema_dsl":
        return [b"message m { required int64 a; optional group l (LIST) "
                b"{ repeated group list { optional binary element (STRING); } } }"]
    if target in ("snappy", "snappy_plan"):
        from . import native
        from .compress import _py_snappy_compress

        comp = (native.snappy_compress if native.available()
                else _py_snappy_compress)
        # bytes() each seed: native compress returns a uint8 array, and
        # mutate()'s truthiness/slicing assumes bytes semantics
        return [bytes(comp(x)) for x in (
            b"the quick brown fox " * 40,            # literal+copy mix
            bytes(rng.integers(0, 4, 600).astype(np.uint8)),
            b"\x00" * 3000,                          # deep RLE-style chains
            b"ab" * 2000,                            # offset-2 overlap copies
            b"",
        )]
    if target == "snappy_ops":
        return [b"\x02" + s for s in crafted_snappy_streams()] + [
            # declared-size lie: bias +1 on a valid stream must reject
            b"\x03" + crafted_snappy_streams()[0],
        ]
    if target == "io_ranges":
        return crafted_io_range_blobs()
    if target == "page_corrupt":
        return crafted_page_corrupt_blobs()
    if target == "scan_plan":
        return crafted_scan_plan_blobs()
    if target == "chaos_schedule":
        return crafted_chaos_blobs()
    if target == "fused_plan":
        return crafted_fused_plan_blobs()
    if target == "result_cache":
        return crafted_result_cache_blobs()
    if target == "footer_merge":
        return crafted_footer_merge_blobs()
    if target == "stream_cursor":
        return crafted_stream_cursor_blobs()
    if target == "fetch_engine":
        return crafted_fetch_engine_blobs()
    if target == "request_trace":
        return crafted_request_trace_blobs()
    if target == "fleet_snapshot":
        return crafted_fleet_snapshot_blobs()
    if target == "loader_state":
        from .data import checkpoint as ck

        loader = _loader_for_fuzz()
        fresh = loader.state_blob()
        mid = dict(loader.state())
        mid.update(epoch=2, rows_taken=2 * loader.batch_size)
        return [fresh, ck.pack_state(mid)]
    if target == "narrow":
        return [
            rng.integers(500, 1500, 64).astype(np.int64).tobytes(),
            (rng.integers(-40, 40, 64) * 1000).astype(np.int64).tobytes(),
            rng.integers(0, 200, 64).astype(np.int32).tobytes(),
            np.full(32, -(1 << 62), dtype=np.int64).tobytes(),
        ]
    raise KeyError(target)


def mutate(data: bytes, rng: np.random.Generator) -> bytes:
    """go-fuzz-style byte mutations: flips, splices, truncation, duplication."""
    if not data:
        return bytes(rng.integers(0, 256, rng.integers(1, 64), dtype=np.uint8))
    buf = bytearray(data)
    for _ in range(int(rng.integers(1, 8))):
        if not buf:
            break
        op = rng.integers(0, 6)
        i = int(rng.integers(0, len(buf)))
        if op == 0:      # bit flip
            buf[i] ^= 1 << int(rng.integers(0, 8))
        elif op == 1:    # random byte
            buf[i] = int(rng.integers(0, 256))
        elif op == 2 and len(buf) > 1:   # truncate tail
            del buf[i:]
        elif op == 3:    # insert random run
            ins = bytes(rng.integers(0, 256, int(rng.integers(1, 16)), dtype=np.uint8))
            buf[i:i] = ins
        elif op == 4:    # duplicate a chunk
            j = int(rng.integers(0, len(buf)))
            lo, hi = min(i, j), max(i, j)
            buf[lo:lo] = buf[lo:hi][:64]
        elif op == 5:    # interesting values
            magic = rng.choice([0x00, 0xFF, 0x7F, 0x80, 0x01])
            buf[i] = int(magic)
        if len(buf) > 1 << 16:
            del buf[1 << 16 :]
    return bytes(buf)


def minimize(target_fn, data: bytes, max_rounds: int = 200) -> bytes:
    """Greedy chunk-deletion minimization preserving the crash."""
    def crashes(b: bytes) -> bool:
        try:
            target_fn(b)
            return False
        except ParquetError:
            return False
        except Exception:
            return True

    if not crashes(data):
        return data
    cur = data
    step = max(len(cur) // 2, 1)
    rounds = 0
    while step > 0 and rounds < max_rounds:
        i = 0
        shrunk = False
        while i < len(cur) and rounds < max_rounds:
            cand = cur[:i] + cur[i + step :]
            rounds += 1
            if cand != cur and crashes(cand):
                cur = cand
                shrunk = True
            else:
                i += step
        if not shrunk:
            step //= 2
    return cur


# the targets that take ``device=`` (the device reader and the result
# cache's device tier)
DEVICE_TARGETS = frozenset({"device_reader", "result_cache"})


def target_fn(target: str, device=None):
    """The target's callable, bound to ``device`` where it takes one (the
    device is resolved here: without a card the default raises before any
    input runs)."""
    fn = TARGETS[target]
    if target in DEVICE_TARGETS:
        from .torch_decode import _resolve_device

        return functools.partial(
            fn, device=_resolve_device(device, f"fuzz target {target}"))
    return fn


def corpus_files(dirs=REPLAY_DIRS) -> "list[str]":
    """The corpus files (``<target>-<sha>``) of ``dirs``, in order; dot
    files and absent directories are skipped."""
    return [os.path.join(d, n) for d in dirs if os.path.isdir(d)
            for n in sorted(os.listdir(d)) if not n.startswith(".")]


def replay(dirs=REPLAY_DIRS, device=None) -> "list[tuple[str, str]]":
    """Run every corpus file of ``dirs`` through its target; returns
    ``(path, exception repr)`` for each that raised anything but
    ``ParquetError``."""
    failures = []
    for path in corpus_files(dirs):
        name = os.path.basename(path)
        fn = target_fn(name.rsplit("-", 1)[0], device)
        with open(path, "rb") as f:
            data = f.read()
        try:
            fn(data)
        except ParquetError:
            pass
        except Exception as e:  # noqa: BLE001 — the whole point
            failures.append((path, repr(e)))
            print(f"[replay] {path}: CRASH {e!r}", file=sys.stderr)
    return failures


def run_fuzz(target: str, runs: int, seed: int = 0,
             save_crashers: bool = True, device=None):
    """Fuzz one target; returns list of (minimized_input, exception_repr).
    ``device`` is the device of the targets in ``DEVICE_TARGETS``."""
    fn = target_fn(target, device)
    rng = np.random.default_rng(seed)
    corpus = _seed_inputs(target)
    crashers = []
    for it in range(runs):
        base = corpus[int(rng.integers(0, len(corpus)))]
        data = mutate(base, rng)
        try:
            fn(data)
            if len(corpus) < 64 and rng.random() < 0.02:
                corpus.append(data)  # coverage-ish: keep accepted mutants
        except ParquetError:
            pass
        except Exception as e:  # noqa: BLE001 — the whole point
            small = minimize(fn, data)
            crashers.append((small, repr(e)))
            if save_crashers:
                os.makedirs(_CORPUS_DIR, exist_ok=True)
                name = f"{target}-{hashlib.sha256(small).hexdigest()[:12]}"
                with open(os.path.join(_CORPUS_DIR, name), "wb") as f:
                    f.write(small)
            print(f"[{target}] iter {it}: CRASH {e!r} "
                  f"({len(data)}B → {len(small)}B)", file=sys.stderr)
    return crashers


def main(argv=None):
    import argparse

    from .cuda_kernels import launches

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--target", default="all", choices=["all", *TARGETS])
    ap.add_argument("--runs", type=int, default=5000)
    ap.add_argument("--target-runs", action="append", default=[],
                    metavar="NAME=N",
                    help="runs for one target instead of --runs")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the device targets (default: cuda)")
    ap.add_argument("--replay", action="append", default=None, metavar="DIR",
                    help="replay a corpus directory first (repeatable)")
    ap.add_argument("--no-save", action="store_true",
                    help="do not write crashers to the corpus")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the per-target summary as JSON")
    args = ap.parse_args(argv)
    runs_for = {}
    for spec in args.target_runs:
        name, _, n = spec.partition("=")
        if name not in TARGETS or not n.isdigit():
            ap.error(f"--target-runs wants NAME=N with a target name: {spec!r}")
        runs_for[name] = int(n)
    summary: dict = {"device": args.device, "seed": args.seed,
                     "replay": None, "targets": {}}
    total = 0
    before = dict(launches)
    if args.replay:
        t0 = time.perf_counter()
        n_files = len(corpus_files(args.replay))
        failed = replay(args.replay, device=args.device)
        summary["replay"] = {"files": n_files, "crashers": len(failed),
                             "failed": failed,
                             "seconds": time.perf_counter() - t0}
        print(f"replay: {n_files} files, {len(failed)} crashers",
              file=sys.stderr)
        total += len(failed)
    names = list(TARGETS) if args.target == "all" else [args.target]
    for name in names:
        runs = runs_for.get(name, args.runs)
        t0 = time.perf_counter()
        found = run_fuzz(name, runs, seed=args.seed,
                         save_crashers=not args.no_save, device=args.device)
        secs = time.perf_counter() - t0
        summary["targets"][name] = {"runs": runs, "crashers": len(found),
                                    "seconds": secs}
        print(f"{name}: {runs} runs, {len(found)} crashers", file=sys.stderr)
        total += len(found)
    summary["launches"] = {k: n - before[k] for k, n in launches.items()}
    summary["crashers"] = total
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=1)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
