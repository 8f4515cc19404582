"""Native (C++) runtime pieces, loaded via ctypes.

Built lazily with g++ the first time they're needed (no pip/cmake dependency at
import time); the shared object is cached next to the sources and rebuilt when any
source file changes (content-hash stamp).  The build writes a per-process temporary
file and renames it onto the stamped name, so processes that load at the same moment
never open a half-written library.  Everything here is optional: each consumer
has a pure-Python fallback, so the framework still works — slower — without a C++
toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ["snappy.cpp", "meta_parse.cpp"]
_LIB_BASENAME = "_libtpq_native.so"

_lock = threading.Lock()
_lib = None
_load_failed = False


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in _SOURCES:
        with open(os.path.join(_DIR, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _build(lib_path: str, attempt: int = 0) -> None:
    """Compile into a temporary name of this process, then rename it onto
    ``lib_path`` in one step (another process sees no file or a whole one),
    and only then drop the builds of other source stamps."""
    tmp = f"{lib_path}.tmp{os.getpid()}_{attempt}"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-march=native",
        "-o", tmp,
    ] + [os.path.join(_DIR, s) for s in _SOURCES]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    keep = os.path.basename(lib_path)
    for f in os.listdir(_DIR):
        # stale stamps only: another process's temporary file is its build
        if f.startswith(_LIB_BASENAME) and f != keep and ".tmp" not in f:
            try:
                os.unlink(os.path.join(_DIR, f))
            except OSError:
                pass


def load():
    """Return the ctypes native library, building it if needed; None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            stamp = _source_hash()
            lib_path = os.path.join(_DIR, f"{_LIB_BASENAME}.{stamp}")
            if not os.path.exists(lib_path):
                _build(lib_path)
            try:
                lib = ctypes.CDLL(lib_path)
            except OSError:
                # a damaged file under the stamped name: rebuild it once
                _build(lib_path, attempt=1)
                lib = ctypes.CDLL(lib_path)
            lib.tpq_snappy_uncompressed_length.restype = ctypes.c_longlong
            lib.tpq_snappy_uncompressed_length.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.tpq_snappy_decompress.restype = ctypes.c_int
            lib.tpq_snappy_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t,
            ]
            lib.tpq_snappy_max_compressed_length.restype = ctypes.c_size_t
            lib.tpq_snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
            lib.tpq_snappy_compress.restype = ctypes.c_longlong
            lib.tpq_snappy_compress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p,
            ]
            c_ll = ctypes.c_longlong
            p = ctypes.POINTER
            lib.tpq_delta_ba_stitch.restype = c_ll
            lib.tpq_delta_ba_stitch.argtypes = [
                p(ctypes.c_longlong), p(ctypes.c_longlong), p(ctypes.c_uint8),
                p(ctypes.c_longlong), p(ctypes.c_uint8), c_ll,
            ]
            lib.tpq_bytearray_walk.restype = c_ll
            lib.tpq_bytearray_walk.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, p(ctypes.c_longlong),
                p(ctypes.c_uint8),
            ]
            lib.tpq_bytearray_lengths.restype = c_ll
            lib.tpq_bytearray_lengths.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, c_ll, p(ctypes.c_uint32),
            ]
            lib.tpq_page_header.restype = c_ll
            lib.tpq_page_header.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, p(ctypes.c_longlong),
            ]
            lib.tpq_delta_meta.restype = c_ll
            lib.tpq_delta_meta.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, p(ctypes.c_longlong),
                p(ctypes.c_longlong), p(ctypes.c_int32), p(ctypes.c_uint64),
                c_ll,
            ]
            lib.tpq_snappy_plan.restype = c_ll
            lib.tpq_snappy_plan.argtypes = [
                ctypes.c_char_p, c_ll, c_ll,
                p(c_ll), p(c_ll), p(ctypes.c_uint8), c_ll,
                p(c_ll), c_ll, p(c_ll),
            ]
            lib.tpq_dict_build_bytes.restype = c_ll
            lib.tpq_dict_build_bytes.argtypes = [
                p(c_ll), ctypes.c_char_p, c_ll, c_ll,
                p(ctypes.c_int32), c_ll, p(ctypes.c_uint32), p(c_ll),
            ]
            lib.tpq_dict_build_fixed.restype = c_ll
            lib.tpq_dict_build_fixed.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, c_ll,
                p(ctypes.c_int32), c_ll, p(ctypes.c_uint32), p(c_ll),
            ]
            lib.tpq_int_minmax.restype = None
            lib.tpq_int_minmax.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, ctypes.c_int, p(c_ll),
            ]
            lib.tpq_int_truncate.restype = None
            lib.tpq_int_truncate.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.tpq_hybrid_meta.restype = c_ll
            # output pointers as c_void_p: the wrapper passes raw addresses
            # into ONE arena allocation — per-call POINTER() casts on the
            # hottest wrapper (once per page per stream) cost as much as the
            # C walk itself
            lib.tpq_bp_pack.restype = None
            lib.tpq_bp_pack.argtypes = [
                p(ctypes.c_uint64), c_ll, c_ll, ctypes.c_void_p,
            ]
            lib.tpq_hybrid_meta.argtypes = [
                ctypes.c_char_p, c_ll, c_ll, c_ll, c_ll,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, c_ll, ctypes.c_void_p,
                c_ll, ctypes.c_void_p,
                c_ll, ctypes.c_uint64, ctypes.c_void_p,
            ]
            lib.tpq_ragged_take.restype = None
            lib.tpq_ragged_take.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, c_ll,
                ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.tpq_hybrid_expand.restype = None
            lib.tpq_hybrid_expand.argtypes = [
                ctypes.c_char_p, c_ll,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, c_ll, ctypes.c_int, c_ll, ctypes.c_void_p,
            ]
            _lib = lib
        except Exception:
            _load_failed = True
    return _lib


def _buf_arg(buf):
    """ctypes argument for a read-only byte buffer: ``bytes`` passes through
    (fast path, no conversion); any other contiguous buffer-protocol object
    (numpy views of decompressed pages, memoryviews of mmap'd chunks) passes
    as a raw pointer with ZERO copies.  The caller's reference keeps the
    memory alive for the duration of the call."""
    if type(buf) is bytes:
        return buf
    import numpy as np

    a = np.frombuffer(buf, np.uint8)
    return ctypes.c_char_p(a.ctypes.data)


def snappy_decompress(data, max_size: int = -1):
    """Raw-snappy decompress; returns a uint8 numpy array (NOT bytes — the
    extra ``tobytes`` copy was ~1 s of a 100M-row scan's host phase; every
    downstream consumer slices/views, so the buffer-protocol array is a
    drop-in)."""
    import numpy as np

    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    dptr = _buf_arg(data)
    n = lib.tpq_snappy_uncompressed_length(dptr, len(data))
    if n < 0:
        raise ValueError("malformed snappy data: bad length header")
    if 0 <= max_size < n:
        # bomb guard: the stream's own varint claims more than the page header
        # declared — reject BEFORE allocating the output buffer
        raise ValueError(
            f"snappy stream claims {n} bytes, page declared {max_size}"
        )
    # np.empty skips create_string_buffer's zero-init memset (decompress
    # overwrites every byte on success; failures discard the buffer).
    # +16 slack bytes: tpq_snappy_decompress's short-op fast paths do blind
    # 16-byte stores (see its contract); the logical output is out[:n].
    out = np.empty(n + 16, dtype=np.uint8)
    rc = lib.tpq_snappy_decompress(
        dptr, len(data), out.ctypes.data_as(ctypes.c_char_p), n
    )
    if rc != 0:
        raise ValueError(f"malformed snappy data (error {rc})")
    return out[:n]


def snappy_compress(data) -> bytes:
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    import numpy as np

    cap = lib.tpq_snappy_max_compressed_length(len(data))
    # np.empty (no zero-init) + _buf_arg input: the create_string_buffer
    # memset and the callers' bytes() copies were ~15% of a plain-int64
    # page write
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tpq_snappy_compress(_buf_arg(data), len(data),
                                out.ctypes.data_as(ctypes.c_char_p))
    if n < 0:
        raise ValueError("snappy compression failed")
    # uint8-array out: the parts-based page writer appends buffers and
    # never concatenates, so the tobytes copy (was ~10% of a plain page
    # write) is pure waste.  NOTE for consumers: never += this into a
    # bytearray via fallback paths — numpy broadcasting hazard.
    return out[:n]


def delta_meta(buf: bytes, pos: int, cap: int):
    """Walk DELTA_BINARY_PACKED headers natively (meta_parse.cpp).

    Returns (header, starts, widths, mins) on success where header is
    int64[6] = [block_size, minis_per_block, total, first_value, consumed,
    n_minis] and the arrays are trimmed to n_minis — or a negative error code
    (int) the caller maps to its DeltaError messages.  Returns None when the
    native library is unavailable (caller falls back to the Python walk).
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    header = np.zeros(6, dtype=np.int64)
    starts = np.empty(cap, dtype=np.int64)
    widths = np.empty(cap, dtype=np.int32)
    mins = np.empty(cap, dtype=np.uint64)
    pll = ctypes.POINTER(ctypes.c_longlong)
    rc = lib.tpq_delta_meta(
        _buf_arg(buf), len(buf), pos,
        header.ctypes.data_as(pll),
        starts.ctypes.data_as(pll),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mins.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        cap,
    )
    if rc < 0:
        return int(rc)
    n = int(header[5])
    return header, starts[:n], widths[:n], mins[:n]


def hybrid_meta(buf: bytes, n: int, pos: int, width: int, count: int, cap: int,
                want_max: bool = False, eq_target: "int | None" = None):
    """Walk RLE/bit-packed hybrid run headers natively (meta_parse.cpp).

    Returns (n_runs, consumed, ends, kinds, vals, starts, max_value,
    eq_count) trimmed to n_runs (max_value is None unless want_max; eq_count
    — the number of stream values equal to ``eq_target`` — is None unless
    eq_target is given), a negative error code (int; -10 = cap exceeded,
    retry bigger), or None when the native library is unavailable.
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    # ONE arena for every output (header scalars + 4 run tables), addressed
    # by raw pointer arithmetic: the previous 7 allocations + 7 POINTER()
    # casts cost ~as much as the C walk on run-light pages, and this wrapper
    # runs once per page per stream.  Layout (8-aligned: np.empty data is
    # 16-aligned, all offsets multiples of 8 until the u32/u8 tails):
    #   [consumed i64 | max u64 | eq i64 | ends i64*cap | starts i64*cap
    #    | vals u32*cap | kinds u8*cap]
    o_ends, o_starts = 24, 24 + 8 * cap
    o_vals, o_kinds = 24 + 16 * cap, 24 + 20 * cap
    arena = np.empty(24 + 21 * cap, dtype=np.uint8)
    arena[:24] = 0  # scalar slots must read 0 when not requested
    base = arena.ctypes.data
    rc = lib.tpq_hybrid_meta(
        _buf_arg(buf), n, pos, width, count,
        base + o_ends, base + o_kinds, base + o_vals, base + o_starts, cap,
        base,
        1 if want_max else 0,
        base + 8,
        0 if eq_target is None else 1,
        0 if eq_target is None else int(eq_target),
        base + 16,
    )
    if rc < 0:
        return int(rc)
    r = int(rc)
    head = np.frombuffer(arena, np.int64, 3, 0)
    # the max slot is u64 in C — an i64 view would return >=2^63 values
    # (width-64 RLE runs) as negative
    mx = int(np.frombuffer(arena, np.uint64, 1, 8)[0]) if want_max else None
    eq = int(head[2]) if eq_target is not None else None
    return (
        r, int(head[0]),
        np.frombuffer(arena, np.int64, r, o_ends),
        np.frombuffer(arena, np.uint8, r, o_kinds),
        np.frombuffer(arena, np.uint32, r, o_vals),
        np.frombuffer(arena, np.int64, r, o_starts),
        mx, eq,
    )


# meta_parse.cpp error codes → messages (kept aligned with the C enum);
# shared by every native-walk caller so diagnostics don't depend on which
# wrapper surfaced the failure
NATIVE_ERRORS = {
    -1: "truncated varint in stream header",
    -2: "varint too long in stream header",
    -3: "invalid delta block size",
    -4: "invalid miniblock count",
    -5: "miniblock size not multiple of 32",
    -6: "implausible delta value count",
    -7: "truncated miniblock bit widths",
    -8: "invalid miniblock bit width",
    -9: "truncated miniblock data",
    -11: "truncated bit-packed run",
    -12: "truncated RLE run value",
    -13: "hybrid stream exhausted",
}


def hybrid_meta_retry(buf: bytes, n: int, pos: int, width: int, count: int,
                      want_max: bool = False, eq_target: "int | None" = None):
    """hybrid_meta with the standard cap-retry policy.

    Starts with a small run-table cap and retries once with the provable
    worst case (one run per value/byte) on ERR_CAP.  Returns the result
    tuple, a negative error code, or None when unavailable.
    """
    cap = min(count, max(n - pos, 0) + 1, 4096)
    full_cap = min(count, max(n - pos, 0) + 1)
    while True:
        res = hybrid_meta(buf, n, pos, width, count, cap, want_max=want_max,
                          eq_target=eq_target)
        if isinstance(res, int) and res == -10 and cap < full_cap:
            cap = full_cap
            continue
        return res


def bytearray_walk(buf: bytes, count: int):
    """Walk PLAIN BYTE_ARRAY length prefixes natively (meta_parse.cpp).

    Returns (offsets int64[count+1], heap uint8[total]) with prefixes
    stripped, a negative error code (int), or None when the native library is
    unavailable.
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    n = len(buf)
    offsets = np.empty(count + 1, dtype=np.int64)
    # upper bound is n, NOT n - 4*count: a malformed stream can run out of
    # records midway, after legitimately copying up to ~n payload bytes
    # (found by fuzz_plain — the tighter bound corrupted the heap allocation)
    heap = np.empty(n, dtype=np.uint8)
    rc = lib.tpq_bytearray_walk(
        _buf_arg(buf), n, count,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        heap.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc < 0:
        return int(rc)
    return offsets, heap[: int(rc)]


def bytearray_lengths(buf: bytes, count: int, pos: int = 0):
    """Validate PLAIN BYTE_ARRAY prefixes from ``pos`` and return the u32
    lengths only (no copies anywhere: the caller passes the whole page
    buffer + offset, and the device compacts the heap from the raw stream).

    Returns (lens uint32[count], consumed_end int — the stream position
    after the last value), a negative error code (int), or None when the
    native library is unavailable.
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    lens = np.empty(count, dtype=np.uint32)
    rc = lib.tpq_bytearray_lengths(
        _buf_arg(buf), len(buf), pos, count,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if rc < 0:
        return int(rc)
    return lens, int(rc)


def snappy_plan(payload: bytes, expect: int):
    """Parse a raw snappy stream's TAG STRUCTURE only (no byte movement).

    Returns (dst_end int64[nops], op_src int64[nops], is_lit uint8[nops],
    max_chain_depth int) where dst_end is each op's cumulative output end,
    op_src is a literal run's payload offset in the COMPRESSED stream or a
    copy's back-reference offset, and max_chain_depth bounds the
    pointer-doubling rounds the device resolver needs
    (device_reader._plan_device_snappy).  Validates the whole stream with the
    same reject set as tpq_snappy_decompress.  Returns a negative error code
    on malformed input, or None when the native library is unavailable.
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    n = len(payload)
    full_cap = n // 2 + 2  # provable worst case: every op >= 2 stream bytes
    # normal streams carry one op per ~60 bytes; start small and retry on
    # ERR_CAP — allocating (and zeroing the depth tree for) the worst case
    # up front costs more than the walk itself on multi-MB pages
    cap = min(full_cap, max(n // 32, 64))
    pll = ctypes.POINTER(ctypes.c_longlong)
    while True:
        cap2 = 1
        while cap2 < cap:
            cap2 <<= 1
        dst_end = np.empty(cap, dtype=np.int64)
        op_src = np.empty(cap, dtype=np.int64)
        is_lit = np.empty(cap, dtype=np.uint8)
        seg = np.zeros(2 * cap2, dtype=np.int64)  # zeroed: depth maxima
        out = np.zeros(2, dtype=np.int64)
        rc = lib.tpq_snappy_plan(
            _buf_arg(payload), n, expect,
            dst_end.ctypes.data_as(pll), op_src.ctypes.data_as(pll),
            is_lit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
            seg.ctypes.data_as(pll), cap2, out.ctypes.data_as(pll),
        )
        if rc == -10 and cap < full_cap:
            cap = min(full_cap, cap * 8)
            continue
        if rc < 0:
            return int(rc)
        r = int(rc)
        return dst_end[:r], op_src[:r], is_lit[:r], int(out[1])


def dict_build(n: int, max_dict: int, *, offsets=None, heap=None,
               data=None, width: int = 0):
    """First-appearance dictionary build (writer side) — ragged when
    ``offsets``/``heap`` given, fixed-width rows when ``data``/``width``.

    Returns (firsts int64[k], inverse uint32[n]) in first-appearance order,
    -50 when the distinct count exceeds ``max_dict`` (caller falls back to
    plain), or None when the native library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    nslots = 16
    while nslots < 2 * n:
        nslots <<= 1
    slots = np.full(nslots, -1, dtype=np.int32)
    inverse = np.empty(n, dtype=np.uint32)
    firsts = np.empty(max_dict, dtype=np.int64)
    pll = ctypes.POINTER(ctypes.c_longlong)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    if offsets is not None:
        rc = lib.tpq_dict_build_bytes(
            offsets.ctypes.data_as(pll),
            heap.ctypes.data_as(ctypes.c_char_p), n, max_dict,
            slots.ctypes.data_as(pi32), nslots,
            inverse.ctypes.data_as(pu32), firsts.ctypes.data_as(pll),
        )
    else:
        rc = lib.tpq_dict_build_fixed(
            data.ctypes.data_as(ctypes.c_char_p), n, width, max_dict,
            slots.ctypes.data_as(pi32), nslots,
            inverse.ctypes.data_as(pu32), firsts.ctypes.data_as(pll),
        )
    if rc < 0:
        return int(rc)
    return firsts[: int(rc)], inverse


def bp_pack(vals, width: int):
    """LSB-first bit-pack of a contiguous uint64 array (widths 1..56);
    returns a uint8 array of ceil(n*width/8) bytes, or None when the native
    library is unavailable."""
    import numpy as np

    lib = load()
    if lib is None or not 1 <= width <= 56:
        return None
    v = np.ascontiguousarray(vals, dtype=np.uint64)
    out = np.empty((len(v) * width + 7) // 8, dtype=np.uint8)
    lib.tpq_bp_pack(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(v), width,
        out.ctypes.data,
    )
    return out


def int_minmax(buf: bytes, pos: int, n: int, width: int):
    """Min/max of ``n`` little-endian signed ``width``-byte ints at buf+pos.

    Returns (min, max) as python ints, or None when the native library is
    unavailable (caller falls back to numpy)."""
    import numpy as np

    lib = load()
    if lib is None or n <= 0:
        return None
    out = np.empty(2, dtype=np.int64)
    lib.tpq_int_minmax(
        _buf_arg(buf), pos, n, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    return int(out[0]), int(out[1])


def int_truncate(buf: bytes, pos: int, n: int, width: int, bias: int, k: int,
                 dst) -> bool:
    """Write ``(v - bias) mod 2**(8*width)`` truncated to k bytes per value
    into ``dst`` (uint8 numpy array, >= n*k bytes).  Returns False when the
    native library is unavailable."""
    lib = load()
    if lib is None:
        return False
    lib.tpq_int_truncate(_buf_arg(buf), pos, n, width,
                         ctypes.c_uint64(bias % (1 << 64)), k,
                         dst.ctypes.data)
    return True


def page_header(buf: bytes, pos: int = 0):
    """Parse one thrift compact PageHeader natively (meta_parse.cpp).

    Returns (PageHeader, end_pos), a negative error code (int — TERR_*
    values, same accept/reject set as the Python engine), or None when the
    native library is unavailable.  Everything the format defines is
    populated, including each data page header's Statistics (min/max bytes,
    null/distinct counts — consumed by page-level predicate pruning).
    """
    lib = load()
    if lib is None:
        return None
    # stack-local ctypes array: per-page numpy allocation + data_as cast
    # would eat a few percent of the win this parser exists for
    out = (ctypes.c_longlong * 40)()
    rc = lib.tpq_page_header(_buf_arg(buf), len(buf), pos, out)
    if rc < 0:
        return int(rc)
    from ..format import (
        DataPageHeader, DataPageHeaderV2, DictionaryPageHeader,
        IndexPageHeader, PageHeader, Statistics,
    )

    mask = int(out[18])

    def g(i):
        return int(out[i]) if mask >> i & 1 else None

    def stats(base, struct_bit):
        if not (mask >> struct_bit & 1):
            return None
        st = Statistics(null_count=g(base), distinct_count=g(base + 1))

        def b(slot):
            if not (mask >> slot & 1):
                return None
            p, ln = int(out[slot]), int(out[slot + 1])
            return buf[p : p + ln]

        st.max, st.min = b(base + 2), b(base + 4)
        st.max_value, st.min_value = b(base + 6), b(base + 8)
        return st

    h = PageHeader(
        type=g(0), uncompressed_page_size=g(1),
        compressed_page_size=g(2), crc=g(3),
    )
    if mask >> 60 & 1:
        h.data_page_header = DataPageHeader(
            num_values=g(4), encoding=g(5),
            definition_level_encoding=g(6), repetition_level_encoding=g(7),
            statistics=stats(20, 58),
        )
    if mask >> 59 & 1:
        h.index_page_header = IndexPageHeader()
    if mask >> 61 & 1:
        dph = DictionaryPageHeader(num_values=g(8), encoding=g(9))
        if mask >> 10 & 1:
            dph.is_sorted = bool(out[10])
        h.dictionary_page_header = dph
    if mask >> 62 & 1:
        v2 = DataPageHeaderV2(
            num_values=g(11), num_nulls=g(12), num_rows=g(13),
            encoding=g(14), definition_levels_byte_length=g(15),
            repetition_levels_byte_length=g(16),
            statistics=stats(30, 57),
        )
        if mask >> 17 & 1:
            v2.is_compressed = bool(out[17])
        h.data_page_header_v2 = v2
    return h, int(out[19])


def delta_ba_stitch(prefix_lens, suf_off, suf_heap, out_off, heap) -> "int | None":
    """Run the DELTA_BYTE_ARRAY prefix chain natively (meta_parse.cpp).

    All arguments are numpy arrays (int64 offsets, uint8 heaps); ``heap`` is
    written in place.  Returns 0, -30 (prefix exceeds previous value), or
    None when the native library is unavailable.
    """
    lib = load()
    if lib is None:
        return None
    pll = ctypes.POINTER(ctypes.c_longlong)
    pu8 = ctypes.POINTER(ctypes.c_uint8)
    return int(lib.tpq_delta_ba_stitch(
        prefix_lens.ctypes.data_as(pll),
        suf_off.ctypes.data_as(pll),
        suf_heap.ctypes.data_as(pu8),
        out_off.ctypes.data_as(pll),
        heap.ctypes.data_as(pu8),
        len(prefix_lens),
    ))


def ragged_take(offsets, heap, idx, out_off, out_heap) -> bool:
    """Gather ragged rows: out_heap[out_off[i]:out_off[i+1]] =
    heap[offsets[idx[i]]:offsets[idx[i]+1]] (dictionary expansion).

    All arrays are caller-allocated, contiguous numpy (offsets/idx/out_off
    int64, heaps uint8); the caller computed ``out_off`` and bounds-checked
    ``idx``.  Returns False when the native library is unavailable (caller
    keeps the numpy gather).  Runs with the GIL released — the prefetch
    pipeline's worker threads overlap here.
    """
    lib = load()
    if lib is None:
        return False
    lib.tpq_ragged_take(
        offsets.ctypes.data, heap.ctypes.data, idx.ctypes.data, len(idx),
        out_off.ctypes.data, out_heap.ctypes.data,
    )
    return True


def hybrid_expand(buf, ends, kinds, vals, starts, width: int, count: int):
    """Expand hybrid run tables (hybrid_meta output) to uint32[count].

    Same value contract as the numpy sweep in kernels/rle.py:_decode_native
    (bit-packed fields at starts[r] + i*width, RLE broadcasting vals[r]).
    Returns the array, or None when the native library is unavailable.
    GIL-free like ragged_take.
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    out = np.empty(count, dtype=np.uint32)
    # locals keep the (possibly converted) tables alive across the C call
    e = np.ascontiguousarray(ends, np.int64)
    k = np.ascontiguousarray(kinds, np.uint8)
    v = np.ascontiguousarray(vals, np.uint32)
    s = np.ascontiguousarray(starts, np.int64)
    lib.tpq_hybrid_expand(
        _buf_arg(buf), len(buf),
        e.ctypes.data, k.ctypes.data, v.ctypes.data, s.ctypes.data,
        len(e), width, count, out.ctypes.data,
    )
    return out


def available() -> bool:
    return load() is not None
