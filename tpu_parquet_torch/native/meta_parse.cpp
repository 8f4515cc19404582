// Host-side stream-structure parsers: DELTA_BINARY_PACKED block headers and
// RLE/bit-packed hybrid run headers.
//
// The device decode path splits every encoded stream into (structure, bulk):
// structure — varint headers, a few bytes per block/run — is walked on the
// host; bulk bytes go to the TPU untouched (jax_decode.parse_delta_meta /
// parse_hybrid_meta docstrings).  The structure walk is sequential byte
// chasing, the one shape Python is worst at: on a 10M-row DELTA column the
// pure-Python walk costs ~10x the actual XLA decode.  These C functions do the
// identical walk at memory speed; the Python versions remain as the reference
// implementation and the fallback when no C++ toolchain is available.
//
// Semantics mirror the reference decoders' header validation:
// deltabp_decoder.go:38-103 (block geometry + bit-width bounds) and
// hybrid_decoder.go:115-165 (run headers, truncation checks).  Varints follow
// helpers.go readUVariant64: at most 10 bytes (continuation past shift 63 is
// an error); values may exceed 64 bits transiently, so accumulation is 128-bit
// to match the Python parser bit for bit on hostile inputs.

#include <cstdint>

typedef uint8_t u8;
typedef int32_t i32;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;
typedef unsigned __int128 u128;

namespace {

// error codes shared with the ctypes wrapper (tpu_parquet/native/__init__.py)
enum {
    ERR_TRUNC_VARINT = -1,
    ERR_VARINT_LONG = -2,
    ERR_BLOCK_SIZE = -3,
    ERR_MINI_COUNT = -4,
    ERR_MINI_MULT = -5,
    ERR_COUNT_BOMB = -6,
    ERR_TRUNC_WIDTHS = -7,
    ERR_BAD_WIDTH = -8,
    ERR_TRUNC_MINI = -9,
    ERR_CAP = -10,
    ERR_TRUNC_RUN = -11,
    ERR_TRUNC_RLE_VALUE = -12,
    ERR_EXHAUSTED = -13,
};

int read_uvarint(const u8 *buf, i64 n, i64 *pos, u128 *out) {
    u128 result = 0;
    int shift = 0;
    for (;;) {
        if (*pos >= n) return ERR_TRUNC_VARINT;
        u8 b = buf[(*pos)++];
        result |= (u128)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            *out = result;
            return 0;
        }
        shift += 7;
        if (shift > 63) return ERR_VARINT_LONG;
    }
}

int read_zigzag(const u8 *buf, i64 n, i64 *pos, u128 *out) {
    u128 v;
    int rc = read_uvarint(buf, n, pos, &v);
    if (rc) return rc;
    // (v >> 1) ^ -(v & 1) in 128-bit, exactly like the Python reference
    *out = (v >> 1) ^ (~(u128)0 * (v & 1));
    return 0;
}

}  // namespace

extern "C" {

// Parse a DELTA_BINARY_PACKED stream's headers starting at buf[pos].
//
// header_out[6]: block_size, minis_per_block, total, first_value (two's
// complement low 64 bits), consumed byte position, n_minis written.
// starts/widths/mins: per-miniblock payload bit offset, bit width, and block
// min-delta (low 64 bits), cap entries each.  Returns 0 or a negative error.
i64 tpq_delta_meta(const u8 *buf, i64 len, i64 pos, i64 *header_out,
                   i64 *starts, i32 *widths, u64 *mins, i64 cap) {
    u128 block_size, minis_per_block, total, first;
    int rc;
    if ((rc = read_uvarint(buf, len, &pos, &block_size))) return rc;
    if ((rc = read_uvarint(buf, len, &pos, &minis_per_block))) return rc;
    if ((rc = read_uvarint(buf, len, &pos, &total))) return rc;
    if ((rc = read_zigzag(buf, len, &pos, &first))) return rc;
    if (block_size == 0 || block_size % 128 != 0) return ERR_BLOCK_SIZE;
    if (block_size > ((u128)1 << 30)) return ERR_BLOCK_SIZE;  // decompression-bomb guard
    if (minis_per_block == 0 || block_size % minis_per_block != 0)
        return ERR_MINI_COUNT;
    u128 values_per_mini = block_size / minis_per_block;
    if (values_per_mini % 32 != 0) return ERR_MINI_MULT;
    if (total > ((u128)1 << 40)) return ERR_COUNT_BOMB;

    i64 n_deltas = total > 0 ? (i64)total - 1 : 0;
    i64 got = 0, n_minis = 0;
    // values_per_mini/minis_per_block stay 128-bit through the size math:
    // hostile headers can make them exceed i64, and a narrowing cast would
    // turn the bound checks below into out-of-bounds reads (the Python
    // reference walk does this arithmetic in unbounded ints)
    u128 vpm128 = values_per_mini;
    // width vectors are only read when there are deltas to decode: a
    // total<=1 stream legally ends right after the header (the Go reference
    // reads blocks lazily and never touches one for a single value), so the
    // truncation pre-check must not fire for it.  minis_per_block <=
    // block_size <= 2^30 here (the %-check above), so the cast is safe.
    if (n_deltas > 0 && minis_per_block > (u128)len + 1)
        return ERR_TRUNC_WIDTHS;
    i64 mpb = (i64)minis_per_block;
    while (got < n_deltas) {
        u128 min_delta;
        if ((rc = read_zigzag(buf, len, &pos, &min_delta))) return rc;
        if (pos + mpb > len) return ERR_TRUNC_WIDTHS;
        const u8 *wvec = buf + pos;
        pos += mpb;
        for (i64 m = 0; m < mpb && got < n_deltas; m++) {
            i64 w = wvec[m];
            if (w > 64) return ERR_BAD_WIDTH;
            u128 nbytes128 = (vpm128 * (u128)w + 7) / 8;
            if ((u128)pos + nbytes128 > (u128)len) return ERR_TRUNC_MINI;
            if (n_minis >= cap) return ERR_CAP;
            starts[n_minis] = pos * 8;
            widths[n_minis] = (i32)w;
            mins[n_minis] = (u64)min_delta;
            n_minis++;
            pos += (i64)nbytes128;
            u128 take = (u128)(n_deltas - got);
            got += (i64)(take < vpm128 ? take : vpm128);
        }
    }
    header_out[0] = (i64)block_size;
    header_out[1] = mpb;
    header_out[2] = (i64)total;
    header_out[3] = (i64)(u64)first;
    header_out[4] = pos;
    header_out[5] = n_minis;
    return 0;
}

// Parse RLE/bit-packed hybrid run headers for `count` values starting at
// buf[pos], bounded by n (the v1 length prefix, or the buffer end).
//
// ends/kinds/vals/starts: per-run cumulative value count, is-RLE flag, RLE
// value, and bit-packed payload bit offset minus run_start*width (the uniform
// position form expand_rle_hybrid consumes), cap entries each.
// consumed_out[0] receives the final byte position.  When want_max is nonzero
// the stream's maximum value (RLE run values + a scan of every bit-packed
// field up to each run's real extent) is written to max_out[0] — this lets
// dictionary-index range validation happen entirely on the host, so the
// device decode path needs zero device→host syncs.  When want_eq is nonzero
// the number of stream values equal to eq_target is written to eq_out[0]:
// for definition-level streams with eq_target = max_def this is the page's
// defined-value count, which gates every static decode shape — so the host
// never needs to materialize the decoded level array at all.  Returns
// n_runs >= 0, or a negative error (ERR_CAP: caller retries with a larger
// cap).
i64 tpq_hybrid_meta(const u8 *buf, i64 n, i64 pos, i64 width, i64 count,
                    i64 *ends, u8 *kinds, u32 *vals, i64 *starts, i64 cap,
                    i64 *consumed_out, i64 want_max, u64 *max_out,
                    i64 want_eq, u64 eq_target, i64 *eq_out) {
    i64 value_bytes = (width + 7) / 8;
    i64 total = 0, n_runs = 0;
    u64 max_val = 0;
    i64 eq_count = 0;
    const u64 mask = width >= 64 ? ~(u64)0 : (((u64)1 << width) - 1);
    const int scan_bp = (want_max || want_eq);
    while (total < count) {
        if (pos >= n) return ERR_EXHAUSTED;
        u128 h;
        int rc = read_uvarint(buf, n, &pos, &h);
        if (rc) return rc;
        if (h & 1) {
            u128 groups = h >> 1;
            if (groups == 0) continue;
            u128 nbytes128 = groups * (u128)width;
            if ((u128)pos + nbytes128 > (u128)n) return ERR_TRUNC_RUN;
            // nvals in 128-bit: for width 0 the byte bound above doesn't cap
            // groups, and (i64)(groups*8) could truncate to 0 and stall the
            // walk where the Python reference accepts the run
            u128 nvals128 = groups * 8;
            i64 take = count - total;
            if (nvals128 < (u128)take) take = (i64)nvals128;
            if (n_runs >= cap) return ERR_CAP;
            kinds[n_runs] = 0;
            vals[n_runs] = 0;
            starts[n_runs] = pos * 8 - total * width;
            if (scan_bp && width > 0) {
                // scan the run's real extent (padding past `take` is ignored,
                // matching the device expansion's idx[:count] semantics).
                // Block-lane form: a bit-packed run is whole 8-value groups
                // of `width` bytes, and within every group lane j sits at
                // the FIXED (byte, shift) = ((j*width)>>3, (j*width)&7) —
                // so the inner 8-lane loop has compile-time-hoistable
                // offsets and 8 independent max/eq accumulator chains the
                // superscalar units run in parallel.  Measured ~2x over the
                // per-value u64-load walk (itself ~4x the byte walk); this
                // scan is the hottest host cost on dictionary-heavy files.
                i64 k = 0;
                if (width <= 56) {
                    i64 blocks = take >> 3;
                    // every lane load reads 8 bytes: bound the last block's
                    // highest load (lane 7) inside the buffer
                    i64 lane7 = ((i64)7 * width) >> 3;
                    while (blocks > 0 &&
                           pos + (blocks - 1) * width + lane7 + 8 > n)
                        blocks--;
                    u64 mx[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                    i64 eqc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
                    const u8 *bp = buf + pos;
                    for (i64 b = 0; b < blocks; b++, bp += width) {
                        for (int j = 0; j < 8; j++) {
                            u64 acc;
                            __builtin_memcpy(&acc, bp + (((i64)j * width) >> 3), 8);
                            u64 v = (acc >> (((i64)j * width) & 7)) & mask;
                            if (v > mx[j]) mx[j] = v;
                            eqc[j] += (i64)(v == eq_target);
                        }
                    }
                    for (int j = 0; j < 8; j++) {
                        if (mx[j] > max_val) max_val = mx[j];
                        eq_count += eqc[j];
                    }
                    k = blocks * 8;
                }
                i64 safe_end = n - 8;
                for (; k < take; k++) {
                    i64 bit = pos * 8 + k * width;
                    i64 byte0 = bit >> 3;
                    int sh = (int)(bit & 7);
                    u64 v;
                    if (width <= 56 && byte0 <= safe_end) {
                        u64 acc;
                        __builtin_memcpy(&acc, buf + byte0, 8);
                        v = (acc >> sh) & mask;
                    } else {
                        u64 acc = 0;
                        i64 nb = (width + sh + 7) / 8;
                        for (i64 b = 0; b < nb && byte0 + b < n; b++)
                            acc |= (u64)buf[byte0 + b] << (8 * b);
                        v = (acc >> sh) & mask;
                    }
                    if (v > max_val) max_val = v;
                    if (v == eq_target) eq_count++;
                }
            } else if (want_eq && width == 0 && eq_target == 0) {
                eq_count += take;  // width-0 stream: every value is 0
            }
            pos += (i64)nbytes128;
            total += take;
        } else {
            u128 repeats128 = h >> 1;
            if (repeats128 == 0) continue;
            i64 repeats = repeats128 > (u128)(count - total)
                              ? count - total
                              : (i64)repeats128;
            if (pos + value_bytes > n) return ERR_TRUNC_RLE_VALUE;
            u64 v = 0;
            for (i64 k = 0; k < value_bytes; k++)
                v |= (u64)buf[pos + k] << (8 * k);
            pos += value_bytes;
            if (n_runs >= cap) return ERR_CAP;
            kinds[n_runs] = 1;
            vals[n_runs] = (u32)v;
            starts[n_runs] = 0;
            // RLE run values are NOT masked to the stream width: the Python
            // decoder, the run table (vals above), and the device expansion
            // all broadcast the raw little-endian bytes, so max/eq must see
            // the same value or a malformed file's defined-count diverges
            // between the host and batched-device paths (found by the
            // device_reader differential fuzzer).
            if (want_max && v > max_val) max_val = v;
            if (want_eq && v == eq_target) eq_count += repeats;
            total += repeats;
        }
        ends[n_runs] = total;
        n_runs++;
    }
    consumed_out[0] = pos;
    if (want_max) max_out[0] = max_val;
    if (want_eq) eq_out[0] = eq_count;
    return n_runs;
}

// Walk `count` PLAIN BYTE_ARRAY values (uint32 LE length prefix + bytes,
// type_bytearray.go:13-96 wire shape) starting at buf[0]: validate prefixes,
// write offsets[count+1] (cumulative value lengths) and compact the value
// bytes into heap (prefixes stripped).  heap must hold >= n - 4*count bytes
// (the caller allocates the upper bound).  Returns total heap bytes, or a
// negative error (ERR_TRUNC_PREFIX / ERR_LEN_RANGE).
i64 tpq_bytearray_walk(const u8 *buf, i64 n, i64 count, i64 *offsets,
                       u8 *heap) {
    i64 pos = 0, total = 0;
    offsets[0] = 0;
    for (i64 i = 0; i < count; i++) {
        if (pos + 4 > n) return -20;  // truncated length prefix
        u32 ln = (u32)buf[pos] | ((u32)buf[pos + 1] << 8) |
                 ((u32)buf[pos + 2] << 16) | ((u32)buf[pos + 3] << 24);
        if ((u128)pos + 4 + ln > (u128)n) return -21;  // length exceeds buffer
        pos += 4;
        __builtin_memcpy(heap + total, buf + pos, ln);
        pos += ln;
        total += ln;
        offsets[i + 1] = total;
    }
    return total;
}

// Lengths-only variant of tpq_bytearray_walk: validate the same prefix walk
// (starting at `pos` of the page buffer — callers never slice/copy the
// stream) but write only the u32 value lengths — no heap copy.  The batched
// device reader stages the RAW stream and compacts the heap on device
// (offsets = cumsum of these lengths there), so the host never touches the
// value bytes.  Returns the position after the last value, or
// ERR_TRUNC_PREFIX / ERR_LEN_RANGE.
i64 tpq_bytearray_lengths(const u8 *buf, i64 n, i64 pos, i64 count,
                          u32 *lens) {
    for (i64 i = 0; i < count; i++) {
        if (pos + 4 > n) return -20;  // truncated length prefix
        u32 ln = (u32)buf[pos] | ((u32)buf[pos + 1] << 8) |
                 ((u32)buf[pos + 2] << 16) | ((u32)buf[pos + 3] << 24);
        if ((u128)pos + 4 + ln > (u128)n) return -21;  // length exceeds buffer
        lens[i] = ln;
        pos += 4 + (i64)ln;
    }
    return pos;
}

// ---------------------------------------------------------------------------
// Thrift compact-protocol PageHeader parse (the per-page host hot path).
//
// Semantics mirror tpu_parquet/thrift.py's CompactReader EXACTLY (that engine
// is the reference and the fuzz-parity oracle): varints reject >10 bytes and
// 64-bit overflow, field ids arrive as header deltas or zigzag varints, bool
// field values ride the header ctype, containers are capped at 2^24, nesting
// at depth 32, and a known field id carrying the wrong wire type is skipped
// by its wire type (leaving the field absent).  Only the fields the readers
// consume are extracted; everything else (incl. page Statistics, which no
// consumer reads — predicate pushdown uses chunk metadata stats) is skipped
// by wire type.
// ---------------------------------------------------------------------------

enum {
    TERR_TRUNC = -40,      // truncated input
    TERR_VARLONG = -41,    // varint too long / exceeds 64 bits
    TERR_CONTAINER = -42,  // container exceeds sanity cap
    TERR_DEPTH = -43,      // nesting too deep
    TERR_CTYPE = -44,      // unknown thrift wire type (13-15)
};

static const i64 T_MAX_CONTAINER = (i64)1 << 24;

static int t_varint(const u8 *buf, i64 n, i64 *pos, u64 *out) {
    u64 result = 0;
    int shift = 0;
    i64 p = *pos;
    while (1) {
        if (p >= n) return TERR_TRUNC;
        u8 b = buf[p++];
        result |= (u64)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 63) return TERR_VARLONG;
    }
    // shift==63 with a 2-bit payload would exceed 64 bits; the python engine
    // rejects via `result >> 64`, which the shift cap above already covers
    // except for the final byte's high bits — replicate the exact check:
    if (shift == 63 && (buf[p - 1] & 0x7E)) return TERR_VARLONG;
    *pos = p;
    *out = result;
    return 0;
}

static int t_zigzag(const u8 *buf, i64 n, i64 *pos, i64 *out) {
    u64 v;
    int rc = t_varint(buf, n, pos, &v);
    if (rc) return rc;
    *out = (i64)(v >> 1) ^ -(i64)(v & 1);
    return 0;
}

static int t_skip(const u8 *buf, i64 n, i64 *pos, int ctype, int depth);

static int t_skip_struct(const u8 *buf, i64 n, i64 *pos, int depth) {
    if (depth > 32) return TERR_DEPTH;
    u64 last = 0;  // wraps like a machine int; python's unbounded ids only miss lookups
    while (1) {
        if (*pos >= n) return TERR_TRUNC;
        u8 b = buf[(*pos)++];
        // the python engine masks ctype BEFORE its STOP comparison, so any
        // zero-ctype-nibble byte terminates the struct (0x00 consumes
        // nothing further; nonzero deltas were already folded into fid)
        if ((b & 0x0F) == 0x00) return 0;  // CT_STOP
        int ctype = b & 0x0F;
        int delta = (b >> 4) & 0x0F;
        if (delta) {
            last += (u64)delta;
        } else {
            i64 fid;
            int rc = t_zigzag(buf, n, pos, &fid);
            if (rc) return rc;
            last = (u64)fid;
        }
        if (ctype != 0x01 && ctype != 0x02) {  // bools carry no payload
            int rc = t_skip(buf, n, pos, ctype, depth + 1);
            if (rc) return rc;
        }
    }
}

static int t_skip(const u8 *buf, i64 n, i64 *pos, int ctype, int depth) {
    if (depth > 32) return TERR_DEPTH;
    u64 v;
    int rc;
    switch (ctype) {
        case 0x01: case 0x02: return 0;            // bool in field header
        case 0x03:                                  // byte
            if (*pos + 1 > n) return TERR_TRUNC;
            (*pos)++;
            return 0;
        case 0x04: case 0x05: case 0x06:            // i16/i32/i64 varints
            return t_varint(buf, n, pos, &v);
        case 0x07:                                  // double
            if (*pos + 8 > n) return TERR_TRUNC;
            *pos += 8;
            return 0;
        case 0x08:                                  // binary
            rc = t_varint(buf, n, pos, &v);
            if (rc) return rc;
            if (v > (u64)T_MAX_CONTAINER) return TERR_CONTAINER;
            if (*pos + (i64)v > n) return TERR_TRUNC;
            *pos += (i64)v;
            return 0;
        case 0x09: case 0x0A: {                     // list/set
            if (*pos >= n) return TERR_TRUNC;
            u8 b = buf[(*pos)++];
            i64 size = (b >> 4) & 0x0F;
            int etype = b & 0x0F;
            if (size == 15) {
                rc = t_varint(buf, n, pos, &v);
                if (rc) return rc;
                if (v > (u64)T_MAX_CONTAINER) return TERR_CONTAINER;
                size = (i64)v;
            }
            if (size > T_MAX_CONTAINER) return TERR_CONTAINER;
            if (etype == 0x01 || etype == 0x02) {   // bool elems are one byte
                if (*pos + size > n) return TERR_TRUNC;
                *pos += size;
                return 0;
            }
            for (i64 i = 0; i < size; i++) {
                rc = t_skip(buf, n, pos, etype, depth + 1);
                if (rc) return rc;
            }
            return 0;
        }
        case 0x0B: {                                // map
            rc = t_varint(buf, n, pos, &v);
            if (rc) return rc;
            if (v > (u64)T_MAX_CONTAINER) return TERR_CONTAINER;
            if (v) {
                if (*pos >= n) return TERR_TRUNC;
                u8 kv = buf[(*pos)++];
                int kt = (kv >> 4) & 0x0F, vt = kv & 0x0F;
                for (u64 i = 0; i < v; i++) {
                    rc = t_skip(buf, n, pos, kt, depth + 1);
                    if (rc) return rc;
                    rc = t_skip(buf, n, pos, vt, depth + 1);
                    if (rc) return rc;
                }
            }
            return 0;
        }
        case 0x0C:                                  // struct
            // python's skip() checks depth at entry (done above) and walks
            // inner fields at depth+1 — the walker continues at THIS depth
            return t_skip_struct(buf, n, pos, depth);
        default:
            // unknown wire type (13-15): the python engine's skip() raises
            // "cannot skip unknown thrift ctype" — distinct code, same reject
            return TERR_CTYPE;
    }
}

// Statistics sub-struct (format field ids: 1 max binary, 2 min binary,
// 3 null_count i64, 4 distinct_count i64, 5 max_value binary, 6 min_value
// binary).  Binary values are recorded as (pos, len) into the source buffer.
// Slot bank at `base` (base+0 null_count, +1 distinct_count, +2/+3 max,
// +4/+5 min, +6/+7 max_value, +8/+9 min_value); presence bits are the value
// slots' indices, and `struct_bit` marks the sub-struct itself.  v1 and v2
// data page headers get SEPARATE banks (20/bit 58 and 30/bit 57): both may
// appear in one PageHeader and each python object carries its own stats.
static int t_stats(const u8 *buf, i64 n, i64 *pos, i64 *out, u64 *mask,
                   int base, int struct_bit) {
    for (int i = base; i < base + 10; i++) {
        out[i] = 0;
        *mask &= ~((u64)1 << i);
    }
    u64 last = 0;
    while (1) {
        if (*pos >= n) return TERR_TRUNC;
        u8 b = buf[(*pos)++];
        if ((b & 0x0F) == 0x00) break;  // masked-STOP (python parity)
        int ctype = b & 0x0F;
        int delta = (b >> 4) & 0x0F;
        if (delta) {
            last += (u64)delta;
        } else {
            i64 fid;
            int rc = t_zigzag(buf, n, pos, &fid);
            if (rc) return rc;
            last = (u64)fid;
        }
        int rc = 0;
        if ((last == 3 || last == 4) && ctype == 0x06) {
            i64 v;
            rc = t_zigzag(buf, n, pos, &v);
            if (!rc) {
                int slot = base + (last == 3 ? 0 : 1);
                out[slot] = v;
                *mask |= (u64)1 << slot;
            }
        } else if ((last == 1 || last == 2 || last == 5 || last == 6)
                   && ctype == 0x08) {
            u64 blen;
            rc = t_varint(buf, n, pos, &blen);
            if (!rc) {
                if (blen > (u64)T_MAX_CONTAINER) return TERR_CONTAINER;
                if (*pos + (i64)blen > n) return TERR_TRUNC;
                int slot = base + (last == 1 ? 2 : last == 2 ? 4
                                   : last == 5 ? 6 : 8);
                out[slot] = *pos;
                out[slot + 1] = (i64)blen;
                *mask |= (u64)1 << slot;
                *pos += (i64)blen;
            }
        } else if (ctype != 0x01 && ctype != 0x02) {
            rc = t_skip(buf, n, pos, ctype, 2);
        }
        if (rc) return rc;
    }
    *mask |= (u64)1 << struct_bit;
    return 0;
}

// Parse the sub-struct `fids` maps into out slots: for each field id fid in
// [1, nf], if fid maps to slot s >= 0 and the wire type matches `want`
// (varint ints) or is a bool (want < 0), record the value + presence bit.
// wants[fid-1]: 5/6 = zigzag varint of that wire type, -1 = bool, 0 = skip.
// `stats_fid` != 0 routes that struct-typed field into t_stats (the
// Statistics carried by DataPageHeader field 5 / DataPageHeaderV2 field 8).
static int t_sub_struct(const u8 *buf, i64 n, i64 *pos, const int8_t *wants,
                        const int8_t *slots, int nf, i64 *out, u64 *mask,
                        int stats_fid, int stats_base, int stats_bit) {
    u64 last = 0;  // wrap-safe; range tests below bound all uses
    while (1) {
        if (*pos >= n) return TERR_TRUNC;
        u8 b = buf[(*pos)++];
        if ((b & 0x0F) == 0x00) return 0;  // masked-STOP (python parity)
        int ctype = b & 0x0F;
        int delta = (b >> 4) & 0x0F;
        if (delta) {
            last += (u64)delta;
        } else {
            i64 fid;
            int rc = t_zigzag(buf, n, pos, &fid);
            if (rc) return rc;
            last = (u64)fid;
        }
        int want = (last >= 1 && last <= (u64)nf) ? wants[last - 1] : 0;
        int slot = (last >= 1 && last <= (u64)nf) ? slots[last - 1] : -1;
        if (stats_fid && last == (u64)stats_fid && ctype == 0x0C) {
            int rc = t_stats(buf, n, pos, out, mask, stats_base, stats_bit);
            if (rc) return rc;
        } else if (want == -1 && (ctype == 0x01 || ctype == 0x02)) {
            out[slot] = (ctype == 0x01);
            *mask |= (u64)1 << slot;
        } else if (want > 0 && ctype == want) {
            i64 v;
            int rc = t_zigzag(buf, n, pos, &v);
            if (rc) return rc;
            out[slot] = v;
            *mask |= (u64)1 << slot;
        } else if (ctype != 0x01 && ctype != 0x02) {
            int rc = t_skip(buf, n, pos, ctype, 1);
            if (rc) return rc;
        }
    }
}

// Slot layout (out i64[40]):
//   0 type  1 uncompressed_page_size  2 compressed_page_size  3 crc
//   4 dph.num_values  5 dph.encoding  6 dph.def_level_enc  7 dph.rep_level_enc
//   8 dict.num_values  9 dict.encoding  10 dict.is_sorted
//   11 v2.num_values  12 v2.num_nulls  13 v2.num_rows  14 v2.encoding
//   15 v2.def_levels_byte_length  16 v2.rep_levels_byte_length
//   17 v2.is_compressed
//   18 presence mask (bits 0-17/20-39 as slot indices; bits 59/60/61/62 =
//      index/dph/dict/v2 sub-struct present; 58/57 = dph/v2 Statistics
//      present)  19 end position
//   20-29 dph.statistics bank, 30-39 v2.statistics bank (see t_stats)
// Returns 0 or a TERR_* code.
i64 tpq_page_header(const u8 *buf, i64 n, i64 pos, i64 *out) {
    u64 mask = 0;
    for (int i = 0; i < 18; i++) out[i] = 0;
    for (int i = 20; i < 40; i++) out[i] = 0;
    static const int8_t dph_w[5] = {5, 5, 5, 5, 0};
    static const int8_t dph_s[5] = {4, 5, 6, 7, -1};
    static const int8_t dict_w[3] = {5, 5, -1};
    static const int8_t dict_s[3] = {8, 9, 10};
    static const int8_t v2_w[8] = {5, 5, 5, 5, 5, 5, -1, 0};
    static const int8_t v2_s[8] = {11, 12, 13, 14, 15, 16, 17, -1};
    u64 last = 0;  // wrap-safe field-id accumulator (see t_sub_struct)
    while (1) {
        if (pos >= n) return TERR_TRUNC;
        u8 b = buf[pos++];
        if ((b & 0x0F) == 0x00) break;  // masked-STOP (python parity)
        int ctype = b & 0x0F;
        int delta = (b >> 4) & 0x0F;
        if (delta) {
            last += delta;
        } else {
            i64 fid;
            int rc = t_zigzag(buf, n, &pos, &fid);
            if (rc) return rc;
            last = fid;
        }
        int rc = 0;
        if (last >= 1 && last <= 4 && ctype == 0x05) {
            i64 v;
            rc = t_zigzag(buf, n, &pos, &v);
            if (!rc) {
                out[last - 1] = v;
                mask |= (u64)1 << (last - 1);
            }
        } else if (last == 5 && ctype == 0x0C) {
            // last occurrence wins (python setattr replaces the object) —
            // including the sub-struct's statistics bank
            for (int i = 4; i <= 7; i++) { out[i] = 0; mask &= ~((u64)1 << i); }
            for (int i = 20; i <= 29; i++) { out[i] = 0; mask &= ~((u64)1 << i); }
            mask &= ~((u64)1 << 58);
            rc = t_sub_struct(buf, n, &pos, dph_w, dph_s, 5, out, &mask,
                              5, 20, 58);
            if (!rc) mask |= (u64)1 << 60;
        } else if (last == 6 && ctype == 0x0C) {
            // IndexPageHeader is an empty struct: walk it, record presence
            rc = t_skip_struct(buf, n, &pos, 0);
            if (!rc) mask |= (u64)1 << 59;
        } else if (last == 7 && ctype == 0x0C) {
            for (int i = 8; i <= 10; i++) { out[i] = 0; mask &= ~((u64)1 << i); }
            rc = t_sub_struct(buf, n, &pos, dict_w, dict_s, 3, out, &mask,
                              0, 0, 0);
            if (!rc) mask |= (u64)1 << 61;
        } else if (last == 8 && ctype == 0x0C) {
            for (int i = 11; i <= 17; i++) { out[i] = 0; mask &= ~((u64)1 << i); }
            for (int i = 30; i <= 39; i++) { out[i] = 0; mask &= ~((u64)1 << i); }
            mask &= ~((u64)1 << 57);
            rc = t_sub_struct(buf, n, &pos, v2_w, v2_s, 8, out, &mask,
                              8, 30, 57);
            if (!rc) mask |= (u64)1 << 62;
        } else if (ctype != 0x01 && ctype != 0x02) {
            rc = t_skip(buf, n, &pos, ctype, 0);
        }
        if (rc) return rc;
    }
    out[18] = (i64)mask;
    out[19] = pos;
    return 0;
}

// DELTA_BYTE_ARRAY prefix stitching (type_bytearray.go:189-292 semantics):
// value i = previous value's first prefix_lens[i] bytes + suffix i.  The
// chain is inherently sequential (SURVEY.md §7.4.4) — this runs it at memcpy
// speed.  All offset arrays are caller-validated cumulative sums; the only
// data-dependent check is the prefix-vs-previous-length bound.
// Returns 0, or -30 when value i's prefix exceeds the previous value's length.
i64 tpq_delta_ba_stitch(const i64 *prefix_lens, const i64 *suf_off,
                        const u8 *suf_heap, const i64 *out_off, u8 *heap,
                        i64 count) {
    i64 prev_start = 0, prev_len = 0;
    for (i64 i = 0; i < count; i++) {
        i64 p = prefix_lens[i];
        if (p > prev_len) return -30;
        i64 start = out_off[i];
        if (p) __builtin_memmove(heap + start, heap + prev_start, p);
        i64 sl = suf_off[i + 1] - suf_off[i];
        if (sl) __builtin_memcpy(heap + start + p, suf_heap + suf_off[i], sl);
        prev_start = start;
        prev_len = p + sl;
    }
    return 0;
}

// Narrow-int transcode support (device_reader._plan_narrow_ints): the host
// link is the scarce resource, so PLAIN INT columns whose value span fits in
// k < width bytes ship as (v - min) truncated to k little-endian bytes.
// These two passes replace a 4-temp numpy pipeline (min, max, subtract,
// strided copy) with two streaming loops gcc auto-vectorizes; unaligned
// sources are handled with memcpy loads (pages start at arbitrary offsets).

// min/max of n little-endian signed width-byte ints at buf+pos; width 4 or 8.
// Writes out[0]=min, out[1]=max.  n==0 leaves out untouched (caller guards).
void tpq_int_minmax(const u8 *buf, i64 pos, i64 n, int width, i64 *out) {
    const u8 *src = buf + pos;
    if (n <= 0) return;
    // ternary (branchless) reductions: -O3 vectorizes these into packed
    // min/max, ~4-8x the branchy compare on span probes over whole chunks
    if (width == 8) {
        i64 mn = INT64_MAX, mx = INT64_MIN;
        for (i64 i = 0; i < n; i++) {
            i64 v;
            __builtin_memcpy(&v, src + i * 8, 8);
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
        }
        out[0] = mn;
        out[1] = mx;
    } else {
        int32_t mn = INT32_MAX, mx = INT32_MIN;
        for (i64 i = 0; i < n; i++) {
            int32_t v;
            __builtin_memcpy(&v, src + i * 4, 4);
            mn = v < mn ? v : mn;
            mx = v > mx ? v : mx;
        }
        out[0] = mn;
        out[1] = mx;
    }
}

// Write (v - bias) mod 2^(8*width) truncated to its k low bytes, for each of
// n width-byte values at buf+pos, densely into dst (n*k bytes).  The caller
// guarantees the span fits k bytes, so truncation is lossless.
// k-specialized loops: a fixed-size store compiles to a plain mov (and the
// w8 cases vectorize); the generic memcpy-with-runtime-k form cost ~2.5
// ns/value on the 100M-row transcode path.
#define TPQ_TRUNC_LOOP(W, K)                                      \
    for (i64 i = 0; i < n; i++) {                                 \
        u64 v = 0;                                                \
        __builtin_memcpy(&v, src + i * (W), (W));                 \
        u64 d = v - bias;                                         \
        __builtin_memcpy(dst + i * (K), &d, (K));                 \
    }
void tpq_int_truncate(const u8 *buf, i64 pos, i64 n, int width, u64 bias,
                      int k, u8 *dst) {
    const u8 *src = buf + pos;
    if (width == 8) {
        switch (k) {
        case 1: TPQ_TRUNC_LOOP(8, 1); return;
        case 2: TPQ_TRUNC_LOOP(8, 2); return;
        case 3: TPQ_TRUNC_LOOP(8, 3); return;
        case 4: TPQ_TRUNC_LOOP(8, 4); return;
        case 5: TPQ_TRUNC_LOOP(8, 5); return;
        }
    } else if (width == 4) {
        switch (k) {
        case 1: TPQ_TRUNC_LOOP(4, 1); return;
        case 2: TPQ_TRUNC_LOOP(4, 2); return;
        }
    }
    TPQ_TRUNC_LOOP(width, k);
}
#undef TPQ_TRUNC_LOOP

// ---------------------------------------------------------------------------
// Device-side snappy expansion: the host parses ONLY the tag structure of a
// raw snappy stream into op tables; the actual byte movement (literal
// stitching + back-reference resolution) runs on the TPU as gathers
// (device_reader._plan_device_snappy).  This walk touches ~1 tag byte per
// ~60 payload bytes, so eligible pages skip host decompression entirely and
// ship compressed.
//
// Per op i (in stream order, output-contiguous):
//   dst_end[i]  cumulative output end of op i (within this stream)
//   src[i]      literal: byte offset of the run's payload in the COMPRESSED
//               stream; copy: the back-reference offset
//   is_lit[i]   1 literal / 0 copy
// Copy semantics for the device: output byte dst_start+j of a copy op reads
// output position dst_start - offset + (j mod offset) — the mod form makes
// overlapping (RLE-style) copies jump straight past the op, so every chain
// hop crosses an op boundary and pointer-doubling converges in
// log2(max_chain_depth) rounds.  The exact max depth is computed here with
// an incremental segment-tree max over op slots.
//
// Returns n_ops >= 0, or a negative TERR-style code on malformed input
// (same reject set as tpq_snappy_decompress).  out[0] = uncompressed size,
// out[1] = max chain depth.  cap is the op-table capacity; -10 = cap
// exceeded (callers size cap = n/2+2, the provable worst case, so -10 is
// unreachable from that sizing).

static inline i64 seg_query(const i64 *tree, i64 cap2, i64 lo, i64 hi) {
    // max over [lo, hi) of the segment tree (iterative, 0-based leaves)
    i64 best = 0;
    for (lo += cap2, hi += cap2; lo < hi; lo >>= 1, hi >>= 1) {
        if (lo & 1) { if (tree[lo] > best) best = tree[lo]; lo++; }
        if (hi & 1) { hi--; if (tree[hi] > best) best = tree[hi]; }
    }
    return best;
}

static inline void seg_update(i64 *tree, i64 cap2, i64 i, i64 v) {
    i += cap2;
    tree[i] = v;
    for (i >>= 1; i >= 1; i >>= 1) {
        i64 m = tree[2 * i] > tree[2 * i + 1] ? tree[2 * i] : tree[2 * i + 1];
        if (tree[i] == m) break;
        tree[i] = m;
    }
}

i64 tpq_snappy_plan(const u8 *src, i64 n, i64 expect,
                    i64 *dst_end, i64 *op_src, u8 *is_lit, i64 cap,
                    i64 *seg_tree, i64 cap2, i64 *out) {
    i64 pos = 0;
    // uncompressed-length uvarint
    u64 ulen = 0;
    int shift = 0;
    while (1) {
        if (pos >= n) return -2;
        u8 b = src[pos++];
        if (shift == 28 && (b & 0xf0)) return -2;
        ulen |= (u64)(b & 0x7f) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
        if (shift > 28) return -2;
    }
    if ((i64)ulen != expect) return -3;
    i64 outp = 0, nops = 0, maxdepth = 0;
    while (pos < n) {
        u8 tag = src[pos++];
        u32 kind = tag & 3;
        i64 len, offset = 0;
        if (kind == 0) {  // literal
            len = tag >> 2;
            if (len >= 60) {
                i64 extra = len - 59;
                if (pos + extra > n) return -4;
                len = 0;
                for (i64 i = 0; i < extra; i++)
                    len |= (i64)src[pos + i] << (8 * i);
                pos += extra;
            }
            len += 1;
            if (pos + len > n || outp + len > (i64)ulen) return -5;
            if (nops >= cap) return -10;
            dst_end[nops] = outp + len;
            op_src[nops] = pos;
            is_lit[nops] = 1;
            seg_update(seg_tree, cap2, nops, 0);
            nops++;
            pos += len;
            outp += len;
        } else {
            if (kind == 1) {
                if (pos >= n) return -6;
                len = ((tag >> 2) & 7) + 4;
                offset = ((i64)(tag >> 5) << 8) | src[pos];
                pos += 1;
            } else if (kind == 2) {
                if (pos + 2 > n) return -6;
                len = (tag >> 2) + 1;
                offset = (i64)src[pos] | ((i64)src[pos + 1] << 8);
                pos += 2;
            } else {
                if (pos + 4 > n) return -6;
                len = (tag >> 2) + 1;
                offset = (i64)src[pos] | ((i64)src[pos + 1] << 8) |
                         ((i64)src[pos + 2] << 16) | ((i64)src[pos + 3] << 24);
                pos += 4;
            }
            if (offset == 0 || offset > outp) return -7;
            if (outp + len > (i64)ulen) return -8;
            if (nops >= cap) return -10;
            // chain depth: 1 + max depth of ops covering the source range
            // [outp-offset, min(outp, outp-offset+len)) — the mod form never
            // reads at/after outp
            i64 s = outp - offset;
            i64 e = s + len < outp ? s + len : outp;
            // ops covering [s, e): first op with dst_end > s .. first with
            // dst_end >= e (inclusive) — binary search over dst_end[0..nops)
            i64 lo = 0, hi = nops;
            while (lo < hi) {
                i64 mid = (lo + hi) >> 1;
                if (dst_end[mid] > s) hi = mid; else lo = mid + 1;
            }
            i64 j1 = lo;
            lo = 0; hi = nops;
            while (lo < hi) {
                i64 mid = (lo + hi) >> 1;
                if (dst_end[mid] >= e) hi = mid; else lo = mid + 1;
            }
            i64 j2 = lo < nops ? lo + 1 : nops;
            i64 d = 1 + seg_query(seg_tree, cap2, j1, j2);
            if (d > maxdepth) maxdepth = d;
            dst_end[nops] = outp + len;
            op_src[nops] = offset;
            is_lit[nops] = 0;
            seg_update(seg_tree, cap2, nops, d);
            nops++;
            outp += len;
        }
    }
    if (outp != (i64)ulen) return -9;
    out[0] = outp;
    out[1] = maxdepth;
    return nops;
}

// ---------------------------------------------------------------------------
// Writer-side dictionary build: first-appearance uniquing with an open-
// addressing hash table (FNV-1a + linear probe).  Replaces the numpy
// unique-on-hashes path (argsort-bound, ~80% of dict-encode time on string
// columns) with one O(n) pass at memory speed.  `slots` (caller-allocated,
// nslots = power of two >= 2n, pre-filled with -1) maps hash slot -> dict
// id; `firsts` records the value index of each dict id's first occurrence
// (ascending by construction = first-appearance order).  Returns the
// distinct count k, or -50 once it would exceed max_dict (the caller falls
// back to plain encoding, chunk_writer.go:188-207 MaxInt16 semantics).

// 8-bytes-at-a-time mix (multiply + xor-shift per word, splitmix-style
// finalizer): the per-byte FNV loop was ~half the whole dict-string write
// (~20 ops per typical value vs ~4 here); collision quality only affects
// probe counts — equality is always decided by memcmp.
static inline u64 tpq_hash_span(const u8 *p, i64 len) {
    u64 h = 0x9E3779B97F4A7C15ull ^ (u64)len;
    while (len >= 8) {
        u64 w;
        __builtin_memcpy(&w, p, 8);
        h = (h ^ w) * 0xFF51AFD7ED558CCDull;
        h ^= h >> 29;
        p += 8;
        len -= 8;
    }
    if (len) {
        u64 w = 0;
        for (i64 j = 0; j < len; j++) w |= (u64)p[j] << (8 * j);
        h = (h ^ w) * 0xFF51AFD7ED558CCDull;
        h ^= h >> 29;
    }
    return h ^ (h >> 32);
}

i64 tpq_dict_build_bytes(const i64 *offsets, const u8 *heap, i64 n,
                         i64 max_dict, i32 *slots, i64 nslots,
                         u32 *inverse, i64 *firsts) {
    i64 k = 0;
    u64 mask = (u64)nslots - 1;
    for (i64 i = 0; i < n; i++) {
        i64 a = offsets[i], len = offsets[i + 1] - a;
        u64 s = tpq_hash_span(heap + a, len) & mask;
        for (;;) {
            i32 v = slots[s];
            if (v < 0) {
                if (k >= max_dict) return -50;
                slots[s] = (i32)k;
                firsts[k] = i;
                inverse[i] = (u32)k;
                k++;
                break;
            }
            i64 fa = offsets[firsts[v]];
            if (offsets[firsts[v] + 1] - fa == len &&
                __builtin_memcmp(heap + fa, heap + a, (u64)len) == 0) {
                inverse[i] = (u32)v;
                break;
            }
            s = (s + 1) & mask;
        }
    }
    return k;
}

i64 tpq_dict_build_fixed(const u8 *data, i64 n, i64 w, i64 max_dict,
                         i32 *slots, i64 nslots, u32 *inverse, i64 *firsts) {
    i64 k = 0;
    u64 mask = (u64)nslots - 1;
    for (i64 i = 0; i < n; i++) {
        const u8 *p = data + i * w;
        u64 s = tpq_hash_span(p, w) & mask;
        for (;;) {
            i32 v = slots[s];
            if (v < 0) {
                if (k >= max_dict) return -50;
                slots[s] = (i32)k;
                firsts[k] = i;
                inverse[i] = (u32)k;
                k++;
                break;
            }
            if (__builtin_memcmp(data + firsts[v] * w, p, (u64)w) == 0) {
                inverse[i] = (u32)v;
                break;
            }
            s = (s + 1) & mask;
        }
    }
    return k;
}

}  // extern "C"

// Pack n unsigned values (u64, already < 2^width) into the LSB-first
// continuous bit stream the RLE/bit-packed hybrid and DELTA_BINARY_PACKED
// formats share.  out must hold ceil(n*width/8) bytes; widths 1..56 (the
// accumulator holds width+7 pending bits).  The numpy encoder expanded a
// (n, width) bit matrix — ~25 ns/value; this loop is ~1 ns/value.
extern "C" void tpq_bp_pack(const uint64_t* vals, i64 n, i64 width, u8* out) {
    const u64 mask = width >= 64 ? ~(u64)0 : (((u64)1 << width) - 1);
    u64 acc = 0;
    int nb = 0;
    u8* o = out;
    for (i64 i = 0; i < n; i++) {
        acc |= (vals[i] & mask) << nb;
        nb += (int)width;
        while (nb >= 8) {
            *o++ = (u8)acc;
            acc >>= 8;
            nb -= 8;
        }
    }
    if (nb) *o++ = (u8)acc;
}
