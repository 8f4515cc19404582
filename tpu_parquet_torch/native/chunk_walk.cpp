// Whole-chunk page walk for the device reader's host phase.
//
// The device reader's host phase walks every page of a column chunk: the
// thrift page header, the page CRC, the decompression of the pages whose bytes
// the host needs, and the RLE/bit-packed run headers of every dictionary-index
// page.  Done page by page from Python, each page costs an interpreter
// iteration, several ctypes calls and a handful of objects — more than the
// native work under them on files with many small pages.  These three calls
// walk a whole chunk instead, in a fixed number of calls per chunk:
//
//   tpq_chunk_headers      every page header into a flat page table, with the
//                          checks of chunk_decode.walk_pages;
//   tpq_chunk_materialise  CRC checks and decompression of the selected data
//                          pages into one arena, with parse_data_page's
//                          per-page checks and lazy-page rule;
//   tpq_chunk_runs         the hybrid run walk of every dictionary-index page
//                          into concatenated run tables, the range max folded
//                          as _parse_dict_index_page folds it, and the
//                          bit-packed payloads packed back to back.
//
// Every failure is reported as (code, page, values): the Python side raises
// the exception the page loop raises, with the same message.  The page loop
// stays as the reference implementation (device_reader._collect_pages)
// and the tests and the fuzz harness hold the two equal.

#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

typedef uint8_t u8;
typedef int32_t i32;
typedef uint32_t u32;
typedef int64_t i64;
typedef uint64_t u64;
typedef __int128 i128;

extern "C" {
i64 tpq_page_header(const u8 *buf, i64 n, i64 pos, i64 *out);
long long tpq_snappy_uncompressed_length(const uint8_t *src, size_t n);
int tpq_snappy_decompress(const uint8_t *src, size_t n, uint8_t *dst,
                          size_t dst_len);
i64 tpq_hybrid_meta(const u8 *buf, i64 n, i64 pos, i64 width, i64 count,
                    i64 *ends, u8 *kinds, u32 *vals, i64 *starts, i64 cap,
                    i64 *consumed_out, i64 want_max, u64 *max_out,
                    i64 want_eq, u64 eq_target, i64 *eq_out);
}

namespace {

// page table: PT_FIELDS int64 per page (native/__init__.py names them)
enum {
    PT_TYPE = 0,
    PT_FLAGS,
    PT_USIZE,
    PT_CSIZE,
    PT_CRC,
    PT_NVALUES,
    PT_ENCODING,
    PT_START,
    PT_END,
    PT_CLAIM,
    PT_FIELDS,
};

// PT_FLAGS bits: which optional thrift fields the header carried
enum {
    F_TYPE = 1,
    F_CRC = 2,
    F_ENCODING = 4,
    F_V2 = 8,
};

// failure codes (the wrapper maps each to the page loop's exception)
enum {
    W_OK = 0,
    W_EXHAUSTED = 1,     // chunk exhausted at seen/total values
    W_THRIFT = 2,        // corrupt page header (value: the TERR_* code)
    W_CSIZE = 3,         // invalid compressed page size (value, present)
    W_USIZE = 4,         // invalid uncompressed page size (value, present)
    W_PAST_END = 5,      // page payload extends past chunk end
    W_EXTRA_DICT = 6,    // unexpected extra dictionary page
    W_DICT_HDR = 7,      // dictionary page missing its header
    W_V1_HDR = 8,        // data page v1 missing its header
    W_V2_HDR = 9,        // data page v2 missing its header
    W_CRC = 10,          // page CRC mismatch (header crc, data crc)
    W_NEG_VALUES = 11,   // negative page value count (value)
    W_ENCODING = 12,     // unknown value encoding (value, present)
    W_SNAPPY_LEN = 13,   // malformed snappy data: bad length header
    W_SNAPPY_CLAIM = 14, // snappy stream claims (claim, declared)
    W_SNAPPY_BAD = 15,   // malformed snappy data (error rc)
    W_SIZE = 16,         // page declared (declared) uncompressed bytes, got
    W_IDX_TRUNC = 17,    // dictionary page data truncated (missing width)
    W_IDX_WIDTH = 18,    // dictionary index width (width) invalid
    W_RUNS = 19,         // hybrid walk error (value: meta_parse.cpp code)
    W_CAP = -10,         // an output table is full: retry with more room
};

// page states written by tpq_chunk_materialise
enum { S_ARENA = 1, S_LAZY = 2, S_VIEW = 3 };

// materialise flags
enum {
    M_VALIDATE_CRC = 1,
    M_LAZY = 2,          // PLAIN pages stay compressed (parse_data_page rule)
    M_SNAPPY = 4,        // chunk codec SNAPPY (else UNCOMPRESSED)
    M_DECOMPRESS = 8,    // decompress only: lazy pages materialised later
};

inline i64 now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// CRC-32 (ISO-HDLC, zlib's crc32): reflected polynomial 0xEDB88320.  The
// table walk (slicing by 16; tables built once, on first use) takes what the
// carry-less-multiply fold below does not.
struct CrcTables {
    u32 t[16][256];
    CrcTables() {
        for (u32 i = 0; i < 256; i++) {
            u32 c = i;
            for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1)));
            t[0][i] = c;
        }
        for (u32 i = 0; i < 256; i++)
            for (int s = 1; s < 16; s++)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

const CrcTables &crc_tables() {
    static const CrcTables tables;
    return tables;
}

u32 crc32_update(u32 crc, const u8 *p, i64 n) {
    const CrcTables &T = crc_tables();
    u32 c = ~crc;
    while (n >= 16) {
        u32 a, b, d, e;
        std::memcpy(&a, p, 4);
        std::memcpy(&b, p + 4, 4);
        std::memcpy(&d, p + 8, 4);
        std::memcpy(&e, p + 12, 4);
        a ^= c;
        c = T.t[15][a & 0xFF] ^ T.t[14][(a >> 8) & 0xFF] ^
            T.t[13][(a >> 16) & 0xFF] ^ T.t[12][a >> 24] ^
            T.t[11][b & 0xFF] ^ T.t[10][(b >> 8) & 0xFF] ^
            T.t[9][(b >> 16) & 0xFF] ^ T.t[8][b >> 24] ^
            T.t[7][d & 0xFF] ^ T.t[6][(d >> 8) & 0xFF] ^
            T.t[5][(d >> 16) & 0xFF] ^ T.t[4][d >> 24] ^
            T.t[3][e & 0xFF] ^ T.t[2][(e >> 8) & 0xFF] ^
            T.t[1][(e >> 16) & 0xFF] ^ T.t[0][e >> 24];
        p += 16;
        n -= 16;
    }
    while (n-- > 0) c = (c >> 8) ^ T.t[0][(c ^ *p++) & 0xFF];
    return ~c;
}

#if defined(__x86_64__)
// The same CRC by carry-less multiplication: four 128-bit lanes folded over
// 64-byte blocks, then into one lane, then Barrett-reduced to 32 bits (the
// PCLMULQDQ method of Gopal et al., "Fast CRC Computation for Generic
// Polynomials Using PCLMULQDQ Instruction", Intel 2009; constants for the
// reflected 0xEDB88320 polynomial).  `c` is the inverted running CRC; n is a
// multiple of 16 and at least 64.
__attribute__((target("pclmul,sse4.1"))) u32 crc32_fold(u32 c, const u8 *p,
                                                         i64 n) {
    const __m128i k1k2 = _mm_set_epi64x(0x00000001c6e41596LL,
                                        0x0000000154442bd4LL);
    const __m128i k3k4 = _mm_set_epi64x(0x00000000ccaa009eLL,
                                        0x00000001751997d0LL);
    const __m128i k5 = _mm_set_epi64x(0, 0x0000000163cd6124LL);
    const __m128i poly = _mm_set_epi64x(0x00000001f7011641LL,
                                        0x00000001db710641LL);
    const __m128i mask32 = _mm_set_epi32(0, 0, 0, -1);
    __m128i x1 = _mm_loadu_si128((const __m128i *)p);
    __m128i x2 = _mm_loadu_si128((const __m128i *)(p + 16));
    __m128i x3 = _mm_loadu_si128((const __m128i *)(p + 32));
    __m128i x4 = _mm_loadu_si128((const __m128i *)(p + 48));
    x1 = _mm_xor_si128(x1, _mm_cvtsi32_si128((int)c));
    p += 64;
    n -= 64;
    while (n >= 64) {
        __m128i h1 = _mm_clmulepi64_si128(x1, k1k2, 0x11);
        __m128i h2 = _mm_clmulepi64_si128(x2, k1k2, 0x11);
        __m128i h3 = _mm_clmulepi64_si128(x3, k1k2, 0x11);
        __m128i h4 = _mm_clmulepi64_si128(x4, k1k2, 0x11);
        x1 = _mm_clmulepi64_si128(x1, k1k2, 0x00);
        x2 = _mm_clmulepi64_si128(x2, k1k2, 0x00);
        x3 = _mm_clmulepi64_si128(x3, k1k2, 0x00);
        x4 = _mm_clmulepi64_si128(x4, k1k2, 0x00);
        x1 = _mm_xor_si128(_mm_xor_si128(x1, h1),
                           _mm_loadu_si128((const __m128i *)p));
        x2 = _mm_xor_si128(_mm_xor_si128(x2, h2),
                           _mm_loadu_si128((const __m128i *)(p + 16)));
        x3 = _mm_xor_si128(_mm_xor_si128(x3, h3),
                           _mm_loadu_si128((const __m128i *)(p + 32)));
        x4 = _mm_xor_si128(_mm_xor_si128(x4, h4),
                           _mm_loadu_si128((const __m128i *)(p + 48)));
        p += 64;
        n -= 64;
    }
    // four lanes into one
    __m128i h = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x1, k3k4, 0x00), h),
                       x2);
    h = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x1, k3k4, 0x00), h),
                       x3);
    h = _mm_clmulepi64_si128(x1, k3k4, 0x11);
    x1 = _mm_xor_si128(_mm_xor_si128(_mm_clmulepi64_si128(x1, k3k4, 0x00), h),
                       x4);
    while (n >= 16) {
        h = _mm_clmulepi64_si128(x1, k3k4, 0x11);
        x1 = _mm_xor_si128(
            _mm_xor_si128(_mm_clmulepi64_si128(x1, k3k4, 0x00), h),
            _mm_loadu_si128((const __m128i *)p));
        p += 16;
        n -= 16;
    }
    // 128 -> 64 bits (with 32 zero bits appended), 64 -> 32, Barrett
    x1 = _mm_xor_si128(_mm_clmulepi64_si128(k3k4, x1, 0x01),
                       _mm_srli_si128(x1, 8));
    x2 = _mm_srli_si128(x1, 4);
    x1 = _mm_xor_si128(
        _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), k5, 0x00), x2);
    x2 = x1;
    x1 = _mm_and_si128(
        _mm_clmulepi64_si128(_mm_and_si128(x1, mask32), poly, 0x10), mask32);
    x1 = _mm_xor_si128(_mm_clmulepi64_si128(x1, poly, 0x00), x2);
    return (u32)_mm_extract_epi32(x1, 1);
}

bool has_clmul() {
    static const bool yes = __builtin_cpu_supports("pclmul") &&
                            __builtin_cpu_supports("sse4.1");
    return yes;
}
#endif

u32 crc32(const u8 *p, i64 n) {
#if defined(__x86_64__)
    if (n >= 64 && has_clmul()) {
        i64 bulk = n & ~(i64)15;
        u32 c = ~crc32_fold(~0u, p, bulk);
        return crc32_update(c, p + bulk, n - bulk);
    }
#endif
    return crc32_update(0, p, n);
}

inline bool valid_encoding(i64 e) {
    // format.Encoding: PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED,
    // DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
    // RLE_DICTIONARY, BYTE_STREAM_SPLIT
    return e == 0 || (e >= 2 && e <= 9);
}

inline void fail(i64 *res, i64 code, i64 page, i64 a, i64 b) {
    res[0] = code;
    res[1] = page;
    res[2] = a;
    res[3] = b;
}

}  // namespace

extern "C" {

u32 tpq_crc32(const u8 *buf, i64 n) { return crc32(buf, n); }

// Walk the page headers of one chunk (chunk_decode.walk_pages, check for
// check): pages are parsed until the data pages' value counts reach
// total_values; one dictionary page, and only first; index and unknown pages
// recorded and skipped.  pt: PT_FIELDS int64 per page, cap pages.  For a
// SNAPPY chunk (snappy != 0) each v1 data page's PT_CLAIM is the length its
// snappy stream claims (-1 when the header is malformed), so the caller can
// size the arena before anything is decompressed.
// res: [0] W_* code, [1] pages written (the failing one not among them),
// [2] a value for the message, [3] 1 when that value was present.
// Returns the page count, or W_CAP when cap pages were not enough.
i64 tpq_chunk_headers(const u8 *buf, i64 n, i64 total_values, i64 snappy,
                      i64 *pt, i64 cap, i64 *res) {
    i64 pos = 0, np = 0;
    i128 seen = 0;
    bool seen_dict = false;
    i64 h[40];
    res[0] = res[1] = res[2] = res[3] = 0;
    while (seen < (i128)total_values) {
        if (pos >= n) {
            fail(res, W_EXHAUSTED, np, 0, 0);
            break;
        }
        i64 rc = tpq_page_header(buf, n, pos, h);
        if (rc < 0) {
            fail(res, W_THRIFT, np, rc, 1);
            break;
        }
        u64 mask = (u64)h[18];
        if (!(mask >> 2 & 1) || h[2] < 0) {
            fail(res, W_CSIZE, np, h[2], (i64)(mask >> 2 & 1));
            break;
        }
        if (!(mask >> 1 & 1) || h[1] < 0) {
            fail(res, W_USIZE, np, h[1], (i64)(mask >> 1 & 1));
            break;
        }
        pos = h[19];
        if ((i128)pos + h[2] > (i128)n) {
            fail(res, W_PAST_END, np, 0, 0);
            break;
        }
        if (np >= cap) return W_CAP;
        i64 *rec = pt + np * PT_FIELDS;
        i64 flags = 0, nvalues = 0, encoding = 0, claim = -1;
        bool has_type = mask & 1;
        i64 type = has_type ? h[0] : -1;
        if (has_type && type == 2) {  // DICTIONARY_PAGE
            if (seen_dict || np > 0) {
                fail(res, W_EXTRA_DICT, np, 0, 0);
                break;
            }
            if (!(mask >> 61 & 1)) {
                fail(res, W_DICT_HDR, np, 0, 0);
                break;
            }
            seen_dict = true;
            nvalues = (mask >> 8 & 1) ? h[8] : 0;
            if (mask >> 9 & 1) {
                flags |= F_ENCODING;
                encoding = h[9];
            }
        } else if (has_type && type == 0) {  // DATA_PAGE
            if (!(mask >> 60 & 1)) {
                fail(res, W_V1_HDR, np, 0, 0);
                break;
            }
            nvalues = (mask >> 4 & 1) ? h[4] : 0;
            seen += nvalues;
            if (mask >> 5 & 1) {
                flags |= F_ENCODING;
                encoding = h[5];
            }
            if (snappy)
                claim = tpq_snappy_uncompressed_length(buf + pos, (size_t)h[2]);
        } else if (has_type && type == 3) {  // DATA_PAGE_V2
            if (!(mask >> 62 & 1)) {
                fail(res, W_V2_HDR, np, 0, 0);
                break;
            }
            nvalues = (mask >> 11 & 1) ? h[11] : 0;
            seen += nvalues;
            flags |= F_V2;
            if (mask >> 14 & 1) {
                flags |= F_ENCODING;
                encoding = h[14];
            }
        }
        if (has_type) flags |= F_TYPE;
        if (mask >> 3 & 1) flags |= F_CRC;
        rec[PT_TYPE] = type;
        rec[PT_FLAGS] = flags;
        rec[PT_USIZE] = h[1];
        rec[PT_CSIZE] = h[2];
        rec[PT_CRC] = (mask >> 3 & 1) ? h[3] : 0;
        rec[PT_NVALUES] = nvalues;
        rec[PT_ENCODING] = encoding;
        rec[PT_START] = pos;
        rec[PT_END] = pos + h[2];
        rec[PT_CLAIM] = claim;
        np++;
        pos += h[2];
    }
    res[1] = np;
    return np;
}

// CRC-check and decompress m data pages of one chunk, in order: page j is the
// page table's row ix[j].  Per page, as parse_data_page does it: the CRC
// (M_VALIDATE_CRC, where the header has one), the negative value count, the
// lazy rule (M_LAZY: a PLAIN page stays compressed; any other encoding must
// be a known one), then the decompression into arena + dst[j] (SNAPPY: the
// stream's claimed length, at most the declared size, must equal it; the
// arena has 16 bytes of slack past its last slot for the decoder's blind
// stores) or, UNCOMPRESSED, the payload's length check (the page stays a view
// of the chunk).  M_DECOMPRESS: decompression only (lazy pages a consumer
// needs as host bytes).  state[j]: S_ARENA, S_LAZY or S_VIEW.
// res: [0] W_* code, [1] the failing j, [2] and [3] values for the message,
// [4] CRC nanoseconds, [5] decompression nanoseconds.
i64 tpq_chunk_materialise(const u8 *buf, const i64 *pt, const i64 *ix, i64 m,
                          i64 flags, const i64 *dst, u8 *arena, u8 *state,
                          i64 *res) {
    i64 t_crc = 0, t_dec = 0;
    res[0] = res[1] = res[2] = res[3] = 0;
    i64 rc = 0;
    for (i64 j = 0; j < m; j++) {
        const i64 *rec = pt + ix[j] * PT_FIELDS;
        const u8 *src = buf + rec[PT_START];
        i64 clen = rec[PT_END] - rec[PT_START];
        i64 usize = rec[PT_USIZE];
        if (!(flags & M_DECOMPRESS)) {
            if ((flags & M_VALIDATE_CRC) && (rec[PT_FLAGS] & F_CRC)) {
                i64 t0 = now_ns();
                u32 got = crc32(src, clen);
                t_crc += now_ns() - t0;
                u32 want = (u32)rec[PT_CRC];
                if (got != want) {
                    fail(res, W_CRC, j, want, got);
                    rc = 1;
                    break;
                }
            }
            if (rec[PT_NVALUES] < 0) {
                fail(res, W_NEG_VALUES, j, rec[PT_NVALUES], 1);
                rc = 1;
                break;
            }
            if (flags & M_LAZY) {
                bool has_enc = rec[PT_FLAGS] & F_ENCODING;
                if (!has_enc || !valid_encoding(rec[PT_ENCODING])) {
                    fail(res, W_ENCODING, j, rec[PT_ENCODING], has_enc);
                    rc = 1;
                    break;
                }
                if (rec[PT_ENCODING] == 0) {
                    state[j] = S_LAZY;
                    continue;
                }
            }
        }
        if (!(flags & M_SNAPPY)) {
            if (clen != usize) {
                fail(res, W_SIZE, j, usize, clen);
                rc = 1;
                break;
            }
            state[j] = S_VIEW;
            continue;
        }
        i64 claim = rec[PT_CLAIM];
        if (claim < 0) {
            fail(res, W_SNAPPY_LEN, j, 0, 0);
            rc = 1;
            break;
        }
        if (claim > usize) {
            fail(res, W_SNAPPY_CLAIM, j, claim, usize);
            rc = 1;
            break;
        }
        i64 t0 = now_ns();
        int drc = tpq_snappy_decompress(src, (size_t)clen, arena + dst[j],
                                        (size_t)claim);
        t_dec += now_ns() - t0;
        if (drc != 0) {
            fail(res, W_SNAPPY_BAD, j, drc, 1);
            rc = 1;
            break;
        }
        if (claim != usize) {
            fail(res, W_SIZE, j, usize, claim);
            rc = 1;
            break;
        }
        state[j] = S_ARENA;
    }
    res[4] = t_crc;
    res[5] = t_dec;
    return rc;
}

// Walk the RLE/bit-packed index streams of m dictionary-index pages (page j's
// stream: base + off[j], len[j] bytes, count[j] indices), in order, as
// _parse_dict_index_page walks each: the width byte, then the hybrid runs from
// byte 1 (tpq_hybrid_meta).  A page whose width's whole value range lies
// inside the dictionary (width < 31 and dict_len >= 2^width) folds only its
// RLE run values into the range max; any other page folds its every value.
// Outputs: ks[j] runs and widths[j] per page; the runs concatenated in page
// order (ends page-local cumulative, kinds 1 = RLE, vals, bit starts relative
// to the page's stream); each bit-packed run's used groups (ceil(take / 8)
// groups of `width` bytes) copied back to back into packed, page j's from
// pk[j] to pk[j + 1].  run_cap bounds the runs, packed must hold the sum of
// len[j].  res: [0] W_* code, [1] the failing j, [2] a value for the message
// (the width, or the hybrid walk's code), [4] the runs written, [5] the range
// max (u64).  Returns 0, 1 on a failure, or W_CAP when run_cap is too small.
i64 tpq_chunk_runs(const u8 *base, const i64 *off, const i64 *len,
                   const i64 *count, i64 m, i64 dict_len, i64 *ks,
                   i64 *widths, i64 *ends, u8 *kinds, u32 *vals, i64 *starts,
                   i64 run_cap, u8 *packed, i64 *pk, i64 *res) {
    i64 r = 0, p = 0;
    u64 host_max = 0;
    res[0] = res[1] = res[2] = res[3] = 0;
    pk[0] = 0;
    for (i64 j = 0; j < m; j++) {
        const u8 *s = base + off[j];
        i64 n = len[j];
        ks[j] = 0;
        widths[j] = 0;
        if (n < 1) {
            fail(res, W_IDX_TRUNC, j, 0, 0);
            res[4] = r;
            return 1;
        }
        i64 width = s[0];
        if (width > 32) {
            fail(res, W_IDX_WIDTH, j, width, 1);
            res[4] = r;
            return 1;
        }
        widths[j] = width;
        i64 c = count[j];
        if (c > 0) {
            bool covered = width < 31 && dict_len >= ((i64)1 << width);
            i64 consumed = 0;
            u64 mx = 0;
            i64 nr = tpq_hybrid_meta(s, n, 1, width, c, ends + r, kinds + r,
                                     vals + r, starts + r, run_cap - r,
                                     &consumed, covered ? 0 : 1, &mx, 0, 0,
                                     nullptr);
            if (nr == W_CAP) return W_CAP;
            if (nr < 0) {
                fail(res, W_RUNS, j, nr, 1);
                res[4] = r;
                return 1;
            }
            if (covered) {
                for (i64 q = r; q < r + nr; q++)
                    if (kinds[q] && vals[q] > host_max) host_max = vals[q];
            } else if (mx > host_max) {
                host_max = mx;
            }
            i64 prev = 0;
            for (i64 q = r; q < r + nr; q++) {
                if (!kinds[q] && width > 0) {
                    i64 at = (starts[q] + prev * width) >> 3;
                    i64 bytes = (ends[q] - prev + 7) / 8 * width;
                    std::memcpy(packed + p, s + at, (size_t)bytes);
                    p += bytes;
                }
                prev = ends[q];
            }
            ks[j] = nr;
            r += nr;
        }
        pk[j + 1] = p;
    }
    res[4] = r;
    res[5] = (i64)host_max;
    return 0;
}

}  // extern "C"
