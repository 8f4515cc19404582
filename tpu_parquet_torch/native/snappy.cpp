// Native runtime: Snappy raw-block codec (C++17, no external deps).
//
// Parquet's default page codec is Snappy's *raw* (non-framed) format.  The Go
// reference pulls in github.com/golang/snappy (compress.go:182-187); the Python
// snappy binding is not available in this image, so the codec is implemented here
// from the format spec and exposed to Python via ctypes
// (tpu_parquet/native/__init__.py).  A pure-Python fallback lives in
// tpu_parquet/compress.py for environments without a C++ toolchain.
//
// Raw snappy format:
//   [uvarint uncompressed_length] then a sequence of elements:
//     tag & 3 == 0: literal.  len-1 in tag>>2 if < 60, else (tag>>2)-59 extra
//                   little-endian length bytes follow; then the literal bytes.
//     tag & 3 == 1: copy, 1-byte offset: len = ((tag>>2)&7)+4,
//                   offset = ((tag>>5)<<8) | next byte.   (4..11 bytes, off<2048)
//     tag & 3 == 2: copy, 2-byte LE offset: len = (tag>>2)+1.
//     tag & 3 == 3: copy, 4-byte LE offset: len = (tag>>2)+1.
// Matches only ever reach back < 65536 bytes because compression operates on
// 64 KiB fragments.

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

constexpr size_t kBlockSize = 1 << 16;   // compression fragment size
constexpr int kHashBits = 14;
constexpr size_t kHashTableSize = 1 << kHashBits;

inline uint32_t load32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t load64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

// --- varint ----------------------------------------------------------------

int read_uvarint32(const uint8_t* src, size_t n, size_t* pos, uint32_t* out) {
  uint32_t result = 0;
  int shift = 0;
  while (*pos < n) {
    uint8_t b = src[(*pos)++];
    if (shift == 28 && (b & 0xf0) != 0) return -1;  // overflow past 32 bits
    result |= uint32_t(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return 0;
    }
    shift += 7;
    if (shift > 28) return -1;
  }
  return -1;  // truncated
}

size_t write_uvarint32(uint8_t* dst, uint32_t v) {
  size_t i = 0;
  while (v >= 0x80) {
    dst[i++] = uint8_t(v) | 0x80;
    v >>= 7;
  }
  dst[i++] = uint8_t(v);
  return i;
}

// --- emit helpers for the compressor --------------------------------------

inline uint8_t* emit_literal(uint8_t* dst, const uint8_t* src, size_t len) {
  if (len == 0) return dst;
  size_t n = len - 1;
  if (n < 60) {
    *dst++ = uint8_t(n << 2);
  } else if (n < (1u << 8)) {
    *dst++ = 60 << 2;
    *dst++ = uint8_t(n);
  } else if (n < (1u << 16)) {
    *dst++ = 61 << 2;
    *dst++ = uint8_t(n);
    *dst++ = uint8_t(n >> 8);
  } else if (n < (1u << 24)) {
    *dst++ = 62 << 2;
    *dst++ = uint8_t(n);
    *dst++ = uint8_t(n >> 8);
    *dst++ = uint8_t(n >> 16);
  } else {
    *dst++ = 63 << 2;
    *dst++ = uint8_t(n);
    *dst++ = uint8_t(n >> 8);
    *dst++ = uint8_t(n >> 16);
    *dst++ = uint8_t(n >> 24);
  }
  std::memcpy(dst, src, len);
  return dst + len;
}

// Emit one copy element of length 4..64 (caller splits longer matches).
inline uint8_t* emit_copy_chunk(uint8_t* dst, size_t offset, size_t len) {
  if (len < 12 && offset < 2048) {
    *dst++ = uint8_t(((offset >> 8) << 5) | ((len - 4) << 2) | 1);
    *dst++ = uint8_t(offset);
  } else {
    *dst++ = uint8_t(((len - 1) << 2) | 2);
    *dst++ = uint8_t(offset);
    *dst++ = uint8_t(offset >> 8);
  }
  return dst;
}

inline uint8_t* emit_copy(uint8_t* dst, size_t offset, size_t len) {
  // Prefer 64-byte chunks; keep the tail >= 4.
  while (len >= 68) {
    dst = emit_copy_chunk(dst, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    dst = emit_copy_chunk(dst, offset, 60);
    len -= 60;
  }
  return emit_copy_chunk(dst, offset, len);
}

}  // namespace

extern "C" {

// Parse the uncompressed-length header. Returns length, or -1 on malformed input.
long long tpq_snappy_uncompressed_length(const uint8_t* src, size_t n) {
  size_t pos = 0;
  uint32_t len;
  if (read_uvarint32(src, n, &pos, &len) != 0) return -1;
  return (long long)len;
}

// Decompress src (raw snappy) into dst of exactly dst_len bytes.
// Returns 0 on success, negative error codes on malformed input.
// Contract: dst must have >= 16 writable SLACK bytes past dst_len (the
// Python wrapper over-allocates) — the short-op fast paths below do blind
// 16-byte stores and the slack keeps them in-bounds without per-op length
// branches.  Bytes past dst_len are scratch; the logical output is
// dst[0:dst_len].
int tpq_snappy_decompress(const uint8_t* src, size_t n, uint8_t* dst,
                          size_t dst_len) {
  size_t pos = 0;
  uint32_t expect;
  if (read_uvarint32(src, n, &pos, &expect) != 0) return -2;
  if (expect != dst_len) return -3;
  size_t out = 0;
  while (pos < n) {
    uint8_t tag = src[pos++];
    uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      size_t len = tag >> 2;
      if (len < 60) {
        len += 1;
        if (pos + len > n || out + len > dst_len) return -5;
        if (len <= 16 && pos + 16 <= n) {
          // blind 16-byte copy (slack covers the overshoot); the typical
          // literal is short and a memcpy call dominated it
          std::memcpy(dst + out, src + pos, 16);
        } else {
          std::memcpy(dst + out, src + pos, len);
        }
        pos += len;
        out += len;
        continue;
      }
      size_t extra = len - 59;
      if (pos + extra > n) return -4;
      len = 0;
      for (size_t i = 0; i < extra; i++) len |= size_t(src[pos + i]) << (8 * i);
      pos += extra;
      len += 1;
      if (pos + len > n || out + len > dst_len) return -5;
      std::memcpy(dst + out, src + pos, len);
      pos += len;
      out += len;
    } else {  // copy
      size_t len, offset;
      if (kind == 1) {
        if (pos >= n) return -6;
        len = ((tag >> 2) & 7) + 4;
        offset = (size_t(tag >> 5) << 8) | src[pos];
        pos += 1;
      } else if (kind == 2) {
        if (pos + 2 > n) return -6;
        len = (tag >> 2) + 1;
        offset = size_t(src[pos]) | (size_t(src[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > n) return -6;
        len = (tag >> 2) + 1;
        offset = size_t(src[pos]) | (size_t(src[pos + 1]) << 8) |
                 (size_t(src[pos + 2]) << 16) | (size_t(src[pos + 3]) << 24);
        pos += 4;
      }
      if (offset == 0 || offset > out) return -7;
      if (out + len > dst_len) return -8;
      uint8_t* d = dst + out;
      const uint8_t* s = d - offset;
      if (offset >= 8) {
        // 8-byte stride blind copy into the slack (format caps copy len at
        // 64, so this is at most 8 wide stores, usually 1-2)
        for (size_t i = 0; i < len; i += 8) std::memcpy(d + i, s + i, 8);
      } else {
        // overlapping copy: byte-wise (RLE-style repetition)
        for (size_t i = 0; i < len; i++) d[i] = s[i];
      }
      out += len;
    }
  }
  return out == dst_len ? 0 : -9;
}

size_t tpq_snappy_max_compressed_length(size_t n) {
  return 32 + n + n / 6;
}

// Compress src into dst (capacity >= max_compressed_length). Returns output size.
long long tpq_snappy_compress(const uint8_t* src, size_t n, uint8_t* dst) {
  uint8_t* out = dst + write_uvarint32(dst, uint32_t(n));
  static thread_local uint16_t table[kHashTableSize];

  for (size_t block = 0; block < n || block == 0; block += kBlockSize) {
    size_t block_len = n - block < kBlockSize ? n - block : kBlockSize;
    const uint8_t* base = src + block;
    if (block_len < 16) {
      out = emit_literal(out, base, block_len);
      if (n == 0) break;
      continue;
    }
    std::memset(table, 0, sizeof(table));
    size_t ip = 0;
    size_t lit_start = 0;
    const size_t margin = block_len - 15;  // room for fast 8-byte loads
    // skip acceleration (the snappy format's standard incompressible-input
    // heuristic): after 32 consecutive hash misses, probe every 2nd byte,
    // then every 3rd, ... — random data costs O(n/step) instead of one
    // probe per byte (measured 0.44 -> ~3 GB/s on random int64 pages)
    size_t skip = 32;
    while (ip + 4 <= margin) {
      uint32_t h = hash32(load32(base + ip));
      size_t cand = table[h];
      table[h] = uint16_t(ip);
      if (cand < ip && load32(base + cand) == load32(base + ip)) {
        skip = 32;
        // extend match forward
        size_t len = 4;
        while (ip + len + 8 <= block_len &&
               load64(base + cand + len) == load64(base + ip + len)) {
          len += 8;
        }
        while (ip + len < block_len && base[cand + len] == base[ip + len]) len++;
        out = emit_literal(out, base + lit_start, ip - lit_start);
        out = emit_copy(out, ip - cand, len);
        ip += len;
        lit_start = ip;
        if (ip + 4 <= margin) {
          // re-prime the table at the new position - 1
          table[hash32(load32(base + ip - 1))] = uint16_t(ip - 1);
        }
      } else {
        ip += (skip++ >> 5);
      }
    }
    out = emit_literal(out, base + lit_start, block_len - lit_start);
    if (n == 0) break;
  }
  return out - dst;
}

// --- ragged gather / hybrid expansion (host decode hot paths) ---------------
//
// These two transforms dominated the host decode profile as numpy
// (repeat+arange gather for dictionary take, searchsorted + byte-window
// sweep for hybrid expansion) and — unlike numpy's non-ufunc kernels — run
// here with the GIL released (ctypes), so the chunk-prefetch pipeline's
// worker threads genuinely overlap.

// Dictionary expansion for ragged BYTE_ARRAY rows: output row i is
// heap[offsets[idx[i]] : offsets[idx[i]+1]], landing at out_off[i].  The
// caller computes out_off (cumsum of the selected lengths) and has already
// bounds-checked idx against the dictionary.
void tpq_ragged_take(const int64_t* offsets, const uint8_t* heap,
                     const int64_t* idx, long long n,
                     const int64_t* out_off, uint8_t* out_heap) {
  for (long long i = 0; i < n; ++i) {
    const int64_t j = idx[i];
    const int64_t start = offsets[j];
    const int64_t len = offsets[j + 1] - start;
    if (len > 0) std::memcpy(out_heap + out_off[i], heap + start, size_t(len));
  }
}

// Expand parsed hybrid run tables (tpq_hybrid_meta's output, meta_parse.cpp)
// to `count` uint32 values.  kinds[r] == 0 is a bit-packed run whose value
// at global position i sits at bit starts[r] + i*width (starts are
// pre-normalized by -run_start*width, exactly the contract the numpy sweep
// in kernels/rle.py consumes); nonzero kinds are RLE runs filling vals[r].
// width 1..32.  Reads never pass nbuf (tail fields assemble byte-wise).
void tpq_hybrid_expand(const uint8_t* buf, long long nbuf,
                       const int64_t* ends, const uint8_t* kinds,
                       const uint32_t* vals, const int64_t* starts,
                       long long n_runs, int width, long long count,
                       uint32_t* out) {
  const uint64_t mask =
      (width >= 32) ? 0xffffffffull : ((1ull << width) - 1ull);
  int64_t pos = 0;
  for (long long r = 0; r < n_runs && pos < count; ++r) {
    int64_t end = ends[r];
    if (end > count) end = count;
    if (end <= pos) continue;
    if (kinds[r] != 0) {  // RLE: broadcast the run value
      const uint32_t v = vals[r];
      for (; pos < end; ++pos) out[pos] = v;
    } else {  // bit-packed: extract width-bit fields at affine positions
      const int64_t sbit = starts[r];
      for (; pos < end; ++pos) {
        const int64_t bit = sbit + pos * int64_t(width);
        const int64_t byte0 = bit >> 3;
        uint64_t acc = 0;
        if (byte0 + 8 <= nbuf) {
          std::memcpy(&acc, buf + byte0, 8);
        } else {
          for (int k = 0; k < 8 && byte0 + k < nbuf; ++k)
            acc |= uint64_t(buf[byte0 + k]) << (8 * k);
        }
        out[pos] = uint32_t((acc >> (bit & 7)) & mask);
      }
    }
  }
  for (; pos < count; ++pos) out[pos] = 0;  // defensive: runs short of count
}

}  // extern "C"
