// K2: fused PLAIN decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_parquet/pallas_kernels.py:280
// `_fused_plain_kernel` (reached through `fused_plain_words`, the
// `fused_plain` ship route).  PLAIN 4- or 8-byte little-endian values at
// byte `vbase` of the staged buffer become finished uint32 words,
// out[count][width/4]; rows at or past `n_valid` are written as zero
// (decode and the validity tail in one pass).  On a little-endian card the
// words are the value bytes themselves, so this is a copy from an
// arbitrary byte offset into an aligned output, with the tail masked.
//
// What bounds it on the card: bytes.  It reads and writes count*width
// bytes and computes nothing but a compare per word, so the least time is
// (2 * count * width) / 3.35 TB/s.  Reaching that needs many bytes in
// flight per SM: wide accesses and several of them per thread.
//
// What the design does about it:
//  - Every access is 16 bytes and aligned.  Output chunk j (bytes 16j ..
//    16j+15) needs the source bytes at vbase + 16j, which lie in two
//    aligned 16-byte chunks, c[j] and c[j+1], shifted by r = (buf + vbase)
//    mod 16 -- the same r for every chunk.  Each lane loads only c[j] and
//    takes c[j+1] from its neighbour lane by a warp shuffle (the last lane
//    of a warp's span from lane 0 of the next span, or by one more load at
//    the end), then realigns with __funnelshift_r.  At r = 0 no shuffle
//    runs.  An odd base thus moves the same bytes as an aligned one.
//  - A warp takes STEPS spans of 32 chunks at once (STEPS x 16 bytes in
//    flight per lane), loads with __ldcs and stores with __stcs: every byte
//    is touched once, so neither should stay in the caches.  The grid is
//    sized by the wrapper to the SMs and strides over the warp tiles.
//  - A load never reaches outside [buf, buf + buf_len): a chunk that
//    crosses either end (at most the first and the last) is read byte by
//    byte.  A chunk that holds no byte of a valid row is not read at all.
//  - The tail mask is a select per word, no branch.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for an output that is not
// 16-byte aligned or a count that is not whole tiles) so the wrapper can
// raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// aligned chunk at address a: zero unless it holds a byte of [need0, need1)
__device__ __forceinline__ uint4 load_chunk(uintptr_t a, uintptr_t lo,
                                            uintptr_t hi, uintptr_t need0,
                                            uintptr_t need1) {
  if (a >= need1 || a + 16 <= need0) return make_uint4(0u, 0u, 0u, 0u);
  if (a >= lo && a + 16 <= hi) return __ldcs(reinterpret_cast<const uint4*>(a));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const uintptr_t x = a + b;
    if (x >= lo && x < hi)
      w[b >> 2] |= (uint32_t)*reinterpret_cast<const uint8_t*>(x)
                   << (8 * (b & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bytes r .. r+15 of the 32 bytes a:b (r is the same in the whole grid)
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int r) {
  uint32_t w0, w1, w2, w3, w4;
  switch (r >> 2) {
    case 0: w0 = a.x; w1 = a.y; w2 = a.z; w3 = a.w; w4 = b.x; break;
    case 1: w0 = a.y; w1 = a.z; w2 = a.w; w3 = b.x; w4 = b.y; break;
    case 2: w0 = a.z; w1 = a.w; w2 = b.x; w3 = b.y; w4 = b.z; break;
    default: w0 = a.w; w1 = b.x; w2 = b.y; w3 = b.z; w4 = b.w; break;
  }
  const unsigned sh = 8u * (unsigned)(r & 3);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int src_lane) {
  return make_uint4(__shfl_sync(0xffffffffu, v.x, src_lane),
                    __shfl_sync(0xffffffffu, v.y, src_lane),
                    __shfl_sync(0xffffffffu, v.z, src_lane),
                    __shfl_sync(0xffffffffu, v.w, src_lane));
}

__device__ __forceinline__ uint4 shfl4_down(uint4 v) {
  return make_uint4(__shfl_down_sync(0xffffffffu, v.x, 1),
                    __shfl_down_sync(0xffffffffu, v.y, 1),
                    __shfl_down_sync(0xffffffffu, v.z, 1),
                    __shfl_down_sync(0xffffffffu, v.w, 1));
}

template <int STEPS>
__global__ void __launch_bounds__(kThreads) tpq_fused_plain_kernel(
    const uint8_t* __restrict__ buf, long long buf_len, long long vbase,
    int width, long long n_valid, long long n_chunks,
    uint4* __restrict__ out) {
  constexpr int kTile = 32 * STEPS;  // chunks per warp tile
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(buf);
  const uintptr_t hi = lo + (uintptr_t)buf_len;
  const uintptr_t src = lo + (uintptr_t)vbase;
  // the source bytes that rows below n_valid need
  const long long rows = n_chunks * 16 / width;
  const long long nv = n_valid < 0 ? 0 : (n_valid > rows ? rows : n_valid);
  const uintptr_t need1 = src + (uintptr_t)(nv * width);
  const uintptr_t al = src & ~(uintptr_t)15;
  const int r = (int)(src & 15);
  const int row_shift = width == 8 ? 1 : 0;  // word index -> row
  for (long long t0 = warp * kTile; t0 < n_chunks; t0 += warps * kTile) {
    uint4 c[STEPS];
#pragma unroll
    for (int u = 0; u < STEPS; ++u)
      c[u] = load_chunk(al + 16 * (uintptr_t)(t0 + 32 * u + lane), lo, hi,
                        src, need1);
    uint4 extra = make_uint4(0u, 0u, 0u, 0u);
    if (r != 0 && lane == 31)
      extra = load_chunk(al + 16 * (uintptr_t)(t0 + kTile), lo, hi, src,
                         need1);
#pragma unroll
    for (int u = 0; u < STEPS; ++u) {
      const long long j = t0 + 32 * u + lane;
      uint4 v = c[u];
      if (r != 0) {
        const uint4 down = shfl4_down(c[u]);
        // lane 31's next chunk: lane 0's of the next span, or the extra
        uint4 next = extra;
        if (u + 1 < STEPS) next = shfl4(c[(u + 1) % STEPS], 0);
        v = realign(c[u], lane == 31 ? next : down, r);
      }
      const long long w0 = 4 * j;  // first word of the chunk
      v.x = ((w0 + 0) >> row_shift) < nv ? v.x : 0u;
      v.y = ((w0 + 1) >> row_shift) < nv ? v.y : 0u;
      v.z = ((w0 + 2) >> row_shift) < nv ? v.z : 0u;
      v.w = ((w0 + 3) >> row_shift) < nv ? v.w : 0u;
      __stcs(out + j, v);
    }
  }
}

}  // namespace

extern "C" int tpq_fused_plain_words(const void* buf, long long buf_len,
                                     long long vbase, int width,
                                     long long n_valid, long long count,
                                     int steps, int grid, void* out,
                                     void* stream) {
  if (count <= 0) return 0;
  if ((steps != 1 && steps != 4) || (width != 4 && width != 8))
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = count * width / 16;
  if (n_chunks * 16 != count * width || n_chunks % (32LL * steps) != 0 ||
      grid <= 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15u) != 0u)
    return (int)cudaErrorInvalidValue;
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  uint4* o = static_cast<uint4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (steps == 4) {
    tpq_fused_plain_kernel<4><<<grid, kThreads, 0, s>>>(
        b, buf_len, vbase, width, n_valid, n_chunks, o);
  } else {
    tpq_fused_plain_kernel<1><<<grid, kThreads, 0, s>>>(
        b, buf_len, vbase, width, n_valid, n_chunks, o);
  }
  return (int)cudaGetLastError();
}
