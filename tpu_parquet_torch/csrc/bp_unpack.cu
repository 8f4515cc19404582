// K1 for Hopper (sm_90a): the BP-group unpack, standalone and fused with the
// RLE/bit-packed run-table combine.
//
// Replaces the Pallas TPU kernel tpu_parquet/pallas_kernels.py:93
// `_unpack_kernel` (through `_unpack_call` :122 and `_bp_groups_jit` :179)
// and, in its fused form, the combine that follows it,
// tpu_parquet/device_reader.py:817 `_hybrid_combine_staged_jit`.
//
// tpq_unpack_bp_groups: the LSB-first fixed-width unpack of `groups` 8-value
//   groups at bp_base (group g is the `width` bytes at bp_base + g*width, so
//   value v starts at bit v*width of the payload).  Output uint32[groups*8].
//
// tpq_hybrid_unpack_combine: one RLE/bit-packed hybrid stream in stream
//   order.  The run table sits in the staged buffer at `tbase` (4-byte
//   aligned): [ends i32 | is_rle u8 | values u32 | bp_idx_base i32] x rp, rp
//   a power of two >= 8, `ends` non-decreasing (padded with the total, as the
//   planner builds them).  For every position pos < count:
//     r      = min(upper_bound(ends, pos), rp - 1)
//     bp_idx = clamp(bp_idx_base[r] + pos, 0, gpad*8 - 1)   (int32 math)
//     out    = is_rle[r] ? values[r] : the width bits at bit bp_idx*width
//     out    = pos < n_valid ? out : 0
//   Output int32[count] holding the uint32 bits.  The unfused chain wrote
//   the whole uint32[gpad*8] unpack to device memory and gathered from it in
//   about fifteen PyTorch launches; here nothing but the output is written.
//
// What bounds it on the card: bytes.  The work is a few shifts and compares
// per value, far below the H100's operations-per-byte balance point, so the
// least time is (the BP payload read once + the run table + count*4
// written) / 3.35 TB/s.
//
// What the design does about that bound:
//  - A block of 256 threads takes a tile of 2,048 consecutive positions; a
//    thread takes two groups of 4 consecutive positions, 1,024 apart, so
//    that each warp's output is one 16-byte store per lane, 512 contiguous
//    bytes (a scalar tail where `count` ends inside a group of 4).
//  - Run window: two threads find the tile's first and last run with a
//    binary search over `ends` in global memory (L2-resident); the block
//    copies that window of the four tables into shared memory.  A thread
//    finds the run of each of its groups of 4 positions by a binary search
//    there and loads that run's row once; the next positions cost one
//    compare (a new search only where the run ends inside the group).  A
//    window over 1,024 runs (level streams with many short runs) stays in
//    global memory and the same searches run there.  Positions at or past
//    n_valid are zero whatever the tables say, so they take no part in the
//    window.
//  - Payload staging: the bit-packed values a tile selects lie in one span
//    of the payload (runs are staged in stream order).  The block reduces
//    its threads' least and greatest bp_idx and copies that byte span into
//    shared memory with 16-byte cp.async for the aligned chunks and bytes
//    for a ragged head or tail, never reading outside [buf, the read extent
//    bp_base + gpad*width).  A span over the shared capacity (2 x 2,048
//    values) is read from global memory byte by byte instead.
//  - Extraction: each value is a funnel shift of the two aligned 32-bit
//    words (a 64-bit window) that hold its bits: at most 32 bits at any
//    shift, so every width 1..32 takes two shared loads, where a thread
//    per group issued up to five single-byte global loads per value.  Bit
//    positions in the staged span are 32-bit offsets from the block's least
//    index; in global memory they are 64-bit (bp_idx*width overflows int32).
//  - Instructions: positions are int32 (count <= INT_MAX - 2,048), and a
//    group of 4 positions inside one run takes its row once and its 4
//    values at once; only a group that a run end or the index clamp cuts
//    goes position by position.
//  - The standalone unpack is the same staging and extraction over a tile of
//    256 groups with no run table.
//
// Both launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() (cudaErrorInvalidValue for arguments the wrapper should
// have refused) so the wrapper can raise.  Shared memory stays under 48 KB,
// so no launch needs the large-shared-memory attribute.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                             // positions per store
constexpr int kTile = 2048;                         // positions per block
constexpr int kChunks = kTile / (kThreads * kVec);  // groups of 4 per thread
constexpr int kWindow = 1024;                       // run rows kept in smem
constexpr int kSpanValues = 2 * kTile;              // BP values staged

// shared bytes that stage `values` consecutive width-bit values from any
// byte offset: the span, a 16-byte-aligned head, 8 bytes past the last
// value for the second word of the funnel shift, rounded to 16
__host__ __device__ constexpr int stage_cap(int values, int width) {
  return (int)((((long long)values * width) / 8 + 48 + 15) & ~15LL);
}

constexpr int kTableBytes = 13 * kWindow;  // a multiple of 16

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy the global bytes [a0, a1) (16-byte-aligned addresses) to smem[0..);
// chunks inside the readable range [lo, hi) go by 16-byte cp.async, the
// others byte by byte with the bytes outside [lo, hi) read as 0.  The
// caller synchronises the block afterwards.
__device__ __forceinline__ void stage_span(uint8_t* smem, uintptr_t a0,
                                           uintptr_t a1, uintptr_t lo,
                                           uintptr_t hi) {
  for (uintptr_t a = a0 + 16 * (uintptr_t)threadIdx.x; a < a1;
       a += 16 * (uintptr_t)blockDim.x) {
    uint8_t* s = smem + (a - a0);
    if (a >= lo && a + 16 <= hi) {
      cp_async16(s, reinterpret_cast<const void*>(a));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uintptr_t b = a + j;
        s[j] = (b >= lo && b < hi) ? __ldg(reinterpret_cast<const uint8_t*>(b))
                                   : (uint8_t)0;
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// the width bits at bit `bit` of the staged words, LSB first
__device__ __forceinline__ uint32_t extract(const uint32_t* words,
                                            uint32_t bit, uint32_t mask) {
  const uint32_t wi = bit >> 5;
  return __funnelshift_r(words[wi], words[wi + 1], bit & 31u) & mask;
}

// the same from global memory, byte by byte, bytes at or past `end` as 0
__device__ __forceinline__ uint32_t extract_global(const uint8_t* buf,
                                                   long long end,
                                                   long long bp_base,
                                                   uint64_t bit, int width,
                                                   uint32_t mask) {
  const long long b0 = bp_base + (long long)(bit >> 3);
  const int shift = (int)(bit & 7);
  const int nbytes = (shift + width + 7) >> 3;  // 1..5 bytes cover the field
  uint64_t acc = 0;
  for (int k = 0; k < nbytes; ++k) {
    if (b0 + k < end) acc |= (uint64_t)__ldg(buf + b0 + k) << (8 * k);
  }
  return (uint32_t)(acc >> shift) & mask;
}

__device__ __forceinline__ uint32_t width_mask(int width) {
  return width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
}

__device__ __forceinline__ void store_group(uint32_t* __restrict__ out,
                                            int p0, int count,
                                            const uint32_t (&o)[kVec]) {
  if (p0 + kVec <= count) {
    *reinterpret_cast<uint4*>(out + p0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (p0 + k < count) out[p0 + k] = o[k];
    }
  }
}

// lo + the number of entries of e[lo..n) that are <= key: the upper bound
// of key when e is sorted and every entry before lo is <= key
__device__ __forceinline__ int count_le(const int* e, int lo, int n,
                                        int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) tpq_unpack_bp_groups_kernel(
    const uint8_t* __restrict__ buf, long long end, long long bp_base,
    int width, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long v0 = (long long)blockIdx.x * kTile;
  const uintptr_t base = reinterpret_cast<uintptr_t>(buf);
  const uintptr_t g_lo = base + bp_base + (v0 / 8) * width;
  const uintptr_t g_hi = g_lo + (uintptr_t)(kTile / 8) * width;
  const uintptr_t a0 = g_lo & ~(uintptr_t)15;
  const uintptr_t a1 = (g_hi + 8 + 15) & ~(uintptr_t)15;
  stage_span(smem, a0, a1, base, base + end);
  __syncthreads();
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem);
  const uint32_t mask = width_mask(width);
  const uint32_t head = 8 * (uint32_t)(g_lo - a0);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int t = c * kThreads * kVec + threadIdx.x * kVec;
    uint32_t o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = extract(words, head + (uint32_t)(t + k) * width, mask);
    *reinterpret_cast<uint4*>(out + v0 + t) =
        make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(kThreads) tpq_hybrid_unpack_combine_kernel(
    const uint8_t* __restrict__ buf, long long buf_len, long long bp_base,
    long long tbase, int lim, int width, long long gpad, int count, int rp,
    int pay_cap, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* s_ends = reinterpret_cast<int*>(smem);
  uint32_t* s_vals = reinterpret_cast<uint32_t*>(smem + 4 * kWindow);
  int* s_bib = reinterpret_cast<int*>(smem + 8 * kWindow);
  uint8_t* s_isr = smem + 12 * kWindow;
  uint8_t* s_pay = smem + kTableBytes;
  __shared__ int s_run[2];
  __shared__ int s_red[2][kThreads / 32];

  const int* ends = reinterpret_cast<const int*>(buf + tbase);
  const uint8_t* isr = buf + tbase + 4LL * rp;
  const uint32_t* rvals =
      reinterpret_cast<const uint32_t*>(buf + tbase + 5LL * rp);
  const int* bib = reinterpret_cast<const int*>(buf + tbase + 9LL * rp);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kTile;
  // positions [t0, v1) take their value from the tables; the rest are 0
  // (lim = n_valid clamped to [0, count]; count <= INT_MAX - kTile)
  const int v1 = min(t0 + kTile, lim);
  uint32_t val[kChunks][kVec] = {};
  uint32_t from_bp = 0;  // bit c*kVec+k: that position reads the payload
  int mn = INT_MAX, mx = -1;  // least and greatest BP index: the
                              // thread's, then (step 3) the block's
  bool staged = false;
  int rel0 = 0;  // bit of BP index mn in s_pay
  const long long end = min(buf_len, bp_base + gpad * width);
  const uint32_t mask = width_mask(width);
  const uintptr_t base = reinterpret_cast<uintptr_t>(buf);

  if (v1 > t0) {  // block-uniform
    // 1. the tile's run window [r_lo, r_hi], in shared memory where it fits
    if (tid == 0 || tid == 32) {
      const int key = tid == 0 ? t0 : v1 - 1;
      s_run[tid >> 5] = min(count_le(ends, 0, rp, key), rp - 1);
    }
    __syncthreads();
    const int r_lo = s_run[0];
    const int w = max(s_run[1] - r_lo + 1, 1);  // >= 1 even if unsorted
    const bool in_smem = w <= kWindow;
    if (in_smem) {
      for (int i = tid; i < w; i += kThreads) {
        s_ends[i] = __ldg(ends + r_lo + i);
        s_vals[i] = __ldg(rvals + r_lo + i);
        s_bib[i] = __ldg(bib + r_lo + i);
        s_isr[i] = __ldg(isr + r_lo + i);
      }
    }
    __syncthreads();
    const int* e = in_smem ? s_ends : ends + r_lo;
    const uint32_t* rv = in_smem ? s_vals : rvals + r_lo;
    const int* bb = in_smem ? s_bib : bib + r_lo;
    const uint8_t* ir = in_smem ? s_isr : isr + r_lo;

    // 2. each position's run: RLE value, or its clamped BP index.  A
    // group of 4 positions searches once and loads its run's row once; a
    // group inside one run takes its 4 values at once, the others move on
    // position by position where the run ends.
    const int gmax = (int)(gpad * 8 - 1);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int p0 = t0 + c * kThreads * kVec + tid * kVec;
      if (p0 >= v1) continue;
      // the window's last row is the answer once every earlier end is
      // <= pos (the clamp to rp - 1 included)
      int rr = count_le(e, 0, w - 1, p0);
      int run_end = rr < w - 1 ? e[rr] : INT_MAX;
      bool rle = ir[rr] != 0;
      uint32_t rval = rv[rr];
      int rbib = bb[rr];
      // int32 wrap-around add, as the reference's int32 math
      const int idx0 = (int)((unsigned)rbib + (unsigned)p0);
      if (p0 + kVec <= min(run_end, v1) &&
          (rle || (idx0 >= 0 && idx0 <= gmax - (kVec - 1)))) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) val[c][k] = rle ? rval : idx0 + k;
        if (!rle) {
          from_bp |= ((1u << kVec) - 1u) << (c * kVec);
          mn = min(mn, idx0);
          mx = max(mx, idx0 + kVec - 1);
        }
        continue;
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int pi = p0 + k;
        if (pi >= v1) break;
        if (pi >= run_end) {
          rr = count_le(e, rr + 1, w - 1, pi);
          run_end = rr < w - 1 ? e[rr] : INT_MAX;
          rle = ir[rr] != 0;
          rval = rv[rr];
          rbib = bb[rr];
        }
        if (rle) {
          val[c][k] = rval;
        } else {
          int idx = (int)((unsigned)rbib + (unsigned)pi);
          idx = min(max(idx, 0), gmax);
          val[c][k] = (uint32_t)idx;
          from_bp |= 1u << (c * kVec + k);
          mn = min(mn, idx);
          mx = max(mx, idx);
        }
      }
    }

    // 3. the block's BP index range, then its payload span into smem
    mn = __reduce_min_sync(0xFFFFFFFFu, mn);
    mx = __reduce_max_sync(0xFFFFFFFFu, mx);
    if ((tid & 31) == 0) {
      s_red[0][tid >> 5] = mn;
      s_red[1][tid >> 5] = mx;
    }
    __syncthreads();
    mn = s_red[0][0];
    mx = s_red[1][0];
#pragma unroll
    for (int i = 1; i < kThreads / 32; ++i) {
      mn = min(mn, s_red[0][i]);
      mx = max(mx, s_red[1][i]);
    }
    if (mx >= 0) {  // block-uniform
      const uintptr_t g_lo = base + bp_base + (((uint64_t)mn * width) >> 3);
      const uintptr_t g_hi =
          base + bp_base + ((((uint64_t)mx + 1) * width + 7) >> 3);
      const uintptr_t a0 = g_lo & ~(uintptr_t)15;
      const uintptr_t a1 = (g_hi + 8 + 15) & ~(uintptr_t)15;
      staged = a1 - a0 <= (uintptr_t)pay_cap;
      if (staged) {
        stage_span(s_pay, a0, a1, base, base + end);
        rel0 = (int)((long long)mn * width -
                     8 * ((long long)(a0 - base) - bp_base));
      }
      __syncthreads();
    }
  }

  // 4. extract and store
  const uint32_t* words = reinterpret_cast<const uint32_t*>(s_pay);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int p0 = t0 + c * kThreads * kVec + tid * kVec;
    uint32_t o[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      o[k] = val[c][k];
      if (from_bp >> (c * kVec + k) & 1u) {
        o[k] = staged
                   ? extract(words, (o[k] - (uint32_t)mn) * width + rel0, mask)
                   : extract_global(buf, end, bp_base,
                                    (uint64_t)o[k] * width, width, mask);
      }
    }
    store_group(out, p0, count, o);
  }
}

}  // namespace

extern "C" int tpq_unpack_bp_groups(const void* buf, long long buf_len,
                                    long long bp_base, int width,
                                    long long groups, void* out,
                                    void* stream) {
  if (groups <= 0) return 0;
  if (width < 1 || width > 32 || groups % (kTile / 8) != 0)
    return (int)cudaErrorInvalidValue;
  const long long end = bp_base + groups * width;
  if (bp_base < 0 || end > buf_len) return (int)cudaErrorInvalidValue;
  const long long blocks = groups * 8 / kTile;
  tpq_unpack_bp_groups_kernel<<<(unsigned int)blocks, kThreads,
                                stage_cap(kTile, width),
                                (cudaStream_t)stream>>>(
      (const uint8_t*)buf, end, bp_base, width, (uint32_t*)out);
  return (int)cudaGetLastError();
}

extern "C" int tpq_hybrid_unpack_combine(const void* buf, long long buf_len,
                                         long long bp_base, long long tbase,
                                         long long n_valid, int width,
                                         long long gpad, long long count,
                                         int rp, void* out, void* stream) {
  if (count <= 0) return 0;
  if (width < 1 || width > 32 || rp < 8 || (rp & (rp - 1)) != 0 ||
      gpad <= 0 || gpad * 8 > (long long)INT_MAX + 1 ||
      count > INT_MAX - kTile || tbase < 0 || tbase + 13LL * rp > buf_len ||
      bp_base < 0 || bp_base + gpad * width > buf_len)
    return (int)cudaErrorInvalidValue;
  const int pay_cap = stage_cap(kSpanValues, width);
  const int lim = (int)(n_valid < 0 ? 0 : (n_valid < count ? n_valid : count));
  const long long blocks = (count + kTile - 1) / kTile;
  tpq_hybrid_unpack_combine_kernel<<<(unsigned int)blocks, kThreads,
                                     kTableBytes + pay_cap,
                                     (cudaStream_t)stream>>>(
      (const uint8_t*)buf, buf_len, bp_base, tbase, lim, width, gpad,
      (int)count, rp, pay_cap, (uint32_t*)out);
  return (int)cudaGetLastError();
}
