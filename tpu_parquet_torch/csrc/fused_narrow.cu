// K3: fused narrow+snappy decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_parquet/pallas_kernels.py:353
// `_fused_narrow_kernel` (reached through `fused_narrow_words`, the
// `fused_narrow_snappy` ship route).  The host shipped snappy over the
// k-byte narrow transcode (v - min) of an INT32/INT64 column, plus the
// stream's op tables from its tag walk.  Per output value this kernel
// resolves each of its k bytes through the op tables to a literal byte of
// the compressed payload, widens the k bytes little-endian, adds the bias
// (the column minimum) modulo 2^(8*width), and writes finished uint32
// words out[count][width/4]; values at or past `n_valid` are written as 0.
//
// Inputs, all inside one staged byte buffer:
//   tables at `tbase` (4-byte aligned): ends[n_ops] i32 (sorted output
//     ends, padded with out_pad), asrc[n_ops] i32 (literal: payload offset;
//     copy: output-space source base dst_start - offset), offs[n_ops] i32
//     (copy offset, 1 for literals), islit[n_ops] u8;
//   payload at `pbase`: `ppad` bytes of the compressed stream.
//
// What bounds it on the card: the chase's instructions and their latency,
// not bytes.  The bytes it must move (ppad + 13*n_ops read, count*width
// written) take well under a microsecond at 3.35 TB/s.  Each output byte
// finds its op by an upper-bound search over the op ends, in each of up to
// depth+1 chase rounds, and a warp runs until its deepest lane is done.  A
// search over the whole table in global memory is about 13 dependent loads
// of L2 latency each.
//
// What the design does about it:
//  - Each block copies the op tables (at most 13 * 4096 = 53,248 bytes)
//    into shared memory once, with 16-byte cp.async copies of the aligned
//    middle (`ends` first, so the index is built while the rest arrives)
//    and byte copies of the ragged head and tail (the tables are only
//    4-byte aligned in the staged buffer).  A block has 512 threads and the
//    grid at most one block per SM, so each SM copies the tables and builds
//    the index once.
//  - Beside the tables, a coarse index: for each bucket of B = 2^shift
//    output bytes (B chosen by the wrapper so that the index has at most
//    4,096 uint16 entries), upper_bound(ends, bucket start).  The block
//    builds it without any search: op i marks the first bucket at or past
//    ends[i-1] (the last op of a run of ops sharing one bucket writes),
//    then a prefix max over the marks; each thread loads before it
//    stores, so its loads are in flight together.  A lookup of p reads the
//    entries of p's bucket and the next one and finishes with a binary
//    search between them, over the few ops that end inside the bucket.
//    Positions outside the index search the whole table.
//  - A thread takes one value and chases its k bytes (k a template
//    parameter) in straight-line code: selects, no branches, the search's
//    step count the widest range of the warp's lanes, so the k chains'
//    loads are in flight together and the warp leaves when none of its
//    bytes is pending.  A copy's floor modulo is a float quotient,
//    corrected by one either way: exact while the position lies less than
//    2^16 bytes into its op (a snappy copy is at most 64 bytes); anything
//    else takes an exact integer path.
//  - A warp takes 32 consecutive values at a time; the groups of 32 are
//    dealt round-robin over the blocks, so that a region of the output
//    with deep copy chains is spread over the SMs instead of setting one
//    block's time.
//
// Bit for bit what the reference computes, including its edge rules: the
// byte position clamps to out_pad - 1; the op index is the upper bound
// over the padded ends, clamped to n_ops - 1; a copy re-enters at asrc +
// within mod max(offs, 1) (floor modulo); a lane whose chain does not end
// within depth + 1 rounds reads payload byte 0; the payload index clamps to
// ppad - 1 and to the staged buffer's length; the bias add is a uint64 add.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a shared-memory size
// that does not fit the tables and index) so the wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxOps = 4096;          // FUSED_MAX_OPS
constexpr int kIndexEntries = 4096;    // coarse index entries, buckets + 1
constexpr int kOpsPerThread = kMaxOps / kThreads;
constexpr int kEntriesPerThread = kIndexEntries / kThreads;

// shared memory: the raw table bytes (at their address modulo 16), then the
// index, then 32 ints of scan scratch
__host__ __device__ constexpr long long raw_bytes(int n_ops) {
  return (13LL * n_ops + 31) & ~15LL;
}

__host__ __device__ constexpr long long index_bytes(int entries) {
  return (2LL * entries + 15) & ~15LL;
}

__host__ __device__ constexpr long long smem_need(int n_ops, int entries) {
  return raw_bytes(n_ops) + index_bytes(entries) + 32 * 4;
}

constexpr int kMaxSmem = (int)smem_need(kMaxOps, kIndexEntries);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// the first bucket whose start is at or past e (no overflow: e < 2^31 and
// a bucket is at most 2^30 bytes)
__device__ __forceinline__ unsigned first_bucket(int e, int shift) {
  return e <= 0 ? 0u : ((unsigned)e + (1u << shift) - 1u) >> shift;
}

template <int K>
__global__ void __launch_bounds__(kThreads) tpq_fused_narrow_kernel(
    const uint8_t* __restrict__ buf, long long buf_len, long long tbase,
    long long pbase, int n_ops, long long ppad, unsigned long long bias,
    long long n_valid, int width, int depth, long long out_pad, int shift,
    long long count, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;

  // 1. the tables, byte j of them at smem[head + j]
  const uintptr_t g0 = reinterpret_cast<uintptr_t>(buf + tbase);
  const uintptr_t g1 = g0 + 13 * (uintptr_t)n_ops;
  const uintptr_t gbase = g0 & ~(uintptr_t)15;
  const uintptr_t a0 = (g0 + 15) & ~(uintptr_t)15;
  const uintptr_t a1 = g1 & ~(uintptr_t)15;
  // two groups of 16-byte copies: the chunks that hold `ends` first, so
  // the index can be built while the other tables are still arriving
  uintptr_t split = (g0 + 4 * (uintptr_t)n_ops + 15) & ~(uintptr_t)15;
  split = split < a0 ? a0 : (split > a1 ? a1 : split);
  for (uintptr_t a = a0 + 16 * (uintptr_t)tid; a < split; a += 16 * kThreads)
    cp_async16(smem + (a - gbase), reinterpret_cast<const void*>(a));
  asm volatile("cp.async.commit_group;\n" ::);
  for (uintptr_t a = split + 16 * (uintptr_t)tid; a < a1;
       a += 16 * kThreads)
    cp_async16(smem + (a - gbase), reinterpret_cast<const void*>(a));
  asm volatile("cp.async.commit_group;\n" ::);
  // the ragged head and tail byte by byte (all of it for a short table)
  const uintptr_t h1 = a0 < a1 ? a0 : g1, t0 = a0 < a1 ? a1 : g1;
  for (uintptr_t a = g0 + tid; a < h1; a += kThreads)
    smem[a - gbase] = *reinterpret_cast<const uint8_t*>(a);
  for (uintptr_t a = t0 + tid; a < g1; a += kThreads)
    smem[a - gbase] = *reinterpret_cast<const uint8_t*>(a);
  const int32_t* ends = reinterpret_cast<const int32_t*>(smem + (g0 - gbase));
  const int32_t* asrc = ends + n_ops;
  const int32_t* offs = asrc + n_ops;
  const uint8_t* islit = reinterpret_cast<const uint8_t*>(offs + n_ops);

  // 2. the coarse index: index[b] = upper_bound(ends, b << shift)
  const int nb = (int)((out_pad + (1LL << shift) - 1) >> shift);
  const int entries = nb + 1;
  uint16_t* index = reinterpret_cast<uint16_t*>(smem + raw_bytes(n_ops));
  int* scratch = reinterpret_cast<int*>(smem + raw_bytes(n_ops) +
                                        index_bytes(entries));
  for (int o = 16 * tid; o < index_bytes(entries); o += 16 * kThreads)
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(index) + o) =
        make_uint4(0u, 0u, 0u, 0u);
  asm volatile("cp.async.wait_group 1;\n" ::);
  __syncthreads();
  // op i (1-based slot) marks the first bucket at or past ends[i-1]; of the
  // ops sharing that bucket, the last writes.  All loads before any store.
  {
    unsigned f[kOpsPerThread], fn[kOpsPerThread];
#pragma unroll
    for (int j = 0; j < kOpsPerThread; ++j) {
      const int i = 1 + tid + j * kThreads;
      f[j] = i <= n_ops ? first_bucket(ends[i - 1], shift) : 0xFFFFFFFFu;
      fn[j] = i < n_ops ? first_bucket(ends[i], shift) : 0xFFFFFFFFu;
    }
#pragma unroll
    for (int j = 0; j < kOpsPerThread; ++j) {
      if (f[j] < (unsigned)entries && f[j] != fn[j])
        index[f[j]] = (uint16_t)(1 + tid + j * kThreads);
    }
  }
  __syncthreads();
  // prefix max over the marks: a run of entries per thread in registers,
  // then across lanes and warps
  {
    const int per = (entries + kThreads - 1) / kThreads;
    const int e0 = tid * per;
    int vals[kEntriesPerThread];
    int run = 0;
#pragma unroll
    for (int j = 0; j < kEntriesPerThread; ++j) {
      vals[j] = j < per && e0 + j < entries ? (int)index[e0 + j] : 0;
      run = max(run, vals[j]);
    }
    const int lane = tid & 31, warp = tid >> 5;
    int incl = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = max(incl, up);
    }
    if (lane == 31) scratch[warp] = incl;
    __syncthreads();
    int carry = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) carry = 0;
    for (int w = 0; w < warp; ++w) carry = max(carry, scratch[w]);
#pragma unroll
    for (int j = 0; j < kEntriesPerThread; ++j) {
      carry = max(carry, vals[j]);
      if (j < per && e0 + j < entries) index[e0 + j] = (uint16_t)carry;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 3. the chase, one value per thread, its k bytes side by side
  const unsigned covered = (unsigned)nb << shift;
  const uint8_t* payload = buf + pbase;
  long long plimit = buf_len - pbase;
  if (ppad < plimit) plimit = ppad;
  // groups of 32 values, one per warp at a time, dealt round-robin over
  // the blocks: the deep copy chains of a stream cluster in regions of the
  // output, and dealing spreads each region over the SMs
  const long long groups = count >> 5;
  for (long long g = blockIdx.x + (long long)(tid >> 5) * gridDim.x;
       g < groups; g += (long long)gridDim.x * (kThreads >> 5)) {
    const long long v = (g << 5) + (tid & 31);
    int p[K], src[K];
    unsigned pending = v < n_valid ? (1u << K) - 1u : 0u;
#pragma unroll
    for (int b = 0; b < K; ++b) {
      const long long q = v * K + b;
      p[b] = (int)(q < out_pad - 1 ? q : out_pad - 1);
      src[b] = 0;
    }
    // every step below is straight-line over the k bytes (selects, no
    // branches), so their loads are in flight together; the warp leaves
    // the loop together when none of its bytes is pending
    for (int round = 0; round <= depth && __any_sync(0xffffffffu, pending);
         ++round) {
      int lo[K], hi[K];
      unsigned span = 0;
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const bool in = (unsigned)p[b] < covered;
        const int bk = in ? p[b] >> shift : 0;
        lo[b] = in ? (int)index[bk] : 0;
        hi[b] = in ? (int)index[bk + 1] : n_ops;
        if ((pending >> b) & 1u) span = max(span, (unsigned)(hi[b] - lo[b]));
      }
      // the search steps the widest range in the warp needs
      const int steps = 32 - __clz(__reduce_max_sync(0xffffffffu, span));
      for (int s = 0; s < steps; ++s) {
#pragma unroll
        for (int b = 0; b < K; ++b) {
          const int mid = (lo[b] + hi[b]) >> 1;
          const bool go = lo[b] < hi[b];
          const bool right = ends[mid] <= p[b];
          lo[b] = go && right ? mid + 1 : lo[b];
          hi[b] = go && !right ? mid : hi[b];
        }
      }
      unsigned slow = 0;
      int a[K], within[K], m[K];
#pragma unroll
      for (int b = 0; b < K; ++b) {
        const int op = lo[b] < n_ops - 1 ? lo[b] : n_ops - 1;
        const int start = ends[op > 0 ? op - 1 : 0];
        within[b] = p[b] - (op > 0 ? start : 0);
        a[b] = asrc[op];
        const bool lit = islit[op] != 0;
        m[b] = max(offs[op], 1);
        const bool live = (pending >> b) & 1u;
        // floor modulo from a float quotient, off by at most one and
        // corrected: exact for 0 <= within < 2^16 (a snappy copy is at
        // most 64 bytes); anything else takes the exact path below
        const int q = (int)__fdividef((float)within[b], (float)m[b]);
        int r = within[b] - q * m[b];
        r += r < 0 ? m[b] : 0;
        r -= r >= m[b] ? m[b] : 0;
        src[b] = live && lit ? a[b] + within[b] : src[b];
        p[b] = live && !lit ? a[b] + r : p[b];
        slow |= (live && !lit && (unsigned)within[b] >= 65536u) ? 1u << b
                                                                 : 0u;
        pending &= live && lit ? ~(1u << b) : ~0u;
      }
      if (slow) {
#pragma unroll
        for (int b = 0; b < K; ++b) {
          if ((slow >> b) & 1u) {
            int r = within[b] % m[b];
            if (r < 0) r += m[b];
            p[b] = a[b] + r;
          }
        }
      }
    }
    unsigned long long u = 0ull;
    if (v < n_valid) {
#pragma unroll
      for (int b = 0; b < K; ++b) {
        long long idx = src[b] < 0 ? 0 : (long long)src[b];
        if (idx > plimit - 1) idx = plimit - 1;
        u |= (unsigned long long)__ldg(payload + idx) << (8 * b);
      }
      u += bias;
    }
    if (width == 8) {
      reinterpret_cast<uint2*>(out)[v] =
          make_uint2((uint32_t)(u & 0xFFFFFFFFull), (uint32_t)(u >> 32));
    } else {
      out[v] = (uint32_t)(u & 0xFFFFFFFFull);
    }
  }
}

template <int K>
int launch(const uint8_t* buf, long long buf_len, long long tbase,
           long long pbase, int n_ops, long long ppad,
           unsigned long long bias, long long n_valid, int width, int depth,
           long long out_pad, int shift, long long count, int smem, int grid,
           uint32_t* out, cudaStream_t stream) {
  // above 48 KB a block's dynamic shared memory must be allowed first; the
  // most any launch asks for, once per device
  static bool allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(tpq_fused_narrow_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  tpq_fused_narrow_kernel<K><<<grid, kThreads, smem, stream>>>(
      buf, buf_len, tbase, pbase, n_ops, ppad, bias, n_valid, width, depth,
      out_pad, shift, count, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tpq_fused_narrow_words(
    const void* buf, long long buf_len, long long tbase, long long pbase,
    int n_ops, long long ppad, unsigned long long bias, long long n_valid,
    int k, int width, int depth, long long out_pad, long long count,
    int shift, int smem, int grid, void* out, void* stream) {
  if (count <= 0) return 0;
  if (n_ops <= 0 || n_ops > kMaxOps || shift < 0 || shift > 30 ||
      grid <= 0 || out_pad <= 0 || count % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const long long entries = ((out_pad + (1LL << shift) - 1) >> shift) + 1;
  if (entries > kIndexEntries || smem < smem_need(n_ops, (int)entries) ||
      smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const uint8_t* b = static_cast<const uint8_t*>(buf);
  uint32_t* o = static_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define TPQ_K3_CASE(KK)                                                     \
  case KK:                                                                  \
    return launch<KK>(b, buf_len, tbase, pbase, n_ops, ppad, bias, n_valid, \
                      width, depth, out_pad, shift, count, smem, grid, o, s);
    TPQ_K3_CASE(1) TPQ_K3_CASE(2) TPQ_K3_CASE(3) TPQ_K3_CASE(4)
    TPQ_K3_CASE(5) TPQ_K3_CASE(6) TPQ_K3_CASE(7) TPQ_K3_CASE(8)
#undef TPQ_K3_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
