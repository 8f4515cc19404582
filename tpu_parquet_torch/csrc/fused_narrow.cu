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
// What bounds it on the card: the op search.  Each output byte runs an
// upper-bound binary search over the op ends (about log2(n_ops) = 12 steps
// at 4096 ops) in each of up to depth+1 chase rounds, each step a dependent
// load; the bytes it must move are only ppad + 13*n_ops read and
// count*width written, which at 3.35 TB/s is a few microseconds.
//
// What this simple design does about it: one thread per output value (256
// threads per block), the k bytes of a value chased in that thread, so the
// bias add needs no cross-thread step.  A chase stops at its literal, so a
// byte pays only its own chain's rounds.  The tables (at most 13 * 4096 =
// 53,248 bytes) stay in global memory behind __ldg: every block reads the
// same few tens of kilobytes, which stay L2-resident.  Staging them in
// shared memory is left to a later redesign.
//
// Bit for bit what the reference computes, including its edge rules: the
// byte position clamps to out_pad - 1; the op index clamps to n_ops - 1;
// a copy re-enters at asrc + within mod max(offs, 1) (floor modulo); a lane
// whose chain does not end within depth + 1 rounds reads payload byte 0;
// the payload index clamps to ppad - 1 and to the staged buffer's length.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void tpq_fused_narrow_kernel(
    const uint8_t* __restrict__ buf, long long buf_len, long long tbase,
    long long pbase, int n_ops, long long ppad, unsigned long long bias,
    long long n_valid, int k, int width, int depth, long long out_pad,
    long long count, uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  unsigned long long u = 0ull;
  if (i < n_valid) {
    const int32_t* ends = reinterpret_cast<const int32_t*>(buf + tbase);
    const int32_t* asrc = ends + n_ops;
    const int32_t* offs = asrc + n_ops;
    const uint8_t* islit = reinterpret_cast<const uint8_t*>(offs + n_ops);
    const uint8_t* payload = buf + pbase;
    long long plimit = buf_len - pbase;
    if (ppad < plimit) plimit = ppad;
    for (int b = 0; b < k; ++b) {
      long long q = i * k + b;
      if (q > out_pad - 1) q = out_pad - 1;
      int p = (int)q;
      int src = 0;
      for (int round = 0; round <= depth; ++round) {
        // upper bound: the first op whose end is past p
        int lo = 0, hi = n_ops;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldg(ends + mid) <= p) lo = mid + 1; else hi = mid;
        }
        const int op = lo < n_ops - 1 ? lo : n_ops - 1;
        const int start = op > 0 ? __ldg(ends + op - 1) : 0;
        const int within = p - start;
        const int a = __ldg(asrc + op);
        if (__ldg(islit + op) != 0) {
          src = a + within;
          break;
        }
        int m = __ldg(offs + op);
        if (m < 1) m = 1;
        int r = within % m;
        if (r < 0) r += m;
        p = a + r;
      }
      long long idx = src < 0 ? 0 : (long long)src;
      if (idx > plimit - 1) idx = plimit - 1;
      u |= (unsigned long long)__ldg(payload + idx) << (8 * b);
    }
    u += bias;
  }
  if (width == 8) {
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2((uint32_t)(u & 0xFFFFFFFFull), (uint32_t)(u >> 32));
  } else {
    out[i] = (uint32_t)(u & 0xFFFFFFFFull);
  }
}

extern "C" int tpq_fused_narrow_words(
    const void* buf, long long buf_len, long long tbase, long long pbase,
    int n_ops, long long ppad, unsigned long long bias, long long n_valid,
    int k, int width, int depth, long long out_pad, long long count,
    void* out, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  tpq_fused_narrow_kernel<<<(unsigned int)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
      (const uint8_t*)buf, buf_len, tbase, pbase, n_ops, ppad, bias, n_valid,
      k, width, depth, out_pad, count, (uint32_t*)out);
  return (int)cudaGetLastError();
}
