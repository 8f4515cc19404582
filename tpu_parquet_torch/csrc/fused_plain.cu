// K2: fused PLAIN decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_parquet/pallas_kernels.py
// `_fused_plain_kernel` (reached through `fused_plain_words`).  PLAIN 4- or
// 8-byte little-endian values at byte `vbase` of the staged buffer become
// finished uint32 words, out[count][width/4]; rows at or past `n_valid` are
// written as zero (decode and the validity tail in one pass).
//
// What bounds it on the card: memory.  It reads and writes count*width
// bytes and computes nothing but a compare per value, so the least time is
// (2 * count * width) / 3.35 TB/s.
//
// What the design does about that: one thread per value, so a warp reads
// and writes one contiguous span.  `vbase` is an arbitrary byte offset of
// the staged buffer: where the value's address is 4-byte aligned the words
// are read with 4-byte loads, otherwise byte by byte (an unaligned wide
// load faults on the card).  Every byte past `buf_len` reads as 0.  An
// 8-byte value is stored as one 8-byte store.
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint32_t load_word_bytes(
    const uint8_t* __restrict__ buf, long long buf_len, long long p) {
  uint32_t acc = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const long long i = p + b;
    const uint32_t byte = i < buf_len ? (uint32_t)__ldg(buf + i) : 0u;
    acc |= byte << (8 * b);
  }
  return acc;
}

__global__ void tpq_fused_plain_kernel(const uint8_t* __restrict__ buf,
                                       long long buf_len, long long vbase,
                                       int width, long long n_valid,
                                       long long count,
                                       uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int words = width >> 2;
  const long long p = vbase + i * (long long)width;
  uint32_t w0 = 0u, w1 = 0u;
  if (i < n_valid) {
    const bool aligned =
        ((reinterpret_cast<uintptr_t>(buf) + (uintptr_t)p) & 3u) == 0u;
    if (aligned && p + width <= buf_len) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(buf + p);
      w0 = __ldg(q);
      if (words == 2) w1 = __ldg(q + 1);
    } else {
      w0 = load_word_bytes(buf, buf_len, p);
      if (words == 2) w1 = load_word_bytes(buf, buf_len, p + 4);
    }
  }
  if (words == 2) {
    reinterpret_cast<uint2*>(out)[i] = make_uint2(w0, w1);
  } else {
    out[i] = w0;
  }
}

extern "C" int tpq_fused_plain_words(const void* buf, long long buf_len,
                                     long long vbase, int width,
                                     long long n_valid, long long count,
                                     void* out, void* stream) {
  if (count <= 0) return 0;
  const int threads = 256;
  const long long blocks = (count + threads - 1) / threads;
  tpq_fused_plain_kernel<<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)buf, buf_len, vbase, width, n_valid, count,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}
