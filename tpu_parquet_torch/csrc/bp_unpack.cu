// K1: BP-group unpack for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tpu_parquet/pallas_kernels.py
// `_unpack_kernel` (reached through `unpack_bp_groups`).  It computes the
// LSB-first fixed-width unpack of `groups` 8-value groups: group g is the
// `width` contiguous bytes at bp_base + g*width, and value j of the group
// starts at bit j*width of them.  Output: uint32[groups * 8].
//
// What bounds it on the card: memory.  It reads groups*width bytes and
// writes groups*32 bytes, with a handful of shifts per value; at any width
// it is far below the H100's operations-per-byte balance point, so the
// least time is (groups*width + groups*32) / 3.35 TB/s.
//
// What the design does about that: one thread per group.  Neighbouring
// threads read neighbouring `width`-byte rows (the loads of a warp fall in
// a few cache lines, so each byte crosses the memory bus once), and each
// thread writes its 8 values as two 16-byte stores, so a warp's stores are
// one contiguous 1 KiB span.  The TPU kernel's byte-plane transpose works
// around a Mosaic miscompile and is not carried over: the natural
// (groups, width) rows are read directly.  The base may be any byte
// offset, so rows are read as bytes; every byte past `buf_len` reads as 0
// (CUDA does not clamp a read past the buffer the way the TPU does).
//
// Launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

static __device__ __forceinline__ uint64_t load_byte(
    const uint8_t* __restrict__ buf, long long buf_len, long long i) {
  return i < buf_len ? (uint64_t)__ldg(buf + i) : 0ull;
}

__global__ void tpq_unpack_bp_groups_kernel(const uint8_t* __restrict__ buf,
                                            long long buf_len,
                                            long long bp_base, int width,
                                            long long groups,
                                            uint32_t* __restrict__ out) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const long long row = bp_base + g * (long long)width;
  const uint32_t mask = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  uint32_t v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bit = j * width;
    const long long b0 = row + (bit >> 3);
    const int shift = bit & 7;
    const int nbytes = (shift + width + 7) >> 3;  // 1..5 bytes cover the field
    uint64_t acc = 0;
    for (int k = 0; k < nbytes; ++k) {
      acc |= load_byte(buf, buf_len, b0 + k) << (8 * k);
    }
    v[j] = (uint32_t)(acc >> shift) & mask;
  }
  uint4* o = reinterpret_cast<uint4*>(out + g * 8);
  o[0] = make_uint4(v[0], v[1], v[2], v[3]);
  o[1] = make_uint4(v[4], v[5], v[6], v[7]);
}

extern "C" int tpq_unpack_bp_groups(const void* buf, long long buf_len,
                                    long long bp_base, int width,
                                    long long groups, void* out,
                                    void* stream) {
  if (groups <= 0) return 0;
  const int threads = 256;
  const long long blocks = (groups + threads - 1) / threads;
  tpq_unpack_bp_groups_kernel<<<(unsigned int)blocks, threads, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)buf, buf_len, bp_base, width, groups, (uint32_t*)out);
  return (int)cudaGetLastError();
}
