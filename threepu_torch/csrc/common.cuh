// Shared helpers of the threepu_torch kernels.
//
// Every kernel file exports one `extern "C"` entry point that launches on
// the stream it is given, allocates nothing, and returns the
// cudaError_t of the launch (cudaGetLastError right after it), which
// threepu_torch/_build.py turns into a Python exception.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace threepu {

constexpr unsigned kFullMask = 0xffffffffu;

// The bits of a float as an unsigned integer in the float's order: -0
// reads as +0, which compares equal to it.  Not for NaN.
__device__ __forceinline__ unsigned ordered_bits(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The largest key over the warp, ties to the lowest index i: two
// redux.sync, and every lane gets both.
__device__ __forceinline__ void warp_argmax(unsigned& key, unsigned& i) {
  const unsigned best = __reduce_max_sync(kFullMask, key);
  i = __reduce_min_sync(kFullMask, key == best ? i : ~0u);
  key = best;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFullMask, v, off);
  return v;
}

// Squared 3-D distance, rounded as (dx*dx + dy*dy) + dz*dz with no fused
// multiply-add (the library is built with -fmad=false): the plain PyTorch
// versions compute it in the same order.
__device__ __forceinline__ float sq_dist3(float ax, float ay, float az,
                                          float bx, float by, float bz) {
  float dx = ax - bx, dy = ay - by, dz = az - bz;
  return dx * dx + dy * dy + dz * dz;
}

}  // namespace threepu
