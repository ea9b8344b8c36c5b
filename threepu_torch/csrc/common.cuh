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

// (value, index) pair ordered by value, then by index.
__device__ __forceinline__ bool lex_less(float av, int ai, float bv, int bi) {
  return av < bv || (av == bv && ai < bi);
}

// Lexicographic min of (v, i) over the warp; every lane gets the result.
__device__ __forceinline__ void warp_lex_min(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFullMask, v, off);
    int oi = __shfl_xor_sync(kFullMask, i, off);
    if (lex_less(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Max of v over the warp, ties to the lowest index i; every lane gets it.
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    float ov = __shfl_xor_sync(kFullMask, v, off);
    int oi = __shfl_xor_sync(kFullMask, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
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
