// One-way nearest neighbour: for each point of a (B, N, 3), the squared
// distance to and the index of its nearest point in b (B, M, 3) — kernel 5.
//
// Replaces: threepu/ops/chamfer_pallas.py, `_nn_kernel` / `nn_one_way_pallas`
// (a query block against the whole reference set in VMEM, swept in
// 2048-point tiles with a running (min, argmin) carry).  On the main path it
// serves the Chamfer loss of the training step: both directions of
// (16, 624) x (16, 624) per step; the quality Chamfer of an 80k output is
// (1, 80000) x (1, 80000).
//
// What bounds it on the H100: operations.  Each candidate pair costs
// 8 float operations (3 subtractions, 3 products, 2 sums; the Pallas cost
// estimate's 8 * B * N * M) plus a compare; at 80k x 80k that is 51 GFLOP,
// 0.77 ms at the 67 TFLOP/s fp32 peak, against 1.6 MB of inputs and
// outputs (under 1 us at 3.35 TB/s).  Nothing but the coordinates and the
// two outputs touches device memory.
//
// Design: one thread per query point, its coordinates in registers;
// 128 threads per block, grid (ceil(N / 128), B).  The block stages the
// reference set of its batch element through shared memory in tiles of
// 2048 points (float4, 32 KB), and every thread sweeps each tile (a
// broadcast read) keeping a running (min, argmin) that takes a later
// candidate only when strictly smaller: candidates arrive in increasing
// index order, so ties keep the lowest index, as the Pallas carry does
// (`chamfer_pallas.py:51-56`) and as torch.min does.  The ragged last
// tile is masked by its count; no padding sentinel exists.  The library
// is built with -fmad=false, so each distance rounds as
// (dx*dx + dy*dy) + dz*dz exactly as the plain PyTorch version computes
// it, and values and indices match it bit for bit.  Inputs are finite.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 2048;

__global__ void __launch_bounds__(kThreads)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ dist, int* __restrict__ idx, int n, int m) {
  __shared__ float4 tile[kTile];
  const int batch = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool has_q = i < n;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (has_q) {
    const float* ap = a + (static_cast<size_t>(batch) * n + i) * 3;
    ax = ap[0];
    ay = ap[1];
    az = ap[2];
  }
  const float* bb = b + static_cast<size_t>(batch) * m * 3;
  float best = INFINITY;
  int best_i = 0;
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      const float* bp = bb + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(bp[0], bp[1], bp[2], 0.f);
    }
    __syncthreads();
    if (!has_q) continue;
#pragma unroll 8
    for (int j = 0; j < cnt; ++j) {
      const float4 e = tile[j];
      const float d = threepu::sq_dist3(ax, ay, az, e.x, e.y, e.z);
      if (d < best) {
        best = d;
        best_i = base + j;
      }
    }
  }
  if (has_q) {
    const size_t o = static_cast<size_t>(batch) * n + i;
    dist[o] = best;
    idx[o] = best_i;
  }
}

}  // namespace

// a (bsz, n, 3), b (bsz, m, 3) float32 -> dist (bsz, n) float32, idx (bsz, n)
// int32.  Needs 1 <= bsz <= 65535, n >= 1, m >= 1 (the wrapper checks them).
extern "C" int threepu_nn_one_way(const float* a, const float* b, float* dist,
                                  int* idx, int bsz, int n, int m,
                                  cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, bsz);
  nn_kernel<<<grid, kThreads, 0, stream>>>(a, b, dist, idx, n, m);
  return static_cast<int>(cudaGetLastError());
}
