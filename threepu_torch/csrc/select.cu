// Exact k smallest values per row, ordered by (value, index) — kernel 1.
//
// Replaces: threepu/ops/select_pallas.py, `_make_kernel` / `select_pallas`
// (k lexicographic-min sweeps over a VMEM-resident (M, N) block).  On the
// main path it serves the feature-space kNN of every DenseEdgeConv:
// d (B, 312, 312) with B = 8..320 and k = 33 (99,840 rows at level 4).
//
// What bounds it on the H100: not memory — a row of 312 floats is read
// from device memory once (125 MB at level 4, ~40 us at 3.35 TB/s) — but
// the k sweeps over it: k * N compares per row plus a 5-step warp
// shuffle reduction per sweep, i.e. issue rate on the SMs.
//
// Design: one warp per row, 8 rows per block.  The warp stages its row in
// shared memory (when 8 rows fit in 48 KB, i.e. N <= 1536; longer rows are
// read through L1/L2), then runs k sweeps.  Each sweep takes, per lane,
// the lexicographically smallest (value, index) among the columns that
// rank strictly after the previous pick, then a warp-shuffle
// lexicographic min.  Exactly the Pallas kernel's exclusion rule
// (`select_pallas.py:87-94`), so ties go to the lowest index and values
// are copied verbatim: the result equals a stable ascending sort's first
// k columns bit for bit, including rows with fewer than k unpenalized
// columns.  Rows must hold no NaN.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr size_t kMaxStagedBytes = 48 * 1024;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
select_kernel(const float* __restrict__ d, float* __restrict__ out_v,
              int* __restrict__ out_i, int rows, int n, int k, bool staged) {
  extern __shared__ float rows_smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // whole warp; only warp-level sync below

  const float* src = d + static_cast<size_t>(row) * n;
  const float* r = src;
  if (staged) {
    float* buf = rows_smem + static_cast<size_t>(warp) * n;
    for (int j = lane; j < n; j += 32) buf[j] = src[j];
    __syncwarp();
    r = buf;
  }

  float prev_v = -INFINITY;
  int prev_i = -1;
  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  for (int s = 0; s < k; ++s) {
    float best_v = INFINITY;
    int best_i = INT_MAX;
    for (int j = lane; j < n; j += 32) {
      const float v = r[j];
      const bool later = v > prev_v || (v == prev_v && j > prev_i);
      if (later && threepu::lex_less(v, j, best_v, best_i)) {
        best_v = v;
        best_i = j;
      }
    }
    threepu::warp_lex_min(best_v, best_i);
    if (lane == 0) {
      ov[s] = best_v;
      oi[s] = best_i;
    }
    prev_v = best_v;
    prev_i = best_i;
  }
}

}  // namespace

// d (rows, n) float32 -> out_v (rows, k) float32, out_i (rows, k) int32.
// Needs 1 <= k <= n (the wrapper checks it).
extern "C" int threepu_select(const float* d, float* out_v, int* out_i,
                              int rows, int n, int k, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * n * sizeof(float);
  const bool staged = smem <= kMaxStagedBytes;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  select_kernel<<<blocks, kWarpsPerBlock * 32, staged ? smem : 0, stream>>>(
      d, out_v, out_i, rows, n, k, staged);
  return static_cast<int>(cudaGetLastError());
}
