// The interlevel feature-propagation skip: selection, gather and weighting
// in one kernel — kernel 3.
//
// Replaces: threepu/ops/interlevel_pallas.py — the fused kernel
// `_make_kernel` (`_interlevel_call`, levels 2-3) AND the selection kernel
// `_make_select_kernel` (`interlevel_select_pallas`) with its XLA tail
// `_interp_from_selection` (level 4).  The TPU needed two kernels because
// the previous set's features outgrew VMEM at level 4; here the features
// stay in device memory and only coordinates are staged, so one kernel
// serves every level, and prev_group == 1 as well.
//
// Computes, for sub-patch b (top patch p = b / group) and each of its N
// points q: the K nearest previous points of top patch p by squared
// distance (direct subtraction), previous points flagged in prev_dup
// ranked at 1e30, order (rank, index); then with the true distances d_s,
// the feature distances d_f = |xq - f|^2 of the K gathered feature rows,
// h_s / h_f = mean over the sub-patch's N points of the min over K,
// w = exp(-d_s / (h_s / 2)) * exp(-d_f / (h_f / 2)), w /= sum(w + 1e-5),
// out[b, q, :] = sum_k w_k f_k.  Features stay float32.
//
// What bounds it on the H100: the selection.  At level 4 (B = 320
// sub-patches, N = 312, M = 6240) that is 623 M candidate distances, each
// ~12 instructions including the compare against the running top-K;
// the gather moves only B * N * K * C * 4 B = 527 MB (C = 264) of feature
// rows, mostly from L2 (the previous features, 53 MB, are shared by the 40
// sub-patches of a top patch).
//
// Design: one block per sub-patch, one thread per query point (N <= 1024).
//   1. Selection.  The block stages the top patch's previous coordinates
//      and duplicate flags through shared memory in tiles of 2048 points
//      (float4, 32 KB); every thread scans each tile (a broadcast read)
//      and keeps a register-resident sorted top-K of (rank, index, true
//      distance).  A candidate enters only if strictly below the current
//      K-th rank and bubbles up only past strictly larger ranks; indices
//      are scanned in increasing order, so ties keep the lowest index.
//   2. Feature distances: one warp per query, lanes across the C channels
//      (coalesced rows), warp-shuffle sums.
//   3. h_s and h_f: block reductions over the N queries.
//   4. Weights and output: one warp per query, lanes across C.
// The library is built with -fmad=false, so the squared distances round
// exactly as the plain PyTorch version computes them and selections match
// it bit for bit; sums over C and over the queries run in another order
// than PyTorch's, so output values agree to float32 rounding.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kTile = 2048;
constexpr float kPenalty = 1e30f;

template <int K>
__global__ void __launch_bounds__(1024)
interlevel_kernel(const float* __restrict__ q_xyz, const float* __restrict__ xq,
                  const float* __restrict__ prev_xyz,
                  const float* __restrict__ prev_feat,
                  const uint8_t* __restrict__ prev_dup, float* __restrict__ out,
                  int* __restrict__ idx_out, int n, int group, int m, int c) {
  extern __shared__ float4 smem4[];
  float4* tile = smem4;                                        // kTile
  int* s_idx = reinterpret_cast<int*>(smem4 + kTile);          // n * K
  float* s_ds = reinterpret_cast<float*>(s_idx + n * K);       // n * K
  float* s_fd = s_ds + n * K;                                  // n * K
  float* s_red = s_fd + n * K;                                 // 2 * 32 + 2

  const int bsub = blockIdx.x;
  const int p = bsub / group;
  const float* pxyz = prev_xyz + static_cast<size_t>(p) * m * 3;
  const uint8_t* pdup = prev_dup + static_cast<size_t>(p) * m;
  const float* pfeat = prev_feat + static_cast<size_t>(p) * m * c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const bool has_q = tid < n;

  // ---- 1. selection --------------------------------------------------
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (has_q) {
    const float* qp = q_xyz + (static_cast<size_t>(bsub) * n + tid) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float rank[K], dist[K];
  int idx[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    rank[s] = INFINITY;
    dist[s] = 0.f;
    idx[s] = 0;
  }
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    __syncthreads();  // the previous tile is consumed
    for (int j = tid; j < cnt; j += blockDim.x) {
      const float* pp = pxyz + static_cast<size_t>(base + j) * 3;
      tile[j] = make_float4(pp[0], pp[1], pp[2], pdup[base + j] ? 1.f : 0.f);
    }
    __syncthreads();
    if (!has_q) continue;
    for (int j = 0; j < cnt; ++j) {
      const float4 e = tile[j];
      const float d = threepu::sq_dist3(qx, qy, qz, e.x, e.y, e.z);
      const float r = e.w != 0.f ? kPenalty : d;
      if (r < rank[K - 1]) {
        rank[K - 1] = r;
        dist[K - 1] = d;
        idx[K - 1] = base + j;
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (rank[s] < rank[s - 1]) {
            const float tr = rank[s], td = dist[s];
            const int ti = idx[s];
            rank[s] = rank[s - 1];
            dist[s] = dist[s - 1];
            idx[s] = idx[s - 1];
            rank[s - 1] = tr;
            dist[s - 1] = td;
            idx[s - 1] = ti;
          }
        }
      }
    }
  }
  float min_ds = INFINITY;
  if (has_q) {
    int* qo = idx_out + (static_cast<size_t>(bsub) * n + tid) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      qo[s] = idx[s];
      s_idx[tid * K + s] = idx[s];
      s_ds[tid * K + s] = dist[s];
      min_ds = fminf(min_ds, dist[s]);
    }
  }
  __syncthreads();

  // ---- 2. feature distances, one warp per query ------------------------
  for (int q = warp; q < n; q += nwarps) {
    const float* xrow = xq + (static_cast<size_t>(bsub) * n + q) * c;
    const int* qi = s_idx + q * K;
    float acc[K];
#pragma unroll
    for (int s = 0; s < K; ++s) acc[s] = 0.f;
    for (int ch = lane; ch < c; ch += 32) {
      const float xv = xrow[ch];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float df = xv - pfeat[static_cast<size_t>(qi[s]) * c + ch];
        acc[s] += df * df;
      }
    }
#pragma unroll
    for (int s = 0; s < K; ++s) acc[s] = threepu::warp_sum(acc[s]);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < K; ++s) s_fd[q * K + s] = acc[s];
    }
  }
  __syncthreads();

  // ---- 3. h = mean over the queries of the min over K ------------------
  float min_fd = 0.f;
  if (has_q) {
    min_fd = INFINITY;
#pragma unroll
    for (int s = 0; s < K; ++s) min_fd = fminf(min_fd, s_fd[tid * K + s]);
  } else {
    min_ds = 0.f;
  }
  min_ds = threepu::warp_sum(min_ds);
  min_fd = threepu::warp_sum(min_fd);
  if (lane == 0) {
    s_red[warp] = min_ds;
    s_red[32 + warp] = min_fd;
  }
  __syncthreads();
  if (warp == 0) {
    float a = lane < nwarps ? s_red[lane] : 0.f;
    float f = lane < nwarps ? s_red[32 + lane] : 0.f;
    a = threepu::warp_sum(a);
    f = threepu::warp_sum(f);
    if (lane == 0) {
      s_red[64] = a / static_cast<float>(n);
      s_red[65] = f / static_cast<float>(n);
    }
  }
  __syncthreads();
  const float half_hs = s_red[64] / 2.0f;
  const float half_hf = s_red[65] / 2.0f;

  // ---- 4. weights and output, one warp per query ----------------------
  for (int q = warp; q < n; q += nwarps) {
    const int* qi = s_idx + q * K;
    float w[K];
    float denom = 0.f;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      w[s] = expf(-s_ds[q * K + s] / half_hs) * expf(-s_fd[q * K + s] / half_hf);
      denom += w[s] + 1e-5f;
    }
#pragma unroll
    for (int s = 0; s < K; ++s) w[s] = w[s] / denom;
    float* orow = out + (static_cast<size_t>(bsub) * n + q) * c;
    for (int ch = lane; ch < c; ch += 32) {
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < K; ++s)
        acc += w[s] * pfeat[static_cast<size_t>(qi[s]) * c + ch];
      orow[ch] = acc;
    }
  }
}

template <int K>
int launch(const float* q_xyz, const float* xq, const float* prev_xyz,
           const float* prev_feat, const uint8_t* prev_dup, float* out,
           int* idx_out, int b, int n, int p, int m, int c,
           cudaStream_t stream) {
  const int threads = (n + 31) / 32 * 32;
  const size_t smem = kTile * sizeof(float4) +
                      3 * static_cast<size_t>(n) * K * sizeof(float) +
                      (2 * 32 + 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      interlevel_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  interlevel_kernel<K><<<b, threads, smem, stream>>>(
      q_xyz, xq, prev_xyz, prev_feat, prev_dup, out, idx_out, n, b / p, m, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_xyz (b, n, 3), xq (b, n, c), prev_xyz (p, m, 3), prev_feat (p, m, c)
// float32, prev_dup (p, m) uint8 -> out (b, n, c) float32 and the picks
// idx_out (b, n, k) int32, in rank order.  Needs p | b,
// 1 <= n <= 1024, 1 <= k <= min(m, 8) (the wrapper checks them).
extern "C" int threepu_interlevel(const float* q_xyz, const float* xq,
                                  const float* prev_xyz, const float* prev_feat,
                                  const uint8_t* prev_dup, float* out,
                                  int* idx_out, int b, int n, int p, int m,
                                  int c, int k, cudaStream_t stream) {
  switch (k) {
#define THREEPU_K(K) \
  case K:            \
    return launch<K>(q_xyz, xq, prev_xyz, prev_feat, prev_dup, out, idx_out, b, n, p, m, c, \
                     stream);
    THREEPU_K(1) THREEPU_K(2) THREEPU_K(3) THREEPU_K(4)
    THREEPU_K(5) THREEPU_K(6) THREEPU_K(7) THREEPU_K(8)
#undef THREEPU_K
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
