// The DenseEdgeConv activation chain, fused and forward-only — kernel 6.
//
//   zn      = z[b, idx[b, p, j], :]                       (gather, exact)
//   g_0     = relu(zn + pt_0[b, p])
//   g_i     = [relu](sum_{jj < i} g_{i-1-jj} @ W_{i,jj} + pt_i[b, p])
//             for i = 1 .. n-1, no relu on the last stage when n > 1
//   out[b, p] = [max_j g_{n-1}, ..., max_j g_0]           (n * G channels)
//
// Replaces: threepu/ops/edgeconv_pallas.py, `_make_kernel` /
// `edge_conv_chain_pallas` (a bf16 one-hot matmul gather with a hi/lo split,
// the chain on (TP*k, G) tiles padded to 128 lanes, a roll-tree max, batch
// segments of 40).  None of that is carried over: a thread reads the
// neighbour's row of z by its index.  On the main path it serves the 16 edge
// convs of every 8-patch chunk of the 16x eval pipeline: B = 8, 80, 160, 320
// sub-patches of N = 312 points, k = 32, G = 12, n = 3.
//
// What bounds it on the H100: operations.  Each neighbour costs
// 2 * G * G * n(n-1)/2 + 3 * n * G float operations (864 + 108 at G = 12,
// n = 3); at B = 320 that is 3.1 GFLOP, 0.046 ms at the 67 TFLOP/s fp32 peak,
// against 46 MB of inputs and output (0.014 ms at 3.35 TB/s).  The
// (B, N, k, G) tensors of the plain version, 153 MB each, never exist.
//
// Design: one warp per point, lanes stride over the k neighbours (k = 32: one
// lane each).  A lane gathers its neighbour's G floats of z (float4 loads
// where G is a multiple of 4 and the arrays are 16-byte aligned), keeps the
// n stage vectors and a running max per output channel in registers, and reads
// the n(n-1)/2 weight blocks from shared memory, where the block loaded them
// once, zero-padded to GP x GP (a broadcast read: every lane wants the same
// weight).  The products are fused multiply-adds over the source channel, in
// increasing order, block (i, 0) first: the plain version's cuBLAS products
// round the same way up to the order of the sum.  A butterfly of warp shuffles
// finishes the max over neighbours and lane 0 writes the point's n * G
// channels.  A block of 8 warps walks points with a grid stride, so the
// weights are staged once per block.  The kernel is instantiated per stage
// count n = 1..4 and padded width GP in {4, 8, 12, 16, 24, 32}, so that every
// register array has a static size; channels from G up to GP are zeros that
// the sums carry along.  An index outside [0, N) traps.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// blocks per SM that the grid is cut to: enough to even out the tail
constexpr int kBlocksPerSm = 16;

template <int NS, int GP>
__global__ void __launch_bounds__(kThreads)
edgeconv_kernel(const float* __restrict__ z, const int* __restrict__ idx,
                const float* __restrict__ pts, const float* __restrict__ w,
                float* __restrict__ out, long long points, int n_pts, int k,
                int g, bool vec) {
  constexpr int kChain = NS * (NS - 1) / 2;
  constexpr int kQuads = GP / 4;
  __shared__ float4 ws[kChain > 0 ? kChain * GP * kQuads : 1];
  float* wsf = reinterpret_cast<float*>(ws);
  for (int e = threadIdx.x; e < kChain * GP * GP; e += kThreads) {
    const int blk = e / (GP * GP), r = (e / GP) % GP, c = e % GP;
    wsf[e] = (r < g && c < g) ? w[(blk * g + r) * g + c] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long p = static_cast<long long>(blockIdx.x) * kWarps + warp;
       p < points; p += static_cast<long long>(gridDim.x) * kWarps) {
    const long long b = p / n_pts;
    const int i_pt = static_cast<int>(p - b * n_pts);
    const float* zb = z + b * n_pts * g;
    const int* ip = idx + p * k;
    // pt_s of this point: pts is (B, NS, N, G)
    const float* pp = pts + (b * NS * n_pts + i_pt) * g;
    const size_t stage_stride = static_cast<size_t>(n_pts) * g;

    float best[NS][GP];
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < GP; ++c) best[s][c] = -INFINITY;

    for (int j = lane; j < k; j += 32) {
      const int nb = ip[j];
      if (static_cast<unsigned>(nb) >= static_cast<unsigned>(n_pts)) __trap();
      const float* zr = zb + static_cast<size_t>(nb) * g;
      float gs[NS][GP];
      // stage 0: relu(z[nb] + pt_0)
      if (vec) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), t = a;
          if (4 * q < g) {
            a = reinterpret_cast<const float4*>(zr)[q];
            t = reinterpret_cast<const float4*>(pp)[q];
          }
          gs[0][4 * q + 0] = fmaxf(a.x + t.x, 0.f);
          gs[0][4 * q + 1] = fmaxf(a.y + t.y, 0.f);
          gs[0][4 * q + 2] = fmaxf(a.z + t.z, 0.f);
          gs[0][4 * q + 3] = fmaxf(a.w + t.w, 0.f);
        }
      } else {
#pragma unroll
        for (int c = 0; c < GP; ++c)
          gs[0][c] = c < g ? fmaxf(zr[c] + pp[c], 0.f) : 0.f;
      }
      // stages 1 .. NS-1: block (i, jj) multiplies g_{i-1-jj}
      int blk = 0;
#pragma unroll
      for (int i = 1; i < NS; ++i) {
        float y[GP];
#pragma unroll
        for (int c = 0; c < GP; ++c) y[c] = 0.f;
#pragma unroll
        for (int jj = 0; jj < i; ++jj) {
          const float4* wb = ws + blk * GP * kQuads;
#pragma unroll
          for (int r = 0; r < GP; ++r) {
            const float src = gs[i - 1 - jj][r];
#pragma unroll
            for (int q = 0; q < kQuads; ++q) {
              const float4 wv = wb[r * kQuads + q];
              y[4 * q + 0] = fmaf(src, wv.x, y[4 * q + 0]);
              y[4 * q + 1] = fmaf(src, wv.y, y[4 * q + 1]);
              y[4 * q + 2] = fmaf(src, wv.z, y[4 * q + 2]);
              y[4 * q + 3] = fmaf(src, wv.w, y[4 * q + 3]);
            }
          }
          ++blk;
        }
        const float* pi = pp + i * stage_stride;
#pragma unroll
        for (int c = 0; c < GP; ++c) {
          const float v = c < g ? y[c] + pi[c] : 0.f;
          gs[i][c] = i == NS - 1 ? v : fmaxf(v, 0.f);
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s)
#pragma unroll
        for (int c = 0; c < GP; ++c) best[s][c] = fmaxf(best[s][c], gs[s][c]);
    }

    // max over the lanes; lanes beyond k hold -inf
#pragma unroll
    for (int s = 0; s < NS; ++s)
#pragma unroll
      for (int c = 0; c < GP; ++c)
        if (c < g) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            best[s][c] = fmaxf(best[s][c], __shfl_xor_sync(threepu::kFullMask,
                                                           best[s][c], off));
        }

    // out (B, N, NS * G): stage-major, reversed, [g_{NS-1}, ..., g_0]
    if (lane == 0) {
      float* op = out + p * NS * g;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float* os = op + (NS - 1 - s) * g;
        if (vec) {
#pragma unroll
          for (int q = 0; q < kQuads; ++q)
            if (4 * q < g)
              reinterpret_cast<float4*>(os)[q] =
                  make_float4(best[s][4 * q], best[s][4 * q + 1],
                              best[s][4 * q + 2], best[s][4 * q + 3]);
        } else {
#pragma unroll
          for (int c = 0; c < GP; ++c)
            if (c < g) os[c] = best[s][c];
        }
      }
    }
  }
}

template <int NS, int GP>
int launch(const float* z, const int* idx, const float* pts, const float* w,
           float* out, long long points, int n_pts, int k, int g,
           cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (points + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = g % 4 == 0 && aligned(z) && aligned(pts) && aligned(out);
  edgeconv_kernel<NS, GP><<<blocks, kThreads, 0, stream>>>(
      z, idx, pts, w, out, points, n_pts, k, g, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int launch_width(const float* z, const int* idx, const float* pts,
                 const float* w, float* out, long long points, int n_pts,
                 int k, int g, cudaStream_t stream) {
#define THREEPU_EC_WIDTH(GP) \
  if (g <= GP)               \
    return launch<NS, GP>(z, idx, pts, w, out, points, n_pts, k, g, stream);
  THREEPU_EC_WIDTH(4)
  THREEPU_EC_WIDTH(8)
  THREEPU_EC_WIDTH(12)
  THREEPU_EC_WIDTH(16)
  THREEPU_EC_WIDTH(24)
  THREEPU_EC_WIDTH(32)
#undef THREEPU_EC_WIDTH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// z (bsz, n_pts, g) float32, idx (bsz, n_pts, k) int32 in [0, n_pts),
// pts (bsz, n, n_pts, g) float32, w (n(n-1)/2, g, g) float32 (unread when
// n = 1) -> out (bsz, n_pts, n * g) float32.  Needs 1 <= n <= 4,
// 1 <= g <= 32, bsz, n_pts, k >= 1 (the wrapper checks them; another n or g
// returns cudaErrorInvalidValue).
extern "C" int threepu_edge_conv_chain(const float* z, const int* idx,
                                       const float* pts, const float* w,
                                       float* out, int bsz, int n_pts, int k,
                                       int n, int g, cudaStream_t stream) {
  const long long points = static_cast<long long>(bsz) * n_pts;
  switch (n) {
    case 1:
      return launch_width<1>(z, idx, pts, w, out, points, n_pts, k, g, stream);
    case 2:
      return launch_width<2>(z, idx, pts, w, out, points, n_pts, k, g, stream);
    case 3:
      return launch_width<3>(z, idx, pts, w, out, points, n_pts, k, g, stream);
    case 4:
      return launch_width<4>(z, idx, pts, w, out, points, n_pts, k, g, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
