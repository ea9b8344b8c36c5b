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
// Design: 16 lanes a point, two neighbours a lane (k <= 32 on the main
// path; a larger k takes rounds of 32), two points a warp.  A lane gathers
// its neighbours' G floats of z (float4 loads where G, the strides and the
// arrays allow), runs the n stages of both in registers, and reads the
// n(n-1)/2 weight blocks from shared memory, where the block staged them
// once, zero-padded to GP x GP: a broadcast float4 that feeds eight fused
// multiply-adds, four for each neighbour (with one neighbour a lane a read
// fed four, and the kernel was 1.2x slower at B = 320: PERF.md).  Each
// block's products are fused multiply-adds over the source channel, in
// increasing order from zero, and the blocks' sums are added in block
// order, (i, 0) first, then the point term: the order in which the plain
// version's cuBLAS products and its adds round, so that a later conv's kNN
// sees the plain version's features and flips none of its near-ties
// (PERF.md).  The stage vectors are the lane's candidates for the max
// themselves, so no running max is kept (a round of a larger k folds its
// result into the few channels the lane ends with).
// The max over the neighbours is a reduce-scatter: at each of four xor
// steps a lane keeps half of its channels and trades the other half with
// its partner, so the n * GP channels end spread over the point's lanes
// after ~n * GP shuffles (35 at n * G = 36, where a butterfly on every
// channel took 180), and the lanes write the point's row together.  Blocks
// of 4 warps, held to 128 registers a thread (4 blocks an SM), walk points
// with a grid stride, so the weights are staged once per block.  z, idx and
// pts are read through their strides, idx as int32 or int64: the wrapper
// passes the edge conv's sliced index view and the layer's one product of z
// and the per-point terms as they are.  The kernel is instantiated per
// stage count n = 1..4 and padded width GP in {4, 8, 12, 16, 24, 32}, so
// that every register array has a static size; channels from G up to GP
// are zeros that the sums carry along.  An index outside [0, N) traps.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// blocks per SM that the grid is cut to: enough to even out the tail
constexpr int kBlocksPerSm = 16;
constexpr int kMaxStages = 4;
constexpr int kMaxBlocks = kMaxStages * (kMaxStages - 1) / 2;
// blocks an SM that the register allocation of the instantiations with
// n * GP <= 48 (the main path's is 36) must leave room for: 128 registers
// (at 5 blocks and 96, a stage's separate block sums spilled 352 bytes and
// the kernel ran 1.3x slower at B = 320: PERF.md)
constexpr int kMinBlocks = 4;
// neighbours a lane: 16 lanes a point, two points a warp, each weight read
// feeding both neighbours' products
constexpr int kNpl = 2;

}  // namespace

// One call's arrays, passed by value to the kernel (the C entry point takes
// its address; ops/edgeconv.py packs it, `_ARGS`).  Strides count
// elements; every stage's and z's and idx's last stride is 1.
struct EdgeConvArgs {
  const float* z;  // (bsz, n_pts, g): z + b * z_sb + p * z_sp + c
  long long z_sb, z_sp;
  const void* idx;  // (bsz, n_pts, k) int32 or int64 (idx64)
  long long idx_sb, idx_sp;
  const float* pts[kMaxStages];  // stage s: (bsz, n_pts, g)
  long long pts_sb[kMaxStages], pts_sp[kMaxStages];
  const float* w[kMaxBlocks];  // block (i, jj): (g, g), (r, c) at r*w_sr + c*w_sc
  long long w_sr[kMaxBlocks], w_sc[kMaxBlocks];
  float* out;  // (bsz, n_pts, n * g), contiguous
  int bsz, n_pts, k, n, g, idx64;
};

namespace {

// The max over the warp of C channels, scattered: at step OFF a lane keeps
// the lower or upper half (by its lane bit OFF) of the channels it holds,
// and takes the max with its partner's copy of that half.  A lane ends
// with the channels [base, base + cnt) of the row in res[0, cnt).  Every
// lane of the warp must call it.
template <int C, int OFF>
struct Scatter {
  static constexpr int H = (C + 1) / 2;
  static constexpr int kOut = Scatter<H, OFF / 2>::kOut;
  __device__ __forceinline__ static void run(const float (&v)[C],
                                             float (&res)[kOut], int lane,
                                             int& base, int& cnt) {
    const bool hi = (lane & OFF) != 0;
    float o[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo_v = v[i];
      const float hi_v = H + i < C ? v[H + i < C ? H + i : 0] : -INFINITY;
      const float send = hi ? lo_v : hi_v;
      o[i] = fmaxf(hi ? hi_v : lo_v,
                   __shfl_xor_sync(threepu::kFullMask, send, OFF));
    }
    if (hi) {
      base += H;
      cnt = max(cnt - H, 0);
    } else {
      cnt = min(cnt, H);
    }
    Scatter<H, OFF / 2>::run(o, res, lane, base, cnt);
  }
};

template <int C>
struct Scatter<C, 0> {
  static constexpr int kOut = C;
  __device__ __forceinline__ static void run(const float (&v)[C],
                                             float (&res)[C], int, int&,
                                             int&) {
#pragma unroll
    for (int i = 0; i < C; ++i) res[i] = v[i];
  }
};

template <int NS, int GP>
__global__ void __launch_bounds__(kThreads, NS * GP <= 48 ? kMinBlocks : 1)
edgeconv_kernel(const EdgeConvArgs a, long long points, bool vec) {
  constexpr int kChain = NS * (NS - 1) / 2;
  constexpr int kQuads = GP / 4;
  constexpr int kCh = NS * GP;
  // kLanes lanes a point, kNpl neighbours a lane, kNpl points a warp
  constexpr int kLanes = 32 / kNpl;
  using Red = Scatter<kCh, kLanes / 2>;
  __shared__ float4 ws[kChain > 0 ? kChain * GP * kQuads : 1];
  float* wsf = reinterpret_cast<float*>(ws);
  const int g = a.g, n_pts = a.n_pts, k = a.k;
#pragma unroll
  for (int blk = 0; blk < kChain; ++blk) {
    const float* wb = a.w[blk];
    const long long sr = a.w_sr[blk], sc = a.w_sc[blk];
    for (int e = threadIdx.x; e < GP * GP; e += kThreads) {
      const int r = e / GP, c = e % GP;
      wsf[blk * GP * GP + e] = (r < g && c < g) ? wb[r * sr + c * sc] : 0.f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lp = lane % kLanes;  // the lane's place among its point's lanes
  for (long long p0 = (static_cast<long long>(blockIdx.x) * kWarps + warp) *
                      kNpl;
       p0 < points; p0 += static_cast<long long>(gridDim.x) * kWarps * kNpl) {
    // a warp's last point may lie past the end: its lanes run the last
    // point and write nothing, so that every lane takes part in the max
    const long long p_own = p0 + lane / kLanes;
    const long long p = p_own < points ? p_own : points - 1;
    const long long b = p / n_pts;
    const int i_pt = static_cast<int>(p - b * n_pts);
    const float* zb = a.z + b * a.z_sb;
    const long long ioff = b * a.idx_sb + i_pt * a.idx_sp;
    const float* pp[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      pp[s] = a.pts[s] + b * a.pts_sb[s] + i_pt * a.pts_sp[s];

    float best[Red::kOut];
    int base = 0, cnt = kCh;
#pragma unroll
    for (int i = 0; i < Red::kOut; ++i) best[i] = -INFINITY;
    for (int j0 = 0; j0 < k; j0 += 32) {
      // neighbours j0 + lp + u * kLanes, u < kNpl
      float gs[kNpl][NS][GP];
#pragma unroll
      for (int u = 0; u < kNpl; ++u) {
        const int j = j0 + lp + u * kLanes;
        int nb = 0;
        if (j < k) {
          const long long v =
              a.idx64 ? static_cast<const long long*>(a.idx)[ioff + j]
                      : static_cast<const int*>(a.idx)[ioff + j];
          if (static_cast<unsigned long long>(v) >=
              static_cast<unsigned long long>(n_pts))
            __trap();
          nb = static_cast<int>(v);
        }
        const float* zr = zb + nb * a.z_sp;
        // stage 0: relu(z[nb] + pt_0)
        if (vec) {
#pragma unroll
          for (int q = 0; q < kQuads; ++q) {
            float4 za = make_float4(0.f, 0.f, 0.f, 0.f), t = za;
            if (4 * q < g) {
              za = reinterpret_cast<const float4*>(zr)[q];
              t = reinterpret_cast<const float4*>(pp[0])[q];
            }
            gs[u][0][4 * q + 0] = fmaxf(za.x + t.x, 0.f);
            gs[u][0][4 * q + 1] = fmaxf(za.y + t.y, 0.f);
            gs[u][0][4 * q + 2] = fmaxf(za.z + t.z, 0.f);
            gs[u][0][4 * q + 3] = fmaxf(za.w + t.w, 0.f);
          }
        } else {
#pragma unroll
          for (int c = 0; c < GP; ++c)
            gs[u][0][c] = c < g ? fmaxf(zr[c] + pp[0][c], 0.f) : 0.f;
        }
      }
      bool valid[kNpl];
#pragma unroll
      for (int u = 0; u < kNpl; ++u) valid[u] = j0 + lp + u * kLanes < k;
      // the lane's max in output order [g_{NS-1}, ..., g_0]; neighbours
      // past k count as -inf
      float v[kCh];
      // stages 1 .. NS-1, four output channels at a time: block (i, jj)
      // multiplies g_{i-1-jj}, and each weight read serves the lane's kNpl
      // neighbours; the last stage goes straight into the max
#pragma unroll
      for (int i = 1; i < NS; ++i) {
#pragma unroll
        for (int q = 0; q < kQuads; ++q) {
          // each block's products sum apart, from zero; the blocks' sums
          // then add in block order, as the plain version's do
          float y[kNpl][4];
#pragma unroll
          for (int jj = 0; jj < i; ++jj) {
            const float4* wb = ws + (i * (i - 1) / 2 + jj) * GP * kQuads;
            float t[kNpl][4];
#pragma unroll
            for (int u = 0; u < kNpl; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e) t[u][e] = 0.f;
#pragma unroll
            for (int r = 0; r < GP; ++r) {
              const float4 wv = wb[r * kQuads + q];
#pragma unroll
              for (int u = 0; u < kNpl; ++u) {
                const float src = gs[u][i - 1 - jj][r];
                t[u][0] = fmaf(src, wv.x, t[u][0]);
                t[u][1] = fmaf(src, wv.y, t[u][1]);
                t[u][2] = fmaf(src, wv.z, t[u][2]);
                t[u][3] = fmaf(src, wv.w, t[u][3]);
              }
            }
#pragma unroll
            for (int u = 0; u < kNpl; ++u)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                y[u][e] = jj == 0 ? t[u][e] : y[u][e] + t[u][e];
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 4 * q + e;
            const float pt = c < g ? pp[i][c] : 0.f;
            float m = -INFINITY;
#pragma unroll
            for (int u = 0; u < kNpl; ++u) {
              const float yv = c < g ? y[u][e] + pt : 0.f;
              if (i < NS - 1)
                gs[u][i][c] = fmaxf(yv, 0.f);
              else
                m = valid[u] ? fmaxf(m, yv) : m;
            }
            if (i == NS - 1) v[c] = m;
          }
        }
      }
      // the stages before the last (and the only one when NS = 1)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        if (NS > 1 && s == NS - 1) continue;
#pragma unroll
        for (int c = 0; c < GP; ++c) {
          float m = -INFINITY;
#pragma unroll
          for (int u = 0; u < kNpl; ++u)
            m = valid[u] ? fmaxf(m, gs[u][s][c]) : m;
          v[(NS - 1 - s) * GP + c] = m;
        }
      }
      float res[Red::kOut];
      base = 0;
      cnt = kCh;
      Red::run(v, res, lane, base, cnt);
#pragma unroll
      for (int i = 0; i < Red::kOut; ++i) best[i] = fmaxf(best[i], res[i]);
    }

    // out (B, N, NS * G): channel ch of the padded row is stage
    // ch / GP (output order), column ch % GP
    if (p_own < points) {
      float* op = a.out + p * NS * g;
#pragma unroll
      for (int i = 0; i < Red::kOut; ++i) {
        const int ch = base + i, c = ch % GP;
        if (i < cnt && c < g) op[(ch / GP) * g + c] = best[i];
      }
    }
  }
}

template <int NS, int GP>
int launch(const EdgeConvArgs& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long points = static_cast<long long>(a.bsz) * a.n_pts;
  const long long want = (points + kWarps * kNpl - 1) / (kWarps * kNpl);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  // float4 rows: G a multiple of 4 and every row 16-byte aligned
  const auto rows16 = [](const float* ptr, long long sb, long long sp) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && sb % 4 == 0 &&
           sp % 4 == 0;
  };
  bool vec = a.g % 4 == 0 && rows16(a.z, a.z_sb, a.z_sp);
  for (int s = 0; s < NS; ++s)
    vec = vec && rows16(a.pts[s], a.pts_sb[s], a.pts_sp[s]);
  edgeconv_kernel<NS, GP><<<blocks, kThreads, 0, stream>>>(a, points, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int NS>
int launch_width(const EdgeConvArgs& a, cudaStream_t stream) {
#define THREEPU_EC_WIDTH(GP) \
  if (a.g <= GP) return launch<NS, GP>(a, stream);
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

// *args: z (bsz, n_pts, g) float32, idx (bsz, n_pts, k) int32 or int64 in
// [0, n_pts), the n stages' pts (bsz, n_pts, g) float32 and the n(n-1)/2
// weight blocks (g, g) float32 (none when n = 1), all read through their
// strides -> out (bsz, n_pts, n * g) float32.  Needs 1 <= n <= 4,
// 1 <= g <= 32, bsz, n_pts, k >= 1 (the wrapper checks them; another n or g
// returns cudaErrorInvalidValue).
extern "C" int threepu_edge_conv_chain(const EdgeConvArgs* args,
                                       cudaStream_t stream) {
  switch (args->n) {
    case 1:
      return launch_width<1>(*args, stream);
    case 2:
      return launch_width<2>(*args, stream);
    case 3:
      return launch_width<3>(*args, stream);
    case 4:
      return launch_width<4>(*args, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
