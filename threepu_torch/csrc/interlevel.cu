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
// out[b, q, :] = sum_k w_k f_k.  Features stay float32.  When w_out is not
// null, the normalized weights w (B, N, K) are written there too: the
// backward of the training step scatters w * grad into prev_feat.
//
// What bounds it on the H100: the selection's issue slots.  At level 4
// (B = 320 sub-patches, N = 312, M = 6240) that is 623 M candidates, each a
// separately rounded squared distance (8 operations under -fmad=false), the
// penalty and a compare: ~0.19 ms of issue on 132 SMs at their top clock,
// ~5x the bound's count, which prices every operation at half an FMA.  The
// gathers move B * N * K * C * 4 B = 527 MB (C = 264) of feature rows
// twice, mostly from L2 (a top patch's previous features, 6.6 MB, serve its
// 40 sub-patches).
//
// Design:
//   - A team of kTeam = 8 lanes per query, 4 queries a warp.  The team keeps
//     the query's top-K so far as (rank bits << 32 | index) keys, entry s in
//     lane s, so the K-th rank, the threshold a candidate must not exceed,
//     is one shuffle away.  Lane t of a team reads the candidates j = t mod
//     8 of each staged tile, 8 at a time, and the warp votes once on their
//     least rank; a candidate that passes enters at its place in (rank,
//     index) order: a ballot counts the entries below its key, and the
//     entries above it move up one lane.  Ties keep the lowest index
//     whichever lane read them.  With the threshold shared by the team, a
//     query's entries change about K ln(M / K) times, as in a serial scan.
//   - Each candidate costs its distance, one bitwise select (a LOP3) of
//     1e30's bits under a mask staged beside the coordinates, all ones for
//     a flagged point (the plain version's select, so a flagged point
//     ranks 1e30 whatever its coordinates), and its share of the vote.  Tiles are padded with NaN points, which never pass.
//     The true distances of the K picks are recomputed from device memory
//     in the same rounding.
//   - A sub-patch's queries are spread over a thread-block cluster of up to
//     8 blocks, laid out by ops.interlevel.interlevel_plan (8 blocks of 320
//     threads at N = 312), each staging the top patch's coordinates in
//     tiles of 2048 (float4, 32 KB).  The sums behind h_s and h_f are
//     summed per block, then over the cluster through distributed shared
//     memory, in the same order in every block.  Blocks of up to 320
//     threads are held to 48 registers a thread, 4 blocks an SM.
//   - The two passes over the K feature rows (distances, then the weighted
//     sum) run with the team's lanes across the C channels, float4 where C
//     is a multiple of 4 and the rows are 16-byte aligned.
// The library is built with -fmad=false, so the squared distances round
// exactly as the plain PyTorch version computes them and selections match
// it bit for bit; sums over C and over the queries run in another order
// than PyTorch's, so output values agree to float32 rounding.
#include <cooperative_groups.h>

#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTeam = 8;
// candidates a lane reads before the team votes on them
constexpr int kUnroll = 8;
constexpr int kChunk = kTeam * kUnroll;
constexpr int kTile = 2048;  // a multiple of kChunk
constexpr int kMaxThreads = 1024;
// blocks up to this many threads (sub-patches of N <= 320 on clusters of 8,
// the main path's 312 among them) take an instantiation whose registers
// leave room for kSmallBlocksPerSm of them an SM (48 registers a thread);
// larger ones are held to 64
constexpr int kSmallBlock = 320;
constexpr int kSmallBlocksPerSm = 4;
constexpr int kMaxCluster = 8;
constexpr unsigned kPenaltyBits = 0x7149f2cau;  // 1e30f, the plain rank
// the key of an empty list slot: rank +inf, index 0xffffffff
constexpr unsigned long long kEmpty = 0x7f800000ffffffffull;

// (rank, index) as one key in their lexicographic order: ranks are >= +0
// or +inf, so their bits order as the floats do.
__device__ __forceinline__ unsigned long long pick_key(float rank, int i) {
  return (static_cast<unsigned long long>(__float_as_uint(rank)) << 32) |
         static_cast<unsigned>(i);
}

// Sum over the kTeam lanes of each team (aligned groups of a warp); every
// lane of the warp must call it.
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int off = kTeam / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(threepu::kFullMask, v, off);
  return v;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

template <int K, int kBlockThreads>
__global__ void __launch_bounds__(
    kBlockThreads, kBlockThreads == kSmallBlock ? kSmallBlocksPerSm : 1)
interlevel_kernel(const float* __restrict__ q_xyz, const float* __restrict__ xq,
                  const float* __restrict__ prev_xyz,
                  const float* __restrict__ prev_feat,
                  const uint8_t* __restrict__ prev_dup, float* __restrict__ out,
                  int* __restrict__ idx_out, float* __restrict__ w_out, int n,
                  int group, int m, int c, int cl, int per_block, bool vec) {
  __shared__ float4 tile[kTile];
  __shared__ float s_red[2][kMaxThreads / 32];
  __shared__ float s_part[2];   // this block's sums, read by the cluster
  __shared__ float s_half[2];   // h_s / 2 and h_f / 2

  cg::cluster_group cluster = cg::this_cluster();
  const int bsub = blockIdx.x / cl;
  const int p = bsub / group;
  const int q0 = static_cast<int>(cluster.block_rank()) * per_block;
  const int count = min(per_block, n - q0);   // >= 1: the plan sees to it
  const float* pxyz = prev_xyz + static_cast<size_t>(p) * m * 3;
  const uint8_t* pdup = prev_dup + static_cast<size_t>(p) * m;
  const float* pfeat = prev_feat + static_cast<size_t>(p) * m * c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int team = tid / kTeam, t = tid % kTeam;
  const int tbase = lane & ~(kTeam - 1);

  // the team's query; a team past the block's last runs the last and
  // writes nothing, so that every lane takes part in the warp's shuffles
  const bool has_q = team < count;
  const size_t row = static_cast<size_t>(bsub) * n + q0 + min(team, count - 1);
  const float qx = q_xyz[row * 3], qy = q_xyz[row * 3 + 1],
              qz = q_xyz[row * 3 + 2];

  // ---- 1. the query's top-K over the team, entry s in lane s ------------
  unsigned long long entry = kEmpty;  // lanes t >= K keep kEmpty
  float thr = INFINITY;               // the query's K-th rank so far
  for (int base = 0; base < m; base += kTile) {
    const int cnt = min(kTile, m - base);
    // the tile padded to whole chunks with NaN points, which never pass
    const int padded = (cnt + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // the previous tile is consumed
#pragma unroll 4
    for (int j = tid; j < padded; j += blockDim.x) {
      float4 e = make_float4(NAN, NAN, NAN, 0.f);
      if (j < cnt) {
        const float* pp = pxyz + static_cast<size_t>(base + j) * 3;
        e = make_float4(pp[0], pp[1], pp[2],
                        __uint_as_float(pdup[base + j] ? ~0u : 0u));
      }
      tile[j] = e;
    }
    __syncthreads();
    for (int j0 = 0; j0 < padded; j0 += kChunk) {
      // kUnroll candidates a lane, then one vote on their least rank
      // (fminf passes over the NaN padding)
      float r[kUnroll];
      float least = NAN;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float4 e = tile[j0 + u * kTeam + t];
        const unsigned d = __float_as_uint(
            threepu::sq_dist3(qx, qy, qz, e.x, e.y, e.z));
        const unsigned flag = __float_as_uint(e.w);
        r[u] = __uint_as_float((d & ~flag) | (kPenaltyBits & flag));
        least = fminf(least, r[u]);
      }
      if (!__any_sync(threepu::kFullMask, least <= thr)) continue;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bool want = r[u] <= thr;
        // the passing candidates enter one a team at a time, each at its
        // place in (rank, index) order; the loop is uniform over the warp
        while (__any_sync(threepu::kFullMask, want)) {
          const unsigned mine =
              (__ballot_sync(threepu::kFullMask, want) >> tbase) & 0xffu;
          const int src = mine ? __ffs(mine) - 1 : 0;
          const float cr = __shfl_sync(threepu::kFullMask, r[u], tbase + src);
          const unsigned long long ck =
              mine ? pick_key(cr, base + j0 + u * kTeam + src) : kEmpty;
          const int pos = __popc(
              (__ballot_sync(threepu::kFullMask, entry < ck) >> tbase) & 0xffu);
          const unsigned long long up =
              __shfl_up_sync(threepu::kFullMask, entry, 1, kTeam);
          if (t < K && t >= pos) entry = t == pos ? ck : up;
          thr = __uint_as_float(static_cast<unsigned>(
              __shfl_sync(threepu::kFullMask, entry, tbase + K - 1) >> 32));
          want = want && t != src && r[u] <= thr;
        }
      }
    }
  }

  // ---- 2. the picks in every lane of the team ----------------------------
  int pick[K];
  float min_ds = INFINITY;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const unsigned long long key =
        __shfl_sync(threepu::kFullMask, entry, tbase + s);
    // an empty slot (fewer than K finite candidates) reads row 0
    pick[s] = key == kEmpty ? 0 : static_cast<int>(key & 0xffffffffu);
    const float* pp = pxyz + static_cast<size_t>(pick[s]) * 3;
    min_ds = fminf(min_ds, threepu::sq_dist3(qx, qy, qz, pp[0], pp[1], pp[2]));
  }
  min_ds = has_q && t == 0 ? min_ds : 0.f;  // counted once a query
  if (has_q && t < K)
    idx_out[row * K + t] =
        entry == kEmpty ? 0 : static_cast<int>(entry & 0xffffffffu);
#ifdef THREEPU_IL_SCAN_ONLY
  return;  // interlevel_split.py times the selection alone
#endif

  // ---- 3. feature distances, the team's lanes across C -----------------
  float fd[K];
  const float* xrow = xq + row * c;
#pragma unroll
  for (int s = 0; s < K; ++s) fd[s] = 0.f;
  if (vec) {
    const int c4 = c >> 2;
    for (int ch = t; ch < c4; ch += kTeam) {
      const float4 x4 = reinterpret_cast<const float4*>(xrow)[ch];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float4 f4 = reinterpret_cast<const float4*>(
            pfeat + static_cast<size_t>(pick[s]) * c)[ch];
        const float dx = x4.x - f4.x, dy = x4.y - f4.y, dz = x4.z - f4.z,
                    dw = x4.w - f4.w;
        fd[s] += dx * dx;
        fd[s] += dy * dy;
        fd[s] += dz * dz;
        fd[s] += dw * dw;
      }
    }
  } else {
    for (int ch = t; ch < c; ch += kTeam) {
      const float xv = xrow[ch];
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const float df = xv - pfeat[static_cast<size_t>(pick[s]) * c + ch];
        fd[s] += df * df;
      }
    }
  }
  float min_fd = INFINITY;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    fd[s] = team_sum(fd[s]);
    min_fd = fminf(min_fd, fd[s]);
  }
  min_fd = has_q && t == 0 ? min_fd : 0.f;

  // ---- 4. h = mean over the sub-patch of the min over K: block, cluster -
  min_ds = threepu::warp_sum(min_ds);
  min_fd = threepu::warp_sum(min_fd);
  if (lane == 0) {
    s_red[0][warp] = min_ds;
    s_red[1][warp] = min_fd;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.f, f = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      a += s_red[0][w];
      f += s_red[1][w];
    }
    s_part[0] = a;
    s_part[1] = f;
  }
  cluster.sync();  // every block's sums are in its shared memory
  if (warp == 0) {
    float a = 0.f, f = 0.f;
    if (lane < cl) {
      const float* peer = cluster.map_shared_rank(&s_part[0], lane);
      a = peer[0];
      f = peer[1];
    }
    // the same lanes sum in the same order in every block of the cluster
    a = threepu::warp_sum(a);
    f = threepu::warp_sum(f);
    if (lane == 0) {
      s_half[0] = a / static_cast<float>(n) / 2.0f;
      s_half[1] = f / static_cast<float>(n) / 2.0f;
    }
  }
  cluster_arrive();  // this block has read its peers; they may exit
  __syncthreads();
  const float half_hs = s_half[0], half_hf = s_half[1];

  // ---- 5. weights and output ------------------------------------------
  float w[K];
  float denom = 0.f;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const float* pp = pxyz + static_cast<size_t>(pick[s]) * 3;
    const float ds = threepu::sq_dist3(qx, qy, qz, pp[0], pp[1], pp[2]);
    w[s] = expf(-ds / half_hs) * expf(-fd[s] / half_hf);
    denom += w[s] + 1e-5f;
  }
#pragma unroll
  for (int s = 0; s < K; ++s) w[s] = w[s] / denom;
  if (has_q) {
    if (w_out != nullptr && t < K) {
      float v = w[0];
#pragma unroll
      for (int s = 1; s < K; ++s) v = t == s ? w[s] : v;
      w_out[row * K + t] = v;
    }
    float* orow = out + row * c;
    if (vec) {
      const int c4 = c >> 2;
      for (int ch = t; ch < c4; ch += kTeam) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < K; ++s) {
          const float4 f4 = reinterpret_cast<const float4*>(
              pfeat + static_cast<size_t>(pick[s]) * c)[ch];
          acc.x += w[s] * f4.x;
          acc.y += w[s] * f4.y;
          acc.z += w[s] * f4.z;
          acc.w += w[s] * f4.w;
        }
        reinterpret_cast<float4*>(orow)[ch] = acc;
      }
    } else {
      for (int ch = t; ch < c; ch += kTeam) {
        float acc = 0.f;
#pragma unroll
        for (int s = 0; s < K; ++s)
          acc += w[s] * pfeat[static_cast<size_t>(pick[s]) * c + ch];
        orow[ch] = acc;
      }
    }
  }
  cluster_wait();  // no block leaves while a peer may still read it
}

template <int K>
int launch(const float* q_xyz, const float* xq, const float* prev_xyz,
           const float* prev_feat, const uint8_t* prev_dup, float* out,
           int* idx_out, float* w_out, int b, int n, int p, int m, int c,
           int cluster, int per_block, int threads, cudaStream_t stream) {
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  const bool vec = c % 4 == 0 && aligned(xq) && aligned(prev_feat) &&
                   aligned(out);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg,
      threads <= kSmallBlock ? interlevel_kernel<K, kSmallBlock>
                             : interlevel_kernel<K, kMaxThreads>,
      q_xyz, xq, prev_xyz, prev_feat, prev_dup, out, idx_out, w_out, n,
      b / p, m, c, cluster, per_block, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_xyz (b, n, 3), xq (b, n, c), prev_xyz (p, m, 3), prev_feat (p, m, c)
// float32, prev_dup (p, m) uint8 -> out (b, n, c) float32, the picks
// idx_out (b, n, k) int32, in rank order, and, unless w_out is null, their
// weights w_out (b, n, k) float32.  The layout is the caller's
// (ops.interlevel.interlevel_plan): each sub-patch's n queries over a
// cluster of `cluster` blocks (1 to 8) of `per_block` queries, every block
// holding at least one, with a team of 8 lanes a query in blocks of
// `threads` threads; another layout returns cudaErrorInvalidValue.  Needs
// p | b, 1 <= n <= 1024, 1 <= k <= min(m, 8) (the wrapper checks them).
extern "C" int threepu_interlevel(const float* q_xyz, const float* xq,
                                  const float* prev_xyz, const float* prev_feat,
                                  const uint8_t* prev_dup, float* out,
                                  int* idx_out, float* w_out, int b, int n,
                                  int p, int m, int c, int k, int cluster,
                                  int per_block, int threads,
                                  cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster || per_block < 1 ||
      (cluster - 1) * per_block >= n || cluster * per_block < n ||
      threads % 32 != 0 || threads < per_block * kTeam ||
      threads > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (k) {
#define THREEPU_K(K) \
  case K:            \
    return launch<K>(q_xyz, xq, prev_xyz, prev_feat, prev_dup, out, idx_out, \
                     w_out, b, n, p, m, c, cluster, per_block, threads,     \
                     stream);
    THREEPU_K(1) THREEPU_K(2) THREEPU_K(3) THREEPU_K(4)
    THREEPU_K(5) THREEPU_K(6) THREEPU_K(7) THREEPU_K(8)
#undef THREEPU_K
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
