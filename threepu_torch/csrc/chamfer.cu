// Nearest neighbours both ways: for each point of a (B, N, 3), the squared
// distance to and the index of its nearest point in b (B, M, 3), and for
// each point of b the same in a — kernel 5.
//
// Replaces: threepu/ops/chamfer_pallas.py, `_nn_kernel` / `nn_one_way_pallas`
// (a query block against the whole reference set in VMEM, swept in
// 2048-point tiles with a running (min, argmin) carry, one call a
// direction).  On the main path it serves the Chamfer loss of the training
// step, (16, 624) x (16, 624) both ways once a step; the quality Chamfer of
// a 16x output is (1, 80000) x (1, 80000).
//
// What bounds it on the H100: issue slots, not bytes.  Only 20 bytes a
// point cross device memory, but every pair costs 8 separately rounded
// float operations (3 subtractions, 3 products, 2 sums: the library is
// built with -fmad=false, so each one issues on its own) and a min: 9 issue
// slots at one a lane a clock, ~1.7 ms one way at 80k x 80k on 132 SMs at
// 1.98 GHz.  The fp32 bound prices an operation at half an FMA, so it is
// ~2.2x lower than anything this kernel can reach; tensor cores do not
// apply, since the matmul form |a|^2 - 2ab + |b|^2 rounds otherwise and
// moves the argmins of near-ties.
//
// Design, for issue slots:
//   - One launch for both directions: the grid's clusters cover the query
//     tiles of a -> b, then those of b -> a (none for one way).
//   - One query a thread in registers: the main path's clouds (the train
//     step's 16 x 624) fill few SMs, where the length of each warp's chain
//     of candidates sets the time, so the candidate axis is split rather
//     than several queries stacked on a thread.
//   - A cheaper running argmin: the distances of a group of kG candidates
//     stay in registers and their min is one FMNMX a pair; a vote of the
//     warp a group, and only when the group's min is strictly below some
//     lane's running best do the lanes look for the lowest index in the
//     group with that distance.  Strictly smaller wins and ties keep the
//     lowest index, as in a serial scan.
//   - The candidate axis split over a thread-block cluster of S <= 8
//     blocks, laid out by ops.chamfer.chamfer_plan from the clusters the
//     card holds at once (threepu_nn_max_clusters).  Block r scans the
//     r-th contiguous slice of ceil(M / S) candidates (possibly empty),
//     staged through shared memory in tiles of kStage candidates a
//     thread, the next tile loaded into registers while the current one
//     is scanned; the ragged last tile is padded with NaN points, which
//     fminf passes over and no comparison picks.  The slices' (min,
//     argmin) merge through distributed shared memory in slice order, the
//     smaller distance winning and the lower slice on equal distances:
//     the unsplit result, with no scratch buffer and no second launch.
// Each distance rounds as (dx*dx + dy*dy) + dz*dz, as the plain PyTorch
// version computes it, so values and indices match it bit for bit.
// Inputs are finite; a query whose every distance is +inf keeps index 0.
#include <cooperative_groups.h>

#include <cmath>
#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kG = 8;       // candidates between two argmin checks
constexpr int kStage = 4;   // candidates a thread stages a tile
// blocks of up to 128 threads, held to 64 registers a thread so that 8 of
// them (32 warps) fit an SM
constexpr int kMaxThreads = 128;
constexpr int kMinBlocks = 8;
constexpr int kMaxCluster = 8;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// Grid: (bsz * (tiles_a + tiles_b)) clusters of `cl` blocks, cluster c
// < bsz * tiles_a holding query tile c % tiles_a of a -> b for batch element
// c / tiles_a, the rest those of b -> a; a query a thread.  Dynamic shared
// memory: two tiles of kStage * blockDim.x float4, then, for cl > 1, the
// block's partial distances and indices (blockDim.x each).
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
nn_kernel(const float* __restrict__ a, const float* __restrict__ b,
          float* __restrict__ d1, int* __restrict__ i1,
          float* __restrict__ d2, int* __restrict__ i2, int bsz, int n,
          int m, int tiles_a, int tiles_b, int cl) {
  extern __shared__ float4 smem[];
  const int threads = blockDim.x, tid = threadIdx.x;
  const int tile = kStage * threads;

  int c = blockIdx.x / cl;
  const int rank =
      cl == 1 ? 0 : static_cast<int>(cg::this_cluster().block_rank());
  const float *qs, *cs;
  float* dist;
  int* idx;
  int nq, nc, batch, qt;
  if (c < bsz * tiles_a) {
    batch = c / tiles_a;
    qt = c % tiles_a;
    qs = a + static_cast<size_t>(batch) * n * 3;
    cs = b + static_cast<size_t>(batch) * m * 3;
    dist = d1 + static_cast<size_t>(batch) * n;
    idx = i1 + static_cast<size_t>(batch) * n;
    nq = n;
    nc = m;
  } else {
    c -= bsz * tiles_a;
    batch = c / tiles_b;
    qt = c % tiles_b;
    qs = b + static_cast<size_t>(batch) * m * 3;
    cs = a + static_cast<size_t>(batch) * n * 3;
    dist = d2 + static_cast<size_t>(batch) * m;
    idx = i2 + static_cast<size_t>(batch) * m;
    nq = m;
    nc = n;
  }
  const int q = qt * threads + tid;

  // this thread's query; one past the last query scans the last one and
  // writes nothing
  const float* p = qs + static_cast<size_t>(min(q, nq - 1)) * 3;
  const float qx = p[0], qy = p[1], qz = p[2];

  // this block's slice of the candidates
  const int slice = (nc + cl - 1) / cl;
  const int lo = min(nc, rank * slice);
  const int hi = min(nc, lo + slice);

  float sx[kStage], sy[kStage], sz[kStage];
  // candidates base + tid + s * threads into registers, NaN past hi
  const auto fetch = [&](int base) {
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int j = base + tid + s * threads;
      if (j < hi) {
        const float* e = cs + static_cast<size_t>(j) * 3;
        sx[s] = e[0];
        sy[s] = e[1];
        sz[s] = e[2];
      } else {
        sx[s] = sy[s] = sz[s] = NAN;
      }
    }
  };
  const auto stash = [&](float4* dst) {
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      dst[tid + s * threads] = make_float4(sx[s], sy[s], sz[s], 0.f);
  };

  float best = INFINITY;
  int best_i = 0;
  if (lo < hi) {
    fetch(lo);
    stash(smem);
  }
  __syncthreads();
  int t = 0;
  for (int base = lo; base < hi; base += tile, t ^= 1) {
    const bool more = base + tile < hi;
    if (more) fetch(base + tile);   // in flight while this tile is scanned
    const float4* cur = smem + t * tile;
    const int padded = (min(tile, hi - base) + kG - 1) / kG * kG;
    for (int j0 = 0; j0 < padded; j0 += kG) {
      float d[kG];
      float gmin;
#pragma unroll
      for (int u = 0; u < kG; ++u) {
        const float4 e = cur[j0 + u];
        d[u] = threepu::sq_dist3(qx, qy, qz, e.x, e.y, e.z);
        gmin = u == 0 ? d[0] : fminf(gmin, d[u]);
      }
      // uniform over the warp: taken when the group improves some lane's
      // best (NaN, the padding only, never compares below), it looks for
      // the lowest index with the group's min
      const bool take = gmin < best;
      if (__any_sync(threepu::kFullMask, take)) {
        int k = kG - 1;
#pragma unroll
        for (int u = kG - 2; u >= 0; --u) k = d[u] == gmin ? u : k;
        best_i = take ? base + j0 + k : best_i;
        best = take ? gmin : best;
      }
    }
    if (more) stash(smem + (t ^ 1) * tile);
    __syncthreads();
  }

  if (cl == 1) {
    if (q < nq) {
      dist[q] = best;
      idx[q] = best_i;
    }
    return;
  }

  // the slices' partials, merged in slice order: block r merges the r-th
  // run of ceil(threads / cl) of the tile's queries
  float* part_d = reinterpret_cast<float*>(smem + 2 * tile);
  int* part_i = reinterpret_cast<int*>(part_d + threads);
  part_d[tid] = best;
  part_i[tid] = best_i;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partials are in its shared memory
  const int run = (threads + cl - 1) / cl;
  const int j = rank * run + tid;
  if (tid < run && j < threads) {
    // every peer's partial read at once, then merged in slice order
    float v[kMaxCluster];
    int vi[kMaxCluster];
#pragma unroll
    for (int s = 0; s < kMaxCluster; ++s) {
      if (s < cl) {
        v[s] = cluster.map_shared_rank(part_d, s)[j];
        vi[s] = cluster.map_shared_rank(part_i, s)[j];
      }
    }
    float bd = v[0];
    int bi = vi[0];
#pragma unroll
    for (int s = 1; s < kMaxCluster; ++s) {
      if (s < cl && v[s] < bd) {
        bd = v[s];
        bi = vi[s];
      }
    }
    const int r = qt * threads + j;
    if (r < nq) {
      dist[r] = bd;
      idx[r] = bi;
    }
  }
  cluster_arrive();  // this block has read its peers
  cluster_wait();    // no block leaves while a peer may still read it
}

// The launch configuration of `blocks` blocks of `threads` threads on
// clusters of `cluster` (`attr` is filled to point at); false for a layout
// the kernel does not take.
bool configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
               int threads, int cluster, long long blocks,
               cudaStream_t stream) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      cluster < 1 || cluster > kMaxCluster || blocks > INT_MAX)
    return false;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes =
      (2 * kStage * sizeof(float4) + (cluster > 1 ? 8 : 0)) * threads;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return true;
}

}  // namespace

// a (bsz, n, 3), b (bsz, m, 3) float32 -> d1 (bsz, n) float32, i1 (bsz, n)
// int32: each point of a's nearest in b; and, unless d2 and i2 are null,
// d2 (bsz, m), i2 (bsz, m): each point of b's nearest in a, in the same
// launch.  The layout is the caller's (ops.chamfer.chamfer_plan): a query
// a thread, `threads` threads a block (a multiple of 32 up to 128), the
// candidate axis over a cluster of `cluster` blocks (1 to 8), staged in
// tiles of `tile` candidates (kStage a thread); another layout returns
// cudaErrorInvalidValue.  Needs bsz, n, m >= 1 (the wrapper checks them).
extern "C" int threepu_nn(const float* a, const float* b, float* d1, int* i1,
                          float* d2, int* i2, int bsz, int n, int m,
                          int threads, int cluster, int tile,
                          cudaStream_t stream) {
  if (threads < 1 || tile != kStage * threads || bsz < 1 || n < 1 ||
      m < 1 || (d2 == nullptr) != (i2 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles_a = (n + threads - 1LL) / threads;
  const long long tiles_b = d2 == nullptr ? 0 : (m + threads - 1LL) / threads;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!configure(cfg, attr, threads, cluster,
                 bsz * (tiles_a + tiles_b) * cluster, stream))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, nn_kernel, a, b, d1, i1, d2, i2, bsz, n, m,
      static_cast<int>(tiles_a), static_cast<int>(tiles_b), cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Into *out: how many clusters of `cluster` blocks of `threads` threads the
// current device holds at once (cudaOccupancyMaxActiveClusters).  Blocks of
// a cluster share a GPC, so from 3 blocks a cluster up this is fewer than
// the SMs' blocks over the cluster size: ops.chamfer.chamfer_plan sizes the
// cluster by it.
extern "C" int threepu_nn_max_clusters(int threads, int cluster, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (!configure(cfg, attr, threads, cluster, cluster, nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, nn_kernel, &cfg));
}
