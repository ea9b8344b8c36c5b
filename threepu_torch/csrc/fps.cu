// Furthest point sampling — kernel 2.
//
// Replaces: threepu/ops/fps_pallas.py, `_fps_kernel` / `fps_pallas` (point
// planes, carry and pick stamps resident in VMEM, a stable argsort of the
// stamps afterwards).  On the main path: the 48 seed picks of the shape
// (N = 5000), the sub-patch seeds of every level (N <= 2496), each
// level's merge re-stitch (8 clouds of N = 6240 / 12480 / 24960 ->
// 1248 / 2496 / 4992 picks) and the G = 8 groups of the final re-stitch
// (8 clouds of N = 29952 -> 10000 picks).
//
// What bounds it on the H100: the pick chain.  Pick j needs pick j-1's
// point, so the picks run one after another, and a call has only B = 8
// clouds.  The arithmetic (10 operations per point and pick) and the
// bytes (each point read once) are far below the card's rates; the time
// is the latency of one pick: a pass over the cloud, then an argmax over
// all of it.
//
// Design: one cloud per thread-block cluster of C blocks of 256 threads,
// C chosen per call by `ops/fps.py::fps_plan`: the smallest C up to 8,
// the portable maximum, whose blocks hold their slice in registers at 8
// points a thread, else at 16, and 8 for larger clouds.  Clusters of 16
// (a non-portable size) were timed and left out: the longer wait for the
// peers cost a pick more than halving each block's points saved
// (PERF.md).  Block r of a cluster owns the contiguous slice
// [r * ceil(N / C), ...) of the cloud, so rank order is index order.  The
// slice is staged once as float4 (x, y, z, carry) in shared memory and,
// up to 16 points a thread, also held in registers; above 4,096 points a
// block the pass runs over shared memory, and above the opt-in dynamic
// shared memory over a global scratch array (the wrapper decides and
// allocates).  One pick: each thread updates its points and keeps its
// (max, lowest index); a warp argmax (two `redux.sync`: the carry's
// ordered bits, then the lowest index among the lanes that hold the
// largest), one __syncthreads, and warp 0 reads the 8 warps' results in
// turn: the block's candidate (value, index, x, y, z).  Lanes 0..C-1 of
// warp 0 store it into one slot of each block of the cluster with
// `st.async` through distributed shared memory, each store counted as it
// lands on that block's mbarrier for the pick's parity (armed for C
// candidates' bytes by the block's thread 0).  Every thread waits for its
// own block's barrier and reduces the C slots in a tree, so the winner's
// coordinates reach every thread with no load from device memory and no
// fence on the chain.  A split of a pick's cycles by stage (this file
// built with -DTHREEPU_FPS_SPLIT, as `fps_split.py` does) chose this over
// a cluster barrier of every thread per pick, and then over remote
// arrivals released at cluster scope: each was the costliest stage of a
// pick in its turn (PERF.md).
//
// Why the slots and barriers may be double-buffered by the parity of the
// pick: a block sends pick j + 1 only after its __syncthreads of pick
// j + 1, so after all its threads have read its slots of pick j, seen that
// phase end, and thread 0 has re-armed the barrier; a peer stores pick
// j + 2 into those slots only after it has received pick j + 1 from every
// block.  Likewise warp 0 has read s_key before its own block's store can
// end the phase that lets the other warps write it again.
//
// Semantics of `fps_indices` + `sanitize_points`: seed = first valid
// index (0 if none: the same cluster-wide argmax, over "is valid"), carry
// 1e10 on valid points and -inf on masked or non-finite ones, the update
// fminf(carry, d), ties to the lowest index, non-finite coordinates read
// as 0 (they are zeroed when the slice is staged).
#include <cooperative_groups.h>

#include <climits>
#include <cmath>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr float kInitDist = 1e10f;

// Where a block keeps its slice as float4 (x, y, z, carry): a global
// scratch array, its shared memory, or each thread's 8 or 16 points in
// registers (over the shared-memory copy, which then serves only the
// winner's coordinates).  The codes of the C entry points' `storage`
// argument.
enum Storage { kDevice = 0, kShared = 1, kRegisters8 = 2, kRegisters16 = 3 };

__host__ __device__ constexpr int reg_points(int storage) {
  return storage == kRegisters8 ? 8 : storage == kRegisters16 ? 16 : 0;
}

// one block's candidate for a pick: its (max carry, lowest index), the
// carry as threepu::ordered_bits, and the point's coordinates; 16-byte
// aligned for the vector store into a peer
struct alignas(16) Candidate {
  unsigned key, idx;
  float x, y, z;
};
constexpr unsigned kCandidateBytes = 20;

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(unsigned long long* bar,
                                              unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// The arrival of the barrier's current phase, which then also waits for
// `bytes` more to be stored into this block by st.async.
__device__ __forceinline__ void mbarrier_expect(unsigned long long* bar,
                                                unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// The shared::cluster address of `p`'s place in block `rank`.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// `cand` into `slot` of another block, counted on that block's barrier
// `bar` as it lands (both shared::cluster addresses): no fence, the
// barrier's phase ends when the bytes are there.
__device__ __forceinline__ void store_remote(unsigned slot, unsigned bar,
                                             const Candidate& cand) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(slot), "r"(cand.key), "r"(cand.idx),
         "r"(__float_as_uint(cand.x)), "r"(__float_as_uint(cand.y)),
         "r"(bar) : "memory");
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];"
      :: "r"(slot + 16), "r"(__float_as_uint(cand.z)), "r"(bar) : "memory");
}

// Waits, acquiring at cluster scope, until the phase of `bar` with this
// parity has ended.
__device__ __forceinline__ void mbarrier_wait(unsigned long long* bar,
                                              unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT;\n\t}"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// Built with -DTHREEPU_FPS_SPLIT, thread 0 of block 0 also keeps its mean
// cycles per pick in each stage of a pick (slice pass, warp argmax,
// __syncthreads, warp 0's block argmax and stores, the wait for the
// peers, the reduction of the C slots) in split_cycles, which
// threepu_fps_split reads.
#ifdef THREEPU_FPS_SPLIT
constexpr bool kSplit = true;
#else
constexpr bool kSplit = false;
#endif
constexpr int kStages = 6;
__device__ float split_cycles[kStages];

// kStorage: a Storage; `buf` is the block's dynamic shared memory, or for
// kDevice the cloud's slice of `scratch` (b, n) float4.
template <int kStorage>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           float4* __restrict__ scratch, int* __restrict__ out, int n, int m,
           int slice) {
  extern __shared__ float4 staged_smem[];
  __shared__ Candidate slots[2][kMaxCluster];
  __shared__ unsigned long long arrived[2];
  __shared__ unsigned s_key[kWarps], s_idx[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / c;
  const int lo = rank * slice;
  const int cnt = max(0, min(n, lo + slice) - lo);
  const size_t base = static_cast<size_t>(b) * n + lo;
  float4* buf = kStorage == kDevice ? scratch + base : staged_smem;
  int* o = out + static_cast<size_t>(b) * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage the slice, sanitized; the seed candidate is the first live point
  float best_v = -INFINITY;
  int best_i = INT_MAX;
  for (int t = tid; t < cnt; t += kThreads) {
    const float* p = pts + 3 * (base + t);
    float x = p[0], y = p[1], z = p[2];
    const bool fin = finite3(x, y, z);
    const bool live = valid[base + t] && fin;
    if (!fin) x = y = z = 0.f;
    buf[t] = make_float4(x, y, z, live ? kInitDist : -INFINITY);
    const float v = live ? 1.f : -INFINITY;
    if (v > best_v || (v == best_v && lo + t < best_i)) {
      best_v = v;
      best_i = lo + t;
    }
  }
  // arrived[p] ends a phase when every block of the cluster has stored its
  // candidate of a pick of parity p here: thread 0 arms each phase for C
  // candidates' bytes, before any peer can store them; no peer may store
  // before the barriers are initialised
  if (tid == 0) {
    for (int p = 0; p < 2; ++p) {
      mbarrier_init(&arrived[p], 1);
      mbarrier_expect(&arrived[p], kCandidateBytes * c);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  // in registers: point tid + u * kThreads of the slice in place u (a
  // carry of -inf past the slice's end)
  constexpr int kRegs = reg_points(kStorage) > 0 ? reg_points(kStorage) : 1;
  float rx[kRegs], ry[kRegs], rz[kRegs], rw[kRegs];
  if constexpr (reg_points(kStorage) > 0) {
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int t = tid + u * kThreads;
      const float4 q = t < cnt ? buf[t] : make_float4(0.f, 0.f, 0.f, -INFINITY);
      rx[u] = q.x;
      ry[u] = q.y;
      rz[u] = q.z;
      rw[u] = q.w;
    }
  }

  long long cycles[kStages] = {};
  long long stamp = 0;
  auto mark = [&](int stage) {
    if constexpr (kSplit) {
      const long long now = clock64();
      cycles[stage] += now - stamp;
      stamp = now;
    }
  };

  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int j = 0; j < m; ++j) {
    if constexpr (kSplit) stamp = clock64();
    if (j > 0 && reg_points(kStorage) > 0) {
      best_v = -INFINITY;
      best_i = INT_MAX;
#pragma unroll
      for (int u = 0; u < kRegs; ++u) {
        const int t = tid + u * kThreads;
        const float w = fminf(rw[u], threepu::sq_dist3(rx[u], ry[u], rz[u],
                                                       cx, cy, cz));
        rw[u] = w;
        if (t < cnt && (w > best_v || (w == best_v && lo + t < best_i))) {
          best_v = w;
          best_i = lo + t;
        }
      }
    } else if (j > 0) {
      best_v = -INFINITY;
      best_i = INT_MAX;
      for (int t = tid; t < cnt; t += kThreads) {
        const float4 q = buf[t];
        const float w = fminf(q.w, threepu::sq_dist3(q.x, q.y, q.z, cx, cy,
                                                     cz));
        buf[t].w = w;
        if (w > best_v || (w == best_v && lo + t < best_i)) {
          best_v = w;
          best_i = lo + t;
        }
      }
    }
    mark(0);
    // the block's candidate, stored into slots[j & 1][rank] of every block
    unsigned key = threepu::ordered_bits(best_v);
    unsigned idx = static_cast<unsigned>(best_i);
    threepu::warp_argmax(key, idx);
    if (lane == 0) {
      s_key[warp] = key;
      s_idx[warp] = idx;
    }
    mark(1);
    __syncthreads();
    mark(2);
    if (warp == 0) {
      key = s_key[0];
      idx = s_idx[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const unsigned k2 = s_key[w], i2 = s_idx[w];
        if (k2 > key || (k2 == key && i2 < idx)) {
          key = k2;
          idx = i2;
        }
      }
      __syncwarp();  // all of warp 0 has read s_key before any store
      if (lane < c) {
        Candidate cand{key, idx, 0.f, 0.f, 0.f};
        if (cnt > 0) {  // then the winner lies in this slice
          const float4 q = buf[idx - lo];
          cand.x = q.x;
          cand.y = q.y;
          cand.z = q.z;
        }
        store_remote(map_rank(&slots[j & 1][rank], lane),
                     map_rank(&arrived[j & 1], lane), cand);
      }
    }
    mark(3);
    mbarrier_wait(&arrived[j & 1], (j >> 1) & 1);
    // re-armed for pick j + 2 before this block can send pick j + 1, which
    // its peers wait for before they store pick j + 2
    if (tid == 0 && j + 2 < m) mbarrier_expect(&arrived[j & 1],
                                               kCandidateBytes * c);
    mark(4);
    // every thread reduces the C candidates in a tree; rank order is index
    // order, so a tie keeps the lower rank; the winner's point travels with
    // it
    const Candidate* slot = slots[j & 1];
    unsigned keys[kMaxCluster];
    int ranks[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      keys[r] = r < c ? slot[r].key : 0u;  // below every real key
      ranks[r] = r;
    }
    auto fold = [&](int lower, int upper) {
      if (keys[upper] > keys[lower]) {
        keys[lower] = keys[upper];
        ranks[lower] = ranks[upper];
      }
    };
#pragma unroll
    for (int step = 1; step < kMaxCluster; step *= 2) {
#pragma unroll
      for (int r = 0; r < kMaxCluster; r += 2 * step) fold(r, r + step);
    }
    const int win = ranks[0];
    cx = slot[win].x;
    cy = slot[win].y;
    cz = slot[win].z;
    if (rank == 0 && tid == 0) o[j] = static_cast<int>(slot[win].idx);
    mark(5);
  }
  if constexpr (kSplit) {
    if (blockIdx.x == 0 && tid == 0) {
      for (int stage = 0; stage < kStages; ++stage)
        split_cycles[stage] = static_cast<float>(cycles[stage]) / m;
    }
  }
  // no block leaves while a peer may still store into its shared memory
  cluster.sync();
}

using FpsKernel = void (*)(const float*, const uint8_t*, float4*, int*, int,
                           int, int);

FpsKernel kernel_for(int storage) {
  switch (storage) {
    case kDevice: return fps_kernel<kDevice>;
    case kShared: return fps_kernel<kShared>;
    case kRegisters8: return fps_kernel<kRegisters8>;
    case kRegisters16: return fps_kernel<kRegisters16>;
    default: return nullptr;
  }
}

}  // namespace

// pts (b, n, 3) float32, valid (b, n) uint8, scratch (b, n) float4 (used
// for kDevice only) -> out (b, m) int32 indices in pick order.  One cluster
// of `cluster` blocks (1 to 8) per cloud, each keeping its slice of
// ceil(n / cluster) points where `storage` (a Storage) says.  Needs
// n >= 1, m >= 1.
extern "C" int threepu_fps(const float* pts, const uint8_t* valid,
                           float4* scratch, int* out, int b, int n, int m,
                           int cluster, int storage, cudaStream_t stream) {
  if (cluster < 1 || cluster > kMaxCluster) return cudaErrorInvalidValue;
  const int slice = (n + cluster - 1) / cluster;
  const FpsKernel kernel = kernel_for(storage);
  if (kernel == nullptr
      || (reg_points(storage) > 0 && slice > reg_points(storage) * kThreads))
    return cudaErrorInvalidValue;
  // the opt-in dynamic shared memory of a slice kept in shared memory
  const size_t smem = storage == kDevice
                          ? 0 : static_cast<size_t>(slice) * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(b * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, pts, valid, scratch, out, n, m,
                           slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef THREEPU_FPS_SPLIT
// Into out[0..5], host memory: block 0's mean cycles per pick in each
// stage of a pick, from the last threepu_fps launch that has ended.
extern "C" int threepu_fps_split(float* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, split_cycles, sizeof(split_cycles)));
}
#endif
