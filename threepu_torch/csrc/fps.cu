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
// [r * ceil(N / C), ...) of the cloud, and warp w of a block the
// contiguous run [w * 32 P, (w + 1) * 32 P) of its slice, P points a
// thread (lane l: places w * 32 P + l + 32 u, u < P), so the order of
// (rank, warp) is index order.  The slice is staged once as float4 (x, y,
// z, carry) in shared memory and, up to 16 points a thread, also held in
// registers; above 4,096 points a block the pass runs over shared memory,
// and above the opt-in dynamic shared memory over a global scratch array
// (the wrapper decides and allocates).
//
// One pick is one exchange, with no block barrier before it and no serial
// stage.  Each thread updates its points and takes their largest carry
// (an fmaxf tree; the first place that holds it comes from the same tree,
// off the critical path).  Each warp takes the largest key over its lanes
// with one `redux.sync` and a ballot: the lowest lane that holds it is
// the warp's candidate, except on a tie of real carries between lanes,
// where a second `redux.sync` takes the lowest place.  The candidate,
// its key and its point's x, y, z (16 bytes), goes into slot rank * 8 +
// warp of every block of the cluster: lanes 0..C-1 take it from the
// winning lane by shuffles and each sends it to one block with one
// `st.async` through distributed shared memory, counted as it lands on
// that block's mbarrier for the pick's parity (armed for the 8 C
// candidates' bytes by the block's thread 0); at C = 1 the winning lane
// stores it into its own block, and one __syncthreads ends the exchange,
// with no cluster scope operation.  Then every warp reduces the 8 C slots
// itself: lane l holds slots 2l and 2l + 1, one `redux.sync` takes the
// largest key, and a ballot the lowest lane that holds it: slot order is
// index order, so that is the pick, and its point comes from that lane by
// shuffles.  The winning warp's lane writes the pick's index.  Where a
// block's slice fills its shared memory (`shared`: the plan leaves 2 KiB
// beside it, too little for 2 x 64 slots of 16 bytes) a candidate is its
// key and its place in the slice (8 bytes), and the winner's point is read
// from its owner's staged slice through distributed shared memory.  A
// split of a pick's cycles by stage (this file built with
// -DTHREEPU_FPS_SPLIT, as `fps_split.py` does) chose this over a block
// argmax by warp 0 that alone stored into the peers (a __syncthreads, a
// serial 8-way stage and a tree over the C slots on every pick), and that
// over a cluster barrier of every thread per pick and over remote
// arrivals released at cluster scope (PERF.md).
//
// Why the slots and barriers may be double-buffered by the parity of the
// pick: a warp publishes pick j + 1 only after it has read its block's
// slots of pick j (its pass of pick j + 1 needs the winner of pick j).  A
// store of pick j + 2 into a block comes from a warp that has seen its
// own block's exchange of pick j + 1 end, which needs pick j + 1 from
// every warp of the cluster, so every warp has read its slots of pick j
// by then.  With C > 1, thread 0 re-arms a barrier after its wait of pick
// j, before its warp publishes pick j + 1, which every peer waits for
// before it stores pick j + 2.
//
// Semantics of `fps_indices` + `sanitize_points`: seed = first valid
// index (0 if none), carry 1e10 on valid points and -inf on masked or
// non-finite ones, the update fminf(carry, d), ties to the lowest index,
// non-finite coordinates read as 0 (they are zeroed when the slice is
// staged).  Pick 0 is a pick like the others, from a last point at +inf:
// every distance is then +inf and leaves the carries as they are, so the
// largest carry is the first valid point's 1e10.
#include <cooperative_groups.h>

#include <cmath>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// a block's slots for one pick: one candidate for each warp of the cluster
constexpr int kSlots = kWarps * kMaxCluster;
constexpr float kInitDist = 1e10f;
// the key of a masked or non-finite point (carry -inf); a lane with no
// point has key 0, below it
constexpr unsigned kInvalidKey = 0x007fffffu;

// Where a block keeps its slice as float4 (x, y, z, carry): a global
// scratch array, its shared memory, or each thread's 8 or 16 points in
// registers (over the shared-memory copy, which then serves only the
// candidate's coordinates).  The codes of the C entry points' `storage`
// argument.
enum Storage { kDevice = 0, kShared = 1, kRegisters8 = 2, kRegisters16 = 3 };

__host__ __device__ constexpr int reg_points(int storage) {
  return storage == kRegisters8 ? 8 : storage == kRegisters16 ? 16 : 0;
}

// Whether a candidate carries its point's coordinates: not where the
// staged slice fills the block's shared memory.
__host__ __device__ constexpr bool sends_point(int storage) {
  return storage != kShared;
}

// A candidate in its slot: its key, then the bits of its point's x, y, z,
// or (where the point stays behind) its place in its block's slice.
template <int kStorage>
using Slot = std::conditional_t<sends_point(kStorage), uint4, uint2>;

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
__device__ __forceinline__ void mbarrier_expect(unsigned bar,
                                                unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// The shared::cluster address of `p`'s place in block `rank`.
__device__ __forceinline__ unsigned map_rank(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_u32(p)), "r"(rank));
  return out;
}

// A candidate into `slot` of a block, counted on that block's barrier
// `bar` as it lands (both shared::cluster addresses): no fence, the
// barrier's phase ends when the bytes are there.
__device__ __forceinline__ void store_remote(unsigned slot, unsigned bar,
                                             uint4 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];"
      :: "r"(slot), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void store_remote(unsigned slot, unsigned bar,
                                             uint2 v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];"
      :: "r"(slot), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

// x, y, z of the staged point at shared::cta address `a`; its carry is
// left unread, as its owner may be updating it
__device__ __forceinline__ float4 point_at(unsigned a) {
  float4 q;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(q.x), "=f"(q.y) : "r"(a) : "memory");
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(q.z) : "r"(a + 8) : "memory");
  q.w = 0.f;
  return q;
}

// A slot by its shared::cta address.  The kernel keeps 32-bit addresses
// of its shared memory in registers and reads and writes through them:
// from C++ pointers the compiler rebuilt each address on every pick.
__device__ __forceinline__ uint4 load_slot(unsigned a, uint4) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 load_slot(unsigned a, uint2) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
               : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void store_slot(unsigned a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void store_slot(unsigned a, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};"
               :: "r"(a), "r"(v.x), "r"(v.y) : "memory");
}

// The lowest lane of a nonzero ballot: its lowest bit, converted exactly
// to a float, has that lane as its exponent (an integer-to-float
// conversion is quicker than a bit scan here).
__device__ __forceinline__ int lowest_lane(unsigned ballot) {
  const unsigned low = ballot & (0u - ballot);
  return static_cast<int>(__float_as_uint(__uint2float_rz(low)) >> 23) - 127;
}

// point_at for address `a`'s place in block `rank`'s shared memory
__device__ __forceinline__ float4 load_remote(unsigned a, unsigned rank) {
  asm volatile("mapa.shared::cluster.u32 %0, %0, %1;" : "+r"(a) : "r"(rank));
  float4 q;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];"
               : "=f"(q.x), "=f"(q.y) : "r"(a) : "memory");
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(q.z) : "r"(a + 8) : "memory");
  q.w = 0.f;
  return q;
}

// Waits until the phase of the barrier at shared::cta address `bar` with
// this parity has ended.  The wait acquires at CTA scope: what it guards
// is only the candidates that st.async wrote into this block's shared
// memory, which are there once the phase has ended; at cluster scope it
// would also invalidate the SM's L1 cache on every pick.
__device__ __forceinline__ void mbarrier_wait(unsigned bar,
                                              unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

// The largest of `v`'s K values (K a power of two) by a tree of fmaxf, and
// in `first` the first place that holds it, from the same tree: a node's
// first place is its left child's where that child holds the largest
// (only the nodes on the way to it matter).
template <int K>
__device__ __forceinline__ float thread_argmax(const float (&v)[K],
                                               int& first) {
  float t[2 * K];  // t[1] the root, t[i]'s children t[2i] and t[2i + 1]
#pragma unroll
  for (int u = 0; u < K; ++u) t[K + u] = v[u];
#pragma unroll
  for (int i = K - 1; i >= 1; --i) t[i] = fmaxf(t[2 * i], t[2 * i + 1]);
  int at[2 * K];
#pragma unroll
  for (int u = 0; u < K; ++u) at[K + u] = u;
#pragma unroll
  for (int i = K - 1; i >= 1; --i)
    at[i] = t[2 * i] == t[1] ? at[2 * i] : at[2 * i + 1];
  first = at[1];
  return t[1];
}

// Built with -DTHREEPU_FPS_SPLIT, thread 0 of block 0 also keeps its mean
// cycles per pick in each stage of a pick (slice pass, warp argmax,
// publish, the exchange's wait, the reduction of the slots) in
// split_cycles, which threepu_fps_split reads.
#ifdef THREEPU_FPS_SPLIT
constexpr bool kSplit = true;
#else
constexpr bool kSplit = false;
#endif
constexpr int kStages = 5;
__device__ float split_cycles[kStages];

// kStorage: a Storage; `buf` is the block's dynamic shared memory, or for
// kDevice the cloud's slice of `scratch` (b, n) float4.
template <int kStorage>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           float4* __restrict__ scratch, int* __restrict__ out, int n, int m,
           int slice) {
  using SlotT = Slot<kStorage>;
  constexpr bool kSendsPoint = sends_point(kStorage);
  constexpr bool kInRegisters = reg_points(kStorage) > 0;
  extern __shared__ float4 staged_smem[];
  // slot rank * 8 + warp holds that warp's candidate of a pick of each
  // parity
  __shared__ SlotT slots[2][kSlots];
  __shared__ unsigned long long arrived[2];

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
  const int mine = rank * kWarps + warp;
  const int n_slots = kWarps * c;
  const unsigned bytes = sizeof(SlotT) * n_slots;
  // this thread's points: places first_place + 32 u of the slice, u < per
  constexpr int kRegs = kInRegisters ? reg_points(kStorage) : 1;
  const int per = kInRegisters ? kRegs : (slice + kThreads - 1) / kThreads;
  const int first_place = warp * 32 * per + lane;
  const bool has = first_place < cnt;

  // stage the slice, sanitized
  for (int t = tid; t < cnt; t += kThreads) {
    const float* p = pts + 3 * (base + t);
    float x = p[0], y = p[1], z = p[2];
    const bool fin = finite3(x, y, z);
    const bool live = valid[base + t] && fin;
    if (!fin) x = y = z = 0.f;
    buf[t] = make_float4(x, y, z, live ? kInitDist : -INFINITY);
  }
  // arrived[p] ends a phase when every warp of the cluster has stored its
  // candidate of a pick of parity p here: thread 0 arms each phase for the
  // 8 C candidates' bytes, before any peer can store them; no peer may
  // store before the barriers are initialised
  if (tid == 0 && c > 1) {
    for (int p = 0; p < 2; ++p) {
      mbarrier_init(&arrived[p], 1);
      mbarrier_expect(smem_u32(&arrived[p]), bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();

  // in registers: place first_place + 32 u in register u (a carry of -inf
  // past the slice's end)
  float rx[kRegs], ry[kRegs], rz[kRegs], rw[kRegs];
  if constexpr (kInRegisters) {
#pragma unroll
    for (int u = 0; u < kRegs; ++u) {
      const int t = first_place + 32 * u;
      const float4 q = t < cnt ? buf[t] : make_float4(0.f, 0.f, 0.f, -INFINITY);
      rx[u] = q.x;
      ry[u] = q.y;
      rz[u] = q.z;
      rw[u] = q.w;
    }
  }

  // shared::cta addresses of the staged slice, the slots and the barriers
  const unsigned staged = smem_u32(staged_smem);
  const unsigned slots_at = smem_u32(&slots[0][0]);
  constexpr unsigned kParityBytes = sizeof(slots[0]);
  const unsigned bar0 = smem_u32(&arrived[0]);
  // lane r < C: the shared::cluster addresses of this warp's slot in block
  // r, for parities 0 and 1, and of that block's barriers
  unsigned to_slot0 = 0, to_slot1 = 0, to_bar0 = 0, to_bar1 = 0;
  if (c > 1 && lane < c) {
    to_slot0 = map_rank(&slots[0][mine], lane);
    to_slot1 = map_rank(&slots[1][mine], lane);
    to_bar0 = map_rank(&arrived[0], lane);
    to_bar1 = map_rank(&arrived[1], lane);
  }
  // a lane with no point takes key 0
  const unsigned key_mask = has ? ~0u : 0u;

  long long cycles[kStages] = {};
  long long stamp = 0;
  auto mark = [&](int stage) {
    if constexpr (kSplit) {
      const long long now = clock64();
      cycles[stage] += now - stamp;
      stamp = now;
    }
  };

  float cx = INFINITY, cy = INFINITY, cz = INFINITY;
  for (int j = 0; j < m; ++j) {
    const int p = j & 1;
    if constexpr (kSplit) stamp = clock64();
    // the pass: this thread's largest carry, at place `at` of the slice
    float best_v;
    int at;
    float4 q;  // the point at `at`, read once the warp's key is on its way
    if constexpr (kInRegisters) {
#pragma unroll
      for (int u = 0; u < kRegs; ++u)
        rw[u] = fminf(rw[u], threepu::sq_dist3(rx[u], ry[u], rz[u], cx, cy,
                                               cz));
      int first;
      best_v = thread_argmax(rw, first);
      at = first_place + 32 * first;
    } else {
      // a thread's places rise with u, so a strict > keeps the first
      best_v = -INFINITY;
      at = first_place;
      q = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int u = 0; u < per; ++u) {
        const int t = first_place + 32 * u;
        if (t >= cnt) break;
        float4 r = buf[t];
        r.w = fminf(r.w, threepu::sq_dist3(r.x, r.y, r.z, cx, cy, cz));
        buf[t].w = r.w;
        if (u == 0 || r.w > best_v) {
          best_v = r.w;
          at = t;
          q = r;
        }
      }
    }
    mark(0);
    // the warp's candidate: the lowest lane with the largest key, which is
    // the lowest place unless real carries tie across lanes (a tie of
    // invalid points, key kInvalidKey, is between the lanes' first places,
    // which rise with the lane)
    const unsigned key = threepu::ordered_bits(best_v) & key_mask;
    const unsigned top = __reduce_max_sync(threepu::kFullMask, key);
    if constexpr (kInRegisters) {
      q = point_at(staged + 16u * static_cast<unsigned>(has ? at : 0));
    }
    unsigned holders = __ballot_sync(threepu::kFullMask, key == top);
    if ((holders & (holders - 1u)) != 0u && top > kInvalidKey) {
      const unsigned place = static_cast<unsigned>(at);
      const unsigned lowest =
          __reduce_min_sync(threepu::kFullMask, key == top ? place : ~0u);
      holders = __ballot_sync(threepu::kFullMask,
                              key == top && place == lowest);
    }
    const bool won = (holders & (0u - holders)) == (1u << lane);
    mark(1);
    // C = 1: the winning lane stores the candidate into its own block;
    // C > 1: lanes 0..C-1 take it from the winning lane and each stores it
    // into one block
    SlotT cand;
    if (c == 1) {
      if constexpr (kSendsPoint) {
        cand = make_uint4(top, __float_as_uint(q.x), __float_as_uint(q.y),
                          __float_as_uint(q.z));
      } else {
        cand = make_uint2(top, static_cast<unsigned>(at));
      }
      if (won) store_slot(slots_at + p * kParityBytes + warp * sizeof(SlotT),
                          cand);
      mark(2);
      __syncthreads();
    } else {
      const int src = lowest_lane(holders);
      if constexpr (kSendsPoint) {
        cand = make_uint4(
            top, __shfl_sync(threepu::kFullMask, __float_as_uint(q.x), src),
            __shfl_sync(threepu::kFullMask, __float_as_uint(q.y), src),
            __shfl_sync(threepu::kFullMask, __float_as_uint(q.z), src));
      } else {
        cand = make_uint2(top, __shfl_sync(threepu::kFullMask,
                                           static_cast<unsigned>(at), src));
      }
      if (lane < c) store_remote(p ? to_slot1 : to_slot0,
                                 p ? to_bar1 : to_bar0, cand);
      mark(2);
      mbarrier_wait(bar0 + 8u * p, (j >> 1) & 1);
      // re-armed for pick j + 2 before this warp can publish pick j + 1,
      // which every peer waits for before it stores pick j + 2
      if (tid == 0 && j + 2 < m) mbarrier_expect(bar0 + 8u * p, bytes);
    }
    mark(3);
    // every warp reduces the 8 C slots: lane l holds slots 2l and 2l + 1,
    // and the later wins only on a larger key; slot order is index order,
    // so the lowest lane with the largest key holds the pick
    SlotT s0{}, s1{};
    const unsigned here =
        slots_at + p * kParityBytes + 2 * lane * sizeof(SlotT);
    if (2 * lane < n_slots) s0 = load_slot(here, SlotT{});
    if (2 * lane + 1 < n_slots) s1 = load_slot(here + sizeof(SlotT), SlotT{});
    const bool later = s1.x > s0.x;
    const SlotT s = later ? s1 : s0;
    const unsigned best = __reduce_max_sync(threepu::kFullMask, s.x);
    const int from = lowest_lane(__ballot_sync(threepu::kFullMask,
                                               s.x == best));
    if constexpr (kSendsPoint) {
      cx = __uint_as_float(__shfl_sync(threepu::kFullMask, s.y, from));
      cy = __uint_as_float(__shfl_sync(threepu::kFullMask, s.z, from));
      cz = __uint_as_float(__shfl_sync(threepu::kFullMask, s.w, from));
    }
    const int slot = 2 * from + __shfl_sync(threepu::kFullMask,
                                            later ? 1 : 0, from);
    if constexpr (!kSendsPoint) {
      const int place = static_cast<int>(
          __shfl_sync(threepu::kFullMask, s.y, from));
      const int owner = slot / kWarps;
      const float4 w = owner == rank ? point_at(staged + 16u * place)
                                     : load_remote(staged + 16u * place,
                                                   owner);
      cx = w.x;
      cy = w.y;
      cz = w.z;
    }
    if (won && slot == mine) o[j] = lo + at;
    mark(4);
  }
  if constexpr (kSplit) {
    if (blockIdx.x == 0 && tid == 0) {
      for (int stage = 0; stage < kStages; ++stage)
        split_cycles[stage] = static_cast<float>(cycles[stage]) / m;
    }
  }
  // no block leaves while a peer may still store into or read its shared
  // memory
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
// Into out[0..4], host memory: block 0's mean cycles per pick in each
// stage of a pick, from the last threepu_fps launch that has ended.
extern "C" int threepu_fps_split(float* out) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(out, split_cycles, sizeof(split_cycles)));
}
#endif
