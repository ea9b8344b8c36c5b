// Exact k smallest values per row, ordered by (value, index) — kernel 1.
//
// Replaces: threepu/ops/select_pallas.py, `_make_kernel` / `select_pallas`
// (k lexicographic-min sweeps over a VMEM-resident (M, N) block).  On the
// main path it serves the feature-space kNN of every DenseEdgeConv:
// d (B, 312, 312) with B = 8..320 and k = 33 (99,840 rows at level 4).
//
// What bounds it on the H100: not memory — a row of 312 floats is read
// from device memory once (125 MB at level 4, ~40 us at 3.35 TB/s) — but
// the instructions the SMs issue per row.  k sweeps over the whole row
// compare every value k times; this design touches each value a bounded
// number of times.
//
// Design: one warp per row, 8 rows per block.  The row streams once
// through registers in tiles of 32 * R columns (lane l takes columns
// l, l + 32, ...; R = ceil(N / 32) rounded up to 2, 4, 8, 10 or 16, so
// the main path's N = 312 is one tile of R = 10).  Each (value, index)
// becomes one 64-bit key whose integer order is the (value, index) order:
// the float's bits made monotone (-0 read as +0, which compares equal to
// it), then the index.  Each lane sorts its R keys with a fully unrolled
// Batcher odd-even merge network (32 compare-exchanges for R = 10) and
// parks the sorted run in shared memory.  Then k rounds: two `redux.sync`
// minima over the lanes' run heads (the key's high word, then the index
// among the lanes that hold it) give the warp's smallest head, which is
// compared with the head of the k smallest of the earlier tiles (a sorted
// list in shared memory, empty in the first tile); the owner pops its
// head with one shared-memory load.  A value is compared inside its
// lane's network, and then only while it heads its run.  The picks stay
// in registers (lane l holds picks l and 32 + l); values are copied
// verbatim from the row at the end.  So the result equals a stable
// ascending sort's first k columns bit for bit, including every 1e30 tie
// and rows with fewer than k unpenalized columns.  Rows must hold no NaN;
// k <= 64 and k <= N.
#include <utility>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxK = 64;

using Key = unsigned long long;
constexpr Key kSentinel = ~0ull;  // above every real key

// (value, index) as one integer ordered by value, then by index.
__device__ __forceinline__ Key make_key(float v, int i) {
  return (static_cast<Key>(threepu::ordered_bits(v)) << 32)
         | static_cast<unsigned>(i);
}

__device__ __forceinline__ void compare_exchange(Key& a, Key& b) {
  const Key lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// The compare-exchanges of Batcher's odd-even merge sort of R elements
// (any R), in order.
template <int R>
struct Network {
  int lo[R * R], hi[R * R], count;
};

template <int R>
constexpr Network<R> batcher() {
  Network<R> net{};
  for (int p = 1; p < R; p <<= 1)
    for (int k = p; k >= 1; k >>= 1)
      for (int j = k % p; j + k < R; j += 2 * k)
        for (int i = 0; i < k && i + j + k < R; ++i)
          if ((i + j) / (2 * p) == (i + j + k) / (2 * p)) {
            net.lo[net.count] = i + j;
            net.hi[net.count] = i + j + k;
            ++net.count;
          }
  return net;
}

template <int R>
constexpr Network<R> kNetwork = batcher<R>();

template <int Lo, int Hi, int R>
__device__ __forceinline__ void compare_exchange_at(Key (&a)[R]) {
  compare_exchange(a[Lo], a[Hi]);
}

template <int R, int... I>
__device__ __forceinline__ void apply_network(
    Key (&a)[R], std::integer_sequence<int, I...>) {
  (compare_exchange_at<kNetwork<R>.lo[I], kNetwork<R>.hi[I]>(a), ...);
}

// Sorts `a` ascending.  The network is built at compile time and every
// index into `a` is a template argument, so `a` stays in registers.
template <int R>
__device__ __forceinline__ void sort_run(Key (&a)[R]) {
  apply_network(a, std::make_integer_sequence<int, kNetwork<R>.count>());
}

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
select_kernel(const float* __restrict__ d, float* __restrict__ out_v,
              int* __restrict__ out_i, int rows, int n, int k) {
  __shared__ Key runs[kWarpsPerBlock][R][32];
  __shared__ Key lists[kWarpsPerBlock][kMaxK];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // whole warp; only warp-level sync below

  const float* src = d + static_cast<size_t>(row) * n;
  Key(&run)[R][32] = runs[warp];
  Key* list = lists[warp];
  // picks lane and 32 + lane of the k smallest so far
  Key mine0 = kSentinel, mine1 = kSentinel;
  for (int base = 0; base < n; base += 32 * R) {
    Key a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int col = base + 32 * t + lane;
      a[t] = col < n ? make_key(src[col], col) : kSentinel;
    }
    sort_run<R>(a);
#pragma unroll
    for (int t = 0; t < R; ++t) run[t][lane] = a[t];
    // the k smallest of the earlier tiles, sorted; a tile holds at least
    // min(N, 64) >= k columns, so the first tile needs none
    const int listed = base == 0 ? 0 : k;
    if (listed) {
      list[lane] = mine0;
      list[lane + 32] = mine1;
    }
    __syncwarp();

    Key head = a[0];
    int ptr = 0, lp = 0;
    for (int s = 0; s < k; ++s) {
      const unsigned hk = static_cast<unsigned>(head >> 32);
      const unsigned kmin = __reduce_min_sync(threepu::kFullMask, hk);
      const unsigned imin = __reduce_min_sync(
          threepu::kFullMask, hk == kmin ? static_cast<unsigned>(head) : ~0u);
      Key pick = (static_cast<Key>(kmin) << 32) | imin;
      const Key lh = lp < listed ? list[lp] : kSentinel;
      if (lh < pick) {
        pick = lh;
        ++lp;
      } else if (head == pick) {  // indices are unique: one lane pops
        ++ptr;
        head = ptr < R ? run[ptr][lane] : kSentinel;
      }
      if (lane == (s & 31)) {
        if (s < 32) mine0 = pick;
        else mine1 = pick;
      }
    }
    __syncwarp();  // every lane is done with run[] and list[]
  }

  float* ov = out_v + static_cast<size_t>(row) * k;
  int* oi = out_i + static_cast<size_t>(row) * k;
  if (lane < k) {
    const int i = static_cast<int>(static_cast<unsigned>(mine0));
    oi[lane] = i;
    ov[lane] = src[i];
  }
  if (lane + 32 < k) {
    const int i = static_cast<int>(static_cast<unsigned>(mine1));
    oi[lane + 32] = i;
    ov[lane + 32] = src[i];
  }
}

template <int R>
cudaError_t launch(const float* d, float* out_v, int* out_i, int rows, int n,
                   int k, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  select_kernel<R><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      d, out_v, out_i, rows, n, k);
  return cudaGetLastError();
}

}  // namespace

// d (rows, n) float32 -> out_v (rows, k) float32, out_i (rows, k) int32.
// Needs 1 <= k <= min(n, 64) (the wrapper checks it).
extern "C" int threepu_select(const float* d, float* out_v, int* out_i,
                              int rows, int n, int k, cudaStream_t stream) {
  if (k < 1 || k > kMaxK || k > n) return cudaErrorInvalidValue;
  using Launch = cudaError_t (*)(const float*, float*, int*, int, int, int,
                                 cudaStream_t);
  const int per_lane = (n + 31) / 32;
  const Launch run =
      per_lane <= 2 ? launch<2> : per_lane <= 4 ? launch<4>
      : per_lane <= 8 ? launch<8> : per_lane <= 10 ? launch<10> : launch<16>;
  return static_cast<int>(run(d, out_v, out_i, rows, n, k, stream));
}
