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
// What bounds it on the H100: the pick chain is sequential, and each call
// has only B = 8 clouds.  One block per cloud leaves 124 of 132 SMs idle,
// and every pick is a full pass over the cloud plus two block barriers,
// so the kernel is bound by the latency of one SM's pass through L2
// (12 B of point and 8 B of carry traffic per point and pick), not by
// bandwidth or arithmetic.  That is recorded, not fixed, here: splitting a
// cloud across a cluster of SMs is later work.
//
// Design: one block of 1024 threads per cloud.  The min-distance carry
// lives in a global scratch array (8 x 29,952 x 4 B stays L2-resident).
// Each pick: every thread updates its strided share of the carry and
// keeps its (max, lowest index); a warp-shuffle argmax, then one across
// the 32 warps, picks the winner, which is written straight to the index
// list (no stamps, no sort).  Semantics of `fps_indices` +
// `sanitize_points`: seed = first valid index (0 if none), carry 1e10 on
// valid points and -inf on masked or non-finite ones, ties to the lowest
// index, non-finite coordinates read as 0 where they are a pick's centre.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kInitDist = 1e10f;

__device__ __forceinline__ bool finite3(float x, float y, float z) {
  return isfinite(x) && isfinite(y) && isfinite(z);
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
           float* __restrict__ temp, int* __restrict__ out, int n, int m) {
  __shared__ float s_v[kWarps];
  __shared__ int s_i[kWarps];
  __shared__ int s_pick;

  const int b = blockIdx.x;
  const float* p = pts + static_cast<size_t>(b) * n * 3;
  const uint8_t* ok = valid + static_cast<size_t>(b) * n;
  float* t = temp + static_cast<size_t>(b) * n;
  int* o = out + static_cast<size_t>(b) * m;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // carry init; the seed is the first valid point (argmax of the mask)
  float seed_v = -INFINITY;
  int seed_i = INT_MAX;
  for (int i = tid; i < n; i += kThreads) {
    const bool live = ok[i] && finite3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
    t[i] = live ? kInitDist : -INFINITY;
    if (live && seed_i == INT_MAX) {
      seed_v = 1.f;
      seed_i = i;
    }
  }
  // argmax over "is valid" with ties to the lowest index; with no valid
  // point every value is -inf and the lowest index, 0, wins
  if (seed_i == INT_MAX && tid < n) seed_i = tid;
  threepu::warp_argmax(seed_v, seed_i);
  if (lane == 0) {
    s_v[warp] = seed_v;
    s_i[warp] = seed_i;
  }
  __syncthreads();
  if (warp == 0) {
    seed_v = s_v[lane];
    seed_i = s_i[lane];
    threepu::warp_argmax(seed_v, seed_i);
    if (lane == 0) {
      o[0] = seed_i;
      s_pick = seed_i;
    }
  }
  __syncthreads();

  for (int j = 1; j < m; ++j) {
    const int last = s_pick;
    float cx = p[3 * last], cy = p[3 * last + 1], cz = p[3 * last + 2];
    if (!finite3(cx, cy, cz)) cx = cy = cz = 0.f;
    float best_v = -INFINITY;
    int best_i = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float d = threepu::sq_dist3(p[3 * i], p[3 * i + 1], p[3 * i + 2],
                                        cx, cy, cz);
      // fminf keeps -inf against a NaN distance to a non-finite point
      const float ti = fminf(t[i], d);
      t[i] = ti;
      if (ti > best_v || (ti == best_v && i < best_i)) {
        best_v = ti;
        best_i = i;
      }
    }
    threepu::warp_argmax(best_v, best_i);
    if (lane == 0) {
      s_v[warp] = best_v;
      s_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = s_v[lane];
      best_i = s_i[lane];
      threepu::warp_argmax(best_v, best_i);
      if (lane == 0) {
        o[j] = best_i;
        s_pick = best_i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// pts (b, n, 3) float32, valid (b, n) uint8, temp (b, n) float32 scratch
// -> out (b, m) int32 indices in pick order.  Needs n >= 1, m >= 1.
extern "C" int threepu_fps(const float* pts, const uint8_t* valid,
                           float* temp, int* out, int b, int n, int m,
                           cudaStream_t stream) {
  fps_kernel<<<b, kThreads, 0, stream>>>(pts, valid, temp, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
