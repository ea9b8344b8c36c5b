// Host-side native code of threepu_torch: the port's own copy of the JAX
// package's threepu/native/_native.cpp.
//
// The reference falls back to a pure-python numpy FPS for file loading
// and downsampling (utils/pc_utils.py:100-126), which is O(m*N) python-loop
// slow on 100k+-point scans, and parses .xyz text with np.loadtxt.  These
// are the C++ equivalents, bound with ctypes.  They run on the host, not
// on the GPU.
//
// Build: threepu_torch.native builds on demand with
// g++ -O3 -ffp-contract=off (products and sums rounded separately, as the
// numpy and PyTorch versions round them).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Furthest point sampling over an (n, 3) float32 array.
// Selection semantics match threepu.ops.fps / the reference CUDA kernel:
// min-distance carry init 1e10, argmax each step, ties -> lowest index.
// Returns indices in selection order.
void fps_f32(const float* pts, int64_t n, int64_t m, int64_t seed,
             int32_t* out) {
  if (n <= 0 || m <= 0) return;
  if (seed < 0 || seed >= n) seed = 0;
  std::vector<float> temp(static_cast<size_t>(n), 1e10f);
  int64_t last = seed;
  out[0] = static_cast<int32_t>(seed);
  for (int64_t j = 1; j < m; ++j) {
    const float lx = pts[3 * last], ly = pts[3 * last + 1],
                lz = pts[3 * last + 2];
    float best = -1.0f;
    int64_t besti = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = pts[3 * i] - lx;
      const float dy = pts[3 * i + 1] - ly;
      const float dz = pts[3 * i + 2] - lz;
      const float d = dx * dx + dy * dy + dz * dz;
      const float t = temp[i] < d ? temp[i] : d;
      temp[i] = t;
      if (t > best) {
        best = t;
        besti = i;
      }
    }
    last = besti;
    out[j] = static_cast<int32_t>(besti);
  }
}

// Bidirectional nearest-neighbour squared distances (host Chamfer):
// for each point of a (n,3) find the min squared distance into b (m,3)
// and vice versa.  Used by the parity/benchmark harness to score
// outputs without a device round trip.
void nn_dist2_f32(const float* a, int64_t n, const float* b, int64_t m,
                  float* dist_a, int32_t* idx_a, float* dist_b,
                  int32_t* idx_b) {
  for (int64_t i = 0; i < n; ++i) {
    const float ax = a[3 * i], ay = a[3 * i + 1], az = a[3 * i + 2];
    float best = 1e30f;
    int64_t besti = 0;
    for (int64_t j = 0; j < m; ++j) {
      const float dx = ax - b[3 * j];
      const float dy = ay - b[3 * j + 1];
      const float dz = az - b[3 * j + 2];
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < best) {
        best = d;
        besti = j;
      }
    }
    dist_a[i] = best;
    idx_a[i] = static_cast<int32_t>(besti);
  }
  for (int64_t j = 0; j < m; ++j) {
    const float bx = b[3 * j], by = b[3 * j + 1], bz = b[3 * j + 2];
    float best = 1e30f;
    int64_t besti = 0;
    for (int64_t i = 0; i < n; ++i) {
      const float dx = bx - a[3 * i];
      const float dy = by - a[3 * i + 1];
      const float dz = bz - a[3 * i + 2];
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < best) {
        best = d;
        besti = i;
      }
    }
    dist_b[j] = best;
    idx_b[j] = static_cast<int32_t>(besti);
  }
}

// Fast whitespace-separated float parser for .xyz point files
// (np.loadtxt is ~20x slower on multi-MB scans).  Parses up to
// max_vals floats; returns the number parsed.
int64_t parse_floats(const char* text, int64_t len, float* out,
                     int64_t max_vals) {
  int64_t count = 0;
  const char* p = text;
  const char* end = text + len;
  while (p < end && count < max_vals) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                       *p == '\r' || *p == ','))
      ++p;
    if (p >= end) break;
    char* next = nullptr;
    const float v = strtof(p, &next);
    if (next == p) {  // not a number: skip token
      // ',' terminates the skip too (it is a separator above): a
      // number glued to a bad token by a comma must not be swallowed
      while (p < end && *p != ' ' && *p != '\t' && *p != '\n' &&
             *p != '\r' && *p != ',')
        ++p;
      continue;
    }
    out[count++] = v;
    p = next;
  }
  return count;
}

}  // extern "C"
