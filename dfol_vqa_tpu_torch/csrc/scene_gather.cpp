// A batch's scene block, written on the host in one pass with no Python
// (data/features.FeatureSource.gather_unique).
//
// The block is (U_pad, O, W) float32, W = D + 6 (D feature columns, then the
// 6 geometry columns), with its mask (U_pad, O) and the int8 transfer's row
// scale (U_pad, O). For each unique scene u < U, whose k = counts[u] <= O real
// rows start at rows[u] (C-contiguous float32, k x W), one pass over those rows
// writes
//
//   block[u, :k] = the rows        block[u, k:] = 0
//   mask[u, :k]  = 1               mask[u, k:]  = 0
//   scale[u, r]  = max(|max(max_c x, -min_c x)| / 127, SCALE_FLOOR) over the
//                  D feature columns of row r < k, SCALE_FLOOR past k
//
// and the padded scenes u >= U get zeros, mask 0 and SCALE_FLOOR. The scale is
// bitwise that of features.row_scale (numpy's float32 max, min, division by
// 127 and maximum with 1e-12): the largest |x| is exact in any order and the
// division is IEEE float32. A NaN in a row's features gives a NaN scale: the
// row's first NaN, sign cleared, which is numpy's bits where the row's NaNs
// share one payload (numpy's own NaN); of several payloads numpy keeps
// whichever its reduction meets.
//
// What bounds it: memory. A batch of cur5 writes ~105 MB (128 x 100 x 2,054
// float32) and reads its ~77 scenes' rows once. The scenes are dealt to
// `threads` threads from one atomic counter, the calling thread among them;
// Python calls this once per batch through ctypes, which holds no GIL for
// the call. Build: the host's C++ compiler (ops/cuda_build.HOST_FLAGS), no
// flag that changes float results.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <system_error>
#include <thread>
#include <vector>

namespace {

typedef float v4f __attribute__((vector_size(16)));
typedef int32_t v4i __attribute__((vector_size(16)));

// features.SCALE_FLOOR as numpy holds it in float32: the double 1e-12 rounded
const float kFloor = static_cast<float>(1e-12);
const int64_t kGeom = 6;  // features.GEOM_DIM

inline v4f load4(const float* p) {
  v4f v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

inline void store4(float* p, v4f v) { std::memcpy(p, &v, sizeof v); }

inline v4f pick(v4i take, v4f a, v4f b) {  // a where take, else b
  return reinterpret_cast<v4f>((reinterpret_cast<v4i>(a) & take) |
                               (reinterpret_cast<v4i>(b) & ~take));
}

// Copies one row of W floats and returns the scale of its first D.
float copy_row(const float* src, float* dst, int64_t D, int64_t W) {
  const float inf = std::numeric_limits<float>::infinity();
  v4f hi0 = {-inf, -inf, -inf, -inf}, hi1 = hi0;
  v4f lo0 = {inf, inf, inf, inf}, lo1 = lo0;
  v4i nan = {0, 0, 0, 0};
  int64_t c = 0;
  for (; c + 8 <= D; c += 8) {
    v4f a = load4(src + c), b = load4(src + c + 4);
    store4(dst + c, a);
    store4(dst + c + 4, b);
    hi0 = pick(a > hi0, a, hi0);
    hi1 = pick(b > hi1, b, hi1);
    lo0 = pick(a < lo0, a, lo0);
    lo1 = pick(b < lo1, b, lo1);
    nan |= (a != a) | (b != b);
  }
  float hi = -inf, lo = inf;
  bool has_nan = false;
  for (int i = 0; i < 4; ++i) {
    hi = hi0[i] > hi ? hi0[i] : hi;
    hi = hi1[i] > hi ? hi1[i] : hi;
    lo = lo0[i] < lo ? lo0[i] : lo;
    lo = lo1[i] < lo ? lo1[i] : lo;
    has_nan |= nan[i] != 0;
  }
  for (; c < D; ++c) {
    const float v = src[c];
    dst[c] = v;
    hi = v > hi ? v : hi;
    lo = v < lo ? v : lo;
    has_nan |= v != v;
  }
  std::memcpy(dst + D, src + D, (W - D) * sizeof(float));
  float peak = hi > -lo ? hi : -lo;
  if (has_nan) {  // the row's first NaN
    int64_t i = 0;
    while (src[i] == src[i]) ++i;
    peak = src[i];
  }
  const float s = std::fabs(peak) / 127.0f;
  return s < kFloor ? kFloor : s;  // a NaN stays
}

struct Pass {
  const float* const* rows;
  const int64_t* counts;
  int64_t U, U_pad, O, W;
  float* block;
  float* mask;
  float* scale;
  std::atomic<int64_t> next{0};

  void scene(int64_t u) {
    float* out = block + u * O * W;
    float* m = mask + u * O;
    float* s = scale + u * O;
    const int64_t k = u < U ? counts[u] : 0;
    for (int64_t r = 0; r < k; ++r) {
      s[r] = copy_row(rows[u] + r * W, out + r * W, W - kGeom, W);
      m[r] = 1.0f;
    }
    std::memset(out + k * W, 0, (O - k) * W * sizeof(float));
    for (int64_t r = k; r < O; ++r) {
      m[r] = 0.0f;
      s[r] = kFloor;
    }
  }

  void work() {
    for (int64_t u = next++; u < U_pad; u = next++) scene(u);
  }
};

}  // namespace

extern "C" {

// rows (U pointers) and counts (U, each 0..O) give the unique scenes' real
// rows; block (U_pad, O, W), mask and scale (U_pad, O) are written whole.
// Runs on up to `threads` threads, the calling one included (fewer where the
// system refuses a thread). Allocates only the threads; the caller keeps
// every buffer alive for the call.
void dfol_scene_gather(const float* const* rows, const int64_t* counts, int64_t U, int64_t U_pad,
                       int64_t O, int64_t W, float* block, float* mask, float* scale,
                       int threads) {
  Pass pass{rows, counts, U, U_pad, O, W, block, mask, scale};
  std::vector<std::thread> helpers;
  for (int64_t t = 1; t < threads && t < U_pad; ++t) {
    try {
      helpers.emplace_back(&Pass::work, &pass);
    } catch (const std::system_error&) {
      break;
    }
  }
  pass.work();
  for (auto& h : helpers) h.join();
}

}  // extern "C"
