// The relation-oracle pair tail's forward tile, shared by the forward kernel
// (relation_oracle.cu) and the backward kernel (relation_oracle_bwd.cu).
//
// A tile is kPairs = 64 object pairs of one question. For each pair
//
//   z1 = h_s[b,i] + h_o[b,j] + geom[b,i,j] @ Wg + b0,  h1 = elu(z1)          (H)
//   z2 = h1 @ W2,  h2 = sigmoid(z2 + b2)                                      (E)
//   logit[r] = h2 . e_sel[b,r] + b_sel[b,r]                                   (R slots)
//
// h1 is built in shared memory ([pair][h]), and z2 = h1 W2 runs on the tensor
// cores: mma.sync.m16n8k8 in TF32 with the split-precision ("3xTF32") scheme.
// Each f32 operand x becomes a TF32 big part round(x) plus the residual
// x - big (which the tensor core truncates to TF32), and the product is
// small*big + big*small + big*big with f32 accumulators (the small*small
// term, ~2^-22 of the product, is dropped).
// That keeps float32-level error at a third of the TF32 tensor-core rate; a
// single TF32 term would keep only a 10-bit mantissa. The split is done in
// registers as fragments are loaded.
//
// Any width H and E (multiples of 4, which the callers pad to with zeros) is
// taken in slices of at most kSliceH hidden units and kSliceE code columns:
// z2 accumulates over the H slices, h1 is rebuilt for each, and the logits
// are summed over the E slices. A width within one slice runs one iteration
// of each loop, so the tile's row lengths stay the compile-time slice sizes.
//
// A kernel's warps form a Layout: 2 along the pairs (32 rows, two m16 tiles
// each) x kWN along the output columns. The weights stream through a ring of
// stages of sixteen k-rows in shared memory, filled by cp.async (16-byte
// copies, zero-fill past the matrix), so W2 crosses L2 once per 64-pair tile,
// the copies of the next stages overlap the products of the current one and
// the block meets at a barrier once per two k-steps.
//
// Pair tiles in shared memory use an XOR swizzle (`at`) so that both fragment
// patterns that read them are free of bank conflicts: row = fragment row g,
// column = k-index t (an A operand with the pairs as rows), and row = k-index
// t, column = g (the pairs as the K axis of the backward's dW2 product).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pair_tail {

constexpr int kPairs = 64;              // pairs per tile
constexpr int kSliceH = 256;            // hidden units per slice of H
constexpr int kSliceE = 320;            // pair-code columns per slice of E
constexpr int kWidthMultiple = 4;       // H and E: 16-byte weight rows for cp.async
constexpr int kLdH = kSliceH;           // floats per row of the [pair][h] tile
constexpr int kLdE = kSliceE;           // floats per row of the [pair][e] tile
constexpr int kRChunk = 8;              // relation slots per register pass

// The relation hidden width H and pair-code width E the kernels take: any,
// as multiples of 4 (the callers zero-pad other widths).
__host__ __device__ constexpr bool widths_ok(int H, int E) {
  return H > 0 && E > 0 && H % kWidthMultiple == 0 && E % kWidthMultiple == 0;
}

__host__ __device__ constexpr int slices(int n, int slice) { return (n + slice - 1) / slice; }

// Width of slice s of a dimension of n cut into slices of `slice`.
__host__ __device__ constexpr int slice_width(int n, int slice, int s) {
  return n - s * slice < slice ? n - s * slice : slice;
}

// slice_width in a kernel instance that takes its widths in slices
// (kSliced) or as one slice (not kSliced): the latter gets the width itself,
// so the compiler keeps no second, clamped copy of it live.
template <bool kSliced>
__host__ __device__ constexpr int width_of(int n, int slice, int s) {
  return kSliced ? slice_width(n, slice, s) : n;
}

// Warps: 2 along the pairs x kWN along the columns. A padded width (Hp, Ep)
// is a multiple of kCols, so each column warp takes nt(np) n8 tiles.
template <int kWN_>
struct Layout {
  static constexpr int kWN = kWN_;
  static constexpr int kThreads = 64 * kWN;
  static constexpr int kCols = 8 * kWN;
  static constexpr int kZ2Tiles = kSliceE / kCols;  // n8 tiles per warp of z2, at most
  __device__ static int wm() { return (threadIdx.x >> 5) / kWN; }
  __device__ static int wn() { return (threadIdx.x >> 5) % kWN; }
  __host__ __device__ static int pad(int n) { return (n + kCols - 1) / kCols * kCols; }
};

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Offset of (row, col) in a swizzled tile with `ld` (a multiple of 32) floats
// per row: the column's bits 2-4 are XORed with the row's low three bits. The
// tiles' row lengths are the compile-time kLdH / kLdE whatever H and E are, so
// unrolled loops over rows address them with immediate offsets.
__device__ __forceinline__ int at(int row, int col, int ld) {
  return row * ld + (col ^ (((row & 3) << 3) | (row & 4)));
}

__device__ __forceinline__ float elu_exp(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

__device__ __forceinline__ float elu_grad(float x) { return x > 0.f ? 1.f : expf(fminf(x, 0.f)); }

// 1 / (1 + e^-x) with the fast exponential and division (a few ulp, far
// inside the kernels' 1e-4 gates); the ELU keeps the accurate expf.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// z1 of pair (i, j) of question b at hidden unit h, g4 its four geometry
// features: the expression build_h1 evaluates, so a recompute sees its bits.
__device__ __forceinline__ float pre_activation(const float* __restrict__ h_s,
                                                const float* __restrict__ h_o,
                                                const float* __restrict__ w_g,
                                                const float* __restrict__ b0, float4 g4,
                                                int b, int i, int j, int h, int O, int H) {
  const float gw = g4.x * w_g[h] + g4.y * w_g[H + h] + g4.z * w_g[2 * H + h] +
                   g4.w * w_g[3 * H + h];
  return (h_s[(static_cast<size_t>(b) * O + i) * H + h] +
          h_o[(static_cast<size_t>(b) * O + j) * H + h]) +
         gw + b0[h];
}

// ---- 3xTF32 on mma.sync ------------------------------------------------------

// x rounded to TF32 (a 10-bit mantissa; to nearest, ties away from zero, as
// cvt.rna.tf32.f32 rounds), on the bits: half a TF32 ulp is added to the
// magnitude and the 13 low bits cleared. Two integer operations at the full
// ALU rate, where cvt runs on the conversion pipe at a quarter of it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = big + small: big is x rounded to TF32, small the exact float32
// remainder, which the tensor core reads as TF32 by dropping its 13 low bits
// (an error of at most 2^-22 of x, the size of the small x small term that
// 3xTF32 leaves out).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[mt][n0 + j] += a[mt] b[j] in 3xTF32 for the two m16 tiles and the G
// n8 tiles j < G with n0 + j < n_live: the two residual terms first, then
// big x big. Each term is issued for all 2G tiles before the next, so the
// three dependent products of one tile are 2G instructions apart.
template <int G, int NT>
__device__ __forceinline__ void mma3_group(float (&acc)[2][NT][4], int n0, int n_live,
                                           const uint32_t (&a_big)[2][4],
                                           const uint32_t (&a_small)[2][4],
                                           const uint32_t (&b_big)[G][2],
                                           const uint32_t (&b_small)[G][2]) {
#pragma unroll
  for (int term = 0; term < 3; ++term)
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (n0 + j >= n_live) continue;
        if (term == 0) mma_tf32(acc[mt][n0 + j], a_small[mt], b_big[j][0], b_big[j][1]);
        if (term == 1) mma_tf32(acc[mt][n0 + j], a_big[mt], b_small[j][0], b_small[j][1]);
        if (term == 2) mma_tf32(acc[mt][n0 + j], a_big[mt], b_big[j][0], b_big[j][1]);
      }
}

// A fragment (m16 x k8) of a swizzled [pair][ld] tile: rows r0 and r0 + 8,
// columns k and k + 4 (r0 = tile row + g, k = k-step * 8 + t), split.
__device__ __forceinline__ void load_a(const float* tile, int ld, int r0, int k,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(tile[at(r0, k, ld)], big[0], small[0]);
  split(tile[at(r0 + 8, k, ld)], big[1], small[1]);
  split(tile[at(r0, k + 4, ld)], big[2], small[2]);
  split(tile[at(r0 + 8, k + 4, ld)], big[3], small[3]);
}

// ---- cp.async ring of weight rows ---------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The ring: kRingRows weight rows (two k-steps) per stage, kRingStride
// floats per row (= 8 (mod 32): the B fragment loads are free of bank
// conflicts). The weights arrive as they are and are split by each warp that
// reads a fragment.
constexpr int kRingRows = 16;
constexpr int kRingStride = kSliceE + 8;
constexpr int kStageFloats = kRingRows * kRingStride;

// Rows k0..k0 + kRingRows - 1, columns [0, np) of the n_rows x n_cols weight
// block w (row-major, ld floats per row) into one ring stage; what lies
// outside the block is zero-filled. n_cols, ld and w's offset are multiples
// of 4 (16-byte copies). kThreads / kRingRows threads copy a row.
template <int kThreads>
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ w, int ld,
                                           int k0, int n_rows, int n_cols, int np) {
  constexpr int kPerRow = kThreads / kRingRows;
  const int r = threadIdx.x / kPerRow;
  const int k = k0 + r;
  float* dst = stage + r * kRingStride;
  const float* src = w + static_cast<size_t>(k) * ld;
  for (int c = 4 * (threadIdx.x % kPerRow); c < np; c += 4 * kPerRow) {
    const bool ok = k < n_rows && c < n_cols;
    cp_async16(dst + c, ok ? src + c : w, ok);
  }
}

// Issue the first kStages - 1 stages of a product over kp k-rows (a
// multiple of kRingRows). Every thread commits kStages - 1 groups, empty or
// not.
template <int kStages, int kThreads>
__device__ __forceinline__ void ring_prologue(float* ring, const float* __restrict__ w, int ld,
                                              int kp, int n_rows, int n_cols, int np) {
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s * kRingRows < kp) {
      load_stage<kThreads>(ring + s * kStageFloats, w, ld, s * kRingRows, n_rows, n_cols, np);
    }
    cp_commit();
  }
}

// acc[mt][nt] += A[pairs][k] W[k][n] over k < kp (a multiple of kRingRows):
// A a swizzled [kPairs][kLda] tile, split into TF32 parts as its fragments
// load; W (n_rows x n_cols) streamed through the ring, which ring_prologue
// has started. The warp's output columns are [wn * nt_w * 8, (wn + 1) *
// nt_w * 8) with nt_w = np / kCols n8 tiles (<= NT). Starts every stage with
// a block barrier, so writes to A made before the call are visible, and ends
// with one, so the ring and A may be reused.
template <class L, int NT, int kStages, int kLda>
__device__ __forceinline__ void ring_product(float (&acc)[2][NT][4], const float* a_tile,
                                             int kp, float* ring,
                                             const float* __restrict__ w, int ld,
                                             int n_rows, int n_cols, int np) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = np / L::kCols;
  const int n_base = L::wn() * nt_w * 8 + g;
  const int r0 = L::wm() * 32 + g;
  const int stages = kp / kRingRows;
  for (int st_i = 0; st_i < stages; ++st_i) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int next = st_i + kStages - 1;
    if (next < stages) {
      load_stage<L::kThreads>(ring + (next % kStages) * kStageFloats, w, ld, next * kRingRows,
                              n_rows, n_cols, np);
    }
    cp_commit();
    const float* st = ring + (st_i % kStages) * kStageFloats;
#pragma unroll
    for (int kk = 0; kk < kRingRows; kk += 8) {
      const int k = st_i * kRingRows + kk + t;
      uint32_t a_big[2][4], a_small[2][4];
      load_a(a_tile, kLda, r0, k, a_big[0], a_small[0]);
      load_a(a_tile, kLda, r0 + 16, k, a_big[1], a_small[1]);
      constexpr int G = NT <= 5 ? NT : NT / 2;  // n8 tiles whose B fragments load together
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += G) {
        uint32_t b_big[G][2], b_small[G][2];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (n0 + j >= nt_w) continue;
          const float* row = st + (kk + t) * kRingStride + n_base + 8 * (n0 + j);
          split(row[0], b_big[j][0], b_small[j][0]);
          split(row[4 * kRingStride], b_big[j][1], b_small[j][1]);
        }
        mma3_group<G>(acc, n0, nt_w, a_big, a_small, b_big, b_small);
      }
    }
  }
  __syncthreads();
}

// ---- the forward tile ------------------------------------------------------------

// Pair p of a tile -> (i, j), false outside O x O.
struct BandPairs {  // the forward: 64 consecutive pair ids of one question
  int base, O;
  __device__ __forceinline__ bool operator()(int p, int& i, int& j) const {
    const int pid = base + p;
    i = pid / O;
    j = pid - i * O;
    return i < O;
  }
};

struct BlockPairs {  // the backward: rows i0..i0+7 x columns j0..j0+7
  int i0, j0, O;
  __device__ __forceinline__ bool operator()(int p, int& i, int& j) const {
    i = i0 + (p >> 3);
    j = j0 + (p & 7);
    return i < O && j < O;
  }
};

// Columns [e0, e0 + Es) of e_sel[b] (B, R, E) into es_s [Rp][Eps], zero past
// R and Es.
template <int kThreads>
__device__ __forceinline__ void load_esel(float* es_s, const float* __restrict__ e_sel, int b,
                                          int R, int E, int e0, int Es, int Rp, int Eps) {
  const float* src = e_sel + static_cast<size_t>(b) * R * E + e0;
  for (int k = threadIdx.x; k < Rp * Eps; k += kThreads) {
    const int r = k / Eps;
    const int e = k - r * Eps;
    es_s[k] = (r < R && e < Es) ? src[r * E + e] : 0.f;
  }
}

// The tile's pair table pij_s [kPairs] ((i, j), or (-1, -1) outside O x O)
// and its geometry geom_s [kPairs][4] (zero outside O x O).
template <class Pairs>
__device__ __forceinline__ void load_pairs(int2* pij_s, float* geom_s,
                                           const float* __restrict__ geom, int b, int O,
                                           const Pairs& pairs) {
  const int k = threadIdx.x;
  if (k < kPairs * 4) {
    int i, j;
    const bool ok = pairs(k >> 2, i, j);
    geom_s[k] = ok ? geom[(static_cast<size_t>(b) * O * O + static_cast<size_t>(i) * O + j) * 4 +
                          (k & 3)]
                   : 0.f;
    if ((k & 3) == 0) pij_s[k >> 2] = ok ? make_int2(i, j) : make_int2(-1, -1);
  }
}

// Hidden units [h0, h0 + Hs) of the tile's h1 into the swizzled h1s
// [kPairs][kLdH] (column h - h0), zero outside O x O and past Hs (up to Hps).
// Thread tid builds column tid % kLdH of every (kThreads / kLdH)-th pair.
// Reads pij_s, geom_s.
template <int kThreads>
__device__ __forceinline__ void build_h1(float* h1s, const int2* pij_s, const float* geom_s,
                                         const float* __restrict__ h_s,
                                         const float* __restrict__ h_o,
                                         const float* __restrict__ w_g,
                                         const float* __restrict__ b0, int b, int O, int H,
                                         int h0, int Hs, int Hps) {
  constexpr int kStep = kThreads / kLdH;
  const int h = threadIdx.x % kLdH;
  const int p0 = threadIdx.x / kLdH;
  if (h >= Hps) return;
  if (h >= Hs) {
    for (int p = p0; p < kPairs; p += kStep) h1s[at(p, h, kLdH)] = 0.f;
    return;
  }
  const int hg = h0 + h;
  const float* hs = h_s + static_cast<size_t>(b) * O * H + hg;
  const float* ho = h_o + static_cast<size_t>(b) * O * H + hg;
  const float wg0 = w_g[hg], wg1 = w_g[H + hg], wg2 = w_g[2 * H + hg], wg3 = w_g[3 * H + hg];
  const float bias = b0[hg];
#pragma unroll 8
  for (int p = p0; p < kPairs; p += kStep) {
    const int2 ij = pij_s[p];
    float v = 0.f;
    if (ij.x >= 0) {
      const float4 g4 = *reinterpret_cast<const float4*>(geom_s + 4 * p);
      const float gw = g4.x * wg0 + g4.y * wg1 + g4.z * wg2 + g4.w * wg3;
      v = elu_exp((hs[ij.x * H] + ho[ij.y * H]) + gw + bias);
    }
    h1s[at(p, h, kLdH)] = v;
  }
}

// z2 accumulators -> h2 = sigmoid(z2 + b2) in place (0 past E); when h2_tile
// is given, also into it (swizzled [kPairs][kLdE]).
template <class L, int NT>
__device__ __forceinline__ void finish_h2(float (&acc)[2][NT][4], const float* __restrict__ b2,
                                          int E, int Ep, float* h2_tile) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = Ep / L::kCols;
  const int r0 = L::wm() * 32 + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_w) continue;
    const int e = L::wn() * nt_w * 8 + 8 * nt + 2 * t;  // E even: e, e+1 alike
    const bool live = e < E;
    const float c0 = live ? b2[e] : 0.f;
    const float c1 = live ? b2[e + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* x = acc[mt][nt] + 2 * half;
        x[0] = live ? sigmoid(x[0] + c0) : 0.f;
        x[1] = live ? sigmoid(x[1] + c1) : 0.f;
        if (h2_tile != nullptr) {
          *reinterpret_cast<float2*>(h2_tile + at(r0 + 16 * mt + 8 * half, e, kLdE)) =
              make_float2(x[0], x[1]);
        }
      }
    }
  }
}

// Each warp's partial logits over its own columns, h2 . e_sel[r], for the
// tile's pairs: lp_s [kWN][kPairs][Rp], summed over the column warps by
// logit_of (or sum_logits) in a fixed order. es_s is [Rp][Ep].
template <class L, int NT>
__device__ __forceinline__ void partial_logits(const float (&h2)[2][NT][4], const float* es_s,
                                               int Ep, int Rp, float* lp_s) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = Ep / L::kCols;
  const int wn = L::wn();
  const int r0 = L::wm() * 32 + g;
  for (int rc = 0; rc < Rp; rc += kRChunk) {
    float part[2][2][kRChunk];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < kRChunk; ++r) part[mt][half][r] = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt >= nt_w) continue;
      const int e = wn * nt_w * 8 + 8 * nt + 2 * t;
#pragma unroll
      for (int r = 0; r < kRChunk; ++r) {
        const float2 w = *reinterpret_cast<const float2*>(es_s + (rc + r) * Ep + e);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            part[mt][half][r] = fmaf(h2[mt][nt][2 * half], w.x,
                                     fmaf(h2[mt][nt][2 * half + 1], w.y, part[mt][half][r]));
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int r = 0; r < kRChunk; ++r) {
          float v = part[mt][half][r];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          part[mt][half][r] = v;
        }
    if (t == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float4* dst = reinterpret_cast<float4*>(
              lp_s + (wn * kPairs + r0 + 16 * mt + 8 * half) * Rp + rc);
          dst[0] = make_float4(part[mt][half][0], part[mt][half][1], part[mt][half][2],
                               part[mt][half][3]);
          dst[1] = make_float4(part[mt][half][4], part[mt][half][5], part[mt][half][6],
                               part[mt][half][7]);
        }
    }
  }
}

// The logit of pair p, slot r: the column warps' partials in a fixed order
// plus b_sel.
template <class L>
__device__ __forceinline__ float logit_of(const float* lp_s, int p, int r, int Rp, float bias) {
  float s = lp_s[p * Rp + r];
#pragma unroll
  for (int w = 1; w < L::kWN; ++w) s += lp_s[(w * kPairs + p) * Rp + r];
  return s + bias;
}

// Where E spans several slices: lg_s [kPairs][Rp] (+)= the column warps'
// partial logits of this slice, in a fixed order (one thread per element).
template <class L>
__device__ __forceinline__ void sum_logits(const float* lp_s, float* lg_s, int Rp, bool first) {
  for (int q = threadIdx.x; q < kPairs * Rp; q += L::kThreads) {
    float s = lp_s[q];
#pragma unroll
    for (int w = 1; w < L::kWN; ++w) s += lp_s[w * kPairs * Rp + q];
    lg_s[q] = first ? s : lg_s[q] + s;
  }
}

}  // namespace pair_tail

// The slice sizes of H and E and the multiple of both that the libraries'
// kernels take (pair_tail::widths_ok); the callers zero-pad H and E to it.
// Each library is one translation unit that includes this header once and
// exports this function.
extern "C" void dfol_pair_tail_slices(int* slice_h, int* slice_e, int* multiple) {
  *slice_h = pair_tail::kSliceH;
  *slice_e = pair_tail::kSliceE;
  *multiple = pair_tail::kWidthMultiple;
}
