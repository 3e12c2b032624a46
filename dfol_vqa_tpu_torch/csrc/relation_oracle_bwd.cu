// Relation-oracle pair tail, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` in dfol_vqa_tpu/ops/pallas/relation_oracle.py
// (launched by `_pair_tail_bwd`, pallas_call at :183): the backward of the fused
// pair tail that csrc/relation_oracle.cu computes forward,
//
//   z1 = h_s[b,i] + h_o[b,j] + geom[b,i,j] @ Wg + b0,  h1 = elu(z1)          (H)
//   h2 = sigmoid(h1 @ W2 + b2)                                               (E)
//   out[b,r,i,j] = logsigmoid(h2 . e_sel[b,r] + b_sel[b,r])                  (R slots)
//
// Given the R-major cotangent g (B, R, O, O), every pair recomputes z1, h1, h2 and
// the logits on chip and forms
//
//   dlogits = g * sigmoid(-logits) * (rel_tokens != 0)      (pad slots hold a
//             constant in the forward, so they pass no gradient)
//   dz2 = (dlogits @ e_sel) * h2 * (1 - h2),  dz1 = (dz2 @ W2^T) * elu'(z1)
//
// with the ELU and its derivative in the exp(min(x,0)) form (elu' from a
// recomputed z1, bit-identical to the forward's), and accumulates dh_s, dh_o,
// dgeom, dWg, db0, dW2, db2, de_sel and db_sel.
//
// What bounds it: 6HE + 6RE FLOP per pair (475,200 at H=256, E=300, R=8), three
// H x E products per pair -- z2 = h1 W2 (recompute), dh1 = dz2 W2^T and dW2 +=
// h1^T dz2 -- so 380 GFLOP at B=80, O=100: operations, not bytes. On the CUDA
// cores (67 TFLOP/s) that is 5.7 ms; on the tensor cores in 3xTF32 (a third of
// 495 TFLOP/s) 2.2 ms. mma.sync itself reaches two thirds of that TF32 rate.
//
// Design. All three products run on the tensor cores: mma.sync.m16n8k8 in
// TF32 with the split-precision 3xTF32 scheme (pair_tail_tile.cuh), f32
// accumulators, 64 pairs per step (8 subject rows x 8 object columns), 16
// warps (2 along the pairs x 8 along the columns):
//
// * z2 = h1 W2 and dh1 = dz2 W2^T take their A operand (h1, dz2) from swizzled
//   [pair][column] tiles in shared memory and stream W2 / W2^T through a
//   three-stage cp.async ring of 16-row slices, so each weight matrix crosses
//   L2 once per 64 pairs (~8 GB at B=80, O=100; the SIMT kernel this replaces
//   read both element by element per thread, once per 32 pairs, ~15 GB);
// * dW2 += h1^T dz2 reads the same two tiles with the pair axis as K (the
//   swizzle keeps both read patterns free of bank conflicts), in 32 x 32
//   tiles per warp. The block's dW2 partial stays in global memory, in
//   contiguous 4 KB chunks, and its read-modify-write (~9 GB at B=80, O=100,
//   once per 64 pairs) goes through the bulk copy engine (cp.async.bulk load
//   into a per-warp staging chunk, add, bulk store), overlapped with the
//   products instead of stalling the warps on memory;
// * the R-sized parts (logits, dh2 = dlogits e_sel, de_sel, db_sel) and the
//   reductions of dz1 over pairs (dh_s, dh_o, db0, dWg, dgeom) stay in f32 on
//   the CUDA cores, from registers and shared memory.
//
// Reductions are deterministic partials, never atomics. A step (question b,
// kT subject rows x kT object columns) is a unit of work of its own; the
// steps, in the order (b, row band, column band), are cut into runs of `per`
// consecutive steps, one run per block of a persistent grid (the caller sizes
// it from dfol_relation_oracle_bwd_blocks_per_sm), so the blocks share them
// evenly. A block adds its steps' de_sel and db_sel into its slot of the
// question's partials, and their dh_s into its slot of the row band's: the
// blocks whose runs meet a question (a row band) take consecutive slots, and
// one thread owns each element of a slot, so the sums over steps are made in
// L2 (2.3 MB and 16.4 MB of slots at B=80, O=100 on 132 SMs, against 130 MB
// and 106 MB for partials per step and per column band). A step writes dh_o
// of its columns into the row band's partial, and dgeom per pair; dW2, dWg,
// db0 and db2 are per-block partials, and a step's dW2 loads wait for the
// step before's stores. The caller sums the partials over their
// slot/band/block axis in a fixed order, so the result is the same from run
// to run. 221 KB of shared memory at H=256, E=300, R=8: one block of 512
// threads per SM.
//
// Widths past one slice (H > 256 or E > 320, pair_tail_tile.cuh) take the
// kernel's sliced instance: the same step in three passes over the slices,
// with h2 / dz2 spilled to a per-block scratch in L2 when E spans several
// slices (see there). The shipped H=256, E=300 take the one-slice instance.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer, all
// float tensors are float32 and contiguous, rel_tokens is int32.

#include <climits>

#include "bulk_copy.cuh"
#include "pair_tail_tile.cuh"

namespace {

using namespace pair_tail;
using namespace bulk;

using L = Layout<8>;  // 16 warps: 2 along the pairs x 8 along the columns
constexpr int kThreads = L::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;
constexpr int kT = 8;  // a step: kT subject rows x kT object columns
constexpr int kDh1Tiles = kSliceH / L::kCols;     // n8 tiles per warp of dh1, at most
static_assert(kT * kT == kPairs, "a step is one tile");
static_assert(kSliceE <= kThreads, "one thread per column of an E slice");
static_assert(kLdH <= kThreads, "one thread per hidden unit");

// Floats of the ring region: the weight ring during the products; between
// them the column warps' partial logits [kWN][kPairs][Rp] and, in one slice,
// the dlogits [kPairs][Rp] or, sliced, e_sel of an E slice [Rp][kLdE].
template <bool kSliced>
__host__ __device__ int ring_floats(int Rp) {
  const int between = kSliced ? Rp * kLdE + L::kWN * kPairs * Rp : (L::kWN + 1) * kPairs * Rp;
  return between > kStages * kStageFloats ? between : kStages * kStageFloats;
}

// Floats of the region after the ring: in one slice e_sel[b] [Rp][Ep], kept
// while the steps stay on one question; sliced the logits summed over the E
// slices, then the dlogits [kPairs][Rp].
template <bool kSliced>
__host__ __device__ int tail_floats(int Rp, int Ep) {
  return kSliced ? kPairs * Rp : Rp * Ep;
}

// dz2 = (dlogits e_sel) * h2 * (1 - h2) in place of h2 in the swizzled a_s
// [kPairs][kLdE], at the positions of this thread's z2 accumulators (zero past
// E, where e_sel and h2 are zero).
__device__ __forceinline__ void store_dz2(const float* dl_s, const float* es_s, int Ep, int Rp,
                                          float* a_s) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = Ep / L::kCols;
  const int r0 = L::wm() * 32 + g;
  for (int nt = 0; nt < nt_w; ++nt) {
    const int e = L::wn() * nt_w * 8 + 8 * nt + 2 * t;
    float d[2][2][2] = {};
    for (int r = 0; r < Rp; ++r) {
      const float2 w = *reinterpret_cast<const float2*>(es_s + r * Ep + e);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float dl = dl_s[(r0 + 16 * mt + 8 * half) * Rp + r];
          d[mt][half][0] = fmaf(dl, w.x, d[mt][half][0]);
          d[mt][half][1] = fmaf(dl, w.y, d[mt][half][1]);
        }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2* x = reinterpret_cast<float2*>(a_s + at(r0 + 16 * mt + 8 * half, e, kLdE));
        const float2 h2 = *x;
        *x = make_float2(d[mt][half][0] * h2.x * (1.f - h2.x),
                         d[mt][half][1] * h2.y * (1.f - h2.y));
      }
  }
}

// dz1 = dh1 * elu'(z1) of hidden units [h0, h0 + Hs) from the dh1
// accumulators, into the swizzled h1s [kPairs][kLdH] (zero outside O x O and
// past Hs, up to Hps). z1 is recomputed.
template <int NT>
__device__ __forceinline__ void store_dz1(const float (&dh1)[2][NT][4], float* h1s,
                                          const int2* pij_s, const float* geom_s,
                                          const float* __restrict__ h_s,
                                          const float* __restrict__ h_o,
                                          const float* __restrict__ w_g,
                                          const float* __restrict__ b0, int b, int O, int H,
                                          int h0, int Hs, int Hps) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = Hps / L::kCols;
  const int r0 = L::wm() * 32 + g;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= nt_w) continue;
    const int h = L::wn() * nt_w * 8 + 8 * nt + 2 * t;  // H % 4 == 0: h, h+1 alike
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = r0 + 16 * mt + 8 * half;
        const int2 ij = pij_s[p];
        float v0 = 0.f, v1 = 0.f;
        if (h < Hs && ij.x >= 0) {
          const float4 g4 = *reinterpret_cast<const float4*>(geom_s + 4 * p);
          v0 = dh1[mt][nt][2 * half] *
               elu_grad(pre_activation(h_s, h_o, w_g, b0, g4, b, ij.x, ij.y, h0 + h, O, H));
          v1 = dh1[mt][nt][2 * half + 1] *
               elu_grad(pre_activation(h_s, h_o, w_g, b0, g4, b, ij.x, ij.y, h0 + h + 1, O, H));
        }
        *reinterpret_cast<float2*>(h1s + at(p, h, kLdH)) = make_float2(v0, v1);
      }
  }
}

// de_sel[:, e0:e0+Es] += dlogits^T h2 of the step (column e per thread), into
// the block's slot of the question's partial desel_dst (R, E); a_s holds the
// E slice's h2 [kPairs][kLdE], dl_s the dlogits [kPairs][Rp].
__device__ __forceinline__ void update_desel(const float* a_s, const float* dl_s, int Rp, int R,
                                             int E, int e0, int Es, float* __restrict__ desel_dst) {
  for (int e = threadIdx.x; e < Es; e += kThreads) {
    for (int rc = 0; rc < R; rc += kRChunk) {
      float s[kRChunk] = {};
      for (int p = 0; p < kPairs; ++p) {
        const float x = a_s[at(p, e, kLdE)];
        const float4 d0 = *reinterpret_cast<const float4*>(dl_s + p * Rp + rc);
        const float4 d1 = *reinterpret_cast<const float4*>(dl_s + p * Rp + rc + 4);
        s[0] = fmaf(d0.x, x, s[0]);
        s[1] = fmaf(d0.y, x, s[1]);
        s[2] = fmaf(d0.z, x, s[2]);
        s[3] = fmaf(d0.w, x, s[3]);
        s[4] = fmaf(d1.x, x, s[4]);
        s[5] = fmaf(d1.y, x, s[5]);
        s[6] = fmaf(d1.z, x, s[6]);
        s[7] = fmaf(d1.w, x, s[7]);
      }
#pragma unroll
      for (int r = 0; r < kRChunk; ++r) {
        if (rc + r < R) {
          desel_dst[(rc + r) * E + e0 + e] += s[r];
        }
      }
    }
  }
}

// dgeom[b, i, j, c] (+)= dz1[p] . Wg[c] over hidden units [h0, h0 + Hs) (h1s
// holds that slice's dz1), one warp per pair; the first slice writes, the
// others add.
__device__ __forceinline__ void update_dgeom(float* __restrict__ dgeom, const float* h1s,
                                             const int2* pij_s, const float* __restrict__ w_g,
                                             int b, int O, int H, int h0, int Hs, bool add) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int p = warp; p < kPairs; p += kWarps) {
    const int2 ij = pij_s[p];
    if (ij.x < 0) continue;  // warp-uniform
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = lane; h < Hs; h += 32) {
      const float dz = h1s[at(p, h, kLdH)];
#pragma unroll
      for (int c = 0; c < 4; ++c) s[c] = fmaf(dz, w_g[c * H + h0 + h], s[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
    }
    if (lane < 4) {
      float* dst = dgeom + ((static_cast<size_t>(b) * O + ij.x) * O + ij.y) * 4 + lane;
      const float v = lane == 0 ? s[0] : lane == 1 ? s[1] : lane == 2 ? s[2] : s[3];
      *dst = add ? *dst + v : v;
    }
  }
}

constexpr int kChunk = 32;                     // dW2 tiles of kChunk (h) x kChunk (e)
constexpr int kChunkFloats = kChunk * kChunk;  // 4 KB, contiguous in the partial

// The block's dW2 partial += h1^T dz2 over the step's pairs for the H slice
// in h1s (Hps wide, starting at chunk row hc0) and the E slice in a_s (Eps
// wide, starting at chunk column ec0): M = h, N = e, K = the 64 pairs, both
// operands read from the swizzled tiles with the pair axis as K. The partial
// is laid out in 32 x 32 chunks, each 4 KB and contiguous ([Hp/32][n_ec][32]
// [32], n_ec = Ep/32 for the padded E). A warp takes every kWarps-th chunk of the slices:
// it asks the bulk copy engine (TMA) for the chunk's old values into its
// staging buffer in shared memory, runs the chunk's product meanwhile, adds
// the product to the staged values and has the engine store the chunk back,
// so the read-modify-write of the partial overlaps the tensor-core work. The
// step's loads wait until the step before's stores have completed, so every
// element adds its steps in step order.
__device__ __forceinline__ void update_dw2(float* __restrict__ dw2, const float* h1s,
                                           const float* a_s, int Hps, int Eps, int hc0, int ec0,
                                           int n_ec, float* stage, uint64_t* bar,
                                           unsigned& parity) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_ec_s = Eps / kChunk;
  const int chunks = (Hps / kChunk) * n_ec_s;
  if (lane == 0) bulk_wait_all();  // the step before's stores are complete (long since)
  for (int c = warp; c < chunks; c += kWarps) {
    const int hc = c / n_ec_s;
    const int ec = c - hc * n_ec_s;
    float* chunk = dw2 + (static_cast<size_t>(hc0 + hc) * n_ec + ec0 + ec) * kChunkFloats;
    if (lane == 0) bulk_load(stage, chunk, kChunkFloats * sizeof(float), bar);
    const int h0 = hc * kChunk;
    const int e0 = ec * kChunk;
    float acc[2][4][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < kPairs / 8; ++ks) {
      const int p = 8 * ks + t;
      uint32_t a_big[2][4], a_small[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int h = h0 + 16 * mt + g;
        split(h1s[at(p, h, kLdH)], a_big[mt][0], a_small[mt][0]);
        split(h1s[at(p, h + 8, kLdH)], a_big[mt][1], a_small[mt][1]);
        split(h1s[at(p + 4, h, kLdH)], a_big[mt][2], a_small[mt][2]);
        split(h1s[at(p + 4, h + 8, kLdH)], a_big[mt][3], a_small[mt][3]);
      }
      uint32_t b_big[4][2], b_small[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(a_s[at(p, e0 + 8 * j + g, kLdE)], b_big[j][0], b_small[j][0]);
        split(a_s[at(p + 4, e0 + 8 * j + g, kLdE)], b_big[j][1], b_small[j][1]);
      }
      mma3_group<4>(acc, 0, 4, a_big, a_small, b_big, b_small);
    }
    mbar_wait(bar, parity);
    parity ^= 1u;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* x = reinterpret_cast<float2*>(stage + (16 * mt + 8 * half + g) * kChunk +
                                                8 * nt + 2 * t);
          const float2 old = *x;
          *x = make_float2(old.x + acc[mt][nt][2 * half], old.y + acc[mt][nt][2 * half + 1]);
        }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      bulk_store(chunk, stage, kChunkFloats * sizeof(float));
      bulk_wait_read();  // the staging buffer is free for the next chunk
    }
    __syncwarp();
  }
}

// Columns [e0, e0 + Eps) of the block's [kPairs][Ep] scratch <-> the
// swizzled a_s [kPairs][kLdE] (columns [0, Eps)).
__device__ __forceinline__ void spill_slice(const float* a_s, float* __restrict__ scratch, int Ep,
                                            int e0, int Eps) {
  for (int k = threadIdx.x; k < kPairs * Eps; k += kThreads) {
    const int p = k / Eps;
    const int e = k - p * Eps;
    scratch[p * Ep + e0 + e] = a_s[at(p, e, kLdE)];
  }
}

__device__ __forceinline__ void fill_slice(float* a_s, const float* __restrict__ scratch, int Ep,
                                           int e0, int Eps) {
  for (int k = threadIdx.x; k < kPairs * Eps; k += kThreads) {
    const int p = k / Eps;
    const int e = k - p * Eps;
    a_s[at(p, e, kLdE)] = scratch[p * Ep + e0 + e];
  }
}

// The block's row of small_part (grid, 4H + H + E): its dWg, db0, db2
// partials. Formed where it is used, so the one-slice instance keeps no
// pointer to it live over its steps.
__device__ __forceinline__ float* block_row(float* small_part, int H, int E) {
  return small_part + static_cast<size_t>(blockIdx.x) * (5 * H + E);
}

// kSliced: H or E spans more than one slice. Each step then makes three
// passes over the slices:
//
//  1. for each E slice, z2 = sum over the H slices of h1 W2 (h1 rebuilt per
//     H slice, built once when H is one slice) -> h2 and the partial logits,
//     added over the E slices; h2 is spilled to the block's scratch when E
//     spans several slices. The full logits then give the dlogits, so the
//     backward recomputes them rather than reading the forward's output.
//  2. for each E slice: de_sel, dz2 = (dlogits e_sel) h2 (1 - h2) in place of
//     h2, db2 (spilled back when E spans several slices).
//  3. for each H slice: h1 (rebuilt when H spans several slices), then for
//     each E slice dW2 += h1^T dz2 and dh1 += dz2 W2^T; dz1 and its sums
//     (dh_s, dh_o, dgeom added over the H slices, dWg, db0).
//
// The one-slice instantiation runs each loop once with the trip counts known
// at compile time, keeps e_sel[b] in shared memory while its steps stay on one
// question, and holds the block's dWg, db0 and db2 partials in registers over
// all its steps (thread h = tid < H: dWg[:, h], db0[h]; tid < E: db2[tid]).
// Sliced, a thread holds one unit of a slice, not of the whole width, so they
// are added step by step into the block's row of small_part (zeroed by the
// caller; one owning thread per element). Scratch: kPairs x Ep floats per
// block (Ep = E padded), in L2, when E > kSliceE.
template <bool kSliced>
__global__ void __launch_bounds__(kThreads, 1) relation_oracle_bwd_kernel(
    const float* __restrict__ h_s,       // (B, O, H)
    const float* __restrict__ h_o,       // (B, O, H)
    const float* __restrict__ geom,      // (B, O, O, 4)
    const float* __restrict__ w_g,       // (4, H)
    const float* __restrict__ b0,        // (H)
    const float* __restrict__ w2,        // (H, E)
    const float* __restrict__ w2t,       // (E, H): W2 transposed
    const float* __restrict__ b2,        // (E)
    const float* __restrict__ e_sel,     // (B, R, E)
    const float* __restrict__ b_sel,     // (B, R)
    const int* __restrict__ rel_tokens,  // (B, R)
    const float* __restrict__ cot,       // (B, R, O, O) cotangent
    float* __restrict__ dhs_part,        // (B, band_slots, O, H), zeroed by the caller
    float* __restrict__ dho_part,        // (B, nT, O, H): per-row-band partials of dh_o
    float* __restrict__ dgeom,           // (B, O, O, 4), or null when not wanted
    float* __restrict__ desel_part,      // (B, question_slots, R, E), zeroed by the caller
    float* __restrict__ dbsel_part,      // (B, question_slots, R), zeroed by the caller
    float* __restrict__ dw2_part,        // (grid, Hp/32, Ep/32, 32, 32), zeroed by the caller
    float* __restrict__ small_part,      // (grid, 4H + H + E): dWg, db0, db2
    float* __restrict__ h2_scratch,      // (grid, kPairs, Ep) when E > kSliceE, else null
    int B, int O, int H, int E, int R,
    int per,                             // steps per block, consecutive
    int band_slots, int question_slots) {
  const int Hp = L::pad(H);
  const int Ep = L::pad(E);
  const int Rp = round_up(R, kRChunk);
  const int nH = kSliced ? slices(H, kSliceH) : 1;
  const int nE = kSliced ? slices(E, kSliceE) : 1;
  extern __shared__ float4 smem4[];
  float* h1s = reinterpret_cast<float*>(smem4);  // [kPairs][kLdH]: h1, then dz1 (an H slice)
  float* a_s = h1s + kPairs * kLdH;              // [kPairs][kLdE]: h2, then dz2 (an E slice)
  float* ring = a_s + kPairs * kLdE;             // [kStages][kRingRows][kRingStride]
  float* tail = ring + ring_floats<kSliced>(Rp);
  // between the products: [kWN][kPairs][Rp] partial logits, [kPairs][Rp]
  // dlogits (sliced: the summed logits first) and e_sel [Rp][Ep] (sliced: of
  // an E slice)
  float* lp_s = kSliced ? ring + Rp * kLdE : ring;
  float* dl_s = kSliced ? tail : lp_s + L::kWN * kPairs * Rp;
  float* es_s = kSliced ? ring : tail;
  float* geom_s = tail + tail_floats<kSliced>(Rp, Ep);         // [kPairs][4]
  int2* pij_s = reinterpret_cast<int2*>(geom_s + kPairs * 4);  // [kPairs]
  float* stage_x = reinterpret_cast<float*>(pij_s + kPairs);  // a 16th dW2 staging buffer
  uint64_t* bars = reinterpret_cast<uint64_t*>(stage_x + kChunkFloats);  // [kWarps]
  // dW2 staging: warp w's chunk buffer lies in the ring, free during the dW2
  // update, except the last warp's, which has its own
  const int warp_id = threadIdx.x >> 5;
  float* stage = (warp_id + 1) * kChunkFloats <= ring_floats<kSliced>(Rp)
                     ? ring + warp_id * kChunkFloats
                     : stage_x;
  uint64_t* bar = bars + warp_id;
  unsigned parity = 0;
  if ((threadIdx.x & 31) == 0) mbar_init(bar);
  mbar_fence_init();  // before the first barrier

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nT = (O + kT - 1) / kT;  // row (and column) bands per question
  const int steps = B * nT * nT;
  const int first = blockIdx.x * per;
  const int last = min(first + per, steps);
  float* dw2 = dw2_part + static_cast<size_t>(blockIdx.x) * Hp * Ep;
  float* scratch = h2_scratch == nullptr
                       ? nullptr
                       : h2_scratch + static_cast<size_t>(blockIdx.x) * kPairs * Ep;

  // The block's dWg, db0 and db2 partials (sliced: of one H slice's step)
  float dwg[4] = {0.f, 0.f, 0.f, 0.f};
  float db0_acc = 0.f;
  float db2_acc = 0.f;

  int es_b = -1;  // one slice: the question whose e_sel rows es_s holds
  for (int step = first; step < last; ++step) {
    const int b = step / (nT * nT);
    const int it = (step / nT) % nT;
    const int jt = step % nT;
    const int i0 = it * kT;
    const int j0 = jt * kT;
    const BlockPairs pairs{i0, j0, O};
    // this block's slot of the question's (the row band's) partials: its
    // place among the blocks whose runs meet the question (the row band)
    const size_t q_slot = static_cast<size_t>(b) * question_slots + blockIdx.x -
                          b * nT * nT / per;
    const size_t band_slot = static_cast<size_t>(b) * band_slots + blockIdx.x -
                             (b * nT + it) * nT / per;
    float* desel_dst = desel_part + q_slot * R * E;

    // Pass 1 (recompute): z2 = h1 W2 -> h2 (into a_s) and the partial logits.
    ring_prologue<kStages, kThreads>(ring, w2, E, L::pad(width_of<kSliced>(H, kSliceH, 0)),
                                     width_of<kSliced>(H, kSliceH, 0),
                                     width_of<kSliced>(E, kSliceE, 0),
                                     L::pad(width_of<kSliced>(E, kSliceE, 0)));
    if (!kSliced && b != es_b) {  // no thread reads es_s between the last step's barrier and here
      load_esel<kThreads>(es_s, e_sel, b, R, E, 0, E, Rp, Ep);
      es_b = b;
    }
    load_pairs(pij_s, geom_s, geom, b, O, pairs);
    __syncthreads();
    for (int ei = 0; ei < nE; ++ei) {
      const int e0 = ei * kSliceE;
      const int Es = width_of<kSliced>(E, kSliceE, ei);
      const int Eps = L::pad(Es);
      float acc[2][L::kZ2Tiles][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::kZ2Tiles; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
      for (int hi = 0; hi < nH; ++hi) {
        const int h0 = hi * kSliceH;
        const int Hs = width_of<kSliced>(H, kSliceH, hi);
        const int Hps = L::pad(Hs);
        const float* w = w2 + static_cast<size_t>(h0) * E + e0;
        if (ei + hi > 0) ring_prologue<kStages, kThreads>(ring, w, E, Hps, Hs, Es, Eps);
        if (nH > 1 || ei == 0) {
          build_h1<kThreads>(h1s, pij_s, geom_s, h_s, h_o, w_g, b0, b, O, H, h0, Hs, Hps);
        }
        ring_product<L, L::kZ2Tiles, kStages, kLdH>(acc, h1s, Hps, ring, w, E, Hs, Es, Eps);
      }
      if (kSliced) load_esel<kThreads>(es_s, e_sel, b, R, E, e0, Es, Rp, Eps);  // the ring is free
      finish_h2<L>(acc, b2 + e0, Es, Eps, a_s);
      if (kSliced) __syncthreads();
      partial_logits<L>(acc, es_s, Eps, Rp, lp_s);
      if (kSliced) {  // the next slice's ring overwrites lp_s
        __syncthreads();
        sum_logits<L>(lp_s, dl_s, Rp, ei == 0);
        if (nE > 1) spill_slice(a_s, scratch, Ep, e0, Eps);
      }
      __syncthreads();
    }

    // dlogits (sliced: in place of the summed logits), zero on pad slots and
    // outside O x O; db_sel += their sums, into the block's slot of the
    // question's partial.
    for (int q = tid; q < Rp * kPairs; q += kThreads) {
      const int r = q / kPairs;
      const int p = q - r * kPairs;
      int i, j;
      float dl = 0.f;
      if (r < R && pairs(p, i, j) && rel_tokens[b * R + r] != 0) {
        const float bias = b_sel[b * R + r];
        const float logit = kSliced ? dl_s[p * Rp + r] + bias : logit_of<L>(lp_s, p, r, Rp, bias);
        dl = cot[(static_cast<size_t>(b * R + r) * O + i) * O + j] * sigmoid(-logit);
      }
      dl_s[p * Rp + r] = dl;
    }
    __syncthreads();
    if (tid < R) {
      float s = 0.f;
      for (int p = 0; p < kPairs; ++p) s += dl_s[p * Rp + tid];
      dbsel_part[q_slot * R + tid] += s;
    }

    // Pass 2, per E slice: de_sel += dlogits^T h2 (column e per thread), into
    // the block's slot of the question's partial; dz2 in place of h2; db2 +=
    // its column sums.
    for (int ei = 0; ei < nE; ++ei) {
      const int e0 = ei * kSliceE;
      const int Es = width_of<kSliced>(E, kSliceE, ei);
      const int Eps = L::pad(Es);
      if (kSliced) {
        if (nE > 1) fill_slice(a_s, scratch, Ep, e0, Eps);
        load_esel<kThreads>(es_s, e_sel, b, R, E, e0, Es, Rp, Eps);
        __syncthreads();
      }
      update_desel(a_s, dl_s, Rp, R, E, e0, Es, desel_dst);
      __syncthreads();
      store_dz2(dl_s, es_s, Eps, Rp, a_s);
      __syncthreads();
      if (tid < Es) {
        float s = 0.f;
        for (int p = 0; p < kPairs; ++p) s += a_s[at(p, tid, kLdE)];
        if (kSliced) {
          block_row(small_part, H, E)[5 * H + e0 + tid] += s;
        } else {
          db2_acc += s;
        }
      }
      if (kSliced) {
        if (nE > 1) spill_slice(a_s, scratch, Ep, e0, Eps);
        __syncthreads();
      }
    }

    // Pass 3, per H slice: dW2 += h1^T dz2 and dh1 = dz2 W2^T over the E
    // slices (the ring takes W2^T's first rows once the dW2 update has read
    // its staging buffers), then dz1 and its sums. The first barrier of the
    // product also orders the dW2 update's reads of h1s before dz1 is
    // written there.
    for (int hi = 0; hi < nH; ++hi) {
      const int h0 = hi * kSliceH;
      const int Hs = width_of<kSliced>(H, kSliceH, hi);
      const int Hps = L::pad(Hs);
      if (nH > 1) build_h1<kThreads>(h1s, pij_s, geom_s, h_s, h_o, w_g, b0, b, O, H, h0, Hs, Hps);
      float acc[2][kDh1Tiles][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kDh1Tiles; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
      for (int ei = 0; ei < nE; ++ei) {
        const int e0 = ei * kSliceE;
        const int Es = width_of<kSliced>(E, kSliceE, ei);
        const int Eps = L::pad(Es);
        if (kSliced) {
          if (nE > 1) fill_slice(a_s, scratch, Ep, e0, Eps);
          __syncthreads();
        }
        update_dw2(dw2, h1s, a_s, Hps, Eps, h0 / kChunk, e0 / kChunk, Ep / kChunk, stage, bar,
                   parity);
        __syncthreads();  // the staging buffers in the ring are read
        const float* wt = w2t + static_cast<size_t>(e0) * H + h0;
        ring_prologue<kStages, kThreads>(ring, wt, H, Eps, Es, Hs, Hps);
        ring_product<L, kDh1Tiles, kStages, kLdE>(acc, a_s, Eps, ring, wt, H, Es, Hs, Hps);
      }
      store_dz1(acc, h1s, pij_s, geom_s, h_s, h_o, w_g, b0, b, O, H, h0, Hs, Hps);
      __syncthreads();

      // dz1's sums, thread h0 + tid: dh_s of the step's rows, added into the
      // block's slot of the row band's partial, dh_o of its columns into the
      // row band's partial, and the block's db0 and dWg.
      if (tid < Hs) {
        const int h = h0 + tid;
        if (kSliced) {
#pragma unroll
          for (int c = 0; c < 4; ++c) dwg[c] = 0.f;
          db0_acc = 0.f;
        }
        float col[kT];
#pragma unroll
        for (int tj = 0; tj < kT; ++tj) col[tj] = 0.f;
#pragma unroll
        for (int ti = 0; ti < kT; ++ti) {
          float row_sum = 0.f;
#pragma unroll
          for (int tj = 0; tj < kT; ++tj) {
            const int p = ti * kT + tj;
            const float dz = h1s[at(p, tid, kLdH)];
            const float4 g4 = *reinterpret_cast<const float4*>(geom_s + 4 * p);
            dwg[0] = fmaf(g4.x, dz, dwg[0]);
            dwg[1] = fmaf(g4.y, dz, dwg[1]);
            dwg[2] = fmaf(g4.z, dz, dwg[2]);
            dwg[3] = fmaf(g4.w, dz, dwg[3]);
            row_sum += dz;
            col[tj] += dz;
          }
          const int i = i0 + ti;
          if (i < O) dhs_part[(band_slot * O + i) * H + h] += row_sum;
          db0_acc += row_sum;
        }
#pragma unroll
        for (int tj = 0; tj < kT; ++tj) {
          const int j = j0 + tj;
          if (j < O) dho_part[((static_cast<size_t>(b) * nT + it) * O + j) * H + h] = col[tj];
        }
        if (kSliced) {
          float* small = block_row(small_part, H, E);
#pragma unroll
          for (int c = 0; c < 4; ++c) small[c * H + h] += dwg[c];
          small[4 * H + h] += db0_acc;
        }
      }

      // dgeom[b, i, j, c] (+)= dz1[p] . Wg[c], one warp per pair.
      if (dgeom != nullptr) update_dgeom(dgeom, h1s, pij_s, w_g, b, O, H, h0, Hs, hi > 0);
      __syncthreads();
    }
  }

  if (lane == 0) bulk_wait_all();  // the dW2 partial's last stores are complete

  if (!kSliced) {  // the block's dWg, db0 and db2 partials
    float* small = block_row(small_part, H, E);
    if (tid < H) {
#pragma unroll
      for (int c = 0; c < 4; ++c) small[c * H + tid] = dwg[c];
      small[4 * H + tid] = db0_acc;
    }
    if (tid < E) small[5 * H + tid] = db2_acc;
  }
}

bool is_wide(int H, int E) { return H > kSliceH || E > kSliceE; }

template <bool kSliced>
size_t smem_bytes(int E, int R) {
  const int Ep = L::pad(E), Rp = round_up(R, kRChunk);
  return sizeof(float) * (static_cast<size_t>(kPairs) * (kLdH + kLdE) + ring_floats<kSliced>(Rp) +
                          tail_floats<kSliced>(Rp, Ep) + kPairs * 4 + kChunkFloats) +
         sizeof(int2) * kPairs + sizeof(uint64_t) * kWarps;
}

// The kernel's instance for these widths and its dynamic shared memory;
// raises the instance's limit when it needs more than 48 KB.
cudaError_t launch_smem(int H, int E, int R, const void** kernel, size_t* smem) {
  const bool sliced = is_wide(H, E);
  *kernel = sliced ? reinterpret_cast<const void*>(relation_oracle_bwd_kernel<true>)
                   : reinterpret_cast<const void*>(relation_oracle_bwd_kernel<false>);
  *smem = sliced ? smem_bytes<true>(E, R) : smem_bytes<false>(E, R);
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

bool bwd_widths_ok(int H, int E, int R) { return widths_ok(H, E) && R > 0 && R <= kThreads; }

}  // namespace

extern "C" {

// Rows (and columns) of a step's tile (kT): the caller sizes the partials
// with nT = ceil(O / this) bands per question.
int dfol_relation_oracle_bwd_tile() { return kT; }

// The multiple that H and E are padded to (the columns of one step of the
// warps): the caller sizes dw2_part as (grid, Hp/32, Ep/32, 32, 32).
int dfol_relation_oracle_bwd_pad() { return L::kCols; }

// 1 when these widths take the kernel's sliced instance (more than one slice
// of H or E).
int dfol_relation_oracle_bwd_wide(int H, int E) { return is_wide(H, E) ? 1 : 0; }

// Blocks of the kernel that fit on one SM at once at these widths (registers
// and shared memory), written to *blocks; returns a cudaError_t code. The
// persistent grid is this times the SM count, so all its blocks are resident.
int dfol_relation_oracle_bwd_blocks_per_sm(int H, int E, int R, int* blocks) {
  if (!bwd_widths_ok(H, E, R)) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const void* kernel = nullptr;
  cudaError_t err = launch_smem(H, E, R, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem));
}

// Launches on `stream` with `grid` persistent blocks, block k taking steps
// [k per, (k + 1) per) of the B * nT^2 (grid = ceil(steps / per)); band_slots
// and question_slots are 1 + ceil((n - 1) / per) for the nT steps of a row
// band and the nT^2 of a question, the most blocks whose runs meet one.
// Returns a cudaError_t code (0 = success). Does not synchronise and allocates
// nothing: the caller passes dhs_part, desel_part, dbsel_part and dw2_part
// zeroed and sums every *_part buffer over its slot/band/block axis. Takes the
// widths of widths_ok (any multiples of 4, dfol_pair_tail_slices) and
// R <= 512. Past one slice of H or E (dfol_relation_oracle_bwd_wide), the
// caller also zeroes small_part and, when E > kSliceE, passes h2_scratch of
// grid x kPairs x pad(E) floats (else it may be null).
int dfol_relation_oracle_bwd(const void* h_s, const void* h_o, const void* geom,
                             const void* w_g, const void* b0, const void* w2, const void* w2t,
                             const void* b2, const void* e_sel, const void* b_sel,
                             const void* rel_tokens, const void* g, void* dhs_part, void* dho_part,
                             void* dgeom, void* desel_part, void* dbsel_part, void* dw2_part,
                             void* small_part, void* h2_scratch, int B, int O, int H, int E,
                             int R, int grid, int per, int band_slots, int question_slots,
                             void* stream) {
  if (B <= 0 || O <= 0 || O > 46340 || !bwd_widths_ok(H, E, R)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nT = (O + kT - 1) / kT;
  const long long steps = static_cast<long long>(B) * nT * nT;
  const auto slots = [per](int n) { return 1 + (n - 1 + per - 1) / per; };
  if (per <= 0 || steps > INT_MAX || grid != (steps + per - 1) / per ||
      band_slots != slots(nT) || question_slots != slots(nT * nT)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (E > kSliceE && h2_scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  const void* kernel = nullptr;
  cudaError_t err = launch_smem(H, E, R, &kernel, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto launch = is_wide(H, E) ? relation_oracle_bwd_kernel<true>
                                    : relation_oracle_bwd_kernel<false>;
  launch<<<grid, kThreads, smem, st>>>(
      f(h_s), f(h_o), f(geom), f(w_g), f(b0), f(w2), f(w2t), f(b2), f(e_sel), f(b_sel),
      static_cast<const int*>(rel_tokens), f(g), static_cast<float*>(dhs_part),
      static_cast<float*>(dho_part), static_cast<float*>(dgeom), static_cast<float*>(desel_part),
      static_cast<float*>(dbsel_part), static_cast<float*>(dw2_part),
      static_cast<float*>(small_part), static_cast<float*>(h2_scratch), B, O, H, E, R, per,
      band_slots, question_slots);
  return static_cast<int>(cudaGetLastError());
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
