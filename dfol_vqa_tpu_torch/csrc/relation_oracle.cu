// Relation-oracle pair tail, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in dfol_vqa_tpu/ops/pallas/relation_oracle.py
// (launched by `_run_fwd`, pallas_call at :147; reached from rel_cache_pallas).
// For every question b and object pair (i, j):
//
//   h1      = elu(h_s[b,i] + h_o[b,j] + geom[b,i,j] @ Wg + b0)        (H)
//   h2      = sigmoid(h1 @ W2 + b2)                                    (E)
//   out[b,r,i,j] = logsigmoid(h2 . e_sel[b,r] + b_sel[b,r])            (R slots)
//
// written R-major (B, R, O, O) directly, with `default_ll` on the slots whose
// rel_tokens[b,r] == 0. That folds in the JAX wrapper's moveaxis and where
// (relation_oracle.py:293-296). ELU is the kernel's exp(min(x,0))-1 form.
//
// What bounds it: 2HE + 2RE FLOP per pair (158,400 at H=256, E=300, R=8), so
// 50.7 GFLOP at B=32, O=100: operations, not bytes (the inputs and the
// (B,R,O,O) result are ~15 MB). The plain PyTorch version also writes the
// (B,O,O,H) hidden and the (B,O,O,E) pair code to device memory and reads
// them back; this kernel keeps both on chip.
//
// Design (pair_tail_tile.cuh): a block takes a band of 64 consecutive pairs
// of one question, builds their h1 in shared memory and runs z2 = h1 W2 on the
// tensor cores (mma.sync.m16n8k8, TF32 in the split-precision 3xTF32 scheme,
// f32 accumulators: float32-level error at a third of the 495 TFLOP/s TF32
// rate, so a bound of 0.30 ms at B=32, O=100). W2 streams through a
// two-stage cp.async ring of 16-row slices, so it crosses L2 once per 64 pairs
// (the SIMT kernel it replaces read it once per 32 pairs, element by element
// per thread). h2 never leaves the registers: each warp dots its columns of h2
// with e_sel and the four column warps' partial logits are summed in a fixed
// order; e_sel and the partial logits reuse the ring's shared memory once the
// product is done. 106 KB of shared memory and 8 warps per block, two blocks
// per SM.
//
// Widths: H and E are taken in slices of kSliceH = 256 and kSliceE = 320
// (pair_tail_tile.cuh). For each E slice z2 accumulates over the H slices,
// h1 being rebuilt for each H slice (built once when H is one slice), and
// the column warps' partial logits are added over the E slices into a
// [pair][slot] buffer before the logsigmoid. H, E <= one slice (the shipped
// H=256, E=300) run one iteration of each loop.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer,
// all float tensors are float32 and contiguous, rel_tokens is int32.

#include "pair_tail_tile.cuh"

namespace {

using namespace pair_tail;

using L = Layout<4>;  // 8 warps: 2 along the pairs x 4 along E
constexpr int kThreads = L::kThreads;
constexpr int kStages = 2;

// Floats of the ring region: the weight ring during the product, e_sel of the
// E slice and the partial logits after it. Ep is the padded width of the
// widest E slice.
__host__ __device__ int ring_floats(int Ep, int Rp) {
  const int after = Rp * Ep + L::kWN * kPairs * Rp;
  return after > kStages * kStageFloats ? after : kStages * kStageFloats;
}

// kSliced: H or E spans more than one slice; the one-slice instantiation runs
// each loop once with the trip counts known at compile time, so it keeps the
// registers of a kernel without the loops.
template <bool kSliced>
__global__ void __launch_bounds__(kThreads, 2) relation_oracle_fwd_kernel(
    const float* __restrict__ h_s,       // (B, O, H)
    const float* __restrict__ h_o,       // (B, O, H)
    const float* __restrict__ geom,      // (B, O, O, 4)
    const float* __restrict__ w_g,       // (4, H)
    const float* __restrict__ b0,        // (H)
    const float* __restrict__ w2,        // (H, E)
    const float* __restrict__ b2,        // (E)
    const float* __restrict__ e_sel,     // (B, R, E)
    const float* __restrict__ b_sel,     // (B, R)
    const int* __restrict__ rel_tokens,  // (B, R)
    float* __restrict__ out,             // (B, R, O, O)
    int O, int H, int E, int R, float default_ll) {
  const int nH = kSliced ? slices(H, kSliceH) : 1;
  const int nE = kSliced ? slices(E, kSliceE) : 1;
  const int Ep = L::pad(width_of<kSliced>(E, kSliceE, 0));  // the widest E slice
  const int Rp = round_up(R, kRChunk);
  extern __shared__ float4 smem4[];
  float* h1s = reinterpret_cast<float*>(smem4);  // [kPairs][kLdH], swizzled
  float* ring = h1s + kPairs * kLdH;             // [kStages][kRingRows][kRingStride];
  float* es_s = ring;                            //   after a product: [Rp][Eps] e_sel[b]
  float* lp_s = es_s + Rp * Ep;                  //   and [kWN][kPairs][Rp] logits
  float* geom_s = ring + ring_floats(Ep, Rp);    // [kPairs][4]
  int2* pij_s = reinterpret_cast<int2*>(geom_s + kPairs * 4);  // [kPairs]
  float* lg_s = reinterpret_cast<float*>(pij_s + kPairs);      // [kPairs][Rp] when nE > 1

  const int b = blockIdx.y;
  const int OO = O * O;
  const BandPairs pairs{static_cast<int>(blockIdx.x) * kPairs, O};

  ring_prologue<kStages, kThreads>(ring, w2, E, L::pad(width_of<kSliced>(H, kSliceH, 0)),
                                   width_of<kSliced>(H, kSliceH, 0),
                                   width_of<kSliced>(E, kSliceE, 0), Ep);
  load_pairs(pij_s, geom_s, geom, b, O, pairs);
  __syncthreads();

  float acc[2][L::kZ2Tiles][4];
  for (int ei = 0; ei < nE; ++ei) {
    const int e0 = ei * kSliceE;
    const int Es = width_of<kSliced>(E, kSliceE, ei);
    const int Eps = L::pad(Es);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::kZ2Tiles; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
    // z2 of the E slice, summed over the H slices; h1 is built once when H
    // is one slice
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
    load_esel<kThreads>(es_s, e_sel, b, R, E, e0, Es, Rp, Eps);  // the ring is free now
    finish_h2<L>(acc, b2 + e0, Es, Eps, nullptr);
    __syncthreads();
    partial_logits<L>(acc, es_s, Eps, Rp, lp_s);
    __syncthreads();
    if (nE > 1) {  // the next slice's ring overwrites lp_s
      sum_logits<L>(lp_s, lg_s, Rp, ei == 0);
      __syncthreads();
    }
  }

  // logsigmoid of the summed logits, R-major; pad slots get default_ll.
  for (int q = threadIdx.x; q < R * kPairs; q += kThreads) {
    const int r = q / kPairs;
    const int p = q - r * kPairs;
    const int pid = pairs.base + p;
    if (pid >= OO) continue;
    const float bias = b_sel[b * R + r];
    out[static_cast<size_t>(b * R + r) * OO + pid] =
        rel_tokens[b * R + r] == 0
            ? default_ll
            : log_sigmoid(nE > 1 ? lg_s[p * Rp + r] + bias : logit_of<L>(lp_s, p, r, Rp, bias));
  }
}

size_t smem_bytes(int H, int E, int R) {
  const int Ep = L::pad(slice_width(E, kSliceE, 0)), Rp = round_up(R, kRChunk);
  return sizeof(float) * (static_cast<size_t>(kPairs) * kLdH + ring_floats(Ep, Rp) + kPairs * 4) +
         sizeof(int2) * kPairs + (E > kSliceE ? sizeof(float) * kPairs * Rp : 0);
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t code (0 = success). Does not
// synchronise and allocates nothing. Takes the widths of widths_ok: any H and
// E that are multiples of 4 (dfol_pair_tail_slices).
int dfol_relation_oracle_fwd(const void* h_s, const void* h_o, const void* geom,
                             const void* w_g, const void* b0, const void* w2,
                             const void* b2, const void* e_sel, const void* b_sel,
                             const void* rel_tokens, void* out, int B, int O, int H,
                             int E, int R, float default_ll, void* stream) {
  if (B <= 0 || O <= 0 || R <= 0 || B > 65535 || O > 46340 || !widths_ok(H, E)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(H, E, R);
  const bool sliced = H > kSliceH || E > kSliceE;
  const auto kernel = sliced ? relation_oracle_fwd_kernel<true> : relation_oracle_fwd_kernel<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int OO = O * O;
  const dim3 grid((OO + kPairs - 1) / kPairs, B);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_s), static_cast<const float*>(h_o),
      static_cast<const float*>(geom), static_cast<const float*>(w_g),
      static_cast<const float*>(b0), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(e_sel),
      static_cast<const float*>(b_sel), static_cast<const int*>(rel_tokens),
      static_cast<float*>(out), O, H, E, R, default_ll);
  return static_cast<int>(cudaGetLastError());
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
