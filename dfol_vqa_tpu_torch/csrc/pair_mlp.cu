// Shared pair code (the relation pair MLP), forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` in dfol_vqa_tpu/ops/pallas/pair_mlp.py
// (launched by `_run_fwd`, pallas_call at :151; reached from pair_mlp_fused
// <- rel_cache_shared, the shared-image relation route of offline eval).
// For every unique image u and object pair (i, j):
//
//   h    = dist*Wg[0] + ang*Wg[1] + hside*Wg[2] + vside*Wg[3]
//          + h_s[u,i] + h_o[u,j] + b0                               (H)
//   h    = W_l(elu(h)) + b_l   for each Linear l of the chain
//   out[u,i,j] = sigmoid(h)                                          (E)
//
// stored in float32 or bfloat16 (round to nearest even), the stream dtype of
// the (U, O, O, E) pair code that shared_contract.cu reads. ELU is the TPU
// kernel's exp(min(x,0))-1 form; an empty chain stores sigmoid(h) directly.
//
// What bounds it: at U=8, O=100, H=256, E=300 the chain is 2*U*O^2*H*E =
// 12.3 GFLOP of float32 products (the output is 48 MB at bf16), so the
// operations: 0.0745 ms in 3xTF32 on the tensor cores (a third of the
// 495 TFLOP/s TF32 rate), 0.183 ms on the CUDA cores.
//
// Design: the relation-oracle forward's tile (pair_tail_tile.cuh). A block
// takes a band of 64 consecutive pairs of one image; the first layer's
// activations elu(h) are built in a swizzled [pair][256] shared-memory tile
// (build_h1), and every Linear runs on the tensor cores as mma.sync.m16n8k8
// TF32 products in the split-precision 3xTF32 scheme with float32
// accumulators (float32 operands throughout, as JAX's CPU and interpret
// paths compute; the TPU kernel's bf16 dot operands are not carried over),
// its weights streamed through a two-stage cp.async ring. A hidden layer of
// up to 256 units stays on chip: its ELU goes from the accumulators into a
// second tile, which the next layer reads. Only the last layer reaches
// device memory: the band's outputs are staged in shared memory in the
// stream dtype and stored as one contiguous run of 16-byte stores (a bf16 row
// of E=300 is 600 bytes, so rows are not 16-byte aligned; the band is
// contiguous, and the staging keeps the run's alignment phase).
//
// Widths: any, as multiples of 4 (the caller zero-pads the weights; the
// output keeps its true width). A layer's input is taken in slices of 256
// units and its output in slices of 320 columns, as kernels 1 and 2 take H
// and E (the first layer's activations are rebuilt per input slice). A
// hidden layer wider than 256 units does not fit the tile: it goes to a
// per-band scratch in device memory (L2) that the next layer reads back by
// slices, and a last layer wider than 320 columns is stored from the
// accumulators directly. Up to kMaxLayers Linear layers.
//
// Plain C interface (loaded with ctypes); every tensor pointer is a device
// pointer, all inputs are float32 and contiguous.

#include <cuda_bf16.h>
#include <stdint.h>

#include "pair_tail_tile.cuh"

namespace {

using namespace pair_tail;

using L = Layout<4>;  // 8 warps: 2 along the pairs x 4 along the columns
constexpr int kThreads = L::kThreads;
constexpr int kStages = 2;
constexpr int kMaxLayers = 8;  // Linear layers after the split first layer

struct Chain {
  const float* w[kMaxLayers];  // (width[l], width[l+1]) row-major
  const float* b[kMaxLayers];  // (width[l+1])
  int width[kMaxLayers + 1];   // multiples of 4; width[0] = H, width[n] = E (padded)
  int n;
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Copy the run of `bytes` bytes staged at stage + phase (stage 16-byte
// aligned) to dst, whose address is phase (mod 16): 16-byte stores where a
// whole aligned vector lies inside the run, 2-byte ones at its two ends.
__device__ __forceinline__ void store_run(char* dst, const char* stage, int bytes, int phase) {
  char* base = dst - phase;
  const int vectors = (phase + bytes + 15) / 16;
  for (int v = threadIdx.x; v < vectors; v += kThreads) {
    const int lo = max(phase, 16 * v);
    const int hi = min(phase + bytes, 16 * v + 16);
    if (lo == 16 * v && hi == 16 * v + 16) {
      *reinterpret_cast<uint4*>(base + 16 * v) = *reinterpret_cast<const uint4*>(stage + 16 * v);
    } else {
      for (int c = lo; c < hi; c += 2) {
        *reinterpret_cast<uint16_t*>(base + c) = *reinterpret_cast<const uint16_t*>(stage + c);
      }
    }
  }
}

// The accumulators of an output slice (columns [0, Nps) of this slice, bias
// at those columns; the slice has Ns live columns) through f, which gets the
// tile row p, the slice column e and the value z = acc + bias (0 past Ns).
template <class F>
__device__ __forceinline__ void for_each_output(const float (&acc)[2][L::kZ2Tiles][4],
                                                const float* __restrict__ bias, int Ns, int Nps,
                                                F f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int nt_w = Nps / L::kCols;
  const int r0 = L::wm() * 32 + g;
#pragma unroll
  for (int nt = 0; nt < L::kZ2Tiles; ++nt) {
    if (nt >= nt_w) continue;
    const int e = L::wn() * nt_w * 8 + 8 * nt + 2 * t;  // Ns % 4 == 0: e, e+1 alike
    const bool live = e < Ns;
    const float c0 = live ? bias[e] : 0.f;
    const float c1 = live ? bias[e + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = r0 + 16 * mt + 8 * half;
        f(p, e, live, acc[mt][nt][2 * half] + c0, acc[mt][nt][2 * half + 1] + c1);
      }
  }
}

// Block b's [kPairs][ld] slice of a scratch buffer of n_blocks such blocks.
__device__ __forceinline__ float* band_scratch(float* scratch, int ld) {
  return scratch + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * kPairs * ld;
}

template <typename OutT, bool kSliced>
__global__ void __launch_bounds__(kThreads, 2) pair_mlp_fwd_kernel(
    const float* __restrict__ h_s,   // (U, O, H)
    const float* __restrict__ h_o,   // (U, O, H)
    const float* __restrict__ geom,  // (U, O, O, 4)
    const float* __restrict__ w_g,   // (4, H)
    const float* __restrict__ b0,    // (H)
    Chain chain,
    OutT* __restrict__ out,          // (U, O, O, e_out)
    int e_out,                       // the output's true width (<= width[n])
    int O,
    float* __restrict__ scratch,     // 2 x (blocks, kPairs, s_ld) when a hidden layer > 256
    int s_ld) {
  extern __shared__ float4 smem4[];
  float* x0 = reinterpret_cast<float*>(smem4);  // [kPairs][kLdH], swizzled
  float* ring = x0 + kPairs * kLdH;             // [kStages][kRingRows][kRingStride]
  float* x1 = ring + kStages * kStageFloats;    // [kPairs][kLdH], a chain of 2+ layers
  float* geom_s = x1 + (chain.n >= 2 ? kPairs * kLdH : 0);     // [kPairs][4]
  int2* pij_s = reinterpret_cast<int2*>(geom_s + kPairs * 4);  // [kPairs]

  const int u = blockIdx.y;
  const int OO = O * O;
  const int pair0 = blockIdx.x * kPairs;
  const int np = min(kPairs, OO - pair0);
  const BandPairs pairs{pair0, O};
  const int H = chain.width[0];
  OutT* dst = out + (static_cast<size_t>(u) * OO + pair0) * e_out;

  if (chain.n == 0) {  // sigmoid of the first layer
    load_pairs(pij_s, geom_s, geom, u, O, pairs);
    __syncthreads();
    for (int k = threadIdx.x; k < np * e_out; k += kThreads) {
      const int p = k / e_out;
      const int h = k - p * e_out;
      const int2 ij = pij_s[p];
      const float4 g4 = *reinterpret_cast<const float4*>(geom_s + 4 * p);
      put(dst + k, sigmoid(pre_activation(h_s, h_o, w_g, b0, g4, u, ij.x, ij.y, h, O, H)));
    }
    return;
  }

  ring_prologue<kStages, kThreads>(ring, chain.w[0], chain.width[1],
                                   L::pad(slice_width(H, kSliceH, 0)), slice_width(H, kSliceH, 0),
                                   slice_width(chain.width[1], kSliceE, 0),
                                   L::pad(slice_width(chain.width[1], kSliceE, 0)));
  load_pairs(pij_s, geom_s, geom, u, O, pairs);
  __syncthreads();

  float* x = x0;  // the layer's input tile (an input slice)
  float* y = x1;  // a hidden output of up to 256 units
  float* s_in = kSliced ? band_scratch(scratch, s_ld) : nullptr;
  float* s_out = kSliced ? band_scratch(scratch + static_cast<size_t>(gridDim.x) * gridDim.y *
                                                      kPairs * s_ld, s_ld)
                         : nullptr;
  bool in_scratch = false;  // the layer's input lies in s_in (wider than 256)
  float acc[2][L::kZ2Tiles][4];
  for (int l = 0; l < chain.n; ++l) {
    const int K = chain.width[l];
    const int N = chain.width[l + 1];
    const bool last = l == chain.n - 1;
    const int nK = kSliced ? slices(K, kSliceH) : 1;
    const int nN = kSliced ? slices(N, kSliceE) : 1;
    const bool out_scratch = kSliced && !last && N > kSliceH;
    for (int ni = 0; ni < nN; ++ni) {
      const int n0 = ni * kSliceE;
      const int Ns = slice_width(N, kSliceE, ni);
      const int Nps = L::pad(Ns);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < L::kZ2Tiles; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][nt][c] = 0.f;
      for (int ki = 0; ki < nK; ++ki) {
        const int k0 = ki * kSliceH;
        const int Ks = slice_width(K, kSliceH, ki);
        const int Kps = L::pad(Ks);
        const float* w = chain.w[l] + static_cast<size_t>(k0) * N + n0;
        if (l + ni + ki > 0) ring_prologue<kStages, kThreads>(ring, w, N, Kps, Ks, Ns, Nps);
        if (nK > 1 || ni == 0) {
          if (l == 0) {
            build_h1<kThreads>(x, pij_s, geom_s, h_s, h_o, w_g, b0, u, O, H, k0, Ks, Kps);
          } else if (in_scratch) {
            for (int q = threadIdx.x; q < kPairs * Kps; q += kThreads) {
              const int p = q / Kps;
              const int k = q - p * Kps;
              x[at(p, k, kLdH)] = k < Ks ? s_in[p * s_ld + k0 + k] : 0.f;
            }
          }
        }
        ring_product<L, L::kZ2Tiles, kStages, kLdH>(acc, x, Kps, ring, w, N, Ks, Ns, Nps);
      }
      const float* bias = chain.b[l] + n0;
      if (!last && !out_scratch) {  // ELU into the next layer's tile, 0 past N
        for_each_output(acc, bias, Ns, Nps, [&](int p, int e, bool live, float z0, float z1) {
          *reinterpret_cast<float2*>(y + at(p, e, kLdH)) =
              live ? make_float2(elu_exp(z0), elu_exp(z1)) : make_float2(0.f, 0.f);
        });
      } else if (out_scratch) {
        for_each_output(acc, bias, Ns, Nps, [&](int p, int e, bool live, float z0, float z1) {
          if (live) {
            *reinterpret_cast<float2*>(s_out + p * s_ld + n0 + e) =
                make_float2(elu_exp(z0), elu_exp(z1));
          }
        });
      } else if (nN == 1) {  // the last layer: stage the band, then one contiguous run
        char* stage = reinterpret_cast<char*>(x0);  // x0 and the ring are free now
        const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);
        OutT* st = reinterpret_cast<OutT*>(stage + phase);
        for_each_output(acc, bias, Ns, Nps, [&](int p, int e, bool live, float z0, float z1) {
          if (p < np) {
            if (e < e_out) put(st + p * e_out + e, sigmoid(z0));
            if (e + 1 < e_out) put(st + p * e_out + e + 1, sigmoid(z1));
          }
        });
        __syncthreads();
        store_run(reinterpret_cast<char*>(dst), stage, np * e_out * static_cast<int>(sizeof(OutT)),
                  phase);
      } else {  // a last layer wider than one slice: straight from the accumulators
        for_each_output(acc, bias, Ns, Nps, [&](int p, int e, bool live, float z0, float z1) {
          if (p < np) {
            if (n0 + e < e_out) put(dst + p * e_out + n0 + e, sigmoid(z0));
            if (n0 + e + 1 < e_out) put(dst + p * e_out + n0 + e + 1, sigmoid(z1));
          }
        });
      }
    }
    if (!last) {
      if (out_scratch) {
        float* t = s_in;
        s_in = s_out;
        s_out = t;
        in_scratch = true;
      } else {
        float* t = x;
        x = y;
        y = t;
        in_scratch = false;
      }
      __syncthreads();  // the layer's outputs are visible to the next one
    }
  }
}

template <typename OutT, bool kSliced>
int launch(const float* h_s, const float* h_o, const float* geom, const float* w_g,
           const float* b0, const Chain& chain, void* out, int e_out, int U, int O,
           float* scratch, int s_ld, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kPairs) * kLdH + kStages * kStageFloats +
                       (chain.n >= 2 ? kPairs * kLdH : 0) + kPairs * 4) +
      sizeof(int2) * kPairs;
  const auto kernel = pair_mlp_fwd_kernel<OutT, kSliced>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((O * O + kPairs - 1) / kPairs, U);
  kernel<<<grid, kThreads, smem, stream>>>(h_s, h_o, geom, w_g, b0, chain,
                                           static_cast<OutT*>(out), e_out, O, scratch, s_ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The widest hidden layer the kernel keeps on chip (wider ones need the
// scratch of dfol_pair_mlp_fwd).
int dfol_pair_mlp_tile_width() { return kSliceH; }

// ws[l], bs[l] are device pointers of Linear l (l < n_layers); widths holds
// n_layers + 1 ints, widths[0] = H, each a multiple of 4 (zero-padded by the
// caller); e_out is the output's true width (<= widths[n_layers]).
// out_dtype: 0 = float32, 1 = bfloat16. scratch: when a hidden layer (a
// widths[l], 0 < l < n_layers) exceeds dfol_pair_mlp_tile_width, 2 x
// ceil(O^2 / 64) x U x 64 x s_ld floats with s_ld the widest such layer;
// else null. Launches on `stream`; returns a cudaError_t code (0 =
// success). Does not synchronise and allocates nothing.
int dfol_pair_mlp_fwd(const void* h_s, const void* h_o, const void* geom, const void* w_g,
                      const void* b0, const void* const* ws, const void* const* bs,
                      const int* widths, int n_layers, void* out, int e_out, int out_dtype, int U,
                      int O, void* scratch, int s_ld, void* stream) {
  if (U <= 0 || O <= 0 || U > 65535 || O > 46340 || n_layers < 0 || n_layers > kMaxLayers ||
      (out_dtype != 0 && out_dtype != 1) || e_out <= 0 || e_out > widths[n_layers]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain chain{};
  chain.n = n_layers;
  bool sliced = false;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0 || widths[l] % kWidthMultiple != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    chain.width[l] = widths[l];
    if ((l < n_layers && widths[l] > kSliceH) || (l > 0 && widths[l] > kSliceE)) sliced = true;
    if (l > 0 && l < n_layers && widths[l] > kSliceH && (scratch == nullptr || s_ld < widths[l])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int l = 0; l < n_layers; ++l) {
    chain.w[l] = static_cast<const float*>(ws[l]);
    chain.b[l] = static_cast<const float*>(bs[l]);
  }
  const auto* hs = static_cast<const float*>(h_s);
  const auto* ho = static_cast<const float*>(h_o);
  const auto* g = static_cast<const float*>(geom);
  const auto* wg = static_cast<const float*>(w_g);
  const auto* bb = static_cast<const float*>(b0);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    return sliced ? launch<float, true>(hs, ho, g, wg, bb, chain, out, e_out, U, O, sc, s_ld, st)
                  : launch<float, false>(hs, ho, g, wg, bb, chain, out, e_out, U, O, sc, s_ld, st);
  }
  return sliced
             ? launch<__nv_bfloat16, true>(hs, ho, g, wg, bb, chain, out, e_out, U, O, sc, s_ld, st)
             : launch<__nv_bfloat16, false>(hs, ho, g, wg, bb, chain, out, e_out, U, O, sc, s_ld,
                                            st);
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
