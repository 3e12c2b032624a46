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
// 12.3 GFLOP of f32 FMA work, while a plain PyTorch version also writes and
// reads back every (U, O, O, H) hidden layer. This kernel keeps the chain on
// chip: one block owns a band of kPairs consecutive pairs of one image,
// stages each layer's activations (width x kPairs, row stride 36 floats so
// rows stay 16-byte aligned) in shared memory, ping-ponging between two
// buffers, streams each weight matrix once per band (coalesced rows, L2
// resident), and only the final layer reaches device memory, already in the
// stream dtype. Each thread owns one output column and keeps kPairs
// accumulators. It is plain f32 SIMT code with f32 operands (what JAX's CPU
// and interpret paths compute; the TPU kernel's bf16 dot operands are not
// carried over): wgmma with weights resident in shared memory is later work.
//
// Plain C interface (loaded with ctypes); every tensor pointer is a device
// pointer, all inputs are float32 and contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 32;           // object pairs per block
constexpr int kStride = kPairs + 4;  // activation row stride
constexpr int kMaxLayers = 8;        // Linear layers after the split first layer

struct Chain {
  const float* w[kMaxLayers];  // (width[l], width[l+1]) row-major
  const float* b[kMaxLayers];  // (width[l+1])
  int width[kMaxLayers + 1];   // width[0] = H, width[n] = E
  int n;
};

__device__ __forceinline__ float elu_exp(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename OutT>
__global__ void pair_mlp_fwd_kernel(
    const float* __restrict__ h_s,   // (U, O, H)
    const float* __restrict__ h_o,   // (U, O, H)
    const float* __restrict__ geom,  // (U, O, O, 4)
    const float* __restrict__ w_g,   // (4, H)
    const float* __restrict__ b0,    // (H)
    Chain chain,
    OutT* __restrict__ out,          // (U, O, O, width[n])
    int O, int buf_rows) {
  extern __shared__ float4 smem4[];
  float* cur = reinterpret_cast<float*>(smem4);  // [width][kStride], column p = pair
  float* nxt = cur + buf_rows * kStride;

  const int u = blockIdx.y;
  const int OO = O * O;
  const int pair0 = blockIdx.x * kPairs;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int H = chain.width[0];
  const size_t img_pairs = static_cast<size_t>(u) * OO;

  // Phase 1: the split first layer, four rank-1 geometry terms plus the
  // subject and object rows; consecutive threads take consecutive h.
  for (int k = tid; k < kPairs * H; k += nthreads) {
    const int p = k / H;
    const int h = k - p * H;
    const int pid = pair0 + p;
    float v = 0.f;
    if (pid < OO) {
      const int i = pid / O;
      const int j = pid - i * O;
      const float* g = geom + (img_pairs + pid) * 4;
      float z = g[0] * w_g[h] + g[1] * w_g[H + h] + g[2] * w_g[2 * H + h] +
                g[3] * w_g[3 * H + h];
      z = z + h_s[(static_cast<size_t>(u) * O + i) * H + h];
      z = z + h_o[(static_cast<size_t>(u) * O + j) * H + h];
      z = z + b0[h];
      if (chain.n == 0) store(out + (img_pairs + pid) * H + h, sigmoid(z));
      v = elu_exp(z);
    }
    if (chain.n > 0) cur[h * kStride + p] = v;
  }
  __syncthreads();

  // Phase 2: the chain. Threads stride over the layer's outputs (coalesced
  // weight rows); each keeps kPairs accumulators and reads the band's
  // activations four pairs at a time (a broadcast from shared memory).
  for (int l = 0; l < chain.n; ++l) {
    const int K = chain.width[l];
    const int N = chain.width[l + 1];
    const float* __restrict__ w = chain.w[l];
    const bool last = l == chain.n - 1;
    for (int n = tid; n < N; n += nthreads) {
      float acc[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(w + static_cast<size_t>(k) * N + n);
        const float4* row = reinterpret_cast<const float4*>(cur + k * kStride);
#pragma unroll
        for (int q = 0; q < kPairs / 4; ++q) {
          const float4 v = row[q];
          acc[4 * q + 0] = fmaf(v.x, wv, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
        }
      }
      const float bias = chain.b[l][n];
      if (last) {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const int pid = pair0 + p;
          if (pid < OO) store(out + (img_pairs + pid) * N + n, sigmoid(acc[p] + bias));
        }
      } else {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) nxt[n * kStride + p] = elu_exp(acc[p] + bias);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

template <typename OutT>
int launch(const float* h_s, const float* h_o, const float* geom, const float* w_g,
           const float* b0, const Chain& chain, void* out, int U, int O, cudaStream_t stream) {
  // activation buffers: one per chain input width, two when the chain has an
  // inner layer (ping-pong)
  int rows = 0;
  for (int l = 0; l < chain.n; ++l) rows = rows > chain.width[l] ? rows : chain.width[l];
  const int nbuf = chain.n >= 2 ? 2 : (chain.n == 1 ? 1 : 0);
  const size_t smem = sizeof(float) * static_cast<size_t>(nbuf) * rows * kStride;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(pair_mlp_fwd_kernel<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int widest = 0;
  for (int l = 1; l <= chain.n; ++l) widest = widest > chain.width[l] ? widest : chain.width[l];
  int threads = (widest + 31) / 32 * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const dim3 grid((O * O + kPairs - 1) / kPairs, U);
  pair_mlp_fwd_kernel<OutT><<<grid, threads, smem, stream>>>(
      h_s, h_o, geom, w_g, b0, chain, static_cast<OutT*>(out), O, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// ws[l], bs[l] are device pointers of Linear l (l < n_layers); widths holds
// n_layers + 1 ints, widths[0] = H. out_dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`; returns a cudaError_t code (0 = success). Does not
// synchronise and allocates nothing.
int dfol_pair_mlp_fwd(const void* h_s, const void* h_o, const void* geom, const void* w_g,
                      const void* b0, const void* const* ws, const void* const* bs,
                      const int* widths, int n_layers, void* out, int out_dtype, int U,
                      int O, void* stream) {
  if (U <= 0 || O <= 0 || U > 65535 || O > 46340 || n_layers < 0 || n_layers > kMaxLayers ||
      (out_dtype != 0 && out_dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Chain chain{};
  chain.n = n_layers;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] <= 0) return static_cast<int>(cudaErrorInvalidValue);
    chain.width[l] = widths[l];
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
  auto st = static_cast<cudaStream_t>(stream);
  return out_dtype == 0 ? launch<float>(hs, ho, g, wg, bb, chain, out, U, O, st)
                        : launch<__nv_bfloat16>(hs, ho, g, wg, bb, chain, out, U, O, st);
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
