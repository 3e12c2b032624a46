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
// What bounds it: at B=32, O=100, H=256, E=300 the pair tail is ~320k pairs x
// 2*256*300 FLOP = ~49 GFLOP of f32 FMA work, while the plain PyTorch version
// also materialises the (B,O,O,256) hidden (~0.33 GB) and the (B,O,O,300)
// pair code (~0.38 GB) in device memory and reads them back. This kernel
// keeps both on chip: one block owns a band of kPairs consecutive pairs of one
// question, stages their h1 (H x kPairs) and the question's e_sel rows in
// shared memory, streams W2 (H x E, L2-resident) once per band, and only the
// (B,R,O,O) result reaches device memory. It is plain f32 SIMT code: wgmma,
// TMA and tuning are later work.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer,
// all float tensors are float32 and contiguous, rel_tokens is int32.

#include <cuda_runtime.h>

namespace {

constexpr int kPairs = 32;           // object pairs per block
constexpr int kStride = kPairs + 4;  // h1 row stride: 16-byte rows, fewer bank conflicts

__device__ __forceinline__ float elu_exp(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__global__ void relation_oracle_fwd_kernel(
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
  extern __shared__ float4 smem4[];
  float* h1_t = reinterpret_cast<float*>(smem4);  // [H][kStride], column p = pair
  float* h2_s = h1_t + H * kStride;               // [kPairs][E]
  float* es_s = h2_s + kPairs * E;                // [R][E]

  const int b = blockIdx.y;
  const int OO = O * O;
  const int pair0 = blockIdx.x * kPairs;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;

  const float* es_g = e_sel + static_cast<size_t>(b) * R * E;
  for (int k = tid; k < R * E; k += nthreads) es_s[k] = es_g[k];

  // Phase 1: h1 for the band; consecutive threads take consecutive h, so
  // the h_s / h_o / w_g rows are read coalesced.
  for (int k = tid; k < kPairs * H; k += nthreads) {
    const int p = k / H;
    const int h = k - p * H;
    const int pid = pair0 + p;
    float v = 0.f;
    if (pid < OO) {
      const int i = pid / O;
      const int j = pid - i * O;
      const float* g = geom + (static_cast<size_t>(b) * OO + pid) * 4;
      const float gw = g[0] * w_g[h] + g[1] * w_g[H + h] + g[2] * w_g[2 * H + h] +
                       g[3] * w_g[3 * H + h];
      const float z = (h_s[(static_cast<size_t>(b) * O + i) * H + h] +
                       h_o[(static_cast<size_t>(b) * O + j) * H + h]) +
                      gw + b0[h];
      v = elu_exp(z);
    }
    h1_t[h * kStride + p] = v;
  }
  __syncthreads();

  // Phase 2: h2[p, e] = sigmoid(h1[p] . W2[:, e] + b2[e]). Threads stride
  // over E (coalesced W2 rows); each keeps kPairs accumulators and reads the
  // band's h1 column four pairs at a time (a broadcast from shared memory).
  for (int e = tid; e < E; e += nthreads) {
    float acc[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
    for (int h = 0; h < H; ++h) {
      const float w = __ldg(w2 + static_cast<size_t>(h) * E + e);
      const float4* row = reinterpret_cast<const float4*>(h1_t + h * kStride);
#pragma unroll
      for (int q = 0; q < kPairs / 4; ++q) {
        const float4 v = row[q];
        acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
      }
    }
    const float bias = b2[e];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) h2_s[p * E + e] = sigmoid(acc[p] + bias);
  }
  __syncthreads();

  // Phase 3: one warp per (r, p): reduce h2[p] . e_sel[r] over E, add b_sel,
  // logsigmoid, write R-major. Pad slots get default_ll.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = nthreads >> 5;
  for (int q = warp; q < R * kPairs; q += nwarps) {
    const int r = q / kPairs;
    const int p = q - r * kPairs;
    const int pid = pair0 + p;
    if (pid >= OO) continue;  // warp-uniform
    float* dst = out + static_cast<size_t>(b * R + r) * OO + pid;
    if (rel_tokens[b * R + r] == 0) {
      if (lane == 0) *dst = default_ll;
      continue;
    }
    float s = 0.f;
    for (int e = lane; e < E; e += 32) s = fmaf(h2_s[p * E + e], es_s[r * E + e], s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) *dst = log_sigmoid(s + b_sel[b * R + r]);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns a cudaError_t code (0 = success). Does not
// synchronise and allocates nothing.
int dfol_relation_oracle_fwd(const void* h_s, const void* h_o, const void* geom,
                             const void* w_g, const void* b0, const void* w2,
                             const void* b2, const void* e_sel, const void* b_sel,
                             const void* rel_tokens, void* out, int B, int O, int H,
                             int E, int R, float default_ll, void* stream) {
  if (B <= 0 || O <= 0 || H <= 0 || E <= 0 || R <= 0 || B > 65535 || O > 46340) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = (E + 31) / 32 * 32;
  threads = threads < 128 ? 128 : (threads > 1024 ? 1024 : threads);
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(H) * kStride + static_cast<size_t>(kPairs) * E +
                       static_cast<size_t>(R) * E);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(relation_oracle_fwd_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int OO = O * O;
  const dim3 grid((OO + kPairs - 1) / kPairs, B);
  relation_oracle_fwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
