// Shared-image relation contraction (fused gather + contract), forward, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_contract_kernel` in
// dfol_vqa_tpu/ops/pallas/shared_contract.py (launched by `_run_fwd`,
// pallas_call at :82; reached from shared_contract_pallas <- rel_cache_shared,
// the shared-image relation route of offline eval). For every question b,
// relation slot r and object pair (i, j):
//
//   out[b,r,i,j] = logsigmoid(h2[img[b],i,j,:] . e_sel[b,r] + b_sel[b,r])
//
// written R-major (B, R, O, O) in the cache dtype (float32 or bfloat16), with
// `default_ll` on the slots whose rel_tokens[b,r] == 0. h2 (U, O, O, E) and
// e_sel (B, R, E) arrive in the stream dtype (float32 or bfloat16); the dot
// products accumulate in float32.
//
// What bounds it: it reads B*O^2*E elements of h2 and does 2*B*R*O^2*E FLOP
// (3.8 GFLOP at B=80, R=8, O=100, E=300), so it is bound by h2 reads. The
// plain PyTorch version gathers a (B, O, O, E) float32 tensor into device
// memory first (960 MB at B=80). Here nothing but the result is written, and
// h2 is read in an order that keeps it in L2: block (x, y) takes question
// order[x] (questions sorted by image, `order` is the permutation) and band y
// of kBand pairs, and blocks are issued x fastest, so the ~10 questions of one
// image read the same h2 band one after another (the TPU kernel gets the same
// reuse from its (band, question) grid order). Each block stages its
// question's e_sel rows in shared memory; each warp takes one pair at a time,
// reads the pair's h2 row once, coalesced along E, and keeps kSlots dot
// products per lane, reduced across the warp. Results are staged in shared
// memory and stored R-major with coalesced rows. The block loads img_index
// itself, which replaces the TPU kernel's scalar prefetch.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer,
// all tensors are contiguous, index tensors int32, b_sel float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 64;    // object pairs per block
constexpr int kWarps = 8;    // 256 threads
constexpr int kSlots = 8;    // relation slots per pass over an h2 row

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(kWarps * 32) shared_contract_kernel(
    const InT* __restrict__ h2,          // (U, O, O, E)
    const int* __restrict__ img_index,   // (B,)
    const int* __restrict__ order,       // (B,) questions sorted by image
    const InT* __restrict__ e_sel,       // (B, R, E)
    const float* __restrict__ b_sel,     // (B, R)
    const int* __restrict__ rel_tokens,  // (B, R)
    OutT* __restrict__ out,              // (B, R, O, O)
    int U, int O, int E, int R, float default_ll) {
  extern __shared__ float smem[];
  float* es_s = smem;            // [R][E]
  float* out_s = es_s + R * E;   // [R][kBand]

  const int b = order[blockIdx.x];
  int img = img_index[b];
  img = img < 0 ? 0 : (img >= U ? U - 1 : img);  // clamped, as a JAX gather is
  const int OO = O * O;
  const int pair0 = blockIdx.y * kBand;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const InT* es_g = e_sel + static_cast<size_t>(b) * R * E;
  for (int k = tid; k < R * E; k += kWarps * 32) es_s[k] = to_float(es_g[k]);
  __syncthreads();

  const InT* h2_img = h2 + static_cast<size_t>(img) * OO * E;
  for (int p = warp; p < kBand; p += kWarps) {
    const int pid = pair0 + p;
    if (pid >= OO) break;  // warp-uniform
    const InT* row = h2_img + static_cast<size_t>(pid) * E;
    for (int r0 = 0; r0 < R; r0 += kSlots) {
      float acc[kSlots];
#pragma unroll
      for (int s = 0; s < kSlots; ++s) acc[s] = 0.f;
      for (int e = lane; e < E; e += 32) {
        const float x = to_float(row[e]);
#pragma unroll
        for (int s = 0; s < kSlots; ++s) {
          if (r0 + s < R) acc[s] = fmaf(x, es_s[(r0 + s) * E + e], acc[s]);
        }
      }
      float mine = 0.f;  // lane s keeps slot r0 + s
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        float v = acc[s];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == s) mine = v;
      }
      const int r = r0 + lane;
      if (lane < kSlots && r < R) {
        out_s[r * kBand + p] = rel_tokens[b * R + r] == 0
                                   ? default_ll
                                   : log_sigmoid(mine + b_sel[b * R + r]);
      }
    }
  }
  __syncthreads();

  OutT* dst = out + static_cast<size_t>(b) * R * OO;
  for (int k = tid; k < R * kBand; k += kWarps * 32) {
    const int r = k / kBand;
    const int p = k - r * kBand;
    const int pid = pair0 + p;
    if (pid < OO) store(dst + static_cast<size_t>(r) * OO + pid, out_s[k]);
  }
}

template <typename InT, typename OutT>
int launch(const void* h2, const void* img_index, const void* order, const void* e_sel,
           const void* b_sel, const void* rel_tokens, void* out, int U, int B, int O, int E,
           int R, float default_ll, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * E + static_cast<size_t>(R) * kBand);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(shared_contract_kernel<InT, OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(B, (O * O + kBand - 1) / kBand);
  shared_contract_kernel<InT, OutT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const InT*>(h2), static_cast<const int*>(img_index),
      static_cast<const int*>(order), static_cast<const InT*>(e_sel),
      static_cast<const float*>(b_sel), static_cast<const int*>(rel_tokens),
      static_cast<OutT*>(out), U, O, E, R, default_ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in_dtype is the dtype of h2 and e_sel, out_dtype the cache dtype:
// 0 = float32, 1 = bfloat16. Launches on `stream`; returns a cudaError_t code
// (0 = success). Does not synchronise and allocates nothing.
int dfol_shared_contract_fwd(const void* h2, const void* img_index, const void* order,
                             const void* e_sel, const void* b_sel, const void* rel_tokens,
                             void* out, int U, int B, int O, int E, int R, float default_ll,
                             int in_dtype, int out_dtype, void* stream) {
  if (U <= 0 || B <= 0 || O <= 0 || E <= 0 || R <= 0 || O > 2047 || (in_dtype & ~1) ||
      (out_dtype & ~1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const int which = in_dtype * 2 + out_dtype;
  switch (which) {
    case 0:
      return launch<float, float>(h2, img_index, order, e_sel, b_sel, rel_tokens, out, U, B, O,
                                  E, R, default_ll, st);
    case 1:
      return launch<float, __nv_bfloat16>(h2, img_index, order, e_sel, b_sel, rel_tokens, out,
                                          U, B, O, E, R, default_ll, st);
    case 2:
      return launch<__nv_bfloat16, float>(h2, img_index, order, e_sel, b_sel, rel_tokens, out,
                                          U, B, O, E, R, default_ll, st);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16>(h2, img_index, order, e_sel, b_sel,
                                                  rel_tokens, out, U, B, O, E, R, default_ll,
                                                  st);
  }
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
