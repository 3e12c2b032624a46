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
// the logits in shared memory and forms
//
//   dlogits = g * sigmoid(-logits) * (rel_tokens != 0)      (pad slots hold a
//             constant in the forward, so they pass no gradient)
//   dz2 = (dlogits @ e_sel) * h2 * (1 - h2),  dz1 = (dz2 @ W2^T) * elu'(z1)
//
// with the ELU and its derivative in the forward kernel's exp(min(x,0)) form, and
// accumulates dh_s, dh_o, dgeom, dWg, db0, dW2, db2, de_sel and db_sel.
//
// What bounds it: at B=80, O=100, H=256, E=300 there are 800k pairs and three
// products per pair of H x E multiply-adds each -- h1 W2 (recompute), dz2 W2^T and
// the dW2 outer product h1^T dz2 -- ~370 GFLOP of f32 FMA work. The plain PyTorch
// version runs them as three large SGEMMs but moves ~10 GB of (B,O,O,H) and
// (B,O,O,E) intermediates through device memory; this kernel keeps every
// intermediate on chip. The TPU kernel sums the weight gradients into output
// blocks that the sequential grid revisits; blocks on Hopper run in parallel in
// no order, so reductions are deterministic partials instead of atomics:
//
// * a block owns a work item (question b, a band of kTI subject rows) and walks
//   its object columns kTJ at a time, so one step is kTI*kTJ = 32 pairs. dh_s of
//   its rows and de_sel/db_sel of the item accumulate in shared memory and are
//   written once per item (de_sel/db_sel as per-item partials); dh_o is written
//   per (item, column) as the TPU kernel's per-i-tile partials; dgeom per pair;
// * blocks are persistent (the caller sizes the grid from
//   dfol_relation_oracle_bwd_blocks_per_sm, so every block is resident) and
//   stride over items. Each block keeps its own slice of a (grid, H, E) dW2 partial in
//   global memory (read-modify-write from L2 per step, register tiles of
//   kTile x kTile) and its dWg/db0/db2 partials in shared memory. The caller sums
//   the partials over their leading axis. The sum order is fixed by the grid, so
//   the result is the same from run to run.
//
// It is plain f32 SIMT code like the forward kernel: wgmma, TMA and tuning are
// later work.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer, all
// float tensors are float32 and contiguous, rel_tokens is int32.

#include <cuda_runtime.h>

namespace {

constexpr int kTI = 4;               // subject rows per work item
constexpr int kTJ = 8;               // object columns per step
constexpr int kPairs = kTI * kTJ;    // pairs per step
constexpr int kStride = kPairs + 4;  // row stride of the per-pair buffers: 16-byte rows
constexpr int kTile = 4;             // dW2 register tile: kTile rows of h x kTile columns of e

__device__ __forceinline__ float elu_exp(float x) {
  return x > 0.f ? x : expf(fminf(x, 0.f)) - 1.f;
}

__device__ __forceinline__ float elu_grad(float x) { return x > 0.f ? 1.f : expf(fminf(x, 0.f)); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// z1 of pair (i, j) of question b at hidden unit h; the same expression in the
// recompute and in the derivative, so both see the same bits.
__device__ __forceinline__ float pre_activation(const float* __restrict__ h_s,
                                                const float* __restrict__ h_o,
                                                const float* __restrict__ w_g,
                                                const float* __restrict__ b0, const float* g4,
                                                int b, int i, int j, int h, int O, int H) {
  const float gw = g4[0] * w_g[h] + g4[1] * w_g[H + h] + g4[2] * w_g[2 * H + h] +
                   g4[3] * w_g[3 * H + h];
  return (h_s[(static_cast<size_t>(b) * O + i) * H + h] +
          h_o[(static_cast<size_t>(b) * O + j) * H + h]) +
         gw + b0[h];
}

__global__ void relation_oracle_bwd_kernel(
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
    const float* __restrict__ g,         // (B, R, O, O) cotangent
    float* __restrict__ dh_s,            // (B, O, H)
    float* __restrict__ dho_part,        // (B, nI, O, H): per-item partials of dh_o
    float* __restrict__ dgeom,           // (B, O, O, 4), or null when not wanted
    float* __restrict__ desel_part,      // (B, nI, R, E)
    float* __restrict__ dbsel_part,      // (B, nI, R)
    float* __restrict__ dw2_part,        // (grid, H, E), zeroed by the caller
    float* __restrict__ small_part,      // (grid, 4H + H + E): dWg, db0, db2
    int B, int O, int H, int E, int R) {
  extern __shared__ float4 smem4[];
  float* h1_t = reinterpret_cast<float*>(smem4);  // [H][kStride]: h1, then dz1
  float* a_t = h1_t + H * kStride;                // [E][kStride]: h2, then dz2
  float* es_s = a_t + E * kStride;                // [R][E]: e_sel[b]
  float* desel_s = es_s + R * E;                  // [R][E]
  float* dl_s = desel_s + R * E;                  // [kPairs][R]: dlogits
  float* geom_s = dl_s + kPairs * R;              // [kPairs][4]
  float* dhs_s = geom_s + kPairs * 4;             // [kTI][H]
  float* dwg_s = dhs_s + kTI * H;                 // [4][H]
  float* db0_s = dwg_s + 4 * H;                   // [H]
  float* db2_s = db0_s + H;                       // [E]
  float* dbsel_s = db2_s + E;                     // [R]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int nI = (O + kTI - 1) / kTI;
  const int nJ = (O + kTJ - 1) / kTJ;
  const int items = B * nI;
  float* dw2 = dw2_part + static_cast<size_t>(blockIdx.x) * H * E;

  for (int k = tid; k < 5 * H; k += nt) dwg_s[k] = 0.f;  // dwg_s and db0_s are adjacent
  for (int k = tid; k < E; k += nt) db2_s[k] = 0.f;

  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / nI;
    const int it = item - b * nI;
    const int i0 = it * kTI;
    const float* es_g = e_sel + static_cast<size_t>(b) * R * E;
    for (int k = tid; k < R * E; k += nt) {
      es_s[k] = es_g[k];
      desel_s[k] = 0.f;
    }
    for (int k = tid; k < kTI * H; k += nt) dhs_s[k] = 0.f;
    for (int k = tid; k < R; k += nt) dbsel_s[k] = 0.f;

    for (int jt = 0; jt < nJ; ++jt) {
      const int j0 = jt * kTJ;
      // Geometry of the step's pairs; pairs outside O x O read zeros.
      for (int k = tid; k < kPairs * 4; k += nt) {
        const int p = k >> 2;
        const int i = i0 + p / kTJ;
        const int j = j0 + p % kTJ;
        geom_s[k] = (i < O && j < O)
                        ? geom[(static_cast<size_t>(b) * O * O + static_cast<size_t>(i) * O + j) * 4 +
                               (k & 3)]
                        : 0.f;
      }
      __syncthreads();

      // h1 (0 outside O x O); consecutive threads take consecutive h.
      for (int k = tid; k < kPairs * H; k += nt) {
        const int p = k / H;
        const int h = k - p * H;
        const int i = i0 + p / kTJ;
        const int j = j0 + p % kTJ;
        float v = 0.f;
        if (i < O && j < O) {
          v = elu_exp(pre_activation(h_s, h_o, w_g, b0, geom_s + 4 * p, b, i, j, h, O, H));
        }
        h1_t[h * kStride + p] = v;
      }
      __syncthreads();

      // Product 1: h2[p, e] = sigmoid(h1[p] . W2[:, e] + b2[e]), one thread per e.
      for (int e = tid; e < E; e += nt) {
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
        float4* out = reinterpret_cast<float4*>(a_t + e * kStride);
#pragma unroll
        for (int q = 0; q < kPairs / 4; ++q) {
          out[q] = make_float4(sigmoid(acc[4 * q + 0] + bias), sigmoid(acc[4 * q + 1] + bias),
                               sigmoid(acc[4 * q + 2] + bias), sigmoid(acc[4 * q + 3] + bias));
        }
      }
      __syncthreads();

      // dlogits, one thread per (r, p): a warp shares r, so e_sel reads broadcast.
      for (int t = tid; t < R * kPairs; t += nt) {
        const int r = t / kPairs;
        const int p = t - r * kPairs;
        const int i = i0 + p / kTJ;
        const int j = j0 + p % kTJ;
        float dl = 0.f;
        if (i < O && j < O && rel_tokens[b * R + r] != 0) {
          float s = 0.f;
          for (int e = 0; e < E; ++e) s = fmaf(a_t[e * kStride + p], es_s[r * E + e], s);
          const float logit = s + b_sel[b * R + r];
          const float gv =
              g[(static_cast<size_t>(b) * R + r) * O * O + static_cast<size_t>(i) * O + j];
          dl = gv * sigmoid(-logit);
        }
        dl_s[p * R + r] = dl;
      }
      __syncthreads();

      // Per e: de_sel += dlogits^T h2, then dz2 = (dlogits e_sel) h2 (1 - h2) in
      // place of h2, and db2; threads r < R also sum db_sel.
      for (int e = tid; e < E; e += nt) {
        float v[kPairs];
        float4* row = reinterpret_cast<float4*>(a_t + e * kStride);
#pragma unroll
        for (int q = 0; q < kPairs / 4; ++q) {
          const float4 x = row[q];
          v[4 * q + 0] = x.x;
          v[4 * q + 1] = x.y;
          v[4 * q + 2] = x.z;
          v[4 * q + 3] = x.w;
        }
        for (int r = 0; r < R; ++r) {
          float acc = 0.f;
#pragma unroll
          for (int p = 0; p < kPairs; ++p) acc = fmaf(dl_s[p * R + r], v[p], acc);
          desel_s[r * E + e] += acc;
        }
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          float dh2 = 0.f;
          for (int r = 0; r < R; ++r) dh2 = fmaf(dl_s[p * R + r], es_s[r * E + e], dh2);
          v[p] = dh2 * v[p] * (1.f - v[p]);
          sum += v[p];
        }
#pragma unroll
        for (int q = 0; q < kPairs / 4; ++q) {
          row[q] = make_float4(v[4 * q + 0], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        }
        db2_s[e] += sum;
      }
      for (int r = tid; r < R; r += nt) {
        float sum = 0.f;
        for (int p = 0; p < kPairs; ++p) sum += dl_s[p * R + r];
        dbsel_s[r] += sum;
      }
      __syncthreads();

      // Product 3: this block's dW2 partial += h1^T dz2, kTile x kTile per thread.
      {
        const int nHt = (H + kTile - 1) / kTile;
        const int nEt = (E + kTile - 1) / kTile;
        for (int t = tid; t < nHt * nEt; t += nt) {
          const int ht = t / nEt;
          const int h0 = ht * kTile;
          const int e0 = (t - ht * nEt) * kTile;
          float acc[kTile][kTile];
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
#pragma unroll
            for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;
          }
#pragma unroll 2
          for (int q = 0; q < kPairs / 4; ++q) {
            float4 hv[kTile];
            float4 ev[kTile];
#pragma unroll
            for (int a = 0; a < kTile; ++a) {
              hv[a] = h0 + a < H ? reinterpret_cast<const float4*>(h1_t + (h0 + a) * kStride)[q]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
              ev[a] = e0 + a < E ? reinterpret_cast<const float4*>(a_t + (e0 + a) * kStride)[q]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
            }
#pragma unroll
            for (int a = 0; a < kTile; ++a) {
#pragma unroll
              for (int c = 0; c < kTile; ++c) {
                float s = acc[a][c];
                s = fmaf(hv[a].x, ev[c].x, s);
                s = fmaf(hv[a].y, ev[c].y, s);
                s = fmaf(hv[a].z, ev[c].z, s);
                s = fmaf(hv[a].w, ev[c].w, s);
                acc[a][c] = s;
              }
            }
          }
#pragma unroll
          for (int a = 0; a < kTile; ++a) {
#pragma unroll
            for (int c = 0; c < kTile; ++c) {
              if (h0 + a < H && e0 + c < E) dw2[(h0 + a) * E + e0 + c] += acc[a][c];
            }
          }
        }
      }
      __syncthreads();

      // Product 2: dh1 = dz2 W2^T, one thread per h; dz1 = dh1 * elu'(z1) in place
      // of h1, then dh_s, the dh_o partial, db0 and dWg.
      for (int h = tid; h < H; h += nt) {
        float acc[kPairs];
#pragma unroll
        for (int p = 0; p < kPairs; ++p) acc[p] = 0.f;
        for (int e = 0; e < E; ++e) {
          const float w = __ldg(w2t + static_cast<size_t>(e) * H + h);
          const float4* row = reinterpret_cast<const float4*>(a_t + e * kStride);
#pragma unroll
          for (int q = 0; q < kPairs / 4; ++q) {
            const float4 v = row[q];
            acc[4 * q + 0] = fmaf(v.x, w, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v.y, w, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v.z, w, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v.w, w, acc[4 * q + 3]);
          }
        }
        float sum = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f, g3 = 0.f;
        float col[kTJ];
#pragma unroll
        for (int tj = 0; tj < kTJ; ++tj) col[tj] = 0.f;
#pragma unroll
        for (int ti = 0; ti < kTI; ++ti) {
          float row_sum = 0.f;
#pragma unroll
          for (int tj = 0; tj < kTJ; ++tj) {
            const int p = ti * kTJ + tj;
            const int i = i0 + ti;
            const int j = j0 + tj;
            float dz = 0.f;
            if (i < O && j < O) {
              const float* g4 = geom_s + 4 * p;
              dz = acc[p] * elu_grad(pre_activation(h_s, h_o, w_g, b0, g4, b, i, j, h, O, H));
              g0 = fmaf(g4[0], dz, g0);
              g1 = fmaf(g4[1], dz, g1);
              g2 = fmaf(g4[2], dz, g2);
              g3 = fmaf(g4[3], dz, g3);
            }
            h1_t[h * kStride + p] = dz;
            row_sum += dz;
            col[tj] += dz;
          }
          dhs_s[ti * H + h] += row_sum;
          sum += row_sum;
        }
#pragma unroll
        for (int tj = 0; tj < kTJ; ++tj) {
          const int j = j0 + tj;
          if (j < O) dho_part[((static_cast<size_t>(b) * nI + it) * O + j) * H + h] = col[tj];
        }
        db0_s[h] += sum;
        dwg_s[h] += g0;
        dwg_s[H + h] += g1;
        dwg_s[2 * H + h] += g2;
        dwg_s[3 * H + h] += g3;
      }
      __syncthreads();

      // dgeom[b, i, j, c] = dz1[p] . Wg[c], one thread per (p, c).
      if (dgeom != nullptr) {
        for (int t = tid; t < kPairs * 4; t += nt) {
          const int p = t >> 2;
          const int c = t & 3;
          const int i = i0 + p / kTJ;
          const int j = j0 + p % kTJ;
          if (i >= O || j >= O) continue;
          float s = 0.f;
          for (int h = 0; h < H; ++h) s = fmaf(h1_t[h * kStride + p], w_g[c * H + h], s);
          dgeom[(static_cast<size_t>(b) * O * O + static_cast<size_t>(i) * O + j) * 4 + c] = s;
        }
      }
      // The next step writes geom_s and then (after a barrier) h1_t; the dgeom
      // pass reads only h1_t and w_g, so the barrier after the geometry load
      // orders it.
    }
    __syncthreads();

    // The item's rows of dh_s, and its de_sel / db_sel partials.
    for (int k = tid; k < kTI * H; k += nt) {
      const int i = i0 + k / H;
      if (i < O) dh_s[(static_cast<size_t>(b) * O + i) * H + (k % H)] = dhs_s[k];
    }
    float* desel_dst = desel_part + static_cast<size_t>(item) * R * E;
    for (int k = tid; k < R * E; k += nt) desel_dst[k] = desel_s[k];
    for (int k = tid; k < R; k += nt) dbsel_part[static_cast<size_t>(item) * R + k] = dbsel_s[k];
    __syncthreads();
  }

  // The block's dWg, db0 and db2 partials.
  float* small = small_part + static_cast<size_t>(blockIdx.x) * (5 * H + E);
  for (int k = tid; k < 5 * H; k += nt) small[k] = dwg_s[k];
  for (int k = tid; k < E; k += nt) small[5 * H + k] = db2_s[k];
}

// Threads and dynamic shared memory of a launch at these widths; raises the
// kernel's shared-memory limit when the launch needs more than 48 KB.
cudaError_t launch_shape(int H, int E, int R, int* threads, size_t* smem) {
  int t = ((H > E ? H : E) + 31) / 32 * 32;
  *threads = t < 128 ? 128 : (t > 512 ? 512 : t);
  const size_t floats = static_cast<size_t>(H) * kStride + static_cast<size_t>(E) * kStride +
                        2 * static_cast<size_t>(R) * E + static_cast<size_t>(kPairs) * R +
                        kPairs * 4 + static_cast<size_t>(kTI) * H + 5 * static_cast<size_t>(H) +
                        E + R;
  *smem = sizeof(float) * floats;
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(relation_oracle_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(*smem));
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Subject rows per work item (kTI): the caller sizes the per-item partials
// dho_part, desel_part and dbsel_part with ceil(O / this) items per question.
int dfol_relation_oracle_bwd_rows() { return kTI; }

// Blocks of the kernel that fit on one SM at once at these widths (registers
// and shared memory), written to *blocks; returns a cudaError_t code. The
// persistent grid is this times the SM count, so all its blocks are resident.
int dfol_relation_oracle_bwd_blocks_per_sm(int H, int E, int R, int* blocks) {
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = launch_shape(H, E, R, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, relation_oracle_bwd_kernel, threads, smem));
}

// Launches on `stream` with `grid` persistent blocks; returns a cudaError_t code
// (0 = success). Does not synchronise and allocates nothing: the caller passes
// dw2_part zeroed and sums every *_part buffer over its leading item/block axis.
int dfol_relation_oracle_bwd(const void* h_s, const void* h_o, const void* geom,
                             const void* w_g, const void* b0, const void* w2, const void* w2t,
                             const void* b2, const void* e_sel, const void* b_sel,
                             const void* rel_tokens, const void* g, void* dh_s, void* dho_part,
                             void* dgeom, void* desel_part, void* dbsel_part, void* dw2_part,
                             void* small_part, int B, int O, int H, int E, int R, int grid,
                             void* stream) {
  if (B <= 0 || O <= 0 || H <= 0 || E <= 0 || R <= 0 || grid <= 0 || O > 46340) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = 0;
  size_t smem = 0;
  cudaError_t err = launch_shape(H, E, R, &threads, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  relation_oracle_bwd_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(h_s), static_cast<const float*>(h_o),
      static_cast<const float*>(geom), static_cast<const float*>(w_g),
      static_cast<const float*>(b0), static_cast<const float*>(w2),
      static_cast<const float*>(w2t), static_cast<const float*>(b2),
      static_cast<const float*>(e_sel), static_cast<const float*>(b_sel),
      static_cast<const int*>(rel_tokens), static_cast<const float*>(g),
      static_cast<float*>(dh_s), static_cast<float*>(dho_part), static_cast<float*>(dgeom),
      static_cast<float*>(desel_part), static_cast<float*>(dbsel_part),
      static_cast<float*>(dw2_part), static_cast<float*>(small_part), B, O, H, E, R);
  return static_cast<int>(cudaGetLastError());
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
