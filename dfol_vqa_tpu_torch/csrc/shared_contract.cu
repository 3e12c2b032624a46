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
// What bounds it: it reads U*O^2*E elements of h2 and writes B*R*O^2
// log-likelihoods: 48 MB of bf16 h2 and 25.6 MB of float32 results at U=8,
// B=80, R=8, O=100, E=300, 0.022 ms at 3.35 TB/s, against 3.8 GFLOP of
// products (0.004 ms at the bf16 tensor-core rate): the bytes.
//
// Design: for image u the log-likelihoods of all its questions are one
// matrix product, (pairs x E) . (E x n_u R), with a logsigmoid epilogue. The
// caller sorts the questions by image and passes each image's start and
// count in that order. The grid is about one block per SM: block (x, u)
// takes a run of consecutive 64-pair bands of image u. It keeps e_sel of the
// image's (question, slot) columns in shared memory (loaded once when they
// fit one 128-column, 320-deep tile, as 10 questions of 8 slots do; else
// per band, group and chunk of E), and brings each band of h2 into shared
// memory once, with one bulk (TMA) copy of its contiguous bytes
// (cp.async.bulk; the few bytes before the first and after the last 16-byte
// boundary by plain loads, so any band start and row length work: a bf16 row
// of E=300 is 600 bytes). Three band buffers: the next two bands' copies are
// in flight while the current one is scored. The products run on the tensor cores --
// mma.sync.m16n8k16 in bf16 with float32 sums for a bf16 stream (exact
// products), m16n8k8 TF32 in the split-precision 3xTF32 scheme for a float32
// one -- 16 warps, 16 pairs x every fourth n8 tile of columns each; the
// logsigmoid epilogue stores from the accumulators (a warp's store is 4
// columns x 8 consecutive pairs: whole 32-byte sectors). An image with no questions costs no h2 read;
// no atomics, nothing carried between blocks.
//
// Plain C interface (loaded with ctypes); every pointer is a device pointer,
// all tensors are contiguous, index tensors int32, b_sel float32.

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "bulk_copy.cuh"
#include "pair_tail_tile.cuh"

namespace {

using namespace bulk;

constexpr int kMaxBand = 64;              // object pairs per band, at most
constexpr int kWarpsM = 4;                // warps along the pairs, 16 pairs each
constexpr int kWarpsN = 4;                // warps along the columns
constexpr int kWarps = kWarpsM * kWarpsN;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkK = 320;              // e_sel columns per tile
constexpr int kBufs = 3;                  // band buffers: two copies in flight
constexpr int kSmemLimit = 227 * 1024;

// (question, slot) columns per group: 128 for a bf16 stream (16 questions of
// 8 slots, so a 10-question image's e_sel stays in shared memory for all its
// bands), 64 for a float32 one (twice the bytes per element).
template <typename InT>
__host__ __device__ constexpr int group_cols() {
  return sizeof(InT) == 2 ? 128 : 64;
}

// 32-bit words per e_sel tile row: kChunkK elements plus 4 words, so that the
// B fragment loads (row g, word t) are free of bank conflicts.
template <typename InT>
__host__ __device__ constexpr int es_pitch() {
  return kChunkK * static_cast<int>(sizeof(InT)) / 4 + 4;
}

// Bytes of one band buffer: the band's elements, 16 for its alignment phase.
__host__ __device__ inline int band_buffer_bytes(int band_pairs, int E, int esize) {
  return (band_pairs * E * esize + 15) / 16 * 16 + 16;
}

// 4-byte asynchronous copy into shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Elements k and k + 1 of band row p, packed (k in the low half); zero past
// E and past the band's np pairs. `words`: E is even and the band 4-byte
// aligned, so the pair is one aligned 32-bit word.
__device__ __forceinline__ uint32_t band_pair(const char* band, int E, int np, int p, int k,
                                              bool words) {
  if (p >= np || k >= E) return 0u;
  const char* ptr = band + (static_cast<size_t>(p) * E + k) * 2;
  if (words) return *reinterpret_cast<const uint32_t*>(ptr);
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(ptr);
  const uint32_t hi = k + 1 < E ? *reinterpret_cast<const uint16_t*>(ptr + 2) : 0u;
  return lo | (hi << 16);
}

__device__ __forceinline__ float band_f32(const char* band, int E, int np, int p, int k) {
  return p < np && k < E ? reinterpret_cast<const float*>(band)[static_cast<size_t>(p) * E + k]
                         : 0.f;
}

// A band of h2 in global memory: np * E contiguous elements from src, whose
// address is `phase` (mod 16). The bulk copy engine takes the `body` bytes
// between the first and the last 16-byte boundary; the `head` bytes before
// and the tail after are plain loads.
struct Band {
  const char* src;
  int np, bytes, phase, head, body;
};

template <typename InT>
__device__ __forceinline__ Band band_at(const InT* h2, int u, int OO, int E, int band_pairs,
                                        int bi) {
  Band bd;
  const int pair0 = bi * band_pairs;
  bd.src = reinterpret_cast<const char*>(h2 + (static_cast<size_t>(u) * OO + pair0) * E);
  bd.np = min(band_pairs, OO - pair0);
  bd.bytes = bd.np * E * static_cast<int>(sizeof(InT));
  bd.phase = static_cast<int>(reinterpret_cast<uintptr_t>(bd.src) & 15);
  bd.head = min(bd.bytes, (16 - bd.phase) & 15);
  bd.body = (bd.bytes - bd.head) & ~15;
  return bd;
}

// Start bringing band bd into buf (kept at its phase): thread 0 arms the
// buffer's barrier and starts the bulk copy, every thread copies its share
// of the two ends. The caller waits on the barrier (when body > 0) and
// meets the block at __syncthreads before reading.
__device__ __forceinline__ void start_band(const Band& bd, char* buf, uint64_t* bar) {
  char* dst = buf + bd.phase;
  if (threadIdx.x == 0 && bd.body > 0) {
    // the buffer's last reads (generic proxy) before the copy engine writes it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_load(dst + bd.head, bd.src + bd.head, bd.body, bar);
  }
  for (int c = 2 * threadIdx.x; c < bd.head; c += 2 * kThreads) {
    *reinterpret_cast<uint16_t*>(dst + c) = *reinterpret_cast<const uint16_t*>(bd.src + c);
  }
  for (int c = bd.head + bd.body + 2 * threadIdx.x; c < bd.bytes; c += 2 * kThreads) {
    *reinterpret_cast<uint16_t*>(dst + c) = *reinterpret_cast<const uint16_t*>(bd.src + c);
  }
}

// The persistent kernel: grid (chunks, U). Block (x, u) takes the bands
// [x per, (x + 1) per) of image u (per = ceil(bands / chunks)) and keeps the
// next kBufs - 1 bands' bulk copies in flight while it scores the current
// one.
template <typename InT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1) shared_contract_kernel(
    const InT* __restrict__ h2,          // (U, O, O, E)
    const int* __restrict__ order,       // (B,) questions sorted by (clamped) image
    const int* __restrict__ starts,      // (U,) each image's first place in order
    const int* __restrict__ counts,      // (U,) each image's questions
    const InT* __restrict__ e_sel,       // (B, R, E)
    const float* __restrict__ b_sel,     // (B, R)
    const int* __restrict__ rel_tokens,  // (B, R)
    OutT* __restrict__ out,              // (B, R, O, O)
    int O, int E, int R, int band_pairs, float default_ll) {
  constexpr bool kBf16 = sizeof(InT) == 2;
  constexpr int kCols = group_cols<InT>();
  constexpr int kPitch = es_pitch<InT>();
  constexpr int kNTw = kCols / kWarpsN / 8;  // n8 tiles per warp: tiles wn, wn + kWarpsN, ...
  const int u = blockIdx.y;
  const int count = counts[u];
  if (count == 0) return;  // no question reads this image
  const int OO = O * O;
  const int n_bands = (OO + band_pairs - 1) / band_pairs;
  const int per = (n_bands + gridDim.x - 1) / gridDim.x;
  const int b_first = blockIdx.x * per;
  const int b_last = min(b_first + per, n_bands);
  if (b_first >= b_last) return;
  const int start = starts[u];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  const int row0 = wm * 16 + g;  // this lane's pair rows: row0, row0 + 8

  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);           // [kBufs], one per buffer
  uint32_t* es_s = reinterpret_cast<uint32_t*>(smem4 + 2);        // [kCols][kPitch] words
  // [kCols] b * R + r of a live column, ~(b * R + r) of a pad slot's, -1 past the group
  int* col_br = reinterpret_cast<int*>(es_s + kCols * kPitch);
  float* col_bias = reinterpret_cast<float*>(col_br + kCols);      // [kCols] b_sel
  char* bufs = reinterpret_cast<char*>(col_bias + kCols);          // kBufs band buffers
  const int buf_bytes = band_buffer_bytes(band_pairs, E, sizeof(InT));

  const int columns = count * R;
  const int n_groups = (columns + kCols - 1) / kCols;
  const int n_chunks = (E + kChunkK - 1) / kChunkK;
  // one e_sel tile serves every band: load it once
  const bool resident = n_groups * n_chunks == 1;

  // The group's column table (tid < kCols).
  const auto set_columns = [&](int c0) {
    if (tid < kCols) {
      const int c = c0 + tid;
      const int br = c < columns ? order[start + c / R] * R + c % R : -1;
      const bool live = br >= 0 && rel_tokens[br] != 0;
      col_br[tid] = live || br < 0 ? br : ~br;
      col_bias[tid] = live ? b_sel[br] : 0.f;
    }
  };
  // e_sel rows of the group's columns, k in [k0, k0 + kcp), zero past E (and
  // on pad slots, whose results are not used): 4-byte asynchronous copies (a
  // row of E bf16 is 4-byte aligned when E is even), a warp per row, all in
  // flight before one wait. Reads col_br; ends with a block barrier.
  const auto load_esel = [&](int k0) {
    __syncthreads();  // the last tile's readers are done
    const int kc = min(kChunkK, E - k0);
    const int kcp = kBf16 ? (kc + 15) / 16 * 16 : (kc + 7) / 8 * 8;
    const int row_words = kBf16 ? kcp / 2 : kcp;
    const int live_words = kBf16 ? kc / 2 : kc;  // whole words inside the row
    for (int col = warp; col < kCols; col += kWarps) {
      const int br = col_br[col];
      const InT* row = e_sel + static_cast<size_t>(br < 0 ? 0 : br) * E + k0;
      uint32_t* dst = es_s + col * kPitch;
      for (int w = lane; w < row_words; w += 32) {
        if (kBf16 && (E % 2 != 0 || (w == live_words && kc % 2 != 0))) {
          const int k = 2 * w;  // odd E: element by element
          const uint32_t lo = br >= 0 && k < kc ? __bfloat16_as_ushort(row[k]) : 0u;
          const uint32_t hi = br >= 0 && k + 1 < kc ? __bfloat16_as_ushort(row[k + 1]) : 0u;
          dst[w] = lo | (hi << 16);
        } else {
          cp_async4(dst + w, reinterpret_cast<const uint32_t*>(row) + w, br >= 0 && w < live_words);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
  };

  if (tid == 0) {
    for (int k = 0; k < kBufs; ++k) mbar_init(bars + k);
    mbar_fence_init();
  }
  __syncthreads();
  for (int k = 0; k < kBufs - 1 && b_first + k < b_last; ++k) {
    start_band(band_at(h2, u, OO, E, band_pairs, b_first + k), bufs + k * buf_bytes, bars + k);
  }
  if (resident) {
    set_columns(0);
    load_esel(0);
  }
  unsigned parity = 0u;  // bit k: the phase of buffer k's barrier

  for (int bi = b_first; bi < b_last; ++bi) {
    const int cur = (bi - b_first) % kBufs;
    const Band bd = band_at(h2, u, OO, E, band_pairs, bi);
    if (bd.body > 0) {
      mbar_wait(bars + cur, (parity >> cur) & 1u);
      parity ^= 1u << cur;
    }
    // the band's ends are in place, and every warp is done with band bi - 1,
    // whose buffer takes band bi + kBufs - 1
    __syncthreads();
    if (bi + kBufs - 1 < b_last) {
      const int nxt = (cur + kBufs - 1) % kBufs;
      start_band(band_at(h2, u, OO, E, band_pairs, bi + kBufs - 1), bufs + nxt * buf_bytes,
                 bars + nxt);
    }
    const char* band = bufs + cur * buf_bytes + bd.phase;
    const int np = bd.np;
    const bool words = E % 2 == 0 && bd.phase % 4 == 0;
    const bool active = wm * 16 < np;
    const int pair0 = bi * band_pairs;

    for (int grp = 0; grp < n_groups; ++grp) {
      const int c0 = grp * kCols;
      const int ncols = min(kCols, columns - c0);
      if (!resident) {
        __syncthreads();  // the last group's epilogue has read the column table
        set_columns(c0);
      }
      float acc[kNTw][4];
#pragma unroll
      for (int nt = 0; nt < kNTw; ++nt)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[nt][k] = 0.f;
      for (int k0 = 0; k0 < E; k0 += kChunkK) {
        if (!resident) load_esel(k0);
        const int kc = min(kChunkK, E - k0);
        if (!active) continue;
        if constexpr (kBf16) {
          const int kcp = (kc + 15) / 16 * 16;
          for (int kk = 0; kk < kcp; kk += 16) {
            const int k = k0 + kk + 2 * t;
            const uint32_t a[4] = {band_pair(band, E, np, row0, k, words),
                                   band_pair(band, E, np, row0 + 8, k, words),
                                   band_pair(band, E, np, row0, k + 8, words),
                                   band_pair(band, E, np, row0 + 8, k + 8, words)};
            const uint32_t* bw = es_s + (wn * 8 + g) * kPitch + kk / 2 + t;
#pragma unroll
            for (int nt = 0; nt < kNTw; ++nt) {
              if ((kWarpsN * nt + wn) * 8 < ncols) {
                mma_bf16(acc[nt], a, bw[nt * 8 * kWarpsN * kPitch],
                         bw[nt * 8 * kWarpsN * kPitch + 4]);
              }
            }
          }
        } else {
          // each k-step's three products start from zero and are added to
          // acc in float32: the tensor core's own sums of long runs of
          // float32-sized terms lose bits that the 1e-4 gate sees at E=300
          const int kcp = (kc + 7) / 8 * 8;
          for (int kk = 0; kk < kcp; kk += 8) {
            const int k = k0 + kk + t;
            uint32_t a_big[4], a_small[4];
            pair_tail::split(band_f32(band, E, np, row0, k), a_big[0], a_small[0]);
            pair_tail::split(band_f32(band, E, np, row0 + 8, k), a_big[1], a_small[1]);
            pair_tail::split(band_f32(band, E, np, row0, k + 4), a_big[2], a_small[2]);
            pair_tail::split(band_f32(band, E, np, row0 + 8, k + 4), a_big[3], a_small[3]);
            const uint32_t* bw = es_s + (wn * 8 + g) * kPitch + kk + t;
#pragma unroll
            for (int nt = 0; nt < kNTw; ++nt) {
              if ((kWarpsN * nt + wn) * 8 >= ncols) continue;
              uint32_t b_big[2], b_small[2];
              const uint32_t* b_nt = bw + nt * 8 * kWarpsN * kPitch;
              pair_tail::split(__uint_as_float(b_nt[0]), b_big[0], b_small[0]);
              pair_tail::split(__uint_as_float(b_nt[4]), b_big[1], b_small[1]);
              float part[4] = {0.f, 0.f, 0.f, 0.f};
              pair_tail::mma_tf32(part, a_small, b_big[0], b_big[1]);
              pair_tail::mma_tf32(part, a_big, b_small[0], b_small[1]);
              pair_tail::mma_tf32(part, a_big, b_big[0], b_big[1]);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[nt][c] += part[c];
            }
          }
        }
      }

      // Epilogue from the accumulators: a warp's store covers 4 columns x 8
      // consecutive pairs of the R-major output, whole 32-byte sectors.
      if (active) {
#pragma unroll
        for (int nt = 0; nt < kNTw; ++nt) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int col = (kWarpsN * nt + wn) * 8 + 2 * t + c;
            if (col >= ncols) continue;
            const int br = col_br[col];
            const bool pad = br < 0;  // a pad slot
            const float bias = col_bias[col];
            OutT* dst = out + static_cast<size_t>(pad ? ~br : br) * OO + pair0;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int p = row0 + 8 * half;
              if (p < np) {
                put(dst + p,
                    pad ? default_ll : pair_tail::log_sigmoid(acc[nt][2 * half + c] + bias));
              }
            }
          }
        }
      }
    }
  }
}

// Pairs per band: 64, or 32 / 16 where kBufs bands of E-wide rows would not
// fit; 0 when none fits. *smem gets the block's dynamic shared memory.
template <typename InT>
int band_pairs(int E, size_t* smem) {
  constexpr int kCols = group_cols<InT>();
  const size_t fixed = 32 + sizeof(uint32_t) * kCols * es_pitch<InT>() + 2 * sizeof(int) * kCols;
  for (int p = kMaxBand; p >= 16; p /= 2) {
    *smem = fixed + kBufs * static_cast<size_t>(band_buffer_bytes(p, E, sizeof(InT)));
    if (*smem <= kSmemLimit) return p;
  }
  return 0;
}

template <typename InT, typename OutT>
int launch(const void* h2, const void* order, const void* starts, const void* counts,
           const void* e_sel, const void* b_sel, const void* rel_tokens, void* out, int U, int O,
           int E, int R, float default_ll, cudaStream_t stream) {
  size_t smem = 0;
  const int band = band_pairs<InT>(E, &smem);
  if (band == 0 || static_cast<long long>(band) * E * sizeof(InT) > 0xFFFFF) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = shared_contract_kernel<InT, OutT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block per SM in all (U blocks at least): each image's bands split
  // over sms / U blocks
  const int bands = (O * O + band - 1) / band;
  const int chunks = std::max(1, std::min(bands, sms / U));
  const dim3 grid(chunks, U);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const InT*>(h2), static_cast<const int*>(order),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<const InT*>(e_sel), static_cast<const float*>(b_sel),
      static_cast<const int*>(rel_tokens), static_cast<OutT*>(out), O, E, R, band, default_ll);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// in_dtype is the dtype of h2 and e_sel, out_dtype the cache dtype:
// 0 = float32, 1 = bfloat16. order (B,) lists the questions sorted by their
// image (clamped to [0, U)); starts and counts (U,) give each image's run in
// it. Launches on `stream`; returns a cudaError_t code (0 = success). Does
// not synchronise and allocates nothing.
int dfol_shared_contract_fwd(const void* h2, const void* order, const void* starts,
                             const void* counts, const void* e_sel, const void* b_sel,
                             const void* rel_tokens, void* out, int U, int B, int O, int E, int R,
                             float default_ll, int in_dtype, int out_dtype, void* stream) {
  if (U <= 0 || U > 65535 || B <= 0 || O <= 0 || E <= 0 || R <= 0 || O > 2047 ||
      (in_dtype & ~1) || (out_dtype & ~1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (in_dtype * 2 + out_dtype) {
    case 0:
      return launch<float, float>(h2, order, starts, counts, e_sel, b_sel, rel_tokens, out, U, O,
                                  E, R, default_ll, st);
    case 1:
      return launch<float, __nv_bfloat16>(h2, order, starts, counts, e_sel, b_sel, rel_tokens,
                                          out, U, O, E, R, default_ll, st);
    case 2:
      return launch<__nv_bfloat16, float>(h2, order, starts, counts, e_sel, b_sel, rel_tokens,
                                          out, U, O, E, R, default_ll, st);
    default:
      return launch<__nv_bfloat16, __nv_bfloat16>(h2, order, starts, counts, e_sel, b_sel,
                                                  rel_tokens, out, U, O, E, R, default_ll, st);
  }
}

const char* dfol_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
