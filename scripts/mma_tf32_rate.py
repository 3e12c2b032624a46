"""The issue rate of ``mma.sync.m16n8k8`` in TF32 on the card, with no memory
traffic: each warp of a grid of resident blocks runs a loop of independent
products into ``ACC`` accumulator tiles. Prints products per clock per SM and
TFLOP/s for 4 to 16 warps per SM, beside the card's name and power limit.

    PYTHONPATH=. python3 scripts/mma_tf32_rate.py

Kernels 1 and 2 (``csrc/pair_tail_tile.cuh``) issue this instruction for all
their H x E products; this is the ceiling their ``mma.sync`` design can reach.
"""

import ctypes
import os
import subprocess
import sys
import tempfile

import torch

from dfol_vqa_tpu_torch.ops.cuda_build import find_nvcc

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int ACC = 8;  // independent accumulator tiles per warp
__global__ void mma_loop(float* out, int iters, long long* cycles) {
  float d[ACC][4] = {};
  uint32_t a[4], b[2];
  for (int k = 0; k < 4; ++k) a[k] = threadIdx.x + k;
  b[0] = threadIdx.x; b[1] = threadIdx.x + 1;
  long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}
extern "C" int run(float* out, int blocks, int threads, int iters, long long* cycles,
                   void* stream) {
  mma_loop<<<blocks, threads, 0, (cudaStream_t)stream>>>(out, iters, cycles);
  return (int)cudaGetLastError();
}
"""
ACC = 8


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_tf32_rate: needs a CUDA device", file=sys.stderr)
        return 2
    stamp = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "libmma.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
        lib = ctypes.CDLL(lib_path)
        lib.run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        iters = 4096
        for warps in (4, 8, 16):
            threads = 32 * warps
            out = torch.empty(sms * threads, device="cuda")
            cycles = torch.empty(sms, dtype=torch.int64, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            lib.run(out.data_ptr(), sms, threads, iters, cycles.data_ptr(), stream)  # warm-up
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            rc = lib.run(out.data_ptr(), sms, threads, iters, cycles.data_ptr(), stream)
            e.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"launch failed: CUDA error {rc}")
            mmas_per_sm = warps * iters * ACC
            per_clk = mmas_per_sm / cycles.double().mean().item()
            tflops = sms * mmas_per_sm * 2 * 16 * 8 * 8 / (s.elapsed_time(e) * 1e-3) / 1e12
            print(f"mma.sync m16n8k8 tf32, {warps} warps/SM, {ACC} independent tiles per warp: "
                  f"{per_clk!r} products per clock per SM, {tflops!r} TFLOP/s ({stamp})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
