"""How fast mma.sync runs TF32 products on one NVIDIA card, alone and in K7b's inner loop.

    python3 tf32_peak.py [--out FILE]

Builds one small CUDA program with nvcc (under ``build/tf32_peak/``) and prints, for 132 blocks
of 128, 256 and 512 threads:

- ``[mma]``: back-to-back ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` on 4, 8 and 16
  independent accumulators a warp, operands in registers: the card's ceiling for the route K7b
  takes (csrc/res_block_2d_bwd.cu), in m16n8k8 products a clock an SM (the block's clock64 over
  the loop) and in TF32 TFLOP/s (CUDA events);
- ``[loop]``: K7b's input-gradient inner loop in isolation (a warp's 32 x 32 tile, 8-byte
  fragment loads from shared rows of 72 floats, the next step's operands loaded before this
  step's products), with each operand split as ``raw`` (its bits as they are, one product a
  tile), ``int`` (hi and lo rounded to TF32 by two integer ops each, csrc/mma_tf32.cuh, three
  products a tile), ``int_lo_trunc`` (lo unrounded) and ``cvt`` (cvt.rna.tf32.f32 for hi and
  lo).

Prints the card's name and power limit and one JSON line, also written to FILE (default
``build/tf32_peak.json``). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent

SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
               "{%8,%9}, {%0,%1,%2,%3};"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int NACC>
__global__ void peak(float* out, int iters, long long* clk) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1.0f + threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(0.5f + threadIdx.x * 1e-3f + i);
  float acc[NACC][4] = {};
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma(acc[j], a, b);
  }
  const long long t1 = clock64();
  float s = 0;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *clk = t1 - t0;
}

// 0 raw bits, 1 int rounding of hi and lo, 2 lo unrounded, 3 cvt.rna.tf32.f32
template <int S>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (S == 3) {
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
    const float r = v - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(r));
  } else if (S == 0) {
    hi = lo = __float_as_uint(v);
  } else {
    hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    const float r = v - __uint_as_float(hi);
    lo = S == 1 ? ((__float_as_uint(r) + 0x1000u) & 0xffffe000u) : __float_as_uint(r);
  }
}

constexpr int kLd = 72;

template <int S>
__global__ void __launch_bounds__(512) loop(float* out, int reps, long long* clk) {
  extern __shared__ float sm[];
  const int warps = blockDim.x / 32, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* T = sm;
  float* W = sm + warps / 2 * 32 * kLd;
  for (int i = threadIdx.x; i < (warps / 2 * 32 + 64) * kLd; i += blockDim.x)
    sm[i] = 1.f + 1e-3f * (i % 97);
  __syncthreads();
  const float* A = T + ((w >> 1) * 32 + g) * kLd + 2 * t;
  const float* B = W + ((w & 1) * 32 + g) * kLd + 2 * t;
  float acc[2][4][4] = {};
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    float2 ra[2][2], rb[4];
    auto fetch = [&](int k0) {
      for (int mt = 0; mt < 2; ++mt) {
        ra[mt][0] = *reinterpret_cast<const float2*>(A + mt * 16 * kLd + k0);
        ra[mt][1] = *reinterpret_cast<const float2*>(A + (mt * 16 + 8) * kLd + k0);
      }
      for (int nt = 0; nt < 4; ++nt) rb[nt] = *reinterpret_cast<const float2*>(B + nt * 8 * kLd + k0);
    };
    fetch(0);
#pragma unroll
    for (int k0 = 0; k0 < 64; k0 += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        split<S>(ra[mt][0].x, ah[mt][0], al[mt][0]);
        split<S>(ra[mt][1].x, ah[mt][1], al[mt][1]);
        split<S>(ra[mt][0].y, ah[mt][2], al[mt][2]);
        split<S>(ra[mt][1].y, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split<S>(rb[nt].x, bh[nt][0], bl[nt][0]);
        split<S>(rb[nt].y, bh[nt][1], bl[nt][1]);
      }
      if (k0 + 8 < 64) fetch(k0 + 8);
      if (S > 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], ah[mt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
    }
  }
  const long long t1 = clock64();
  float s = 0;
  for (int mt = 0; mt < 2; ++mt)
    for (int nt = 0; nt < 4; ++nt)
      for (int i = 0; i < 4; ++i) s += acc[mt][nt][i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0 && blockIdx.x == 0) *clk = t1 - t0;
}

constexpr int kBlocks = 132;

template <typename K>
void run(const char* tag, const char* what, K kernel, int threads, int smem, int iters,
         double mmas_per_warp, float* out, long long* clk) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<kBlocks, threads, smem>>>(out, 2, clk);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  kernel<<<kBlocks, threads, smem>>>(out, iters, clk);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long c;
  cudaMemcpy(&c, clk, 8, cudaMemcpyDeviceToHost);
  const double mmas = (threads / 32) * mmas_per_warp * iters;  // a block
  printf("[%s] %s threads %d: %.3f mma/clk/SM, %.1f TFLOP/s tf32, %.1f us, %s\n", tag, what,
         threads, mmas / double(c), mmas * kBlocks * 2048 / (ms * 1e-3) / 1e12, ms * 1e3,
         cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  long long* clk;
  cudaMalloc(&out, kBlocks * 512 * 4);
  cudaMalloc(&clk, 8);
  for (int th : {128, 256, 512}) {
    run("mma", "acc 4", peak<4>, th, 0, 4096, 4, out, clk);
    run("mma", "acc 8", peak<8>, th, 0, 4096, 8, out, clk);
    run("mma", "acc 16", peak<16>, th, 0, 4096, 16, out, clk);
  }
  for (int th : {256, 512}) {
    const int smem = (th / 64 * 32 + 64) * kLd * 4;
    run("loop", "raw", loop<0>, th, smem, 2000, 64, out, clk);
    run("loop", "int", loop<1>, th, smem, 2000, 192, out, clk);
    run("loop", "int_lo_trunc", loop<2>, th, smem, 2000, 192, out, clk);
    run("loop", "cvt", loop<3>, th, smem, 2000, 192, out, clk);
  }
  return 0;
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=HERE / "build" / "tf32_peak.json")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line
    from iinsvae_torch.ops.kernels import _build

    d = HERE / "build" / "tf32_peak"
    d.mkdir(parents=True, exist_ok=True)
    (d / "tf32_peak.cu").write_text(SOURCE)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([_build.nvcc(), *flags, "-o", str(d / "tf32_peak"), str(d / "tf32_peak.cu")],
                   check=True)
    text = subprocess.run([str(d / "tf32_peak")], capture_output=True, text=True,
                          check=True).stdout
    print(text, end="", flush=True)
    rows = [dict(kind=m[0], what=m[1], threads=int(m[2]), mma_per_clk_sm=float(m[3]),
                 tflops=float(m[4]), us=float(m[5]))
            for m in re.findall(r"\[(\w+)\] (\S+(?: \d+)?) threads (\d+): ([\d.]+) mma/clk/SM, "
                                r"([\d.]+) TFLOP/s tf32, ([\d.]+) us", text)]
    card = card_line()
    print(card, flush=True)
    res = dict(card=card, rows=rows)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
