// Device code shared by K7's bfloat16 instance (res_block_2d_bf16.cu) and its backward
// (res_block_2d_bf16_bwd.cu): the bfloat16 mma.sync m16n8k16 (fp32 accumulators), operand
// loads, and the staging of a conv's twelve tap slices into shared memory.
//
// mma.sync.m16n8k16 with bfloat16 operands: lane l of a warp holds, with g = l / 4 and
// t = l % 4, A (16 x 16, row): a[0] = A[g][2t, 2t + 1], a[1] = A[g + 8][2t, 2t + 1],
// a[2] = A[g][2t + 8, 2t + 9], a[3] = A[g + 8][2t + 8, 2t + 9]; B (16 x 8, col):
// b[0] = B[2t, 2t + 1][g], b[1] = B[2t + 8, 2t + 9][g]; C (16 x 8): c[0], c[1] = C[g][2t, 2t + 1],
// c[2], c[3] = C[g + 8][2t, 2t + 1]; a register holds its pair's first element in its low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "res_block_2d.cuh"

namespace res2d_bf16 {

using bf16 = __nv_bfloat16;
using res2d::kC;
using res2d::kLd;  // bfloat16 (here) between two rows of a field or a staged slice
using res2d::kTaps;
using res2d::kThreads;

constexpr int kSlices = kTaps + 3;  // nine taps and three edge slices
constexpr int kSlice = kC * kLd;    // bfloat16 of one staged slice

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c = a b (kFresh) or c += a b on one 16 x 8 x 16 tile, bfloat16 operands, fp32 accumulate.
template <bool kFresh>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  if (kFresh) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// The conv's twelve slices into shared memory, (C_in, C_out) rows of kLd as the taps k
// (3, 3, C_in, C_out) store them: the nine taps copied 16 bytes at a time, then the edge slices
// bf16(k[dh][0] + k[dh][2]), summed in fp32 eight at a time: at the edge columns 0 and 7 the W
// taps 0 and 2 read one column, and the Pallas kernel's lane-mix matrices (assemble_w3,
// res2d.py:69, assembled in bfloat16) hold that column's weight as this one rounded sum. Every
// thread calls it; the caller's __syncthreads follows.
__device__ inline void stage_slices(const bf16* __restrict__ k, bf16* taps) {
  constexpr int kChunks = kC / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kSlices * kC * kChunks; i += kThreads) {
    const int row = i / kChunks, c = (i % kChunks) * 8, t = row / kC, ci = row % kC;
    uint4 v;
    if (t < kTaps) {
      v = *reinterpret_cast<const uint4*>(k + row * kC + c);
    } else {
      const int dh = t - kTaps;
      const uint4 a = *reinterpret_cast<const uint4*>(k + ((dh * 3) * kC + ci) * kC + c);
      const uint4 b = *reinterpret_cast<const uint4*>(k + ((dh * 3 + 2) * kC + ci) * kC + c);
      const bf16* pa = reinterpret_cast<const bf16*>(&a);
      const bf16* pb = reinterpret_cast<const bf16*>(&b);
      bf16* pv = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pv[j] = __float2bfloat16_rn(__bfloat162float(pa[j]) + __bfloat162float(pb[j]));
    }
    *reinterpret_cast<uint4*>(taps + t * kSlice + ci * kLd + c) = v;
  }
}

}  // namespace res2d_bf16
