// fp32 products on the tensor cores in 3xTF32 (K7 res_block_2d.cu, K7b res_block_2d_bwd.cu).
//
// An fp32 operand v splits in registers into hi = tf32(v) and lo = tf32(v - hi), each rounded
// to nearest (ties away), the rounding of cvt.rna.tf32.f32; hi + lo carries about 21 of v's 24
// significant bits. A product of
// two such pairs is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b into one fp32 accumulator,
// small terms first; lo_a*lo_b (about 2^-22 of the product) is dropped. At K7b's shapes this
// keeps the plain fp32 product's accuracy (tests/test_torch_res2d_saved.py emulates it), at
// three tensor-core products instead of one fp32 FMA a multiply-add.
//
// mma.sync.m16n8k8 with tf32 operands: lane l of a warp holds, with g = l / 4 and t = l % 4,
//   a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4]  (16 x 8)
//   b[0] = B[t][g], b[1] = B[t + 4][g]                                             (8 x 8)
//   c[0] = C[g][2t], c[1] = C[g][2t + 1], c[2] = C[g + 8][2t], c[3] = C[g + 8][2t + 1].
// The sum over k does not care which of a lane's k indices is which channel or pixel, as long
// as A and B agree, and the rows of A and C may be any one-to-one map of the output's rows: the
// callers choose both so that a lane's operands are pairs of neighbouring floats (one 8-byte
// shared load) and the loads of a warp are free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tf32x3 {

// tf32(v), rounded to nearest with ties away from zero, as a bit pattern: half a TF32 unit
// added to the magnitude's bits, the 13 bits below a TF32 mantissa cleared. For finite v this
// is cvt.rna.tf32.f32's result; on sm_90 that instruction compiles to a test for infinity
// and predicated arithmetic: K7b's inner loop runs 0.437 m16n8k8 products a clock an SM with
// the integer ops against 0.346 with it (tf32_peak.py, PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v -> (hi, lo) as tf32 bit patterns.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// c += a b on one 16 x 8 x 8 tile, fp32 accumulate.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b on one 16 x 8 x 8 tile: no accumulator is read.
__device__ __forceinline__ void mma_fresh(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %10, %10, %10};"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// One operand fragment of n registers, split.
template <int n>
struct Frag {
  uint32_t hi[n], lo[n];
  __device__ __forceinline__ void set(int i, float v) { split(v, hi[i], lo[i]); }
};

// A B fragment's pair (b[0], b[1]) split ahead of its use, as one 16-byte word (hi[0], hi[1],
// lo[0], lo[1]): K7 stages its tap slices so, each value split once a block, and a lane reads
// its fragment with one 16-byte load.
__device__ __forceinline__ uint4 split_pair(float b0, float b1) {
  uint4 v;
  split(b0, v.x, v.z);
  split(b1, v.y, v.w);
  return v;
}

__device__ __forceinline__ Frag<2> frag(const uint4& v) {
  Frag<2> f;
  f.hi[0] = v.x;
  f.hi[1] = v.y;
  f.lo[0] = v.z;
  f.lo[1] = v.w;
  return f;
}

// c[m][n] += a[m] b[n] (kFresh: c[m][n] = a[m] b[n]) for every tile of a warp's M x N tiles in
// 3xTF32: the two small terms, then the large one, each over all tiles in turn, so that
// neighbouring mma's write different accumulators and none waits on the one before.
template <bool kFresh = false, int M, int N>
__device__ __forceinline__ void mma3(float (&c)[M][N][4], const Frag<4> (&a)[M],
                                     const Frag<2> (&b)[N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      if (kFresh)
        mma_fresh(c[m][n], a[m].lo, b[n].hi);
      else
        mma(c[m][n], a[m].lo, b[n].hi);
    }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[m][n], a[m].hi, b[n].lo);
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) mma(c[m][n], a[m].hi, b[n].hi);
}

// c += v, tile by tile, in fp32: a partial sum of mma3's added to its accumulator.
template <int M, int N>
__device__ __forceinline__ void add(float (&c)[M][N][4], const float (&v)[M][N][4]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[m][n][i] += v[m][n][i];
}

}  // namespace tf32x3
