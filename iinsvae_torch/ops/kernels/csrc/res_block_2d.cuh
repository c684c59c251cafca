// Device code shared by K7 res_block_2d (res_block_2d.cu) and its backward
// K7b (res_block_2d_bwd.cu): the tile's fields in shared memory and their
// cp.async staging, the InstanceNorm statistics and the AdaIN / ReLU
// epilogue. K7b takes the statistics of the conv outputs K7 saved, and y1
// from them, with these same functions (channel_stats, norm_relu), so its
// ReLU mask is the forward's bit for bit.
//
// Layout: x (B, 8, 8, 64) channels-last, taps (3, 3, C_in, C_out). In
// shared memory a sample's field is 64 pixel rows of kLd floats (64
// channels and 8 of padding: the 8-byte fragment loads of the tensor-core
// products, a lane's neighbouring pair of channels in each of four
// neighbouring rows, fall on distinct banks).
#pragma once

#include <cuda_runtime.h>

#include "async_smem.cuh"

namespace res2d {

constexpr int kH = 8, kW = 8, kPix = kH * kW, kC = 64;
constexpr int kLd = kC + 8;                // floats between two pixel rows of a field
constexpr int kField = kPix * kLd;         // one sample's field in shared memory
constexpr int kSamples = 2;                // samples a tile holds
constexpr int kPair = kSamples * kField;   // a tile's field
constexpr int kTapFloats = kC * kC;        // one (dh, dw) slice of the taps in device memory
constexpr int kTaps = 9;
constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSamples * kC * 2 == kThreads, "two lanes per (sample, channel) statistic");

// The row (or column) that virtual index u in [-1, 8] reads under reflect pad 1.
__device__ __forceinline__ int reflect8(int u) { return u < 0 ? -u : (u >= kH ? 2 * kH - 2 - u : u); }

// Every thread: its 16-byte cp.async copies of n rows of kC floats from src (consecutive in
// device memory) into dst rows of Ld floats.
template <int Ld = kLd>
__device__ void copy_rows(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n * (kC / 4); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    cp_async16(dst + r * Ld + c, src + r * kC + c, true);
  }
}

// The block's copies in flight as cp.async groups, numbered in commit order; every thread
// commits the same groups. wait(g) returns once this thread's copies of group g (and of every
// group before it) have landed; a __syncthreads then makes every thread's visible.
struct Groups {
  int committed = 0;

  __device__ int commit() {
    cp_async_commit();
    return committed++;
  }

  __device__ void wait(int g) const {
    switch (min(committed - 1 - g, 4)) {  // groups after g that may stay in flight
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      case 3: cp_async_wait<3>(); break;
      default: cp_async_wait<4>(); break;
    }
  }
};

// mean and 1/sqrt(var + eps) of each (sample, channel) of the block's
// fields (kSamples of them, pixel rows of Ld floats) over the 64 pixels,
// two-pass, biased: two lanes a pair. Indexed s * kC + c. Every thread
// calls it.
template <int Ld>
__device__ void channel_stats(const float* fields, float* mean, float* rstd) {
  const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
  const float* f = fields + (pair / kC) * (kPix * Ld) + pair % kC;
  float sum = 0.f;
  for (int i = lane; i < kPix; i += 2) sum += f[i * Ld];
  sum += __shfl_xor_sync(kFull, sum, 1);
  const float m = sum * (1.f / kPix);
  float sq = 0.f;
  for (int i = lane; i < kPix; i += 2) {
    const float d = f[i * Ld] - m;
    sq = fmaf(d, d, sq);
  }
  sq += __shfl_xor_sync(kFull, sq, 1);
  if (lane == 0) {
    mean[pair] = m;
    rstd[pair] = rsqrtf(sq * (1.f / kPix) + kEps);
  }
}

// The normalised value of a conv output v of pair (s, c), with the AdaIN
// affine of the (B, C) tables g, b (offset to the block's first sample)
// where they are given.
__device__ __forceinline__ float norm_affine(float v, int pair, const float* mean,
                                             const float* rstd, const float* __restrict__ g,
                                             const float* __restrict__ b) {
  v = (v - mean[pair]) * rstd[pair];
  return g ? fmaf(v, __ldg(g + pair), __ldg(b + pair)) : v;
}

// Visit the first ns samples of the block's fields a float4 at a time:
// fn(s, pix, c) for channels c..c+3 of pixel pix of sample s.
template <typename Fn>
__device__ __forceinline__ void for_each4(int ns, Fn fn) {
  constexpr int per = kPix * kC / 4;
  for (int i = threadIdx.x; i < ns * per; i += blockDim.x) {
    const int s = i / per, r = i % per;
    fn(s, r >> 4, (r & 15) * 4);
  }
}

// out[s][pix][c] = relu(norm_affine(in[s][pix][c])) for the first ns samples
// (pixel rows of Ld floats).
template <int Ld>
__device__ void norm_relu(const float* in, float* out, int ns, const float* mean,
                          const float* rstd, const float* g, const float* b) {
  for_each4(ns, [&](int s, int pix, int c) {
    const int f = (s * kPix + pix) * Ld + c;
    const float4 v = *reinterpret_cast<const float4*>(in + f);
    const int q = s * kC + c;
    *reinterpret_cast<float4*>(out + f) = make_float4(
        fmaxf(norm_affine(v.x, q, mean, rstd, g, b), 0.f),
        fmaxf(norm_affine(v.y, q + 1, mean, rstd, g, b), 0.f),
        fmaxf(norm_affine(v.z, q + 2, mean, rstd, g, b), 0.f),
        fmaxf(norm_affine(v.w, q + 3, mean, rstd, g, b), 0.f));
  });
}

// Two neighbouring floats of shared memory (8-byte aligned): a fragment pair.
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// The warp's share of a conv-shaped product on the tensor cores (K7's convs, K7b's input
// gradients): rows x_row0() + 16 mt (+ 8) of the tile's (sample, pixel) rows, columns
// x_col0() + 8 nt (+ 1), as the mma's C lays them out; warp w takes rows (w / 2) * 32 .. + 31
// and columns (w % 2) * 32 .. + 31 of the tile's 128 x 64.
__device__ __forceinline__ int x_row0() {
  return (threadIdx.x >> 6) * 32 + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int x_col0() {
  return ((threadIdx.x >> 5) & 1) * 32 + 2 * (threadIdx.x & 3);
}

}  // namespace res2d
