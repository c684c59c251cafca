// Device code of K7 res_block_2d (res_block_2d.cu), part of it shared with
// its backward K7b (res_block_2d_bwd.cu): the 3x3 reflect-pad-1 conv of an
// 8x8x64 field with the taps streamed through shared memory one (dh, dw)
// slice at a time, the InstanceNorm statistics and the AdaIN / ReLU
// epilogue. K7b takes the statistics of the conv outputs K7 saved, and y1
// from them, with these same functions (channel_stats, norm_relu), so its
// ReLU mask is the forward's bit for bit.
//
// Layout: x (B, 8, 8, 64) channels-last, taps (3, 3, C_in, C_out). In
// shared memory a sample's field is 64 pixel rows of kPS floats (64
// channels and 4 of padding, so the four pixels that four neighbouring
// thread groups read lie in four different bank groups); K7b's rows are
// wider (its Ld template argument).
#pragma once

#include <cuda_runtime.h>

namespace res2d {

constexpr int kH = 8, kW = 8, kPix = kH * kW, kC = 64;
constexpr int kPS = kC + 4;           // floats between two pixels of a field in shared memory
constexpr int kField = kPix * kPS;    // one sample's field in shared memory
constexpr int kWS = kC + 4;           // floats between two rows of the tap tile
constexpr int kTile = kC * kWS;       // one (dh, dw) slice of the taps in shared memory
constexpr int kTapFloats = kC * kC;   // one (dh, dw) slice of the taps in device memory
constexpr int kTaps = 9;
constexpr int kSamples = 2;           // samples a block owns
constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSamples * kC * 2 == kThreads, "two lanes per (sample, channel) statistic");
static_assert(kSamples * (kPix / 4) * (kC / 8) == kThreads, "one 4x8 tile per thread");

// The row (or column) that virtual index u in [-1, 8] reads under reflect pad 1.
__device__ __forceinline__ int reflect8(int u) { return u < 0 ? -u : (u >= kH ? 2 * kH - 2 - u : u); }

// A thread's share of a conv output: sample s, the four pixels (h0 + p, w),
// p = 0..3, and the eight channels n0..n0+3, n0+32..n0+35. Within a warp
// the eight channel groups of one pixel column are neighbouring lanes.
struct Tile {
  int s, h0, w, n0;
};

__device__ __forceinline__ Tile my_tile() {
  const int t = threadIdx.x, pg = (t >> 3) & 15;
  return Tile{t >> 7, (pg >> 3) * 4, pg & 7, (t & 7) * 4};
}

__device__ __forceinline__ int tile_pixel(const Tile& t, int p) { return (t.h0 + p) * kW + t.w; }

// One (dh, dw) slice of the taps (C_in, C_out) into the shared tile W[ci][co].
__device__ void load_tap_tile(float* W, const float* __restrict__ k) {
  for (int i = threadIdx.x; i < kTapFloats / 4; i += blockDim.x) {
    const int r = i >> 4, c = (i & 15) * 4;
    *reinterpret_cast<float4*>(W + r * kWS + c) = __ldg(reinterpret_cast<const float4*>(k) + i);
  }
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// acc[p][j] += sum_k in[src[p]][k] * W[k][n], n = n0 + j (j < 4) or n0 + 28 + j:
// a 4-pixel x 8-channel register tile over one 64-deep slice. Each float4
// of the input serves 32 multiply-adds, each float4 of the tile 16.
__device__ __forceinline__ void tile_mac(const float* in, const int (&src)[4], const float* W,
                                         int n0, float (&acc)[4][8]) {
#pragma unroll 2
  for (int k = 0; k < kC; k += 4) {
    float4 xv[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) xv[p] = *reinterpret_cast<const float4*>(in + src[p] * kPS + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w0 = *reinterpret_cast<const float4*>(W + (k + kk) * kWS + n0);
      const float4 w1 = *reinterpret_cast<const float4*>(W + (k + kk) * kWS + n0 + 32);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float a = lane4(xv[p], kk);
        acc[p][0] = fmaf(a, w0.x, acc[p][0]);
        acc[p][1] = fmaf(a, w0.y, acc[p][1]);
        acc[p][2] = fmaf(a, w0.z, acc[p][2]);
        acc[p][3] = fmaf(a, w0.w, acc[p][3]);
        acc[p][4] = fmaf(a, w1.x, acc[p][4]);
        acc[p][5] = fmaf(a, w1.y, acc[p][5]);
        acc[p][6] = fmaf(a, w1.z, acc[p][6]);
        acc[p][7] = fmaf(a, w1.w, acc[p][7]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;
}

// acc = the thread's tile of conv3x3(field, k), reflect pad 1 on both axes,
// no bias; ``field`` is the thread's sample in shared memory, k the
// (3, 3, C, C) taps in device memory, W the shared tap tile. Every thread
// of the block calls it (it synchronises around each tap slice).
__device__ void conv3x3(const float* field, const float* __restrict__ k, float* W, const Tile& t,
                        float (&acc)[4][8]) {
  zero(acc);
  for (int tap = 0; tap < kTaps; ++tap) {
    __syncthreads();  // the previous slice is no longer read; the field is written
    load_tap_tile(W, k + tap * kTapFloats);
    __syncthreads();
    const int dh = tap / 3, dw = tap % 3;
    const int sw = reflect8(t.w + dw - 1);
    int src[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) src[p] = reflect8(t.h0 + p + dh - 1) * kW + sw;
    tile_mac(field, src, W, t.n0, acc);
  }
}

// The thread's tile into its sample's field ``out``.
__device__ __forceinline__ void store_tile(float* out, const Tile& t, const float (&acc)[4][8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float* o = out + tile_pixel(t, p) * kPS + t.n0;
    *reinterpret_cast<float4*>(o) = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
  }
}

// mean and 1/sqrt(var + eps) of each (sample, channel) of the block's
// fields (kSamples of them, pixel rows of Ld floats) over the 64 pixels,
// two-pass, biased: two lanes a pair. Indexed s * kC + c. Every thread
// calls it.
template <int Ld = kPS>
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
template <int Ld = kPS>
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

// The first ns samples of x (B, 8, 8, C) from the block's first sample
// into shared fields.
__device__ void load_fields(const float* __restrict__ x, float* fields, int ns) {
  for_each4(ns, [&](int s, int pix, int c) {
    *reinterpret_cast<float4*>(fields + s * kField + pix * kPS + c) =
        __ldg(reinterpret_cast<const float4*>(x + (s * kPix + pix) * kC + c));
  });
}

}  // namespace res2d
