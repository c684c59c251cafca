// The residual block at the model's shape, (L, C) = (8, 64), both convs k3, stride 1, reflect
// pad 1: what K1's and K5's forward kernel (in_chain.cu) and their backward K1b/K5b
// (in_chain_bwd.cu) share, namespace res. Both stage x and run each conv and each
// InstanceNorm's statistics with these functions, so the backward's ReLU masks and IN
// statistics are the forward's bit for bit, and both are the general kernel's (in_chain.cu's
// conv_points and norm_stage): each conv output one fmaf chain from 0 over t, then ci
// ascending; the IN statistics two-pass on two lanes a row.
#pragma once

#include "async_smem.cuh"

namespace res {

constexpr int kL = 8, kC = 64;  // rows and channels a sample
constexpr int kH = kL + 2;      // staged rows a sample: row 1 above it, row L-2 below (reflect)
constexpr int kLd = kC + 4;     // floats a staged row: 16-byte rows, 8 rows on distinct banks
constexpr int kTaps = 3 * kC * kC;
constexpr int kWFloats = 3 * kC * kLd;  // one conv's taps (t, ci, co), a ci row kLd floats
constexpr float kInvL = 1.f / kL;
constexpr float kEps = 1e-5f;

// The row that tap t of output row l reads (reflect pad 1).
__host__ __device__ constexpr int reflect(int v) {
  return v < 0 ? -v : v >= kL ? 2 * kL - 2 - v : v;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// x of the samples s0 .. s0+ns-1 into xs with their halo rows (kTile samples of kH rows),
// cp.async by a block of kThreads; the rows of samples past the batch are zero (they then add
// exactly 0 to every sum).
template <int kTile, int kThreads>
__device__ void stage_halo(const float* __restrict__ x, int s0, int ns, float* xs) {
  constexpr int q = kC / 4;
  for (int i = threadIdx.x; i < kTile * kH * q; i += kThreads) {
    const int r = i / q, c = (i - r * q) * 4, j = r / kH;
    const bool ok = j < ns;
    const int u = reflect(r - j * kH - 1);
    cp_async16(xs + r * kLd + c, x + (static_cast<size_t>(s0 + (ok ? j : 0)) * kL + u) * kC + c,
               ok);
  }
}

// z (the tile's rows, kLd floats apart) = conv(a, w), a staged with its halo rows. Lane (l, q)
// of warp wp computes row l of the NS samples NS * (wp / 4) .. + NS-1 at channels 16 (wp % 4)
// + 4q .. +3: per step of 4 input channels NS + 4 float4 loads (each x row a broadcast to the
// warp's 4 channel groups, each taps row to its 8 rows) for 16 NS multiply-adds. Each output is
// one fmaf chain over t, then ci ascending, K1's conv_points order. kAhead: each step's
// operands are loaded into registers one step ahead of its products (the forward; the
// backward's recompute keeps its d(taps) in registers and loads in step). tap(t) runs before
// tap t's products, in every thread that calls this. w's (t, ci) rows are kWLd floats apart:
// kLd, or kC where the taps sit unpadded (a warp reads 64 contiguous bytes of one row).
template <int NS, bool kAhead, int kWLd = kLd, typename Tap>
__device__ __forceinline__ void conv_tile(const float* a, const float* w, float* z, Tap tap) {
  const int wp = threadIdx.x >> 5, ln = threadIdx.x & 31;
  const int l = ln >> 2, co = 16 * (wp & 3) + 4 * (ln & 3), sg = NS * (wp >> 2);
  const float* as = a + (sg * kH + l) * kLd;
  float acc[NS][4] = {};
  auto load = [&](int t, int ci, float4(&xv)[NS], float4(&wv)[4]) {
#pragma unroll
    for (int s = 0; s < NS; ++s) xv[s] = lds4(as + (s * kH + t) * kLd + ci);
#pragma unroll
    for (int j = 0; j < 4; ++j) wv[j] = lds4(w + (t * kC + ci + j) * kWLd + co);
  };
  auto products = [&](const float4(&xv)[NS], const float4(&wv)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float v = lane4(xv[s], j);
        acc[s][0] = fmaf(v, wv[j].x, acc[s][0]);
        acc[s][1] = fmaf(v, wv[j].y, acc[s][1]);
        acc[s][2] = fmaf(v, wv[j].z, acc[s][2]);
        acc[s][3] = fmaf(v, wv[j].w, acc[s][3]);
      }
  };
  if constexpr (kAhead) {
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      tap(t);
      float4 xv[NS], wv[4];
      load(t, 0, xv, wv);
#pragma unroll 4
      for (int ci = 0; ci < kC; ci += 4) {
        float4 xn[NS], wn[4];
        load(t, (ci + 4) & (kC - 1), xn, wn);  // the last step reloads step 0: unused
        products(xv, wv);
#pragma unroll
        for (int s = 0; s < NS; ++s) xv[s] = xn[s];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wn[j];
      }
    }
  } else {
#pragma unroll 1
    for (int t = 0; t < 3; ++t) {
      tap(t);
#pragma unroll 4
      for (int ci = 0; ci < kC; ci += 4) {
        float4 xv[NS], wv[4];
        load(t, ci, xv, wv);
        products(xv, wv);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    *reinterpret_cast<float4*>(z + ((sg + s) * kL + l) * kLd + co) =
        make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
}

// One (sample, channel) row of a norm, held by a thread pair (2p, 2p+1), as K1's norm_stage
// holds it at L = 8: the even lane the rows 0, 2, 4, 6, the odd lane the rest. yh the
// normalised values of the lane's rows.
struct RowNorm {
  float yh[kL / 2], rs;
};

// Statistics of the lane's (sample, channel) row of z with norm_stage's order of operations.
__device__ __forceinline__ RowNorm row_norm(const float* z) {
  float v[kL / 2], sum = 0.f;
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) {
    v[k] = z[2 * k * kLd];
    sum += v[k];
  }
  const float mean = (sum + __shfl_xor_sync(0xffffffffu, sum, 1)) * kInvL;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) {
    const float d = v[k] - mean;
    sq = fmaf(d, d, sq);
  }
  RowNorm n;
  n.rs = rsqrtf((sq + __shfl_xor_sync(0xffffffffu, sq, 1)) * kInvL + kEps);
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) n.yh[k] = (v[k] - mean) * n.rs;
  return n;
}

}  // namespace res
