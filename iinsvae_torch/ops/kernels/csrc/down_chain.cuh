// The range encoder's stride-2 chains at the flagship's shapes, every stage conv -> IN -> ReLU:
// what K1's forward kernel there (in_chain.cu, namespace down) and its backward K1b
// (in_chain_bwd.cu, namespace down) share: range.pair0 ((128, 1) k7 reflect 3 -> (128, 4), k4
// s2 zero 1 -> (64, 8)), range.pair1 ((64, 8) -> (32, 16) -> (16, 32), both k4 s2 zero 1) and
// range.single ((16, 32) -> (8, 64)). Both stage x and the taps, and run each conv and each
// InstanceNorm + ReLU, with these functions, so the backward's ReLU masks and IN statistics are
// the forward's bit for bit, and both are the general kernel's (in_chain.cu's conv_points and
// norm_stage): each conv output one fmaf chain from 0 over t, then ci ascending; the IN
// statistics two-pass on norm_lanes(L) lanes a row. K1b's general kernel takes the IN
// statistics helpers from here too.
#pragma once

#include <cuda_runtime.h>

#include "async_smem.cuh"

namespace down {

constexpr float kEps = 1e-5f;

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Lanes that share one (sample, channel) row of length l (in_chain.cu's rule).
__device__ __forceinline__ int norm_lanes(int l) {
  int g = 1;
  while (g < 32 && g * 4 < l) g *= 2;
  return g;
}

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The (sample, channel) rows of the block, `lanes` threads each, in rounds
// that every lane runs the same number of times (the shuffles need full
// warps). fn(p, s, ch, valid, lane, lanes).
template <typename Fn>
__device__ void for_rows(int l, int c, int ns, Fn fn) {
  const int lanes = norm_lanes(l), lane = threadIdx.x % lanes;
  const int slots = blockDim.x / lanes, pairs = ns * c;
  for (int base = 0; base < pairs; base += slots) {
    const int p = base + static_cast<int>(threadIdx.x) / lanes;
    const bool valid = p < pairs;
    fn(p, valid ? p / c : 0, valid ? p % c : 0, valid, lane, lanes);
  }
}

// mean and 1/sqrt(var + eps) of one (sample, channel) row, two-pass.
__device__ __forceinline__ void row_stats(const float* zs, int l, int c, bool valid, int lane,
                                          int lanes, float& mean, float& rs) {
  const float inv_l = 1.f / static_cast<float>(l);
  float sum = 0.f;
  if (valid)
    for (int i = lane; i < l; i += lanes) sum += zs[i * c];
  mean = group_sum(sum, lanes) * inv_l;
  float sq = 0.f;
  if (valid)
    for (int i = lane; i < l; i += lanes) {
      const float d = zs[i * c] - mean;
      sq = fmaf(d, d, sq);
    }
  rs = rsqrtf(group_sum(sq, lanes) * inv_l + kEps);
}

constexpr int kS = 4;  // samples a tile
constexpr int kThreads = 256;
constexpr int kMaxReps = 32;  // threads that share one d(taps) cell, each over its own rows

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// One stage (k taps, stride, pad, reflect; (l_in, c_in) -> (l_out, c_out)) and its shared
// memory: the input staged with its pad rows (rows c_in + 4 floats, so a warp's reads of rows
// a stride apart fall on distinct banks), the conv output between two zero rows, the taps in
// rows of c_out + 4 floats and, for dx, transposed in rows of c_in + 4.
template <int K_, int S_, int P_, bool R_, int LI_, int CI_, int CO_>
struct Stage {
  static constexpr int K = K_, S = S_, P = P_, LI = LI_, CI = CI_, CO = CO_;
  static constexpr bool R = R_;
  static constexpr int LO = (LI + 2 * P - K) / S + 1;
  static constexpr int LdI = CI % 4 ? CI : CI + 4, XS = (LI + 2 * P) * LdI;
  static constexpr int LdZ = CO + 4, ZS = (LO + 2) * LdZ;
  static constexpr int LdW = CO + 4, WFloats = K * CI * LdW;
  static constexpr int LdT = CI + 4, TFloats = K * CO * LdT;
  static constexpr int NTaps = K * CI * CO;
  // d(taps) in registers: cells of (ci, 4 output channels), Cpt cells a thread, or Reps
  // threads a cell, each summing every Reps-th (sample, row) of the tile
  static constexpr int Cells = CI * CO / 4;
  static constexpr int Cpt = Cells > kThreads ? Cells / kThreads : 1;
  static constexpr int Reps =
      Cells >= kThreads ? 1 : cmin(cmin(kThreads / Cells, kMaxReps), kS * LO);
  static constexpr int Active = Reps * cmin(Cells, kThreads);
  static_assert(CO % 4 == 0 && (Cells <= kThreads || Cells % kThreads == 0) &&
                    (Cpt == 1 || kThreads % CI == 0),
                "d(taps) cells");
};

// A chain of one or two stages (S2 unused with one), site kId of iins_down_chain and
// iins_down_chain_bwd, and K1b's shared memory (K1's forward lays out its own, in_chain.cu):
// taps, transposed taps, x, z1, y1 (stage 2's input), z2 and gy1 (the gradient of y1), each
// region a multiple of 4 floats.
template <int kId_, class S1_, class S2_, bool kTwo_>
struct Chain {
  using S1 = S1_;
  using S2 = S2_;
  static constexpr int kId = kId_;
  static constexpr bool kTwo = kTwo_, kDx = !S1::R;  // a reflect first stage reads the CIR
  static constexpr int kGyLd = S2::CI + 4, kGyS = S2::LI * kGyLd;
  static constexpr int kW1t = S1::WFloats;
  static constexpr int kW2s = kW1t + (kDx ? S1::TFloats : 0);
  static constexpr int kW2t = kW2s + (kTwo ? S2::WFloats : 0);
  static constexpr int kXs = kW2t + (kTwo ? S2::TFloats : 0);
  static constexpr int kZ1 = kXs + kS * S1::XS;
  static constexpr int kY1 = kZ1 + kS * S1::ZS;
  static constexpr int kZ2 = kY1 + (kTwo ? kS * S2::XS : 0);
  static constexpr int kGy = kZ2 + (kTwo ? kS * S2::ZS : 0);
  static constexpr int kFloats = kGy + (kTwo ? kS * kGyS : 0);
  static constexpr int kSmemBytes = kFloats * static_cast<int>(sizeof(float));
  static constexpr int kNTaps = S1::NTaps + (kTwo ? S2::NTaps : 0);
  static constexpr int kGS = kTwo ? S2::LO * S2::CO : S1::LO * S1::CO;  // g floats a sample
  static constexpr int kConv = (S1::LO * S1::CO / 4 + 31) / 32 * 32;  // threads of (1)
  static_assert(kW1t % 4 == 0 && kW2s % 4 == 0 && kW2t % 4 == 0 && kXs % 4 == 0 &&
                    kZ1 % 4 == 0 && kY1 % 4 == 0 && kZ2 % 4 == 0 && kGy % 4 == 0,
                "16-byte regions");
  static_assert(S1::Reps * S1::NTaps + (kTwo ? S2::Reps * S2::NTaps : 0) <= kFloats,
                "the d(taps) sums fit where the tile was");
  static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
  static_assert(!kTwo || (S2::LI == S1::LO && S2::CI == S1::CO && !S2::R), "a chain");
  static_assert(kConv <= kThreads - 64, "threads left to transpose the taps during (1)");
};

using Pair0 = Chain<0, Stage<7, 1, 3, true, 128, 1, 4>, Stage<4, 2, 1, false, 128, 4, 8>, true>;
using Pair1 = Chain<1, Stage<4, 2, 1, false, 64, 8, 16>, Stage<4, 2, 1, false, 32, 16, 32>, true>;
using Single = Chain<2, Stage<4, 2, 1, false, 16, 32, 64>, Stage<4, 2, 1, false, 16, 32, 64>,
                     false>;

// The tile's samples s0 .. s0+ns-1 (NS a tile) into xs with each sample's pad rows: reflected
// rows, or zero rows; the samples past the batch are zero. cp.async where rows are whole
// float4s.
template <class T, int NS = kS>
__device__ void stage_input(const float* __restrict__ x, int s0, int ns, float* xs) {
  constexpr int kH = T::LI + 2 * T::P, kQ = T::CI % 4 ? T::CI : T::CI / 4;
  for (int i = threadIdx.x; i < NS * kH * kQ; i += kThreads) {
    const int r = i / kQ, c = (i - r * kQ) * (T::CI % 4 ? 1 : 4), s = r / kH, v = r - s * kH;
    int u = v - T::P;
    bool ok = s < ns;
    if (T::R)
      u = u < 0 ? -u : u >= T::LI ? 2 * T::LI - 2 - u : u;
    else
      ok = ok && u >= 0 && u < T::LI;
    const float* src =
        x + (static_cast<size_t>(s0 + (ok ? s : 0)) * T::LI + (ok ? u : 0)) * T::CI + c;
    float* dst = xs + s * T::XS + v * T::LdI + c;
    if constexpr (T::CI % 4 == 0)
      cp_async16(dst, src, ok);
    else
      *dst = ok ? __ldg(src) : 0.f;
  }
}

// One stage's taps (K, C_in, C_out) into ws by cp.async.
template <class T>
__device__ void stage_taps(const float* __restrict__ w, float* ws) {
  constexpr int kQ = T::CO / 4;
  for (int i = threadIdx.x; i < T::K * T::CI * kQ; i += kThreads) {
    const int r = i / kQ, c = (i - r * kQ) * 4;  // r = t * C_in + ci
    cp_async16(ws + r * T::LdW + c, w + r * T::CO + c, true);
  }
}

// z (rows 1..L_out of each sample's conv output) = conv(a), a staged with its pad rows. Thread
// (l, 4 output channels) computes them for the NS samples of a tile (per step of 4 input
// channels NS + 4 float4 loads for 16 NS multiply-adds). Each output is one fmaf chain over t,
// then ci ascending, K1's conv_points order: a tap on a zero pad row adds fmaf(0, w, acc) =
// acc, which K1 skips, so z is K1's bit for bit.
template <class T, int NS = kS>
__device__ void conv_fwd(const float* a, const float* ws, float* z) {
  constexpr int kQ = T::CO / 4;
  for (int it = threadIdx.x; it < T::LO * kQ; it += kThreads) {
    const int l = it / kQ, co = (it - l * kQ) * 4;
    float acc[NS][4];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
#pragma unroll
    for (int t = 0; t < T::K; ++t) {
      const float* ar = a + (l * T::S + t) * T::LdI;
      const float* wt = ws + t * T::CI * T::LdW + co;
      if constexpr (T::CI % 4 == 0) {
#pragma unroll 4
        for (int ci = 0; ci < T::CI; ci += 4) {
          float4 xv[NS], wv[4];
#pragma unroll
          for (int s = 0; s < NS; ++s) xv[s] = lds4(ar + s * T::XS + ci);
#pragma unroll
          for (int j = 0; j < 4; ++j) wv[j] = lds4(wt + (ci + j) * T::LdW);
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
        }
      } else {
#pragma unroll
        for (int ci = 0; ci < T::CI; ++ci) {
          const float4 wv = lds4(wt + ci * T::LdW);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float v = ar[s * T::XS + ci];
            acc[s][0] = fmaf(v, wv.x, acc[s][0]);
            acc[s][1] = fmaf(v, wv.y, acc[s][1]);
            acc[s][2] = fmaf(v, wv.z, acc[s][2]);
            acc[s][3] = fmaf(v, wv.w, acc[s][3]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s)
      *reinterpret_cast<float4*>(z + s * T::ZS + (1 + l) * T::LdZ + co) =
          make_float4(acc[s][0], acc[s][1], acc[s][2], acc[s][3]);
  }
}

// y1 (stage B's input rows, after its zero pad rows) = relu(IN(z1)), with K1's norm_stage rows,
// lanes and arithmetic, so y1 is the forward's mid-chain activation bit for bit.
template <class A, class B>
__device__ void norm_relu(const float* z, float* y, int ns) {
  for_rows(A::LO, A::CO, ns, [&](int, int s, int ch, bool valid, int lane, int lanes) {
    const float* zs = z + s * A::ZS + A::LdZ + ch;
    float mean, rs;
    row_stats(zs, A::LO, A::LdZ, valid, lane, lanes, mean, rs);
    if (!valid) return;
    float* ys = y + s * B::XS + B::P * B::LdI + ch;
    for (int i = lane; i < A::LO; i += lanes)
      ys[i * B::LdI] = fmaxf((zs[i * A::LdZ] - mean) * rs, 0.f);
  });
}

}  // namespace down
