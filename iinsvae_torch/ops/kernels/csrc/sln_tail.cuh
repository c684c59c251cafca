// The decoder tail's path at input (8, 64): four up-stages to (128, 4), the k7 reflect conv,
// tanh and any pool length, the only shape Decoder1d gives K6. Its forward is shared by K6's
// tail kernel (sln_chain.cu), which writes y, and K6b's (sln_chain_bwd.cu), which recomputes
// it before the backward: both compute K6's general kernel's output bit for bit, so K6b's ReLU
// masks and LayerNorm statistics are those of the forward that ran.
//
// One persistent block of kThreads a SM walks tiles of kS whole samples. All four stages' taps
// and the out conv's sit in shared memory, staged once a block with cp.async (stage_block),
// stages 1-3's landing behind stage 0; each stage's input and conv output keep zero rows past
// their edges, so every tap reads data and no product is masked.
#pragma once

#include "async_smem.cuh"
#include "sln_stage.cuh"

namespace tail {

using iins::kLnEps;
using iins::kUpK;
using iins::warp_sum;

constexpr int kS = 4;            // samples a tile
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;
constexpr int kL0 = 8, kC0 = 64;  // the input (L, C); stage j: (8 << j, 64 >> j) -> x2 rows, C / 2
constexpr int kN = kL0 * kC0;     // floats a sample at every stage
constexpr int kLast = kL0 << kStages;  // the out conv's rows (128, 4 channels)
constexpr int kKOut = 7, kPadOut = 3;

// Shared memory, in floats. Stage j's input act[j] keeps a zero row above and below each sample
// (rows of C + 4 floats: a warp's reads of its rows spread over the banks); its conv output z[j]
// (then its gradient gz) two zero rows above and below (rows of D = C / 2 floats, contiguous
// inside); act[4], the out conv's input, 128 rows of 4. Every sample's block is 4 floats longer
// than its rows, so that the tile's samples start on different banks.
__host__ __device__ constexpr int rows_in(int j) { return kL0 << j; }
__host__ __device__ constexpr int chans(int j) { return kC0 >> j; }
__host__ __device__ constexpr int act_stride(int j) {
  return j < kStages ? chans(j) + 4 : chans(j);
}
__host__ __device__ constexpr int act_floats(int j) {
  return (j < kStages ? rows_in(j) + 2 : rows_in(j)) * act_stride(j) + 4;
}
__host__ __device__ constexpr int z_floats(int j) {
  return (2 * rows_in(j) + 4) * (chans(j) / 2) + 4;
}
// the taps (t, ci, co) of stage j in rows of D + 4 floats (D >= 8; 4 at D = 4), so that the
// input gradient's lanes, one input channel each, read distinct banks
__host__ __device__ constexpr int tap_stride(int j) {
  return chans(j) / 2 >= 8 ? chans(j) / 2 + 4 : chans(j) / 2;
}
__host__ __device__ constexpr int tap_off(int j) {
  return j == 0 ? 0 : tap_off(j - 1) + kUpK * chans(j - 1) * tap_stride(j - 1);
}
constexpr int kTapOut = tap_off(kStages);  // the out conv's 28 taps (32 floats kept)
__host__ __device__ constexpr int act_off(int j) {
  return j == 0 ? kTapOut + 32 : act_off(j - 1) + kS * act_floats(j - 1);
}
__host__ __device__ constexpr int z_off(int j) {
  return j == 0 ? act_off(kStages + 1) : z_off(j - 1) + kS * z_floats(j - 1);
}
// (stage, sample): mean, std, 1 / (std + eps); the forward's shared memory ends after them
constexpr int kStats = z_off(kStages);
constexpr int kFwdFloats = kStats + kStages * kS * 4;
// threads of the recompute: 2 samples x 2 rows x 4 channels a thread
constexpr int kUpThreads = kS / 2 * kN / 8;
static_assert(kS * kLast == kThreads && kUpThreads <= kThreads, "thread layouts");

struct Args {
  const float* w[kStages];
  const float* bias[kStages];
  const float* gamma[kStages];
  const float* beta[kStages];
  const float* w_out;
  const float* b_out;
  int l_pool;
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ int reflect_out(int u) {
  return u < 0 ? -u : (u >= kLast ? 2 * kLast - 2 - u : u);
}

// The zero rows of act[j] (above and below each sample) and of z[j] (two above, two below):
// the rows that the tile's phases read but never write.
template <int J>
__device__ void zero_rows(float* sm) {
  constexpr int L = rows_in(J), P = act_stride(J), D = chans(J) / 2;
  for (int i = threadIdx.x; i < kS * 2 * P; i += kThreads) {
    const int s = i / (2 * P), r = i - s * 2 * P;  // r < P: row 0, else row L + 1
    sm[act_off(J) + s * act_floats(J) + (r < P ? r : L * P + r)] = 0.f;
  }
  for (int i = threadIdx.x; i < kS * 4 * D; i += kThreads) {
    const int s = i / (4 * D), r = i - s * 4 * D;  // rows 0, 1 and 2L + 2, 2L + 3
    sm[z_off(J) + s * z_floats(J) + (r < 2 * D ? r : 2 * L * D + r)] = 0.f;
  }
}

// Stage j's taps (5, C, D) into rows of tap_stride(j) floats, cp.async.
template <int J>
__device__ void stage_taps(const float* __restrict__ w, float* sm) {
  constexpr int C = chans(J), D = C / 2, q = D / 4, TS = tap_stride(J);
  float* dst = sm + tap_off(J);
  for (int i = threadIdx.x; i < kUpK * C * q; i += kThreads) {
    const int r = i / q, c = (i - r * q) * 4;  // r = t * C + ci
    cp_async16(dst + r * TS + c, w + r * D + c, true);
  }
}

// The tile's samples s0 .. s0 + ns - 1 of x into act[0]'s inner rows, cp.async; the rows of
// samples past the batch are zero.
__device__ void stage_x(const float* __restrict__ x, int s0, int ns, float* sm) {
  constexpr int q = kC0 / 4, P = act_stride(0);
  float* a0 = sm + act_off(0);
  for (int i = threadIdx.x; i < kS * kL0 * q; i += kThreads) {
    const int r = i / q, c = (i - r * q) * 4, s = r / kL0, l = r - s * kL0;
    const bool ok = s < ns;
    cp_async16(a0 + s * act_floats(0) + (l + 1) * P + c,
               x + (static_cast<size_t>(s0 + (ok ? s : 0)) * kL0 + l) * kC0 + c, ok);
  }
}

// z[j] = conv(upsample(act[j])) + bias, threads 0 .. kUpThreads - 1: (sample pair, row pair 2m,
// 2m + 1, 4 channels). Output row l's tap t reads input row (l + t - 2) >> 1, staged row (l + t)
// >> 1, so the pair's rows read the same input row at even t and neighbouring rows at odd t.
// Each output is one fmaf chain over t, then ci ascending, as sln_stage.cuh's up_conv_stage sums
// it (a tap that reads a zero row adds fmaf(0, w, acc) = acc, exactly K6's skipped tap), so z is
// K6's bit for bit.
template <int J>
__device__ void up_conv(float* sm, const float* __restrict__ bias) {
  constexpr int L = rows_in(J), C = chans(J), D = C / 2, G = D / 4, P = act_stride(J);
  constexpr int TS = tap_stride(J), AF = act_floats(J), ZF = z_floats(J);
  const int sp = threadIdx.x / (L * G), rem = threadIdx.x - sp * (L * G);
  const int m = rem / G, co = (rem - m * G) * 4;
  const float* as = sm + act_off(J) + 2 * sp * AF;
  float acc[2][2][4] = {};  // [sample][row 2m, 2m + 1][channel]
#pragma unroll
  for (int t = 0; t < kUpK; ++t) {
    const float* xe = as + (m + t / 2) * P;        // staged row of output 2m's tap t
    const float* xo = as + (m + (t + 1) / 2) * P;  // and of output 2m + 1's
    const float* wt = sm + tap_off(J) + t * C * TS + co;
#pragma unroll 2
    for (int ci = 0; ci < C; ci += 4) {
      float4 ve[2], vo[2], wv[4];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        ve[s] = lds4(xe + s * AF + ci);
        vo[s] = t % 2 ? lds4(xo + s * AF + ci) : ve[s];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) wv[k] = lds4(wt + (ci + k) * TS);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float v = lane4(r ? vo[s] : ve[s], k);
            acc[s][r][0] = fmaf(v, wv[k].x, acc[s][r][0]);
            acc[s][r][1] = fmaf(v, wv[k].y, acc[s][r][1]);
            acc[s][r][2] = fmaf(v, wv[k].z, acc[s][r][2]);
            acc[s][r][3] = fmaf(v, wv[k].w, acc[s][r][3]);
          }
    }
  }
  const float b0 = __ldg(bias + co), b1 = __ldg(bias + co + 1), b2 = __ldg(bias + co + 2),
              b3 = __ldg(bias + co + 3);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(sm + z_off(J) + (2 * sp + s) * ZF + (2 * m + r + 2) * D + co) =
          make_float4(acc[s][r][0] + b0, acc[s][r][1] + b1, acc[s][r][2] + b2,
                      acc[s][r][3] + b3);
}

// The LayerNorm statistics of z[j], warp s for sample s, with sln_relu's reduction (lane-strided
// two-pass sums, the xor butterfly), so mean, std and 1 / (std + eps) are K6's bit for bit.
template <int J>
__device__ void ln_stats(float* sm) {
  constexpr int D = chans(J) / 2;
  const int s = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* zs = sm + z_off(J) + s * z_floats(J) + 2 * D;
  const float inv_n = 1.f / static_cast<float>(kN), inv_n1 = 1.f / static_cast<float>(kN - 1);
  float sum = 0.f;
  for (int i = lane; i < kN; i += 32) sum += zs[i];
  const float mean = warp_sum(sum) * inv_n;
  float sq = 0.f;
  for (int i = lane; i < kN; i += 32) {
    const float d = zs[i] - mean;
    sq = fmaf(d, d, sq);
  }
  const float sd = sqrtf(warp_sum(sq) * inv_n1);
  if (lane == 0) {
    float* st = sm + kStats + (J * kS + s) * 4;
    st[0] = mean;
    st[1] = sd;
    st[2] = 1.f / (sd + kLnEps);
  }
}

// act[j + 1] = relu(LN(z[j]) * gamma + beta), sln_relu's expression; thread (sample s, r) takes
// the sample's values r, r + 128, r + 256, r + 384 (all of channel r % D).
template <int J>
__device__ void ln_relu(float* sm, const float* __restrict__ gamma,
                        const float* __restrict__ beta) {
  constexpr int D = chans(J) / 2, P = act_stride(J + 1), H = J + 1 < kStages ? 1 : 0;
  const int s = threadIdx.x >> 7, r = threadIdx.x & 127, c = r % D;
  const float* zs = sm + z_off(J) + s * z_floats(J) + 2 * D;
  float* ys = sm + act_off(J + 1) + s * act_floats(J + 1);
  const float* st = sm + kStats + (J * kS + s) * 4;
  const float mean = st[0], rs = st[2], gm = __ldg(gamma + c), bt = __ldg(beta + c);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = r + 128 * k, l = i / D;
    ys[(l + H) * P + c] = fmaxf(fmaf((zs[i] - mean) * rs, gm, bt), 0.f);
  }
}

template <int J>
__device__ __forceinline__ void forward_stage(float* sm, const float* __restrict__ bias,
                                              const float* __restrict__ gamma,
                                              const float* __restrict__ beta) {
  if (threadIdx.x < kUpThreads) up_conv<J>(sm, bias);
  __syncthreads();
  if (threadIdx.x < kS * 32) ln_stats<J>(sm);
  __syncthreads();
  ln_relu<J>(sm, gamma, beta);
  __syncthreads();
}
// The out conv and tanh at row p of sample s of the tile, as sln_chain.cu's out_stage sums them.
__device__ __forceinline__ float out_tanh(const float* sm, int s, int p, float b_out) {
  const float* xs = sm + act_off(kStages) + s * act_floats(kStages);
  const float* w = sm + kTapOut;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kKOut; ++t) {
    const float4 xv = lds4(xs + reflect_out(p + t - kPadOut) * 4);
    acc = fmaf(xv.x, w[t * 4], acc);
    acc = fmaf(xv.y, w[t * 4 + 1], acc);
    acc = fmaf(xv.z, w[t * 4 + 2], acc);
    acc = fmaf(xv.w, w[t * 4 + 3], acc);
  }
  return tanhf(acc + b_out);
}

// A block's start: the zero rows, the out conv's taps, then stage 0's taps and block `tile`'s x
// (one cp.async group) and stages 1-3's taps (a second, which lands behind stage 0); waits for
// the first group.
__device__ __forceinline__ void stage_block(float* sm, const Args& a, const float* __restrict__ x,
                                            int tile, int batch) {
  zero_rows<0>(sm);
  zero_rows<1>(sm);
  zero_rows<2>(sm);
  zero_rows<3>(sm);
  if (threadIdx.x < kKOut * 4) sm[kTapOut + threadIdx.x] = __ldg(a.w_out + threadIdx.x);
  stage_taps<0>(a.w[0], sm);
  stage_x(x, tile * kS, min(kS, batch - tile * kS), sm);
  cp_async_commit();
  stage_taps<1>(a.w[1], sm);
  stage_taps<2>(a.w[2], sm);
  stage_taps<3>(a.w[3], sm);
  cp_async_commit();
  cp_async_wait<1>();
}

}  // namespace tail
