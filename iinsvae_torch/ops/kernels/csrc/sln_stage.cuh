// Device code of the 1-D decoder's upsample stages, forward and backward,
// shared by K6 sln_chain (sln_chain.cu), K6b (sln_chain_bwd.cu) and the
// one-stage K9 sln_layer and K9b (sln_layer.cu, sln_layer_bwd.cu); and
// K10 tanh_pool's tail conv, shared by K10 and K10b.
//
// An up-stage, (L, C_in) -> (2L, C_out):
//   x2 nearest upsample -> conv k5, zero pad 2 [+ bias] -> per-sample
//   LayerNorm (mean over all 2L*C_out values, unbiased std, / (std +
//   1e-5)) -> per-channel gamma, beta -> ReLU.
// The upsample is folded into the indexing: output l, tap t reads
// pre-upsample row (l + t - 2) >> 1 when 0 <= l + t - 2 < 2L, else zero;
// the 2L-long input is never built. A thread computes four consecutive
// output channels (C_out % 4 == 0, 16-byte aligned taps) from float4 loads
// of the taps through the read-only cache. The LayerNorm of a sample is
// reduced by one warp with shuffles, two-pass (the mean, then the squared
// deviations from it; no E[x^2] - mean^2).
//
// Buffers hold ns samples `width` floats apart, each sample's (L, C)
// row-major.
#pragma once

#include "conv_bwd_common.cuh"

namespace iins {

constexpr int kUpK = 5, kUpPad = 2;  // up-conv taps, zero pad
constexpr float kLnEps = 1e-5f;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out (ns, 2L, C_out) = conv(upsample(in)) [+ bias with kBias]; in (ns, L, C_in).
// kBias is a template argument, not a null test: K6's bias loads are then
// issued ahead of the tap loop, as before the code was shared.
template <bool kBias>
__device__ void up_conv_stage(const float* in, float* out, const float* __restrict__ w,
                              const float* __restrict__ bias, int l_in, int c_in, int c_out,
                              int ns, int width) {
  const int l_out = 2 * l_in, groups = c_out / 4, per = l_out * groups;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int l = r / groups, co = (r - l * groups) * 4;
    const float* xs = in + s * width;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int t = 0; t < kUpK; ++t) {
      const int u = l + t - kUpPad;  // row of the upsampled input
      if (u < 0 || u >= l_out) continue;
      const float* xr = xs + (u >> 1) * c_in;
      const float* wr = w + t * c_in * c_out + co;
#pragma unroll 4
      for (int ci = 0; ci < c_in; ++ci) {
        const float xv = xr[ci];
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + ci * c_out));
        a0 = fmaf(xv, wv.x, a0);
        a1 = fmaf(xv, wv.y, a1);
        a2 = fmaf(xv, wv.z, a2);
        a3 = fmaf(xv, wv.w, a3);
      }
    }
    float* dst = out + s * width + l * c_out + co;
    if constexpr (kBias) {
      dst[0] = a0 + __ldg(bias + co);
      dst[1] = a1 + __ldg(bias + co + 1);
      dst[2] = a2 + __ldg(bias + co + 2);
      dst[3] = a3 + __ldg(bias + co + 3);
    } else {
      dst[0] = a0;
      dst[1] = a1;
      dst[2] = a2;
      dst[3] = a3;
    }
  }
}

// y = relu(LN(z) * gamma + beta) over each sample's n = L*C values, one
// warp a sample; y may be z (in place) or null (statistics only); stats,
// when given, gets (mean, std, 1 / (std + eps)) at 3 s.
__device__ void sln_relu(const float* z, float* y, float* stats, const float* __restrict__ gamma,
                         const float* __restrict__ beta, int n, int c, int ns, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const float inv_n = 1.f / static_cast<float>(n), inv_n1 = 1.f / static_cast<float>(n - 1);
  for (int s = warp; s < ns; s += n_warps) {  // warp-uniform: full warps shuffle
    const float* zs = z + s * width;
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) sum += zs[i];
    const float mean = warp_sum(sum) * inv_n;
    float sq = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float d = zs[i] - mean;
      sq = fmaf(d, d, sq);
    }
    const float sd = sqrtf(warp_sum(sq) * inv_n1);
    const float rs = 1.f / (sd + kLnEps);
    if (y) {
      float* ys = y + s * width;
      for (int i = lane; i < n; i += 32) {
        const int ch = i % c;
        ys[i] = fmaxf(fmaf((zs[i] - mean) * rs, __ldg(gamma + ch), __ldg(beta + ch)), 0.f);
      }
    }
    if (stats && lane == 0) {
      stats[3 * s] = mean;
      stats[3 * s + 1] = sd;
      stats[3 * s + 2] = rs;
    }
  }
}

// out (ns, L_out, C_out) = tanh(conv(in) + bias): K10's tail conv (stride
// 1, any k, zero or reflect pad), one output a thread, summed tap by tap
// over the input channels as K6's fixed k7 reflect out_stage sums them.
__device__ void tanh_conv_stage(const float* in, int in_stride, float* out, int out_stride,
                                const float* __restrict__ w, const float* __restrict__ bias,
                                const Stage& st, int ns) {
  const int per = st.l_out * st.c_out;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int p = r / st.c_out, co = r - p * st.c_out;
    const float* xs = in + s * in_stride;
    float acc = 0.f;
    for (int t = 0; t < st.k; ++t) {
      const int u = src_row(st, p, t);
      if (u < 0) continue;
      const float* xr = xs + u * st.c_in;
      const float* wr = w + t * st.c_in * st.c_out + co;
      for (int ci = 0; ci < st.c_in; ++ci) acc = fmaf(xr[ci], __ldg(wr + ci * st.c_out), acc);
    }
    out[s * out_stride + r] = tanhf(acc + __ldg(bias + co));
  }
}

// ------------------------------ backward ------------------------------

// part[c], part[C + c] = sum over samples and rows of gh * yh and gh, with
// gh = ga where h > 0 (h = yh * gamma + beta): this block's dgamma, dbeta.
__device__ void affine_grad_partial(const float* z, const float* ga, const float* stats,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta, int n, int c, int ns,
                                    int width, float* __restrict__ part) {
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float gm = __ldg(gamma + ch), bt = __ldg(beta + ch);
    float dg = 0.f, db = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float mean = stats[3 * s], rs = stats[3 * s + 2];
      for (int i = ch; i < n; i += c) {
        const float yh = (z[s * width + i] - mean) * rs;
        if (fmaf(yh, gm, bt) > 0.f) {
          const float gh = ga[s * width + i];
          dg = fmaf(gh, yh, dg);
          db += gh;
        }
      }
    }
    part[ch] = dg;
    part[c + ch] = db;
  }
}

// In place z <- gz, the gradient of the stage's conv output, from ga, the
// gradient of its ReLU output; one warp a sample. The LayerNorm with
// unbiased std and /(std + eps): gt = sum gyh * d, gss = gt * (-t^2) /
// (2s), gd = gyh * t + d * 2 gss / (n - 1) (fused.py:892-894), then gz =
// gd - mean(gd) (the centring's adjoint).
__device__ void sln_backward(float* z, const float* ga, const float* stats,
                             const float* __restrict__ gamma, const float* __restrict__ beta,
                             int n, int c, int ns, int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n_warps = blockDim.x >> 5;
  const float inv_n = 1.f / static_cast<float>(n);
  for (int s = warp; s < ns; s += n_warps) {
    float* zs = z + s * width;
    const float* gs = ga + s * width;
    const float mean = stats[3 * s], sd = stats[3 * s + 1], rs = stats[3 * s + 2];
    // gyh at element i, and the centred d
    auto grad_at = [&](int i, float& d, float& gyh) {
      const int ch = i % c;
      const float gm = __ldg(gamma + ch);
      d = zs[i] - mean;
      gyh = fmaf(d * rs, gm, __ldg(beta + ch)) > 0.f ? gs[i] * gm : 0.f;
    };
    float sg = 0.f, sgt = 0.f, sdd = 0.f;
    for (int i = lane; i < n; i += 32) {
      float d, gyh;
      grad_at(i, d, gyh);
      sg += gyh;
      sgt = fmaf(gyh, d, sgt);
      sdd += d;
    }
    sg = warp_sum(sg);
    sgt = warp_sum(sgt);
    sdd = warp_sum(sdd);
    const float gss = sgt * -(rs * rs) / (2.f * sd);
    const float coef = 2.f * gss / static_cast<float>(n - 1);
    const float mean_gd = (rs * sg + coef * sdd) * inv_n;
    for (int i = lane; i < n; i += 32) {
      float d, gyh;
      grad_at(i, d, gyh);
      zs[i] = fmaf(d, coef, gyh * rs) - mean_gd;
    }
  }
}

// part: this block's d(taps) (5, C_in, C_out) of an up-stage and, with
// `with_bias`, its dbias (C_out) after them. kHalf (K6b's stages): C_out is
// C_in / 2, derived here and the c_out argument unused; taking it as an
// argument, K6b (at 64 registers) spilled one (ptxas -v) and ran slower.
template <bool kHalf>
__device__ void up_conv_grad_partial(const float* in, const float* gz, int l_in, int c_in,
                                     int c_out, bool with_bias, int ns, int width,
                                     float* __restrict__ part) {
  if constexpr (kHalf) c_out = c_in / 2;
  const int l_out = 2 * l_in, n = kUpK * c_in * c_out;
  for (int o = threadIdx.x; o < n + (with_bias ? c_out : 0); o += blockDim.x) {
    float acc = 0.f;
    if (o < n) {
      const int co = o % c_out, r = o / c_out;
      const int ci = r % c_in, t = r / c_in;
      for (int s = 0; s < ns; ++s) {
        const float* xs = in + s * width + ci;
        const float* gs = gz + s * width + co;
        for (int l = 0; l < l_out; ++l) {
          const int u = l + t - kUpPad;
          if (u >= 0 && u < l_out) acc = fmaf(xs[(u >> 1) * c_in], gs[l * c_out], acc);
        }
      }
    } else {
      const int co = o - n;
      for (int s = 0; s < ns; ++s)
        for (int l = 0; l < l_out; ++l) acc += gz[s * width + l * c_out + co];
    }
    part[o] = acc;
  }
}

// out[s, u, ci] = the gradient of the up-stage's input: its two upsampled
// rows 2u, 2u+1 are read by output l through tap t = v + 2 - l. kHalf as
// for up_conv_grad_partial.
template <bool kHalf>
__device__ void up_conv_input_grad(const float* gz, const float* __restrict__ w, int l_in,
                                   int c_in, int c_out, int ns, int width, float* out,
                                   int out_stride) {
  if constexpr (kHalf) c_out = c_in / 2;
  const int l_out = 2 * l_in, per = l_in * c_in;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int u = r / c_in, ci = r - u * c_in;
    const float* gs = gz + s * width;
    float acc = 0.f;
    for (int v = 2 * u; v < 2 * u + 2; ++v) {
      for (int t = 0; t < kUpK; ++t) {
        const int l = v + kUpPad - t;
        if (l < 0 || l >= l_out) continue;
        const float* gr = gs + l * c_out;
        const float* wr = w + (t * c_in + ci) * c_out;
        for (int co = 0; co < c_out; co += 4) {
          const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + co));
          const float4 gv = *reinterpret_cast<const float4*>(gr + co);
          acc = fmaf(gv.x, wv.x, acc);
          acc = fmaf(gv.y, wv.y, acc);
          acc = fmaf(gv.z, wv.z, acc);
          acc = fmaf(gv.w, wv.w, acc);
        }
      }
    }
    out[s * out_stride + r] = acc;
  }
}

}  // namespace iins
