// Device helpers of the conv backward kernels (in_chain_bwd.cu,
// conv_bias_act_bwd.cu, sln_chain_bwd.cu, sln_layer_bwd.cu; sln_stage.cuh
// builds on them): the channels-last Conv1d stage
// and its padding rule (as in_chain.cu has them), the conv's input-gradient
// gather, the per-block weight-gradient partial and the fixed-order
// reduction of those partials.
//
// Layout: one sample's activation (L, C) row-major; taps (k, C_in, C_out).
// Output l's tap t reads the virtual row v = l*stride + t - pad; a zero pad
// drops a v outside [0, L), a reflect pad maps v < 0 to -v and v >= L to
// 2L - 2 - v (the edge row is not repeated).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace iins {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 48 * 1024;

struct Stage {
  int k, stride, pad, reflect;
  int l_in, c_in, l_out, c_out;
};

inline bool stage_ok(const Stage& st) {
  return st.k > 0 && st.stride > 0 && st.pad >= 0 && st.c_in > 0 && st.c_out > 0 &&
         st.l_out == (st.l_in + 2 * st.pad - st.k) / st.stride + 1 && st.l_out > 0 &&
         (!st.reflect || st.pad < st.l_in);
}

inline Stage make_stage(const int* p) {
  return Stage{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

inline bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// Input row read by tap t of output position l, or -1 for a zero pad.
__device__ __forceinline__ int src_row(const Stage& st, int l, int t) {
  const int u = l * st.stride + t - st.pad;
  if (u < 0) return st.reflect ? -u : -1;
  if (u >= st.l_in) return st.reflect ? 2 * st.l_in - 2 - u : -1;
  return u;
}

// out (ns, L_out, C_out) = conv(in), samples `in_stride` / `out_stride`
// floats apart; a thread computes four consecutive output channels (C_out %
// 4 == 0, 16-byte aligned taps) in the order in_chain.cu's conv_points
// sums them, so the recomputed activations are the forward's bit for bit.
__device__ void conv_stage4(const float* in, int in_stride, const float* __restrict__ w,
                            float* out, int out_stride, const Stage& st, int ns) {
  const int groups = st.c_out / 4, per = st.l_out * groups;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int l = r / groups, co = (r - l * groups) * 4;
    const float* xs = in + s * in_stride;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int t = 0; t < st.k; ++t) {
      const int u = src_row(st, l, t);
      if (u < 0) continue;
      const float* xr = xs + u * st.c_in;
      const float* wr = w + t * st.c_in * st.c_out + co;
#pragma unroll 4
      for (int ci = 0; ci < st.c_in; ++ci) {
        const float xv = xr[ci];
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + ci * st.c_out));
        a0 = fmaf(xv, wv.x, a0);
        a1 = fmaf(xv, wv.y, a1);
        a2 = fmaf(xv, wv.z, a2);
        a3 = fmaf(xv, wv.w, a3);
      }
    }
    float* dst = out + s * out_stride + l * st.c_out + co;
    dst[0] = a0;
    dst[1] = a1;
    dst[2] = a2;
    dst[3] = a3;
  }
}

// The input gradient of one conv stage: out[s, u, ci] = sum over the
// (l, t) whose tap t of output l reads row u of sum_co gz[s, l, co] *
// w[t, ci, co] (+ add[s, u, ci] when given). Under a reflect pad row u is
// read through the virtual rows u, -u (u >= 1) and 2L - 2 - u (u <= L - 2),
// which folds the edge rows back. V = 4 reads gz and the taps as float4
// (C_out % 4 == 0, gz rows and taps 16-byte aligned).
template <int V>
__device__ void conv_input_grad(const float* gz, int gz_stride, const float* __restrict__ w,
                                const Stage& st, int ns, float* out, int out_stride,
                                const float* add, int add_stride) {
  const int per = st.l_in * st.c_in;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int u = r / st.c_in, ci = r - u * st.c_in;
    const float* gs = gz + s * gz_stride;
    const int vs[3] = {u, -u, 2 * st.l_in - 2 - u};
    const int nv = st.reflect ? 3 : 1;
    float acc = 0.f;
    for (int t = 0; t < st.k; ++t) {
      const float* wr = w + (t * st.c_in + ci) * st.c_out;
      for (int q = 0; q < nv; ++q) {
        if ((q == 1 && u < 1) || (q == 2 && u > st.l_in - 2)) continue;
        const int num = vs[q] + st.pad - t;
        if (num < 0 || num % st.stride) continue;
        const int l = num / st.stride;
        if (l >= st.l_out) continue;
        const float* gr = gs + l * st.c_out;
        if constexpr (V == 4) {
          for (int co = 0; co < st.c_out; co += 4) {
            const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + co));
            const float4 gv = *reinterpret_cast<const float4*>(gr + co);
            acc = fmaf(gv.x, wv.x, acc);
            acc = fmaf(gv.y, wv.y, acc);
            acc = fmaf(gv.z, wv.z, acc);
            acc = fmaf(gv.w, wv.w, acc);
          }
        } else {
          for (int co = 0; co < st.c_out; ++co) acc = fmaf(gr[co], __ldg(wr + co), acc);
        }
      }
    }
    if (add) acc += add[s * add_stride + r];
    out[s * out_stride + r] = acc;
  }
}

// part[(t, ci, co)] = sum over the block's ns samples and the L_out output
// rows of in[s, src(l, t), ci] * gz[s, l, co]: this block's share of the
// taps' gradient. Every block writes all k * C_in * C_out of its partials.
__device__ void taps_grad_partial(const float* in, int in_stride, const float* gz,
                                  int gz_stride, const Stage& st, int ns,
                                  float* __restrict__ part) {
  const int n = st.k * st.c_in * st.c_out;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    const int co = o % st.c_out, r = o / st.c_out;
    const int ci = r % st.c_in, t = r / st.c_in;
    float acc = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* xs = in + s * in_stride + ci;
      const float* gs = gz + s * gz_stride + co;
      for (int l = 0; l < st.l_out; ++l) {
        const int u = src_row(st, l, t);
        if (u >= 0) acc = fmaf(xs[u * st.c_in], gs[l * st.c_out], acc);
      }
    }
    part[o] = acc;
  }
}

// part[co] = sum over the block's samples and rows of gz[s, l, co].
__device__ void bias_grad_partial(const float* gz, int gz_stride, int l, int c, int ns,
                                  float* __restrict__ part) {
  for (int co = threadIdx.x; co < c; co += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < ns; ++s)
      for (int i = 0; i < l; ++i) acc += gz[s * gz_stride + i * c + co];
    part[co] = acc;
  }
}

// out[i] = sum_p part[p, i], p in order: the blocks' partials summed the
// same way on every run, so the weight gradients are bit-reproducible.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ part, int n_parts, int n,
                       float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < n_parts; ++p) acc += __ldg(part + static_cast<size_t>(p) * n + i);
    out[i] = acc;
  }
}

inline int launch_reduce(const float* part, int n_parts, int n, float* out, cudaStream_t s) {
  const int grid = (n + kThreads - 1) / kThreads;
  reduce_partials_kernel<<<grid < 1024 ? grid : 1024, kThreads, 0, s>>>(part, n_parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

// out[i] = sum over p of part[p, i], in one fixed order, for many partial
// rows (one a persistent block): a block of 256 threads takes 32 consecutive
// i, warp w sums the rows p = w, w + 8, ... (128 contiguous bytes a row),
// then the eight warps' sums are added in order.
__global__ void __launch_bounds__(256)
reduce_rows_kernel(const float* __restrict__ part, int n_parts, int n, float* __restrict__ out) {
  __shared__ float sums[256];
  const int ln = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + ln;
  float s = 0.f;
  if (i < n)
    for (int p = wp; p < n_parts; p += 8) s += __ldg(part + static_cast<size_t>(p) * n + i);
  sums[threadIdx.x] = s;
  __syncthreads();
  if (wp == 0 && i < n) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += sums[k * 32 + ln];
    out[i] = t;
  }
}

inline int launch_reduce_rows(const float* part, int n_parts, int n, float* out,
                              cudaStream_t s) {
  reduce_rows_kernel<<<(n + 31) / 32, 256, 0, s>>>(part, n_parts, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace iins
