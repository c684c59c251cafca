// K6b sln_chain_bwd: the backward of K6, the 1-D decoder's tail, in one
// call: (B, L0, C0) -> 4 x (x2 upsample, conv k5 zero pad 2 + bias, sample
// LayerNorm, affine, ReLU) -> conv k7 reflect pad 3 + bias, tanh -> pool.
//
// Replaces the backward of fused_sln_chain (iinsvae_tpu/ops/pallas/
// fused.py:996, kernel _bwd_sln_chain_kernel :922, stage _sln_stage_bwd
// :880): dx, and per stage d(taps), dbias, dgamma, dbeta, then the out
// conv's d(taps) and dbias. The Pallas body reads the saved pre-norm
// activations and returns gradients of the dense upsample-conv matrices
// and tiled rows; this kernel saves nothing in the forward (K6 runs
// unchanged), recomputes the tail from the saved input in shared memory
// with K6's arithmetic, and returns the gradients of the taps and of the
// per-channel vectors directly. Backward, per sample:
//   pool^T: gth[u] = sum over the windows i holding u of g[i] / |window i|
//   tanh:   gz = gth * (1 - th^2); out conv: d(taps), dbias, and the
//           gradient of its input (the reflect pad's edge rows folded back)
//   per stage, last first: gh = ga where h > 0 (h = yh * gamma + beta);
//           dgamma += gh * yh, dbeta += gh (over the batch and L);
//           gyh = gh * gamma; the LayerNorm with unbiased std and
//           /(std + eps): gt = sum gyh * d, gss = gt * (-t^2) / (2s),
//           gd = gyh * t + d * 2 gss / (n - 1) (fused.py:892-894), then
//           gz = gd - mean(gd) (the centring's adjoint);
//           dbias += sum_l gz, d(taps) += up(a)^T gz, and the input's
//           gradient, the upsample's adjoint summing each row pair.
//
// A block keeps, per sample, the input, the four stage outputs and the four
// pre-norm conv outputs (9 x L0*C0 floats) and the tanh output in shared
// memory: 19 KB a sample at the flagship, 2 samples a block in the default
// 48 KB. Per-channel gradients (taps, bias, gamma, beta) are summed over
// the block's samples into its row of a (grid, n) buffer that a second
// kernel sums in order: deterministic, no atomics. The up-stages' code is
// sln_stage.cuh's (shared with K6, K9 and K9b); the fixed k7 reflect tail
// stays here: the runtime-geometry conv helpers K10b uses
// (conv_bwd_common.cuh) made K6b slower on the H100.
//
// Bound on the H100 at batch 500 (flagship): the forward recompute, d(taps)
// and the input gradients each need the forward's 177,024 multiply-adds a
// sample (counting the upsample's row pairs once): 0.53 GFLOP, 7.9 us at 67
// TFLOP/s fp32; ~1.4 MB moved: bound by operations.
#include "sln_stage.cuh"

namespace {

using namespace iins;

constexpr int kStages = 4;
constexpr int kKOut = 7, kPadOut = 3;  // out-conv taps, reflect pad
constexpr int kMaxFloats = 2048;       // floats a sample, per stage

struct ChainArgs {
  const float* w[kStages];      // (5, C_in, C_in / 2)
  const float* bias[kStages];   // (C_in / 2,)
  const float* gamma[kStages];  // (C_in / 2,)
  const float* beta[kStages];   // (C_in / 2,)
  int l_in[kStages], c_in[kStages];  // stage j: (l_in, c_in) -> (2 l_in, c_in / 2)
  int off[kStages];  // offset of stage j's (taps, bias, gamma, beta) gradients in a partial row
  const float* w_out;  // (7, C_last, 1)
  const float* b_out;  // (1,)
  int off_out;         // offset of the out conv's (taps, bias) gradients
  int n_part;          // floats in a partial row
  int l_pool;
  int width;   // floats a sample in each activation buffer (L0 * C0)
  int th_len;  // L_last rounded up to 4
};

__device__ __forceinline__ int reflect(int u, int l) {
  return u < 0 ? -u : (u >= l ? 2 * l - 2 - u : u);
}

__global__ void __launch_bounds__(kThreads)
sln_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ part, int batch, int spb,
                     ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int wd = a.width;
  // act[j]: stage j's input (j = 0: x; j = 4: the out conv's input);
  // z[j]: stage j's conv output; each (spb, width)
  float* act[kStages + 1];
  float* z[kStages];
  for (int j = 0; j <= kStages; ++j) act[j] = smem + j * spb * wd;
  for (int j = 0; j < kStages; ++j) z[j] = smem + (kStages + 1 + j) * spb * wd;
  float* th = smem + (2 * kStages + 1) * spb * wd;  // (spb, th_len)
  float* stats = th + spb * a.th_len;               // (kStages, spb, 3)
  float* mine = part + static_cast<size_t>(blockIdx.x) * a.n_part;

  const int n0 = a.l_in[0] * a.c_in[0];
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    act[0][s * wd + (i - s * n0)] = xg[i];
  }
  __syncthreads();
  for (int j = 0; j < kStages; ++j) {
    const int c_out = a.c_in[j] / 2;
    up_conv_stage<true>(act[j], z[j], a.w[j], a.bias[j], a.l_in[j], a.c_in[j], c_out, ns, wd);
    __syncthreads();
    sln_relu(z[j], act[j + 1], stats + 3 * j * spb, a.gamma[j], a.beta[j],
             2 * a.l_in[j] * c_out, c_out, ns, wd);
    __syncthreads();
  }
  const int l = 2 * a.l_in[kStages - 1], c = a.c_in[kStages - 1] / 2;
  const float b_out = __ldg(a.b_out);
  // th = tanh(conv_k7_reflect(act[4]) + b), sln_chain.cu's out_stage arithmetic
  for (int o = threadIdx.x; o < ns * l; o += blockDim.x) {
    const int s = o / l, p = o - s * l;
    const float* xs = act[kStages] + s * wd;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kKOut; ++t) {
      const float* xr = xs + reflect(p + t - kPadOut, l) * c;
      for (int ci = 0; ci < c; ++ci) acc = fmaf(xr[ci], __ldg(a.w_out + t * c + ci), acc);
    }
    th[s * a.th_len + p] = tanhf(acc + b_out);
  }
  __syncthreads();

  // th <- gz of the out conv: the pool's transpose, then tanh's derivative
  const float* gg = g + static_cast<size_t>(s0) * a.l_pool;
  for (int o = threadIdx.x; o < ns * l; o += blockDim.x) {
    const int s = o / l, u = o - s * l;
    float gth = 0.f;
    for (int i = (u * a.l_pool) / l; i <= ((u + 1) * a.l_pool - 1) / l && i < a.l_pool; ++i) {
      const int start = (i * l) / a.l_pool, end = ((i + 1) * l + a.l_pool - 1) / a.l_pool;
      if (start <= u && u < end) gth += gg[s * a.l_pool + i] / static_cast<float>(end - start);
    }
    const float t = th[s * a.th_len + u];
    th[s * a.th_len + u] = gth * (1.f - t * t);
  }
  __syncthreads();
  // the out conv's d(taps) (7, c) and dbias
  for (int o = threadIdx.x; o <= kKOut * c; o += blockDim.x) {
    float acc = 0.f;
    if (o < kKOut * c) {
      const int t = o / c, ci = o - t * c;
      for (int s = 0; s < ns; ++s)
        for (int p = 0; p < l; ++p)
          acc = fmaf(act[kStages][s * wd + reflect(p + t - kPadOut, l) * c + ci],
                     th[s * a.th_len + p], acc);
    } else {
      for (int s = 0; s < ns; ++s)
        for (int p = 0; p < l; ++p) acc += th[s * a.th_len + p];
    }
    mine[a.off_out + o] = acc;
  }
  __syncthreads();
  // act[4] <- its gradient: row u is read through the virtual rows u, -u
  // and 2L - 2 - u by output p = v + 3 - t
  for (int o = threadIdx.x; o < ns * l * c; o += blockDim.x) {
    const int s = o / (l * c), r = o - s * l * c;
    const int u = r / c, ci = r - u * c;
    const int vs[3] = {u, -u, 2 * l - 2 - u};
    float acc = 0.f;
    for (int q = 0; q < 3; ++q) {
      if ((q == 1 && u < 1) || (q == 2 && u > l - 2)) continue;
      for (int t = 0; t < kKOut; ++t) {
        const int p = vs[q] + kPadOut - t;
        if (p >= 0 && p < l)
          acc = fmaf(th[s * a.th_len + p], __ldg(a.w_out + t * c + ci), acc);
      }
    }
    act[kStages][s * wd + r] = acc;
  }
  __syncthreads();

  for (int j = kStages - 1; j >= 0; --j) {
    const int c_out = a.c_in[j] / 2, n = 2 * a.l_in[j] * c_out;
    const float* st = stats + 3 * j * spb;
    float* pj = mine + a.off[j];
    const int n_taps = kUpK * a.c_in[j] * c_out;
    affine_grad_partial(z[j], act[j + 1], st, a.gamma[j], a.beta[j], n, c_out, ns, wd,
                        pj + n_taps + c_out);
    __syncthreads();
    sln_backward(z[j], act[j + 1], st, a.gamma[j], a.beta[j], n, c_out, ns, wd);
    __syncthreads();
    up_conv_grad_partial<true>(act[j], z[j], a.l_in[j], a.c_in[j], c_out, true, ns, wd, pj);
    __syncthreads();
    if (j > 0) {
      up_conv_input_grad<true>(z[j], a.w[j], a.l_in[j], a.c_in[j], c_out, ns, wd, act[j], wd);
      __syncthreads();
    } else if (dx) {
      up_conv_input_grad<true>(z[0], a.w[0], a.l_in[0], a.c_in[0], c_out, ns, wd,
                               dx + static_cast<size_t>(s0) * n0, n0);
    }
  }
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, l0, c0), g (B, l_pool), dx (B, l0, c0) or null. ws, biases, gammas,
// betas: kStages device pointers each (host arrays); w_out (7, c0 / 16, 1),
// b_out (1,). part: (ceil(B / spb), n) scratch; dw (n): per stage d(taps),
// dbias, dgamma, dbeta, then the out conv's d(taps) and dbias.
int iins_sln_chain_bwd(const float* x, const float* g, float* dx, float* part, float* dw,
                       int batch, const void* const* ws, const void* const* biases,
                       const void* const* gammas, const void* const* betas, int l0, int c0,
                       const float* w_out, const float* b_out, int l_pool, int spb,
                       void* stream) {
  if (batch <= 0 || spb <= 0 || l0 <= 0 || l_pool <= 0) return cudaErrorInvalidValue;
  if (c0 % (4 << kStages) != 0 || l0 * c0 > kMaxFloats) return cudaErrorInvalidValue;
  ChainArgs a{};
  int l = l0, c = c0, off = 0;
  for (int j = 0; j < kStages; ++j) {
    if (!aligned16(ws[j])) return cudaErrorInvalidValue;
    a.w[j] = static_cast<const float*>(ws[j]);
    a.bias[j] = static_cast<const float*>(biases[j]);
    a.gamma[j] = static_cast<const float*>(gammas[j]);
    a.beta[j] = static_cast<const float*>(betas[j]);
    a.l_in[j] = l;
    a.c_in[j] = c;
    a.off[j] = off;
    off += kUpK * c * (c / 2) + 3 * (c / 2);
    l *= 2;
    c /= 2;
  }
  if (l <= kPadOut) return cudaErrorInvalidValue;  // reflect pad 3 needs L > 3
  a.w_out = w_out;
  a.b_out = b_out;
  a.off_out = off;
  a.n_part = off + kKOut * c + 1;
  a.l_pool = l_pool;
  a.width = l0 * c0;
  a.th_len = (l + 3) & ~3;
  const size_t per = (2 * kStages + 1) * static_cast<size_t>(a.width) + a.th_len + 3 * kStages;
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sln_chain_bwd_kernel<<<grid, kThreads, smem, s>>>(x, g, dx, part, batch, spb, a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, a.n_part, dw, s);
}

}  // extern "C"
