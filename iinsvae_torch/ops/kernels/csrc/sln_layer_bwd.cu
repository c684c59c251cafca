// K9b sln_layer_bwd and K10b tanh_pool_bwd: the backward of the one-stage
// decoder entries, each one stage of K6b.
//
// K9b replaces the backward of fused_sln_layer (iinsvae_tpu/ops/pallas/
// fused.py:753, kernel _bwd_sln_kernel :624): from the output's gradient
// g (B, 2L, C_out), recompute the stage (conv of the upsampled input and
// the LayerNorm statistics, K9's arithmetic), then gh = g where h > 0,
// dgamma = sum gh * yh and dbeta = sum gh over the batch and the 2L rows
// (the TPU's (1, N) tile gradients summed over L), the LayerNorm backward
// with unbiased std and /(std + eps) and the centring's adjoint, d(taps)
// and dx through the upsample's adjoint (sln_stage.cuh, K6b's code).
//
// K10b replaces the backward of fused_tanh_pool_layer (fused.py:799,
// kernel _bwd_tanhpool_kernel :653): gth = g pool^T, gz = gth * (1 -
// th^2) with th recomputed, then d(taps), dbias and dx of the conv
// (conv_bwd_common.cuh, K6b's tail). The pool matrix gets no gradient, as
// in the entry (fused.py:822).
//
// Each kernel sums its block's d(taps) (and dgamma, dbeta or dbias) into
// its row of a (grid, n) buffer that a second kernel sums in order: no
// atomics, so two runs give bit-equal gradients. The forward is recomputed
// from the saved input; K9 and K10 write nothing for the backward. Bound on
// the H100 at batch 500: each backward does three times its forward's
// operations (recompute, dx, d(taps)) and moves its input, g and the
// gradients once (2.4-3.1 MB): K9b's first three stages are bound by
// operations (4.0, 2.1 and 1.1 us at 67 TFLOP/s fp32), its last stage and
// K10b by bytes (0.9 and 0.7 us at 3.35 TB/s).
#include "sln_stage.cuh"

namespace {

using namespace iins;

// Shared memory: in, z, ga (spb, width) each, then the LayerNorm statistics
// (spb, 3). z becomes gz in place.
__global__ void __launch_bounds__(kThreads)
sln_layer_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* __restrict__ part, int batch, int l_in, int c_in, int c_out,
                     int spb, int width) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  float* in = smem;
  float* z = in + spb * width;
  float* ga = z + spb * width;
  float* stats = ga + spb * width;
  const int n0 = l_in * c_in, n = 2 * l_in * c_out, n_taps = kUpK * c_in * c_out;
  float* mine = part + static_cast<size_t>(blockIdx.x) * (n_taps + 2 * c_out);
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    in[s * width + (i - s * n0)] = xg[i];
  }
  const float* gg = g + static_cast<size_t>(s0) * n;
  for (int i = threadIdx.x; i < ns * n; i += blockDim.x) {
    const int s = i / n;
    ga[s * width + (i - s * n)] = gg[i];
  }
  __syncthreads();
  up_conv_stage<false>(in, z, w, nullptr, l_in, c_in, c_out, ns, width);
  __syncthreads();
  sln_relu(z, nullptr, stats, gamma, beta, n, c_out, ns, width);
  __syncthreads();
  affine_grad_partial(z, ga, stats, gamma, beta, n, c_out, ns, width, mine + n_taps);
  __syncthreads();
  sln_backward(z, ga, stats, gamma, beta, n, c_out, ns, width);
  __syncthreads();
  up_conv_grad_partial<false>(in, z, l_in, c_in, c_out, false, ns, width, mine);
  if (dx)
    up_conv_input_grad<false>(z, w, l_in, c_in, c_out, ns, width,
                              dx + static_cast<size_t>(s0) * n0, n0);
}

// Shared memory: in (spb, w_in), th (spb, w_th); th becomes gz in place.
__global__ void __launch_bounds__(kThreads)
tanh_pool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ bias, const float* __restrict__ pool,
                     const float* __restrict__ g, float* __restrict__ dx,
                     float* __restrict__ part, int batch, Stage st, int n_out, int spb,
                     int w_in, int w_th) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  float* in = smem;
  float* th = smem + spb * w_in;
  const int n0 = st.l_in * st.c_in, n_mid = st.l_out * st.c_out;
  const int n_taps = st.k * st.c_in * st.c_out;
  float* mine = part + static_cast<size_t>(blockIdx.x) * (n_taps + st.c_out);
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    in[s * w_in + (i - s * n0)] = xg[i];
  }
  __syncthreads();
  tanh_conv_stage(in, w_in, th, w_th, w, bias, st, ns);
  __syncthreads();
  // th <- gz = (g pool^T) * (1 - th^2)
  const float* gg = g + static_cast<size_t>(s0) * n_out;
  for (int o = threadIdx.x; o < ns * n_mid; o += blockDim.x) {
    const int s = o / n_mid, u = o - s * n_mid;
    const float* gs = gg + static_cast<size_t>(s) * n_out;
    const float* pr = pool + static_cast<size_t>(u) * n_out;
    float gth = 0.f;
    for (int i = 0; i < n_out; ++i) gth = fmaf(gs[i], __ldg(pr + i), gth);
    const float t = th[s * w_th + u];
    th[s * w_th + u] = gth * (1.f - t * t);
  }
  __syncthreads();
  taps_grad_partial(in, w_in, th, w_th, st, ns, mine);
  bias_grad_partial(th, w_th, st.l_out, st.c_out, ns, mine + n_taps);
  if (dx)
    conv_input_grad<1>(th, w_th, w, st, ns, dx + static_cast<size_t>(s0) * n0, n0, nullptr, 0);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K9b: x (B, l_in, c_in); w (5, c_in, c_out), 16-byte aligned, c_out a
// multiple of 4; gamma, beta (c_out,); g (B, 2 l_in, c_out); dx (B, l_in,
// c_in) or null; part (ceil(B / spb), n) scratch; dw (n): d(taps), dgamma,
// dbeta.
int iins_sln_layer_bwd(const float* x, const float* w, const float* gamma, const float* beta,
                       const float* g, float* dx, float* part, float* dw, int batch, int l_in,
                       int c_in, int c_out, int spb, void* stream) {
  if (batch <= 0 || spb <= 0 || l_in <= 0 || c_in <= 0 || c_out <= 0 || c_out % 4 ||
      !aligned16(w))
    return cudaErrorInvalidValue;
  const int n_in = l_in * c_in, n = 2 * l_in * c_out;
  const int width = ((n_in > n ? n_in : n) + 3) & ~3;
  const size_t smem = (3 * static_cast<size_t>(width) + 3) * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sln_layer_bwd_kernel<<<grid, kThreads, smem, s>>>(x, w, gamma, beta, g, dx, part, batch,
                                                    l_in, c_in, c_out, spb, width);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, kUpK * c_in * c_out + 2 * c_out, dw, s);
}

// K10b: x (B, l_in, c_in); stage (k, 1, pad, reflect, l_in, c_in, l_out,
// c_mid); w (k, c_in, c_mid); bias (c_mid,); pool (l_out * c_mid, n_out);
// g (B, n_out); dx (B, l_in, c_in) or null; part (ceil(B / spb), n)
// scratch; dw (n): d(taps), dbias.
int iins_tanh_pool_bwd(const float* x, const float* w, const float* bias, const float* pool,
                       const float* g, float* dx, float* part, float* dw, int batch,
                       const int* stage, int n_out, int spb, void* stream) {
  const Stage st = make_stage(stage);
  if (batch <= 0 || spb <= 0 || n_out <= 0 || !stage_ok(st) || st.stride != 1)
    return cudaErrorInvalidValue;
  const int w_in = (st.l_in * st.c_in + 3) & ~3, w_th = (st.l_out * st.c_out + 3) & ~3;
  const size_t smem = static_cast<size_t>(spb) * (w_in + w_th) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tanh_pool_bwd_kernel<<<grid, kThreads, smem, s>>>(x, w, bias, pool, g, dx, part, batch, st,
                                                    n_out, spb, w_in, w_th);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, st.k * st.c_in * st.c_out + st.c_out, dw, s);
}

}  // extern "C"
