// K9 sln_layer and K10 tanh_pool: the one-stage decoder entries, each one
// stage of K6 sln_chain run on its own (device code in sln_stage.cuh; K9's
// up-stage is K6's own).
//
// K9 replaces fused_sln_layer (iinsvae_tpu/ops/pallas/fused.py:844, kernels
// _fwd_sln_kernel :613, layer factory _make_sln_layer :735): x2 nearest upsample
// -> conv k5 zero pad 2 (no bias) -> per-sample LayerNorm (unbiased std,
// / (std + 1e-5)) -> per-channel gamma, beta -> ReLU, (B, L, C_in) -> (B,
// 2L, C_out). The TPU body's dense matrix (the upsample folded in, its
// columns centred over all 2L*C_out outputs) and (1, N) affine tiles are
// TPU devices; this kernel takes the taps and the (C_out,) vectors.
//
// K10 replaces fused_tanh_pool_layer (fused.py:855, kernels
// _fwd_tanhpool_kernel :645, layer factory _make_tanhpool_layer :784):
// tanh(conv(x) + bias) (stride 1, zero or reflect pad, per-channel bias)
// flattened over (L, C_mid), times the caller's pool matrix (L*C_mid,
// n_out). It is K6's tail with the window pool replaced by that matrix.
//
// No model calls either (the decoder runs K6); they are the public
// counterparts of the Pallas entries. Bound on the H100 at batch 500 and the
// flagship decoder's shapes: K9's four stages do 90, 47, 24 and 12 MFLOP
// (taps that read the same pre-upsample row counted once; 1.34-0.18 us at
// 67 TFLOP/s fp32) and move ~2.1 MB each (0.62 us at 3.35 TB/s): the first
// is bound by operations, the others by bytes. K10 moves 1.4 MB (0.42 us)
// for 3.6 MFLOP: bound by bytes. A block keeps its tile of samples in
// shared memory, so device memory sees the input once and the output once;
// K10 reads the pool matrix (80 KB at 128 -> 157) through the read-only
// cache, every block all of it.
#include "sln_stage.cuh"

namespace {

using namespace iins;

// Shared memory: in (spb, width), z (spb, width); width holds a sample's
// input or output, rounded up to 4 floats.
__global__ void __launch_bounds__(kThreads)
sln_layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 float* __restrict__ y, int batch, int l_in, int c_in, int c_out, int spb,
                 int width) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  float* in = smem;
  float* z = smem + spb * width;
  const int n0 = l_in * c_in, n = 2 * l_in * c_out;
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    in[s * width + (i - s * n0)] = xg[i];
  }
  __syncthreads();
  up_conv_stage<false>(in, z, w, nullptr, l_in, c_in, c_out, ns, width);
  __syncthreads();
  sln_relu(z, z, nullptr, gamma, beta, n, c_out, ns, width);
  __syncthreads();
  float* yg = y + static_cast<size_t>(s0) * n;
  for (int i = threadIdx.x; i < ns * n; i += blockDim.x) {
    const int s = i / n;
    yg[i] = z[s * width + (i - s * n)];
  }
}

// Shared memory: in (spb, w_in), th (spb, w_th).
__global__ void __launch_bounds__(kThreads)
tanh_pool_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ bias, const float* __restrict__ pool,
                 float* __restrict__ y, int batch, Stage st, int n_out, int spb, int w_in,
                 int w_th) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  float* in = smem;
  float* th = smem + spb * w_in;
  const int n0 = st.l_in * st.c_in, n_mid = st.l_out * st.c_out;
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    in[s * w_in + (i - s * n0)] = xg[i];
  }
  __syncthreads();
  tanh_conv_stage(in, w_in, th, w_th, w, bias, st, ns);
  __syncthreads();
  // y[s, i] = sum_u th[s, u] pool[u, i]: neighbouring threads read
  // neighbouring columns of a pool row
  float* yg = y + static_cast<size_t>(s0) * n_out;
  for (int o = threadIdx.x; o < ns * n_out; o += blockDim.x) {
    const int s = o / n_out, i = o - s * n_out;
    const float* ts = th + s * w_th;
    float acc = 0.f;
    for (int u = 0; u < n_mid; ++u)
      acc = fmaf(ts[u], __ldg(pool + static_cast<size_t>(u) * n_out + i), acc);
    yg[o] = acc;
  }
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K9: x (B, l_in, c_in) -> y (B, 2 l_in, c_out); w (5, c_in, c_out), 16-byte
// aligned, c_out a multiple of 4; gamma, beta (c_out,).
int iins_sln_layer(const float* x, const float* w, const float* gamma, const float* beta,
                   float* y, int batch, int l_in, int c_in, int c_out, int spb, void* stream) {
  if (batch <= 0 || spb <= 0 || l_in <= 0 || c_in <= 0 || c_out <= 0 || c_out % 4 ||
      !aligned16(w))
    return cudaErrorInvalidValue;
  const int n_in = l_in * c_in, n = 2 * l_in * c_out;
  const int width = ((n_in > n ? n_in : n) + 3) & ~3;
  const size_t smem = 2 * static_cast<size_t>(spb) * width * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  sln_layer_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, gamma, beta, y, batch, l_in, c_in, c_out, spb, width);
  return static_cast<int>(cudaGetLastError());
}

// K10: x (B, l_in, c_in) -> y (B, n_out); stage (k, 1, pad, reflect, l_in,
// c_in, l_out, c_mid); w (k, c_in, c_mid); bias (c_mid,); pool (l_out *
// c_mid, n_out).
int iins_tanh_pool(const float* x, const float* w, const float* bias, const float* pool,
                   float* y, int batch, const int* stage, int n_out, int spb, void* stream) {
  const Stage st = make_stage(stage);
  if (batch <= 0 || spb <= 0 || n_out <= 0 || !stage_ok(st) || st.stride != 1)
    return cudaErrorInvalidValue;
  const int w_in = (st.l_in * st.c_in + 3) & ~3, w_th = (st.l_out * st.c_out + 3) & ~3;
  const size_t smem = static_cast<size_t>(spb) * (w_in + w_th) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  tanh_pool_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, pool, y, batch, st, n_out, spb, w_in, w_th);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
