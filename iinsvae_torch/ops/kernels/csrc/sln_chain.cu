// K6 sln_chain: the 1-D decoder's tail in one launch, (B, L0, C0) -> (B, L_pool).
//
// Replaces fused_sln_chain (iinsvae_tpu/ops/pallas/fused.py:1027, kernel
// _fwd_sln_chain_kernel :901, layer factory _make_sln_chain_layer :965). Four
// stages of
//   x2 nearest upsample -> conv k5, zero pad 2, + bias -> per-sample
//   LayerNorm (mean over all L*C values, unbiased std, / (std + 1e-5)) ->
//   per-channel gamma, beta -> ReLU,
// each (L, C) -> (2L, C/2), then conv k7, reflect pad 3, C_last -> 1, +
// bias, tanh, and the adaptive average pool L_last -> L_pool (each output
// averages the 1 or 2 inputs of its window, ops/pooling.py). The TPU body's
// dense stage matrices (upsample folded in, columns pre-centered), tiled
// affine rows and pool matrix are TPU devices; this kernel computes the
// composed path (iinsvae_tpu/models/decoders.py:178-185) from the taps.
//
// Bound on the H100: at the flagship (8, 64) -> (16, 32) -> (32, 16) ->
// (64, 8) -> (128, 4) -> 128 -> 157 a sample needs 177,024 multiply-adds
// (0.177 GFLOP per launch at batch 500, 2.64 us at 67 TFLOP/s fp32) and the
// launch moves ~1.4 MB (0.4 us at 3.35 TB/s): bound by operations. That
// count sums the weights of the taps that read the same pre-upsample row
// (each output reads at most 3 distinct rows through its 5 taps); this
// kernel does not fold them, so it issues 294,464 FMAs a sample, 5/3 of
// what the function needs. Every
// stage's output is L*C = 512 floats a sample, so a block keeps its tile
// of samples in two ping-pong buffers of shared memory through the whole
// tail, and device memory sees the input once and the pooled output once
// (the TPU kernel kept the chain in VMEM, fused.py:863-869).
//
// Design (the up-stages' device code is sln_stage.cuh's, shared with K6b
// and the one-stage K9 and K9b):
// - The upsample is folded into the indexing; the 2L-long input is never
//   built.
// - The tail keeps its fixed k7 reflect conv (out_stage below): K10's
//   runtime-geometry version of it spilled registers here (ptxas -v) and
//   made K6 slower on the H100.
// - A thread computes four consecutive output channels of one position from
//   float4 loads of the taps. The taps (~54 KB at the flagship, 40 KB of it
//   the first stage's) are read through the read-only cache, not staged in
//   shared memory, so a block needs only the default 48 KB.
// - The LayerNorm statistics of a sample are reduced by one warp with
//   shuffles, two-pass (no E[x^2] - mean^2).
// - Only the flagship's four stages are taken, with every stage's C_out a
//   multiple of 4 and at most 2048 floats a sample; anything else is
//   rejected at launch.
//
// Two paths. The general kernel above (sln_chain_kernel) takes every shape. It
// took 62 us at the decoder's shape at batch 500 on the H100, 23x its bound:
// each output quad is one fmaf chain of 160-320 steps, and every step waits
// on a 16-byte tap load through the read-only cache; 2 of its 8 warps run the
// LayerNorms. The decoder's shape, input (8, 64) (the only one Decoder1d gives
// K6), runs the tail kernel below on sln_tail.cuh, the forward recompute of
// K6b's own path: one persistent block of 512 threads a SM over tiles of 4
// samples, every stage's taps staged once a block in shared memory (stages
// 1-3 landing behind stage 0), 2 samples x a row pair x 4 channels a thread
// from shared-memory float4s, then the out conv, tanh and the pool. Each
// output is summed in the general kernel's order, so y is its bit for bit,
// and K6b's recompute stays K6's. It takes 20.3-20.5 us (PERF.md), 7.7x its
// bound: the four up-convs are most of it, each output quad still one
// fmaf chain of 160-320 steps on 4 of the block's 16 warps.
#include "sln_stage.cuh"
#include "sln_tail.cuh"

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
  const float* w_out;  // (7, C_last, 1)
  const float* b_out;  // (1,)
  int l_pool;
  int width;  // floats a sample in each ping-pong buffer
};

// out (ns, L) = tanh(conv_k7_reflect(in (ns, L, C)) + b).
__device__ void out_stage(const float* in, float* out, const float* __restrict__ w, float b,
                          int l, int c, int ns, int width) {
  for (int o = threadIdx.x; o < ns * l; o += blockDim.x) {
    const int s = o / l, p = o - s * l;
    const float* xs = in + s * width;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kKOut; ++t) {
      int u = p + t - kPadOut;
      u = u < 0 ? -u : (u >= l ? 2 * l - 2 - u : u);
      const float* xr = xs + u * c;
      for (int ci = 0; ci < c; ++ci) acc = fmaf(xr[ci], __ldg(w + t * c + ci), acc);
    }
    out[s * width + p] = tanhf(acc + b);
  }
}

// y (ns, L_pool): output i averages in[floor(i L / L_pool), ceil((i + 1) L / L_pool)).
__device__ void pool_stage(const float* in, float* __restrict__ y, int l, int l_pool, int ns,
                           int width) {
  for (int o = threadIdx.x; o < ns * l_pool; o += blockDim.x) {
    const int s = o / l_pool, i = o - s * l_pool;
    const int start = (i * l) / l_pool, end = ((i + 1) * l + l_pool - 1) / l_pool;
    const float* xs = in + s * width;
    float sum = 0.f;
    for (int u = start; u < end; ++u) sum += xs[u];
    y[static_cast<size_t>(s) * l_pool + i] = sum / static_cast<float>(end - start);
  }
}

__global__ void __launch_bounds__(kThreads)
sln_chain_kernel(const float* __restrict__ x, float* __restrict__ y, int batch, int spb,
                 ChainArgs a) {
  extern __shared__ float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  float* cur = smem;
  float* nxt = smem + spb * a.width;
  const int n0 = a.l_in[0] * a.c_in[0];
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    cur[s * a.width + (i - s * n0)] = xg[i];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStages; ++j) {
    const int c_out = a.c_in[j] / 2;
    up_conv_stage<true>(cur, nxt, a.w[j], a.bias[j], a.l_in[j], a.c_in[j], c_out, ns, a.width);
    __syncthreads();
    sln_relu(nxt, nxt, nullptr, a.gamma[j], a.beta[j], 2 * a.l_in[j] * c_out, c_out, ns,
             a.width);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  const int l = 2 * a.l_in[kStages - 1], c = a.c_in[kStages - 1] / 2;
  out_stage(cur, nxt, a.w_out, __ldg(a.b_out), l, c, ns, a.width);
  __syncthreads();
  pool_stage(nxt, y + static_cast<size_t>(s0) * a.l_pool, l, a.l_pool, ns, a.width);
}

}  // namespace

// ---------------------------------------------------------------------------
// The decoder's own path: input (8, 64), four up-stages to (128, 4), the k7 reflect conv, tanh
// and the pool (sln_tail.cuh).
namespace tail {

// The tanh output th (S, 128) goes to z[0]'s inner rows, free once stage 0's LayerNorm is done.
constexpr int kTh = z_off(0) + 2 * chans(0) / 2;
constexpr int kFwdSmemBytes = kFwdFloats * static_cast<int>(sizeof(float));
static_assert(kFwdSmemBytes <= 232448, "over the 227 KB a block can have");

// y (ns, l_pool) of the tile: output i averages th[floor(i L / L_pool), ceil((i + 1) L / L_pool)),
// summed in the general kernel's pool_stage order.
__device__ void pool_tile(const float* sm, float* __restrict__ y, int s0, int ns, int l_pool) {
  for (int o = threadIdx.x; o < ns * l_pool; o += kThreads) {
    const int s = o / l_pool, i = o - s * l_pool;
    const int start = (i * kLast) / l_pool, end = ((i + 1) * kLast + l_pool - 1) / l_pool;
    const float* th = sm + kTh + s * z_floats(0);
    float sum = 0.f;
    for (int u = start; u < end; ++u) sum += th[u];
    y[static_cast<size_t>(s0 + s) * l_pool + i] = sum / static_cast<float>(end - start);
  }
}

// One persistent block a SM walks tiles of kS samples (tile b, b + grid, ...): the four forward
// stages, then the out conv and tanh (thread (s, p)) and the pool.
__global__ void __launch_bounds__(kThreads, 1)
tail_fwd_kernel(const float* __restrict__ x, float* __restrict__ y, int batch, int n_tiles,
                Args a) {
  extern __shared__ __align__(16) float sm[];
  int tile = blockIdx.x;
  stage_block(sm, a, x, tile, batch);
  const float b_out = __ldg(a.b_out);
  for (bool first = true; tile < n_tiles; tile += gridDim.x, first = false) {
    const int s0 = tile * kS, ns = min(kS, batch - s0);
    if (!first) {
      __syncthreads();  // the last tile's reads of act[0] and th are done
      stage_x(x, s0, ns, sm);
      cp_async_wait_all();
    }
    __syncthreads();
    forward_stage<0>(sm, a.bias[0], a.gamma[0], a.beta[0]);
    if (first) {
      cp_async_wait<0>();
      __syncthreads();
    }
    forward_stage<1>(sm, a.bias[1], a.gamma[1], a.beta[1]);
    forward_stage<2>(sm, a.bias[2], a.gamma[2], a.beta[2]);
    forward_stage<3>(sm, a.bias[3], a.gamma[3], a.beta[3]);
    {
      const int s = threadIdx.x >> 7, p = threadIdx.x & 127;
      sm[kTh + s * z_floats(0) + p] = out_tanh(sm, s, p, b_out);
    }
    __syncthreads();
    pool_tile(sm, y, s0, ns, a.l_pool);
  }
}

int fwd_smem_set = 0;

int launch_fwd(const float* x, float* y, int batch, const Args& a, int tile, int grid, int smem,
               void* stream) {
  const int n_tiles = batch > 0 ? (batch + kS - 1) / kS : 0;
  if (batch <= 0 || tile != kS || grid < 1 || grid > n_tiles || smem != kFwdSmemBytes)
    return cudaErrorInvalidValue;
  if (!iins::aligned16(x)) return cudaErrorInvalidValue;
  for (int j = 0; j < kStages; ++j)
    if (!iins::aligned16(a.w[j])) return cudaErrorInvalidValue;
  const int err = allow_smem(tail_fwd_kernel, smem, &fwd_smem_set);
  if (err) return err;
  tail_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, y, batch,
                                                                               n_tiles, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tail

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, l0, c0) -> y (B, l_pool). ws, biases, gammas, betas: kStages device
// pointers each (host arrays); w_out (7, c0 / 2^kStages, 1), b_out (1,).
int iins_sln_chain(const float* x, float* y, int batch, const void* const* ws,
                   const void* const* biases, const void* const* gammas,
                   const void* const* betas, int l0, int c0, const float* w_out,
                   const float* b_out, int l_pool, int spb, void* stream) {
  if (batch <= 0 || spb <= 0 || l0 <= 0 || l_pool <= 0) return cudaErrorInvalidValue;
  // every stage's C_out = c0 / 2^(j+1) a multiple of 4; L*C is the same at every stage
  if (c0 % (4 << kStages) != 0 || l0 * c0 > kMaxFloats) return cudaErrorInvalidValue;
  ChainArgs a{};
  int l = l0, c = c0;
  for (int j = 0; j < kStages; ++j) {
    if (!aligned16(ws[j])) return cudaErrorInvalidValue;
    a.w[j] = static_cast<const float*>(ws[j]);
    a.bias[j] = static_cast<const float*>(biases[j]);
    a.gamma[j] = static_cast<const float*>(gammas[j]);
    a.beta[j] = static_cast<const float*>(betas[j]);
    a.l_in[j] = l;
    a.c_in[j] = c;
    l *= 2;
    c /= 2;
  }
  if (l <= kPadOut) return cudaErrorInvalidValue;  // reflect pad 3 needs L > 3
  a.w_out = w_out;
  a.b_out = b_out;
  a.l_pool = l_pool;
  a.width = l0 * c0;
  const size_t smem = 2 * static_cast<size_t>(spb) * a.width * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  sln_chain_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, y, batch,
                                                                               spb, a);
  return static_cast<int>(cudaGetLastError());
}

// K6 on the decoder's own path (namespace tail): x (B, 8, 64) -> y (B, l_pool); ws, biases,
// gammas, betas, w_out, b_out as for iins_sln_chain. tile (samples a tile), grid (the persistent
// blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared memory) as fused.sln_tail_plan
// and fused.SLN_TAIL_FWD_SMEM give them; the launch refuses any other.
int iins_sln_tail(const float* x, float* y, int batch, const void* const* ws,
                  const void* const* biases, const void* const* gammas, const void* const* betas,
                  int l0, int c0, const float* w_out, const float* b_out, int l_pool, int tile,
                  int grid, int smem, void* stream) {
  if (l0 != tail::kL0 || c0 != tail::kC0 || l_pool <= 0) return cudaErrorInvalidValue;
  tail::Args a{};
  for (int j = 0; j < tail::kStages; ++j) {
    a.w[j] = static_cast<const float*>(ws[j]);
    a.bias[j] = static_cast<const float*>(biases[j]);
    a.gamma[j] = static_cast<const float*>(gammas[j]);
    a.beta[j] = static_cast<const float*>(betas[j]);
  }
  a.w_out = w_out;
  a.b_out = b_out;
  a.l_pool = l_pool;
  return tail::launch_fwd(x, y, batch, a, tile, grid, smem, stream);
}

}  // extern "C"
