// K1 in_chain and K2 conv_bias_act: direct channels-last Conv1d stages.
//
// K1 replaces three TPU entries of iinsvae_tpu/ops/pallas/fused.py:
//   fused_in_pair (:361), fused_dense_layer(norm='in') (:1320, kernel
//   _make_in_layer :1179) and fused_res_block (:253).
// It runs 1 or 2 stages of conv -> InstanceNorm -> (ReLU | + chain input)
// on a tile of samples. K2 replaces fused_dense_layer(norm='none') (:1320,
// kernel _make_nonorm_layer :1248): one stage of conv + bias + ReLU.
//
// Bound on the H100: one sample's activation is at most 2048 floats here,
// so a block keeps its tile of samples in shared memory through the whole
// chain and device memory sees the chain input once and its output once
// (1-4 MB per launch at batch 500: about a microsecond at 3.35 TB/s). The
// residual block does 192 multiply-adds per output, ~196 MFLOP per launch
// at batch 500, so it is bound by fp32 operations (2.9 us at 67 TFLOP/s);
// the other stages are bound by bytes. At these sizes a launch is latency-bound, so
// the design is about instruction-level parallelism: the mid-chain
// activation stays on chip (the TPU kernel's point, fused.py:265-270), a
// thread computes four consecutive output channels from one float4 load of
// the taps (read through the read-only cache) and one shared-memory read of
// the input (a broadcast across the warp), and the InstanceNorm statistics
// use a few lanes per (sample, channel) so short rows do not serialise.
//
// Layout: x (B, L, C) row-major, taps (k, C_in, C_out). K1 takes stages
// whose C_out is a multiple of 4 only; K2's general kernel runs a C_out that
// is not (a 1x1 conv to 2 channels off its call sites) on its scalar path.
//
// K5 adain_res_block replaces fused_adain_res_block (fused.py:557, kernel
// _fwd_adain_block_kernel :382): the decoder's AdaIN residual block, K1's
// residual mode with one step added. After each stage's InstanceNorm the
// kernel applies y * gamma[s, c] + beta[s, c] from per-sample (B, C)
// tables, before the ReLU or the skip. It is a template instance of K1's
// kernel (kAdain = true), so K1's own instance compiles as before. Its
// bound is K1's residual block's: ~196 MFLOP at batch 500 (2.9 us at 67
// TFLOP/s fp32), bound by operations. The TPU body's per-sample (B, L*C)
// tiles of gamma and beta are a layout device: the kernel reads (B, C).
//
// K8 adain_layer replaces fused_adain_layer (fused.py:828, kernels
// _fwd_adain_kernel :573, layer factory _make_adain_layer :664): one conv ->
// InstanceNorm -> per-sample affine -> (ReLU) stage with an optional
// residual added after the activation, read from its own (B, L, C) array.
// It is the one-stage kAdain instance of the same kernel: the last stage's
// ReLU and its skip are two independent settings (K1 and K5 set them as
// before: ReLU, or the chain input's skip without ReLU). No model calls
// it. At the decoder's (500, 8, 64) k3 reflect shape it does 98 MFLOP (1.5
// us at 67 TFLOP/s fp32) over 1.1-1.7 MB (0.3-0.5 us): bound by
// operations, like one half of K5.
//
// InstanceNorm statistics are two-pass per (sample, channel): the mean,
// then the mean of (x - mean)^2. No E[x^2] - mean^2, which cancels below
// zero on near-constant channels. There is no conv bias before the norm:
// the norm would remove it.
//
// The residual block at the model's shape, (L, C) = (8, 64), two k3 reflect-
// pad-1 convs (K1's three range-encoder blocks, fused_res_block's pallas_call
// :215, kernel _fwd_resblock_kernel :172; K5's three decoder blocks, :508,
// _fwd_adain_block_kernel :382), runs its own kernel (namespace res below),
// the range encoder's three stride-2 chains at the flagship's shapes theirs
// (namespace down, at the end of this file); every other shape (K8, other
// widths) runs the general kernel. At the residual block the general kernel took 27.3-28.2 us at batch 500 (H100), 9.5x its bound: 250
// blocks of 2 samples under the 48 KB default, each re-reading both convs'
// taps, and every output thread reading its taps from global memory (a float4
// for 4 multiply-adds). The res kernel:
// - both convs' taps sit in shared memory (2 x 48 KB, unpadded: a warp reads
//   64 contiguous bytes of a row), staged once a block as six bulk copies of
//   16 KB, each W1 tap on an mbarrier of its own, so conv 1 starts on tap 0
//   while the rest lands (6,144 cp.async copies of 16 B a block staged them
//   slower, and a cluster multicast of the copies slower still);
// - one persistent block a SM (256 threads) walks tiles of 4 whole samples,
//   or of 2 where tiles of 4 would leave more than half the SMs without one
//   (fused.res_fwd_plan: 125 blocks at batch 500, 128 at 256); x and the
//   mid-block activation sit in shared memory with their reflect halo rows
//   (rows of C + 4 floats, so a warp's 8 rows fall on distinct banks), so
//   every window is contiguous and unmasked;
// - the convs run on warps 0-3, a thread 1 row x 4 channels of every sample
//   of the tile, its operands loaded into registers one step ahead
//   (res_block.cuh's conv_tile: kTile + 4 float4 loads for 16 kTile
//   multiply-adds). The phase times read as if a 128-bit shared load costs
//   about 4 cycles of the SM's shared-memory pipe whatever its broadcast, so
//   at 4 samples an SM the loads, not the FMAs, set the pace: 1 x 4 of 2
//   samples a thread on all 8 warps was slower. Full fp32 FMAs, no TF32;
// - IN, K5's affine, the ReLU and the skip run in registers on K1's own two
//   lanes a row, on all 8 warps; y is written once, in contiguous float4s;
// - every sum in the general kernel's order (each conv output one fmaf chain
//   from 0 over t, then ci; the IN statistics two-pass on two lanes; the skip
//   one __fadd_rn, spelled out in both), so its output is the general
//   kernel's bit for bit, and K1b/K5b's recompute, which shares res_block.cuh,
//   is the forward's.
//
// The range chains (fused_in_pair's two sites, fused.py:361, kernel :318; and
// fused_dense_layer(norm='in')'s range stage, :1320, kernel :1186): range.pair0
// ((128, 1) k7 reflect -> (128, 4), k4 s2 -> (64, 8)), range.pair1 ((64, 8) ->
// (32, 16) -> (16, 32)) and range.single ((16, 32) -> (8, 64)). Bound on the
// H100 at batch 500: 0.38 us by bytes at pair0 (1.3 MB), 0.71 and 0.92 us by
// operations at pair1 and single (47.9 and 61.4 MFLOP at 67 TFLOP/s fp32). The
// general kernel took 9.35 / 13.28 / 11.50 us there (phase_times.py, H100):
// 250 blocks of 2 samples, and every output thread reading its taps from L2, a
// float4 for 4 multiply-adds. The down kernel, one template instance a site:
// - the pieces K1b's recompute runs (down_chain.cuh): the stages' taps staged
//   once a block by cp.async in rows of C_out + 4 floats, x and the mid-chain
//   activation with their zero (or reflect) pad rows, so every window is
//   contiguous and unmasked; each conv 4 output channels x every sample of the
//   tile a thread (tile + 4 shared float4 loads for 16 x tile multiply-adds);
//   the IN statistics and ReLU on norm_stage's rows and lanes;
// - one persistent block a SM (256 threads) walks tiles of 4 samples, or of 2
//   where tiles of 4 would leave more than half the SMs without one
//   (fused.res_fwd_plan), in 25-57 KB of shared memory; no transposed taps,
//   gradient buffers or partial rows (K1b's layout takes 66-93 KB);
// - the last stage's IN + ReLU runs in place, and y leaves in contiguous float4
//   rows;
// - every sum in the general kernel's order, so y is its bit for bit.
//
// K2 at its three call sites (fused_dense_layer(norm='none')'s pallas_call :1252): range.out (the
// range encoder's 1x1 out-conv, (8, 64) -> (8, 2)), env.in (the env encoder's k7 reflect-pad-3
// in-conv, (128, 1) -> (128, 16)) and dec.in (the decoder's 1x1 in-conv, (8, 2) -> (8, 64)).
// Bound on the H100 at batch 500 by bytes: 0.32 / 1.30 / 0.32 us (1.1 / 4.4 / 1.1 MB, y 4.1 MB
// of env.in's); their products are at most 7.2 M multiply-adds (env.in's, 0.21 us). The
// general kernel took 5.97 / 10.26 / 3.61 us there: 250 blocks of 2 samples, each thread's conv
// reading its taps through __ldg one step at a time (range.out: a 64-step chain of scalar tap
// loads on 32 busy threads of 256), env.in's windows through src_row's reflect branch. The cba
// kernel, one template instance a site (namespace cba, at the end of this file):
// - one persistent block a SM walks tiles of 4 samples, or of 2 where tiles of 4 would leave more
//   than half the SMs without one (fused.res_fwd_plan); the block has as many threads as its
//   tile has items (range.out one a (row, output channel): 64; env.in four (row, 4 channels)
//   items a thread: 512; dec.in two: 256), so no thread idles;
// - a thread loads its taps and bias into registers once (at most 64 floats), so no tap is
//   read inside a product;
// - the tile's x is staged by cp.async into shared memory (env.in's 3 reflect rows at each edge
//   copied from the rows they mirror, so every window is contiguous and unmasked; range.out's
//   rows C + 4 floats apart), the next tile's while the block works on this one;
// - y is written once, from registers, by streaming stores (st.global.cs): float4s of 4
//   channels (range.out's 2-channel rows as consecutive floats). Plain stores took env.in
//   4.51-4.60 us, streaming ones 3.13-3.31 (its 4.1 MB of y), dec.in 2.38-2.45 and 1.89-2.09
//   (H100; chip_smoke.py, phase_times.py);
// - every output one fmaf chain from 0 over t, then ci ascending, then + bias and ReLU, the
//   general kernel's order, so y is its bit for bit.
// It takes 2.35-2.44 / 3.13-3.31 / 1.89-1.94 us at batch 500 on the H100 (PERF.md), most of
// it the launch and one round trip for x.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "down_chain.cuh"
#include "res_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-5f;

struct Stage {
  int k, stride, pad, reflect;
  int l_in, c_in, l_out, c_out;
  int vec;  // 4: C_out % 4 == 0 and the taps are 16-byte aligned; else 1
};

// Input row read by tap t of output position l, or -1 for a zero pad.
__device__ __forceinline__ int src_row(const Stage& st, int l, int t) {
  int u = l * st.stride + t - st.pad;
  if (u < 0) return st.reflect ? -u : -1;
  if (u >= st.l_in) return st.reflect ? 2 * st.l_in - 2 - u : -1;
  return u;
}

// Output channels co..co+V-1 of position l; xs is one sample (L_in, C_in).
template <int V>
__device__ __forceinline__ void conv_points(const float* xs, const float* __restrict__ w,
                                            const Stage& st, int l, int co, float (&acc)[V]) {
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int t = 0; t < st.k; ++t) {
    const int u = src_row(st, l, t);
    if (u < 0) continue;
    const float* xr = xs + u * st.c_in;
    const float* wr = w + t * st.c_in * st.c_out + co;
#pragma unroll 4
    for (int ci = 0; ci < st.c_in; ++ci) {
      const float xv = xr[ci];
      if constexpr (V == 4) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + ci * st.c_out));
        acc[0] = fmaf(xv, wv.x, acc[0]);
        acc[1] = fmaf(xv, wv.y, acc[1]);
        acc[2] = fmaf(xv, wv.z, acc[2]);
        acc[3] = fmaf(xv, wv.w, acc[3]);
      } else {
        acc[0] = fmaf(xv, __ldg(wr + ci * st.c_out), acc[0]);
      }
    }
  }
}

// out (ns, L_out, C_out) = conv(in); thread item o owns V channels of one position.
template <int V>
__device__ void conv_stage(const float* in, const float* __restrict__ w, float* out,
                           const Stage& st, int ns) {
  const int groups = st.c_out / V, per = st.l_out * groups;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int l = r / groups, co = (r - l * groups) * V;
    float acc[V];
    conv_points<V>(in + s * st.l_in * st.c_in, w, st, l, co, acc);
    float* dst = out + (s * st.l_out + l) * st.c_out + co;
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = acc[v];
  }
}

// Lanes that share one (sample, channel) row of length l: about four
// elements a lane, a power of two <= 32 (so a group never spans warps).
__device__ __forceinline__ int norm_lanes(int l) {
  int g = 1;
  while (g < 32 && g * 4 < l) g *= 2;
  return g;
}

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// In place over y (ns, L, C): IN, then (kAdain) the per-sample affine
// g[s, c], b[s, c] of (ns, C) tables, then ReLU when `relu`, then + skip
// (same shape) when given.
template <bool kAdain>
__device__ void norm_stage(float* y, const float* skip, bool relu, int l, int c, int ns,
                           const float* __restrict__ g, const float* __restrict__ b) {
  const int lanes = norm_lanes(l), lane = threadIdx.x % lanes;
  const int slots = blockDim.x / lanes, pairs = ns * c;
  const float inv_l = 1.f / static_cast<float>(l);
  // every lane runs the same trip count, so the shuffles see full warps
  for (int base = 0; base < pairs; base += slots) {
    const int p = base + static_cast<int>(threadIdx.x) / lanes;
    const bool valid = p < pairs;
    const int s = valid ? p / c : 0, ch = valid ? p - s * c : 0;
    float* ys = y + s * l * c + ch;
    float sum = 0.f;
    if (valid)
      for (int i = lane; i < l; i += lanes) sum += ys[i * c];
    const float mean = group_sum(sum, lanes) * inv_l;
    float sq = 0.f;
    if (valid)
      for (int i = lane; i < l; i += lanes) {
        const float d = ys[i * c] - mean;
        sq = fmaf(d, d, sq);
      }
    const float rs = rsqrtf(group_sum(sq, lanes) * inv_l + kEps);
    if (valid) {
      const float* ks = skip ? skip + s * l * c + ch : nullptr;
      float ga = 1.f, be = 0.f;
      if constexpr (kAdain) {
        ga = __ldg(g + p);
        be = __ldg(b + p);
      }
      for (int i = lane; i < l; i += lanes) {
        float v = (ys[i * c] - mean) * rs;
        if constexpr (kAdain) v = fmaf(v, ga, be);
        if (relu) v = fmaxf(v, 0.f);
        ys[i * c] = ks ? __fadd_rn(v, ks[i * c]) : v;  // as res::res_block_kernel: no FMA
      }
    }
  }
}

// K5's per-sample affine tables, each (B, C); unused by K1.
struct Affine {
  const float *g1, *b1, *g2, *b2;
};

// Shared memory: a0 (spb, L0*C0) chain input, a1 (spb, L1*C1), a2 (spb, L2*C2).
// A first stage of two ends in a ReLU; the last stage ends in a ReLU when
// relu_last, then adds a0 (residual: two stages) or res (B, L_last,
// C_last) when given.
template <bool kAdain>
__global__ void __launch_bounds__(kThreads)
in_chain_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                const float* __restrict__ w2, float* __restrict__ y, int batch,
                Stage s1, Stage s2, int n_stages, int residual, int relu_last,
                const float* __restrict__ res, int spb, Affine af) {
  extern __shared__ float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int n0 = s1.l_in * s1.c_in, n1 = s1.l_out * s1.c_out;
  const int n2 = n_stages == 2 ? s2.l_out * s2.c_out : 0;
  float* a0 = smem;
  float* a1 = a0 + spb * n0;
  float* a2 = a1 + spb * n1;
  if constexpr (kAdain) {
    af.g1 += s0 * s1.c_out;
    af.b1 += s0 * s1.c_out;
    af.g2 += s0 * s2.c_out;
    af.b2 += s0 * s2.c_out;
  }

  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) a0[i] = xg[i];
  __syncthreads();

  const bool two = n_stages == 2;
  const int n_last = two ? n2 : n1;
  const float* skip = residual ? a0 : (res ? res + static_cast<size_t>(s0) * n_last : nullptr);
  conv_stage<4>(a0, w1, a1, s1, ns);
  __syncthreads();
  norm_stage<kAdain>(a1, two ? nullptr : skip, two || relu_last, s1.l_out, s1.c_out, ns, af.g1,
                     af.b1);
  __syncthreads();
  const float* last = a1;
  if (two) {
    conv_stage<4>(a1, w2, a2, s2, ns);
    __syncthreads();
    norm_stage<kAdain>(a2, skip, relu_last, s2.l_out, s2.c_out, ns, af.g2, af.b2);
    __syncthreads();
    last = a2;
  }
  float* yg = y + static_cast<size_t>(s0) * n_last;
  for (int i = threadIdx.x; i < ns * n_last; i += blockDim.x) yg[i] = last[i];
}

// K2's general kernel: one conv stage + per-channel bias + ReLU, written straight to y (every
// shape but the three call sites, which run namespace cba's kernel).
template <int V>
__global__ void __launch_bounds__(kThreads)
conv_bias_act_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ y, int batch,
                     Stage st, int spb) {
  extern __shared__ float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int n0 = st.l_in * st.c_in;
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) smem[i] = xg[i];
  __syncthreads();
  const int groups = st.c_out / V, per = st.l_out * groups;
  float* yg = y + static_cast<size_t>(s0) * st.l_out * st.c_out;
  for (int o = threadIdx.x; o < ns * per; o += blockDim.x) {
    const int s = o / per, r = o - s * per;
    const int l = r / groups, co = (r - l * groups) * V;
    float acc[V];
    conv_points<V>(smem + s * n0, w, st, l, co, acc);
    float* dst = yg + (s * st.l_out + l) * st.c_out + co;
#pragma unroll
    for (int v = 0; v < V; ++v) dst[v] = fmaxf(acc[v] + __ldg(b + co + v), 0.f);
  }
}

bool stage_ok(const Stage& st) {
  return st.k > 0 && st.stride > 0 && st.pad >= 0 && st.c_in > 0 && st.c_out > 0 &&
         st.l_out == (st.l_in + 2 * st.pad - st.k) / st.stride + 1 && st.l_out > 0 &&
         (!st.reflect || st.pad < st.l_in);
}

Stage make_stage(const int* p, const float* w) {
  Stage st{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], 1};
  if (st.c_out % 4 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0) st.vec = 4;
  return st;
}

constexpr size_t kMaxSmem = 48 * 1024;

// Validate a 1-2 stage chain (stage rows as iins_in_chain takes them) and launch it.
template <bool kAdain>
int launch_chain(const float* x, const float* w1, const float* w2, float* y, int batch,
                 const int* stages, int n_stages, int residual, int relu_last,
                 const float* res, int spb, Affine af, void* stream) {
  if (batch <= 0 || spb <= 0 || n_stages < 1 || n_stages > 2) return cudaErrorInvalidValue;
  const Stage s1 = make_stage(stages, w1);
  const Stage s2 = n_stages == 2 ? make_stage(stages + 8, w2) : Stage{};
  if (!stage_ok(s1) || s1.vec != 4) return cudaErrorInvalidValue;
  if (n_stages == 2 && (!stage_ok(s2) || s2.vec != 4 || s2.l_in != s1.l_out ||
                        s2.c_in != s1.c_out)) return cudaErrorInvalidValue;
  if (residual && (n_stages != 2 || s2.l_out != s1.l_in || s2.c_out != s1.c_in || res))
    return cudaErrorInvalidValue;
  const size_t per = static_cast<size_t>(s1.l_in) * s1.c_in + s1.l_out * s1.c_out +
                     (n_stages == 2 ? s2.l_out * s2.c_out : 0);
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  in_chain_kernel<kAdain><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w1, w2, y, batch, s1, s2, n_stages, residual, relu_last, res, spb, af);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---------------------------------------------------------------------------
// The residual block's path: K1's residual block (IN) and K5 (AdaIN) at the model's shape,
// (L, C) = (8, 64), both convs k3, stride 1, reflect pad 1 (res_block.cuh).
namespace res {

constexpr int kThreads = 256;
constexpr int kTapFloats = kC * kC;  // one tap's (C, C) taps

// Floats of a block's shared memory at tiles of kTile samples: both convs' taps (unpadded), x
// and y1 with their halo rows, the conv output, and four mbarriers.
template <int kTile>
constexpr int smem_floats() {
  return 6 * kTapFloats + kTile * (2 * kH + kL) * kLd + 8;
}

// One persistent block a SM walks tiles of kTile samples (tile b, b + grid, ...). Per tile:
//   (1) z = conv(x, W1)               warps 0-3: 1 row x 4 channels x the kTile samples a thread
//   (2) y1 = relu(IN(z) [* g1 + b1])  all 8 warps: a (sample, channel) row a thread pair
//   (3) z = conv(y1, W2)              warps 0-3
//   (4) z = IN(z) [* g2 + b2] + x, in place
//   (5) y = z, in contiguous float4s.
// The taps arrive as six bulk copies, one a tap, each W1 tap on a barrier of its own: (1)
// starts on tap 0 while taps 1-2 land, W2 lands behind (1) and (2). The last stage's sum is
// __fadd_rn(v, x), as the general kernel's norm_stage spells it, so neither may contract it
// into an FMA and both give the same bits.
template <bool kAdain, int kTile>
__global__ void __launch_bounds__(kThreads, 1)
res_block_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                 const float* __restrict__ w2, float* __restrict__ y, int batch, int n_tiles,
                 Affine af) {
  constexpr int kPairs = kThreads / 2;            // thread pairs
  constexpr int kPasses = kTile * kC / kPairs;    // norm rows a thread pair
  static_assert(kL == 8 && kThreads == 256 && (kTile == 2 || kTile == 4), "res layouts");
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                  // (t, ci, co), rows of C floats
  float* w2s = w1s + 3 * kTapFloats;
  float* xs = w2s + 3 * kTapFloats;   // x with halo rows
  float* y1 = xs + kTile * kH * kLd;  // y1 with halo rows
  float* z = y1 + kTile * kH * kLd;   // z1, then z2, then y
  // bars[t]: W1's tap t; bars[3]: W2
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(z + kTile * kL * kLd);
  const int pr = threadIdx.x >> 1, par = threadIdx.x & 1;
  const bool conv = threadIdx.x < 128;  // warps 0-3

  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(bars + i);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the taps, a bulk copy a tap
    for (int t = 0; t < 3; ++t) mbar_expect_tx(bars + t, kTapFloats * 4);
    mbar_expect_tx(bars + 3, 3 * kTapFloats * 4);
    for (int t = 0; t < 6; ++t)
      bulk_copy(w1s + t * kTapFloats, t < 3 ? w1 + t * kTapFloats : w2 + (t - 3) * kTapFloats,
                kTapFloats * 4, bars + (t < 3 ? t : 3));
  }
  int tile = blockIdx.x;
  stage_halo<kTile, kThreads>(x, tile * kTile, min(kTile, batch - tile * kTile), xs);
  cp_async_commit();
  for (bool first = true; tile < n_tiles; tile += gridDim.x, first = false) {
    const int s0 = tile * kTile, ns = min(kTile, batch - s0);
    // the thread pair's rows: pass j holds (sample sn[j], channel cn[j]); K5's tables of them,
    // loaded ahead of the norms
    int sn[kPasses], cn[kPasses];
    float ga1[kPasses], be1[kPasses], ga2[kPasses], be2[kPasses];
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int p = pr + j * kPairs;
      sn[j] = p / kC;
      cn[j] = p % kC;
      if constexpr (kAdain) {
        const bool real = sn[j] < ns;
        const size_t tab = static_cast<size_t>(s0 + (real ? sn[j] : 0)) * kC + cn[j];
        ga1[j] = real ? __ldg(af.g1 + tab) : 0.f;
        be1[j] = real ? __ldg(af.b1 + tab) : 0.f;
        ga2[j] = real ? __ldg(af.g2 + tab) : 0.f;
        be2[j] = real ? __ldg(af.b2 + tab) : 0.f;
      }
    }
    if (!first) {
      __syncthreads();  // the last tile's reads of xs and z are done
      stage_halo<kTile, kThreads>(x, s0, ns, xs);
      cp_async_wait_all();
      __syncthreads();
    }
    // (1) on warps 0-3; the first tile tap by tap, the other warps at the same barriers
    const auto tap = [&](int t) {
      if (first) {
        if (t == 0) {
          cp_async_wait<0>();
          __syncthreads();
        }
        mbar_wait(bars + t);
      }
    };
    if (conv)
      conv_tile<kTile, true, kC>(xs, w1s, z, tap);
    else
      for (int t = 0; t < 3; ++t) tap(t);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {  // (2); row 1's lane also writes its copy above the
      // sample, row L-2's lane below it
      const RowNorm n = row_norm(z + (sn[j] * kL + par) * kLd + cn[j]);
#pragma unroll
      for (int k = 0; k < kL / 2; ++k) {
        float v = n.yh[k];
        if constexpr (kAdain) v = fmaf(v, ga1[j], be1[j]);
        v = fmaxf(v, 0.f);
        const int l = par + 2 * k;
        float* dst = y1 + (sn[j] * kH + l + 1) * kLd + cn[j];
        *dst = v;
        if (l == 1) dst[-2 * kLd] = v;
        if (l == kL - 2) dst[2 * kLd] = v;
      }
    }
    if (first) mbar_wait(bars + 3);
    __syncthreads();
    if (conv) conv_tile<kTile, true, kC>(y1, w2s, z, [](int) {});  // (3)
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {  // (4)
      float* zs = z + (sn[j] * kL + par) * kLd + cn[j];
      const float* xr = xs + (sn[j] * kH + par + 1) * kLd + cn[j];
      const RowNorm n = row_norm(zs);
#pragma unroll
      for (int k = 0; k < kL / 2; ++k) {
        float v = n.yh[k];
        if constexpr (kAdain) v = fmaf(v, ga2[j], be2[j]);
        zs[2 * k * kLd] = __fadd_rn(v, xr[2 * k * kLd]);
      }
    }
    __syncthreads();
    float* yg = y + static_cast<size_t>(s0) * kL * kC;  // (5)
    for (int i = threadIdx.x; i < ns * kL * kC / 4; i += kThreads) {
      const int r = i / (kC / 4), c = (i - r * (kC / 4)) * 4;
      *reinterpret_cast<float4*>(yg + r * kC + c) = lds4(z + r * kLd + c);
    }
  }
}

int smem_set[2][2] = {};

template <bool kAdain, int kTile>
int launch_tile(const float* x, const float* w1, const float* w2, float* y, int batch,
                int n_tiles, int grid, Affine af, cudaStream_t s) {
  constexpr int smem = smem_floats<kTile>() * static_cast<int>(sizeof(float));
  const int err =
      allow_smem(res_block_kernel<kAdain, kTile>, smem, &smem_set[kAdain][kTile == 4]);
  if (err) return err;
  res_block_kernel<kAdain, kTile><<<grid, kThreads, smem, s>>>(x, w1, w2, y, batch, n_tiles, af);
  return static_cast<int>(cudaGetLastError());
}

template <bool kAdain>
int launch(const float* x, const float* w1, const float* w2, float* y, int batch, int l, int c,
           int tile, int grid, int smem, Affine af, void* stream) {
  if (batch <= 0 || l != kL || c != kC || (tile != 2 && tile != 4)) return cudaErrorInvalidValue;
  const int n_tiles = (batch + tile - 1) / tile;
  const int want = (tile == 4 ? smem_floats<4>() : smem_floats<2>()) * sizeof(float);
  if (grid < 1 || grid > n_tiles || smem != want) return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w1),
                        static_cast<const void*>(w2), static_cast<const void*>(y)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 4 ? launch_tile<kAdain, 4>(x, w1, w2, y, batch, n_tiles, grid, af, s)
                   : launch_tile<kAdain, 2>(x, w1, w2, y, batch, n_tiles, grid, af, s);
}

}  // namespace res

// ---------------------------------------------------------------------------
// The range encoder's stride-2 chains at the flagship's shapes (down_chain.cuh: range.pair0,
// range.pair1, range.single), every stage conv -> IN -> ReLU, on the pieces K1b's recompute runs.
namespace down {

// A block's shared memory at tiles of NS samples: each stage's taps (rows of C_out + 4 floats),
// then for the tile x with its pad rows, z1 (between two unused rows) and, with two stages, y1
// (stage 2's input with its zero pad rows) and z2; each region a multiple of 4 floats.
template <class C, int NS>
struct Fwd {
  using S1 = typename C::S1;
  using S2 = typename C::S2;
  static constexpr int kW2s = S1::WFloats;
  static constexpr int kXs = kW2s + (C::kTwo ? S2::WFloats : 0);
  static constexpr int kZ1 = kXs + NS * S1::XS;
  static constexpr int kY1 = kZ1 + NS * S1::ZS;
  static constexpr int kZ2 = kY1 + (C::kTwo ? NS * S2::XS : 0);
  static constexpr int kFloats = kZ2 + (C::kTwo ? NS * S2::ZS : 0);
  static constexpr int kSmemBytes = kFloats * static_cast<int>(sizeof(float));
  static_assert(kW2s % 4 == 0 && kXs % 4 == 0 && kZ1 % 4 == 0 && kY1 % 4 == 0 && kZ2 % 4 == 0,
                "16-byte regions");
  static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
};

// In place over z (a stage's conv output rows): z <- relu(IN(z)), norm_stage's rows, lanes and
// arithmetic (the statistics read the whole row before any lane writes it).
template <class T>
__device__ void norm_relu_rows(float* z, int ns) {
  for_rows(T::LO, T::CO, ns, [&](int, int s, int ch, bool valid, int lane, int lanes) {
    float* zs = z + s * T::ZS + T::LdZ + ch;
    float mean, rs;
    row_stats(zs, T::LO, T::LdZ, valid, lane, lanes, mean, rs);
    if (!valid) return;
    for (int i = lane; i < T::LO; i += lanes)
      zs[i * T::LdZ] = fmaxf((zs[i * T::LdZ] - mean) * rs, 0.f);
  });
}

// One persistent block a SM walks tiles of NS samples (tile b, b + grid, ...), every stage's
// taps staged once a block by cp.async. Per tile, from x staged with its pad rows:
//   (1) z1 = conv(x, W1)       two stages: (2) y1 = relu(IN(z1)) into stage 2's padded input,
//                                          (3) z2 = conv(y1, W2)
//   (4) z = relu(IN(z)) of the last stage, in place; (5) y out in contiguous float4 rows.
// The convs run a thread (output row, 4 channels) for the tile's NS samples, each output one
// fmaf chain over t, then ci ascending, as the general kernel sums it; the norms on its lanes:
// y is the general kernel's bit for bit, and K1b's recompute (the same functions) sees it.
template <class C, int NS>
__global__ void __launch_bounds__(kThreads, 1)
down_chain_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                  const float* __restrict__ w2, float* __restrict__ y, int batch, int n_tiles) {
  using L = Fwd<C, NS>;
  using S1 = typename C::S1;
  using S2 = typename C::S2;
  constexpr int kLO = C::kTwo ? S2::LO : S1::LO, kCO = C::kTwo ? S2::CO : S1::CO;
  constexpr int kLdZ = kCO + 4, kZS = (kLO + 2) * kLdZ, kQ = kCO / 4;
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm;
  float* w2s = sm + L::kW2s;
  float* xs = sm + L::kXs;
  float* z1 = sm + L::kZ1;
  float* y1 = sm + L::kY1;
  float* z2 = sm + L::kZ2;
  float* zl = C::kTwo ? z2 : z1;  // the last stage's output
  if constexpr (C::kTwo)  // y1's pad rows stay zero: no phase writes them
    for (int i = threadIdx.x; i < NS * S2::XS; i += kThreads) y1[i] = 0.f;
  stage_taps<S1>(w1, w1s);
  if constexpr (C::kTwo) stage_taps<S2>(w2, w2s);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int s0 = tile * NS, ns = min(NS, batch - s0);
    __syncthreads();  // the last tile's reads of xs and zl are done
    stage_input<S1, NS>(x, s0, ns, xs);
    cp_async_wait_all();
    __syncthreads();
    conv_fwd<S1, NS>(xs, w1s, z1);  // (1)
    __syncthreads();
    if constexpr (C::kTwo) {
      norm_relu<S1, S2>(z1, y1, ns);  // (2)
      __syncthreads();
      conv_fwd<S2, NS>(y1, w2s, z2);  // (3)
      __syncthreads();
    }
    norm_relu_rows<typename std::conditional<C::kTwo, S2, S1>::type>(zl, ns);  // (4)
    __syncthreads();
    float* yg = y + static_cast<size_t>(s0) * kLO * kCO;  // (5)
    for (int i = threadIdx.x; i < ns * kLO * kQ; i += kThreads) {
      const int r = i / kQ, c = (i - r * kQ) * 4, s = r / kLO, l = r - s * kLO;
      *reinterpret_cast<float4*>(yg + r * kCO + c) = lds4(zl + s * kZS + (1 + l) * kLdZ + c);
    }
  }
}

int smem_set[3][2] = {};

template <class C, int NS>
int launch_tile(const float* x, const float* w1, const float* w2, float* y, int batch,
                int n_tiles, int grid, cudaStream_t s) {
  constexpr int smem = Fwd<C, NS>::kSmemBytes;
  const int err = allow_smem(down_chain_kernel<C, NS>, smem, &smem_set[C::kId][NS == 4]);
  if (err) return err;
  down_chain_kernel<C, NS><<<grid, kThreads, smem, s>>>(x, w1, w2, y, batch, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <class C>
int launch(const float* x, const float* w1, const float* w2, float* y, int batch, int tile,
           int grid, int smem, void* stream) {
  if (batch <= 0 || (tile != 2 && tile != 4)) return cudaErrorInvalidValue;
  const int n_tiles = (batch + tile - 1) / tile;
  const int want = tile == 4 ? Fwd<C, 4>::kSmemBytes : Fwd<C, 2>::kSmemBytes;
  if (grid < 1 || grid > n_tiles || smem != want) return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w1),
                        static_cast<const void*>(w2), static_cast<const void*>(y)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 4 ? launch_tile<C, 4>(x, w1, w2, y, batch, n_tiles, grid, s)
                   : launch_tile<C, 2>(x, w1, w2, y, batch, n_tiles, grid, s);
}

}  // namespace down

// ---------------------------------------------------------------------------
// K2 at its three call sites (fused.CBA_SITES, the rows K2b's site kernel takes), one template
// instance each, the shapes fixed at compile time: range.out (1x1, (8, 64) -> (8, 2)), env.in (k7
// reflect pad 3, (128, 1) -> (128, 16)) and dec.in (1x1, (8, 2) -> (8, 64)); stride 1.
namespace cba {

// (site id, k, pad, reflect, l_in, c_in, c_out, output items a thread)
template <int kId_, int K_, int P_, bool R_, int LI_, int CI_, int CO_, int Per_>
struct CbaSite {
  static constexpr int kId = kId_, K = K_, P = P_, LI = LI_, CI = CI_, CO = CO_, Per = Per_;
  static constexpr bool R = R_;
  static constexpr int LO = LI + 2 * P - K + 1;
  // a thread item: V output channels of one row, the item's group G of them in a row
  static constexpr int V = CO % 4 ? 1 : 4, G = CO / V;
  // a sample's x in shared memory with its pad rows: row u (-P <= u < LI + P) at kXa + u * kLd,
  // rows of kLd floats (C_in + 4 where C_in is a multiple of 4, so that the 4 rows a quarter-
  // warp reads fall on distinct banks), the data rows 16-byte aligned, a sample XS floats
  static constexpr int kLd = CI % 4 ? CI : CI + 4;
  static constexpr int kXa = (P * kLd + 3) / 4 * 4, XS = (kXa + (LI + P) * kLd + 3) / 4 * 4;
  static_assert(LO == LI, "stride-1 'same' convs");
  static_assert(P == 0 || (R && CI == 1 && K == 2 * P + 1), "a padded site is env.in's");
  static_assert(kLd != CI || (LI * CI) % 4 == 0, "a sample's rows in 16-byte copies");
};

using RangeOut = CbaSite<0, 1, 0, false, 8, 64, 2, 1>;
using EnvIn = CbaSite<1, 7, 3, true, 128, 1, 16, 4>;
using DecIn = CbaSite<2, 1, 0, false, 8, 2, 64, 2>;

// A block at tiles of NS samples: a thread each Per items, two buffers of the tile's x.
template <class T, int NS>
struct Layout {
  static constexpr int kThreads = NS * T::LO * T::G / T::Per;
  static constexpr int kBuf = NS * T::XS;
  static constexpr int kSmemBytes = 2 * kBuf * static_cast<int>(sizeof(float));
  static_assert((NS * T::LO * T::G) % T::Per == 0 && kThreads % T::G == 0 && kThreads % 32 == 0 &&
                    kThreads <= 1024, "a block's threads");
  static_assert(kSmemBytes <= 48 * 1024, "under the default shared memory");
};

// y out, as a streaming store (st.global.cs: y is read once, by the next kernel); phase_times.py's
// "products" cut guards it by a condition no launch meets.
template <class V>
__device__ __forceinline__ void put(V* p, V v) { __stcs(p, v); }

// The tile's samples s0 .. s0+ns-1 of x into buffer b by cp.async (env.in's reflect rows copied
// from the rows they mirror, so every window is contiguous); the samples past the batch zero.
template <class T, int NS>
__device__ __forceinline__ void stage_x(const float* __restrict__ x, int s0, int ns, float* b) {
  constexpr int kThreads = Layout<T, NS>::kThreads;
  if constexpr (T::kLd == T::CI) {  // a sample's rows contiguous, as in x
    constexpr int kQ = T::LI * T::CI / 4;
    for (int i = threadIdx.x; i < NS * kQ; i += kThreads) {
      const int s = i / kQ, q = i - s * kQ;
      const bool ok = s < ns;
      cp_async16(b + s * T::XS + T::kXa + 4 * q,
                 x + static_cast<size_t>(s0 + (ok ? s : 0)) * T::LI * T::CI + 4 * q, ok);
    }
  } else {  // rows of C_in floats into rows of kLd
    constexpr int kQ = T::CI / 4;
    for (int i = threadIdx.x; i < NS * T::LI * kQ; i += kThreads) {
      const int r = i / kQ, q = i - r * kQ, s = r / T::LI;
      const bool ok = s < ns;
      cp_async16(b + s * T::XS + T::kXa + (r - s * T::LI) * T::kLd + 4 * q,
                 x + (static_cast<size_t>(s0) * T::LI + (ok ? r : 0)) * T::CI + 4 * q, ok);
    }
  }
  if constexpr (T::P > 0)
    for (int i = threadIdx.x; i < NS * 2 * T::P; i += kThreads) {
      const int s = i / (2 * T::P), j = i - s * 2 * T::P;
      const int u = j < T::P ? j - T::P : T::LI + j - T::P;  // rows -P .. -1 and L .. L+P-1
      const int src = u < 0 ? -u : 2 * T::LI - 2 - u;
      const bool ok = s < ns;
      cp_async4(b + s * T::XS + T::kXa + u,
                x + static_cast<size_t>(s0 + (ok ? s : 0)) * T::LI + src, ok);
    }
}

// One persistent block a SM walks tiles of NS samples (tile b, b + grid, ...), the next tile's
// x in flight (cp.async, two buffers) while it works on this one. A thread holds its taps and
// bias in registers, loaded once; each of its Per items (a row's V output channels, the
// thread's group of them fixed) is one fmaf chain an output from 0 over t, then ci ascending,
// then + bias and ReLU: the general kernel's order (conv_points), so y is its bit for bit.
template <class T, int NS>
__global__ void __launch_bounds__(Layout<T, NS>::kThreads)
cba_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ b, float* __restrict__ y, int batch, int n_tiles) {
  using L = Layout<T, NS>;
  constexpr int K = T::K, CI = T::CI, V = T::V;
  extern __shared__ __align__(16) float sm[];
  int tile = blockIdx.x;
  stage_x<T, NS>(x, tile * NS, min(NS, batch - tile * NS), sm);
  cp_async_commit();
  const int cg = threadIdx.x % T::G;  // the thread's channels cg * V .. cg * V + V - 1
  float wr[K * CI * V], br[V];
#pragma unroll
  for (int j = 0; j < K * CI; ++j) {
    if constexpr (V == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(w + j * T::CO) + cg);
      wr[4 * j] = q.x, wr[4 * j + 1] = q.y, wr[4 * j + 2] = q.z, wr[4 * j + 3] = q.w;
    } else {
      wr[j] = __ldg(w + j * T::CO + cg);
    }
  }
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(b) + cg);
    br[0] = q.x, br[1] = q.y, br[2] = q.z, br[3] = q.w;
  } else {
    br[0] = __ldg(b + cg);
  }
  for (int buf = 0; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int s0 = tile * NS, ns = min(NS, batch - s0), next = tile + gridDim.x;
    if (next < n_tiles)
      stage_x<T, NS>(x, next * NS, min(NS, batch - next * NS), sm + (buf ^ 1) * L::kBuf);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)
    __syncthreads();
    const float* xs = sm + buf * L::kBuf;
#pragma unroll
    for (int k = 0; k < T::Per; ++k) {
      const int r = (static_cast<int>(threadIdx.x) + k * L::kThreads) / T::G;  // the tile's row
      if (r < ns * T::LO) {
        const int s = r / T::LO, l = r - s * T::LO;
        const float* xr = xs + s * T::XS + T::kXa + (l - T::P) * T::kLd;  // the window's first row
        float acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
        for (int t = 0; t < K; ++t) {
          if constexpr (CI % 4 == 0) {
#pragma unroll
            for (int ci = 0; ci < CI; ci += 4) {
              const float4 q = res::lds4(xr + t * T::kLd + ci);
              const float xv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
              for (int c = 0; c < 4; ++c)
#pragma unroll
                for (int v = 0; v < V; ++v)
                  acc[v] = fmaf(xv[c], wr[((t * CI) + ci + c) * V + v], acc[v]);
            }
          } else {
#pragma unroll
            for (int ci = 0; ci < CI; ++ci) {
              const float xv = xr[t * T::kLd + ci];
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] = fmaf(xv, wr[(t * CI + ci) * V + v], acc[v]);
            }
          }
        }
        float* dst = y + (static_cast<size_t>(s0) * T::LO + r) * T::CO + cg * V;
        if constexpr (V == 4)
          put(reinterpret_cast<float4*>(dst),
              make_float4(fmaxf(acc[0] + br[0], 0.f), fmaxf(acc[1] + br[1], 0.f),
                          fmaxf(acc[2] + br[2], 0.f), fmaxf(acc[3] + br[3], 0.f)));
        else
          put(dst, fmaxf(acc[0] + br[0], 0.f));
      }
    }
    __syncthreads();  // the buffer is read before it is staged again
  }
  cp_async_wait<0>();
}

template <class T, int NS>
int launch_tile(const float* x, const float* w, const float* b, float* y, int batch, int n_tiles,
                int grid, cudaStream_t s) {
  using L = Layout<T, NS>;
  cba_fwd_kernel<T, NS><<<grid, L::kThreads, L::kSmemBytes, s>>>(x, w, b, y, batch, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const float* x, const float* w, const float* b, float* y, int batch, int tile,
           int grid, int smem, void* stream) {
  if (batch <= 0 || (tile != 2 && tile != 4)) return cudaErrorInvalidValue;
  const int n_tiles = (batch + tile - 1) / tile;
  const int want = tile == 4 ? Layout<T, 4>::kSmemBytes : Layout<T, 2>::kSmemBytes;
  if (grid < 1 || grid > n_tiles || smem != want) return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w),
                        static_cast<const void*>(b), static_cast<const void*>(y)})
    if (reinterpret_cast<std::uintptr_t>(p) % 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return tile == 4 ? launch_tile<T, 4>(x, w, b, y, batch, n_tiles, grid, s)
                   : launch_tile<T, 2>(x, w, b, y, batch, n_tiles, grid, s);
}

}  // namespace cba

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// stages: n_stages rows of (k, stride, pad, reflect, l_in, c_in, l_out, c_out).
int iins_in_chain(const float* x, const float* w1, const float* w2, float* y, int batch,
                  const int* stages, int n_stages, int residual, int spb, void* stream) {
  return launch_chain<false>(x, w1, w2, y, batch, stages, n_stages, residual, !residual,
                             nullptr, spb, Affine{}, stream);
}

// K5: x, y (B, L, C); w1, w2 (3, C, C), reflect pad 1; g1, b1, g2, b2 (B, C).
int iins_adain_res_block(const float* x, const float* w1, const float* w2, const float* g1,
                         const float* b1, const float* g2, const float* b2, float* y,
                         int batch, int l, int c, int spb, void* stream) {
  const int stages[16] = {3, 1, 1, 1, l, c, l, c, 3, 1, 1, 1, l, c, l, c};
  if (!g1 || !b1 || !g2 || !b2) return cudaErrorInvalidValue;
  return launch_chain<true>(x, w1, w2, y, batch, stages, 2, 1, 0, nullptr, spb,
                            Affine{g1, b1, g2, b2}, stream);
}

// K8: x (B, l_in, c_in) -> y (B, l, c); stage (k, stride, pad, reflect,
// l_in, c_in, l, c); w (k, c_in, c); g, b (B, c); res (B, l, c), added
// after the activation, or null; relu 1 (ReLU) or 0 (none).
int iins_adain_layer(const float* x, const float* w, const float* g, const float* b,
                     const float* res, float* y, int batch, const int* stage, int relu,
                     int spb, void* stream) {
  if (!g || !b) return cudaErrorInvalidValue;
  return launch_chain<true>(x, w, w, y, batch, stage, 1, 0, relu != 0, res, spb,
                            Affine{g, b, nullptr, nullptr}, stream);
}

// K1's residual block (IN: every table null) or K5 (AdaIN) at (l, c) = (8, 64) on the
// residual block's own path: x, y (B, 8, 64); w1, w2 (3, 64, 64), reflect pad 1; K5's tables
// g1, b1, g2, b2 (B, 64). tile (2 or 4 samples), grid (the persistent blocks, 1 ..
// ceil(B / tile)) and smem (a block's dynamic shared memory) as fused.res_fwd_plan and
// RES_FWD_SMEM give them; the launch refuses any other.
int iins_res_block(const float* x, const float* w1, const float* w2, const float* g1,
                   const float* b1, const float* g2, const float* b2, float* y, int batch, int l,
                   int c, int tile, int grid, int smem, void* stream) {
  if (!g1 && !b1 && !g2 && !b2)
    return res::launch<false>(x, w1, w2, y, batch, l, c, tile, grid, smem, Affine{}, stream);
  if (!g1 || !b1 || !g2 || !b2) return cudaErrorInvalidValue;
  return res::launch<true>(x, w1, w2, y, batch, l, c, tile, grid, smem, Affine{g1, b1, g2, b2},
                           stream);
}

// K1 at the range encoder's stride-2 chains on their own path: site 0 range.pair0, 1
// range.pair1, 2 range.single (down_chain.cuh). x (B, l_in, c_in); w1, w2 the stages' taps (w2
// unused at site 2); y (B, l_out, c_out) of the chain output. tile (2 or 4 samples), grid (the
// persistent blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared memory) as
// fused.res_fwd_plan and DOWN_FWD_SMEM give them; the launch refuses any other.
int iins_down_chain(const float* x, const float* w1, const float* w2, float* y, int batch,
                    int site, int tile, int grid, int smem, void* stream) {
  switch (site) {
    case 0:
      return down::launch<down::Pair0>(x, w1, w2, y, batch, tile, grid, smem, stream);
    case 1:
      return down::launch<down::Pair1>(x, w1, w2, y, batch, tile, grid, smem, stream);
    case 2:
      return down::launch<down::Single>(x, w1, w1, y, batch, tile, grid, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// stage: (k, stride, pad, reflect, l_in, c_in, l_out, c_out).
int iins_conv_bias_act(const float* x, const float* w, const float* b, float* y, int batch,
                       const int* stage, int spb, void* stream) {
  if (batch <= 0 || spb <= 0) return cudaErrorInvalidValue;
  const Stage st = make_stage(stage, w);
  if (!stage_ok(st)) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(st.l_in) * st.c_in * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (st.vec == 4) {
    conv_bias_act_kernel<4><<<grid, kThreads, smem, s>>>(x, w, b, y, batch, st, spb);
  } else {
    conv_bias_act_kernel<1><<<grid, kThreads, smem, s>>>(x, w, b, y, batch, st, spb);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 at its three call sites on their own path: site 0 range.out, 1 env.in, 2 dec.in (shapes at
// the top of namespace cba). x (B, l_in, c_in), w (k, c_in, c_out), b (c_out), y (B, l_out,
// c_out), all 16-byte aligned. tile (2 or 4 samples), grid (the persistent blocks, 1 ..
// ceil(B / tile)) and smem (a block's dynamic shared memory) as fused.res_fwd_plan and
// CBA_FWD_SMEM give them; the launch refuses any other.
int iins_cba_fwd(const float* x, const float* w, const float* b, float* y, int batch, int site,
                 int tile, int grid, int smem, void* stream) {
  switch (site) {
    case 0:
      return cba::launch<cba::RangeOut>(x, w, b, y, batch, tile, grid, smem, stream);
    case 1:
      return cba::launch<cba::EnvIn>(x, w, b, y, batch, tile, grid, smem, stream);
    case 2:
      return cba::launch<cba::DecIn>(x, w, b, y, batch, tile, grid, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
