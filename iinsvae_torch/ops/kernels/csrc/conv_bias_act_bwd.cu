// K2b conv_bias_act_bwd: the backward of y = relu(conv1d(x, taps) + bias),
// K2's function.
//
// Replaces the backward of fused_dense_layer(norm='none')
// (iinsvae_tpu/ops/pallas/fused.py:1268, kernel _bwd_nonorm_kernel :150):
// dx, d(taps) and dbias. The Pallas body returns the gradient of the dense
// conv matrix; this kernel computes the composed path's gradient of the
// (k, C_in, C_out) taps directly. The ReLU mask comes from the saved output
// (y > 0, fused.py:158); a stride-2 zero pad scatters to l*s - p + t, a
// reflect pad folds the edge rows back (conv_bwd_common.cuh).
//
// Two paths. The three call sites of a 1-D training step (range.out, the range
// encoder's 1x1 out-conv; env.in, the env encoder's k7 reflect in-conv, no dx;
// dec.in, the decoder's 1x1 in-conv) run their own kernel (namespace site
// below); every other conv runs the general kernel: a block stages its tile
// of samples' x and gz = g * (y > 0) in shared memory, writes dx of its
// samples, and its partial sums of d(taps) and dbias to its row of a (grid,
// n) buffer; a second kernel sums the rows in order (deterministic: no
// atomics).
//
// Bound on the H100 at batch 500: all three sites by bytes, 2.1 MB at
// range.out (x and dx, 1 MB each) and dec.in (g and y), 0.63 us at 3.35 TB/s,
// and 8.4 MB at env.in (g and y, 4 MB each; 2.52 us); their products are at
// most 3.6 M multiply-adds. The general kernel took 13.49 / 32.48 / 13.77 us there
// (phase_times.py, H100): 250 blocks of 2 samples; 6.5-6.8 us in the second
// kernel, one block whose threads each add the 250 partial rows one after
// another; at env.in 18.2 us in the d(taps) partials, one thread a (t, ci,
// co) cell on a serial chain over every (sample, row) of its block, 112 of
// 256 threads busy.
//
// The sites' kernel (site), one template instance a site, the shapes fixed at
// compile time:
// - one persistent block a SM (256 threads) walks tiles of 4 samples; a
//   tile's x (with env.in's reflect rows copied from the rows they mirror, so
//   every window is contiguous), g and y are staged by cp.async into one of
//   two buffers while the block works on the other, and gz is formed in place
//   once;
// - d(taps) and dbias sit in registers over all the block's tiles: every
//   thread has a cell of (ci, 4 output channels, or range.out's 2) and every
//   tap, the threads that share a cell each over every Reps-th (sample, row),
//   a cell's lanes in a warp added by a shuffle tree and its warps in order;
// - dx (the 1x1 sites) from taps held in registers: range.out a float2 of gz
//   to 4 input channels a thread, dec.in 8 threads a row, their 8-channel
//   partial sums added by a shuffle tree;
// - a block writes one partial row (at most 132), and the last block to
//   finish (a ticket in device memory that wraps back to 0, after a
//   __threadfence) sums the rows in block order: one launch a call, no value
//   added atomically, bit-equal over two calls.
#include "async_smem.cuh"
#include "conv_bwd_common.cuh"

namespace {

using namespace iins;

template <int V>
__global__ void __launch_bounds__(kThreads)
conv_bias_act_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ y, const float* __restrict__ g,
                         float* __restrict__ dx, float* __restrict__ part, int batch, Stage st,
                         int spb) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int n_in = st.l_in * st.c_in, n_out = st.l_out * st.c_out;
  const int in_stride = (n_in + 3) & ~3;  // keeps gz's rows 16-byte aligned
  float* xs = smem;
  float* gz = xs + spb * in_stride;
  const float* xg = x + static_cast<size_t>(s0) * n_in;
  for (int i = threadIdx.x; i < ns * n_in; i += blockDim.x) {
    const int s = i / n_in;
    xs[s * in_stride + (i - s * n_in)] = xg[i];
  }
  const size_t o0 = static_cast<size_t>(s0) * n_out;
  for (int i = threadIdx.x; i < ns * n_out; i += blockDim.x)
    gz[i] = __ldg(y + o0 + i) > 0.f ? __ldg(g + o0 + i) : 0.f;
  __syncthreads();

  float* mine = part + static_cast<size_t>(blockIdx.x) * (st.k * st.c_in * st.c_out + st.c_out);
  taps_grad_partial(xs, in_stride, gz, n_out, st, ns, mine);
  bias_grad_partial(gz, n_out, st.l_out, st.c_out, ns, mine + st.k * st.c_in * st.c_out);
  if (dx)
    conv_input_grad<V>(gz, n_out, w, st, ns, dx + static_cast<size_t>(s0) * n_in, n_in,
                       nullptr, 0);
}

}  // namespace

// ---------------------------------------------------------------------------
// K2b at its three call sites in a 1-D training step, one template instance each, the shapes
// fixed at compile time: range.out (1x1, (8, 64) -> (8, 2), dx), env.in (k7 reflect pad 3,
// (128, 1) -> (128, 16), no dx: it reads the pooled CIR) and dec.in (1x1, (8, 2) -> (8, 64),
// dx). Stride 1 at all three.
namespace site {

using iins::aligned16;

constexpr int kThreads = 256;
constexpr int kTile = 4;  // samples a tile

template <int kId_, int K_, int P_, bool R_, int LI_, int CI_, int CO_, bool kDx_>
struct Site {
  static constexpr int kId = kId_, K = K_, P = P_, LI = LI_, CI = CI_, CO = CO_;
  static constexpr bool R = R_, kDx = kDx_;
  static constexpr int LO = LI + 2 * P - K + 1;
  // a sample's x with its pad rows: padded row v at kXa + (v - P) * CI, the data rows 16-byte
  // aligned; g, y and gz NO floats a sample
  static constexpr int kXa = (P * CI + 3) / 4 * 4, XS = (kXa + (LI + P) * CI + 3) / 4 * 4;
  static constexpr int NO = LO * CO;
  // one of the two tile buffers: x, gz (g, masked in place), y
  static constexpr int kG = kTile * XS, kY = kG + kTile * NO, kBuf = kY + kTile * NO;
  static constexpr int kSmemBytes = 2 * kBuf * static_cast<int>(sizeof(float));
  // d(taps) in registers: cells of (ci, V output channels) and every tap, Reps threads a cell
  // over interleaved (sample, row)s; the threads of cell (0, co) also sum dbias
  static constexpr int V = CO % 4 == 0 ? 4 : CO;
  static constexpr int Cells = CI * CO / V, Reps = kThreads / Cells;
  static constexpr int kWarpReps = Cells < 32 ? 32 / Cells : 1;  // a cell's lanes in a warp
  static constexpr int kBlockReps = Reps / kWarpReps;
  static constexpr int NTaps = K * CI * CO, kN = NTaps + CO, kRow = (kN + 3) / 4 * 4;
  static_assert(V == 4 || (V == 2 && CO == 2), "output channels a cell");
  static_assert(kThreads % Cells == 0 && (Cells % 32 == 0 || 32 % Cells == 0), "cells");
  static_assert(P == 0 || (R && CI == 1 && K == 2 * P + 1), "a padded site is env.in's");
  static_assert(!kDx || (K == 1 && P == 0), "dx at the 1x1 sites");
  static_assert(NO % 4 == 0 && (LI * CI) % 4 == 0 && kBuf % 4 == 0, "16-byte rows");
  static_assert(kBlockReps * kN <= 2 * kBuf && kThreads * 4 <= 2 * kBuf, "scratch fits");
  static_assert(kSmemBytes <= 227 * 1024, "a block's shared memory");
};

using RangeOut = Site<0, 1, 0, false, 8, 64, 2, true>;
using EnvIn = Site<1, 7, 3, true, 128, 1, 16, false>;
using DecIn = Site<2, 1, 0, false, 8, 2, 64, true>;

// The blocks that have written their partial rows, per site; the last block of a launch sets it
// back to 0 (atomicInc wraps at the grid), so it needs no reset between launches. One launch of
// a site at a time (the port runs on one stream).
__device__ unsigned int g_done[3];

// The tile's samples s0 .. s0+ns-1 into buffer b by cp.async: x with its pad rows (the reflect
// rows copied from the rows they mirror), g and y; the samples past the batch are zero.
template <class T>
__device__ void stage_tile(const float* __restrict__ x, const float* __restrict__ g,
                           const float* __restrict__ y, int s0, int ns, float* b) {
  constexpr int kXq = T::LI * T::CI / 4, kOq = T::NO / 4;
  for (int i = threadIdx.x; i < kTile * kXq; i += kThreads) {
    const int s = i / kXq, q = i - s * kXq;
    const bool ok = s < ns;
    cp_async16(b + s * T::XS + T::kXa + 4 * q,
               x + static_cast<size_t>(s0 + (ok ? s : 0)) * T::LI * T::CI + 4 * q, ok);
  }
  if constexpr (T::P > 0)
    for (int i = threadIdx.x; i < kTile * 2 * T::P; i += kThreads) {
      const int s = i / (2 * T::P), j = i - s * 2 * T::P;
      const int v = j < T::P ? j : T::LI + j;  // padded rows 0 .. P-1 and L+P .. L+2P-1
      const int u = v - T::P < 0 ? T::P - v : 2 * T::LI - 2 - (v - T::P);
      const bool ok = s < ns;
      cp_async4(b + s * T::XS + T::kXa + (v - T::P),
                x + static_cast<size_t>(s0 + (ok ? s : 0)) * T::LI + u, ok);
    }
  for (int i = threadIdx.x; i < kTile * kOq; i += kThreads) {
    const bool ok = i / kOq < ns;
    const size_t src = static_cast<size_t>(s0) * T::NO + (ok ? 4 * i : 0);
    cp_async16(b + T::kG + 4 * i, g + src, ok);
    cp_async16(b + T::kY + 4 * i, y + src, ok);
  }
}

// acc[t][v] += sum over the tile's (sample, row)s p = rep, rep + Reps, ... of
// x[s, l + t - P, ci] * gz[s, l, co + v] (x read through its pad rows: the reflect fold is in
// the staging), and bacc[v] += gz[s, l, co + v].
template <class T>
__device__ __forceinline__ void taps_grad(const float* b, int ns, int rep, int ci, int co,
                                          float (&acc)[T::K][T::V], float (&bacc)[T::V]) {
  for (int p = rep; p < ns * T::LO; p += T::Reps) {
    const int s = p / T::LO, l = p - s * T::LO;
    const float* gp = b + T::kG + s * T::NO + l * T::CO + co;
    float gv[T::V];
    if constexpr (T::V == 4) {
      const float4 q = *reinterpret_cast<const float4*>(gp);
      gv[0] = q.x, gv[1] = q.y, gv[2] = q.z, gv[3] = q.w;
    } else {
      const float2 q = *reinterpret_cast<const float2*>(gp);
      gv[0] = q.x, gv[1] = q.y;
    }
    const float* xr = b + s * T::XS + T::kXa + (l - T::P) * T::CI + ci;
#pragma unroll
    for (int t = 0; t < T::K; ++t) {
      const float xv = xr[t * T::CI];
#pragma unroll
      for (int v = 0; v < T::V; ++v) acc[t][v] = fmaf(xv, gv[v], acc[t][v]);
    }
#pragma unroll
    for (int v = 0; v < T::V; ++v) bacc[v] += gv[v];
  }
}

// dx of a 1x1 conv, dx[s, l, ci] = sum_co gz[s, l, co] * w[ci, co], written to global memory.
// range.out (C_out 2): a thread 4 input channels of every 16th row, its 4 x 2 taps in
// registers, one float2 of gz a row. dec.in (C_in 2): 8 threads a row, each 8 output channels
// and its 2 x 8 taps in registers, the partial sums added by a shuffle tree.
template <class T>
__device__ __forceinline__ void input_grad(const float* b, const float* __restrict__ w,
                                           float* __restrict__ dx, int ns) {
  const float* gz = b + T::kG;
  if constexpr (T::CO == 2) {
    constexpr int kQ = T::CI / 4, kStep = kThreads / kQ;
    static_assert(T::CI % 4 == 0 && kThreads % kQ == 0, "dx lanes");
    const int q = threadIdx.x % kQ;
    const float4 wa = __ldg(reinterpret_cast<const float4*>(w) + 2 * q);
    const float4 wb = __ldg(reinterpret_cast<const float4*>(w) + 2 * q + 1);
    for (int r = threadIdx.x / kQ; r < ns * T::LO; r += kStep) {
      const float2 gv = *reinterpret_cast<const float2*>(gz + r * 2);
      float4 o;
      o.x = fmaf(gv.y, wa.y, fmaf(gv.x, wa.x, 0.f));
      o.y = fmaf(gv.y, wa.w, fmaf(gv.x, wa.z, 0.f));
      o.z = fmaf(gv.y, wb.y, fmaf(gv.x, wb.x, 0.f));
      o.w = fmaf(gv.y, wb.w, fmaf(gv.x, wb.z, 0.f));
      *reinterpret_cast<float4*>(dx + r * T::CI + 4 * q) = o;
    }
  } else {
    constexpr int kC = T::CO / 8;  // output channels a thread
    static_assert(T::CI == 2 && T::CO % 32 == 0 && kTile * T::LO * 8 == kThreads, "dx lanes");
    const int k = threadIdx.x & 7, r = threadIdx.x >> 3;
    float w0[kC], w1[kC], a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      w0[c] = __ldg(w + k * kC + c);
      w1[c] = __ldg(w + T::CO + k * kC + c);
    }
    const float* gr = gz + r * T::CO + k * kC;
#pragma unroll
    for (int c = 0; c < kC; c += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(gr + c);
      a0 = fmaf(gv.x, w0[c], a0), a1 = fmaf(gv.x, w1[c], a1);
      a0 = fmaf(gv.y, w0[c + 1], a0), a1 = fmaf(gv.y, w1[c + 1], a1);
      a0 = fmaf(gv.z, w0[c + 2], a0), a1 = fmaf(gv.z, w1[c + 2], a1);
      a0 = fmaf(gv.w, w0[c + 3], a0), a1 = fmaf(gv.w, w1[c + 3], a1);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, off);
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    }
    if (k == 0 && r < ns * T::LO) *reinterpret_cast<float2*>(dx + r * 2) = make_float2(a0, a1);
  }
}

// One persistent block a SM walks tiles of kTile samples (tile b, b + grid, ...), the next
// tile's x, g and y in flight (cp.async, two buffers) while it works on this one:
//   (1) gz = g * (y > 0) in place, once;
//   (2) d(taps) and dbias into the thread's registers, kept over all the block's tiles;
//   (3) dx, where asked.
// Then the block's partial row (the cell's lanes added by a shuffle tree, then the warps in
// order), and the last block to finish sums the grid's rows in block order into dwb: one launch
// a call, no value added atomically, bit-equal over two calls.
template <class T>
__global__ void __launch_bounds__(kThreads, 1)
cba_site_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ y, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ part, float* __restrict__ dwb,
                    int batch, int n_tiles) {
  extern __shared__ __align__(16) float sm[];
  __shared__ bool last;
  const int cell = threadIdx.x % T::Cells, rep = threadIdx.x / T::Cells;
  const int ci = cell % T::CI, co = cell / T::CI * T::V;
  float acc[T::K][T::V] = {}, bacc[T::V] = {};
  int buf = 0, tile = blockIdx.x;
  if (tile < n_tiles) stage_tile<T>(x, g, y, tile * kTile, min(kTile, batch - tile * kTile), sm);
  cp_async_commit();
  for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
    const int s0 = tile * kTile, ns = min(kTile, batch - s0), next = tile + gridDim.x;
    float* b = sm + buf * T::kBuf;
    if (next < n_tiles)
      stage_tile<T>(x, g, y, next * kTile, min(kTile, batch - next * kTile),
                    sm + (buf ^ 1) * T::kBuf);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)
    __syncthreads();
    for (int i = threadIdx.x; i < kTile * T::NO / 4; i += kThreads) {  // (1)
      float4* gq = reinterpret_cast<float4*>(b + T::kG) + i;
      const float4 yv = reinterpret_cast<const float4*>(b + T::kY)[i], gv = *gq;
      *gq = make_float4(yv.x > 0.f ? gv.x : 0.f, yv.y > 0.f ? gv.y : 0.f,
                        yv.z > 0.f ? gv.z : 0.f, yv.w > 0.f ? gv.w : 0.f);
    }
    __syncthreads();
    taps_grad<T>(b, ns, rep, ci, co, acc, bacc);  // (2)
    if constexpr (T::kDx)
      if (dx) input_grad<T>(b, w, dx + static_cast<size_t>(s0) * T::LI * T::CI, ns);  // (3)
    __syncthreads();  // b is read before it is staged again
  }
  cp_async_wait<0>();

  // the block's partial row: a cell's lanes in a warp by a shuffle tree, then its warps in order
  if constexpr (T::kWarpReps > 1) {
#pragma unroll
    for (int off = T::Cells; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < T::V; ++v) {
#pragma unroll
        for (int t = 0; t < T::K; ++t) acc[t][v] += __shfl_xor_sync(0xffffffffu, acc[t][v], off);
        bacc[v] += __shfl_xor_sync(0xffffffffu, bacc[v], off);
      }
  }
  const int brep = rep / T::kWarpReps;
  if (rep % T::kWarpReps == 0) {
    float* scr = sm + brep * T::kN;
#pragma unroll
    for (int t = 0; t < T::K; ++t)
#pragma unroll
      for (int v = 0; v < T::V; ++v) scr[(t * T::CI + ci) * T::CO + co + v] = acc[t][v];
    if (ci == 0)
#pragma unroll
      for (int v = 0; v < T::V; ++v) scr[T::NTaps + co + v] = bacc[v];
  }
  __syncthreads();
  float* row = part + static_cast<size_t>(blockIdx.x) * T::kRow;
  for (int e = threadIdx.x; e < T::kRow; e += kThreads) {
    float v = 0.f;
    if (e < T::kN) {
      v = sm[e];
      for (int r = 1; r < T::kBlockReps; ++r) v += sm[r * T::kN + e];
    }
    row[e] = v;
  }

  // the last block to finish sums the rows, block 0 first: row group rg of a column of float4s
  // takes the rows rg, rg + kRG, ..., kIn of them loaded before any is added, then the groups
  // are added in order
  __syncthreads();  // the row is written; thread 0's fence makes it visible before the ticket
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicInc(&g_done[T::kId], gridDim.x - 1) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  constexpr int kQ = T::kRow / 4, kRG = kThreads / kQ, kIn = 16;
  float4* red = reinterpret_cast<float4*>(sm);
  if (threadIdx.x < kRG * kQ) {
    const int c = threadIdx.x % kQ, rg = threadIdx.x / kQ, grid = gridDim.x;
    const float4* col = reinterpret_cast<const float4*>(part) + c;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p0 = rg; p0 < grid; p0 += kIn * kRG) {
      float4 v[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        const int p = p0 + k * kRG;
        v[k] = p < grid ? __ldcg(col + static_cast<size_t>(p) * kQ)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kIn; ++k) s.x += v[k].x, s.y += v[k].y, s.z += v[k].z, s.w += v[k].w;
    }
    red[rg * kQ + c] = s;
  }
  __syncthreads();
  if (threadIdx.x < kQ) {
    float4 s = red[threadIdx.x];
    for (int rg = 1; rg < kRG; ++rg) {
      const float4 v = red[rg * kQ + threadIdx.x];
      s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
    }
    const float o[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * threadIdx.x + j < T::kN) dwb[4 * threadIdx.x + j] = o[j];
  }
}

int smem_set[3] = {0, 0, 0};

template <class T>
int launch(const float* x, const float* w, const float* y, const float* g, float* dx,
           float* part, float* dwb, int batch, int tile, int grid, int smem, void* stream) {
  const int n_tiles = batch > 0 ? (batch + kTile - 1) / kTile : 0;
  if (batch <= 0 || tile != kTile || grid < 1 || grid > n_tiles || smem != T::kSmemBytes ||
      (dx && !T::kDx) || !dwb)
    return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w),
                        static_cast<const void*>(y), static_cast<const void*>(g),
                        static_cast<const void*>(dx), static_cast<const void*>(part)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  int err = allow_smem(cba_site_bwd_kernel<T>, smem, &smem_set[T::kId]);
  if (err) return err;
  cba_site_bwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, y, g, dx, part, dwb, batch, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace site

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// stage: (k, stride, pad, reflect, l_in, c_in, l_out, c_out); x (B, l_in,
// c_in), y and g (B, l_out, c_out); dx (B, l_in, c_in) or null; part
// (ceil(B / spb), k*c_in*c_out + c_out) scratch; dwb (k*c_in*c_out + c_out):
// d(taps) then dbias.
int iins_conv_bias_act_bwd(const float* x, const float* w, const float* y, const float* g,
                           float* dx, float* part, float* dwb, int batch, const int* stage,
                           int spb, void* stream) {
  if (batch <= 0 || spb <= 0) return cudaErrorInvalidValue;
  const Stage st = make_stage(stage);
  if (!stage_ok(st)) return cudaErrorInvalidValue;
  const size_t per = ((st.l_in * st.c_in + 3) & ~3) + static_cast<size_t>(st.l_out) * st.c_out;
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (st.c_out % 4 == 0 && aligned16(w)) {
    conv_bias_act_bwd_kernel<4><<<grid, kThreads, smem, s>>>(x, w, y, g, dx, part, batch, st,
                                                             spb);
  } else {
    conv_bias_act_bwd_kernel<1><<<grid, kThreads, smem, s>>>(x, w, y, g, dx, part, batch, st,
                                                             spb);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, st.k * st.c_in * st.c_out + st.c_out, dwb, s);
}

// K2b at its three call sites on their own path: site 0 range.out, 1 env.in, 2 dec.in (shapes
// at the top of namespace site). x (B, l_in, c_in), w (k, c_in, c_out), y and g (B, l_out,
// c_out); dx (B, l_in, c_in) or null (always null at site 1). tile (samples a tile), grid (the
// persistent blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared memory) as
// backward.cba_bwd_plan and CBA_SMEM give them; the launch refuses any other. part (grid,
// CBA_ROW floats) scratch; dwb (k*c_in*c_out + c_out): d(taps) then dbias.
int iins_cba_site_bwd(const float* x, const float* w, const float* y, const float* g, float* dx,
                      float* part, float* dwb, int batch, int site, int tile, int grid, int smem,
                      void* stream) {
  switch (site) {
    case 0:
      return site::launch<site::RangeOut>(x, w, y, g, dx, part, dwb, batch, tile, grid, smem,
                                          stream);
    case 1:
      return site::launch<site::EnvIn>(x, w, y, g, dx, part, dwb, batch, tile, grid, smem,
                                       stream);
    case 2:
      return site::launch<site::DecIn>(x, w, y, g, dx, part, dwb, batch, tile, grid, smem,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
