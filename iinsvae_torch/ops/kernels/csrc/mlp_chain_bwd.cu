// K4b mlp_chain_bwd: the backward of K4's Dense + LeakyReLU chain,
// y_{j+1} = leaky(d_j, slope_j), d_j = y_j @ W_j + b_j.
//
// Replaces the backward of fused_mlp_chain (iinsvae_tpu/ops/pallas/fused.py:1136,
// kernel _bwd_mlp_kernel :1087): dx, dW_j and db_j of the restorer head
// 16->512->256->256->1, the 2-D restorer 128->512->256->256->1 and the classifier
// 16->16->32->16->5. As there, the forward saved each layer's pre-activation d_j (K4
// writes them under autograd), so nothing is recomputed; the LeakyReLU mask is
// where(d > 0, g, slope * g) (fused.py:1102). GD_j is layer j's masked gradient, and
// the weight gradient dW_j = Y_j^T GD_j, db_j = 1^T GD_j (row D_j of the extended
// (D_j + 1) x D_{j+1} output), Y_0 = x, Y_j = leaky(d_{j-1}).
//
// Bound on the H100: at batch 500 the restorer's backward does 2 x 102 M
// multiply-adds (g @ W^T and the weight gradients, the forward's 102 M each) =
// 0.41 GFLOP, 6.1 us at 67 TFLOP/s fp32 (the 2-D restorer 7.8 us); it moves ~3 MB
// (x, the saved d_j, the weights in and their gradients out): bound by operations.
// The classifier is latency whatever it does.
//
// The kernel this replaces carried 4 samples a block through the whole chain, so each
// of 125 blocks read all of W (820 KB for the restorer) and at the 512->256 and
// 256->256 layers a warp's 32 lanes read 32 rows of W 1-2 KB apart (a 32-byte sector
// for every 4-byte weight); its weight gradient walked the batch in 16 chunks of 32
// rows, each a global round trip with nothing in flight. Here every block issues all
// of its copies at once (cp.async) and computes from shared memory. Two paths:
// - small heads (every width <= 64, the classifier): one block a tile of 8 samples
//   stages all the weights (transposed, so a warp reads 32 inputs) and its rows of x,
//   g and the d_j, runs the whole chain in shared memory (each sum as four interleaved
//   partial sums) and writes its rows' share of every weight gradient as one partial
//   row; a second kernel sums the partial rows in order. Two launches a call.
// - the restorers: one launch a layer, from the last to the first, a product tiled
//   over the card: GD_{j-1} = mask_{j-1}(GD_j W_j^T) (dx = GD_0 W_0^T at j = 0) in
//   tiles of 32 samples x 64 inputs (x 16 for layers of at most 16 inputs, or where 64
//   would leave half the card idle), both panels staged whole (rows of depth + 4
//   floats); the block's 4 groups of 128 threads split the depth, each thread 4 x 4
//   (or 4 x 1) outputs in registers (per 4 steps of depth 8 float4 loads for 64
//   multiply-adds), and the groups' sums are added in order. The first launch masks g
//   as it lands and keeps GD_{n-1}; an epilogue issues all its loads of the next
//   layer's mask before its stores. Then one launch of every layer's weight gradient
//   in tiles of 32 x 64 outputs over fixed chunks of at most 128 samples (4 chunks at
//   batch 500: 3.3 MB of partials for the restorer), the block's 4 groups a quarter of
//   the chunk each, each thread 4 x 4 outputs (per sample 2 float4 loads for 16
//   multiply-adds), and the chunks' sum in order. Launches a call: one a layer (n, or
//   n - 1 without dx), the weight gradient and the sum.
// Deterministic: no atomics, every sum in a fixed order, so two runs give bit-equal
// gradients. Full fp32 FMAs, no TF32.
//
// Both paths also have a bfloat16 instance (iins_mlp_chain_bwd_bf16), K4b under
// --compute_dtype bfloat16 as the Pallas body computes it on bfloat16 refs (fused.py:
// 1087-1106): g, x, the weights and the saved d_j are read as bfloat16 and upcast where they
// are staged (by plain loads: cp.async cannot convert), so the layers' inputs are recomputed
// from the rounded d_j; GD_j, the partial rows and every sum stay fp32; dx and each dW_j, db_j
// are rounded to bfloat16 once, on store (the TPU kernel stores them in its refs' dtype).
// Plain version: backward.mlp_chain_bwd_bf16_ref.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "async_smem.cuh"
#include "conv_bwd_common.cuh"

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 4096;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ float leaky(float v, float slope) { return v > 0.f ? v : slope * v; }

using bf16 = __nv_bfloat16;

// A value of the storage type T (float, or bfloat16 for the bfloat16 instance) as fp32, and
// back, rounded to the nearest.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) return v; else return __float2bfloat16_rn(v);
}

// One value from global memory to dst (shared) as fp32, or 0 where !valid: cp.async for
// float32, a load for bfloat16.
__device__ __forceinline__ void stage_one(float* dst, const float* src, bool valid) {
  cp_async4(dst, src, valid);
}
__device__ __forceinline__ void stage_one(float* dst, const bf16* src, bool valid) {
  *dst = valid ? to_f32(*src) : 0.f;
}

// ---------------------------------------------------------------------------
// Small heads: the whole chain a block of 8 samples.
namespace small {

constexpr int kRows = 8, kThreads = 256, kMaxWidth = 64;

template <class T>
struct Args {
  const T* w[kMaxLayers];
  const T* d[kMaxLayers];
  float slope[kMaxLayers];
  int dims[kMaxLayers + 1];
  int w_off[kMaxLayers], d_off[kMaxLayers], gd_off[kMaxLayers];  // in shared memory
  int x_off, g_off, floats;
  int e_off[kMaxLayers + 1];  // layer j's extended gradient in a partial row; e_off[n] = total
  int n;
};

// The block's rows of a (B, width) array to dst, a value a copy; rows past the batch zero.
template <class T>
__device__ void stage_rows(float* dst, const T* __restrict__ src, int width, int r0, int nr) {
  for (int e = threadIdx.x; e < kRows * width; e += kThreads) {
    const bool ok = e / width < nr;
    stage_one(dst + e, src + (ok ? static_cast<size_t>(r0) * width + e : 0), ok);
  }
}

// T: the storage type of g, x, dx, the weights and the d_j.
template <class T>
__global__ void __launch_bounds__(kThreads)
small_kernel(const T* __restrict__ g, const T* __restrict__ x, T* __restrict__ dx,
             float* __restrict__ part, int batch, Args<T> a) {
  extern __shared__ __align__(16) float sm[];
  const int r0 = blockIdx.x * kRows, nr = min(kRows, batch - r0), n = a.n;
  for (int j = 0; j < n; ++j)  // W_j transposed, (D_{j+1}, D_j): a warp reads 32 inputs i
    for (int e = threadIdx.x; e < a.dims[j] * a.dims[j + 1]; e += kThreads) {
      const int i = e / a.dims[j + 1], k = e - i * a.dims[j + 1];
      stage_one(sm + a.w_off[j] + k * a.dims[j] + i, a.w[j] + e, true);
    }
  stage_rows(sm + a.x_off, x, a.dims[0], r0, nr);
  stage_rows(sm + a.g_off, g, a.dims[n], r0, nr);
  for (int j = 0; j < n; ++j) stage_rows(sm + a.d_off[j], a.d[j], a.dims[j + 1], r0, nr);
  cp_async_wait_all();
  __syncthreads();
  for (int e = threadIdx.x; e < nr * a.dims[n]; e += kThreads)  // GD_{n-1} = mask(g)
    sm[a.gd_off[n - 1] + e] = sm[a.d_off[n - 1] + e] > 0.f ? sm[a.g_off + e]
                                                            : a.slope[n - 1] * sm[a.g_off + e];
  __syncthreads();
  // the chain: GD_{j-1} = mask_{j-1}(GD_j W_j^T), dx = GD_0 W_0^T; each sum as four
  // interleaved partial sums over k (k mod 4), added in order
  for (int j = n - 1; j >= 0; --j) {
    if (j == 0 && !dx) break;
    const int din = a.dims[j], dout = a.dims[j + 1];
    const float* wt = sm + a.w_off[j];
    const float* gd = sm + a.gd_off[j];
    for (int e = threadIdx.x; e < nr * din; e += kThreads) {
      const int r = e / din, i = e - r * din;
      const float* gr = gd + r * dout;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
      int k = 0;
      for (; k + 4 <= dout; k += 4) {
        p0 = fmaf(gr[k], wt[k * din + i], p0);
        p1 = fmaf(gr[k + 1], wt[(k + 1) * din + i], p1);
        p2 = fmaf(gr[k + 2], wt[(k + 2) * din + i], p2);
        p3 = fmaf(gr[k + 3], wt[(k + 3) * din + i], p3);
      }
      for (; k < dout; ++k) p0 = fmaf(gr[k], wt[k * din + i], p0);
      const float acc = (p0 + p1) + (p2 + p3);
      if (j > 0)
        sm[a.gd_off[j - 1] + e] = sm[a.d_off[j - 1] + e] > 0.f ? acc : a.slope[j - 1] * acc;
      else
        dx[static_cast<size_t>(r0) * din + e] = from_f32<T>(acc);
    }
    __syncthreads();
  }
  // the block's rows' share of every extended weight gradient, summed over its rows in order
  float* row = part + static_cast<size_t>(blockIdx.x) * a.e_off[n];
  for (int j = 0; j < n; ++j) {
    const int din = a.dims[j], dout = a.dims[j + 1];
    const float* y = sm + (j ? a.d_off[j - 1] : a.x_off);
    const float ys = j ? a.slope[j - 1] : 1.f;
    const float* gd = sm + a.gd_off[j];
    for (int e = threadIdx.x; e < (din + 1) * dout; e += kThreads) {
      const int i = e / dout, k = e - i * dout;
      float acc = 0.f;
      for (int r = 0; r < nr; ++r)
        acc = fmaf(i < din ? leaky(y[r * din + i], ys) : 1.f, gd[r * dout + k], acc);
      row[a.e_off[j] + e] = acc;
    }
  }
}

int smem_set[2] = {0, 0};  // the float32 and bfloat16 instances'

}  // namespace small

// ---------------------------------------------------------------------------
// The restorers: one launch a layer's chain product, then every layer's weight gradient.
namespace layer {

constexpr int kThreads = 128;  // 8 x 16 threads, 4 x 4 outputs each
constexpr int kTM = 32;        // chain: samples a tile; weight gradient: inputs a tile
constexpr int kTN = 64;        // chain: inputs a tile; weight gradient: outputs a tile
constexpr int kTK = 32;        // a copy group: depth (chain), samples (weight gradient)
constexpr int kGroups = 4;  // thread groups of a block, each a share of the depth or samples
constexpr int kChainThreads = kGroups * kThreads;
constexpr int kChunkRows = kGroups * kTK;  // the most samples a weight-gradient chunk holds
constexpr int kLdY = kTM + 4, kLdG = kTN + 4;
constexpr int kWgradSmem = kChunkRows * (kLdY + kLdG) * static_cast<int>(sizeof(float));
static_assert(kChunkRows * (kLdY + kLdG) >= (kGroups - 1) * 16 * kThreads,
              "the groups' sums fit where the rows were");
static_assert(kThreads == 8 * 16 && kTM == 4 * 8 && kTN == 4 * 16, "thread layouts");

// 4 values from global memory to dst (shared, 16-byte aligned) as fp32, or zeros where !valid:
// one cp.async for float32, an 8-byte load for bfloat16.
__device__ __forceinline__ void stage_four(float* dst, const float* src, bool valid) {
  cp_async16(dst, src, valid);
}
__device__ __forceinline__ void stage_four(float* dst, const bf16* src, bool valid) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (valid) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
    const bf16* h = reinterpret_cast<const bf16*>(&u);
    v = make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
  }
  *reinterpret_cast<float4*>(dst) = v;
}

// Panel rows [row0, row0 + nrows) of a (N, width) matrix, depth columns [c0, c0 + kTK), into
// dst (rows ld floats apart, column c0 at dst + c0) by the block's threads, as fp32: 4 values a
// copy where width % 4 == 0, else one; past nvalid rows or the width, zero.
template <class T>
__device__ void stage(float* dst, int ld, const T* __restrict__ src, int row0, int nvalid,
                      int nrows, int width, int c0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < nrows * kTK / 4; e += kChainThreads) {
      const int r = e / (kTK / 4), k = c0 + (e % (kTK / 4)) * 4;
      const bool ok = r < nvalid && k < width;
      stage_four(dst + r * ld + k, src + (ok ? static_cast<size_t>(row0 + r) * width + k : 0),
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * kTK; e += kChainThreads) {
      const int r = e / kTK, k = c0 + e % kTK;
      const bool ok = r < nvalid && k < width;
      stage_one(dst + r * ld + k, src + (ok ? static_cast<size_t>(row0 + r) * width + k : 0),
                ok);
    }
  }
}

// fn(r, k, count) over the elements this thread copied in stage(..., c0, vec).
template <class Fn>
__device__ void for_own(int nrows, int c0, bool vec, Fn fn) {
  const int per = vec ? kTK / 4 : kTK, w = vec ? 4 : 1;
  for (int e = threadIdx.x; e < nrows * per; e += kChainThreads)
    fn(e / per, c0 + (e % per) * w, w);
}

// A chain launch; the first of a call (mask_in, the head's last layer) masks g as it stages it
// and keeps GD_j (column tile 0) for the weight gradient.
template <class T>
struct Chain {
  const T* g;           // mask_in: g (B, dout)
  const float* gd;      // else GD_j (B, dout)
  const T* d;           // mask_in: d_j
  float* gd_out;        // mask_in: GD_j kept here
  const T* w;           // W_j (din, dout)
  float* out;           // GD_{j-1} (B, din), or null
  T* dx;                // j = 0: dx (B, din), or null
  const T* d_prev;      // d_{j-1} for GD_{j-1}'s mask; null for dx
  float slope, slope_prev;
  int din, dout, batch, n_ci, ldk, mask_in, vec;
};

// Chain tile: out[r, i] = sum_k GD_j[r, k] W_j[i, k] for 32 samples r x 16 NT inputs i (NT = 1
// for layers of at most 16 inputs, else 4). The block's kGroups groups of 128 threads split the
// depth (group q takes the chunks q, q + kGroups, ...), thread (ty, tx) of a group the samples
// ty + 8m and inputs tx + 16n; the groups' sums are added in order.
template <class T, int NT>
__global__ void __launch_bounds__(kChainThreads) chain_kernel(Chain<T> a) {
  constexpr int kTNt = 16 * NT;
  extern __shared__ __align__(16) float sm[];
  float* sa = sm;                 // [kTM][ldk]: GD_j rows
  float* sb = sa + kTM * a.ldk;   // [kTNt][ldk]: W_j rows
  float* sd = sb + kTNt * a.ldk;  // [kTM][ldk]: mask_in's d_j rows
  const int t = blockIdx.x, r0 = (t / a.n_ci) * kTM, i0 = (t % a.n_ci) * kTNt;
  const int nrow = min(kTM, a.batch - r0), ncol = min(kTNt, a.din - i0);
  const int chunks = (a.dout + kTK - 1) / kTK, me = threadIdx.x;
  for (int c = 0; c < chunks; ++c) {
    if (a.mask_in)
      stage(sa, a.ldk, a.g, r0, nrow, kTM, a.dout, c * kTK, a.vec);
    else
      stage(sa, a.ldk, a.gd, r0, nrow, kTM, a.dout, c * kTK, a.vec);
    if (a.mask_in) stage(sd, a.ldk, a.d, r0, nrow, kTM, a.dout, c * kTK, a.vec);
    stage(sb, a.ldk, a.w, i0, ncol, kTNt, a.dout, c * kTK, a.vec);
  }
  cp_async_wait_all();
  if (a.mask_in)  // this thread's own copies of g: GD_j = mask(g), kept by column tile 0
    for (int c = 0; c < chunks; ++c)
      for_own(kTM, c * kTK, a.vec, [&](int r, int k, int cnt) {
        for (int v = 0; v < cnt; ++v) {
          if (r >= nrow || k + v >= a.dout) continue;
          float* p = sa + r * a.ldk + k + v;
          *p = sd[r * a.ldk + k + v] > 0.f ? *p : a.slope * *p;
          if (i0 == 0) a.gd_out[static_cast<size_t>(r0 + r) * a.dout + k + v] = *p;
        }
      });
  __syncthreads();
  const int q = me / kThreads, tid = me % kThreads, ty = tid / 16, tx = tid % 16;
  float acc[4][NT] = {};
  for (int c = q; c < chunks; c += kGroups) {
#pragma unroll
    for (int kk = 0; kk < kTK; kk += 4) {
      float4 av[4], bv[NT];
#pragma unroll
      for (int m = 0; m < 4; ++m) av[m] = lds4(sa + (ty + 8 * m) * a.ldk + c * kTK + kk);
#pragma unroll
      for (int n = 0; n < NT; ++n) bv[n] = lds4(sb + (tx + 16 * n) * a.ldk + c * kTK + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
            acc[m][n] = fmaf(lane4(av[m], j), lane4(bv[n], j), acc[m][n]);
    }
  }
  __syncthreads();  // the panels are read; groups 1.. leave their sums where they were
  if (q > 0)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n) sm[((q - 1) * 16 + 4 * m + n) * kThreads + tid] = acc[m][n];
  __syncthreads();
  if (q > 0 || !(a.out || a.dx)) return;
  // the next layer's mask: all its loads before any store (out may alias d_prev for the
  // compiler, which would otherwise wait out each load's round trip in turn)
  float dp[4][NT];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int r = r0 + ty + 8 * m, i = i0 + tx + 16 * n;
      dp[m][n] = a.d_prev && r < a.batch && i < a.din
                     ? to_f32(__ldg(a.d_prev + static_cast<size_t>(r) * a.din + i)) : 1.f;
    }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = r0 + ty + 8 * m;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float v = acc[m][n];
      for (int p = 1; p < kGroups; ++p) v += sm[((p - 1) * 16 + 4 * m + n) * kThreads + tid];
      const int i = i0 + tx + 16 * n;
      if (r >= a.batch || i >= a.din) continue;
      const float o = dp[m][n] > 0.f ? v : a.slope_prev * v;
      if (a.dx)
        a.dx[static_cast<size_t>(r) * a.din + i] = from_f32<T>(o);
      else
        a.out[static_cast<size_t>(r) * a.din + i] = o;
    }
  }
}

template <class T>
struct Wgrad {
  const T* y[kMaxLayers];       // x, or d_{j-1}
  const float* gd[kMaxLayers];  // GD_j
  float y_slope[kMaxLayers];    // 1 for x, else slope_{j-1}
  int din[kMaxLayers], dout[kMaxLayers];
  int tile0[kMaxLayers + 1];    // first block of layer j
  int e_off[kMaxLayers];        // layer j's extended gradient in a partial row
  int batch, rpc, total;
};

// Weight-gradient tile: chunk c of the batch, inputs i0 .. i0+31 (i = din: the bias row) x
// outputs k0 .. k0+63 of layer j. Group q of the block's kGroups groups of 128 threads sums the
// chunk's samples q * 32 .. q * 32 + 31, thread (ty, tx) the inputs 4ty .. +3 and outputs
// 4tx .. +3 (per sample 2 float4 loads for 16 multiply-adds); the groups' sums are added in
// order and written to the chunk's partial row.
template <class T>
__global__ void __launch_bounds__(kChainThreads) wgrad_kernel(Wgrad<T> a,
                                                              float* __restrict__ part) {
  extern __shared__ __align__(16) float sm[];
  float* sy = sm;                      // [kChunkRows][kLdY]: Y rows
  float* sg = sm + kChunkRows * kLdY;  // [kChunkRows][kLdG]: GD rows
  int j = 0;
  while (static_cast<int>(blockIdx.x) >= a.tile0[j + 1]) ++j;
  const int din = a.din[j], dout = a.dout[j];
  const int n_wi = (din + kTM) / kTM, n_wk = (dout + kTN - 1) / kTN, per = n_wi * n_wk;
  const int t = blockIdx.x - a.tile0[j], c = t / per, rem = t - c * per;
  const int i0 = (rem / n_wk) * kTM, k0 = (rem % n_wk) * kTN;
  const int rb = min(a.batch, c * a.rpc), nr = min(a.batch, rb + a.rpc) - rb;
  const bool vy = din % 4 == 0, vg = dout % 4 == 0;
  const int me = threadIdx.x;
  // a Y row's columns i0 .. i0+31 at sy + row * kLdY, GD's k0 .. k0+63 at sg + row * kLdG
  stage(sy - i0, kLdY, a.y[j] + static_cast<size_t>(rb) * din, 0, nr, kChunkRows, din, i0, vy);
  for (int h = 0; h < 2; ++h)
    stage(sg - k0, kLdG, a.gd[j] + static_cast<size_t>(rb) * dout, 0, nr, kChunkRows, dout,
          k0 + h * kTK, vg);
  cp_async_wait_all();
  // this thread's own copies of Y: leaky(d_{j-1}), and 1 in the bias column
  for_own(kChunkRows, i0, vy, [&](int r, int i, int cnt) {
    float* p = sy + r * kLdY - i0 + i;
    for (int v = 0; v < cnt; ++v)
      p[v] = i + v < din ? leaky(p[v], a.y_slope[j]) : (i + v == din && r < nr ? 1.f : 0.f);
  });
  __syncthreads();
  const int q = me / kThreads, tid = me % kThreads, ty = tid / 16, tx = tid % 16;
  const float* ys = sy + q * kTK * kLdY + 4 * ty;
  const float* gs = sg + q * kTK * kLdG + 4 * tx;
  float acc[4][4] = {};
#pragma unroll 8
  for (int rr = 0; rr < kTK; ++rr) {
    const float4 yv = lds4(ys + rr * kLdY);
    const float4 gv = lds4(gs + rr * kLdG);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(lane4(yv, m), lane4(gv, n), acc[m][n]);
  }
  __syncthreads();  // the rows are read; groups 1.. leave their sums where they were
  if (q > 0)
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) sm[((q - 1) * 16 + 4 * m + n) * kThreads + tid] = acc[m][n];
  __syncthreads();
  if (q > 0) return;
  float* out = part + static_cast<size_t>(c) * a.total + a.e_off[j];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int i = i0 + 4 * ty + m;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float v = acc[m][n];
      for (int p = 1; p < kGroups; ++p) v += sm[((p - 1) * 16 + 4 * m + n) * kThreads + tid];
      const int k = k0 + 4 * tx + n;
      if (i <= din && k < dout) out[static_cast<size_t>(i) * dout + k] = v;
    }
  }
}

// by instance: [bfloat16][NT == 4], [bfloat16]
int chain_smem_set[2][2] = {}, wgrad_smem_set[2] = {};

}  // namespace layer

// dwb[i] = sum over p of part[p, i], p in order (iins::reduce_partials_kernel), rounded to
// bfloat16 once.
__global__ void __launch_bounds__(iins::kThreads)
reduce_partials_bf16_kernel(const float* __restrict__ part, int n_parts, int n,
                            bf16* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int p = 0; p < n_parts; ++p) acc += __ldg(part + static_cast<size_t>(p) * n + i);
    out[i] = __float2bfloat16_rn(acc);
  }
}

// The partial rows' in-order sum into dwb, in its storage type.
int launch_sum(const float* part, int n_parts, int n, float* out, cudaStream_t s) {
  return iins::launch_reduce(part, n_parts, n, out, s);
}
int launch_sum(const float* part, int n_parts, int n, bf16* out, cudaStream_t s) {
  const int grid = (n + iins::kThreads - 1) / iins::kThreads;
  reduce_partials_bf16_kernel<<<grid < 1024 ? grid : 1024, iins::kThreads, 0, s>>>(part, n_parts,
                                                                                  n, out);
  return static_cast<int>(cudaGetLastError());
}

// The chunks of the batch whose weight-gradient partials are summed (backward.mlp_split_plan).
int n_parts(int batch, int max_width) {
  if (max_width <= small::kMaxWidth) return (batch + small::kRows - 1) / small::kRows;
  const int split = (batch + layer::kChunkRows - 1) / layer::kChunkRows;
  return split > 4 ? split : 4;
}

template <class T>
int launch_small(const T* g, const T* x, T* dx, float* part, int batch, int n,
                 const void* const* ws, const void* const* ds, const int* dims,
                 const float* slopes, cudaStream_t s) {
  small::Args<T> a{};
  a.n = n;
  int off = 0;
  for (int j = 0; j <= n; ++j) a.dims[j] = dims[j];
  for (int j = 0; j < n; ++j) {
    a.w[j] = static_cast<const T*>(ws[j]);
    a.d[j] = static_cast<const T*>(ds[j]);
    a.slope[j] = slopes[j];
    a.w_off[j] = off;
    off += dims[j] * dims[j + 1];
    a.d_off[j] = off;
    off += small::kRows * dims[j + 1];
    a.gd_off[j] = off;
    off += small::kRows * dims[j + 1];
    a.e_off[j + 1] = a.e_off[j] + (dims[j] + 1) * dims[j + 1];
  }
  a.x_off = off;
  off += small::kRows * dims[0];
  a.g_off = off;
  off += small::kRows * dims[n];
  a.floats = off;
  const int smem = off * static_cast<int>(sizeof(float));
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  int err = allow_smem(small::small_kernel<T>, smem,
                       &small::smem_set[std::is_same<T, bf16>::value]);
  if (err) return err;
  const int grid = n_parts(batch, small::kMaxWidth);
  small::small_kernel<T><<<grid, small::kThreads, smem, s>>>(g, x, dx, part, batch, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return 0;
}

template <class T>
int launch_layers(const T* g, const T* x, T* dx, float* part, int batch, int n,
                  const void* const* ws, const void* const* ds, void* const* gds,
                  const int* dims, const float* slopes, const int* e_off, int total, int parts,
                  cudaStream_t s) {
  using namespace layer;
  constexpr int kBf16 = std::is_same<T, bf16>::value;
  for (int j = n - 1; j >= 0; --j) {
    if (j == 0 && j != n - 1 && !dx) continue;
    Chain<T> a{};
    a.mask_in = j == n - 1;
    a.g = g;
    a.gd = a.mask_in ? nullptr : static_cast<const float*>(gds[j]);
    a.d = static_cast<const T*>(ds[j]);
    a.gd_out = static_cast<float*>(gds[j]);
    a.w = static_cast<const T*>(ws[j]);
    a.out = j ? static_cast<float*>(gds[j - 1]) : nullptr;
    a.dx = j ? nullptr : dx;
    a.d_prev = j ? static_cast<const T*>(ds[j - 1]) : nullptr;
    a.slope = slopes[j];
    a.slope_prev = j ? slopes[j - 1] : 1.f;
    a.din = dims[j];
    a.dout = dims[j + 1];
    a.batch = batch;
    // 16-input tiles (a thread's 4 x 1 outputs) for narrow layers, and where 64-input tiles
    // would leave over half the card idle
    const int row_tiles = (batch + kTM - 1) / kTM;
    const bool narrow = a.din <= 16 || row_tiles * ((a.din + kTN - 1) / kTN) < 64;
    const int tn = narrow ? 16 : kTN;
    a.n_ci = (a.din + tn - 1) / tn;
    a.ldk = (a.dout + kTK - 1) / kTK * kTK + 4;
    a.vec = a.dout % 4 == 0;
    const int panels = (kTM + tn + (a.mask_in ? kTM : 0)) * a.ldk;
    const int sums = (kGroups - 1) * 16 * kThreads;  // the groups' sums, after the panels
    const int smem = (panels > sums ? panels : sums) * static_cast<int>(sizeof(float));
    if (smem > kMaxSmem) return cudaErrorInvalidValue;
    const int grid = (batch + kTM - 1) / kTM * a.n_ci;
    int err = narrow ? allow_smem(chain_kernel<T, 1>, smem, &chain_smem_set[kBf16][0])
                     : allow_smem(chain_kernel<T, 4>, smem, &chain_smem_set[kBf16][1]);
    if (err) return err;
    if (narrow)
      chain_kernel<T, 1><<<grid, kChainThreads, smem, s>>>(a);
    else
      chain_kernel<T, 4><<<grid, kChainThreads, smem, s>>>(a);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  Wgrad<T> w{};
  w.batch = batch;
  w.rpc = (batch + parts - 1) / parts;
  w.total = total;
  if (w.rpc > kChunkRows) return cudaErrorInvalidValue;
  for (int j = 0; j < n; ++j) {
    w.y[j] = j ? static_cast<const T*>(ds[j - 1]) : x;
    w.gd[j] = static_cast<const float*>(gds[j]);
    w.y_slope[j] = j ? slopes[j - 1] : 1.f;
    w.din[j] = dims[j];
    w.dout[j] = dims[j + 1];
    w.e_off[j] = e_off[j];
    w.tile0[j + 1] = w.tile0[j] + parts * ((dims[j] + kTM) / kTM) *
                                      ((dims[j + 1] + kTN - 1) / kTN);
  }
  int err = allow_smem(wgrad_kernel<T>, kWgradSmem, &wgrad_smem_set[kBf16]);
  if (err) return err;
  wgrad_kernel<T><<<w.tile0[n], kChainThreads, kWgradSmem, s>>>(w, part);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_bwd(const void* g_, const void* x_, void* dx_, int batch, int n_layers,
               const void* const* ws, const void* const* ds, void* const* gds, void* dwb,
               float* part, int parts, const int* dims, const float* slopes, void* stream) {
  if (batch <= 0 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  int e_off[kMaxLayers + 1] = {0}, width = 0;
  for (int j = 0; j <= n_layers; ++j) {
    if (dims[j] <= 0 || dims[j] > kMaxWidth) return cudaErrorInvalidValue;
    width = dims[j] > width ? dims[j] : width;
  }
  for (int j = 0; j < n_layers; ++j) e_off[j + 1] = e_off[j] + (dims[j] + 1) * dims[j + 1];
  if (parts != n_parts(batch, width)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* g = static_cast<const T*>(g_);
  const T* x = static_cast<const T*>(x_);
  T* dx = static_cast<T*>(dx_);
  const int err = width <= small::kMaxWidth
                      ? launch_small(g, x, dx, part, batch, n_layers, ws, ds, dims, slopes, s)
                      : launch_layers(g, x, dx, part, batch, n_layers, ws, ds, gds, dims,
                                      slopes, e_off, e_off[n_layers], parts, s);
  if (err) return err;
  return launch_sum(part, parts, e_off[n_layers], static_cast<T*>(dwb), s);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// g (B, dims[n]); x (B, dims[0]); dx (B, dims[0]) or null (not needed). Host arrays of
// device pointers: ws the n W_j, ds the n saved d_j, gds n workspaces (B, dims[j+1]) for
// GD_j (unused where every width is at most 64). dwb (sum_j (dims[j] + 1) * dims[j+1]):
// layer j's extended gradient, rows 0..D_j-1 dW_j and row D_j db_j, after layer j-1's; part
// (parts, same) scratch, one row a chunk of the batch, parts as backward.mlp_split_plan gives
// it (the launch refuses any other).
int iins_mlp_chain_bwd(const float* g, const float* x, float* dx, int batch, int n_layers,
                       const void* const* ws, const void* const* ds, void* const* gds,
                       float* dwb, float* part, int parts, const int* dims, const float* slopes,
                       void* stream) {
  return launch_bwd<float>(g, x, dx, batch, n_layers, ws, ds, gds, dwb, part, parts, dims,
                           slopes, stream);
}

// The same, the bfloat16 instance: g, x, dx, the weights, ds and dwb bfloat16; gds and part
// fp32.
int iins_mlp_chain_bwd_bf16(const void* g, const void* x, void* dx, int batch, int n_layers,
                            const void* const* ws, const void* const* ds, void* const* gds,
                            void* dwb, float* part, int parts, const int* dims,
                            const float* slopes, void* stream) {
  return launch_bwd<bf16>(g, x, dx, batch, n_layers, ws, ds, gds, dwb, part, parts, dims,
                          slopes, stream);
}

}  // extern "C"
