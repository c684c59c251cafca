// K4 mlp_chain: k Dense + LeakyReLU layers in one launch,
// y_{j+1} = leaky(y_j @ W_j + b_j, slope_j), slope 1.0 = linear.
//
// Replaces fused_mlp_chain (iinsvae_tpu/ops/pallas/fused.py:1164, kernel
// _fwd_mlp_kernel :1072): the restorer head 16->512->256->256->1 (slopes
// 0.2, 0.2, 0.2, 1.0) and the classifier head 16->16->32->16->5 (slopes
// 0.01, 0.01, 0.01, 0.2).
//
// Bound on the H100: the restorer does ~205 MFLOP at batch 500 (3 us at
// 67 TFLOP/s fp32) and moves under 1 MB, so it is bound by operations;
// the classifier is a few microseconds of latency whatever it does. A
// block owns kRows samples; their activations ping-pong between two
// shared-memory buffers (stored k-major, so one float4 read gives four
// samples' input k), so intermediates never reach device memory. The
// weights (the restorer's 512x256 layer alone is 512 KB) do not fit in
// shared memory: the block streams each W_j through a 32 KB shared tile of
// whole rows, loaded cooperatively with independent float4 loads (many in
// flight at once, where a per-thread walk down its own columns waits on
// every load) one tile ahead, through registers, while the current tile is
// multiplied; each weight read from the tile serves all kRows samples from
// registers. Narrow layers (5 or 16 outputs) split the input dimension
// over up to 32 lanes and reduce with warp shuffles.
//
// Under autograd the launch may also write each layer's pre-activation
// d_j (B, D_{j+1}) to device memory (``ds``; null when serving): K4's
// backward (mlp_chain_bwd.cu) reads them, as the TPU backward reads the
// d_j its forward saved (fused.py:1082). That is ~2 MB at batch 500.
//
// Three paths. The kernel above (mlp_chain_kernel) takes every chain the two
// below do not (any other widths). At the restorers it took 41.8 us (1-D)
// and 53.8 us (2-D) at batch 500 on the H100, slower than four torch.mm
// calls: its 125 blocks each read every weight from L2 once for 4 samples,
// 103 MB (1-D) and 132 MB (2-D) a call, a 32 KB tile at a time in series.
// The restorers, D0 -> 512 -> 256 -> 256 -> 1 (D0 = 16 or 128, a multiple of
// 16 up to 128), and the soft restorers, whose last layer gives 2 outputs (mu,
// logvar), run mlp_cluster_kernel below instead:
// - A cluster of 8 blocks owns a tile of 12, 24 or 36 samples (the least
//   with which the clusters the card holds at once, 15 on the H100, take
//   the batch in one round), and each block an eighth of every layer's
//   output columns, whose weights it keeps in shared memory, staged once
//   with cp.async. A cluster walks its tiles with the weights resident, so
//   each weight is read from L2 once a cluster: about 14 MB a call at batch
//   500 (14 clusters), against the general kernel's 103 / 132 MB.
// - After layers 0 and 1 each block copies its columns of the activation to
//   every other block of the cluster (bulk copies between the blocks'
//   shared memory, each completing on the receiver's mbarrier), once every
//   block is done reading its own (the cluster's barrier). The next layer's
//   products take each block's rows as they land, the block's own first.
// - Layer 0 of the 1-D restorer (16 inputs) runs whole in every block (0.3
//   MFLOP a block): that costs less than the exchange it saves.
// - The 256 -> 1 (or 2) layer is a partial dot product in each block (two
//   for the soft restorer, the last width a template parameter), summed by
//   rank 0 in rank order.
// - The products are fp32 FMAs in register tiles of 12 samples x 8 columns
//   (96 FMAs for 5 16-byte shared loads), 8 lanes a tile over interleaved
//   rows of the input width (rows 4 banks apart), summed in a fixed
//   shuffle tree and then over the width's parts in order: the output is
//   the same bit for bit from call to call. 3xTF32 would not pay: the
//   products are about 3 us a call.
// It takes 19.2-19.6 us (1-D) and 23.0-23.4 us (2-D) a call at batch 500 on
// the H100 (PERF.md), 6-7x its bound: the staging of layer 0's inputs and
// the exchanges take a third (1-D) to a half (2-D) of it (phase_times.py).
//
// The small heads, chains of 1-8 layers whose every width is at most 64 (the
// classifier 16 -> 16 -> 32 -> 16 -> 5 of both models: 1,360 weights and 69
// biases, 5.7 KB; 0.02 us of FMAs at batch 500), run mlp_head_kernel (namespace
// head). The general kernel took 6.87-6.92 us there, all latency: 125 blocks of
// 4 samples, each layer's weights read from L2 only once the layer starts (four
// dependent round trips a call), two __syncthreads a weight tile and one a
// layer, each 16-32-long dot product split over lanes and a shuffle tree. The
// head kernel:
// - stages every layer's weights and biases once a block, in one round of
//   cp.async beside the tile's x: one L2 round trip a call, not one a layer;
// - takes a warp a sample (8 a block, at most one persistent block a SM,
//   fused.mlp_head_plan: 63 blocks at batch 500), lane c its layer's output
//   columns c and c + 32, reading the layer's input from the warp's own row
//   in shared memory as float4 broadcasts: a __syncwarp between the layers,
//   no block barrier. Broadcast by __shfl_sync from registers instead, the
//   input cost the classifier 5.48-5.54 us a call, 4.37 with its widths
//   fixed at compile time (H100; chip_smoke.py, phase_times.py): each FMA
//   waited on its shuffle;
// - runs the classifier on an instance whose widths are compile-time
//   constants (Dims<16, 16, 32, 16, 5>: every loop unrolls, the loads go
//   ahead of the FMAs), any other small chain on one that reads them from the
//   launch's arguments (Any); both take every layer's pointers and slope at
//   fixed offsets of the arguments (the loops over the layers unroll);
// - sums each column as one fmaf chain from 0 over k ascending, then + bias:
//   another order than the general kernel's split (within the plain version's
//   tolerance, not bit for bit), the same bits from call to call; it writes
//   each d_j where asked, as the general kernel does.
// It takes 3.36-3.37 us a call at batch 500 on the H100 (PERF.md): the launch
// (1.2 us) and the staging (1.0) are two thirds of it.
//
// The cluster and head kernels also have bfloat16 instances (iins_mlp_cluster_bf16,
// iins_mlp_head_bf16), K4 under --compute_dtype bfloat16 as the Pallas body computes it on
// bfloat16 refs (fused.py:1072-1084): x, the weights and the biases are read as bfloat16 and
// upcast where they are staged (by plain loads: cp.async cannot convert), the chain runs in
// fp32 between the layers as in float32 (y is not rounded there, so a bfloat16 mma would not
// compute it), and each d_j and the output are rounded to bfloat16 on store. Plain version:
// fused.mlp_chain_bf16_ref.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "async_smem.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kMaxLayers = 8;
constexpr int kMaxCols = 4;         // output columns a thread may own: dout*lanes <= 1024
constexpr int kTileFloats = 8192;   // 32 KB of weight rows
constexpr int kPrefetch = kTileFloats / 4 / kThreads;  // float4s a thread holds
constexpr size_t kMaxSmem = 48 * 1024;  // a block's default; the restorer needs exactly this

using bf16 = __nv_bfloat16;

// A value of the storage type T (float, or bfloat16 for the bfloat16 instances) as fp32, and
// back, rounded to the nearest.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same<T, float>::value) return v; else return __float2bfloat16_rn(v);
}

template <class T>
struct ChainArgs {
  const T* w[kMaxLayers];
  const T* b[kMaxLayers];
  float slope[kMaxLayers];
  T* d[kMaxLayers];  // each layer's pre-activations (B, dims[j + 1]), or null
  int dims[kMaxLayers + 1];
  int n_layers;
  int width;  // max(dims): length of each activation buffer, in kRows-float rows
};
using MlpArgs = ChainArgs<float>;

// Lanes per output column for a layer of `dout` outputs: a power of two
// <= 32 with dout * lanes <= kThreads.
__host__ __device__ inline int lanes_for(int dout) {
  int g = 1;
  while (g < 32 && dout * g * 2 <= kThreads) g *= 2;
  return g;
}

// Rows [k0, k0 + kt) of W (kt * dout floats, dout % 4 == 0) into registers.
__device__ __forceinline__ void prefetch(float4 (&pre)[kPrefetch], const float* __restrict__ w,
                                         int dout, int k0, int kt) {
  const float4* src = reinterpret_cast<const float4*>(w + static_cast<size_t>(k0) * dout);
  const int n4 = kt * dout / 4;
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int i = threadIdx.x + q * kThreads;
    if (i < n4) pre[q] = __ldg(src + i);
  }
}

__global__ void __launch_bounds__(kThreads)
mlp_chain_kernel(const float* __restrict__ x, float* __restrict__ y, int batch, MlpArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;                      // [width][kRows]
  float* nxt = cur + a.width * kRows;     // [width][kRows]
  float* tile = nxt + a.width * kRows;    // [kTileFloats]
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, batch - r0);
  const int d0 = a.dims[0];
  for (int i = threadIdx.x; i < kRows * d0; i += blockDim.x) {
    const int r = i / d0, k = i - r * d0;
    cur[k * kRows + r] = r < nr ? x[static_cast<size_t>(r0 + r) * d0 + k] : 0.f;
  }

  for (int j = 0; j < a.n_layers; ++j) {
    const int din = a.dims[j], dout = a.dims[j + 1];
    const int g = lanes_for(dout);
    const int span = (dout * g + blockDim.x - 1) / blockDim.x;  // <= kMaxCols
    const float* __restrict__ w = a.w[j];
    const bool vec = dout % 4 == 0 && reinterpret_cast<std::uintptr_t>(w) % 16 == 0;
    const int tk = min(din, kTileFloats / dout);
    float acc[kMaxCols][kRows];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[c][r] = 0.f;

    // float4 tiles are double-buffered through registers: tile k0 + tk is
    // in flight while tile k0 is multiplied
    float4 pre[kPrefetch];
    if (vec) prefetch(pre, w, dout, 0, min(tk, din));
    for (int k0 = 0; k0 < din; k0 += tk) {
      const int kt = min(tk, din - k0);
      __syncthreads();  // the previous tile (and, at k0 = 0, cur) is consumed
      if (vec) {
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) {
          const int i = threadIdx.x + q * kThreads;
          if (i < kt * dout / 4) reinterpret_cast<float4*>(tile)[i] = pre[q];
        }
      } else {
        const float* src = w + static_cast<size_t>(k0) * dout;
        for (int i = threadIdx.x; i < kt * dout; i += blockDim.x) tile[i] = __ldg(src + i);
      }
      __syncthreads();
      if (vec && k0 + tk < din) prefetch(pre, w, dout, k0 + tk, min(tk, din - k0 - tk));
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        if (c >= span) break;
        const int idx = threadIdx.x + c * blockDim.x;
        const int col = idx / g, part = idx - col * g;
        if (col >= dout) continue;
        for (int kk = part; kk < kt; kk += g) {
          const float wv = tile[kk * dout + col];
          const float4* xa = reinterpret_cast<const float4*>(cur + (k0 + kk) * kRows);
#pragma unroll
          for (int q = 0; q < kRows / 4; ++q) {
            const float4 xv = xa[q];
            acc[c][4 * q + 0] = fmaf(xv.x, wv, acc[c][4 * q + 0]);
            acc[c][4 * q + 1] = fmaf(xv.y, wv, acc[c][4 * q + 1]);
            acc[c][4 * q + 2] = fmaf(xv.z, wv, acc[c][4 * q + 2]);
            acc[c][4 * q + 3] = fmaf(xv.w, wv, acc[c][4 * q + 3]);
          }
        }
      }
    }

    const bool last = j == a.n_layers - 1;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= span) break;  // uniform: every lane runs the shuffles below
      const int idx = threadIdx.x + c * blockDim.x;
      const int col = idx / g, part = idx - col * g;
      for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[c][r] += __shfl_xor_sync(0xffffffffu, acc[c][r], off);
      }
      if (col < dout && part == 0) {
        const float bias = __ldg(a.b[j] + col), slope = a.slope[j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float d = acc[c][r] + bias;
          const float v = d > 0.f ? d : slope * d;
          if (a.d[j] && r < nr) a.d[j][static_cast<size_t>(r0 + r) * dout + col] = d;
          if (!last) {
            nxt[col * kRows + r] = v;
          } else if (r < nr) {
            y[static_cast<size_t>(r0 + r) * dout + col] = v;
          }
        }
      }
    }
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The restorers' path: a cluster of kCluster blocks a tile of samples, each block its share of
// every layer's output columns.
namespace cluster {

namespace cg = cooperative_groups;

constexpr int kCluster = 8;
constexpr int kThreads = 384;  // 12 warps, 3 an SM sub-partition
constexpr int kD1 = 512, kD2 = 256, kD3 = 256;  // the restorers' widths after D0, then D4
constexpr int kMaxD4 = 2;  // the last width D4, a template parameter: 1, or 2 (mu, logvar)
constexpr int kN0 = kD1 / kCluster, kN1 = kD2 / kCluster, kN2 = kD3 / kCluster;  // columns a block
constexpr int kMaxD0 = 128, kMaxS = 36;  // tiles of 12, 24 or 36 samples
constexpr int kTs = 12, kTc = 8, kLanes = 8;  // a thread's samples, columns, lanes a tile
constexpr int kP = kThreads * kTs;  // the split products' partial sums, in floats

template <class T>
struct Args {
  const T* w[4];
  const T* b[4];
  float slope[4];
  T* d[4];  // each layer's pre-activations (B, D_{j+1}), or null
  int d0;
};

// Shared memory, in floats (the same for either last width D4): the block's weight slices W1
// (512, 32) and W2 (256, 32) in rows of 36 floats, W3's 32 rows of D4 (room for kMaxD4) and its
// biases (b0's 64, or all 512 where every block runs layer 0; b1's and b2's 32; b3's D4); the
// layer input A (k, S)
// in rows of as(S) floats: x with W0's slice (D0, 64) behind it in rows of 68 (both dead once
// layer 0's products are done, staged again for a cluster's next tile), then each layer's
// output, every block's columns at its rank's rows; the split products' partial sums P (part,
// column, sample); this block's outputs of layers 0 and 1 (64, as(S)) and (32, as(S)), which
// bulk copies take to every block's A; the 256 -> D4 layer's partial sums of every block (rank,
// D4, S; room for kMaxD4), read by rank 0; an mbarrier for each layer 0 and 1 and each other block, on which that
// block's copy of its outputs into A completes, one for x's copy (the tile's x lands in P,
// row-major, and is placed k-major from there).
// Rows of W and A are 4 banks apart (a row length of 4 mod 8 floats), so that the 8 lanes that
// read 8 consecutive rows at the same column read distinct banks.
constexpr int kBias = kD1 + kN1 + kN2 + 4;  // b0 (all of it, or this block's 64), b1, b2, b3 (D4)
__host__ __device__ constexpr int ld(int n) { return n + 4; }
__host__ __device__ constexpr int as(int s) { return s % 8 ? s : s + 4; }
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }
constexpr int kW2 = kD1 * ld(kN1), kW3 = kW2 + kD2 * ld(kN2), kB = kW3 + kN2 * kMaxD4;
constexpr int kA = kB + kBias;
__host__ __device__ constexpr int a_floats(int d0, int s) {
  return max_of(kD1 * as(s), d0 * (as(s) + ld(kN0)));
}
__host__ __device__ constexpr int p_off(int d0, int s) { return kA + a_floats(d0, s); }
__host__ __device__ constexpr int o_off(int d0, int s) { return p_off(d0, s) + kP; }
__host__ __device__ constexpr int p3_off(int d0, int s) {
  return o_off(d0, s) + (kN0 + kN1) * as(s);
}
__host__ __device__ constexpr int bar_off(int d0, int s) {
  return p3_off(d0, s) + kCluster * kMaxD4 * s;
}
__host__ __device__ constexpr int smem_floats(int d0, int s) {
  return bar_off(d0, s) + 4 * kCluster + 4;  // 17 mbarriers and room for an 18th
}
static_assert(smem_floats(kMaxD0, kMaxS) * 4 <= 232448, "over the 227 KB a block can have");

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A copy of `bytes` (a multiple of 16) from this block's shared memory at src into block
// `rank`'s at the same offset as dst, completing its bytes on that block's mbarrier at the
// offset of bar (the copy engine's bulk copy between the blocks of a cluster).
__device__ __forceinline__ void copy_to_block(float* dst, const float* src, unsigned bytes,
                                              unsigned long long* bar, int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(b) : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];" ::"r"(d),
      "r"(smem_u32(src)), "r"(bytes), "r"(b)
      : "memory");
}

// The cluster's barrier in two halves: arrive (release) once this thread is done with what
// the peers may overwrite; wait (acquire) before touching what they were done with.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Rows [0, rows) of a weight slice: `cols` values a row from w + k * ld_w, into dst (rows,
// ld_d floats apart): float32 by cp.async, bfloat16 8 values a 16-byte load, upcast and stored
// (cols a multiple of 8).
template <class T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ w, int rows,
                                           int cols, int ld_w, int ld_d) {
  if constexpr (std::is_same<T, float>::value) {
    const int q = cols / 4;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int k = i / q, c = (i - k * q) * 4;
      cp_async16(dst + k * ld_d + c, w + static_cast<size_t>(k) * ld_w + c, true);
    }
  } else {
    const int q = cols / 8;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int k = i / q, c = (i - k * q) * 8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(w + static_cast<size_t>(k) * ld_w + c));
      const bf16* h = reinterpret_cast<const bf16*>(&v);
      float4* o = reinterpret_cast<float4*>(dst + k * ld_d + c);
      o[0] = make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
      o[1] = make_float4(to_f32(h[4]), to_f32(h[5]), to_f32(h[6]), to_f32(h[7]));
    }
  }
}

// One value from global memory to dst (shared) as fp32: cp.async for float32, a load for
// bfloat16.
__device__ __forceinline__ void stage_one(float* dst, const float* src) { cp_async4(dst, src, true); }
__device__ __forceinline__ void stage_one(float* dst, const bf16* src) { *dst = to_f32(*src); }

// The tile's samples row0 .. row0 + ns - 1 of x (B, D0), one bulk copy into P (row-major, in
// x's type), which completes on xbar; thread 0 issues it.
template <class T>
__device__ __forceinline__ void fetch_x(float* p, const T* __restrict__ x, int d0, int row0,
                                        int ns, unsigned long long* xbar) {
  if (threadIdx.x == 0) {
    const unsigned bytes = ns * d0 * sizeof(T);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // P's earlier reads first
    mbar_expect_tx(xbar, bytes);
    bulk_copy(p, reinterpret_cast<const float*>(x + static_cast<size_t>(row0) * d0), bytes, xbar);
  }
}

// x from P into dst (D0, S) as fp32, k-major in rows of as(S) floats; samples past the batch
// zero.
template <class T>
__device__ __forceinline__ void place_x(float* dst, const float* p, int d0, int s_tile, int ns) {
  const int sa = as(s_tile);
  const T* px = reinterpret_cast<const T*>(p);
  for (int i = threadIdx.x; i < s_tile * d0; i += kThreads) {
    const int s = i / d0, k = i - s * d0;
    dst[k * sa + s] = s < ns ? to_f32(px[i]) : 0.f;
  }
}

// This block's slice of W0 (D0, 64) in rows of 68 floats, or all of it (D0, 512), to dst.
template <class T>
__device__ __forceinline__ void stage_w0(float* dst, const T* __restrict__ w0, int d0,
                                        bool all) {
  if (all)
    stage_rows(dst, w0, d0, kD1, kD1, kD1);
  else
    stage_rows(dst, w0, d0, kN0, kD1, ld(kN0));
}

// A layer's split of its input width K into `parts` parts: (part, tile) pairs, a tile 12
// samples x 8 columns, each kLanes lanes of one warp.
__device__ __forceinline__ int parts_of(int n, int s_tile) {
  return kThreads / (n / kTc * (s_tile / kTs) * kLanes);
}

// v[2h + b][r] of the lane whose bit `off` is b: its half (columns h) plus the partner's, so
// that after rounds of 4, 2 and 1 lane l holds column l summed over the 8 lanes.
template <int H>
__device__ __forceinline__ void halve(const float (&v)[2 * H][kTs], float (&out)[H][kTs], int off,
                                      bool hi) {
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int r = 0; r < kTs; ++r) {
      const float keep = hi ? v[H + h][r] : v[h][r], send = hi ? v[h][r] : v[H + h][r];
      out[h][r] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
}

// One layer's products: out (S, N) = A (K, S)^T W (K, N). With `bars`, A's K rows are the
// kCluster blocks' slices of K / kCluster rows, which land one by one (bars[r] completes when
// block r's has): where the split's parts divide a slice into whole rounds of the 8 lanes, each
// part takes its share of every slice, this block's own slice first, then the others in the
// order their copies are sent (block rank - 1 first); else, and without `bars`, the part takes
// its share of the K rows (once every slice has landed). Each part goes to its own warps; in a warp,
// each 8 lanes take a tile of 12 samples x 8 columns, lane l every 8th of the part's rows from
// the l-th, a fmaf chain an output over them; the 8 lanes' sums are added in a fixed tree
// (shuffles), leaving lane l column l of the tile, which it writes to P (part, column, sample).
__device__ __forceinline__ void products(const float* a, const float* w, float* p, int k_len,
                                         int n, int s_tile, unsigned long long* bars,
                                         unsigned parity, int rank) {
  const int cgs = n / kTc, tiles = cgs * (s_tile / kTs), parts = parts_of(n, s_tile);
  const int lane = threadIdx.x & (kLanes - 1), g = threadIdx.x / kLanes;
  const int part = g / tiles, tile = g - part * tiles;
  const int c0 = (tile % cgs) * kTc, s0 = tile / cgs * kTs, sa = as(s_tile), wl = ld(n);
  if (part >= parts) return;  // warp-uniform: tiles * kLanes is a multiple of 32
  // slice by slice where each lane's share of a part's slice is whole rounds of kLanes rows;
  // else every slice waited for first
  const bool by_slice = bars && k_len / kCluster % (parts * kLanes) == 0;
  if (bars && !by_slice)
    for (int r = 0; r < kCluster; ++r)
      if (r != rank) mbar_wait(bars + r, parity);
  const int chunks = by_slice ? kCluster : 1, rows = k_len / chunks;
  const int kb = part * rows / parts, ke = (part + 1) * rows / parts;
  const float* ap = a + s0;
  const float* wp = w + c0;
  float acc[kTc][kTs] = {};
  for (int i = 0; i < chunks; ++i) {
    const int r = (rank - i + kCluster) % kCluster, base = by_slice ? r * rows : 0;
    if (i > 0) mbar_wait(bars + r, parity);
#pragma unroll 2
    for (int k = base + kb + lane; k < base + ke; k += kLanes) {
      const float4 x0 = lds4(ap + k * sa), x1 = lds4(ap + k * sa + 4), x2 = lds4(ap + k * sa + 8);
      const float4 wa = lds4(wp + k * wl), wb = lds4(wp + k * wl + 4);
      const float xs[kTs] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y,
                             x1.z, x1.w, x2.x, x2.y, x2.z, x2.w};
      const float ws[kTc] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int q = 0; q < kTc; ++q)
#pragma unroll
        for (int r2 = 0; r2 < kTs; ++r2) acc[q][r2] = fmaf(xs[r2], ws[q], acc[q][r2]);
    }
  }
  float h4[4][kTs], h2[2][kTs], h1[1][kTs];
  halve<4>(acc, h4, 4, lane & 4);
  halve<2>(h4, h2, 2, lane & 2);
  halve<1>(h2, h1, 1, lane & 1);
  float* pp = p + (part * n + c0 + lane) * s_tile + s0;
#pragma unroll
  for (int r = 0; r < kTs; r += 4)
    *reinterpret_cast<float4*>(pp + r) = make_float4(h1[0][r], h1[0][r + 1], h1[0][r + 2],
                                                     h1[0][r + 3]);
}

// Layer 0 of a narrow input (D0 <= kRepD0, the 1-D restorer), every column in every block: no
// exchange. A (512, S) = leaky(x W0 + b0) from x (D0, S) and all of W0 (D0, 512) staged at xw;
// thread (sample group g, column c) the columns c + 128 q, q < 4, of 12 samples, one fmaf chain
// an output over k ascending. Writes this block's columns' pre-activations to ds where given.
constexpr int kRepD0 = 16;
static_assert(kRepD0 * (as(kMaxS) + kD1) <= kD2 * ld(kN2), "x and all of W0 fit in W2's place");

template <class T>
__device__ __forceinline__ void layer0_all(const float* xw, float* a, int d0, int s_tile,
                                           const float* b0, float slope,
                                           T* __restrict__ ds, int rank, int row0, int ns) {
  const int c = threadIdx.x % 128, g = threadIdx.x / 128, s0 = g * kTs, sa = as(s_tile);
  if (s0 >= s_tile) return;
  const float* xp = xw + s0;
  const float* wp = xw + d0 * sa + c;
  float acc[4][kTs] = {};
  for (int k = 0; k < d0; ++k) {
    const float4 x0 = lds4(xp + k * sa), x1 = lds4(xp + k * sa + 4), x2 = lds4(xp + k * sa + 8);
    const float xs[kTs] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w, x2.x, x2.y, x2.z, x2.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float wv = wp[k * kD1 + 128 * q];
#pragma unroll
      for (int r = 0; r < kTs; ++r) acc[q][r] = fmaf(xs[r], wv, acc[q][r]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int col = c + 128 * q;
    const float b = b0[col];
    float v[kTs];
#pragma unroll
    for (int r = 0; r < kTs; ++r) {
      const float d = acc[q][r] + b;
      if (ds && col / kN0 == rank && s0 + r < ns)
        ds[static_cast<size_t>(row0 + s0 + r) * kD1 + col] = from_f32<T>(d);
      v[r] = d > 0.f ? d : slope * d;
    }
#pragma unroll
    for (int r = 0; r < kTs; r += 4)
      *reinterpret_cast<float4*>(a + col * sa + s0 + r) = make_float4(v[r], v[r + 1], v[r + 2],
                                                                      v[r + 3]);
  }
}

// The layer's outputs from the partial sums P: d = the parts summed in order + bias (the
// block's N, staged), written to ds (rows row0 .. row0 + ns - 1, columns col0 ..) where given;
// out (N, S) = leaky(d), in rows of as(S) floats, and the same in out2 where given.
template <class T>
__device__ __forceinline__ void finish(const float* p, float* out, float* out2, int n,
                                       int s_tile, const float* bias, float slope,
                                       T* __restrict__ ds, int dout, int col0, int row0,
                                       int ns) {
  const int parts = parts_of(n, s_tile), len = n * s_tile, sa = as(s_tile);
  for (int o = threadIdx.x; o < len; o += kThreads) {
    const int c = o / s_tile, s = o - c * s_tile;
    float v = p[o];
    for (int q = 1; q < parts; ++q) v += p[q * len + o];
    const float d = v + bias[c];
    if (ds && s < ns) ds[static_cast<size_t>(row0 + s) * dout + col0 + c] = from_f32<T>(d);
    const float v_out = d > 0.f ? d : slope * d;
    out[c * sa + s] = v_out;
    if (out2) out2[c * sa + s] = v_out;
  }
}

// A layer's exchange, after its products: this block's outputs into O and into its rank's rows
// of A (the next layer's input), then, once every block is done reading its A (the cluster's
// barrier, which warp 0 awaits here and the others before their next arrival), one bulk copy
// of O to each other block's A, completing on that block's mbarrier bars[rank] (armed before
// this block's arrival, so that no copy completes on it before). On a block's first tile it
// also waits for all but kPending of its weights' copy groups.
template <int kPending, class T>
__device__ __forceinline__ void exchange(float* a, float* p, float* o, const float* bias, int n,
                                         int s_tile, float slope, T* ds, int dout, int rank,
                                         int row0, int ns, unsigned long long* bars, bool first) {
  const int slice = n * as(s_tile);
  if (threadIdx.x == 0)
    for (int r = 0; r < kCluster; ++r)
      if (r != rank) mbar_expect_tx(bars + r, slice * 4);
  cluster_arrive();  // this thread is done reading A
  __syncthreads();
  finish(p, o, a + rank * slice, n, s_tile, bias, slope, ds, dout, rank * n, row0, ns);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // O, for the copy engine
  if (first) cp_async_wait<kPending>();  // the next layer's weights, on a block's first tile
  __syncthreads();
  if (threadIdx.x < 32) {
    cluster_wait();  // every block is done reading its A
    if (threadIdx.x > 0 && threadIdx.x < kCluster)
      copy_to_block(a + rank * slice, o, slice * 4, bars + rank, (rank + threadIdx.x) % kCluster);
  }
}

// Cluster c walks tiles c, c + clusters, ... of s_tile samples; block rank r of the cluster
// owns columns [r N_j, (r + 1) N_j) of layers 0-2 and rows [r N_2, (r + 1) N_2) of the last
// layer's weight (256, D4). T: the storage type of x, y, the weights, the biases and the d_j;
// D4: the last width, 1 or 2.
template <class T, int D4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
mlp_cluster_kernel(const T* __restrict__ x, T* __restrict__ y, int batch, int s_tile,
                   int n_tiles, Args<T> a) {
  static_assert(D4 >= 1 && D4 <= kMaxD4, "the last width is 1 or 2");
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int clusters = gridDim.x / kCluster;
  const int d0 = a.d0, sa = as(s_tile);
  float* act = sm + kA;
  float* p = sm + p_off(d0, s_tile);
  float* p3 = sm + p3_off(d0, s_tile);
  float* o = sm + o_off(d0, s_tile);
  auto* bars = reinterpret_cast<unsigned long long*>(sm + bar_off(d0, s_tile));
  const float* bias = sm + kB;
  const T* w0 = a.w[0] + rank * kN0;
  unsigned long long* xbar = bars + 2 * kCluster;
  if (threadIdx.x <= 2 * kCluster) {
    mbar_init(bars + threadIdx.x);
    mbar_fence_init();  // before this block's first arrival at the cluster's barrier
  }
  __syncthreads();  // the barriers, before x's copy and any wait

  // layer 0 of a narrow input runs in every block (layer0_all): x and all of W0 then sit in
  // W2's place, and W2 is staged once they are done with
  const bool all0 = d0 <= kRepD0;
  float* xw = sm + kW2;
  int tile = blockIdx.x / kCluster;
  // layer 0's inputs first, then the later layers' weights, which land behind layer 0
  float* x_at = all0 ? xw : act;  // x (D0, S), then W0 behind it
  fetch_x(p, x, d0, tile * s_tile, min(s_tile, batch - tile * s_tile), xbar);
  stage_w0(x_at + d0 * sa, all0 ? a.w[0] : w0, d0, all0);
  stage_rows(sm + kW3, a.w[3] + rank * kN2 * D4, 1, kN2 * D4, 0, 0);
  stage_rows(sm + kB, a.b[0] + (all0 ? 0 : rank * kN0), 1, all0 ? kD1 : kN0, 0, 0);
  stage_rows(sm + kB + kD1, a.b[1] + rank * kN1, 1, kN1, 0, 0);
  stage_rows(sm + kB + kD1 + kN1, a.b[2] + rank * kN2, 1, kN2, 0, 0);
  if (threadIdx.x < D4) stage_one(sm + kB + kD1 + kN1 + kN2 + threadIdx.x, a.b[3] + threadIdx.x);
  cp_async_wait_all();
  stage_rows(sm, a.w[1] + rank * kN1, kD1, kN1, kD2, ld(kN1));
  cp_async_commit();
  if (!all0) {
    stage_rows(sm + kW2, a.w[2] + rank * kN2, kD2, kN2, kD3, ld(kN2));
    cp_async_commit();
  }
  unsigned parity = 0;
  for (bool first = true; tile < n_tiles; tile += clusters, first = false, parity ^= 1) {
    const int row0 = tile * s_tile, ns = min(s_tile, batch - row0);
    if (!first) {
      fetch_x(p, x, d0, row0, ns, xbar);
      stage_w0(x_at + d0 * sa, all0 ? a.w[0] : w0, d0, all0);
      cp_async_wait_all();
    }
    mbar_wait(xbar, parity);
    place_x<T>(x_at, p, d0, s_tile, ns);
    __syncthreads();
    if (all0) {
      // layer 0: x (D0, S) -> A (512, S), all of it here
      layer0_all(xw, act, d0, s_tile, bias, a.slope[0], a.d[0], rank, row0, ns);
      __syncthreads();
      stage_rows(sm + kW2, a.w[2] + rank * kN2, kD2, kN2, kD3, ld(kN2));
      cp_async_commit();
      if (first) cp_async_wait<1>();  // W1
      __syncthreads();
      // layer 1: (512, S) -> A (256, S)
      products(act, sm, p, kD1, kN1, s_tile, nullptr, parity, rank);
    } else {
      // layer 0: x (D0, S) -> A (512, S)
      products(act, act + d0 * sa, p, d0, kN0, s_tile, nullptr, parity, rank);
      exchange<1>(act, p, o, bias, kN0, s_tile, a.slope[0], a.d[0], kD1, rank, row0, ns, bars,
                  first);
      // layer 1: (512, S) -> A (256, S), each block's rows of the input as they land
      products(act, sm, p, kD1, kN1, s_tile, bars, parity, rank);
      if (threadIdx.x >= 32) cluster_wait();  // the last exchange's barrier, long complete
    }
    exchange<0>(act, p, o + kN0 * sa, bias + kD1, kN1, s_tile, a.slope[1], a.d[1], kD2, rank,
                row0, ns, bars + kCluster, first || all0);
    // layer 2: (256, S) -> this block's columns (32, S), then layer 3: its rows of the D4 dot
    // products, into rank 0's partial sums, which rank 0 sums in rank order
    products(act, sm + kW2, p, kD2, kN2, s_tile, bars + kCluster, parity, rank);
    __syncthreads();
    finish(p, act, nullptr, kN2, s_tile, bias + kD1 + kN1, a.slope[2], a.d[2], kD3, rank * kN2,
           row0, ns);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < kLanes * s_tile) {  // 8 lanes a sample, 4 rows each
      const int s3 = threadIdx.x / kLanes, j = threadIdx.x % kLanes;
      const float* w3 = sm + kW3 + 4 * j * D4;
      const float* x3 = act + 4 * j * sa + s3;
      float v[D4] = {};
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int q = 0; q < D4; ++q) v[q] = fmaf(x3[c * sa], w3[c * D4 + q], v[q]);
#pragma unroll
      for (int q = 0; q < D4; ++q) {
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 4);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 2);
        v[q] += __shfl_xor_sync(0xffffffffu, v[q], 1);
        if (j == 0) cl.map_shared_rank(p3, 0)[(rank * D4 + q) * s_tile + s3] = v[q];
      }
    }
    if (threadIdx.x >= 32) cluster_wait();  // the last exchange's barrier, long complete
    cl.sync();  // rank 0 holds every block's partial sums; every copy of this tile is done
    if (rank == 0 && static_cast<int>(threadIdx.x) < ns) {
      const size_t row = static_cast<size_t>(row0 + threadIdx.x) * D4;
#pragma unroll
      for (int q = 0; q < D4; ++q) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kCluster; ++r) v += p3[(r * D4 + q) * s_tile + threadIdx.x];
        const float d = v + bias[kD1 + kN1 + kN2 + q];
        if (a.d[3]) a.d[3][row + q] = from_f32<T>(d);
        y[row + q] = from_f32<T>(d > 0.f ? d : a.slope[3] * d);
      }
    }
  }
}

int smem_set[2][kMaxD4] = {};  // the float32 and bfloat16 instances', each last width's

// The clusters of blocks of `smem` bytes that the card holds at once (the float32 instance's of
// last width 1; the others take the same shared memory).
int slots(int smem, int* out) {
  int err = allow_smem(mlp_cluster_kernel<float, 1>, smem, &smem_set[0][0]);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, mlp_cluster_kernel<float, 1>, &cfg));
}

template <class T, int D4>
int launch(const T* x, T* y, int batch, const Args<T>& a, int s_tile, int clusters, int smem,
           void* stream) {
  const int n_tiles = batch > 0 ? (batch + s_tile - 1) / s_tile : 0;
  if (batch <= 0 || s_tile < kTs || s_tile > kMaxS || s_tile % kTs || clusters < 1 ||
      clusters > n_tiles || a.d0 < 16 || a.d0 > kMaxD0 || a.d0 % 16 ||
      smem != smem_floats(a.d0, s_tile) * 4)
    return cudaErrorInvalidValue;
  if (reinterpret_cast<std::uintptr_t>(x) % 16) return cudaErrorInvalidValue;
  for (int j = 0; j < 4; ++j)
    if (reinterpret_cast<std::uintptr_t>(a.w[j]) % 16 ||
        (j < 3 && reinterpret_cast<std::uintptr_t>(a.b[j]) % 16))
      return cudaErrorInvalidValue;
  const int err = allow_smem(mlp_cluster_kernel<T, D4>, smem,
                             &smem_set[std::is_same<T, bf16>::value][D4 - 1]);
  if (err) return err;
  mlp_cluster_kernel<T, D4><<<clusters * kCluster, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(x, y, batch, s_tile, n_tiles,
                                                                   a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cluster

// ---------------------------------------------------------------------------
// The small heads' path: chains of 1-8 layers whose every width is at most 64 (the classifier),
// a warp a sample, no block barrier between the layers.
namespace head {

constexpr int kWarps = 8, kThreads = 32 * kWarps;  // a tile of kWarps samples a block
constexpr int kMaxWidth = 64;

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Floats of a block's shared memory: each layer's weight (D_j, D_{j+1}), then its bias, each
// rounded up to 4 floats, layer by layer; then each warp's two activation rows of kMaxWidth.
inline int smem_floats(const int* dims, int n_layers) {
  int n = 0;
  for (int j = 0; j < n_layers; ++j) n += round4(dims[j] * dims[j + 1]) + round4(dims[j + 1]);
  return n + kWarps * 2 * kMaxWidth;
}

// n floats from src (global) to dst (shared, 16-byte aligned) by cp.async: 16-byte copies where
// src is 16-byte aligned and n a multiple of 4, else 4-byte ones; n bfloat16 values by loads,
// upcast.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  if (n % 4 == 0 && reinterpret_cast<std::uintptr_t>(src) % 16 == 0)
    for (int i = threadIdx.x; i < n / 4; i += kThreads) cp_async16(dst + 4 * i, src + 4 * i, true);
  else
    for (int i = threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i, true);
}
__device__ __forceinline__ void stage(float* dst, const bf16* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = to_f32(src[i]);
}

// Sample s's input in the warp: lane k holds x[s, k] in a0 and x[s, k + 32] in a1, 0 past D0
// and past the batch.
template <class T>
__device__ __forceinline__ void load_x(const T* __restrict__ x, int s, int batch, int d0,
                                       int lane, float& a0, float& a1) {
  const T* xs = x + static_cast<size_t>(s) * d0;
  a0 = s < batch && lane < d0 ? to_f32(__ldg(xs + lane)) : 0.f;
  a1 = s < batch && lane + 32 < d0 ? to_f32(__ldg(xs + lane + 32)) : 0.f;
}

// y out; phase_times.py's "products" cut guards this store by a condition no launch meets.
template <class T>
__device__ __forceinline__ void put(T* p, float v) { *p = from_f32<T>(v); }

// A chain's widths read from the launch's arguments (Any), or fixed at compile time (Dims<D0,
// D1, ...>: the classifier's instance, whose loops all unroll; the launch picks it where the
// widths match).
struct Any {};
template <int... W>
struct Dims {
  static constexpr int kLayers = sizeof...(W) - 1;
  __host__ __device__ static constexpr int at(int j) {
    constexpr int w[] = {W...};
    return j <= kLayers ? w[j] : 1;
  }
  static bool matches(const int* dims, int n_layers) {
    if (n_layers != kLayers) return false;
    for (int j = 0; j <= kLayers; ++j)
      if (dims[j] != at(j)) return false;
    return true;
  }
};
using Classifier = Dims<16, 16, 32, 16, 5>;

template <class D, class A>
__device__ __forceinline__ int layers(const A& a) {
  if constexpr (std::is_same<D, Any>::value) return a.n_layers; else return D::kLayers;
}
template <class D, class A>
__device__ __forceinline__ int width(const A& a, int j) {
  if constexpr (std::is_same<D, Any>::value) return a.dims[j]; else return D::at(j);
}

// acc0 (acc1) += column c0 (c1) of a . W (kTwo: dout > 32), a (din) the warp's activation row
// and W (din, dout) in shared memory, one fmaf chain over k ascending; every lane reads the same
// a_k (a broadcast). kFull: din is a compile-time constant and the loop unrolls whole, a read
// as float4s where din is a multiple of 4.
template <bool kFull, bool kTwo>
__device__ __forceinline__ void dots(const float* w, const float* a, int din, int dout, int c0,
                                     int c1, float& acc0, float& acc1) {
  const auto step = [&](int k, float ak) {
    acc0 = fmaf(ak, w[k * dout + c0], acc0);
    if constexpr (kTwo) acc1 = fmaf(ak, w[k * dout + c1], acc1);
  };
  if constexpr (kFull) {
    if (din % 4 == 0) {
#pragma unroll
      for (int k = 0; k < din; k += 4) {
        const float4 q = cluster::lds4(a + k);
        step(k, q.x), step(k + 1, q.y), step(k + 2, q.z), step(k + 3, q.w);
      }
    } else {
#pragma unroll
      for (int k = 0; k < din; ++k) step(k, a[k]);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < din; ++k) step(k, a[k]);
  }
}

// Block b walks tiles b, b + grid, ... of kWarps samples, warp w of the block sample w of the
// tile. Every layer's weights and biases are staged once a block, in one round of cp.async,
// beside the first tile's x (read into registers); the next tile's x is read while this one
// runs. A layer: lane c owns output columns c and c + 32 and reads the layer's input from the
// warp's activation row in shared memory (two rows, one a layer's input, the other its output,
// in turn; a __syncwarp between the layers, no block barrier); each column is one fmaf chain
// from 0 over k ascending, then + bias (d_j, written where asked) and LeakyReLU. Both loops over
// the layers run over kMaxLayers with the layer a compile-time index, so that each layer's
// pointers and slope are kernel parameters at fixed offsets; the classifier's instance has its
// widths, offsets and loop bounds as constants too, and its loads unroll ahead of the FMAs.
// T: the storage type of x, y, the weights, the biases and the d_j.
template <class T, class D>
__global__ void __launch_bounds__(kThreads)
mlp_head_kernel(const T* __restrict__ x, T* __restrict__ y, int batch, int n_tiles,
                ChainArgs<T> a) {
  constexpr bool kStatic = !std::is_same<D, Any>::value;
  extern __shared__ __align__(16) float sm[];
  const int n_layers = layers<D>(a);
  int off = 0;
#pragma unroll
  for (int j = 0; j < kMaxLayers; ++j) {
    if (j < n_layers) {
      const int n = width<D>(a, j) * width<D>(a, j + 1);
      stage(sm + off, a.w[j], n);
      stage(sm + off + round4(n), a.b[j], width<D>(a, j + 1));
      off += round4(n) + round4(width<D>(a, j + 1));
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, d0 = width<D>(a, 0);
  float* act = sm + off + warp * 2 * kMaxWidth;  // the warp's two activation rows
  int tile = blockIdx.x;
  float x0, x1;
  load_x(x, tile * kWarps + warp, batch, d0, lane, x0, x1);
  cp_async_wait_all();
  __syncthreads();
  for (; tile < n_tiles; tile += gridDim.x) {
    const int s = tile * kWarps + warp;
    float a0 = x0, a1 = x1;
    load_x(x, (tile + gridDim.x) * kWarps + warp, batch, d0, lane, x0, x1);
    if (s >= batch) continue;  // the warp's sample is past the batch: warp-uniform
    act[lane] = a0;
    act[lane + 32] = a1;
    __syncwarp();
    const float* w = sm;
    int dl = d0;
#pragma unroll
    for (int j = 0; j < kMaxLayers; ++j) {
      if (j < n_layers) {
        const int din = width<D>(a, j), dout = width<D>(a, j + 1);
        const float* bias = w + round4(din * dout);
        const bool hi = lane + 32 < dout;
        const int c0 = lane < dout ? lane : 0, c1 = hi ? lane + 32 : 0;  // in range where unused
        float acc0 = 0.f, acc1 = 0.f;
        const float* in = act + (j & 1) * kMaxWidth;
        if (dout > 32)
          dots<kStatic, true>(w, in, din, dout, c0, c1, acc0, acc1);
        else
          dots<kStatic, false>(w, in, din, dout, c0, c1, acc0, acc1);
        const float slope = a.slope[j];
        const float e0 = acc0 + bias[c0], e1 = acc1 + bias[c1];
        if (a.d[j]) {
          T* dj = a.d[j] + static_cast<size_t>(s) * dout;
          if (lane < dout) dj[lane] = from_f32<T>(e0);
          if (hi) dj[lane + 32] = from_f32<T>(e1);
        }
        a0 = lane < dout ? (e0 > 0.f ? e0 : slope * e0) : 0.f;
        a1 = hi ? (e1 > 0.f ? e1 : slope * e1) : 0.f;
        float* out = act + ((j + 1) & 1) * kMaxWidth;  // the next layer's input
        out[lane] = a0;
        out[lane + 32] = a1;
        __syncwarp();
        dl = dout;
        w = bias + round4(dout);
      }
    }
    if (lane < dl) put(y + static_cast<size_t>(s) * dl + lane, a0);
    if (lane + 32 < dl) put(y + static_cast<size_t>(s) * dl + lane + 32, a1);
  }
}

int smem_set[4] = {0, 0, 0, 0};

template <class T, class D>
int launch_instance(const T* x, T* y, int batch, int n_tiles, const ChainArgs<T>& a, int grid,
                    int smem, cudaStream_t s) {
  const int err = allow_smem(mlp_head_kernel<T, D>, smem,
                             &smem_set[2 * std::is_same<T, bf16>::value +
                                       std::is_same<D, Any>::value]);
  if (err) return err;
  mlp_head_kernel<T, D><<<grid, kThreads, smem, s>>>(x, y, batch, n_tiles, a);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch(const T* x, T* y, int batch, const ChainArgs<T>& a, int tile, int grid, int smem,
           void* stream) {
  const int n_tiles = batch > 0 ? (batch + kWarps - 1) / kWarps : 0;
  if (batch <= 0 || tile != kWarps || grid < 1 || grid > n_tiles || a.n_layers < 1 ||
      a.n_layers > kMaxLayers)
    return cudaErrorInvalidValue;
  for (int j = 0; j <= a.n_layers; ++j)
    if (a.dims[j] < 1 || a.dims[j] > kMaxWidth) return cudaErrorInvalidValue;
  if (smem != smem_floats(a.dims, a.n_layers) * static_cast<int>(sizeof(float)) ||
      smem > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return Classifier::matches(a.dims, a.n_layers)
             ? launch_instance<T, Classifier>(x, y, batch, n_tiles, a, grid, smem, s)
             : launch_instance<T, Any>(x, y, batch, n_tiles, a, grid, smem, s);
}

}  // namespace head

namespace {

// A chain of n_layers layers as iins_mlp_chain and iins_mlp_head take it (the widths unchecked).
template <class T>
ChainArgs<T> chain_args(int n_layers, const void* const* ws, const void* const* bs,
                        const int* dims, const float* slopes, void* const* ds) {
  ChainArgs<T> a{};
  a.n_layers = n_layers;
  for (int j = 0; j <= n_layers; ++j) {
    a.dims[j] = dims[j];
    a.width = dims[j] > a.width ? dims[j] : a.width;
  }
  for (int j = 0; j < n_layers; ++j) {
    a.w[j] = static_cast<const T*>(ws[j]);
    a.b[j] = static_cast<const T*>(bs[j]);
    a.slope[j] = slopes[j];
    a.d[j] = ds ? static_cast<T*>(ds[j]) : nullptr;
  }
  return a;
}

template <class T>
int launch_cluster(const void* x, void* y, int batch, int d0, int d4, const void* const* ws,
                   const void* const* bs, const float* slopes, void* const* ds, int tile,
                   int clusters, int smem, void* stream) {
  cluster::Args<T> a{};
  a.d0 = d0;
  for (int j = 0; j < 4; ++j) {
    a.w[j] = static_cast<const T*>(ws[j]);
    a.b[j] = static_cast<const T*>(bs[j]);
    a.slope[j] = slopes[j];
    a.d[j] = ds ? static_cast<T*>(ds[j]) : nullptr;
  }
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (d4 == 1) return cluster::launch<T, 1>(xt, yt, batch, a, tile, clusters, smem, stream);
  if (d4 == 2) return cluster::launch<T, 2>(xt, yt, batch, a, tile, clusters, smem, stream);
  return cudaErrorInvalidValue;
}

template <class T>
int launch_head(const void* x, void* y, int batch, int n_layers, const void* const* ws,
                const void* const* bs, const int* dims, const float* slopes, void* const* ds,
                int tile, int grid, int smem, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  return head::launch(static_cast<const T*>(x), static_cast<T*>(y), batch,
                      chain_args<T>(n_layers, ws, bs, dims, slopes, ds), tile, grid, smem,
                      stream);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ws, bs: n_layers device pointers (host arrays); dims: n_layers + 1 widths;
// slopes: n_layers LeakyReLU negative slopes; ds: null, or n_layers device
// pointers (a host array) to write the pre-activations to.
int iins_mlp_chain(const float* x, float* y, int batch, int n_layers, const void* const* ws,
                   const void* const* bs, const int* dims, const float* slopes,
                   void* const* ds, void* stream) {
  if (batch <= 0 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  for (int j = 0; j <= n_layers; ++j)
    if (dims[j] <= 0 || (j > 0 && (dims[j] > kTileFloats ||
                                   dims[j] * lanes_for(dims[j]) > kMaxCols * kThreads)))
      return cudaErrorInvalidValue;
  const MlpArgs a = chain_args<float>(n_layers, ws, bs, dims, slopes, ds);
  const size_t smem = (2 * static_cast<size_t>(kRows) * a.width + kTileFloats) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + kRows - 1) / kRows;
  mlp_chain_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, y, batch, a);
  return static_cast<int>(cudaGetLastError());
}

// K4 on the restorers' path (namespace cluster): x (B, d0) -> y (B, d4) through d0 -> 512 -> 256
// -> 256 -> d4, d4 1 or 2 (the soft restorer's mu, logvar); ws, bs, slopes, ds as for
// iins_mlp_chain (4 layers). tile (12, 24 or 36 samples), clusters (1 .. ceil(B / tile)) and smem
// (a block's dynamic shared memory) as fused.mlp_cluster_plan gives them; the launch refuses any
// other.
int iins_mlp_cluster(const float* x, float* y, int batch, int d0, int d4, const void* const* ws,
                     const void* const* bs, const float* slopes, void* const* ds, int tile,
                     int clusters, int smem, void* stream) {
  return launch_cluster<float>(x, y, batch, d0, d4, ws, bs, slopes, ds, tile, clusters, smem,
                               stream);
}

// The same, the bfloat16 instance: x, y, the weights, the biases and ds bfloat16; the plan
// (tile, clusters, smem) that of float32.
int iins_mlp_cluster_bf16(const void* x, void* y, int batch, int d0, int d4,
                          const void* const* ws, const void* const* bs, const float* slopes,
                          void* const* ds, int tile, int clusters, int smem, void* stream) {
  return launch_cluster<bf16>(x, y, batch, d0, d4, ws, bs, slopes, ds, tile, clusters, smem,
                              stream);
}

// *out = the clusters of the restorers' path that the card holds at once, its blocks taking
// smem bytes of shared memory each.
int iins_mlp_cluster_slots(int smem, int* out) { return cluster::slots(smem, out); }

// K4 on the small heads' path (namespace head): 1-8 layers, every width 1 .. 64; ws, bs, dims,
// slopes, ds as for iins_mlp_chain. tile (8 samples), grid (the persistent blocks, 1 ..
// ceil(B / tile)) and smem (a block's dynamic shared memory) as fused.mlp_head_plan and
// mlp_head_smem give them; the launch refuses any other.
int iins_mlp_head(const float* x, float* y, int batch, int n_layers, const void* const* ws,
                  const void* const* bs, const int* dims, const float* slopes, void* const* ds,
                  int tile, int grid, int smem, void* stream) {
  return launch_head<float>(x, y, batch, n_layers, ws, bs, dims, slopes, ds, tile, grid, smem,
                            stream);
}

// The same, the bfloat16 instance: x, y, the weights, the biases and ds bfloat16; the plan
// (tile, grid, smem) that of float32.
int iins_mlp_head_bf16(const void* x, void* y, int batch, int n_layers, const void* const* ws,
                       const void* const* bs, const int* dims, const float* slopes,
                       void* const* ds, int tile, int grid, int smem, void* stream) {
  return launch_head<bf16>(x, y, batch, n_layers, ws, bs, dims, slopes, ds, tile, grid, smem,
                           stream);
}

}  // extern "C"
