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
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;
constexpr int kMaxLayers = 8;
constexpr int kMaxCols = 4;         // output columns a thread may own: dout*lanes <= 1024
constexpr int kTileFloats = 8192;   // 32 KB of weight rows
constexpr int kPrefetch = kTileFloats / 4 / kThreads;  // float4s a thread holds
constexpr size_t kMaxSmem = 48 * 1024;  // a block's default; the restorer needs exactly this

struct MlpArgs {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  float slope[kMaxLayers];
  float* d[kMaxLayers];  // each layer's pre-activations (B, dims[j + 1]), or null
  int dims[kMaxLayers + 1];
  int n_layers;
  int width;  // max(dims): length of each activation buffer, in kRows-float rows
};

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
  MlpArgs a{};
  a.n_layers = n_layers;
  a.width = 0;
  for (int j = 0; j <= n_layers; ++j) {
    if (dims[j] <= 0) return cudaErrorInvalidValue;
    if (j > 0 && (dims[j] > kTileFloats || dims[j] * lanes_for(dims[j]) > kMaxCols * kThreads))
      return cudaErrorInvalidValue;
    a.dims[j] = dims[j];
    a.width = dims[j] > a.width ? dims[j] : a.width;
  }
  for (int j = 0; j < n_layers; ++j) {
    a.w[j] = static_cast<const float*>(ws[j]);
    a.b[j] = static_cast<const float*>(bs[j]);
    a.slope[j] = slopes[j];
    a.d[j] = ds ? static_cast<float*>(ds[j]) : nullptr;
  }
  const size_t smem = (2 * static_cast<size_t>(kRows) * a.width + kTileFloats) * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + kRows - 1) / kRows;
  mlp_chain_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(x, y, batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
