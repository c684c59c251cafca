// K4b mlp_chain_bwd: the backward of K4's Dense + LeakyReLU chain,
// y_{j+1} = leaky(d_j, slope_j), d_j = y_j @ W_j + b_j.
//
// Replaces the backward of fused_mlp_chain (iinsvae_tpu/ops/pallas/fused.py:1136,
// kernel _bwd_mlp_kernel :1087): dx, dW_j and db_j of the restorer head
// 16->512->256->256->1 and the classifier head 16->16->32->16->5. As there,
// the forward saved each layer's pre-activation d_j (K4 writes them under
// autograd), so nothing is recomputed; the LeakyReLU mask is
// where(d > 0, g, slope * g) (fused.py:1102).
//
// Two kernels in one call, both deterministic (no atomics; every sum runs
// in a fixed order, so two runs give bit-equal gradients):
// 1. chain: per tile of kRows samples, the gradient is carried layer by
//    layer from the output to the input, as K4 carries the activations
//    forward: gd_j = mask(g) is written to a workspace (B, D_{j+1}) and
//    g <- gd_j @ W_j^T, with the samples' vectors in shared memory and W_j
//    read through the read-only cache; the last g is dx.
// 2. wgrad: dW_j = Y_j^T @ GD_j and db_j = 1^T @ GD_j, a product over the
//    batch (Y_0 = x, Y_j = leaky(d_{j-1})), tiled 32 x 32 outputs a block,
//    the batch walked in order in chunks of 32 rows through shared memory.
//    The bias is row D_j of the extended (D_j + 1) x D_{j+1} output, whose
//    Y column is 1.
//
// Bound on the H100: at batch 500 the restorer's backward does 2 x 102 M
// multiply-adds (g @ W^T and the weight gradients, the forward's 102 M
// each) = 0.41 GFLOP, 6.1 us at 67 TFLOP/s fp32; it moves ~3 MB (x, the
// saved d_j, the weights in and their gradients out, the workspace
// twice): bound by operations. The classifier is latency whatever it does.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // samples a block in the chain kernel
constexpr int kMaxLayers = 8;
constexpr int kMaxCols = 4;  // output slots a thread may own: width*lanes <= kMaxCols*kThreads
constexpr int kMaxWidth = 1024;
constexpr int kTile = 32;  // wgrad output tile and batch chunk

struct BwdArgs {
  const float* w[kMaxLayers];   // W_j (D_j, D_{j+1})
  const float* d[kMaxLayers];   // saved pre-activations d_j (B, D_{j+1})
  float* gd[kMaxLayers];        // workspace: gd_j (B, D_{j+1})
  float* dwb[kMaxLayers];       // out: (D_j + 1, D_{j+1}), rows 0..D_j-1 dW_j, row D_j db_j
  float slope[kMaxLayers];
  int dims[kMaxLayers + 1];
  int tile0[kMaxLayers + 1];    // first wgrad block of layer j; tile0[n] = grid
  int n_layers;
  int width;                    // max(dims)
};

// Lanes per output for a layer of `n` outputs: a power of two <= 32 with
// n * lanes * 2 <= kThreads unless n alone fills the block.
__host__ __device__ inline int lanes_for(int n) {
  int g = 1;
  while (g < 32 && n * g * 2 <= kThreads) g *= 2;
  return g;
}

__global__ void __launch_bounds__(kThreads)
mlp_bwd_chain_kernel(const float* __restrict__ g_out, float* __restrict__ dx, int batch,
                     BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;                   // [width][kRows]: the gradient being carried
  float* nxt = cur + a.width * kRows;  // [width][kRows]
  const int r0 = blockIdx.x * kRows;
  const int nr = min(kRows, batch - r0);
  const int n = a.n_layers;
  const int d_last = a.dims[n];
  for (int i = threadIdx.x; i < kRows * d_last; i += blockDim.x) {
    const int r = i / d_last, k = i - r * d_last;
    cur[k * kRows + r] = r < nr ? g_out[static_cast<size_t>(r0 + r) * d_last + k] : 0.f;
  }
  __syncthreads();

  for (int j = n - 1; j >= 0; --j) {
    const int din = a.dims[j], dout = a.dims[j + 1];
    // gd_j = where(d_j > 0, g, slope * g), in place, and to the workspace
    const float slope = a.slope[j];
    for (int i = threadIdx.x; i < kRows * dout; i += blockDim.x) {
      const int r = i / dout, k = i - r * dout;
      if (r >= nr) {
        cur[k * kRows + r] = 0.f;
        continue;
      }
      const size_t at = static_cast<size_t>(r0 + r) * dout + k;
      const float g = cur[k * kRows + r];
      const float gd = __ldg(a.d[j] + at) > 0.f ? g : slope * g;
      cur[k * kRows + r] = gd;
      a.gd[j][at] = gd;
    }
    if (j == 0 && !dx) break;
    __syncthreads();

    // nxt[i] = sum_k gd[k] * W_j[i, k]: `lanes` threads share output i
    const int lanes = lanes_for(din);
    const int span = (din * lanes + blockDim.x - 1) / blockDim.x;  // <= kMaxCols
    const float* __restrict__ w = a.w[j];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      if (c >= span) break;  // uniform: every lane runs the shuffles below
      const int idx = threadIdx.x + c * blockDim.x;
      const int row = idx / lanes, part = idx - row * lanes;
      float acc[kRows] = {0.f, 0.f, 0.f, 0.f};
      if (row < din) {
        const float* wr = w + static_cast<size_t>(row) * dout;
        for (int k = part; k < dout; k += lanes) {
          const float wv = __ldg(wr + k);
          const float4 gv = *reinterpret_cast<const float4*>(cur + k * kRows);
          acc[0] = fmaf(gv.x, wv, acc[0]);
          acc[1] = fmaf(gv.y, wv, acc[1]);
          acc[2] = fmaf(gv.z, wv, acc[2]);
          acc[3] = fmaf(gv.w, wv, acc[3]);
        }
      }
      for (int off = lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
      }
      if (row < din && part == 0) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (j > 0) {
            nxt[row * kRows + r] = acc[r];
          } else if (r < nr) {
            dx[static_cast<size_t>(r0 + r) * din + row] = acc[r];
          }
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// One 32 x 32 tile of layer j's extended weight gradient a block.
__global__ void __launch_bounds__(kThreads)
mlp_wgrad_kernel(const float* __restrict__ x, int batch, BwdArgs a) {
  __shared__ float ys[kTile][kTile + 1];  // [b][i]
  __shared__ float gs[kTile][kTile + 1];  // [b][k]
  int j = 0;
  while (blockIdx.x >= a.tile0[j + 1]) ++j;
  const int din = a.dims[j], dout = a.dims[j + 1];
  const int tiles_k = (dout + kTile - 1) / kTile;
  const int t = blockIdx.x - a.tile0[j];
  const int i0 = (t / tiles_k) * kTile, k0 = (t % tiles_k) * kTile;
  const float* __restrict__ y = j == 0 ? x : a.d[j - 1];
  const float slope = j == 0 ? 1.f : a.slope[j - 1];
  const float* __restrict__ gd = a.gd[j];
  const int ii = threadIdx.x / 8, cc = (threadIdx.x % 8) * 4;  // outputs (ii, cc..cc+3)
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int b0 = 0; b0 < batch; b0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += blockDim.x) {
      const int bb = e / kTile, col = e - bb * kTile, b = b0 + bb;
      const int i = i0 + col, k = k0 + col;
      float yv = 0.f, gv = 0.f;
      if (b < batch) {
        if (i < din) {
          const float v = __ldg(y + static_cast<size_t>(b) * din + i);
          yv = v > 0.f ? v : slope * v;
        } else if (i == din) {
          yv = 1.f;  // the bias row
        }
        if (k < dout) gv = __ldg(gd + static_cast<size_t>(b) * dout + k);
      }
      ys[bb][col] = yv;
      gs[bb][col] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int bb = 0; bb < kTile; ++bb) {
      const float yv = ys[bb][ii];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(yv, gs[bb][cc + q], acc[q]);
    }
    __syncthreads();
  }
  const int i = i0 + ii;
  if (i > din) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = k0 + cc + q;
    if (k < dout) a.dwb[j][static_cast<size_t>(i) * dout + k] = acc[q];
  }
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// g (B, dims[n]); x (B, dims[0]); dx (B, dims[0]) or null (not needed).
// Host arrays of n device pointers: ws W_j, ds the saved d_j, gds the
// (B, dims[j+1]) workspaces, dwbs the (dims[j] + 1, dims[j+1]) outputs.
int iins_mlp_chain_bwd(const float* g, const float* x, float* dx, int batch, int n_layers,
                       const void* const* ws, const void* const* ds, void* const* gds,
                       void* const* dwbs, const int* dims, const float* slopes, void* stream) {
  if (batch <= 0 || n_layers < 1 || n_layers > kMaxLayers) return cudaErrorInvalidValue;
  BwdArgs a{};
  a.n_layers = n_layers;
  a.width = 0;
  a.tile0[0] = 0;
  for (int j = 0; j <= n_layers; ++j) {
    if (dims[j] <= 0 || dims[j] > kMaxWidth) return cudaErrorInvalidValue;
    a.dims[j] = dims[j];
    a.width = dims[j] > a.width ? dims[j] : a.width;
  }
  for (int j = 0; j < n_layers; ++j) {
    a.w[j] = static_cast<const float*>(ws[j]);
    a.d[j] = static_cast<const float*>(ds[j]);
    a.gd[j] = static_cast<float*>(gds[j]);
    a.dwb[j] = static_cast<float*>(dwbs[j]);
    a.slope[j] = slopes[j];
    // the chain kernel gives each input row `lanes` threads
    if (dims[j] * lanes_for(dims[j]) > kMaxCols * kThreads) return cudaErrorInvalidValue;
    a.tile0[j + 1] = a.tile0[j] + ((dims[j] + 1 + kTile - 1) / kTile) *
                                      ((dims[j + 1] + kTile - 1) / kTile);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = 2 * static_cast<size_t>(kRows) * a.width * sizeof(float);
  mlp_bwd_chain_kernel<<<(batch + kRows - 1) / kRows, kThreads, smem, s>>>(g, dx, batch, a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_wgrad_kernel<<<a.tile0[n_layers], kThreads, 0, s>>>(x, batch, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
