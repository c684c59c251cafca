// K7 res_block_2d: one 2-D residual block of the expanded model,
//   y = x + N2(conv3x3(relu(N1(conv3x3(x, k1))), k2)),
// reflect pad 1 on both axes, no conv bias, on x (B, 8, 8, 64). N is
// InstanceNorm over each sample's 8x8 field per channel (the range
// encoder's blocks) or InstanceNorm followed by a per-sample (B, C) affine
// (the decoder's AdaIN blocks: y*gamma + beta).
//
// Replaces fused_res_block_2d (iinsvae_tpu/ops/pallas/res2d.py:434, forward
// kernel _fwd_kernel :174 via pallas_call :339), norm 'in' and 'adain'. The
// Pallas body folds the W-axis taps into three (W*C, W*C) lane-mix
// matrices (assemble_w3 :69, 5/8 of them zeros) over 128-lane rows and sums
// the statistics with an XOR butterfly; those are TPU layout devices. This
// kernel reads the (3, 3, C, C) taps directly. Under autograd it also writes
// the pre-norm conv outputs d1 and d2 for the backward, as the TPU kernel
// does (:182, :191): K7b reads them and recomputes no conv. Serving launches
// the instance that writes neither and pays nothing for training; training
// pays 2 x 4 B x 64 x 64 a sample, 16.4 MB at batch 500 (4.9 us at 3.35
// TB/s).
//
// Bound on the H100: the two convs are 2 x 64 pixels x 64 x 576
// multiply-adds a sample, 4.72 GFLOP at batch 500 (70 us at 67 TFLOP/s
// fp32), against 16.4 MB moved (4.9 us at 3.35 TB/s): bound by operations.
// One sample's field is 4096 floats and one conv's taps 36,864, so a
// block cannot hold the taps beside its samples: it owns two samples and
// streams the taps through a shared tile one (dh, dw) slice (64 x 64) at a
// time. Each thread keeps a 4-pixel x 8-channel tile of the conv in
// registers over the nine slices. The block also keeps the conv outputs and
// the mid-block activation on chip, so device memory sees x twice (the skip
// rereads it, from L2) and y once; the InstanceNorm statistics of a sample
// stay inside its block. Two blocks fit an SM (86 KB of shared memory
// each). The variance is two-pass: the TPU kernel's E[x^2] - mean^2 went
// negative (res2d.py:157).
#include "res_block_2d.cuh"

namespace {

using namespace res2d;

// Shared memory: fa (kSamples fields: x, then the second conv's output),
// fb (the first conv's output, then the mid-block activation), the tap
// tile and the statistics.
constexpr size_t kSmem = (2 * kSamples * kField + kTile + 2 * kSamples * kC) * sizeof(float);

// The thread's tile of a conv output into the sample's rows of a (B, 8, 8, C)
// tensor in device memory (K7b's saved d1, d2).
__device__ __forceinline__ void save_tile(float* __restrict__ out, const Tile& t,
                                          const float (&acc)[4][8]) {
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float* o = out + (t.s * kPix + tile_pixel(t, p)) * kC + t.n0;
    *reinterpret_cast<float4*>(o) = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    *reinterpret_cast<float4*>(o + 32) = make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
  }
}

// kSave: also write d1 and d2 (training); the arithmetic is the same either way.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 2)
res_block_2d_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                    const float* __restrict__ k2, const float* __restrict__ g1,
                    const float* __restrict__ b1, const float* __restrict__ g2,
                    const float* __restrict__ b2, float* __restrict__ y, float* __restrict__ d1,
                    float* __restrict__ d2, int batch) {
  extern __shared__ __align__(16) float smem[];
  float* fa = smem;
  float* fb = fa + kSamples * kField;
  float* W = fb + kSamples * kField;
  float* mean = W + kTile;
  float* rstd = mean + kSamples * kC;
  const int s0 = blockIdx.x * kSamples;
  const int ns = min(kSamples, batch - s0);
  const size_t off = static_cast<size_t>(s0) * kPix * kC;
  if (g1) {
    g1 += s0 * kC;
    b1 += s0 * kC;
    g2 += s0 * kC;
    b2 += s0 * kC;
  }
  const Tile t = my_tile();
  float acc[4][8];

  load_fields(x + off, fa, ns);
  conv3x3(fa + t.s * kField, k1, W, t, acc);
  store_tile(fb + t.s * kField, t, acc);
  if (kSave && t.s < ns) save_tile(d1 + off, t, acc);
  __syncthreads();
  channel_stats(fb, mean, rstd);
  __syncthreads();
  norm_relu(fb, fb, ns, mean, rstd, g1, b1);
  conv3x3(fb + t.s * kField, k2, W, t, acc);
  store_tile(fa + t.s * kField, t, acc);
  if (kSave && t.s < ns) save_tile(d2 + off, t, acc);
  __syncthreads();
  channel_stats(fa, mean, rstd);
  __syncthreads();
  for_each4(ns, [&](int s, int pix, int c) {
    const float4 v = *reinterpret_cast<const float4*>(fa + s * kField + pix * kPS + c);
    const size_t i = off + (s * kPix + pix) * kC + c;
    const float4 r = __ldg(reinterpret_cast<const float4*>(x + i));
    const int q = s * kC + c;
    *reinterpret_cast<float4*>(y + i) = make_float4(
        r.x + norm_affine(v.x, q, mean, rstd, g2, b2),
        r.y + norm_affine(v.y, q + 1, mean, rstd, g2, b2),
        r.z + norm_affine(v.z, q + 2, mean, rstd, g2, b2),
        r.w + norm_affine(v.w, q + 3, mean, rstd, g2, b2));
  });
}

template <bool kSave>
int launch(const float* x, const float* k1, const float* k2, const float* g1, const float* b1,
           const float* g2, const float* b2, float* y, float* d1, float* d2, int batch,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(res_block_2d_kernel<kSave>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  const int grid = (batch + kSamples - 1) / kSamples;
  res_block_2d_kernel<kSave><<<grid, kThreads, kSmem, stream>>>(x, k1, k2, g1, b1, g2, b2, y, d1,
                                                                d2, batch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y (B, 8, 8, 64); k1, k2 (3, 3, 64, 64); g1, b1, g2, b2 (B, 64) for the
// AdaIN block, all four null for the InstanceNorm block; d1, d2 (B, 8, 8, 64)
// the pre-norm conv outputs to save for K7b, both or neither null. Every
// pointer 16-byte aligned.
int iins_res_block_2d(const float* x, const float* k1, const float* k2, const float* g1,
                      const float* b1, const float* g2, const float* b2, float* y, float* d1,
                      float* d2, int batch, void* stream) {
  if (batch <= 0 || !x || !k1 || !k2 || !y || (d1 == nullptr) != (d2 == nullptr))
    return cudaErrorInvalidValue;
  if ((g1 == nullptr) != (b1 == nullptr) || (g1 == nullptr) != (g2 == nullptr) ||
      (g1 == nullptr) != (b2 == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d1 ? launch<true>(x, k1, k2, g1, b1, g2, b2, y, d1, d2, batch, s)
            : launch<false>(x, k1, k2, g1, b1, g2, b2, y, nullptr, nullptr, batch, s);
}

}  // extern "C"
