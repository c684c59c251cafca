// K7b res_block_2d_bwd: the backward of K7's 2-D residual block, IN and
// AdaIN, from the upstream gradient g of y = x + a2:
//   a2 = N2(d2), d2 = conv3x3(y1, k2), y1 = relu(a1), a1 = N1(d1), d1 = conv3x3(x, k1)
//   AdaIN: dgamma2[s, c] = sum_pix g * xn2, dbeta2[s, c] = sum_pix g; gxn2 = g * gamma2
//   gd2 = r2 * (gxn2 - mean(gxn2) - xn2 * mean(gxn2 * xn2))   (IN backward,
//         the two-pass statistics of the forward; r = 1/sqrt(var + eps))
//   dk2[dh, dw, ci, co] = sum_{b, pix} y1[b, src(pix; dh, dw), ci] * gd2[b, pix, co]
//   dy1 = conv3x3^T(gd2, k2); ga1 = dy1 where a1 > 0; then as above to gd1, dk1
//   dx = g + conv3x3^T(gd1, k1)
// with src(pix; dh, dw) the reflect-padded source pixel.
//
// Replaces the backward of fused_res_block_2d (iinsvae_tpu/ops/pallas/
// res2d.py:434, kernel _bwd_kernel :201 via pallas_call :377). The Pallas
// body reads the pre-norm activations its forward saved and returns the
// gradients of the lane-mix matrices, which XLA maps back to the taps; this
// kernel recomputes the block from the saved x with K7's own device code
// (res_block_2d.cuh) and returns the (3, 3, C, C) taps' gradients directly.
//
// The reflect adjoint folds on both axes: output row h reads row
// reflect(h + dh - 1), so row 1 is read by h = 0 and h = 2 through dh = 0,
// row 6 by h = 5 and h = 7 through dh = 2, and likewise for columns. For
// each (dh, dw) the block first sums gd over the outputs that read each
// input pixel (fold_tap, at most 2 x 2 of them), then runs the same
// register-tiled product as the forward against the transposed tap slice.
//
// Weight gradients sum over the batch without atomics: each block writes
// its two samples' partial d(taps) (2 x 36,864 floats) to its row of a
// (grid, 73,728) buffer, and a second kernel sums the rows in block order,
// so two backward passes give bit-equal gradients. The AdaIN gradients are
// per sample, written directly as (B, C) tables.
//
// Bound on the H100 at batch 500: the recomputed forward (2 convs), dk1
// and dk2, dy1 and dx are six conv-equivalents, 14.2 GFLOP (211 us at 67
// TFLOP/s fp32), against ~33 MB of x, g and dx (10 us): bound by
// operations. A block keeps x, d1, y1 (then ga1), d2 (then gd2) and the
// folded gradient of its two samples in shared memory (190 KB: one block
// an SM).
#include "conv_bwd_common.cuh"
#include "res_block_2d.cuh"

namespace {

using namespace res2d;

constexpr int kTapGrads = kTaps * kC * kC;  // one conv's d(taps)
constexpr size_t kSmem =
    (5 * kSamples * kField + kTile + 6 * kSamples * kC) * sizeof(float);

// The output rows (columns) whose tap d reads row u, at most two: -> count.
__device__ __forceinline__ int readers(int u, int d, int (&r)[2]) {
  int n = 0;
  const int h = u + 1 - d;
  if (h >= 0 && h < kH) r[n++] = h;
  if (d == 0 && u == 1) r[n++] = 0;
  if (d == 2 && u == kH - 2) r[n++] = kH - 1;
  return n;
}

// T[s][u][v][c] = the sum of gd[s][h][w][c] over the outputs (h, w) whose
// tap (dh, dw) reads pixel (u, v), for every sample of the block.
__device__ void fold_tap(const float* gd, float* T, int dh, int dw) {
  for_each4(kSamples, [&](int s, int pix, int c) {
    int hs[2], ws[2];
    const int nh = readers(pix / kW, dh, hs), nw = readers(pix % kW, dw, ws);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < nh; ++i)
      for (int j = 0; j < nw; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(gd + s * kField + (hs[i] * kW + ws[j]) * kPS + c);
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
    *reinterpret_cast<float4*>(T + s * kField + pix * kPS + c) = a;
  });
}

// acc = the thread's tile of conv3x3^T(gd, k): the gradient of a conv's
// input from the gradient gd of its output (both the block's fields).
__device__ void conv3x3_input_grad(const float* gd, float* T, const float* __restrict__ k,
                                   float* W, const Tile& t, float (&acc)[4][8]) {
  zero(acc);
  int own[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) own[p] = tile_pixel(t, p);
  for (int tap = 0; tap < kTaps; ++tap) {
    __syncthreads();  // T and W are no longer read; gd is written
    fold_tap(gd, T, tap / 3, tap % 3);
    load_tap_tile(W, k + tap * kTapFloats, true);
    __syncthreads();
    tile_mac(T + t.s * kField, own, W, t.n0, acc);
  }
}

// part[tap][ci][co] = sum over the first ns samples and the 64 pixels of
// in[s][src(pix; tap)][ci] * gd[s][pix][co]: the block's share of a conv's
// d(taps). A thread owns a 4 (ci) x 4 (co) tile of each tap slice.
__device__ void taps_grad(const float* in, const float* gd, int ns, float* __restrict__ part) {
  const int k0 = (threadIdx.x >> 4) * 4, n0 = (threadIdx.x & 15) * 4;
  for (int tap = 0; tap < kTaps; ++tap) {
    const int dh = tap / 3, dw = tap % 3;
    float acc[4][4] = {};
    for (int s = 0; s < ns; ++s) {
      const float* is = in + s * kField + k0;
      const float* gs = gd + s * kField + n0;
      for (int pix = 0; pix < kPix; ++pix) {
        const int src = reflect8(pix / kW + dh - 1) * kW + reflect8(pix % kW + dw - 1);
        const float4 a = *reinterpret_cast<const float4*>(is + src * kPS);
        const float4 b = *reinterpret_cast<const float4*>(gs + pix * kPS);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
          acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
          acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
          acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(part + tap * kC * kC + (k0 + i) * kC + n0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
}

// In place, for the first ns samples: ga (the gradient of a = N(d)) becomes
// gd, the gradient of the conv output d, from d's statistics (mean, rstd)
// and the affine gamma (null for IN). For each (s, c):
//   sa = sum ga, sx = sum ga * xn (AdaIN: dbeta and dgamma, written to the
//   block's rows of the (B, C) tables dg, db)
//   gd = rstd * gamma * (ga - sa / 64 - xn * sx / 64).
// ``ga`` is a shared field, or (gx) the upstream gradient in device memory,
// read at the block's first sample, with gd written to ``out``.
__device__ void norm_grad(const float* ga, const float* __restrict__ gx, const float* d,
                          float* out, int ns, const float* mean, const float* rstd,
                          const float* __restrict__ g, float* dg, float* db, float* ca,
                          float* cx) {
  {
    const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
    const int s = pair / kC, c = pair % kC;
    float sa = 0.f, sx = 0.f;
    if (s < ns)
      for (int i = lane; i < kPix; i += 2) {
        const float a = gx ? __ldg(gx + (s * kPix + i) * kC + c) : ga[s * kField + i * kPS + c];
        sa += a;
        sx = fmaf(a, (d[s * kField + i * kPS + c] - mean[pair]) * rstd[pair], sx);
      }
    sa += __shfl_xor_sync(kFull, sa, 1);
    sx += __shfl_xor_sync(kFull, sx, 1);
    if (lane == 0) {
      ca[pair] = sa * (1.f / kPix);
      cx[pair] = sx * (1.f / kPix);
      if (dg && s < ns) {
        dg[pair] = sx;
        db[pair] = sa;
      }
    }
  }
  __syncthreads();
  for_each4(ns, [&](int s, int pix, int c) {
    const int f = s * kField + pix * kPS + c;
    const float4 a = gx ? __ldg(reinterpret_cast<const float4*>(gx + (s * kPix + pix) * kC + c))
                        : *reinterpret_cast<const float4*>(ga + f);
    const float4 v = *reinterpret_cast<const float4*>(d + f);
    const float av[4] = {a.x, a.y, a.z, a.w}, vv[4] = {v.x, v.y, v.z, v.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = s * kC + c + j;
      const float xn = (vv[j] - mean[q]) * rstd[q];
      const float scale = g ? rstd[q] * __ldg(g + q) : rstd[q];
      r[j] = scale * (av[j] - ca[q] - xn * cx[q]);
    }
    *reinterpret_cast<float4*>(out + f) = make_float4(r[0], r[1], r[2], r[3]);
  });
}

__global__ void __launch_bounds__(kThreads, 1)
res_block_2d_bwd_kernel(const float* __restrict__ x, const float* __restrict__ k1,
                        const float* __restrict__ k2, const float* __restrict__ g1,
                        const float* __restrict__ b1, const float* __restrict__ g2,
                        const float* __restrict__ g, float* __restrict__ dx,
                        float* __restrict__ part, float* dg1, float* db1, float* dg2,
                        float* db2, int batch) {
  extern __shared__ __align__(16) float smem[];
  float* fx = smem;                        // x
  float* f1 = fx + kSamples * kField;      // d1, then gd1
  float* fy = f1 + kSamples * kField;      // y1, then ga1
  float* f2 = fy + kSamples * kField;      // d2, then gd2
  float* ft = f2 + kSamples * kField;      // the folded gradient of one tap
  float* W = ft + kSamples * kField;
  float* m1 = W + kTile;
  float* r1 = m1 + kSamples * kC;
  float* m2 = r1 + kSamples * kC;
  float* r2 = m2 + kSamples * kC;
  float* ca = r2 + kSamples * kC;
  float* cx = ca + kSamples * kC;
  const int s0 = blockIdx.x * kSamples;
  const int ns = min(kSamples, batch - s0);
  const size_t off = static_cast<size_t>(s0) * kPix * kC;
  if (g1) {
    g1 += s0 * kC;
    b1 += s0 * kC;
    g2 += s0 * kC;
    dg1 += s0 * kC;
    db1 += s0 * kC;
    dg2 += s0 * kC;
    db2 += s0 * kC;
  }
  part += static_cast<size_t>(blockIdx.x) * 2 * kTapGrads;
  const Tile t = my_tile();
  float acc[4][8];

  // the forward, as K7 computes it
  load_fields(x + off, fx, ns);
  conv3x3(fx + t.s * kField, k1, W, t, acc);
  store_tile(f1 + t.s * kField, t, acc);
  __syncthreads();
  channel_stats(f1, m1, r1);
  __syncthreads();
  norm_relu(f1, fy, ns, m1, r1, g1, b1);
  conv3x3(fy + t.s * kField, k2, W, t, acc);
  store_tile(f2 + t.s * kField, t, acc);
  __syncthreads();
  channel_stats(f2, m2, r2);
  __syncthreads();

  // the second norm and conv
  norm_grad(nullptr, g + off, f2, f2, ns, m2, r2, g2, dg2, db2, ca, cx);
  __syncthreads();
  taps_grad(fy, f2, ns, part + kTapGrads);
  conv3x3_input_grad(f2, ft, k2, W, t, acc);
  // ga1 = dy1 where a1 > 0, i.e. where y1 > 0, into y1's field
  {
    float* ys = fy + t.s * kField;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      float* o = ys + tile_pixel(t, p) * kPS + t.n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* e = o + (j < 4 ? j : 28 + j);
        *e = *e > 0.f ? acc[p][j] : 0.f;
      }
    }
  }
  __syncthreads();

  // the first norm and conv
  norm_grad(fy, nullptr, f1, f1, ns, m1, r1, g1, dg1, db1, ca, cx);
  __syncthreads();
  taps_grad(fx, f1, ns, part);
  if (dx) {
    conv3x3_input_grad(f1, ft, k1, W, t, acc);
    if (t.s < ns) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const size_t i = off + (t.s * kPix + tile_pixel(t, p)) * kC + t.n0;
        const float4 ga = __ldg(reinterpret_cast<const float4*>(g + i));
        const float4 gb = __ldg(reinterpret_cast<const float4*>(g + i + 32));
        *reinterpret_cast<float4*>(dx + i) = make_float4(
            acc[p][0] + ga.x, acc[p][1] + ga.y, acc[p][2] + ga.z, acc[p][3] + ga.w);
        *reinterpret_cast<float4*>(dx + i + 32) = make_float4(
            acc[p][4] + gb.x, acc[p][5] + gb.y, acc[p][6] + gb.z, acc[p][7] + gb.w);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, g (B, 8, 8, 64); k1, k2 (3, 3, 64, 64); g1, b1, g2 (B, 64) for the
// AdaIN block, null for the InstanceNorm block (beta2 does not enter the
// backward). Out: dx (B, 8, 8, 64) or null (not needed); dk (2 x 36,864:
// dk1 then dk2); dg1, db1, dg2, db2 (B, 64) for AdaIN, else null. part is
// scratch of ceil(B / 2) x 73,728 floats. Every pointer 16-byte aligned.
int iins_res_block_2d_bwd(const float* x, const float* k1, const float* k2, const float* g1,
                          const float* b1, const float* g2, const float* g, float* dx,
                          float* part, float* dk, float* dg1, float* db1, float* dg2,
                          float* db2, int batch, void* stream) {
  if (batch <= 0 || !x || !k1 || !k2 || !g || !part || !dk) return cudaErrorInvalidValue;
  const bool adain = g1 != nullptr;
  if (adain != (b1 != nullptr) || adain != (g2 != nullptr) || adain != (dg1 != nullptr) ||
      adain != (db1 != nullptr) || adain != (dg2 != nullptr) || adain != (db2 != nullptr))
    return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(res_block_2d_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (batch + kSamples - 1) / kSamples;
  res_block_2d_bwd_kernel<<<grid, kThreads, kSmem, s>>>(x, k1, k2, g1, b1, g2, g, dx, part, dg1,
                                                        db1, dg2, db2, batch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return iins::launch_reduce(part, grid, 2 * kTapGrads, dk, s);
}

}  // extern "C"
