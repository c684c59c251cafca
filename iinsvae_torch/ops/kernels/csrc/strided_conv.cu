// K3 strided_conv: y = relu(conv1d(x, taps, k=4, s=2, zero pad 1) + bias),
// x (B, L_in, C_in) channels-last, taps (4, C_in, C_out), fp32.
//
// Replaces fused_strided_conv (iinsvae_tpu/ops/pallas/strided_conv.py:250,
// forward pallas_call :192, kernel _fwd_kernel :126). The TPU kernel's
// 128-lane row tiles, prev/cur/next sublane rolls and W3 assembly
// (:101-123) are lane devices; this kernel computes the same function as
// the window product of strided_conv.cuh: Y = A . W, A the overlapping
// 4*C_in-float windows of x.
//
// Bound on the H100 at batch 500: at the env's first stride-2 stage
// ((128, 16) -> (64, 32)) it moves x in and y out, 8.2 MB (2.45 us at 3.35
// TB/s), for 65.5 M multiply-adds (1.96 us at 67 TFLOP/s fp32): bound by
// bytes; at the second ((64, 32) -> (32, 64)) 131 M multiply-adds (3.9 us)
// over the same 8.2 MB: bound by operations. The generic conv kernel it replaces
// issued one 16-byte read of the taps from L1 for every 4 FMAs and was
// bound by those loads. Here a block stages W (8-32 KB), the bias and its
// tile's input rows in shared memory once (cp.async), and each thread keeps
// a register tile of 4 rows x 8 channels: per step of 4 input channels it
// reads 4 float4 of A and 8 float4 of W from shared memory for 128
// independent FMAs. Full fp32 FMAs in the composed path's order (tap, then
// input channel), no TF32. The epilogue adds the bias, applies the ReLU
// and stores float4s, a warp's stores covering whole rows.
//
// Thread layout: ncg = C_out_pad / 8 channel groups (C_out_pad = C_out
// rounded up to 8, zero columns past C_out), channel group cg owning
// channels 4cg..4cg+3 and C_out_pad/2 + 4cg..+3 so that a quarter warp's W
// reads are one contiguous 128-byte row segment; nrg = 128 / ncg row
// groups, row group rg owning tile rows rg + m*nrg, m < 4; a tile is 4*nrg
// rows. C_out up to 1024, and W with the tile within the 227 KB of shared
// memory a block can have.
#include "strided_conv.cuh"

namespace {

using namespace iins_sc;

constexpr int kRowsPerThread = 4;
constexpr int kTargetThreads = 128;

struct Plan {
  int ncg, nrg, tm, cp, sx, smem;
};

Plan plan_for(int l_in, int c_in, int c_out) {
  Plan pl;
  pl.cp = (c_out + 7) / 8 * 8;
  pl.ncg = pl.cp / 8;
  pl.sx = c_in + 4;  // keeps a warp's A reads on distinct banks
  pl.smem = -1;
  const int p = l_in / 2;
  // the largest tile that fits: short samples put many segments in a tile
  for (pl.nrg = kTargetThreads / pl.ncg; pl.nrg >= 1; pl.nrg /= 2) {
    pl.tm = kRowsPerThread * pl.nrg;
    const size_t floats = static_cast<size_t>(4) * c_in * pl.cp + pl.cp +
                          static_cast<size_t>(2 * pl.tm + 2 * max_segments(pl.tm, p)) * pl.sx;
    if (floats * sizeof(float) <= static_cast<size_t>(kMaxSmem)) {
      pl.smem = static_cast<int>(floats * sizeof(float));
      break;
    }
  }
  return pl;
}

__global__ void __launch_bounds__(kTargetThreads)
strided_conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y, Geom g, int tm,
                    int ncg) {
  extern __shared__ __align__(16) float smem[];
  const int cp = 8 * ncg, half = 4 * ncg, kk = 4 * g.c_in, sx = g.c_in + 4;
  float* ws = smem;      // (4*C_in, cp)
  float* bs = ws + kk * cp;  // (cp)
  float* xs = bs + cp;   // the tile's staged input rows
  const int q0 = blockIdx.x * tm;
  const int n = min(tm, g.rows - q0);
  for (int it = threadIdx.x; it < (kk + 1) * ncg * 2; it += blockDim.x) {
    const int k = it / (2 * ncg), c = (it - k * 2 * ncg) * 4;
    const bool ok = c < g.c_out;
    if (k < kk)
      cp_async16(ws + k * cp + c, w + static_cast<size_t>(k) * g.c_out + (ok ? c : 0), ok);
    else
      cp_async16(bs + c, b + (ok ? c : 0), ok);
  }
  stage_x(x, g, q0, n, xs, sx);
  cp_async_wait_all();
  __syncthreads();

  const int nrg = blockDim.x / ncg;
  const int cg = threadIdx.x % ncg, rg = threadIdx.x / ncg;
  const int s0 = q0 / g.p;
  int base[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = min(rg + m * nrg, n - 1);  // rows past the tile read a staged row
    base[m] = 2 * (i + (q0 + i) / g.p - s0) * sx;
  }
  float acc[kRowsPerThread][8];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[m][v] = 0.f;

  for (int t = 0; t < 4; ++t) {
    const float* wt = ws + t * g.c_in * cp + 4 * cg;
    const float* xt = xs + t * sx;
    for (int c = 0; c < g.c_in; c += 4) {
      float4 a[kRowsPerThread];
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m)
        a[m] = *reinterpret_cast<const float4*>(xt + base[m] + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + (c + e) * cp);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + (c + e) * cp + half);
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const float av = e == 0 ? a[m].x : e == 1 ? a[m].y : e == 2 ? a[m].z : a[m].w;
          acc[m][0] = fmaf(av, w0.x, acc[m][0]);
          acc[m][1] = fmaf(av, w0.y, acc[m][1]);
          acc[m][2] = fmaf(av, w0.z, acc[m][2]);
          acc[m][3] = fmaf(av, w0.w, acc[m][3]);
          acc[m][4] = fmaf(av, w1.x, acc[m][4]);
          acc[m][5] = fmaf(av, w1.y, acc[m][5]);
          acc[m][6] = fmaf(av, w1.z, acc[m][6]);
          acc[m][7] = fmaf(av, w1.w, acc[m][7]);
        }
      }
    }
  }

  const float4 b0 = *reinterpret_cast<const float4*>(bs + 4 * cg);
  const float4 b1 = *reinterpret_cast<const float4*>(bs + half + 4 * cg);
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = rg + m * nrg;
    if (i >= n) continue;
    float* dst = y + static_cast<size_t>(q0 + i) * g.c_out;
    if (4 * cg < g.c_out)
      *reinterpret_cast<float4*>(dst + 4 * cg) = make_float4(
          fmaxf(acc[m][0] + b0.x, 0.f), fmaxf(acc[m][1] + b0.y, 0.f),
          fmaxf(acc[m][2] + b0.z, 0.f), fmaxf(acc[m][3] + b0.w, 0.f));
    if (half + 4 * cg < g.c_out)
      *reinterpret_cast<float4*>(dst + half + 4 * cg) = make_float4(
          fmaxf(acc[m][4] + b1.x, 0.f), fmaxf(acc[m][5] + b1.y, 0.f),
          fmaxf(acc[m][6] + b1.z, 0.f), fmaxf(acc[m][7] + b1.w, 0.f));
  }
}

int smem_set = 0;

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a launch at this shape takes, or -1 where it needs
// more than a block can have (the launch then fails).
int iins_strided_conv_smem(int l_in, int c_in, int c_out) {
  if (!shape_ok(1, l_in, c_in, c_out)) return -1;
  return plan_for(l_in, c_in, c_out).smem;
}

// x (batch, l_in, c_in), w (4, c_in, c_out), b (c_out) -> y (batch, l_in/2,
// c_out); C_in and C_out multiples of 4, every pointer 16-byte aligned.
int iins_strided_conv(const float* x, const float* w, const float* b, float* y, int batch,
                      int l_in, int c_in, int c_out, void* stream) {
  if (!shape_ok(batch, l_in, c_in, c_out) || !aligned16(x) || !aligned16(w) ||
      !aligned16(b) || !aligned16(y))
    return cudaErrorInvalidValue;
  const Plan pl = plan_for(l_in, c_in, c_out);
  if (pl.smem < 0) return cudaErrorInvalidValue;
  const int l_out = l_in / 2;
  const Geom g{batch, l_in, c_in, l_out, c_out, l_out, batch * l_out};
  int err = allow_smem(strided_conv_kernel, pl.smem, &smem_set);
  if (err) return err;
  const int grid = (g.rows + pl.tm - 1) / pl.tm;
  strided_conv_kernel<<<grid, pl.ncg * pl.nrg, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, y, g, pl.tm, pl.ncg);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
