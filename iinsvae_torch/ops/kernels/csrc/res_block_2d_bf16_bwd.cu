// K7b res_block_2d_bwd, bfloat16 instance: the backward of K7's bfloat16 instance
// (res_block_2d_bf16.cu) from the bfloat16 upstream gradient g and the bfloat16 d1, d2 it
// saved, as the Pallas body computes it on bfloat16 refs (iinsvae_tpu/ops/pallas/
// res2d.py:201-283):
//   statistics of d2 and d1 taken again, in fp32, from the rounded d1, d2
//   gd2 = bf16(N2'(g, d2))                          (AdaIN: dgamma2, dbeta2 sums of g xn2, g)
//   y1 = bf16(relu(a1)), a1 = N1(d1)
//   dk2 = sum over the batch of y1-windows^T gd2    (fp32, rounded once)
//   dy1 = conv3x3^T(gd2, k2);  ga1 = dy1 where a1 > 0
//   gd1 = bf16(N1'(ga1, d1));  dk1 = sum of x-windows^T gd1;  dx = bf16(g + conv3x3^T(gd1, k1))
// Every product takes bfloat16 operands and sums in fp32; every output is rounded to
// bfloat16 once. conv3x3^T is the adjoint of the forward's conv with its edge slices
// (bf16(k[dh][0] + k[dh][2]) at the edge columns, res_block_2d_bf16.cu), as the Pallas
// backward multiplies by its lane-mix matrices; the taps' gradient is that of each tap. The
// Pallas kernel adds dk in bfloat16 across its grid's chunks of samples (:246-253, :271-278;
// _chunk :286 gives 25 samples a chunk at batch 500), VMEM scaffolding: here dk sums the whole
// batch in fp32 and rounds once, which equals the Pallas result wherever one chunk holds the
// batch. Plain version: backward.res_block_2d_bwd_bf16_ref.
//
// Bound on the H100 at batch 500: four conv-sized products, 9.44 GFLOP on the bfloat16 tensor
// cores (989 TFLOP/s), 9.5 us; ~20 MB of x, d1, d2, g and dx, 6.1 us at 3.35 TB/s. A first,
// simple design:
// - Persistent blocks of 256 threads, one a SM (at most ceil(B / 2)), walk over tiles of two
//   samples; shared memory (215 KB) holds gd (bfloat16, and a zero row), y1 then x
//   (bfloat16), twelve staged slices of the taps (bfloat16, (C_in, C_out) rows as stored,
//   res_block_2d_bf16.cuh), d2 then d1 (fp32), ga1 (fp32) and the statistics.
// - The taps' gradient is one (576 x 128) . (128 x 64) product a tile on the tensor cores
//   (mma.sync m16n8k16, bfloat16, fp32 accumulators), A gathered from the reflect-shifted
//   pixel rows of y1 or x, B from gd; a warp owns 9 of its 36 m-tiles x 32 output channels
//   and adds its tile's sums into the block's own fp32 row of a (blocks, 73,728) buffer;
//   a second kernel sums the rows in a fixed order and rounds, so two runs are bit-equal.
// - The input gradient is a (128 x 64) . (64 x 64) product a slice on the tensor cores,
//   summed in the mma's accumulators over the twelve slices and, for the slices of dh 0 and 2,
//   once more for the rows that reflection reads twice: A row p' = the gd row of the output
//   that reads input pixel p' through the slice (or a zero row), B = the slice^T; a warp owns
//   32 x 32 of it, each slice's four k-steps in a partial sum from zero added in fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"
#include "res_block_2d.cuh"
#include "res_block_2d_bf16.cuh"

namespace {

using namespace res2d;
using namespace res2d_bf16;

constexpr int kLdF = kC + 4;             // floats between two rows of an fp32 field
constexpr int kRows = kSamples * kPix;   // 128 pixel rows a tile
constexpr int kTapGrads = kTaps * kC * kC;
constexpr size_t kFieldBytes = kRows * kLd * sizeof(bf16);
constexpr size_t kGdBytes = (kRows + 1) * kLd * sizeof(bf16);  // and the zero row
constexpr size_t kTapBytes = kSlices * kSlice * sizeof(bf16);
constexpr size_t kF32Bytes = kRows * kLdF * sizeof(float);
constexpr size_t kSmem = kGdBytes + kFieldBytes + kTapBytes + 2 * kF32Bytes +
                         6 * kSamples * kC * sizeof(float);
static_assert(kGdBytes % 16 == 0 && kFieldBytes % 16 == 0 && kTapBytes % 16 == 0,
              "16-byte aligned regions");

// The pixel row that tile row p reads through tap t of the forward's conv (no edge slices:
// the taps' gradient is that of each tap).
__device__ __forceinline__ int tap_source(int p, int t) {
  const int s = p >> 6, u = (p >> 3) & 7, v = p & 7;
  return s * kPix + reflect8(u + t / 3 - 1) * kW + reflect8(v + t % 3 - 1);
}

// tile rows of a bfloat16 (B, 8, 8, C) tensor into an fp32 field (zeros past ns samples)
__device__ void load_f32(const bf16* __restrict__ src, float* dst, int ns) {
  for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    dst[r * kLdF + c] = r < ns * kPix ? __bfloat162float(src[i]) : 0.f;
  }
}

// The taps' gradient of one tile: part[tap][ci][co] (first: =, else +=) the sum over the
// tile's pixels of in[tap_source(p, tap)][ci] * gd[p][co]. m-tile j holds tap j / 4 and input
// channels (j % 4) * 16 .. + 15; warp w owns the m-tiles w / 2 + 4 i and the output channels
// (w % 2) * 32 .. + 31. A lane's k indices are pixels, so its operand pairs are gathered.
__device__ void taps_grad(const bf16* in, const bf16* gd, float* __restrict__ part,
                          bool first) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int co0 = (w & 1) * 32;
  for (int j = w >> 1; j < 4 * kTaps; j += 4) {
    const int tap = j >> 2, ci = (j & 3) * 16 + g;
    float acc[4][4];
#pragma unroll 1
    for (int ks = 0; ks < kRows / 16; ++ks) {
      const int p0 = 16 * ks + t2;
      const int s0 = tap_source(p0, tap), s1 = tap_source(p0 + 1, tap);
      const int s8 = tap_source(p0 + 8, tap), s9 = tap_source(p0 + 9, tap);
      uint32_t a[4];
      a[0] = pack(in[s0 * kLd + ci], in[s1 * kLd + ci]);
      a[1] = pack(in[s0 * kLd + ci + 8], in[s1 * kLd + ci + 8]);
      a[2] = pack(in[s8 * kLd + ci], in[s9 * kLd + ci]);
      a[3] = pack(in[s8 * kLd + ci + 8], in[s9 * kLd + ci + 8]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + 8 * nt + g;
        const uint32_t b0 = pack(gd[p0 * kLd + co], gd[(p0 + 1) * kLd + co]);
        const uint32_t b1 = pack(gd[(p0 + 8) * kLd + co], gd[(p0 + 9) * kLd + co]);
        if (ks == 0)
          mma<true>(acc[nt], a, b0, b1);
        else
          mma<false>(acc[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* q = part + (tap * kC + ci + 8 * h) * kC + co0 + 8 * nt + t2;
        const float v0 = acc[nt][2 * h], v1 = acc[nt][2 * h + 1];
        q[0] = first ? v0 : q[0] + v0;
        q[1] = first ? v1 : q[1] + v1;
      }
  }
}

// The gd row that input pixel r reads through slice t of the adjoint (sub 0: the output pixel
// (u1 + 1 - dh, ...); sub 1: the reflected one, u = 0 at u1 = 1 for dh = 0, u = 7 at u1 = 6
// for dh = 2): taps t < 9 (dh, dw) were read by the output (u, v) with reflect(u + dh - 1) = u1
// and v = v1 + 1 - dw, except at the output's edge columns where dw != 1; edge slice 9 + dh by
// the output column 0 (input column 1) and 7 (input column 6). kRows, the zero row, where none.
__device__ __forceinline__ int adjoint_row(int r, int t, int sub) {
  const int s = r >> 6, u1 = (r >> 3) & 7, v1 = r & 7;
  const int dh = t < kTaps ? t / 3 : t - kTaps;
  int u;
  if (sub == 0) {
    u = u1 + 1 - dh;
    if (u < 0 || u >= kH) return kRows;
  } else {
    if (dh == 0 && u1 == 1) u = 0;
    else if (dh == 2 && u1 == kH - 2) u = kH - 1;
    else return kRows;
  }
  int v;
  if (t < kTaps) {
    const int dw = t % 3;
    v = v1 + 1 - dw;
    if (v < (dw == 1 ? 0 : 1) || v > (dw == 1 ? kW - 1 : kW - 2)) return kRows;
  } else {
    if (v1 == 1) v = 0;
    else if (v1 == kW - 2) v = kW - 1;
    else return kRows;
  }
  return s * kPix + u * kW + v;
}

// acc = the warp's 32 x 32 of conv3x3^T(gd, k) on the tile, rows x_row0() + 16 mt (+ 8) (input
// pixels), columns x_col0() + 8 nt (+ 1) (input channels): for each slice, and for the slices
// with dh 0 or 2 once more for the reflected rows, A = the gd rows that read each input pixel
// (adjoint_row; the zero row where none), B = the slice^T, in a partial sum from zero added to
// acc in fp32. gd has its zero row at kRows.
__device__ void input_grad(const bf16* gd, const bf16* taps, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 6) * 32, c0 = ((threadIdx.x >> 5) & 1) * 32;
  const int u_lo = (r0 >> 3) & 7;  // the warp's rows hold input rows u_lo .. u_lo + 3
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
  for (int t = 0; t < kSlices; ++t) {
    const int dh = t < kTaps ? t / 3 : t - kTaps;
#pragma unroll 1
    for (int sub = 0; sub < 2; ++sub) {
      // the reflected rows: input row 1 (dh 0) or 6 (dh 2), in the warp's rows or not at all
      if (sub == 1 && !(dh == 0 && u_lo <= 1) && !(dh == 2 && u_lo + 3 >= kH - 2)) continue;
      const bf16* A[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          A[mt][h] = gd + adjoint_row(r0 + 16 * mt + 8 * h + g, t, sub) * kLd + t2;
      const bf16* B = taps + t * kSlice + (c0 + g) * kLd + t2;
      float part[2][4][4];
#pragma unroll
      for (int ks = 0; ks < kC / 16; ++ks) {
        const int k0 = 16 * ks;
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          a[mt][0] = ld32(A[mt][0] + k0);
          a[mt][1] = ld32(A[mt][1] + k0);
          a[mt][2] = ld32(A[mt][0] + k0 + 8);
          a[mt][3] = ld32(A[mt][1] + k0 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint32_t b0 = ld32(B + nt * 8 * kLd + k0), b1 = ld32(B + nt * 8 * kLd + k0 + 8);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (ks == 0)
              mma<true>(part[mt][nt], a[mt], b0, b1);
            else
              mma<false>(part[mt][nt], a[mt], b0, b1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
    }
  }
}

// In place for the first ns samples: the conv output d (fp32 field) becomes gd = bf16 of the
// gradient of d into gdb, from ga (the gradient of a = N(d)): a float field, or (gx) the
// bfloat16 upstream gradient in device memory at the tile's first sample; d's statistics;
// gamma (null for IN). Per (s, c): sa = sum ga, sx = sum ga * xn (AdaIN: dbeta and dgamma,
// rounded to bfloat16 into the tile's rows of db, dg);
// gd = rstd * gamma * (ga - sa / 64 - xn * sx / 64). Rows past ns get gd 0.
__device__ void norm_grad(const float* ga, const bf16* __restrict__ gx, const float* d,
                          bf16* gdb, int ns, const float* mean, const float* rstd,
                          const bf16* __restrict__ gam, bf16* dg, bf16* db, float* ca,
                          float* cx) {
  {
    const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
    const int s = pair / kC, c = pair % kC;
    float sa = 0.f, sx = 0.f;
    if (s < ns)
      for (int i = lane; i < kPix; i += 2) {
        const int r = s * kPix + i;
        const float a = gx ? __bfloat162float(gx[r * kC + c]) : ga[r * kLdF + c];
        sa += a;
        sx = fmaf(a, (d[r * kLdF + c] - mean[pair]) * rstd[pair], sx);
      }
    sa += __shfl_xor_sync(kFull, sa, 1);
    sx += __shfl_xor_sync(kFull, sx, 1);
    if (lane == 0) {
      ca[pair] = sa * (1.f / kPix);
      cx[pair] = sx * (1.f / kPix);
      if (dg && s < ns) {
        dg[pair] = __float2bfloat16_rn(sx);
        db[pair] = __float2bfloat16_rn(sa);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
    const int r = i / kC, c = i % kC, q = (r / kPix) * kC + c;
    float v = 0.f;
    if (r < ns * kPix) {
      const float a = gx ? __bfloat162float(gx[r * kC + c]) : ga[r * kLdF + c];
      const float xn = (d[r * kLdF + c] - mean[q]) * rstd[q];
      const float scale = gam ? rstd[q] * __bfloat162float(gam[q]) : rstd[q];
      v = scale * (a - ca[q] - xn * cx[q]);
    }
    gdb[r * kLd + c] = __float2bfloat16_rn(v);
  }
}

struct Args {
  const bf16 *x, *d1, *d2, *k1, *k2, *g1, *b1, *g2, *g;
  bf16 *dx;
  float* part;
  bf16 *dg1, *db1, *dg2, *db2;
  int batch;
};

// a1 = N1(d1) of (tile row r, channel c), with the AdaIN affine of the bfloat16 tables g, b
// where given: xn * gamma, then + beta, each rounded, as the forward computes it.
__device__ __forceinline__ float norm_bf16(const float* D, int r, int c, const float* mean,
                                           const float* rstd, const bf16* __restrict__ g,
                                           const bf16* __restrict__ b) {
  const int q = (r / kPix) * kC + c;
  float v = __fmul_rn(__fsub_rn(D[r * kLdF + c], mean[q]), rstd[q]);
  return g ? __fadd_rn(__fmul_rn(v, __bfloat162float(g[q])), __bfloat162float(b[q])) : v;
}

__global__ void __launch_bounds__(kThreads, 1) res2d_bf16_bwd_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* gd = reinterpret_cast<bf16*>(smem_raw);                   // gd2, then gd1; zero row
  bf16* fy = reinterpret_cast<bf16*>(smem_raw + kGdBytes);        // y1, then x
  bf16* taps = reinterpret_cast<bf16*>(smem_raw + kGdBytes + kFieldBytes);  // k2's, then k1's
  float* D = reinterpret_cast<float*>(smem_raw + kGdBytes + kFieldBytes + kTapBytes);
  float* P = D + kRows * kLdF;  // ga1
  float* m1 = P + kRows * kLdF;
  float* r1 = m1 + kSamples * kC;
  float* m2 = r1 + kSamples * kC;
  float* r2 = m2 + kSamples * kC;
  float* ca = r2 + kSamples * kC;
  float* cx = ca + kSamples * kC;
  const int tiles = (a.batch + kSamples - 1) / kSamples;
  float* part = a.part + static_cast<size_t>(blockIdx.x) * 2 * kTapGrads;  // dk1, then dk2
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 6) * 32, c0 = ((threadIdx.x >> 5) & 1) * 32;
  for (int c = threadIdx.x; c < kC; c += kThreads) gd[kRows * kLd + c] = __float2bfloat16_rn(0.f);
  float acc[2][4][4];
  for (int tile = blockIdx.x, it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int s0 = tile * kSamples, ns = min(kSamples, a.batch - s0);
    const size_t off = static_cast<size_t>(s0) * kPix * kC;
    const int tab = s0 * kC;
    const bf16* g1 = a.g1 ? a.g1 + tab : nullptr;
    const bf16* b1 = a.g1 ? a.b1 + tab : nullptr;
    const bf16* g2 = a.g1 ? a.g2 + tab : nullptr;
    bf16* dg1 = a.g1 ? a.dg1 + tab : nullptr;
    bf16* db1 = a.g1 ? a.db1 + tab : nullptr;
    bf16* dg2 = a.g1 ? a.dg2 + tab : nullptr;
    bf16* db2 = a.g1 ? a.db2 + tab : nullptr;
    // (1) gd2 = bf16(N2'(g, d2)); k2's slices staged
    __syncthreads();  // the previous tile's reads of every buffer are done
    stage_slices(a.k2, taps);
    load_f32(a.d2 + off, D, ns);
    __syncthreads();
    channel_stats<kLdF>(D, m2, r2);
    __syncthreads();
    norm_grad(nullptr, a.g + off, D, gd, ns, m2, r2, g2, dg2, db2, ca, cx);
    __syncthreads();
    // (2) d1 and its statistics; y1 = bf16(relu(N1(d1)))
    load_f32(a.d1 + off, D, ns);
    __syncthreads();
    channel_stats<kLdF>(D, m1, r1);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const float v = r < ns * kPix ? norm_bf16(D, r, c, m1, r1, g1, b1) : 0.f;
      fy[r * kLd + c] = __float2bfloat16_rn(fmaxf(v, 0.f));
    }
    __syncthreads();
    // (3) dk2 += y1-windows^T gd2
    taps_grad(fy, gd, part + kTapGrads, it == 0);
    // (4) dy1 = conv3x3^T(gd2, k2); ga1 = dy1 where a1 > 0, into P
    input_grad(gd, taps, acc);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 16 * mt + 8 * (i >> 1) + g8, c = c0 + 8 * nt + t2 + (i & 1);
          const bool on = r < ns * kPix && norm_bf16(D, r, c, m1, r1, g1, b1) > 0.f;
          P[r * kLdF + c] = on ? acc[mt][nt][i] : 0.f;
        }
    __syncthreads();  // every warp is past (3), which read y1
    // x replaces y1
    for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      fy[r * kLd + c] = r < ns * kPix ? a.x[off + i] : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    // (5) gd1 = bf16(N1'(ga1, d1))
    norm_grad(P, nullptr, D, gd, ns, m1, r1, g1, dg1, db1, ca, cx);
    __syncthreads();
    // (6) dk1 += x-windows^T gd1
    taps_grad(fy, gd, part, it == 0);
    // (7) dx = bf16(g + conv3x3^T(gd1, k1)); (4) read k2's slices before the __syncthreads above
    if (a.dx) {
      stage_slices(a.k1, taps);
      __syncthreads();
      input_grad(gd, taps, acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + 16 * mt + 8 * (i >> 1) + g8, c = c0 + 8 * nt + t2 + (i & 1);
            if (r < ns * kPix) {
              const size_t j = off + r * kC + c;
              a.dx[j] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(a.g[j]), acc[mt][nt][i]));
            }
          }
    }
  }
}

// out[i] = bf16(sum over the rows p = 0 .. n_parts - 1 of part[p][i]), in that order.
__global__ void reduce_rows_bf16_kernel(const float* __restrict__ part, int n_parts, int n,
                                        bf16* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < n_parts; ++p) s += part[static_cast<size_t>(p) * n + i];
  out[i] = __float2bfloat16_rn(s);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bfloat16 x, d1, d2 (K7's saved pre-norm conv outputs), g (B, 8, 8, 64); k1, k2 (3, 3, 64,
// 64); g1, b1, g2 (B, 64) for the AdaIN block, null for the InstanceNorm block. Out (bfloat16):
// dx (B, 8, 8, 64) or null (not needed); dk (2 x 36,864: dk1 then dk2); dg1, db1, dg2, db2
// (B, 64) for AdaIN, else null. blocks: the persistent grid, at most one block a SM and at
// most ceil(B / 2); part is fp32 scratch of blocks x 73,728. Every pointer 16-byte aligned.
int iins_res_block_2d_bf16_bwd(const void* x, const void* d1, const void* d2, const void* k1,
                               const void* k2, const void* g1, const void* b1, const void* g2,
                               const void* g, void* dx, void* part, void* dk, void* dg1,
                               void* db1, void* dg2, void* db2, int batch, int blocks,
                               void* stream) {
  if (batch <= 0 || blocks <= 0 || blocks > (batch + kSamples - 1) / kSamples || !x || !d1 ||
      !d2 || !k1 || !k2 || !g || !part || !dk)
    return cudaErrorInvalidValue;
  const bool adain = g1 != nullptr;
  if (adain != (b1 != nullptr) || adain != (g2 != nullptr) || adain != (dg1 != nullptr) ||
      adain != (db1 != nullptr) || adain != (dg2 != nullptr) || adain != (db2 != nullptr))
    return cudaErrorInvalidValue;
  static int smem_set = 0;
  const int err = allow_smem(res2d_bf16_bwd_kernel, static_cast<int>(kSmem), &smem_set);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using cb = const bf16*;
  const Args args{static_cast<cb>(x),   static_cast<cb>(d1),  static_cast<cb>(d2),
                  static_cast<cb>(k1),  static_cast<cb>(k2),  static_cast<cb>(g1),
                  static_cast<cb>(b1),  static_cast<cb>(g2),  static_cast<cb>(g),
                  static_cast<bf16*>(dx), static_cast<float*>(part),
                  static_cast<bf16*>(dg1), static_cast<bf16*>(db1), static_cast<bf16*>(dg2),
                  static_cast<bf16*>(db2), batch};
  res2d_bf16_bwd_kernel<<<blocks, kThreads, kSmem, s>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = 2 * kTapGrads;
  reduce_rows_bf16_kernel<<<(n + 255) / 256, 256, 0, s>>>(static_cast<const float*>(part),
                                                          blocks, n, static_cast<bf16*>(dk));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
