// K7b res_block_2d_bwd: the backward of K7's 2-D residual block, IN and
// AdaIN, from the upstream gradient g of y = x + a2 and the pre-norm conv
// outputs d1, d2 that K7 saved:
//   a2 = N2(d2), d2 = conv3x3(y1, k2), y1 = relu(a1), a1 = N1(d1), d1 = conv3x3(x, k1)
//   AdaIN: dgamma2[s, c] = sum_pix g * xn2, dbeta2[s, c] = sum_pix g; gxn2 = g * gamma2
//   gd2 = r2 * (gxn2 - mean(gxn2) - xn2 * mean(gxn2 * xn2))   (IN backward,
//         the two-pass statistics of the forward; r = 1/sqrt(var + eps))
//   dk2[dh, dw, ci, co] = sum_{b, pix} y1[b, src(pix; dh, dw), ci] * gd2[b, pix, co]
//   dy1 = conv3x3^T(gd2, k2); ga1 = dy1 where y1 > 0; then as above to gd1, dk1
//   dx = g + conv3x3^T(gd1, k1)
// with src(pix; dh, dw) the reflect-padded source pixel.
//
// Replaces the backward of fused_res_block_2d (iinsvae_tpu/ops/pallas/
// res2d.py:434, kernel _bwd_kernel :201 via pallas_call :377). Like the
// Pallas body it reads the saved d1 and d2 and recomputes no conv; it takes
// their statistics and y1 with K7's own channel_stats and norm_relu
// (res_block_2d.cuh), so the ReLU mask is the forward's bit for bit. The
// Pallas body returns the gradients of its lane-mix matrices, which XLA maps
// back to the taps; this kernel returns the (3, 3, C, C) taps' gradients.
//
// Bound on the H100 at batch 500: four conv-sized products (dk2, dy1, dk1,
// dx), 9.44 GFLOP, against ~41 MB of x, d1, d2, g and dx (12 us at 3.35
// TB/s): 141 us as fp32 FMAs at 67 TFLOP/s, 57 us as 3xTF32 on the tensor
// cores (three TF32 products a product, 28.3 GFLOP at 495 TFLOP/s). Bound by
// operations; mma.sync itself peaks at 0.667 m16n8k8 a clock an SM on the
// H100 (312-326 TFLOP/s of TF32, tf32_peak.py), which puts the products'
// floor at 84 us. What the design does about it:
// - The products run on the tensor cores, mma.sync m16n8k8 in 3xTF32
//   (mma_tf32.cuh), fp32 operands split in registers. The input gradients
//   are (pixels x C_out) . (C_out x C_in) a tap over the nine taps, a warp
//   32 x 32 of the tile's 128 x 64, the next step's operands loaded before
//   this step's mma's; the taps' gradients one product of 36 m-tiles of
//   (tap, ci) rows against (pixels x C_out), in three rounds of 3 m-tiles a
//   warp times 32 output channels, so one split of gd serves three m-tiles.
// - Accuracy. The tensor core truncates where an mma adds into its
//   accumulator, so every two k-steps of a product run in a partial sum from
//   zero, added to the product's sums in fp32 (kFlush, as K7 does); the
//   partial sums' registers are why the taps' gradients take three rounds.
// - The A operand of dk is a gather of reflect-shifted pixel rows of the
//   field (y1 or x) in shared memory, read in place. That of the input
//   gradient, the sum of gd over the outputs that read each pixel, is one
//   shifted pixel of gd, zero, or at a reflected edge one of 36 edge sums a
//   sample computed once a product (edge_sums): each lane reads its rows in
//   place, and a tap costs one __syncthreads. Rows of 72 floats, and lane
//   maps in which a lane's operand pairs are neighbouring floats, keep the
//   8-byte fragment loads free of bank conflicts.
// - Persistent blocks, one a SM, walk over tiles of two samples (250 tiles
//   at batch 500; 118 blocks take two). Shared memory (209 KB) holds d2 (then
//   gd2), two fields for d1 (then gd1) and y1 (then ga1) whose roles swap
//   each tile, x, the edge sums and a ring of two tap slices. Everything
//   arrives by 16-byte cp.async copies in numbered groups (bulk copies of
//   256-byte rows ran at about 4 bytes a clock an SM: the copies alone took
//   100 us of a first design, PERF.md): the next tile's d2, d1 and x as soon
//   as their field is free, under this tile's products, its g prefetched
//   into L2; the tap slices (k2's nine, then k1's) one ahead of the slice in
//   use, so that no product waits on a __syncthreads around a global load.
// - Weight gradients sum over the batch without atomics: a block adds each
//   of its tiles' d(taps) into its own row of a (blocks, 73,728) buffer
//   (stored by its first tile, read and added by the next), and a second
//   kernel sums the rows in a fixed order, so two backward passes give
//   bit-equal gradients. The rows are 132 x 295 KB = 38.9 MB written and
//   read once (the parent wrote and read one row a block of two samples,
//   73.7 MB); the second tile's read-modify-write mostly stays in L2. The
//   AdaIN gradients are per sample, written directly as (B, C) tables.
#include "async_smem.cuh"
#include "conv_bwd_common.cuh"
#include "mma_tf32.cuh"
#include "res_block_2d.cuh"

namespace {

using namespace res2d;
using tf32x3::Frag;

constexpr int kSlice = kC * kLd;            // one (dh, dw) slice of the taps, rows ci
constexpr int kTapGrads = kTaps * kC * kC;  // one conv's d(taps)
constexpr int kStats = 6 * kSamples * kC;
// Beside a gradient field gd, a sample's reflected-edge sums, pixel rows of kLd floats: R0 =
// row 2 + row 0 and R2 = row 5 + row 7 (a pixel a column), C0 = column 2 + column 0 and C2 =
// column 5 + column 7 (a pixel a row), the four pixels where an R and a C meet (R0 C0, R0 C2,
// R2 C0, R2 C2), and a zero pixel.
constexpr int kR0 = 0, kC0 = 2 * kW, kCorner = kC0 + 2 * kH, kZero = kCorner + 4;
constexpr int kEdge = kZero + 1;             // pixel rows a sample
constexpr int kEdges = kSamples * kEdge * kLd;
// four fields, the edge sums, the two tap slices (one field's floats), the statistics
constexpr size_t kSmem = (5 * kPair + kEdges + kStats) * sizeof(float);
static_assert(2 * kSlice == kPair, "the tap ring takes one field's room");
// The tile's phases: (1) gd2 and y1, (2) dk2, (3) dy1 and ga1, (4) gd1, (5) dk1, (6) dx. The
// kernel computes them up to kLastPhase; phase_times.py builds variants with an earlier last
// phase, which keep every copy, wait and __syncthreads of the whole kernel.
constexpr int kLastPhase = 6;
// Where an mma adds its products into an accumulator the tensor core truncates the sum: summed
// in one accumulator (72 k-steps for dy1 and dx, 16 a tile for the taps), the gradients were
// up to tens of times further from float64 than the plain fp32 backward's
// (tests/test_torch_gpu.py). So each kFlush k-steps of a product run in a partial sum of their
// own, from zero, which is then added to the product's sums in fp32, as in K7; 4 spills more
// registers and runs slower.
constexpr int kFlush = 2;

// The tap slices a block reads, in order: for each of its tiles k2's nine and, with dx, k1's
// nine. Slice n goes to ring slot n % 2 as one group.
struct TapStream {
  const float* k1;
  const float* k2;
  float* ring;
  int per_tile, total;
  int group0, group1;  // the group of each slot's slice

  // Copy slice n into its slot (nothing past the block's last slice).
  __device__ void issue(int n, Groups& gs) {
    if (n >= total) return;
    const int j = n % per_tile;
    copy_rows(ring + (n & 1) * kSlice,
              j < kTaps ? k2 + j * kTapFloats : k1 + (j - kTaps) * kTapFloats, kC);
    (n & 1 ? group1 : group0) = gs.commit();
  }

  // This thread's copies of slice n have landed: -> its slot.
  __device__ const float* wait(int n, const Groups& gs) const {
    gs.wait(n & 1 ? group1 : group0);
    return ring + (n & 1) * kSlice;
  }
};

// The input gradient's operand for tap (dh, dw) at pixel (u, v) is T[u][v], the sum of gd over
// the outputs (h, w) whose tap reads (u, v). Output row h reads row reflect(h + dh - 1), so
// row u is read by h = u + 1 - dh where that is a row, and through the reflection also by
// h = 0 (dh = 0, u = 1) or h = 7 (dh = 2, u = 6); likewise for columns. T[u][v] is therefore
// one pixel of gd shifted, or, at a reflected edge, one of the edge sums, or zero.

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The edge sums of gd's first ns samples into E.
__device__ void edge_sums(const float* gd, float* E, int ns) {
  constexpr int kRows = kZero;  // the zero pixel is written once
  for (int i = threadIdx.x; i < ns * kRows * (kC / 4); i += kThreads) {
    const int s = i / (kRows * (kC / 4)), r = (i / (kC / 4)) % kRows, c = (i & 15) * 4;
    const float* f = gd + s * kField + c;
    auto px = [&](int h, int w) {
      return *reinterpret_cast<const float4*>(f + (h * kW + w) * kLd);
    };
    float4 v;
    if (r < kC0) {  // R0 or R2 at column r % 8
      const int w = r & 7;
      v = r < kW ? add4(px(2, w), px(0, w)) : add4(px(5, w), px(7, w));
    } else if (r < kCorner) {  // C0 or C2 at row r % 8
      const int h = r & 7;
      v = r < kC0 + kH ? add4(px(h, 2), px(h, 0)) : add4(px(h, 5), px(h, 7));
    } else {  // R_j at C_k: R_j[2 or 5] + R_j[0 or 7]
      const int j = (r - kCorner) >> 1, k = (r - kCorner) & 1;
      const int h0 = j ? 5 : 2, h1 = j ? 7 : 0, w0 = k ? 5 : 2, w1 = k ? 7 : 0;
      v = add4(add4(px(h0, w0), px(h1, w0)), add4(px(h0, w1), px(h1, w1)));
    }
    *reinterpret_cast<float4*>(E + (s * kEdge + r) * kLd + c) = v;
  }
}

// Where T[u][v] of tap (dh, dw) lies for tile row p (sample p / 64, pixel (u, v)): a pixel row
// of gd or of the edge sums E.
__device__ __forceinline__ const float* operand_row(const float* gd, const float* E, int p,
                                                    int dh, int dw) {
  const int s = p >> 6, r = ((p >> 3) & 7) + 1 - dh, c = (p & 7) + 1 - dw;
  const float* e = E + s * kEdge * kLd;
  const int rm = dh == 0 && r == 2 ? 0 : (dh == 2 && r == 5 ? 1 : -1);  // R0 or R2
  const int cm = dw == 0 && c == 2 ? 0 : (dw == 2 && c == 5 ? 1 : -1);  // C0 or C2
  if (r < 0 || r >= kH || c < 0 || c >= kW) return e + kZero * kLd;
  if (rm >= 0 && cm >= 0) return e + (kCorner + 2 * rm + cm) * kLd;
  if (rm >= 0) return e + (kR0 + rm * kW + c) * kLd;
  if (cm >= 0) return e + (kC0 + cm * kH + r) * kLd;
  return gd + s * kField + (r * kW + c) * kLd;
}

// acc = the warp's 32 x 32 of conv3x3^T(gd, k) on the tile: for each tap, acc += T . slice^T,
// the product over the 64 output channels, T read in place from gd and its edge sums E.
// Slices come from the stream, q the next one (it and the one after it already copied);
// every thread calls it. Ends with a __syncthreads after which gd, E and the slices are free.
// Without kMma only the slices' copies, waits and __syncthreads.
template <bool kMma>
__device__ void input_grad(const float* gd, const float* E, TapStream& st, Groups& gs, int& q,
                           float (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // a lane's operands: k index t is channel k0 + 2t, t + 4 is k0 + 2t + 1
  const int t2 = 2 * (threadIdx.x & 3);
  const int boff = (x_col0() - t2 + ((threadIdx.x & 31) >> 2)) * kLd + t2;
  for (int tap = 0; tap < kTaps; ++tap) {
    const float* B = st.wait(q, gs) + boff;
    __syncthreads();  // every thread's copies of slice q have landed; slice q - 1 is read
    if (tap > 0) st.issue(q + 1, gs);
    ++q;
    if (!kMma) continue;
    const float* A[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        A[mt][h] = operand_row(gd, E, x_row0() + 16 * mt + 8 * h, tap / 3, tap % 3) + t2;
    // the next step's operands are loaded before this step's products are issued
    float2 ra[2][2], rb[4];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ra[mt][0] = ld2(A[mt][0] + k0);
        ra[mt][1] = ld2(A[mt][1] + k0);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) rb[nt] = ld2(B + nt * 8 * kLd + k0);
    };
    fetch(0);
    float part[2][4][4];
#pragma unroll
    for (int k0 = 0; k0 < kC; k0 += 8) {
      Frag<4> a[2];
      Frag<2> b[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt].set(0, ra[mt][0].x);
        a[mt].set(1, ra[mt][1].x);
        a[mt].set(2, ra[mt][0].y);
        a[mt].set(3, ra[mt][1].y);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt].set(0, rb[nt].x);
        b[nt].set(1, rb[nt].y);
      }
      if (k0 + 8 < kC) fetch(k0 + 8);
      const int j = (k0 / 8) % kFlush;
      if (j == 0)
        tf32x3::mma3<true>(part, a, b);
      else
        tf32x3::mma3(part, a, b);
      if (j == kFlush - 1) tf32x3::add(acc, part);
    }
  }
  __syncthreads();
  st.issue(q + 1, gs);
}

// The taps' gradients as one product with 36 m-tiles of (tap, ci) rows, m-tile j holding tap
// j / 4 and channels (j % 4) * 16 .. + 15: part[tap][ci][co] = (first) or += the sum over the
// first ns samples and the 64 pixels of in[s][src(pix; tap)][ci] * gd[s][pix][co]. In a round
// of M m-tiles a warp from m-tile base on, warp w owns m-tiles base + (w / 2) * M .. + M - 1
// and co (w % 2) * 32 .. + 31, so one split of gd serves M m-tiles. A lane's A rows g and
// g + 8 are channels 2g and 2g + 1 of an m-tile, its k indices t and t + 4 the pixels t and
// t + 4 of one image row.
template <int M>
__device__ void taps_grad_round(const float* in, const float* gd, int ns, float* __restrict__ part,
                                bool first, int base) {
  const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int j0 = base + (w >> 1) * M, co0 = (w & 1) * 32;
  int dh[M], ca[M], cb[M];  // each m-tile's tap row and its A columns' offsets
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int tap = (j0 + i) >> 2, dw = tap % 3, ci = ((j0 + i) & 3) * 16 + 2 * g;
    dh[i] = tap / 3;
    ca[i] = reflect8(t + dw - 1) * kLd + ci;
    cb[i] = reflect8(t + 3 + dw) * kLd + ci;
  }
  float acc[M][4][4] = {}, sum[M][4][4];
  for (int s = 0; s < ns; ++s) {
    for (int h0 = 0; h0 < kH; h0 += kFlush) {
#pragma unroll
      for (int j = 0; j < kFlush; ++j) {  // a step: image row h of sample s
        const int h = h0 + j;
        const float* br = gd + s * kField + (h * kW + t) * kLd + co0 + g;
        Frag<4> a[M];
        Frag<2> b[4];
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const float* ar = in + s * kField + reflect8(h + dh[i] - 1) * kW * kLd;
          const float2 u = ld2(ar + ca[i]), v = ld2(ar + cb[i]);
          a[i].set(0, u.x);
          a[i].set(1, u.y);
          a[i].set(2, v.x);
          a[i].set(3, v.y);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          b[nt].set(0, br[8 * nt]);
          b[nt].set(1, br[4 * kLd + 8 * nt]);
        }
        if (j == 0)
          tf32x3::mma3<true>(sum, a, b);
        else
          tf32x3::mma3(sum, a, b);
      }
      tf32x3::add(acc, sum);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int tap = (j0 + i) >> 2, ci = ((j0 + i) & 3) * 16 + 2 * g;
      float2* p0 =
          reinterpret_cast<float2*>(part + (tap * kC + ci) * kC + co0 + 8 * nt + 2 * t);
      float2* p1 = p0 + kC / 2;
      float2 v0 = make_float2(acc[i][nt][0], acc[i][nt][1]);
      float2 v1 = make_float2(acc[i][nt][2], acc[i][nt][3]);
      if (!first) {
        const float2 o0 = *p0, o1 = *p1;
        v0 = make_float2(o0.x + v0.x, o0.y + v0.y);
        v1 = make_float2(o1.x + v1.x, o1.y + v1.y);
      }
      *p0 = v0;
      *p1 = v1;
    }
}

// The tile's share of a conv's d(taps), in three rounds of 12 m-tiles (three a warp): a round
// holds its sums and their partial sums in registers.
__device__ void taps_grad(const float* in, const float* gd, int ns, float* __restrict__ part,
                          bool first) {
  taps_grad_round<3>(in, gd, ns, part, first, 0);
  taps_grad_round<3>(in, gd, ns, part, first, 12);
  taps_grad_round<3>(in, gd, ns, part, first, 24);
}

// In place, for the first ns samples: d (a conv output's field) becomes gd,
// the gradient of d, from ga (the gradient of a = N(d)), d's statistics
// (mean, rstd) and the affine gamma (null for IN). For each (s, c):
//   sa = sum ga, sx = sum ga * xn (AdaIN: dbeta and dgamma, written to the
//   tile's rows of the (B, C) tables dg, db)
//   gd = rstd * gamma * (ga - sa / 64 - xn * sx / 64).
// ``ga`` is a shared field, or (gx) the upstream gradient in device memory,
// read at the tile's first sample.
__device__ void norm_grad(const float* ga, const float* __restrict__ gx, float* d, int ns,
                          const float* mean, const float* rstd, const float* __restrict__ gam,
                          float* dg, float* db, float* ca, float* cx) {
  {
    const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
    const int s = pair / kC, c = pair % kC;
    // summed in fp64: the sums are dgamma and dbeta themselves, each within half an fp32 unit
    double sa = 0.0, sx = 0.0;
    if (s < ns)
      for (int i = lane; i < kPix; i += 2) {
        const float a = gx ? __ldg(gx + (s * kPix + i) * kC + c) : ga[(s * kPix + i) * kLd + c];
        sa += a;
        sx = fma(static_cast<double>(a),
                 static_cast<double>((d[(s * kPix + i) * kLd + c] - mean[pair]) * rstd[pair]),
                 sx);
      }
    sa += __shfl_xor_sync(kFull, sa, 1);
    sx += __shfl_xor_sync(kFull, sx, 1);
    if (lane == 0) {
      ca[pair] = static_cast<float>(sa * (1.0 / kPix));
      cx[pair] = static_cast<float>(sx * (1.0 / kPix));
      if (dg && s < ns) {
        dg[pair] = static_cast<float>(sx);
        db[pair] = static_cast<float>(sa);
      }
    }
  }
  __syncthreads();
  for_each4(ns, [&](int s, int pix, int c) {
    const int f = (s * kPix + pix) * kLd + c;
    const float4 a = gx ? __ldg(reinterpret_cast<const float4*>(gx + (s * kPix + pix) * kC + c))
                        : *reinterpret_cast<const float4*>(ga + f);
    const float4 v = *reinterpret_cast<const float4*>(d + f);
    const float av[4] = {a.x, a.y, a.z, a.w}, vv[4] = {v.x, v.y, v.z, v.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = s * kC + c + j;
      const float xn = (vv[j] - mean[q]) * rstd[q];
      const float scale = gam ? rstd[q] * __ldg(gam + q) : rstd[q];
      r[j] = scale * (av[j] - ca[q] - xn * cx[q]);
    }
    *reinterpret_cast<float4*>(d + f) = make_float4(r[0], r[1], r[2], r[3]);
  });
}

struct Args {
  const float *x, *d1, *d2, *k1, *k2, *g1, *b1, *g2, *g;
  float *dx, *part, *dg1, *db1, *dg2, *db2;
  int batch;
};

__global__ void __launch_bounds__(kThreads, 1) res2d_bwd_tc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* f2 = smem;            // d2, then gd2
  float* fd = f2 + kPair;      // two fields: d1 then gd1, y1 then ga1; the roles swap each tile
  float* fx = fd + 2 * kPair;  // x
  float* fe = fx + kPair;      // the edge sums of gd2, then of gd1
  float* ring = fe + kEdges;   // two tap slices
  float* m1 = ring + kPair;
  float* r1 = m1 + kSamples * kC;
  float* m2 = r1 + kSamples * kC;
  float* r2 = m2 + kSamples * kC;
  float* ca = r2 + kSamples * kC;
  float* cx = ca + kSamples * kC;
  const int tiles = (a.batch + kSamples - 1) / kSamples;
  const int mine = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // tiles j, j + grid, ...
  const int per_tile = a.dx ? 2 * kTaps : kTaps;
  TapStream st{a.k1, a.k2, ring, per_tile, mine * per_tile, 0, 0};
  Groups gs;
  float* part = a.part + static_cast<size_t>(blockIdx.x) * 2 * kTapGrads;

  // tile it's rows of a (B, 8, 8, C) tensor into a field: -> the copies' group
  auto load = [&](int it, float* dst, const float* src) {
    const int s0 = (blockIdx.x + it * gridDim.x) * kSamples;
    copy_rows(dst, src + static_cast<size_t>(s0) * kPix * kC, min(kSamples, a.batch - s0) * kPix);
    return gs.commit();
  };
  for (int i = threadIdx.x; i < kSamples * kC; i += kThreads)  // the zero pixels
    fe[((i / kC) * kEdge + kZero) * kLd + i % kC] = 0.f;
  int g_d2 = load(0, f2, a.d2), g_d1 = load(0, fd, a.d1);
  st.issue(0, gs);
  st.issue(1, gs);
  int g_x = load(0, fx, a.x);
  int q = 0;  // the next tap slice
  float acc[2][4][4];
  for (int it = 0; it < mine; ++it) {
    const int s0 = (blockIdx.x + it * gridDim.x) * kSamples, ns = min(kSamples, a.batch - s0);
    const size_t off = static_cast<size_t>(s0) * kPix * kC;
    const bool next = it + 1 < mine;
    float* f1 = fd + (it & 1) * kPair;        // d1, then gd1
    float* fy = fd + ((it & 1) ^ 1) * kPair;  // y1, then ga1
    const int tab = s0 * kC;
    const float* g1 = a.g1 ? a.g1 + tab : nullptr;
    const float* b1 = a.g1 ? a.b1 + tab : nullptr;
    const float* g2 = a.g1 ? a.g2 + tab : nullptr;
    float* dg1 = a.g1 ? a.dg1 + tab : nullptr;
    float* db1 = a.g1 ? a.db1 + tab : nullptr;
    float* dg2 = a.g1 ? a.dg2 + tab : nullptr;
    float* db2 = a.g1 ? a.db2 + tab : nullptr;
    if (threadIdx.x == 0) {
      if (it == 0) prefetch_l2(a.g + off, ns * kPix * kC * 4);
      if (next) {
        const int s1 = s0 + gridDim.x * kSamples;
        prefetch_l2(a.g + static_cast<size_t>(s1) * kPix * kC,
                    min(kSamples, a.batch - s1) * kPix * kC * 4);
      }
    }

    // (1) gd2 = N2'(g, d2), in place; y1 = relu(N1(d1)) with K7's statistics and epilogue
    gs.wait(g_d2);
    __syncthreads();
    if (kLastPhase >= 1) {
      channel_stats<kLd>(f2, m2, r2);
      __syncthreads();
      norm_grad(nullptr, a.g + off, f2, ns, m2, r2, g2, dg2, db2, ca, cx);
    }
    gs.wait(g_d1);
    __syncthreads();
    if (kLastPhase >= 1) {
      channel_stats<kLd>(f1, m1, r1);
      __syncthreads();
      norm_relu<kLd>(f1, fy, ns, m1, r1, g1, b1);
      __syncthreads();
    }
    // (2) dk2 = sum of y1-windows^T gd2
    if (kLastPhase >= 2) taps_grad(fy, f2, ns, part + kTapGrads, it == 0);
    // (3) dy1 = conv3x3^T(gd2, k2); then d2's field takes the next tile's d2, and
    // ga1 = dy1 where y1 > 0 goes into y1's field
    if (kLastPhase >= 3) edge_sums(f2, fe, ns);
    __syncthreads();
    input_grad<kLastPhase >= 3>(f2, fe, st, gs, q, acc);
    if (next) g_d2 = load(it + 1, f2, a.d2);
#pragma unroll
    for (int mt = 0; mt < 2 * (kLastPhase >= 3); ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* y = reinterpret_cast<float2*>(fy + (x_row0() + 16 * mt + 8 * h) * kLd +
                                                x_col0() + 8 * nt);
          const float2 v = *y;
          *y = make_float2(v.x > 0.f ? acc[mt][nt][2 * h] : 0.f,
                           v.y > 0.f ? acc[mt][nt][2 * h + 1] : 0.f);
        }
    __syncthreads();
    // (4) gd1 = N1'(ga1, d1), in place; then ga1's field takes the next tile's d1
    if (kLastPhase >= 4) norm_grad(fy, nullptr, f1, ns, m1, r1, g1, dg1, db1, ca, cx);
    gs.wait(g_x);
    __syncthreads();
    if (next) g_d1 = load(it + 1, fy, a.d1);
    // (5) dk1 = sum of x-windows^T gd1; then x's field takes the next tile's x
    if (kLastPhase >= 5) taps_grad(fx, f1, ns, part, it == 0);
    __syncthreads();
    if (next) g_x = load(it + 1, fx, a.x);
    // (6) dx = g + conv3x3^T(gd1, k1)
    if (a.dx) {
      if (kLastPhase >= 6) edge_sums(f1, fe, ns);
      __syncthreads();
      input_grad<kLastPhase >= 6>(f1, fe, st, gs, q, acc);
      // the warp's share of g (in L2), loaded after the product: held through it, g and the
      // partial sums spilled registers
      if (kLastPhase >= 6 && (threadIdx.x >> 7) < ns) {  // the warp's sample
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const size_t i = off + (x_row0() + 16 * mt + 8 * h) * kC + x_col0() + 8 * nt;
              const float2 gv = __ldg(reinterpret_cast<const float2*>(a.g + i));
              *reinterpret_cast<float2*>(a.dx + i) =
                  make_float2(acc[mt][nt][2 * h] + gv.x, acc[mt][nt][2 * h + 1] + gv.y);
            }
      }
    }
  }
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, d1, d2 (K7's saved pre-norm conv outputs), g (B, 8, 8, 64); k1, k2 (3, 3, 64, 64);
// g1, b1, g2 (B, 64) for the AdaIN block, null for the InstanceNorm block (beta2 does not
// enter the backward). Out: dx (B, 8, 8, 64) or null (not needed); dk (2 x 36,864: dk1 then
// dk2); dg1, db1, dg2, db2 (B, 64) for AdaIN, else null. blocks: the persistent grid, at most
// one block a SM and at most ceil(B / 2); part is scratch of blocks x 73,728 floats. Every
// pointer 16-byte aligned.
int iins_res_block_2d_bwd(const float* x, const float* d1, const float* d2, const float* k1,
                          const float* k2, const float* g1, const float* b1, const float* g2,
                          const float* g, float* dx, float* part, float* dk, float* dg1,
                          float* db1, float* dg2, float* db2, int batch, int blocks,
                          void* stream) {
  if (batch <= 0 || blocks <= 0 || blocks > (batch + kSamples - 1) / kSamples || !x || !d1 ||
      !d2 || !k1 || !k2 || !g || !part || !dk)
    return cudaErrorInvalidValue;
  const bool adain = g1 != nullptr;
  if (adain != (b1 != nullptr) || adain != (g2 != nullptr) || adain != (dg1 != nullptr) ||
      adain != (db1 != nullptr) || adain != (dg2 != nullptr) || adain != (db2 != nullptr))
    return cudaErrorInvalidValue;
  static int smem_set = 0;
  const int err = allow_smem(res2d_bwd_tc_kernel, static_cast<int>(kSmem), &smem_set);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args args{x, d1, d2, k1, k2, g1, b1, g2, g, dx, part, dg1, db1, dg2, db2, batch};
  res2d_bwd_tc_kernel<<<blocks, kThreads, kSmem, s>>>(args);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return iins::launch_reduce_rows(part, blocks, 2 * kTapGrads, dk, s);
}

}  // extern "C"
