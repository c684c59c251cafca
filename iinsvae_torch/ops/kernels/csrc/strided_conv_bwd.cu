// K3b strided_conv_bwd: the backward of K3, y = relu(conv1d(x, taps, k=4,
// s=2, zero pad 1) + bias): dx (unless not asked for), d(taps) and dbias,
// from gz = g * (y > 0) (the saved output's ReLU mask).
//
// Replaces the backward of fused_strided_conv
// (iinsvae_tpu/ops/pallas/strided_conv.py:211, kernel _bwd_kernel :140),
// which returns the gradient of its W3 lane block; this kernel returns the
// gradient of the (4, C_in, C_out) taps directly. Both products are window
// products over tiles of rows (strided_conv.cuh):
//
// - dx. Input rows 2m and 2m+1, taken as one row of 2*C_in floats, receive
//   from outputs m-1, m, m+1 only: row 2m gets tap 3 of output m-1 and tap
//   1 of output m, row 2m+1 tap 2 of output m and tap 0 of output m+1. So
//   dX2 (B*P, 2*C_in) = [gz_{m-1} | gz_m | gz_{m+1}] . [W3t | 0 ; W1t | W2t
//   ; 0 | W0t], Wk = taps[k] (C_in, C_out), P = ceil(L_in / 2) row pairs a
//   sample, gz rows past a sample's ends zero. No atomics and no
//   overlap-add; the zero blocks are skipped. The taps are staged
//   transposed in shared memory, (4, C_out, C_in), so that a thread reads a
//   float4 of input channels.
// - d(taps) and dbias. dW (4*C_in, C_out) = A^T . GZ summed over all
//   B*L_out output rows (A the forward's windows), dbias the column sums of
//   GZ. Row pair m of the dx product is output row m, so the same staged x
//   and gz tiles feed both products.
//
// Bound on the H100 at batch 500: at the env's second stride-2 stage
// ((64, 32) -> (32, 64)) dx and d(taps) are 131 M multiply-adds each (0.52
// GFLOP, 7.8 us at 67 TFLOP/s fp32) over 16.4 MB (x, y, g in, dx out; 4.9
// us at 3.35 TB/s): bound by operations; at the first ((128, 16) -> (64,
// 32)) 65.5 M each (3.9 us) over the same 16.4 MB: bound by bytes. The generic conv
// backward it replaces kept one accumulator a thread with two shared-memory
// loads per FMA and wrote 250 partial rows of d(taps). Here each block is
// persistent (at most one a SM, tiles striding over the grid), keeps a
// register tile of 4 row pairs x 8 dx values (per step of 4 output
// channels: 12 float4 of gz and 16 of the taps for 256 FMAs) and one of 4
// x 8 d(taps) entries (per row: 3 float4 for 32 FMAs), and adds its d(taps)
// tile into a per-block accumulator in shared memory after each tile. So
// the block writes one partial row for all its tiles, about one partial
// row a SM, and a second kernel sums the rows in a fixed order: the
// result is bit-reproducible (no atomics). Full fp32 FMAs, no TF32.
//
// Thread layouts (256 threads). dx: ncx = C_in / 4 channel groups x nrx =
// 256 / ncx row groups, a tile is 4 * nrx row pairs; channel group cx
// writes channels 4cx..4cx+3 of both rows of a pair. d(taps): groups of 4
// taps rows x 8 channels (4 * cw..+3 and C_out_pad/2 + 4 * cw..+3), cw
// fastest, so a quarter warp reads one broadcast float4 of A and 128
// contiguous bytes of gz; where there are fewer groups than threads, rsub
// = 256 / groups threads share a group, each summing every rsub-th row
// into its own accumulator, and the block sums those in order at the end.
#include <algorithm>
#include <initializer_list>

#include "conv_bwd_common.cuh"
#include "strided_conv.cuh"

namespace {

using namespace iins_sc;

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

struct Plan {
  int ncx, nrx, tm, cp, ncw, groups, rsub, sx, sg, n_acc, smem;
};

Plan plan_for(int l_in, int c_in, int c_out) {
  Plan pl;
  pl.ncx = c_in / 4;
  pl.cp = (c_out + 7) / 8 * 8;
  pl.ncw = pl.cp / 8;
  pl.groups = c_in * pl.ncw;  // (4*C_in / 4) taps-row groups x ncw
  pl.rsub = pl.groups < kThreads ? kThreads / pl.groups : 1;
  pl.sx = c_in + 4;  // staged rows 4 floats apart keep a warp's reads on distinct banks
  pl.sg = pl.cp + 4;
  pl.n_acc = pl.rsub * pl.groups * 32 + pl.cp;
  pl.smem = -1;
  const int p = (l_in + 1) / 2;
  // the largest tile that fits: short samples put many segments in a tile
  for (pl.nrx = kThreads / pl.ncx; pl.nrx >= 1; pl.nrx /= 2) {
    pl.tm = kRowsPerThread * pl.nrx;
    const int seg = max_segments(pl.tm, p);
    const size_t floats = static_cast<size_t>(4) * c_in * c_out +
                          static_cast<size_t>(2 * pl.tm + 2 * seg) * pl.sx +
                          2 * static_cast<size_t>(pl.tm + 2 * seg) * pl.sg + pl.n_acc;
    if (floats * sizeof(float) <= static_cast<size_t>(kMaxSmem)) {
      pl.smem = static_cast<int>(floats * sizeof(float));
      break;
    }
  }
  return pl;
}

// Stage g and y of tile rows [q0, q0 + n) at gs and ys, sg floats a row,
// cp columns (zero past C_out): tile row i's row m at staged row i + 2j + 1,
// each segment's halo rows m_a - 1 and m_b before and after; rows outside
// [0, L_out) zero. Issues cp.async copies only; mask_gz then makes gs gz.
__device__ void stage_g_y(const float* __restrict__ y, const float* __restrict__ g_,
                          const Geom& g, int q0, int n, int cp, float* gs, float* ys, int sg) {
  const int c4 = cp / 4, s0 = q0 / g.p;
  const int nseg = (q0 + n - 1) / g.p - s0 + 1;
  for (int it = threadIdx.x; it < (n + 2 * nseg) * c4; it += blockDim.x) {
    const int r = it / c4, c = (it - r * c4) * 4;
    int s, m, dst;
    if (r < n) {  // own rows
      const int q = q0 + r;
      s = q / g.p;
      m = q - s * g.p;
      dst = r + 2 * (s - s0) + 1;
    } else {  // halo rows: head and tail of segment j
      const int j = (r - n) / 2, tail = (r - n) & 1;
      const Segment sgm = segment(g, q0, n, j);
      s = s0 + j;
      m = tail ? sgm.m_a + sgm.b - sgm.a : sgm.m_a - 1;
      dst = (tail ? sgm.b + 1 : sgm.a) + 2 * j;
    }
    const bool ok = m >= 0 && m < g.l_out && c < g.c_out;
    const size_t o = ok ? (static_cast<size_t>(s) * g.l_out + m) * g.c_out + c : 0;
    cp_async16(gs + dst * sg + c, g_ + o, ok);
    cp_async16(ys + dst * sg + c, y + o, ok);
  }
}

// gs = gs * (ys > 0) over the staged rows (after stage_g_y's copies landed).
__device__ void mask_gz(float* gs, const float* ys, int n_floats) {
  for (int i = 4 * threadIdx.x; i < n_floats; i += 4 * blockDim.x) {
    const float4 yv = *reinterpret_cast<const float4*>(ys + i);
    float4 gv = *reinterpret_cast<float4*>(gs + i);
    gv.x = yv.x > 0.f ? gv.x : 0.f;
    gv.y = yv.y > 0.f ? gv.y : 0.f;
    gv.z = yv.z > 0.f ? gv.z : 0.f;
    gv.w = yv.w > 0.f ? gv.w : 0.f;
    *reinterpret_cast<float4*>(gs + i) = gv;
  }
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// dx of the tile's row pairs: thread (rg, cx) writes channels 4cx..4cx+3 of
// input rows 2m and 2m+1 for its 4 row pairs.
__device__ void tile_dx(const float* wts, const float* gs, const Geom& g, const Plan& pl,
                        int q0, int n, float* __restrict__ dx) {
  const int cx = threadIdx.x % pl.ncx, rg = threadIdx.x / pl.ncx;
  if (rg >= pl.nrx) return;
  const int s0 = q0 / g.p, c_in = g.c_in, c_out = g.c_out, sg = pl.sg;
  int base[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = min(rg + m * pl.nrx, n - 1);
    base[m] = (i + 2 * ((q0 + i) / g.p - s0)) * sg;  // gz row m-1 of row pair i
  }
  float a0[kRowsPerThread][4], a1[kRowsPerThread][4];  // rows 2m, 2m+1
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m)
#pragma unroll
    for (int v = 0; v < 4; ++v) a0[m][v] = a1[m][v] = 0.f;
  const int tap_stride = c_out * c_in;
  const float* wc = wts + 4 * cx;
  for (int co = 0; co < c_out; co += 4) {
    float4 gp[kRowsPerThread], gm[kRowsPerThread], gn[kRowsPerThread];
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      gp[m] = *reinterpret_cast<const float4*>(gs + base[m] + co);
      gm[m] = *reinterpret_cast<const float4*>(gs + base[m] + sg + co);
      gn[m] = *reinterpret_cast<const float4*>(gs + base[m] + 2 * sg + co);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* wr = wc + (co + e) * c_in;
      const float4 w0 = *reinterpret_cast<const float4*>(wr);
      const float4 w1 = *reinterpret_cast<const float4*>(wr + tap_stride);
      const float4 w2 = *reinterpret_cast<const float4*>(wr + 2 * tap_stride);
      const float4 w3 = *reinterpret_cast<const float4*>(wr + 3 * tap_stride);
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const float p = lane(gp[m], e), c = lane(gm[m], e), nx = lane(gn[m], e);
        a0[m][0] = fmaf(c, w1.x, fmaf(p, w3.x, a0[m][0]));
        a0[m][1] = fmaf(c, w1.y, fmaf(p, w3.y, a0[m][1]));
        a0[m][2] = fmaf(c, w1.z, fmaf(p, w3.z, a0[m][2]));
        a0[m][3] = fmaf(c, w1.w, fmaf(p, w3.w, a0[m][3]));
        a1[m][0] = fmaf(nx, w0.x, fmaf(c, w2.x, a1[m][0]));
        a1[m][1] = fmaf(nx, w0.y, fmaf(c, w2.y, a1[m][1]));
        a1[m][2] = fmaf(nx, w0.z, fmaf(c, w2.z, a1[m][2]));
        a1[m][3] = fmaf(nx, w0.w, fmaf(c, w2.w, a1[m][3]));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int i = rg + m * pl.nrx;
    if (i >= n) continue;
    const int q = q0 + i, s = q / g.p, u = 2 * (q - s * g.p);
    float* dst = dx + (static_cast<size_t>(s) * g.l_in + u) * c_in + 4 * cx;
    *reinterpret_cast<float4*>(dst) = make_float4(a0[m][0], a0[m][1], a0[m][2], a0[m][3]);
    if (u + 1 < g.l_in)
      *reinterpret_cast<float4*>(dst + c_in) =
          make_float4(a1[m][0], a1[m][1], a1[m][2], a1[m][3]);
  }
}

// d(taps) and dbias of the tile's rows, added to the block's accumulator
// acc: entry e of group gid, row subset sub at acc[(e * rsub + sub) *
// groups + gid]; dbias at acc[32 * rsub * groups + co].
__device__ void tile_dw(const float* xs, const float* gs, const Geom& g, const Plan& pl,
                        int q0, int n, float* acc) {
  const int nseg = (q0 + n - 1) / g.p - q0 / g.p + 1;
  const int half = pl.cp / 2, sx = pl.sx, sg = pl.sg, rsub = pl.rsub;
  const int active = pl.groups < kThreads ? pl.groups * rsub : kThreads;
  if (static_cast<int>(threadIdx.x) < active) {
    const int sub = pl.groups < kThreads ? threadIdx.x / pl.groups : 0;
    for (int gid = threadIdx.x % (pl.groups < kThreads ? pl.groups : kThreads); gid < pl.groups;
         gid += kThreads) {
      const int kg = gid / pl.ncw, cw = gid - kg * pl.ncw;
      const int t = 4 * kg / g.c_in, c = 4 * kg - t * g.c_in;
      float d[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int v = 0; v < 8; ++v) d[a][v] = 0.f;
      for (int j = 0; j < nseg; ++j) {
        const Segment sgm = segment(g, q0, n, j);
        const int i0 = sgm.a + ((sub - sgm.a) % rsub + rsub) % rsub;
        const float* xr = xs + (2 * (i0 + j) + t) * sx + c;
        const float* gr = gs + (i0 + 2 * j + 1) * sg + 4 * cw;
#pragma unroll 4
        for (int i = i0; i < sgm.b; i += rsub, xr += 2 * rsub * sx, gr += rsub * sg) {
          const float4 av = *reinterpret_cast<const float4*>(xr);
          const float4 g0 = *reinterpret_cast<const float4*>(gr);
          const float4 g1 = *reinterpret_cast<const float4*>(gr + half);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float x_ = lane(av, a);
            d[a][0] = fmaf(x_, g0.x, d[a][0]);
            d[a][1] = fmaf(x_, g0.y, d[a][1]);
            d[a][2] = fmaf(x_, g0.z, d[a][2]);
            d[a][3] = fmaf(x_, g0.w, d[a][3]);
            d[a][4] = fmaf(x_, g1.x, d[a][4]);
            d[a][5] = fmaf(x_, g1.y, d[a][5]);
            d[a][6] = fmaf(x_, g1.z, d[a][6]);
            d[a][7] = fmaf(x_, g1.w, d[a][7]);
          }
        }
      }
      float* mine = acc + sub * pl.groups + gid;
      const int stride = rsub * pl.groups;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int v = 0; v < 8; ++v) mine[(8 * a + v) * stride] += d[a][v];
    }
  }
  // dbias: thread co sums gz column co over the tile's rows
  for (int co = threadIdx.x; co < g.c_out; co += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < nseg; ++j) {
      const Segment sgm = segment(g, q0, n, j);
      for (int i = sgm.a; i < sgm.b; ++i) s += gs[(i + 2 * j + 1) * sg + co];
    }
    acc[32 * rsub * pl.groups + co] += s;
  }
}

__global__ void __launch_bounds__(kThreads)
strided_conv_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ y, const float* __restrict__ g_,
                        float* __restrict__ dx, float* __restrict__ part, Geom g, Plan pl,
                        int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int c_in = g.c_in, c_out = g.c_out;
  float* wts = smem;                             // (4, C_out, C_in): taps transposed
  float* xs = wts + 4 * c_in * c_out;            // staged input rows
  const int seg = max_segments(pl.tm, g.p);
  const int n_g = (pl.tm + 2 * seg) * pl.sg;
  float* gs = xs + (2 * pl.tm + 2 * seg) * pl.sx;  // staged g, then gz
  float* ys = gs + n_g;                            // staged y
  float* acc = ys + n_g;                           // the block's d(taps), dbias
  if (dx) {
    // taps (t, ci, co) -> wts (t, co, ci): a float4 of 4 co a thread, ci
    // fastest across threads so the transposed stores hit distinct banks;
    // four loads in flight a thread
    const int n4 = c_in * c_out, co4 = c_out / 4;
    for (int it0 = threadIdx.x; it0 < n4; it0 += 4 * blockDim.x) {
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int it = it0 + k * blockDim.x;
        if (it >= n4) break;
        const int ci = it % c_in, r = it / c_in, t = r / co4, c = (r - t * co4) * 4;
        v[k] = __ldg(reinterpret_cast<const float4*>(w + (t * c_in + ci) * c_out + c));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int it = it0 + k * blockDim.x;
        if (it >= n4) break;
        const int ci = it % c_in, r = it / c_in, t = r / co4, c = (r - t * co4) * 4;
        float* dst = wts + (t * c_out + c) * c_in + ci;
        dst[0] = v[k].x;
        dst[c_in] = v[k].y;
        dst[2 * c_in] = v[k].z;
        dst[3 * c_in] = v[k].w;
      }
    }
  }
  for (int i = threadIdx.x; i < pl.n_acc; i += blockDim.x) acc[i] = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = tile * pl.tm, n = min(pl.tm, g.rows - q0);
    __syncthreads();  // the previous tile's reads are done
    stage_x(x, g, q0, n, xs, pl.sx);
    stage_g_y(y, g_, g, q0, n, pl.cp, gs, ys, pl.sg);
    cp_async_wait_all();
    __syncthreads();
    mask_gz(gs, ys, (n + 2 * ((q0 + n - 1) / g.p - q0 / g.p + 1)) * pl.sg);
    __syncthreads();
    if (dx) tile_dx(wts, gs, g, pl, q0, n, dx);
    tile_dw(xs, gs, g, pl, q0, n, acc);
  }
  __syncthreads();

  // the block's partial row: d(taps) (4*C_in, C_out), then dbias
  const int n_w = 4 * c_in * c_out, half = pl.cp / 2, stride = pl.rsub * pl.groups;
  float* row = part + static_cast<size_t>(blockIdx.x) * (n_w + c_out);
  for (int idx = threadIdx.x; idx < n_w + c_out; idx += blockDim.x) {
    float v;
    if (idx < n_w) {
      const int k = idx / c_out, co = idx - k * c_out;
      const int hi = co >= half, cc = co - hi * half;
      const int gid = (k / 4) * pl.ncw + cc / 4;
      const int e = 8 * (k % 4) + 4 * hi + cc % 4;
      v = 0.f;
      for (int sub = 0; sub < pl.rsub; ++sub) v += acc[(e * pl.rsub + sub) * pl.groups + gid];
    } else {
      v = acc[32 * stride + idx - n_w];
    }
    row[idx] = v;
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
int iins_strided_conv_bwd_smem(int l_in, int c_in, int c_out) {
  if (!shape_ok(1, l_in, c_in, c_out)) return -1;
  return plan_for(l_in, c_in, c_out).smem;
}

// x (batch, l_in, c_in), w (4, c_in, c_out), y and g (batch, l_in/2,
// c_out); dx (batch, l_in, c_in) or null; part (max_blocks, 4*c_in*c_out +
// c_out) scratch, one row a block, the grid min(max_blocks, tiles) blocks
// (the caller passes the SM count: one persistent block a SM); dwb
// (4*c_in*c_out + c_out): d(taps), then dbias.
int iins_strided_conv_bwd(const float* x, const float* w, const float* y, const float* g_,
                          float* dx, float* part, float* dwb, int batch, int l_in, int c_in,
                          int c_out, int max_blocks, void* stream) {
  if (!shape_ok(batch, l_in, c_in, c_out) || max_blocks < 1) return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w),
                        static_cast<const void*>(y), static_cast<const void*>(g_),
                        static_cast<const void*>(dx)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  const Plan pl = plan_for(l_in, c_in, c_out);
  if (pl.smem < 0) return cudaErrorInvalidValue;
  const int p = (l_in + 1) / 2;
  const Geom g{batch, l_in, c_in, l_in / 2, c_out, p, batch * p};
  const int n_tiles = (g.rows + pl.tm - 1) / pl.tm;
  const int grid = std::min(n_tiles, max_blocks);
  int err = allow_smem(strided_conv_bwd_kernel, pl.smem, &smem_set);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  strided_conv_bwd_kernel<<<grid, kThreads, pl.smem, s>>>(x, w, y, g_, dx, part, g, pl,
                                                            n_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n = 4 * c_in * c_out + c_out;
  return iins::launch_reduce_rows(part, grid, n, dwb, s);
}

}  // extern "C"
