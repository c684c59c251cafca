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
// cores (989 TFLOP/s), 9.5 us; ~20 MB of x, d1, d2, g and dx, 6.1 us at 3.35 TB/s. The design,
// for Hopper (res_block_2d_bf16.cuh), three launches a call:
// - res2d_bf16_bwd_wgmma_kernel, the input gradients. Persistent blocks of two warpgroups,
//   one block an SM; a warpgroup owns one sample at a time. Both convs' twelve slices (192 KB,
//   128-byte swizzled, rows C_in of C_out as stored: B of the adjoint without a transpose) are
//   staged once a block. A thread reads g, d1, d2 straight into registers at its accumulator
//   positions, where it needs them (the next sample's are asked into L2 first; held across
//   the products, g and d1 would spill): the norms' backward and the
//   statistics work on them there, with shuffles across the warp's rows and a small exchange
//   across its four warps. gd2 then gd1 (bfloat16) go into one swizzled field, the A operand
//   of the adjoint: its rows gathered by ldmatrix, each lane's row the gd row that its input
//   pixel reads through the slice (adjoint_row), and for the slices of dh 0 and 2 a second pass
//   for the rows that reflection reads twice: 20 products of four wgmma m64n64k16 a gradient,
//   each adding into the gradient's sums in the tensor cores, the next pass's gather under it.
//   No partial sums here (K7's convs keep them): with them the kernel spilled and ran slower;
//   the float64 checks hold either way, every output being rounded to bfloat16. gd2, gd1 and y1 (bfloat16) also go to scratch for the taps' gradient, and dx
//   out, each through that field, 16 contiguous bytes a thread (store_tile).
// - res2d_bf16_dk_kernel, the taps' gradient: 2 x chunks blocks of three warpgroups, block
//   (conv, chunk) takes the samples chunk, chunk + chunks, ... of dk1 (x, gd1) or dk2 (y1, gd2);
//   warpgroup w owns taps 3 w .. 3 w + 2, whose (64 C_in x 64 C_out) sums it holds in its
//   registers across the block's samples. A tap's product a sample is (C_in x 64 pixels) .
//   (64 pixels x C_out): A, the input's reflect-shifted rows gathered transposed (ldmatrix
//   .trans), B, gd in pixel rows, the descriptor's transpose; each tap's four k-steps add into
//   its sums in the tensor cores (no partial sums: the float64 checks hold, dk being rounded to
//   bfloat16 once), the next tap's gather under them. The next three samples' inputs and gd
//   come in by cp.async, a ring of four buffers, under the products. At the end each block
//   puts its fp32 row of 36,864 in its shared memory (thread-major, over the ring), and the
//   cluster of 4 blocks (consecutive chunks of one conv) sums its four rows through distributed
//   shared memory, each block a quarter in rank order, into one row in device memory: one row
//   a cluster, not a block. The clusters are at most as many as the card holds at once
//   (iins_res_block_2d_bf16_bwd_slots): more ran in a second wave.
// - reduce_rows_bf16_kernel sums each conv's cluster rows in order and rounds: two calls are
//   bit-equal (no atomics).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"
#include "res_block_2d_bf16.cuh"

namespace {

using namespace res2d_bf16;

constexpr int kTapGrads = kTaps * kC * kC;  // one conv's d(taps)
constexpr int kGroups = 2;                  // warpgroups a block of the input gradients
constexpr int kThreads = kGroups * kWarpGroup;
constexpr int kGdOff = 2 * kConvBytes;
constexpr int kRedOff = kGdOff + kGroups * kTileBytes;
constexpr int kRedFloats = 2 * 4 * kC;      // two sums of four warps a channel
constexpr int kStatOff = kRedOff + kGroups * kRedFloats * 4;
constexpr int kStatFloats = 3 * kC;         // mean1, rstd1, gamma1 a channel
constexpr int kZeroOff = kStatOff + kGroups * kStatFloats * 4;
constexpr size_t kSmem = kZeroOff + kRowBytes;
static_assert(kSmem <= 232448, "over the H100's 227 KB of shared memory a block");
constexpr int kDkGroups = 3;                // warpgroups a block of the taps' gradient
constexpr int kDkThreads = kDkGroups * kWarpGroup;
constexpr int kDkStages = 4;                // buffers of (input, gd): 3 samples ahead
constexpr int kDkCluster = 4;               // blocks a cluster, whose rows it sums in one
constexpr size_t kDkSmem = kTapGrads * 4;   // the block's row, over the ring at the end
static_assert(kDkSmem >= kDkStages * 2 * kTileBytes, "the ring fits in the row's space");

// Phases past kLastPhase do no work (phase_times.py --kernel res2d_bf16_bwd): 0 the staging,
// loads, copies, waits and barriers, and the partial rows' sum; 1 gd2; 2 y1; 3 dy1's products
// (a cut there keeps them, or ptxas would drop them); 4 gd1; 5 dx's products; 6 the taps'
// gradient's products.
constexpr int kLastPhase = 6;

// The gd row that input pixel r reads through slice t of the adjoint, or -1 (a zero row). Sub
// 0: the output pixel (r / 8 + 1 - dh, ...); sub 1: the reflected one, u = 0 at input row 1
// for dh = 0, u = 7 at input row 6 for dh = 2. Taps t < 9 (dh, dw) were read by the output
// (u, v) with reflect(u + dh - 1) = u1 and v = v1 + 1 - dw, except at the output's edge
// columns where dw != 1; edge slice 9 + dh by the output column 0 (input column 1) and 7
// (input column 6).
__device__ __forceinline__ int adjoint_row(int r, int t, int sub) {
  const int u1 = r >> 3, v1 = r & 7;
  const int dh = t < kTaps ? t / 3 : t - kTaps;
  int u;
  if (sub == 0) {
    u = u1 + 1 - dh;
    if (u < 0 || u >= kH) return -1;
  } else if (dh == 0 && u1 == 1) {
    u = 0;
  } else if (dh == 2 && u1 == kH - 2) {
    u = kH - 1;
  } else {
    return -1;
  }
  int v;
  if (t < kTaps) {
    const int dw = t % 3;
    v = v1 + 1 - dw;
    if (v < (dw == 1 ? 0 : 1) || v > (dw == 1 ? kW - 1 : kW - 2)) return -1;
  } else if (v1 == 1) {
    v = 0;
  } else if (v1 == kW - 2) {
    v = kW - 1;
  } else {
    return -1;
  }
  return u * kW + v;
}

// The adjoint's passes: the twelve slices, then the second pass of the eight with dh 0 or 2.
__host__ __device__ constexpr int pass_slice(int n) {
  return n < kSlices ? n : (n < kSlices + 3 ? n - kSlices : (n < kSlices + 6 ? n - kSlices + 3
                                                                 : (n == kSlices + 6 ? 9 : 11)));
}
constexpr int kPasses = kSlices + 8;

// acc = conv3x3^T(gd, k) in the accumulator layout (rows input pixels, columns C_in).
__device__ __forceinline__ void input_grad(const unsigned char* gd, const unsigned char* zero,
                                           const unsigned char* taps, float (&acc)[32]) {
  sum_products<0, 0, kPasses>(acc, gd, zero, taps, gather_row(),
                              [](int n) { return pass_slice(n); },
                           [](int p, int n) { return adjoint_row(p, pass_slice(n), n < kSlices ? 0 : 1); });
}

struct Args {
  const bf16 *x, *d1, *d2, *k1, *k2, *g1, *b1, *g2, *g;
  bf16* dx;
  float* part;               // 2 x chunks rows of kTapGrads: dk1's, then dk2's
  bf16 *gd1s, *gd2s, *y1s;   // scratch (B, 8, 8, 64) each: the taps' gradient's operands
  bf16 *dk, *dg1, *db1, *dg2, *db2;
  int batch, chunks;
};

// The thread's 32 positions of a sample's bfloat16 (64, 64) rows.
__device__ __forceinline__ void load_frag(const bf16* __restrict__ src, uint32_t (&r)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r[2 * j + h] = __ldg(reinterpret_cast<const unsigned*>(src + frag_off(j, h)));
}

__device__ __forceinline__ void unpack_frag(const uint32_t (&r)[16], float (&d)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 f = unpack2(r[2 * j + h]);
      d[4 * j + 2 * h] = f.x;
      d[4 * j + 2 * h + 1] = f.y;
    }
}

// The norm's backward in place: ga (the gradient of a = N(d), accumulator layout) becomes gd:
// per channel sa = sum ga, sx = sum ga xn (AdaIN: dbeta, dgamma, rounded into the sample's
// table rows db, dg); gd = rstd gamma (ga - sa / 64 - xn sx / 64), xn = (d - mean) rstd.
template <bool kAdain>
__device__ __forceinline__ void norm_grad(float (&ga)[32], const float (&d)[32],
                                          const float (&mean)[16], const float (&rstd)[16],
                                          const float (&gam)[16], bf16* __restrict__ dg,
                                          bf16* __restrict__ db, float* red, int wg) {
  float s[2][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int q0 = 4 * (i >> 1) + (i & 1), q1 = q0 + 2;
    s[0][i] = ga[q0] + ga[q1];
    s[1][i] = fmaf(ga[q0], (d[q0] - mean[i]) * rstd[i], ga[q1] * ((d[q1] - mean[i]) * rstd[i]));
  }
  channel_sums<2>(s, red, wg);
  if (kAdain && threadIdx.x % kWarpGroup < 4)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      dg[chan(i)] = __float2bfloat16_rn(s[1][i]);
      db[chan(i)] = __float2bfloat16_rn(s[0][i]);
    }
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const int i = 2 * (q >> 2) + (q & 1);
    const float xn = (d[q] - mean[i]) * rstd[i];
    const float scale = kAdain ? rstd[i] * gam[i] : rstd[i];
    ga[q] = scale * (ga[q] - s[0][i] * (1.f / kPix) - xn * (s[1][i] * (1.f / kPix)));
  }
}

// The thread's 32 values into the warpgroup's field, then the field out to dst (a sample's
// rows in device memory); the field stays.
__device__ __forceinline__ void put_and_store(unsigned char* field, const float (&v)[32],
                                              bf16* __restrict__ dst, int wg) {
  put_tile(field, v);
  wg_sync(wg);
  store_tile(field, dst);
}

template <bool kAdain, bool kDx>
__global__ void __launch_bounds__(kThreads, 1) res2d_bf16_bwd_wgmma_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / kWarpGroup;
  unsigned char* taps2 = smem;  // k2's slices (dy1), then k1's (dx)
  unsigned char* taps1 = smem + kConvBytes;
  unsigned char* gd = smem + kGdOff + wg * kTileBytes;
  float* red = reinterpret_cast<float*>(smem + kRedOff) + wg * kRedFloats;
  float* stat = reinterpret_cast<float*>(smem + kStatOff) + wg * kStatFloats;
  unsigned char* zero = smem + kZeroOff;
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();  // the swizzle needs 1024 B
  const int stride = kGroups * gridDim.x;
  // a sample's g, d2, d1 are asked into L2 a sample ahead: the first under the staging
  auto prefetch = [&](int s) {
    if (threadIdx.x % kWarpGroup == 0 && s < a.batch) {
      const size_t off = static_cast<size_t>(s) * kPix * kC;
      prefetch_l2(reinterpret_cast<const float*>(a.g + off), kTileBytes);
      prefetch_l2(reinterpret_cast<const float*>(a.d2 + off), kTileBytes);
      prefetch_l2(reinterpret_cast<const float*>(a.d1 + off), kTileBytes);
    }
  };
  prefetch(kGroups * blockIdx.x + wg);
  if (threadIdx.x < kRowBytes / 16) reinterpret_cast<uint4*>(zero)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  copy_taps(a.k2, taps2, threadIdx.x, kThreads);
  if (kDx) copy_taps(a.k1, taps1, threadIdx.x, kThreads);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  edge_slices(taps2, threadIdx.x, kThreads);
  if (kDx) edge_slices(taps1, threadIdx.x, kThreads);
  fence_proxy_async();
  __syncthreads();
  for (int s = kGroups * blockIdx.x + wg; s < a.batch; s += stride) {
    const size_t off = static_cast<size_t>(s) * kPix * kC;
    prefetch(s + stride);
    // g and d1 are read again where they are needed (from L2): held in registers across the
    // products they would spill. Every output goes out through the warpgroup's field gd
    // (put_and_store), whose last use it follows.
    uint32_t r[16];
    float d[32], ga[32], mean[16], rstd[16], gam[16] = {}, bet[16] = {};
    // (2) d1's statistics; a1 = N1(d1), its ReLU mask; y1 = bf16(relu(a1)) to scratch
    load_frag(a.d1 + off, r);
    unpack_frag(r, d);
    uint32_t mask = 0;
    if (kAdain) {
      table16(a.g1 + s * kC, gam);
      table16(a.b1 + s * kC, bet);
    }
    if (kLastPhase >= 2) {
      channel_stats(d, mean, rstd, red, wg);  // its barriers: the last sample's field reads done
      if (threadIdx.x % kWarpGroup < 4)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          stat[chan(i)] = mean[i];
          stat[kC + chan(i)] = rstd[i];
          stat[2 * kC + chan(i)] = gam[i];
        }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int i = 2 * (q >> 2) + (q & 1);
        const float a1 = norm_bf16<kAdain>(d[q], mean[i], rstd[i], gam[i], bet[i]);
        mask |= static_cast<uint32_t>(a1 > 0.f) << q;
        ga[q] = fmaxf(a1, 0.f);
      }
      put_and_store(gd, ga, a.y1s + off, wg);
    }
    // (1) gd2 = bf16(N2'(g, d2)), statistics from the rounded d2
    load_frag(a.g + off, r);
    unpack_frag(r, ga);
    load_frag(a.d2 + off, r);
    unpack_frag(r, d);
    if (kAdain) table16(a.g2 + s * kC, gam);
    if (kLastPhase >= 1) {
      channel_stats(d, mean, rstd, red, wg);  // its barriers: y1's field reads done
      norm_grad<kAdain>(ga, d, mean, rstd, gam, a.dg2 + s * kC, a.db2 + s * kC, red, wg);
      put_and_store(gd, ga, a.gd2s + off, wg);
    }
    wg_sync(wg);  // gd2 and the statistics in place
    // (3) dy1 = conv3x3^T(gd2, k2)
    float acc[32];
    if (kLastPhase >= 3) {
      input_grad(gd, zero, taps2, acc);
      if (kLastPhase == 3) keep(acc, a.dk);
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
    // (4) ga1 = dy1 where a1 > 0; gd1 = bf16(N1'(ga1, d1)) over gd2
    if (kLastPhase >= 4) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        mean[i] = stat[chan(i)];
        rstd[i] = stat[kC + chan(i)];
        gam[i] = stat[2 * kC + chan(i)];
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) ga[q] = (mask >> q) & 1 ? acc[q] : 0.f;
      load_frag(a.d1 + off, r);
      unpack_frag(r, d);
      norm_grad<kAdain>(ga, d, mean, rstd, gam, a.dg1 + s * kC, a.db1 + s * kC, red, wg);
      put_and_store(gd, ga, a.gd1s + off, wg);  // norm_grad's barriers: dy1's gathers done
    }
    // (5) dx = bf16(g + conv3x3^T(gd1, k1))
    if (kDx) {
      wg_sync(wg);  // gd1 in place
      if (kLastPhase >= 5) input_grad(gd, zero, taps1, acc);
      load_frag(a.g + off, r);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const float2 gv = unpack2(r[2 * (q >> 2) + ((q >> 1) & 1)]);
        acc[q] = __fadd_rn(q & 1 ? gv.y : gv.x, acc[q]);
      }
      wg_sync(wg);  // every warp's gathers of gd1 are done
      put_and_store(gd, acc, a.dx + off, wg);
    }
    wg_sync(wg);  // the field's reads are done before the next sample writes it
  }
}

__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;"
               ::: "memory");
}

// 16 bytes at this block's shared address a in the shared memory of block `rank` of the cluster.
__device__ __forceinline__ float4 ld_cluster(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(r)
               : "memory");
  return v;
}

// The taps' gradient of one conv over a chunk of the batch; a cluster's rows summed in one.
__global__ void __cluster_dims__(kDkCluster, 1, 1) __launch_bounds__(kDkThreads, 1)
    res2d_bf16_dk_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();  // the swizzle needs 1024 B
  const int conv = blockIdx.x / a.chunks, chunk = blockIdx.x % a.chunks;
  const bf16* in = conv ? a.y1s : a.x;
  const bf16* gsrc = conv ? a.gd2s : a.gd1s;
  const int wg = threadIdx.x / kWarpGroup, tid = threadIdx.x % kWarpGroup;
  const int warp = tid >> 5, lane = tid & 31;
  float acc[3][32];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[k][i] = 0.f;
  // ldmatrix.trans: lane l addresses pixel row (l % 8) + 8 (l / 16) of a k-step's 16, and
  // C_in chunk 2 warp + (l / 8) % 2: A[ci][p] = in[tap source of p][ci], the m16n8k16 A layout
  const int pl = (lane & 7) + 8 * (lane >> 4), cl = 2 * warp + ((lane >> 3) & 1);
  auto fill = [&](int s, int buf) {
    const size_t off = static_cast<size_t>(s) * kPix * kC;
    copy_tile(in + off, smem + buf * 2 * kTileBytes, threadIdx.x, kDkThreads);
    copy_tile(gsrc + off, smem + (buf * 2 + 1) * kTileBytes, threadIdx.x, kDkThreads);
  };
#pragma unroll
  for (int k = 0; k < kDkStages - 1; ++k) {
    if (chunk + k * a.chunks < a.batch) fill(chunk + k * a.chunks, k);
    cp_async_commit();
  }
  for (int s = chunk, it = 0; s < a.batch; s += a.chunks, ++it) {
    const unsigned char* field = smem + (it % kDkStages) * 2 * kTileBytes;
    const unsigned char* gdt = field + kTileBytes;
    const int ahead = s + (kDkStages - 1) * a.chunks;
    if (ahead < a.batch) fill(ahead, (it + kDkStages - 1) % kDkStages);
    cp_async_commit();
    cp_async_wait<kDkStages - 1>();
    fence_proxy_async();  // gd, copied by this thread, is read by wgmma
    __syncthreads();
    if (kLastPhase >= 6) {
      // each tap's four k-steps add into its sums in the tensor cores, one group a tap, the
      // next tap's gather in flight meanwhile (two A buffers)
      uint32_t am[2][4][4];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (k == 2) {
          wgmma_wait<1>();
          fence_regs(acc[0]);
          fence_regs(am[0]);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int p = 16 * ks + pl;
          const int src = reflect8((p >> 3) + wg - 1) * kW + reflect8((p & 7) + k - 1);
          ldsm_x4_trans(am[k & 1][ks], smem_u32(field + swz(src, cl)));
        }
        fence_regs(acc[k]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma<1, 1>(acc[k], am[k & 1][ks], desc_sw128(smem_u32(gdt) + ks * 16 * kRowBytes));
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(acc[1]);
      fence_regs(acc[2]);
      fence_regs(am[1]);
      fence_regs(am[0]);
    }
    __syncthreads();  // every warpgroup is done with this buffer before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring's reads are done: the block's row goes over it
  // the row thread-major, 16 contiguous bytes a thread a store (a thread's own pairs, stored
  // where they lie in dk, scatter a warp's stores over 8 rows and ran far below the memory's
  // rate): tap t's
  // 4,096 floats as [j][thread][4], the float4 acc[4 j .. 4 j + 3] (reduce_rows_bf16_kernel
  // maps them back)
  float* mine = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(mine + (3 * wg + k) * kC * kC + (j * kWarpGroup + tid) * 4) =
          make_float4(acc[k][4 * j], acc[k][4 * j + 1], acc[k][4 * j + 2], acc[k][4 * j + 3]);
  cluster_sync_all();  // every block's row in its shared memory
  // block rank r of the cluster sums the quarter r of the cluster's rows, in rank order, and
  // writes it to the cluster's row in device memory: a fourth of the rows the sum then reads
  constexpr int kQuarter = kTapGrads / 4 / kDkCluster;  // float4s
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  float4* row = reinterpret_cast<float4*>(
      a.part + (static_cast<size_t>(conv) * (a.chunks / kDkCluster) + chunk / kDkCluster) *
                   kTapGrads);
  for (int i = rank * kQuarter + threadIdx.x; i < (rank + 1) * kQuarter; i += kDkThreads) {
    const uint32_t at = smem_u32(mine) + i * 16;
    float4 v = ld_cluster(at, 0);
#pragma unroll
    for (int r = 1; r < kDkCluster; ++r) {
      const float4 u = ld_cluster(at, r);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    row[i] = v;
  }
  cluster_sync_all();  // no block leaves while another reads its shared memory
}

// dk = bf16 of the sum over the rows c = 0 .. rows - 1 (one a cluster), in that order, of each
// conv's rows, dk1 then dk2: a thread sums one float4 of the thread-major rows (tap t, j, thread w l) and
// writes it where it lies in dk (t, C_in, C_out): C_in 16 w + l / 4 (+ 8), C_out 8 j + 2 (l % 4)
// (+ 1).
__global__ void reduce_rows_bf16_kernel(const float* __restrict__ part, int rows,
                                        bf16* __restrict__ dk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // a float4 of the two convs' rows
  if (i >= 2 * kTapGrads / 4) return;
  const int conv = i / (kTapGrads / 4), k = i % (kTapGrads / 4);
  const float4* p = reinterpret_cast<const float4*>(part) +
                    static_cast<size_t>(conv) * rows * (kTapGrads / 4) + k;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = 0; c < rows; ++c) {
    const float4 v = p[static_cast<size_t>(c) * (kTapGrads / 4)];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int t = k / (kC * kC / 4), j = (k / kWarpGroup) % 8, thr = k % kWarpGroup;
  const int w = thr >> 5, l = thr & 31;
  bf16* o = dk + conv * kTapGrads + t * kC * kC + (16 * w + (l >> 2)) * kC + 8 * j + 2 * (l & 3);
  *reinterpret_cast<uint32_t*>(o) = pack2(s.x, s.y);
  *reinterpret_cast<uint32_t*>(o + 8 * kC) = pack2(s.z, s.w);
}

template <bool kAdain, bool kDx>
int launch_input_grads(const Args& a, int blocks, cudaStream_t s) {
  static int smem_set = 0;
  const int err = allow_smem(res2d_bf16_bwd_wgmma_kernel<kAdain, kDx>, static_cast<int>(kSmem),
                             &smem_set);
  if (err) return err;
  res2d_bf16_bwd_wgmma_kernel<kAdain, kDx><<<blocks, kThreads, kSmem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The clusters of the taps' gradient's kernel that the card holds at once, into out: more
// clusters than that run in a second wave.
int iins_res_block_2d_bf16_bwd_slots(int* out) {
  static int smem_set = 0;
  const int err = allow_smem(res2d_bf16_dk_kernel, static_cast<int>(kDkSmem), &smem_set);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kDkCluster * 64);
  cfg.blockDim = dim3(kDkThreads);
  cfg.dynamicSmemBytes = kDkSmem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, res2d_bf16_dk_kernel, &cfg));
}

// bfloat16 x, d1, d2 (K7's saved pre-norm conv outputs), g (B, 8, 8, 64); k1, k2 (3, 3, 64,
// 64); g1, b1, g2 (B, 64) for the AdaIN block, null for the InstanceNorm block. Out (bfloat16):
// dx (B, 8, 8, 64) or null (not needed); dk (2 x 36,864: dk1 then dk2); dg1, db1, dg2, db2
// (B, 64) for AdaIN, else null. blocks: the input gradients' persistent grid, at most B;
// chunks: the taps' gradient's blocks a conv, a multiple of 4 (the cluster) and at most B
// rounded up to one; scratch: 2 x chunks / 4 x 36,864 floats of partial rows (one a cluster),
// then 3 x B x 4,096 bfloat16 (gd1, gd2, y1). Every pointer 16-byte aligned.
int iins_res_block_2d_bf16_bwd(const void* x, const void* d1, const void* d2, const void* k1,
                               const void* k2, const void* g1, const void* b1, const void* g2,
                               const void* g, void* dx, void* scratch, void* dk, void* dg1,
                               void* db1, void* dg2, void* db2, int batch, int blocks,
                               int chunks, void* stream) {
  if (batch <= 0 || blocks <= 0 || blocks > batch || chunks <= 0 || chunks % kDkCluster ||
      chunks > kDkCluster * ((batch + kDkCluster - 1) / kDkCluster) || !x || !d1 || !d2 || !k1 || !k2 || !g || !scratch || !dk)
    return cudaErrorInvalidValue;
  const bool adain = g1 != nullptr;
  if (adain != (b1 != nullptr) || adain != (g2 != nullptr) || adain != (dg1 != nullptr) ||
      adain != (db1 != nullptr) || adain != (dg2 != nullptr) || adain != (db2 != nullptr))
    return cudaErrorInvalidValue;
  static int dk_smem_set = 0;
  int err = allow_smem(res2d_bf16_dk_kernel, static_cast<int>(kDkSmem), &dk_smem_set);
  if (err) return err;
  using cb = const bf16*;
  float* part = static_cast<float*>(scratch);
  bf16* fields =
      reinterpret_cast<bf16*>(part + static_cast<size_t>(2) * (chunks / kDkCluster) * kTapGrads);
  const size_t n = static_cast<size_t>(batch) * kPix * kC;
  const Args args{static_cast<cb>(x),     static_cast<cb>(d1),    static_cast<cb>(d2),
                  static_cast<cb>(k1),    static_cast<cb>(k2),    static_cast<cb>(g1),
                  static_cast<cb>(b1),    static_cast<cb>(g2),    static_cast<cb>(g),
                  static_cast<bf16*>(dx), part,                   fields,
                  fields + n,             fields + 2 * n,         static_cast<bf16*>(dk),
                  static_cast<bf16*>(dg1), static_cast<bf16*>(db1), static_cast<bf16*>(dg2),
                  static_cast<bf16*>(db2), batch,                 chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adain)
    err = dx ? launch_input_grads<true, true>(args, blocks, s)
             : launch_input_grads<true, false>(args, blocks, s);
  else
    err = dx ? launch_input_grads<false, true>(args, blocks, s)
             : launch_input_grads<false, false>(args, blocks, s);
  if (err) return err;
  res2d_bf16_dk_kernel<<<2 * chunks, kDkThreads, kDkSmem, s>>>(args);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  reduce_rows_bf16_kernel<<<(2 * kTapGrads / 4 + 255) / 256, 256, 0, s>>>(
      part, chunks / kDkCluster, static_cast<bf16*>(dk));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
