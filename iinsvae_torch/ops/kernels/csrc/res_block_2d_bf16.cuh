// Device code shared by K7's bfloat16 instance (res_block_2d_bf16.cu) and its backward
// (res_block_2d_bf16_bwd.cu): the tile constants of the bfloat16 designs (their own, apart
// from the fp32 K7 / K7b of res_block_2d.cuh), the 128-byte swizzled layout of a field or a
// tap slice in shared memory, the staging of a conv's twelve tap slices, Hopper's warpgroup
// products (wgmma m64n64k16, bfloat16 operands, fp32 accumulators, A in registers gathered by
// ldmatrix, B read by a shared-memory descriptor), and the per-channel sums over one sample's
// 64 pixels that a warpgroup takes from its accumulators.
//
// A warpgroup (128 threads) owns one sample's 64 pixel rows x 64 channels. Its accumulator
// (wgmma's D fragment, 32 floats a thread) holds, for warp w, lane l (g = l / 4, t = l % 4),
// j = 0..7, h = 0..1, e = 0..1: d[4 j + 2 h + e] = D[16 w + g + 8 h][8 j + 2 t + e]. Every
// per-(pixel, channel) value of the designs lives in that layout: a thread reads and writes
// exactly those 32 positions of x, d1, d2, g, y, dx.
//
// Layout (the TMA's SWIZZLE_128B): a 64 x 64 bfloat16 tile is 64 rows of 128 bytes, 1024-byte
// aligned, its 16-byte chunk c of row r stored at chunk c ^ (r % 8). For wgmma's B operand a
// tap slice is staged as k stores it, rows C_in of C_out: with rows as K (K-major, no
// transpose) that is B[k = co][n = ci], the adjoint's B (K7b's input gradient); with rows as
// K and the descriptor's transpose (MN-major) it is B[k = ci][n = co], the conv's B (K7).
// ldmatrix reads 8 rows of 16 bytes a phase: the swizzle puts the 8 rows of one image row on
// distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"

namespace res2d_bf16 {

using bf16 = __nv_bfloat16;

constexpr int kH = 8, kW = 8, kPix = kH * kW, kC = 64;
constexpr int kTaps = 9;
constexpr int kSlices = kTaps + 3;              // nine taps and three edge slices
constexpr int kRowBytes = kC * 2;               // a pixel row (or a slice row) of bfloat16
constexpr int kTileBytes = kPix * kRowBytes;    // a sample's field, or one tap slice: 8 KB
constexpr int kConvBytes = kSlices * kTileBytes;  // a conv's twelve slices: 96 KB
constexpr int kWarpGroup = 128;
constexpr float kEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

// The row (or column) that virtual index u in [-1, 8] reads under reflect pad 1.
__device__ __forceinline__ int reflect8(int u) { return u < 0 ? -u : (u >= kH ? 2 * kH - 2 - u : u); }

// Byte offset of chunk c (8 bfloat16) of row r in a swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// ---------------------------------------------------------------- staging

// A conv's twelve slices into taps (kConvBytes, 1024-byte aligned), rows C_in of C_out as k
// (3, 3, C_in, C_out) stores them, swizzled. copy_taps: the nine taps, 16-byte cp.async copies
// by the threads tid = 0..n-1 (the caller commits, waits, fences and syncs); then edge_slices:
// the three edge slices bf16(k[dh][0] + k[dh][2]) from the staged taps, summed in fp32: at the
// edge columns 0 and 7 the W taps 0 and 2 read one column, and the Pallas kernel's lane-mix
// matrices (assemble_w3, res2d.py:69, assembled in bfloat16) hold that column's weight as this
// one rounded sum. The caller's fence_proxy_async and __syncthreads follow before wgmma reads.
__device__ inline void copy_taps(const bf16* __restrict__ k, unsigned char* taps, int tid,
                                 int n) {
  for (int i = tid; i < kTaps * kC * 8; i += n)
    cp_async16(reinterpret_cast<float*>(taps + (i >> 9) * kTileBytes + swz((i >> 3) & 63, i & 7)),
               reinterpret_cast<const float*>(k + i * 8), true);
}

__device__ inline void edge_slices(unsigned char* taps, int tid, int n) {
  for (int i = tid; i < 3 * kC * 8; i += n) {
    const int dh = i >> 9;
    const uint32_t o = swz((i >> 3) & 63, i & 7);
    const uint4 a = *reinterpret_cast<const uint4*>(taps + dh * 3 * kTileBytes + o);
    const uint4 b = *reinterpret_cast<const uint4*>(taps + (dh * 3 + 2) * kTileBytes + o);
    const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
    const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
    uint4 v;
    uint32_t* pv = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 fa = unpack2(pa[q]), fb = unpack2(pb[q]);
      pv[q] = pack2(fa.x + fb.x, fa.y + fb.y);
    }
    *reinterpret_cast<uint4*>(taps + (kTaps + dh) * kTileBytes + o) = v;
  }
}

// One sample's 64 rows of 128 bytes (src, consecutive in device memory) into a swizzled tile,
// 16-byte cp.async copies by the threads tid = 0..n-1 (the caller commits and waits).
__device__ __forceinline__ void copy_tile(const bf16* __restrict__ src, unsigned char* dst,
                                          int tid, int n) {
  for (int i = tid; i < kPix * 8; i += n)
    cp_async16(reinterpret_cast<float*>(dst + swz(i >> 3, i & 7)),
               reinterpret_cast<const float*>(src + i * 8), true);
}

// The thread's 32 values (accumulator layout) into a swizzled tile as bfloat16 pairs.
__device__ __forceinline__ void put_tile(unsigned char* tile, const float (&v)[32]);

// A warpgroup's swizzled tile out to a sample's 64 rows in device memory (dst), 16 bytes a
// thread a step, so that each warp stores 512 contiguous bytes: a thread's own 4-byte pairs,
// stored where they lie, scatter each warp's store over 8 rows and ran far below the memory's
// rate.
__device__ __forceinline__ void store_tile(const unsigned char* tile, bf16* __restrict__ dst) {
  const int tid = threadIdx.x % kWarpGroup;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = tid + k * kWarpGroup;
    *reinterpret_cast<uint4*>(dst + i * 8) =
        *reinterpret_cast<const uint4*>(tile + swz(i >> 3, i & 7));
  }
}

// Make this thread's generic-proxy writes to shared memory visible to the async proxy (wgmma's
// reads of its B operand); then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The 128 threads of warpgroup wg at a named barrier (1 + wg; 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// ---------------------------------------------------------------- wgmma

// A shared-memory matrix descriptor of a 128-byte swizzled operand at shared address a: start
// address, leading byte offset (16 B units; unused by a K-major swizzled operand, and by an
// MN-major one 64 elements wide), stride byte offset 1024 (the next 8 rows), layout
// SWIZZLE_128B.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t a) {
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an asynchronous wgmma owns
// across this point.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d = a b (kAccum 0) or d += a b, m64n64k16: a the warpgroup's 64 x 16 in registers (each
// warp's 16 rows in the mma.m16n8k16 A layout), b the 16 x 64 tile the descriptor names
// (kTransB 0: K-major, 1: MN-major), fp32 accumulators in d.
template <int kAccum, int kTransB>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(kAccum), "n"(kTransB));
}

// The four m64n64k16 steps of one K = 64 product: d = a . B (from zero: a partial sum that the
// caller adds to its sums in fp32, since the tensor cores' accumulation truncates); B's k-step
// ks starts at b + ks * kStep bytes (K-major: 32, MN-major: 16 rows of 128 bytes).
// The descriptors are made here, from an opaque copy of b's address: they depend only on the
// staged slices, and are not to be made once ahead of the sample loop and held in registers.
template <int kTransB, int kFirst = 0>
__device__ __forceinline__ void product64(float (&d)[32], const uint32_t (&a)[4][4],
                                          const unsigned char* b) {
  constexpr int kStep = kTransB ? 16 * kRowBytes : 32;
  uint32_t base = smem_u32(b);
  asm volatile("" : "+r"(base));
  wgmma<kFirst, kTransB>(d, a[0], desc_sw128(base));
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) wgmma<1, kTransB>(d, a[ks], desc_sw128(base + ks * kStep));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A operand of a K = 64 product whose row m (of the warpgroup's 64) is row src of a
// swizzled tile, or zero where src < 0: the lane's own row address (ldmatrix: lanes 8i..8i+7
// address matrix i's rows; matrices 0-3 are rows 0-7 / 8-15 of the warp's 16, k 0-7 / 8-15).
// src is the source of the lane's row 16 w + (l % 8) + 8 ((l / 8) % 2).
__device__ __forceinline__ void gather_a(uint32_t (&a)[4][4], const unsigned char* tile,
                                         const unsigned char* zero, int src) {
  const int kh = (threadIdx.x & 31) >> 4;
  const uint32_t base = smem_u32(src < 0 ? zero : tile + src * kRowBytes);
  const int r7 = src < 0 ? 0 : (src & 7);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) ldsm_x4(a[ks], base + (((2 * ks + kh) ^ r7) << 4));
}

// The row of the warpgroup's 64 a lane addresses in gather_a.
__device__ __forceinline__ int gather_row() {
  const int l = threadIdx.x & 31;
  return 16 * ((threadIdx.x >> 5) & 3) + (l & 7) + 8 * ((l >> 3) & 1);
}

// acc = the sum of kPasses products of K = 64: pass n multiplies the rows src(p, n) of field
// (gather_a, p the lane's row; -1 a zero row) by the tap slice slice(n) of taps. Pass n sums
// its four k-steps from zero into part[n % 2], added to acc in fp32 once its group is done,
// while pass n + 1's products run: the tensor cores' accumulation truncates, so no sum runs
// long in them. Unrolled (a loop over the passes made ptxas serialize the products); each pass
// takes the lane's row through an empty asm, so that no pass's gather addresses are computed
// ahead of it and held in registers.
// kPartBuffers 2 as above (K7's convs); 0: no partial sums, every pass adds into acc in the
// tensor cores (K7b's input gradients: its kernel then fits its registers without spilling and
// ran faster; the float64 checks hold, every output being rounded to bfloat16).
template <int kPartBuffers, int kTransB, int kPasses, typename Slice, typename Src>
__device__ __forceinline__ void sum_products(float (&acc)[32], const unsigned char* field,
                                             const unsigned char* zero,
                                             const unsigned char* taps, int p, Slice slice,
                                             Src src) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if constexpr (kPartBuffers == 0) {  // every pass adds into acc in the tensor cores
    uint32_t a[2][4][4];
    fence_regs(acc);
#pragma unroll
    for (int n = 0; n < kPasses; ++n) {
      int q = p;
      asm volatile("" : "+r"(q));
      gather_a(a[n & 1], field, zero, src(q, n));
      wgmma_fence();
      product64<kTransB, 1>(acc, a[n & 1], taps + slice(n) * kTileBytes);
      wgmma_commit();
      if (n > 0) {
        wgmma_wait<1>();
        fence_regs(a[(n - 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a[(kPasses - 1) & 1]);
    return;
  }
  float part[2][32];
  uint32_t a[2][4][4];
#pragma unroll
  for (int n = 0; n < kPasses; ++n) {
    int q = p;
    asm volatile("" : "+r"(q));
    gather_a(a[n & 1], field, zero, src(q, n));
    fence_regs(part[n & 1]);
    wgmma_fence();
    product64<kTransB>(part[n & 1], a[n & 1], taps + slice(n) * kTileBytes);
    wgmma_commit();
    if (n > 0) {
      wgmma_wait<1>();
      fence_regs(part[(n - 1) & 1]);
      fence_regs(a[(n - 1) & 1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += part[(n - 1) & 1][i];
    }
  }
  wgmma_wait<0>();
  fence_regs(part[(kPasses - 1) & 1]);
  fence_regs(a[(kPasses - 1) & 1]);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[(kPasses - 1) & 1][i];
}

// ---------------------------------------------------------------- per-channel sums

// A phase cut's sink (phase_times.py): keeps the values v live, storing their sum only where it
// is one NaN bit pattern that no sum of finite values is.
__device__ __forceinline__ void keep(const float (&v)[32], bf16* sink) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s += v[i];
  if (__float_as_uint(s) == 0x7fc00001u) *sink = __float2bfloat16_rn(s);
}

// The thread's 16 channels: c(j, e) = 8 j + 2 t + e, index 2 j + e.
__device__ __forceinline__ int chan(int i) { return 8 * (i >> 1) + 2 * (threadIdx.x & 3) + (i & 1); }

// In place, for kN values a channel: v[n][i] (this thread's sum over its two rows for channel
// chan(i)) becomes the sum over the sample's 64 pixels: over the warp's 8 row groups by
// shuffles, then the four warps' sums through red (kN x 4 x 64 floats of the warpgroup), added
// in warp order. Every thread of the warpgroup calls it.
template <int kN>
__device__ __forceinline__ void channel_sums(float (&v)[kN][16], float* red, int wg) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[n][i] += __shfl_xor_sync(kFull, v[n][i], 4);
      v[n][i] += __shfl_xor_sync(kFull, v[n][i], 8);
      v[n][i] += __shfl_xor_sync(kFull, v[n][i], 16);
    }
  if (lane < 4)
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 16; ++i) red[(n * 4 + warp) * kC + chan(i)] = v[n][i];
  wg_sync(wg);
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float* r = red + n * 4 * kC + chan(i);
      v[n][i] = ((r[0] + r[kC]) + r[2 * kC]) + r[3 * kC];
    }
  wg_sync(wg);  // red may be written again
}

// mean and 1/sqrt(var + eps) of each of the thread's 16 channels over the sample's 64 pixels,
// two-pass and biased, from the values d (the accumulator layout).
__device__ __forceinline__ void channel_stats(const float (&d)[32], float (&mean)[16],
                                              float (&rstd)[16], float* red, int wg) {
  float s[1][16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = i >> 1, e = i & 1;
    s[0][i] = d[4 * j + e] + d[4 * j + 2 + e];
  }
  channel_sums<1>(s, red, wg);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = i >> 1, e = i & 1;
    mean[i] = s[0][i] * (1.f / kPix);
    const float a = d[4 * j + e] - mean[i], b = d[4 * j + 2 + e] - mean[i];
    s[0][i] = fmaf(a, a, b * b);
  }
  channel_sums<1>(s, red, wg);
#pragma unroll
  for (int i = 0; i < 16; ++i) rstd[i] = rsqrtf(s[0][i] * (1.f / kPix) + kEps);
}

// The normalised value of conv output v of a channel, with the AdaIN affine (gamma, beta as
// floats of bfloat16 values) where kAdain: xn * gamma, then + beta, each rounded, as the plain
// version computes it.
template <bool kAdain>
__device__ __forceinline__ float norm_bf16(float v, float mean, float rstd, float gamma,
                                           float beta) {
  v = __fmul_rn(__fsub_rn(v, mean), rstd);
  return kAdain ? __fadd_rn(__fmul_rn(v, gamma), beta) : v;
}

// The thread's 16 channels of a sample's bfloat16 (B, C) table row as floats.
__device__ __forceinline__ void table16(const bf16* __restrict__ row, float (&v)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 f = unpack2(__ldg(reinterpret_cast<const unsigned*>(row + chan(2 * j))));
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// The element offset, in a sample's (64, 64) bfloat16 rows, of the pair d[4 j + 2 h] (+1).
__device__ __forceinline__ int frag_off(int j, int h) {
  const int l = threadIdx.x & 31;
  return (16 * ((threadIdx.x >> 5) & 3) + (l >> 2) + 8 * h) * kC + 8 * j + 2 * (l & 3);
}

// The byte offset of the same pair in a swizzled tile.
__device__ __forceinline__ uint32_t frag_swz(int j, int h) {
  const int l = threadIdx.x & 31;
  return swz(16 * ((threadIdx.x >> 5) & 3) + (l >> 2) + 8 * h, j) + 4 * (l & 3);
}

__device__ __forceinline__ void put_tile(unsigned char* tile, const float (&v)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(tile + frag_swz(j, h)) =
          pack2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
}

}  // namespace res2d_bf16
