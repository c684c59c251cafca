// K7 res_block_2d, bfloat16 instance: the 2-D residual block of K7 (res_block_2d.cu) on
// bfloat16 x, taps and AdaIN tables, as the Pallas body computes it on bfloat16 refs
// (iinsvae_tpu/ops/pallas/res2d.py:128-139, :176-198):
//   d1 = conv3x3(bf16 x, bf16 k1), fp32 sums;  a1 = N1(d1), statistics in fp32 of the unrounded d1
//   y1 = bf16(relu(a1));  d2 = conv3x3(y1, bf16 k2), fp32 sums;  y = bf16(x + N2(d2))
// with d1, d2 stored as bfloat16 for the backward (res_block_2d_bf16_bwd.cu) where asked.
// Reflect pad 1 on both axes; at the edge columns 0 and 7 the W taps 0 and 2 read one
// column (1 or 6), and the Pallas kernel's lane-mix matrices (assemble_w3, res2d.py:69,
// assembled in bfloat16) hold that column's weight as the one rounded sum
// bf16(k[dh][0] + k[dh][2]): this kernel takes those three edge slices as taps of their own
// (plain version: res2d.res_block_2d_bf16_ref).
//
// Bound on the H100 at batch 500: 2 x 64 pixels x 64 x 576 multiply-adds a sample, 4.72 GFLOP
// on the bfloat16 tensor cores (989 TFLOP/s dense) is 4.8 us; the bytes, x and y (8.2 MB) and
// d1, d2 under training (8.2 MB), 2.4-4.9 us at 3.35 TB/s. A first, simple design:
// - A block of 256 threads owns a tile of two samples (128 pixel rows); 250 blocks at batch
//   500, one a SM (161 KB of shared memory).
// - Each conv is a (128 x 768) . (768 x 64) product on the tensor cores, mma.sync m16n8k16
//   with bfloat16 operands and fp32 accumulators, over twelve tap slices (nine taps, three
//   edge slices); a warp owns 32 x 32 of the output. A operand: the field's pixel rows in
//   shared memory (bfloat16, rows of 72), reflect-shifted for the tap and read in place, a
//   zero row where the slice does not apply to the pixel; B: the slice as stored, (C_in,
//   C_out) rows of 72, copied 16 bytes at a time (res_block_2d_bf16.cuh), a fragment's pair
//   two 2-byte loads a row apart. Each slice's four k-steps run in a partial sum from zero
//   that is added to the conv's sums in fp32: the tensor cores' accumulation truncates.
// - The conv's fp32 output goes to shared memory for the statistics (two-pass) and the
//   epilogue; y1 replaces x in the field; y reads x again from device memory (L2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"
#include "res_block_2d.cuh"
#include "res_block_2d_bf16.cuh"

namespace {

using namespace res2d;
using namespace res2d_bf16;

constexpr int kLdD = kC + 4;             // floats between two pixel rows of the conv output
constexpr int kRows = kSamples * kPix;   // 128 pixel rows a tile
constexpr int kZeroRow = kRows;          // the field's all-zero row
constexpr size_t kFieldBytes = (kRows + 1) * kLd * sizeof(bf16);
constexpr size_t kTapBytes = kSlices * kSlice * sizeof(bf16);
constexpr size_t kSmem = kFieldBytes + kTapBytes + kRows * kLdD * sizeof(float) +
                         2 * kSamples * kC * sizeof(float);
static_assert(kFieldBytes % 16 == 0 && kTapBytes % 16 == 0, "16-byte aligned regions");

// The field row that tile row p reads for slice t: taps t < 9 (dh, dw) read the
// reflect-shifted pixel, except that at the edge columns the W taps 0 and 2 give way to the
// edge slice 9 + dh, which reads column 1 (at column 0) or 6 (at column 7); a zero row where
// the slice does not apply.
__device__ __forceinline__ int source_row(int p, int t) {
  const int s = p >> 6, u = (p >> 3) & 7, v = p & 7;
  const bool edge = v == 0 || v == kW - 1;
  int dh, col;
  if (t < kTaps) {
    dh = t / 3;
    const int dw = t % 3;
    if (edge && dw != 1) return kZeroRow;
    col = reflect8(v + dw - 1);
  } else {
    dh = t - kTaps;
    if (!edge) return kZeroRow;
    col = v == 0 ? 1 : kW - 2;
  }
  return s * kPix + reflect8(u + dh - 1) * kW + col;
}

// acc = the warp's 32 x 32 of the conv of the field (bfloat16 rows of kLd) with the staged
// slices: rows x_row0() + 16 mt (+ 8), columns x_col0() + 8 nt (+ 1), the mma's C layout.
__device__ void conv(const bf16* field, const bf16* taps, float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 6) * 32, c0 = ((threadIdx.x >> 5) & 1) * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll 1
  for (int t = 0; t < kSlices; ++t) {
    const bf16* A[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        A[mt][h] = field + source_row(r0 + 16 * mt + 8 * h + g, t) * kLd + t2;
    // B[k = ci][n = co] from the slice's (C_in, C_out) rows: a pair along ci, two rows apart
    const bf16* B = taps + t * kSlice + t2 * kLd + c0 + g;
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
        const bf16* b = B + k0 * kLd + 8 * nt;
        const uint32_t b0 = pack(b[0], b[kLd]), b1 = pack(b[8 * kLd], b[9 * kLd]);
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

// The warp's share of the conv output into D (rows of kLdD floats).
__device__ __forceinline__ void store_acc(const float (&acc)[2][4][4], float* D) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t2 = 2 * (lane & 3);
  const int r0 = (threadIdx.x >> 6) * 32, c0 = ((threadIdx.x >> 5) & 1) * 32;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* d = D + (r0 + 16 * mt + 8 * h + g) * kLdD + c0 + 8 * nt + t2;
        d[0] = acc[mt][nt][2 * h];
        d[1] = acc[mt][nt][2 * h + 1];
      }
}

// The normalised value of conv output v of (sample, channel) q, with the AdaIN affine of the
// bfloat16 (B, C) tables g, b (offset to the tile's first sample) where they are given:
// xn * gamma, then + beta, each rounded, as the plain version computes it.
__device__ __forceinline__ float norm_bf16(float v, int q, const float* mean, const float* rstd,
                                           const bf16* __restrict__ g,
                                           const bf16* __restrict__ b) {
  v = __fmul_rn(__fsub_rn(v, mean[q]), rstd[q]);
  return g ? __fadd_rn(__fmul_rn(v, __bfloat162float(g[q])), __bfloat162float(b[q])) : v;
}

struct Args {
  const bf16 *x, *k1, *k2, *g1, *b1, *g2, *b2;
  bf16 *y, *d1, *d2;
  int batch;
};

// kSave: also write d1 and d2 (training); the arithmetic is the same either way.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1) res2d_bf16_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* field = reinterpret_cast<bf16*>(smem_raw);                  // x, then y1
  bf16* taps = reinterpret_cast<bf16*>(smem_raw + kFieldBytes);     // k1's slices, then k2's
  float* D = reinterpret_cast<float*>(smem_raw + kFieldBytes + kTapBytes);  // d1, then d2
  float* mean = D + kRows * kLdD;
  float* rstd = mean + kSamples * kC;
  const int s0 = blockIdx.x * kSamples, ns = min(kSamples, a.batch - s0);
  const size_t off = static_cast<size_t>(s0) * kPix * kC;
  const bf16 *g1 = nullptr, *b1 = nullptr, *g2 = nullptr, *b2 = nullptr;
  if (a.g1) {
    g1 = a.g1 + s0 * kC;
    b1 = a.b1 + s0 * kC;
    g2 = a.g2 + s0 * kC;
    b2 = a.b2 + s0 * kC;
  }
  // x into the field (a missing second sample and the zero row as zeros), 8 bfloat16 a thread
  for (int i = threadIdx.x; i < (kRows + 1) * (kC / 8); i += kThreads) {
    const int r = i / (kC / 8), c = (i % (kC / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < ns * kPix) v = *reinterpret_cast<const uint4*>(a.x + off + r * kC + c);
    *reinterpret_cast<uint4*>(field + r * kLd + c) = v;
  }
  stage_slices(a.k1, taps);
  __syncthreads();
  float acc[2][4][4];
  for (int n = 0; n < 2; ++n) {
    // d = conv3x3(field, k): into D, saved as bfloat16 where asked
    conv(field, taps, acc);
    store_acc(acc, D);
    __syncthreads();
    if (n == 0) stage_slices(a.k2, taps);  // k1's slices are no longer read
    bf16* saved = n == 0 ? a.d1 : a.d2;
    if (kSave)
      for (int i = threadIdx.x; i < ns * kPix * kC; i += kThreads)
        saved[off + i] = __float2bfloat16_rn(D[(i / kC) * kLdD + i % kC]);
    channel_stats<kLdD>(D, mean, rstd);
    __syncthreads();
    if (n == 0) {
      // y1 = bf16(relu(N1(d1))) replaces x in the field
      for (int i = threadIdx.x; i < kRows * kC; i += kThreads) {
        const int r = i / kC, c = i % kC, q = (r / kPix) * kC + c;
        const float v = (r / kPix) < ns ? norm_bf16(D[r * kLdD + c], q, mean, rstd, g1, b1) : 0.f;
        field[r * kLd + c] = __float2bfloat16_rn(fmaxf(v, 0.f));
      }
      __syncthreads();
    }
  }
  // y = bf16(x + N2(d2)), x reread (from L2)
  for (int i = threadIdx.x; i < ns * kPix * kC; i += kThreads) {
    const int r = i / kC, c = i % kC, q = (r / kPix) * kC + c;
    const float v = norm_bf16(D[r * kLdD + c], q, mean, rstd, g2, b2);
    a.y[off + i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(a.x[off + i]), v));
  }
}

template <bool kSave>
int launch(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;
  const int err = allow_smem(res2d_bf16_kernel<kSave>, static_cast<int>(kSmem), &smem_set);
  if (err) return err;
  const int grid = (a.batch + kSamples - 1) / kSamples;
  res2d_bf16_kernel<kSave><<<grid, kThreads, kSmem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bfloat16 x, y (B, 8, 8, 64); k1, k2 (3, 3, 64, 64); g1, b1, g2, b2 (B, 64) for the AdaIN
// block, all four null for the InstanceNorm block; d1, d2 (B, 8, 8, 64) the pre-norm conv
// outputs to save for the backward, both or neither null. Every pointer 16-byte aligned.
int iins_res_block_2d_bf16(const void* x, const void* k1, const void* k2, const void* g1,
                           const void* b1, const void* g2, const void* b2, void* y, void* d1,
                           void* d2, int batch, void* stream) {
  if (batch <= 0 || !x || !k1 || !k2 || !y || (d1 == nullptr) != (d2 == nullptr))
    return cudaErrorInvalidValue;
  if ((g1 == nullptr) != (b1 == nullptr) || (g1 == nullptr) != (g2 == nullptr) ||
      (g1 == nullptr) != (b2 == nullptr))
    return cudaErrorInvalidValue;
  const Args args{static_cast<const bf16*>(x),  static_cast<const bf16*>(k1),
                  static_cast<const bf16*>(k2), static_cast<const bf16*>(g1),
                  static_cast<const bf16*>(b1), static_cast<const bf16*>(g2),
                  static_cast<const bf16*>(b2), static_cast<bf16*>(y),
                  static_cast<bf16*>(d1),       static_cast<bf16*>(d2),
                  batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d1 ? launch<true>(args, s) : launch<false>(args, s);
}

}  // extern "C"
