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
// d1, d2 under training (8.2 MB), 2.4-4.9 us at 3.35 TB/s. The design, for Hopper (res_block_2d_bf16.cuh):
// - Persistent blocks of two warpgroups, one block an SM (at most ceil(B / 2)); a warpgroup
//   owns one sample at a time, samples 2 b + w, then + 2 x grid. Both convs' twelve slices
//   (192 KB, 128-byte swizzled) are staged once a block, before the first sample, and stay:
//   the nine taps by cp.async, every copy in flight at once, then the edge sums from them; the
//   first design restaged them twice a tile of two samples.
// - Each conv is 12 products (64 pixels x 64 C_in) . (64 C_in x 64 C_out) of four wgmma
//   m64n64k16 each: A, the reflect-shifted pixel rows of the field (x, then y1), gathered into
//   registers by ldmatrix with each lane's own row address (a zero row where the slice does not
//   apply), so the reflection is an address and not a copy; B, the slice, read by a
//   descriptor with the transpose (the slice's rows are C_in). Each slice's four k-steps sum
//   from zero into one of two partial accumulators, added to the conv's sums in fp32 (the tensor
//   cores' accumulation truncates) while the next slice's products run.
// - Statistics from the accumulators: a thread's 2 rows a channel, shuffles across the warp's
//   rows, the four warps' sums through shared memory; two-pass. y1 goes back into the field
//   over x (a thread keeps its own 32 values of x in registers for the skip); d1, d2 and y go
//   out through the field too, 16 contiguous bytes a thread (store_tile).
// - The next sample's x comes in by cp.async into the warpgroup's second field under the
//   current sample's products. Shared memory: 192 KB of taps, 4 x 8 KB of fields, 2 KB of
//   sums, a zero row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"
#include "res_block_2d_bf16.cuh"

namespace {

using namespace res2d_bf16;

constexpr int kGroups = 2;  // warpgroups a block, one sample each
constexpr int kThreads = kGroups * kWarpGroup;
constexpr int kFieldsOff = 2 * kConvBytes;
constexpr int kRedOff = kFieldsOff + 2 * kGroups * kTileBytes;
constexpr int kZeroOff = kRedOff + kGroups * 4 * kC * 4;
constexpr size_t kSmem = kZeroOff + kRowBytes;
static_assert(kSmem <= 232448, "over the H100's 227 KB of shared memory a block");

// Phases past kLastPhase do no work (phase_times.py --kernel res2d_bf16): 0 the staging, the
// copies, waits and barriers; 1 conv 1's products; 2 its statistics, d1, y1; 3 conv 2's
// products; 4 its statistics and the epilogue. A cut right after a conv's products keeps them
// (keep), or ptxas would drop them.
constexpr int kLastPhase = 4;

// The field row that output pixel p reads for slice t, or -1 (a zero row): taps t < 9 (dh, dw)
// the reflect-shifted pixel, except that at the edge columns the W taps 0 and 2 give way to the
// edge slice 9 + dh, which reads column 1 (at column 0) or 6 (at column 7).
__device__ __forceinline__ int source_row(int p, int t) {
  const int u = p >> 3, v = p & 7;
  const bool edge = v == 0 || v == kW - 1;
  if (t < kTaps) {
    const int dw = t % 3;
    if (edge && dw != 1) return -1;
    return reflect8(u + t / 3 - 1) * kW + reflect8(v + dw - 1);
  }
  if (!edge) return -1;
  return reflect8(u + t - kTaps - 1) * kW + (v == 0 ? 1 : kW - 2);
}

// acc = conv3x3 of the field with the staged slices, in the accumulator layout: twelve
// products, one a slice (B: the slice's rows C_in, the descriptor's transpose). kPhase: the
// products' phase, whose successor consumes acc (a cut between them keeps acc in sink).
template <int kPhase>
__device__ __forceinline__ void conv(const unsigned char* field, const unsigned char* zero,
                                     const unsigned char* taps, float (&acc)[32], bf16* sink) {
  if (kLastPhase < kPhase) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    return;
  }
  sum_products<2, 1, kSlices>(acc, field, zero, taps, gather_row(), [](int t) { return t; },
                           [](int p, int t) { return source_row(p, t); });
  if (kLastPhase == kPhase) keep(acc, sink);
}

struct Args {
  const bf16 *x, *k1, *k2, *g1, *b1, *g2, *b2;
  bf16 *y, *d1, *d2;
  int batch;
};

// kSave: also write d1 and d2 (training); the arithmetic is the same either way.
template <bool kSave, bool kAdain>
__global__ void __launch_bounds__(kThreads, 1) res2d_bf16_wgmma_kernel(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int wg = threadIdx.x / kWarpGroup, tid = threadIdx.x % kWarpGroup;
  unsigned char* taps1 = smem;
  unsigned char* taps2 = smem + kConvBytes;
  unsigned char* fields = smem + kFieldsOff + wg * 2 * kTileBytes;
  float* red = reinterpret_cast<float*>(smem + kRedOff) + wg * 4 * kC;
  unsigned char* zero = smem + kZeroOff;
  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();  // the swizzle needs 1024 B
  const int stride = kGroups * gridDim.x;
  int s = kGroups * blockIdx.x + wg;
  if (threadIdx.x < kRowBytes / 16) reinterpret_cast<uint4*>(zero)[threadIdx.x] = make_uint4(0, 0, 0, 0);
  copy_taps(a.k1, taps1, threadIdx.x, kThreads);
  copy_taps(a.k2, taps2, threadIdx.x, kThreads);
  if (s < a.batch) copy_tile(a.x + static_cast<size_t>(s) * kPix * kC, fields, tid, kWarpGroup);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();
  edge_slices(taps1, threadIdx.x, kThreads);
  edge_slices(taps2, threadIdx.x, kThreads);
  fence_proxy_async();
  __syncthreads();
  for (int it = 0; s < a.batch; s += stride, ++it) {
    unsigned char* field = fields + (it & 1) * kTileBytes;
    const size_t off = static_cast<size_t>(s) * kPix * kC;
    if (s + stride < a.batch)
      copy_tile(a.x + off + static_cast<size_t>(stride) * kPix * kC,
                fields + ((it + 1) & 1) * kTileBytes, tid, kWarpGroup);
    cp_async_commit();
    cp_async_wait<1>();  // this sample's x
    wg_sync(wg);
    // (1) d1 = conv3x3(x, k1)
    float acc[32], mean[16], rstd[16], gam[16] = {}, bet[16] = {};
    conv<1>(field, zero, taps1, acc, a.y);
    if (kAdain) {
      table16(a.g1 + s * kC, gam);
      table16(a.b1 + s * kC, bet);
    }
    // (2) its statistics; d1 saved; x kept for the skip; y1 = bf16(relu(N1(d1))) over x
    uint32_t xr[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xr[2 * j + h] = *reinterpret_cast<const uint32_t*>(field + frag_swz(j, h));
    if (kLastPhase >= 2) {
      channel_stats(acc, mean, rstd, red, wg);  // its barriers: every thread has its x
      if (kSave) {  // d1 out through the field
        put_tile(field, acc);
        wg_sync(wg);
        store_tile(field, a.d1 + off);
        wg_sync(wg);
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int i = 2 * (q >> 2) + (q & 1);
        acc[q] = fmaxf(norm_bf16<kAdain>(acc[q], mean[i], rstd[i], gam[i], bet[i]), 0.f);
      }
      put_tile(field, acc);
    }
    wg_sync(wg);  // y1 in place for every warp's gather
    // (3) d2 = conv3x3(y1, k2)
    conv<3>(field, zero, taps2, acc, a.y);
    // (4) its statistics; d2 saved; y = bf16(x + N2(d2))
    if (kLastPhase >= 4) {
      if (kAdain) {
        table16(a.g2 + s * kC, gam);
        table16(a.b2 + s * kC, bet);
      }
      channel_stats(acc, mean, rstd, red, wg);  // its barriers: every warp's gather is done
      if (kSave) {  // d2 out through the field
        put_tile(field, acc);
        wg_sync(wg);
        store_tile(field, a.d2 + off);
        wg_sync(wg);
      }
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        const int i = 2 * (q >> 2) + (q & 1);
        const float2 xv = unpack2(xr[2 * (q >> 2) + ((q >> 1) & 1)]);
        acc[q] = __fadd_rn(q & 1 ? xv.y : xv.x,
                           norm_bf16<kAdain>(acc[q], mean[i], rstd[i], gam[i], bet[i]));
      }
      put_tile(field, acc);  // y out through the field
      wg_sync(wg);
      store_tile(field, a.y + off);
    }
    wg_sync(wg);  // the field's reads are done before it is refilled
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
  }
  return sms;
}

template <bool kSave, bool kAdain>
int launch(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;
  const int err =
      allow_smem(res2d_bf16_wgmma_kernel<kSave, kAdain>, static_cast<int>(kSmem), &smem_set);
  if (err) return err;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int tiles = (a.batch + kGroups - 1) / kGroups, grid = tiles < sms ? tiles : sms;
  res2d_bf16_wgmma_kernel<kSave, kAdain><<<grid, kThreads, kSmem, stream>>>(a);
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
  if (g1) return d1 ? launch<true, true>(args, s) : launch<false, true>(args, s);
  return d1 ? launch<true, false>(args, s) : launch<false, false>(args, s);
}

}  // extern "C"
