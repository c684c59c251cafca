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
// Bound on the H100 at batch 500: the two convs are 2 x 64 pixels x 64 x 576
// multiply-adds a sample, 4.72 GFLOP, against 16.4 MB of x and y (4.9 us at
// 3.35 TB/s): bound by operations. As fp32 FMAs that is 70 us at 67 TFLOP/s;
// as 3xTF32 on the tensor cores (three TF32 products a product, 14.2 GFLOP)
// 28.6 us at 495 TFLOP/s, and mma.sync itself peaks at 0.667 m16n8k8 a clock
// an SM (tf32_peak.py), which puts the products' floor at 43-45 us. What the
// design does about it:
// - Each conv runs on the tensor cores, mma.sync m16n8k8 in 3xTF32
//   (mma_tf32.cuh): a tile of two samples is a (128 pixels x 576) . (576 x
//   64) product over the nine taps, a warp 32 x 32 of it, the next k-step's
//   operands loaded before this step's mma's. Its A operand is a pixel row
//   of the field in shared memory, reflect-shifted for the tap and read in
//   place, split into TF32 halves in registers; a lane's k indices t and
//   t + 4 are channels 2t and 2t + 1, one 8-byte load, and rows of kLd = 72
//   floats keep a warp's loads free of bank conflicts.
// - The B operand is the tap slice k[dh][dw][ci][co] with ci as the depth,
//   the strided axis as stored: read as stored, a fragment pair would be two
//   4-byte loads two rows apart, and every warp would split it again. So each
//   slice is split once a block, as it arrives: copied as stored (16-byte
//   cp.async into rows of 68 floats), then split by the block into hi and lo
//   halves laid out in fragment order, a lane's whole fragment pair (hi and
//   lo of both values) one 16-byte word, so that a warp reads an n-tile's B
//   with one conflict-free 16-byte load a lane and splits nothing but A.
// - Accuracy. Where an mma adds into its accumulator the tensor core
//   truncates the sum: a conv summed in one accumulator over its 216 mma's a
//   tile was 5-26 times further from the float64 conv than the plain fp32
//   one (k7_variants.py). So each two k-steps' products run in a partial sum
//   from zero, added to the conv's sums in fp32. And each conv's input is
//   centred first: less its mean per (sample, channel), conv(mean) added
//   back to the output (its products summed in fp32 as the block splits the
//   taps). Where a field barely varies over its pixels (the 2-D decoder's
//   blocks at init), InstanceNorm divides by a tiny std, so an error
//   relative to the field's values rather than its variation reached the
//   training step's gradients: without the centring, those of the decoder's
//   taps were 4.3 times further from float64 than
//   test_gpu_training_step_gradients_match_cpu allows. With both, y, d1 and
//   d2 stay within twice the plain fp32 block's error against float64
//   (tests/test_torch_gpu.py); PERF.md has what each costs.
// - The slices stream through shared memory: the block's eighteen (k1's
//   nine, then k2's) are copied two ahead of the products in a ring of two
//   raw slots, and one split slot holds the slice in use; after a slice's
//   products the block splits the next one into its place between two
//   __syncthreads. No product waits on a global load.
// - Blocks of 256 threads own a tile of two samples each (250 blocks at
//   batch 500, 128 at batch 256) in 104 KB of shared memory, so two blocks
//   share an SM: one block's splits, statistics and epilogue run under the
//   other's products. The field holds x, then d1 and y1 in place, then d2;
//   device memory sees x twice (the skip rereads it, from L2) and y once,
//   and the InstanceNorm statistics of a sample stay inside its block. The
//   variance is two-pass: the TPU kernel's E[x^2] - mean^2 went negative
//   (res2d.py:157).
#include "async_smem.cuh"
#include "mma_tf32.cuh"
#include "res_block_2d.cuh"

namespace {

using namespace res2d;
using tf32x3::Frag;

constexpr int kLdR = kC + 4;            // floats between two rows (ci) of a slice as copied
constexpr int kRaw = kC * kLdR;         // one slice as copied
constexpr int kSplit = kTapFloats / 2;  // 16-byte words of one slice split into hi and lo
constexpr int kSlices = 2 * kTaps;      // a tile's slices: k1's nine, then k2's
// the field, the split slice, two slices as copied, the statistics, center()'s constants and
// their conv
constexpr size_t kSmem = kPair * sizeof(float) + kSplit * sizeof(uint4) +
                         (2 * kRaw + 4 * kSamples * kC) * sizeof(float);
// The tile's phases: (1) the taps' split, (2) conv 1's products, (3) y1 = relu(N1(d1)),
// (4) conv 2's products, (5) y = x + N2(d2). The kernel computes them up to kLastPhase;
// phase_times.py builds variants with an earlier last phase, which keep every copy, wait and
// __syncthreads of the whole kernel.
constexpr int kLastPhase = 5;
// k-steps a partial sum of the products runs before it is added to the conv's sums (see
// tap_product)
constexpr int kFlush = 2;

// The output channel whose B fragments thread j splits (see split_slice).
__device__ __forceinline__ int co_of(int j) {
  return (j >> 7) * 32 + ((j >> 5) & 3) * 8 + ((j >> 2) & 7);
}

// A slice as copied (rows ci of kLdR floats) into the fragment order of the products: word
// ks * 256 + (wc * 4 + nt) * 32 + lane holds, for lane = 4 g + t, the split pair of
// (W[8 ks + 2 t][co], W[8 ks + 2 t + 1][co]), co = 32 wc + 8 nt + g: the B fragment of k-step
// ks and n-tile nt of the warps that own columns 32 wc .. + 31. Thread j writes the words of
// lane j % 32, n-tile (j / 32) % 4 and wc = j / 128 at every k-step: eight neighbouring threads
// write 128 neighbouring bytes, and a warp's 4-byte reads (four rows two apart, eight
// neighbouring columns) fall on 32 distinct banks. The thread also adds its 16 rows' share of
// the slice's c . W[:, co] to kp[s], sample s's c the (sample, channel) constants of center().
__device__ __forceinline__ void split_slice(const float* w, uint4* out, const float* c,
                                            float (&kp)[kSamples]) {
  const int j = threadIdx.x, t = j & 3;
  const float* src = w + 2 * t * kLdR + co_of(j);
  uint4* dst = out + (j >> 5) * 32 + (j & 31);
  float part[kSamples] = {};
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    const float v0 = src[8 * ks * kLdR], v1 = src[(8 * ks + 1) * kLdR];
    dst[ks * 256] = tf32x3::split_pair(v0, v1);
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      const float2 cc = ld2(c + s * kC + 8 * ks + 2 * t);
      part[s] = fmaf(cc.y, v1, fmaf(cc.x, v0, part[s]));
    }
  }
#pragma unroll
  for (int s = 0; s < kSamples; ++s) kp[s] += part[s];
}

// The block's tap slices in order, k1's nine then k2's: slice n is copied into raw slot n % 2
// as one cp.async group, two slices ahead of its products, and split into `split` once the
// products of slice n - 1 are done.
struct TapStream {
  const float* k1;
  const float* k2;
  float* raw;
  uint4* split;
  Groups gs;
  int cur = -1;  // the slice in `split`
  int group0 = 0, group1 = 0;  // the group of each raw slot's slice

  __device__ void issue(int n) {
    if (n >= kSlices) return;
    const float* k = n < kTaps ? k1 + n * kTapFloats : k2 + (n - kTaps) * kTapFloats;
    copy_rows<kLdR>(raw + (n & 1) * kRaw, k, kC);
    (n & 1 ? group1 : group0) = gs.commit();
  }

  // Every thread: wait for this thread's copies of the next slice. After its __syncthreads
  // every thread's have landed, `split` is no longer read and the field may be written.
  __device__ void land() {
    if (cur + 1 < kSlices) gs.wait((cur + 1) & 1 ? group1 : group0);
    __syncthreads();
  }

  // Every thread, after land(): split the next slice into `split` (and its share of conv(c)
  // into kp), then copy the slice two after it into the raw slot the next one came from.
  __device__ void next(const float* c, float (&kp)[kSamples]) {
    const int n = ++cur;
    if (kLastPhase >= 1) split_slice(raw + (n & 1) * kRaw, split, c, kp);
    __syncthreads();
    issue(n + 2);
  }
};

__device__ __forceinline__ void zero(float (&c)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0.f;
}

__device__ __forceinline__ void add(float (&c)[2][4][4], const float (&v)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[mt][nt][i] += v[mt][nt][i];
}

// acc += the warp's 32 x 32 of the tile's product for one tap (dh, dw): A row p (sample p / 64,
// pixel (u, v)) is the field's pixel (reflect(u + dh - 1), reflect(v + dw - 1)), read in place;
// B the split slice S. Where an mma adds its products into an accumulator the tensor core
// truncates the sum, so over a conv's 216 mma's a tile one accumulator drifts 5-26 times
// further from the exact sum than the plain fp32 conv (k7_variants.py). Instead each kFlush
// k-steps run in a partial sum of their own, from zero, which is then added to acc in fp32.
__device__ __forceinline__ void tap_product(const float* field, const uint4* S, int tap,
                                            float (&acc)[2][4][4]) {
  const int lane = threadIdx.x & 31, dh = tap / 3, dw = tap % 3;
  const float* A[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = x_row0() + 16 * mt + 8 * h;
      const int src = reflect8(((p >> 3) & 7) + dh - 1) * kW + reflect8((p & 7) + dw - 1);
      A[mt][h] = field + (p >> 6) * kField + src * kLd + 2 * (lane & 3);
    }
  const uint4* B = S + ((threadIdx.x >> 5) & 1) * 128 + lane;
  // A's pairs are loaded a k-step ahead of their products, B's (split already) as they are used:
  // more in flight spills the partial sums' registers
  float2 ra[2][2];
  auto fetch = [&](int ks) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      ra[mt][0] = ld2(A[mt][0] + 8 * ks);
      ra[mt][1] = ld2(A[mt][1] + 8 * ks);
    }
  };
  fetch(0);
  float part[2][4][4];
#pragma unroll 1
  for (int k0 = 0; k0 < kC / 8; k0 += kFlush) {
#pragma unroll
    for (int j = 0; j < kFlush; ++j) {
      const int ks = k0 + j;
      Frag<4> a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt].set(0, ra[mt][0].x);
        a[mt].set(1, ra[mt][1].x);
        a[mt].set(2, ra[mt][0].y);
        a[mt].set(3, ra[mt][1].y);
      }
      Frag<2> b[4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) b[nt] = tf32x3::frag(B[ks * 256 + nt * 32]);
      if (ks + 1 < kC / 8) fetch(ks + 1);
      if (j == 0)
        tf32x3::mma3<true>(part, a, b);
      else
        tf32x3::mma3(part, a, b);
    }
    add(acc, part);
  }
}

// Each (sample, channel) of the tile's field less its mean over the 64 pixels, c (written to
// c; two lanes a pair, as channel_stats): a reflect-padded constant field stays constant, so
// conv3x3(field) = conv3x3(field - c) + conv(c), conv(c) one value a (sample, output channel).
// Every thread calls it.
__device__ void center(float* field, float* c) {
  if (kLastPhase >= 1) {
    const int pair = threadIdx.x >> 1, lane = threadIdx.x & 1;
    const float* f = field + (pair / kC) * kField + pair % kC;
    float sum = 0.f;
    for (int i = lane; i < kPix; i += 2) sum += f[i * kLd];
    sum += __shfl_xor_sync(kFull, sum, 1);
    if (lane == 0) c[pair] = sum * (1.f / kPix);
  }
  __syncthreads();
  if (kLastPhase < 1) return;
  for_each4(kSamples, [&](int s, int pix, int ch) {
    float4* v = reinterpret_cast<float4*>(field + s * kField + pix * kLd + ch);
    const float4 a = *v, b = *reinterpret_cast<const float4*>(c + s * kC + ch);
    *v = make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
  });
}

// acc = the warp's 32 x 32 of conv3x3(field, k) on the tile, k's nine slices from the stream
// (the next one landed), field centred by center() with constants c; K = conv(c), (sample,
// output channel) rows. Every thread calls it; it ends with a __syncthreads after which the
// field may be written and K read. Without kMma only the stream's copies,
// splits, waits and __syncthreads.
template <bool kMma>
__device__ void conv3x3(const float* field, TapStream& st, const float* c, float* K,
                        float (&acc)[2][4][4]) {
  float kp[kSamples] = {};
  st.next(c, kp);
  zero(acc);
#pragma unroll 1
  for (int tap = 0; tap < kTaps; ++tap) {
    if (kMma) tap_product(field, st.split, tap, acc);
    st.land();
    if (tap + 1 < kTaps) st.next(c, kp);
  }
  // the four threads that split a column's fragments (lanes 4 g + t) hold its rows' shares
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    kp[s] += __shfl_xor_sync(kFull, kp[s], 1);
    kp[s] += __shfl_xor_sync(kFull, kp[s], 2);
    if ((threadIdx.x & 3) == 0) K[s * kC + co_of(threadIdx.x)] = kp[s];
  }
  __syncthreads();
}

// The warp's share of a conv output, acc + K, into the tile's field.
__device__ __forceinline__ void store_conv(const float (&acc)[2][4][4], const float* K,
                                           float* field) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = x_row0() + 16 * mt + 8 * h, c = x_col0() + 8 * nt;
        const float2 k = ld2(K + (p >> 6) * kC + c);
        *reinterpret_cast<float2*>(field + p * kLd + c) =
            make_float2(acc[mt][nt][2 * h] + k.x, acc[mt][nt][2 * h + 1] + k.y);
      }
}

// The first ns samples of the field into the tile's rows d of a (B, 8, 8, C) tensor in device
// memory (K7b's saved d1, d2), a float4 a thread, neighbouring threads on neighbouring bytes.
__device__ __forceinline__ void save_field(const float* field, float* __restrict__ d, int ns) {
  for_each4(ns, [&](int s, int pix, int c) {
    *reinterpret_cast<float4*>(d + (s * kPix + pix) * kC + c) =
        *reinterpret_cast<const float4*>(field + s * kField + pix * kLd + c);
  });
}

struct Args {
  const float *x, *k1, *k2, *g1, *b1, *g2, *b2;
  float *y, *d1, *d2;
  int batch;
};

// kSave: also write d1 and d2 (training); the arithmetic is the same either way.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 2) res2d_tc_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* f = smem;  // x, then d1 and y1, then d2
  uint4* split = reinterpret_cast<uint4*>(f + kPair);
  float* raw = reinterpret_cast<float*>(split + kSplit);
  float* mean = raw + 2 * kRaw;
  float* rstd = mean + kSamples * kC;
  float* c = rstd + kSamples * kC;                  // center()'s constants
  float* K = c + kSamples * kC;     // conv(c)
  const int s0 = blockIdx.x * kSamples, ns = min(kSamples, a.batch - s0);
  const size_t off = static_cast<size_t>(s0) * kPix * kC;
  const float *g1 = nullptr, *b1 = nullptr, *g2 = nullptr, *b2 = nullptr;
  if (a.g1) {
    g1 = a.g1 + s0 * kC;
    b1 = a.b1 + s0 * kC;
    g2 = a.g2 + s0 * kC;
    b2 = a.b2 + s0 * kC;
  }
  TapStream st{a.k1, a.k2, raw, split};
  // x into the field, a missing second sample as zeros
  for (int i = threadIdx.x; i < kSamples * kPix * (kC / 4); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool ok = r < ns * kPix;
    cp_async16(f + r * kLd + c, a.x + off + (ok ? r : 0) * kC + c, ok);
  }
  st.gs.commit();
  st.issue(0);
  st.issue(1);
  st.land();  // x and slice 0 in place
  float acc[2][4][4];
  // (2) d1 = conv3x3(x, k1) into the field
  center(f, c);
  conv3x3<kLastPhase >= 2>(f, st, c, K, acc);
  store_conv(acc, K, f);
  __syncthreads();
  if (kSave) save_field(f, a.d1 + off, ns);
  // (3) y1 = relu(N1(d1)), in place
  if (kLastPhase >= 3) {
    channel_stats<kLd>(f, mean, rstd);
    __syncthreads();
    norm_relu<kLd>(f, f, ns, mean, rstd, g1, b1);
  }
  __syncthreads();
  // (4) d2 = conv3x3(y1, k2) into the field
  center(f, c);
  conv3x3<kLastPhase >= 4>(f, st, c, K, acc);
  store_conv(acc, K, f);
  __syncthreads();
  if (kSave) save_field(f, a.d2 + off, ns);
  // (5) y = x + N2(d2), x reread (from L2)
  if (kLastPhase < 5) return;
  channel_stats<kLd>(f, mean, rstd);
  __syncthreads();
  for_each4(ns, [&](int s, int pix, int c) {
    const float4 v = *reinterpret_cast<const float4*>(f + s * kField + pix * kLd + c);
    const size_t i = off + (s * kPix + pix) * kC + c;
    const float4 r = __ldg(reinterpret_cast<const float4*>(a.x + i));
    const int q = s * kC + c;
    *reinterpret_cast<float4*>(a.y + i) = make_float4(
        r.x + norm_affine(v.x, q, mean, rstd, g2, b2),
        r.y + norm_affine(v.y, q + 1, mean, rstd, g2, b2),
        r.z + norm_affine(v.z, q + 2, mean, rstd, g2, b2),
        r.w + norm_affine(v.w, q + 3, mean, rstd, g2, b2));
  });
}

template <bool kSave>
int launch(const Args& a, cudaStream_t stream) {
  static int smem_set = 0;
  const int err = allow_smem(res2d_tc_kernel<kSave>, static_cast<int>(kSmem), &smem_set);
  if (err) return err;
  const int grid = (a.batch + kSamples - 1) / kSamples;
  res2d_tc_kernel<kSave><<<grid, kThreads, kSmem, stream>>>(a);
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
  const Args args{x, k1, k2, g1, b1, g2, b2, y, d1, d2, batch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d1 ? launch<true>(args, s) : launch<false>(args, s);
}

}  // extern "C"
