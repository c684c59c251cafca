// K6b sln_chain_bwd: the backward of K6, the 1-D decoder's tail, in one
// call: (B, L0, C0) -> 4 x (x2 upsample, conv k5 zero pad 2 + bias, sample
// LayerNorm, affine, ReLU) -> conv k7 reflect pad 3 + bias, tanh -> pool.
//
// Replaces the backward of fused_sln_chain (iinsvae_tpu/ops/pallas/
// fused.py:996, kernel _bwd_sln_chain_kernel :922, stage _sln_stage_bwd
// :880): dx, and per stage d(taps), dbias, dgamma, dbeta, then the out
// conv's d(taps) and dbias. The Pallas body reads the saved pre-norm
// activations and returns gradients of the dense upsample-conv matrices
// and tiled rows; this kernel saves nothing in the forward (K6 runs
// unchanged), recomputes the tail from the saved input in shared memory
// with K6's arithmetic, and returns the gradients of the taps and of the
// per-channel vectors directly. Backward, per sample:
//   pool^T: gth[u] = sum over the windows i holding u of g[i] / |window i|
//   tanh:   gz = gth * (1 - th^2); out conv: d(taps), dbias, and the
//           gradient of its input (the reflect pad's edge rows folded back)
//   per stage, last first: gh = ga where h > 0 (h = yh * gamma + beta);
//           dgamma += gh * yh, dbeta += gh (over the batch and L);
//           gyh = gh * gamma; the LayerNorm with unbiased std and
//           /(std + eps): gt = sum gyh * d, gss = gt * (-t^2) / (2s),
//           gd = gyh * t + d * 2 gss / (n - 1) (fused.py:892-894), then
//           gz = gd - mean(gd) (the centring's adjoint);
//           dbias += sum_l gz, d(taps) += up(a)^T gz, and the input's
//           gradient, the upsample's adjoint summing each row pair.
//
// Two paths. The decoder's shape, input (8, 64) (the only one Decoder1d gives K6; one call a
// 1-D training step), runs its own kernel (namespace tail below); every other shape the
// general kernel.
//
// Bound on the H100 at batch 500 (flagship): the forward recompute, d(taps)
// and the input gradients each need the forward's 177,024 multiply-adds a
// sample (counting the upsample's row pairs once): 0.53 GFLOP, 7.9 us at 67
// TFLOP/s fp32; ~1.4 MB moved: bound by operations.
//
// The general kernel keeps, per sample, the input, the four stage outputs and the four
// pre-norm conv outputs (9 x L0*C0 floats) and the tanh output in shared memory: 19 KB a
// sample at the flagship, 2 samples a block in the default 48 KB. Per-channel gradients
// (taps, bias, gamma, beta) are summed over the block's samples into its row of a (grid, n)
// buffer that a second kernel sums in order: deterministic, no atomics. The up-stages' code
// is sln_stage.cuh's (shared with K6, K9 and K9b); the fixed k7 reflect tail stays here: the
// runtime-geometry conv helpers K10b uses (conv_bwd_common.cuh) made K6b slower on the H100.
// At the decoder's shape it took 362-366 us at batch 500 (phase_times.py, H100): 148 in the
// d(taps) partials (one thread a tap entry, serial over 2 samples' rows, two shared loads a
// multiply-add, 250 partial rows of 13,809 floats), 108 in the input gradients (each thread
// reads a taps row of its own from device memory), about 80 in the recompute.
//
// The decoder's kernel (tail):
// - one persistent block a SM (512 threads) walks tiles of 4 whole samples (the LayerNorm
//   couples a sample's values); all four stages' taps (rows of C_out + 4 floats, so a warp's
//   reads of 32 input channels' rows hit distinct banks) and the out conv's sit in shared
//   memory, staged once a block with cp.async, stages 1-3's landing behind stage 0's
//   recompute; 215 KB a block;
// - each stage's input and conv output keep zero rows past their edges, so every tap reads
//   data and no product is masked;
// - the recompute is K6's bit for bit (the ReLU masks and LayerNorm statistics depend on it):
//   each output one fmaf chain over t, then ci ascending, the bias added last (a tap that reads
//   a zero row adds exactly 0), the statistics with sln_relu's warp-a-sample reduction, the
//   tail in sln_chain.cu's out_stage order; 2 samples x a row pair (which share their input
//   rows at even taps) x 4 channels a thread;
// - the products are register-tiled so that a multiply-add takes few bytes from shared
//   memory, which gives an SM's lanes 128 B a clock: d(taps) and the input gradients in the
//   upsample's phase form (E[m] = gz row 2m, O[m] = row 2m + 1 read input rows m-1, m, m+1
//   through 3 folded taps each, 6 products where the plain form has 10); d(taps) 6 sums x 1
//   input x 1-4 output channels a thread over a split of the tile's row pairs, dx 8 rows x 1
//   channel a thread from the folded taps formed in registers;
// - the LayerNorm backward and the affine and bias gradients on all 16 warps (4 a sample);
//   per-channel gradients summed a tile at a time into shared memory in a fixed order, stage
//   0's d(taps) too, stages 1-3's kept in registers over the block's tiles;
// - a block writes one partial row, coalesced (125 at batch 500: 125 tiles on 132 SMs; was
//   250), summed in a fixed order by a second kernel: bit-reproducible, no atomics. Full fp32
//   FMAs, no TF32.
#include "async_smem.cuh"
#include "sln_stage.cuh"
#include "sln_tail.cuh"

namespace {

using namespace iins;

constexpr int kStages = 4;
constexpr int kKOut = 7, kPadOut = 3;  // out-conv taps, reflect pad
constexpr int kMaxFloats = 2048;       // floats a sample, per stage

struct ChainArgs {
  const float* w[kStages];      // (5, C_in, C_in / 2)
  const float* bias[kStages];   // (C_in / 2,)
  const float* gamma[kStages];  // (C_in / 2,)
  const float* beta[kStages];   // (C_in / 2,)
  int l_in[kStages], c_in[kStages];  // stage j: (l_in, c_in) -> (2 l_in, c_in / 2)
  int off[kStages];  // offset of stage j's (taps, bias, gamma, beta) gradients in a partial row
  const float* w_out;  // (7, C_last, 1)
  const float* b_out;  // (1,)
  int off_out;         // offset of the out conv's (taps, bias) gradients
  int n_part;          // floats in a partial row
  int l_pool;
  int width;   // floats a sample in each activation buffer (L0 * C0)
  int th_len;  // L_last rounded up to 4
};

__device__ __forceinline__ int reflect(int u, int l) {
  return u < 0 ? -u : (u >= l ? 2 * l - 2 - u : u);
}

__global__ void __launch_bounds__(kThreads)
sln_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ part, int batch, int spb,
                     ChainArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int wd = a.width;
  // act[j]: stage j's input (j = 0: x; j = 4: the out conv's input);
  // z[j]: stage j's conv output; each (spb, width)
  float* act[kStages + 1];
  float* z[kStages];
  for (int j = 0; j <= kStages; ++j) act[j] = smem + j * spb * wd;
  for (int j = 0; j < kStages; ++j) z[j] = smem + (kStages + 1 + j) * spb * wd;
  float* th = smem + (2 * kStages + 1) * spb * wd;  // (spb, th_len)
  float* stats = th + spb * a.th_len;               // (kStages, spb, 3)
  float* mine = part + static_cast<size_t>(blockIdx.x) * a.n_part;

  const int n0 = a.l_in[0] * a.c_in[0];
  const float* xg = x + static_cast<size_t>(s0) * n0;
  for (int i = threadIdx.x; i < ns * n0; i += blockDim.x) {
    const int s = i / n0;
    act[0][s * wd + (i - s * n0)] = xg[i];
  }
  __syncthreads();
  for (int j = 0; j < kStages; ++j) {
    const int c_out = a.c_in[j] / 2;
    up_conv_stage<true>(act[j], z[j], a.w[j], a.bias[j], a.l_in[j], a.c_in[j], c_out, ns, wd);
    __syncthreads();
    sln_relu(z[j], act[j + 1], stats + 3 * j * spb, a.gamma[j], a.beta[j],
             2 * a.l_in[j] * c_out, c_out, ns, wd);
    __syncthreads();
  }
  const int l = 2 * a.l_in[kStages - 1], c = a.c_in[kStages - 1] / 2;
  const float b_out = __ldg(a.b_out);
  // th = tanh(conv_k7_reflect(act[4]) + b), sln_chain.cu's out_stage arithmetic
  for (int o = threadIdx.x; o < ns * l; o += blockDim.x) {
    const int s = o / l, p = o - s * l;
    const float* xs = act[kStages] + s * wd;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kKOut; ++t) {
      const float* xr = xs + reflect(p + t - kPadOut, l) * c;
      for (int ci = 0; ci < c; ++ci) acc = fmaf(xr[ci], __ldg(a.w_out + t * c + ci), acc);
    }
    th[s * a.th_len + p] = tanhf(acc + b_out);
  }
  __syncthreads();

  // th <- gz of the out conv: the pool's transpose, then tanh's derivative
  const float* gg = g + static_cast<size_t>(s0) * a.l_pool;
  for (int o = threadIdx.x; o < ns * l; o += blockDim.x) {
    const int s = o / l, u = o - s * l;
    float gth = 0.f;
    for (int i = (u * a.l_pool) / l; i <= ((u + 1) * a.l_pool - 1) / l && i < a.l_pool; ++i) {
      const int start = (i * l) / a.l_pool, end = ((i + 1) * l + a.l_pool - 1) / a.l_pool;
      if (start <= u && u < end) gth += gg[s * a.l_pool + i] / static_cast<float>(end - start);
    }
    const float t = th[s * a.th_len + u];
    th[s * a.th_len + u] = gth * (1.f - t * t);
  }
  __syncthreads();
  // the out conv's d(taps) (7, c) and dbias
  for (int o = threadIdx.x; o <= kKOut * c; o += blockDim.x) {
    float acc = 0.f;
    if (o < kKOut * c) {
      const int t = o / c, ci = o - t * c;
      for (int s = 0; s < ns; ++s)
        for (int p = 0; p < l; ++p)
          acc = fmaf(act[kStages][s * wd + reflect(p + t - kPadOut, l) * c + ci],
                     th[s * a.th_len + p], acc);
    } else {
      for (int s = 0; s < ns; ++s)
        for (int p = 0; p < l; ++p) acc += th[s * a.th_len + p];
    }
    mine[a.off_out + o] = acc;
  }
  __syncthreads();
  // act[4] <- its gradient: row u is read through the virtual rows u, -u
  // and 2L - 2 - u by output p = v + 3 - t
  for (int o = threadIdx.x; o < ns * l * c; o += blockDim.x) {
    const int s = o / (l * c), r = o - s * l * c;
    const int u = r / c, ci = r - u * c;
    const int vs[3] = {u, -u, 2 * l - 2 - u};
    float acc = 0.f;
    for (int q = 0; q < 3; ++q) {
      if ((q == 1 && u < 1) || (q == 2 && u > l - 2)) continue;
      for (int t = 0; t < kKOut; ++t) {
        const int p = vs[q] + kPadOut - t;
        if (p >= 0 && p < l)
          acc = fmaf(th[s * a.th_len + p], __ldg(a.w_out + t * c + ci), acc);
      }
    }
    act[kStages][s * wd + r] = acc;
  }
  __syncthreads();

  for (int j = kStages - 1; j >= 0; --j) {
    const int c_out = a.c_in[j] / 2, n = 2 * a.l_in[j] * c_out;
    const float* st = stats + 3 * j * spb;
    float* pj = mine + a.off[j];
    const int n_taps = kUpK * a.c_in[j] * c_out;
    affine_grad_partial(z[j], act[j + 1], st, a.gamma[j], a.beta[j], n, c_out, ns, wd,
                        pj + n_taps + c_out);
    __syncthreads();
    sln_backward(z[j], act[j + 1], st, a.gamma[j], a.beta[j], n, c_out, ns, wd);
    __syncthreads();
    up_conv_grad_partial<true>(act[j], z[j], a.l_in[j], a.c_in[j], c_out, true, ns, wd, pj);
    __syncthreads();
    if (j > 0) {
      up_conv_input_grad<true>(z[j], a.w[j], a.l_in[j], a.c_in[j], c_out, ns, wd, act[j], wd);
      __syncthreads();
    } else if (dx) {
      up_conv_input_grad<true>(z[0], a.w[0], a.l_in[0], a.c_in[0], c_out, ns, wd,
                               dx + static_cast<size_t>(s0) * n0, n0);
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The decoder's own path: input (8, 64), four up-stages to (128, 4), the k7 reflect conv,
// tanh and any pool length, the only shape Decoder1d gives K6. Its forward recompute, layout
// and staging are sln_tail.cuh's, shared with K6's tail kernel; K6b's shared memory goes on
// after the forward's (the taps, the tile's buffers and the statistics), in floats.
namespace tail {

constexpr int kGzoStride = kLast + 4;
constexpr int kGzo = kFwdFloats;                    // the out conv's gz, (S, 128)
constexpr int kActs = kGzo + kS * kGzoStride - act_off(0);  // the tile's buffers
constexpr int kRed = kGzo + kS * kGzoStride;        // per warp: dbias, dgamma, dbeta of 32 channels
constexpr int kRed2 = kRed + kWarps * 3 * 32;       // per warp: the LayerNorm backward's three sums
constexpr int kSmall = kRed2 + kWarps * 4;          // the block's dbias, dgamma, dbeta a stage
constexpr int kSmallOut = kSmall + kStages * 3 * 32;  // the out conv's d(taps) and dbias (29)
constexpr int kScr = kSmallOut + 32;                // the out conv's per-thread partials
constexpr int kOutParts = 29;
constexpr int kRedOut = kScr + 128 * kOutParts;     // the out conv's per-sample sums (4 x 29)
constexpr int kDw0 = kRedOut + 128;                 // the block's d(taps) of stage 0, (5, 64, 32)
constexpr int kFloats = kDw0 + kUpK * kC0 * kC0 / 2;
constexpr int kSmemBytes = kFloats * static_cast<int>(sizeof(float));
static_assert(kSmemBytes <= 232448, "over the 227 KB a block can have");
static_assert(kS * kOutParts <= 128, "the per-sample sums fit their region");
// threads of the input gradients: kDxRows rows x 1 channel a thread
constexpr int kDxRows = 8;
constexpr int kDxThreads = kS * kN / kDxRows;
static_assert(kDxThreads <= kThreads, "thread layouts");

// A partial row: per stage j, d(taps) (5, C, D), dbias, dgamma, dbeta (D each), then the out
// conv's d(taps) (7, 4) and dbias.
__host__ __device__ constexpr int row_off(int j) {
  return j == 0 ? 0
                : row_off(j - 1) + (kUpK * chans(j - 1) + 3) * (chans(j - 1) / 2);
}
constexpr int kRowFloats = row_off(kStages) + kOutParts;



template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 q = lds4(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = *p;
  }
}



// The out conv and tanh, as sln_chain.cu's out_stage sums them, then the pool's transpose and
// tanh's derivative: gzo[s, p] for thread (s, p).
__device__ void tail_forward(float* sm, const float* __restrict__ g, int s0, int ns, float b_out,
                             int l_pool) {
  const int s = threadIdx.x >> 7, p = threadIdx.x & 127;
  const float th = out_tanh(sm, s, p, b_out);
  float gth = 0.f;
  if (s < ns) {
    const float* gg = g + static_cast<size_t>(s0 + s) * l_pool;
    for (int i = (p * l_pool) / kLast; i <= ((p + 1) * l_pool - 1) / kLast && i < l_pool; ++i) {
      const int start = (i * kLast) / l_pool, end = ((i + 1) * kLast + l_pool - 1) / l_pool;
      if (start <= p && p < end) gth += __ldg(gg + i) / static_cast<float>(end - start);
    }
  }
  sm[kGzo + s * kGzoStride + p] = gth * (1.f - th * th);
}

// The out conv's d(taps) (7, 4) and dbias over the tile, threads 0-127: (sample s, rows 4q ..
// 4q + 3) sums its 29 values in registers into kScr.
__device__ void tail_taps_grad(float* sm) {
  const int s = threadIdx.x >> 5, p0 = (threadIdx.x & 31) * 4;
  const float* xs = sm + act_off(kStages) + s * act_floats(kStages);
  const float4 gv = lds4(sm + kGzo + s * kGzoStride + p0);
  float acc[kOutParts] = {};
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const float gz = lane4(gv, pp);
#pragma unroll
    for (int t = 0; t < kKOut; ++t) {
      const float4 xv = lds4(xs + reflect_out(p0 + pp + t - kPadOut) * 4);
      acc[t * 4] = fmaf(xv.x, gz, acc[t * 4]);
      acc[t * 4 + 1] = fmaf(xv.y, gz, acc[t * 4 + 1]);
      acc[t * 4 + 2] = fmaf(xv.z, gz, acc[t * 4 + 2]);
      acc[t * 4 + 3] = fmaf(xv.w, gz, acc[t * 4 + 3]);
    }
    acc[kOutParts - 1] += gz;
  }
  float* dst = sm + kScr + threadIdx.x * kOutParts;
#pragma unroll
  for (int o = 0; o < kOutParts; ++o) dst[o] = acc[o];
}

// act[4] <- the out conv's input gradient, thread (s, u): row u is read through the virtual rows
// u, -u and 2L - 2 - u by output p = v + 3 - t.
__device__ void tail_input_grad(float* sm) {
  const int s = threadIdx.x >> 7, u = threadIdx.x & 127;
  const float* gz = sm + kGzo + s * kGzoStride;
  const float* w = sm + kTapOut;
  const int vs[3] = {u, -u, 2 * kLast - 2 - u};
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if ((q == 1 && u < 1) || (q == 2 && u > kLast - 2)) continue;
#pragma unroll
    for (int t = 0; t < kKOut; ++t) {
      const int p = vs[q] + kPadOut - t;
      if (p < 0 || p >= kLast) continue;
      const float gv = gz[p];
      a0 = fmaf(gv, w[t * 4], a0);
      a1 = fmaf(gv, w[t * 4 + 1], a1);
      a2 = fmaf(gv, w[t * 4 + 2], a2);
      a3 = fmaf(gv, w[t * 4 + 3], a3);
    }
  }
  *reinterpret_cast<float4*>(sm + act_off(kStages) + s * act_floats(kStages) + u * 4) =
      make_float4(a0, a1, a2, a3);
}

// In place z[j] <- gz from ga (the gradient of act[j + 1], in act[j + 1]'s rows), thread (s, r)
// on the sample's values r + 128 k as in ln_relu: gh = ga where h > 0; the LayerNorm with
// unbiased std and /(std + eps) as sln_stage.cuh's sln_backward: gt = sum gyh * d, gss = gt *
// (-t^2) / (2s), gd = gyh * t + d * 2 gss / (n - 1), gz = gd - mean(gd); the sample's sums over
// its four warps. Samples past the batch get gz = 0. Each warp leaves its channels' sums of gz,
// gh * yh and gh in kRed (lanes 0 .. D - 1).
template <int J>
__device__ void ln_backward(float* sm, const float* __restrict__ gamma,
                            const float* __restrict__ beta, int ns) {
  constexpr int D = chans(J) / 2, P = act_stride(J + 1), H = J + 1 < kStages ? 1 : 0;
  const int s = threadIdx.x >> 7, r = threadIdx.x & 127, c = r % D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* zs = sm + z_off(J) + s * z_floats(J) + 2 * D;
  const float* gs = sm + act_off(J + 1) + s * act_floats(J + 1);
  const float* st = sm + kStats + (J * kS + s) * 4;
  const float mean = st[0], sd = st[1], rs = st[2];
  const float gm = __ldg(gamma + c), bt = __ldg(beta + c);
  float d[4], gyh[4], dg = 0.f, db = 0.f, sg = 0.f, sgt = 0.f, sdd = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = r + 128 * k, l = i / D;
    d[k] = zs[i] - mean;
    const float yh = d[k] * rs;
    const float gh = fmaf(yh, gm, bt) > 0.f ? gs[(l + H) * P + c] : 0.f;
    dg = fmaf(gh, yh, dg);
    db += gh;
    gyh[k] = gh * gm;
    sg += gyh[k];
    sgt = fmaf(gyh[k], d[k], sgt);
    sdd += d[k];
  }
  sg = warp_sum(sg);
  sgt = warp_sum(sgt);
  sdd = warp_sum(sdd);
  float* red2 = sm + kRed2;
  if (lane == 0) {
    red2[warp * 4] = sg;
    red2[warp * 4 + 1] = sgt;
    red2[warp * 4 + 2] = sdd;
  }
  __syncthreads();
  sg = sgt = sdd = 0.f;
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    sg += red2[(4 * s + w) * 4];
    sgt += red2[(4 * s + w) * 4 + 1];
    sdd += red2[(4 * s + w) * 4 + 2];
  }
  const float gss = sgt * -(rs * rs) / (2.f * sd);
  const float coef = 2.f * gss / static_cast<float>(kN - 1);
  const float mean_gd = (rs * sg + coef * sdd) * (1.f / static_cast<float>(kN));
  float dbias = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gz = s < ns ? fmaf(d[k], coef, gyh[k] * rs) - mean_gd : 0.f;
    zs[r + 128 * k] = gz;
    dbias += gz;
  }
#pragma unroll
  for (int off = D; off < 32; off <<= 1) {
    dbias += __shfl_xor_sync(0xffffffffu, dbias, off);
    dg += __shfl_xor_sync(0xffffffffu, dg, off);
    db += __shfl_xor_sync(0xffffffffu, db, off);
  }
  float* red = sm + kRed + warp * 3 * 32;
  if (lane < D) {
    red[lane] = dbias;
    red[32 + lane] = dg;
    red[64 + lane] = db;
  }
}

// The block's dbias, dgamma, dbeta of stage j += the 16 warps' sums, in order.
template <int J>
__device__ void fold_channels(float* sm) {
  constexpr int D = chans(J) / 2;
  if (threadIdx.x >= 3 * D) return;
  const int q = threadIdx.x / D, c = threadIdx.x - q * D;
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += sm[kRed + (w * 3 + q) * 32 + c];
  sm[kSmall + (J * 3 + q) * 32 + c] += v;
}

// Stage j's d(taps) in the upsample's phase form: with E[m] = gz row 2m and O[m] = row 2m + 1,
// pa[0..5] += a[m-1] E, a[m-1] O, a[m] E, a[m] O, a[m+1] E, a[m+1] O over the thread's rows, and
// at the end dW0 = pa0 + pa1, dW1 = pa0 + pa3, dW2 = pa2 + pa3, dW3 = pa2 + pa5, dW4 = pa4 + pa5.
// Thread (split k, input channel ci, NCO output channels); the KS = 512 / cells splits cut the
// tile's (sample, m) pairs into equal runs. The caller keeps pa over the block's tiles
// (stages 1-3) or sums it into shared memory a tile at a time (stage 0).
template <int J, int NCO>
struct TapsGrad {
  static constexpr int L = rows_in(J), C = chans(J), D = C / 2, H = D / NCO, CELLS = C * H;
  static constexpr int KS = kThreads / CELLS, PPS = kS * L / KS, MB = PPS < L ? PPS : L;
  static_assert(KS * CELLS == kThreads && KS * PPS == kS * L && PPS % MB == 0, "splits");
};

template <int J, int NCO>
__device__ __forceinline__ void taps_grad(const float* sm, float (&pa)[6][NCO]) {
  using T = TapsGrad<J, NCO>;
  constexpr int L = T::L, D = T::D, P = act_stride(J);
  const int k = threadIdx.x / T::CELLS, cell = threadIdx.x - k * T::CELLS;
  const int ci = cell / T::H, co = (cell - ci * T::H) * NCO;
#pragma unroll 1
  for (int idx = k * T::PPS; idx < (k + 1) * T::PPS; idx += T::MB) {
    const int s = idx / L, m0 = idx - s * L;
    const float* as = sm + act_off(J) + s * act_floats(J) + ci;  // row m at as[(m + 1) * P]
    const float* zs = sm + z_off(J) + s * z_floats(J) + co;     // row l at zs[(l + 2) * D]
    float am = as[m0 * P], a0 = as[(m0 + 1) * P];
#pragma unroll
    for (int mm = 0; mm < T::MB; ++mm) {
      const int m = m0 + mm;
      const float ap = as[(m + 2) * P];
      float e[NCO], o[NCO];
      load_n(zs + (2 * m + 2) * D, e);
      load_n(zs + (2 * m + 3) * D, o);
#pragma unroll
      for (int n = 0; n < NCO; ++n) {
        pa[0][n] = fmaf(am, e[n], pa[0][n]);
        pa[1][n] = fmaf(am, o[n], pa[1][n]);
        pa[2][n] = fmaf(a0, e[n], pa[2][n]);
        pa[3][n] = fmaf(a0, o[n], pa[3][n]);
        pa[4][n] = fmaf(ap, e[n], pa[4][n]);
        pa[5][n] = fmaf(ap, o[n], pa[5][n]);
      }
      am = a0;
      a0 = ap;
    }
  }
}

// d(taps) of tap t at output channel n from the phase-form sums.
template <int NCO>
__device__ __forceinline__ float dtap(const float (&pa)[6][NCO], int t, int n) {
  constexpr int a[5] = {0, 0, 2, 2, 4}, b[5] = {1, 3, 3, 5, 5};
  return pa[a[t]][n] + pa[b[t]][n];
}

// Stage j's input gradient in the upsample's phase form: input row m gets E[m-1] w4 + O[m-1]
// (w3 + w4) + E[m] (w2 + w3) + O[m] (w1 + w2) + E[m+1] (w0 + w1) + O[m+1] w0, the folded taps
// formed in registers from the staged ones. Threads 0 .. kDxThreads - 1: (row block, sample,
// input channel), kDxRows rows a thread, 4 output channels a step. j > 0: into act[j]'s inner
// rows (the gradient of stage j - 1's output); j = 0: dx, where given.
template <int J>
__device__ void input_grad(float* sm, float* __restrict__ dx, int s0, int ns) {
  constexpr int L = rows_in(J), C = chans(J), D = C / 2, TS = tap_stride(J), R = kDxRows;
  const int ci = threadIdx.x % C, s = (threadIdx.x / C) % kS, m0 = threadIdx.x / (C * kS) * R;
  const float* wc = sm + tap_off(J) + ci * TS;
  const float* zs = sm + z_off(J) + s * z_floats(J);
  float acc[R] = {};
#pragma unroll 1
  for (int co = 0; co < D; co += 4) {
    float4 w[kUpK];
#pragma unroll
    for (int t = 0; t < kUpK; ++t) w[t] = lds4(wc + t * C * TS + co);
    const float4 f[6] = {
        w[4],
        make_float4(w[3].x + w[4].x, w[3].y + w[4].y, w[3].z + w[4].z, w[3].w + w[4].w),
        make_float4(w[2].x + w[3].x, w[2].y + w[3].y, w[2].z + w[3].z, w[2].w + w[3].w),
        make_float4(w[1].x + w[2].x, w[1].y + w[2].y, w[1].z + w[2].z, w[1].w + w[2].w),
        make_float4(w[0].x + w[1].x, w[0].y + w[1].y, w[0].z + w[1].z, w[0].w + w[1].w),
        w[0]};
#pragma unroll
    for (int k = -1; k <= R; ++k) {  // E and O of m = m0 + k (the zero rows past the edges)
      const float4 e = lds4(zs + (2 * (m0 + k) + 2) * D + co);
      const float4 o = lds4(zs + (2 * (m0 + k) + 3) * D + co);
#pragma unroll
      for (int h = 0; h < 3; ++h) {  // row m0 + k + 1 - h gets E f[2h] + O f[2h + 1]
        const int u = k + 1 - h;
        if (u < 0 || u >= R) continue;
        float v = acc[u];
        v = fmaf(e.x, f[2 * h].x, v);
        v = fmaf(e.y, f[2 * h].y, v);
        v = fmaf(e.z, f[2 * h].z, v);
        v = fmaf(e.w, f[2 * h].w, v);
        v = fmaf(o.x, f[2 * h + 1].x, v);
        v = fmaf(o.y, f[2 * h + 1].y, v);
        v = fmaf(o.z, f[2 * h + 1].z, v);
        v = fmaf(o.w, f[2 * h + 1].w, v);
        acc[u] = v;
      }
    }
  }
  if constexpr (J > 0) {
    float* out = sm + act_off(J) + s * act_floats(J) + ci;
#pragma unroll
    for (int u = 0; u < R; ++u) out[(m0 + u + 1) * act_stride(J)] = acc[u];
  } else {
    if (dx && s < ns) {
      float* out = dx + (static_cast<size_t>(s0 + s) * L + m0) * C + ci;
#pragma unroll
      for (int u = 0; u < R; ++u) out[u * C] = acc[u];
    }
  }
}


// Stage j's d(taps) of the whole block (j = 1..3) into its partial row: the splits' sums
// through the tile buffers (free at the end) at scratch, each entry summed over the splits in
// order.
template <int J, int NCO>
__device__ __forceinline__ void put_taps(const float (&pa)[6][NCO], float* scratch) {
  using T = TapsGrad<J, NCO>;
  constexpr int C = T::C, D = T::D;
  const int k = threadIdx.x / T::CELLS, cell = threadIdx.x - k * T::CELLS;
  const int ci = cell / T::H, co = (cell - ci * T::H) * NCO;
#pragma unroll
  for (int t = 0; t < kUpK; ++t)
#pragma unroll
    for (int n = 0; n < NCO; ++n)
      scratch[k * kUpK * C * D + (t * C + ci) * D + co + n] = dtap(pa, t, n);
}

template <int J, int NCO>
__device__ __forceinline__ void sum_taps(const float* scratch, float* __restrict__ row) {
  using T = TapsGrad<J, NCO>;
  constexpr int n = kUpK * T::C * T::D;
  for (int o = threadIdx.x; o < n; o += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < T::KS; ++k) v += scratch[k * n + o];
    row[row_off(J) + o] = v;
  }
}

// One persistent block a SM walks tiles of kS samples (tile b, b + grid, ...). Per tile, from x
// staged beside all four stages' taps:
//   forward, j = 0..3: z[j] = conv(up(act[j])) + bias, its statistics, act[j+1] = relu(...)
//   tail: the out conv and tanh, the pool's transpose and tanh', the out conv's d(taps),
//         dbias and input gradient (into act[4])
//   backward, j = 3..0: gz[j] (in place of z[j]), dbias, dgamma, dbeta; d(taps); the input
//         gradient (into act[j], or dx)
// Per-channel gradients are summed a tile at a time into kSmall in a fixed order; d(taps) stay
// in registers over the block's tiles (stage 0's in kDw0). The block writes one partial row.
__global__ void __launch_bounds__(kThreads, 1)
tail_bwd_kernel(const float* __restrict__ x, const float* __restrict__ g, float* __restrict__ dx,
                float* __restrict__ part, int batch, int n_tiles, Args a) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < kStages * 3 * 32 + 32; i += kThreads) sm[kSmall + i] = 0.f;
  int tile = blockIdx.x;
  stage_block(sm, a, x, tile, batch);
  const float b_out = __ldg(a.b_out);
  float pa1[6][2] = {}, pa2[6][2] = {}, pa3[6][1] = {};
  for (bool first = true; tile < n_tiles; tile += gridDim.x, first = false) {
    const int s0 = tile * kS, ns = min(kS, batch - s0);
    if (!first) {
      __syncthreads();  // the last tile's reads of act[0] are done
      stage_x(x, s0, ns, sm);
      cp_async_wait_all();
    }
    __syncthreads();
    forward_stage<0>(sm, a.bias[0], a.gamma[0], a.beta[0]);
    if (first) {
      cp_async_wait<0>();
      __syncthreads();
    }
    forward_stage<1>(sm, a.bias[1], a.gamma[1], a.beta[1]);
    forward_stage<2>(sm, a.bias[2], a.gamma[2], a.beta[2]);
    forward_stage<3>(sm, a.bias[3], a.gamma[3], a.beta[3]);
    tail_forward(sm, g, s0, ns, b_out, a.l_pool);
    __syncthreads();
    if (threadIdx.x < 128) tail_taps_grad(sm);
    __syncthreads();
    tail_input_grad(sm);
    if (threadIdx.x < kS * kOutParts) {  // per sample: the sum of its 32 threads' partials
      const int s = threadIdx.x / kOutParts, o = threadIdx.x - s * kOutParts;
      float v = 0.f;
      for (int q = 0; q < 32; ++q) v += sm[kScr + (s * 32 + q) * kOutParts + o];
      sm[kRedOut + threadIdx.x] = v;
    }
    __syncthreads();
    if (threadIdx.x < kOutParts) {
      float v = sm[kSmallOut + threadIdx.x];
#pragma unroll
      for (int s = 0; s < kS; ++s) v += sm[kRedOut + s * kOutParts + threadIdx.x];
      sm[kSmallOut + threadIdx.x] = v;
    }
    // backward, j = 3..0; input_grad<j> overwrites act[j], which taps_grad<j> reads (but dx
    // at j = 0)
    ln_backward<3>(sm, a.gamma[3], a.beta[3], ns);
    __syncthreads();
    fold_channels<3>(sm);
    taps_grad<3, 1>(sm, pa3);
    __syncthreads();
    if (threadIdx.x < kDxThreads) input_grad<3>(sm, dx, s0, ns);
    __syncthreads();
    ln_backward<2>(sm, a.gamma[2], a.beta[2], ns);
    __syncthreads();
    fold_channels<2>(sm);
    taps_grad<2, 2>(sm, pa2);
    __syncthreads();
    if (threadIdx.x < kDxThreads) input_grad<2>(sm, dx, s0, ns);
    __syncthreads();
    ln_backward<1>(sm, a.gamma[1], a.beta[1], ns);
    __syncthreads();
    fold_channels<1>(sm);
    taps_grad<1, 2>(sm, pa1);
    __syncthreads();
    if (threadIdx.x < kDxThreads) input_grad<1>(sm, dx, s0, ns);
    __syncthreads();
    ln_backward<0>(sm, a.gamma[0], a.beta[0], ns);
    __syncthreads();
    fold_channels<0>(sm);
    {  // stage 0's d(taps) (no splits: a thread owns its entries) into kDw0, a tile at a time
      float pa0[6][4] = {};
      taps_grad<0, 4>(sm, pa0);
      float* dw = sm + kDw0 + (threadIdx.x >> 3) * (kC0 / 2) + (threadIdx.x & 7) * 4;
#pragma unroll
      for (int t = 0; t < kUpK; ++t) {
        float4 v = first ? make_float4(0.f, 0.f, 0.f, 0.f) : lds4(dw + t * kC0 * kC0 / 2);
        v.x += dtap(pa0, t, 0);
        v.y += dtap(pa0, t, 1);
        v.z += dtap(pa0, t, 2);
        v.w += dtap(pa0, t, 3);
        *reinterpret_cast<float4*>(dw + t * kC0 * kC0 / 2) = v;
      }
    }
    if (threadIdx.x < kDxThreads) input_grad<0>(sm, dx, s0, ns);
  }

  // the block's partial row (13,809 floats: rows are not 16-byte aligned), a float a thread,
  // coalesced: stage 0's d(taps) from kDw0, the other stages' through the tile buffers (their
  // splits' sums), the per-channel gradients from kSmall
  __syncthreads();
  float* row = part + static_cast<size_t>(blockIdx.x) * kRowFloats;
  float* scratch = sm + act_off(0);
  constexpr int n1 = TapsGrad<1, 2>::KS * kUpK * chans(1) * chans(1) / 2;
  constexpr int n2 = TapsGrad<2, 2>::KS * kUpK * chans(2) * chans(2) / 2;
  constexpr int n3 = TapsGrad<3, 1>::KS * kUpK * chans(3) * chans(3) / 2;
  static_assert(n1 + n2 + n3 <= kActs, "the tile buffers hold the splits' sums");
  put_taps<1, 2>(pa1, scratch);
  put_taps<2, 2>(pa2, scratch + n1);
  put_taps<3, 1>(pa3, scratch + n1 + n2);
  __syncthreads();
  for (int i = threadIdx.x; i < kUpK * kC0 * kC0 / 2; i += kThreads) row[i] = sm[kDw0 + i];
  sum_taps<1, 2>(scratch, row);
  sum_taps<2, 2>(scratch + n1, row);
  sum_taps<3, 1>(scratch + n1 + n2, row);
  for (int i = threadIdx.x; i < kStages * 3 * 32; i += kThreads) {
    const int j = i / 96, q = (i / 32) % 3, c = i % 32, d = chans(j) / 2;
    if (c < d) row[row_off(j) + kUpK * chans(j) * d + q * d + c] = sm[kSmall + i];
  }
  if (threadIdx.x < kOutParts) row[row_off(kStages) + threadIdx.x] = sm[kSmallOut + threadIdx.x];
}

int smem_set = 0;

int launch(const float* x, const float* g, float* dx, float* part, float* dw, int batch,
           const Args& a, int tile, int grid, int smem, void* stream) {
  const int n_tiles = batch > 0 ? (batch + kS - 1) / kS : 0;
  if (batch <= 0 || tile != kS || grid < 1 || grid > n_tiles || smem != kSmemBytes)
    return cudaErrorInvalidValue;
  if (!iins::aligned16(x)) return cudaErrorInvalidValue;
  for (int j = 0; j < kStages; ++j)
    if (!iins::aligned16(a.w[j])) return cudaErrorInvalidValue;
  int err = allow_smem(tail_bwd_kernel, smem, &smem_set);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  tail_bwd_kernel<<<grid, kThreads, smem, s>>>(x, g, dx, part, batch, n_tiles, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return iins::launch_reduce_rows(part, grid, kRowFloats, dw, s);
}

}  // namespace tail

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x (B, l0, c0), g (B, l_pool), dx (B, l0, c0) or null. ws, biases, gammas,
// betas: kStages device pointers each (host arrays); w_out (7, c0 / 16, 1),
// b_out (1,). part: (ceil(B / spb), n) scratch; dw (n): per stage d(taps),
// dbias, dgamma, dbeta, then the out conv's d(taps) and dbias.
int iins_sln_chain_bwd(const float* x, const float* g, float* dx, float* part, float* dw,
                       int batch, const void* const* ws, const void* const* biases,
                       const void* const* gammas, const void* const* betas, int l0, int c0,
                       const float* w_out, const float* b_out, int l_pool, int spb,
                       void* stream) {
  if (batch <= 0 || spb <= 0 || l0 <= 0 || l_pool <= 0) return cudaErrorInvalidValue;
  if (c0 % (4 << kStages) != 0 || l0 * c0 > kMaxFloats) return cudaErrorInvalidValue;
  ChainArgs a{};
  int l = l0, c = c0, off = 0;
  for (int j = 0; j < kStages; ++j) {
    if (!aligned16(ws[j])) return cudaErrorInvalidValue;
    a.w[j] = static_cast<const float*>(ws[j]);
    a.bias[j] = static_cast<const float*>(biases[j]);
    a.gamma[j] = static_cast<const float*>(gammas[j]);
    a.beta[j] = static_cast<const float*>(betas[j]);
    a.l_in[j] = l;
    a.c_in[j] = c;
    a.off[j] = off;
    off += kUpK * c * (c / 2) + 3 * (c / 2);
    l *= 2;
    c /= 2;
  }
  if (l <= kPadOut) return cudaErrorInvalidValue;  // reflect pad 3 needs L > 3
  a.w_out = w_out;
  a.b_out = b_out;
  a.off_out = off;
  a.n_part = off + kKOut * c + 1;
  a.l_pool = l_pool;
  a.width = l0 * c0;
  a.th_len = (l + 3) & ~3;
  const size_t per = (2 * kStages + 1) * static_cast<size_t>(a.width) + a.th_len + 3 * kStages;
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sln_chain_bwd_kernel<<<grid, kThreads, smem, s>>>(x, g, dx, part, batch, spb, a);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, a.n_part, dw, s);
}

// K6b on the decoder's own path (namespace tail): x (B, 8, 64), g (B, l_pool), dx (B, 8, 64) or
// null; ws, biases, gammas, betas, w_out, b_out as for iins_sln_chain_bwd. tile (samples a
// tile), grid (the persistent blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared
// memory) as backward.sln_tail_plan gives them; the launch refuses any other. part (grid, n)
// scratch; dw (n) as for iins_sln_chain_bwd.
int iins_sln_tail_bwd(const float* x, const float* g, float* dx, float* part, float* dw,
                      int batch, const void* const* ws, const void* const* biases,
                      const void* const* gammas, const void* const* betas, int l0, int c0,
                      const float* w_out, const float* b_out, int l_pool, int tile, int grid,
                      int smem, void* stream) {
  if (l0 != tail::kL0 || c0 != tail::kC0 || l_pool <= 0) return cudaErrorInvalidValue;
  tail::Args a{};
  for (int j = 0; j < tail::kStages; ++j) {
    a.w[j] = static_cast<const float*>(ws[j]);
    a.bias[j] = static_cast<const float*>(biases[j]);
    a.gamma[j] = static_cast<const float*>(gammas[j]);
    a.beta[j] = static_cast<const float*>(betas[j]);
  }
  a.w_out = w_out;
  a.b_out = b_out;
  a.l_pool = l_pool;
  return tail::launch(x, g, dx, part, dw, batch, a, tile, grid, smem, stream);
}

}  // extern "C"
