// K1b in_chain_bwd: the backward of K1's 1-2 stage conv -> InstanceNorm ->
// (ReLU | + chain input) chain and, as its kAdain template instances, of
// K5's AdaIN residual block and (K8b) of K8's one AdaIN stage.
//
// Replaces the backward bodies of fused_in_pair (iinsvae_tpu/ops/pallas/
// fused.py:333, kernel _bwd_in_pair_kernel :286), fused_dense_layer(norm=
// 'in') (:1201, _bwd_in_kernel :121), fused_res_block (:225,
// _bwd_resblock_kernel :186) and fused_adain_res_block (:524,
// _bwd_adain_block_kernel :397), and as K8b that of fused_adain_layer
// (:686, _bwd_adain_kernel :591). The Pallas bodies read the saved pre-norm
// activations and return the gradient of the dense, pre-centred conv
// matrix; this kernel saves nothing in the forward (K1 and K5 run
// unchanged) and recomputes the chain from the saved input in shared
// memory, as the forward computed it, then returns the gradient of the
// (k, C_in, C_out) taps directly.
//
// Per stage, backward from the stage output's gradient g:
//   gh  = g where h > 0 (ReLU, fused.py:127) or g (no ReLU; the chain
//         input's skip also adds g to dx, fused.py:204; K8's residual
//         is not a kernel input: its gradient is g, fused.py:712);
//         h = yh [* gamma + beta]
//   kAdain: dgamma[s, c] = sum_l gh * yh, dbeta[s, c] = sum_l gh, the
//         (B, C) tables (the TPU's (B, L*C) tiles summed over L); gyh = gh * gamma
//   gz  = r * (gyh - mean_l(gyh) - yh * mean_l(gyh * yh)), the
//         InstanceNorm backward with the forward's two-pass statistics
//         (fused.py:133-134 gives gd = r*gyh - d*mean(gyh*d)*r^3 for the
//         centred d; the centring's own adjoint adds -mean_l)
//   d(taps) += in^T gz over the block's samples and rows; g_in = conv^T(gz).
//
// A block keeps its tile of samples' input, conv outputs and mid-chain
// activation in shared memory. Its partial sums of d(taps) go to its row
// of a (grid, n) buffer that a second kernel sums in order (deterministic:
// no atomics; at batch 500, 250 blocks x a residual block's 2 x 3*64*64
// taps is 24.6 MB). Input gradients are skipped where the caller needs
// none (the range encoder's first stage reads the pooled CIR).
//
// Bound on the H100 at batch 500: the residual block (K1's and K5's
// largest) recomputes its two convs (2 x 24.6 M multiply-adds) and runs
// dx and d(taps) of each (4 x 24.6 M): 0.29 GFLOP, 4.4 us at 67 TFLOP/s
// fp32, over ~8 MB moved (2.4 us at 3.35 TB/s): bound by operations.
#include "conv_bwd_common.cuh"

namespace {

using namespace iins;

constexpr float kEps = 1e-5f;

// Lanes that share one (sample, channel) row of length l (in_chain.cu's rule).
__device__ __forceinline__ int norm_lanes(int l) {
  int g = 1;
  while (g < 32 && g * 4 < l) g *= 2;
  return g;
}

__device__ __forceinline__ float group_sum(float v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Per-sample (B, C) tables of K5, each offset to the block's first sample
// by the kernel; unused by K1.
struct Affine {
  const float *g1, *b1, *g2;
};
struct AffineGrad {
  float *dg1, *db1, *dg2, *db2;
};

// The (sample, channel) rows of the block, `lanes` threads each, in rounds
// that every lane runs the same number of times (the shuffles need full
// warps). fn(p, s, ch, valid, lane, lanes).
template <typename Fn>
__device__ void for_rows(int l, int c, int ns, Fn fn) {
  const int lanes = norm_lanes(l), lane = threadIdx.x % lanes;
  const int slots = blockDim.x / lanes, pairs = ns * c;
  for (int base = 0; base < pairs; base += slots) {
    const int p = base + static_cast<int>(threadIdx.x) / lanes;
    const bool valid = p < pairs;
    fn(p, valid ? p / c : 0, valid ? p % c : 0, valid, lane, lanes);
  }
}

// mean and 1/sqrt(var + eps) of one (sample, channel) row, two-pass.
__device__ __forceinline__ void row_stats(const float* zs, int l, int c, bool valid, int lane,
                                          int lanes, float& mean, float& rs) {
  const float inv_l = 1.f / static_cast<float>(l);
  float sum = 0.f;
  if (valid)
    for (int i = lane; i < l; i += lanes) sum += zs[i * c];
  mean = group_sum(sum, lanes) * inv_l;
  float sq = 0.f;
  if (valid)
    for (int i = lane; i < l; i += lanes) {
      const float d = zs[i * c] - mean;
      sq = fmaf(d, d, sq);
    }
  rs = rsqrtf(group_sum(sq, lanes) * inv_l + kEps);
}

// y (ns, L, C) = relu(IN(z) [* g + b]), z kept: the forward's mid-chain
// activation, recomputed with in_chain.cu's arithmetic.
template <bool kAdain>
__device__ void norm_relu(const float* z, float* y, int l, int c, int ns, int stride,
                          const float* __restrict__ g, const float* __restrict__ b) {
  for_rows(l, c, ns, [&](int p, int s, int ch, bool valid, int lane, int lanes) {
    const float* zs = z + s * stride + ch;
    float mean, rs;
    row_stats(zs, l, c, valid, lane, lanes, mean, rs);
    if (!valid) return;
    float ga = 1.f, be = 0.f;
    if constexpr (kAdain) {
      ga = __ldg(g + p);
      be = __ldg(b + p);
    }
    float* ys = y + s * stride + ch;
    for (int i = lane; i < l; i += lanes) {
      float v = (zs[i * c] - mean) * rs;
      if constexpr (kAdain) v = fmaf(v, ga, be);
      ys[i * c] = fmaxf(v, 0.f);
    }
  });
}

// In place over z (the stage's raw conv output, ns samples `stride` floats
// apart): z <- gz, from the stage output's gradient gsrc (same layout,
// `g_stride` apart). relu: mask by h > 0; else the skip's identity.
template <bool kAdain>
__device__ void norm_backward(float* z, const float* gsrc, int g_stride, bool relu, int l,
                              int c, int ns, int stride, const float* __restrict__ gam,
                              const float* __restrict__ bet, float* dgam, float* dbet) {
  const float inv_l = 1.f / static_cast<float>(l);
  for_rows(l, c, ns, [&](int p, int s, int ch, bool valid, int lane, int lanes) {
    float* zs = z + s * stride + ch;
    const float* gs = gsrc + s * g_stride + ch;
    float mean, rs;
    row_stats(zs, l, c, valid, lane, lanes, mean, rs);
    float ga = 1.f, be = 0.f;
    if (kAdain && valid) {
      ga = __ldg(gam + p);
      be = bet ? __ldg(bet + p) : 0.f;  // the skip stage needs no beta: it has no mask
    }
    // gh and gyh = gh * ga at element i
    auto grad_at = [&](int i, float& yh, float& gh) {
      yh = (zs[i * c] - mean) * rs;
      const float h = kAdain ? fmaf(yh, ga, be) : yh;
      gh = (!relu || h > 0.f) ? gs[i * c] : 0.f;
    };
    float sgh = 0.f, sghy = 0.f;
    if (valid)
      for (int i = lane; i < l; i += lanes) {
        float yh, gh;
        grad_at(i, yh, gh);
        sgh += gh;
        sghy = fmaf(gh, yh, sghy);
      }
    sgh = group_sum(sgh, lanes);
    sghy = group_sum(sghy, lanes);
    if (!valid) return;
    if constexpr (kAdain) {
      if (lane == 0) {
        dgam[p] = sghy;
        dbet[p] = sgh;
      }
    }
    // mean(gyh) and mean(gyh * yh), gyh = gh * ga
    const float mg = sgh * ga * inv_l, mgy = sghy * ga * inv_l;
    for (int i = lane; i < l; i += lanes) {
      float yh, gh;
      grad_at(i, yh, gh);
      zs[i * c] = rs * (gh * ga - mg - yh * mgy);
    }
  });
}

// Shared memory per sample: a0 input (n0), z1 (n1); two stages add y1
// (n1) and z2 (n2). n0 is rounded up to 4 floats so every row stays
// 16-byte aligned.
template <bool kAdain>
__global__ void __launch_bounds__(kThreads)
in_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                    const float* __restrict__ w2, const float* __restrict__ g,
                    float* __restrict__ dx, float* __restrict__ part, int batch, Stage s1,
                    Stage s2, int n_stages, int residual, int relu_last, int spb, Affine af,
                    AffineGrad ag) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const bool two = n_stages == 2;
  const int x_len = s1.l_in * s1.c_in, n0 = (x_len + 3) & ~3;
  const int n1 = s1.l_out * s1.c_out, n2 = two ? s2.l_out * s2.c_out : 0;
  const int n_last = two ? n2 : n1;
  float* a0 = smem;
  float* z1 = a0 + spb * n0;
  float* y1 = z1 + spb * n1;
  float* z2 = y1 + (two ? spb * n1 : 0);
  if constexpr (kAdain) {
    af.g1 += s0 * s1.c_out;
    af.b1 += s0 * s1.c_out;
    af.g2 += s0 * s2.c_out;
    ag.dg1 += s0 * s1.c_out;
    ag.db1 += s0 * s1.c_out;
    ag.dg2 += s0 * s2.c_out;
    ag.db2 += s0 * s2.c_out;
  }
  const int n_w1 = s1.k * s1.c_in * s1.c_out;
  float* mine = part + static_cast<size_t>(blockIdx.x) *
                           (n_w1 + (two ? s2.k * s2.c_in * s2.c_out : 0));
  const float* gg = g + static_cast<size_t>(s0) * n_last;

  const float* xg = x + static_cast<size_t>(s0) * x_len;
  for (int i = threadIdx.x; i < ns * x_len; i += blockDim.x) {
    const int s = i / x_len;
    a0[s * n0 + (i - s * x_len)] = xg[i];
  }
  __syncthreads();
  conv_stage4(a0, n0, w1, z1, n1, s1, ns);
  __syncthreads();

  if (two) {
    norm_relu<kAdain>(z1, y1, s1.l_out, s1.c_out, ns, n1, af.g1, af.b1);
    __syncthreads();
    conv_stage4(y1, n1, w2, z2, n2, s2, ns);
    __syncthreads();
    norm_backward<kAdain>(z2, gg, n2, relu_last, s2.l_out, s2.c_out, ns, n2, af.g2, nullptr,
                          ag.dg2, ag.db2);
    __syncthreads();
    taps_grad_partial(y1, n1, z2, n2, s2, ns, mine + n_w1);
    __syncthreads();  // y1 is read; it now takes the stage input's gradient
    conv_input_grad<4>(z2, n2, w2, s2, ns, y1, n1, nullptr, 0);
    __syncthreads();
    norm_backward<kAdain>(z1, y1, n1, true, s1.l_out, s1.c_out, ns, n1, af.g1, af.b1, ag.dg1,
                          ag.db1);
  } else {
    norm_backward<kAdain>(z1, gg, n1, relu_last, s1.l_out, s1.c_out, ns, n1, af.g1, af.b1,
                          ag.dg1, ag.db1);
  }
  __syncthreads();
  taps_grad_partial(a0, n0, z1, n1, s1, ns, mine);
  if (dx)
    conv_input_grad<4>(z1, n1, w1, s1, ns, dx + static_cast<size_t>(s0) * x_len, x_len,
                       residual ? gg : nullptr, n_last);
}

// Validate a 1-2 stage chain and launch the backward and the reduction.
template <bool kAdain>
int launch_chain_bwd(const float* x, const float* w1, const float* w2, const float* g,
                     float* dx, float* part, float* dw, int batch, const int* stages,
                     int n_stages, int residual, int relu_last, int spb, Affine af,
                     AffineGrad ag, void* stream) {
  if (batch <= 0 || spb <= 0 || n_stages < 1 || n_stages > 2) return cudaErrorInvalidValue;
  const Stage s1 = make_stage(stages);
  const Stage s2 = n_stages == 2 ? make_stage(stages + 8) : Stage{};
  if (!stage_ok(s1) || s1.c_out % 4 || !aligned16(w1)) return cudaErrorInvalidValue;
  if (n_stages == 2 && (!stage_ok(s2) || s2.c_out % 4 || !aligned16(w2) ||
                        s2.l_in != s1.l_out || s2.c_in != s1.c_out))
    return cudaErrorInvalidValue;
  if (residual && (n_stages != 2 || s2.l_out != s1.l_in || s2.c_out != s1.c_in))
    return cudaErrorInvalidValue;
  const size_t n1 = static_cast<size_t>(s1.l_out) * s1.c_out;
  const size_t per = ((s1.l_in * s1.c_in + 3) & ~3) + n1 +
                     (n_stages == 2 ? n1 + static_cast<size_t>(s2.l_out) * s2.c_out : 0);
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  in_chain_bwd_kernel<kAdain><<<grid, kThreads, smem, s>>>(
      x, w1, w2, g, dx, part, batch, s1, s2, n_stages, residual, relu_last, spb, af, ag);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int n_w = s1.k * s1.c_in * s1.c_out + (n_stages == 2 ? s2.k * s2.c_in * s2.c_out : 0);
  return launch_reduce(part, grid, n_w, dw, s);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// stages: n_stages rows of (k, stride, pad, reflect, l_in, c_in, l_out,
// c_out); g the chain output's gradient; dx or null; part (ceil(B / spb),
// n_w) scratch; dw (n_w): d(taps1) then d(taps2).
int iins_in_chain_bwd(const float* x, const float* w1, const float* w2, const float* g,
                      float* dx, float* part, float* dw, int batch, const int* stages,
                      int n_stages, int residual, int spb, void* stream) {
  return launch_chain_bwd<false>(x, w1, w2, g, dx, part, dw, batch, stages, n_stages, residual,
                                 !residual, spb, Affine{}, AffineGrad{}, stream);
}

// K5's backward: x, g, dx (B, L, C); w1, w2 (3, C, C), reflect pad 1;
// g1, b1, g2 (B, C) the forward's tables; dg1, db1, dg2, db2 (B, C) out.
int iins_adain_res_block_bwd(const float* x, const float* w1, const float* w2,
                             const float* g1, const float* b1, const float* g2, const float* g,
                             float* dx, float* part, float* dw, float* dg1, float* db1,
                             float* dg2, float* db2, int batch, int l, int c, int spb,
                             void* stream) {
  const int stages[16] = {3, 1, 1, 1, l, c, l, c, 3, 1, 1, 1, l, c, l, c};
  if (!g1 || !b1 || !g2 || !dg1 || !db1 || !dg2 || !db2) return cudaErrorInvalidValue;
  return launch_chain_bwd<true>(x, w1, w2, g, dx, part, dw, batch, stages, 2, 1, 0, spb,
                                Affine{g1, b1, g2}, AffineGrad{dg1, db1, dg2, db2}, stream);
}

// K8b, K8's backward: x (B, l_in, c_in); stage (k, stride, pad, reflect,
// l_in, c_in, l, c); w (k, c_in, c); gam, bet (B, c) the forward's tables;
// relu as K8 took it; g (B, l, c); dx or null; part (ceil(B / spb),
// k*c_in*c) scratch; dw (k, c_in, c); dgam, dbet (B, c) out.
int iins_adain_layer_bwd(const float* x, const float* w, const float* gam, const float* bet,
                         const float* g, float* dx, float* part, float* dw, float* dgam,
                         float* dbet, int batch, const int* stage, int relu, int spb,
                         void* stream) {
  if (!gam || !bet || !dgam || !dbet) return cudaErrorInvalidValue;
  return launch_chain_bwd<true>(x, w, w, g, dx, part, dw, batch, stage, 1, 0, relu != 0, spb,
                                Affine{gam, bet, nullptr},
                                AffineGrad{dgam, dbet, nullptr, nullptr}, stream);
}

}  // extern "C"
