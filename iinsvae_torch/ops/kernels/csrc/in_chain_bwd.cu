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
// matrix; this kernel saves nothing in the forward (K1 and K5 save only
// their input) and recomputes the chain from the saved input in shared
// memory, as the forward computed it, then returns the gradient of the
// (k, C_in, C_out) taps directly. At the residual block the recompute and
// K1's and K5's forward kernel share res_block.cuh's staging, conv and norm
// statistics.
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
// Three paths. The residual block at the model's shape, (L, C) = (8, 64) with
// both convs k3, stride 1, reflect pad 1 (K1's three range-encoder blocks and
// K5's three decoder blocks: 6 of a 1-D training step's 9 K1b/K5b launches),
// runs its own kernel (namespace res below). The range encoder's three
// stride-2 chains at the flagship's shapes (fused_in_pair's two sites, :333 /
// _bwd_in_pair_kernel :286, and fused_dense_layer(norm='in')'s stage 5, :1201 /
// _bwd_in_kernel :121: the step's other 3 launches) run theirs (namespace down).
// Every other chain (K8b's one AdaIN stage, other widths or depths, range.pair0
// where dx is asked for) runs the general kernel.
//
// Bound on the H100 at batch 500: the residual block recomputes its two convs
// and runs dx and d(taps) of each, six products of 500 * 8 * 64 outputs x 192
// multiply-adds (49.2 M each): 0.59 GFLOP, 8.8 us at 67 TFLOP/s fp32, over
// 3.3-3.6 MB moved (x, g, dx, taps, K5's tables; 1.1 us at 3.35 TB/s): bound
// by operations.
//
// Bound of the range chains on the H100 at batch 500 (the forward recomputed,
// d(taps) and dx where the step needs it, over the taps that read data): 31.7,
// 143 and 184 MFLOP at range.pair0, pair1 and single, 0.47, 2.14 and 2.75 us at
// 67 TFLOP/s fp32, over 1.3-2.6 MB (x, g, dx, taps): bound by operations.
//
// The general kernel: a block keeps its tile of samples' input, conv outputs
// and mid-chain activation in shared memory and computes each output with
// one thread, reading the taps from global memory. Its partial sums of
// d(taps) go to its row of a (grid, n) buffer that a second kernel sums in
// order (deterministic: no atomics). Input gradients are skipped where the
// caller needs none (the range encoder's first stage reads the pooled CIR).
// At the residual block it took 293 us at batch 500 (phase_times.py, H100):
// 173 in the d(taps) partials (250 blocks of 2 samples, two shared loads a
// multiply-add, 24.6 MB of partial rows), 77 in dx (each thread reads a taps
// row of its own from global memory, 256 B apart across a warp), about 25
// in the recomputes.
//
// It took 51-103 us at the range chains (H100, batch 500), for the same
// reasons: 250 blocks of 2 samples, the taps read from global memory by every
// output thread, two shared loads a multiply-add in d(taps), and 250 partial
// rows (8.2 MB at stage 5).
//
// The residual block's kernel (res):
// - both convs' taps sit in shared memory (2 x 51 KB: rows of C + 4 floats,
//   so a warp's reads of 32 rows hit distinct banks), staged once a block
//   with cp.async, the second conv's landing behind the first conv;
// - one persistent block a SM (512 threads) walks tiles of 4 whole samples
//   (the IN statistics couple a sample's rows); x and g of a tile are staged
//   with the reflect halo rows, so each window is contiguous and unmasked;
// - the products are register-tiled so that a multiply-add takes few bytes
//   from shared memory, which delivers 128 B a clock to an SM's lanes: the
//   recomputes 4 samples x 4 channels a thread (warps 0-3, 2 B a
//   multiply-add), each output one fmaf chain over t, then ci ascending, as
//   K1's kernels sum it (res_block.cuh), so the ReLU masks and IN
//   statistics are the forward's bit for bit; dx 8 rows x 1 channel a thread
//   (warps 0-7), the reflect fold fixed at compile time; d(taps) 3 taps x 2 input x 4 output
//   channels a thread (all 16 warps), kept in registers over all the
//   block's tiles;
// - a block writes one partial row of both convs' d(taps) (125 rows, 12.3 MB
//   at batch 500), coalesced through shared memory, summed in a fixed order
//   by a second kernel: bit-reproducible, no atomics. Full fp32 FMAs, no
//   TF32.
// The range chains' kernel (down), one template instance a site, the shapes
// fixed at compile time:
// - one persistent block a SM (256 threads) walks tiles of 4 whole samples; the
//   stages' taps are staged once a block by cp.async in rows of C_out + 4
//   floats, and transposed for dx (rows of C_in + 4) by the warps that the
//   first recompute leaves idle; x and the mid-chain activation are staged with
//   their zero (or reflect) pad rows, the conv outputs between two zero rows, so
//   every window is contiguous and unmasked;
// - the recomputes run 4 samples x 4 output channels a thread, each output one
//   fmaf chain over t, then ci ascending (a tap on a zero row adds exactly 0),
//   and the IN statistics run on K1's own rows and lanes: the ReLU masks are the
//   forward's bit for bit;
// - d(taps) sits in registers over all the block's tiles, a thread a cell of
//   (ci, 4 output channels) and every tap (where a stage has fewer cells than
//   threads, up to 32 threads share a cell over interleaved rows); a block writes
//   one partial row, the repeats and then the rows summed in a fixed order;
// - dx runs 4 input rows x 4 channels a thread: the stride-2 k4 windows overlap
//   by two rows, so a thread's 4 rows read 4 gz rows and the taps that reach
//   each row are fixed at compile time.
#include "async_smem.cuh"
#include "conv_bwd_common.cuh"
#include "down_chain.cuh"
#include "res_block.cuh"

namespace {

using namespace iins;
using down::for_rows;
using down::group_sum;
using down::row_stats;

// Per-sample (B, C) tables of K5, each offset to the block's first sample
// by the kernel; unused by K1.
struct Affine {
  const float *g1, *b1, *g2;
};
struct AffineGrad {
  float *dg1, *db1, *dg2, *db2;
};

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

// ---------------------------------------------------------------------------
// The residual block's path: K1's residual block (IN) and K5 (AdaIN) at the
// model's shape, (L, C) = (8, 64), both convs k3, stride 1, reflect pad 1.
namespace res {

using iins::aligned16;

constexpr int kS = 4;  // samples a tile
constexpr int kThreads = 512;
constexpr int kHaloFloats = kS * kH * kLd;  // a tile with its halo rows
constexpr int kTileFloats = kS * kL * kLd;
constexpr int kSmemBytes =
    (2 * kWFloats + 2 * kHaloFloats + 3 * kTileFloats) * static_cast<int>(sizeof(float));
// the thread layouts below are written for this shape: a (sample, channel) row of a norm to
// each thread pair, 4 warps x 32 lanes of 4 x 4 recomputed outputs, 4 x 64 dx rows
static_assert(kL == 8 && kC == 64 && kS == 4 && kThreads == 2 * kS * kC, "res layouts");

// One conv's taps (3, C, C) into w, cp.async.
__device__ void stage_taps(const float* __restrict__ w, float* ws) {
  constexpr int q = kC / 4;
  for (int i = threadIdx.x; i < 3 * kC * q; i += kThreads) {
    const int r = i / q, c = (i - r * q) * 4;  // r = t * C + ci
    cp_async16(ws + r * kLd + c, w + r * kC + c, true);
  }
}

// The tile's samples s0 .. s0+ns-1, cp.async: x with its halo rows at xs, g at gs; the rows of
// samples past the batch are zero (they then add exactly 0 to every sum).
__device__ void stage_tile(const float* __restrict__ x, const float* __restrict__ g, int s0,
                           int ns, float* xs, float* gs) {
  constexpr int q = kC / 4;
  stage_halo<kS, kThreads>(x, s0, ns, xs);
  for (int i = threadIdx.x; i < kS * kL * q; i += kThreads) {
    const int r = i / q, c = (i - r * q) * 4;
    const bool ok = r / kL < ns;
    cp_async16(gs + r * kLd + c, g + (static_cast<size_t>(s0) * kL + (ok ? r : 0)) * kC + c, ok);
  }
}

// The recomputes: z = conv(a, w) on warps 0-3, 4 samples x 4 channels a thread
// (res_block.cuh's conv_tile), the operands loaded in step.
__device__ __forceinline__ void conv_tile(const float* a, const float* w, float* z) {
  conv_tile<kS, false>(a, w, z, [](int) {});
}

// gz = the norm's backward of gh (= gsrc, masked by h = yh * ga + be > 0 when kRelu) over the
// lane's rows; kAdain: dga = sum gh * yh and dbe = sum gh of the row (the even lane writes).
template <bool kAdain, bool kRelu>
__device__ __forceinline__ void norm_bwd(const RowNorm& n, float ga, float be, const float* gsrc,
                                         float* gz, float* dga, float* dbe) {
  float gh[kL / 2], sgh = 0.f, sghy = 0.f;
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) {
    const float h = kAdain ? fmaf(n.yh[k], ga, be) : n.yh[k];
    gh[k] = (!kRelu || h > 0.f) ? gsrc[2 * k * kLd] : 0.f;
    sgh += gh[k];
    sghy = fmaf(gh[k], n.yh[k], sghy);
  }
  sgh += __shfl_xor_sync(0xffffffffu, sgh, 1);
  sghy += __shfl_xor_sync(0xffffffffu, sghy, 1);
  if (kAdain && dga) {
    *dga = sghy;
    *dbe = sgh;
  }
  const float mg = sgh * ga * kInvL, mgy = sghy * ga * kInvL;
#pragma unroll
  for (int k = 0; k < kL / 2; ++k) gz[2 * k * kLd] = n.rs * (gh[k] * ga - mg - n.yh[k] * mgy);
}

// dw[h][t][v] += sum over the tile's rows l of a[s, reflect(l + t - 1), ci + 32 h] *
// gz[s, l, co + v]: thread (ci, co / 4) of the block, ci < 32, its 24 entries of d(taps) in
// registers (per row 1 float4 of gz, broadcast across the warp, for 24 multiply-adds).
__device__ __forceinline__ void taps_grad(const float* a, const float* gz, int ns,
                                          float (&dw)[2][3][4]) {
  const int ci = threadIdx.x & 31, co = 4 * (threadIdx.x >> 5);
#pragma unroll 1
  for (int s = 0; s < ns; ++s) {
    float av[2][kH];
#pragma unroll
    for (int r = 0; r < kH; ++r) {
      av[0][r] = a[(s * kH + r) * kLd + ci];
      av[1][r] = a[(s * kH + r) * kLd + ci + 32];
    }
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const float4 gv = lds4(gz + (s * kL + l) * kLd + co);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          const float v = av[h][l + t];
          dw[h][t][0] = fmaf(v, gv.x, dw[h][t][0]);
          dw[h][t][1] = fmaf(v, gv.y, dw[h][t][1]);
          dw[h][t][2] = fmaf(v, gv.z, dw[h][t][2]);
          dw[h][t][3] = fmaf(v, gv.w, dw[h][t][3]);
        }
    }
  }
}

// acc[u] = the conv's input gradient at row u, channel ci of sample s, thread (s, ci) of warps
// 0-7: sum over the gz rows r and taps t with reflect(r + t - 1) == u of gz[s, r] . w[t, ci].
// Each gz row reaches three rows; the reflect pad folds tap 0 of row 0 onto row 1 and tap 2 of
// row L-1 onto row L-2, fixed at compile time.
__device__ __forceinline__ void input_grad(const float* gz, const float* w, float (&acc)[kL]) {
  const int s = threadIdx.x / kC, ci = threadIdx.x & (kC - 1);
#pragma unroll
  for (int u = 0; u < kL; ++u) acc[u] = 0.f;
  const float* wc = w + ci * kLd;
  const float* gs = gz + s * kL * kLd;
#pragma unroll 2
  for (int co = 0; co < kC; co += 4) {
    float4 wt[3];
#pragma unroll
    for (int t = 0; t < 3; ++t) wt[t] = lds4(wc + t * kC * kLd + co);
#pragma unroll
    for (int r = 0; r < kL; ++r) {
      const float4 gv = lds4(gs + r * kLd + co);
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int u = reflect(r + t - 1);
        acc[u] = fmaf(gv.x, wt[t].x, acc[u]);
        acc[u] = fmaf(gv.y, wt[t].y, acc[u]);
        acc[u] = fmaf(gv.z, wt[t].z, acc[u]);
        acc[u] = fmaf(gv.w, wt[t].w, acc[u]);
      }
    }
  }
}

// A thread's 24 entries of one conv's d(taps) into dst, (t, ci, co) in rows of kLd floats
// (a warp's 32 input channels on distinct banks).
__device__ __forceinline__ void put_taps(float* dst, const float (&dw)[2][3][4]) {
  const int ci = threadIdx.x & 31, co = 4 * (threadIdx.x >> 5);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int t = 0; t < 3; ++t)
      *reinterpret_cast<float4*>(dst + (t * kC + ci + 32 * h) * kLd + co) =
          make_float4(dw[h][t][0], dw[h][t][1], dw[h][t][2], dw[h][t][3]);
}

// One persistent block a SM walks tiles of kS samples (tile b, b + grid, ...). Per tile, from
// x and g staged in shared memory beside both convs' taps:
//   (1) z1 = conv(x, W1)                       (2) y1 = relu(IN(z1) [* g1 + b1]), yh1 kept
//   (3) z2 = conv(y1, W2)                      (4) gz2 = IN backward of g [* g2]
//   (5) dW2 += window(y1)^T gz2, gy1 = conv2^T(gz2)
//   (6) gz1 = IN backward of gy1 masked by h1 > 0
//   (7) dW1 += window(x)^T gz1, dx = conv1^T(gz1) + g.
// The block keeps its d(taps) in registers over all its tiles and writes one partial row.
template <bool kAdain>
__global__ void __launch_bounds__(kThreads, 1)
res_block_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ w2, const float* __restrict__ g,
                     float* __restrict__ dx, float* __restrict__ part, int batch, int n_tiles,
                     Affine af, AffineGrad ag) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* w2s = w1s + kWFloats;
  float* xs = w2s + kWFloats;   // x with halo rows
  float* y1 = xs + kHaloFloats;  // y1 with halo rows
  float* gs = y1 + kHaloFloats;  // g
  float* z2 = gs + kTileFloats;  // z2, then gz2
  float* gy = z2 + kTileFloats;  // z1, then gy1, then gz1
  const bool recompute = threadIdx.x < 128, dgrad = threadIdx.x < 256;  // warps 0-3, 0-7
  // the thread's norm rows: rows par, par + 2, ... of (sample sn, channel cn)
  const int pr = threadIdx.x >> 1, par = threadIdx.x & 1;
  const int sn = pr / kC, cn = pr & (kC - 1), nrow = (sn * kL + par) * kLd + cn;
  float dw1[2][3][4] = {}, dw2[2][3][4] = {};

  int tile = blockIdx.x;
  stage_taps(w1, w1s);
  stage_tile(x, g, tile * kS, min(kS, batch - tile * kS), xs, gs);
  cp_async_commit();
  stage_taps(w2, w2s);
  cp_async_commit();
  cp_async_wait<1>();  // W1 and the first tile; W2 lands behind (1) and (2)
  for (bool first = true; tile < n_tiles; tile += gridDim.x, first = false) {
    const int s0 = tile * kS, ns = min(kS, batch - s0);
    const bool real = sn < ns;
    const size_t tab = static_cast<size_t>(s0 + (real ? sn : 0)) * kC + cn;
    if (!first) {
      __syncthreads();  // the last tile's reads of xs and gs are done
      stage_tile(x, g, s0, ns, xs, gs);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    if (recompute) conv_tile(xs, w1s, gy);  // (1)
    __syncthreads();
    // (2); row 1's lane also writes its copy above the sample, row L-2's lane below it
    const RowNorm n1 = row_norm(gy + nrow);
    float ga1 = 1.f, be1 = 0.f;
    if (kAdain) {
      ga1 = real ? __ldg(af.g1 + tab) : 0.f;
      be1 = real ? __ldg(af.b1 + tab) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kL / 2; ++k) {
      float v = n1.yh[k];
      if (kAdain) v = fmaf(v, ga1, be1);
      v = fmaxf(v, 0.f);
      const int l = par + 2 * k;
      float* dst = y1 + (sn * kH + l + 1) * kLd + cn;
      *dst = v;
      if (l == 1) dst[-2 * kLd] = v;
      if (l == kL - 2) dst[2 * kLd] = v;
    }
    if (first) cp_async_wait<0>();
    __syncthreads();
    if (recompute) conv_tile(y1, w2s, z2);  // (3)
    __syncthreads();
    {  // (4)
      const RowNorm n2 = row_norm(z2 + nrow);
      const float ga2 = kAdain ? (real ? __ldg(af.g2 + tab) : 0.f) : 1.f;
      const bool out = kAdain && real && par == 0;
      norm_bwd<kAdain, false>(n2, ga2, 0.f, gs + nrow, z2 + nrow, out ? ag.dg2 + tab : nullptr,
                              out ? ag.db2 + tab : nullptr);
    }
    __syncthreads();
    if (dgrad) {  // (5)
      float acc[kL];
      input_grad(z2, w2s, acc);
      const int s = threadIdx.x / kC, ci = threadIdx.x & (kC - 1);
#pragma unroll
      for (int u = 0; u < kL; ++u) gy[(s * kL + u) * kLd + ci] = acc[u];
    }
    taps_grad(y1, z2, ns, dw2);
    __syncthreads();
    {  // (6)
      const bool out = kAdain && real && par == 0;
      norm_bwd<kAdain, true>(n1, ga1, be1, gy + nrow, gy + nrow, out ? ag.dg1 + tab : nullptr,
                             out ? ag.db1 + tab : nullptr);
    }
    __syncthreads();
    if (dgrad && dx) {  // (7)
      float acc[kL];
      input_grad(gy, w1s, acc);
      const int s = threadIdx.x / kC, ci = threadIdx.x & (kC - 1);
      if (s < ns) {
        float* d = dx + (static_cast<size_t>(s0 + s) * kL) * kC + ci;
#pragma unroll
        for (int u = 0; u < kL; ++u) d[u * kC] = acc[u] + gs[(s * kL + u) * kLd + ci];
      }
    }
    taps_grad(xs, gy, ns, dw1);
  }

  // the block's partial row, d(taps1) then d(taps2): through the taps' shared memory (the
  // two regions are 2 * 3 * C rows of kLd floats), then out in contiguous float4s
  __syncthreads();
  put_taps(w1s, dw1);
  put_taps(w2s, dw2);
  __syncthreads();
  float* row = part + static_cast<size_t>(blockIdx.x) * 2 * kTaps;
  for (int i = threadIdx.x; i < 2 * kTaps / 4; i += kThreads) {
    const int r = i / (kC / 4), c = (i - r * (kC / 4)) * 4;
    *reinterpret_cast<float4*>(row + r * kC + c) = lds4(smem + r * kLd + c);
  }
}

int smem_set[2] = {0, 0};

template <bool kAdain>
int launch(const float* x, const float* w1, const float* w2, const float* g, float* dx,
           float* part, float* dw, int batch, int l, int c, int tile, int grid, int smem,
           Affine af, AffineGrad ag, void* stream) {
  const int n_tiles = batch > 0 ? (batch + kS - 1) / kS : 0;
  if (batch <= 0 || l != kL || c != kC || tile != kS || grid < 1 || grid > n_tiles ||
      smem != kSmemBytes)
    return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w1),
                        static_cast<const void*>(w2), static_cast<const void*>(g),
                        static_cast<const void*>(dx)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  int err = allow_smem(res_block_bwd_kernel<kAdain>, smem, &smem_set[kAdain]);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  res_block_bwd_kernel<kAdain><<<grid, kThreads, smem, s>>>(x, w1, w2, g, dx, part, batch,
                                                            n_tiles, af, ag);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return iins::launch_reduce_rows(part, grid, 2 * kTaps, dw, s);
}

}  // namespace res

// ---------------------------------------------------------------------------
// The range encoder's stride-2 chains at the flagship's shapes, every stage conv -> IN -> ReLU:
// range.pair0 ((128, 1) k7 reflect 3 -> (128, 4), k4 s2 zero 1 -> (64, 8); no dx), range.pair1
// ((64, 8) -> (32, 16) -> (16, 32), both k4 s2 zero 1) and range.single ((16, 32) -> (8, 64)).
namespace down {

using iins::aligned16;

// K1b's own constants; the stages, sites and forward pieces are down_chain.cuh's
constexpr int kRB = 4;  // input rows of a dx thread

// One stage's taps transposed into wt (K, C_out, C_in) by the threads t0 .. kThreads-1 (those
// the first recompute leaves idle): a float4 of 4 output channels a thread, C_in fastest across
// threads, 8 loads in flight before their stores.
template <class T>
__device__ void transpose_taps(const float* __restrict__ w, float* wt, int t0) {
  constexpr int kQ = T::CO / 4, kN = T::K * T::CI * kQ, kB = 8;
  const int nt = kThreads - t0;
  for (int base = threadIdx.x - t0; base < kN; base += kB * nt) {
    float4 v[kB];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = base + b * nt;
      if (i >= kN) break;
      const int ci = i % T::CI, r = i / T::CI, t = r / kQ, c = (r - t * kQ) * 4;
      v[b] = __ldg(reinterpret_cast<const float4*>(w + (t * T::CI + ci) * T::CO + c));
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int i = base + b * nt;
      if (i >= kN) break;
      const int ci = i % T::CI, r = i / T::CI, t = r / kQ, c = (r - t * kQ) * 4;
      float* d = wt + (t * T::CO + c) * T::LdT + ci;
      d[0] = v[b].x;
      d[T::LdT] = v[b].y;
      d[2 * T::LdT] = v[b].z;
      d[3 * T::LdT] = v[b].w;
    }
  }
}

// In place over z (the stage's conv output rows): z <- gz, the IN backward of gh = g where the
// recomputed relu input is > 0; g (sample s, row i, channel c) at gsrc[s * g_ss + i * g_ld + c].
template <class T>
__device__ void norm_grad(float* z, const float* gsrc, int g_ss, int g_ld, int ns) {
  const float inv_l = 1.f / static_cast<float>(T::LO);
  for_rows(T::LO, T::CO, ns, [&](int, int s, int ch, bool valid, int lane, int lanes) {
    float* zs = z + s * T::ZS + T::LdZ + ch;
    const float* gs = gsrc + s * g_ss + ch;
    float mean, rs;
    row_stats(zs, T::LO, T::LdZ, valid, lane, lanes, mean, rs);
    float sgh = 0.f, sghy = 0.f;
    if (valid)
      for (int i = lane; i < T::LO; i += lanes) {
        const float yh = (zs[i * T::LdZ] - mean) * rs;
        const float gh = yh > 0.f ? gs[i * g_ld] : 0.f;
        sgh += gh;
        sghy = fmaf(gh, yh, sghy);
      }
    sgh = group_sum(sgh, lanes);
    sghy = group_sum(sghy, lanes);
    if (!valid) return;
    const float mg = sgh * inv_l, mgy = sghy * inv_l;
    for (int i = lane; i < T::LO; i += lanes) {
      const float yh = (zs[i * T::LdZ] - mean) * rs;
      const float gh = yh > 0.f ? gs[i * g_ld] : 0.f;
      zs[i * T::LdZ] = rs * (gh - mg - yh * mgy);
    }
  });
}

// The thread's d(taps) cell: its repeat (which (sample, row)s it sums), input channel and first
// output channel; false where the thread has none.
template <class T>
__device__ __forceinline__ bool taps_cell(int& rep, int& ci, int& co) {
  const int tid = threadIdx.x;
  if (tid >= T::Active) return false;
  const int cell = T::Cells >= kThreads ? tid : tid % T::Cells;
  rep = T::Cells >= kThreads ? 0 : tid / T::Cells;
  ci = cell % T::CI;
  co = cell / T::CI * 4;
  return true;
}

// acc[c][t][v] += sum over the tile's (sample, row) of a[s, l*S + t, ci] * gz[s, l, co_c + v],
// the cell's d(taps) (per row K broadcast-free loads of a and Cpt float4s of gz for 4 K Cpt
// multiply-adds), kept in registers over the block's tiles.
template <class T>
__device__ void taps_grad(const float* a, const float* gz, int ns,
                          float (&acc)[T::Cpt][T::K][4]) {
  int rep, ci, co;
  if (!taps_cell<T>(rep, ci, co)) return;
  for (int p = rep; p < ns * T::LO; p += T::Reps) {
    const int s = p / T::LO, l = p - s * T::LO;
    float xv[T::K];
#pragma unroll
    for (int t = 0; t < T::K; ++t) xv[t] = a[s * T::XS + (l * T::S + t) * T::LdI + ci];
#pragma unroll
    for (int c = 0; c < T::Cpt; ++c) {
      const float4 gv = lds4(gz + s * T::ZS + (1 + l) * T::LdZ + co + c * (kThreads / T::CI) * 4);
#pragma unroll
      for (int t = 0; t < T::K; ++t) {
        acc[c][t][0] = fmaf(xv[t], gv.x, acc[c][t][0]);
        acc[c][t][1] = fmaf(xv[t], gv.y, acc[c][t][1]);
        acc[c][t][2] = fmaf(xv[t], gv.z, acc[c][t][2]);
        acc[c][t][3] = fmaf(xv[t], gv.w, acc[c][t][3]);
      }
    }
  }
}

// The cells' d(taps) into scr, repeat r's (K, C_in, C_out) at scr + r * NTaps.
template <class T>
__device__ void put_taps(float* scr, const float (&acc)[T::Cpt][T::K][4]) {
  int rep, ci, co;
  if (!taps_cell<T>(rep, ci, co)) return;
#pragma unroll
  for (int c = 0; c < T::Cpt; ++c)
#pragma unroll
    for (int t = 0; t < T::K; ++t)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        scr[rep * T::NTaps + (t * T::CI + ci) * T::CO + co + c * (kThreads / T::CI) * 4 + v] =
            acc[c][t][v];
}

// row[e] = the repeats' sums of entry e, added in order.
template <class T>
__device__ void sum_taps(const float* scr, float* __restrict__ row) {
  for (int e = threadIdx.x; e < T::NTaps; e += kThreads) {
    float v = scr[e];
    for (int r = 1; r < T::Reps; ++r) v += scr[r * T::NTaps + e];
    row[e] = v;
  }
}

// The stage's input gradient (zero pad), out[s, u, ci] = sum over (l, t) with l*S + t - P == u
// of gz[s, l] . wt[t, :, ci]: thread (s, kRB rows, 4 input channels) reads, per 4 output
// channels, the gz rows its rows need (the pad's zero rows past each end) and 4 K float4s of the
// transposed taps; which taps reach which row is fixed at compile time.
template <class T>
__device__ void input_grad(const float* gz, const float* wt, float* out, int out_ss, int out_ld,
                           int ns) {
  constexpr int kQ = T::CI / 4, kUB = T::LI / kRB;
  constexpr int kLmin = floor_div(T::P - T::K + 1, T::S), kLmax = floor_div(kRB - 1 + T::P, T::S);
  constexpr int kNR = kLmax - kLmin + 1;
  static_assert(!T::R && T::CI % 4 == 0 && T::LI % kRB == 0 && kRB % T::S == 0 && kLmin >= -1 &&
                    (T::LI - kRB) / T::S + kLmax <= T::LO,
                "dx rows");
  for (int it = threadIdx.x; it < kS * kUB * kQ; it += kThreads) {
    const int q = it % kQ, r = it / kQ, ub = r % kUB, s = r / kUB;
    if (s >= ns) continue;
    const int u0 = ub * kRB, ci = 4 * q;
    const float* gs = gz + s * T::ZS + (1 + u0 / T::S + kLmin) * T::LdZ;
    float acc[kRB][4];
#pragma unroll
    for (int j = 0; j < kRB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll 2
    for (int co = 0; co < T::CO; co += 4) {
      float4 gr[kNR];
#pragma unroll
      for (int k = 0; k < kNR; ++k) gr[k] = lds4(gs + k * T::LdZ + co);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4 wv[T::K];
#pragma unroll
        for (int t = 0; t < T::K; ++t) wv[t] = lds4(wt + (t * T::CO + co + e) * T::LdT + ci);
#pragma unroll
        for (int j = 0; j < kRB; ++j)
#pragma unroll
          for (int t = 0; t < T::K; ++t) {
            const int num = j + T::P - t;
            if (num % T::S) continue;
            const float gv = lane4(gr[num / T::S - kLmin], e);
            acc[j][0] = fmaf(gv, wv[t].x, acc[j][0]);
            acc[j][1] = fmaf(gv, wv[t].y, acc[j][1]);
            acc[j][2] = fmaf(gv, wv[t].z, acc[j][2]);
            acc[j][3] = fmaf(gv, wv[t].w, acc[j][3]);
          }
      }
    }
#pragma unroll
    for (int j = 0; j < kRB; ++j)
      *reinterpret_cast<float4*>(out + s * out_ss + (u0 + j) * out_ld + ci) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

// One persistent block a SM walks tiles of kS samples (tile b, b + grid, ...). Per tile, from x
// staged with its pad rows beside the taps staged once a block:
//   (1) z1 = conv(x, W1)                 two stages: (2) y1 = relu(IN(z1)), (3) z2 = conv(y1, W2),
//   (4) gz2 = IN backward of g masked by the recomputed relu input, (5) dW2 += window(y1)^T gz2
//   and gy1 = conv2^T(gz2), (6) gz1 = IN backward of gy1 masked;  one stage: (6) gz1 from g
//   (7) dW1 += window(x)^T gz1 and, where asked, dx = conv1^T(gz1).
// The block keeps its d(taps) in registers over all its tiles and writes one partial row.
template <class C>
__global__ void __launch_bounds__(kThreads, 1)
down_chain_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                      const float* __restrict__ w2, const float* __restrict__ g,
                      float* __restrict__ dx, float* __restrict__ part, int batch, int n_tiles) {
  using S1 = typename C::S1;
  using S2 = typename C::S2;
  extern __shared__ __align__(16) float sm[];
  float* w1s = sm;
  float* w1t = sm + C::kW1t;
  float* w2s = sm + C::kW2s;
  float* w2t = sm + C::kW2t;
  float* xs = sm + C::kXs;
  float* z1 = sm + C::kZ1;  // z1, then gz1
  float* y1 = sm + C::kY1;
  float* z2 = sm + C::kZ2;  // z2, then gz2
  float* gy = sm + C::kGy;
  // the conv outputs' and y1's pad rows stay zero: no phase writes them
  for (int i = threadIdx.x; i < C::kGy - C::kZ1; i += kThreads) z1[i] = 0.f;
  stage_taps<S1>(w1, w1s);
  if constexpr (C::kTwo) stage_taps<S2>(w2, w2s);
  float acc1[S1::Cpt][S1::K][4] = {}, acc2[S2::Cpt][S2::K][4] = {};

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int s0 = tile * kS, ns = min(kS, batch - s0);
    const float* gg = g + static_cast<size_t>(s0) * C::kGS;
    __syncthreads();  // the last tile's reads of xs are done
    stage_input<S1>(x, s0, ns, xs);
    cp_async_wait_all();
    __syncthreads();
    if (threadIdx.x < C::kConv) {
      conv_fwd<S1>(xs, w1s, z1);  // (1)
    } else if (tile == static_cast<int>(blockIdx.x)) {  // meanwhile, once a block: dx's taps
      if constexpr (C::kDx) transpose_taps<S1>(w1, w1t, C::kConv);
      if constexpr (C::kTwo) transpose_taps<S2>(w2, w2t, C::kConv);
    }
    __syncthreads();
    if constexpr (C::kTwo) {
      norm_relu<S1, S2>(z1, y1, ns);  // (2)
      __syncthreads();
      conv_fwd<S2>(y1, w2s, z2);  // (3)
      __syncthreads();
      norm_grad<S2>(z2, gg, S2::LO * S2::CO, S2::CO, ns);  // (4)
      __syncthreads();
      taps_grad<S2>(y1, z2, ns, acc2);  // (5)
      input_grad<S2>(z2, w2t, gy, C::kGyS, C::kGyLd, ns);
      __syncthreads();
      norm_grad<S1>(z1, gy, C::kGyS, C::kGyLd, ns);  // (6)
    } else {
      norm_grad<S1>(z1, gg, S1::LO * S1::CO, S1::CO, ns);  // (6)
    }
    __syncthreads();
    taps_grad<S1>(xs, z1, ns, acc1);  // (7)
    if constexpr (C::kDx)
      if (dx)
        input_grad<S1>(z1, w1t, dx + static_cast<size_t>(s0) * S1::LI * S1::CI,
                       S1::LI * S1::CI, S1::CI, ns);
  }

  // the block's partial row, d(taps1) then d(taps2): each cell's repeats summed in order
  __syncthreads();
  float* scr2 = sm + S1::Reps * S1::NTaps;
  put_taps<S1>(sm, acc1);
  if constexpr (C::kTwo) put_taps<S2>(scr2, acc2);
  __syncthreads();
  float* row = part + static_cast<size_t>(blockIdx.x) * C::kNTaps;
  sum_taps<S1>(sm, row);
  if constexpr (C::kTwo) sum_taps<S2>(scr2, row + S1::NTaps);
}

int smem_set[3] = {0, 0, 0};

template <class C>
int launch(const float* x, const float* w1, const float* w2, const float* g, float* dx,
           float* part, float* dw, int batch, int tile, int grid, int smem, void* stream) {
  const int n_tiles = batch > 0 ? (batch + kS - 1) / kS : 0;
  if (batch <= 0 || tile != kS || grid < 1 || grid > n_tiles || smem != C::kSmemBytes ||
      (dx && !C::kDx))
    return cudaErrorInvalidValue;
  for (const void* p : {static_cast<const void*>(x), static_cast<const void*>(w1),
                        static_cast<const void*>(w2), static_cast<const void*>(g),
                        static_cast<const void*>(dx)})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  int err = allow_smem(down_chain_bwd_kernel<C>, smem, &smem_set[C::kId]);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  down_chain_bwd_kernel<C><<<grid, kThreads, smem, s>>>(x, w1, w2, g, dx, part, batch, n_tiles);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return iins::launch_reduce_rows(part, grid, C::kNTaps, dw, s);
}

}  // namespace down

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

// K1's residual block (IN: g1 null) or K5 (AdaIN) at (l, c) = (8, 64) on the residual
// block's own path: x, g (B, 8, 64); dx (B, 8, 64) or null; w1, w2 (3, 64, 64); K5's tables
// g1, b1, g2 and its gradients dg1, db1, dg2, db2 (B, 64). tile (samples a tile), grid (the
// persistent blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared memory) as
// backward.res_block_plan gives them; the launch refuses any other. part (grid, 2*3*64*64)
// scratch; dw (2*3*64*64): d(taps1), then d(taps2).
int iins_res_block_bwd(const float* x, const float* w1, const float* w2, const float* g1,
                       const float* b1, const float* g2, const float* g, float* dx, float* part,
                       float* dw, float* dg1, float* db1, float* dg2, float* db2, int batch,
                       int l, int c, int tile, int grid, int smem, void* stream) {
  if (!g1)
    return res::launch<false>(x, w1, w2, g, dx, part, dw, batch, l, c, tile, grid, smem,
                              Affine{}, AffineGrad{}, stream);
  if (!b1 || !g2 || !dg1 || !db1 || !dg2 || !db2) return cudaErrorInvalidValue;
  return res::launch<true>(x, w1, w2, g, dx, part, dw, batch, l, c, tile, grid, smem,
                           Affine{g1, b1, g2}, AffineGrad{dg1, db1, dg2, db2}, stream);
}

// K1b at the range encoder's stride-2 chains on their own path: site 0 range.pair0, 1
// range.pair1, 2 range.single (shapes at the top of namespace down). x (B, l_in, c_in); w1, w2
// the stages' taps (w2 unused at site 2); g (B, l_out, c_out) of the chain output; dx (B,
// l_in, c_in) or null (always null at site 0). tile (samples a tile), grid (the persistent
// blocks, 1 .. ceil(B / tile)) and smem (a block's dynamic shared memory) as
// backward.down_chain_plan and DOWN_SMEM give them; the launch refuses any other. part (grid,
// n_w) scratch; dw (n_w): d(taps1), then d(taps2).
int iins_down_chain_bwd(const float* x, const float* w1, const float* w2, const float* g,
                        float* dx, float* part, float* dw, int batch, int site, int tile,
                        int grid, int smem, void* stream) {
  switch (site) {
    case 0:
      return down::launch<down::Pair0>(x, w1, w2, g, dx, part, dw, batch, tile, grid, smem,
                                       stream);
    case 1:
      return down::launch<down::Pair1>(x, w1, w2, g, dx, part, dw, batch, tile, grid, smem,
                                       stream);
    case 2:
      return down::launch<down::Single>(x, w1, w1, g, dx, part, dw, batch, tile, grid, smem,
                                        stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
