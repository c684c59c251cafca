// K2b conv_bias_act_bwd: the backward of y = relu(conv1d(x, taps) + bias),
// K2's function.
//
// Replaces the backward of fused_dense_layer(norm='none')
// (iinsvae_tpu/ops/pallas/fused.py:1268, kernel _bwd_nonorm_kernel :150):
// dx, d(taps) and dbias. The Pallas body returns the gradient of the dense
// conv matrix; this kernel computes the composed path's gradient of the
// (k, C_in, C_out) taps directly. The ReLU mask comes from the saved output
// (y > 0, fused.py:158); a stride-2 zero pad scatters to l*s - p + t, a
// reflect pad folds the edge rows back (conv_bwd_common.cuh).
//
// A block stages its tile of samples' x and gz = g * (y > 0) in shared
// memory, writes dx of its samples, and its partial sums of d(taps) and
// dbias to its row of a (grid, n) buffer; a second kernel sums the rows in
// order (deterministic: no atomics).
//
// Bound on the H100 at batch 500: K2's sites (the 1x1 convs and the env's
// k7 reflect in-conv) are bound by bytes.
#include "conv_bwd_common.cuh"

namespace {

using namespace iins;

template <int V>
__global__ void __launch_bounds__(kThreads)
conv_bias_act_bwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ y, const float* __restrict__ g,
                         float* __restrict__ dx, float* __restrict__ part, int batch, Stage st,
                         int spb) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * spb;
  const int ns = min(spb, batch - s0);
  const int n_in = st.l_in * st.c_in, n_out = st.l_out * st.c_out;
  const int in_stride = (n_in + 3) & ~3;  // keeps gz's rows 16-byte aligned
  float* xs = smem;
  float* gz = xs + spb * in_stride;
  const float* xg = x + static_cast<size_t>(s0) * n_in;
  for (int i = threadIdx.x; i < ns * n_in; i += blockDim.x) {
    const int s = i / n_in;
    xs[s * in_stride + (i - s * n_in)] = xg[i];
  }
  const size_t o0 = static_cast<size_t>(s0) * n_out;
  for (int i = threadIdx.x; i < ns * n_out; i += blockDim.x)
    gz[i] = __ldg(y + o0 + i) > 0.f ? __ldg(g + o0 + i) : 0.f;
  __syncthreads();

  float* mine = part + static_cast<size_t>(blockIdx.x) * (st.k * st.c_in * st.c_out + st.c_out);
  taps_grad_partial(xs, in_stride, gz, n_out, st, ns, mine);
  bias_grad_partial(gz, n_out, st.l_out, st.c_out, ns, mine + st.k * st.c_in * st.c_out);
  if (dx)
    conv_input_grad<V>(gz, n_out, w, st, ns, dx + static_cast<size_t>(s0) * n_in, n_in,
                       nullptr, 0);
}

}  // namespace

extern "C" {

const char* iins_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// stage: (k, stride, pad, reflect, l_in, c_in, l_out, c_out); x (B, l_in,
// c_in), y and g (B, l_out, c_out); dx (B, l_in, c_in) or null; part
// (ceil(B / spb), k*c_in*c_out + c_out) scratch; dwb (k*c_in*c_out + c_out):
// d(taps) then dbias.
int iins_conv_bias_act_bwd(const float* x, const float* w, const float* y, const float* g,
                           float* dx, float* part, float* dwb, int batch, const int* stage,
                           int spb, void* stream) {
  if (batch <= 0 || spb <= 0) return cudaErrorInvalidValue;
  const Stage st = make_stage(stage);
  if (!stage_ok(st)) return cudaErrorInvalidValue;
  const size_t per = ((st.l_in * st.c_in + 3) & ~3) + static_cast<size_t>(st.l_out) * st.c_out;
  const size_t smem = per * spb * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int grid = (batch + spb - 1) / spb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (st.c_out % 4 == 0 && aligned16(w)) {
    conv_bias_act_bwd_kernel<4><<<grid, kThreads, smem, s>>>(x, w, y, g, dx, part, batch, st,
                                                             spb);
  } else {
    conv_bias_act_bwd_kernel<1><<<grid, kThreads, smem, s>>>(x, w, y, g, dx, part, batch, st,
                                                             spb);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_reduce(part, grid, st.k * st.c_in * st.c_out + st.c_out, dwb, s);
}

}  // extern "C"
