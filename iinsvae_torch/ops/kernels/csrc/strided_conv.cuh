// Shared code of K3 strided_conv (strided_conv.cu) and K3b strided_conv_bwd
// (strided_conv_bwd.cu): the k4 s2 zero-pad-1 conv of a channels-last
// (B, L_in, C_in) activation as window products over tiles of rows.
//
// Output row l of a sample reads input rows 2l-1 .. 2l+2, which are 4*C_in
// contiguous floats of the sample (rows -1 and L_in are the zero pad). So
// the conv is one product Y (B*L_out, C_out) = A (B*L_out, 4*C_in) .
// W (4*C_in, C_out), where A is an overlapping view of x with a row stride
// of 2*C_in and W is the (4, C_in, C_out) taps read as one matrix.
//
// A block works on tiles of consecutive rows of the flattened (B*P) row
// space (P rows a sample: L_out for the forward, ceil(L_in / 2) for the
// backward's input-row pairs), and a tile may span samples. It stages the
// tile's input rows in shared memory one segment per sample: segment j
// covers tile rows a_j .. b_j-1, which are rows m_a .. m_b-1 of sample
// s0 + j, and holds input rows 2*m_a - 1 .. 2*m_b (2*(b_j - a_j) + 2 rows,
// pad rows zero) from staged row 2*a_j + 2*j on. Row i of the tile then
// finds its window, unmasked, at staged rows 2*(i + j(i)) .. + 3, j(i) its
// segment. The backward stages gz = g * (y > 0) the same way, one row a
// tile row with one halo row each side of a segment: tile row i's gz rows
// m-1, m, m+1 are staged rows i + 2*j(i) + 0, 1, 2.
//
// The copies are 16-byte cp.async with zero fill for the pad rows, so C_in
// and C_out are multiples of 4 and every pointer is 16-byte aligned.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "async_smem.cuh"

namespace iins_sc {

// the most dynamic shared memory a block may opt in to on the H100
constexpr int kMaxSmem = 227 * 1024;

struct Geom {
  int batch, l_in, c_in, l_out, c_out;
  int p;     // tile rows a sample
  int rows;  // batch * p
};

inline bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

inline bool shape_ok(int batch, int l_in, int c_in, int c_out) {
  return batch > 0 && l_in >= 2 && c_in > 0 && c_out > 0 && c_in % 4 == 0 && c_out % 4 == 0;
}

// The most segments a tile of tm rows can touch, P rows a sample.
__host__ __device__ inline int max_segments(int tm, int p) { return (tm - 1) / p + 2; }

// Segment j of the tile [q0, q0 + n): its tile rows [a, b) and its first
// row m_a within sample s0 + j.
struct Segment {
  int a, b, m_a;
};

__device__ __forceinline__ Segment segment(const Geom& g, int q0, int n, int j) {
  const int start = (q0 / g.p + j) * g.p - q0;
  const int a = max(0, start);
  return Segment{a, min(n, start + g.p), a - start};
}

// Stage the input rows of tile rows [q0, q0 + n) (n >= 1) at xs, `sx`
// floats a staged row (see the top of this file). Issues cp.async copies
// only: the caller waits (cp_async_wait_all) and syncs.
__device__ void stage_x(const float* __restrict__ x, const Geom& g, int q0, int n, float* xs,
                        int sx) {
  const int c4 = g.c_in / 4, s0 = q0 / g.p;
  // a tile row's own input rows 2m, 2m+1 go to staged rows 2(i+j)+1, 2(i+j)+2
  for (int it = threadIdx.x; it < n * 2 * c4; it += blockDim.x) {
    const int i = it / (2 * c4), r = it - i * 2 * c4;
    const int h = r / c4, c = (r - h * c4) * 4;
    const int q = q0 + i, s = q / g.p;
    const int u = 2 * (q - s * g.p) + h;
    const bool ok = u < g.l_in;
    cp_async16(xs + (2 * (i + s - s0) + 1 + h) * sx + c,
               x + (static_cast<size_t>(s) * g.l_in + (ok ? u : 0)) * g.c_in + c, ok);
  }
  // each segment's head row 2m_a - 1 and tail row 2m_b
  const int nseg = (q0 + n - 1) / g.p - s0 + 1;
  for (int it = threadIdx.x; it < nseg * 2 * c4; it += blockDim.x) {
    const int j = it / (2 * c4), r = it - j * 2 * c4;
    const int tail = r / c4, c = (r - tail * c4) * 4;
    const Segment sg = segment(g, q0, n, j);
    const int u = tail ? 2 * (sg.m_a + sg.b - sg.a) : 2 * sg.m_a - 1;
    const bool ok = u >= 0 && u < g.l_in;
    cp_async16(xs + (2 * ((tail ? sg.b : sg.a) + j) + tail) * sx + c,
               x + (static_cast<size_t>(s0 + j) * g.l_in + (ok ? u : 0)) * g.c_in + c, ok);
  }
}

}  // namespace iins_sc
