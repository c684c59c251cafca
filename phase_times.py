"""Where a redesigned kernel spends its time, phase by phase, on one NVIDIA card.

    python3 phase_times.py [--kernel res|res_fwd|tail|chain|mlp|res2d|res2d_bwd|mlp_fwd|sln_fwd|
                                     cba_bwd|chain_fwd|cba_fwd|mlp_head|res2d_bf16|res2d_bf16_bwd]
                           [--tree DIR] [--out FILE]

``--kernel res`` (the default): K1b's residual-block backward, from DIR's
``iinsvae_torch/ops/kernels/csrc/in_chain_bwd.cu``, timed through DIR's own wrappers at the two
residual-block sites of a 1-D training step: K1b at the range encoder's IN block
(``in_chain_bwd``) and K5b at the decoder's AdaIN block (``adain_res_block_bwd``).
``--kernel tail``: K6b, the decoder tail's backward, from DIR's ``csrc/sln_chain_bwd.cu``, timed
through ``sln_chain_bwd`` at the decoder tail (``dec.tail``: (500, 8, 64) -> 157).
``--kernel chain``: K1b at the range encoder's three stride-2 chains (``range.pair0`` without
dx, ``range.pair1``, ``range.single``), from ``csrc/in_chain_bwd.cu``, through ``in_chain_bwd``.
``--kernel mlp``: K4b, from ``csrc/mlp_chain_bwd.cu``, through ``mlp_chain_bwd`` at the 1-D
restorer, the classifier and the 2-D restorer, with the pre-activations K4 saves.
``--kernel res_fwd``: the forward of the residual blocks, from ``csrc/in_chain.cu``, through
``in_chain`` at the range encoder's IN block (K1) and ``adain_res_block`` at the decoder's AdaIN
block (K5).
``--kernel res2d``: K7, the 2-D residual block's forward, from ``csrc/res_block_2d.cu``, through
``res_block_2d`` (the serving instance, which saves nothing) at the expanded 2-D model's range
encoder IN block (``range.res2d``) and decoder AdaIN block (``dec.res2d``).
``--kernel res2d_bwd``: K7b, the 2-D residual block's backward, from ``csrc/res_block_2d_bwd.cu``,
through ``res_block_2d_bwd`` at the expanded 2-D model's range encoder IN block (``range.res2d``)
and decoder AdaIN block (``dec.res2d``), with the d1, d2 that K7 saves.
``--kernel res2d_bf16``: K7's bfloat16 instance, from ``csrc/res_block_2d_bf16.cu``, through
``res2d.launch_res_block_2d`` (serving, nothing saved) at the same two blocks on bfloat16 inputs
and the model's taps rounded to bfloat16. ``--kernel res2d_bf16_bwd``: K7b's bfloat16 instance,
from ``csrc/res_block_2d_bf16_bwd.cu``, through ``res_block_2d_bwd`` there, with the d1, d2 that
K7's bfloat16 instance saves.
``--kernel cba_bwd``: K2b, from ``csrc/conv_bias_act_bwd.cu``, through ``conv_bias_act_bwd`` at
its three sites in a 1-D training step: the range encoder's 1x1 out-conv (``range.out``), the
env encoder's k7 reflect in-conv without dx (``env.in``) and the decoder's 1x1 in-conv
(``dec.in``).
``--kernel chain_fwd``: K1 at the range encoder's three stride-2 chains (``range.pair0``,
``range.pair1``, ``range.single``), from ``csrc/in_chain.cu``, through ``in_chain``.
``--kernel cba_fwd``: K2 at its three call sites (``range.out``, ``env.in``, ``dec.in``), from
``csrc/in_chain.cu``, through ``conv_bias_act``.
``--kernel mlp_head``: K4 at the classifier (16 -> 16 -> 32 -> 16 -> 5), from
``csrc/mlp_chain.cu``, through ``mlp_chain``.

DIR defaults to this checkout. The script builds one variant of the source for each phase,
which stops the kernel after that phase (one nvcc each, all at once, under
``build/phases/``), and times each variant at batch 500 with the flagship's seeded weights and
seeded inputs, by chip_smoke.py's CUDA-graph replay (median of 25). A variant's time less the
one before is its phase's time; the first row (the kernel returns at once) is the launch and,
for a backward, the fixed-order reduction of the partial rows. Every variant computes garbage
past its cut, so nothing is checked here: chip_smoke.py holds the whole kernel to its plain
version.

The cut points are written for two designs of each kernel, named by the kernel function that
runs the site: ``in_chain_bwd_kernel`` (one kernel for every K1b site, before the residual
block, and later the range chains, got their own paths), ``res_block_bwd_kernel`` and
``down_chain_bwd_kernel``; ``sln_chain_bwd_kernel`` (K6b's kernel for every shape, before the
decoder's shape got its own path) and ``tail_bwd_kernel``; K4b's ``mlp_bwd_chain_kernel`` (a
chain kernel and a weight-gradient kernel) and ``small_kernel`` (the classifier's one-block
chain, beside the restorers' launch a layer and weight-gradient launch); K1's and K5's
forward at the residual blocks: ``in_chain_kernel`` (the general kernel, which ran them before
they got a kernel of their own) and ``res_block_kernel``; K7b's ``res2d_bwd_tc_kernel``, whose
cuts set its ``kLastPhase`` (every copy, wait and __syncthreads stays, the phases after it do no
work), and the row before them returns at once; K7's ``res_block_2d_kernel`` (fp32 FMAs, before
the tensor cores) and ``res2d_tc_kernel``, whose first row stops once x and the first tap slice
are in place and whose others set its ``kLastPhase`` as K7b's do (the second row keeps only the
copies, waits and __syncthreads); K2b's ``conv_bias_act_bwd_kernel`` (every shape, before its
three call sites got a kernel of their own) and ``cba_site_bwd_kernel``; K1's
``in_chain_kernel`` and, at the range chains, ``down_chain_kernel``; K2's
``conv_bias_act_kernel`` (every shape, before its call sites got a kernel of their own) and
``cba_fwd_kernel``; K4's ``mlp_chain_kernel`` (the general kernel, which ran the classifier
before) and ``mlp_head_kernel``; K7's and K7b's bfloat16 instances on wgmma,
``res2d_bf16_wgmma_kernel`` and ``res2d_bf16_bwd_wgmma_kernel``, whose cuts set their
``kLastPhase`` (K7b's rows before the last run its taps' gradient's kernel without products,
so the last row less the one before is those products). A "(y not stored)" row computes everything and stores y only
where a pointer equals 1, which no launch meets.
A kernel that launches several kernels a call is split by name too: each site's device time a
call of each kernel, from a torch.profiler trace of the whole call (``[split]`` lines). Prints
one JSON line and writes it to FILE (default ``build/phase_times.json``). Needs one CUDA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CSRC = "iinsvae_torch/ops/kernels/csrc"

# (phase, text after which the variant stops, the statement that stops it; None: the whole
# kernel), in the order the kernel runs them. A cut after the new design's d(taps) work has
# begun continues to the block's partial-row write, or the compiler would drop that work.
_CONT = "{ cp_async_wait<0>(); continue; }"
CUTS = {
    "in_chain_bwd_kernel": [
        ("launch + reduce", "  const float* gg = g + static_cast<size_t>(s0) * n_last;\n"),
        ("stage x", "    a0[s * n0 + (i - s * x_len)] = xg[i];\n  }\n  __syncthreads();\n"),
        ("(1) z1 = conv(x)", "  conv_stage4(a0, n0, w1, z1, n1, s1, ns);\n  __syncthreads();\n"),
        ("(2) y1 = relu(IN(z1))",
         "    norm_relu<kAdain>(z1, y1, s1.l_out, s1.c_out, ns, n1, af.g1, af.b1);\n"
         "    __syncthreads();\n"),
        ("(3) z2 = conv(y1)",
         "    conv_stage4(y1, n1, w2, z2, n2, s2, ns);\n    __syncthreads();\n"),
        ("(4) gz2", "                          ag.dg2, ag.db2);\n    __syncthreads();\n"),
        ("(5a) dW2", "    taps_grad_partial(y1, n1, z2, n2, s2, ns, mine + n_w1);\n"),
        ("(5b) gy1", "    conv_input_grad<4>(z2, n2, w2, s2, ns, y1, n1, nullptr, 0);\n"),
        ("(6) gz1", "af.g1, af.b1, ag.dg1,\n                          ag.db1);\n"),
        ("(7a) dW1", "  taps_grad_partial(a0, n0, z1, n1, s1, ns, mine);\n"),
        ("(7b) dx: the whole kernel", None),
    ],
    "res_block_bwd_kernel": [
        ("launch + reduce", "  float dw1[2][3][4] = {}, dw2[2][3][4] = {};\n"),
        ("stage taps, x, g", "      cp_async_wait<0>();\n    }\n    __syncthreads();\n",
         "{ cp_async_wait<0>(); return; }"),
        ("(1) z1 = conv(x)",
         "    if (recompute) conv_tile(xs, w1s, gy);  // (1)\n    __syncthreads();\n",
         "{ cp_async_wait<0>(); return; }"),
        ("(2) y1 = relu(IN(z1))", "    if (first) cp_async_wait<0>();\n    __syncthreads();\n"),
        ("(3) z2 = conv(y1)",
         "    if (recompute) conv_tile(y1, w2s, z2);  // (3)\n    __syncthreads();\n"),
        ("(4) gz2", "out ? ag.db2 + tab : nullptr);\n    }\n    __syncthreads();\n"),
        ("(4) + the partial-row write",
         "out ? ag.db2 + tab : nullptr);\n    }\n    __syncthreads();\n", _CONT),
        ("(5) dW2, gy1", "    taps_grad(y1, z2, ns, dw2);\n    __syncthreads();\n", _CONT),
        ("(6) gz1", "out ? ag.db1 + tab : nullptr);\n    }\n    __syncthreads();\n", _CONT),
        ("(7) dW1, dx: the whole kernel", None),
    ],
}


def _stage_cuts(phases, stages) -> list[tuple]:
    """Cuts inside a loop over the stages j: for each j of ``stages`` in turn, each (label,
    anchor) of ``phases`` as (f"{label} {j}", anchor, f"if (j == {j}) return;")."""
    return [(f"{label} {j}", anchor, f"if (j == {j}) return;")
            for j in stages for label, anchor in phases]


# K6b before the decoder's shape got its own path: the forward loop over the stages j = 0..3,
# the tail, then the backward loop j = 3..0; the last cut is the whole kernel.
_K6B_FWD = [
    ("up-conv recompute", "    up_conv_stage<true>(act[j], z[j], a.w[j], a.bias[j], a.l_in[j], "
     "a.c_in[j], c_out, ns, wd);\n    __syncthreads();\n"),
    ("LayerNorm + ReLU recompute",
     "             2 * a.l_in[j] * c_out, c_out, ns, wd);\n    __syncthreads();\n"),
]
_K6B_BWD = [
    ("dgamma, dbeta partial", "                        pj + n_taps + c_out);\n"
     "    __syncthreads();\n"),
    ("LayerNorm backward", "    sln_backward(z[j], act[j + 1], st, a.gamma[j], a.beta[j], n, "
     "c_out, ns, wd);\n    __syncthreads();\n"),
    ("d(taps), dbias partial", "    up_conv_grad_partial<true>(act[j], z[j], a.l_in[j], a.c_in[j], "
     "c_out, true, ns, wd, pj);\n    __syncthreads();\n"),
    ("input gradient", "      up_conv_input_grad<true>(z[j], a.w[j], a.l_in[j], a.c_in[j], "
     "c_out, ns, wd, act[j], wd);\n      __syncthreads();\n"),
]
CUTS["sln_chain_bwd_kernel"] = [
    ("launch + reduce",
     "  float* mine = part + static_cast<size_t>(blockIdx.x) * a.n_part;\n"),
    ("stage x", "    act[0][s * wd + (i - s * n0)] = xg[i];\n  }\n  __syncthreads();\n"),
    *_stage_cuts(_K6B_FWD, range(4)),
    ("tail recompute: conv k7, tanh",
     "    th[s * a.th_len + p] = tanhf(acc + b_out);\n  }\n  __syncthreads();\n"),
    ("pool^T, tanh'", "    th[s * a.th_len + u] = gth * (1.f - t * t);\n  }\n  __syncthreads();\n"),
    ("out conv d(taps), dbias", "    mine[a.off_out + o] = acc;\n  }\n  __syncthreads();\n"),
    ("out conv dx", "    act[kStages][s * wd + r] = acc;\n  }\n  __syncthreads();\n"),
    *_stage_cuts(_K6B_BWD, (3, 2, 1)),
    *_stage_cuts(_K6B_BWD[:3], (0,)),
    ("input gradient 0 (dx): the whole kernel", None),
]
# K6b's tail path: the tile loop's phases as the kernel body lists them. A cut continues to the
# block's partial-row write (the d(taps) sums are registers the compiler would otherwise drop),
# so every row from the second on includes that write.
_TAIL_CONT = "continue;"


def _tail_stage_phases(j: int) -> list[tuple[str, str]]:
    """(label, anchor) of the tail path's backward stage j (stage 0 sums its d(taps) into
    shared memory right after computing them)."""
    taps = (f"    taps_grad<{j}, {2 if j in (1, 2) else 1}>(sm, pa{j});\n" if j else
            "        *reinterpret_cast<float4*>(dw + t * kC0 * kC0 / 2) = v;\n      }\n    }\n")
    return [(f"LayerNorm backward, dgamma, dbeta, dbias {j}",
             f"    ln_backward<{j}>(sm, a.gamma[{j}], a.beta[{j}], ns);\n    __syncthreads();\n"
             f"    fold_channels<{j}>(sm);\n"),
            (f"d(taps) {j}", taps),
            (f"input gradient {j}",
             f"    if (threadIdx.x < kDxThreads) input_grad<{j}>(sm, dx, s0, ns);\n")]


CUTS["tail_bwd_kernel"] = [
    ("launch + reduce", "  extern __shared__ __align__(16) float sm[];\n", "return;"),
    ("zero, stage taps and x, write the row",
     "      cp_async_wait_all();\n    }\n    __syncthreads();\n",
     "{ cp_async_wait<0>(); continue; }"),
    ("forward stage 0: conv, LayerNorm, ReLU",
     "    forward_stage<0>(sm, a.bias[0], a.gamma[0], a.beta[0]);\n    if (first) {\n"
     "      cp_async_wait<0>();\n      __syncthreads();\n    }\n", _TAIL_CONT),
    *[(f"forward stage {j}: conv, LayerNorm, ReLU",
       f"    forward_stage<{j}>(sm, a.bias[{j}], a.gamma[{j}], a.beta[{j}]);\n", _TAIL_CONT)
      for j in range(1, 4)],
    ("tail: conv k7, tanh, pool^T, tanh'",
     "    tail_forward(sm, g, s0, ns, b_out, a.l_pool);\n    __syncthreads();\n", _TAIL_CONT),
    ("out conv d(taps), dbias",
     "    if (threadIdx.x < 128) tail_taps_grad(sm);\n    __syncthreads();\n", _TAIL_CONT),
    ("out conv dx", "      sm[kSmallOut + threadIdx.x] = v;\n    }\n", _TAIL_CONT),
    *[(label, anchor, _TAIL_CONT) for j in (3, 2, 1, 0) for label, anchor in
      _tail_stage_phases(j)][:-1],
    ("input gradient 0 (dx): the whole kernel", None),
]
# K1b's path at the range encoder's stride-2 chains: the tile loop's phases. A cut continues to
# the next tile and the block's partial-row write, so every row from the second on includes that
# write; range.single (one stage) never reaches the cuts of stage 2: those rows time its whole
# kernel.
_DOWN_CONT = "continue;"
CUTS["down_chain_bwd_kernel"] = [
    ("launch + reduce", "  float* gy = sm + C::kGy;\n", "return;"),
    ("zero, stage taps and x, write the row",
     "    stage_input<S1>(x, s0, ns, xs);\n    cp_async_wait_all();\n    __syncthreads();\n",
     _DOWN_CONT),
    ("(1) z1 = conv(x); dx's taps transposed",
     "      if constexpr (C::kTwo) transpose_taps<S2>(w2, w2t, C::kConv);\n    }\n"
     "    __syncthreads();\n", _DOWN_CONT),
    ("(2) y1 = relu(IN(z1))",
     "      norm_relu<S1, S2>(z1, y1, ns);  // (2)\n      __syncthreads();\n", _DOWN_CONT),
    ("(3) z2 = conv(y1)", "      conv_fwd<S2>(y1, w2s, z2);  // (3)\n      __syncthreads();\n",
     _DOWN_CONT),
    ("(4) gz2", "      norm_grad<S2>(z2, gg, S2::LO * S2::CO, S2::CO, ns);  // (4)\n"
     "      __syncthreads();\n", _DOWN_CONT),
    ("(5) dW2, gy1", "      input_grad<S2>(z2, w2t, gy, C::kGyS, C::kGyLd, ns);\n"
     "      __syncthreads();\n", _DOWN_CONT),
    ("(6) gz1", "      norm_grad<S1>(z1, gg, S1::LO * S1::CO, S1::CO, ns);  // (6)\n    }\n"
     "    __syncthreads();\n", _DOWN_CONT),
    ("(7a) dW1", "    taps_grad<S1>(xs, z1, ns, acc1);  // (7)\n", _DOWN_CONT),
    ("(7b) dx: the whole kernel", None),
]
# K4b: which of its kernels runs. Before the redesign a chain kernel and a weight-gradient kernel;
# now one kernel a layer (chain tiles and weight-gradient tiles) and the chunks' sum.
CUTS["mlp_bwd_chain_kernel"] = [
    ("chain kernel; the weight-gradient kernel returns at once",
     "  __shared__ float gs[kTile][kTile + 1];  // [b][k]\n"),
    ("chain and weight-gradient kernels: the whole call", None),
]
_MLP_SMALL = "             float* __restrict__ part, int batch, Args a) {\n"
_MLP_CHAIN = "__global__ void __launch_bounds__(kChainThreads) chain_kernel(Chain a) {\n"
_MLP_WGRAD = ("__global__ void __launch_bounds__(kChainThreads) wgrad_kernel(Wgrad a, "
              "float* __restrict__ part) {\n")
CUTS["small_kernel"] = [
    ("launches and the partial rows' sum", (_MLP_SMALL, _MLP_CHAIN, _MLP_WGRAD)),
    ("staging and the chain; no weight gradient",
     ("  // the block's rows' share of every extended weight gradient, summed over its rows in "
      "order\n", _MLP_WGRAD)),
    ("the whole call", None),
]
# K1 and K5 at the residual blocks: the general kernel (every K1, K5 and K8 shape, before the
# residual block got its own kernel) and res_block_kernel. A cut of the new kernel waits for the
# block's copies in flight (x by cp.async, the taps by bulk copies) before it returns.
CUTS["in_chain_kernel"] = [
    ("launch", "  const int n0 = s1.l_in * s1.c_in, n1 = s1.l_out * s1.c_out;\n"),
    ("stage x", "i < ns * n0; i += blockDim.x) a0[i] = xg[i];\n  __syncthreads();\n"),
    ("(1) z1 = conv(x, W1)", "  conv_stage<4>(a0, w1, a1, s1, ns);\n  __syncthreads();\n"),
    ("(2) y1 = relu(IN(z1) [* g1 + b1])", "                     af.b1);\n  __syncthreads();\n"),
    ("(3) z2 = conv(y1, W2)", "    conv_stage<4>(a1, w2, a2, s2, ns);\n    __syncthreads();\n"),
    ("(4) IN(z2) [* g2 + b2] + x",
     "    norm_stage<kAdain>(a2, skip, relu_last, s2.l_out, s2.c_out, ns, af.g2, af.b2);\n"
     "    __syncthreads();\n"),
    ("(5) y out: the whole kernel", None),
]
_RES_FWD_STOP = "{ cp_async_wait<0>(); mbar_wait(bars + 3); return; }"
CUTS["res_block_kernel"] = [
    ("launch", "  const int pr = threadIdx.x >> 1, par = threadIdx.x & 1;\n"),
    ("stage x, W1 and W2 (not overlapped)",
     "  stage_halo<kTile, kThreads>(x, tile * kTile, min(kTile, batch - tile * kTile), xs);\n"
     "  cp_async_commit();\n",
     "{ cp_async_wait<0>(); for (int i = 0; i < 4; ++i) mbar_wait(bars + i); __syncthreads(); "
     "return; }"),
    ("(1) z = conv(x, W1)", "      for (int t = 0; t < 3; ++t) tap(t);\n    __syncthreads();\n",
     _RES_FWD_STOP),
    ("(2) y1 = relu(IN(z) [* g1 + b1])",
     "    if (first) mbar_wait(bars + 3);\n    __syncthreads();\n"),
    ("(3) z = conv(y1, W2)",
     "    if (conv) conv_tile<kTile, true, kC>(y1, w2s, z, [](int) {});  // (3)\n"
     "    __syncthreads();\n"),
    ("(4) IN(z) [* g2 + b2] + x",
     "        zs[2 * k * kLd] = __fadd_rn(v, xr[2 * k * kLd]);\n      }\n    }\n"
     "    __syncthreads();\n"),
    ("(5) y out: the whole kernel", None),
]
# K7b on the tensor cores: the variant of each row computes the tile's phases up to its
# kLastPhase; the first returns at once (the launch and the partial rows' sum).
_RES2D_LAST = "constexpr int kLastPhase = 6;"
CUTS["res2d_bwd_tc_kernel"] = [
    ("launch + reduce",
     "  float* part = a.part + static_cast<size_t>(blockIdx.x) * 2 * kTapGrads;\n"),
    *[(phase, {_RES2D_LAST: f"constexpr int kLastPhase = {j};"}) for j, phase in enumerate(
        ("staging: every copy, wait and __syncthreads", "(1) gd2 = N2'(g, d2), y1",
         "(2) dk2", "(3) dy1, ga1", "(4) gd1 = N1'(ga1, d1)", "(5) dk1"))],
    ("(6) dx: the whole kernel", None),
]
# K7: the fp32-FMA kernel (the SIMT conv), and the kernel on the tensor cores, whose rows after
# the first set its kLastPhase (0: only the copies, waits and __syncthreads).
CUTS["res_block_2d_kernel"] = [
    ("launch", "  float acc[4][8];\n"),
    ("stage x", "  load_fields(x + off, fa, ns);\n"),
    ("(1) conv 1", "  if (kSave && t.s < ns) save_tile(d1 + off, t, acc);\n  __syncthreads();\n"),
    ("(2) statistics, norm_relu", "  norm_relu(fb, fb, ns, mean, rstd, g1, b1);\n"),
    ("(3) conv 2", "  if (kSave && t.s < ns) save_tile(d2 + off, t, acc);\n  __syncthreads();\n"),
    ("(4) statistics, epilogue: the whole kernel", None),
]
_RES2D_FWD_LAST = "constexpr int kLastPhase = 5;"
CUTS["res2d_tc_kernel"] = [
    ("launch, x and the first tap slice", "  st.land();  // x and slice 0 in place\n",
     "{ cp_async_wait<0>(); return; }"),
    *[(phase, {_RES2D_FWD_LAST: f"constexpr int kLastPhase = {j};"}) for j, phase in enumerate(
        ("copies, waits and __syncthreads only", "(1) the taps' split, centring",
         "(2) conv 1's products", "(3) statistics, norm_relu", "(4) conv 2's products"))],
    ("(5) statistics, epilogue: the whole kernel", None),
]
# K7's bfloat16 instance on wgmma: the first row returns at once, the others set its
# kLastPhase (0: the taps' staging, x's copies, the waits and barriers only).
_RES2D_BF16_LAST = "constexpr int kLastPhase = 4;"
CUTS["res2d_bf16_wgmma_kernel"] = [
    ("launch", "  if (threadIdx.x == 0 && (smem_u32(smem) & 1023)) __trap();  "
               "// the swizzle needs 1024 B\n"),
    *[(phase, {_RES2D_BF16_LAST: f"constexpr int kLastPhase = {j};"}) for j, phase in enumerate(
        ("(0) staging: taps, x copies, waits, barriers", "(1) conv 1's products",
         "(2) statistics, d1, y1", "(3) conv 2's products"))],
    ("(4) statistics, epilogue: the whole kernel", None),
]
# K7b's bfloat16 instance, three launches a call: the input gradients' kernel, the taps'
# gradient's kernel (res2d_bf16_dk_kernel) and the rows' sum. Each row's variant does the work of
# the phases up to its kLastPhase; the first also returns from the input gradients' kernel at
# once, and every row before the last runs the taps' gradient's kernel without its products (its
# copies, waits, barriers and row writes), and the sum.
_RES2D_BF16_BWD_LAST = "constexpr int kLastPhase = 6;"
CUTS["res2d_bf16_bwd_wgmma_kernel"] = [
    ("launch; dk kernel without products; the sum",
     {_RES2D_BF16_BWD_LAST: "constexpr int kLastPhase = 5;",
      "  copy_taps(a.k2, taps2, threadIdx.x, kThreads);\n":
      "  if (kLastPhase < 6) return;\n  copy_taps(a.k2, taps2, threadIdx.x, kThreads);\n"}),
    *[(phase, {_RES2D_BF16_BWD_LAST: f"constexpr int kLastPhase = {j};"}) for j, phase in enumerate(
        ("(0) staging: taps, loads, waits, barriers", "(1) gd2 = N2'(g, d2)", "(2) y1",
         "(3) dy1's products", "(4) gd1 = N1'(ga1, d1)", "(5) dx's products"))],
    ("(6) the taps' gradient's products: the whole call", None),
]
# K4's forward: the general kernel (one block a tile of 4 samples, each layer's weights streamed
# through one tile of shared memory), cut after each layer.
CUTS["mlp_chain_kernel"] = [
    ("launch", "  const int d0 = a.dims[0];\n"),
    ("stage x", "    cur[k * kRows + r] = r < nr ? x[static_cast<size_t>(r0 + r) * d0 + k] : 0.f;\n"
     "  }\n"),
    *[(f"layer {j}", "    float* t = cur;\n    cur = nxt;\n    nxt = t;\n", f"if (j == {j}) return;")
      for j in range(3)],
    ("layer 3: the whole kernel", None),
]
# K6's forward: the general kernel (two samples a block, taps read through the read-only cache),
# cut after each stage's conv and LayerNorm, and after the out conv.
CUTS["sln_chain_kernel"] = [
    ("launch", "  float* nxt = smem + spb * a.width;\n"),
    ("stage x", "    cur[s * a.width + (i - s * n0)] = xg[i];\n  }\n  __syncthreads();\n"),
    *_stage_cuts([
        ("up-conv", "    up_conv_stage<true>(cur, nxt, a.w[j], a.bias[j], a.l_in[j], a.c_in[j], "
         "c_out, ns, a.width);\n    __syncthreads();\n"),
        ("LayerNorm + ReLU", "             a.width);\n    __syncthreads();\n")], range(4)),
    ("out conv k7, tanh",
     "  out_stage(cur, nxt, a.w_out, __ldg(a.b_out), l, c, ns, a.width);\n  __syncthreads();\n"),
    ("pool: the whole kernel", None),
]
# K4 at the restorers: the cluster kernel, its two flows (layer 0 in every block for the 1-D
# restorer's 16 inputs, else exchanged) cut at the same points. A cut after an exchange waits
# for the cluster's barrier and for the other blocks' copies into this block, so that no block
# leaves while a copy into it is in flight.
_CL_IN = ("for (int r = 0; r < kCluster; ++r) if (r != rank) mbar_wait(bars + OFF + r, "
          "parity);")
_CL_W = "if (threadIdx.x >= 32) cluster_wait();"
_CL_L0 = "      layer0_all(xw, act, d0, s_tile, bias, a.slope[0], a.d[0], rank, row0, ns);\n"
CUTS["mlp_cluster_kernel"] = [
    ("launch", "  const int clusters = gridDim.x / kCluster;\n"),
    ("stage x, W0, W1 and the biases (all landed)",
     "  stage_rows(sm, a.w[1] + rank * kN1, kD1, kN1, kD2, ld(kN1));\n  cp_async_commit();\n",
     "{ cp_async_wait<0>(); mbar_wait(xbar, 0); "
     "__syncthreads(); return; }"),
    ("layer 0: products (1-D: the whole layer, every column)",
     (_CL_L0, "      products(act, act + d0 * sa, p, d0, kN0, s_tile, nullptr, parity, rank);\n"),
     "{ cp_async_wait<0>(); return; }"),
    ("layer 0: sums, bias, LeakyReLU, barrier, copies landed (2-D)",
     (_CL_L0, "      exchange<1>(act, p, o, bias, kN0, s_tile, a.slope[0], a.d[0], kD1, rank, row0, "
      "ns, bars,\n                  first);\n"),
     "{ cp_async_wait<0>(); if (!all0) { " + _CL_W + " " + _CL_IN.replace("OFF", "0")
     + " } return; }"),
    ("layer 1: products (2-D: as the copies land)",
     ("      products(act, sm, p, kD1, kN1, s_tile, nullptr, parity, rank);\n",
      "      products(act, sm, p, kD1, kN1, s_tile, bars, parity, rank);\n"
      "      if (threadIdx.x >= 32) cluster_wait();  // the last exchange's barrier, long complete\n"),
     "{ cp_async_wait<0>(); return; }"),
    ("layer 1: sums, bias, LeakyReLU, barrier, copies landed",
     "                row0, ns, bars + kCluster, first || all0);\n",
     "{ " + _CL_W + " " + _CL_IN.replace("OFF", "kCluster") + " return; }"),
    ("layer 2: products (as the copies land), sums, bias, LeakyReLU",
     "           row0, ns);\n    __syncthreads();\n", "{ " + _CL_W + " return; }"),
    ("layer 3: partial dot products; barrier",
     "    cl.sync();  // rank 0 holds every block's partial sums; every copy of this tile is done\n",
     "return;"),
    ("layer 3: the cluster's sum: the whole kernel", None),
]
# K6 at the decoder's shape: the tail kernel (sln_tail.cuh's forward, as K6b recomputes it).
CUTS["tail_fwd_kernel"] = [
    ("launch", "  extern __shared__ __align__(16) float sm[];\n  int tile = blockIdx.x;\n"),
    ("zero rows, stage every stage's taps and x (all landed)",
     "  stage_block(sm, a, x, tile, batch);\n", "{ cp_async_wait<0>(); __syncthreads(); return; }"),
    ("forward stage 0: conv, LayerNorm, ReLU",
     "    forward_stage<0>(sm, a.bias[0], a.gamma[0], a.beta[0]);\n    if (first) {\n"
     "      cp_async_wait<0>();\n      __syncthreads();\n    }\n"),
    *[(f"forward stage {j}: conv, LayerNorm, ReLU",
       f"    forward_stage<{j}>(sm, a.bias[{j}], a.gamma[{j}], a.beta[{j}]);\n") for j in range(1, 4)],
    ("out conv k7, tanh",
     "      sm[kTh + s * z_floats(0) + p] = out_tanh(sm, s, p, b_out);\n    }\n    __syncthreads();\n"),
    ("pool: the whole kernel", None),
]
# K2b: the general kernel (one block a tile of spb samples, a partial row a block, summed by a
# second kernel), cut after each phase.
CUTS["conv_bias_act_bwd_kernel"] = [
    ("launch + reduce", "  const int s0 = blockIdx.x * spb;\n"),
    ("stage x, gz = g * (y > 0)",
     "    gz[i] = __ldg(y + o0 + i) > 0.f ? __ldg(g + o0 + i) : 0.f;\n  __syncthreads();\n"),
    ("d(taps) partial", "  taps_grad_partial(xs, in_stride, gz, n_out, st, ns, mine);\n"),
    ("dbias partial", "  bias_grad_partial(gz, n_out, st.l_out, st.c_out, ns, mine + st.k * st.c_in * "
     "st.c_out);\n"),
    ("dx: the whole kernel", None),
]
# K2b at its call sites (namespace site): the cuts of the tile loop continue to the next tile, so
# those rows include the block's partial-row write and the last block's sum of the rows (" + sum");
# the next row returns after the partial-row write, and the last is the whole kernel: the two
# differ by the last block's sum.
_CBA_CONT = "{ cp_async_wait<0>(); continue; }"
CUTS["cba_site_bwd_kernel"] = [
    ("launch", "  __shared__ bool last;\n"),
    ("staging landed + sum",
     "    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)\n"
     "    __syncthreads();\n", _CBA_CONT),
    ("(1) gz = g * (y > 0) + sum",
     "                        yv.z > 0.f ? gv.z : 0.f, yv.w > 0.f ? gv.w : 0.f);\n    }\n"
     "    __syncthreads();\n", _CBA_CONT),
    ("(2) d(taps), dbias + sum", "    taps_grad<T>(b, ns, rep, ci, co, acc, bacc);  // (2)\n",
     _CBA_CONT),
    ("(3) dx; the partial row (no sum)", "    row[e] = v;\n  }\n", "return;"),
    ("(4) the ticket (the last block returns)", "  if (!last) return;\n", "return;"),
    ("(5) the last block's sum: the whole kernel", None),
]
# K1 at the range chains (namespace down): a cut continues to the next tile; range.single (one
# stage) never reaches the cuts of stage 2, so those rows time its whole kernel.
CUTS["down_chain_kernel"] = [
    ("launch", "  float* zl = C::kTwo ? z2 : z1;  // the last stage's output\n"),
    ("stage taps and x (landed)",
     "    stage_input<S1, NS>(x, s0, ns, xs);\n    cp_async_wait_all();\n    __syncthreads();\n",
     "continue;"),
    ("(1) z1 = conv(x, W1)", "    conv_fwd<S1, NS>(xs, w1s, z1);  // (1)\n    __syncthreads();\n",
     "continue;"),
    ("(2) y1 = relu(IN(z1))", "      norm_relu<S1, S2>(z1, y1, ns);  // (2)\n      __syncthreads();\n",
     "continue;"),
    ("(3) z2 = conv(y1, W2)",
     "      conv_fwd<S2, NS>(y1, w2s, z2);  // (3)\n      __syncthreads();\n", "continue;"),
    ("(4) IN, ReLU of the last stage", "(zl, ns);  // (4)\n    __syncthreads();\n", "continue;"),
    ("(5) y out: the whole kernel", None),
]
# K2: the general kernel (one block a tile of spb samples, taps read through __ldg inside the
# products), and at its call sites the cba kernel (namespace cba), whose x lands in shared memory
# by cp.async, its taps in registers. The "products" rows compute everything and store y only
# where a pointer equals 1, which no launch meets.
_NO_STORE = "if (reinterpret_cast<std::uintptr_t>(dst) == 1) "
CUTS["conv_bias_act_kernel"] = [
    ("launch", "                     Stage st, int spb) {\n"),
    ("stage x", "i < ns * n0; i += blockDim.x) smem[i] = xg[i];\n  __syncthreads();\n"),
    ("products, bias, ReLU (y not stored)",
     {"    for (int v = 0; v < V; ++v) dst[v] = fmaxf(acc[v] + __ldg(b + co + v), 0.f);\n":
      "    for (int v = 0; v < V; ++v) " + _NO_STORE + "dst[v] = fmaxf(acc[v] + __ldg(b + co + v), "
      "0.f);\n"}),
    ("y out: the whole kernel", None),
]
CUTS["cba_fwd_kernel"] = [
    ("launch", "  extern __shared__ __align__(16) float sm[];\n  int tile = blockIdx.x;\n"),
    ("x staged (landed)",
     "    cp_async_wait<1>();  // this tile's copies (the next tile's may be in flight)\n"
     "    __syncthreads();\n", "{ cp_async_wait<0>(); continue; }"),
    ("taps in registers, products, bias, ReLU (y not stored)",
     {"void put(V* p, V v) { __stcs(p, v); }":
      "void put(V* p, V v) { if (reinterpret_cast<std::uintptr_t>(p) == 1) __stcs(p, v); }"}),
    ("y out: the whole kernel", None),
]
# K4 at the small heads (namespace head): a cut after layer j returns with its d_j stores kept
# (the launch's ds pointers are unknown to the compiler), so the layer's products stay.
CUTS["mlp_head_kernel"] = [
    ("launch", "  constexpr bool kStatic = !std::is_same<D, Any>::value;\n"
     "  extern __shared__ __align__(16) float sm[];\n"),
    ("weights, biases and x staged (landed)",
     "  load_x(x, tile * kWarps + warp, batch, d0, lane, x0, x1);\n  cp_async_wait_all();\n"
     "  __syncthreads();\n"),
    *[(f"layer {j}", "        w = bias + round4(dout);\n", f"if (j == {j}) return;")
      for j in range(3)],
    ("layer 3 (y not stored)",
     {"void put(float* p, float v) { *p = v; }":
      "void put(float* p, float v) { if (reinterpret_cast<std::uintptr_t>(p) == 1) *p = v; }"}),
    ("y out: the whole kernel", None),
]
# which source each --kernel reads, and its designs, newest first
KERNELS = {
    "res": ("in_chain_bwd", ("res_block_bwd_kernel", "in_chain_bwd_kernel")),
    "res_fwd": ("in_chain", ("res_block_kernel", "in_chain_kernel")),
    "tail": ("sln_chain_bwd", ("tail_bwd_kernel", "sln_chain_bwd_kernel")),
    "chain": ("in_chain_bwd", ("down_chain_bwd_kernel", "in_chain_bwd_kernel")),
    "mlp": ("mlp_chain_bwd", ("small_kernel", "mlp_bwd_chain_kernel")),
    "res2d": ("res_block_2d", ("res2d_tc_kernel", "res_block_2d_kernel")),
    "res2d_bwd": ("res_block_2d_bwd", ("res2d_bwd_tc_kernel",)),
    "res2d_bf16": ("res_block_2d_bf16", ("res2d_bf16_wgmma_kernel",)),
    "res2d_bf16_bwd": ("res_block_2d_bf16_bwd", ("res2d_bf16_bwd_wgmma_kernel",)),
    "mlp_fwd": ("mlp_chain", ("mlp_cluster_kernel", "mlp_chain_kernel")),
    "sln_fwd": ("sln_chain", ("tail_fwd_kernel", "sln_chain_kernel")),
    "cba_bwd": ("conv_bias_act_bwd", ("cba_site_bwd_kernel", "conv_bias_act_bwd_kernel")),
    "chain_fwd": ("in_chain", ("down_chain_kernel", "in_chain_kernel")),
    "cba_fwd": ("in_chain", ("cba_fwd_kernel", "conv_bias_act_kernel")),
    "mlp_head": ("mlp_chain", ("mlp_head_kernel", "mlp_chain_kernel")),
}


def variants(src: str, kernel: str) -> tuple[str, list[tuple[str, str]]]:
    """-> (the design's kernel name, [(phase, variant source)]). A cut without a statement of
    its own returns; a cut of several anchors stops after each; a cut given as a dict replaces
    each key's text by its value."""
    name = next((d for d in KERNELS[kernel][1] if re.search(rf"\b{d}\(", src)), None)
    if name is None:
        raise SystemExit(f"phase_times: no design of --kernel {kernel} in the source")
    out = []
    for phase, anchor, *stop in CUTS[name]:
        text = src
        if isinstance(anchor, dict):
            for old, new in anchor.items():
                if text.count(old) != 1:
                    raise SystemExit(f"phase_times: {old!r} is not in the source once")
                text = text.replace(old, new)
            out.append((phase, text))
            continue
        for a in (() if anchor is None else anchor if isinstance(anchor, tuple) else (anchor,)):
            if text.count(a) != 1:
                raise SystemExit(f"phase_times: the cut after {phase!r} is not in the source once")
            j = text.index(a) + len(a)
            text = text[:j] + f"{stop[0] if stop else 'return;'}  // phase_times\n" + text[j:]
        out.append((phase, text))
    return name, out


def kernel_split(fn, calls: int = 20) -> dict[str, float]:
    """Device time a call of each kernel launch that ``fn`` makes, in us, from a torch.profiler
    trace of ``calls`` calls after a warm-up: "<i> <name>" for the i-th launch of a call, names
    cut to 60 characters."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    per = len(events) // calls
    out = {}
    for i, e in enumerate(events[:per * calls]):
        key = f"{i % per} {e.name[:60]}"
        out[key] = out.get(key, 0.0) + (e.time_range.end - e.time_range.start) / calls
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="res")
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--out", type=Path, default=HERE / "build" / "phase_times.json")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    if not torch.cuda.is_available():
        print("phase_times: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line, device_ms
    from iinsvae_torch.models.vae import IInsVAE
    from iinsvae_torch.ops.kernels import _build, backward, fused

    torch.backends.cudnn.allow_tf32 = False
    lib = KERNELS[args.kernel][0]
    src = (tree / CSRC / f"{lib}.cu").read_text()
    kernel, vs = variants(src, args.kernel)
    out_dir = HERE / "build" / "phases" / tree.name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (phase, text) in enumerate(vs):
        cu = out_dir / f"{lib}_{i}.cu"
        cu.write_text(text)
        so = out_dir / f"{lib}_{i}.so"
        procs.append((so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(tree / CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"phase_times: nvcc {so.name} failed:\n{log}")

    model = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                    generator=torch.Generator().manual_seed(0)).cuda()
    re_, dec = model.encoder.range_encoder, model.decoder.decoder
    gen = torch.Generator().manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    b = 500
    if args.kernel == "chain":
        re_ = model.encoder.range_encoder
        st = [(re_.in_kernel, 1, 3, "reflect")] + [
            (getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)]
        sites = {}
        for name, (l, c, first, n, need_dx) in {
                "range.pair0": (128, 1, 0, 2, False), "range.pair1": (64, 8, 2, 2, True),
                "range.single": (16, 32, 4, 1, True)}.items():
            stages = st[first:first + n]
            x = rand(b, l, c)
            with torch.no_grad():
                y = fused.in_chain(x, stages)
            g = rand(*y.shape)
            sites[name] = (lambda g=g, x=x, stages=stages, need_dx=need_dx:
                           backward.in_chain_bwd(g, x, stages, need_dx=need_dx))
    elif args.kernel == "chain_fwd":
        st = [(re_.in_kernel, 1, 3, "reflect")] + [
            (getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)]
        sites = {}
        for name, (l, c, first, n) in {"range.pair0": (128, 1, 0, 2),
                                       "range.pair1": (64, 8, 2, 2),
                                       "range.single": (16, 32, 4, 1)}.items():
            x = rand(b, l, c)
            sites[name] = lambda x=x, stages=st[first:first + n]: fused.in_chain(x, stages)
    elif args.kernel == "cba_bwd":
        ee = model.encoder.env_encoder.ConvINAct_0
        sites = {}
        for name, (l, c, taps, bias, pad, mode, need_dx) in {
                "range.out": (8, 64, re_.out_kernel, re_.out_bias, 0, "zero", True),
                "env.in": (128, 1, ee.kernel, ee.bias, 3, "reflect", False),
                "dec.in": (8, 2, dec.in_kernel, dec.in_bias, 0, "zero", True)}.items():
            x = rand(b, l, c)
            with torch.no_grad():
                y = fused.conv_bias_act(x, taps, bias, padding=pad, pad_mode=mode)
            g = rand(*y.shape)
            sites[name] = (lambda g=g, x=x, t=taps, bi=bias, y=y, p=pad, m=mode, d=need_dx:
                           backward.conv_bias_act_bwd(g, x, t, bi, y, padding=p, pad_mode=m,
                                                      need_dx=d))
    elif args.kernel == "cba_fwd":
        ee = model.encoder.env_encoder.ConvINAct_0
        sites = {}
        for name, (l, c, taps, bias, pad, mode) in {
                "range.out": (8, 64, re_.out_kernel, re_.out_bias, 0, "zero"),
                "env.in": (128, 1, ee.kernel, ee.bias, 3, "reflect"),
                "dec.in": (8, 2, dec.in_kernel, dec.in_bias, 0, "zero")}.items():
            x = rand(b, l, c)
            sites[name] = (lambda x=x, t=taps, bi=bias, p=pad, m=mode:
                           fused.conv_bias_act(x, t, bi, padding=p, pad_mode=m))
    elif args.kernel == "mlp_head":
        head = model.classifier.classifier
        n = len(head.slopes)
        ws = [getattr(head, f"w{j}") for j in range(n)]
        bs = [getattr(head, f"b{j}") for j in range(n)]
        x = rand(b, ws[0].shape[0])
        sites = {"classifier": lambda: fused.mlp_chain(x, ws, bs, head.slopes)}
    elif args.kernel == "mlp":
        model_2d = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
        sites = {}
        for name, head in (("restorer", model.restorer.restorer),
                           ("classifier", model.classifier.classifier),
                           ("restorer.2d", model_2d.restorer.restorer)):
            n = len(head.slopes)
            ws = [getattr(head, f"w{j}") for j in range(n)]
            bs = [getattr(head, f"b{j}") for j in range(n)]
            x = rand(b, ws[0].shape[0])
            with torch.no_grad():
                _, ds = fused.launch_mlp_chain(x, ws, bs, head.slopes, save_pre=True)
            g = rand(b, ws[-1].shape[1])
            sites[name] = (lambda g=g, x=x, ws=ws, bs=bs, sl=head.slopes, ds=ds:
                           backward.mlp_chain_bwd(g, x, ws, bs, sl, ds))
    elif args.kernel == "mlp_fwd":
        model_2d = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
        sites = {}
        for name, head in (("restorer", model.restorer.restorer),
                           ("restorer.2d", model_2d.restorer.restorer)):  # the classifier: mlp_head
            n = len(head.slopes)
            ws = [getattr(head, f"w{j}") for j in range(n)]
            bs = [getattr(head, f"b{j}") for j in range(n)]
            x = rand(b, ws[0].shape[0])
            sites[name] = (lambda x=x, ws=ws, bs=bs, sl=head.slopes:
                           fused.mlp_chain(x, ws, bs, sl))
    elif args.kernel == "res_fwd":
        x = rand(b, 8, 64)
        block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
        tables = [rand(b, 64) for _ in range(4)]
        sites = {
            "range.res": lambda: fused.in_chain(x, block, residual=True),
            "dec.res": lambda: fused.adain_res_block(x, dec.res0_kernel1, dec.res0_kernel2,
                                                     *tables),
        }
    elif args.kernel == "res2d":
        from iinsvae_torch.ops.kernels import res2d

        model_2d = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
        sites = {}
        for name, mod, tables in (("range.res2d", model_2d.encoder.range_encoder, []),
                                  ("dec.res2d", model_2d.decoder.decoder,
                                   [rand(b, 64) for _ in range(4)])):
            x, k1, k2 = rand(b, 8, 8, 64), mod.res0_kernel1, mod.res0_kernel2
            sites[name] = (lambda x=x, k1=k1, k2=k2, t=tables: res2d.res_block_2d(x, k1, k2, *t))
    elif args.kernel in ("res2d_bf16", "res2d_bf16_bwd"):
        from iinsvae_torch.ops.kernels import res2d

        model_2d = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
        sites = {}
        for name, mod, n_tables in (("range.res2d", model_2d.encoder.range_encoder, 0),
                                    ("dec.res2d", model_2d.decoder.decoder, 4)):
            x, g = (rand(b, 8, 8, 64).to(torch.bfloat16) for _ in range(2))
            k1, k2 = (mod.res0_kernel1.detach().to(torch.bfloat16),
                      mod.res0_kernel2.detach().to(torch.bfloat16))
            tables = [rand(b, 64).to(torch.bfloat16) for _ in range(n_tables)]
            if args.kernel == "res2d_bf16":
                sites[name] = (lambda x=x, k1=k1, k2=k2, t=tables:
                               res2d.launch_res_block_2d(x, k1, k2, *t))
                continue
            with torch.no_grad():
                _, d1, d2 = res2d.launch_res_block_2d(x, k1, k2, *tables, save=True)
            sites[name] = (lambda g=g, x=x, k1=k1, k2=k2, t=tables, s=(d1, d2):
                           backward.res_block_2d_bwd(g, x, k1, k2, *t, saved=s))
    elif args.kernel == "res2d_bwd":
        from iinsvae_torch.ops.kernels import res2d

        model_2d = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                           generator=torch.Generator().manual_seed(0)).cuda()
        sites = {}
        for name, mod, tables in (("range.res2d", model_2d.encoder.range_encoder, []),
                                  ("dec.res2d", model_2d.decoder.decoder,
                                   [rand(b, 64) for _ in range(4)])):
            x, g, k1, k2 = rand(b, 8, 8, 64), rand(b, 8, 8, 64), mod.res0_kernel1, mod.res0_kernel2
            with torch.no_grad():
                _, d1, d2 = res2d.launch_res_block_2d(x, k1, k2, *tables, save=True)
            sites[name] = (lambda g=g, x=x, k1=k1, k2=k2, t=tables, s=(d1, d2):
                           backward.res_block_2d_bwd(g, x, k1, k2, *t, saved=s))
    elif args.kernel == "res":
        x, g = rand(b, 8, 64), rand(b, 8, 64)
        block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
        tables = [rand(b, 64) for _ in range(4)]
        sites = {
            "range.res": lambda: backward.in_chain_bwd(g, x, block, residual=True),
            "dec.res": lambda: backward.adain_res_block_bwd(g, x, dec.res0_kernel1,
                                                            dec.res0_kernel2, *tables),
        }
    else:
        x, g = rand(b, 8, 64), rand(b, 157)
        up = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
              for j in range(4)]
        if args.kernel == "sln_fwd":
            sites = {"dec.tail": lambda: fused.sln_chain(x, up, dec.out_kernel, dec.out_bias,
                                                         157)}
        else:
            sites = {"dec.tail": lambda: backward.sln_chain_bwd(g, x, up, dec.out_kernel,
                                                                 dec.out_bias, 157)}
    rows = []
    with torch.no_grad():
        for (phase, _), (so, _) in zip(vs, procs):
            _build._fns.clear()
            _build._libs[lib] = ctypes.CDLL(str(so))
            rows.append(dict(phase=phase, **{f"{k}_ms": device_ms(f) for k, f in sites.items()}))
            print(f"[phase] {phase:<42} " + "  ".join(
                f"{k} {rows[-1][f'{k}_ms'] * 1e3:8.2f} us" for k in sites), flush=True)
        split = {k: kernel_split(f) for k, f in sites.items()}  # the whole kernel, last built
    for k, ops in split.items():
        print(f"[split] {k}: " + ", ".join(f"{n} {us:.2f} us" for n, us in ops.items()),
              flush=True)
    res = dict(card=card_line(), torch=torch.__version__, tree=str(tree), kernel=kernel,
               batch=b, phases=rows, device_us_by_kernel=split)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
