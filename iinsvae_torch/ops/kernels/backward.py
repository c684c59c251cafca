"""Backward wrappers of K1-K10 and their plain versions.

Seven CUDA sources compute the gradients of the ten forward wrappers:

  K1b csrc/in_chain_bwd.cu        in_chain_bwd, adain_res_block_bwd and (K8b)
                                  adain_layer_bwd (kAdain instances); its residual
                                  blocks and range chains run paths of their own
  K2b csrc/conv_bias_act_bwd.cu   conv_bias_act_bwd
  K3b csrc/strided_conv_bwd.cu    strided_conv_bwd
  K4b csrc/mlp_chain_bwd.cu       mlp_chain_bwd
  K6b csrc/sln_chain_bwd.cu       sln_chain_bwd
  K7b csrc/res_block_2d_bwd.cu    res_block_2d_bwd (IN and AdaIN)
  K9b, K10b csrc/sln_layer_bwd.cu sln_layer_bwd, tanh_pool_bwd

Each wrapper takes the upstream gradient ``g`` and the forward's inputs
(K2b and K3b also the forward's output, for the ReLU mask; K4b the
pre-activations K4 saved; K7b the pre-norm conv outputs K7 saved) and
returns the gradients of those inputs: the input's (None without
``need_dx``), then the parameters' in the forward's argument order. On CPU
tensors it returns its plain version's (``*_bwd_ref``, autograd through
the forward's ``*_ref``, on any device); on CUDA tensors it launches its kernel and counts the launch in
``<wrapper>.launches`` (one launch = one call: the kernel, for K4b's restorers one a layer
and the weight gradient's, and the in-order reduction of the per-block weight-gradient
partials). Weight gradients are summed without atomics, so two runs give bit-equal gradients.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from iinsvae_torch.ops.conv import reflect_pad2d
from iinsvae_torch.ops.kernels import _build, fused, res2d, strided_conv
from iinsvae_torch.ops.kernels.fused import (CBA_SITES, DOWN_SITES, DOWN_TILE, RES_C, RES_L,
                                             RES_STAGE, SLN_STAGES, Stage, UpStage, _round4,
                                             down_chain_plan, res_fwd_plan)
from iinsvae_torch.ops.norms import EPS, adain, instance_norm

_P = ctypes.c_void_p
_I = ctypes.c_int


def plain_grads(fn: Callable, inputs: Sequence[torch.Tensor], g: torch.Tensor):
    """Gradients of ``fn(*inputs)`` against ``g`` for every input, by
    autograd through the plain ops (fresh leaves: the caller's tensors keep
    their flags)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(fn(*leaves), leaves, g)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _split(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    out, i = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        out.append(flat[i:i + n].view(shape))
        i += n
    return out


# --------------------------- K1b: K1 and K5 ---------------------------


# K1b's and K5b's residual-block path (csrc/in_chain_bwd.cu, namespace res), at the model's
# residual blocks (L, C) = (8, 64), both convs k3, stride 1, reflect pad 1: tiles of RES_TILE
# samples, at most one persistent block a SM, RES_SMEM bytes of shared memory a block (both
# convs' taps, rows of RES_C + 4 floats, and the tile's buffers), as the source lays them out.
RES_TILE = 4
RES_SMEM = 4 * (RES_C + 4) * (2 * 3 * RES_C + RES_TILE * (2 * (RES_L + 2) + 3 * RES_L))


def chain_floats(rows: Sequence[int]) -> int:
    """Floats of shared memory a sample takes on K1b's general path, for 1 or 2 stage rows
    (k, stride, pad, reflect, l_in, c_in, l_out, c_out): its input (rounded up to 4), each
    stage's conv output and, with two stages, the mid-chain activation."""
    n1 = rows[6] * rows[7]
    return _round4(rows[4] * rows[5]) + n1 + (n1 + rows[14] * rows[15] if len(rows) > 8 else 0)


def res_block_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of the residual-block path: block j of the grid takes tiles j,
    j + blocks, ..., tile t the samples t * RES_TILE .. (t + 1) * RES_TILE - 1 below batch."""
    tiles = -(-batch // RES_TILE)
    return tiles, min(tiles, sms)


# K1's and K5's forward at the residual blocks (csrc/in_chain.cu, namespace res): tiles of 4
# samples, or of 2 where tiles of 4 would leave more than half the SMs without one
# (fused.res_fwd_plan); at most one persistent block a SM; RES_FWD_SMEM[tile] bytes of shared memory a block (both convs' taps,
# unpadded; x and the mid-block activation with their halo rows, and the conv output, in rows of
# RES_C + 4 floats; four 8-byte mbarriers), as the source lays them out.
RES_FWD_SMEM = {t: 4 * (6 * RES_C * RES_C + t * (3 * RES_L + 4) * (RES_C + 4) + 8)
                for t in (2, 4)}


# K1b's path at the range encoder's stride-2 chains (csrc/in_chain_bwd.cu, namespace down; the
# sites fused.DOWN_SITES, the grid fused.down_chain_plan): DOWN_SMEM[site] bytes of shared memory
# a block, as the source lays them out. range.pair0's first stage reads the pooled CIR (reflect
# pad): that path computes no dx there.


def down_floats(rows: Sequence[int]) -> int:
    """Floats of shared memory a block of the stride-2 chains' path takes for 1 or 2 stage rows:
    each stage's taps (rows of C_out + 4 floats) and, where it computes its input gradient, the
    taps transposed (rows of C_in + 4); per sample of a tile, each stage's input with its pad
    rows (rows of C_in + 4 floats, or C_in where that is not a multiple of 4), its conv output
    with a zero row each side (rows of C_out + 4) and, at a second stage, its input's gradient."""
    n = 0
    for j in range(0, len(rows), 8):
        k, _, pad, reflect, l_in, c_in, l_out, c_out = rows[j:j + 8]
        ld_in = c_in if c_in % 4 else c_in + 4
        n += k * c_in * (c_out + 4) + (0 if reflect else k * c_out * (c_in + 4))
        n += DOWN_TILE * ((l_in + 2 * pad) * ld_in + (l_out + 2) * (c_out + 4)
                          + (l_in * (c_in + 4) if j else 0))
    return n


DOWN_SMEM = {name: 4 * down_floats(rows) for name, rows in DOWN_SITES.items()}


def _down_chain_bwd(g: torch.Tensor, x: torch.Tensor, taps, name: str, need_dx: bool):
    """Launch the stride-2 chains' path at site ``name``; -> (dx or None, [d(taps)])."""
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, blocks = down_chain_plan(b, sms)
    n_w = sum(t.numel() for t in taps)
    part = torch.empty((blocks, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("in_chain_bwd", "iins_down_chain_bwd", [_P] * 7 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps[0].data_ptr(), taps[-1].data_ptr(), g.data_ptr(), _ptr(dx),
             part.data_ptr(), dw.data_ptr(), b, list(DOWN_SITES).index(name), DOWN_TILE, blocks,
             DOWN_SMEM[name], _build.stream_handle(x))
    _build.check(err, "in_chain_bwd", "in_chain_bwd")
    return dx, _split(dw, [t.shape for t in taps])


def _res_block_bwd(what: str, g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor,
                   k2: torch.Tensor, tables, need_dx: bool):
    """Launch the residual-block path: K1b's (tables None) or K5b's (tables g1, b1, g2); ->
    (dx or None, [dk1, dk2], the (4, B, C) affine gradients or None)."""
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, blocks = res_block_plan(b, sms)
    n_w = k1.numel() + k2.numel()
    part = torch.empty((blocks, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    affine = torch.empty((4, b, RES_C), device=x.device, dtype=x.dtype) if tables else None
    fn = _build.function("in_chain_bwd", "iins_res_block_bwd", [_P] * 14 + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), k1.data_ptr(), k2.data_ptr(),
             *((t.data_ptr() for t in tables) if tables else (None,) * 3), g.data_ptr(),
             _ptr(dx), part.data_ptr(), dw.data_ptr(),
             *((a.data_ptr() for a in affine) if tables else (None,) * 4), b, RES_L, RES_C,
             RES_TILE, blocks, RES_SMEM, _build.stream_handle(x))
    _build.check(err, "in_chain_bwd", what)
    return dx, _split(dw, [k1.shape, k2.shape]), affine


def in_chain_bwd_ref(g: torch.Tensor, x: torch.Tensor, stages: Sequence[Stage], *,
                     residual: bool = False, need_dx: bool = True):
    """Plain version of K1b."""
    spec = [s[1:] for s in stages]
    dx, *dtaps = plain_grads(
        lambda x_, *t: fused.in_chain_ref(x_, [(ti, *si) for ti, si in zip(t, spec)],
                                          residual=residual),
        [x, *(s[0] for s in stages)], g)
    return (dx if need_dx else None), list(dtaps)


def in_chain_bwd(g: torch.Tensor, x: torch.Tensor, stages: Sequence[Stage], *,
                 residual: bool = False, need_dx: bool = True):
    """K1b: -> (dx, [d(taps) per stage]) of fused.in_chain. The residual block at (8, 64)
    runs the residual-block path, the range encoder's stride-2 chains (DOWN_SITES; range.pair0
    without dx) theirs, any other chain the general kernel."""
    if g.device.type == "cpu":
        return in_chain_bwd_ref(g, x, stages, residual=residual, need_dx=need_dx)
    if not 1 <= len(stages) <= 2:
        raise ValueError(f"in_chain_bwd runs 1 or 2 stages, got {len(stages)}")
    rows, l_out, c_out = fused.stage_rows(x, stages)
    b = x.shape[0]
    if g.shape != (b, l_out, c_out):
        raise ValueError(f"g must be {(b, l_out, c_out)}, got {tuple(g.shape)}")
    if residual and (len(stages) != 2 or (l_out, c_out) != tuple(x.shape[1:])):
        raise ValueError("a residual chain has two stages and keeps the input's shape")
    taps = [s[0] for s in stages]
    if any(t.shape[2] % 4 or t.data_ptr() % 16 for t in taps):
        raise ValueError("in_chain_bwd takes 16-byte aligned taps with C_out a multiple of 4")
    _build.require_cuda_f32("in_chain_bwd", g, x, *taps)
    if residual and rows == 2 * RES_STAGE:
        dx, dtaps, _ = _res_block_bwd("in_chain_bwd", g, x, *taps, None, need_dx)
        in_chain_bwd.launches += 1
        return dx, dtaps
    down = fused.down_site(rows)
    if not residual and down is not None and not (need_dx and rows[3]):
        dx, dtaps = _down_chain_bwd(g, x, taps, down, need_dx)
        in_chain_bwd.launches += 1
        return dx, dtaps
    spb = _build.samples_per_block(b, chain_floats(rows))
    n_w = sum(t.numel() for t in taps)
    part = torch.empty(((b + spb - 1) // spb, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("in_chain_bwd", "iins_in_chain_bwd",
                         [_P, _P, _P, _P, _P, _P, _P, _I, ctypes.POINTER(_I), _I, _I, _I, _P])
    err = fn(x.data_ptr(), taps[0].data_ptr(), taps[-1].data_ptr(), g.data_ptr(), _ptr(dx),
             part.data_ptr(), dw.data_ptr(), b, (_I * len(rows))(*rows), len(stages),
             int(residual), spb, _build.stream_handle(x))
    _build.check(err, "in_chain_bwd", "in_chain_bwd")
    in_chain_bwd.launches += 1
    return dx, _split(dw, [t.shape for t in taps])


in_chain_bwd.launches = 0


def adain_res_block_bwd_ref(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor,
                            k2: torch.Tensor, g1: torch.Tensor, b1: torch.Tensor,
                            g2: torch.Tensor, b2: torch.Tensor, *, need_dx: bool = True):
    """Plain version of K1b's kAdain instance."""
    dx, *rest = plain_grads(fused.adain_res_block_ref, [x, k1, k2, g1, b1, g2, b2], g)
    return ((dx if need_dx else None), *rest)


def adain_res_block_bwd(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                        g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor, b2: torch.Tensor,
                        *, need_dx: bool = True):
    """K1b (kAdain): -> (dx, dk1, dk2, dg1, db1, dg2, db2) of
    fused.adain_res_block; the four affine gradients are (B, C) tables."""
    if g.device.type == "cpu":
        return adain_res_block_bwd_ref(g, x, k1, k2, g1, b1, g2, b2, need_dx=need_dx)
    fused.check_adain_res_block(x, k1, k2, g1, b1, g2, b2)
    if g.shape != x.shape:
        raise ValueError(f"g must be {tuple(x.shape)}, got {tuple(g.shape)}")
    _build.require_cuda_f32("adain_res_block_bwd", g)
    b, l, c = x.shape
    if (l, c) == (RES_L, RES_C):
        dx, (dk1, dk2), affine = _res_block_bwd("adain_res_block_bwd", g, x, k1, k2,
                                                (g1, b1, g2), need_dx)
        adain_res_block_bwd.launches += 1
        return (dx, dk1, dk2, *affine)
    spb = _build.samples_per_block(b, chain_floats([3, 1, 1, 1, l, c, l, c] * 2))
    part = torch.empty(((b + spb - 1) // spb, 2 * k1.numel()), device=x.device, dtype=x.dtype)
    dw = torch.empty(2 * k1.numel(), device=x.device, dtype=x.dtype)
    affine = torch.empty((4, b, c), device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("in_chain_bwd", "iins_adain_res_block_bwd",
                         [_P] * 14 + [_I, _I, _I, _I, _P])
    err = fn(x.data_ptr(), k1.data_ptr(), k2.data_ptr(), g1.data_ptr(), b1.data_ptr(),
             g2.data_ptr(), g.data_ptr(), _ptr(dx), part.data_ptr(), dw.data_ptr(),
             *(a.data_ptr() for a in affine), b, l, c, spb, _build.stream_handle(x))
    _build.check(err, "in_chain_bwd", "adain_res_block_bwd")
    adain_res_block_bwd.launches += 1
    dk1, dk2 = _split(dw, [k1.shape, k2.shape])
    return (dx, dk1, dk2, *affine)


adain_res_block_bwd.launches = 0


# ------------------------------ K2b and K3b ------------------------------


# K2b's path at its three call sites in a 1-D training step (csrc/conv_bias_act_bwd.cu,
# namespace site), by their stage rows (fused.CBA_SITES, which K2's forward shares): the range
# encoder's 1x1 out-conv, the env encoder's k7 reflect in-conv (no dx: it reads the pooled CIR)
# and the decoder's 1x1 in-conv. Tiles of CBA_TILE samples, at most one persistent block a SM
# (cba_bwd_plan), CBA_SMEM[site] bytes of shared memory a block (two tile buffers) and a partial
# row of CBA_ROW[site] floats a block, as the source lays them out.
CBA_TILE = 4


def cba_site(rows: Sequence[int], need_dx: bool) -> str | None:
    """The call site whose stage row this is, where its path computes what is asked, or None
    (the general kernel): env.in's path computes no dx."""
    site = fused.cba_site(rows)
    return None if site is None or (need_dx and rows[3]) else site


def cba_floats(rows: Sequence[int]) -> int:
    """Floats of shared memory a block of K2b's site path takes for a stage row: two buffers of
    a tile, each sample's x with its pad rows (the data rows 16-byte aligned, the sample rounded
    up to 4 floats), g (masked into gz in place) and y."""
    _, _, pad, _, l_in, c_in, l_out, c_out = rows
    xa = _round4(pad * c_in)
    return 2 * CBA_TILE * (_round4(xa + (l_in + pad) * c_in) + 2 * l_out * c_out)


CBA_SMEM = {name: 4 * cba_floats(rows) for name, rows in CBA_SITES.items()}
CBA_ROW = {name: _round4(r[0] * r[5] * r[7] + r[7]) for name, r in CBA_SITES.items()}


def cba_bwd_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of K2b's site path: block j of the grid takes tiles j, j + blocks, ...,
    tile t the samples t * CBA_TILE .. (t + 1) * CBA_TILE - 1 below batch."""
    tiles = -(-batch // CBA_TILE)
    return tiles, min(tiles, sms)


def _cba_site_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, y: torch.Tensor,
                  name: str, need_dx: bool):
    """Launch K2b's site path at ``name``; -> (dx or None, d(taps), dbias)."""
    if any(t.data_ptr() % 16 for t in (g, x, taps, y)):
        raise ValueError("conv_bias_act_bwd: the call sites' kernel takes 16-byte aligned x, "
                         "taps, y and g")
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    _, blocks = cba_bwd_plan(b, sms)
    c_out = taps.shape[2]
    part = torch.empty((blocks, CBA_ROW[name]), device=x.device, dtype=x.dtype)
    dw = torch.empty(taps.numel() + c_out, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("conv_bias_act_bwd", "iins_cba_site_bwd", [_P] * 7 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), g.data_ptr(), _ptr(dx),
             part.data_ptr(), dw.data_ptr(), b, list(CBA_SITES).index(name), CBA_TILE, blocks,
             CBA_SMEM[name], _build.stream_handle(x))
    _build.check(err, "conv_bias_act_bwd", "conv_bias_act_bwd")
    dtaps, dbias = _split(dw, [taps.shape, (c_out,)])
    return dx, dtaps, dbias


def conv_bias_act_bwd_ref(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                          bias: torch.Tensor, y: torch.Tensor, *, stride: int = 1,
                          padding: int = 0, pad_mode: str = "zero", need_dx: bool = True):
    """Plain version of K2b (y, the forward's output, is not read)."""
    dx, dt, db = plain_grads(
        lambda x_, t_, b_: fused.conv_bias_act_ref(x_, t_, b_, stride=stride, padding=padding,
                                                   pad_mode=pad_mode),
        [x, taps, bias], g)
    return (dx if need_dx else None), dt, db


def conv_bias_act_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                      bias: torch.Tensor, y: torch.Tensor, *, stride: int = 1,
                      padding: int = 0, pad_mode: str = "zero", need_dx: bool = True,
                      general: bool = False):
    """K2b: -> (dx, d(taps), dbias) of fused.conv_bias_act, whose output was y. Its three call
    sites in a 1-D training step (CBA_SITES; env.in without dx) run their own path, any other
    conv the general kernel; ``general`` runs the general kernel there too, the GPU tests'
    second oracle."""
    if g.device.type == "cpu":
        return conv_bias_act_bwd_ref(g, x, taps, bias, y, stride=stride, padding=padding,
                                     pad_mode=pad_mode, need_dx=need_dx)
    rows, l_out, c_out = fused.stage_rows(x, [(taps, stride, padding, pad_mode)])
    b = x.shape[0]
    if bias.shape != (c_out,) or g.shape != (b, l_out, c_out) or y.shape != g.shape:
        raise ValueError(f"conv_bias_act_bwd: bias must be ({c_out},), g and y "
                         f"{(b, l_out, c_out)}")
    _build.require_cuda_f32("conv_bias_act_bwd", g, x, taps, bias, y)
    site = None if general else cba_site(rows, need_dx)
    if site is not None:
        dx, dtaps, dbias = _cba_site_bwd(g, x, taps, y, site, need_dx)
        conv_bias_act_bwd.launches += 1
        return dx, dtaps, dbias
    spb = _build.samples_per_block(b, _round4(rows[4] * rows[5]) + l_out * c_out)
    n_w = taps.numel() + c_out
    part = torch.empty(((b + spb - 1) // spb, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("conv_bias_act_bwd", "iins_conv_bias_act_bwd",
                         [_P] * 7 + [_I, ctypes.POINTER(_I), _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), g.data_ptr(), _ptr(dx),
             part.data_ptr(), dw.data_ptr(), b, (_I * 8)(*rows), spb, _build.stream_handle(x))
    _build.check(err, "conv_bias_act_bwd", "conv_bias_act_bwd")
    conv_bias_act_bwd.launches += 1
    dtaps, dbias = _split(dw, [taps.shape, bias.shape])
    return dx, dtaps, dbias


conv_bias_act_bwd.launches = 0


def strided_conv_bwd_ref(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                         bias: torch.Tensor, y: torch.Tensor, *, need_dx: bool = True):
    """Plain version of K3's backward (y is not read)."""
    dx, dt, db = plain_grads(strided_conv.strided_conv_ref, [x, taps, bias], g)
    return (dx if need_dx else None), dt, db


def strided_conv_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                     y: torch.Tensor, *, need_dx: bool = True):
    """K3b: -> (dx, d(taps), dbias) of strided_conv.strided_conv, whose
    output was y."""
    if g.device.type == "cpu":
        return strided_conv_bwd_ref(g, x, taps, bias, y, need_dx=need_dx)
    b, l_in, c_in, c_out = strided_conv.check_operands("strided_conv_bwd", "strided_conv_bwd",
                                                       x, taps, bias, g, y)
    if g.shape != (b, l_in // 2, c_out) or y.shape != g.shape:
        raise ValueError(f"strided_conv_bwd: g and y must be {(b, l_in // 2, c_out)}, got "
                         f"{tuple(g.shape)} and {tuple(y.shape)}")
    n_w = taps.numel() + c_out
    # at most one block a SM, each writing one partial row
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    part = torch.empty((sms, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("strided_conv_bwd", "iins_strided_conv_bwd", [_P] * 7 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), y.data_ptr(), g.data_ptr(), _ptr(dx),
             part.data_ptr(), dw.data_ptr(), b, l_in, c_in, c_out, part.shape[0],
             _build.stream_handle(x))
    _build.check(err, "strided_conv_bwd", "strided_conv_bwd")
    strided_conv_bwd.launches += 1
    dtaps, dbias = _split(dw, [taps.shape, bias.shape])
    return dx, dtaps, dbias


strided_conv_bwd.launches = 0


# ------------------------------ K4b ------------------------------


# K4b's weight gradient sums the batch in chunks, each into its own partial row, then the rows
# in order (csrc/mlp_chain_bwd.cu): where every width is at most MLP_SMALL_WIDTH (the
# classifier) one block a tile of MLP_SMALL_ROWS samples runs the whole backward; else (the
# restorers) at least MLP_MIN_SPLIT chunks of at most MLP_CHUNK_ROWS samples.
MLP_SMALL_WIDTH, MLP_SMALL_ROWS, MLP_MIN_SPLIT, MLP_CHUNK_ROWS = 64, 8, 4, 128


def mlp_split_plan(batch: int, dims: Sequence[int]) -> list[tuple[int, int]]:
    """-> each chunk's [start, end) of the batch, as the kernel splits it for a chain of the
    widths ``dims`` (the last chunks may be short or empty)."""
    if max(dims) <= MLP_SMALL_WIDTH:
        per = MLP_SMALL_ROWS
        split = -(-batch // per)
    else:
        split = max(MLP_MIN_SPLIT, -(-batch // MLP_CHUNK_ROWS))
        per = -(-batch // split)
    return [(min(batch, c * per), min(batch, (c + 1) * per)) for c in range(split)]


def mlp_chain_bwd_ref(g: torch.Tensor, x: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor], slopes: Sequence[float],
                      ds: Sequence[torch.Tensor], *, need_dx: bool = True):
    """Plain version of K4b (recomputes the forward; ``ds`` is not read)."""
    n = len(ws)
    dx, *rest = plain_grads(lambda x_, *p: fused.mlp_chain_ref(x_, p[:n], p[n:], slopes),
                            [x, *ws, *bs], g)
    return (dx if need_dx else None), list(rest[:n]), list(rest[n:])


def mlp_chain_bwd_bf16_ref(g: torch.Tensor, x: torch.Tensor, ws: Sequence[torch.Tensor],
                           bs: Sequence[torch.Tensor], slopes: Sequence[float],
                           ds: Sequence[torch.Tensor], *, need_dx: bool = True):
    """Plain version of K4b's bfloat16 instance (fused.py:1087-1106): the layers' inputs
    recomputed from x and the bfloat16 d_j that K4 saved, g read as fp32, the chain's gradient
    in fp32 between layers; dx, each dW_j and db_j rounded to bfloat16 once."""
    n = len(ws)
    ys = [x.float()] + [torch.nn.functional.leaky_relu(d.float(), s) if s != 1.0 else d.float()
                        for d, s in zip(ds[:-1], slopes[:-1])]
    g = g.float()
    dws, dbs = [None] * n, [None] * n
    for j in range(n - 1, -1, -1):
        gd = g if slopes[j] == 1.0 else torch.where(ds[j].float() > 0, g, slopes[j] * g)
        dws[j] = (ys[j].T @ gd).to(torch.bfloat16)
        dbs[j] = gd.sum(dim=0).to(torch.bfloat16)
        g = gd @ ws[j].float().T
    return (g.to(torch.bfloat16) if need_dx else None), dws, dbs


def mlp_chain_bwd(g: torch.Tensor, x: torch.Tensor, ws: Sequence[torch.Tensor],
                  bs: Sequence[torch.Tensor], slopes: Sequence[float],
                  ds: Sequence[torch.Tensor], *, need_dx: bool = True):
    """K4b: -> (dx, [dW_j], [db_j]) of fused.mlp_chain; ``ds`` are the
    pre-activations d_j that K4 saved (fused.launch_mlp_chain(save_pre=True)). Where every
    width is at most MLP_SMALL_WIDTH one kernel a tile of samples runs the whole backward, else
    one kernel a layer and one for the weight gradient (csrc/mlp_chain_bwd.cu). bfloat16
    operands run the same kernels' bfloat16 instances (bfloat16 dx, dW_j, db_j), on the CPU
    mlp_chain_bwd_bf16_ref."""
    if g.device.type == "cpu":
        ref = mlp_chain_bwd_bf16_ref if x.dtype == torch.bfloat16 else mlp_chain_bwd_ref
        return ref(g, x, ws, bs, slopes, ds, need_dx=need_dx)
    n = len(ws)
    dims = [x.shape[1]] + [w.shape[1] for w in ws]
    if len(ds) != n or any(d.shape != (x.shape[0], k) for d, k in zip(ds, dims[1:])):
        raise ValueError("mlp_chain_bwd needs each layer's saved pre-activations (B, D_j+1)")
    if g.shape != (x.shape[0], dims[-1]) or any(w.shape != (a, k) for w, a, k in
                                                 zip(ws, dims, dims[1:])):
        raise ValueError(f"g must be ({x.shape[0]}, {dims[-1]}) and the weights follow "
                         f"the widths {dims}")
    _build.require_cuda("mlp_chain_bwd", x.dtype, g, x, *ws, *ds)
    bf16 = x.dtype == torch.bfloat16
    b = x.shape[0]
    # GD_j and the partial rows are fp32 in both instances
    gds = [torch.empty(d.shape, device=x.device, dtype=torch.float32) for d in ds] \
        if max(dims) > MLP_SMALL_WIDTH else []
    shapes = [(a + 1, k) for a, k in zip(dims, dims[1:])]
    total = sum(a * k for a, k in shapes)
    dwb = torch.empty(total, device=x.device, dtype=x.dtype)
    part = torch.empty((len(mlp_split_plan(b, dims)), total), device=x.device,
                       dtype=torch.float32)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("mlp_chain_bwd", "iins_mlp_chain_bwd" + ("_bf16" if bf16 else ""),
                         [_P, _P, _P, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                          ctypes.POINTER(_P), _P, _P, _I, ctypes.POINTER(_I),
                          ctypes.POINTER(ctypes.c_float), _P])

    def ptrs(ts):
        return (_P * max(1, len(ts)))(*[t.data_ptr() for t in ts])

    err = fn(g.data_ptr(), x.data_ptr(), _ptr(dx), b, n, ptrs(ws), ptrs(ds), ptrs(gds),
             dwb.data_ptr(), part.data_ptr(), part.shape[0], (_I * (n + 1))(*dims),
             (ctypes.c_float * n)(*slopes), _build.stream_handle(x))
    _build.check(err, "mlp_chain_bwd", "mlp_chain_bwd")
    if bf16:
        mlp_chain_bwd.launches_bf16 += 1
    else:
        mlp_chain_bwd.launches += 1
    if fused.takes_mlp_cluster(dims) and dims[-1] == 2:  # the soft restorer's widths
        fused.count_soft("mlp_chain_bwd", bf16)
    views = _split(dwb, shapes)
    return dx, [d[:-1] for d in views], [d[-1] for d in views]


mlp_chain_bwd.launches = 0
mlp_chain_bwd.launches_bf16 = 0  # the bfloat16 instance's launches


# ------------------------------ K6b ------------------------------


def sln_chain_bwd_ref(g: torch.Tensor, x: torch.Tensor, stages: Sequence[UpStage],
                      out_kernel: torch.Tensor, out_bias: torch.Tensor, l_pool: int, *,
                      need_dx: bool = True, pool: torch.Tensor | None = None):
    """Plain version of K6b; ``pool`` as for fused.sln_chain_ref."""
    params = [t for st in stages for t in st] + [out_kernel, out_bias]
    n = len(stages)
    dx, *rest = plain_grads(
        lambda x_, *p: fused.sln_chain_ref(x_, [tuple(p[4 * j:4 * j + 4]) for j in range(n)],
                                           p[-2], p[-1], l_pool, pool=pool),
        [x, *params], g)
    return ((dx if need_dx else None), [tuple(rest[4 * j:4 * j + 4]) for j in range(n)],
            rest[-2], rest[-1])


# K6b's path at the decoder's shape (csrc/sln_chain_bwd.cu, namespace tail): fused.sln_tail_plan's
# tiles and blocks, SLN_TAIL_SMEM bytes of shared memory a block: K6's forward's
# (fused.SLN_TAIL_FWD_SMEM), then the backward's, as the source lays them out.
SLN_TAIL_L, SLN_TAIL_C, SLN_TAIL_TILE = fused.SLN_TAIL_L, fused.SLN_TAIL_C, fused.SLN_TAIL_TILE
sln_tail_plan = fused.sln_tail_plan


def _sln_tail_floats() -> int:
    """Floats of shared memory a block of K6b's tail path takes, as the source lays them out."""
    # the out conv's gradient (128 + 4 a sample), per-warp sums (16 warps), the block's
    # per-channel gradients, the out conv's partials (128 threads x 29) and per-sample sums,
    # the block's d(taps) of stage 0
    last, c = SLN_TAIL_L << SLN_STAGES, SLN_TAIL_C
    gzo = SLN_TAIL_TILE * (last + 4)
    rest = 16 * 3 * 32 + 16 * 4 + SLN_STAGES * 3 * 32 + 32 + 128 * 29 + 128 + 5 * c * c // 2
    return fused.sln_tail_fwd_floats() + gzo + rest


SLN_TAIL_SMEM = 4 * _sln_tail_floats()


def sln_chain_bwd(g: torch.Tensor, x: torch.Tensor, stages: Sequence[UpStage],
                  out_kernel: torch.Tensor, out_bias: torch.Tensor, l_pool: int, *,
                  need_dx: bool = True):
    """K6b: -> (dx, [(d(taps), dbias, dgamma, dbeta) per stage], d(out_kernel),
    d(out_bias)) of fused.sln_chain. The decoder's shape, input (8, 64), runs the tail path
    (persistent blocks, sln_tail_plan); any other shape the general kernel."""
    if g.device.type == "cpu":
        return sln_chain_bwd_ref(g, x, stages, out_kernel, out_bias, l_pool, need_dx=need_dx)
    params = [t for st in stages for t in st] + [out_kernel, out_bias]
    fused.check_sln_chain(x, stages, out_kernel, out_bias, l_pool)
    b, l0, c0 = x.shape
    if g.shape != (b, l_pool):
        raise ValueError(f"g must be ({b}, {l_pool}), got {tuple(g.shape)}")
    _build.require_cuda_f32("sln_chain_bwd", g)
    n_w = sum(t.numel() for t in params)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    ptrs = [(_P * SLN_STAGES)(*[st[i].data_ptr() for st in stages]) for i in range(4)]
    head = [_P, _P, _P, _P, _P, _I] + [ctypes.POINTER(_P)] * 4 + [_I, _I, _P, _P, _I]
    if (l0, c0) == (SLN_TAIL_L, SLN_TAIL_C):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, blocks = sln_tail_plan(b, sms)
        part = torch.empty((blocks, n_w), device=x.device, dtype=x.dtype)
        fn = _build.function("sln_chain_bwd", "iins_sln_tail_bwd", head + [_I, _I, _I, _P])
        plan = (SLN_TAIL_TILE, blocks, SLN_TAIL_SMEM)
    else:
        # the general kernel: per sample the input, four stage outputs and four conv outputs,
        # the tanh output and the LayerNorm statistics, in the default 48 KB of shared memory
        l_last = l0 << SLN_STAGES
        spb = _build.samples_per_block(b, 9 * l0 * c0 + _round4(l_last) + 3 * SLN_STAGES)
        part = torch.empty(((b + spb - 1) // spb, n_w), device=x.device, dtype=x.dtype)
        fn = _build.function("sln_chain_bwd", "iins_sln_chain_bwd", head + [_I, _P])
        plan = (spb,)
    err = fn(x.data_ptr(), g.data_ptr(), _ptr(dx), part.data_ptr(), dw.data_ptr(), b, *ptrs,
             l0, c0, out_kernel.data_ptr(), out_bias.data_ptr(), l_pool, *plan,
             _build.stream_handle(x))
    _build.check(err, "sln_chain_bwd", "sln_chain_bwd")
    sln_chain_bwd.launches += 1
    grads = _split(dw, [t.shape for t in params])
    return dx, [tuple(grads[4 * j:4 * j + 4]) for j in range(len(stages))], grads[-2], grads[-1]


sln_chain_bwd.launches = 0


# ------------------------------ K7b ------------------------------


def res2d_bwd_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of K7b: tiles of res2d.SAMPLES_PER_BLOCK samples, block j of the
    persistent grid (at most one a SM) takes tiles j, j + blocks, ..., and owns row j of the
    weight-gradient partials."""
    tiles = -(-batch // res2d.SAMPLES_PER_BLOCK)
    return tiles, min(tiles, sms)


# blocks a cluster of K7b bf16's taps' gradient (kDkCluster of csrc/res_block_2d_bf16_bwd.cu)
RES2D_BF16_DK_CLUSTER = 4


_dk_slots: dict[int, int] = {}


def res2d_bf16_dk_slots(device: torch.device) -> int:
    """The clusters of K7b bf16's taps' gradient that the card holds at once, asked of the CUDA
    runtime once a device."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _dk_slots:
        n = ctypes.c_int(0)
        fn = _build.function("res_block_2d_bf16_bwd", "iins_res_block_2d_bf16_bwd_slots",
                             [ctypes.POINTER(_I)])
        with torch.cuda.device(key):
            _build.check(fn(ctypes.byref(n)), "res_block_2d_bf16_bwd",
                         "res_block_2d_bwd cluster occupancy")
        if n.value < 2:
            raise RuntimeError("res_block_2d_bwd: the card holds fewer than two clusters of the "
                               "bfloat16 taps' gradient")
        _dk_slots[key] = n.value
    return _dk_slots[key]


def res2d_bf16_bwd_plan(batch: int, sms: int, slots: int) -> tuple[int, int]:
    """-> (blocks, chunks) of K7b's bfloat16 instance: the input gradients' persistent grid of
    blocks of two warpgroups, one sample each at a time (at most one block a SM); and the taps'
    gradient's sample chunks a conv, a multiple of the cluster of 4, both convs' clusters at
    most the ``slots`` the card holds at once (more run in a second wave): block (conv, c) of
    its 2 x chunks sums the samples c, c + chunks, ..., and each cluster of 4 chunks writes one
    partial row."""
    n = RES2D_BF16_DK_CLUSTER
    return min(sms, -(-batch // 2)), n * max(1, min(slots // 2, -(-batch // n)))


def res2d_bf16_bwd_scratch(batch: int, chunks: int) -> int:
    """Floats of K7b bf16's scratch: 2 x chunks / 4 partial rows of 36,864 (each conv's
    d(taps), one a cluster), then gd1, gd2 and y1 of the batch in bfloat16, the taps'
    gradient's operands."""
    return 2 * (chunks // RES2D_BF16_DK_CLUSTER) * 9 * 64 * 64 + 3 * batch * 64 * 64 // 2


def res_block_2d_bwd_ref(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                         *affine: torch.Tensor, saved=None, need_dx: bool = True):
    """Plain version of K7b: autograd through the plain forward from x (``saved``, which the
    kernel reads, is taken and not read)."""
    dx, *rest = plain_grads(res2d.res_block_2d_ref, [x, k1, k2, *affine], g)
    return ((dx if need_dx else None), *rest)


def _in_grad(ga: torch.Tensor, d: torch.Tensor, gamma: torch.Tensor | None):
    """-> (gd, sum ga * xn, sum ga) for a = IN(d) [* gamma + beta], per (sample, channel) over
    the 8 x 8 pixels: gd = rstd * gamma * (ga - mean(ga) - xn * mean(ga * xn)), with the
    forward's two-pass statistics of d (gamma 1 for IN)."""
    dev = d - d.mean(dim=(1, 2), keepdim=True)
    rstd = torch.rsqrt((dev * dev).mean(dim=(1, 2), keepdim=True) + EPS)
    xn = dev * rstd
    sx, sa = (ga * xn).sum(dim=(1, 2)), ga.sum(dim=(1, 2))
    scale = rstd if gamma is None else rstd * gamma[:, None, None, :]
    n = d.shape[1] * d.shape[2]
    return scale * (ga - sa[:, None, None] / n - xn * sx[:, None, None] / n), sx, sa


def _taps_grad_2d(a: torch.Tensor, gd: torch.Tensor) -> torch.Tensor:
    """d(taps) (3, 3, C_in, C_out) of conv3x3(a, k), reflect pad 1, from its output's gradient:
    dk[dh, dw] = sum over samples and pixels of a's reflect-shifted window^T . gd."""
    ap, h, w = reflect_pad2d(a, 1), gd.shape[1], gd.shape[2]
    return torch.stack([torch.stack([torch.einsum("bhwi,bhwo->io", ap[:, i:i + h, j:j + w], gd)
                                     for j in range(3)]) for i in range(3)])


def _conv3x3_t(gd: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """conv3x3^T(gd, k): the gradient of a reflect-pad-1 3x3 conv's input from the gradient gd
    of its output. Each tap's product lands on the padded (H + 2, W + 2) grid; the border rows
    and columns are then folded onto the rows and columns they reflect (padded 0 onto 2,
    H + 1 onto H - 1), rows first."""
    b, h, w, _ = gd.shape
    gp = gd.new_zeros((b, h + 2, w + 2, k.shape[2]))
    for i in range(3):
        for j in range(3):
            gp[:, i:i + h, j:j + w] += gd @ k[i, j].T
    gp[:, 2] += gp[:, 0]
    gp[:, h - 1] += gp[:, h + 1]
    gp[:, :, 2] += gp[:, :, 0]
    gp[:, :, w - 1] += gp[:, :, w + 1]
    return gp[:, 1:h + 1, 1:w + 1]


def res_block_2d_bwd_closed(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor,
                            k2: torch.Tensor, *affine: torch.Tensor, saved,
                            need_dx: bool = True):
    """K7b's formulas in plain PyTorch, from g, x and ``saved`` = (d1, d2), the forward's
    pre-norm conv outputs, with no conv of the forward recomputed: gd2 from g and d2, y1 =
    relu(N1(d1)), dk2, dy1 = conv3x3^T(gd2, k2), ga1 = dy1 where y1 > 0, gd1, dk1, dx = g +
    conv3x3^T(gd1, k1). -> what res_block_2d_bwd returns."""
    d1, d2 = saved
    gam1, bet1, gam2 = affine[:3] if affine else (None, None, None)
    gd2, dg2, db2 = _in_grad(g, d2, gam2)
    y1 = torch.relu(adain(d1, gam1, bet1) if affine else instance_norm(d1))
    dk2 = _taps_grad_2d(y1, gd2)
    gd1, dg1, db1 = _in_grad(_conv3x3_t(gd2, k2) * (y1 > 0), d1, gam1)
    dk1 = _taps_grad_2d(x, gd1)
    dx = g + _conv3x3_t(gd1, k1) if need_dx else None
    return (dx, dk1, dk2, *((dg1, db1, dg2, db2) if affine else ()))


def _conv3x3_t_bf16(gd: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The adjoint of res2d.conv3x3_bf16 in fp32 (gd fp32 holding bfloat16 values, k
    bfloat16): _conv3x3_t without the W taps 0 and 2 at the output's edge columns, plus those
    columns' edge tap (res2d.edge_taps) into columns 1 and 6."""
    kf, f = k.float(), res2d.edge_taps(k).float()
    b, h, w, _ = gd.shape
    inner = gd.clone()
    inner[:, :, 0] = 0
    inner[:, :, w - 1] = 0
    gp = gd.new_zeros((b, h + 2, w + 2, k.shape[2]))
    for i in range(3):
        for j in range(3):
            gp[:, i:i + h, j:j + w] += (gd if j == 1 else inner) @ kf[i, j].T
        gp[:, i:i + h, 2] += gd[:, :, 0] @ f[i].T
        gp[:, i:i + h, w - 1] += gd[:, :, w - 1] @ f[i].T
    gp[:, 2] += gp[:, 0]
    gp[:, h - 1] += gp[:, h + 1]
    return gp[:, 1:h + 1, 1:w + 1]


def res_block_2d_bwd_bf16_ref(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor,
                              k2: torch.Tensor, *affine: torch.Tensor, saved,
                              need_dx: bool = True):
    """Plain version of K7b's bfloat16 instance (res2d.py:201-283) on bfloat16 operands, from
    the bfloat16 d1, d2 that K7 saved: the statistics are taken again, in fp32, from the
    rounded d1 and d2; gd2 and gd1 are rounded to bfloat16 before any product, and so are the
    products' other operands (y1, x; the taps are bfloat16); the products accumulate in fp32,
    dk over the whole batch, and every gradient is rounded to bfloat16 once. (The TPU kernel
    adds dk in bfloat16 across its grid's sample chunks, VMEM scaffolding: one chunk holds
    every batch up to 25 samples, where the two agree.)"""
    f32, bf16 = torch.float32, torch.bfloat16
    d1, d2 = (t.to(f32) for t in saved)
    gf, xf = g.to(f32), x.to(f32)
    gam1, bet1, gam2 = (t.to(f32) for t in affine[:3]) if affine else (None, None, None)
    gd2, dg2, db2 = _in_grad(gf, d2, gam2)
    gd2 = gd2.to(bf16).to(f32)
    a1 = adain(d1, gam1, bet1) if affine else instance_norm(d1)
    y1 = torch.relu(a1).to(bf16).to(f32)
    dk2 = _taps_grad_2d(y1, gd2)
    gd1, dg1, db1 = _in_grad(_conv3x3_t_bf16(gd2, k2) * (a1 > 0), d1, gam1)
    gd1 = gd1.to(bf16).to(f32)
    dk1 = _taps_grad_2d(xf, gd1)
    dx = (gf + _conv3x3_t_bf16(gd1, k1)).to(bf16) if need_dx else None
    return (dx, *(t.to(bf16) for t in (dk1, dk2, *((dg1, db1, dg2, db2) if affine else ()))))


def res_block_2d_bwd(g: torch.Tensor, x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                     *affine: torch.Tensor, saved=None, need_dx: bool = True):
    """K7b: -> (dx, dk1, dk2[, dgamma1, dbeta1, dgamma2, dbeta2]) of
    res2d.res_block_2d; the affine gradients are (B, C) tables. On CUDA tensors it reads
    ``saved`` = (d1, d2), the pre-norm conv outputs K7 wrote
    (``res2d.launch_res_block_2d(..., save=True)``), and raises without them. One launch is
    the kernel and the in-order sum of its blocks' d(taps) partial rows. bfloat16 operands
    run K7b's bfloat16 instance (csrc/res_block_2d_bf16_bwd.cu: the input gradients, the
    taps' gradient's partial rows and their in-order sum, by res2d_bf16_bwd_plan), on the CPU
    its closed form (res_block_2d_bwd_bf16_ref), and return bfloat16 gradients."""
    if g.device.type == "cpu":
        if x.dtype == torch.bfloat16:
            return res_block_2d_bwd_bf16_ref(g, x, k1, k2, *affine, saved=saved,
                                             need_dx=need_dx)
        return res_block_2d_bwd_ref(g, x, k1, k2, *affine, saved=saved, need_dx=need_dx)
    res2d.check_res_block_2d(x, k1, k2, *affine)
    if g.shape != x.shape or g.data_ptr() % 16:
        raise ValueError(f"g must be a 16-byte aligned {tuple(x.shape)}, got {tuple(g.shape)}")
    if saved is None or len(saved) != 2 or any(t.shape != x.shape or t.data_ptr() % 16
                                               for t in saved):
        raise ValueError(f"res_block_2d_bwd reads K7's saved d1, d2: two 16-byte aligned "
                         f"{tuple(x.shape)}")
    d1, d2 = saved
    _build.require_cuda("res_block_2d_bwd", x.dtype, g, x, d1, d2)
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_w = k1.numel() + k2.numel()
    dk = torch.empty(n_w, device=x.device, dtype=x.dtype)
    daffine = torch.empty((4, b, x.shape[3]), device=x.device, dtype=x.dtype) if affine else ()
    dx = torch.empty_like(x) if need_dx else None
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        lib, name = "res_block_2d_bf16_bwd", "iins_res_block_2d_bf16_bwd"
        blocks, chunks = res2d_bf16_bwd_plan(b, sms, res2d_bf16_dk_slots(x.device))
        part = torch.empty(res2d_bf16_bwd_scratch(b, chunks), device=x.device,
                           dtype=torch.float32)
        fn = _build.function(lib, name, [_P] * 16 + [_I, _I, _I, _P])
        plan = (blocks, chunks)
    else:
        lib, name = "res_block_2d_bwd", "iins_res_block_2d_bwd"
        _, blocks = res2d_bwd_plan(b, sms)
        # the blocks' d(taps) partial rows
        part = torch.empty((blocks, n_w), device=x.device, dtype=torch.float32)
        fn = _build.function(lib, name, [_P] * 16 + [_I, _I, _P])
        plan = (blocks,)
    tables = [t.data_ptr() for t in affine[:3]] if affine else [None] * 3
    dtables = [t.data_ptr() for t in daffine] if affine else [None] * 4
    err = fn(x.data_ptr(), d1.data_ptr(), d2.data_ptr(), k1.data_ptr(), k2.data_ptr(), *tables,
             g.data_ptr(), _ptr(dx), part.data_ptr(), dk.data_ptr(), *dtables, b, *plan,
             _build.stream_handle(x))
    _build.check(err, lib, "res_block_2d_bwd")
    if bf16:
        res_block_2d_bwd.launches_bf16 += 1
    else:
        res_block_2d_bwd.launches += 1
    dk1, dk2 = _split(dk, [k1.shape, k2.shape])
    return (dx, dk1, dk2, *daffine)


res_block_2d_bwd.launches = 0
res_block_2d_bwd.launches_bf16 = 0  # the bfloat16 instance's launches



# ------------------------------ K8b ------------------------------


def adain_layer_bwd_ref(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                        gamma: torch.Tensor, beta: torch.Tensor, *, stride: int = 1,
                        padding: int = 0, pad_mode: str = "zero", act: str = "none",
                        need_dx: bool = True):
    """Plain version of K8b."""
    dx, dt, dg, db = plain_grads(
        lambda x_, t_, g_, b_: fused.adain_layer_ref(x_, t_, g_, b_, stride=stride,
                                                     padding=padding, pad_mode=pad_mode,
                                                     act=act),
        [x, taps, gamma, beta], g)
    return (dx if need_dx else None), dt, dg, db


def adain_layer_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, *, stride: int = 1, padding: int = 0,
                    pad_mode: str = "zero", act: str = "none", need_dx: bool = True):
    """K8b (K1b's one-stage kAdain instance): -> (dx, d(taps), dgamma, dbeta)
    of fused.adain_layer; dgamma and dbeta are (B, C) tables. The residual's
    gradient is g itself: autograd.AdainLayer returns it, with no launch."""
    if g.device.type == "cpu":
        return adain_layer_bwd_ref(g, x, taps, gamma, beta, stride=stride, padding=padding,
                                   pad_mode=pad_mode, act=act, need_dx=need_dx)
    rows = fused.check_adain_layer(x, taps, gamma, beta, None, stride, padding, pad_mode, act)
    b, l_out, c_out = x.shape[0], rows[6], rows[7]
    if g.shape != (b, l_out, c_out):
        raise ValueError(f"g must be {(b, l_out, c_out)}, got {tuple(g.shape)}")
    _build.require_cuda_f32("adain_layer_bwd", g)
    spb = _build.samples_per_block(b, chain_floats(rows))
    part = torch.empty(((b + spb - 1) // spb, taps.numel()), device=x.device, dtype=x.dtype)
    dtaps = torch.empty_like(taps)
    daffine = torch.empty((2, b, c_out), device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("in_chain_bwd", "iins_adain_layer_bwd",
                         [_P] * 10 + [_I, ctypes.POINTER(_I), _I, _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
             _ptr(dx), part.data_ptr(), dtaps.data_ptr(), daffine[0].data_ptr(),
             daffine[1].data_ptr(), b, (_I * 8)(*rows), int(act == "relu"), spb,
             _build.stream_handle(x))
    _build.check(err, "in_chain_bwd", "adain_layer_bwd")
    adain_layer_bwd.launches += 1
    return dx, dtaps, daffine[0], daffine[1]


adain_layer_bwd.launches = 0


# ------------------------------ K9b ------------------------------


def sln_layer_bwd_ref(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, *, need_dx: bool = True):
    """Plain version of K9b."""
    dx, *rest = plain_grads(fused.sln_layer_ref, [x, taps, gamma, beta], g)
    return ((dx if need_dx else None), *rest)


def sln_layer_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor, *, need_dx: bool = True):
    """K9b: -> (dx, d(taps), dgamma, dbeta) of fused.sln_layer; dgamma and
    dbeta summed over the batch and the rows."""
    if g.device.type == "cpu":
        return sln_layer_bwd_ref(g, x, taps, gamma, beta, need_dx=need_dx)
    width = fused.check_sln_layer(x, taps, gamma, beta)
    b, l, c_in = x.shape
    c_out = taps.shape[2]
    if g.shape != (b, 2 * l, c_out):
        raise ValueError(f"g must be {(b, 2 * l, c_out)}, got {tuple(g.shape)}")
    _build.require_cuda_f32("sln_layer_bwd", g)
    # the input, the conv output and g, and the LayerNorm statistics
    spb = _build.samples_per_block(b, 3 * width + 3)
    n_w = taps.numel() + 2 * c_out
    part = torch.empty(((b + spb - 1) // spb, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("sln_layer_bwd", "iins_sln_layer_bwd", [_P] * 8 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(), g.data_ptr(),
             _ptr(dx), part.data_ptr(), dw.data_ptr(), b, l, c_in, c_out, spb,
             _build.stream_handle(x))
    _build.check(err, "sln_layer_bwd", "sln_layer_bwd")
    sln_layer_bwd.launches += 1
    return (dx, *_split(dw, [taps.shape, gamma.shape, beta.shape]))


sln_layer_bwd.launches = 0


# ------------------------------ K10b ------------------------------


def tanh_pool_bwd_ref(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                      pool: torch.Tensor, *, padding: int = 0, pad_mode: str = "zero",
                      need_dx: bool = True):
    """Plain version of K10b (pool gets no gradient)."""
    dx, dt, db = plain_grads(
        lambda x_, t_, b_: fused.tanh_pool_ref(x_, t_, b_, pool, padding=padding,
                                               pad_mode=pad_mode),
        [x, taps, bias], g)
    return (dx if need_dx else None), dt, db


def tanh_pool_bwd(g: torch.Tensor, x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                  pool: torch.Tensor, *, padding: int = 0, pad_mode: str = "zero",
                  need_dx: bool = True):
    """K10b: -> (dx, d(taps), dbias) of fused.tanh_pool; the pool matrix gets
    no gradient, as in the Pallas entry."""
    if g.device.type == "cpu":
        return tanh_pool_bwd_ref(g, x, taps, bias, pool, padding=padding, pad_mode=pad_mode,
                                 need_dx=need_dx)
    rows = fused.check_tanh_pool(x, taps, bias, pool, padding, pad_mode)
    b, n_out = x.shape[0], pool.shape[1]
    if g.shape != (b, n_out):
        raise ValueError(f"g must be {(b, n_out)}, got {tuple(g.shape)}")
    _build.require_cuda_f32("tanh_pool_bwd", g)
    spb = _build.samples_per_block(b, _round4(rows[4] * rows[5]) + _round4(rows[6] * rows[7]))
    n_w = taps.numel() + bias.numel()
    part = torch.empty(((b + spb - 1) // spb, n_w), device=x.device, dtype=x.dtype)
    dw = torch.empty(n_w, device=x.device, dtype=x.dtype)
    dx = torch.empty_like(x) if need_dx else None
    fn = _build.function("sln_layer_bwd", "iins_tanh_pool_bwd",
                         [_P] * 8 + [_I, ctypes.POINTER(_I), _I, _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), pool.data_ptr(), g.data_ptr(),
             _ptr(dx), part.data_ptr(), dw.data_ptr(), b, (_I * 8)(*rows), n_out, spb,
             _build.stream_handle(x))
    _build.check(err, "sln_layer_bwd", "tanh_pool_bwd")
    tanh_pool_bwd.launches += 1
    return (dx, *_split(dw, [taps.shape, bias.shape]))


tanh_pool_bwd.launches = 0

BACKWARD = (in_chain_bwd, conv_bias_act_bwd, strided_conv_bwd, mlp_chain_bwd,
            adain_res_block_bwd, sln_chain_bwd, res_block_2d_bwd, adain_layer_bwd,
            sln_layer_bwd, tanh_pool_bwd)
# each backward wrapper's plain version, which takes the same arguments
PLAIN = {in_chain_bwd: in_chain_bwd_ref, conv_bias_act_bwd: conv_bias_act_bwd_ref,
         strided_conv_bwd: strided_conv_bwd_ref, mlp_chain_bwd: mlp_chain_bwd_ref,
         adain_res_block_bwd: adain_res_block_bwd_ref, sln_chain_bwd: sln_chain_bwd_ref,
         res_block_2d_bwd: res_block_2d_bwd_ref, adain_layer_bwd: adain_layer_bwd_ref,
         sln_layer_bwd: sln_layer_bwd_ref, tanh_pool_bwd: tanh_pool_bwd_ref}
