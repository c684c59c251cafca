"""One ``torch.autograd.Function`` for each of K1-K10.

``forward`` launches the forward kernel (fused.py, strided_conv.py,
res2d.py) and saves its inputs (K2 and K3 also their output, for the ReLU
mask; K4 the pre-activations and K7 the pre-norm conv outputs its kernel
writes under autograd); ``backward`` launches
the backward kernel (backward.py). The public wrappers take these only for
CUDA tensors, with grad mode on and an input that requires grad; the input
gradient is computed only where autograd asks for it
(``ctx.needs_input_grad``).

K4 and K7 also take bfloat16 operands on both devices: their bfloat16
instances on the card, and on the CPU their plain bfloat16 versions with the
closed-form bfloat16 backward (backward.mlp_chain_bwd, res_block_2d_bwd), whose
cast points are not autograd of the forward.
"""

from __future__ import annotations

import torch
from torch.autograd import Function
from torch.autograd.function import once_differentiable

from iinsvae_torch.ops.kernels import backward, fused, res2d, strided_conv


class InChain(Function):
    """K1 / K1b. apply(x, spec, residual, *taps); spec holds each stage's
    (stride, padding, pad_mode)."""

    @staticmethod
    def forward(ctx, x, spec, residual, *taps):
        ctx.spec, ctx.residual = spec, residual
        ctx.save_for_backward(x, *taps)
        return fused.launch_in_chain(x, [(t, *s) for t, s in zip(taps, spec)], residual)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *taps = ctx.saved_tensors
        dx, dtaps = backward.in_chain_bwd(
            g.contiguous(), x, [(t, *s) for t, s in zip(taps, ctx.spec)],
            residual=ctx.residual, need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, *dtaps)


class ConvBiasAct(Function):
    """K2 / K2b. apply(x, taps, bias, (stride, padding, pad_mode))."""

    @staticmethod
    def forward(ctx, x, taps, bias, geometry):
        y = fused.launch_conv_bias_act(x, taps, bias, *geometry)
        fused.conv_bias_act.launches += 1
        ctx.geometry = geometry
        ctx.save_for_backward(x, taps, bias, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, taps, bias, y = ctx.saved_tensors
        stride, padding, pad_mode = ctx.geometry
        dx, dtaps, dbias = backward.conv_bias_act_bwd(
            g.contiguous(), x, taps, bias, y, stride=stride, padding=padding,
            pad_mode=pad_mode, need_dx=ctx.needs_input_grad[0])
        return dx, dtaps, dbias, None


class StridedConv(Function):
    """K3 / K3b. apply(x, taps, bias)."""

    @staticmethod
    def forward(ctx, x, taps, bias):
        y = strided_conv.launch_strided_conv(x, taps, bias)
        strided_conv.strided_conv.launches += 1
        ctx.save_for_backward(x, taps, bias, y)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, taps, bias, y = ctx.saved_tensors
        return backward.strided_conv_bwd(g.contiguous(), x, taps, bias, y,
                                         need_dx=ctx.needs_input_grad[0])


class MlpChain(Function):
    """K4 / K4b. apply(x, slopes, n_layers, *ws, *bs)."""

    @staticmethod
    def forward(ctx, x, slopes, n, *params):
        ws, bs = params[:n], params[n:]
        fwd = fused.mlp_chain_bf16_ref if x.device.type == "cpu" else fused.launch_mlp_chain
        y, ds = fwd(x, ws, bs, slopes, save_pre=True)
        ctx.slopes, ctx.n = slopes, n
        ctx.save_for_backward(x, *params, *ds)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        n = ctx.n
        ws, bs, ds = rest[:n], rest[n:2 * n], rest[2 * n:]
        dx, dws, dbs = backward.mlp_chain_bwd(g.contiguous(), x, ws, bs, ctx.slopes, ds,
                                              need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, *dws, *dbs)


class AdainResBlock(Function):
    """K5 / K1b's kAdain instance. apply(x, k1, k2, g1, b1, g2, b2)."""

    @staticmethod
    def forward(ctx, x, k1, k2, g1, b1, g2, b2):
        ctx.save_for_backward(x, k1, k2, g1, b1, g2, b2)
        return fused.launch_adain_res_block(x, k1, k2, g1, b1, g2, b2)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return backward.adain_res_block_bwd(g.contiguous(), *ctx.saved_tensors,
                                            need_dx=ctx.needs_input_grad[0])


class SlnChain(Function):
    """K6 / K6b. apply(x, l_pool, *stage tensors (taps, bias, gamma, beta
    per stage), out_kernel, out_bias)."""

    @staticmethod
    def forward(ctx, x, l_pool, *params):
        ctx.l_pool = l_pool
        ctx.save_for_backward(x, *params)
        return fused.launch_sln_chain(x, _stages(params), params[-2], params[-1], l_pool)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        dx, dstages, dko, dbo = backward.sln_chain_bwd(
            g.contiguous(), x, _stages(params), params[-2], params[-1], ctx.l_pool,
            need_dx=ctx.needs_input_grad[0])
        return (dx, None, *(t for st in dstages for t in st), dko, dbo)


class ResBlock2d(Function):
    """K7 / K7b. apply(x, k1, k2, *affine), affine () or (g1, b1, g2, b2);
    K7 saves the pre-norm conv outputs d1, d2 that K7b reads."""

    @staticmethod
    def forward(ctx, x, k1, k2, *affine):
        y, d1, d2 = res2d.forward_saved(x, k1, k2, *affine)
        ctx.save_for_backward(x, d1, d2, k1, k2, *affine)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, d1, d2, *params = ctx.saved_tensors
        return backward.res_block_2d_bwd(g.contiguous(), x, *params, saved=(d1, d2),
                                         need_dx=ctx.needs_input_grad[0])


class AdainLayer(Function):
    """K8 / K8b. apply(x, taps, gamma, beta, residual or None, (stride,
    padding, pad_mode, act)); the residual's gradient is g, with no launch."""

    @staticmethod
    def forward(ctx, x, taps, gamma, beta, residual, geometry):
        ctx.geometry = geometry
        ctx.save_for_backward(x, taps, gamma, beta)
        return fused.launch_adain_layer(x, taps, gamma, beta, residual, *geometry)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        stride, padding, pad_mode, act = ctx.geometry
        g = g.contiguous()
        dx, dtaps, dgamma, dbeta = backward.adain_layer_bwd(
            g, *ctx.saved_tensors, stride=stride, padding=padding, pad_mode=pad_mode, act=act,
            need_dx=ctx.needs_input_grad[0])
        return dx, dtaps, dgamma, dbeta, (g if ctx.needs_input_grad[4] else None), None


class SlnLayer(Function):
    """K9 / K9b. apply(x, taps, gamma, beta)."""

    @staticmethod
    def forward(ctx, x, taps, gamma, beta):
        ctx.save_for_backward(x, taps, gamma, beta)
        return fused.launch_sln_layer(x, taps, gamma, beta)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return backward.sln_layer_bwd(g.contiguous(), *ctx.saved_tensors,
                                      need_dx=ctx.needs_input_grad[0])


class TanhPool(Function):
    """K10 / K10b. apply(x, taps, bias, pool, (padding, pad_mode)); pool gets
    no gradient, as in the Pallas entry."""

    @staticmethod
    def forward(ctx, x, taps, bias, pool, geometry):
        ctx.geometry = geometry
        ctx.save_for_backward(x, taps, bias, pool)
        return fused.launch_tanh_pool(x, taps, bias, pool, *geometry)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        padding, pad_mode = ctx.geometry
        dx, dtaps, dbias = backward.tanh_pool_bwd(
            g.contiguous(), *ctx.saved_tensors, padding=padding, pad_mode=pad_mode,
            need_dx=ctx.needs_input_grad[0])
        return dx, dtaps, dbias, None, None


def _stages(params) -> list[tuple[torch.Tensor, ...]]:
    return [tuple(params[4 * j:4 * j + 4]) for j in range((len(params) - 2) // 4)]
