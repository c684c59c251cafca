"""The one-stage decoder ops against the JAX package's Pallas entries.

``adain_layer`` (K8), ``sln_layer`` (K9) and ``tanh_pool`` (K10) of
iinsvae_torch.ops.kernels.fused against ``fused_adain_layer``,
``fused_sln_layer`` and ``fused_tanh_pool_layer`` in interpret mode, at the
shapes of tests/test_fused_chunked.py scaled down (batch 8, L 8, C 16).
Each entry takes a dense matrix M, built here from the same taps inside
the differentiated function (``dense_conv_matrix``, ``dense_upconv_matrix``),
and per-position tiles of the affine and bias vectors: the port's
per-sample (B, C) or per-channel (C,) tables are tiled over L there too, so
``jax.vjp`` sums the entry's tile gradients over L. The port's wrapper on
CPU tensors runs the kernel's plain version, differentiated by autograd;
the backward wrapper's CPU path must give the same. Inputs come from numpy
with a seed.

Tolerance: fp32, rtol 5e-4 / atol 5e-5 (tests/test_lowering_parity.py),
forward and VJP. The CUDA kernels are held against these plain versions on
the card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.ops import dense_conv
from iinsvae_tpu.ops.pallas import fused as pf
from iinsvae_tpu.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.ops.kernels import backward as bw
from iinsvae_torch.ops.kernels import fused

RTOL, ATOL = 5e-4, 5e-5
B, L, C = 8, 8, 16


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(2000 + sum(map(ord, name)))


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _taps(rng, k, c_in, c_out):
    return (rng.normal(size=(k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)


def _tile(v, l):
    """(B, C) or (C,) -> the Pallas entries' (B, l*C) or (1, l*C) tiles."""
    v = v.reshape((-1, 1, v.shape[-1]))
    return jnp.tile(v, (1, l, 1)).reshape(v.shape[0], -1)


def _vjp(jfn, tfn, args, g):
    """Forward outputs and input gradients of the Pallas entry (jfn) and the
    port (tfn) on the same inputs and upstream gradient."""
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in args))
    want = [np.asarray(out)] + [np.asarray(d) for d in vjp(jnp.asarray(g).reshape(out.shape))]
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    y = tfn(*leaves)
    got = [y.detach().numpy()] + [
        d.numpy() for d in torch.autograd.grad(y, leaves, torch.tensor(g).view(y.shape))]
    return got, want


def _close(got, want, names):
    assert len(got) == len(want) == len(names)
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(a).reshape(b.shape), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["relu", "none"])
def test_adain_layer_matches_pallas(act, residual):
    """K8's plain version vs fused_adain_layer (the decoder's k3 reflect
    conv): the output, d(input), d(taps), d(gamma), d(beta) and, with a
    residual, d(residual)."""
    rng = _rng(f"adain{act}{residual}")
    x, taps = _f32(rng, B, L, C), _taps(rng, 3, C, C)
    gamma, beta = _f32(rng, B, C, scale=0.5) + 1.0, _f32(rng, B, C, scale=0.3)
    args = [x, taps, gamma, beta] + ([_f32(rng, B, L, C)] if residual else [])
    g = _f32(rng, B, L, C)

    def jfn(x_, t_, g_, b_, *res):
        m = dense_conv.dense_conv_matrix(t_, L, padding=1, pad_mode="reflect")
        return pf.fused_adain_layer(x_.reshape(B, -1), m, _tile(g_, L), _tile(b_, L),
                                    l_out=L, c_out=C, act=act,
                                    residual=res[0].reshape(B, -1) if res else None)

    def tfn(x_, t_, g_, b_, *res):
        return fused.adain_layer(x_, t_, g_, b_, padding=1, pad_mode="reflect", act=act,
                                 residual=res[0] if res else None)

    got, want = _vjp(jfn, tfn, args, g)
    _close(got, want, ["y", "dx", "dtaps", "dgamma", "dbeta"] + (["dres"] if residual else []))
    kw = dict(padding=1, pad_mode="reflect", act=act)
    _same(bw.adain_layer_bwd(torch.tensor(g), *map(torch.tensor, args[:4]), **kw), got[1:5])


@pytest.mark.parametrize("l_in,c_in,c_out", [(L, C, C // 2), (2 * L, C // 2, 4)])
def test_sln_layer_matches_pallas(l_in, c_in, c_out):
    """K9's plain version vs fused_sln_layer, the upsample folded into M by
    dense_upconv_matrix: the output, d(input), d(taps), d(gamma), d(beta)."""
    rng = _rng(f"sln{l_in}")
    n = 2 * l_in * c_out
    x, taps = _f32(rng, B, l_in, c_in), _taps(rng, 5, c_in, c_out)
    gamma = rng.uniform(size=c_out).astype(np.float32)  # the reference's U(0, 1) init
    beta = _f32(rng, c_out, scale=0.1)
    g = _f32(rng, B, 2 * l_in, c_out)

    def jfn(x_, t_, g_, b_):
        m = dense_conv.dense_upconv_matrix(t_, l_in, padding=2)
        return pf.fused_sln_layer(x_.reshape(B, -1), m, _tile(g_, 2 * l_in),
                                  _tile(b_, 2 * l_in), n=n)

    got, want = _vjp(jfn, fused.sln_layer, [x, taps, gamma, beta], g)
    _close(got, want, ["y", "dx", "dtaps", "dgamma", "dbeta"])
    _same(bw.sln_layer_bwd(*map(torch.tensor, (g, x, taps, gamma, beta))), got[1:])


# (l, c, k, c_mid, padding, pad_mode, n_out): the flagship tail's k7 reflect
# conv to one channel and its adaptive pool, and a zero-pad conv to two
# channels with a dense random pool matrix
TANH_POOLS = {"tail": (2 * L, 4, 7, 1, 3, "reflect", 20),
              "zero_pad": (L, 8, 3, 2, 1, "zero", 5)}


@pytest.mark.parametrize("name", list(TANH_POOLS))
def test_tanh_pool_matches_pallas(name):
    """K10's plain version vs fused_tanh_pool_layer: the output, d(input),
    d(taps), d(bias); pool is a constant of both (no gradient)."""
    rng = _rng(name)
    l, c, k, c_mid, p, mode, n_out = TANH_POOLS[name]
    x, taps, bias = _f32(rng, B, l, c), _taps(rng, k, c, c_mid), _f32(rng, c_mid, scale=0.1)
    pool = (adaptive_avg_pool_matrix(l, n_out) if name == "tail"
            else _f32(rng, l * c_mid, n_out, scale=0.3))
    pool = np.asarray(pool, np.float32)
    g = _f32(rng, B, n_out)

    def jfn(x_, t_, b_):
        m = dense_conv.dense_conv_matrix(t_, l, padding=p, pad_mode=mode)
        return pf.fused_tanh_pool_layer(x_.reshape(B, -1), m, _tile(b_, l), jnp.asarray(pool))

    def tfn(x_, t_, b_):
        return fused.tanh_pool(x_, t_, b_, torch.tensor(pool), padding=p, pad_mode=mode)

    got, want = _vjp(jfn, tfn, [x, taps, bias], g)
    _close(got, want, ["y", "dx", "dtaps", "dbias"])
    _same(bw.tanh_pool_bwd(*map(torch.tensor, (g, x, taps, bias, pool)), padding=p,
                           pad_mode=mode), got[1:])


def test_two_adain_layers_are_the_adain_res_block():
    """The cross-check chip_smoke.py runs on the card, plain against plain:
    adain_layer (relu), then adain_layer (none) with the block's input as the
    residual, is adain_res_block."""
    rng = _rng("k8k8")
    x = torch.tensor(_f32(rng, B, L, C))
    k1, k2 = torch.tensor(_taps(rng, 3, C, C)), torch.tensor(_taps(rng, 3, C, C))
    g1, b1, g2, b2 = (torch.tensor(_f32(rng, B, C)) for _ in range(4))
    kw = dict(padding=1, pad_mode="reflect")
    y = fused.adain_layer(x, k1, g1, b1, act="relu", **kw)
    y = fused.adain_layer(y, k2, g2, b2, act="none", residual=x, **kw)
    torch.testing.assert_close(y, fused.adain_res_block(x, k1, k2, g1, b1, g2, b2),
                               rtol=1e-6, atol=1e-6)


def test_four_sln_layers_and_tanh_pool_are_the_sln_chain():
    """The other cross-check of chip_smoke.py, plain against plain: four
    sln_layer stages and tanh_pool with the adaptive pool matrix are
    sln_chain whose stages have zero conv biases (sln_layer has none)."""
    rng = _rng("k9k10")
    x = torch.tensor(_f32(rng, B, 4, 64))
    stages, c = [], 64
    for _ in range(4):
        stages.append((torch.tensor(_taps(rng, 5, c, c // 2)), torch.zeros(c // 2),
                       torch.tensor(rng.uniform(size=c // 2).astype(np.float32)),
                       torch.tensor(_f32(rng, c // 2, scale=0.1))))
        c //= 2
    ko, bo = torch.tensor(_taps(rng, 7, 4, 1)), torch.tensor(_f32(rng, 1, scale=0.1))
    y = x
    for taps, _, gamma, beta in stages:
        y = fused.sln_layer(y, taps, gamma, beta)
    pool = torch.tensor(np.asarray(adaptive_avg_pool_matrix(y.shape[1], 20), np.float32))
    torch.testing.assert_close(fused.tanh_pool(y, ko, bo, pool, padding=3, pad_mode="reflect"),
                               fused.sln_chain(x, stages, ko, bo, 20), rtol=1e-5, atol=1e-6)


def test_one_stage_wrappers_reject_a_bad_activation():
    x, taps, tab = torch.zeros((2, L, C)), torch.zeros((3, C, C)), torch.zeros((2, C))
    with pytest.raises(ValueError):
        fused.adain_layer(x, taps, tab, tab, act="gelu")
