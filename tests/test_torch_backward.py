"""The port's backward against the JAX package's Pallas entries' VJPs.

For each of the eight Pallas entry variants on the training path (rows 1-8
of PERF.md's kernel table), ``jax.vjp`` of the entry in interpret mode, with
the dense conv matrices built from the taps inside the differentiated
function (as tests/test_torch_kernels.py builds its forward comparisons),
gives d(input) and d(taps), d(bias), d(gamma), d(beta), dW, db. The port's
wrapper on CPU tensors runs the kernel's plain version and
``torch.autograd.grad`` differentiates it; the backward wrapper's CPU path
(backward.py) must give the same. Inputs and the upstream gradient come
from numpy with a seed.

Tolerance: fp32, rtol 5e-4 / atol 5e-5, the forward's
(tests/test_lowering_parity.py); the largest error seen is half of it (K5's
d(k1)). The CUDA backward kernels are held against these plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.ops import dense_conv
from iinsvae_tpu.ops.pallas import fused as pf
from iinsvae_tpu.ops.pallas import strided_conv as psc
from iinsvae_tpu.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.ops.kernels import backward as bw
from iinsvae_torch.ops.kernels import fused, strided_conv

RTOL, ATOL = 5e-4, 5e-5
B = 4

# (l_in, c_in, stages as (k, c_out, stride, padding, pad_mode)): K1's sites
IN_CHAINS = {
    "pair0": (128, 1, [(7, 4, 1, 3, "reflect"), (4, 8, 2, 1, "zero")]),
    "pair1": (64, 8, [(4, 16, 2, 1, "zero"), (4, 32, 2, 1, "zero")]),
    "single": (16, 32, [(4, 64, 2, 1, "zero")]),
    "res": (8, 64, [(3, 64, 1, 1, "reflect"), (3, 64, 1, 1, "reflect")]),
}
# (l_in, c_in, k, c_out, padding, pad_mode): K2's sites
CONV_BIAS_ACT = {
    "range_out": (8, 64, 1, 2, 0, "zero"),
    "env_in": (128, 1, 7, 16, 3, "reflect"),
    "dec_in": (8, 2, 1, 64, 0, "zero"),
}
STRIDED = {"env_down0": (128, 16, 32), "env_down1": (64, 32, 64)}
MLPS = {
    "restorer": ((16, 512, 256, 256, 1), (0.2, 0.2, 0.2, 1.0)),
    "classifier": ((16, 16, 32, 16, 5), (0.01, 0.01, 0.01, 0.2)),
}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(1000 + sum(map(ord, name)))


def _taps(rng, k, c_in, c_out):
    return (rng.normal(size=(k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)


def _f32(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def _m(t, l_in, s, p, mode, centered):
    return dense_conv.dense_conv_matrix(t, l_in, stride=s, padding=p, pad_mode=mode,
                                        centered=centered)


def _jax_grads(fn, args, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    assert out.shape == g.shape
    return [np.asarray(d) for d in vjp(jnp.asarray(g))]


def _port_grads(fn, args, g):
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    out = fn(*leaves)
    return [d.numpy() for d in torch.autograd.grad(out, leaves, torch.tensor(g).view(out.shape))]


def _close(got, want, names):
    assert len(got) == len(want) == len(names)
    for a, b, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(a).reshape(b.shape), b, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def _same(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name", list(IN_CHAINS))
def test_in_chain_backward_matches_pallas_vjp(name):
    """pair0/pair1 vs fused_in_pair, single vs fused_dense_layer(norm='in'),
    res vs fused_res_block: d(input) and every stage's d(taps)."""
    rng = _rng(name)
    l, c, spec = IN_CHAINS[name]
    x = _f32(rng, B, l, c)
    taps, shapes = [], []
    for k, c_out, s, p, _ in spec:
        taps.append(_taps(rng, k, c, c_out))
        l_out = (l + 2 * p - k) // s + 1
        shapes.append((l, l_out, c_out))
        l, c = l_out, c_out
    g = _f32(rng, B, l * c)

    def jfn(x_, *t):
        ms = [_m(ti, l_in, s, p, mode, True)
              for ti, (l_in, _, _), (_, _, s, p, mode) in zip(t, shapes, spec)]
        x2 = x_.reshape(B, -1)
        if name == "res":
            return pf.fused_res_block(x2, *ms, l_out=l, c_out=c, centered=True)
        if name == "single":
            return pf.fused_dense_layer(x2, ms[0], l_out=l, c_out=c, norm="in", act="relu",
                                        centered=True)
        (_, l1, c1), (_, l2, c2) = shapes
        return pf.fused_in_pair(x2, *ms, l1=l1, c1=c1, l2=l2, c2=c2, centered=True)

    def tfn(x_, *t):
        return fused.in_chain(x_, [(ti, *sp[2:]) for ti, sp in zip(t, spec)],
                              residual=name == "res")

    want = _jax_grads(jfn, [x, *taps], g)
    got = _port_grads(tfn, [x, *taps], g)
    names = ["dx"] + [f"dtaps{j}" for j in range(len(taps))]
    _close(got, want, names)
    stages = [(torch.tensor(t), *sp[2:]) for t, sp in zip(taps, spec)]
    dx, dtaps = bw.in_chain_bwd(torch.tensor(g).view(B, l, c), torch.tensor(x), stages,
                                residual=name == "res")
    _same([dx, *dtaps], got)


@pytest.mark.parametrize("name", list(CONV_BIAS_ACT))
def test_conv_bias_act_backward_matches_pallas_vjp(name):
    """vs fused_dense_layer(norm='none') with the bias tiled over L: d(input),
    d(taps), d(bias)."""
    rng = _rng(name)
    l, c, k, c_out, p, mode = CONV_BIAS_ACT[name]
    x = _f32(rng, B, l, c)
    taps = _taps(rng, k, c, c_out)
    bias = rng.uniform(-0.5, 0.5, size=c_out).astype(np.float32)
    l_out = l + 2 * p - k + 1
    g = _f32(rng, B, l_out * c_out)

    def jfn(x_, t, b):
        return pf.fused_dense_layer(x_.reshape(B, -1), _m(t, l, 1, p, mode, False), l_out=l_out,
                                    c_out=c_out, norm="none", act="relu", bias=jnp.tile(b, l_out))

    def tfn(x_, t, b):
        return fused.conv_bias_act(x_, t, b, padding=p, pad_mode=mode)

    want = _jax_grads(jfn, [x, taps, bias], g)
    got = _port_grads(tfn, [x, taps, bias], g)
    _close(got, want, ["dx", "dtaps", "dbias"])
    xt, tt, bt = torch.tensor(x), torch.tensor(taps), torch.tensor(bias)
    y = fused.conv_bias_act(xt, tt, bt, padding=p, pad_mode=mode)
    _same(bw.conv_bias_act_bwd(torch.tensor(g).view(y.shape), xt, tt, bt, y, padding=p,
                               pad_mode=mode), got)


@pytest.mark.parametrize("name", list(STRIDED))
def test_strided_conv_backward_matches_pallas_vjp(name):
    """vs fused_strided_conv: d(input), d(taps), d(bias)."""
    rng = _rng(name)
    l, c, c_out = STRIDED[name]
    x = _f32(rng, B, l, c)
    taps = _taps(rng, 4, c, c_out)
    bias = rng.uniform(-0.5, 0.5, size=c_out).astype(np.float32)
    g = _f32(rng, B, l // 2, c_out)
    want = _jax_grads(lambda x_, t, b: psc.fused_strided_conv(x_, t, b, l_in=l, c_in=c),
                      [x, taps, bias], g)
    got = _port_grads(strided_conv.strided_conv, [x, taps, bias], g)
    _close(got, want, ["dx", "dtaps", "dbias"])
    xt, tt, bt = torch.tensor(x), torch.tensor(taps), torch.tensor(bias)
    _same(bw.strided_conv_bwd(torch.tensor(g), xt, tt, bt, strided_conv.strided_conv(xt, tt, bt)),
          got)


@pytest.mark.parametrize("name", list(MLPS))
def test_mlp_chain_backward_matches_pallas_vjp(name):
    """vs fused_mlp_chain: d(input), every dW_j and db_j."""
    rng = _rng(name)
    dims, slopes = MLPS[name]
    x = _f32(rng, B, dims[0])
    ws = [(rng.uniform(-1, 1, size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(rng.uniform(-1, 1, size=b) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    g = _f32(rng, B, dims[-1])
    n = len(ws)
    want = _jax_grads(lambda x_, *p: pf.fused_mlp_chain(x_, p[:n], p[n:], slopes),
                      [x, *ws, *bs], g)
    got = _port_grads(lambda x_, *p: fused.mlp_chain(x_, p[:n], p[n:], slopes),
                      [x, *ws, *bs], g)
    _close(got, want, ["dx"] + [f"dW{j}" for j in range(n)] + [f"db{j}" for j in range(n)])
    dx, dws, dbs = bw.mlp_chain_bwd(torch.tensor(g), torch.tensor(x),
                                    [torch.tensor(w) for w in ws],
                                    [torch.tensor(b) for b in bs], slopes, ds=[])
    _same([dx, *dws, *dbs], got)


def test_adain_res_block_backward_matches_pallas_vjp():
    """vs fused_adain_res_block with g, b tiled over L (decoders.py:135-148):
    d(input), d(k1), d(k2) and the four (B, C) affine gradients."""
    rng = _rng("adain_res_block")
    l, c = 8, 64
    x = _f32(rng, B, l, c)
    k1, k2 = _taps(rng, 3, c, c), _taps(rng, 3, c, c)
    affine = [_f32(rng, B, c) for _ in range(4)]
    g = _f32(rng, B, l * c)

    def jfn(x_, t1, t2, *aff):
        ms = [_m(t, l, 1, 1, "reflect", True) for t in (t1, t2)]
        tiles = [jnp.tile(a, (1, l)) for a in aff]
        return pf.fused_adain_res_block(x_.reshape(B, -1), *ms, *tiles, l_out=l, c_out=c,
                                        centered=True)

    want = _jax_grads(jfn, [x, k1, k2, *affine], g)
    got = _port_grads(fused.adain_res_block, [x, k1, k2, *affine], g)
    _close(got, want, ["dx", "dk1", "dk2", "dg1", "db1", "dg2", "db2"])
    _same(bw.adain_res_block_bwd(torch.tensor(g).view(B, l, c),
                                 *(torch.tensor(a) for a in (x, k1, k2, *affine))), got)


def test_sln_chain_backward_matches_pallas_vjp():
    """vs fused_sln_chain with the dense upsample-conv matrices, tiled rows,
    the reflect out-matrix and the 128 -> 157 pool (decoders.py:150-165):
    d(input), each stage's d(taps), d(bias), d(gamma), d(beta), and the out
    conv's d(taps) and d(bias)."""
    rng = _rng("sln_chain")
    x = _f32(rng, B, 8, 64)
    params, d = [], 64
    for _ in range(4):
        params += [_taps(rng, 5, d, d // 2),
                   rng.uniform(-0.3, 0.3, size=d // 2).astype(np.float32),
                   rng.uniform(0.2, 1.0, size=d // 2).astype(np.float32),
                   _f32(rng, d // 2, scale=0.1)]
        d //= 2
    params += [_taps(rng, 7, d, 1), rng.uniform(-0.3, 0.3, size=1).astype(np.float32)]
    g = _f32(rng, B, 157)

    def jfn(x_, *p):
        l, ms, biases, gammas, betas = 8, [], [], [], []
        for j in range(4):
            taps, bias, gamma, beta = p[4 * j:4 * j + 4]
            ms.append(dense_conv.dense_upconv_matrix(taps, l, padding=2))
            l *= 2
            biases.append(jnp.tile(bias, l).reshape(1, -1))
            gammas.append(jnp.tile(gamma, l).reshape(1, -1))
            betas.append(jnp.tile(beta, l).reshape(1, -1))
        m_out = _m(p[16], l, 1, 3, "reflect", False)
        return pf.fused_sln_chain(x_.reshape(B, -1), tuple(ms), tuple(gammas), tuple(betas),
                                  m_out, jnp.tile(p[17], l).reshape(1, -1),
                                  adaptive_avg_pool_matrix(l, 157), biases=tuple(biases))

    def tfn(x_, *p):
        return fused.sln_chain(x_, [tuple(p[4 * j:4 * j + 4]) for j in range(4)], p[16], p[17],
                               157)

    want = _jax_grads(jfn, [x, *params], g)
    got = _port_grads(tfn, [x, *params], g)
    names = ["dx"] + [f"stage{j}.{n}" for j in range(4)
                      for n in ("dtaps", "dbias", "dgamma", "dbeta")] + ["dout_k", "dout_b"]
    _close(got, want, names)
    dx, dstages, dko, dbo = bw.sln_chain_bwd(
        torch.tensor(g), torch.tensor(x),
        [tuple(torch.tensor(t) for t in params[4 * j:4 * j + 4]) for j in range(4)],
        torch.tensor(params[16]), torch.tensor(params[17]), 157)
    _same([dx, *(t for st in dstages for t in st), dko, dbo], got)


def test_backward_wrappers_skip_the_input_gradient_when_asked():
    """need_dx=False returns None for the input (the range encoder's first
    stage and the env in-conv read the pooled CIR); the weight gradients
    are unchanged."""
    rng = _rng("need_dx")
    x = torch.tensor(_f32(rng, B, 128, 1))
    taps = torch.tensor(_taps(rng, 7, 1, 16))
    bias = torch.zeros(16)
    y = fused.conv_bias_act(x, taps, bias, padding=3, pad_mode="reflect")
    g = torch.tensor(_f32(rng, *y.shape))
    kw = dict(padding=3, pad_mode="reflect")
    dx, dt, db = bw.conv_bias_act_bwd(g, x, taps, bias, y, need_dx=False, **kw)
    assert dx is None
    _same([dt, db], bw.conv_bias_act_bwd(g, x, taps, bias, y, **kw)[1:])
