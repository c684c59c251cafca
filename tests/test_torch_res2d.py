"""K7 res_block_2d's plain version against the JAX package's Pallas entry.

``fused_res_block_2d`` (iinsvae_tpu/ops/pallas/res2d.py:434) runs in
interpret mode on the CPU, as tests/test_res2d.py runs it (b = 6, C = 16:
W*C = 128 lanes). The port's wrapper on CPU tensors runs its plain version
(dense reflect-pad conv2d, two-pass InstanceNorm, AdaIN, ReLU, the skip),
and ``torch.autograd.grad`` differentiates it; the backward wrapper's CPU
path (backward.res_block_2d_bwd) must give the same. Forward and VJP, IN
and AdaIN; inputs and the upstream gradient from numpy with a seed.

Tolerance: fp32, rtol 5e-4 / atol 5e-5 (tests/test_lowering_parity.py),
the forward's and every gradient's. The TPU kernel's variance is the
one-pass E[x^2] - mean^2 clamped at 0 (res2d.py:157) and the port's
two-pass; on these inputs they agree within that tolerance. The CUDA kernels
are held against these plain versions on the card by tests/test_torch_gpu.py
and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.ops.pallas.res2d import fused_res_block_2d
from iinsvae_torch.ops.kernels import backward as bw
from iinsvae_torch.ops.kernels import res2d

RTOL, ATOL = 5e-4, 5e-5
B, C = 6, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 8, 8, C)).astype(np.float32)
    k1 = (0.1 * rng.standard_normal((3, 3, C, C))).astype(np.float32)
    k2 = (0.1 * rng.standard_normal((3, 3, C, C))).astype(np.float32)
    affine = [rng.standard_normal((B, C)).astype(np.float32) for _ in range(4)]
    g = rng.standard_normal((B, 8, 8, C)).astype(np.float32)
    return x, k1, k2, affine, g


def _jax_block(norm):
    if norm == "in":
        return lambda x, k1, k2: fused_res_block_2d(x, k1, k2, norm="in")
    return lambda x, k1, k2, g1, b1, g2, b2: fused_res_block_2d(
        x, k1, k2, norm="adain", gamma1=g1, beta1=b1, gamma2=g2, beta2=b2)


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_res_block_2d_forward_matches_pallas(data, norm):
    x, k1, k2, affine, _ = data
    args = [x, k1, k2] + (affine if norm == "adain" else [])
    want = np.asarray(_jax_block(norm)(*(jnp.asarray(a) for a in args)))
    got = res2d.res_block_2d(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_res_block_2d_vjp_matches_pallas(data, norm):
    """d(x), d(k1), d(k2) and, for AdaIN, the four (B, C) affine gradients."""
    x, k1, k2, affine, g = data
    args = [x, k1, k2] + (affine if norm == "adain" else [])
    out, vjp = jax.vjp(_jax_block(norm), *(jnp.asarray(a) for a in args))
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    got = torch.autograd.grad(res2d.res_block_2d(*leaves), leaves, torch.tensor(g))
    via_wrapper = bw.res_block_2d_bwd(torch.tensor(g), *(torch.tensor(a) for a in args))
    assert len(want) == len(got) == len(via_wrapper) == len(args)
    for i, (w, a, b) in enumerate(zip(want, got, via_wrapper)):
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"grad {i}")
        np.testing.assert_allclose(b.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"wrapper {i}")
    assert bw.res_block_2d_bwd(torch.tensor(g), *(torch.tensor(a) for a in args),
                               need_dx=False)[0] is None


def test_res_block_2d_is_finite_on_constant_fields():
    """Two-pass variance: an exactly constant channel and a constant sample
    give finite outputs and gradients (the one-pass form went negative on
    the TPU, res2d.py:157)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 8, 8, 64)).astype(np.float32)
    x[1, :, :, 7] = 100.0
    x[2] = 50.0
    k1, k2 = (torch.tensor(0.02 * rng.standard_normal((3, 3, 64, 64)), dtype=torch.float32)
              for _ in range(2))
    xt = torch.tensor(x, requires_grad=True)
    y = res2d.res_block_2d(xt, k1, k2)
    (gx,) = torch.autograd.grad(y.square().sum(), xt)
    assert torch.isfinite(y).all() and torch.isfinite(gx).all()
