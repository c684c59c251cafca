"""K7b's formulas on the CPU: the backward from the forward's saved activations, and 3xTF32.

K7 writes the pre-norm conv outputs d1 = conv3x3(x, k1) and d2 = conv3x3(y1, k2) under
autograd, and K7b computes the block's gradients from them without recomputing a conv, its
products on the tensor cores in 3xTF32 (csrc/res_block_2d_bwd.cu). Here:

(a) the plain forward that also returns (d1, d2) (``res2d.res_block_2d_ref(..., save=True)``)
    and the plain closed-form backward from (g, x, d1, d2, k1, k2, *affine)
    (``backward.res_block_2d_bwd_closed``, the formulas the kernel follows) against the JAX
    entry ``fused_res_block_2d`` in interpret mode, its output and its VJP, IN and AdaIN, at
    tests/test_torch_res2d.py's B = 6, C = 16, with its tolerance (fp32, rtol 5e-4 / atol
    5e-5); and the closed form against autograd through the plain forward in float64 at the
    model's C = 64, where the two are the same function (rtol 1e-10 of each gradient's
    largest magnitude);
(b) a plain emulation of the 3xTF32 product the kernel runs (each fp32 operand split into
    hi = tf32(v) and lo = tf32(v - hi), rounded to nearest with ties away, 10 mantissa bits;
    lo*hi, hi*lo, hi*hi accumulated in fp32, each 8-deep step of the tensor core's m16n8k8
    summed exactly and rounded once) on one conv's input-gradient shape, (B*64 x 576) .
    (576 x 64), and its taps'-gradient shape, (576 x B*64) . (B*64 x 64), at B = 4 with
    normal data and taps 0.1*N(0, 1): its largest error against float64, over the result's
    largest magnitude, is within twice the plain fp32 product's, while plain TF32 (one
    product of the hi parts) is not;
(c) the same at the block: the plain block with both convs run as K7 runs them (each input
    centred per (sample, channel), the 3xTF32 products with K7's partial sums every
    K7_FLUSH k-steps, conv(mean) added back), IN and AdaIN at C = 64, B = 2 and 4: y, d1 and
    d2 each within twice the plain fp32 block's error against float64, and 1xTF32 not. The
    emulation sums each 8-deep step exactly; the card's tensor cores truncate, which
    tests/test_torch_gpu.py measures.

The card's kernels are held to the plain versions by tests/test_torch_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.ops.pallas.res2d import fused_res_block_2d
from iinsvae_torch.ops.conv import conv2d, reflect_pad2d
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
def test_forward_with_saves_matches_pallas_and_returns_the_pre_norm_convs(data, norm):
    x, k1, k2, affine, _ = data
    args = [x, k1, k2] + (affine if norm == "adain" else [])
    want = np.asarray(_jax_block(norm)(*(jnp.asarray(a) for a in args)))
    t = [torch.tensor(a) for a in args]
    y, d1, d2 = res2d.res_block_2d_ref(*t, save=True)
    np.testing.assert_allclose(y.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(y, res2d.res_block_2d_ref(*t))
    assert torch.equal(d1, conv2d(t[0], t[1], padding=1, pad_mode="reflect"))
    assert d2.shape == d1.shape == y.shape and torch.isfinite(d2).all()


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_closed_form_backward_from_the_saves_matches_the_pallas_vjp(data, norm):
    """d(x), d(k1), d(k2) and, for AdaIN, the four (B, C) affine gradients, from g, x, d1,
    d2 and the parameters alone."""
    x, k1, k2, affine, g = data
    args = [x, k1, k2] + (affine if norm == "adain" else [])
    _, vjp = jax.vjp(_jax_block(norm), *(jnp.asarray(a) for a in args))
    want = [np.asarray(d) for d in vjp(jnp.asarray(g))]
    t = [torch.tensor(a) for a in args]
    _, d1, d2 = res2d.res_block_2d_ref(*t, save=True)
    got = bw.res_block_2d_bwd_closed(torch.tensor(g), *t, saved=(d1, d2))
    assert len(got) == len(want) == len(args)
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.numpy(), w, rtol=RTOL, atol=ATOL, err_msg=f"grad {i}")
    no_dx = bw.res_block_2d_bwd_closed(torch.tensor(g), *t, saved=(d1, d2), need_dx=False)
    assert no_dx[0] is None and all(torch.equal(a, b) for a, b in zip(no_dx[1:], got[1:]))


@pytest.mark.parametrize("adain", [False, True])
def test_closed_form_backward_is_autograd_of_the_plain_block_at_c64(adain):
    rng = np.random.default_rng(7)
    b, c = 3, 64
    x = torch.tensor(rng.standard_normal((b, 8, 8, c)))
    k1, k2 = (torch.tensor(0.1 * rng.standard_normal((3, 3, c, c))) for _ in range(2))
    affine = [torch.tensor(rng.standard_normal((b, c))) for _ in range(4)] if adain else []
    g = torch.tensor(rng.standard_normal((b, 8, 8, c)))
    _, d1, d2 = res2d.res_block_2d_ref(x, k1, k2, *affine, save=True)
    got = bw.res_block_2d_bwd_closed(g, x, k1, k2, *affine, saved=(d1, d2))
    want = bw.res_block_2d_bwd_ref(g, x, k1, k2, *affine)
    assert len(got) == len(want) == 3 + len(affine)
    for i, (a, w) in enumerate(zip(got, want)):
        assert (a - w).abs().max() <= 1e-10 * w.abs().max(), f"gradient {i}"


def _tf32(v: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 (10 mantissa bits), to nearest with ties away from zero, as
    cvt.rna.tf32.f32 does: add half of the dropped bits' unit to the magnitude, truncate."""
    u = np.ascontiguousarray(v, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_product(pairs, m: int, n: int, k: int, flush: int | None = None) -> np.ndarray:
    """sum over the (a, b) pairs of a . b, accumulated in fp32 an 8-deep step at a time, the
    pairs in order within a step: each step's products summed exactly, the sum rounded once.
    With ``flush``, the steps run in a partial sum of their own that is added (fp32) to the
    result every ``flush`` steps and then starts from zero, as K7's partial sums do."""
    acc = part = np.zeros((m, n), np.float32)
    for i, k0 in enumerate(range(0, k, 8)):
        for a, b in pairs:
            step = a[:, k0:k0 + 8].astype(np.float64) @ b[k0:k0 + 8].astype(np.float64)
            part = (part.astype(np.float64) + step).astype(np.float32)
        if flush and (i + 1) % flush == 0:
            acc, part = acc + part, np.zeros_like(part)
    return acc + part


def _errors(a: np.ndarray, b: np.ndarray) -> dict[str, float]:
    """Largest error against float64, over the result's largest magnitude, of the plain fp32
    product, 3xTF32 and plain TF32."""
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    m, k, n = a.shape[0], a.shape[1], b.shape[1]
    got = {"fp32": a @ b,
           "3xtf32": _mma_product([(al, bh), (ah, bl), (ah, bh)], m, n, k),
           "1xtf32": _mma_product([(ah, bh)], m, n, k)}
    scale = np.abs(ref).max()
    return {name: float(np.abs(v.astype(np.float64) - ref).max() / scale)
            for name, v in got.items()}


def _windows(field: np.ndarray) -> np.ndarray:
    """(B, 8, 8, C) -> (B*64, 9*C): each pixel's reflect-padded 3x3 window, taps (dh, dw, c)."""
    p = reflect_pad2d(torch.from_numpy(field), 1).numpy()
    b, _, _, c = field.shape
    return np.concatenate([p[:, i:i + 8, j:j + 8].reshape(b * 64, c)
                           for i in range(3) for j in range(3)], axis=1)


@pytest.mark.parametrize("product", ["input_grad", "taps_grad"])
def test_3xtf32_keeps_fp32_accuracy_at_k7b_shapes(product):
    rng = np.random.default_rng(11)
    b, c = 4, 64
    win = _windows(rng.standard_normal((b, 8, 8, c)).astype(np.float32))  # (256, 576)
    if product == "input_grad":
        taps = (0.1 * rng.standard_normal((9 * c, c))).astype(np.float32)
        err = _errors(win, taps)
    else:
        gd = rng.standard_normal((b * 64, c)).astype(np.float32)
        err = _errors(np.ascontiguousarray(win.T), gd)
    assert err["3xtf32"] <= 2 * err["fp32"], err
    assert err["1xtf32"] > 2 * err["fp32"], err


# k-steps K7's partial sums run before they are added to the conv's sums (kFlush of
# csrc/res_block_2d.cu)
K7_FLUSH = 2


def _emulated_conv(terms: str):
    """A stand-in for ops.conv.conv2d (3x3, reflect pad 1) that runs the conv as K7 does on the
    tensor cores: the field less its mean per (sample, channel), c; its (B*64 x 9C) windows
    times the (9C x C) taps, tap-major, an 8-deep step at a time; plus conv(c), one value a
    (sample, output channel) (summed in float64 here, in fp32 on the card). ``terms``
    "3xtf32": lo*hi, hi*lo, hi*hi in that order, with K7's partial sums; "1xtf32": hi*hi
    alone."""

    def conv(x, k, padding, pad_mode):
        assert padding == 1 and pad_mode == "reflect"
        f = x.numpy()
        c = f.mean(axis=(1, 2), keepdims=True, dtype=np.float32)
        a = _windows(f - c)
        w = np.ascontiguousarray(k.numpy().reshape(-1, k.shape[-1]))
        ah, wh = _tf32(a), _tf32(w)
        pairs = [(_tf32(a - ah), wh), (ah, _tf32(w - wh)), (ah, wh)] if terms == "3xtf32" \
            else [(ah, wh)]
        out = _mma_product(pairs, a.shape[0], w.shape[1], a.shape[1],
                           K7_FLUSH if terms == "3xtf32" else None)
        kc = np.einsum("bc,tcd->bd", c[:, 0, 0].astype(np.float64),
                       w.reshape(9, f.shape[-1], -1).astype(np.float64)).astype(np.float32)
        return torch.from_numpy(out.reshape(*x.shape[:3], w.shape[1]) + kc[:, None, None, :])

    return conv


@pytest.mark.parametrize("adain", [False, True])
@pytest.mark.parametrize("b", [2, 4])
def test_3xtf32_block_keeps_fp32_accuracy_at_k7_shapes(monkeypatch, b, adain):
    """The whole block with both convs as K7 runs them in 3xTF32 (the plain block, its conv
    replaced by the emulation): y, d1 and d2 against the float64 block, each within twice the
    plain fp32 block's error (largest error over the largest magnitude). The same block with
    1xTF32 products is not: its errors are 500-1,000 times the plain block's."""
    rng = np.random.default_rng(13 + b)
    c = 64
    x = rng.standard_normal((b, 8, 8, c)).astype(np.float32)
    k1, k2 = ((0.1 * rng.standard_normal((3, 3, c, c))).astype(np.float32) for _ in range(2))
    affine = [rng.standard_normal((b, c)).astype(np.float32) for _ in range(4)] if adain else []
    t = [torch.from_numpy(a) for a in (x, k1, k2, *affine)]
    want = res2d.res_block_2d_ref(*(a.double() for a in t), save=True)

    def errors(conv=None):
        if conv is not None:
            monkeypatch.setattr(res2d, "conv2d", conv)
        got = res2d.res_block_2d_ref(*t, save=True)
        return {k: float((g.double() - w).abs().max() / w.abs().max())
                for k, g, w in zip(("y", "d1", "d2"), got, want)}

    plain = errors()
    x3, x1 = errors(_emulated_conv("3xtf32")), errors(_emulated_conv("1xtf32"))
    for k in plain:
        assert x3[k] <= 2 * plain[k], (k, x3, plain)
        assert x1[k] > 2 * plain[k], (k, x1, plain)
