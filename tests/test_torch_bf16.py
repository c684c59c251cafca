"""bfloat16 training of the expanded 2-D model (``--compute_dtype bfloat16``)
against the JAX package's bfloat16 path, on the CPU.

* K7's plain bfloat16 version (res2d.res_block_2d_bf16_ref, with the closed-
  form backward backward.res_block_2d_bwd_bf16_ref) against
  ``fused_res_block_2d`` on bfloat16 inputs in interpret mode, IN and AdaIN,
  forward and VJP, on the samples whose every pre-ReLU value clears
  MASK_MARGIN of the sample's largest (there the ReLU mask is not decided by
  rounding).
* K4's plain bfloat16 version (fused.mlp_chain_bf16_ref, with
  backward.mlp_chain_bwd_bf16_ref) against ``fused_mlp_chain`` on bfloat16
  inputs at the 2-D restorer's and the classifier's widths, forward and VJP;
  and two variants that must fail: the chain rounded to bfloat16 between
  layers (JAX's composed heads.py:45, not its kernel), and the backward's
  layer inputs taken from fp32 d_j instead of the bfloat16 ones K4 saved.
* The whole 2-D model (dim 2, one residual block, the flagship's heads) in
  bfloat16: its forward and one semi step (loss, gradients; parameters after
  1 and 3 Adam steps) against JAX's, the mask drawn as the JAX step draws it
  and injected. JAX runs its Pallas entries (res2d and the MLP chain) in
  interpret mode, as tests/test_torch_2d.py's serving tests do.
* The bfloat16 weight sums: a batch of 437 real rows counts 436, as in JAX.
* The CLIs: ``train_semi --conv_type 2 --compute_dtype bfloat16`` trains,
  checkpoints and resumes bit-equal; ``evaluate`` takes the flag; bfloat16
  with conv_type 1 or 3, the Conv heads, ``run`` or ``run_sep`` raises
  NotImplementedError.

Tolerances (ulp: a bfloat16 unit in the last place, 2^(e - 7) at 2^e):
* K7 and K4 forward, and the input gradient dx: each element within 1 ulp of
  JAX's (at its own magnitude).
* K4's dW and db: each element within 1 ulp.
* K7's taps' gradient: within 2 ulps of its largest entry; the AdaIN tables'
  gradients within 4 ulps of their largest entry. The Pallas backward rounds
  each of the lane-mix matrix's 8 column blocks of d(taps) (res2d.py:246-253)
  and each of a sample's 8 row partials of dgamma and dbeta (:222-225) to
  bfloat16 before they are summed; the port sums in fp32 and rounds once. Where
  those partials cancel, an element's own ulp is far below their rounding
  (the largest differences seen, in units of the tensor's largest entry's ulp:
  1 for dk, 2 for the tables).
* The whole model (batch 32): each output, the loss and its parts: the
  largest error against JAX's fp32 result at most 1.5 times JAX bfloat16's
  own largest error against it, plus 1 ulp of the fp32 result's largest
  magnitude. Gradients: a bfloat16 step's gradient errors are dominated by
  discrete flips, the L1 loss's signs and the ReLU masks that rounding
  decides, which fall in different places in two bfloat16 implementations;
  a small tensor's error (a conv's bias, a few summed flips) then swings by
  several times between them. So the gradients are held as a whole: the mean
  over the gradient tensors of each one's relative RMS error against JAX's
  fp32 gradient at most 1.5 times JAX bfloat16's mean, plus 2^-8; and each
  tensor's at most 6 times JAX bfloat16's, plus 2^-8. (Measured at three
  seeds while this test was written: the port's mean 0.09-0.16 against
  JAX bfloat16's 0.19-0.51; the worst tensor 5.4 times JAX's, a 2-entry
  bias.) The range encoder's conv biases before an InstanceNorm have a true
  gradient of 0: both sides give rounding noise there, held below 1 ulp of
  the model's largest gradient; the residual blocks' conv biases, no K7
  input, get exactly 0 on both sides. Parameters in units of lr: Adam's
  first update is lr g / (|g| + 1e-8), so an entry whose gradient is
  rounding noise moves by up to lr with a sign rounding decides
  (tests/test_torch_2d.py). After one step entries whose JAX gradient is
  clear of its bfloat16 noise agree within 0.05 lr and all within 2 lr;
  after three steps within 3 lr and 6 lr, and the mean difference at most
  1.5 times the mean difference of JAX bfloat16's parameters from JAX
  fp32's, plus 0.01 lr.
"""

import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.ops.pallas.fused import fused_mlp_chain
from iinsvae_tpu.ops.pallas.res2d import fused_res_block_2d
from iinsvae_tpu.training import losses as jlosses
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.cli import evaluate as evaluate_cli
from iinsvae_torch.cli import run, run_sep, train_semi
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.conv import conv2d
from iinsvae_torch.ops.kernels import backward as bw
from iinsvae_torch.ops.kernels import fused, res2d
from iinsvae_torch.ops.norms import adain, instance_norm
from iinsvae_torch.training import losses, steps
from iinsvae_torch.training.state import create_train_state

BF = torch.bfloat16
MASK_MARGIN = 1e-5
LR = 1e-3
B = 32
SMALL = dict(cir_len=157, num_classes=5, style_dim=16, dim=2, n_residual=1)
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae")
NORMED_BIASES = ("encoder/range_encoder/in_bias",) + tuple(
    f"encoder/range_encoder/down{j}_bias" for j in range(4))


def _bf(a) -> np.ndarray:
    """numpy float32 rounded to bfloat16 values."""
    return torch.tensor(np.asarray(a, np.float32)).to(BF).float().numpy()


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ulp(v: np.ndarray) -> np.ndarray:
    m = np.maximum(np.abs(np.asarray(v, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(m)) - 7)


def _within_ulps(got, want, n: float, what: str) -> None:
    """Each element within n ulps at the larger magnitude of the two."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, what
    u = np.abs(got - want) / _ulp(np.maximum(np.abs(got), np.abs(want)))
    assert u.max(initial=0.0) <= n, f"{what}: {u.max()} ulps, at {np.unravel_index(u.argmax(), u.shape)}"


def _within_scale_ulps(got, want, n: float, what: str) -> None:
    """Every element within n ulps of the tensor's largest magnitude."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = _ulp(np.abs(want).max())
    d = np.abs(got - want).max() / scale
    assert d <= n, f"{what}: {d} ulps of the largest entry"


# ------------------------------ K7 ------------------------------


@pytest.fixture(scope="module")
def block_data():
    rng = np.random.default_rng(4)
    b, c = 6, 16
    x = _bf(rng.standard_normal((b, 8, 8, c)))
    k1 = _bf(0.1 * rng.standard_normal((3, 3, c, c)))
    k2 = _bf(0.1 * rng.standard_normal((3, 3, c, c)))
    affine = [_bf(rng.standard_normal((b, c))) for _ in range(4)]
    g = _bf(rng.standard_normal((b, 8, 8, c)))
    return x, k1, k2, affine, g


def _jax_block(norm):
    if norm == "in":
        return lambda x, k1, k2: fused_res_block_2d(x, k1, k2, norm="in")
    return lambda x, k1, k2, g1, b1, g2, b2: fused_res_block_2d(
        x, k1, k2, norm="adain", gamma1=g1, beta1=b1, gamma2=g2, beta2=b2)


def _clear(x, k1, *affine) -> np.ndarray:
    """The samples whose every pre-ReLU value (float64) clears MASK_MARGIN of the sample's
    largest."""
    d1 = conv2d(torch.tensor(x).double(), torch.tensor(k1).double(), padding=1,
                pad_mode="reflect")
    a1 = (adain(d1, *(torch.tensor(t).double() for t in affine[:2])) if affine
          else instance_norm(d1)).abs().flatten(1)
    clear = (a1.amin(dim=1) >= MASK_MARGIN * a1.amax(dim=1)).numpy()
    assert clear.mean() >= 0.5
    return clear


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_res_block_2d_bf16_forward_and_vjp_match_pallas(block_data, norm):
    x, k1, k2, affine, g = block_data
    args = [x, k1, k2] + (affine if norm == "adain" else [])
    out, vjp = jax.vjp(_jax_block(norm), *(jnp.asarray(a, jnp.bfloat16) for a in args))
    want = vjp(jnp.asarray(g, jnp.bfloat16))
    targs = [torch.tensor(a).to(BF) for a in args]
    y, d1, d2 = res2d.res_block_2d_bf16_ref(*targs, save=True)
    assert y.dtype == d1.dtype == d2.dtype == BF
    clear = _clear(x, k1, *affine)
    _within_ulps(y[clear], _np(out)[clear], 1, "y")
    got = bw.res_block_2d_bwd(torch.tensor(g).to(BF), *targs, saved=(d1, d2))
    assert len(got) == len(args) and all(t.dtype == BF for t in got)
    _within_ulps(got[0][clear], _np(want[0])[clear], 1, "dx")
    for i, (a, w) in enumerate(zip(got[1:3], want[1:3])):
        _within_scale_ulps(a, w, 2, f"dk{i + 1}")
    for i, (a, w) in enumerate(zip(got[3:], want[3:])):
        _within_scale_ulps(a[clear], _np(w)[clear], 4, f"affine {i}")
    # the wrapper under autograd takes the same forward and backward
    leaves = [t.clone().requires_grad_(True) for t in targs]
    y2 = res2d.res_block_2d(*leaves)
    assert torch.equal(y2, y)
    for a, b in zip(torch.autograd.grad(y2, leaves, torch.tensor(g).to(BF)), got):
        assert torch.equal(a, b)


# ------------------------------ K4 ------------------------------

HEADS = {"restorer.2d": (128, 512, 256, 256, 1), "classifier": (16, 16, 32, 16, 5)}
SLOPES = (0.2, 0.2, 0.2, 1.0)


@pytest.fixture(scope="module", params=sorted(HEADS))
def chain(request):
    dims = HEADS[request.param]
    rng = np.random.default_rng(5)
    b = 24
    x = _bf(rng.standard_normal((b, dims[0])))
    ws = [_bf(rng.uniform(-1, 1, (a, k)) / np.sqrt(a)) for a, k in zip(dims, dims[1:])]
    bs = [_bf(rng.uniform(-1, 1, k) / np.sqrt(a)) for a, k in zip(dims, dims[1:])]
    g = _bf(rng.standard_normal((b, dims[-1])))
    out, vjp = jax.vjp(lambda x_, w_, b_: fused_mlp_chain(x_, list(w_), list(b_), SLOPES),
                       jnp.asarray(x, jnp.bfloat16),
                       tuple(jnp.asarray(w, jnp.bfloat16) for w in ws),
                       tuple(jnp.asarray(v, jnp.bfloat16) for v in bs))
    dx, dws, dbs = vjp(jnp.asarray(g, jnp.bfloat16))
    # the pre-activations the Pallas forward saves (fused.py:1081): its body's arithmetic in
    # jnp, whose output is the kernel's bit for bit. K4b's check takes these, so that a 1-ulp
    # difference of the two forwards' d_j (their sums' order) does not enter it.
    y, jds = jnp.asarray(x), []
    for w, v, s in zip(ws, bs, SLOPES):
        d = jnp.dot(y, jnp.asarray(w), preferred_element_type=jnp.float32) + jnp.asarray(v)
        jds.append(np.asarray(d))
        y = jnp.where(d > 0, d, s * d)
    np.testing.assert_array_equal(_np(y.astype(jnp.bfloat16)), _np(out))
    torch_in = [torch.tensor(x).to(BF), [torch.tensor(w).to(BF) for w in ws],
                [torch.tensor(v).to(BF) for v in bs], torch.tensor(g).to(BF),
                [torch.tensor(d) for d in jds]]
    return torch_in, (out, dx, dws, [d.reshape(-1) for d in dbs])


def test_mlp_chain_bf16_forward_and_vjp_match_pallas(chain):
    (x, ws, bs, g, jds), (out, dx, dws, dbs) = chain
    y, ds = fused.mlp_chain_bf16_ref(x, ws, bs, SLOPES, save_pre=True)
    assert y.dtype == BF and all(d.dtype == BF for d in ds)
    _within_ulps(y, out, 1, "y")
    for j, (a, w) in enumerate(zip(ds, jds)):
        _within_ulps(a, w.to(BF), 1, f"d{j}")
    gx, gws, gbs = bw.mlp_chain_bwd(g, x, ws, bs, SLOPES, [d.to(BF) for d in jds])
    _within_ulps(gx, dx, 1, "dx")
    for j, (a, w) in enumerate(zip(gws, dws)):
        _within_ulps(a, w, 1, f"dW{j}")
    for j, (a, w) in enumerate(zip(gbs, dbs)):
        _within_ulps(a, w, 1, f"db{j}")
    # the wrapper under autograd takes the same forward and backward
    leaves = [t.clone().requires_grad_(True) for t in [x, *ws, *bs]]
    n = len(ws)
    y2 = fused.mlp_chain(leaves[0], leaves[1:1 + n], leaves[1 + n:], SLOPES)
    assert torch.equal(y2, y)
    want = bw.mlp_chain_bwd(g, x, ws, bs, SLOPES, ds)
    for a, b in zip(torch.autograd.grad(y2, leaves, g), [want[0], *want[1], *want[2]]):
        assert torch.equal(a, b)


def _over_one_ulp(got, want) -> bool:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return bool((np.abs(got - want) / _ulp(np.maximum(np.abs(got), np.abs(want))) > 1).any())


def test_mlp_chain_bf16_variants_do_not_match_pallas(chain):
    """The two ways to get K4's bfloat16 function wrong that the 1-ulp check above must see."""
    (x, ws, bs, g, jds), (out, dx, dws, dbs) = chain
    # (a) the chain rounded to bfloat16 between layers
    y = x
    for w, b, s in zip(ws, bs, SLOPES):
        d = (y.float() @ w.float() + b.float()).to(BF)
        y = d if s == 1.0 else torch.nn.functional.leaky_relu(d, s)
    assert _over_one_ulp(y, out)
    # (b) the backward's layer inputs from the fp32 d_j, not the bfloat16 ones K4 saved
    _, gws, _ = bw.mlp_chain_bwd_bf16_ref(g, x, ws, bs, SLOPES, jds)
    assert any(_over_one_ulp(a, w) for a, w in zip(gws, dws))
    _, gws, _ = bw.mlp_chain_bwd_bf16_ref(g, x, ws, bs, SLOPES, [d.to(BF) for d in jds])
    assert not any(_over_one_ulp(a, w) for a, w in zip(gws, dws))


# ------------------------- the whole model -------------------------


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def model2d():
    """The small 2-D model in JAX (its Pallas entries in interpret mode), its variables, the
    jitted grads function and a batch with one padded row."""
    model = JaxIInsVAE(conv_type=2, expand=True, **SMALL)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(1)}, jnp.ones((2, 157)))
    rng = np.random.default_rng(12)
    weight = np.ones(B, np.float32)
    weight[6] = 0.0
    batch = {"cir": rng.normal(size=(B, 157)).astype(np.float32),
             "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
             "label": rng.integers(0, 5, size=(B, 1)).astype(np.float32), "weight": weight}
    return model, variables, jax.jit(jsteps.make_semi_grads_fn(model, 0.5)), batch


def _jax_batch(batch, dtype):
    return {k: jnp.asarray(v, dtype if k in ("cir", "weight") else jnp.float32)
            for k, v in batch.items()}


def _port_batch(batch, dtype):
    return {k: torch.tensor(v).to(dtype if k in ("cir", "weight") else torch.float32)
            for k, v in batch.items()}


def _ratio_check(port, jax_bf16, jax_f32, what):
    """The port's largest error against JAX's fp32 result at most 1.5 times JAX bfloat16's
    own, plus 1 ulp of the result's largest magnitude."""
    ref = _np(jax_f32).astype(np.float64)
    e_port = np.abs(_np(port) - ref).max(initial=0.0)
    e_jax = np.abs(_np(jax_bf16) - ref).max(initial=0.0)
    floor = _ulp(np.abs(ref).max(initial=0.0))
    assert e_port <= 1.5 * e_jax + floor, f"{what}: port {e_port} against JAX bf16 {e_jax}"


def _rel_rms(got, ref) -> float:
    ref = _np(ref).astype(np.float64)
    return float(np.sqrt(((_np(got) - ref) ** 2).mean() / (ref**2).mean()))


def test_forward_2d_bf16_matches_jax(model2d):
    model, variables, _, batch = model2d
    apply = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))
    want32 = apply(variables, jnp.asarray(batch["cir"]))
    want16 = apply(variables, jnp.asarray(batch["cir"], jnp.bfloat16))
    port = IInsVAE(conv_type=2, **SMALL)
    port.load_state_dict(bridge.from_flax_numpy(_flat(variables["params"])))
    with torch.no_grad():
        got = port(torch.tensor(batch["cir"]).to(BF))
    for key in ("range_code", "env_code", "err_est", "logits", "recon"):
        assert got[key].dtype == BF and want16[key].dtype == jnp.bfloat16, key
        _ratio_check(got[key], want16[key], want32[key], key)


def _jax_mask(key, rate):
    return np.asarray(jax.random.bernoulli(jax.random.split(key, 3)[0], rate, (B,)), np.float32)


def test_semi_step_2d_bf16_matches_jax(model2d):
    model, variables, jgrads, batch = model2d
    rate = 0.5
    tx = joptim.make_optimizer(LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    jstate_ = jstate32 = jstate.create_train_state(model, variables, tx)
    port = IInsVAE(conv_type=2, **SMALL)
    port.load_state_dict(bridge.from_flax_numpy(_flat(variables["params"])))
    state = create_train_state(port, LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    grads_fn = steps.make_semi_grads_fn(rate)
    jb16, jb32 = _jax_batch(batch, jnp.bfloat16), _jax_batch(batch, jnp.float32)
    tbatch = _port_batch(batch, BF)
    base = jax.random.PRNGKey(5)
    for i in range(3):
        key = jax.random.fold_in(base, i)
        grads, jm, _ = jgrads(jstate_, jb16, key)
        grads32, jm32, _ = jgrads(jstate32, jb32, key)
        mask = _jax_mask(key, rate)
        tm = grads_fn(port, tbatch, sup_mask=torch.tensor(mask))
        assert tm["count"].dtype == BF and float(tm["count"]) == float(jm["count"]) == B - 1
        assert float(tm["correct"]) == float(jm["correct"])
        if i == 0:
            assert 0 < mask.sum() < B
            for k in METRICS:
                _ratio_check(tm[k].item(), float(jm[k]), float(jm32[k]), k)
            first, first32 = _flat(grads), _flat(grads32)
            got = bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()})
            assert set(got) == set(first) and all(v.dtype == np.float32 for v in got.values())
            largest = max(np.abs(v).max() for v in first32.values())
            port_err, jax_err = [], []
            for k, v in first32.items():
                if k.endswith(NORMED_BIASES):
                    assert np.abs(got[k]).max() <= _ulp(largest), k
                    continue
                if not v.any():  # the residual blocks' conv biases: no K7 input
                    assert not got[k].any() and not first[k].any(), k
                    continue
                port_err.append(_rel_rms(got[k], v))
                jax_err.append(_rel_rms(first[k], v))
                assert port_err[-1] <= 6 * jax_err[-1] + 2.0**-8, \
                    f"gradient {k}: {port_err[-1]} against JAX bf16 {jax_err[-1]}"
            assert np.mean(port_err) <= 1.5 * np.mean(jax_err) + 2.0**-8, \
                (np.mean(port_err), np.mean(jax_err))
        jstate_ = jstate_.apply_gradients(grads)
        jstate32 = jstate32.apply_gradients(grads32)
        state.apply_gradients()
        got = bridge.to_flax_numpy(dict(port.named_parameters()))
        want32 = _flat(jstate32.params)
        diff = {k: np.abs(got[k] - v) / LR for k, v in _flat(jstate_.params).items()}
        for k, d in diff.items():
            noise = np.abs(first[k] - first32[k]).max()
            big = np.abs(first[k]) > 4 * noise
            if i == 0:
                assert d[big].max(initial=0.0) <= 0.05 and d.max() <= 2.0, k
            if i == 2:
                assert d[big].max(initial=0.0) <= 3.0 and d.max() <= 6.0, k
        if i == 2:
            # on the mean, the port is no further from JAX bfloat16 than JAX bfloat16 from fp32
            mean = np.concatenate([d.ravel() for d in diff.values()]).mean()
            own = np.concatenate([np.abs(v - want32[k]).ravel() / LR
                                  for k, v in _flat(jstate_.params).items()]).mean()
            assert mean <= 1.5 * own + 0.01, (mean, own)
    assert state.step == 3


def test_bf16_weight_sums_round_as_in_jax():
    """jnp.sum(jnp.ones(437, bfloat16)) is 436 (bfloat16 steps by 2 above 256): the count of a
    batch of 500 with 437 real rows, the supervised count and the losses' denominators carry
    that rounding in both packages."""
    n, real = 500, 437
    rng = np.random.default_rng(3)
    w = np.zeros(n, np.float32)
    w[:real] = 1.0
    err_est = rng.normal(size=(n, 1)).astype(np.float32)
    err = rng.normal(size=(n, 1)).astype(np.float32)
    logits = rng.normal(size=(n, 5)).astype(np.float32)
    label = rng.integers(0, 5, (n, 1)).astype(np.float32)
    jm = jsteps._metrics(jnp.asarray(err_est, jnp.bfloat16), jnp.asarray(err),
                         jnp.asarray(logits, jnp.bfloat16), jnp.asarray(label),
                         jnp.asarray(w, jnp.bfloat16))
    tm = steps._metrics(torch.tensor(err_est).to(BF), torch.tensor(err),
                        torch.tensor(logits).to(BF), torch.tensor(label), torch.tensor(w).to(BF))
    assert float(jm["count"]) == float(tm["count"]) == 436.0
    assert tm["count"].dtype == BF and float(tm["correct"]) == float(jm["correct"])
    assert tm["se"].dtype == torch.float32
    np.testing.assert_allclose(float(tm["se"]), float(jm["se"]), rtol=1e-5)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    want = jlosses._wmean(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    got = losses._wmean(torch.tensor(x).to(BF), torch.tensor(w).to(BF))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    per_sample = torch.tensor(x).to(BF).float().mean(dim=1)
    assert float(got) == pytest.approx(float(per_sample[:real].sum()) / 436, rel=1e-5)
    assert float(torch.sum(torch.ones(real, dtype=BF))) == 436.0


# ------------------------------ CLIs ------------------------------

CLI = ["--device", "cpu", "--conv_type", "2", "--compute_dtype", "bfloat16", "--dataset_env",
       "room_full", "--synthetic_n", "70", "--batch_size", "28", "--sample_interval", "0",
       "--checkpoint_interval", "-1", "--decay_epoch", "1"]


def _dirs(tmp) -> list[str]:
    return ["--model_dir", os.path.join(tmp, "saved_models"),
            "--out_dir", os.path.join(tmp, "saved_results")]


def test_train_semi_bf16_resumes_bit_equal_and_evaluates(tmp_path):
    a, b = str(tmp_path / "continuous"), str(tmp_path / "resumed")
    state_a, m_a = train_semi.main(CLI + _dirs(a) + ["--n_epochs", "2"])
    train_semi.main(CLI + _dirs(b) + ["--n_epochs", "1"])
    state_b, m_b = train_semi.main(CLI + _dirs(b) + ["--n_epochs", "2", "--epoch", "1"])
    assert state_a.step == state_b.step == 2 * 2
    for (n, p), q in zip(state_a.model.named_parameters(), state_b.model.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), n
    assert m_a == m_b and np.isfinite(m_a["rmse"]) and 0.0 <= m_a["accuracy"] <= 1.0
    m = evaluate_cli.main(CLI + _dirs(a) + ["--test_epoch", "2"])
    assert m == m_a
    f32 = [("float32" if f == "bfloat16" else f) for f in CLI]
    m32 = evaluate_cli.main(f32 + _dirs(a) + ["--test_epoch", "2"])
    assert m32["rmse"] != m_a["rmse"]  # the same checkpoint in float32 evaluates differently


@pytest.mark.parametrize("argv", [
    ["train_semi", "--conv_type", "1"], ["train_semi", "--conv_type", "3"],
    ["train_semi", "--restorer_type", "Conv1d"], ["run"], ["run_sep"],
    ["evaluate", "--net", "joint"]])
def test_bf16_elsewhere_raises_before_a_model_is_built(argv, tmp_path, monkeypatch):
    def no_model(*a, **k):
        raise AssertionError("a model was built")

    monkeypatch.setattr(IInsVAE, "__init__", no_model)
    mains = {"train_semi": train_semi.main, "run": run.main, "run_sep": run_sep.main,
             "evaluate": evaluate_cli.main}
    flags = [f for f in CLI if f not in ("--conv_type", "2")] + _dirs(str(tmp_path))
    with pytest.raises(NotImplementedError, match="bfloat16"):
        mains[argv[0]](flags + argv[1:] + (["--conv_type", "2"] if len(argv) == 1 or
                                           argv[1] == "--restorer_type" else []))
