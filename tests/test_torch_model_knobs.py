"""Two model knobs of the port against the JAX package: ``--env_conv_init``
and ``--use_soft``.

* ``--env_conv_init torch`` draws only the env branch's conv taps from
  torch's default U(+-1/sqrt(fan_in)) (JAX tests/test_models.py:165-196,
  ported): at conv_type 1 and 3, in EMNet and IdentifierSep, every other
  parameter keeps its seeded value. It raises ValueError at conv_type 2, as
  JAX's config does (iinsvae_tpu/config.py:215-223).
* ``--use_soft``: the semi step of the 1-D model (one residual block) in fp32
  against the JAX step on its composed path (``set_pallas_enabled(False)``,
  restored after this module), with the mask and the restorer's eps drawn as
  the JAX step draws them from its key (steps.py:135-150: ``k_mask, k_sample,
  k_drop = split(key, 3)``, ``k_env, k_soft = split(k_sample)``, eps =
  ``normal(k_soft, (B, 1))``) and injected: the loss and its parts, every
  gradient, the parameters after 1 and 3 Adam steps. The soft RestorerLinear
  head alone in bfloat16 at the 2-D code's width of 128 (its sample and its
  mu, and their VJP) against JAX's bfloat16 head, K4 in interpret mode. A JAX
  soft checkpoint through ``bridge`` (``model_geometry`` reads ``soft``) and
  ``Predictor``, which serves mu.

JAX's variables are the port's seeded parameters as a flax tree, which must
have the JAX model's own keys and shapes (``init`` traced, not run).

Tolerances: fp32 rtol 5e-4 / atol 5e-5 and the parameters in units of lr as
tests/test_torch_training.py states them (after one step entries whose JAX
gradient is >= 1e-6 within 0.01 lr, the rest within 1 lr; after three steps
within 3 lr, the mean within 0.05 lr). bfloat16 at the ratios of
tests/test_torch_bf16.py: each output's largest error against JAX's fp32
result at most 1.5 times JAX bfloat16's own, plus 1 ulp of the result's
largest magnitude; the gradients' mean relative RMS error against JAX's fp32
ones at most 1.5 times JAX bfloat16's, plus 2^-8, and each tensor's at most 6
times, plus 2^-8.
"""

import argparse

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu import config as jconfig
from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.models.heads import RestorerLinear as JaxRestorerLinear
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.cli import train_semi
from iinsvae_torch.config import add_args, add_train_args, from_args
from iinsvae_torch.models.emnet import EMNet, IdentifierSep
from iinsvae_torch.models.heads import Restorer
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import steps
from iinsvae_torch.training.state import create_train_state

RTOL, ATOL = 5e-4, 5e-5
LR = 1e-3
B = 8
BF = torch.bfloat16
SMALL = dict(cir_len=157, num_classes=5, style_dim=16, n_residual=1)
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
           "count", "sup_count")


def _parse(argv):
    parser = argparse.ArgumentParser()
    add_args(parser)
    add_train_args(parser)
    return from_args(parser.parse_args(argv))


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_variables(port, jax_model, *example) -> dict:
    """The port's variables as a flax tree, which must have the JAX model's own keys and
    shapes (``init`` traced by ``jax.eval_shape``, not run)."""
    flat = bridge.to_flax_numpy(port.state_dict())
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)}, *example)
    assert {k: v.shape for k, v in flat.items()} == {
        "params/" + k: v.shape
        for k, v in flax.traverse_util.flatten_dict(shapes["params"], sep="/").items()}
    tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in flat.items()})
    return {"batch_stats": {}, **tree}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------ --env_conv_init ------------------------------

# the env branch's conv taps: the kernels of the env encoders' convs (their biases keep
# torch's default under either init)
MODELS = {
    "conv_type 1": (lambda init: IInsVAE(conv_type=1, style_dim=16, env_conv_init=init),
                    "encoder.env_encoder.", "ConvINAct_0.kernel"),
    "conv_type 3": (lambda init: IInsVAE(conv_type=3, style_dim=16, env_conv_init=init),
                    "encoder.env_encoder.", "Conv2d_0.kernel"),
    "EMNet": (lambda init: EMNet(env_conv_init=init), "backbone.env_encoder.",
              "ConvINAct_0.kernel"),
    "IdentifierSep": (lambda init: IdentifierSep(env_conv_init=init), "env_encoder.",
                      "ConvINAct_0.kernel"),
}


@pytest.mark.parametrize("which", sorted(MODELS))
def test_env_conv_init_torch_changes_only_the_env_kernels(which):
    make, env, in_conv = MODELS[which]
    ref, tor = dict(make("reference").named_parameters()), dict(make("torch").named_parameters())
    assert set(ref) == set(tor)
    changed = sorted(n for n in ref if not torch.equal(ref[n], tor[n]))
    kernels = sorted(n for n in ref if n.startswith(env) and n.endswith(".kernel"))
    assert changed == kernels and len(kernels) == 4
    for n in kernels:
        fan_in = int(np.prod(ref[n].shape[:-1]))
        assert ref[n].abs().max() < 0.12  # ~5 sigma of N(0, 0.02)
        assert tor[n].abs().max() <= 1.0 / np.sqrt(fan_in) + 1e-6
        assert tor[n].abs().max() > 0.5 / np.sqrt(fan_in)
    # the in-conv: (7, 1, 16) taps, fan_in 7, torch's bound 0.378
    assert tor[env + in_conv].abs().max() > 0.15


def test_env_conv_init_flag_reaches_the_models_and_raises_at_conv_type_2(monkeypatch):
    for conv_type in ("1", "3"):
        cfg = _parse(["--env_conv_init", "torch", "--conv_type", conv_type])
        assert cfg.model_kwargs()["env_conv_init"] == "torch"
        assert cfg.joint_kwargs()["env_conv_init"] == "torch"
    assert _parse([]).model_kwargs()["env_conv_init"] == "reference"
    with pytest.raises(ValueError, match="diverges"):
        _parse(["--env_conv_init", "torch", "--conv_type", "2"])
    with pytest.raises(ValueError, match="diverges"):  # the JAX package's own check
        jconfig.from_args(jconfig.add_args(argparse.ArgumentParser()).parse_args(
            ["--env_conv_init", "torch", "--conv_type", "2"]))

    def no_model(*args, **kwargs):
        raise AssertionError("a model was built")

    monkeypatch.setattr(train_semi, "IInsVAE", no_model)
    with pytest.raises(ValueError, match="diverges"):
        train_semi.main(["--device", "cpu", "--conv_type", "2", "--env_conv_init", "torch"])


# ------------------------------ --use_soft ------------------------------


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    weight = np.ones(B, np.float32)
    weight[5] = 0.0  # a padded row
    return {"cir": rng.normal(size=(B, 157)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
            "label": rng.integers(0, 5, size=(B, 1)).astype(np.float32),
            "weight": weight}


def test_soft_semi_step_matches_jax(batch):
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        model = JaxIInsVAE(conv_type=1, soft=True, **SMALL)
        port = IInsVAE(conv_type=1, soft=True, **SMALL,
                       generator=torch.Generator().manual_seed(6))
        variables = _jax_variables(port, model, jnp.ones((2, 157)))
        rate = 0.5
        tx = joptim.make_optimizer(LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                                   steps_per_epoch=1)
        jstate_ = jstate.create_train_state(model, variables, tx)
        jgrads = jax.jit(jsteps.make_semi_grads_fn(model, rate))
        japply = jax.jit(lambda s_, g_: s_.apply_gradients(g_))  # eager, optax dispatches op by op
        state = create_train_state(port, LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                                   steps_per_epoch=1)
        grads_fn = steps.make_semi_grads_fn(rate)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        base = jax.random.PRNGKey(3)
        for i in range(3):
            key = jax.random.fold_in(base, i)
            grads, jm, _ = jgrads(jstate_, jbatch, key)
            k_mask, k_sample, _ = jax.random.split(key, 3)
            mask = np.asarray(jax.random.bernoulli(k_mask, rate, (B,)), np.float32)
            eps = np.asarray(jax.random.normal(jax.random.split(k_sample)[1], (B, 1)))
            tm = grads_fn(port, tbatch, sup_mask=torch.tensor(mask), soft_eps=torch.tensor(eps))
            for k in METRICS:
                _close(tm[k].item(), float(jm[k]), f"step {i} {k}")
            if i == 0:
                assert 0 < mask.sum() < B and np.abs(eps).max() > 0.1
                first = _flat(grads)
                got = bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()})
                assert set(got) == set(first)
                assert got["params/restorer/restorer/w3"].shape == (256, 2)
                assert np.abs(got["params/restorer/restorer/w3"][:, 1]).max() > 0  # logvar
                for k, v in first.items():
                    _close(got[k], v, f"gradient {k}")
            jstate_ = japply(jstate_, grads)
            state.apply_gradients()
            got = bridge.to_flax_numpy(dict(port.named_parameters()))
            diff = {k: np.abs(got[k] - v) / LR for k, v in _flat(jstate_.params).items()}
            if i == 0:
                for k, d in diff.items():
                    big = np.abs(first[k]) >= 1e-6
                    assert d[big].max(initial=0.0) <= 0.01 and d.max() <= 1.0, k
            if i == 2:
                everything = np.concatenate([d.ravel() for d in diff.values()])
                assert everything.max() <= 3.0 and everything.mean() <= 0.05
    finally:
        pallas_fused.set_pallas_enabled(was)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(v), 2.0**-126))) - 7)


def _ratio_check(port, jax_bf16, jax_f32, what):
    ref = _np(jax_f32).astype(np.float64)
    e_port = np.abs(_np(port) - ref).max()
    e_jax = np.abs(_np(jax_bf16) - ref).max()
    assert e_port <= 1.5 * e_jax + _ulp(np.abs(ref).max()), f"{what}: {e_port} vs {e_jax}"


def _rel_rms(got, ref) -> float:
    ref = _np(ref).astype(np.float64)
    return float(np.sqrt(((_np(got) - ref) ** 2).mean() / (ref**2).mean()))


def test_soft_restorer_head_bf16_matches_jax():
    """The soft RestorerLinear at the 2-D code's width (128 -> 512 -> 256 -> 256 -> 2) in
    bfloat16: its sample with JAX's bfloat16 eps (drawn from the head's key) and its VJP with
    respect to the code and the parameters, and its mu, against JAX's head (K4 in interpret
    mode), each against JAX's fp32 head on the same eps."""
    b = 24
    rng = np.random.default_rng(13)
    code = rng.normal(size=(b, 8, 8, 2)).astype(np.float32)
    port = Restorer((8, 8, 2), "Linear", soft=True, generator=torch.Generator().manual_seed(7))
    params = {n: jnp.asarray(p.detach()) for n, p in port.restorer.named_parameters()}
    head = JaxRestorerLinear(soft=True)
    key = jax.random.PRNGKey(9)
    eps16 = jax.random.normal(key, (b, 1), jnp.bfloat16)
    g = rng.normal(size=(b, 1)).astype(np.float32)

    plain = JaxRestorerLinear(soft=False)

    def jax_run(dtype, sample_key, eps=None):
        def f(c, p):
            if eps is None:
                return head.apply({"params": p}, c, sample_key=sample_key)
            # the fp32 reference of a sample: the head's mu and logvar, with the bfloat16 eps
            mu, logvar = (plain.apply({"params": {**p, "w3": p["w3"][:, q:q + 1],
                                                  "b3": p["b3"][q:q + 1]}}, c) for q in (0, 1))
            return eps * jnp.exp(logvar / 2.0) + mu
        c = jnp.asarray(code, dtype)
        p = {n: v.astype(dtype) for n, v in params.items()}
        out, vjp = jax.vjp(f, c, p)
        return out, vjp(jnp.asarray(g, dtype))

    want16, (dc16, dp16) = jax_run(jnp.bfloat16, key)
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)  # fp32: the composed chain is the kernel's math
    try:
        want32, (dc32, dp32) = jax_run(jnp.float32, None, eps16.astype(jnp.float32))
        mu32 = head.apply({"params": params}, jnp.asarray(code))
    finally:
        pallas_fused.set_pallas_enabled(was)
    leaves = [torch.tensor(code).to(BF).requires_grad_(True)]
    got = port(leaves[0], torch.tensor(_np(eps16)).to(BF))
    assert got.dtype == BF and got.shape == (b, 1)
    _ratio_check(got, want16, want32, "sample")
    got.backward(torch.tensor(g).to(BF))
    _ratio_check(leaves[0].grad, dc16, dc32, "dcode")
    e_port = [_rel_rms(p.grad, dp32[n]) for n, p in port.restorer.named_parameters()]
    e_jax = [_rel_rms(dp16[n], dp32[n]) for n, _ in port.restorer.named_parameters()]
    assert np.mean(e_port) <= 1.5 * np.mean(e_jax) + 2.0**-8, (e_port, e_jax)
    assert all(a <= 6 * e + 2.0**-8 for a, e in zip(e_port, e_jax)), (e_port, e_jax)
    # mu, without a sample: its forward
    mu16 = head.apply({"params": {n: v.astype(jnp.bfloat16) for n, v in params.items()}},
                      jnp.asarray(code, jnp.bfloat16))
    with torch.no_grad():
        _ratio_check(port(torch.tensor(code).to(BF)), mu16, mu32, "mu")


def test_soft_checkpoint_serves_mu(tmp_path):
    """A JAX soft checkpoint (an export_serving npz): ``model_geometry`` reads ``soft`` from
    the restorer's last width, and ``Predictor`` serves the restorer's mu, JAX's forward
    without a sample key."""
    model = JaxIInsVAE(conv_type=1, soft=True, **SMALL)
    port = IInsVAE(conv_type=1, soft=True, **SMALL, generator=torch.Generator().manual_seed(8))
    variables = _jax_variables(port, model, jnp.ones((2, 157)))
    npz = tmp_path / "weights.npz"
    np.savez(npz, **_flat(variables["params"]), **{"batch_stats/__empty__": np.zeros(0)})
    state = bridge.load_npz(str(npz))
    assert bridge.model_geometry(state) == dict(
        conv_type=1, dim=4, n_downsample=4, n_residual=1, range_dim=2, style_dim=16,
        num_classes=5, soft=True)
    cirs = np.random.default_rng(14).normal(size=(6, 157)).astype(np.float32)
    want = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))(
        variables, jnp.asarray(cirs))
    pred = Predictor.from_npz(str(npz), batch_size=4, device="cpu")
    got = pred(cirs)
    _close(got.err_est, want["err_est"], "err_est")
    with torch.inference_mode():  # the head's two outputs (mu, logvar): the first is served
        range_code, _ = pred.model.encode(torch.tensor(cirs))
        out = pred.model.restorer.restorer(range_code)
    np.testing.assert_array_equal(got.err_est, out[:, :1].numpy())
