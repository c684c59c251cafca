"""The port's column-image model (conv_type=3, NoExpand) against the JAX package's.

* ``ResidualBlock2dNoExpand`` with InstanceNorm and with AdaIN, the Encoder
  (``RangeEncoder2dNoExpand``, ``EnvEncoder2dNoExpand``), the Decoder
  (``Decoder2dNoExpand``) and the whole ``IInsVAE(conv_type=3)`` forward with
  the Linear and the Conv1d heads, and the ``Conv2dNoExpand`` restorer, on the
  same parameters: the port's seeded ones as a flax tree, which must have the
  JAX model's own keys and shapes (``init`` traced, not run: compiling the
  JAX init would take most of this file's time). That tree, saved as an
  export_serving npz, is a JAX NoExpand checkpoint: ``Predictor.from_npz``
  serves it. The JAX model is built as its CLI builds it (``expand`` on,
  iinsvae_tpu/config.py:113-115).
* The semi step at a small geometry (one residual block) against the JAX
  step on its composed path (``set_pallas_enabled(False)``, restored after
  this module), the mask drawn as the JAX step draws it and injected: the
  loss and its parts, every gradient, and the parameters after 1 and 3 Adam
  steps; the port's gradients against its own float64 run. The conv biases
  before an InstanceNorm or AdaIN (the residual blocks' and the range
  encoder's stride-2 convs') are no input of the port's forward, so their
  gradient is exactly 0 (JAX's, which adds them before the norm, is rounding
  noise). The small geometry keeps the flagship's width (dim 4): at
  dim 2 a channel of the first stride-2 conv is near-constant at these seeds
  (std 3e-4), and its InstanceNorm (eps 1e-5) amplifies either framework's
  rounding some 300 times, so two fp32 implementations part by 5e-2.
* ``--restorer_type 3`` with ``--conv_type 3`` (the JAX package fails there
  with ZeroDivisionError) and conv_type 4 raise ValueError.
* ``train_semi``, ``evaluate`` and ``serve`` on ``--device cpu`` at
  ``--conv_type 3`` through a checkpoint, with ``--use_soft`` and
  ``--env_conv_init torch``.

Tolerances (fp32): outputs, losses and gradients rtol 5e-4 / atol 5e-5
(tests/test_lowering_parity.py); the port's fp32 gradients against its float64
ones rtol 1e-3 / atol 1e-4 of each gradient's largest magnitude. Parameters in
units of lr, as tests/test_torch_2d.py states them: after one step entries whose
JAX gradient is >= 1e-6 within 0.01 lr and the rest within 2 lr; after three
steps within 3 lr and 6 lr, the mean within 0.05 lr.
"""

import re

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.models.heads import Restorer as JaxRestorer
from iinsvae_tpu.models.layers import ResidualBlock2dNoExpand as JaxBlock
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.cli import evaluate as evaluate_cli
from iinsvae_torch.cli import serve as serve_cli
from iinsvae_torch.cli import train_semi
from iinsvae_torch.config import Config, add_args, add_train_args, from_args
from iinsvae_torch.models.encoders import env_kl, split_env_stats
from iinsvae_torch.models.heads import Restorer
from iinsvae_torch.models.layers import ResidualBlock2dNoExpand
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import steps
from iinsvae_torch.training.state import create_train_state

RTOL, ATOL = 5e-4, 5e-5
LR = 1e-3
B = 8
EXPAND = Config(conv_type=3).expand  # the JAX CLI's expand at conv_type 3: on
FLAGSHIP = dict(cir_len=157, num_classes=5, style_dim=16)
SMALL = dict(FLAGSHIP, n_residual=1)
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
           "count", "sup_count")
# the conv biases before a norm (the residual blocks' and the range encoder's stride-2 convs'):
# no input of the port's forward, gradient exactly 0
NORMED_BIAS = re.compile(r"params/((encoder/range_encoder|decoder/decoder)/ResidualBlock2dNoExpand_"
                         r"\d+/Conv2d_[01]|encoder/range_encoder/Conv2d_[1-4])/bias")


def _flat(tree, collection="params") -> dict[str, np.ndarray]:
    return {f"{collection}/{k}": np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _variables_flat(variables) -> dict[str, np.ndarray]:
    flat = _flat(variables["params"])
    if "batch_stats" in variables:
        flat.update(_flat(variables["batch_stats"], "batch_stats"))
    return flat


def _jax_variables(port, jax_model, *example) -> dict:
    """The port's variables as a flax tree, which must have the JAX model's own keys and
    shapes (``init`` traced by ``jax.eval_shape``, not run). A model's state goes through
    ``bridge.to_flax_numpy``; a lone module's is named alike (BatchNormEps's running mean and
    var in ``batch_stats``)."""
    if isinstance(port, IInsVAE):
        flat = bridge.to_flax_numpy(port.state_dict())
    else:
        flat = {("batch_stats/" if k.endswith((".mean", ".var")) else "params/")
                + k.replace(".", "/"): v.numpy() for k, v in port.state_dict().items()}
    shapes = jax.eval_shape(jax_model.init, {"params": jax.random.PRNGKey(0)}, *example)
    assert {k: v.shape for k, v in flat.items()} == {
        f"{c}/{k}": v.shape for c in shapes
        for k, v in flax.traverse_util.flatten_dict(shapes[c], sep="/").items()}
    tree = flax.traverse_util.unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                                              for k, v in flat.items()})
    return {"batch_stats": {}, **tree}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------ the modules ------------------------------


@pytest.mark.parametrize("norm", ["in", "adain"])
def test_residual_block_noexpand_matches_jax(norm):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 8, 1, 64)).astype(np.float32)
    tables = [(rng.normal(size=(5, 64)).astype(np.float32) + 1.0,
               rng.normal(size=(5, 64)).astype(np.float32)) for _ in range(2)]
    jt = [tuple(jnp.asarray(t) for t in pair) for pair in tables] if norm == "adain" else None
    port = ResidualBlock2dNoExpand(64, norm, generator=torch.Generator().manual_seed(4))
    params = {f"Conv2d_{i}": {n: jnp.asarray(getattr(port, f"Conv2d_{i}").__getattr__(n).detach())
                              for n in ("kernel", "bias")} for i in range(2)}
    want = JaxBlock(64, norm=norm).apply({"params": params}, jnp.asarray(x), jt)
    leaves = [torch.tensor(x[:, :, 0]).requires_grad_(True)]
    tt = [tuple(torch.tensor(t) for t in pair) for pair in tables] if norm == "adain" \
        else (None, None)
    got = port(leaves[0], tt)
    _close(got.detach().unsqueeze(2), want, f"block {norm}")
    got.square().sum().backward()
    for i in range(2):
        conv = getattr(port, f"Conv2d_{i}")
        assert conv.bias.grad is None and conv.kernel.grad.abs().max() > 0  # the norm removes it


@pytest.fixture(scope="module")
def cirs():
    return np.random.default_rng(7).normal(size=(13, 157)).astype(np.float32)


def test_predictor_and_forward_noexpand_match_jax(cirs, tmp_path):
    """The column-image flagship with the Linear heads: the whole forward (the codes, the
    KL, the heads, the reconstruction) against JAX's; its tree as a JAX checkpoint (an
    export_serving npz) through ``bridge``, the geometry it gives and the port's
    ``Predictor`` with the reconstruction (13 CIRs at batch 8 pad the tail batch)."""
    model = JaxIInsVAE(conv_type=3, expand=EXPAND, **FLAGSHIP)
    port = IInsVAE(conv_type=3, **FLAGSHIP, generator=torch.Generator().manual_seed(3))
    variables = _jax_variables(port, model, jnp.ones((2, 157)))
    jout = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))(
        variables, jnp.asarray(cirs))
    with torch.inference_mode():
        out = port(torch.tensor(cirs))
        out["kl"] = env_kl(*split_env_stats(out["env_code"]))
    assert out["range_code"].shape == (13, 8, 1, 2)
    for key in ("range_code", "env_code", "err_est", "logits", "kl", "recon"):
        _close(out[key], jout[key], key)

    npz = tmp_path / "weights.npz"
    np.savez(npz, **_flat(variables["params"]), **{"batch_stats/__empty__": np.zeros(0)})
    assert bridge.model_geometry(bridge.load_npz(str(npz))) == dict(
        conv_type=3, dim=4, n_downsample=4, n_residual=3, range_dim=2, style_dim=16,
        num_classes=5)
    got = Predictor.from_npz(str(npz), batch_size=8, return_recon=True, device="cpu")(cirs)
    probs = jax.nn.softmax(jout["logits"], axis=-1)
    for f, want in (("err_est", jout["err_est"]), ("label_probs", probs),
                    ("env_code", jout["env_code"]), ("recon", jout["recon"])):
        assert getattr(got, f).shape == want.shape, f
        _close(getattr(got, f), want, f)
    np.testing.assert_array_equal(got.label, np.argmax(np.asarray(probs), axis=-1))


def test_conv1d_heads_forward_noexpand_matches_jax(cirs):
    """The column model with the Conv1d restorer and classifier (BatchNormEps with running
    stats, moved off their init; eval mode): the restorer takes the code's column 0
    (heads.py:85-87). The tree with ``batch_stats`` goes through the bridge and its
    geometry."""
    kw = dict(restorer_type="Conv1d", classifier_type="Conv1d", **SMALL)
    model = JaxIInsVAE(conv_type=3, expand=EXPAND, **kw)
    port = IInsVAE(conv_type=3, **kw, generator=torch.Generator().manual_seed(4))
    for name, buf in port.named_buffers():
        if name.endswith((".mean", ".var")):
            buf.add_(0.25)
    variables = _jax_variables(port, model, jnp.ones((2, 157)))
    want = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))(
        variables, jnp.asarray(cirs))
    state = bridge.from_flax_numpy(_variables_flat(variables))
    geo = bridge.model_geometry(state)
    assert (geo["conv_type"], geo["restorer_type"], geo["classifier_type"]) == (3, "Conv1d",
                                                                              "Conv1d")
    back = IInsVAE(cir_len=157, **geo)
    back.load_state_dict(state)
    with torch.inference_mode():
        got = back.eval()(torch.tensor(cirs))
    for key in ("range_code", "env_code", "err_est", "logits", "recon"):
        _close(got[key], want[key], key)


def test_restorer_conv2d_noexpand_matches_jax():
    """``Restorer(net_type='Conv2dNoExpand')`` (heads.py:133-166), reachable from the
    constructor only, as in JAX: the code pooled to (32, 1), four (4,1) stride-2 convs, the
    BatchNormEps running stats in eval mode; soft, so its Dense gives (mu, logvar) and the
    head mu without a sample."""
    rng = np.random.default_rng(9)
    code = rng.normal(size=(6, 8, 1, 2)).astype(np.float32)
    head = JaxRestorer(soft=True, conv_type=3, expand=True, net_type="Conv2dNoExpand")
    port = Restorer((8, 1, 2), "Conv2dNoExpand", soft=True,
                    generator=torch.Generator().manual_seed(5)).eval()
    assert port.restorer.Dense_0.kernel.shape == (256, 2)
    for buf in port.buffers():
        buf.add_(0.3)  # running stats off their init
    variables = _jax_variables(port, head, jnp.asarray(code))
    want = jax.jit(lambda v, c: head.apply(v, c, train=False))(variables, jnp.asarray(code))
    with torch.inference_mode():
        _close(port(torch.tensor(code)), want, "mu")


# ------------------------- the training step -------------------------


@pytest.fixture(scope="module")
def composed3():
    """The small column model in JAX on its composed path, the port's seeded parameters as
    its variables, and the port model."""
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        model = JaxIInsVAE(conv_type=3, expand=EXPAND, **SMALL)
        port = IInsVAE(conv_type=3, **SMALL, generator=torch.Generator().manual_seed(1))
        yield model, _jax_variables(port, model, jnp.ones((2, 157))), port
    finally:
        pallas_fused.set_pallas_enabled(was)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(12)
    weight = np.ones(B, np.float32)
    weight[6] = 0.0  # a padded row
    return {"cir": rng.normal(size=(B, 157)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
            "label": rng.integers(0, 5, size=(B, 1)).astype(np.float32),
            "weight": weight}


def test_semi_step_noexpand_matches_jax(composed3, batch):
    model, variables, port = composed3
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
    base = jax.random.PRNGKey(5)
    for i in range(3):
        key = jax.random.fold_in(base, i)
        grads, jm, _ = jgrads(jstate_, jbatch, key)
        mask = np.asarray(jax.random.bernoulli(jax.random.split(key, 3)[0], rate, (B,)),
                          np.float32)
        tm = grads_fn(port, tbatch, sup_mask=torch.tensor(mask))
        for k in METRICS:
            _close(tm[k].item(), float(jm[k]), f"step {i} {k}")
        if i == 0:
            assert 0 < mask.sum() < B
            first = _flat(grads)
            got = bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()})
            assert set(got) == set(first)
            zero = [k for k in first if NORMED_BIAS.fullmatch(k)]
            assert len(zero) == 2 + 2 + 4  # a block in the encoder and the decoder, 4 stride-2
            for k, v in first.items():
                _close(got[k], v, f"gradient {k}")
                if k in zero:
                    assert not got[k].any(), k  # exactly 0: no input of the forward
        jstate_ = japply(jstate_, grads)
        state.apply_gradients()
        got = bridge.to_flax_numpy(dict(port.named_parameters()))
        diff = {k: np.abs(got[k] - v) / LR for k, v in _flat(jstate_.params).items()}
        for k, d in diff.items():
            # a gradient entry that is rounding noise moves its parameter by up to lr a step,
            # with a sign rounding decides: JAX's biases before a norm (its noise there reaches
            # 1e-5; the port's are exactly 0) and entries below 1e-6
            big = (np.abs(first[k]) >= 1e-6) & (not NORMED_BIAS.fullmatch(k))
            if i == 0:
                assert d[big].max(initial=0.0) <= 0.01 and d.max() <= 2.0, k
            if i == 2:
                assert d[big].max(initial=0.0) <= 3.0 and d.max() <= 6.0, k
        if i == 2:
            assert np.concatenate([d.ravel() for d in diff.values()]).mean() <= 0.05
    assert state.step == 3


def test_semi_step_noexpand_gradients_match_float64(batch):
    """The port's fp32 gradients against its own float64 run, the mask injected (the sums
    that cancel, Known hazards). The conv biases before a norm get exactly 0 in both."""
    fp32 = IInsVAE(conv_type=3, **SMALL, generator=torch.Generator().manual_seed(2))
    f64 = IInsVAE(conv_type=3, **SMALL, generator=torch.Generator().manual_seed(2)).double()
    mask = (np.arange(B) % 3 == 0).astype(np.float32)
    grads_fn = steps.make_semi_grads_fn(0.5)
    m32 = grads_fn(fp32, {k: torch.tensor(v) for k, v in batch.items()},
                   sup_mask=torch.tensor(mask))
    m64 = grads_fn(f64, {k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()},
                   sup_mask=torch.tensor(mask, dtype=torch.float64))
    assert m32["loss"].item() == pytest.approx(m64["loss"].item(), rel=1e-5)
    ref = dict(f64.named_parameters())
    zeros = 0
    for name, p in fp32.named_parameters():
        want, flax_name = ref[name].grad, "params/" + name.replace(".", "/")
        torch.testing.assert_close(p.grad.double(), want, rtol=1e-3,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")
        if NORMED_BIAS.fullmatch(flax_name):
            assert not p.grad.any() and not want.any(), name
            zeros += 1
    assert zeros == 4 + 4


# ------------------------- the flags and the CLIs -------------------------


def _parse(argv):
    import argparse

    parser = argparse.ArgumentParser()
    add_args(parser)
    add_train_args(parser)
    return from_args(parser.parse_args(argv))


def test_conv2d_restorer_at_conv_type_3_and_conv_type_4_raise():
    """The JAX CLI's model with the Conv2d restorer at conv_type 3 keeps the (B, 8, 1, C) code
    and fails with ZeroDivisionError; the port refuses it with a ValueError before a model is
    built, and any conv_type but 1, 2 and 3 (which JAX runs as the column model)."""
    with pytest.raises(ZeroDivisionError):  # traced, not run
        jax.eval_shape(JaxRestorer(conv_type=3, expand=EXPAND, net_type="Conv2d").init,
                       {"params": jax.random.PRNGKey(0)}, jnp.ones((2, 8, 1, 2)))
    with pytest.raises(ValueError, match="Conv2d"):
        _parse(["--conv_type", "3", "--restorer_type", "3"])
    with pytest.raises(ValueError, match="Conv2d"):
        IInsVAE(conv_type=3, restorer_type="Conv2d")
    with pytest.raises(ValueError, match="conv_type"):
        _parse(["--conv_type", "4"])
    with pytest.raises(ValueError, match="conv_type"):
        IInsVAE(conv_type=4)
    for restorer in ("1", "2"):
        assert _parse(["--conv_type", "3", "--restorer_type", restorer]).conv_type == 3


def test_cli_trains_evaluates_and_serves_noexpand_on_cpu(tmp_path, capsys):
    """``train_semi`` at ``--conv_type 3 --use_soft --env_conv_init torch`` on the CPU, then
    ``evaluate`` and ``serve`` from its checkpoint: the checkpoint round-trips the flags, the
    evaluation reads the restorer's mu, the server answers every request."""
    flags = ["--device", "cpu", "--conv_type", "3", "--use_soft", "--env_conv_init", "torch",
             "--dataset_env", "room_full", "--synthetic_n", "100", "--batch_size", "40",
             "--model_dir", str(tmp_path / "models"), "--out_dir", str(tmp_path / "results")]
    state, final = train_semi.main(flags + ["--n_epochs", "1", "--sample_interval", "0",
                                            "--checkpoint_interval", "-1"])
    assert state.model.soft and state.model.restorer.restorer.w3.shape == (256, 2)
    assert all(np.isfinite(v) for v in final.values() if isinstance(v, float))
    m = evaluate_cli.main(flags + ["--test_epoch", "1"])
    assert m["rmse"] == pytest.approx(final["rmse"], rel=1e-6)
    capsys.readouterr()
    serve_cli.main(flags + ["--epoch", "1", "--selftest_n", "7", "--serve_batch", "4"])
    out = capsys.readouterr().out
    assert "checkpoint epoch 1" in out and "self-test ok: 7 requests" in out
