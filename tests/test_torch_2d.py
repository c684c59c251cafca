"""The port's expanded 2-D model (conv_type=2) against the JAX package's.

* The column-group ops (ops/colgroups.py), the subpixel upsample
  (ops/subpixel.py) and the channels-last conv2d against their JAX
  counterparts.
* The flagship-width model ``IInsVAE(conv_type=2, expand=True, cir_len=157,
  num_classes=5, style_dim=16)``: its flax parameters go through a weights
  npz (the format of ``export_serving``) and ``bridge.load_npz``; the
  port's ``Predictor(device="cpu")`` with and without the reconstruction,
  its encoder and its decoder must give what the JAX ``Predictor`` and
  model give (Pallas res2d in interpret mode) on the same CIRs: 13 CIRs at
  batch 8 pad the tail batch.
* The semi step at a small geometry (dim 2, one residual block, as
  tests/test_decoder2d_fast.py:69 cuts it) against the JAX step on its
  composed path (``set_pallas_enabled(False)``, restored after this
  module), with the mask drawn as the JAX step draws it and injected:
  the loss and its parts, every gradient, and the parameters after 1 and 3
  Adam steps; the port's gradients against its own float64 run; the
  residual blocks' conv biases, which K7 does not take, with a gradient of
  exactly 0 (JAX's, which adds them before a norm, is rounding noise).

Tolerances (fp32): outputs, losses and gradients rtol 5e-4 / atol 5e-5
(tests/test_lowering_parity.py); the port's fp32 gradients against its
float64 ones rtol 1e-3 / atol 1e-4 of each gradient's largest magnitude
(the largest error seen is 8.7e-5 of it, at the decoder's res0_kernel2).
Parameters in units of lr: Adam's first update is lr * g / (|g| + 1e-8),
so an entry moves by at most lr a step, and one whose gradient is rounding
noise (the conv biases before a norm, in both packages; below 1e-6 here)
moves by up to lr with a sign that rounding decides. After one step entries
whose JAX gradient is >= 1e-6 agree within 0.01 lr and the rest within
2 lr; after three steps those within 3 lr, the rest within 6 lr, and the
mean within 0.05 lr.
"""

import os
import re
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.ops import colgroups as jcg
from iinsvae_tpu.ops import conv as jconv
from iinsvae_tpu.ops import subpixel as jsp
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.serving import Predictor as JaxPredictor
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.config import Config
from iinsvae_torch.models.encoders import env_kl, split_env_stats
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops import colgroups as cg
from iinsvae_torch.ops import subpixel as sp
from iinsvae_torch.ops.conv import conv2d
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import steps
from iinsvae_torch.training.state import create_train_state

RTOL, ATOL = 5e-4, 5e-5
LR = 1e-3
B = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = dict(cir_len=157, num_classes=5, style_dim=16)
SMALL = dict(FLAGSHIP, dim=2, n_residual=1)
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
           "count", "sup_count")
RES_BIASES = ("encoder/range_encoder/res", "decoder/decoder/res")


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ------------------------------ ops ------------------------------


def test_colgroups_chain_matches_jax():
    """The encoders' chain on the constant field: pool 157 -> 128, k7
    reflect conv (one group), IN, ReLU, k4 s2 zero-pad convs (three groups),
    the weighted global mean and the expansion, step by step."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 157, 1)).astype(np.float32)
    convs = [((7, 7, 1, 4), 1, 3, "reflect"), ((4, 4, 4, 8), 2, 1, "zero"),
             ((4, 4, 8, 16), 2, 1, "zero")]
    params = [(rng.normal(size=s).astype(np.float32) * 0.2,
               rng.normal(size=s[-1]).astype(np.float32)) for s, *_ in convs]
    jx = jcg.pool_constant_field(jcg.constant_field(jnp.asarray(x), 157), 128)
    tx = cg.pool_constant_field(cg.constant_field(torch.tensor(x), 157), 128)
    assert tx.col2g == jx.col2g and tx.width == 128
    _close(tx.data, jx.data, "pool")
    for (shape, s, p, mode), (k, b) in zip(convs, params):
        jx = jcg.conv2d_grouped(jx, jnp.asarray(k), jnp.asarray(b), stride=s, padding=p,
                                pad_mode=mode)
        tx = cg.conv2d_grouped(tx, torch.tensor(k), torch.tensor(b), stride=s, padding=p,
                               pad_mode=mode)
        assert tx.col2g == jx.col2g, shape
        _close(tx.data, jx.data, f"conv {shape}")
        jx = jcg.relu_grouped(jcg.instance_norm_grouped(jx))
        tx = cg.relu_grouped(cg.instance_norm_grouped(tx))
        _close(tx.data, jx.data, f"IN + ReLU after {shape}")
    assert tx.data.shape[2] == 3  # left edge, interior, right edge
    np.testing.assert_array_equal(tx.counts, jx.counts)
    _close(cg.global_mean_grouped(tx), jcg.global_mean_grouped(jx), "global mean")
    _close(tx.expand(), jx.expand(), "expand")


@pytest.mark.parametrize("stride,padding,pad_mode", [(1, 1, "reflect"), (2, 1, "zero"),
                                                     (1, 3, "reflect"), (1, 0, "zero")])
def test_conv2d_matches_jax(stride, padding, pad_mode):
    rng = np.random.default_rng(2)
    k = 2 * padding + 1 if padding else 1
    x = rng.normal(size=(2, 9, 9, 5)).astype(np.float32)
    kernel = rng.normal(size=(k, k, 5, 3)).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias), stride=stride,
                        padding=padding, pad_mode=pad_mode)
    got = conv2d(torch.tensor(x), torch.tensor(kernel), torch.tensor(bias), stride=stride,
                 padding=padding, pad_mode=pad_mode)
    _close(got, want, "conv2d")


def test_subpixel_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    kernel = rng.normal(size=(5, 5, 6, 3)).astype(np.float32)
    bias = rng.normal(size=3).astype(np.float32)
    _close(sp.phase_kernel(torch.tensor(kernel)), jsp.phase_kernel(jnp.asarray(kernel)), "phase")
    z = sp.upsample_conv5_phase(torch.tensor(x), torch.tensor(kernel), torch.tensor(bias))
    jz = jsp.upsample_conv5_phase(jnp.asarray(x), jnp.asarray(kernel), jnp.asarray(bias))
    _close(z, jz, "upsample_conv5_phase")
    _close(sp.pixel_shuffle2(z), jsp.pixel_shuffle2(jz), "pixel_shuffle2")
    # and it is the upsampled 5x5 conv
    up = torch.tensor(x).repeat_interleave(2, 1).repeat_interleave(2, 2)
    _close(sp.pixel_shuffle2(z), conv2d(up, torch.tensor(kernel), torch.tensor(bias), padding=2),
           "vs upsample + conv", rtol=1e-4, atol=1e-4)


# ------------------------- the serving model -------------------------


@pytest.fixture(scope="module")
def model2d(tmp_path_factory):
    """The 2-D flagship in JAX (pallas on: res2d in interpret mode), its
    variables, and its weights as an export_serving-style npz."""
    model = JaxIInsVAE(conv_type=2, expand=Config(conv_type=2).expand, **FLAGSHIP)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.ones((2, 157)))
    path = tmp_path_factory.mktemp("serving2d") / "weights.npz"
    np.savez(path, **_flat(variables["params"]), **{"batch_stats/__empty__": np.zeros(0)})
    return model, variables, str(path)


@pytest.fixture(scope="module")
def cirs():
    return np.random.default_rng(7).normal(size=(13, 157)).astype(np.float32)


@pytest.mark.parametrize("recon", [False, True])
def test_predictor_2d_matches_jax(model2d, cirs, recon):
    import types

    model, variables, npz = model2d
    state = types.SimpleNamespace(params=variables["params"], batch_stats={})
    want = JaxPredictor(model, state, batch_size=8, return_recon=recon)(cirs)
    got = Predictor.from_npz(npz, batch_size=8, return_recon=recon, device="cpu")(cirs)
    fields = ("err_est", "label_probs", "env_code") + (("recon",) if recon else ())
    for f in fields:
        assert getattr(got, f).shape == getattr(want, f).shape, f
        _close(getattr(got, f), getattr(want, f), f)
    np.testing.assert_array_equal(got.label, want.label)
    assert got.recon is None if not recon else got.recon.shape == (13, 157)


def test_forward_2d_codes_kl_and_recon_match_jax(model2d, cirs):
    """Encoder(conv_type=2) (the range code (B, 8, 8, 2), the env stats and
    their KL) and the whole forward, the decoder's reconstruction included."""
    model, variables, npz = model2d
    want = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))(
        variables, jnp.asarray(cirs))
    port = IInsVAE(conv_type=2, **FLAGSHIP)
    port.load_state_dict(bridge.load_npz(npz))
    with torch.inference_mode():
        got = port(torch.tensor(cirs))
        got["kl"] = env_kl(*split_env_stats(got["env_code"]))
    assert got["range_code"].shape == (13, 8, 8, 2)
    for key in ("range_code", "env_code", "err_est", "logits", "kl", "recon"):
        _close(got[key], want[key], key)


def test_decoder_2d_matches_jax_on_random_codes(model2d):
    """Decoder(conv_type=2) alone, on codes the encoder would not give."""
    model, variables, npz = model2d
    rng = np.random.default_rng(8)
    rc = rng.normal(size=(5, 8, 8, 2)).astype(np.float32)
    ec = rng.normal(size=(5, 16)).astype(np.float32)
    want = model.apply(variables, jnp.asarray(rc), jnp.asarray(ec), method=JaxIInsVAE.decode)
    port = IInsVAE(conv_type=2, **FLAGSHIP)
    port.load_state_dict(bridge.load_npz(npz))
    with torch.inference_mode():
        got = port.decode(torch.tensor(rc), torch.tensor(ec))
    assert got.shape == (5, 157)
    _close(got, want, "recon")


def test_bridge_round_trips_the_2d_keys(model2d):
    """Every 2-D key lands on the port's parameter of the same shape (no
    transposes) and maps back to the same name and value; the geometry
    reads conv_type 2 from the taps' rank."""
    _, variables, npz = model2d
    flat = _flat(variables["params"])
    state = bridge.load_npz(npz)
    port = IInsVAE(conv_type=2, **FLAGSHIP).state_dict()
    assert set(state) == set(port)
    assert all(state[k].shape == port[k].shape for k in state)
    assert state["encoder.range_encoder.res0_kernel1"].shape == (3, 3, 64, 64)
    assert state["encoder.env_encoder.out_kernel"].shape == (1, 1, 64, 16)
    assert state["restorer.restorer.w0"].shape == (128, 512)
    back = bridge.to_flax_numpy(state)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert bridge.model_geometry(state) == dict(
        conv_type=2, dim=4, n_downsample=4, n_residual=3, range_dim=2, style_dim=16,
        num_classes=5)
    with pytest.raises(KeyError, match="unknown JAX parameter"):
        bridge.from_flax_numpy({**flat, "params/encoder/env_encoder/down0_scale": np.zeros(1)})


# ------------------------- the training step -------------------------


@pytest.fixture(scope="module")
def composed2d():
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        model = JaxIInsVAE(conv_type=2, expand=True, **SMALL)
        variables = jax.jit(model.init)({"params": jax.random.PRNGKey(1)}, jnp.ones((2, 157)))
        yield model, variables
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


def _jax_mask(key, rate):
    """The per-sample mask steps.py:135-144 draws from the step's key."""
    return np.asarray(jax.random.bernoulli(jax.random.split(key, 3)[0], rate, (B,)), np.float32)


def test_semi_step_2d_matches_jax(composed2d, batch):
    model, variables = composed2d
    rate = 0.5
    tx = joptim.make_optimizer(LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    jstate_ = jstate.create_train_state(model, variables, tx)
    jgrads = jax.jit(jsteps.make_semi_grads_fn(model, rate))
    port = IInsVAE(conv_type=2, **SMALL)
    port.load_state_dict(bridge.from_flax_numpy(_flat(variables["params"])))
    state = create_train_state(port, LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    grads_fn = steps.make_semi_grads_fn(rate)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    base = jax.random.PRNGKey(5)
    for i in range(3):
        key = jax.random.fold_in(base, i)
        grads, jm, _ = jgrads(jstate_, jbatch, key)
        mask = _jax_mask(key, rate)
        tm = grads_fn(port, tbatch, sup_mask=torch.tensor(mask))
        for k in METRICS:
            _close(tm[k].item(), float(jm[k]), f"step {i} {k}")
        if i == 0:
            assert 0 < mask.sum() < B
            first = _flat(grads)
            got = bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()})
            assert set(got) == set(first)
            for k, v in first.items():
                _close(got[k], v, f"gradient {k}")
                if k.startswith(tuple("params/" + r for r in RES_BIASES)) and "_bias" in k:
                    assert not got[k].any(), k  # exactly 0: no K7 input
        jstate_ = jstate_.apply_gradients(grads)
        state.apply_gradients()
        got = bridge.to_flax_numpy(dict(port.named_parameters()))
        diff = {k: np.abs(got[k] - v) / LR for k, v in _flat(jstate_.params).items()}
        for k, d in diff.items():
            big = np.abs(first[k]) >= 1e-6
            if i == 0:
                assert d[big].max(initial=0.0) <= 0.01 and d.max() <= 2.0, k
            if i == 2:
                assert d[big].max(initial=0.0) <= 3.0 and d.max() <= 6.0, k
        if i == 2:
            assert np.concatenate([d.ravel() for d in diff.values()]).mean() <= 0.05
    assert state.step == 3


def test_semi_step_2d_gradients_match_float64(batch):
    """The port's fp32 gradients against its own float64 run, the mask
    injected. The range encoder's conv biases before an InstanceNorm have an
    exact gradient of 0, so float64 gives rounding noise (1e-16) and fp32
    1e-7: they are held below 1e-6 of the model's largest gradient. The
    residual blocks' biases get exactly 0 in both."""
    fp32 = IInsVAE(conv_type=2, **SMALL, generator=torch.Generator().manual_seed(2))
    f64 = IInsVAE(conv_type=2, **SMALL, generator=torch.Generator().manual_seed(2)).double()
    mask = (np.arange(B) % 3 == 0).astype(np.float32)
    grads_fn = steps.make_semi_grads_fn(0.5)
    m32 = grads_fn(fp32, {k: torch.tensor(v) for k, v in batch.items()},
                   sup_mask=torch.tensor(mask))
    m64 = grads_fn(f64, {k: torch.tensor(v, dtype=torch.float64) for k, v in batch.items()},
                   sup_mask=torch.tensor(mask, dtype=torch.float64))
    assert m32["loss"].item() == pytest.approx(m64["loss"].item(), rel=1e-5)
    ref = dict(f64.named_parameters())
    largest = max(p.grad.abs().max().item() for p in ref.values())
    for name, p in fp32.named_parameters():
        want = ref[name].grad
        if re.fullmatch(r"encoder\.range_encoder\.(in|down\d+)_bias", name):
            assert (p.grad.double() - want).abs().max().item() <= 1e-6 * largest, name
            continue
        torch.testing.assert_close(p.grad.double(), want, rtol=1e-3,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=lambda m: f"{name}: {m}")
        if ".res" in name and "_bias" in name:
            assert not p.grad.any() and not want.any(), name


def _run(args):
    """A port entry point in a fresh interpreter where importing jax or the
    JAX package fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['iinsvae_tpu'] = None\n"
            f"from iinsvae_torch.cli import {args[0]}\n"
            f"{args[0]}.main({list(args[1:])!r})\n")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    # the time limit leaves room for a machine loaded by the suite's other workers
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_serves_2d_with_recon_on_cpu():
    r = _run(["serve", "--device", "cpu", "--conv_type", "2", "--dataset_env", "room_full",
              "--selftest_n", "9", "--serve_batch", "4", "--recon"])
    assert r.returncode == 0, r.stderr
    assert "self-test ok: 9 requests through the server" in r.stdout
    assert "[serve] stats: 9 submitted" in r.stdout
    assert "recon (9, 157)" in r.stdout


def test_cli_trains_2d_on_cpu(tmp_path):
    r = _run(["train_semi", "--device", "cpu", "--conv_type", "2", "--dataset_env", "room_full",
              "--synthetic_n", "300", "--batch_size", "120", "--n_epochs", "1",
              "--model_dir", str(tmp_path / "models"), "--out_dir", str(tmp_path / "results")])
    assert r.returncode == 0, r.stderr
    assert "240 train CIRs in 2 batches of 120" in r.stdout
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("[Epoch 0/1]"))
    for key in ("loss", "rmse", "accuracy"):
        assert np.isfinite(float(line.split(f"[{key}: ")[1].split("]")[0])), line
