"""The port's semi-supervised training step against the JAX package's.

The JAX flagship ``IInsVAE(cir_len=157, num_classes=5, style_dim=16)`` runs
on its composed path (``set_pallas_enabled(False)``, restored after this
module); its flax parameters carry across with ``bridge.from_flax_numpy``.
One batch of 8 seeded CIRs, errors, labels and a padding weight with a zero
in it; the supervision mask is drawn as steps.py:135-144 draws it from the
step's key, on the JAX side, and injected into the port (threefry and
Philox give different streams). Checked: the loss and its four parts and
the metric sums, every gradient by flax name (``bridge.to_flax_numpy``),
and the parameters after 1 and 3 Adam steps with the LambdaLR decay active
(lr 1e-3 halved at the third step). Repeated with ``kl_free_bits=0.5`` and
``mask_mode='batch'``.

Tolerances (fp32): losses and the first step's gradients rtol 5e-4 / atol
5e-5 (tests/test_lowering_parity.py). Parameters, in units of lr: Adam's
first update is lr * g / (|g| + 1e-8), so a gradient entry below ~1e-6
(a third of this model's, many of them rounding noise of an exact 0) moves
its parameter by a share of lr that the two frameworks' rounding decides.
After one step, entries whose JAX gradient is >= 1e-6 agree within 0.01 lr
(measured 6.4e-4 lr) and the rest within lr (measured 0.2 lr). Those
differences then feed the next gradients, so after three steps the bound
is 3 lr on any entry (measured 2.3 lr) and 0.05 lr on the mean (measured
0.011 lr).
"""

import os
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.data.synthetic import synthetic_arrays as jax_synthetic_arrays
from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.training import loop as jloop
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.data.splits import Standardizer
from iinsvae_torch.data.synthetic import synthetic_arrays
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.training import loop, optim, steps
from iinsvae_torch.training.state import create_train_state

RTOL, ATOL = 5e-4, 5e-5
LR = 1e-3
B = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
           "count", "sup_count")


@pytest.fixture(scope="module")
def composed():
    """The JAX model on its composed path (pallas off) and its initial
    variables; the module-global switch is restored afterwards."""
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        model = JaxIInsVAE(cir_len=157, num_classes=5, style_dim=16)
        variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.ones((2, 157)))
        yield model, variables
    finally:
        pallas_fused.set_pallas_enabled(was)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(11)
    weight = np.ones(B, np.float32)
    weight[5] = 0.0  # a padded row
    return {"cir": rng.normal(size=(B, 157)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
            "label": rng.integers(0, 5, size=(B, 1)).astype(np.float32),
            "weight": weight}


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


def _jax_mask(key, rate, mask_mode):
    """The mask steps.py:135-144 draws from the step's key."""
    k_mask = jax.random.split(key, 3)[0]
    shape = (B,) if mask_mode == "sample" else (1,)
    return np.asarray(jnp.broadcast_to(jax.random.bernoulli(k_mask, rate, shape), (B,)),
                      np.float32)


def _compare(got: dict, want: dict, what: str, rtol=RTOL, atol=ATOL):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("kl_free_bits,mask_mode,rate", [(0.0, "sample", 0.5),
                                                         (0.5, "batch", 0.7)])
def test_semi_step_matches_jax(composed, batch, kl_free_bits, mask_mode, rate):
    model, variables = composed
    tx = joptim.make_optimizer(LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    jstate_ = jstate.create_train_state(model, variables, tx)
    jgrads = jax.jit(jsteps.make_semi_grads_fn(model, rate, mask_mode=mask_mode,
                                               kl_free_bits=kl_free_bits))
    port = IInsVAE(cir_len=157, num_classes=5, style_dim=16)
    port.load_state_dict(bridge.from_flax_numpy(_flat(variables["params"])))
    state = create_train_state(port, LR, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    grads_fn = steps.make_semi_grads_fn(rate, mask_mode=mask_mode, kl_free_bits=kl_free_bits)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    base = jax.random.PRNGKey(3)
    for i in range(3):
        key = jax.random.fold_in(base, i)
        grads, jm, _ = jgrads(jstate_, jbatch, key)
        mask = _jax_mask(key, rate, mask_mode)
        tm = grads_fn(port, tbatch, sup_mask=torch.tensor(mask))
        _compare({k: tm[k].item() for k in METRICS}, {k: float(jm[k]) for k in METRICS},
                 f"step {i} metric")
        if i == 0:
            # 'sample' labels some rows of the batch; 'batch' (rate 0.7) leaves
            # this first batch unlabeled and labels the next two
            assert 0 < mask.sum() < B if mask_mode == "sample" else mask.sum() == 0
            first_grads = _flat(grads)
            _compare(bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()}),
                     first_grads, "gradient")
        jstate_ = jstate_.apply_gradients(grads)
        state.apply_gradients()
        got = bridge.to_flax_numpy(dict(port.named_parameters()))
        diff = {k: np.abs(got[k] - v) / LR for k, v in _flat(jstate_.params).items()}
        if i == 0:
            for k, d in diff.items():
                big = np.abs(first_grads[k]) >= 1e-6
                assert d[big].max(initial=0.0) <= 0.01 and d.max() <= 1.0, k
        if i == 2:
            everything = np.concatenate([d.ravel() for d in diff.values()])
            assert everything.max() <= 3.0 and everything.mean() <= 0.05
    assert state.step == 3 and state.optimizer.param_groups[0]["lr"] == pytest.approx(LR / 2)


def test_schedule_matches_jax_and_clamps_at_zero_past_n_epochs():
    j = joptim.lambda_lr_schedule(1e-4, 10, 4, 3)
    t = optim.lambda_lr_schedule(1e-4, 10, 4, 3)
    for step in range(0, 45):
        assert t(step) == pytest.approx(float(j(step)), rel=1e-6, abs=1e-12)
    assert t(10 * 3) == 0.0 and t(44) == 0.0  # past n_epochs: 0, not negative
    with pytest.raises(ValueError, match="Decay must start"):
        optim.lambda_lr_schedule(1e-4, 4, 4, 3)


def test_pad_to_batches_matches_jax():
    rng = np.random.default_rng(0)
    data = {"cir": rng.normal(size=(7, 157)).astype(np.float32),
            "err": rng.normal(size=(7, 1)).astype(np.float32),
            "label": rng.integers(0, 5, size=(7, 1)).astype(np.float32)}
    got, want = loop.pad_to_batches(data, 3), jloop.pad_to_batches(data, 3)
    assert set(got) == set(want) == {"cir", "err", "label", "weight"}
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["cir"].shape == (9, 157) and got["weight"].tolist() == [1] * 7 + [0, 0]


def test_reduce_metrics_is_exact_under_a_padded_tail():
    """Per-batch means recombined with their true denominators equal the
    metric of the whole set (a mean of batch means would not), as JAX's
    reduce_metrics gives them."""
    rng = np.random.default_rng(4)
    n, bs = 10, 4
    err = rng.normal(size=(n, 1)).astype(np.float32)
    est = rng.normal(size=(n, 1)).astype(np.float32)
    sup = (rng.random(n) < 0.5).astype(np.float32)
    padded = loop.pad_to_batches({"cir": np.zeros((n, 1), np.float32), "err": err,
                                  "est": est, "sup": sup}, bs)
    per_batch = []
    for i in range(0, 12, bs):
        w, s = padded["weight"][i:i + bs], padded["sup"][i:i + bs]
        d = (padded["est"][i:i + bs] - padded["err"][i:i + bs]).abs().reshape(-1)
        per_batch.append({"loss_res": (d * w * s).sum() / (w * s).sum().clamp_min(1.0),
                          "loss_ae": (d * w).sum() / w.sum().clamp_min(1.0),
                          "count": w.sum(), "sup_count": (w * s).sum()})
    stacked = {k: torch.stack([m[k] for m in per_batch]) for k in per_batch[0]}
    got = steps.reduce_metrics(stacked, lambda v: v.sum(0))
    d = np.abs(est - err).reshape(-1)
    np.testing.assert_allclose(got["loss_res"].item(), (d * sup).sum() / sup.sum(), rtol=1e-6)
    np.testing.assert_allclose(got["loss_ae"].item(), d.mean(), rtol=1e-6)
    assert got["count"].item() == n
    want = jsteps.reduce_metrics({k: jnp.asarray(v.numpy()) for k, v in stacked.items()},
                                 jnp.sum)
    _compare({k: v.item() for k, v in got.items()}, {k: float(v) for k, v in want.items()},
             "reduced", rtol=1e-6, atol=1e-7)


def test_epoch_runner_repeats_from_its_seed_and_masks_as_asked():
    """Two runs of train_epochs with one seed give the same metrics: the
    permutation and every mask come from the epoch's seeded generator.
    'batch' masks a whole batch with one draw, 'sample' each row."""
    rng = np.random.default_rng(6)
    data = loop.pad_to_batches({"cir": rng.normal(size=(10, 157)).astype(np.float32),
                                "err": np.abs(rng.normal(size=(10, 1))).astype(np.float32),
                                "label": rng.integers(0, 5, size=(10, 1)).astype(np.float32)},
                               4)

    def run():
        model = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                        generator=torch.Generator().manual_seed(1))
        state = create_train_state(model, LR)
        run_epoch = loop.make_epoch_runner(steps.make_semi_train_step(0.5), 4)
        return loop.train_epochs(state, run_epoch, data, 2, seed=7)

    first = run()
    assert first == run() and len(first) == 2 and {"loss", "rmse", "accuracy"} <= set(first[0])
    gen = torch.Generator().manual_seed(0)
    whole = steps.draw_sup_mask(64, 0.5, "batch", gen)
    assert whole.shape == (64,) and whole.min() == whole.max()
    rows = steps.draw_sup_mask(64, 0.5, "sample", gen)
    assert 0 < rows.sum() < 64


def test_synthetic_fixture_is_bit_equal_to_jax():
    for n, seed in ((300, 3), (1000, 0)):
        got = synthetic_arrays(n, seed, "room_full")
        want = jax_synthetic_arrays(n, seed, "room_full")
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    # the CLI's default environment (every environment: tests/test_torch_eval.py)
    for a, b in zip(synthetic_arrays(10, 0, "nlos"), jax_synthetic_arrays(10, 0, "nlos")):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_standardizer_matches_jax():
    from iinsvae_tpu.data.splits import Standardizer as JaxStandardizer
    x = np.random.default_rng(2).normal(size=(50, 6))
    x[:, 3] = 1.5  # a constant column keeps std 1
    got, want = Standardizer.fit(x), JaxStandardizer.fit(x)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    np.testing.assert_array_equal(got.inverse(got.transform(x)), want.inverse(want.transform(x)))


def _run(args):
    """The training CLI in a fresh interpreter where importing jax or the
    JAX package fails: the port trains without them."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['iinsvae_tpu'] = None\n"
            "from iinsvae_torch.cli import train_semi\n"
            f"train_semi.main({list(args)!r})\n")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    # the time limit leaves room for a machine loaded by the suite's other workers
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)


def test_cli_trains_two_epochs_on_cpu(tmp_path):
    r = _run(["--device", "cpu", "--dataset_env", "room_full", "--synthetic_n", "600",
              "--batch_size", "200", "--n_epochs", "2", "--model_dir", str(tmp_path / "models"),
              "--out_dir", str(tmp_path / "results")])
    assert r.returncode == 0, r.stderr
    assert "480 train CIRs in 3 batches of 200" in r.stdout
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("[Epoch ")]
    assert [ln.split("]")[0] for ln in lines] == ["[Epoch 0/2", "[Epoch 1/2"]
    for ln in lines:
        for key in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "rmse", "accuracy"):
            value = float(ln.split(f"[{key}: ")[1].split("]")[0])
            assert np.isfinite(value), (key, ln)


def test_cli_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = _run(["--dataset_env", "room_full", "--synthetic_n", "600", "--n_epochs", "1"])
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
