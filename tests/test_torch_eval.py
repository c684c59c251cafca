"""The port's evaluation against the JAX package's: the eval step and the
evaluator, ``evaluate_semi`` with ``add_plurality_share``, and the fixture of
every environment.

The JAX models run on their composed path (``set_pallas_enabled(False)``,
restored after this module): the 1-D flagship widths ``IInsVAE(cir_len=157,
num_classes=5, style_dim=16)`` and the 2-D model (conv_type=2) at dim 2 with
one residual block; their flax parameters carry across with
``bridge.from_flax_numpy``. The split is not whole batches (70 rows at
batch 32; 2-D 20 rows at batch 8), so the last batch is padded.

Tolerances (fp32): the outputs err_est, logits, env_code and recon rtol
5e-4 / atol 5e-5 (tests/test_lowering_parity.py); count exactly; a sample's
correctness exactly wherever its top-two logit margin exceeds 1e-4 (below
that the two frameworks' rounding may pick either class); rmse and abs
rtol 1e-5.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.data.synthetic import synthetic_arrays as jax_synthetic_arrays
from iinsvae_tpu.data.zenodo import ZENODO_ENVS
from iinsvae_tpu.data.zenodo import label_dictionary as jax_label_dictionary
from iinsvae_tpu.evaluation import evaluate as jevaluate
from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.ops.pallas import fused as pallas_fused
from iinsvae_tpu.training import loop as jloop
from iinsvae_tpu.training import optim as joptim
from iinsvae_tpu.training import state as jstate
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.data import zenodo
from iinsvae_torch.data.synthetic import synthetic_arrays
from iinsvae_torch.evaluation import evaluate
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.training import loop, steps

RTOL, ATOL = 5e-4, 5e-5
METRIC_RTOL = 1e-5
MARGIN = 1e-4
FLAGSHIP = dict(cir_len=157, num_classes=5, style_dim=16)
# conv_type -> (model widths, rows of the split, batch)
CASES = {1: (FLAGSHIP, 70, 32), 2: (dict(FLAGSHIP, dim=2, n_residual=1), 20, 8)}


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def composed():
    """conv_type -> (JAX model, its JAX train state, the port's model with
    the same parameters), the JAX models on their composed path."""
    was = pallas_fused.pallas_enabled()
    pallas_fused.set_pallas_enabled(False)
    try:
        models = {}
        for conv_type, (widths, _, _) in CASES.items():
            model = JaxIInsVAE(conv_type=conv_type, expand=conv_type != 1, **widths)
            variables = jax.jit(model.init)({"params": jax.random.PRNGKey(conv_type)},
                                            jnp.ones((2, 157)))
            state = jstate.create_train_state(model, variables, joptim.make_optimizer())
            port = IInsVAE(conv_type=conv_type, **widths)
            port.load_state_dict(bridge.from_flax_numpy(_flat(variables["params"])))
            models[conv_type] = (model, state, port)
        yield models
    finally:
        pallas_fused.set_pallas_enabled(was)


def _split(n: int, seed: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"cir": rng.normal(size=(n, 157)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(n, 1))).astype(np.float32),
            "label": rng.integers(0, 5, size=(n, 1)).astype(np.float32)}


def _margin(logits: np.ndarray) -> np.ndarray:
    top = np.sort(logits, axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("conv_type", [1, 2])
def test_eval_step_and_evaluator_match_jax(composed, conv_type):
    model, state, port = composed[conv_type]
    _, n, bs = CASES[conv_type]
    data = _split(n, conv_type)
    jpadded = jloop.pad_to_batches(data, bs)
    want_m, want_o = jloop.make_evaluator(jsteps.make_semi_eval_step(model), bs)(state, jpadded)
    want_m = {k: float(v) for k, v in want_m.items()}
    port.train()
    got_m, got_o = loop.make_evaluator(steps.make_semi_eval_step(), bs)(
        port, loop.pad_to_batches(data, bs))
    assert port.training, "the eval step restores the model's mode"
    assert set(got_m) == set(want_m) == {"rmse", "abs", "accuracy"}
    for k in steps.EVAL_OUTPUTS:  # on the real rows: a zero row's norms are degenerate
        want = np.asarray(want_o[k])
        assert got_o[k].shape == want.shape == (-(-n // bs), bs) + want.shape[2:], k
        np.testing.assert_allclose(got_o[k].reshape((-1,) + want.shape[2:])[:n],
                                   want.reshape((-1,) + want.shape[2:])[:n], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    for k in ("rmse", "abs"):
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=METRIC_RTOL, err_msg=k)
    # per sample: correctness equal where the top-two margin clears MARGIN
    logits_j = np.asarray(want_o["logits"]).reshape(-1, 5)[:n]
    logits_p = got_o["logits"].reshape(-1, 5)[:n]
    label = data["label"].reshape(-1)
    clear = _margin(logits_j) > MARGIN
    right_j, right_p = logits_j.argmax(-1) == label, logits_p.argmax(-1) == label
    np.testing.assert_array_equal(right_p[clear], right_j[clear])
    # the count is exact, and the correct sums differ by at most the unclear samples
    count = n
    assert abs(got_m["accuracy"] * count - want_m["accuracy"] * count) <= (~clear).sum() + 1e-3
    assert abs(got_m["accuracy"] * count - right_p.sum()) < 1e-3


def test_eval_step_sums_match_jax_on_a_padded_batch(composed):
    """One eval step's sums on a batch with two padded rows: count exact, se
    and ae within tolerance, the outputs without an autograd graph."""
    model, state, port = composed[1]
    batch = _split(6, 9)
    batch["weight"] = np.asarray([1, 1, 1, 1, 0, 0], np.float32)
    want, _ = jsteps.make_semi_eval_step(model)(state, {k: jnp.asarray(v)
                                                        for k, v in batch.items()})
    got, out = steps.make_semi_eval_step()(port, {k: torch.from_numpy(v)
                                                  for k, v in batch.items()})
    assert set(got) == set(want) == {"se", "ae", "correct", "count"}
    assert got["count"].item() == float(want["count"]) == 4.0
    for k in ("se", "ae"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=METRIC_RTOL, err_msg=k)
    assert all(not v.requires_grad for v in (*got.values(), *out.values()))
    assert set(out) == {"err_est", "logits", "env_code", "recon"}


def test_evaluate_semi_matches_jax_and_exports_residuals(composed, tmp_path):
    model, state, port = composed[1]
    data = _split(70, 4)
    want = jevaluate.evaluate_semi(model, state, {k: jnp.asarray(v) for k, v in data.items()},
                                   32)
    got = evaluate.evaluate_semi(port, data, 32, result_path=str(tmp_path), epoch=3,
                                 dataset_env="room_full", export=True)
    for k in ("rmse", "abs", "accuracy", "plurality_share"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)
    assert ("env_head_degenerate" in got) == ("env_head_degenerate" in want)
    npz = np.load(tmp_path / "residuals_zenodo_room_full_3.npz")
    assert set(npz.files) == {"residual_em", "original"}
    assert npz["residual_em"].shape == npz["original"].shape == (70, 1)  # unpadded
    np.testing.assert_array_equal(npz["original"], data["err"])
    assert (tmp_path / "residual_em_zenodo_room_full_3.mat").exists()
    assert (tmp_path / "original_zenodo_room_full_3.mat").exists()
    # the outputs on request: the evaluator's, on the real rows only
    again, outs = evaluate.evaluate_semi(port, data, 32, outputs=True)
    assert again == got
    _, stacked = loop.make_evaluator(steps.make_semi_eval_step(), 32)(
        port, loop.pad_to_batches(data, 32))
    assert set(outs) == set(steps.EVAL_OUTPUTS)
    for k, v in stacked.items():
        np.testing.assert_array_equal(outs[k], v.reshape((-1,) + v.shape[2:])[:70], err_msg=k)
    np.testing.assert_array_equal(npz["residual_em"], np.abs(data["err"] - outs["err_est"]))


@pytest.mark.parametrize("accuracy,labels", [
    (0.40, [0, 0, 1, 2, 3]),        # 0.4 is the share: degenerate
    (0.404, [0, 0, 1, 2, 3]),       # within 0.005 of it: degenerate
    (0.60, [0, 0, 1, 2, 3]),        # clears it
    (0.30, [4, 4, 4, 1]),           # below the share of class 4
    (0.90, [2]),
])
def test_plurality_share_and_flag_match_jax(accuracy, labels):
    labels = np.asarray(labels, np.float32).reshape(-1, 1)
    got = evaluate.add_plurality_share({"accuracy": accuracy}, labels)
    want = jevaluate.add_plurality_share({"accuracy": accuracy}, labels)
    assert got == want


@pytest.mark.parametrize("env", ZENODO_ENVS)
def test_every_environment_of_the_fixture_is_bit_equal_to_jax(env):
    for seed in (3, 0):
        got = synthetic_arrays(300, seed, env)
        want = jax_synthetic_arrays(300, seed, env)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, env
            np.testing.assert_array_equal(a, b)
    assert zenodo.label_dictionary(env) == jax_label_dictionary(env)
    assert set(np.unique(got[2]).astype(int)) <= set(zenodo.label_dictionary(env))


def test_environment_tables_match_jax():
    from iinsvae_tpu.data import zenodo as jzenodo
    assert zenodo.ZENODO_ENVS == jzenodo.ZENODO_ENVS
    assert zenodo.OBSTACLE_ONEHOT == jzenodo.OBSTACLE_ONEHOT
    assert zenodo._OBSTACLE_PART == jzenodo._OBSTACLE_PART
    with pytest.raises(ValueError, match="Unknown environment"):
        zenodo.label_dictionary("bogus")
    with pytest.raises(ValueError, match="Unknown environment option"):
        synthetic_arrays(10, 0, "bogus")
