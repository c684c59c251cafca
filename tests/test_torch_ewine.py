"""The port's eWine path against the JAX package's: the fixture's CSVs, the native parser and
extraction, ``verify_ewine``, the 1-D model at 152 taps and 2 classes, the plain K6 at a pool
of 152, and the entry points on the eWine fixture.

* The CSVs: the port's fixture file, read by JAX's ``load_reg_data`` and by the port's, gives
  bit-equal CIRs and labels, and errors bit-equal to JAX's numpy extraction (JAX's native one
  fuses a multiply-add, an ulp of the distance apart); a JAX-written file (pandas ``to_csv``) reads back to the port's own rows
  bit for bit. ``ewine_extract`` on hostile rows (a NaN, infinite or out-of-range first-path
  index) equals JAX's ``extract_reg_arrays`` and the port's numpy version exactly.
* The 1-D model (one residual block, dim 4, style 16) at cir_len 152: JAX's variables are the
  port's seeded parameters as a flax tree with the JAX model's own keys and shapes (``init``
  traced by ``jax.eval_shape``, not run); the forward and one semi step's loss, metric sums
  and gradients against JAX's composed path (``set_pallas_enabled(False)``, restored after),
  the mask drawn as the JAX step draws it and injected; rtol 5e-4 / atol 5e-5
  (tests/test_torch_training.py states why).
* K6 at the decoder tail pooling 128 -> 152, plain version against ``fused_sln_chain`` in
  interpret mode (as tests/test_torch_kernels.py and tests/test_torch_backward.py hold it at
  157), forward and VJP, batch 5; rtol 5e-4 / atol 5e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax
from iinsvae_tpu.data import ewine as jewine
from iinsvae_tpu.data import synthetic as jsynthetic
from iinsvae_tpu.data import verify as jverify
from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.ops import dense_conv
from iinsvae_tpu.ops.pallas import fused as pf
from iinsvae_tpu.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_tpu.training import steps as jsteps
from iinsvae_torch import bridge
from iinsvae_torch.cli import evaluate, inspect_data, serve, train_semi
from iinsvae_torch.data import ewine, synthetic, verify
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.kernels import fused
from iinsvae_torch.runtime import native
from iinsvae_torch.training import steps

RTOL, ATOL = 5e-4, 5e-5
B = 8
L = 152
SMALL = dict(conv_type=1, cir_len=L, num_classes=2, style_dim=16, n_residual=1)
METRICS = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "se", "ae", "correct",
           "count", "sup_count")


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_fixture_csv_reads_bit_equal_in_both_packages(tmp_path):
    paths = [synthetic.synthetic_ewine_csv(str(tmp_path / f"tag_room{i}.csv"), n=40, seed=i)
             for i in range(2)]
    got = ewine.load_reg_data(paths, seed=5)
    want = jewine.load_reg_data(paths, seed=5)
    _same(got[::2], want[::2])
    # the error is numpy's arithmetic exactly; the JAX package's native build (-march=native)
    # fuses dx * dx + dy * dy into one FMA, which moves the distance (below 15 m) by an ulp
    # (1.8e-15) and its difference with the measured one by as much
    rows = np.vstack([jewine.load_data_from_file(p) for p in paths])
    np.random.default_rng(5).shuffle(rows)
    _same(got, jewine.extract_reg_arrays(rows))
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=4e-15)
    assert got[0].shape == (80, L) and set(np.unique(got[2])) == {0.0, 1.0}
    _same(ewine.load_cls_data(paths, seed=5), (got[0], got[2]))
    # a folder reads its top-level CSVs in sorted order
    _same(ewine.load_reg_data(str(tmp_path), seed=5), got)


def test_jax_written_csv_reads_back_to_the_same_rows(tmp_path):
    path = jsynthetic.synthetic_ewine_csv(str(tmp_path / "jax.csv"), n=30, seed=7)
    rows = synthetic.synthetic_ewine_rows(30, seed=7)
    _same([native.read_csv(path)], [rows])
    _same([ewine.load_data_from_file(path)], [jewine.load_data_from_file(path)])
    ours = synthetic.synthetic_ewine_csv(str(tmp_path / "port.csv"), n=30, seed=7)
    assert open(ours).readline() == open(path).readline()  # the c0..cN header


def _hostile_rows(cols):
    rng = np.random.default_rng(3)
    rows = np.abs(rng.normal(size=(9, cols))) * 100 + 1
    rows[:, 8] = [0, 20, np.nan, np.inf, -np.inf, -40, 1e300, cols, 7.9]
    return rows


@pytest.mark.parametrize("cols", [218, 160, 152])
def test_ewine_extract_on_hostile_rows_matches_jax(cols):
    rows = _hostile_rows(cols)
    got = native.ewine_extract(rows)
    _same(got, jewine.extract_reg_arrays(rows))
    _same(got, ewine.extract_reg_arrays(rows))
    for extract in (native.ewine_extract, jewine.extract_reg_arrays):
        with pytest.raises(ValueError, match="columns"):
            extract(rows[:, :151])


def _tree(base, case):
    """An eWine CSV tree: the fixture's two files, and for 'hostile' a third loader file with
    NaN and out-of-range first paths and a zero amplitude, a narrow file outside the loader's
    paths, and a loader folder (dataset2/tag_room1/) of one file."""
    for i in range(2):
        synthetic.synthetic_ewine_csv(str(base / "dataset1" / f"tag_room{i}.csv"), n=12, seed=i)
    if case == "hostile":
        rows = _hostile_rows(218)
        rows[4, 17] = 0.0
        synthetic.write_csv(str(base / "dataset2" / "tag_room0.csv"), rows)
        synthetic.write_csv(str(base / "other_schema.csv"), np.zeros((3, 7)))
        synthetic.write_csv(str(base / "dataset2" / "tag_room1" / "a.csv"), rows[:3, :100])


@pytest.mark.parametrize("case", ["fixture", "hostile", "absent"])
def test_verify_ewine_matches_jax(tmp_path, case):
    base = tmp_path / "data_ewine"
    if case != "absent":
        _tree(base, case)
    got, want = verify.verify_ewine(str(base)), jverify.verify_ewine(str(base))
    assert got == want
    assert got["ok"] == (case == "fixture")


def test_verify_ewine_reports_a_non_numeric_field(tmp_path):
    """The port reads a CSV as its loader does, a non-number as NaN: a loader file with one
    is an error entry of the report, not a crash."""
    synthetic.synthetic_ewine_csv(str(tmp_path / "dataset1" / "tag_room0.csv"), n=4, seed=0)
    text = (tmp_path / "dataset1" / "tag_room0.csv").read_text().splitlines()
    fields = text[2].split(",")
    fields[100] = "notanumber"  # inside every window: first paths 0-29 read 15-196
    text[2] = ",".join(fields)
    (tmp_path / "dataset1" / "tag_room0.csv").write_text("\n".join(text) + "\n")
    report = verify.verify_ewine(str(tmp_path))
    assert not report["ok"] and any("1/4 rows" in e and "non-numeric" in e
                                    for e in report["errors"])


def _flat(tree) -> dict[str, np.ndarray]:
    return {"params/" + k: np.asarray(v)
            for k, v in flax.traverse_util.flatten_dict(tree, sep="/").items()}


@pytest.fixture(scope="module")
def composed():
    """The JAX model at 152 taps on its composed path and the port's seeded model, whose
    parameters are the JAX variables."""
    was = pf.pallas_enabled()
    pf.set_pallas_enabled(False)
    try:
        model = JaxIInsVAE(**SMALL)
        port = IInsVAE(**SMALL, generator=torch.Generator().manual_seed(4))
        flat = bridge.to_flax_numpy(port.state_dict())
        shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)}, jnp.ones((2, L)))
        assert {k: v.shape for k, v in flat.items()} == {
            "params/" + k: v.shape
            for k, v in flax.traverse_util.flatten_dict(shapes["params"], sep="/").items()}
        params = flax.traverse_util.unflatten_dict({tuple(k.split("/")[1:]): jnp.asarray(v)
                                                    for k, v in flat.items()})
        yield model, {"params": params, "batch_stats": {}}, port
    finally:
        pf.set_pallas_enabled(was)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(17)
    weight = np.ones(B, np.float32)
    weight[6] = 0.0  # a padded row
    return {"cir": rng.normal(size=(B, L)).astype(np.float32),
            "err": np.abs(0.3 * rng.normal(size=(B, 1))).astype(np.float32),
            "label": rng.integers(0, 2, size=(B, 1)).astype(np.float32), "weight": weight}


def test_ewine_model_forward_matches_jax(composed, batch):
    model, variables, port = composed
    want = jax.jit(model.apply)(variables, jnp.asarray(batch["cir"]))
    with torch.no_grad():
        got = port(torch.tensor(batch["cir"]))
    assert got["recon"].shape == (B, L) and got["logits"].shape == (B, 2)
    for k in ("recon", "err_est", "logits", "env_code"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]).reshape(got[k].shape),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_ewine_semi_step_matches_jax(composed, batch):
    from iinsvae_tpu.training import optim as joptim
    from iinsvae_tpu.training import state as jstate

    model, variables, port = composed
    rate = 0.5
    tx = joptim.make_optimizer(1e-3, 0.5, 0.999, n_epochs=3, decay_start_epoch=1,
                               steps_per_epoch=1)
    js = jstate.create_train_state(model, variables, tx)
    key = jax.random.PRNGKey(3)
    grads, jm, _ = jax.jit(jsteps.make_semi_grads_fn(model, rate))(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    mask = np.asarray(jax.random.bernoulli(jax.random.split(key, 3)[0], rate, (B,)), np.float32)
    assert 0 < mask.sum() < B
    tm = steps.make_semi_grads_fn(rate)(port, {k: torch.tensor(v) for k, v in batch.items()},
                                        sup_mask=torch.tensor(mask))
    for k in METRICS:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, atol=ATOL, err_msg=k)
    got = bridge.to_flax_numpy({n: p.grad for n, p in port.named_parameters()})
    want = _flat(grads)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def _sln_params(rng):
    """The decoder tail at flagship width: four (taps, bias, gamma, beta) stages 64 -> 32 ->
    16 -> 8 -> 4 on x (b, 8, 64), then the k7 out-conv."""
    params, d = [], 64
    for _ in range(4):
        params += [(rng.normal(size=(5, d, d // 2)) / np.sqrt(5 * d)).astype(np.float32),
                   rng.uniform(-0.3, 0.3, size=d // 2).astype(np.float32),
                   rng.uniform(0.2, 1.0, size=d // 2).astype(np.float32),
                   (0.1 * rng.normal(size=d // 2)).astype(np.float32)]
        d //= 2
    params += [(rng.normal(size=(7, d, 1)) / np.sqrt(7 * d)).astype(np.float32),
               rng.uniform(-0.3, 0.3, size=1).astype(np.float32)]
    return params


def _pallas_sln_chain(x, *p, pool_len=L):
    """fused_sln_chain with the dense upsample-conv matrices, tiled rows, the reflect
    out-matrix and the 128 -> pool_len pool, as the JAX decoder builds them."""
    b, l = x.shape[0], 8
    ms, biases, gammas, betas = [], [], [], []
    for j in range(4):
        taps, bias, gamma, beta = p[4 * j:4 * j + 4]
        ms.append(dense_conv.dense_upconv_matrix(taps, l, padding=2))
        l *= 2
        for rows, v in ((biases, bias), (gammas, gamma), (betas, beta)):
            rows.append(jnp.tile(v, l).reshape(1, -1))
    m_out = dense_conv.dense_conv_matrix(p[16], l, stride=1, padding=3, pad_mode="reflect",
                                         centered=False)
    return pf.fused_sln_chain(x.reshape(b, -1), tuple(ms), tuple(gammas), tuple(betas), m_out,
                              jnp.tile(p[17], l).reshape(1, -1),
                              adaptive_avg_pool_matrix(l, pool_len), biases=tuple(biases))


def _port_sln_chain(x, *p):
    return fused.sln_chain(x, [tuple(p[4 * j:4 * j + 4]) for j in range(4)], p[16], p[17], L)


@pytest.mark.parametrize("direction", ["forward", "vjp"])
def test_plain_sln_chain_pools_to_152_as_pallas_does(direction):
    rng = np.random.default_rng(152)
    b = 5
    x = rng.normal(size=(b, 8, 64)).astype(np.float32)
    params = _sln_params(rng)
    if direction == "forward":
        want = [_pallas_sln_chain(jnp.asarray(x), *map(jnp.asarray, params))]
        got = [_port_sln_chain(torch.tensor(x), *map(torch.tensor, params))]
        assert got[0].shape == (b, L)
    else:
        g = rng.normal(size=(b, L)).astype(np.float32)
        out, vjp = jax.vjp(_pallas_sln_chain, *(jnp.asarray(a) for a in (x, *params)))
        want = vjp(jnp.asarray(g))
        leaves = [torch.tensor(a, requires_grad=True) for a in (x, *params)]
        got = torch.autograd.grad(_port_sln_chain(*leaves), leaves, torch.tensor(g))
    for i, (a, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a.detach().numpy().reshape(np.shape(w)), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=f"output {i}")


def test_ewine_entry_points_on_cpu(tmp_path, monkeypatch, capsys):
    """train_semi, evaluate, serve (its self-test sends the test split's 152-tap CIRs) and
    inspect_data, with and without --verify_data, on the eWine fixture: 2 classes."""
    monkeypatch.chdir(tmp_path)
    flags = ["--device", "cpu", "--dataset_name", "ewine", "--synthetic_n", "300",
             "--batch_size", "60", "--sample_interval", "0", "--checkpoint_interval", "-1"]
    state, final = train_semi.main(flags + ["--n_epochs", "1"])
    assert state.model.cir_len == L and state.model.num_classes == 2
    assert np.isfinite(final["rmse"])
    assert evaluate.main(flags + ["--test_epoch", "1"]) == final
    serve.main(flags + ["--epoch", "1", "--selftest_n", "5", "--serve_batch", "4", "--recon"])
    train, test = inspect_data.main(["--dataset_name", "ewine", "--synthetic_n", "300",
                                     "--out_dir", str(tmp_path / "out")])
    assert train[0].shape == (240, L) and test[0].shape == (60, L)
    with pytest.raises(SystemExit) as e:
        inspect_data.main(["--verify_data", "--dataset_name", "ewine"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "no ewine csvs -> synthetic fixture at ./data/data_ewine/dataset1/tag_room0.csv" in out
    assert "self-test ok: 5 requests through the server" in out and "recon (5, 152)" in out
    assert "[verify_data] ewine ./data/data_ewine: OK" in out and "total rows 300" in out
    assert list((tmp_path / "out").glob("ewine_sample_*.png"))
