"""The port's joint and separated entry points on the CPU (no JAX needed).

- ``cli.run`` on the default environment (nlos, 2 classes) at 70 CIRs:
  its log, its checkpoints at the interval and the end, the evaluations,
  the residual exports under the ``test`` results; a run of 1 epoch resumed
  with ``--epoch -1`` to 2 ends on the parameters of a continuous 2-epoch
  run, bit for bit, with the LR decay active in the resumed epoch (as
  tests/test_cli.py:197 holds the JAX CLIs); ``cli.evaluate --net joint``
  reads the final checkpoint and gives the run's final metrics; the same
  with ``--net_ablation loops`` and Conv heads, whose BatchNormEps running
  stats the checkpoint holds.
- ``cli.run_sep``: ``ENet_epoch_N`` / ``MNet_epoch_N`` checkpoints, the sep-E
  and sep-M epoch lines, finite sep-EM soft and hard RMSE, and a resume
  bit-equal to the continuous run. The entry points import in a fresh
  interpreter where importing jax or the JAX package fails.
- ``train_semi --restorer_type 2 --classifier_type 3`` (Conv1d and Conv2d
  heads) trains, checkpoints the BatchNormEps running stats, and evaluates.
- Without ``--device cpu`` the entry points raise where CUDA is missing;
  ``--n_devices`` and ``--dist_*`` raise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from iinsvae_torch.cli import evaluate as evaluate_cli
from iinsvae_torch.cli import run, run_sep, train_semi
from iinsvae_torch.config import Config
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# 56 train CIRs in 2 batches of 32, 14 test CIRs; the LR decays from the second epoch on
SMALL = ["--device", "cpu", "--synthetic_n", "70", "--batch_size", "32", "--decay_epoch", "0"]


def _dirs(tmp) -> list[str]:
    return ["--model_dir", os.path.join(tmp, "saved_models"),
            "--out_dir", os.path.join(tmp, "saved_results")]


def _cfg(tmp, **kw) -> Config:
    return Config(synthetic_n=70, batch_size=32, model_dir=os.path.join(tmp, "saved_models"),
                  out_dir=os.path.join(tmp, "saved_results"), **kw)


def _equal_states(a, b) -> list[str]:
    return [k for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values())
            if not torch.equal(x, y)]


def test_run_trains_checkpoints_resumes_and_evaluates(tmp_path):
    cont = str(tmp_path / "continuous")
    state, m = run.main(SMALL + _dirs(cont) + ["--n_epochs", "2", "--checkpoint_interval", "1",
                                               "--sample_interval", "1"])
    cfg = _cfg(cont)
    model_path = ckpt.joint_model_dir(cfg)
    assert model_path == os.path.join(cont, "saved_models_loop", "data_zenodo_nlos_mode_full",
                                      "enetLinear_mnetLinear")
    assert ckpt.list_epochs(model_path) == [0, 1, 2]
    assert state.step == 2 * 2
    for k in ("rmse", "abs", "accuracy", "plurality_share"):
        assert np.isfinite(m[k]), k
    log = open(os.path.join(ckpt.joint_result_dir(cfg), "training_log.log")).read()
    assert "[Epoch 1/2]" in log and "[val epoch 1]" in log and "[test]" in log
    assert "loss_idy" in log and "loss_reg" in log
    npz = np.load(os.path.join(ckpt.joint_result_dir(cfg, test=True),
                               "residuals_zenodo_nlos_2.npz"))
    assert npz["residual_em"].shape == (14, 1) and (npz["residual_em"] >= 0).all()

    # 1 epoch, then resumed to 2: the continuous run's parameters, bit for bit
    res = str(tmp_path / "resumed")
    run.main(SMALL + _dirs(res) + ["--n_epochs", "1", "--checkpoint_interval", "-1"])
    resumed, m_r = run.main(SMALL + _dirs(res) + ["--n_epochs", "2", "--epoch", "-1",
                                                  "--checkpoint_interval", "-1"])
    assert resumed.step == state.step and not _equal_states(state, resumed)
    assert m_r == m

    # evaluate --net joint reads the final checkpoint
    got = evaluate_cli.main(SMALL + _dirs(cont) + ["--net", "joint", "--test_epoch", "2"])
    assert {k: got[k] for k in ("rmse", "abs", "accuracy")} == {
        k: m[k] for k in ("rmse", "abs", "accuracy")}
    assert "[test epoch 2]" in open(os.path.join(ckpt.joint_result_dir(cfg, test=True),
                                                 "val_log.log")).read()


def test_run_loops_with_conv_heads_saves_the_running_stats_and_evaluates(tmp_path):
    tmp = str(tmp_path)
    flags = SMALL + _dirs(tmp) + ["--net_ablation", "loops", "--identifier_type", "2",
                                  "--regressor_type", "3"]
    state, m = run.main(flags + ["--n_epochs", "1"])
    cfg = _cfg(tmp, net_ablation="loops", identifier_type="Conv1d", regressor_type="Conv2d")
    saved = ckpt.read_checkpoint(ckpt.joint_model_dir(cfg), 1)["model"]
    assert "loop_proj.kernel" in saved
    bn = "identifier.classifier.BatchNormEps_0.mean"
    assert torch.equal(saved[bn], state.model.state_dict()[bn]) and saved[bn].abs().sum() > 0
    assert np.isfinite(m["rmse"])
    got = evaluate_cli.main(flags + ["--net", "joint"])
    assert got["rmse"] == m["rmse"] and got["accuracy"] == m["accuracy"]


def test_the_entry_points_import_without_jax():
    """run, run_sep and evaluate in a fresh interpreter where importing jax or
    the JAX package fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['iinsvae_tpu'] = None\n"
            "from iinsvae_torch.cli import evaluate, run, run_sep\n"
            "print('imported')\n")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    # the time limit leaves room for a machine loaded by the suite's other workers
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and "imported" in r.stdout, r.stderr


def test_run_sep_trains_both_stages_and_resumes_bit_equal(tmp_path, capsys):
    cont = str(tmp_path / "continuous")
    m = run_sep.main(SMALL + _dirs(cont) + ["--n_epochs", "2", "--checkpoint_interval", "1"])
    for k in ("accuracy", "rmse", "rmse_hard", "abs", "plurality_share"):
        assert np.isfinite(m[k]), k
    cfg = _cfg(cont)
    model_path = ckpt.sep_model_dir(cfg)
    assert model_path.endswith(os.path.join("saved_models_sep", "data_zenodo_nlos_mode_full",
                                            "enetLinear_mnetLinear"))
    for tag in ("ENet", "MNet"):
        assert ckpt.list_epochs(model_path, tag) == [0, 1, 2]
        assert ckpt.latest_epoch(model_path, tag) == 2
    assert ckpt.list_epochs(model_path) == []
    lines = capsys.readouterr().out.splitlines()
    assert sum("[Sep-E Identifier" in ln for ln in lines) == 2
    assert sum("[Sep-M Regressor" in ln for ln in lines) == 2
    assert any(ln.startswith("[Sep-EM test]") for ln in lines)

    # 1 epoch, then resumed to 2: both models as the continuous run left them
    res = str(tmp_path / "resumed")
    run_sep.main(SMALL + _dirs(res) + ["--n_epochs", "1", "--checkpoint_interval", "-1"])
    m_r = run_sep.main(SMALL + _dirs(res) + ["--n_epochs", "2", "--epoch", "-1",
                                             "--checkpoint_interval", "-1"])
    assert m_r == m
    res_path = ckpt.sep_model_dir(_cfg(res))
    for tag in ("ENet", "MNet"):
        want = ckpt.read_checkpoint(model_path, 2, tag)
        got = ckpt.read_checkpoint(res_path, 2, tag)
        assert got["step"] == want["step"] == 2 * 2
        for k, v in want["model"].items():
            assert torch.equal(got["model"][k], v), (tag, k)


def test_train_semi_with_conv_heads_trains_and_evaluates(tmp_path):
    tmp = str(tmp_path)
    flags = SMALL + _dirs(tmp) + ["--restorer_type", "2", "--classifier_type", "3"]
    state, m = train_semi.main(flags + ["--n_epochs", "1"])
    assert np.isfinite(m["rmse"]) and 0.0 <= m["accuracy"] <= 1.0
    cfg = _cfg(tmp, restorer_type="Conv1d", classifier_type="Conv2d")
    path = ckpt.semi_model_dir(cfg)
    assert path.endswith("SEMI0.100000_AE1_ResConv1d_ClsConv2d_Rdim2Edim16")
    saved = ckpt.read_checkpoint(path, 1)["model"]
    assert "restorer.restorer.BatchNormEps_0.var" in saved
    got = evaluate_cli.main(flags + ["--test_epoch", "1"])
    assert {k: got[k] for k in ("rmse", "accuracy")} == {k: m[k] for k in ("rmse", "accuracy")}
    # the predictor serves the checkpoint in eval mode: running stats, no dropout
    p = Predictor.from_checkpoint(cfg, 1, batch_size=16, device="cpu")
    assert not p.model.training
    cirs = np.random.default_rng(0).normal(size=(5, 157)).astype(np.float32)
    np.testing.assert_array_equal(p(cirs).err_est, p(cirs).err_est)


@pytest.mark.parametrize("main", [run.main, run_sep.main])
def test_joint_and_sep_entry_points_need_cuda_and_one_device(main, tmp_path):
    base = ["--synthetic_n", "70", "--batch_size", "32", "--n_epochs", "1"] + _dirs(
        str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(base)
    for extra in (["--n_devices", "2"], ["--dist_procs", "2", "--dist_rank", "0",
                                         "--dist_coordinator", "localhost:1"]):
        with pytest.raises(NotImplementedError, match="parallel training"):
            main(base + ["--device", "cpu"] + extra)
