"""The port's checkpoints, resume and entry points on the CPU.

- A save/restore round trip: parameters, Adam's moments and steps, the
  train state's step and the LR of the next update, bit for bit.
- ``gc_checkpoints`` and ``update_best`` against the JAX package's on two
  identical trees of empty ``epoch_N`` directories.
- Resume: a run of 2 epochs resumed with ``--epoch 2`` to 4 ends on the
  parameters of a continuous 4-epoch run, bit for bit, with the LR decay
  active from epoch 1 (iinsvae_tpu tests/test_cli.py:197).
- The entry points: ``train_semi`` with its default environment (nlos)
  writes its log, checkpoints, ``best.json`` and residual exports without
  JAX; ``--epoch -1`` resumes from the latest checkpoint; ``evaluate`` reads
  a checkpoint and exits where there is none, and with ``--net joint`` reads
  the joint path's; ``serve --epoch N`` serves it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from iinsvae_tpu.training import checkpoint as jckpt
from iinsvae_torch.cli import evaluate as evaluate_cli
from iinsvae_torch.cli import run, serve, train_semi
from iinsvae_torch.config import Config
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import checkpoint as ckpt
from iinsvae_torch.training import steps
from iinsvae_torch.training.state import create_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--synthetic_n", "120", "--batch_size", "32"]


def _dirs(tmp) -> list[str]:
    return ["--model_dir", os.path.join(tmp, "saved_models"),
            "--out_dir", os.path.join(tmp, "saved_results")]


def _state(seed: int = 1):
    model = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                    generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, 1e-3, n_epochs=4, decay_start_epoch=1, steps_per_epoch=2)


def _train(state, n: int = 3) -> None:
    rng = np.random.default_rng(0)
    step = steps.make_semi_train_step(0.5)
    gen = torch.Generator().manual_seed(2)
    for _ in range(n):
        batch = {"cir": torch.tensor(rng.normal(size=(8, 157)), dtype=torch.float32),
                 "err": torch.tensor(np.abs(rng.normal(size=(8, 1))), dtype=torch.float32),
                 "label": torch.tensor(rng.integers(0, 5, (8, 1)), dtype=torch.float32)}
        step(state, batch, gen)


def test_checkpoint_round_trip_restores_params_adam_and_the_schedule(tmp_path):
    state = _state()
    _train(state, 5)
    path = ckpt.save_checkpoint(str(tmp_path), 3, state)
    assert os.path.isfile(os.path.join(path, "state.pt"))
    assert ckpt.latest_epoch(str(tmp_path)) == 3 and ckpt.list_epochs(str(tmp_path)) == [3]

    fresh = _state(seed=5)
    assert fresh.step == 0
    restored = ckpt.restore_checkpoint(str(tmp_path), 3, fresh)
    assert restored is fresh and restored.step == state.step == 5
    for (n, a), b in zip(state.model.state_dict().items(), restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    want, got = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    assert set(want) == set(got) and len(want) == len(list(state.model.parameters()))
    for i in want:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(want[i][k], got[i][k]), (i, k)
            assert got[i][k].device == want[i][k].device, (i, k)
    # the LR of the next update comes from the restored step: epoch 2, decay from epoch 1
    assert restored.schedule(restored.step) == state.schedule(state.step) == pytest.approx(
        1e-3 * (1 - 1 / 3))
    _train(state, 1)
    _train(restored, 1)
    for a, b in zip(state.model.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)


def _tree(root, epochs, best):
    for e in epochs:
        os.makedirs(os.path.join(root, f"epoch_{e}"))
    if best is not None:
        with open(os.path.join(root, "best.json"), "w") as f:
            json.dump({"epoch": best, "metric": 0.5}, f)


@pytest.mark.parametrize("best", [None, 2, 7])
@pytest.mark.parametrize("keep_last", [-1, 1, 2])
def test_gc_checkpoints_removes_what_jax_removes(tmp_path, keep_last, best):
    epochs = [0, 2, 4, 7, 10]
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    _tree(port, epochs, best)
    _tree(jax_, epochs, best)
    got, want = ckpt.gc_checkpoints(port, keep_last), jckpt.gc_checkpoints(jax_, keep_last)
    assert got == want
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_))
    assert ckpt.list_epochs(port) == jckpt.list_epochs(jax_)
    assert ckpt.latest_epoch(port) == jckpt.latest_epoch(jax_) == 10
    if best is not None:
        assert os.path.isdir(os.path.join(port, f"epoch_{best}"))


def test_update_best_keeps_only_strictly_lower_values(tmp_path):
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    assert ckpt.best_epoch(port) is None
    for epoch, metric in ((1, 0.5), (2, 0.6), (3, 0.5), (4, 0.4), (5, 0.4), (6, 0.45)):
        assert ckpt.update_best(port, epoch, metric) == jckpt.update_best(jax_, epoch, metric)
        assert ckpt.best_epoch(port) == jckpt.best_epoch(jax_)
    assert ckpt.best_epoch(port) == {"epoch": 4, "metric": 0.4}
    assert os.listdir(port) == ["best.json"]  # the pointer swapped in, no temporary left


def test_restore_best_reads_the_pointed_epoch(tmp_path):
    state = _state()
    _train(state, 1)
    ckpt.save_checkpoint(str(tmp_path), 2, state)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_best(str(tmp_path), _state())
    ckpt.update_best(str(tmp_path), 2, 0.3)
    assert ckpt.restore_best(str(tmp_path), _state()).step == 1


def test_resume_matches_continuous_run_with_active_decay(tmp_path):
    common = SMALL + ["--device", "cpu", "--dataset_env", "room_full", "--decay_epoch", "1",
                      "--checkpoint_interval", "2", "--sample_interval", "0"]
    a = str(tmp_path / "continuous")
    state_a, m_a = train_semi.main(common + _dirs(a) + ["--n_epochs", "4"])
    b = str(tmp_path / "resumed")
    train_semi.main(common + _dirs(b) + ["--n_epochs", "2"])
    state_b, m_b = train_semi.main(common + _dirs(b) + ["--n_epochs", "4", "--epoch", "2"])
    assert state_a.step == state_b.step == 4 * 3
    for (n, p), q in zip(state_a.model.named_parameters(), state_b.model.parameters()):
        assert torch.equal(p, q), n
    assert m_a == m_b


def _record_hooks(module, events, monkeypatch, rmse):
    """Replace the CLI ``module``'s checkpoint writer with one that makes an
    empty ``epoch_N`` directory, and its evaluation with one that returns
    ``rmse[epoch]``; log each save, collection, best update and evaluation
    with the checkpoint directory's listing after it."""
    real_gc, real_best = module.gc_checkpoints, module.update_best

    def save(path, epoch, state):
        os.makedirs(os.path.join(path, f"epoch_{epoch}"), exist_ok=True)
        events.append(("save", epoch, sorted(os.listdir(path))))

    def gc(path, keep_last):
        removed = real_gc(path, keep_last)
        events.append(("gc", removed, sorted(os.listdir(path))))
        return removed

    def best(path, epoch, metric):
        new = real_best(path, epoch, metric)
        events.append(("best", epoch, new))
        return new

    def evaluate(*args, epoch, **kwargs):
        events.append(("eval", epoch))
        return {"rmse": rmse[epoch], "accuracy": 0.5}

    for name, fn in (("save_checkpoint", save), ("gc_checkpoints", gc),
                     ("update_best", best), ("evaluate_semi", evaluate)):
        monkeypatch.setattr(module, name, fn)


def test_train_semi_saves_collects_and_evaluates_in_the_order_of_jax(tmp_path, monkeypatch):
    """Keep-last 1 with new bests on the checkpoint epochs 2 and 4: the port's
    CLI saves, collects, evaluates and moves best.json in the JAX CLI's order
    and leaves the same checkpoint tree after every step. Both evaluate to one
    scripted RMSE an epoch; the JAX side builds no state and trains nothing."""
    from iinsvae_tpu.cli import train_semi as jax_train_semi

    rmse = {1: 0.5, 2: 0.4, 3: 0.45, 4: 0.3, 5: 0.35}
    flags = SMALL + ["--dataset_env", "room_full", "--n_epochs", "5", "--keep_last", "1",
                     "--checkpoint_interval", "2", "--sample_interval", "1"]
    port, jax_ = [], []
    _record_hooks(train_semi, port, monkeypatch, rmse)
    _record_hooks(jax_train_semi, jax_, monkeypatch, rmse)
    sums = {"count": 1.0, "se": 1.0, "ae": 1.0, "correct": 1.0}
    monkeypatch.setattr(jax_train_semi, "init_state", lambda model, cfg, **kwargs: None)
    monkeypatch.setattr(jax_train_semi, "make_epoch_runner",
                        lambda step, batch_size: lambda state, data, key: (state, sums))
    train_semi.main(flags + ["--device", "cpu"] + _dirs(str(tmp_path / "port")))
    jax_dir = str(tmp_path / "jax")
    jax_train_semi.main(flags + _dirs(jax_dir)
                        + ["--data_root", os.path.join(jax_dir, "data", "dataset.pkl")])
    assert port == jax_
    kinds = [(e[0], e[1]) for e in port if e[0] in ("save", "eval")]
    assert kinds == [("save", 0), ("eval", 1), ("save", 1), ("save", 2), ("eval", 2),
                     ("save", 2), ("eval", 3), ("save", 4), ("eval", 4), ("save", 4),
                     ("save", 5), ("eval", 5)]
    assert port[-2] == ("gc", [2], ["best.json", "epoch_4", "epoch_5"])


def _run_without_jax(args, cwd):
    """train_semi in a fresh interpreter where importing jax or the JAX
    package fails."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['iinsvae_tpu'] = None\n"
            "from iinsvae_torch.cli import train_semi\n"
            f"train_semi.main({list(args)!r})\n")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    # the time limit leaves room for a machine loaded by the suite's other workers
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


@pytest.fixture(scope="module")
def default_env_run(tmp_path_factory):
    """train_semi with the default --dataset_env (nlos): 3 epochs, a
    checkpoint every 2, an evaluation every epoch after 0, keep-last 1."""
    tmp = str(tmp_path_factory.mktemp("default_env"))
    args = SMALL + ["--device", "cpu", "--n_epochs", "3", "--checkpoint_interval", "2",
                    "--sample_interval", "1", "--keep_last", "1"]
    r = _run_without_jax(args, tmp)
    assert r.returncode == 0, r.stderr
    cfg = Config(synthetic_n=120, batch_size=32, model_dir=os.path.join(tmp, "saved_models"),
                 out_dir=os.path.join(tmp, "saved_results"))
    return tmp, args, r, cfg


def test_train_semi_with_the_default_env_checkpoints_and_evaluates(default_env_run):
    tmp, _, r, cfg = default_env_run
    assert cfg.dataset_env == "nlos"
    # written under the working directory's ./saved_models and ./saved_results
    model_path, result_path = ckpt.semi_model_dir(cfg), ckpt.semi_result_dir(cfg)
    assert model_path == os.path.join(tmp, "saved_models", "nlos_mode_full",
                                      "SEMI0.100000_AE1_ResLinear_ClsLinear_Rdim2Edim16")
    assert "96 train CIRs in 3 batches of 32" in r.stdout
    assert [ln.split("]")[0] for ln in r.stdout.splitlines() if ln.startswith("[Epoch ")] == \
        ["[Epoch 0/3", "[Epoch 1/3", "[Epoch 2/3"]
    assert [ln.split("]")[0] for ln in r.stdout.splitlines() if ln.startswith("[val epoch")] == \
        ["[val epoch 1", "[val epoch 2"]
    final = next(ln for ln in r.stdout.splitlines() if ln.startswith("[final]"))
    for key in ("rmse", "abs", "accuracy", "plurality_share"):
        assert np.isfinite(float(final.split(f"[{key}: ")[1].split("]")[0])), final
    # epoch 0 checkpointed, then 1 and 2 each a new best or not; keep-last 1 and
    # the best leave the final epoch and the best one
    best = ckpt.best_epoch(model_path)
    assert best is not None and best["epoch"] in (1, 2)
    assert ckpt.list_epochs(model_path) == sorted({best["epoch"], 3})
    assert os.path.isfile(os.path.join(model_path, "epoch_3", "state.pt"))
    log = open(os.path.join(result_path, "train_log.log")).read()
    assert "[Epoch 2/3]" in log and "[final]" in log
    npz = np.load(os.path.join(result_path, "residuals_zenodo_nlos_3.npz"))
    assert npz["residual_em"].shape == (24, 1) and (npz["residual_em"] >= 0).all()
    assert os.path.isfile(os.path.join(result_path, "residual_em_zenodo_nlos_3.mat"))


def test_train_semi_resumes_from_the_latest_checkpoint(default_env_run, tmp_path):
    tmp, args, _, cfg = default_env_run
    import shutil
    shutil.copytree(os.path.join(tmp, "saved_models"), tmp_path / "saved_models")
    state, m = train_semi.main(args + ["--epoch", "-1", "--n_epochs", "4"] + _dirs(str(tmp_path)))
    assert state.step == 4 * 3  # three epochs restored, one trained
    log = open(os.path.join(ckpt.semi_result_dir(
        Config(**{**cfg.to_dict(), "out_dir": str(tmp_path / "saved_results")})),
        "train_log.log")).read()
    assert "resumed from epoch 3" in log
    assert np.isfinite(m["rmse"])


def test_evaluate_reads_the_checkpoint_and_serve_serves_it(default_env_run, tmp_path, capsys):
    tmp, _, _, cfg = default_env_run
    flags = SMALL + ["--device", "cpu"] + _dirs(tmp)
    m = evaluate_cli.main(flags + ["--test_epoch", "3"])
    assert 0.0 <= m["accuracy"] <= 1.0 and np.isfinite(m["rmse"]) and m["plurality_share"] > 0
    log = open(os.path.join(ckpt.semi_result_dir(cfg), "val_log.log")).read()
    assert "[test epoch 3]" in log
    # a test epoch that was not saved falls back to the latest
    assert evaluate_cli.main(flags + ["--test_epoch", "7"]) == m
    with pytest.raises(SystemExit, match="No saved models"):
        evaluate_cli.main(flags[:-4] + _dirs(str(tmp_path)))
    # --net joint evaluates the joint path's checkpoint (cli.run's), not the semi one
    _, joint = run.main(flags + ["--n_epochs", "1"])
    got = evaluate_cli.main(flags + ["--net", "joint"])
    assert {k: got[k] for k in ("rmse", "abs", "accuracy")} == {
        k: joint[k] for k in ("rmse", "abs", "accuracy")}

    serve.main(flags + ["--epoch", "3", "--selftest_n", "9", "--serve_batch", "4"])
    out = capsys.readouterr().out
    assert "checkpoint epoch 3" in out and "self-test ok: 9 requests through the server" in out
    assert "[serve] stats: 9 submitted" in out
    # the served model is the checkpoint's
    cirs = np.random.default_rng(0).normal(size=(5, 157)).astype(np.float32)
    got = Predictor.from_checkpoint(cfg, 3, batch_size=4, device="cpu")(cirs)
    model = IInsVAE(**cfg.model_kwargs())
    model.load_state_dict(ckpt.read_checkpoint(ckpt.semi_model_dir(cfg), 3)["model"])
    want = Predictor(model, batch_size=4, device="cpu")(cirs)
    np.testing.assert_array_equal(got.err_est, want.err_est)
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(Config(model_dir=str(tmp_path)), device="cpu")
