"""`run` entry of the port: supervised joint training of EMNet
(``--net_ablation loop``) or EMNetLoop (``loops``) on the dataset (the synthetic
fixture where the real one is absent), then its evaluation (iinsvae_tpu/cli/run.py,
one process).

Resolves the data and its ``--mode`` split as ``train_semi`` does, then runs the
epochs of the joint step (CE on the env logits + L1 on the ranging error,
Adam with the LambdaLR decay from ``--decay_epoch``) and logs one line an
epoch. ``--identifier_type`` / ``--regressor_type`` (1 Linear, 2 Conv1d,
3 Conv2d) pick the heads. Around the epochs:

- ``--epoch N`` resumes from checkpoint N, ``--epoch -1`` from the latest;
- a checkpoint every ``--checkpoint_interval`` epochs (-1: none), then
  ``--keep_last`` cleanup;
- an evaluation of the test part every ``--sample_interval`` epochs after
  epoch 0 (0: none), written under the training results;
- at the end a checkpoint at ``--n_epochs`` and the final evaluation
  (``evaluate_joint``), whose residual exports go under the ``test``
  results directory.

Checkpoints go under ``<--model_dir>_<net_ablation>``, ``training_log.log``
and the residuals under ``<--out_dir>_<net_ablation>`` (training/
checkpoint.py names the directories). Parallel training (``--n_devices``,
``--dist_*``), the SVM baseline and the plots are not ported.

    python -m iinsvae_torch.cli.run --net_ablation loops --dataset_env room_full \\
        --n_epochs 400 --synthetic_n 10000 --batch_size 500
"""

from __future__ import annotations

import time

import torch

from iinsvae_torch.cli.common import (EpochLogger, device_data, fmt_metrics, parse,
                                      setup_logging, start_epoch, train_state)
from iinsvae_torch.config import Config, reject_bf16, reject_parallel
from iinsvae_torch.evaluation.evaluate import evaluate_joint
from iinsvae_torch.models.emnet import EMNet, EMNetLoop
from iinsvae_torch.serving import resolve_device
from iinsvae_torch.training.checkpoint import (gc_checkpoints, joint_model_dir, joint_result_dir,
                                               restore_checkpoint, save_checkpoint)
from iinsvae_torch.training.loop import make_epoch_runner, train_epochs
from iinsvae_torch.training.state import TrainState
from iinsvae_torch.training.steps import make_joint_train_step


def build_model(cfg: Config):
    """EMNet for ``--net_ablation loop``, EMNetLoop for ``loops``, seeded with ``cfg.seed``."""
    cls = {"loop": EMNet, "loops": EMNetLoop}.get(cfg.net_ablation)
    if cls is None:
        raise ValueError("Unknown network arrangement, choices: loop, loops.")
    return cls(**cfg.joint_kwargs(), generator=torch.Generator().manual_seed(cfg.seed))


def main(argv=None) -> tuple[TrainState, dict]:
    """-> (the trained state, the final evaluation's metrics)."""
    args, cfg = parse(__doc__, argv)
    reject_parallel(cfg)
    reject_bf16(cfg, "run")
    t0 = time.perf_counter()
    data, test = device_data(cfg, resolve_device(args.device))
    model = build_model(cfg).to(data["cir"].device)
    state = train_state(model, cfg, data["cir"].shape[0] // cfg.batch_size)
    model_path = joint_model_dir(cfg)
    train_path, test_path = joint_result_dir(cfg), joint_result_dir(cfg, test=True)
    logger = setup_logging(train_path, "training_log.log")
    logger.info(str(cfg.to_dict()))
    cfg.epoch = start_epoch(cfg, model_path)
    if cfg.epoch != 0:
        restore_checkpoint(model_path, cfg.epoch, state)
        logger.info(f"resumed from epoch {cfg.epoch}")
    logger.info(f"[run] {cfg.net_ablation}: {int(data['weight'].sum().item())} train CIRs in "
                f"{data['cir'].shape[0] // cfg.batch_size} batches of {cfg.batch_size} on "
                f"{data['cir'].device}")
    eval_bs = min(500, test["cir"].shape[0])

    def evaluate(epoch: int, path: str, final: bool = False) -> dict:
        return evaluate_joint(state.model, test, eval_bs, result_path=path, epoch=epoch,
                              dataset_env=cfg.dataset_env, dataset_name=cfg.dataset_name,
                              export=final)

    def validate(epoch: int, state: TrainState) -> None:
        if epoch > 0:
            logger.info(f"[val epoch {epoch}] {fmt_metrics(evaluate(epoch, train_path))}")

    def checkpoint(epoch: int, state: TrainState) -> None:
        save_checkpoint(model_path, epoch, state)
        gc_checkpoints(model_path, cfg.keep_last)

    train_epochs(state, make_epoch_runner(make_joint_train_step(), cfg.batch_size), data,
                 cfg.n_epochs, seed=cfg.seed, start_epoch=cfg.epoch,
                 log_fn=EpochLogger(logger, cfg.n_epochs,
                                    f"[Data Env: {cfg.dataset_env}] [Identifier"
                                    f"{cfg.identifier_type}_Regressor{cfg.regressor_type}]"),
                 eval_fn=validate, eval_interval=cfg.sample_interval,
                 checkpoint_fn=checkpoint, checkpoint_interval=max(cfg.checkpoint_interval, 0))
    save_checkpoint(model_path, cfg.n_epochs, state)
    gc_checkpoints(model_path, cfg.keep_last)
    m = evaluate(cfg.n_epochs, test_path, final=True)
    logger.info(f"[test] {fmt_metrics(m)} [wall: {time.perf_counter() - t0:.3f}s]")
    return state, m


if __name__ == "__main__":
    main()
