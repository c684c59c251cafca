"""`train_semi` entry of the port: semi-supervised training of the 1-D
IIns-VAE, or with ``--conv_type 2`` the expanded 2-D one, with ``--conv_type
3`` the column-image one (iinsvae_tpu/cli/train_semi.py, one process). ``--use_soft`` trains the
reparameterised restorer (its sample in the step, its mu evaluated);
``--env_conv_init torch`` draws the env encoder's conv taps from torch's
default (refused at conv_type 2). With ``--conv_type 2 --compute_dtype
bfloat16`` the CIRs, the activations and the test split are bfloat16 (the
parameters, Adam and the checkpoints stay float32).

Resolves the data (cli/common.resolve_data): the Zenodo pickle at
``--data_root`` (which needs pandas) and the environment ``--dataset_env``, or
with ``--dataset_name ewine`` the eWine CSVs (152 taps, 2 classes), else the
synthetic fixture of ``--synthetic_n`` CIRs (``--fixture_version``); takes the
``--mode`` split ('full': the first ``--split_factor`` of the rows train, the
rest test; 'paper': the medium room, Room == 2, held out), standardizes it (the
mmap cache keeps it for the next run), pads the train part to whole batches
and keeps both parts on the device; then runs the epochs of
the semi step (per-sample or per-batch Bernoulli(``--supervision_rate``)
label mask, Adam with the LambdaLR decay from ``--decay_epoch``) and logs
one line an epoch: the loss, its four parts, the range RMSE and the env
accuracy. Around them:

- ``--epoch N`` resumes from checkpoint N, ``--epoch -1`` from the latest;
  the LR schedule goes on from the restored step;
- a checkpoint every ``--checkpoint_interval`` epochs (-1: none), then
  ``--keep_last`` cleanup (the newest N and the best stay);
- an evaluation of the test part every ``--sample_interval`` epochs after
  epoch 0 (0: none); a new best validation RMSE moves ``best.json`` and
  saves that epoch;
- at the end a checkpoint at ``--n_epochs`` and a final evaluation that
  writes the residual exports.

Checkpoints go under ``--model_dir``, ``train_log.log`` and the residuals
under ``--out_dir`` (training/checkpoint.py names the directories). The SVM
baseline and the plots are not ported.

    python -m iinsvae_torch.cli.train_semi --dataset_env room_full --n_epochs 3 \\
        --synthetic_n 10000 --batch_size 500
    python -m iinsvae_torch.cli.train_semi --mode paper --dataset_env paper --conv_type 2 \\
        --compute_dtype bfloat16 --supervision_rate 1.0 --n_epochs 800 --decay_epoch 300
    python -m iinsvae_torch.cli.train_semi --dataset_name ewine --n_epochs 3
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import torch

from iinsvae_torch.cli.common import (EpochLogger, device_data, fmt_metrics, parse,
                                      setup_logging, start_epoch, train_state)
from iinsvae_torch.config import Config, reject_bf16, reject_parallel
from iinsvae_torch.evaluation.evaluate import evaluate_semi
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.conv import fp32_reduction
from iinsvae_torch.serving import resolve_device
from iinsvae_torch.training.checkpoint import (gc_checkpoints, restore_checkpoint,
                                               save_checkpoint, semi_model_dir,
                                               semi_result_dir, update_best)
from iinsvae_torch.training.loop import make_epoch_runner, train_epochs
from iinsvae_torch.training.state import TrainState
from iinsvae_torch.training.steps import make_semi_train_step

LOGGED = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "rmse", "accuracy")


@dataclass
class Trainer:
    cfg: Config
    state: TrainState
    data: dict[str, torch.Tensor]  # the padded train split, on the device
    test: dict[str, torch.Tensor]  # the test split (cir, err, label), on the device
    train_step: Callable
    run_epoch: Callable


def build(cfg: Config, device: str | torch.device = "cuda") -> Trainer:
    """The data's split on ``device``, the seeded model, Adam with the
    schedule, the step and the epoch runner. Under ``--compute_dtype
    bfloat16`` on the card, train under ``ops.conv.fp32_reduction`` (as
    ``main`` does)."""
    reject_parallel(cfg)
    reject_bf16(cfg)
    data, test = device_data(cfg, resolve_device(device))
    model = IInsVAE(**cfg.model_kwargs(),
                    generator=torch.Generator().manual_seed(cfg.seed)).to(data["cir"].device)
    state = train_state(model, cfg, data["cir"].shape[0] // cfg.batch_size)
    step = make_semi_train_step(cfg.supervision_rate, mask_mode=cfg.mask_mode,
                                kl_free_bits=cfg.kl_free_bits)
    return Trainer(cfg, state, data, test, step, make_epoch_runner(step, cfg.batch_size))


@fp32_reduction()
def main(argv=None) -> tuple[TrainState, dict]:
    """-> (the trained state, the final evaluation's metrics)."""
    args, cfg = parse(__doc__, argv)
    t0 = time.perf_counter()
    trainer = build(cfg, args.device)
    model_path, result_path = semi_model_dir(cfg), semi_result_dir(cfg)
    logger = setup_logging(result_path, "train_log.log")
    logger.info(str(cfg.to_dict()))
    state = trainer.state
    cfg.epoch = start_epoch(cfg, model_path)
    if cfg.epoch != 0:
        restore_checkpoint(model_path, cfg.epoch, state)
        logger.info(f"resumed from epoch {cfg.epoch}")
    n = int(trainer.data["weight"].sum().item())
    logger.info(f"[train_semi] {n} train CIRs in {trainer.data['cir'].shape[0] // cfg.batch_size} "
                f"batches of {cfg.batch_size} on {trainer.data['cir'].device}, "
                f"supervision {cfg.supervision_rate} ({cfg.mask_mode})")
    eval_bs = min(500, trainer.test["cir"].shape[0])

    def evaluate(epoch: int, state: TrainState, final: bool = False) -> dict:
        return evaluate_semi(state.model, trainer.test, eval_bs, result_path=result_path,
                             epoch=epoch, dataset_env=cfg.dataset_env,
                             dataset_name=cfg.dataset_name, export=final)

    def validate(epoch: int, state: TrainState) -> None:
        if epoch == 0:
            return
        m = evaluate(epoch, state)
        logger.info(f"[val epoch {epoch}] {fmt_metrics(m)}")
        # best-model tracking keyed on the validation range RMSE
        if update_best(model_path, epoch, m["rmse"]):
            save_checkpoint(model_path, epoch, state)
            logger.info(f"[best epoch {epoch}] rmse {m['rmse']:.6f}")

    def checkpoint(epoch: int, state: TrainState) -> None:
        save_checkpoint(model_path, epoch, state)
        gc_checkpoints(model_path, cfg.keep_last)

    train_epochs(state, trainer.run_epoch, trainer.data, cfg.n_epochs, seed=cfg.seed,
                 start_epoch=cfg.epoch,
                 log_fn=EpochLogger(logger, cfg.n_epochs,
                                    f"[Model: C{cfg.conv_type}_{cfg.restorer_type}_semi"
                                    f"{cfg.supervision_rate}]"),
                 eval_fn=validate, eval_interval=cfg.sample_interval,
                 checkpoint_fn=checkpoint, checkpoint_interval=max(cfg.checkpoint_interval, 0))
    save_checkpoint(model_path, cfg.n_epochs, state)
    gc_checkpoints(model_path, cfg.keep_last)
    m = evaluate(cfg.n_epochs, state, final=True)
    logger.info(f"[final] {fmt_metrics(m)} [wall: {time.perf_counter() - t0:.3f}s]")
    return state, m


if __name__ == "__main__":
    main()
