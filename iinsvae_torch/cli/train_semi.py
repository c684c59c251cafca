"""`train_semi` entry of the port: semi-supervised training of the 1-D
IIns-VAE, or with ``--conv_type 2`` the expanded 2-D one, on the synthetic
fixture (iinsvae_tpu/cli/train_semi.py).

Builds the synthetic Zenodo fixture (``--synthetic_n`` CIRs, fixture v2),
takes the 'full' split's train part (the first 80%), standardizes it, pads
it to whole batches and keeps it on the device; then runs ``--n_epochs``
epochs of the semi step (per-sample or per-batch
Bernoulli(``--supervision_rate``) label mask, Adam with the LambdaLR decay
from ``--decay_epoch``) and prints one line an epoch: the loss, its four
parts, the range RMSE and the env accuracy. Checkpoints, evaluation and the
SVM baseline come with the evaluation slice.

    python -m iinsvae_torch.cli.train_semi --dataset_env room_full --n_epochs 3 \\
        --synthetic_n 10000 --batch_size 500
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Callable

import torch

from iinsvae_torch.config import Config, add_args, add_train_args, from_args
from iinsvae_torch.data.splits import full_split
from iinsvae_torch.data.synthetic import synthetic_arrays
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import resolve_device
from iinsvae_torch.training.loop import make_epoch_runner, pad_to_batches, train_epochs
from iinsvae_torch.training.state import TrainState, create_train_state
from iinsvae_torch.training.steps import make_semi_train_step

LOGGED = ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env", "rmse", "accuracy")


@dataclass
class Trainer:
    cfg: Config
    state: TrainState
    data: dict[str, torch.Tensor]  # the padded train split, on the device
    train_step: Callable
    run_epoch: Callable


def build(cfg: Config, device: str | torch.device = "cuda") -> Trainer:
    """The fixture's train split on ``device``, the seeded model, Adam with
    the schedule, the step and the epoch runner."""
    device = resolve_device(device)
    cir, err, label, _ = synthetic_arrays(cfg.synthetic_n, cfg.seed, cfg.dataset_env,
                                          cfg.dataset_name)
    (train_cir, train_err, train_label), _ = full_split(cir, err, label)
    data = pad_to_batches({"cir": train_cir, "err": train_err, "label": train_label},
                          cfg.batch_size)
    data = {k: v.to(device) for k, v in data.items()}
    steps_per_epoch = data["cir"].shape[0] // cfg.batch_size
    model = IInsVAE(**cfg.model_kwargs(),
                    generator=torch.Generator().manual_seed(cfg.seed)).to(device)
    state = create_train_state(model, cfg.lr, cfg.b1, cfg.b2, n_epochs=cfg.n_epochs,
                               decay_start_epoch=cfg.decay_epoch,
                               steps_per_epoch=steps_per_epoch)
    step = make_semi_train_step(cfg.supervision_rate, mask_mode=cfg.mask_mode,
                                kl_free_bits=cfg.kl_free_bits)
    return Trainer(cfg, state, data, step, make_epoch_runner(step, cfg.batch_size))


def main(argv=None) -> tuple[Trainer, list[dict]]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    cfg = from_args(args)
    trainer = build(cfg, args.device)
    n = int(trainer.data["weight"].sum().item())
    print(f"[train_semi] {n} train CIRs in {trainer.data['cir'].shape[0] // cfg.batch_size} "
          f"batches of {cfg.batch_size} on {trainer.data['cir'].device}, "
          f"supervision {cfg.supervision_rate} ({cfg.mask_mode})", flush=True)
    t0 = time.perf_counter()

    def log(epoch, m):
        parts = " ".join(f"[{k}: {m[k]:.6f}]" for k in LOGGED)
        print(f"[Epoch {epoch}/{cfg.n_epochs}] {parts} "
              f"[{time.perf_counter() - t0:.2f}s]", flush=True)

    history = train_epochs(trainer.state, trainer.run_epoch, trainer.data, cfg.n_epochs,
                           seed=cfg.seed, log_fn=log)
    return trainer, history


if __name__ == "__main__":
    main()
