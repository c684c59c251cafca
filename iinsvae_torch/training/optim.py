"""Adam and the LambdaLR schedule (iinsvae_tpu/training/optim.py).

Adam(lr=1e-4, betas=(0.5, 0.999), eps=1e-8): ``torch.optim.Adam`` has the
update formula of optax ``adam`` (the JAX package runs it outside any
Pallas kernel too). The learning rate of update ``i`` (counted from 0, as
optax counts) is ``schedule(i)``: the reference's per-epoch linear decay
``1 - max(0, epoch + offset - decay_start) / (n_epochs - decay_start)``,
clamped at 0 so training past ``n_epochs`` stops instead of ascending.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def lambda_lr_schedule(base_lr: float, n_epochs: int, decay_start_epoch: int,
                       steps_per_epoch: int, offset: int = 0) -> Callable[[int], float]:
    if n_epochs - decay_start_epoch <= 0:
        raise ValueError("Decay must start before the training session ends!")

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        factor = 1.0 - max(0.0, epoch + offset - decay_start_epoch) / (
            n_epochs - decay_start_epoch)
        return base_lr * max(factor, 0.0)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4, b1: float = 0.5,
                   b2: float = 0.999, n_epochs: int | None = None,
                   decay_start_epoch: int | None = None, steps_per_epoch: int = 1,
                   offset: int = 0) -> tuple[torch.optim.Adam, Callable[[int], float]]:
    """-> (Adam over ``params``, the schedule). Without a decay that starts
    before ``n_epochs`` the schedule is the constant ``lr``."""
    if n_epochs is not None and decay_start_epoch is not None and decay_start_epoch < n_epochs:
        schedule = lambda_lr_schedule(lr, n_epochs, decay_start_epoch, steps_per_epoch, offset)
    else:
        def schedule(step: int) -> float:
            return lr
    return torch.optim.Adam(params, lr=schedule(0), betas=(b1, b2), eps=1e-8), schedule
