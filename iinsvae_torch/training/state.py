"""Train state: the model, its optimizer, the LR schedule and the step
(iinsvae_tpu/training/state.py). The model's parameters and the
optimizer's moments are updated in place."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from iinsvae_torch.training.optim import make_optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad`` at lr = schedule(step)."""
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, lr: float = 1e-4, b1: float = 0.5, b2: float = 0.999,
                       n_epochs: int | None = None, decay_start_epoch: int | None = None,
                       steps_per_epoch: int = 1) -> TrainState:
    optimizer, schedule = make_optimizer(model.parameters(), lr, b1, b2, n_epochs,
                                         decay_start_epoch, steps_per_epoch)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule)
