"""What the entry points share: logging, the data on the device, a model's
train state, resuming and the epoch lines (iinsvae_tpu/cli/common.py).

The port has no loader of the real datasets: ``resolve_data`` builds the
synthetic fixture (``--synthetic_n`` CIRs from ``--seed``) and its split.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from iinsvae_torch.config import Config, add_args, add_train_args, from_args
from iinsvae_torch.data.splits import full_split
from iinsvae_torch.data.synthetic import synthetic_arrays
from iinsvae_torch.training.checkpoint import latest_epoch
from iinsvae_torch.training.loop import pad_to_batches
from iinsvae_torch.training.state import TrainState, create_train_state


def parse(doc: str, argv=None) -> tuple[argparse.Namespace, Config]:
    """The training entry points' flags: --device and the model and training
    flags. -> (the namespace, its Config)."""
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    add_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    return args, from_args(args)


def setup_logging(result_path: str, filename: str) -> logging.Logger:
    """A logger that writes to ``result_path/filename`` (with times) and to
    stdout (the message alone)."""
    os.makedirs(result_path, exist_ok=True)
    logger = logging.getLogger(filename)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()
    fh = logging.FileHandler(os.path.join(result_path, filename))
    fh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    logger.info("Started")
    return logger


def resolve_data(cfg: Config):
    """-> (train, test), each (cir, err, label) as float32 numpy, the CIRs
    standardized with the train part's statistics: the synthetic fixture of
    ``cfg.dataset_env`` and its 'full' split at ``cfg.split_factor``."""
    if cfg.mode != "full":
        raise NotImplementedError(
            f"mode {cfg.mode!r}: only the 'full' split is ported; the 'paper' split comes "
            "with the data pipeline slice")
    cir, err, label, _ = synthetic_arrays(cfg.synthetic_n, cfg.seed, cfg.dataset_env,
                                          cfg.dataset_name)
    return full_split(cir, err, label, cfg.split_factor)


def batch_dict(split, cfg: Config) -> dict[str, torch.Tensor]:
    """(cir, err, label) -> {cir, err, label} tensors on the CPU, the CIRs in
    ``cfg.compute_dtype`` and err and label float32 (iinsvae_tpu/cli/common.py:111-118)."""
    cir, err, label = (torch.as_tensor(v) for v in split)
    return {"cir": cir.to(cfg.torch_dtype), "err": err.float(), "label": label.float()}


def device_data(cfg: Config, device: torch.device) -> tuple[dict, dict]:
    """-> (the train split padded to whole batches of ``cfg.batch_size`` with
    its weight mask (in the CIRs' dtype), the test split {cir, err, label}),
    both on ``device`` (batch_dict)."""
    train, test = resolve_data(cfg)
    data = pad_to_batches(batch_dict(train, cfg), cfg.batch_size)
    data = {k: v.to(device) for k, v in data.items()}
    test = {k: v.to(device) for k, v in batch_dict(test, cfg).items()}
    return data, test


def train_state(model: torch.nn.Module, cfg: Config, steps_per_epoch: int) -> TrainState:
    """Adam over ``model`` with the LambdaLR decay of ``cfg``."""
    return create_train_state(model, cfg.lr, cfg.b1, cfg.b2, n_epochs=cfg.n_epochs,
                              decay_start_epoch=cfg.decay_epoch, steps_per_epoch=steps_per_epoch)


def start_epoch(cfg: Config, model_path: str, tag: str = "") -> int:
    """``--epoch``: -1 is the latest checkpoint of ``tag`` under ``model_path``
    (0 where there is none)."""
    return (latest_epoch(model_path, tag) or 0) if cfg.epoch == -1 else cfg.epoch


def fmt_metrics(metrics: dict) -> str:
    return " ".join(f"[{k}: {v:.6f}]" for k, v in metrics.items() if isinstance(v, float))


class EpochLogger:
    """One line an epoch with the epoch time and the ETA; the line starts
    with ``[Epoch i/n]``, followed by the header."""

    def __init__(self, logger: logging.Logger, n_epochs: int, header: str = ""):
        self.logger = logger
        self.n_epochs = n_epochs
        self.header = header
        self.t0 = time.time()
        self.done = 0

    def __call__(self, epoch: int, metrics: dict) -> None:
        self.done += 1
        elapsed = time.time() - self.t0
        eta = elapsed / self.done * (self.n_epochs - epoch - 1)
        head = f" {self.header}" if self.header else ""
        self.logger.info(f"[Epoch {epoch}/{self.n_epochs}]{head} {fmt_metrics(metrics)} "
                         f"[epoch time: {elapsed / self.done:.3f}s ETA: {eta:.0f}s]")
