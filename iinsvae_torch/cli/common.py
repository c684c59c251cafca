"""Shared entry-point plumbing: logging, the data and the epoch lines
(iinsvae_tpu/cli/common.py:26-38, 143-163).

The port has no loader of the real datasets: ``resolve_data`` builds the
synthetic fixture (``--synthetic_n`` CIRs from ``--seed``) and its split.
"""

from __future__ import annotations

import logging
import os
import sys
import time

from iinsvae_torch.config import Config
from iinsvae_torch.data.splits import full_split
from iinsvae_torch.data.synthetic import synthetic_arrays


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
