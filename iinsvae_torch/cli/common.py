"""What the entry points share: logging, the data and its split on the device, a model's
train state, resuming and the epoch lines (iinsvae_tpu/cli/common.py).

``resolve_data`` reads the real dataset where it is (the Zenodo pickle at ``--data_root``,
which needs pandas; the eWine CSVs at ``EWINE_DEFAULT_PATHS``), else the synthetic fixture of
``--synthetic_n`` CIRs from ``--seed`` (``--no_synthetic``: FileNotFoundError), assembles the
``--mode`` split and keeps it in the mmap cache (``--no_data_cache``: not).
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import torch

from iinsvae_torch.config import Config, add_args, add_train_args, from_args
from iinsvae_torch.data.splits import err_mitigation_dataset
from iinsvae_torch.data.synthetic import ensure_ewine_dataset, fixture_path, synthetic_arrays
from iinsvae_torch.training.checkpoint import latest_epoch
from iinsvae_torch.training.loop import pad_to_batches
from iinsvae_torch.training.state import TrainState, create_train_state

EWINE_DEFAULT_PATHS = [
    "./data/data_ewine/dataset1/tag_room0.csv",
    "./data/data_ewine/dataset1/tag_room1.csv",
    "./data/data_ewine/dataset2/tag_room0.csv",
    "./data/data_ewine/dataset2/tag_room1/",
]
SPLIT_NAMES = ("train_cir", "train_err", "train_label", "test_cir", "test_err", "test_label")


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
    """-> (train, test), each (cir, err, label) as float32 numpy, the CIRs standardized with
    the train part's statistics (iinsvae_tpu/cli/common.py:41-108). The source: the Zenodo
    pickle ``cfg.data_root`` where it exists, else the synthetic fixture (in memory; its cache
    key names the file ``ensure_dataset`` would write, so n, seed and version are in it);
    eWine's CSVs at EWINE_DEFAULT_PATHS, else its fixture's, written there. With
    ``cfg.data_cache`` the split is read from, or written to,
    ``<dirname(source)>/cache/<key>.iinsc`` (read-only arrays viewing the mapping)."""
    fixture = False  # the Zenodo fixture, built in memory on a cache miss
    if cfg.dataset_name == "zenodo":
        root = cfg.data_root
        if not os.path.exists(root):
            if not cfg.allow_synthetic:
                raise FileNotFoundError(
                    f"{root} not found; download the Zenodo dataset "
                    "(DOI 10.5281/zenodo.4290069) or drop --no_synthetic")
            root, fixture = fixture_path(root, cfg.synthetic_n, cfg.seed,
                                         cfg.fixture_version), True
            print(f"[data] dataset.pkl absent -> synthetic fixture {root} (in memory)")
    elif cfg.dataset_name == "ewine":
        root = [p for p in EWINE_DEFAULT_PATHS if os.path.exists(p)]
        if not root:
            if not cfg.allow_synthetic:
                raise FileNotFoundError("no ewine csvs found under ./data/data_ewine/")
            root = ensure_ewine_dataset(n=cfg.synthetic_n, seed=cfg.seed)
            print(f"[data] no ewine csvs -> synthetic fixture at {root[0]} ...")
    else:
        raise ValueError(f"Unknown dataset: {cfg.dataset_name}")
    env = cfg.dataset_env if cfg.dataset_name == "zenodo" else None

    cache_path = None
    if cfg.data_cache:
        from iinsvae_torch.runtime.cache import cache_key, read_cache

        src = root if isinstance(root, str) else root[0]
        key = cache_key(src, name=cfg.dataset_name, env=env, split=cfg.split_factor,
                        mode=cfg.mode, seed=cfg.seed)
        cache_path = os.path.join(os.path.dirname(src) or ".", "cache", key + ".iinsc")
        cached = read_cache(cache_path)
        if cached is not None and set(SPLIT_NAMES) <= set(cached):
            return (tuple(cached[k] for k in SPLIT_NAMES[:3]),
                    tuple(cached[k] for k in SPLIT_NAMES[3:]))

    arrays = (synthetic_arrays(cfg.synthetic_n, cfg.seed, env, cfg.fixture_version)
              if fixture else None)
    train, test, _, _ = err_mitigation_dataset(
        root, dataset_name=cfg.dataset_name, dataset_env=env, split_factor=cfg.split_factor,
        scaling=True, mode=cfg.mode, seed=cfg.seed, arrays=arrays)
    if cache_path is not None:
        from iinsvae_torch.runtime.cache import write_cache

        write_cache(cache_path, dict(zip(SPLIT_NAMES, (*train, *test))))
    return train, test


def batch_dict(split, cfg: Config) -> dict[str, torch.Tensor]:
    """(cir, err, label) -> {cir, err, label} tensors on the CPU, the CIRs in
    ``cfg.compute_dtype`` and err and label float32 (iinsvae_tpu/cli/common.py:111-118).
    The tensors own copies: a cached split's arrays are read-only views of its mapping."""
    cir, err, label = (torch.tensor(v) for v in split)
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
