"""The model-geometry, serving and training fields of the run config.

A copy of the subset of iinsvae_tpu/config.py that serving, the semi, joint
and separated training steps, checkpoints, evaluation and the data pipeline
need, with the same names and defaults, and the env -> (num_classes, cir_len)
tables. ``add_args`` gives the model flags every entry point takes,
``add_train_args`` the trainer's and the data's, which also name the
checkpoint directory, so the evaluate and serve entry points take them too.
"""

from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass

import torch

from iinsvae_torch.models.heads import check_restorer
from iinsvae_torch.models.layers import check_conv_type

NUM_CLASSES = {
    "nlos": 2,
    "room_full": 5,
    "obstacle_full": 10,
    "room_part": 3,
    "room_full_rough": 3,
    "obstacle_part": 4,
    "obstacle_part2": 2,
    "room_full_rough2": 2,
    "paper": 4,
}

CIR_LEN = {"zenodo": 157, "ewine": 152}

# the CLI's net types (iinsvae_tpu/config.py:31-33); the column-image restorer
# (Conv2dNoExpand) is reachable from the model's constructor only, in either package
_NET_NAMES = {"1": "Linear", "2": "Conv1d", "3": "Conv2d",
              "Linear": "Linear", "Conv1d": "Conv1d", "Conv2d": "Conv2d"}


@dataclass
class Config:
    n_residual: int = 3
    n_downsample: int = 4
    env_dim: int = 16
    conv_type: int = 1  # 1 the 1-D model, 2 the expanded 2-D model, 3 the column image
    dim: int = 4
    range_dim: int = 2
    restorer_type: str = "Linear"
    classifier_type: str = "Linear"
    use_soft: bool = False  # the reparameterised restorer (iinsvae_tpu/config.py:146)
    env_conv_init: str = "reference"  # reference | torch: the env encoder's conv taps (:184)
    # the joint and separated paths (iinsvae_tpu/config.py:50-58)
    net_ablation: str = "loop"  # loop (EMNet) | loops (EMNetLoop)
    filters: int = 16
    identifier_type: str = "Linear"
    regressor_type: str = "Linear"
    dataset_name: str = "zenodo"
    dataset_env: str = "nlos"
    seed: int = 0
    # training (iinsvae_tpu/config.py:39-100)
    n_epochs: int = 500
    batch_size: int = 500
    lr: float = 1e-4
    b1: float = 0.5
    b2: float = 0.999
    decay_epoch: int = 100
    supervision_rate: float = 0.1
    mask_mode: str = "sample"  # sample (intent) | batch (reference literal)
    kl_free_bits: float = 0.0  # per-dim KL floor; 0 = reference-exact
    synthetic_n: int = 8192
    # the data (iinsvae_tpu/config.py:87, :97-103): the Zenodo pickle, the synthetic fixture
    # when it is absent, the mmap cache of the assembled split, the fixture's version
    data_root: str = "./data/data_zenodo/dataset.pkl"
    allow_synthetic: bool = True  # fall back to the synthetic fixture
    data_cache: bool = True  # mmap binary cache of the assembled split
    fixture_version: int = 2  # 2 adds the material signatures; 1 the pre-round-5 generator
    # data split and the run's intervals and directories
    # (iinsvae_tpu/config.py:39-41, 67-72, 88-89)
    mode: str = "full"
    split_factor: float = 0.8
    epoch: int = 0  # epoch to start training from; -1 resumes from the latest checkpoint
    test_epoch: int = 500
    sample_interval: int = 20
    checkpoint_interval: int = 50
    keep_last: int = -1  # checkpoint GC: keep the newest N (and the best); <= 0 keeps all
    out_dir: str = "./saved_results"
    model_dir: str = "./saved_models"
    # the activations' dtype (iinsvae_tpu/config.py:90): the parameters stay float32 and every
    # layer casts them to the activations' dtype at use
    compute_dtype: str = "float32"  # float32 | bfloat16
    # parallel training (iinsvae_tpu/config.py:79-85): not ported, rejected
    n_devices: int = 1
    dist_coordinator: str = ""
    dist_procs: int = 1
    dist_rank: int = -1

    @property
    def cir_len(self) -> int:
        return CIR_LEN[self.dataset_name]

    @property
    def torch_dtype(self):
        """The activations' torch dtype of ``compute_dtype``."""
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]

    @property
    def expand(self) -> bool:
        """The JAX model's ``expand`` (iinsvae_tpu/config.py:113-115): on for
        conv_type 2 and 3, where conv_type 2 runs on the expanded square image
        and 3 on the column; the port's IInsVAE takes both from conv_type."""
        return self.conv_type != 1

    @property
    def num_classes(self) -> int:
        if self.dataset_name == "ewine":
            return 2
        return NUM_CLASSES[self.dataset_env]

    def to_dict(self) -> dict:
        return asdict(self)

    def model_kwargs(self) -> dict:
        """Keyword arguments of models.vae.IInsVAE for this config."""
        return dict(
            conv_type=self.conv_type, dim=self.dim,
            n_residual=self.n_residual, n_downsample=self.n_downsample,
            style_dim=self.env_dim, range_dim=self.range_dim,
            cir_len=self.cir_len, num_classes=self.num_classes,
            restorer_type=self.restorer_type,
            classifier_type=self.classifier_type,
            soft=self.use_soft, env_conv_init=self.env_conv_init,
        )

    def joint_kwargs(self) -> dict:
        """Keyword arguments of models.emnet.EMNet / EMNetLoop."""
        return dict(cir_len=self.cir_len, num_classes=self.num_classes, env_dim=self.env_dim,
                    filters=self.filters, enet_type=self.identifier_type,
                    mnet_type=self.regressor_type, env_conv_init=self.env_conv_init)


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = Config()
    a = parser.add_argument
    a("--n_residual", type=int, default=d.n_residual)
    a("--n_downsample", type=int, default=d.n_downsample)
    a("--env_dim", type=int, default=d.env_dim)
    a("--conv_type", type=int, default=d.conv_type,
      help="1 Conv1d / 2 Conv2d (expand) / 3 Conv2d on the column image (NoExpand)")
    a("--dim", type=int, default=d.dim)
    a("--range_dim", type=int, default=d.range_dim)
    a("--restorer_type", type=str, default=d.restorer_type)
    a("--classifier_type", type=str, default=d.classifier_type)
    a("--use_soft", action="store_true", default=d.use_soft,
      help="the reparameterised restorer: (mu, logvar), a sample in training, mu served")
    a("--env_conv_init", type=str, default=d.env_conv_init, choices=["reference", "torch"],
      help="the env encoder's conv taps: reference N(0, 0.02) or torch's default "
           "U(+-1/sqrt(fan_in)); torch is refused with --conv_type 2")
    a("--net_ablation", type=str, default=d.net_ablation, choices=["loop", "loops"])
    a("--filters", type=int, default=d.filters)
    a("--identifier_type", type=str, default="1", help="1 Linear / 2 Conv1d / 3 Conv2d")
    a("--regressor_type", type=str, default="1")
    a("--dataset_name", type=str, default=d.dataset_name, choices=sorted(CIR_LEN))
    a("--dataset_env", type=str, default=d.dataset_env)
    a("--seed", type=int, default=d.seed)
    return parser


def add_train_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    d = Config()
    a = parser.add_argument
    a("--n_epochs", type=int, default=d.n_epochs)
    a("--batch_size", type=int, default=d.batch_size)
    a("--lr", type=float, default=d.lr)
    a("--b1", type=float, default=d.b1)
    a("--b2", type=float, default=d.b2)
    a("--decay_epoch", type=int, default=d.decay_epoch)
    a("--supervision_rate", type=float, default=d.supervision_rate)
    a("--mask_mode", type=str, default=d.mask_mode, choices=["sample", "batch"])
    a("--kl_free_bits", type=float, default=d.kl_free_bits,
      help="per-dimension KL floor (free bits); 0 = the reference's plain KL")
    a("--synthetic_n", type=int, default=d.synthetic_n)
    a("--data_root", type=str, default=d.data_root)
    a("--no_synthetic", action="store_true",
      help="fail instead of falling back to the synthetic fixture")
    a("--no_data_cache", action="store_true", help="disable the mmap binary dataset cache")
    a("--fixture_version", type=int, default=d.fixture_version, choices=[1, 2],
      help="synthetic fixture generation: 2 (default) adds scale-invariant material resonance "
           "signatures; 1 is the pre-round-5 generator")
    a("--mode", type=str, default=d.mode, choices=["full", "paper"])
    a("--split_factor", type=float, default=d.split_factor)
    a("--epoch", type=int, default=d.epoch,
      help="epoch to start training from; -1 resumes from the latest checkpoint")
    a("--test_epoch", type=int, default=d.test_epoch)
    a("--sample_interval", type=int, default=d.sample_interval)
    a("--checkpoint_interval", type=int, default=d.checkpoint_interval)
    a("--keep_last", type=int, default=d.keep_last,
      help="checkpoint GC: keep only the newest N epoch checkpoints (plus the best); "
           "<=0 keeps all")
    a("--out_dir", type=str, default=d.out_dir)
    a("--model_dir", type=str, default=d.model_dir)
    a("--compute_dtype", type=str, default=d.compute_dtype, choices=["float32", "bfloat16"],
      help="the activations' dtype; bfloat16 takes --conv_type 2 with the Linear heads "
           "(and --use_soft)")
    a("--n_devices", type=int, default=d.n_devices, help="parallel training: not ported")
    a("--dist_coordinator", type=str, default=d.dist_coordinator,
      help="multi-host training: not ported")
    a("--dist_procs", type=int, default=d.dist_procs, help="multi-host training: not ported")
    a("--dist_rank", type=int, default=d.dist_rank, help="multi-host training: not ported")
    return parser


def reject_parallel(cfg: Config) -> None:
    """The port trains on one device: --n_devices > 1 and the --dist_* flags raise."""
    if cfg.n_devices > 1 or cfg.dist_procs > 1 or cfg.dist_coordinator or cfg.dist_rank >= 0:
        raise NotImplementedError(
            "parallel training (--n_devices > 1, --dist_*) is not ported; the port trains on "
            "one device")


def reject_bf16(cfg: Config, entry: str = "train_semi") -> None:
    """bfloat16 runs the semi path of the expanded 2-D model (conv_type 2) with the Linear
    heads, soft or not (``train_semi``, ``evaluate``): the 1-D and the column-image model
    (conv_type 1, 3), the Conv heads and any other entry point raise NotImplementedError,
    before a model is built."""
    if cfg.compute_dtype != "bfloat16":
        return
    if entry != "train_semi":
        raise NotImplementedError(
            f"--compute_dtype bfloat16 in {entry}: the port runs bfloat16 on the semi path "
            "only (train_semi, evaluate); the joint and separated paths (BatchNormEps and the "
            "Conv heads in bfloat16) are a later slice")
    if cfg.conv_type != 2:
        raise NotImplementedError(
            f"--compute_dtype bfloat16 with --conv_type {cfg.conv_type}: the port runs "
            "bfloat16 on the expanded 2-D model (conv_type 2) only, with --use_soft or "
            "without; the 1-D model's (conv_type 1) and the column-image model's "
            "(conv_type 3) bfloat16 paths are later slices")
    if cfg.restorer_type != "Linear" or cfg.classifier_type != "Linear":
        raise NotImplementedError(
            "--compute_dtype bfloat16 takes the Linear heads: the Conv heads in bfloat16 are "
            "a later slice")


def from_args(args: argparse.Namespace) -> Config:
    cfg = Config()
    for k in vars(args):
        if hasattr(cfg, k):
            setattr(cfg, k, getattr(args, k))
    if getattr(args, "no_synthetic", False):
        cfg.allow_synthetic = False
    if getattr(args, "no_data_cache", False):
        cfg.data_cache = False
    cfg.restorer_type = _NET_NAMES[str(cfg.restorer_type)]
    cfg.classifier_type = _NET_NAMES[str(cfg.classifier_type)]
    cfg.identifier_type = _NET_NAMES[str(cfg.identifier_type)]
    cfg.regressor_type = _NET_NAMES[str(cfg.regressor_type)]
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {cfg.compute_dtype!r}")
    if cfg.dataset_env not in NUM_CLASSES and cfg.dataset_name == "zenodo":
        raise ValueError(
            f"Unknown environment {cfg.dataset_env!r}; choices: {sorted(NUM_CLASSES)}")
    check_conv_type(cfg.conv_type)
    if cfg.env_conv_init == "torch" and cfg.conv_type == 2:
        raise ValueError(
            "--env_conv_init torch diverges on the conv_type=2 expanded path (NaN within the "
            "first epochs in the JAX package, f32 and bf16, BASELINE.md round 3): its 2-D env "
            "encoder has no normalization, so torch's default init leaves the (mu, log_sigma) "
            "head O(1)+ and the KL blows up. Use the default --env_conv_init reference with "
            "conv_type=2.")
    check_restorer(cfg.conv_type, cfg.restorer_type)
    return cfg
