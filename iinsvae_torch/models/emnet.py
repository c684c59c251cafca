"""The supervised joint networks and the separated two-stage pair
(iinsvae_tpu/models/emnet.py:35-164).

  * ``EMNet(cir) -> (label_est, env_latent, err_est)``: the range and env
    encoders side by side, the Classifier on the env latent, the Restorer on
    the range code;
  * ``EMNetLoop``: the same, with ``Dense(loop_proj)`` of the softmax of the
    logits added to every position of the range code before the Restorer;
  * ``IdentifierSep(cir) -> (label_est, env_latent)``: the env branch only;
  * ``RegressorSep(cir, label) -> err_est``: the range branch with
    ``Dense(label_proj)`` of the one-hot of ``label[:, 0]`` added to the code.

The encoders are the port's RangeEncoder1d (K1, K2) and EnvEncoder1d (K2,
K3); the Linear heads run K4. Both encoders read the CIR pooled to 128 taps,
once a forward. Parameter names follow the flax tree (``backbone.
range_encoder.in_kernel``, ``identifier.classifier.w0``, ``loop_proj.kernel``,
...), so bridge.from_flax_numpy loads a JAX tree with no renaming.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from iinsvae_torch.models.encoders import POOLED_LEN, EnvEncoder1d, RangeEncoder1d
from iinsvae_torch.models.heads import Classifier, Restorer
from iinsvae_torch.models.layers import Dense
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

# the range code of RangeEncoder1d(4, 3, 4, 2): 128 / 2**4 positions of 2 channels
CODE_SHAPE = (8, 2)


class _Pooled(nn.Module):
    """Holds the (cir_len, 128) adaptive-pool matrix as a buffer."""

    def __init__(self, cir_len: int):
        super().__init__()
        self.register_buffer("pool", adaptive_avg_pool_matrix(cir_len, POOLED_LEN),
                             persistent=False)

    def pooled(self, cir: torch.Tensor) -> torch.Tensor:
        return (cir @ self.pool).unsqueeze(-1)  # (B, 128, 1)


class _Backbone(_Pooled):
    """emnet.py:35-56: CIR -> (range_code (B, 8, 2), env_latent (B, env_dim))."""

    def __init__(self, cir_len: int, env_dim: int, env_conv_init: str = "reference", *,
                 generator: torch.Generator):
        super().__init__(cir_len)
        self.range_encoder = RangeEncoder1d(4, 3, 4, CODE_SHAPE[-1], generator=generator)
        self.env_encoder = EnvEncoder1d(16, 2, env_dim, env_conv_init, generator=generator)

    def forward(self, cir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.pooled(cir)
        return self.range_encoder(x), self.env_encoder(x)


class EMNet(nn.Module):
    """emnet.py:59-82. ``enet_type`` / ``mnet_type`` name the Classifier's and
    the Restorer's net type ('Linear', 'Conv1d', 'Conv2d'); ``env_conv_init``
    the env encoder's conv taps ('reference' or 'torch', ``--env_conv_init``)."""

    loop = False

    def __init__(self, cir_len: int = 157, num_classes: int = 5, env_dim: int = 16,
                 filters: int = 16, enet_type: str = "Linear", mnet_type: str = "Linear",
                 env_conv_init: str = "reference", *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cir_len, self.num_classes = cir_len, num_classes
        self.backbone = _Backbone(cir_len, env_dim, env_conv_init, generator=generator)
        self.identifier = Classifier(env_dim, num_classes, filters, enet_type,
                                     generator=generator)
        if self.loop:
            self.loop_proj = Dense(num_classes, CODE_SHAPE[-1], generator=generator)
        self.regressor = Restorer(CODE_SHAPE, mnet_type, generator=generator)

    def forward(self, cir: torch.Tensor):
        range_code, env_latent = self.backbone(cir)
        label_est = self.identifier(env_latent)
        if self.loop:
            cond = self.loop_proj(torch.softmax(label_est, dim=-1))
            range_code = range_code + cond[:, None, :]
        return label_est, env_latent, self.regressor(range_code)


class EMNetLoop(EMNet):
    """emnet.py:85-113, the 'loops' ablation: the regressor also sees the
    class distribution, through ``loop_proj``."""

    loop = True


class IdentifierSep(_Pooled):
    """emnet.py:116-136, sep-E: cir -> (label_est, env_latent)."""

    def __init__(self, cir_len: int = 157, num_classes: int = 2, env_dim: int = 16,
                 filters: int = 16, enet_type: str = "Linear", env_conv_init: str = "reference",
                 *, generator: torch.Generator | None = None):
        super().__init__(cir_len)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cir_len, self.num_classes = cir_len, num_classes
        self.env_encoder = EnvEncoder1d(16, 2, env_dim, env_conv_init, generator=generator)
        self.identifier = Classifier(env_dim, num_classes, filters, enet_type,
                                     generator=generator)

    def forward(self, cir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        env_latent = self.env_encoder(self.pooled(cir))
        return self.identifier(env_latent), env_latent


class RegressorSep(_Pooled):
    """emnet.py:139-164, sep-M: (cir, label) -> err_est, the regressor
    conditioned on the environment label (a float (B, 1) class index)."""

    def __init__(self, cir_len: int = 157, num_classes: int = 2, mnet_type: str = "Linear", *,
                 generator: torch.Generator | None = None):
        super().__init__(cir_len)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cir_len, self.num_classes = cir_len, num_classes
        self.range_encoder = RangeEncoder1d(4, 3, 4, CODE_SHAPE[-1], generator=generator)
        self.label_proj = Dense(num_classes, CODE_SHAPE[-1], generator=generator)
        self.regressor = Restorer(CODE_SHAPE, mnet_type, generator=generator)

    def forward(self, cir: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        range_code = self.range_encoder(self.pooled(cir))
        onehot = F.one_hot(label.reshape(label.shape[0], -1)[:, 0].long(),
                           self.num_classes).to(range_code.dtype)
        return self.regressor(range_code + self.label_proj(onehot)[:, None, :])
