"""IInsVAE for serving: Encoder + Decoder + Restorer + Classifier
(iinsvae_tpu/models/vae.py)."""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.decoders import Decoder
from iinsvae_torch.models.encoders import Encoder
from iinsvae_torch.models.heads import Classifier, Restorer, check_restorer


class IInsVAE(nn.Module):
    """With Conv1d / Conv2d heads the module's mode matters, as flax's
    ``train`` flag does: in train mode their Dropout and BatchNormEps run on
    the batch (the semi step), in eval mode they are the identity and the
    running stats (the eval step, ``Predictor``). Parameters are made from ``generator`` (default: seed 0) on the CPU;
    move the module with ``.to(device)``. Parameter names follow the flax
    tree (``encoder.range_encoder.in_kernel``, ``decoder.decoder.mlp.Dense_0.kernel``,
    ``restorer.restorer.w0``, ...), so bridge.from_flax_numpy loads a JAX
    checkpoint with no renaming.

    conv_type: 1 the 1-D model, 2 the expanded 2-D model, 3 the column-image
    model (NoExpand); any other raises ValueError. ``soft``: the restorer's
    reparameterised head (``--use_soft``), whose sample the forward draws
    with the ``soft_eps`` it is given (mu without one). ``env_conv_init``:
    the env encoder's conv taps, 'reference' N(0, 0.02) or 'torch'
    (``--env_conv_init``); a seed gives every other parameter the same
    values under either."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_downsample: int = 4, style_dim: int = 8, range_dim: int = 2,
                 cir_len: int = 157, num_classes: int = 5,
                 restorer_type: str = "Linear", classifier_type: str = "Linear",
                 soft: bool = False, env_conv_init: str = "reference",
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        check_restorer(conv_type, restorer_type)
        self.cir_len, self.num_classes, self.soft = cir_len, num_classes, soft
        self.encoder = Encoder(conv_type, dim, n_residual, n_downsample, style_dim,
                               range_dim, cir_len, env_conv_init, generator=generator)
        # the range code is (side, range_dim), (side, side, range_dim) for conv_type 2 or
        # (side, 1, range_dim) for conv_type 3
        side = 128 // 2**n_downsample
        code_shape = {1: (side,), 2: (side, side), 3: (side, 1)}[conv_type] + (range_dim,)
        self.restorer = Restorer(code_shape, restorer_type, soft, generator=generator)
        self.classifier = Classifier(style_dim, num_classes, net_type=classifier_type,
                                     generator=generator)
        # drawn last, so a seed gives the encoder and heads the same weights
        # as a model without the decoder
        self.decoder = Decoder(conv_type, dim, n_residual, n_downsample, cir_len, range_dim,
                               style_dim, generator=generator)

    def forward(self, cir: torch.Tensor,
                soft_eps: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """cir (B, cir_len) -> recon (B, cir_len), err_est (B, 1), logits
        (B, num_classes), env_code (B, style_dim), range_code (B, 8,
        range_dim), (B, 8, 8, range_dim) for conv_type 2 or (B, 8, 1,
        range_dim) for 3. A soft restorer's err_est is its sample with the
        standard-normal ``soft_eps`` (B, 1) (JAX draws it from the step's key,
        vae.py:79-84), else mu. The KL term of the JAX forward is
        ``encoders.env_kl(*split_env_stats(env_code))``: serving never reads
        it, so it is not computed here."""
        range_code, env_code = self.encode(cir)
        return {
            "recon": self.decode(range_code, env_code),
            "err_est": self.restore(range_code, soft_eps),
            "logits": self.classify(env_code),
            "env_code": env_code,
            "range_code": range_code,
        }

    def encode(self, cir: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (range_code (B, 8, range_dim), (B, 8, 8, range_dim) or (B, 8, 1,
        range_dim), env_code (B, style_dim))."""
        return self.encoder(cir)

    def decode(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        return self.decoder(range_code, env_code)

    def restore(self, range_code: torch.Tensor,
                soft_eps: torch.Tensor | None = None) -> torch.Tensor:
        return self.restorer(range_code, soft_eps)

    def classify(self, env_code: torch.Tensor) -> torch.Tensor:
        return self.classifier(env_code)
