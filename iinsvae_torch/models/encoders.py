"""Encoders of the 1-D model: CIR -> (range_code, env_code stats).

Shapes as in iinsvae_tpu/models/encoders.py, channels-last:

  pool 157 -> 128 (once, in the Encoder facade)
  RangeEncoder1d: (B, 128, 1) -> (B, 128, 4) -> 4x stride-2 -> (B, 8, 64)
                  -> 3x residual -> 1x1 conv -> (B, 8, 2)
  EnvEncoder1d:   (B, 128, 1) -> (B, 128, 16) -> 2x stride-2 -> (B, 32, 64)
                  -> mean over L -> 1x1 conv -> (B, style_dim) = (mu, log_sigma)
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import Conv1d, ConvINAct, bias_uniform, conv_normal
from iinsvae_torch.ops.kernels import fused
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

POOLED_LEN = 128


class RangeEncoder1d(nn.Module):
    """encoders.py:47-149. The conv stages run two per K1 in_chain launch
    (the last, odd one alone), each residual block as one K1 launch, the
    1x1 out-conv as one K2 conv_bias_act launch. Takes the pooled
    (B, 128, 1) signal."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_downsample: int = 4,
                 out_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.n_downsample, self.n_residual = n_downsample, n_residual
        self.in_kernel = conv_normal((7, 1, dim), generator)
        d = dim
        for j in range(n_downsample):
            setattr(self, f"down{j}_kernel", conv_normal((4, d, d * 2), generator))
            d *= 2
        for i in range(n_residual):
            setattr(self, f"res{i}_kernel1", conv_normal((3, d, d), generator))
            setattr(self, f"res{i}_kernel2", conv_normal((3, d, d), generator))
        self.out_kernel = conv_normal((1, d, out_dim), generator)
        self.out_bias = bias_uniform((out_dim,), d, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 128, 1)
        stages = [(self.in_kernel, 1, 3, "reflect")]
        stages += [(getattr(self, f"down{j}_kernel"), 2, 1, "zero")
                   for j in range(self.n_downsample)]
        for i in range(0, len(stages), 2):
            x = fused.in_chain(x, stages[i:i + 2])
        for i in range(self.n_residual):
            block = [(getattr(self, f"res{i}_kernel{n}"), 1, 1, "reflect") for n in (1, 2)]
            x = fused.in_chain(x, block, residual=True)
        return fused.conv_bias_act(x, self.out_kernel, self.out_bias)  # (B, 8, out_dim)


class EnvEncoder1d(nn.Module):
    """encoders.py:297-324 with the reference conv init N(0, 0.02). The k7
    reflect in-conv runs K2 conv_bias_act, the stride-2 stages K3
    strided_conv; the mean and the 1x1 head are plain tensor ops. Takes the
    pooled (B, 128, 1) signal."""

    def __init__(self, dim: int = 16, n_downsample: int = 2, style_dim: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        convs = [ConvINAct(1, dim, 7, padding=3, pad_mode="reflect", generator=generator)]
        d = dim
        for _ in range(2):
            convs.append(ConvINAct(d, d * 2, 4, stride=2, padding=1, generator=generator))
            d *= 2
        for _ in range(n_downsample - 2):
            convs.append(ConvINAct(d, d, 4, stride=2, padding=1, generator=generator))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            setattr(self, f"ConvINAct_{i}", conv)
        self.Conv1d_0 = Conv1d(d, style_dim, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 128, 1)
        for i in range(self.n_convs):
            x = getattr(self, f"ConvINAct_{i}")(x)
        cat = self.Conv1d_0(x.mean(dim=1, keepdim=True))  # (B, 1, style_dim)
        return cat.reshape(cat.shape[0], -1)


def split_env_stats(cat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cat (B, style_dim) -> (mu, log_sigma), each (B, style_dim // 2)."""
    half = cat.shape[-1] // 2
    return cat[..., :half], cat[..., half:]


def env_kl(mu: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) = 0.5 * sum(e^{2ls} + mu^2 - 1 - 2ls), batch mean."""
    kl = 0.5 * torch.sum(torch.exp(2.0 * log_sigma) + mu**2 - 1.0 - 2.0 * log_sigma, dim=-1)
    return kl.mean()


class Encoder(nn.Module):
    """Facade of encoders.py:400-477 for conv_type=1.

    forward(cir (B, L)) -> (range_code (B, 8, out_dim), env_code
    (B, style_dim) = (mu, log_sigma)). The CIR is pooled to 128 taps once
    and both encoders read it. Serving reads no KL, so the forward computes
    none: ``env_kl(*split_env_stats(env_code))`` gives it where it is read."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_downsample: int = 4, style_dim: int = 8, out_dim: int = 2,
                 cir_len: int = 157, *, generator: torch.Generator):
        super().__init__()
        if conv_type != 1:
            raise NotImplementedError(
                f"conv_type={conv_type}: only the 1-D model (conv_type=1) is ported; "
                "conv_type 2 and 3 are a later slice")
        self.range_encoder = RangeEncoder1d(dim, n_residual, n_downsample, out_dim,
                                            generator=generator)
        self.env_encoder = EnvEncoder1d(dim * 4, n_downsample - 2, style_dim,
                                        generator=generator)
        self.register_buffer("pool", adaptive_avg_pool_matrix(cir_len, POOLED_LEN),
                             persistent=False)

    def forward(self, cir: torch.Tensor):
        x = (cir @ self.pool).unsqueeze(-1)  # (B, 128, 1)
        return self.range_encoder(x), self.env_encoder(x)
