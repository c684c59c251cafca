"""Encoders: CIR -> (range_code, env_code stats).

Shapes as in iinsvae_tpu/models/encoders.py, channels-last. The 1-D model
(conv_type=1):

  pool 157 -> 128 (once, in the Encoder facade)
  RangeEncoder1d: (B, 128, 1) -> (B, 128, 4) -> 4x stride-2 -> (B, 8, 64)
                  -> 3x residual -> 1x1 conv -> (B, 8, 2)
  EnvEncoder1d:   (B, 128, 1) -> (B, 128, 16) -> 2x stride-2 -> (B, 32, 64)
                  -> mean over L -> 1x1 conv -> (B, style_dim) = (mu, log_sigma)

The expanded 2-D model (conv_type=2) reads the square image
``image[b, i, j] = cir[b, i]``, carried as a column-grouped field
(ops/colgroups.py): every conv of the encoders is a 1-D conv over H of a
few distinct columns, exactly the dense field's.

  pool to (128, 128) (once, in the Encoder facade): one group
  RangeEncoder2d: k7 reflect conv 1 -> 4, IN, ReLU -> 4x (k4 s2 conv, IN,
                  ReLU) -> (B, 8, 8, 64), expanded -> 3x residual (K7)
                  -> relu(1x1 conv) -> (B, 8, 8, 2)
  EnvEncoder2d:   k7 reflect conv 1 -> 16, ReLU -> 2x (k4 s2 conv, ReLU)
                  -> weighted mean over (H, W) -> dense 64 -> style_dim
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import Conv1d, ConvINAct, bias_uniform, conv_normal
from iinsvae_torch.ops import colgroups as cg
from iinsvae_torch.ops.conv import cast_like, conv2d
from iinsvae_torch.ops.kernels import fused, res2d
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


class RangeEncoder2d(nn.Module):
    """encoders.py:152-233, grouped lowering with the res2d branch (:204-212).

    Takes the pooled one-group (B, 128, 1, 1) field. The normed stages keep
    their conv biases, as the JAX module does: InstanceNorm removes them,
    so their gradient is rounding noise. The residual blocks run on the
    expanded (B, 8, 8, 64) field, one K7 res_block_2d launch each; their
    ``res{i}_bias{1,2}`` parameters exist for the JAX parameter tree but
    are no K7 input (the norm would remove them), so their gradient is
    exactly 0. Parameters named as in the flax module."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_downsample: int = 4,
                 out_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.n_downsample, self.n_residual = n_downsample, n_residual
        self.in_kernel = conv_normal((7, 7, 1, dim), generator)
        self.in_bias = bias_uniform((dim,), 49, generator)
        d = dim
        for j in range(n_downsample):
            setattr(self, f"down{j}_kernel", conv_normal((4, 4, d, d * 2), generator))
            setattr(self, f"down{j}_bias", bias_uniform((d * 2,), d * 16, generator))
            d *= 2
        for i in range(n_residual):
            for n in (1, 2):
                setattr(self, f"res{i}_kernel{n}", conv_normal((3, 3, d, d), generator))
                setattr(self, f"res{i}_bias{n}", bias_uniform((d,), d * 9, generator))
        self.out_kernel = conv_normal((1, 1, d, out_dim), generator)
        self.out_bias = bias_uniform((out_dim,), d, generator)

    def forward(self, x: cg.GroupedField) -> torch.Tensor:
        x = cg.relu_grouped(cg.instance_norm_grouped(
            cg.conv2d_grouped(x, self.in_kernel, self.in_bias, padding=3, pad_mode="reflect")))
        for j in range(self.n_downsample):
            x = cg.relu_grouped(cg.instance_norm_grouped(cg.conv2d_grouped(
                x, getattr(self, f"down{j}_kernel"), getattr(self, f"down{j}_bias"),
                stride=2, padding=1)))
        xd = x.expand()  # (B, 8, 8, 64)
        for i in range(self.n_residual):
            xd = res2d.res_block_2d(xd, getattr(self, f"res{i}_kernel1"),
                                    getattr(self, f"res{i}_kernel2"))
        return torch.relu(conv2d(xd, self.out_kernel, self.out_bias))  # (B, 8, 8, out_dim)


class EnvEncoder2d(nn.Module):
    """encoders.py:327-370, grouped lowering, reference init N(0, 0.02).
    No norm; the global mean weights each group by its column count, and
    the 1x1 head on the (B, 64) mean is a dense layer. Takes the pooled
    one-group (B, 128, 1, 1) field."""

    def __init__(self, dim: int = 16, n_downsample: int = 2, style_dim: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        dims, d = [], dim
        for _ in range(2):
            dims.append((d, d * 2))
            d *= 2
        dims += [(d, d)] * (n_downsample - 2)
        self.n_down = len(dims)
        self.in_kernel = conv_normal((7, 7, 1, dim), generator)
        self.in_bias = bias_uniform((dim,), 49, generator)
        for j, (di, do) in enumerate(dims):
            setattr(self, f"down{j}_kernel", conv_normal((4, 4, di, do), generator))
            setattr(self, f"down{j}_bias", bias_uniform((do,), di * 16, generator))
        self.out_kernel = conv_normal((1, 1, d, style_dim), generator)
        self.out_bias = bias_uniform((style_dim,), d, generator)

    def forward(self, x: cg.GroupedField) -> torch.Tensor:
        x = cg.relu_grouped(cg.conv2d_grouped(x, self.in_kernel, self.in_bias, padding=3,
                                              pad_mode="reflect"))
        for j in range(self.n_down):
            x = cg.relu_grouped(cg.conv2d_grouped(x, getattr(self, f"down{j}_kernel"),
                                                  getattr(self, f"down{j}_bias"), stride=2,
                                                  padding=1))
        pooled = cg.global_mean_grouped(x)
        return pooled @ cast_like(self.out_kernel[0, 0], pooled) + cast_like(self.out_bias, pooled)


def split_env_stats(cat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cat (B, style_dim) -> (mu, log_sigma), each (B, style_dim // 2)."""
    half = cat.shape[-1] // 2
    return cat[..., :half], cat[..., half:]


def env_kl(mu: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) = 0.5 * sum(e^{2ls} + mu^2 - 1 - 2ls), batch mean."""
    kl = 0.5 * torch.sum(torch.exp(2.0 * log_sigma) + mu**2 - 1.0 - 2.0 * log_sigma, dim=-1)
    return kl.mean()


class Encoder(nn.Module):
    """Facade of encoders.py:400-477 for conv_type 1 and 2 (expanded).

    forward(cir (B, L)) -> (range_code (B, 8, out_dim) for conv_type 1,
    (B, 8, 8, out_dim) for 2; env_code (B, style_dim) = (mu, log_sigma)).
    The CIR is pooled to 128 taps once and both encoders read it: conv_type
    2 reads it as the constant field of width 128, which is the adaptive
    pool of the (L, L) expanded image to (128, 128) (colgroups.
    pool_constant_field; encoders.py:449-450). Serving reads no KL, so the
    forward computes none: ``env_kl(*split_env_stats(env_code))`` gives it
    where it is read."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_downsample: int = 4, style_dim: int = 8, out_dim: int = 2,
                 cir_len: int = 157, *, generator: torch.Generator):
        super().__init__()
        encoders = {1: (RangeEncoder1d, EnvEncoder1d), 2: (RangeEncoder2d, EnvEncoder2d)}
        if conv_type not in encoders:
            raise NotImplementedError(
                f"conv_type={conv_type}: the port has the 1-D model (conv_type=1) and the "
                "expanded 2-D model (conv_type=2); conv_type 3 is a later slice")
        self.conv_type = conv_type
        range_cls, env_cls = encoders[conv_type]
        self.range_encoder = range_cls(dim, n_residual, n_downsample, out_dim,
                                       generator=generator)
        self.env_encoder = env_cls(dim * 4, n_downsample - 2, style_dim, generator=generator)
        self.register_buffer("pool", adaptive_avg_pool_matrix(cir_len, POOLED_LEN),
                             persistent=False)

    def forward(self, cir: torch.Tensor):
        x = (cir @ cast_like(self.pool, cir)).unsqueeze(-1)  # (B, 128, 1)
        if self.conv_type == 2:
            x = cg.constant_field(x, POOLED_LEN)  # (B, 128, 1 group, 1)
        return self.range_encoder(x), self.env_encoder(x)
