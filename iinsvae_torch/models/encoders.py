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

The column-image model (conv_type=3, NoExpand) reads the CIR as a (L, 1)
column with (k, 1) kernels (encoders.py:236-294), carried here as (B, H, C):

  pool to (128, 1) (once, in the Encoder facade)
  RangeEncoder2dNoExpand: relu(1x1 conv 1 -> 4) -> 4x ((4,1) s2 conv, IN,
                  ReLU) -> (B, 8, 64) -> 3x residual ((3,1) reflect, IN)
                  -> relu(1x1 conv) -> (B, 8, 1, 2)
  EnvEncoder2dNoExpand: (7,1) zero-padded conv 1 -> 16, ReLU -> 2x ((4,1) s2
                  conv, ReLU) -> mean over H -> 1x1 conv -> style_dim

Every conv of the column model is plain tensor ops, as XLA runs it in the
JAX package. The env encoders take ``conv_init`` ('reference' N(0, 0.02) or
'torch', the CLI's ``--env_conv_init``) for their conv taps.
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import (ColumnConv, Conv1d, ConvINAct, ResidualBlock2dNoExpand,
                                         bias_uniform, check_conv_type, conv_normal,
                                         pick_conv_init)
from iinsvae_torch.ops import colgroups as cg
from iinsvae_torch.ops.conv import cast_like, conv2d
from iinsvae_torch.ops.kernels import fused, res2d
from iinsvae_torch.ops.norms import instance_norm
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
    """encoders.py:297-324; ``conv_init`` gives the conv taps (the biases
    keep torch's default either way). The k7 reflect in-conv runs K2
    conv_bias_act, the stride-2 stages K3 strided_conv; the mean and the 1x1
    head are plain tensor ops. Takes the pooled (B, 128, 1) signal."""

    def __init__(self, dim: int = 16, n_downsample: int = 2, style_dim: int = 8,
                 conv_init: str = "reference", *, generator: torch.Generator):
        super().__init__()
        init = pick_conv_init(conv_init)
        convs = [ConvINAct(1, dim, 7, padding=3, pad_mode="reflect", init=init,
                           generator=generator)]
        d = dim
        for _ in range(2):
            convs.append(ConvINAct(d, d * 2, 4, stride=2, padding=1, init=init,
                                   generator=generator))
            d *= 2
        for _ in range(n_downsample - 2):
            convs.append(ConvINAct(d, d, 4, stride=2, padding=1, init=init, generator=generator))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            setattr(self, f"ConvINAct_{i}", conv)
        self.Conv1d_0 = Conv1d(d, style_dim, 1, init=init, generator=generator)

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
    """encoders.py:327-370, grouped lowering; ``conv_init`` gives the conv taps.
    No norm; the global mean weights each group by its column count, and
    the 1x1 head on the (B, 64) mean is a dense layer. Takes the pooled
    one-group (B, 128, 1, 1) field."""

    def __init__(self, dim: int = 16, n_downsample: int = 2, style_dim: int = 8,
                 conv_init: str = "reference", *, generator: torch.Generator):
        super().__init__()
        init = pick_conv_init(conv_init)
        dims, d = [], dim
        for _ in range(2):
            dims.append((d, d * 2))
            d *= 2
        dims += [(d, d)] * (n_downsample - 2)
        self.n_down = len(dims)
        self.in_kernel = init((7, 7, 1, dim), generator)
        self.in_bias = bias_uniform((dim,), 49, generator)
        for j, (di, do) in enumerate(dims):
            setattr(self, f"down{j}_kernel", init((4, 4, di, do), generator))
            setattr(self, f"down{j}_bias", bias_uniform((do,), di * 16, generator))
        self.out_kernel = init((1, 1, d, style_dim), generator)
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


class RangeEncoder2dNoExpand(nn.Module):
    """encoders.py:236-257 on the pooled (B, 128, 1) column; the convs at
    ``Conv2d_0`` (1x1 in), ``Conv2d_1..n`` ((4,1) stride-2, each before an
    IN), ``ResidualBlock2dNoExpand_{i}`` and the 1x1 out-conv last, as flax
    names them. Every conv bias before a norm is no input (``norm_follows``):
    its gradient is exactly 0. -> (B, 8, 1, out_dim)."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_downsample: int = 4,
                 out_dim: int = 2, *, generator: torch.Generator):
        super().__init__()
        self.n_downsample, self.n_residual = n_downsample, n_residual
        self.Conv2d_0 = ColumnConv(1, dim, 1, generator=generator)
        d = dim
        for j in range(n_downsample):
            setattr(self, f"Conv2d_{j + 1}", ColumnConv(d, d * 2, 4, stride=2, padding=1,
                                                        norm_follows=True, generator=generator))
            d *= 2
        for i in range(n_residual):
            setattr(self, f"ResidualBlock2dNoExpand_{i}",
                    ResidualBlock2dNoExpand(d, "in", generator=generator))
        setattr(self, f"Conv2d_{n_downsample + 1}", ColumnConv(d, out_dim, 1, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 128, 1)
        x = torch.relu(self.Conv2d_0(x))  # no norm (reference models.py:228-233)
        for j in range(self.n_downsample):
            x = torch.relu(instance_norm(getattr(self, f"Conv2d_{j + 1}")(x)))
        for i in range(self.n_residual):
            x = getattr(self, f"ResidualBlock2dNoExpand_{i}")(x)
        x = torch.relu(getattr(self, f"Conv2d_{self.n_downsample + 1}")(x))
        return x.unsqueeze(2)  # (B, 8, 1, out_dim)


class EnvEncoder2dNoExpand(nn.Module):
    """encoders.py:260-294 on the pooled (B, 128, 1) column: the (7,1) in-conv
    zero-padded (PARITY.md resolves the reference's ReflectionPad2d(3) on a
    width-1 field that way), (4,1) stride-2 convs, ReLU, the mean over H and
    a 1x1 head; ``conv_init`` gives every conv's taps."""

    def __init__(self, dim: int = 16, n_downsample: int = 2, style_dim: int = 8,
                 conv_init: str = "reference", *, generator: torch.Generator):
        super().__init__()
        init = pick_conv_init(conv_init)
        convs = [ColumnConv(1, dim, 7, padding=3, init=init, generator=generator)]
        d = dim
        for _ in range(2):
            convs.append(ColumnConv(d, d * 2, 4, stride=2, padding=1, init=init,
                                    generator=generator))
            d *= 2
        for _ in range(n_downsample - 2):
            convs.append(ColumnConv(d, d, 4, stride=2, padding=1, init=init, generator=generator))
        convs.append(ColumnConv(d, style_dim, 1, init=init, generator=generator))
        self.n_convs = len(convs)
        for i, conv in enumerate(convs):
            setattr(self, f"Conv2d_{i}", conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, 128, 1)
        for i in range(self.n_convs - 1):
            x = torch.relu(getattr(self, f"Conv2d_{i}")(x))
        cat = getattr(self, f"Conv2d_{self.n_convs - 1}")(x.mean(dim=1, keepdim=True))
        return cat.reshape(cat.shape[0], -1)  # (B, style_dim)


def split_env_stats(cat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cat (B, style_dim) -> (mu, log_sigma), each (B, style_dim // 2)."""
    half = cat.shape[-1] // 2
    return cat[..., :half], cat[..., half:]


def env_kl(mu: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    """KL(q || N(0, I)) = 0.5 * sum(e^{2ls} + mu^2 - 1 - 2ls), batch mean."""
    kl = 0.5 * torch.sum(torch.exp(2.0 * log_sigma) + mu**2 - 1.0 - 2.0 * log_sigma, dim=-1)
    return kl.mean()


ENCODERS = {1: (RangeEncoder1d, EnvEncoder1d), 2: (RangeEncoder2d, EnvEncoder2d),
            3: (RangeEncoder2dNoExpand, EnvEncoder2dNoExpand)}


class Encoder(nn.Module):
    """Facade of encoders.py:400-477 for conv_type 1, 2 (expanded) and 3
    (column image).

    forward(cir (B, L)) -> (range_code (B, 8, out_dim) for conv_type 1,
    (B, 8, 8, out_dim) for 2, (B, 8, 1, out_dim) for 3; env_code (B,
    style_dim) = (mu, log_sigma)). The CIR is pooled to 128 taps once and
    both encoders read it: conv_type 2 reads it as the constant field of
    width 128, which is the adaptive pool of the (L, L) expanded image to
    (128, 128) (colgroups.pool_constant_field; encoders.py:449-450), and
    conv_type 3 as the column, the (L, 1) image pooled to (128, 1)
    (encoders.py:249, :281). Serving reads no KL, so the forward computes
    none: ``env_kl(*split_env_stats(env_code))`` gives it where it is read.
    ``env_conv_init`` gives the env encoder's conv taps."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_downsample: int = 4, style_dim: int = 8, out_dim: int = 2,
                 cir_len: int = 157, env_conv_init: str = "reference", *,
                 generator: torch.Generator):
        super().__init__()
        check_conv_type(conv_type)
        self.conv_type = conv_type
        range_cls, env_cls = ENCODERS[conv_type]
        self.range_encoder = range_cls(dim, n_residual, n_downsample, out_dim,
                                       generator=generator)
        self.env_encoder = env_cls(dim * 4, n_downsample - 2, style_dim, env_conv_init,
                                   generator=generator)
        self.register_buffer("pool", adaptive_avg_pool_matrix(cir_len, POOLED_LEN),
                             persistent=False)

    def forward(self, cir: torch.Tensor):
        x = (cir @ cast_like(self.pool, cir)).unsqueeze(-1)  # (B, 128, 1)
        if self.conv_type == 2:
            x = cg.constant_field(x, POOLED_LEN)  # (B, 128, 1 group, 1)
        return self.range_encoder(x), self.env_encoder(x)
