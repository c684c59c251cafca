"""The decoders: (range_code, env_code) -> reconstructed CIR
(iinsvae_tpu/models/decoders.py), channels-last. The 1-D decoder
(decoders.py:35-185):

  mlp(env_code) -> per-sample AdaIN (gamma, beta) for 3 blocks x 2 layers
  (B, 8, 2) -> relu(1x1 conv + bias) -> (B, 8, 64)          K2 conv_bias_act
            -> 3x AdaIN residual block, k3 reflect       K5 adain_res_block
            -> 4x (x2 upsample, k5 conv + bias, LayerNorm, ReLU) -> (B, 128, 4)
            -> tanh(k7 reflect conv + bias) -> pool 128 -> 157  K6 sln_chain

The expanded 2-D decoder, 'fast' lowering (decoders.py:262-340):

  (B, 8, 8, 2) -> relu(1x1 conv + bias) -> (B, 8, 8, 64)
               -> 3x AdaIN residual block, 3x3 reflect       K7 res_block_2d
               -> 4x (subpixel x2 upsample + 5x5 conv + bias, LayerNorm,
                  ReLU) -> (B, 128, 128, 4), the last stage only where the
                  output column 0 reads it
               -> tanh(7x7 reflect conv + bias) of column 0 -> pool 128 -> 157

The column-image decoder (conv_type=3, decoders.py:361-394), on the
(B, H, C) column, every op plain tensor ops:

  (B, 8, 1, 2) -> relu(1x1 conv + bias) -> (B, 8, 64)
               -> 3x AdaIN residual block, (3,1) reflect
               -> 4x ((2,1) nearest upsample, (5,1) zero-padded conv + bias,
                  LayerNorm, ReLU) -> (B, 128, 4)
               -> tanh((7,1) reflect conv + bias) -> pool 128 -> 157

All three read ``env_code``, the (mu, log_sigma) stats, not a sample
(iinsvae_tpu/models/vae.py:82-83).
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import (MLP, ColumnConv, ResidualBlock2dNoExpand,
                                         SampleLayerNorm, bias_uniform, check_conv_type,
                                         conv_normal)
from iinsvae_torch.ops import subpixel
from iinsvae_torch.ops.colgroups import on_device
from iinsvae_torch.ops.conv import conv1d, conv2d
from iinsvae_torch.ops.kernels import fused, res2d
from iinsvae_torch.ops.norms import (sample_layer_norm, sample_layer_norm_apply,
                                     sample_layer_norm_stats)
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

# the 7x7 reflect conv's output column 0 reads these columns (reflect pad 3)
_COLUMN0_TAPS = (3, 2, 1, 0, 1, 2, 3)


def slice_adain_params(adain_params: torch.Tensor, n_blocks: int, features: int):
    """(B, n_blocks*2*2*features) -> [[(gamma, beta), (gamma, beta)], ...]
    per block, each (B, features) and contiguous.

    The MLP output holds ``[beta, gamma]`` per AdaIN layer, layer 1 then
    layer 2 of block 0 first (decoders.py:35-47). One copy lays every table
    out contiguously, so the kernel reads (B, C) rows."""
    b = adain_params.shape[0]
    t = adain_params.reshape(b, n_blocks, 2, 2, features).permute(1, 2, 3, 0, 4).contiguous()
    return [[(t[i, j, 1], t[i, j, 0]) for j in range(2)] for i in range(n_blocks)]


class Decoder1d(nn.Module):
    """decoders.py:50-185; parameters named as in the flax module. One
    K2 launch, one K5 launch a residual block and one K6 launch for the
    tail; the AdaIN MLP is plain tensor ops."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_upsample: int = 4,
                 in_dim: int = 157, out_dim: int = 2, style_dim: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_residual, self.n_upsample, self.in_dim = n_residual, n_upsample, in_dim
        d = self.width = dim * 2**n_upsample
        self.mlp = MLP(style_dim, n_residual * 2 * 2 * d, generator=generator)
        self.in_kernel = conv_normal((1, out_dim, d), generator)
        self.in_bias = bias_uniform((d,), out_dim, generator)
        for i in range(n_residual):
            setattr(self, f"res{i}_kernel1", conv_normal((3, d, d), generator))
            setattr(self, f"res{i}_kernel2", conv_normal((3, d, d), generator))
        for j in range(n_upsample):
            # the conv bias before the per-sample LayerNorm is real: that norm
            # does not remove a per-channel bias (decoders.py:105-110)
            setattr(self, f"up{j}_kernel", conv_normal((5, d, d // 2), generator))
            setattr(self, f"up{j}_bias", bias_uniform((d // 2,), d * 5, generator))
            setattr(self, f"up{j}_gamma", nn.Parameter(torch.rand((d // 2,), generator=generator)))
            setattr(self, f"up{j}_beta", nn.Parameter(torch.zeros(d // 2)))
            d //= 2
        self.out_kernel = conv_normal((7, d, 1), generator)
        self.out_bias = bias_uniform((1,), d * 7, generator)

    def forward(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        per_block = slice_adain_params(self.mlp(env_code), self.n_residual, self.width)
        x = fused.conv_bias_act(range_code, self.in_kernel, self.in_bias)  # (B, 8, 64)
        for i, ((g1, b1), (g2, b2)) in enumerate(per_block):
            x = fused.adain_res_block(x, getattr(self, f"res{i}_kernel1"),
                                      getattr(self, f"res{i}_kernel2"), g1, b1, g2, b2)
        stages = [tuple(getattr(self, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
                  for j in range(self.n_upsample)]
        return fused.sln_chain(x, stages, self.out_kernel, self.out_bias, self.in_dim)


class Decoder2d(nn.Module):
    """decoders.py:185-340, the 'fast' lowering; parameters named as in the
    flax module. The residual blocks are one K7 res_block_2d launch each
    (AdaIN, the per-sample (B, 64) tables of slice_adain_params); their
    ``res{i}_bias{1,2}`` are no K7 input (AdaIN's norm would remove them)
    and get a gradient of exactly 0. Everything else is plain tensor ops, as
    XLA runs it in the JAX package: the 1x1 convs, the subpixel upsample
    stages (ops/subpixel.py) with the per-sample LayerNorm (its affine tiled
    over the four phases), and the column-0 tail.

    The reference keeps only column 0 of the final (in_dim, in_dim) image
    (decoders.py:423-431). The W pool maps output column 0 to input column 0
    alone, and the 7x7 reflect conv's column 0 reads columns 3,2,1,0,1,2,3
    of the last stage, which are its pre-shuffle columns 0-1. So the last
    stage takes its LayerNorm statistics over the whole conv output but
    normalises, activates and shuffles only those two columns
    (decoders.py:296-319), and the tail is a k7 reflect conv1d over H with
    7*C channels, tanh and the (128, in_dim) pool."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_upsample: int = 4,
                 in_dim: int = 157, out_dim: int = 2, style_dim: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_residual, self.n_upsample, self.in_dim = n_residual, n_upsample, in_dim
        d = self.width = dim * 2**n_upsample
        self.mlp = MLP(style_dim, n_residual * 2 * 2 * d, generator=generator)
        self.in_kernel = conv_normal((1, 1, out_dim, d), generator)
        self.in_bias = bias_uniform((d,), out_dim, generator)
        for i in range(n_residual):
            for n in (1, 2):
                setattr(self, f"res{i}_kernel{n}", conv_normal((3, 3, d, d), generator))
                setattr(self, f"res{i}_bias{n}", bias_uniform((d,), d * 9, generator))
        for j in range(n_upsample):
            setattr(self, f"up{j}_kernel", conv_normal((5, 5, d, d // 2), generator))
            setattr(self, f"up{j}_bias", bias_uniform((d // 2,), d * 25, generator))
            setattr(self, f"up{j}_gamma", nn.Parameter(torch.rand((d // 2,), generator=generator)))
            setattr(self, f"up{j}_beta", nn.Parameter(torch.zeros(d // 2)))
            d //= 2
        self.out_kernel = conv_normal((7, 7, d, 1), generator)
        self.out_bias = bias_uniform((1,), d * 49, generator)

    def forward(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        per_block = slice_adain_params(self.mlp(env_code), self.n_residual, self.width)
        x = torch.relu(conv2d(range_code, self.in_kernel, self.in_bias))  # (B, 8, 8, 64)
        for i, ((g1, b1), (g2, b2)) in enumerate(per_block):
            x = res2d.res_block_2d(x, getattr(self, f"res{i}_kernel1"),
                                   getattr(self, f"res{i}_kernel2"), g1, b1, g2, b2)
        for j in range(self.n_upsample):
            z = subpixel.upsample_conv5_phase(x, getattr(self, f"up{j}_kernel"),
                                              getattr(self, f"up{j}_bias"))
            gamma = getattr(self, f"up{j}_gamma").repeat(4)
            beta = getattr(self, f"up{j}_beta").repeat(4)
            if j == self.n_upsample - 1 and x.shape[2] >= 2:
                mean, std = sample_layer_norm_stats(z)
                z = sample_layer_norm_apply(z[:, :, :2, :], mean, std, gamma, beta)
            else:
                z = sample_layer_norm(z, gamma, beta)
            x = subpixel.pixel_shuffle2(torch.relu(z))
        b, h, _, c = x.shape
        xcols = x.index_select(2, on_device(_COLUMN0_TAPS, torch.long, x.device))
        xcols = xcols.reshape(b, h, 7 * c)
        y = torch.tanh(conv1d(xcols, self.out_kernel.reshape(7, 7 * c, 1), self.out_bias,
                              padding=3, pad_mode="reflect"))  # (B, H, 1)
        pool = adaptive_avg_pool_matrix(h, self.in_dim, device=y.device, dtype=y.dtype)
        return y.reshape(b, h) @ pool


class Decoder2dNoExpand(nn.Module):
    """decoders.py:361-394; parameters named as in the flax module: ``mlp``,
    ``Conv2d_0`` (1x1 in), ``ResidualBlock2dNoExpand_{i}`` (AdaIN; their conv
    biases no input), ``Conv2d_{1..n}`` with ``SampleLayerNorm_{0..n-1}`` (the
    upsample stages; the reference's asymmetric ReflectionPad2d((3,1)) of the
    out-conv resolved to the symmetric 3 over H, as in JAX) and the (7,1)
    out-conv last."""

    def __init__(self, dim: int = 4, n_residual: int = 3, n_upsample: int = 4,
                 in_dim: int = 157, out_dim: int = 2, style_dim: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_residual, self.n_upsample, self.in_dim = n_residual, n_upsample, in_dim
        d = self.width = dim * 2**n_upsample
        self.mlp = MLP(style_dim, n_residual * 2 * 2 * d, generator=generator)
        self.Conv2d_0 = ColumnConv(out_dim, d, 1, generator=generator)
        for i in range(n_residual):
            setattr(self, f"ResidualBlock2dNoExpand_{i}",
                    ResidualBlock2dNoExpand(d, "adain", generator=generator))
        for j in range(n_upsample):
            setattr(self, f"Conv2d_{j + 1}", ColumnConv(d, d // 2, 5, padding=2,
                                                        generator=generator))
            setattr(self, f"SampleLayerNorm_{j}", SampleLayerNorm(d // 2, generator=generator))
            d //= 2
        setattr(self, f"Conv2d_{n_upsample + 1}", ColumnConv(d, 1, 7, padding=3,
                                                             pad_mode="reflect",
                                                             generator=generator))

    def forward(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        per_block = slice_adain_params(self.mlp(env_code), self.n_residual, self.width)
        x = torch.relu(self.Conv2d_0(range_code[:, :, 0]))  # (B, 8, 64)
        for i, params in enumerate(per_block):
            x = getattr(self, f"ResidualBlock2dNoExpand_{i}")(x, params)
        for j in range(self.n_upsample):
            x = getattr(self, f"Conv2d_{j + 1}")(x.repeat_interleave(2, dim=1))
            x = torch.relu(getattr(self, f"SampleLayerNorm_{j}")(x))
        y = torch.tanh(getattr(self, f"Conv2d_{self.n_upsample + 1}")(x))  # (B, 128, 1)
        b, h = y.shape[:2]
        pool = adaptive_avg_pool_matrix(h, self.in_dim, device=y.device, dtype=y.dtype)
        return y.reshape(b, h) @ pool


class Decoder(nn.Module):
    """Facade (decoders.py:397-437) for conv_type 1, 2 (expanded) and 3
    (column image): the decoder sits at ``.decoder``; forward(range_code
    (B, 8, out_dim), (B, 8, 8, out_dim) or (B, 8, 1, out_dim), env_code
    (B, style_dim)) -> (B, in_dim)."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_upsample: int = 4, in_dim: int = 157, out_dim: int = 2, style_dim: int = 8,
                 *, generator: torch.Generator):
        super().__init__()
        check_conv_type(conv_type)
        decoders = {1: Decoder1d, 2: Decoder2d, 3: Decoder2dNoExpand}
        self.decoder = decoders[conv_type](dim, n_residual, n_upsample, in_dim, out_dim,
                                           style_dim, generator=generator)

    def forward(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        return self.decoder(range_code, env_code)
