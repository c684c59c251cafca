"""The 1-D decoder: (range_code, env_code) -> reconstructed CIR
(iinsvae_tpu/models/decoders.py:35-185, 397-422), channels-last:

  mlp(env_code) -> per-sample AdaIN (gamma, beta) for 3 blocks x 2 layers
  (B, 8, 2) -> relu(1x1 conv + bias) -> (B, 8, 64)          K2 conv_bias_act
            -> 3x AdaIN residual block, k3 reflect       K5 adain_res_block
            -> 4x (x2 upsample, k5 conv + bias, LayerNorm, ReLU) -> (B, 128, 4)
            -> tanh(k7 reflect conv + bias) -> pool 128 -> 157  K6 sln_chain

The decoder reads ``env_code``, the (mu, log_sigma) stats, not a sample
(iinsvae_tpu/models/vae.py:82-83).
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import MLP, bias_uniform, conv_normal
from iinsvae_torch.ops.kernels import fused


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


class Decoder(nn.Module):
    """Facade (decoders.py:397-422) for conv_type=1: the decoder sits at
    ``.decoder``; forward(range_code (B, 8, out_dim), env_code (B, style_dim))
    -> (B, in_dim)."""

    def __init__(self, conv_type: int = 1, dim: int = 4, n_residual: int = 3,
                 n_upsample: int = 4, in_dim: int = 157, out_dim: int = 2, style_dim: int = 8,
                 *, generator: torch.Generator):
        super().__init__()
        if conv_type != 1:
            raise NotImplementedError(
                f"conv_type={conv_type}: only the 1-D decoder (conv_type=1) is ported")
        self.decoder = Decoder1d(dim, n_residual, n_upsample, in_dim, out_dim, style_dim,
                                 generator=generator)

    def forward(self, range_code: torch.Tensor, env_code: torch.Tensor) -> torch.Tensor:
        return self.decoder(range_code, env_code)
