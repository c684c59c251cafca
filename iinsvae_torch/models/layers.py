"""Initialisers, ConvINAct, Conv1d and the decoder's MLP.

Initialisation mirrors iinsvae_tpu/models/layers.py:21-31 in distribution
(not in values: torch.Generator and jax.random give different streams):
conv taps ~ N(0, 0.02) (the reference's weights_init_normal), biases and
Dense weights ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default).
"""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.ops.conv import conv1d
from iinsvae_torch.ops.kernels import fused, strided_conv


def conv_normal(shape, generator: torch.Generator, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator))


def bias_uniform(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    bound = 1.0 / float(fan_in) ** 0.5
    u = torch.rand(shape, generator=generator)
    return nn.Parameter((2.0 * u - 1.0) * bound)


class ConvINAct(nn.Module):
    """The norm-free ConvINAct of the env encoder: Conv1d + bias + ReLU in
    one launch (JAX layers.py:126-220 with norm='none', act='relu').

    Parameters as in the JAX module: ``kernel`` (k, C_in, C_out) and
    ``bias`` (C_out,). The k4 s2 zero-pad-1 case runs K3 strided_conv, any
    other conv K2 conv_bias_act. (The range encoder's normed stages call K1
    in_chain directly, as the JAX RangeEncoder1d holds their taps itself.)"""

    def __init__(self, c_in: int, features: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, pad_mode: str = "zero", generator: torch.Generator):
        super().__init__()
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.kernel = conv_normal((kernel_size, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if strided_conv.applicable(self.kernel.shape[0], self.stride, self.padding, self.pad_mode):
            return strided_conv.strided_conv(x, self.kernel, self.bias)
        return fused.conv_bias_act(x, self.kernel, self.bias, stride=self.stride,
                                   padding=self.padding, pad_mode=self.pad_mode)


class Conv1d(nn.Module):
    """Plain channels-last Conv1d with bias (JAX layers.py:58-95), for the
    env encoder's 1x1 head on the length-1 mean: a plain tensor op."""

    def __init__(self, c_in: int, features: int, kernel_size: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.kernel = conv_normal((kernel_size, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.kernel, self.bias)


class Dense(nn.Module):
    """Linear layer with torch-default init (JAX layers.py:223-240):
    ``kernel`` (D_in, D_out) and ``bias`` (D_out,), each U(+-1/sqrt(D_in))."""

    def __init__(self, d_in: int, features: int, *, generator: torch.Generator):
        super().__init__()
        self.kernel = bias_uniform((d_in, features), d_in, generator)
        self.bias = bias_uniform((features,), d_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MLP(nn.Module):
    """The AdaIN-parameter predictor (JAX layers.py:243-258): d_in -> dim ->
    ReLU -> ... -> output_dim, ``n_blk`` Dense layers named ``Dense_{i}`` as
    in flax. Plain tensor ops: the JAX package computes it outside any
    Pallas kernel too."""

    def __init__(self, d_in: int, output_dim: int, dim: int = 256, n_blk: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        widths = [dim] * (n_blk - 1) + [output_dim]
        self.n_blk = n_blk
        for i, w in enumerate(widths):
            setattr(self, f"Dense_{i}", Dense(d_in, w, generator=generator))
            d_in = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_blk - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_blk - 1}")(x)
