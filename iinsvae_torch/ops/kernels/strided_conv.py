"""K3 strided_conv: relu(conv1d(x, taps, k=4, s=2, zero pad 1) + bias).

Replaces fused_strided_conv (iinsvae_tpu/ops/pallas/strided_conv.py:250).
On the card it launches the conv + bias + ReLU kernel of csrc/in_chain.cu
(K2's) at k4, stride 2, zero pad 1, and counts its own launches; that
source states the bound on the H100. Under autograd it goes through
autograd.ConvBiasAct, whose backward launches K2b (backward.strided_conv_bwd). x is (B, L_in, C_in) channels-last,
taps (4, C_in, C_out), bias (C_out,).
"""

from __future__ import annotations

import torch

from iinsvae_torch.ops.conv import conv1d
from iinsvae_torch.ops.kernels.fused import launch_conv_bias_act, wants_grad


def applicable(kernel_size: int, stride: int, padding: int, pad_mode: str) -> bool:
    return (kernel_size, stride, padding, pad_mode) == (4, 2, 1, "zero")


def strided_conv_ref(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    return torch.relu(conv1d(x, taps, bias, stride=2, padding=1))


def strided_conv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3: the k4 s2 zero-pad-1 conv + bias + ReLU in one launch."""
    if x.device.type == "cpu":
        return strided_conv_ref(x, taps, bias)
    if taps.dim() != 3 or taps.shape[0] != 4:
        raise ValueError(f"taps must be (4, C_in, C_out), got {tuple(taps.shape)}")
    if wants_grad(x, taps, bias):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.ConvBiasAct.apply(x, taps, bias, (2, 1, "zero"), "strided_conv")
    y = launch_conv_bias_act(x, taps, bias, 2, 1, "zero")
    strided_conv.launches += 1
    return y


strided_conv.launches = 0
