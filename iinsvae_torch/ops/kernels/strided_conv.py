"""K3 strided_conv: relu(conv1d(x, taps, k=4, s=2, zero pad 1) + bias).

Replaces fused_strided_conv (iinsvae_tpu/ops/pallas/strided_conv.py:250).
On the card it launches the window-product kernel of csrc/strided_conv.cu
and counts its own launches; that source states the bound on the H100.
Under autograd it goes through autograd.StridedConv, whose backward
launches K3b (backward.strided_conv_bwd, csrc/strided_conv_bwd.cu). x is
(B, L_in, C_in) channels-last, taps (4, C_in, C_out), bias (C_out,); the
kernels take C_in and C_out multiples of 4 and L_in >= 2, wherever the
weights and a tile of rows fit in a block's shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from iinsvae_torch.ops.conv import conv1d
from iinsvae_torch.ops.kernels import _build
from iinsvae_torch.ops.kernels.fused import wants_grad

_P = ctypes.c_void_p
_I = ctypes.c_int


def applicable(kernel_size: int, stride: int, padding: int, pad_mode: str) -> bool:
    return (kernel_size, stride, padding, pad_mode) == (4, 2, 1, "zero")


def strided_conv_ref(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3."""
    return torch.relu(conv1d(x, taps, bias, stride=2, padding=1))


def strided_conv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K3: the k4 s2 zero-pad-1 conv + bias + ReLU in one launch."""
    if x.device.type == "cpu":
        return strided_conv_ref(x, taps, bias)
    if wants_grad(x, taps, bias):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.StridedConv.apply(x, taps, bias)
    y = launch_strided_conv(x, taps, bias)
    strided_conv.launches += 1
    return y


strided_conv.launches = 0


def check_operands(what: str, lib: str, x: torch.Tensor, taps: torch.Tensor,
                   bias: torch.Tensor, *more: torch.Tensor) -> tuple[int, int, int, int]:
    """Raise on what K3 and K3b do not take; -> (B, L_in, C_in, C_out)."""
    if x.dim() != 3 or taps.dim() != 3 or taps.shape[0] != 4 or taps.shape[1] != x.shape[2]:
        raise ValueError(f"{what}: x (B, L_in, C_in) and taps (4, C_in, C_out), got "
                         f"{tuple(x.shape)} and {tuple(taps.shape)}")
    b, l_in, c_in = x.shape
    c_out = taps.shape[2]
    if bias.shape != (c_out,):
        raise ValueError(f"{what}: bias must be ({c_out},), got {tuple(bias.shape)}")
    if c_in % 4 or c_out % 4 or l_in < 2:
        raise ValueError(f"{what}: C_in and C_out must be multiples of 4 and L_in >= 2, got "
                         f"C_in {c_in}, C_out {c_out}, L_in {l_in}")
    _build.require_cuda_f32(what, x, taps, bias, *more)
    if any(t.data_ptr() % 16 for t in (x, taps, bias, *more)):
        raise ValueError(f"{what}: tensors must be 16-byte aligned")
    fn = _build.function(lib, f"iins_{lib}_smem", [_I, _I, _I])
    if fn(l_in, c_in, c_out) < 0:
        raise ValueError(f"{what}: C_in {c_in}, C_out {c_out} at L_in {l_in} need more "
                         "shared memory than a block has")
    return b, l_in, c_in, c_out


def launch_strided_conv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Check the operands and launch K3; counts nothing (strided_conv and
    autograd.StridedConv count)."""
    b, l_in, c_in, c_out = check_operands("strided_conv", "strided_conv", x, taps, bias)
    y = torch.empty((b, l_in // 2, c_out), device=x.device, dtype=x.dtype)
    fn = _build.function("strided_conv", "iins_strided_conv", [_P] * 4 + [_I] * 4 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), y.data_ptr(), b, l_in, c_in, c_out,
             _build.stream_handle(x))
    _build.check(err, "strided_conv", "strided_conv")
    return y
