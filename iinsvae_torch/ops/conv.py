"""Plain channels-last Conv1d: the building block of the kernels' plain versions.

Padding follows iinsvae_tpu/ops/dense_conv.py:30-49: output ``o``'s tap
``t`` reads input ``u = o*stride + t - padding``; zero padding drops an
out-of-range ``u``, reflect padding maps it to ``-u`` or ``2L-2-u`` (the
edge itself is not repeated).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def out_len(l_in: int, k: int, stride: int = 1, padding: int = 0) -> int:
    return (l_in + 2 * padding - k) // stride + 1


def _reflect_index(l_in: int, padding: int, device) -> torch.Tensor:
    u = torch.arange(-padding, l_in + padding, device=device)
    u = torch.where(u < 0, -u, u)
    return torch.where(u >= l_in, 2 * l_in - 2 - u, u)


def upsample_nearest1d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of x (B, L, C) along L (torch
    nn.Upsample(scale_factor=factor)): row u of the output is row u // factor."""
    return x.repeat_interleave(factor, dim=1)


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    pad_mode: str = "zero",
) -> torch.Tensor:
    """x (B, L_in, C_in), kernel (k, C_in, C_out) -> (B, L_out, C_out)."""
    if pad_mode not in ("zero", "reflect"):
        raise ValueError(f"pad_mode must be 'zero' or 'reflect', got {pad_mode!r}")
    k = kernel.shape[0]
    if padding:
        if pad_mode == "reflect":
            x = x[:, _reflect_index(x.shape[1], padding, x.device)]
        else:
            x = F.pad(x, (0, 0, padding, padding))
    win = x.unfold(1, k, stride)  # (B, L_out, C_in, k)
    y = torch.einsum("blct,tcd->bld", win, kernel)
    if bias is not None:
        y = y + bias
    return y
