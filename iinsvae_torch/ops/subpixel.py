"""The decoder's upsample stages in subpixel (phase) form, a copy of
iinsvae_tpu/ops/subpixel.py in torch.

``nearest_upsample(2) -> Conv2d(5x5, zero pad 2)`` equals, for each output
phase (p, q) in {0, 1}^2,

    y[2i+p, 2j+q] = sum_{a,b in {-1,0,1}} Kp[p,q][a,b] . x[i+a, j+b]
    Kp[p,q][a,b]  = sum_{t: floor((p+t-2)/2)=a} sum_{s: floor((q+s-2)/2)=b} K[t,s]

one 3x3 zero-pad-1 conv on the low-resolution grid with 4*C_out phase
channels, ordered (p, q, c_out), then a pixel shuffle. Exact up to the
order of the sums: 9/25 of the products of the upsampled conv.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from iinsvae_torch.ops.conv import conv2d


@functools.lru_cache(maxsize=None)
def _phase_incidence_np(k: int = 5) -> np.ndarray:
    """PH[p, a, t] = 1 where upsampled tap t of phase p reads cell offset
    a - 1 (a in {0, 1, 2} for offsets {-1, 0, 1})."""
    ph = np.zeros((2, 3, k), dtype=np.float32)
    for p in range(2):
        for t in range(k):
            ph[p, (p + t - k // 2) // 2 + 1, t] = 1.0
    return ph


@functools.lru_cache(maxsize=None)
def _phase_incidence(k: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The incidence on ``device``, made once (no host copy after that),
    outside inference mode (autograd may save it later)."""
    with torch.inference_mode(False):
        return torch.as_tensor(_phase_incidence_np(k), dtype=dtype, device=device)


def phase_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(5, 5, C_in, C_out) -> the (3, 3, C_in, 4*C_out) phase kernel,
    output channels ordered (p, q, c_out)."""
    k, k2, c_in, c_out = kernel.shape
    if (k, k2) != (5, 5):
        raise ValueError(f"phase folding takes 5x5 kernels, got {k}x{k2}")
    ph = _phase_incidence(k, kernel.dtype, kernel.device)
    kp = torch.einsum("pat,qbs,tscd->abcpqd", ph, ph, kernel)
    return kp.reshape(3, 3, c_in, 4 * c_out)


def upsample_conv5_phase(x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """nearest_up2 + conv5 (zero pad 2) in phase layout: x (B, H, W, C),
    kernel (5, 5, C, C') -> (B, H, W, 4*C'); pixel_shuffle2 gives (B, 2H, 2W, C')."""
    full_bias = None if bias is None else bias.repeat(4)
    return conv2d(x, phase_kernel(kernel), full_bias, padding=1)


def pixel_shuffle2(z: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 4C), channels ordered (p, q, c) -> (B, 2H, 2W, C)."""
    b, h, w, c4 = z.shape
    c = c4 // 4
    z = z.reshape(b, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)  # b, h, p, w, q, c
    return z.reshape(b, 2 * h, 2 * w, c)
