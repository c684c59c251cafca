"""InstanceNorm with the reference's numerics (iinsvae_tpu/ops/norms.py:32-37):
no affine, no running stats, biased variance, eps 1e-5.

The variance is taken two-pass, as the mean of (x - mean)^2: the one-pass
E[x^2] - mean^2 form cancels to a negative number on near-constant
channels and gives NaN under the rsqrt.
"""

from __future__ import annotations

import torch

EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x (B, L, C): normalize each (sample, channel) over L."""
    mean = x.mean(dim=1, keepdim=True)
    d = x - mean
    var = (d * d).mean(dim=1, keepdim=True)
    return d * torch.rsqrt(var + eps)
