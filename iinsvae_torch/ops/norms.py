"""Norms with the reference's numerics (iinsvae_tpu/ops/norms.py:32-90).

* InstanceNorm: no affine, no running stats, biased variance, eps 1e-5,
  over every spatial axis: L of a (B, L, C) field, H and W of (B, H, W, C).
* AdaIN: InstanceNorm with a per-sample (gamma, beta) of shape (B, C).
* The reference's "LayerNorm" (sample layer norm): per-sample mean over all
  L*C values, torch's UNBIASED std (n - 1), denominator (std + eps) (not
  sqrt(var + eps)), then a per-channel affine.

Every variance is taken two-pass, from the squared deviations from the
mean: the one-pass E[x^2] - mean^2 form cancels to a negative number on
near-constant inputs and gives NaN under the root.

On bfloat16 activations the statistics are taken in float32 and rounded to
bfloat16 (jnp.mean and jnp.var upcast bfloat16 and round their result), the
rest runs in bfloat16, and the affine parameters are cast to the
activations' dtype (iinsvae_tpu/ops/norms.py:47, :78).
"""

from __future__ import annotations

import torch

EPS = 1e-5


def _stats_f32(x: torch.Tensor, axes, correction: int = 0):
    """(mean, variance) of bfloat16 x over ``axes`` taken in float32 (two-pass) and rounded to
    bfloat16, as jnp.mean and jnp.var give them."""
    xf = x.float()
    mean = xf.mean(dim=axes, keepdim=True)
    d = xf - mean
    n = xf.numel() // mean.numel()
    var = (d * d).sum(dim=axes, keepdim=True) / (n - correction)
    return mean.to(x.dtype), var.to(x.dtype)


def instance_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """x (B, *spatial, C): normalize each (sample, channel) over the spatial axes."""
    axes = tuple(range(1, x.dim() - 1))
    if x.dtype == torch.bfloat16:
        mean, var = _stats_f32(x, axes)
        return (x - mean) * torch.rsqrt(var + eps)
    mean = x.mean(dim=axes, keepdim=True)
    d = x - mean
    var = (d * d).mean(dim=axes, keepdim=True)
    return d * torch.rsqrt(var + eps)


def adain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float = EPS) -> torch.Tensor:
    """x (B, *spatial, C); gamma, beta (B, C): IN(x) * gamma + beta per sample."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
    y = instance_norm(x, eps)
    return y * gamma.reshape(shape).to(y.dtype) + beta.reshape(shape).to(y.dtype)


def sample_layer_norm_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (mean, unbiased std) over all non-batch values, each (B,)."""
    flat = x.reshape(x.shape[0], -1)
    if x.dtype == torch.bfloat16:
        mean, var = _stats_f32(flat, (1,), correction=1)
        return mean[:, 0], torch.sqrt(var[:, 0])
    mean = flat.mean(dim=1)
    d = flat - mean[:, None]
    std = torch.sqrt((d * d).sum(dim=1) / (flat.shape[1] - 1))
    return mean, std


def sample_layer_norm_apply(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor,
                            eps: float = EPS) -> torch.Tensor:
    """(x - mean) / (std + eps) per sample, then the per-channel affine
    gamma, beta (C,)."""
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    y = (x - mean.reshape(shape)) / (std.reshape(shape) + eps)
    return y * gamma.to(y.dtype) + beta.to(y.dtype)


def sample_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      eps: float = EPS) -> torch.Tensor:
    """The reference's per-sample LayerNorm (models.py:965-985)."""
    mean, std = sample_layer_norm_stats(x)
    return sample_layer_norm_apply(x, mean, std, gamma, beta, eps)
