"""Adaptive average pooling with exact torch semantics, as a matmul.

Output bin ``i`` averages input taps ``[floor(i*L_in/L_out),
ceil((i+1)*L_in/L_out))``; for static shapes that is one constant matrix
``P`` with ``y = x @ P`` (iinsvae_tpu/ops/pooling.py:23-45).
"""

from __future__ import annotations

import torch


def adaptive_avg_pool_matrix(l_in: int, l_out: int, device=None,
                             dtype=torch.float32) -> torch.Tensor:
    """The (l_in, l_out) pooling matrix P such that y = x @ P. Built with
    tensor ops on ``device`` (no host copy), so a CUDA graph can capture it."""
    i = torch.arange(l_out, device=device)
    start = (i * l_in) // l_out
    end = -((-(i + 1) * l_in) // l_out)  # ceil((i+1)*l_in / l_out)
    u = torch.arange(l_in, device=device)[:, None]
    inside = (u >= start) & (u < end)
    return inside.to(dtype) / (end - start).to(dtype)
