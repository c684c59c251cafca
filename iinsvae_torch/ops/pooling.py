"""Adaptive average pooling with exact torch semantics, as a matmul.

Output bin ``i`` averages input taps ``[floor(i*L_in/L_out),
ceil((i+1)*L_in/L_out))``; for static shapes that is one constant matrix
``P`` with ``y = x @ P`` (iinsvae_tpu/ops/pooling.py:23-45).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _pool_matrix_np(l_in: int, l_out: int) -> np.ndarray:
    p = np.zeros((l_in, l_out), dtype=np.float32)
    for i in range(l_out):
        start = (i * l_in) // l_out
        end = -((-(i + 1) * l_in) // l_out)  # ceil((i+1)*l_in / l_out)
        p[start:end, i] = 1.0 / (end - start)
    p.setflags(write=False)
    return p


def adaptive_avg_pool_matrix(l_in: int, l_out: int, device=None,
                             dtype=torch.float32) -> torch.Tensor:
    """The (l_in, l_out) pooling matrix P such that y = x @ P."""
    return torch.tensor(_pool_matrix_np(l_in, l_out), device=device, dtype=dtype)

