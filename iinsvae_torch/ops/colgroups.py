"""Exact column-group compression of the expanded 2-D field (conv_type=2).

A copy of iinsvae_tpu/ops/colgroups.py's calculus, in torch. The expanded
model's input is the square image ``image[b, i, j] = cir[b, i]``: every
column is the same. Pooling and every conv of the encoders keep that
structure in compressed form, so a field only ever has a few distinct
columns ("groups"): 1 through the reflect-padded first conv, 3 through each
zero-padded stride-2 stage (left edge, interior, right edge). A grouped
field carries ``(B, H, G, C)`` and a static column -> group map, and a 2-D
conv on it is one 1-D conv over H with the group-transformed kernel

    K1[dh, (g, ci), (g', co)] = sum_t A[g', t, g] * K[dh, t, ci, co]

where A is the 0/1 tap-to-group incidence of the output group's column
signature. InstanceNorm and global means over (H, W) are weighted sums over
the groups, each weighted by its column count / (H * W). The group
bookkeeping is static Python over (W, kernel, stride, padding, pad_mode),
cached; only the data is a tensor. Its constants (incidences, group
weights, column indices) are cached on each device too, so a forward
copies nothing from the host after its first call (a CUDA graph can
capture it).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from iinsvae_torch.ops.conv import conv1d
from iinsvae_torch.ops.norms import EPS
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

PAD = -1  # group id of a zero-padding tap


@dataclass
class GroupedField:
    """A width-compressed channels-last field: data[b, h, g, c] is the value
    of every column j with col2g[j] == g."""

    data: torch.Tensor  # (B, H, G, C)
    col2g: tuple  # length W, values in [0, G)

    @property
    def width(self) -> int:
        return len(self.col2g)

    @property
    def counts(self) -> np.ndarray:
        return np.bincount(np.asarray(self.col2g), minlength=self.data.shape[2]).astype(np.float32)

    def expand(self) -> torch.Tensor:
        """-> the dense (B, H, W, C) field."""
        return self.data.index_select(2, on_device(self.col2g, torch.long, self.data.device))

    def weights(self) -> torch.Tensor:
        """Each group's share of the (H, W) field: count / (H * W), (G,)."""
        w = self.counts / (self.data.shape[1] * self.width)
        return on_device(tuple(w.tolist()), self.data.dtype, self.data.device)


@functools.lru_cache(maxsize=None)
def on_device(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant tensor of static values, made once per (dtype, device),
    outside inference mode (autograd may save it later)."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def constant_field(x1d: torch.Tensor, width: int) -> GroupedField:
    """(B, H, C) -> the column-constant field of the given width: one group."""
    return GroupedField(x1d[:, :, None, :], (0,) * width)


@functools.lru_cache(maxsize=None)
def conv_group_structure(col2g: tuple, kw: int, stride: int, padding: int, pad_mode: str):
    """Static group calculus of one conv along W: (col2g_out, signatures),
    where signatures[g'] is the kw-tuple of input groups (PAD for a zero
    tap) that output group g' reads. Output columns with equal signatures
    are equal."""
    w = len(col2g)
    w_out = (w + 2 * padding - kw) // stride + 1
    sig2g: dict = {}
    col2g_out, signatures = [], []
    for j in range(w_out):
        sig = []
        for t in range(kw):
            u = j * stride + t - padding
            if u < 0:
                u = -u if pad_mode == "reflect" else PAD
            elif u >= w:
                u = 2 * w - 2 - u if pad_mode == "reflect" else PAD
            sig.append(PAD if u == PAD else col2g[u])
        sig = tuple(sig)
        if sig not in sig2g:
            sig2g[sig] = len(signatures)
            signatures.append(sig)
        col2g_out.append(sig2g[sig])
    return tuple(col2g_out), tuple(signatures)


@functools.lru_cache(maxsize=None)
def _tap_incidence(signatures: tuple, g_in: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.as_tensor(_tap_incidence_np(signatures, g_in), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _tap_incidence_np(signatures: tuple, g_in: int) -> np.ndarray:
    """A[g', t, g] = 1 where output group g''s tap t reads input group g."""
    g_out, kw = len(signatures), len(signatures[0])
    a = np.zeros((g_out, kw, g_in), dtype=np.float32)
    for gp, sig in enumerate(signatures):
        for t, g in enumerate(sig):
            if g != PAD:
                a[gp, t, g] = 1.0
    return a


def conv2d_grouped(xg: GroupedField, kernel: torch.Tensor, bias: torch.Tensor | None = None,
                   *, stride: int = 1, padding: int = 0, pad_mode: str = "zero") -> GroupedField:
    """A 2-D conv (square kernel, one stride and padding, one pad mode on
    both axes) of a grouped field: one 1-D conv over H with the
    group-transformed kernel (kh, G*C_in, G'*C_out)."""
    kh, kw, c_in, c_out = kernel.shape
    b, h, g, c = xg.data.shape
    if c != c_in:
        raise ValueError(f"kernel takes {c_in} input channels, the field has {c}")
    col2g_out, sigs = conv_group_structure(xg.col2g, kw, stride, padding, pad_mode)
    g_out = len(sigs)
    a = _tap_incidence(sigs, g, kernel.dtype, kernel.device)
    k1 = torch.einsum("Gtg,htcd->hgcGd", a, kernel).reshape(kh, g * c_in, g_out * c_out)
    full_bias = None if bias is None else bias.repeat(g_out)
    y = conv1d(xg.data.reshape(b, h, g * c_in), k1, full_bias, stride=stride, padding=padding,
               pad_mode=pad_mode)
    return GroupedField(y.reshape(b, y.shape[1], g_out, c_out), col2g_out)


def instance_norm_grouped(xg: GroupedField, eps: float = EPS) -> GroupedField:
    """InstanceNorm over (H, W) per (sample, channel), W reduced as a
    count-weighted sum over the groups (two-pass, biased, no affine)."""
    wts = xg.weights()
    mean = torch.einsum("bhgc,g->bc", xg.data, wts)
    centered = xg.data - mean[:, None, None, :]
    var = torch.einsum("bhgc,g->bc", centered * centered, wts)
    return GroupedField(centered * torch.rsqrt(var + eps)[:, None, None, :], xg.col2g)


def global_mean_grouped(xg: GroupedField) -> torch.Tensor:
    """The mean over (H, W) -> (B, C) (AdaptiveAvgPool2d(1) of the dense field)."""
    return torch.einsum("bhgc,g->bc", xg.data, xg.weights())


def relu_grouped(xg: GroupedField) -> GroupedField:
    return GroupedField(torch.relu(xg.data), xg.col2g)


def pool_constant_field(xg: GroupedField, out_hw: int) -> GroupedField:
    """Adaptive average pool of a one-group (column-constant) field to
    (out_hw, out_hw). Along W each window averages equal values with weights
    that sum to 1, so only the H pool computes; the result is the constant
    field of width out_hw."""
    if xg.data.shape[2] != 1:
        raise ValueError("pool_constant_field takes a one-group field")
    h = xg.data.shape[1]
    if h == out_hw and xg.width == out_hw:
        return xg
    p = adaptive_avg_pool_matrix(h, out_hw, device=xg.data.device, dtype=xg.data.dtype)
    return GroupedField(torch.einsum("bhgc,ho->bogc", xg.data, p), (0,) * out_hw)
