"""Restorer (range_code -> ranging error) and Classifier (env_code ->
environment logits) heads (iinsvae_tpu/models/heads.py:20-264).

The Linear heads are one K4 mlp_chain launch each. The Conv1d / Conv2d /
Conv2dNoExpand heads are plain tensor ops, as in the JAX package, where XLA
(no Pallas kernel) runs them: strided or 1x1 convs with LeakyReLU,
Dropout(0.25) and BatchNormEps, then one Dense layer. Sub-modules are named
as flax names them (``Conv1d_0``, ``Dropout_1``, ``BatchNormEps_0``,
``Dense_0``).

A soft Restorer (``soft=True``, the CLI's ``--use_soft``): its head ends in
two outputs, (mu, logvar), and the facade returns mu + eps * exp(logvar / 2)
where its forward is given the standard-normal ``eps`` (B, 1), else mu
(heads.py:20-23, :62-70): the semi step gives it, serving and evaluation do
not.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from iinsvae_torch.models.layers import (BatchNormEps, ColumnConv, Conv1d, Conv2d, Dense,
                                         Dropout, bias_uniform)
from iinsvae_torch.ops.conv import cast_like
from iinsvae_torch.ops.kernels import fused
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

NET_TYPES = ("Linear", "Conv1d", "Conv2d")
# the Restorer's net types: the column-image head too, reachable from the constructor only
# (the CLI's --restorer_type has no name for it, in either package)
RESTORER_TYPES = NET_TYPES + ("Conv2dNoExpand",)


def soft_sample(out: torch.Tensor, eps: torch.Tensor | None) -> torch.Tensor:
    """A soft head's (B, 2) output (mu, logvar) -> mu + eps * exp(logvar / 2), or mu where
    ``eps`` is None (heads.py:20-23)."""
    mu, logvar = out[:, 0:1], out[:, 1:2]
    if eps is None:
        return mu
    return eps.to(out.dtype) * torch.exp(logvar / 2.0) + mu


class _MLPChain(nn.Module):
    """Dense + LeakyReLU chain with torch-default init; parameters
    ``w{j}`` (D_j, D_{j+1}) and ``b{j}`` (D_{j+1},) as in heads.py:26-48."""

    def __init__(self, d_in: int, widths, slopes, generator: torch.Generator):
        super().__init__()
        self.slopes = tuple(float(s) for s in slopes)
        d = d_in
        for j, w in enumerate(widths):
            setattr(self, f"w{j}", bias_uniform((d, w), d, generator))
            setattr(self, f"b{j}", bias_uniform((w,), d, generator))
            d = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.slopes)
        # cast to the input's dtype, as heads.py:41-45 casts them before the kernel
        ws = [cast_like(getattr(self, f"w{j}"), x) for j in range(n)]
        bs = [cast_like(getattr(self, f"b{j}"), x) for j in range(n)]
        return fused.mlp_chain(x.reshape(x.shape[0], -1).contiguous(), ws, bs, self.slopes)


class RestorerLinear(_MLPChain):
    """flatten -> 512 -> 256 -> 256 (LeakyReLU 0.2) -> 1, or 2 (mu, logvar)
    where ``soft``. The range code (B, 8, 2) flattens l-major, c-minor, the
    2-D code (B, 8, 8, 2) in (h, w, c) order (128 wide) and the column code
    (B, 8, 1, 2) to 16, as the JAX reshape does (heads.py:61)."""

    def __init__(self, code_shape: tuple[int, ...] = (8, 2), soft: bool = False, *,
                 generator: torch.Generator):
        super().__init__(math.prod(code_shape), (512, 256, 256, 2 if soft else 1),
                         (0.2, 0.2, 0.2, 1.0), generator)


class _ConvStack(nn.Module):
    """Two k-wide stride-s convs, each followed by LeakyReLU(0.2) and
    Dropout(0.25), then BatchNormEps, flatten and one Dense layer."""

    def __init__(self, conv, c_in: int, filters: tuple[int, int], kernel_size: int, stride: int,
                 padding: int, flat: int, d_out: int, *, generator: torch.Generator):
        super().__init__()
        name = conv.__name__
        for i, f in enumerate(filters):
            setattr(self, f"{name}_{i}", conv(c_in, f, kernel_size, stride=stride,
                                              padding=padding, generator=generator))
            setattr(self, f"Dropout_{i}", Dropout(0.25))
            c_in = f
        self.convs = [f"{name}_{i}" for i in range(len(filters))]
        self.BatchNormEps_0 = BatchNormEps(c_in, generator=generator)
        self.Dense_0 = Dense(flat, d_out, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, conv in enumerate(self.convs):
            x = getattr(self, f"Dropout_{i}")(F.leaky_relu(getattr(self, conv)(x), 0.2))
        x = self.BatchNormEps_0(x)
        return self.Dense_0(x.reshape(x.shape[0], -1))


class RestorerConv1d(_ConvStack):
    """heads.py:74-100: (B, 8, C) -> k4 s2 convs to (B, 4, 16) and (B, 2, 32)
    -> (B, 64) -> 1, or (mu, logvar) where ``soft``. The 2-D code (B, 8, 8,
    C) and the column code (B, 8, 1, C) give their first column."""

    def __init__(self, code_shape: tuple[int, ...] = (8, 2), soft: bool = False, *,
                 generator: torch.Generator):
        side, c = code_shape[0], code_shape[-1]
        super().__init__(Conv1d, c, (16, 32), 4, 2, 1, side // 4 * 32, 2 if soft else 1,
                         generator=generator)

    def forward(self, range_code: torch.Tensor) -> torch.Tensor:
        return super().forward(range_code[:, :, 0] if range_code.dim() == 4 else range_code)


class RestorerConv2d(_ConvStack):
    """heads.py:103-130: the 1-D code (B, 8, C) broadcast along a new W axis
    to (B, 8, 8, C) (the 2-D code is taken as it is) -> k4 s2 convs to
    (B, 4, 4, 16) and (B, 2, 2, 32) -> (B, 128) -> 1, or (mu, logvar) where
    ``soft``. The JAX model broadcasts a column code (B, 8, 1, C) the same way
    only where its ``expand`` is off, which its CLI never sets; at conv_type 3
    the CLI's model fails (IInsVAE raises here)."""

    def __init__(self, code_shape: tuple[int, ...] = (8, 2), soft: bool = False, *,
                 generator: torch.Generator):
        side, c = code_shape[0], code_shape[-1]
        super().__init__(Conv2d, c, (16, 32), 4, 2, 1, (side // 4) ** 2 * 32, 2 if soft else 1,
                         generator=generator)

    def forward(self, range_code: torch.Tensor) -> torch.Tensor:
        x = range_code
        if x.dim() == 3:
            x = x[:, :, None, :].expand(-1, -1, x.shape[1], -1)
        elif x.shape[2] == 1:
            x = x.expand(-1, -1, x.shape[1], -1)
        return super().forward(x)


class RestorerConv2dNoExpand(nn.Module):
    """heads.py:133-166, the column-image restorer: the code (B, L, 1, C) (or
    (B, L, C)) pooled to (32, 1), four (4,1) stride-2 convs of 16, 32, 64 and
    128 filters down to (2, 1), each with LeakyReLU(0.2) and Dropout(0.25),
    BatchNormEps after all but the first, then (B, 256) -> Dense -> 1, or
    (mu, logvar) where ``soft``."""

    def __init__(self, code_shape: tuple[int, ...] = (8, 1, 2), soft: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        c, filters = code_shape[-1], 16
        for i in range(4):  # (32,1) -> (16,1) -> (8,1) -> (4,1) -> (2,1)
            setattr(self, f"Conv2d_{i}", ColumnConv(c, filters, 4, stride=2, padding=1,
                                                    generator=generator))
            setattr(self, f"Dropout_{i}", Dropout(0.25))
            if i > 0:
                setattr(self, f"BatchNormEps_{i - 1}", BatchNormEps(filters, generator=generator))
            c, filters = filters, filters * 2
        self.Dense_0 = Dense(2 * c, 2 if soft else 1, generator=generator)

    def forward(self, range_code: torch.Tensor) -> torch.Tensor:
        x = range_code[:, :, 0] if range_code.dim() == 4 else range_code  # (B, L, C)
        pool = adaptive_avg_pool_matrix(x.shape[1], 32, device=x.device, dtype=x.dtype)
        x = torch.einsum("blc,lo->boc", x, pool)
        for i in range(4):
            x = getattr(self, f"Dropout_{i}")(F.leaky_relu(getattr(self, f"Conv2d_{i}")(x), 0.2))
            if i > 0:
                x = getattr(self, f"BatchNormEps_{i - 1}")(x)
        return self.Dense_0(x.reshape(x.shape[0], -1))


class ClassifierLinear(_MLPChain):
    """env_dim -> filters -> 2*filters -> filters -> num_classes, slopes
    0.01 between layers and 0.2 on the output (before any softmax)."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__(env_dim, (filters, filters * 2, filters, num_classes),
                         (0.01, 0.01, 0.01, 0.2), generator)


class ClassifierConv1d(_ConvStack):
    """heads.py:187-203: the code as (B, 1, env_dim) -> two 1x1 convs to
    ``filters`` -> (B, filters) -> num_classes, LeakyReLU(0.2) on the output."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__(Conv1d, env_dim, (filters, filters), 1, 1, 0, filters, num_classes,
                         generator=generator)

    def forward(self, env_code: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(super().forward(env_code.reshape(env_code.shape[0], 1, -1)), 0.2)


class ClassifierConv2d(_ConvStack):
    """heads.py:206-221: ClassifierConv1d on the code as (B, 1, 1, env_dim)."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__(Conv2d, env_dim, (filters, filters), 1, 1, 0, filters, num_classes,
                         generator=generator)

    def forward(self, env_code: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(super().forward(env_code.reshape(env_code.shape[0], 1, 1, -1)), 0.2)


def _check(head: str, net_type: str, choices: tuple[str, ...]) -> None:
    if net_type not in choices:
        raise ValueError(f"Unknown network type for {head}: {net_type!r}; choices {choices}")


def check_restorer(conv_type: int, restorer_type: str) -> None:
    """``restorer_type='Conv2d'`` at ``conv_type=3`` raises ValueError. The JAX CLI builds
    that model with ``expand`` on (its ``expand`` is conv_type != 1), so the restorer keeps
    the (B, 8, 1, C) column code, and its second stride-2, padding-1, width-4 conv leaves
    width 0: the JAX package fails there with ZeroDivisionError (heads.py:113-117)."""
    if conv_type == 3 and restorer_type == "Conv2d":
        raise ValueError(
            "restorer_type='Conv2d' with conv_type=3: the column code (B, 8, 1, C) has width 1, "
            "which the Conv2d restorer's two stride-2 convs cannot take (the JAX package fails "
            "there with ZeroDivisionError); use the Linear or Conv1d restorer")


class Restorer(nn.Module):
    """Facade (heads.py:224-244); the head sits at ``.restorer``.
    ``code_shape`` is the range code's shape without the batch axis:
    (8, range_dim), (8, 8, range_dim) for conv_type 2 or (8, 1, range_dim)
    for conv_type 3. forward(range_code, eps=None): ``eps`` (B, 1) draws a
    soft head's sample, which is mu without it."""

    def __init__(self, code_shape: tuple[int, ...] = (8, 2), net_type: str = "Linear",
                 soft: bool = False, *, generator: torch.Generator):
        super().__init__()
        _check("Restorer", net_type, RESTORER_TYPES)
        cls = {"Linear": RestorerLinear, "Conv1d": RestorerConv1d, "Conv2d": RestorerConv2d,
               "Conv2dNoExpand": RestorerConv2dNoExpand}[net_type]
        self.soft = soft
        self.restorer = cls(tuple(code_shape), soft, generator=generator)

    def forward(self, range_code: torch.Tensor, eps: torch.Tensor | None = None) -> torch.Tensor:
        out = self.restorer(range_code)
        return soft_sample(out, eps) if self.soft else out


class Classifier(nn.Module):
    """Facade (heads.py:247-264); the head sits at ``.classifier``."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16,
                 net_type: str = "Linear", *, generator: torch.Generator):
        super().__init__()
        _check("Classifier", net_type, NET_TYPES)
        cls = {"Linear": ClassifierLinear, "Conv1d": ClassifierConv1d,
               "Conv2d": ClassifierConv2d}[net_type]
        self.classifier = cls(env_dim, num_classes, filters, generator=generator)

    def forward(self, env_code: torch.Tensor) -> torch.Tensor:
        return self.classifier(env_code)
