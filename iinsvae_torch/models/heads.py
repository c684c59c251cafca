"""Linear Restorer (range_code -> ranging error) and Classifier
(env_code -> environment logits) heads, each one K4 mlp_chain launch
(iinsvae_tpu/models/heads.py:26-71, 169-184, 224-264)."""

from __future__ import annotations

import torch
from torch import nn

from iinsvae_torch.models.layers import bias_uniform
from iinsvae_torch.ops.kernels import fused


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
        ws = [getattr(self, f"w{j}") for j in range(n)]
        bs = [getattr(self, f"b{j}") for j in range(n)]
        return fused.mlp_chain(x.reshape(x.shape[0], -1).contiguous(), ws, bs, self.slopes)


class RestorerLinear(_MLPChain):
    """flatten -> 512 -> 256 -> 256 (LeakyReLU 0.2) -> 1. The range code
    (B, 8, 2) flattens l-major, c-minor, and the 2-D code (B, 8, 8, 2) in
    (h, w, c) order (128 wide), as the JAX reshape does (heads.py:61)."""

    def __init__(self, code_size: int = 16, *, generator: torch.Generator):
        super().__init__(code_size, (512, 256, 256, 1), (0.2, 0.2, 0.2, 1.0), generator)


class ClassifierLinear(_MLPChain):
    """env_dim -> filters -> 2*filters -> filters -> num_classes, slopes
    0.01 between layers and 0.2 on the output (before any softmax)."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__(env_dim, (filters, filters * 2, filters, num_classes),
                         (0.01, 0.01, 0.01, 0.2), generator)


def _only_linear(head: str, net_type: str) -> None:
    if net_type != "Linear":
        raise NotImplementedError(
            f"{head} net_type={net_type!r}: only the Linear heads are ported; "
            "the Conv1d/Conv2d heads come with the joint and sep slice")


class Restorer(nn.Module):
    """Facade (heads.py:224-244); the head sits at ``.restorer``."""

    def __init__(self, code_size: int = 16, net_type: str = "Linear", *,
                 generator: torch.Generator):
        super().__init__()
        _only_linear("Restorer", net_type)
        self.restorer = RestorerLinear(code_size, generator=generator)

    def forward(self, range_code: torch.Tensor) -> torch.Tensor:
        return self.restorer(range_code)


class Classifier(nn.Module):
    """Facade (heads.py:247-264); the head sits at ``.classifier``."""

    def __init__(self, env_dim: int, num_classes: int, filters: int = 16,
                 net_type: str = "Linear", *, generator: torch.Generator):
        super().__init__()
        _only_linear("Classifier", net_type)
        self.classifier = ClassifierLinear(env_dim, num_classes, filters, generator=generator)

    def forward(self, env_code: torch.Tensor) -> torch.Tensor:
        return self.classifier(env_code)
