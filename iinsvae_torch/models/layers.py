"""Initialisers, ConvINAct, Conv1d, Conv2d, ColumnConv, Dense, the decoder's MLP,
SampleLayerNorm, the column-image residual block, and the Conv heads'
BatchNormEps and Dropout.

Initialisation mirrors iinsvae_tpu/models/layers.py:21-55 in distribution
(not in values: torch.Generator and jax.random give different streams):
conv taps ~ N(0, 0.02) (the reference's weights_init_normal), biases and
Dense weights ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default); the
env encoders' conv taps optionally torch's default too (``pick_conv_init``).
Parameters are float32; a layer casts them to its input's dtype at use
(ops.conv.cast_like), so a bfloat16 input runs the layer in bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
from torch import nn

from iinsvae_torch.ops.conv import cast_like, conv1d, conv2d
from iinsvae_torch.ops.kernels import fused, strided_conv
from iinsvae_torch.ops.norms import adain, instance_norm, sample_layer_norm


def check_conv_type(conv_type: int) -> None:
    """``conv_type`` 1, 2 or 3 (the 1-D, the expanded 2-D and the column-image model); any
    other raises ValueError. (The JAX Encoder and Decoder run any other value as the
    column-image model.)"""
    if conv_type not in (1, 2, 3):
        raise ValueError(f"conv_type must be 1 (1-D), 2 (expanded 2-D) or 3 (column image, "
                         f"NoExpand), got {conv_type!r}")


def conv_normal(shape, generator: torch.Generator, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator))


def bias_uniform(shape, fan_in: int, generator: torch.Generator) -> nn.Parameter:
    bound = 1.0 / float(fan_in) ** 0.5
    u = torch.rand(shape, generator=generator)
    return nn.Parameter((2.0 * u - 1.0) * bound)


def conv_torch(shape, generator: torch.Generator) -> nn.Parameter:
    """torch's Conv default U(+-1/sqrt(fan_in)), fan_in every axis of the taps but the
    last (JAX layers.py:34-49). For taps of 16 values or more ``torch.rand`` takes as much
    of the generator's stream as ``torch.randn``, so a model's other parameters come out
    the same under either init."""
    fan_in = 1
    for n in shape[:-1]:
        fan_in *= int(n)
    return bias_uniform(shape, fan_in, generator)


CONV_INITS = ("reference", "torch")


def pick_conv_init(name: str):
    """'reference' -> N(0, 0.02) (weights_init_normal); 'torch' -> torch's Conv default
    U(+-1/sqrt(fan_in)) (JAX layers.py:52-55)."""
    if name not in CONV_INITS:
        raise ValueError(f"conv init must be one of {CONV_INITS}, got {name!r}")
    return conv_normal if name == "reference" else conv_torch


class ConvINAct(nn.Module):
    """The norm-free ConvINAct of the env encoder: Conv1d + bias + ReLU in
    one launch (JAX layers.py:126-220 with norm='none', act='relu').

    Parameters as in the JAX module: ``kernel`` (k, C_in, C_out) and
    ``bias`` (C_out,). The k4 s2 zero-pad-1 case runs K3 strided_conv, any
    other conv K2 conv_bias_act. (The range encoder's normed stages call K1
    in_chain directly, as the JAX RangeEncoder1d holds their taps itself.)"""

    def __init__(self, c_in: int, features: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, pad_mode: str = "zero", init=conv_normal,
                 generator: torch.Generator):
        super().__init__()
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.kernel = init((kernel_size, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if strided_conv.applicable(self.kernel.shape[0], self.stride, self.padding, self.pad_mode):
            return strided_conv.strided_conv(x, self.kernel, self.bias)
        return fused.conv_bias_act(x, self.kernel, self.bias, stride=self.stride,
                                   padding=self.padding, pad_mode=self.pad_mode)


class Conv1d(nn.Module):
    """Plain channels-last Conv1d with bias (JAX layers.py:58-95): the env
    encoder's 1x1 head on the length-1 mean and the Conv heads' convs, plain
    tensor ops (the JAX package runs them outside any Pallas kernel too)."""

    def __init__(self, c_in: int, features: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, init=conv_normal, generator: torch.Generator):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = init((kernel_size, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d(x, self.kernel, self.bias, stride=self.stride, padding=self.padding)


class Conv2d(nn.Module):
    """Plain NHWC Conv2d with bias (JAX layers.py:98-123), one stride and
    zero padding for both axes: ``kernel`` (k, k, C_in, C_out), ``bias``
    (C_out,) U(+-1/sqrt(C_in * k * k))."""

    def __init__(self, c_in: int, features: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, generator: torch.Generator):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.kernel = conv_normal((kernel_size, kernel_size, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size**2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d(x, self.kernel, self.bias, stride=self.stride, padding=self.padding)


class ColumnConv(nn.Module):
    """The flax Conv2d of the column-image model (conv_type 3): a (k, 1) kernel, stride
    (s, 1) and padding ((p, p), (0, 0)) on a (B, H, 1, C) column (JAX layers.py:98-123).
    Parameters as flax names them: ``kernel`` (k, 1, C_in, C_out), ``bias`` (C_out,)
    U(+-1/sqrt(C_in * k)). The port carries the column as (B, H, C), its width 1 dropped,
    so the conv is a conv1d over H: plain tensor ops, as XLA runs it in the JAX package.
    ``norm_follows``: an InstanceNorm or AdaIN follows the conv and removes its bias, so
    the bias is no input of the forward and its gradient is exactly 0 (JAX adds it and
    its gradient is rounding noise)."""

    def __init__(self, c_in: int, features: int, kernel_size: int, *, stride: int = 1,
                 padding: int = 0, pad_mode: str = "zero", norm_follows: bool = False,
                 init=conv_normal, generator: torch.Generator):
        super().__init__()
        self.stride, self.padding, self.pad_mode = stride, padding, pad_mode
        self.norm_follows = norm_follows
        self.kernel = init((kernel_size, 1, c_in, features), generator)
        self.bias = bias_uniform((features,), c_in * kernel_size, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, C_in) -> (B, H_out, C_out)
        return conv1d(x, self.kernel[:, 0], None if self.norm_follows else self.bias,
                      stride=self.stride, padding=self.padding, pad_mode=self.pad_mode)


class ResidualBlock2dNoExpand(nn.Module):
    """The column-image residual block (JAX layers.py:362-385): x + norm(conv(relu(
    norm(conv(x))))), each conv (3, 1) with reflect padding 1 over H, each norm
    InstanceNorm or AdaIN with a per-sample (gamma, beta) (B, C). The convs sit at
    ``Conv2d_0`` / ``Conv2d_1`` as in flax; their biases are no input (``norm_follows``).
    Plain tensor ops on the (B, H, C) column."""

    def __init__(self, features: int, norm: str = "in", *, generator: torch.Generator):
        super().__init__()
        if norm not in ("in", "adain"):
            raise ValueError(f"norm must be 'in' or 'adain', got {norm!r}")
        self.norm = norm
        for i in range(2):
            setattr(self, f"Conv2d_{i}", ColumnConv(features, features, 3, padding=1,
                                                    pad_mode="reflect", norm_follows=True,
                                                    generator=generator))

    def _norm(self, y: torch.Tensor, params) -> torch.Tensor:
        return instance_norm(y) if self.norm == "in" else adain(y, *params)

    def forward(self, x: torch.Tensor, adain_params=(None, None)) -> torch.Tensor:
        y = torch.relu(self._norm(self.Conv2d_0(x), adain_params[0]))
        return x + self._norm(self.Conv2d_1(y), adain_params[1])


class SampleLayerNorm(nn.Module):
    """The reference's per-sample LayerNorm as a module (JAX layers.py:261-271): ``gamma``
    ~ U(0, 1), ``beta`` 0, per channel."""

    def __init__(self, c: int, *, generator: torch.Generator):
        super().__init__()
        self.gamma = nn.Parameter(torch.rand((c,), generator=generator))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sample_layer_norm(x, self.gamma, self.beta)


class Dense(nn.Module):
    """Linear layer with torch-default init (JAX layers.py:223-240):
    ``kernel`` (D_in, D_out) and ``bias`` (D_out,), each U(+-1/sqrt(D_in))."""

    def __init__(self, d_in: int, features: int, *, generator: torch.Generator):
        super().__init__()
        self.kernel = bias_uniform((d_in, features), d_in, generator)
        self.bias = bias_uniform((features,), d_in, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ cast_like(self.kernel, x) + cast_like(self.bias, x)


class MLP(nn.Module):
    """The AdaIN-parameter predictor (JAX layers.py:243-258): d_in -> dim ->
    ReLU -> ... -> output_dim, ``n_blk`` Dense layers named ``Dense_{i}`` as
    in flax. Plain tensor ops: the JAX package computes it outside any
    Pallas kernel too."""

    def __init__(self, d_in: int, output_dim: int, dim: int = 256, n_blk: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        widths = [dim] * (n_blk - 1) + [output_dim]
        self.n_blk = n_blk
        for i, w in enumerate(widths):
            setattr(self, f"Dense_{i}", Dense(d_in, w, generator=generator))
            d_in = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_blk - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_blk - 1}")(x)


class BatchNormEps(nn.Module):
    """The reference's ``nn.BatchNorm1d(c, 0.8)``, whose 0.8 lands on eps
    (JAX layers.py:274-312): ``scale`` ~ N(1, 0.02), ``bias`` 0, running
    ``mean`` / ``var`` buffers (the flax ``batch_stats``). In train mode it
    normalises by the batch's mean and biased variance over every axis but
    the last (padding rows count, as in JAX) and moves the running stats by
    ``momentum`` towards the mean and the unbiased variance; in eval mode it
    reads the running stats."""

    def __init__(self, c: int, eps: float = 0.8, momentum: float = 0.1, *,
                 generator: torch.Generator):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(1.0 + 0.02 * torch.randn(c, generator=generator))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(dim=axes)
            var = x.var(dim=axes, correction=0)
            n = x.numel() // x.shape[-1]
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_((1 - m) * self.mean + m * mean)
                self.var.copy_((1 - m) * self.var + m * (var * (n / max(n - 1, 1))))
        else:
            mean, var = self.mean, self.var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias


class Dropout(nn.Module):
    """flax ``nn.Dropout(rate)``: in train mode each entry is kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed; in eval
    mode the identity. The keep mask is ``keep`` where one is injected (a
    bool tensor of x's shape), else a draw from ``generator``; both are set
    for one forward by ``dropout_source``."""

    def __init__(self, rate: float = 0.25):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.keep: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return x
        keep = self.keep
        if keep is None:
            if self.generator is None:
                raise RuntimeError("Dropout in train mode needs a generator or an injected mask "
                                   "(dropout_source)")
            keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros((), dtype=x.dtype,
                                                                     device=x.device))


@contextlib.contextmanager
def dropout_source(model: nn.Module, generator: Optional[torch.Generator] = None,
                   masks: Optional[dict[str, torch.Tensor]] = None) -> Iterator[None]:
    """For the forwards inside the block, every Dropout of ``model`` takes
    its keep mask from ``masks`` (by module name, as flax names the module's
    path: ``identifier.classifier.Dropout_0``) or, where none is given, draws
    it from ``generator``, in the order the forward reaches them."""
    mods = {n: m for n, m in model.named_modules() if isinstance(m, Dropout)}
    unknown = set(masks or ()) - set(mods)
    if unknown:
        raise KeyError(f"no Dropout named {sorted(unknown)}; the model has {sorted(mods)}")
    for n, m in mods.items():
        m.generator, m.keep = generator, (masks or {}).get(n)
    try:
        yield
    finally:
        for m in mods.values():
            m.generator = m.keep = None


def draw_dropout_masks(model: nn.Module, generator: torch.Generator,
                       *inputs: torch.Tensor) -> dict[str, torch.Tensor]:
    """Keep masks for every Dropout of ``model`` at the shapes a forward on
    ``inputs`` gives them, drawn from ``generator`` on its device, by module
    name: inject them (dropout_source) into copies of the model on other
    devices or dtypes to run them all on the same masks. The shapes come from
    a forward in eval mode, which moves no running stats."""
    shapes: dict[str, torch.Size] = {}
    handles = [m.register_forward_hook(
        lambda mod, args, out, name=name: shapes.__setitem__(name, args[0].shape))
        for name, m in model.named_modules() if isinstance(m, Dropout)]
    was_training = model.training
    try:
        model.eval()
        with torch.no_grad():
            model(*inputs)
    finally:
        model.train(was_training)
        for h in handles:
            h.remove()
    return {n: torch.rand(s, generator=generator, device=generator.device) >= 0.25
            for n, s in shapes.items()}
