"""Plain channels-last Conv1d and Conv2d: the building blocks of the
kernels' plain versions and of the 2-D model's plain convs.

Padding follows iinsvae_tpu/ops/dense_conv.py:30-49: output ``o``'s tap
``t`` reads input ``u = o*stride + t - padding``; zero padding drops an
out-of-range ``u``, reflect padding maps it to ``-u`` or ``2L-2-u`` (the
edge itself is not repeated). Conv2d pads both spatial axes alike.

Both are a window view and one einsum (a matmul), not cuDNN: a float32
matmul runs in full fp32 under torch's default matmul precision, forward
and backward, where cuDNN's float32 convolutions default to TF32
(``torch.backends.cudnn.allow_tf32``) and would put ~1e-3 between the card
and the CPU.

Under bfloat16 activations (``--compute_dtype bfloat16``) the float32
parameters are cast to the activations' dtype at use (``cast_like``, JAX's
``kernel.astype(x.dtype)``, iinsvae_tpu/ops/conv.py:84-88, :141-147): the
products take bfloat16 operands, accumulate in fp32 and round the result,
as XLA's ``preferred_element_type=jnp.float32`` does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def cast_like(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Parameter ``p`` in the dtype of the activations ``x`` (a no-op for float32). The
    gradient flows back through the cast in ``p``'s dtype, so the optimizer and the checkpoints
    see float32."""
    return p.to(x.dtype)


@contextlib.contextmanager
def fp32_reduction():
    """Inside the block (or the function it decorates) a product of bfloat16 operands on the
    card reduces in fp32, as the CPU's does and as ``preferred_element_type=jnp.float32``
    asks: cuBLAS may reduce in bfloat16 while
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` is on (torch's
    default). The entry points that pick the compute dtype run under it; the setting is
    restored on exit."""
    matmul = torch.backends.cuda.matmul
    before = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = before


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


def reflect_pad2d(x: torch.Tensor, padding: int) -> torch.Tensor:
    """Reflection padding of the H and W axes of x (B, H, W, C)
    (iinsvae_tpu/ops/conv.py:33, torch's ReflectionPad2d)."""
    x = x[:, _reflect_index(x.shape[1], padding, x.device)]
    return x[:, :, _reflect_index(x.shape[2], padding, x.device)]


def conv2d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int = 0,
    pad_mode: str = "zero",
) -> torch.Tensor:
    """x (B, H, W, C_in), kernel (kh, kw, C_in, C_out) -> (B, H_out, W_out,
    C_out) (iinsvae_tpu/ops/conv.py:92 with one stride and padding for both axes)."""
    if pad_mode not in ("zero", "reflect"):
        raise ValueError(f"pad_mode must be 'zero' or 'reflect', got {pad_mode!r}")
    kh, kw = kernel.shape[:2]
    if padding:
        if pad_mode == "reflect":
            x = reflect_pad2d(x, padding)
        else:
            x = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)  # (B, H_out, W_out, C_in, kh, kw)
    y = torch.einsum("bhwcij,ijcd->bhwd", win, cast_like(kernel, x))
    if bias is not None:
        y = y + cast_like(bias, y)
    return y


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
    y = torch.einsum("blct,tcd->bld", win, cast_like(kernel, x))
    if bias is not None:
        y = y + cast_like(bias, y)
    return y
