"""K1 in_chain, K2 conv_bias_act and K4 mlp_chain: wrappers and plain versions.

The CUDA sources are csrc/in_chain.cu (K1, K2 and K3's kernel) and
csrc/mlp_chain.cu (K4);
each states the TPU entry it replaces, its bound on the H100 and what its
design does about it. Layouts are the JAX package's: activations (B, L, C),
conv taps (k, C_in, C_out), dense weights (D_in, D_out).

A conv stage is a tuple ``(taps, stride, padding, pad_mode)`` with
``pad_mode`` 'zero' or 'reflect'.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from iinsvae_torch.ops.conv import conv1d, out_len
from iinsvae_torch.ops.kernels import _build
from iinsvae_torch.ops.norms import instance_norm

Stage = tuple[torch.Tensor, int, int, str]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _stage_rows(x: torch.Tensor, stages: Sequence[Stage]) -> tuple[list[int], int, int]:
    """Validate a conv chain on x (B, L, C); return the flat
    (k, stride, pad, reflect, l_in, c_in, l_out, c_out) rows and the
    chain's output (L, C)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got shape {tuple(x.shape)}")
    _, l, c = x.shape
    rows = []
    for taps, stride, padding, pad_mode in stages:
        if taps.dim() != 3 or taps.shape[1] != c:
            raise ValueError(f"taps {tuple(taps.shape)} do not take {c} input channels")
        if pad_mode not in ("zero", "reflect"):
            raise ValueError(f"pad_mode must be 'zero' or 'reflect', got {pad_mode!r}")
        k, _, c_out = taps.shape
        l_out = out_len(l, k, stride, padding)
        if l_out < 1 or stride < 1 or padding < 0 or (pad_mode == "reflect" and padding >= l):
            raise ValueError(f"conv k={k} s={stride} p={padding} does not fit length {l}")
        rows += [k, stride, padding, int(pad_mode == "reflect"), l, c, l_out, c_out]
        l, c = l_out, c_out
    return rows, l, c


# ------------------------------ K1 in_chain ------------------------------


def in_chain_ref(x: torch.Tensor, stages: Sequence[Stage], *,
                 residual: bool = False) -> torch.Tensor:
    """Plain version of K1: per stage conv (no bias) -> InstanceNorm -> ReLU;
    with ``residual`` the last stage adds the chain input instead of the ReLU."""
    y = x
    for i, (taps, stride, padding, pad_mode) in enumerate(stages):
        y = instance_norm(conv1d(y, taps, stride=stride, padding=padding, pad_mode=pad_mode))
        y = y + x if residual and i == len(stages) - 1 else torch.relu(y)
    return y


def in_chain(x: torch.Tensor, stages: Sequence[Stage], *, residual: bool = False) -> torch.Tensor:
    """K1: 1 or 2 conv -> IN -> ReLU stages in one launch, the mid-chain
    activation kept in shared memory (residual: the last stage adds x).

    Replaces fused_in_pair, fused_dense_layer(norm='in') and fused_res_block
    (iinsvae_tpu/ops/pallas/fused.py:361, :1320, :253)."""
    if x.device.type == "cpu":
        return in_chain_ref(x, stages, residual=residual)
    if not 1 <= len(stages) <= 2:
        raise ValueError(f"in_chain runs 1 or 2 stages, got {len(stages)}")
    rows, l_out, c_out = _stage_rows(x, stages)
    if residual and (len(stages) != 2 or (l_out, c_out) != tuple(x.shape[1:])):
        raise ValueError("a residual chain has two stages and keeps the input's shape")
    taps = [s[0] for s in stages]
    if any(t.shape[2] % 4 or t.data_ptr() % 16 for t in taps):
        raise ValueError("in_chain takes 16-byte aligned taps with C_out a multiple of 4")
    _build.require_cuda_f32("in_chain", x, *taps)
    b = x.shape[0]
    y = torch.empty((b, l_out, c_out), device=x.device, dtype=x.dtype)
    # the chain input plus each stage's output stay in shared memory
    per_sample = rows[4] * rows[5] + sum(rows[i + 6] * rows[i + 7] for i in range(0, len(rows), 8))
    spb = _build.samples_per_block(b, per_sample)
    fn = _build.function("in_chain", "iins_in_chain",
                         [_P, _P, _P, _P, _I, ctypes.POINTER(_I), _I, _I, _I, _P])
    err = fn(x.data_ptr(), taps[0].data_ptr(), taps[-1].data_ptr(), y.data_ptr(), b,
             (_I * len(rows))(*rows), len(stages), int(residual), spb, _build.stream_handle(x))
    _build.check(err, "in_chain", "in_chain")
    in_chain.launches += 1
    return y


in_chain.launches = 0


# --------------------------- K2 conv_bias_act ---------------------------


def conv_bias_act_ref(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, *,
                      stride: int = 1, padding: int = 0, pad_mode: str = "zero") -> torch.Tensor:
    """Plain version of K2: relu(conv1d(x, taps) + bias)."""
    return torch.relu(conv1d(x, taps, bias, stride=stride, padding=padding, pad_mode=pad_mode))


def conv_bias_act(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, *,
                  stride: int = 1, padding: int = 0, pad_mode: str = "zero") -> torch.Tensor:
    """K2: conv + per-channel bias + ReLU, no norm.

    Replaces fused_dense_layer(norm='none') (iinsvae_tpu/ops/pallas/fused.py:1320)."""
    if x.device.type == "cpu":
        return conv_bias_act_ref(x, taps, bias, stride=stride, padding=padding, pad_mode=pad_mode)
    y = launch_conv_bias_act(x, taps, bias, stride, padding, pad_mode)
    conv_bias_act.launches += 1
    return y


conv_bias_act.launches = 0


def launch_conv_bias_act(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                         stride: int, padding: int, pad_mode: str) -> torch.Tensor:
    """Check the operands and launch the conv + bias + ReLU kernel; counts
    nothing (K2 and K3 each count their own launches)."""
    rows, l_out, c_out = _stage_rows(x, [(taps, stride, padding, pad_mode)])
    if bias.shape != (c_out,):
        raise ValueError(f"bias must be ({c_out},), got {tuple(bias.shape)}")
    _build.require_cuda_f32("conv_bias_act", x, taps, bias)
    b = x.shape[0]
    y = torch.empty((b, l_out, c_out), device=x.device, dtype=x.dtype)
    spb = _build.samples_per_block(b, rows[4] * rows[5])
    fn = _build.function("in_chain", "iins_conv_bias_act",
                         [_P, _P, _P, _P, _I, ctypes.POINTER(_I), _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
             (_I * 8)(*rows), spb, _build.stream_handle(x))
    _build.check(err, "in_chain", "conv_bias_act")
    return y


# ------------------------------ K4 mlp_chain ------------------------------


def mlp_chain_ref(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                  slopes: Sequence[float]) -> torch.Tensor:
    """Plain version of K4: x (B, D0) through Dense + LeakyReLU(slope_j);
    slope 1.0 is linear."""
    for w, b, s in zip(ws, bs, slopes):
        x = x @ w + b
        if s != 1.0:
            x = torch.nn.functional.leaky_relu(x, s)
    return x


_MAX_LAYERS = 8


def mlp_chain(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
              slopes: Sequence[float]) -> torch.Tensor:
    """K4: the whole Dense + LeakyReLU chain in one launch.

    Replaces fused_mlp_chain (iinsvae_tpu/ops/pallas/fused.py:1164)."""
    if x.device.type == "cpu":
        return mlp_chain_ref(x, ws, bs, slopes)
    n = len(ws)
    if not (1 <= n <= _MAX_LAYERS and len(bs) == n and len(slopes) == n):
        raise ValueError(f"mlp_chain takes 1-{_MAX_LAYERS} layers with one bias and slope each")
    if x.dim() != 2:
        raise ValueError(f"x must be (B, D), got shape {tuple(x.shape)}")
    dims = [x.shape[1]]
    for w, b in zip(ws, bs):
        if w.dim() != 2 or w.shape[0] != dims[-1] or b.shape != (w.shape[1],):
            raise ValueError(f"layer {len(dims) - 1}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)} do not follow width {dims[-1]}")
        dims.append(w.shape[1])
    _build.require_cuda_f32("mlp_chain", x, *ws, *bs)
    y = torch.empty((x.shape[0], dims[-1]), device=x.device, dtype=x.dtype)
    fn = _build.function("mlp_chain", "iins_mlp_chain",
                         [_P, _P, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                          ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_float), _P])
    err = fn(x.data_ptr(), y.data_ptr(), x.shape[0], n,
             (_P * n)(*[w.data_ptr() for w in ws]), (_P * n)(*[b.data_ptr() for b in bs]),
             (_I * (n + 1))(*dims), (ctypes.c_float * n)(*slopes), _build.stream_handle(x))
    _build.check(err, "mlp_chain", "mlp_chain")
    mlp_chain.launches += 1
    return y


mlp_chain.launches = 0
