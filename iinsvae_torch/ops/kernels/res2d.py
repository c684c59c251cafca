"""K7 res_block_2d: the expanded 2-D model's residual block, wrapper and
plain version.

    y = x + N2(conv3x3(relu(N1(conv3x3(x, k1))), k2))

on x (B, 8, 8, 64) channels-last with (3, 3, C, C) taps, reflect pad 1 on
both axes and no conv bias (a per-channel bias before the norm is removed
by it, and its gradient is exactly 0). N is InstanceNorm over each sample's
8x8 field (the range encoder's blocks) or, with the four (B, C) tables
``affine = (gamma1, beta1, gamma2, beta2)``, AdaIN (the decoder's blocks).

Replaces fused_res_block_2d (iinsvae_tpu/ops/pallas/res2d.py:434). The
CUDA source is csrc/res_block_2d.cu (its backward K7b csrc/res_block_2d_bwd.cu,
backward.res_block_2d_bwd); it states the kernel's bound on the H100 and
what its design does about it. Both convs run on the tensor cores in
3xTF32 (csrc/mma_tf32.cuh), with partial sums and inputs centred per
(sample, channel) that keep the plain fp32 block's accuracy against
float64 (tests/test_torch_res2d_saved.py emulates it, tests/test_torch_gpu.py
checks it on the card). The wrapper runs the plain version on CPU
tensors (autograd differentiates it); on CUDA tensors it launches the
kernel, through autograd.ResBlock2d where a gradient is needed, or raises on
what the kernel does not take. Under autograd K7 also writes the pre-norm
conv outputs d1 = conv3x3(x, k1) and d2 = conv3x3(y1, k2), which K7b reads
instead of recomputing them (``save=True``); serving writes neither. The
TPU guard ``res2d.applicable`` (lane widths, the interpret-mode batch cap)
has no counterpart: on the card every block of the model's shape launches
K7.

bfloat16 (the 2-D model under ``--compute_dtype bfloat16``): the taps and
the AdaIN tables are cast to x's dtype, as fused_res_block_2d casts them
(iinsvae_tpu/ops/pallas/res2d.py:448-455), and the block computes what the
Pallas body computes on bfloat16 refs (:128-139, :176-198): x and y1 = relu(N1(d1)) are
rounded to bfloat16 as the convs' operands, the taps are bfloat16, the
products accumulate in fp32, the statistics are taken in fp32 from the
unrounded d1 and d2, and y, d1 and d2 are stored as bfloat16. Its kernel is
csrc/res_block_2d_bf16.cu (K7's bfloat16 instance: persistent blocks of two
warpgroups, both convs' taps staged once a block, wgmma m64n64k16), its
backward csrc/res_block_2d_bf16_bwd.cu (three launches: the input gradients,
the taps' gradient in clusters of four blocks, the sum of the partial rows);
under autograd both devices go
through autograd.ResBlock2d, whose backward is the bfloat16 closed form on
the CPU (backward.res_block_2d_bwd_bf16_ref), since the backward's own cast
points (gd1 and gd2 rounded to bfloat16 before the products, statistics
from the rounded saved d1 and d2) are not autograd of the forward.
"""

from __future__ import annotations

import ctypes

import torch

from iinsvae_torch.ops.conv import cast_like, conv2d
from iinsvae_torch.ops.kernels import _build
from iinsvae_torch.ops.kernels.fused import wants_grad
from iinsvae_torch.ops.norms import adain, instance_norm

# the only field the kernel takes: (8, 8) pixels of 64 channels
FIELD = (8, 8, 64)
# samples a block of K7, and a tile of K7b, owns (kSamples of csrc/res_block_2d.cuh; the
# float32 instances: the bfloat16 ones have their own, csrc/res_block_2d_bf16.cuh)
SAMPLES_PER_BLOCK = 2

_P = ctypes.c_void_p
_I = ctypes.c_int


def res_block_2d_ref(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                     *affine: torch.Tensor, save: bool = False):
    """Plain version of K7: dense reflect-pad conv2d, two-pass InstanceNorm
    (with the per-sample affine where ``affine`` is given), ReLU, the skip.
    -> y, or with ``save`` (y, d1, d2), the pre-norm conv outputs."""

    def norm(y, i):
        return adain(y, affine[2 * i], affine[2 * i + 1]) if affine else instance_norm(y)

    d1 = conv2d(x, k1, padding=1, pad_mode="reflect")
    d2 = conv2d(torch.relu(norm(d1, 0)), k2, padding=1, pad_mode="reflect")
    y = x + norm(d2, 1)
    return (y, d1, d2) if save else y


def edge_taps(k: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, C) bfloat16 taps -> (3, C, C): bf16(k[dh, 0] + k[dh, 2]), summed in fp32. At
    output columns 0 and 7 the W taps 0 and 2 read one column (1 or 6) under reflect pad 1, and
    the TPU kernel's lane-mix matrices (assemble_w3, res2d.py:69, assembled in x's dtype) hold
    that column's weight as this one rounded sum; the bfloat16 block takes it there too."""
    return (k[:, 0].float() + k[:, 2].float()).to(torch.bfloat16)


def _rows(x: torch.Tensor, dh: int) -> torch.Tensor:
    """x (B, 8, W, C) with row u replaced by row reflect(u + dh - 1)."""
    u = (torch.arange(8, device=x.device) + dh - 1).abs()
    return x[:, torch.where(u > 7, 14 - u, u)]


def conv3x3_bf16(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The bfloat16 block's conv: x (B, 8, 8, C) fp32 holding bfloat16 values, k bfloat16
    (3, 3, C, C) -> fp32 (B, 8, 8, C), reflect pad 1, fp32 products and sums; at the edge
    columns the W taps 0 and 2 act as one tap of weight edge_taps(k)."""
    kf, f = k.float(), edge_taps(k).float()
    d = conv2d(x, kf, padding=1, pad_mode="reflect")
    for v, src in ((0, 1), (7, 6)):
        d[:, :, v] = sum(_rows(x, dh)[:, :, v] @ kf[dh, 1] + _rows(x, dh)[:, :, src] @ f[dh]
                         for dh in range(3))
    return d


def res_block_2d_bf16_ref(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                          *affine: torch.Tensor, save: bool = False):
    """Plain version of K7's bfloat16 instance, on bfloat16 x, taps and tables: the convs
    (conv3x3_bf16) are fp32 products of bfloat16-valued operands (x, and y1 rounded to
    bfloat16), the InstanceNorm statistics two-pass in fp32 of the unrounded d1 and d2,
    y = x + N2(d2) rounded to bfloat16. -> y, or with ``save`` (y, d1, d2), d1 and d2 rounded
    to bfloat16."""
    xf = x.float()
    aff = [t.float() for t in affine]

    def norm(d, i):
        return adain(d, aff[2 * i], aff[2 * i + 1]) if aff else instance_norm(d)

    d1 = conv3x3_bf16(xf, k1)
    y1 = torch.relu(norm(d1, 0)).to(torch.bfloat16).float()
    d2 = conv3x3_bf16(y1, k2)
    y = (xf + norm(d2, 1)).to(torch.bfloat16)
    return (y, d1.to(torch.bfloat16), d2.to(torch.bfloat16)) if save else y


def res_block_2d(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                 *affine: torch.Tensor) -> torch.Tensor:
    """K7: one whole residual block in one launch. x (B, 8, 8, 64); k1, k2
    (3, 3, 64, 64); affine () for the IN block or (gamma1, beta1, gamma2,
    beta2), each (B, 64), for the AdaIN block. The taps and tables are cast
    to x's dtype (float32 or bfloat16)."""
    k1, k2 = cast_like(k1, x), cast_like(k2, x)
    affine = tuple(cast_like(t, x) for t in affine)
    if x.dtype == torch.bfloat16:
        if wants_grad(x, k1, k2, *affine):
            from iinsvae_torch.ops.kernels import autograd
            return autograd.ResBlock2d.apply(x, k1, k2, *affine)
        if x.device.type == "cpu":
            return res_block_2d_bf16_ref(x, k1, k2, *affine)
        return launch_res_block_2d(x, k1, k2, *affine)
    if x.device.type == "cpu":
        return res_block_2d_ref(x, k1, k2, *affine)
    if wants_grad(x, k1, k2, *affine):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.ResBlock2d.apply(x, k1, k2, *affine)
    return launch_res_block_2d(x, k1, k2, *affine)


def check_res_block_2d(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                       *affine: torch.Tensor) -> None:
    """Raise on what K7 (and its backward) does not take."""
    if x.dim() != 4 or tuple(x.shape[1:]) != FIELD or x.shape[0] < 1:
        raise ValueError(f"x must be (B, {', '.join(map(str, FIELD))}), got {tuple(x.shape)}")
    b, c = x.shape[0], FIELD[2]
    if k1.shape != (3, 3, c, c) or k2.shape != (3, 3, c, c):
        raise ValueError(f"taps must be (3, 3, {c}, {c}), got {tuple(k1.shape)}, "
                         f"{tuple(k2.shape)}")
    if len(affine) not in (0, 4) or any(t.shape != (b, c) for t in affine):
        raise ValueError(f"affine must be empty or four ({b}, {c}) tables")
    if any(t.data_ptr() % 16 for t in (x, k1, k2, *affine)):
        raise ValueError("res_block_2d takes 16-byte aligned tensors")
    _build.require_cuda("res_block_2d", x.dtype, x, k1, k2, *affine)


def forward_saved(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                  *affine: torch.Tensor):
    """-> (y, d1, d2) for autograd.ResBlock2d: K7's saving instance on the card, the plain
    version on the CPU (which autograd.ResBlock2d takes for bfloat16 only: float32 runs
    autograd through the plain ops there)."""
    if x.device.type == "cpu":
        ref = res_block_2d_bf16_ref if x.dtype == torch.bfloat16 else res_block_2d_ref
        return ref(x, k1, k2, *affine, save=True)
    return launch_res_block_2d(x, k1, k2, *affine, save=True)


def launch_res_block_2d(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                        *affine: torch.Tensor, save: bool = False):
    """Check the operands, launch K7 (its bfloat16 instance on bfloat16 operands) and count
    the launch. -> y, or with ``save`` (y, d1, d2): the same y, and the pre-norm conv outputs
    K7b reads."""
    check_res_block_2d(x, k1, k2, *affine)
    y = torch.empty_like(x)
    saved = (torch.empty_like(x), torch.empty_like(x)) if save else ()
    lib, name = ("res_block_2d_bf16", "iins_res_block_2d_bf16") if x.dtype == torch.bfloat16 \
        else ("res_block_2d", "iins_res_block_2d")
    fn = _build.function(lib, name, [_P] * 10 + [_I, _P])
    tables = [t.data_ptr() for t in affine] if affine else [None] * 4
    err = fn(x.data_ptr(), k1.data_ptr(), k2.data_ptr(), *tables, y.data_ptr(),
             *([t.data_ptr() for t in saved] if save else [None] * 2), x.shape[0],
             _build.stream_handle(x))
    _build.check(err, lib, "res_block_2d")
    if x.dtype == torch.bfloat16:
        res_block_2d.launches_bf16 += 1
    else:
        res_block_2d.launches += 1
    return (y, *saved) if save else y


res_block_2d.launches = 0
res_block_2d.launches_bf16 = 0  # the bfloat16 instance's launches
