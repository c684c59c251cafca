"""K1 in_chain, K2 conv_bias_act, K4 mlp_chain, K5 adain_res_block, K6
sln_chain and the one-stage decoder entries K8 adain_layer, K9 sln_layer and
K10 tanh_pool: wrappers and plain versions.

A wrapper runs the plain version on CPU tensors (autograd differentiates
it). On CUDA tensors it launches its kernel: through the kernel's
``torch.autograd.Function`` (autograd.py, whose backward launches the
backward kernel of backward.py) when grad mode is on and an input requires
grad, else directly, as under ``torch.inference_mode``.

The CUDA sources are csrc/in_chain.cu (K1, K2, K5, K8 and K3's kernel),
csrc/mlp_chain.cu (K4), csrc/sln_chain.cu (K6) and csrc/sln_layer.cu (K9,
K10); each states the TPU entry it replaces, its bound on the H100 and what
its design does about it. No model calls K8-K10: they are the counterparts
of the Pallas entries fused_adain_layer, fused_sln_layer and
fused_tanh_pool_layer.
Layouts are the JAX package's: activations (B, L, C), conv taps
(k, C_in, C_out), dense weights (D_in, D_out).

A conv stage is a tuple ``(taps, stride, padding, pad_mode)`` with
``pad_mode`` 'zero' or 'reflect'.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from iinsvae_torch.ops.conv import conv1d, out_len, upsample_nearest1d
from iinsvae_torch.ops.kernels import _build
from iinsvae_torch.ops.norms import adain, instance_norm, sample_layer_norm
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix

Stage = tuple[torch.Tensor, int, int, str]

_P = ctypes.c_void_p
_I = ctypes.c_int


def wants_grad(*tensors: torch.Tensor) -> bool:
    """True where the autograd Function has to carry a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def stage_rows(x: torch.Tensor, stages: Sequence[Stage]) -> tuple[list[int], int, int]:
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

# The model's residual block, which K1, K5 and their backward run on kernels of their own:
# (L, C) = (8, 64), two k3 stride-1 reflect-pad-1 convs (each stage's row as stage_rows gives it).
RES_L, RES_C = 8, 64
RES_STAGE = [3, 1, 1, 1, RES_L, RES_C, RES_L, RES_C]


# The range encoder's stride-2 chains at the flagship's shapes (csrc/down_chain.cuh), every stage
# conv -> IN -> ReLU, where K1 (csrc/in_chain.cu) and K1b (csrc/in_chain_bwd.cu) run kernels of
# their own (namespace down, one template instance a site), picked by the stage rows. K1b takes
# tiles of DOWN_TILE samples, at most one persistent block a SM (down_chain_plan); K1 tiles of 4
# or 2 (res_fwd_plan) and DOWN_FWD_SMEM[site, tile] bytes of shared memory a block, as the
# source lays them out. range.pair0's first stage reads the pooled CIR (reflect pad).
DOWN_TILE = 4
DOWN_SITES = {"range.pair0": [7, 1, 3, 1, 128, 1, 128, 4, 4, 2, 1, 0, 128, 4, 64, 8],
              "range.pair1": [4, 2, 1, 0, 64, 8, 32, 16, 4, 2, 1, 0, 32, 16, 16, 32],
              "range.single": [4, 2, 1, 0, 16, 32, 8, 64]}


def down_site(rows: Sequence[int]) -> str | None:
    """The stride-2 chain site whose stage rows these are, or None."""
    return next((k for k, v in DOWN_SITES.items() if v == list(rows)), None)


def down_chain_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of K1b's stride-2 chains' path: block j of the grid takes tiles j,
    j + blocks, ..., tile t the samples t * DOWN_TILE .. (t + 1) * DOWN_TILE - 1 below batch."""
    tiles = -(-batch // DOWN_TILE)
    return tiles, min(tiles, sms)


def down_fwd_floats(rows: Sequence[int], tile: int) -> int:
    """Floats of shared memory a block of K1's stride-2 chains' path takes for 1 or 2 stage rows
    at tiles of ``tile`` samples: each stage's taps (rows of C_out + 4 floats) and, per sample,
    each stage's input with its pad rows (rows of C_in + 4 floats, or C_in where that is not a
    multiple of 4) and its conv output between two rows (rows of C_out + 4)."""
    n = 0
    for j in range(0, len(rows), 8):
        k, _, pad, _, l_in, c_in, l_out, c_out = rows[j:j + 8]
        ld_in = c_in if c_in % 4 else c_in + 4
        n += k * c_in * (c_out + 4) + tile * ((l_in + 2 * pad) * ld_in + (l_out + 2) * (c_out + 4))
    return n


DOWN_FWD_SMEM = {(name, t): 4 * down_fwd_floats(rows, t) for name, rows in DOWN_SITES.items()
                 for t in (2, 4)}


def res_fwd_plan(batch: int, sms: int) -> tuple[int, int, int]:
    """-> (tile, tiles, blocks) of K1's and K5's forward kernels at the residual blocks, of K1's
    at the stride-2 chains and of K2's at its call sites: tiles of 4 samples, or of 2 where tiles
    of 4 would leave more than half the SMs without one; block j of the grid takes tiles j,
    j + blocks, ..., tile t the samples t * tile .. (t + 1) * tile - 1 below batch."""
    tile = 4 if -(-batch // 4) > sms // 2 else 2
    tiles = -(-batch // tile)
    return tile, tiles, min(tiles, sms)


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
    activation kept in shared memory (residual: the last stage adds x; the
    model's residual block at (8, 64) runs a kernel of its own).

    Replaces fused_in_pair, fused_dense_layer(norm='in') and fused_res_block
    (iinsvae_tpu/ops/pallas/fused.py:361, :1320, :253)."""
    if x.device.type == "cpu":
        return in_chain_ref(x, stages, residual=residual)
    taps = [s[0] for s in stages]
    if wants_grad(x, *taps):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.InChain.apply(x, tuple(s[1:] for s in stages), residual, *taps)
    return launch_in_chain(x, stages, residual)


def launch_in_chain(x: torch.Tensor, stages: Sequence[Stage], residual: bool, *,
                    general: bool = False) -> torch.Tensor:
    """Check the operands, launch K1 and count the launch. The residual block at (8, 64) runs
    its own kernel (_res_block), the range encoder's stride-2 chains (DOWN_SITES) theirs
    (_down_chain); ``general`` runs the general kernel there instead, the second oracle of the
    GPU tests and chip_smoke.py."""
    if not 1 <= len(stages) <= 2:
        raise ValueError(f"in_chain runs 1 or 2 stages, got {len(stages)}")
    rows, l_out, c_out = stage_rows(x, stages)
    if residual and (len(stages) != 2 or (l_out, c_out) != tuple(x.shape[1:])):
        raise ValueError("a residual chain has two stages and keeps the input's shape")
    taps = [s[0] for s in stages]
    if any(t.shape[2] % 4 or t.data_ptr() % 16 for t in taps):
        raise ValueError("in_chain takes 16-byte aligned taps with C_out a multiple of 4")
    _build.require_cuda_f32("in_chain", x, *taps)
    if residual and not general and rows == 2 * RES_STAGE:
        y = _res_block("in_chain", x, *taps, None)
        in_chain.launches += 1
        return y
    down = None if residual or general else down_site(rows)
    if down is not None:
        y = _down_chain(x, taps, down)
        in_chain.launches += 1
        return y
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


def _down_chain(x: torch.Tensor, taps: Sequence[torch.Tensor], name: str) -> torch.Tensor:
    """Launch K1's kernel at the stride-2 chain ``name`` (csrc/in_chain.cu's namespace down) on
    the grid of res_fwd_plan; counts nothing (the caller counts)."""
    if x.data_ptr() % 16:
        raise ValueError("in_chain: the range chains' kernel takes a 16-byte aligned x")
    rows = DOWN_SITES[name]
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, _, blocks = res_fwd_plan(b, sms)
    y = torch.empty((b, rows[-2], rows[-1]), device=x.device, dtype=x.dtype)
    fn = _build.function("in_chain", "iins_down_chain", [_P] * 4 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps[0].data_ptr(), taps[-1].data_ptr(), y.data_ptr(), b,
             list(DOWN_SITES).index(name), tile, blocks, DOWN_FWD_SMEM[name, tile],
             _build.stream_handle(x))
    _build.check(err, "in_chain", "in_chain")
    return y


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
    if wants_grad(x, taps, bias):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.ConvBiasAct.apply(x, taps, bias, (stride, padding, pad_mode))
    y = launch_conv_bias_act(x, taps, bias, stride, padding, pad_mode)
    conv_bias_act.launches += 1
    return y


conv_bias_act.launches = 0


# K2's and K2b's call sites in the 1-D model, by their stage rows: the range encoder's 1x1
# out-conv, the env encoder's k7 reflect in-conv and the decoder's 1x1 in-conv. K2 runs them on
# a kernel of its own (csrc/in_chain.cu, namespace cba, one template instance a site): tiles of
# 4 or 2 samples, at most one persistent block a SM (res_fwd_plan), CBA_FWD_SMEM[site, tile]
# bytes of shared memory a block (two buffers of the tile's x), as the source lays them out.
# K2b's site kernel (backward.cba_site) takes the same rows, env.in without dx.
CBA_SITES = {"range.out": [1, 1, 0, 0, 8, 64, 8, 2],
             "env.in": [7, 1, 3, 1, 128, 1, 128, 16],
             "dec.in": [1, 1, 0, 0, 8, 2, 8, 64]}


def cba_site(rows: Sequence[int]) -> str | None:
    """The K2 call site whose stage row this is, or None."""
    return next((k for k, v in CBA_SITES.items() if v == list(rows)), None)


def cba_fwd_floats(rows: Sequence[int], tile: int) -> int:
    """Floats of shared memory a block of K2's site kernel takes for a stage row at tiles of
    ``tile`` samples: two buffers, each sample's x with its pad rows in rows of C_in + 4 floats
    (C_in where that is not a multiple of 4), the data rows 16-byte aligned, the sample rounded
    up to 4 floats."""
    _, _, pad, _, l_in, c_in, _, _ = rows
    ld = c_in if c_in % 4 else c_in + 4
    return 2 * tile * _round4(_round4(pad * ld) + (l_in + pad) * ld)


CBA_FWD_SMEM = {(name, t): 4 * cba_fwd_floats(rows, t) for name, rows in CBA_SITES.items()
                for t in (2, 4)}


def _cba_site(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, name: str) -> torch.Tensor:
    """Launch K2's kernel at the call site ``name`` (csrc/in_chain.cu's namespace cba) on the grid
    of res_fwd_plan; counts nothing (the callers count)."""
    if any(t.data_ptr() % 16 for t in (x, taps, bias)):
        raise ValueError("conv_bias_act: the call sites' kernel takes 16-byte aligned x, taps and "
                         "bias")
    rows = CBA_SITES[name]
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, _, blocks = res_fwd_plan(b, sms)
    y = torch.empty((b, rows[6], rows[7]), device=x.device, dtype=x.dtype)
    fn = _build.function("in_chain", "iins_cba_fwd", [_P] * 4 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
             list(CBA_SITES).index(name), tile, blocks, CBA_FWD_SMEM[name, tile],
             _build.stream_handle(x))
    _build.check(err, "in_chain", "conv_bias_act")
    return y


def launch_conv_bias_act(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                         stride: int, padding: int, pad_mode: str, *,
                         general: bool = False) -> torch.Tensor:
    """Check the operands and launch the conv + bias + ReLU kernel; counts nothing
    (conv_bias_act and autograd.ConvBiasAct count). The call sites (CBA_SITES) run their own
    kernel (_cba_site); ``general`` runs the general kernel there instead, the second oracle of
    the GPU tests and chip_smoke.py."""
    rows, l_out, c_out = stage_rows(x, [(taps, stride, padding, pad_mode)])
    if bias.shape != (c_out,):
        raise ValueError(f"bias must be ({c_out},), got {tuple(bias.shape)}")
    _build.require_cuda_f32("conv_bias_act", x, taps, bias)
    site = None if general else cba_site(rows)
    if site is not None:
        return _cba_site(x, taps, bias, site)
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


def mlp_chain_bf16_ref(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                       slopes: Sequence[float], save_pre: bool = False):
    """Plain version of K4's bfloat16 instance (fused.py:1072-1084): bfloat16 x, weights and
    biases read as fp32; the chain runs in fp32 between layers (y is not rounded), each
    pre-activation d_j and the output are stored as bfloat16. -> y, or with ``save_pre``
    (y, [d_j])."""
    y, ds = x.float(), []
    for w, b, s in zip(ws, bs, slopes):
        d = y @ w.float() + b.float()
        ds.append(d.to(torch.bfloat16))
        y = d if s == 1.0 else torch.nn.functional.leaky_relu(d, s)
    y = y.to(torch.bfloat16)
    return (y, ds) if save_pre else y


def mlp_chain(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
              slopes: Sequence[float]) -> torch.Tensor:
    """K4: the whole Dense + LeakyReLU chain in one launch.

    Replaces fused_mlp_chain (iinsvae_tpu/ops/pallas/fused.py:1164). On
    bfloat16 x, weights and biases it runs K4's bfloat16 instance (the
    cluster and head kernels of csrc/mlp_chain.cu on bfloat16 storage; plain
    version mlp_chain_bf16_ref); under
    autograd both devices go through autograd.MlpChain, whose backward is
    K4b's bfloat16 instance on the card and its closed form on the CPU
    (backward.mlp_chain_bwd_bf16_ref): the Pallas backward recomputes the
    chain from the bfloat16 d_j, which autograd of the forward would not."""
    if x.dtype == torch.bfloat16:
        if wants_grad(x, *ws, *bs):
            from iinsvae_torch.ops.kernels import autograd
            return autograd.MlpChain.apply(x, tuple(slopes), len(ws), *ws, *bs)
        if x.device.type == "cpu":
            return mlp_chain_bf16_ref(x, ws, bs, slopes)
        return launch_mlp_chain(x, ws, bs, slopes)[0]
    if x.device.type == "cpu":
        return mlp_chain_ref(x, ws, bs, slopes)
    if wants_grad(x, *ws, *bs):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.MlpChain.apply(x, tuple(slopes), len(ws), *ws, *bs)
    return launch_mlp_chain(x, ws, bs, slopes)[0]


# K4's path at the restorers (csrc/mlp_chain.cu, namespace cluster): widths D0 -> 512 -> 256 ->
# 256 -> D4 with D0 a multiple of 16 up to 128 (the 1-D and column-image restorers' 16, the 2-D
# one's 128) and D4 1, or 2 for the soft restorers' (mu, logvar). A cluster of MLP_CLUSTER blocks
# takes a tile of samples, each block 1 / MLP_CLUSTER of every layer's output columns
# (mlp_cluster_columns), with those columns' weights in shared memory.
MLP_CLUSTER = 8
MLP_CLUSTER_WIDTHS = (512, 256, 256)  # the widths after D0, then D4
MLP_CLUSTER_LAST = (1, 2)  # D4: the kernel's template instances
MLP_CLUSTER_TILE = 12  # samples a tile: 12, 24 or 36
MLP_CLUSTER_WHOLE_L0 = 16  # up to this many inputs layer 0 runs whole in every block


def takes_mlp_cluster(dims: Sequence[int]) -> bool:
    """Whether a chain of the widths ``dims`` runs K4's restorer path."""
    return (len(dims) == 5 and tuple(dims[1:4]) == MLP_CLUSTER_WIDTHS
            and dims[4] in MLP_CLUSTER_LAST and dims[0] % 16 == 0 and 16 <= dims[0] <= 128)


def mlp_cluster_columns(dims: Sequence[int]) -> list[list[tuple[int, int]]]:
    """-> per layer, each block rank's [start, end) of the layer's output columns; at the last
    layer (one or two columns) each rank's rows of the weight, the partial dot products it
    sums."""
    out = []
    for j, d in enumerate(dims[1:]):
        n = (d if j < len(dims) - 2 else dims[-2]) // MLP_CLUSTER
        out.append([(r * n, (r + 1) * n) for r in range(MLP_CLUSTER)])
    return out


def mlp_cluster_smem(d0: int, tile: int) -> int:
    """Bytes of shared memory a block of K4's restorer path takes, as the source lays them out
    (the same for either last width D4): its slices of W1 and W2 in rows of 36 floats, W3's 32
    rows of up to 2, room for all of b0, its 32 of b1 and of b2, and b3; the layer input (512,
    tile) in rows of tile (+ 4 where tile is a multiple of 8) floats, which first holds x (d0,
    tile) and its slice of W0 in rows of 68; the split products' partial sums (12 a thread of
    384); its outputs of layers 0 and 1 in rows of the same length; every block's partial dot
    products (8, up to 2, tile); room for 18 8-byte mbarriers."""
    d1, d2, d3 = MLP_CLUSTER_WIDTHS
    c, d4 = MLP_CLUSTER, max(MLP_CLUSTER_LAST)
    weights = d1 * (d2 // c + 4) + d2 * (d3 // c + 4) + d3 // c * d4 + d1 + (d2 + d3) // c + 4
    row = tile if tile % 8 else tile + 4
    act = max(d1 * row, d0 * (row + d1 // c + 4))
    return 4 * (weights + act + 12 * 384 + (d1 + d2) // c * row + c * d4 * tile + 4 * c + 4)


def mlp_cluster_plan(batch: int, d0: int, slots: int) -> tuple[int, int, int, int]:
    """-> (tile, tiles, clusters, smem) of K4's restorer path: cluster c takes the tiles c,
    c + clusters, ..., tile t the samples t * tile .. (t + 1) * tile - 1 below batch. The tile is
    the least of 12, 24 and 36 samples with which the ``slots`` clusters the card holds at once
    take the batch in one round, else 36; at most ``slots`` clusters."""
    t = MLP_CLUSTER_TILE
    tile = min(3 * t, t * -(-batch // (t * slots)))
    tiles = -(-batch // tile)
    return tile, tiles, min(tiles, slots), mlp_cluster_smem(d0, tile)


_cluster_slots: dict[tuple[int, int], int] = {}


def mlp_cluster_slots(device: torch.device, d0: int) -> int:
    """The clusters of K4's restorer path that the card holds at once (at the largest tile's
    shared memory), asked of the CUDA runtime once a device and D0."""
    key = (device.index if device.index is not None else torch.cuda.current_device(), d0)
    if key not in _cluster_slots:
        n = ctypes.c_int(0)
        fn = _build.function("mlp_chain", "iins_mlp_cluster_slots", [_I, ctypes.POINTER(_I)])
        with torch.cuda.device(key[0]):
            _build.check(fn(mlp_cluster_smem(d0, 3 * MLP_CLUSTER_TILE), ctypes.byref(n)),
                         "mlp_chain", "mlp_chain cluster occupancy")
        if n.value < 1:
            raise RuntimeError("mlp_chain: the card holds no cluster of the restorer path")
        _cluster_slots[key] = n.value
    return _cluster_slots[key]


# K4's path at the small heads (csrc/mlp_chain.cu, namespace head): chains whose every width is
# at most MLP_HEAD_WIDTH (the classifier 16 -> 16 -> 32 -> 16 -> 5), a warp a sample, tiles of
# MLP_HEAD_TILE samples, at most one persistent block a SM (mlp_head_plan), every layer's weights
# and biases in mlp_head_smem(dims) bytes of shared memory a block.
MLP_HEAD_WIDTH, MLP_HEAD_TILE = 64, 8


def takes_mlp_head(dims: Sequence[int]) -> bool:
    """Whether a chain of the widths ``dims`` runs K4's small-head path."""
    return 1 <= len(dims) - 1 <= _MAX_LAYERS and max(dims) <= MLP_HEAD_WIDTH


def mlp_head_smem(dims: Sequence[int]) -> int:
    """Bytes of shared memory a block of K4's small-head path takes: each layer's weight, then
    its bias, each rounded up to 4 floats, then each warp's two activation rows of
    MLP_HEAD_WIDTH floats, as the source lays them out."""
    return 4 * (sum(_round4(a * k) + _round4(k) for a, k in zip(dims, dims[1:]))
                + MLP_HEAD_TILE * 2 * MLP_HEAD_WIDTH)


def mlp_head_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of K4's small-head path: block j of the grid takes tiles j, j + blocks,
    ..., tile t the samples t * MLP_HEAD_TILE .. (t + 1) * MLP_HEAD_TILE - 1 below batch, one a
    warp."""
    tiles = -(-batch // MLP_HEAD_TILE)
    return tiles, min(tiles, sms)


def launch_mlp_chain(x: torch.Tensor, ws: Sequence[torch.Tensor], bs: Sequence[torch.Tensor],
                     slopes: Sequence[float], save_pre: bool = False, *, general: bool = False):
    """Check the operands, launch K4 and count the launch. -> (y, ds): with
    ``save_pre`` the kernel also writes each layer's pre-activation
    d_j (B, D_{j+1}), which the backward kernel reads; else ds is []. The restorers' widths
    (takes_mlp_cluster) run the cluster kernel (mlp_cluster_plan), the small heads'
    (takes_mlp_head) the head kernel (mlp_head_plan), any other the general one; ``general``
    runs the general kernel at any widths, the second oracle of the GPU tests and
    chip_smoke.py. bfloat16 operands run the bfloat16 instances of the cluster and head kernels
    (the same plans; the general kernel has none: other widths raise)."""
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
    _build.require_cuda("mlp_chain", x.dtype, x, *ws, *bs)
    y = torch.empty((x.shape[0], dims[-1]), device=x.device, dtype=x.dtype)
    ds = [torch.empty((x.shape[0], d), device=x.device, dtype=x.dtype)
          for d in dims[1:]] if save_pre else []
    bf16 = x.dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    if bf16 and (general or not (takes_mlp_head(dims) or takes_mlp_cluster(dims))):
        raise ValueError(f"mlp_chain: the bfloat16 instance takes the small heads' and the "
                         f"restorers' widths, not {dims}")
    layers = ((_P * n)(*[w.data_ptr() for w in ws]), (_P * n)(*[b.data_ptr() for b in bs]),
              (_I * (n + 1))(*dims), (ctypes.c_float * n)(*slopes),
              (_P * n)(*[d.data_ptr() for d in ds]) if save_pre else None)
    if not general and takes_mlp_head(dims):
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, blocks = mlp_head_plan(x.shape[0], sms)
        fn = _build.function("mlp_chain", "iins_mlp_head" + suffix,
                             [_P, _P, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                              ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_float),
                              ctypes.POINTER(_P), _I, _I, _I, _P])
        err = fn(x.data_ptr(), y.data_ptr(), x.shape[0], n, *layers, MLP_HEAD_TILE, blocks,
                 mlp_head_smem(dims), _build.stream_handle(x))
        _build.check(err, "mlp_chain", "mlp_chain")
        _count_mlp_chain(bf16)
        return y, ds
    if not general and takes_mlp_cluster(dims):
        if any(t.data_ptr() % 16 for t in (x, *ws, *bs[:-1])):
            raise ValueError("mlp_chain: the restorer path takes 16-byte aligned x, weights and "
                             "biases")
        tile, _, clusters, smem = mlp_cluster_plan(x.shape[0], dims[0],
                                                   mlp_cluster_slots(x.device, dims[0]))
        fn = _build.function("mlp_chain", "iins_mlp_cluster" + suffix,
                             [_P, _P, _I, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                              ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_P), _I, _I, _I, _P])
        w_ptrs, b_ptrs, _, slopes_c, d_ptrs = layers
        err = fn(x.data_ptr(), y.data_ptr(), x.shape[0], dims[0], dims[-1], w_ptrs, b_ptrs,
                 slopes_c, d_ptrs, tile, clusters, smem, _build.stream_handle(x))
        _build.check(err, "mlp_chain", "mlp_chain")
        _count_mlp_chain(bf16, soft=dims[-1] == 2)
        return y, ds
    fn = _build.function("mlp_chain", "iins_mlp_chain",
                         [_P, _P, _I, _I, ctypes.POINTER(_P), ctypes.POINTER(_P),
                          ctypes.POINTER(_I), ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_P),
                          _P])
    err = fn(x.data_ptr(), y.data_ptr(), x.shape[0], n, *layers, _build.stream_handle(x))
    _build.check(err, "mlp_chain", "mlp_chain")
    mlp_chain.launches += 1
    return y, ds


mlp_chain.launches = 0
mlp_chain.launches_bf16 = 0  # the bfloat16 instance's launches
# of K4's and K4b's launches, those at the soft restorer (the cluster kernel's widths with a last
# width of 2), fp32 and bfloat16, under the names kernels.soft_launch_counts gives them
SOFT_LAUNCHES = dict.fromkeys(("mlp_chain_soft", "mlp_chain_bf16_soft", "mlp_chain_bwd_soft",
                               "mlp_chain_bwd_bf16_soft"), 0)


def count_soft(wrapper: str, bf16: bool) -> None:
    SOFT_LAUNCHES[wrapper + ("_bf16" if bf16 else "") + "_soft"] += 1


def _count_mlp_chain(bf16: bool, soft: bool = False) -> None:
    if bf16:
        mlp_chain.launches_bf16 += 1
    else:
        mlp_chain.launches += 1
    if soft:
        count_soft("mlp_chain", bf16)


# --------------------------- K5 adain_res_block ---------------------------


def adain_res_block_ref(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                        g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor,
                        b2: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: x + adain(conv(relu(adain(conv(x, k1), g1, b1)), k2), g2, b2),
    both convs k3 reflect pad 1 without bias."""
    y = torch.relu(adain(conv1d(x, k1, padding=1, pad_mode="reflect"), g1, b1))
    return x + adain(conv1d(y, k2, padding=1, pad_mode="reflect"), g2, b2)


def adain_res_block(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                    g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """K5: the decoder's AdaIN residual block in one launch (at the model's
    (8, 64) the residual block's own kernel, else K1's general kernel, each
    with a per-sample affine after each InstanceNorm). x (B, L, C); k1, k2
    (3, C, C); g1, b1, g2, b2 (B, C), contiguous.

    Replaces fused_adain_res_block (iinsvae_tpu/ops/pallas/fused.py:557)."""
    if x.device.type == "cpu":
        return adain_res_block_ref(x, k1, k2, g1, b1, g2, b2)
    if wants_grad(x, k1, k2, g1, b1, g2, b2):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.AdainResBlock.apply(x, k1, k2, g1, b1, g2, b2)
    return launch_adain_res_block(x, k1, k2, g1, b1, g2, b2)


def check_adain_res_block(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                          *affine: torch.Tensor) -> None:
    """Raise on what K5 (and its backward) does not take."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got shape {tuple(x.shape)}")
    b, l, c = x.shape
    if k1.shape != (3, c, c) or k2.shape != (3, c, c):
        raise ValueError(f"taps must be (3, {c}, {c}), got {tuple(k1.shape)}, {tuple(k2.shape)}")
    if any(t.shape != (b, c) for t in affine):
        raise ValueError(f"gamma and beta must each be ({b}, {c})")
    if c % 4 or k1.data_ptr() % 16 or k2.data_ptr() % 16 or l < 2:
        raise ValueError("adain_res_block takes 16-byte aligned taps, C a multiple of 4, L >= 2")
    _build.require_cuda_f32("adain_res_block", x, k1, k2, *affine)


def launch_adain_res_block(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
                           g1: torch.Tensor, b1: torch.Tensor, g2: torch.Tensor,
                           b2: torch.Tensor, *, general: bool = False) -> torch.Tensor:
    """Check the operands, launch K5 and count the launch. At (L, C) = (8, 64) it runs the
    residual block's own kernel (_res_block); ``general`` runs K1's general kernel there
    instead, the second oracle of the GPU tests and chip_smoke.py."""
    check_adain_res_block(x, k1, k2, g1, b1, g2, b2)
    b, l, c = x.shape
    if not general and (l, c) == (RES_L, RES_C):
        y = _res_block("adain_res_block", x, k1, k2, (g1, b1, g2, b2))
        adain_res_block.launches += 1
        return y
    y = torch.empty_like(x)
    spb = _build.samples_per_block(b, 3 * l * c)  # input, mid-block and output in shared memory
    fn = _build.function("in_chain", "iins_adain_res_block",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    err = fn(x.data_ptr(), k1.data_ptr(), k2.data_ptr(), g1.data_ptr(), b1.data_ptr(),
             g2.data_ptr(), b2.data_ptr(), y.data_ptr(), b, l, c, spb, _build.stream_handle(x))
    _build.check(err, "in_chain", "adain_res_block")
    adain_res_block.launches += 1
    return y


adain_res_block.launches = 0


def _res_block(what: str, x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
               tables: Sequence[torch.Tensor] | None) -> torch.Tensor:
    """Launch K1's (tables None) or K5's (tables g1, b1, g2, b2) residual-block kernel at
    (8, 64), csrc/in_chain.cu's namespace res, on the grid of res_fwd_plan; counts
    nothing (the caller counts)."""
    from iinsvae_torch.ops.kernels import backward
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: the residual block's kernel takes a 16-byte aligned x")
    b = x.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, _, blocks = res_fwd_plan(b, sms)
    y = torch.empty_like(x)
    fn = _build.function("in_chain", "iins_res_block", [_P] * 8 + [_I] * 6 + [_P])
    err = fn(x.data_ptr(), k1.data_ptr(), k2.data_ptr(),
             *((t.data_ptr() for t in tables) if tables else (None,) * 4), y.data_ptr(), b,
             RES_L, RES_C, tile, blocks, backward.RES_FWD_SMEM[tile],
             _build.stream_handle(x))
    _build.check(err, "in_chain", what)
    return y


# ------------------------------ K6 sln_chain ------------------------------

# one up-stage: (taps (5, C, C/2), conv bias, gamma, beta (C/2,) each)
UpStage = tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
SLN_STAGES = 4  # the 1-D decoder's n_upsample; the kernel takes no other count


def sln_chain_ref(x: torch.Tensor, stages: Sequence[UpStage], out_kernel: torch.Tensor,
                  out_bias: torch.Tensor, l_pool: int,
                  pool: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K6: per stage x2 upsample -> conv k5 zero pad 2 +
    bias -> sample_layer_norm -> ReLU; then tanh(conv k7 reflect pad 3 +
    bias) (C_out 1) and the adaptive average pool to l_pool: (B, l_pool).
    ``pool`` is that pool's (L_last, l_pool) matrix when the caller holds
    one; else it is built here."""
    for taps, bias, gamma, beta in stages:
        x = conv1d(upsample_nearest1d(x, 2), taps, bias, padding=2)
        x = torch.relu(sample_layer_norm(x, gamma, beta))
    x = torch.tanh(conv1d(x, out_kernel, out_bias, padding=3, pad_mode="reflect"))
    x = x.reshape(x.shape[0], -1)
    if pool is None:
        pool = adaptive_avg_pool_matrix(x.shape[1], l_pool, device=x.device, dtype=x.dtype)
    elif pool.shape != (x.shape[1], l_pool):
        raise ValueError(f"pool must be ({x.shape[1]}, {l_pool}), got {tuple(pool.shape)}")
    return x @ pool


def sln_chain(x: torch.Tensor, stages: Sequence[UpStage], out_kernel: torch.Tensor,
              out_bias: torch.Tensor, l_pool: int) -> torch.Tensor:
    """K6: the decoder tail (x (B, L, C) -> (B, l_pool)) in one launch,
    every stage's activation kept in shared memory.

    Replaces fused_sln_chain (iinsvae_tpu/ops/pallas/fused.py:1027)."""
    if x.device.type == "cpu":
        return sln_chain_ref(x, stages, out_kernel, out_bias, l_pool)
    params = [t for st in stages for t in st] + [out_kernel, out_bias]
    if wants_grad(x, *params):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.SlnChain.apply(x, l_pool, *params)
    return launch_sln_chain(x, stages, out_kernel, out_bias, l_pool)


def check_sln_chain(x: torch.Tensor, stages: Sequence[UpStage], out_kernel: torch.Tensor,
                    out_bias: torch.Tensor, l_pool: int) -> None:
    """Raise on what K6 (and its backward) does not take."""
    if len(stages) != SLN_STAGES:
        raise ValueError(f"sln_chain runs the decoder's {SLN_STAGES} stages, got {len(stages)}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got shape {tuple(x.shape)}")
    b, l0, c0 = x.shape
    c = c0
    for j, (taps, bias, gamma, beta) in enumerate(stages):
        half = (c // 2,)
        if taps.shape != (5, c, c // 2) or not bias.shape == gamma.shape == beta.shape == half:
            raise ValueError(f"stage {j}: taps {tuple(taps.shape)} must be (5, {c}, {c // 2}) "
                             f"and bias, gamma, beta ({c // 2},)")
        c //= 2
    if out_kernel.shape != (7, c, 1) or out_bias.shape != (1,):
        raise ValueError(f"out conv must be (7, {c}, 1) with bias (1,), got "
                         f"{tuple(out_kernel.shape)}, {tuple(out_bias.shape)}")
    if c0 % (4 << SLN_STAGES) or l0 * c0 > 2048 or l_pool < 1:
        raise ValueError(f"sln_chain takes C a multiple of {4 << SLN_STAGES} and L*C <= 2048, "
                         f"got ({l0}, {c0}) -> {l_pool}")
    if any(st[0].data_ptr() % 16 for st in stages):
        raise ValueError("sln_chain takes 16-byte aligned taps")
    _build.require_cuda_f32("sln_chain", x, *(t for st in stages for t in st), out_kernel,
                            out_bias)


# K6's and K6b's path at the decoder's shape (csrc/sln_chain.cu's and csrc/sln_chain_bwd.cu's
# namespace tail, on csrc/sln_tail.cuh): input (8, 64), four up-stages to (128, 4); tiles of
# SLN_TAIL_TILE samples, at most one persistent block a SM (sln_tail_plan); the forward's
# SLN_TAIL_FWD_SMEM bytes of shared memory a block, as the source lays them out (K6b's
# backward.SLN_TAIL_SMEM goes on after them).
SLN_TAIL_L, SLN_TAIL_C, SLN_TAIL_TILE = 8, 64, 4


def sln_tail_fwd_floats() -> int:
    """Floats of shared memory a block of the tail path's forward takes."""
    ls = [SLN_TAIL_L << j for j in range(SLN_STAGES)]  # stage j: (ls[j], cs[j]) -> x2 rows, C / 2
    cs = [SLN_TAIL_C >> j for j in range(SLN_STAGES)]
    # the taps in rows of C_out + 4 floats (C_out >= 8), the out conv's 28 (32 kept)
    taps = sum(5 * c * (c // 2 + 4 if c // 2 >= 8 else c // 2) for c in cs) + 32
    # per sample: each stage's input with a zero row above and below (rows of C + 4), the out
    # conv's input (128, 4), each conv output with two zero rows above and below, each 4 floats
    # longer; then the LayerNorm statistics, 4 floats a stage and sample
    acts = sum((l + 2) * (c + 4) + 4 for l, c in zip(ls, cs)) + 2 * ls[-1] * (cs[-1] // 2) + 4
    zs = sum((2 * l + 4) * (c // 2) + 4 for l, c in zip(ls, cs))
    return taps + SLN_TAIL_TILE * (acts + zs) + SLN_STAGES * SLN_TAIL_TILE * 4


SLN_TAIL_FWD_SMEM = 4 * sln_tail_fwd_floats()


def sln_tail_plan(batch: int, sms: int) -> tuple[int, int]:
    """-> (tiles, blocks) of the tail path: block j of the grid takes tiles j, j + blocks, ...,
    tile t the samples t * SLN_TAIL_TILE .. (t + 1) * SLN_TAIL_TILE - 1 below batch."""
    tiles = -(-batch // SLN_TAIL_TILE)
    return tiles, min(tiles, sms)


def launch_sln_chain(x: torch.Tensor, stages: Sequence[UpStage], out_kernel: torch.Tensor,
                     out_bias: torch.Tensor, l_pool: int, *, general: bool = False) -> torch.Tensor:
    """Check the operands, launch K6 and count the launch. The decoder's shape, input (8, 64),
    runs the tail kernel (sln_tail_plan); ``general`` runs the general kernel there instead,
    the second oracle of the GPU tests and chip_smoke.py."""
    check_sln_chain(x, stages, out_kernel, out_bias, l_pool)
    b, l0, c0 = x.shape
    y = torch.empty((b, l_pool), device=x.device, dtype=x.dtype)
    head = [_P, _P, _I] + [ctypes.POINTER(_P)] * 4 + [_I, _I, _P, _P, _I]
    if not general and (l0, c0) == (SLN_TAIL_L, SLN_TAIL_C):
        if x.data_ptr() % 16:
            raise ValueError("sln_chain: the tail kernel takes a 16-byte aligned x")
        sms = torch.cuda.get_device_properties(x.device).multi_processor_count
        _, blocks = sln_tail_plan(b, sms)
        fn = _build.function("sln_chain", "iins_sln_tail", head + [_I, _I, _I, _P])
        plan = (SLN_TAIL_TILE, blocks, SLN_TAIL_FWD_SMEM)
    else:
        fn = _build.function("sln_chain", "iins_sln_chain", head + [_I, _P])
        plan = (_build.samples_per_block(b, 2 * l0 * c0),)  # two ping-pong buffers a sample
    ptrs = [(_P * SLN_STAGES)(*[st[i].data_ptr() for st in stages]) for i in range(4)]
    err = fn(x.data_ptr(), y.data_ptr(), b, *ptrs, l0, c0, out_kernel.data_ptr(),
             out_bias.data_ptr(), l_pool, *plan, _build.stream_handle(x))
    _build.check(err, "sln_chain", "sln_chain")
    sln_chain.launches += 1
    return y


sln_chain.launches = 0


# ------------------------------ K8 adain_layer ------------------------------

ACTS = ("none", "relu")


def adain_layer_ref(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, *, stride: int = 1, padding: int = 0,
                    pad_mode: str = "zero", act: str = "none",
                    residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K8: act(adain(conv1d(x, taps), gamma, beta)) [+ residual];
    the conv has no bias (the InstanceNorm would remove it)."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    y = adain(conv1d(x, taps, stride=stride, padding=padding, pad_mode=pad_mode), gamma, beta)
    if act == "relu":
        y = torch.relu(y)
    return y if residual is None else y + residual


def adain_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                *, stride: int = 1, padding: int = 0, pad_mode: str = "zero",
                act: str = "none", residual: torch.Tensor | None = None) -> torch.Tensor:
    """K8: one conv -> AdaIN -> act stage in one launch (K1's kernel, its
    one-stage kAdain instance), the residual added after the activation.
    x (B, L_in, C_in); taps (k, C_in, C_out); gamma, beta (B, C_out);
    residual (B, L_out, C_out) or None; act 'none' or 'relu'.

    Replaces fused_adain_layer (iinsvae_tpu/ops/pallas/fused.py:828)."""
    if x.device.type == "cpu":
        return adain_layer_ref(x, taps, gamma, beta, stride=stride, padding=padding,
                               pad_mode=pad_mode, act=act, residual=residual)
    geometry = (stride, padding, pad_mode, act)
    if wants_grad(x, taps, gamma, beta, *(() if residual is None else (residual,))):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.AdainLayer.apply(x, taps, gamma, beta, residual, geometry)
    return launch_adain_layer(x, taps, gamma, beta, residual, *geometry)


def check_adain_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, residual: torch.Tensor | None, stride: int,
                      padding: int, pad_mode: str, act: str) -> list[int]:
    """Raise on what K8 (and its backward) does not take; -> the stage row."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}, got {act!r}")
    rows, l_out, c_out = stage_rows(x, [(taps, stride, padding, pad_mode)])
    b = x.shape[0]
    if gamma.shape != (b, c_out) or beta.shape != (b, c_out):
        raise ValueError(f"gamma and beta must each be ({b}, {c_out})")
    if residual is not None and residual.shape != (b, l_out, c_out):
        raise ValueError(f"residual must be {(b, l_out, c_out)}, got {tuple(residual.shape)}")
    if c_out % 4 or taps.data_ptr() % 16:
        raise ValueError("adain_layer takes 16-byte aligned taps with C_out a multiple of 4")
    _build.require_cuda_f32("adain_layer", x, taps, gamma, beta,
                            *(() if residual is None else (residual,)))
    return rows


def launch_adain_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, residual: torch.Tensor | None, stride: int,
                       padding: int, pad_mode: str, act: str) -> torch.Tensor:
    """Check the operands, launch K8 and count the launch."""
    rows = check_adain_layer(x, taps, gamma, beta, residual, stride, padding, pad_mode, act)
    b, l_out, c_out = x.shape[0], rows[6], rows[7]
    y = torch.empty((b, l_out, c_out), device=x.device, dtype=x.dtype)
    spb = _build.samples_per_block(b, rows[4] * rows[5] + l_out * c_out)
    fn = _build.function("in_chain", "iins_adain_layer",
                         [_P] * 6 + [_I, ctypes.POINTER(_I), _I, _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
             None if residual is None else residual.data_ptr(), y.data_ptr(), b,
             (_I * 8)(*rows), int(act == "relu"), spb, _build.stream_handle(x))
    _build.check(err, "in_chain", "adain_layer")
    adain_layer.launches += 1
    return y


adain_layer.launches = 0


# ------------------------------ K9 sln_layer ------------------------------


def sln_layer_ref(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                  beta: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: relu(sample_layer_norm(conv1d(upsample_x2(x), taps,
    zero pad 2), gamma, beta)); no conv bias."""
    return torch.relu(sample_layer_norm(conv1d(upsample_nearest1d(x, 2), taps, padding=2),
                                        gamma, beta))


def sln_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
              beta: torch.Tensor) -> torch.Tensor:
    """K9: one decoder up-stage in one launch (one stage of K6), (B, L, C_in)
    -> (B, 2L, C_out): x2 nearest upsample, conv k5 zero pad 2 without bias,
    the per-sample LayerNorm, per-channel gamma, beta (C_out,), ReLU.
    taps (5, C_in, C_out).

    Replaces fused_sln_layer (iinsvae_tpu/ops/pallas/fused.py:844)."""
    if x.device.type == "cpu":
        return sln_layer_ref(x, taps, gamma, beta)
    if wants_grad(x, taps, gamma, beta):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.SlnLayer.apply(x, taps, gamma, beta)
    return launch_sln_layer(x, taps, gamma, beta)


def check_sln_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor) -> int:
    """Raise on what K9 (and its backward) does not take; -> the floats a
    sample takes in each of the kernel's shared buffers (its input or its
    output, rounded up to 4)."""
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got shape {tuple(x.shape)}")
    _, l, c_in = x.shape
    if taps.dim() != 3 or taps.shape[:2] != (5, c_in):
        raise ValueError(f"taps must be (5, {c_in}, C_out), got {tuple(taps.shape)}")
    c_out = taps.shape[2]
    if gamma.shape != (c_out,) or beta.shape != (c_out,):
        raise ValueError(f"gamma and beta must each be ({c_out},)")
    if c_out % 4 or taps.data_ptr() % 16:
        raise ValueError("sln_layer takes 16-byte aligned taps with C_out a multiple of 4")
    _build.require_cuda_f32("sln_layer", x, taps, gamma, beta)
    return _round4(max(l * c_in, 2 * l * c_out))


def launch_sln_layer(x: torch.Tensor, taps: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor) -> torch.Tensor:
    """Check the operands, launch K9 and count the launch."""
    width = check_sln_layer(x, taps, gamma, beta)
    b, l, c_in = x.shape
    c_out = taps.shape[2]
    y = torch.empty((b, 2 * l, c_out), device=x.device, dtype=x.dtype)
    spb = _build.samples_per_block(b, 2 * width)  # input and output in shared memory
    fn = _build.function("sln_layer", "iins_sln_layer", [_P] * 5 + [_I] * 5 + [_P])
    err = fn(x.data_ptr(), taps.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), b,
             l, c_in, c_out, spb, _build.stream_handle(x))
    _build.check(err, "sln_layer", "sln_layer")
    sln_layer.launches += 1
    return y


sln_layer.launches = 0


# ------------------------------ K10 tanh_pool ------------------------------


def tanh_pool_ref(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, pool: torch.Tensor,
                  *, padding: int = 0, pad_mode: str = "zero") -> torch.Tensor:
    """Plain version of K10: tanh(conv1d(x, taps) + bias) flattened over
    (L, C_mid), times ``pool``. ``pool`` is a constant: it gets no gradient,
    as in the Pallas entry (iinsvae_tpu/ops/pallas/fused.py:822)."""
    th = torch.tanh(conv1d(x, taps, bias, padding=padding, pad_mode=pad_mode))
    return th.reshape(th.shape[0], -1) @ pool.detach()


def tanh_pool(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, pool: torch.Tensor, *,
              padding: int = 0, pad_mode: str = "zero") -> torch.Tensor:
    """K10: the decoder's tail in one launch (K6's tail with a pool matrix):
    x (B, L, C) -> tanh(conv stride 1 + bias) (B, L_out, C_mid) -> flattened
    @ pool (L_out * C_mid, n_out) -> (B, n_out). taps (k, C, C_mid), bias
    (C_mid,).

    Replaces fused_tanh_pool_layer (iinsvae_tpu/ops/pallas/fused.py:855)."""
    if x.device.type == "cpu":
        return tanh_pool_ref(x, taps, bias, pool, padding=padding, pad_mode=pad_mode)
    if wants_grad(x, taps, bias):
        from iinsvae_torch.ops.kernels import autograd
        return autograd.TanhPool.apply(x, taps, bias, pool, (padding, pad_mode))
    return launch_tanh_pool(x, taps, bias, pool, padding, pad_mode)


def check_tanh_pool(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, pool: torch.Tensor,
                    padding: int, pad_mode: str) -> list[int]:
    """Raise on what K10 (and its backward) does not take; -> the stage row."""
    rows, l_out, c_mid = stage_rows(x, [(taps, 1, padding, pad_mode)])
    if bias.shape != (c_mid,):
        raise ValueError(f"bias must be ({c_mid},), got {tuple(bias.shape)}")
    if pool.dim() != 2 or pool.shape[0] != l_out * c_mid:
        raise ValueError(f"pool must be ({l_out * c_mid}, n_out), got {tuple(pool.shape)}")
    _build.require_cuda_f32("tanh_pool", x, taps, bias, pool)
    return rows


def launch_tanh_pool(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor,
                     pool: torch.Tensor, padding: int, pad_mode: str) -> torch.Tensor:
    """Check the operands, launch K10 and count the launch."""
    rows = check_tanh_pool(x, taps, bias, pool, padding, pad_mode)
    b, n_out = x.shape[0], pool.shape[1]
    y = torch.empty((b, n_out), device=x.device, dtype=x.dtype)
    # the input and the tanh output in shared memory
    spb = _build.samples_per_block(b, _round4(rows[4] * rows[5]) + _round4(rows[6] * rows[7]))
    fn = _build.function("sln_layer", "iins_tanh_pool",
                         [_P] * 5 + [_I, ctypes.POINTER(_I), _I, _I, _P])
    err = fn(x.data_ptr(), taps.data_ptr(), bias.data_ptr(), pool.data_ptr(), y.data_ptr(), b,
             (_I * 8)(*rows), n_out, spb, _build.stream_handle(x))
    _build.check(err, "sln_layer", "tanh_pool")
    tanh_pool.launches += 1
    return y


tanh_pool.launches = 0

