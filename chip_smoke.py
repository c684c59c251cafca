"""Smoke test of the PyTorch/CUDA port (iinsvae_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from iinsvae_torch/ops/kernels/csrc with nvcc,
   one nvcc a source, all at once;
   [server] then drives the serving deployment path before any torch.profiler session
   (server_phase): the flagship 1-D model (seeded) as a recon Predictor at batch 256 behind
   ``runtime.serve_predictor`` (probabilities and reconstruction, deadline 3 ms, the native
   plane built with g++ from iinsvae_torch/runtime/csrc), a unix-socket and a TCP front;
   8 client threads, 4 on each front, send 16 frames of 1-32 seeded CIRs each while 2
   threads submit in-process, with every launch counter set to 0 just before and read just
   after (17 launches a served batch, none backward); every row against the CPU Predictor;
   the server's counters (native plane, every row posted, no timeout, reclaim or rejected
   frame); the 2-D model through an in-process server (256 requests, 8 launches a batch);
   and ``python -m iinsvae_torch.cli.serve --socket`` in a subprocess, answered, then
   stopped by SIGINT (exit code 0, its stats line). It prints served rows/s through the
   fronts, frame latency, mean occupancy and queue time beside the card (no claim);
3. at batch 500, calls every kernel at every shape the 1-D model's serving
   forward gives it, holds the result against the kernel's plain PyTorch
   version on the same inputs, and times kernel, plain version and (where
   one PyTorch call computes the same conv) that call on the device: CUDA
   graphs of 20 calls replayed between CUDA events after a warmup, median
   of 25 replays; the kernel's eager back-to-back time (the host's
   dispatch) beside it; where no call computes the whole op, one cuDNN
   conv of the same data (TF32 off) is timed as a yardstick, marked with a
   double dagger: the widest conv of K1's range chains, one k3 reflect conv
   of K1's and K5's residual blocks, stage 0's k5 conv of K6 on the
   upsampled input (500, 64, 16), and for K4 one fp32 torch.mm of the
   head's largest layer; at the residual blocks (``range.res``,
   ``dec.res``) and the range encoder's stride-2 chains (``range.pair0``,
   ``range.pair1``, ``range.single``) and K2's call sites (``range.out``,
   ``env.in``, ``dec.in``) also the device kernel a call launches (their own
   kernels, ``res::res_block_kernel``, ``down::down_chain_kernel`` and
   ``cba::cba_fwd_kernel``; a trace naming another fails the run), two calls
   bit-equal, and the output bit-equal to the general kernel's on the same
   inputs (a second oracle, timed beside it; a mismatch fails the run); K4's
   heads (the cluster kernel at the restorers, ``head::mlp_head_kernel`` at
   the classifier) within tolerance of the general kernel, timed beside it;
4. serves the flagship 1-D model at full width (seeded weights) through
   ``Predictor(device="cuda")`` on two paths, each on 3 batches of 500 CIRs
   and a ragged 137 with every launch counter set to 0 just before and
   read just after: without the decoder (12 launches a batch) and with
   ``return_recon=True`` (17 a batch); checks that every kernel ran its
   expected count and that the outputs, the reconstruction included, match
   the same weights' ``Predictor(device="cpu")``;
5. measures serving throughput at batch 500 and 256, without and with the
   reconstruction, and the device's idle share of served batches from a
   torch.profiler trace of the card;
6. at each of the 17 forward call sites of a training step, at batch 500,
   calls the backward kernel (K1b, K2b, K3b, K4b, K6b through their six
   wrappers) and holds every gradient against autograd of the plain
   version, and times both, with cuDNN's conv backward
   (``aten.convolution_backward``, TF32 off) beside K2b's and K3b's sites
   and, as the double-dagger yardstick, beside K1b's range chains (the
   chain's widest conv) and residual blocks, K5b's blocks and K6b's decoder
   tail (the forward's yardstick conv), and two fp32 torch.mm calls (dx and
   dW of the head's largest layer) beside K4b; each call bit-equal over two
   calls, and the device kernels it launches named (the path it took);
   then holds every 1-D forward and backward kernel call at the ragged
   batches 5 and 261 against its plain version, the residual blocks', the
   range chains' and K2's call sites' forward also bit for bit against the
   general kernel, K4's heads within tolerance of it, each of those bit-equal
   over two calls (``[ragged]`` lines);
7. trains the flagship (seeded weights) on the synthetic room_full fixture
   (10000 CIRs, the 'full' split's 8000 train CIRs standardized, batch 500)
   through ``cli.train_semi.build`` and ``training.loop.train_epochs``:
   supervision 0.1, Adam with bench.py's schedule (500 epochs, decay from
   100), 3 epochs with every launch counter set to 0 just before and read
   just after (17 forward and 17 backward launches a step); checks a finite
   loss that falls from epoch 1 to epoch 3; then measures training CIR/s
   over 5 more epochs, and the device's busy time per step and idle share
   from a torch.profiler trace of 20 steps; and holds one step's gradients
   on the card against the CPU port's on the same weights and mask;
8. [one_stage] runs the one-stage decoder ops, which no model calls (each
   at 0 launches on the serving and training paths above), at batch 500 on
   the flagship decoder's weights: K8 adain_layer as the AdaIN block's two
   halves on (500, 8, 64), K9 sln_layer at the four upsample stages
   (8, 64) -> (16, 32) -> (32, 16) -> (64, 8) -> (128, 4), K10 tanh_pool at
   the tail (128, 4) -> k7 reflect -> pool 157, and their backward K8b-K10b:
   first that chain under autograd, on the inputs of two seeds, each time
   with every launch counter set to 0 just before and read just after (7
   forward, 7 backward launches), output and gradients held against the
   plain chain in float64 (one_stage_path); then each
   call held against its plain version at batch 500 and 5 and timed beside
   its bound, its plain version and one cuDNN conv (or conv backward) of
   the same data (TF32 off; marked with a double dagger, since no single
   PyTorch call computes the op); and two cross-checks: two K8 calls equal
   one K5 adain_res_block, four K9 calls and K10 with the adaptive pool
   matrix equal K6 sln_chain with zero stage biases;
9. repeats 3-7 for the expanded 2-D model (conv_type=2, the same widths
   and depth): K7 res_block_2d at the range encoder's IN blocks and the
   decoder's AdaIN blocks and K4 at the 128->512 restorer, each beside one
   cuDNN 3x3 conv of the block (TF32 off); serving without the decoder (5
   launches a batch: 3 K7, 2 K4) and with it (8: 6 K7), at batch 500 over
   40 batches; K7b and K4b at their sites; training with 8 forward and 8
   backward launches a step. K7 is also timed as training launches it, writing
   the pre-norm conv outputs d1, d2 (``save_ms``): its y bit-equal to the
   serving launch's, d1 and d2 within tolerance of the plain convs. K7b reads
   the d1, d2 of such a K7 call; its bound is its four conv-sized products as
   3xTF32 on the tensor cores (the route it takes), the fp32-FMA figure
   beside it;
10. [eval] trains, checkpoints, resumes and evaluates through the entry points, in a
   temporary directory (eval_phase): ``cli.train_semi.main`` on the 1-D flagship at full
   width (room_full, 10000 CIRs, batch 500, --kl_free_bits 0.5) for 4 epochs, a checkpoint
   every 2, an evaluation every epoch, keep-last 1: the checkpoints and ``best.json`` it
   leaves; its final checkpoint evaluated on the card with every launch counter set to 0
   just before and read just after (17 forward launches a batch, no backward) and restored
   on the CPU and evaluated there (outputs within the serving tolerance); the evaluated
   CIR/s; a 2-epoch run resumed to 4, bit-equal to the continuous one; one epoch of the
   default environment (nlos); the seeded 2-D model's evaluation over the 2000-row test
   split (8 forward launches a batch, no backward), card against CPU.

11. [joint] drives the supervised joint and separated paths at full width, batch 500, on the
   synthetic nlos fixture (joint_phase): each model's steps counted (EMNet and EMNetLoop 12
   forward and 12 backward launches a step, EMNetLoop with Conv1d heads 10 and 10, sep-E 4
   and 4, sep-M 8 and 8) and one sep-EM inference batch (20, no backward); one step's
   gradients and BatchNormEps running stats of EMNet and of EMNetLoop with Conv1d heads (masks
   injected), card and CPU against float64 on the batch's samples clear of MASK_MARGIN; K4 and
   K4b at the 2-class classifier (the small-head kernel's <Any> instance, checked with the
   serving sites of step 3) against their plain versions at batch 500 and 261; ``cli.run.main``
   for 3 epochs, counted, its loss finite and falling, its checkpoints, a 2 -> 3 resume
   bit-equal, ``cli.evaluate --net joint``; ``cli.run_sep.main`` for 2 epochs a stage, counted;
   EMNet's training CIR/s and its traced step (no claim). The ``kernels`` line gains
   ``launches_joint`` and ``launches_sep``, each kernel's launches on the two entry points' runs.

12. [bf16] (after the 2-D training, bf16_sites and bf16_train_path): the bfloat16 instances of
   K7 (serving and saving, y bit-equal), K7b, K4 and K4b at the 2-D model's IN and AdaIN blocks,
   restorer and classifier, at batch 500 on the model's weights rounded to bfloat16 and seeded
   bfloat16 inputs: every output and gradient against float64 on the same inputs, at most
   BF16_FACTOR times the plain bfloat16 version's error plus BF16_FLOOR of the result's
   magnitude (K7's and K7b's per-sample tensors on the samples clear of MASK_MARGIN); each
   call's device kernels (BF16_DEVICE_KERNELS), its time beside its bound (at the card's
   bfloat16 rate for all four; K4 and K4b compute in fp32 FMAs, whose time is printed beside
   it), its plain version and a bfloat16 yardstick
   (double dagger: one cuDNN 3x3 conv or conv backward of the block, torch.mm of the head's
   largest layer), K7 and K7b also beside the whole block composed of library calls (two
   cuDNN convs, the norms and the skip as torch ops) and its autograd backward, in CUDA graphs
   (res2d_library_block); then ``--compute_dtype bfloat16`` training of the 2-D model through
   ``cli.train_semi.build``: 3 epochs counted (K7 6, K7b 6, K4 2, K4b 2 bfloat16 launches a
   step, no float32 instance), a finite loss that falls, training CIR/s and a traced step's
   device busy time beside the float32 step's, one step's gradients on the card and on the
   CPU port (bfloat16) against float64; and the entry points (bf16_cli_check): ``train_semi``
   trains, checkpoints and resumes bit-equal, ``evaluate`` reads the checkpoint. The
   ``kernels`` line gains the four bfloat16 instances as rows of their own; their
   ``launches_joint``, ``launches_sep`` and ``launches_server`` are read in [joint] and [server],
   which fail unless every bfloat16 counter stayed 0 there. The soft 2-D restorer's (128 -> 512
   -> 256 -> 256 -> 2, the cluster kernel's instance of last width 2) bfloat16 K4 and K4b sites
   run here too.

13. [noexpand] (noexpand_phase): the column-image model (conv_type 3, NoExpand: full width, 3
   residual blocks, 4 downsamples, style_dim 16, 157 taps, 5 classes, --env_conv_init torch,
   seeded) served through ``Predictor(device="cuda")`` at batch 500 without and with the
   reconstruction, counted (2 launches a batch: K4 at the restorer and at the classifier) and
   held to the CPU Predictor; the port's kernels of a forward batch and of a step's forward and
   backward read from CUDA graphs (K4's cluster and head kernels; with K4b's at the two heads);
   serving CIR/s, device busy time and idle share; its training main path as in 7 (2 + 2
   launches a step).

14. [soft] (soft_phase): K4 at the soft restorers (16 -> ... -> 2 and 128 -> ... -> 2, fp32)
   and K4b, at batch 500 and 261, against their plain versions, K4 within tolerance of the
   general kernel and launching the cluster kernel; the 1-D soft step (--use_soft) through
   ``cli.train_semi.build``, one epoch counted (17 + 17 a step), one step's gradients card vs
   CPU against float64 with the eps injected; the bfloat16 2-D soft step, one epoch counted;
   the cluster kernel named once in a CUDA graph of each soft step. The ``kernels`` line gains
   the soft rows (``mlp_chain_soft``, ``mlp_chain_bwd_soft``, ``mlp_chain_bf16_soft``,
   ``mlp_chain_bwd_bf16_soft``) and ``launches_noexpand``, each row's wrapper's launches on
   the column-image model's 3 counted training epochs.

15. [data] (data_phase, in a temporary working directory): ``resolve_data`` on the card's
   machine (no pandas there) for the eWine fixture (two CSVs of 5000 seeded rows written, parsed
   by the native plane bit-equal to the rows written, the 'full' split, then read again from the
   mmap cache) and the 'paper' split of fixture v2 (the cache written cold, read warm; its test
   split exactly the Room == 2 rows); K6 and K6b at the eWine decoder tail (pool 128 -> 152,
   batch 500) against their plain versions as the 157 sites are held (K6 on the tail kernel,
   bit-equal to the general kernel); K4 and K4b bfloat16 at the paper protocol's 4-class
   classifier (the head kernel's <Any> instance) against float64 beside the plain bfloat16
   version; the eWine model's (152 taps, 2 classes) training main path as in 7 (17 + 17
   launches a step, counted), its step's CUDA graph naming exactly the 157-tap step's kernels;
   the eWine model served through Predictor (17 launches a batch, counted, against the CPU) and
   by ``serve --dataset_name ewine`` in a subprocess, frames of 152 taps on both fronts against
   the CPU Predictor, then SIGINT; and the paper protocol's bfloat16 2-D step (--mode paper
   --dataset_env paper --conv_type 2 --compute_dtype bfloat16 --supervision_rate 1.0) through
   ``cli.train_semi.build``, one epoch counted (K7 6 and K4 2 bfloat16 launches a step, one
   backward each), the cluster and head kernels once each in a CUDA graph of a step. The
   ``kernels`` line gains K6 and K6b at the pool of 152 and K4 and K4b bfloat16 at the 4-class
   head (``sln_chain_152``, ``sln_chain_bwd_152``, ``mlp_chain_bf16_4class``,
   ``mlp_chain_bwd_bf16_4class``; ``counter`` names the launch counter their other phases'
   launches are read from).

Each device-kernel check (``device_kernel`` sites, the backward sites, [bf16]) reads the
kernel nodes of a CUDA graph of the call (graph_kernels.launched_kernels, the graph replayed
and its outputs bit-equal to an eager call's), not a torch.profiler trace, which on the card
sometimes held no device event.

Prints a ``sites`` line (per call site, both models), a ``serving`` line,
a ``backward`` line (per backward call site), a ``training`` and a
``training_2d`` line, a ``one_stage`` line, an ``eval`` line, a ``joint`` line, a ``server``
line, a ``noexpand`` / ``soft`` line, a ``data`` line, a ``kernels`` line (with ``launches_server``, each
kernel's launches in the ``[server]`` phase), the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. The whole result also goes to
chiprun_out/chip_smoke.json. Any failure raises and exits non-zero; without
a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from iinsvae_torch.cli import train_semi
from iinsvae_torch.config import Config
from iinsvae_torch.evaluation import evaluate_semi
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops import kernels
from iinsvae_torch.ops.conv import conv1d, out_len, upsample_nearest1d
from iinsvae_torch.ops.kernels import _build, backward, fused, graph_kernels, res2d, strided_conv
from iinsvae_torch.ops.norms import adain, instance_norm, sample_layer_norm
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import loop, steps

BATCH = 500
# batches for the ragged checks: no whole number of tiles of any kernel
# (K3's tiles are 64-128 rows of 32-64 a sample, K3b's 128-256 row pairs)
RAGGED = (5, 261)
# H100 SXM data-sheet peaks: HBM bytes/s, float32 outside the tensor cores
# (the kernels use fp32 FMAs), and dense TF32 on the tensor cores (K7b's
# products, three TF32 products for each fp32 one: 3xTF32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12
# Kernel vs plain version on the card: both fp32, but the kernels sum in
# another order (conv sums of up to 192 terms, dense sums of up to 512) and
# InstanceNorm divides by a per-channel std, which can scale that rounding up.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# K7's y, d1 and d2 (3xTF32 on the tensor cores) against the float64 block: an error at most
# this many times the plain fp32 block's, the plain block's own rounding being the yardstick.
F64_FACTOR = 2.0
# Predictor on the card vs on the CPU: 12 (17) launches' reorderings compound.
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4
# launches per forward batch of the flagship (n_downsample 4, n_residual 3)
# without the decoder: in_chain 3 stage groups + 3 residual blocks;
# conv_bias_act the range out-conv and the env in-conv; strided_conv two
# env stages; mlp_chain 2 heads. The decoder adds its 1x1 in-conv
# (conv_bias_act), 3 AdaIN blocks and the tail.
EXPECTED_NO_RECON = {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2,
                     "adain_res_block": 0, "sln_chain": 0, "res_block_2d": 0,
                     "adain_layer": 0, "sln_layer": 0, "tanh_pool": 0}
EXPECTED_RECON = {**EXPECTED_NO_RECON, "conv_bias_act": 3, "adain_res_block": 3,
                  "sln_chain": 1}
# launches of one training step: the recon forward's 17, and one backward
# launch for each of them
EXPECTED_TRAIN = dict(EXPECTED_RECON)
EXPECTED_TRAIN_BWD = {f"{k}_bwd": v for k, v in EXPECTED_RECON.items()}
# the expanded 2-D model (conv_type=2): K7 for the range encoder's 3 IN
# blocks and the decoder's 3 AdaIN blocks, K4 for the 2 heads; everything
# else on its path is plain tensor ops. A step: the recon forward's 8
# launches and one backward launch for each.
EXPECTED_2D_NO_RECON = {**{k: 0 for k in EXPECTED_NO_RECON}, "mlp_chain": 2, "res_block_2d": 3}
EXPECTED_2D_RECON = {**EXPECTED_2D_NO_RECON, "res_block_2d": 6}
EXPECTED_2D_TRAIN_BWD = {f"{k}_bwd": v for k, v in EXPECTED_2D_RECON.items()}
# the one-stage phase's chain: the AdaIN block as two K8 calls, four K9
# up-stages, the K10 tail; under autograd one backward launch for each
ONE_STAGE = {"adain_layer": 2, "sln_layer": 4, "tanh_pool": 1}
ONE_STAGE_BWD = {f"{k}_bwd": v for k, v in ONE_STAGE.items()}
# a value before a ReLU this close to 0, relative to its sample's largest,
# may take its mask from the summation order (tests/test_torch_gpu.py)
MASK_MARGIN = 1e-5
# The one-stage chain held to float64 (one_stage_path): at least this share
# of a batch must have no ReLU input within MASK_MARGIN of 0 (409 and 424 of
# 500 at seeds 11 and 15 on the H100); the chain's outputs with a row a sample
CLEAR_SHARE = 0.75
PER_SAMPLE = ("y", "x", "gamma1", "beta1", "gamma2", "beta2")
# Backward kernel vs plain version, per gradient: rtol 1e-3 and atol 1e-4
# times the gradient's largest magnitude. A weight gradient sums B*L
# products over the batch (in another order than autograd's), and the
# InstanceNorm and LayerNorm gradients scale by 1/std.
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
# One training step's gradients on the card and on the CPU (both fp32), each
# against the CPU port's in float64: per parameter, the card's largest error
# may be at most STEP_FACTOR times the CPU's own plus STEP_FLOOR of the
# gradient's largest magnitude. A per-tensor tolerance does not fit here: a
# weight gradient such as the decoder's 1x1 in-conv sums 4000 terms that
# cancel to 1e-4 of their size, so two fp32 summation orders differ by
# 1e-3 of the result.
STEP_FACTOR, STEP_FLOOR = 10.0, 1e-4
# The 2-D range encoder's conv biases before an InstanceNorm: their exact
# gradient is 0, so each fp32 gradient is rounding noise; it is held below
# ZERO_GRAD_SHARE of the model's largest gradient instead.
ZERO_GRAD = re.compile(r"encoder\.range_encoder\.(in|down\d+)_bias")
ZERO_GRAD_SHARE = 1e-6
# The models whose training-step gradient check (step_grads_vs_cpu) runs on the batch's samples
# whose every ReLU input clears MASK_MARGIN, as joint_grads_vs_cpu's does: on the eWine model's
# first fixture batch 100 of 500 samples have one within it, and a 1e-7 relative perturbation of
# the CIRs moved the float64 gradients by up to 5.7e-4 of their scale (the clear 400: 1.8e-6):
# there the summation order of an fp32 forward decides a mask and the gradient, which the card
# (kernels or plain backward alike) then misses by 1e-3 of the scale
CLEAR_STEP = ("ewine",)
_CSRC = "iinsvae_torch/ops/kernels/csrc/"
SOURCES = {
    "in_chain": _CSRC + "in_chain.cu",
    "conv_bias_act": _CSRC + "in_chain.cu",
    "strided_conv": _CSRC + "strided_conv.cu",
    "mlp_chain": _CSRC + "mlp_chain.cu",
    "adain_res_block": _CSRC + "in_chain.cu",
    "sln_chain": _CSRC + "sln_chain.cu",
    "in_chain_bwd": _CSRC + "in_chain_bwd.cu",
    "conv_bias_act_bwd": _CSRC + "conv_bias_act_bwd.cu",
    "strided_conv_bwd": _CSRC + "strided_conv_bwd.cu",
    "mlp_chain_bwd": _CSRC + "mlp_chain_bwd.cu",
    "adain_res_block_bwd": _CSRC + "in_chain_bwd.cu",
    "sln_chain_bwd": _CSRC + "sln_chain_bwd.cu",
    "res_block_2d": _CSRC + "res_block_2d.cu",
    "res_block_2d_bwd": _CSRC + "res_block_2d_bwd.cu",
    "adain_layer": _CSRC + "in_chain.cu",
    "sln_layer": _CSRC + "sln_layer.cu",
    "tanh_pool": _CSRC + "sln_layer.cu",
    "adain_layer_bwd": _CSRC + "in_chain_bwd.cu",
    "sln_layer_bwd": _CSRC + "sln_layer_bwd.cu",
    "tanh_pool_bwd": _CSRC + "sln_layer_bwd.cu",
    "res_block_2d_bf16": _CSRC + "res_block_2d_bf16.cu",
    "res_block_2d_bwd_bf16": _CSRC + "res_block_2d_bf16_bwd.cu",
    "mlp_chain_bf16": _CSRC + "mlp_chain.cu",
    "mlp_chain_bwd_bf16": _CSRC + "mlp_chain_bwd.cu",
}
# [eval]: the entry point's flags (the training-quality recipe's model and fixture), the
# epochs of its runs, and the CPU's top-two logit margin under which the card's argmax may
# differ from the CPU's (the outputs agree within SERVE_RTOL / SERVE_ATOL)
EVAL_FLAGS = ["--device", "cuda", "--dataset_env", "room_full", "--kl_free_bits", "0.5",
              "--synthetic_n", "10000", "--batch_size", str(BATCH)]
EVAL_SCHEDULE = ["--checkpoint_interval", "2", "--sample_interval", "1", "--keep_last", "1"]
EVAL_EPOCHS = 4
FLIP_MARGIN = 1e-3
# [joint]: the entry points' flags (run / run_sep's default environment nlos, 2 classes, the
# fixture and batch of the training-quality recipe), the epochs of their runs, and the
# forward launches of one step of each model (one backward launch for each): EMNet and
# EMNetLoop with Linear heads, K1 6 (the range encoder), K2 2 (range.out, env.in), K3 2 (the
# env stages), K4 2 (the heads); Conv heads are plain ops (no K4); sep-E the env branch and the
# classifier, sep-M the range branch and the restorer
JOINT_FLAGS = ["--device", "cuda", "--dataset_env", "nlos", "--synthetic_n", "10000",
               "--batch_size", str(BATCH)]
JOINT_EPOCHS, SEP_EPOCHS = 3, 2
JOINT_STEP = {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2}
SEP_E_STEP = {"conv_bias_act": 1, "strided_conv": 2, "mlp_chain": 1}
SEP_M_STEP = {"in_chain": 6, "conv_bias_act": 1, "mlp_chain": 1}
# [server]: the request batcher in front of the recon Predictor at the serve CLI's batch and
# deadline; SERVER_CLIENTS client threads (half on the unix-socket front, half on TCP) send
# SERVER_FRAMES frames of 1-32 CIRs each, SERVER_LOCAL threads submit SERVER_LOCAL_N CIRs each
# in-process beside them; the 2-D model serves SERVER_2D_N in-process requests
SERVER_BATCH, SERVER_DEADLINE_MS = 256, 3.0
SERVER_CLIENTS, SERVER_FRAMES, SERVER_MAX_FRAME = 8, 16, 32
SERVER_LOCAL, SERVER_LOCAL_N = 2, 64
SERVER_2D_N = 256
FLAGSHIP = dict(conv_type=1, cir_len=157, num_classes=5, style_dim=16, dim=4,
                n_residual=3, n_downsample=4, range_dim=2)
FLAGSHIP_2D = dict(FLAGSHIP, conv_type=2)
# [noexpand]: the column-image model (conv_type 3, NoExpand) at full width with the env encoder's
# conv taps from torch's default (--env_conv_init torch): its forward launches K4 at the restorer
# (16 -> 512 -> 256 -> 256 -> 1, the cluster kernel) and at the classifier (the head kernel),
# every conv and norm a plain op; a step one K4b launch for each
FLAGSHIP_3D = dict(FLAGSHIP, conv_type=3, env_conv_init="torch")
EXPECTED_3D = {**{k: 0 for k in EXPECTED_NO_RECON}, "mlp_chain": 2}
EXPECTED_3D_TRAIN_BWD = {f"{k}_bwd": v for k, v in EXPECTED_3D.items()}
# [soft]: the 1-D model with the soft restorer (--use_soft: 16 -> ... -> 2, the cluster kernel's
# instance of last width 2), which launches as the 1-D model does
FLAGSHIP_SOFT = dict(FLAGSHIP, soft=True)
# [data]: the eWine model, the 1-D flagship at 152 taps and 2 classes: its encoders pool 152 ->
# 128, so every kernel but K6 / K6b runs the 157-tap model's shapes, and the decoder tail pools
# 128 -> 152; its step launches the 1-D step's kernels
FLAGSHIP_EWINE = dict(FLAGSHIP, cir_len=152, num_classes=2)
MODELS = {1: FLAGSHIP, 2: FLAGSHIP_2D, 3: FLAGSHIP_3D, "soft": FLAGSHIP_SOFT,
          "ewine": FLAGSHIP_EWINE}
RES2D = "iinsvae_tpu/ops/pallas/res2d.py"
OUT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke.json"


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def eager_ms(fn, reps: int = 25, inner: int = 10) -> float:
    """Back-to-back eager calls between CUDA events, median per call over
    ``reps``: with launches this small it is the host's dispatch time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """The card's time for one call: ``inner`` calls captured in a CUDA
    graph, the graph replayed ``reps`` times between CUDA events (no Python
    between launches), median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    del graph
    return statistics.median(times)


def valid_taps(l_in: int, k: int, stride: int, padding: int, pad_mode: str) -> int:
    """Tap reads over all output positions; a zero pad reads nothing."""
    if pad_mode == "reflect":
        return out_len(l_in, k, stride, padding) * k
    return sum(1 for o in range(out_len(l_in, k, stride, padding)) for t in range(k)
               if 0 <= o * stride + t - padding < l_in)


def upsampled_rows(l_in: int, k: int, padding: int) -> int:
    """Input rows a zero-pad conv over the x2 nearest upsample of length
    ``l_in`` needs, over all 2*l_in outputs: the taps of output o read
    upsampled rows o+t-padding, which fall on the distinct rows
    (o+t-padding)>>1; taps that read the same row sum their weights first,
    so each distinct row costs one multiply-add per channel pair."""
    return sum(len({(o + t - padding) >> 1 for t in range(k)
                    if 0 <= o + t - padding < 2 * l_in}) for o in range(2 * l_in))


def conv_flops(b: int, l_in: int, taps: torch.Tensor, stride: int, padding: int,
               pad_mode: str) -> float:
    k, c_in, c_out = taps.shape
    return 2.0 * b * valid_taps(l_in, k, stride, padding, pad_mode) * c_in * c_out


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ncl_conv(x: torch.Tensor, taps: torch.Tensor, bias: torch.Tensor, stride: int,
             padding: int, pad_mode: str):
    """One F.conv1d call on the same data laid out channels-first (layout
    and reflect padding prepared outside the timed call); bias included,
    the ReLU not."""
    xc = x.transpose(1, 2).contiguous()
    if pad_mode == "reflect":
        xc, padding = F.pad(xc, (padding, padding), mode="reflect"), 0
    w = taps.permute(2, 1, 0).contiguous()
    return lambda: F.conv1d(xc, w, bias, stride=stride, padding=padding)


def res2d_flops(b: int) -> float:
    """One 3x3 conv of a (b, 8, 8, 64) field to 64 channels (reflect pad:
    every tap reads data)."""
    return 2.0 * b * 64 * 9 * 64 * 64


def nchw_conv3x3(x: torch.Tensor, taps: torch.Tensor):
    """One F.conv2d call (cuDNN, TF32 off) of the same 3x3 reflect-pad conv
    on the same data as a channels-last NCHW view, reflect padding prepared
    outside the timed call. No PyTorch call computes K7's whole block, so
    this time of one of its two convs stands beside it, not as its library
    time."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(
        memory_format=torch.channels_last)
    w = taps.detach().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xp, w)


def mlp_site(name: str, head, replaces: str, b: int, rand, rand_yard) -> dict:
    """K4's call at a head (``head``: a Linear head, its ``w{j}``, ``b{j}`` and slopes) at
    batch b on ``rand``'s inputs: the forward site dict of call_sites, a torch.mm of the
    head's largest layer on ``rand_yard``'s data as its double-dagger yardstick, the general
    kernel as its second oracle (within tolerance), the device kernel its path launches."""
    n = len(head.slopes)
    ws = [getattr(head, f"w{j}") for j in range(n)]
    bs = [getattr(head, f"b{j}") for j in range(n)]
    dev = ws[0].device
    x = rand(b, ws[0].shape[0])
    j = max(range(n), key=lambda i: ws[i].numel())  # the yardstick: the largest layer's mm
    x_j, w_j = rand_yard(b, ws[j].shape[0]), ws[j].detach()
    dims = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    return dict(
        name=name, kernel="mlp_chain", replaces=replaces, calls_per_batch=1,
        shape="->".join(str(d) for d in dims),
        run=lambda: fused.mlp_chain(x, ws, bs, head.slopes),
        plain=lambda: fused.mlp_chain_ref(x, ws, bs, head.slopes), library=None,
        cudnn_conv=lambda: torch.mm(x_j, w_j),
        yardstick=f"torch.mm of its {ws[j].shape[0]}->{ws[j].shape[1]} layer",
        bytes=nbytes(x, *ws, *bs) + 4 * b * ws[-1].shape[1],
        flops=2.0 * b * sum(w.numel() for w in ws), traced=True,
        general_close=lambda: fused.launch_mlp_chain(x, ws, bs, head.slopes, general=True)[0],
        device_kernel=("head::mlp_head_kernel" if fused.takes_mlp_head(dims)
                       else "cluster::mlp_cluster_kernel"),
        weights_l2=mlp_weight_l2_bytes(dims, b, dev))


def call_sites(model: IInsVAE, gen: torch.Generator, b: int = BATCH) -> list[dict]:
    """Every kernel call of one serving forward with the reconstruction, at
    batch b (500 unless a ragged check asks for another), with the model's own weights and seeded random inputs of the
    right shape: the 1-D model's sites or the expanded 2-D model's."""
    re_, ee = model.encoder.range_encoder, model.encoder.env_encoder
    dec = model.decoder.decoder
    dev = next(model.parameters()).device

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    yard_gen = torch.Generator().manual_seed(98)  # the yardsticks' data, apart from the sites'

    def rand_yard(*shape):
        return torch.randn(shape, generator=yard_gen).to(dev)

    sites = []

    def add_in_chain(name, x, stages, replaces, residual=False, calls=1, **more):
        l, flops, widest = x.shape[1], 0.0, (0.0, None)
        for taps, s, p, mode in stages:
            f = conv_flops(b, l, taps, s, p, mode)
            flops += f
            widest = max(widest, (f, (l, taps, s, p, mode)), key=lambda w: w[0])
            l = out_len(l, taps.shape[0], s, p)
        if "cudnn_conv" not in more:  # the chain's widest conv
            l_w, t_w, s_w, p_w, mode_w = widest[1]
            more["cudnn_conv"] = ncl_conv(rand_yard(b, l_w, t_w.shape[1]), t_w, None, s_w, p_w,
                                          mode_w)
        if "general" not in more:  # the range chains: their kernel against the general one
            more["general"] = lambda: fused.launch_in_chain(x, stages, residual, general=True)
        y_numel = b * l * stages[-1][0].shape[2]
        sites.append(dict(
            name=name, kernel="in_chain", replaces=replaces, calls_per_batch=calls,
            shape=f"{tuple(x.shape)}->({b}, {l}, {stages[-1][0].shape[2]})",
            run=lambda: fused.in_chain(x, stages, residual=residual),
            plain=lambda: fused.in_chain_ref(x, stages, residual=residual), library=None,
            bytes=nbytes(x, *[s[0] for s in stages]) + 4 * y_numel, flops=flops, **more))

    def add_conv(name, kernel, x, taps, bias, s, p, mode, replaces):
        l_out = out_len(x.shape[1], taps.shape[0], s, p)
        more = {}
        if kernel == "strided_conv":
            run = lambda: strided_conv.strided_conv(x, taps, bias)
            plain = lambda: strided_conv.strided_conv_ref(x, taps, bias)
        else:  # K2's call sites: their kernel bit for bit against the general one
            run = lambda: fused.conv_bias_act(x, taps, bias, stride=s, padding=p, pad_mode=mode)
            plain = lambda: fused.conv_bias_act_ref(x, taps, bias, stride=s, padding=p,
                                                    pad_mode=mode)
            more = dict(general=lambda: fused.launch_conv_bias_act(x, taps, bias, s, p, mode,
                                                                   general=True),
                        device_kernel="cba::cba_fwd_kernel")
        sites.append(dict(
            name=name, kernel=kernel, replaces=replaces, calls_per_batch=1,
            shape=f"{tuple(x.shape)}->({b}, {l_out}, {taps.shape[2]})",
            run=run, plain=plain, library=ncl_conv(x, taps, bias, s, p, mode),
            bytes=nbytes(x, taps, bias) + 4 * b * l_out * taps.shape[2],
            flops=conv_flops(b, x.shape[1], taps, s, p, mode), **more))

    def add_mlp(name, head, replaces):
        sites.append(mlp_site(name, head, replaces, b, rand, rand_yard))

    fp = "iinsvae_tpu/ops/pallas/fused.py"
    if model.encoder.conv_type == 2:
        for name, mod, affine in (("range.res2d", re_, []),
                                  ("dec.res2d", dec, [rand(b, 64) for _ in range(4)])):
            x, k1, k2 = rand(b, 8, 8, 64), mod.res0_kernel1, mod.res0_kernel2
            sites.append(dict(
                name=name, kernel="res_block_2d", replaces=f"{RES2D}:339", calls_per_batch=3,
                shape=f"{tuple(x.shape)}->{tuple(x.shape)}" + (" adain" if affine else " in"),
                run=lambda x=x, k1=k1, k2=k2, a=affine: res2d.res_block_2d(x, k1, k2, *a),
                plain=lambda x=x, k1=k1, k2=k2, a=affine: res2d.res_block_2d_ref(x, k1, k2, *a),
                library=None, cudnn_conv=nchw_conv3x3(x, k1),
                save=lambda x=x, k1=k1, k2=k2, a=affine: res2d.launch_res_block_2d(
                    x, k1, k2, *a, save=True),
                save_plain=lambda x=x, k1=k1, k2=k2, a=affine: res2d.res_block_2d_ref(
                    x, k1, k2, *a, save=True),
                save_f64=lambda x=x, k1=k1, k2=k2, a=affine: res2d.res_block_2d_ref(
                    *(t.double() for t in (x, k1, k2, *a)), save=True),
                bytes=nbytes(x, k1, k2, *affine, x), flops=2 * res2d_flops(b), tf32x3=True))
        add_mlp("restorer.2d", model.restorer.restorer, f"{fp}:1164")
        return sites
    stages = [(re_.in_kernel, 1, 3, "reflect")] + [
        (getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)]
    add_in_chain("range.pair0", rand(b, 128, 1), stages[0:2], f"{fp}:361")
    add_in_chain("range.pair1", rand(b, 64, 8), stages[2:4], f"{fp}:361")
    add_in_chain("range.single", rand(b, 16, 32), stages[4:5], f"{fp}:1320")
    x = rand(b, 8, 64)
    block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
    add_in_chain("range.res", x, block, f"{fp}:253", residual=True, calls=3,
                 cudnn_conv=ncl_conv(x, re_.res0_kernel1, None, 1, 1, "reflect"),
                 general=lambda x=x: fused.launch_in_chain(x, block, True, general=True))
    add_conv("range.out", "conv_bias_act", rand(b, 8, 64), re_.out_kernel, re_.out_bias,
             1, 0, "zero", f"{fp}:1320")
    c0, c1, c2 = ee.ConvINAct_0, ee.ConvINAct_1, ee.ConvINAct_2
    add_conv("env.in", "conv_bias_act", rand(b, 128, 1), c0.kernel, c0.bias, 1, 3,
             "reflect", f"{fp}:1320")
    sc = "iinsvae_tpu/ops/pallas/strided_conv.py:250"
    add_conv("env.down0", "strided_conv", rand(b, 128, 16), c1.kernel, c1.bias, 2, 1,
             "zero", sc)
    add_conv("env.down1", "strided_conv", rand(b, 64, 32), c2.kernel, c2.bias, 2, 1,
             "zero", sc)
    add_mlp("restorer", model.restorer.restorer, f"{fp}:1164")
    add_mlp("classifier", model.classifier.classifier, f"{fp}:1164")

    add_conv("dec.in", "conv_bias_act", rand(b, 8, 2), dec.in_kernel, dec.in_bias, 1, 0,
             "zero", f"{fp}:1320")
    x, k1, k2 = rand(b, 8, 64), dec.res0_kernel1, dec.res0_kernel2
    affine = [rand(b, 64) for _ in range(4)]
    sites.append(dict(
        name="dec.res", kernel="adain_res_block", replaces=f"{fp}:557", calls_per_batch=3,
        shape=f"{tuple(x.shape)}->{tuple(x.shape)}",
        run=lambda: fused.adain_res_block(x, k1, k2, *affine),
        plain=lambda: fused.adain_res_block_ref(x, k1, k2, *affine), library=None,
        general=lambda: fused.launch_adain_res_block(x, k1, k2, *affine, general=True),
        cudnn_conv=ncl_conv(x, k1, None, 1, 1, "reflect"), bytes=nbytes(x, k1, k2, *affine, x),
        flops=2 * conv_flops(b, 8, k1, 1, 1, "reflect")))
    xt = rand(b, 8, 64)
    stages = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
              for j in range(4)]
    flops, l = 0.0, xt.shape[1]
    for taps, *_ in stages:  # x2 upsample, then a k5 zero-pad-2 conv
        k, c_in, c_out = taps.shape
        flops += 2.0 * b * upsampled_rows(l, k, 2) * c_in * c_out
        l *= 2
    flops += conv_flops(b, l, dec.out_kernel, 1, 3, "reflect")
    l_pool = model.cir_len  # 157, or 152 for the eWine model
    pool = adaptive_avg_pool_matrix(l, l_pool, device=dev)  # a buffer, as the encoder's is
    sites.append(dict(
        name="dec.tail", kernel="sln_chain", replaces=f"{fp}:1027", calls_per_batch=1,
        shape=f"{tuple(xt.shape)}->({b}, {l_pool})",
        run=lambda: fused.sln_chain(xt, stages, dec.out_kernel, dec.out_bias, l_pool),
        plain=lambda: fused.sln_chain_ref(xt, stages, dec.out_kernel, dec.out_bias, l_pool,
                                          pool=pool),
        general=lambda: fused.launch_sln_chain(xt, stages, dec.out_kernel, dec.out_bias, l_pool,
                                               general=True),
        library=None, cudnn_conv=ncl_conv(upsample_nearest1d(xt, 2), *stages[0][:2], 1, 2, "zero"),
        bytes=nbytes(xt, *[t for st in stages for t in st], dec.out_kernel, dec.out_bias)
        + 4 * b * l_pool,
        flops=flops))
    return sites


def mlp_weight_l2_bytes(dims, b: int, dev) -> tuple[int, str]:
    """(bytes of weights and biases one K4 call reads from L2, what reads them) as the kernel's
    path stages them: the restorer path once a cluster (with all of W0 in each of its blocks
    where layer 0 runs whole in every block), the small-head path once a block, the general
    kernel once for each block of 4 samples."""
    wb = 4 * sum(a * k + k for a, k in zip(dims, dims[1:]))
    if fused.takes_mlp_head(dims):
        _, blocks = fused.mlp_head_plan(b, torch.cuda.get_device_properties(dev)
                                        .multi_processor_count)
        return blocks * wb, f"{blocks} blocks of {fused.MLP_HEAD_TILE} samples"
    if fused.takes_mlp_cluster(dims):
        _, _, clusters, _ = fused.mlp_cluster_plan(b, dims[0],
                                                   fused.mlp_cluster_slots(dev, dims[0]))
        whole0 = (fused.MLP_CLUSTER - 1) * 4 * (dims[0] + 1) * dims[1]
        return clusters * (wb + (whole0 if dims[0] <= fused.MLP_CLUSTER_WHOLE_L0 else 0)), \
            f"{clusters} clusters of {fused.MLP_CLUSTER}"
    return -(-b // 4) * wb, f"{-(-b // 4)} blocks"


def compare_forward(s: dict, what: str = "") -> tuple[float, float]:
    """A forward site's kernel output against its plain version: finite and
    within KERNEL_RTOL / KERNEL_ATOL; where the site has a second oracle, the
    general kernel on the same inputs, bit-equal to it (``general``: K1's and
    K5's own kernels, K2's at its call sites, K6's tail) or within the same
    tolerance (``general_close``: K4's own kernels, which sum in another
    order). Returns the largest absolute and relative errors."""
    got, want = s["run"](), s["plain"]()
    torch.cuda.synchronize()
    name = f"{s['name']}{what}"
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if "general" in s and not torch.equal(got, s["general"]()):
        raise AssertionError(f"{name}: the kernel's output is not bit-equal to the general "
                             f"kernel's")
    if "general_close" in s:
        torch.testing.assert_close(got, s["general_close"](), rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                   msg=lambda m: f"{name} kernel vs the general kernel: {m}")
    torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                               msg=lambda m: f"{name} kernel vs plain: {m}")
    err = (got - want).abs()
    return err.max().item(), (err / want.abs().clamp_min(1e-12)).max().item()


def compare_backward(s: dict, what: str = "") -> tuple[list[float], list[float]]:
    """Every gradient of a backward site against the plain version's: as many,
    of the same shapes, finite, and within BWD_RTOL and BWD_ATOL of the plain
    gradient's largest magnitude. Returns each gradient's largest absolute
    error and that error over the magnitude."""
    got, want = _tensors(s["run"]()), _tensors(s["plain"]())
    torch.cuda.synchronize()
    name = f"{s['name']}{what}"
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} gradients, plain {len(want)}")
    errs, scaled = [], []
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name} gradient {i}: shape {tuple(a.shape)} "
                                 f"(plain {tuple(b.shape)}) or non-finite")
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=BWD_RTOL, atol=BWD_ATOL * scale,
                                   msg=lambda m: f"{name} gradient {i}: {m}")
        errs.append((a - b).abs().max().item())
        scaled.append(errs[-1] / scale if scale else 0.0)
    return errs, scaled


def compare_saves(s: dict) -> dict:
    """K7 as training launches it: y bit-equal to the serving launch's, and the saved d1, d2
    within KERNEL_RTOL / KERNEL_ATOL of the plain convs; y, d1 and d2 against the float64 block,
    each with an error at most F64_FACTOR times the plain fp32 block's. Returns their errors and
    the launch's device time (save_ms)."""
    got, plain, f64 = s["save"](), s["save_plain"](), s["save_f64"]()
    torch.cuda.synchronize()
    if not torch.equal(got[0], s["run"]()):
        raise AssertionError(f"{s['name']}: K7's y differs when it saves d1 and d2")
    errs = {}
    for k, a, p, w in zip(("y", "d1", "d2"), got, plain, f64):
        if k != "y":
            torch.testing.assert_close(a, p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                       msg=lambda m: f"{s['name']} saved {k} vs plain: {m}")
            errs[f"saved_{k}_max_abs_err"] = (a - p).abs().max().item()
        e, e_plain = ((t.double() - w).abs().max().item() for t in (a, p))
        if e > F64_FACTOR * e_plain:
            raise AssertionError(f"{s['name']}: {k}'s error against float64 {e:.3e} is over "
                                 f"{F64_FACTOR} x the plain fp32 block's {e_plain:.3e}")
        errs[f"{k}_err_vs_f64"], errs[f"plain_{k}_err_vs_f64"] = e, e_plain
    return dict(y_bit_equal_when_saving=True, **errs, save_ms=device_ms(s["save"]))


def ops_bound_ms(s: dict) -> tuple[float, float, dict]:
    """A site's operations over the card's peak: -> (the bound, the fp32-FMA time, the row's
    extra fields). A site with ``tf32x3`` runs its products on the tensor cores, three TF32
    products each; its bound is theirs, the FMA time reported beside it."""
    fma_ms = s["flops"] / PEAK_FP32_FLOP_PER_S * 1e3
    if not s.get("tf32x3"):
        return fma_ms, fma_ms, {}
    tf32_ms = 3 * s["flops"] / PEAK_TF32_FLOP_PER_S * 1e3
    return tf32_ms, fma_ms, dict(tf32x3_bound_ms=tf32_ms, fp32_fma_bound_ms=fma_ms)


def check_and_time(sites: list[dict], tag: str = "kernel") -> list[dict]:
    rows = []
    for s in sites:
        abs_err, rel = compare_forward(s)
        oracle = {}
        if "general" in s or s.get("traced"):
            if not bit_equal_calls(s["run"]):
                raise AssertionError(f"{s['name']}: two calls of the kernel are not bit-equal")
            oracle = dict(bit_equal_over_two_calls=True)
        if "general" in s:  # compare_forward held it bit for bit to the general kernel
            oracle.update(bit_equal_to_general=True, general_ms=device_ms(s["general"]))
        if "general_close" in s:  # and within tolerance of it
            oracle.update(within_tolerance_of_general=True,
                          general_ms=device_ms(s["general_close"]))
        if "weights_l2" in s:
            oracle.update(weights_l2_bytes=s["weights_l2"][0], weights_l2_readers=s["weights_l2"][1])
        if "save" in s:
            oracle = compare_saves(s)
        bytes_ms = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        flops_ms, fma_ms, more = ops_bound_ms(s)
        oracle.update(more)
        rows.append(dict(
            name=s["name"], kernel=s["kernel"], shape=s["shape"], replaces=s["replaces"],
            calls_per_batch=s["calls_per_batch"], max_abs_err=abs_err, max_rel_err=rel,
            ms=device_ms(s["run"]), eager_ms=eager_ms(s["run"]),
            plain_ms=device_ms(s["plain"]),
            library_ms=device_ms(s["library"]) if s["library"] else None,
            cudnn_conv_ms=device_ms(s["cudnn_conv"]) if "cudnn_conv" in s else None,
            yardstick=s.get("yardstick", "cuDNN conv") if "cudnn_conv" in s else None,
            bytes=s["bytes"], flops=s["flops"], bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations", **oracle))
        r = rows[-1]
        print(f"[{tag}] {r['name']:<16} {r['shape']:<34} max_abs_err {r['max_abs_err']:.3e} "
              f"max_rel_err {r['max_rel_err']:.3e}  {r['ms'] * 1e3:8.2f} us (eager "
              f"{r['eager_ms'] * 1e3:.2f})  plain "
              f"{r['plain_ms'] * 1e3:8.2f} us  bound {r['bound_ms'] * 1e3:6.2f} us "
              f"({r['bound_by']}" + (f", 3xTF32; as fp32 FMAs {fma_ms * 1e3:.2f} us"
                                     if s.get("tf32x3") else "") + ")"
              + (f"  {r['yardstick']} (double dagger) "
                                      f"{r['cudnn_conv_ms'] * 1e3:.2f} us"
                                      if r["cudnn_conv_ms"] is not None else "")
              + (f"  weights read from L2 {r['weights_l2_bytes'] / 1e6:.2f} MB a call "
                 f"({r['weights_l2_readers']})" if "weights_l2" in s else "")
              + (f"  bit-equal to the general kernel ({r['general_ms'] * 1e3:.2f} us) and over "
                 "two calls" if "general" in s else "")
              + ("  bit-equal over two calls" if s.get("traced") else "")
              + (f"  the general kernel {r['general_ms'] * 1e3:.2f} us, within tolerance"
                 if "general_close" in s else "")
              + (f"  saving d1, d2 {r['save_ms'] * 1e3:.2f} us (y bit-equal, d1 / d2 max_abs_err "
                 f"{r['saved_d1_max_abs_err']:.3e} / {r['saved_d2_max_abs_err']:.3e}; vs float64 "
                 + ", ".join(f"{k} {r[f'{k}_err_vs_f64']:.2e} "
                             f"(plain {r[f'plain_{k}_err_vs_f64']:.2e})"
                             for k in ("y", "d1", "d2")) + ")"
                 if "save" in s else ""), flush=True)
    # the device kernels of the sites with a second oracle, traced once every site is timed: the
    # device times of small kernels read a few tenths of a us longer after a profiler session
    for r, s in zip(rows, sites):
        if "general" in s or s.get("traced"):
            r["device_kernels"] = device_kernels(s["run"])
            print(f"[{tag}] {r['name']}: kernels " + ", ".join(
                f"{k} x{v}" for k, v in r["device_kernels"].items()), flush=True)
            check_device_kernel(s, r["device_kernels"], tag)
    return rows


def check_device_kernel(s: dict, seen: dict[str, int], tag: str) -> None:
    """Where a site names the device kernel its call must launch (``device_kernel``), a CUDA
    graph of the call (device_kernels) holds that kernel once and nothing else."""
    want = s.get("device_kernel")
    if want is None:
        return
    if seen != {want: 1}:
        raise AssertionError(f"{s['name']}: the call launched {seen}, not {want} once")


def conv_yardstick(site_rows: list[dict], kernel: str, key: str) -> dict:
    """{key: the double-dagger cuDNN conv time of a kernel's call sites, each times its calls
    per batch} over the sites that have one; {} where none has."""
    ms = [r["cudnn_conv_ms"] * r["calls_per_batch"] for r in site_rows
          if r["kernel"] == kernel and r["cudnn_conv_ms"] is not None]
    return {key: sum(ms)} if ms else {}


def per_call_sum(site_rows: list[dict], kernel: str, key: str) -> float:
    """The sum of ``key`` over a kernel's call sites, each times its calls per batch."""
    return sum(r[key] * r["calls_per_batch"] for r in site_rows if r["kernel"] == kernel)


def kernel_rows(site_rows: list[dict], names, launches: dict[str, int], per: str,
                extra: dict[str, dict]) -> list[dict]:
    """One row per kernel wrapper, its numbers summed over its call sites
    (each times its calls per batch); ``launches`` from a main path's run,
    ``extra`` more fields by name; ``general_ms`` where every site timed the
    general kernel beside its own."""
    out = []
    for name in names:
        rs = [r for r in site_rows if r["kernel"] == name]

        def total(key):
            return sum(r[key] * r["calls_per_batch"] for r in rs)

        bytes_ms = sum(r["bound_ms"] * r["calls_per_batch"] for r in rs if r["bound_by"] == "bytes")
        replaces = list(dict.fromkeys(r["replaces"] for r in rs))
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=replaces[0],
            also_replaces=replaces[1:], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if bytes_ms >= total("bound_ms") / 2 else "operations",
            library_ms=(total("library_ms") if all(r["library_ms"] is not None for r in rs)
                        else None),
            per=per, **({"general_ms": total("general_ms")}
                        if all("general_ms" in r for r in rs) else {}),
            **extra.get(name, {})))
    return out


def serve_main_path(model: IInsVAE, cpu_model: IInsVAE, recon: bool,
                    expected: dict[str, int]) -> tuple[dict, dict]:
    """3 batches of 500 and one of 137 through Predictor(device='cuda'),
    without or with the reconstruction, counted (``expected`` launches a
    batch), and compared with the CPU Predictor on the same weights."""
    rng = np.random.default_rng(0)
    requests = [rng.normal(size=(n, model.cir_len)).astype(np.float32)
                for n in (500, 500, 500, 137)]
    gpu = Predictor(model, batch_size=BATCH, return_recon=recon, device="cuda")
    kernels.reset_launch_counts()
    outs = [gpu(r) for r in requests]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    for name, per in expected.items():
        if launches[name] != per * len(requests):
            raise AssertionError(f"{name}: {launches[name]} launches on the main path "
                                 f"(recon={recon}), expected {per} x {len(requests)} batches")
    cpu = Predictor(cpu_model, batch_size=BATCH, return_recon=recon, device="cpu")
    errs, label_mismatch = {}, 0
    for r, got in zip(requests, outs):
        want = cpu(r)
        for f in ("err_est", "label_probs", "env_code") + (("recon",) if recon else ()):
            a, b = getattr(got, f), getattr(want, f)
            if a.shape != b.shape or not np.isfinite(a).all():
                raise AssertionError(f"{f}: shape {a.shape} (want {b.shape}) or non-finite")
            np.testing.assert_allclose(a, b, rtol=SERVE_RTOL, atol=SERVE_ATOL, err_msg=f)
            errs[f] = max(errs.get(f, 0.0), float(np.abs(a - b).max()))
        # a label may flip only where the CPU's top two classes tie within tolerance
        top2 = np.sort(want.label_probs, axis=1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * SERVE_ATOL
        if (got.label[clear] != want.label[clear]).any():
            raise AssertionError("labels differ from the CPU path")
        label_mismatch += int((got.label != want.label).sum())
    result = dict(conv_type=model.encoder.conv_type, recon=recon,
                  requests=[len(r) for r in requests], launches=launches,
                  launches_per_batch=sum(launches.values()) // len(requests),
                  max_abs_err_vs_cpu=errs, label_mismatches_within_ties=label_mismatch)
    print(f"[serve] main path: {result}", flush=True)
    return result, launches


def traced_idle_share(p: Predictor, batches: list[np.ndarray]) -> dict:
    """Serve ``batches`` under torch.profiler (CUDA activity only) and read
    the trace: device busy time = the union of the card's kernel and copy
    intervals, over the host's wall time of the served batches. The
    profiler's own host cost is inside the wall time, so this share is an
    upper bound on the untraced one."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            p(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_events, busy_us = device_busy(prof)
    return dict(device_events=n_events, device_busy_us=busy_us, wall_us=wall_us,
                device_busy_us_per_batch=busy_us / len(batches),
                device_idle_share=1.0 - busy_us / wall_us if n_events else None,
                top_device_ops_per_batch=top_device_ops(prof, len(batches)))


def top_device_ops(prof, per: int, top: int = 10) -> list[dict]:
    """The ops (kernels and copies) that take the most device time in a
    torch.profiler trace, per step or batch (``per`` of them traced)."""
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return [dict(name=e.key[:80], device_us=e.self_device_time_total / per, calls=e.count / per)
            for e in events[:top]]


def device_busy(prof) -> tuple[int, float]:
    """(device events, µs the card was busy): the union of the kernel and
    copy intervals of a torch.profiler trace."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return len(spans), busy_us


def throughput(model: IInsVAE, recon: bool, sizes=(500, 256), n_batches: int = 120) -> dict:
    """Per-request path (host arrays in, host arrays out) at each batch size,
    without or with the reconstruction; one forward of that path on a
    resident batch, on the device (graph) and eager; the device's idle
    share over 40 served batches, from a trace."""
    rng = np.random.default_rng(1)
    res = {}
    for bs in sizes:
        p = Predictor(model, batch_size=bs, return_recon=recon, device="cuda")
        data = rng.normal(size=(n_batches * bs, 157)).astype(np.float32)
        p(data[:bs])
        lat = []
        t_all = time.perf_counter()
        for i in range(n_batches):
            t0 = time.perf_counter()
            p(data[i * bs:(i + 1) * bs])
            lat.append((time.perf_counter() - t0) * 1e3)
        wall = time.perf_counter() - t_all
        x = torch.from_numpy(data[:bs]).cuda()
        with torch.inference_mode():
            fwd_ms, fwd_eager_ms = device_ms(lambda: p.forward_batch(x)), eager_ms(
                lambda: p.forward_batch(x))
        median_lat = statistics.median(lat)
        trace = traced_idle_share(p, [data[i * bs:(i + 1) * bs] for i in range(40)])
        res[bs] = dict(cir_per_s=n_batches * bs / wall, batch_latency_ms_median=median_lat,
                       batch_latency_ms_p90=float(np.percentile(lat, 90)),
                       forward_device_ms=fwd_ms, forward_eager_ms=fwd_eager_ms,
                       batches=n_batches, trace=trace)
        idle = trace["device_idle_share"]
        print(f"[serve] conv_type {model.encoder.conv_type} "
              f"{'recon' if recon else 'no recon'} batch {bs}: "
              f"{res[bs]['cir_per_s']:.1f} CIR/s, latency median "
              f"{median_lat:.3f} ms, forward {fwd_ms:.4f} ms on the device "
              f"({fwd_eager_ms:.4f} ms eager), device idle over 40 traced batches "
              f"{'not measured (no device events)' if idle is None else f'{idle:.4f}'} "
              f"({trace['device_events']} device events)", flush=True)
    return res


def _tensors(out) -> list[torch.Tensor]:
    """The tensors of a backward wrapper's nested result, None dropped."""
    if out is None:
        return []
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in _tensors(o)]


def conv_backward_call(x, taps, y, g, stride: int, padding: int, pad_mode: str, need_dx: bool):
    """One aten.convolution_backward call (cuDNN) on the same data laid out
    channels-first: the ReLU-masked gradient, the (reflect-padded) input and
    the taps are prepared outside the timed call. With a reflect pad its dx
    is that of the padded input (the edge rows are not folded back)."""
    with torch.no_grad():
        xc = x.transpose(1, 2).contiguous()
        if pad_mode == "reflect":
            xc, padding = F.pad(xc, (padding, padding), mode="reflect"), 0
        w = taps.detach().permute(2, 1, 0).contiguous()
        gz = (g * (y > 0)).transpose(1, 2).contiguous()
    return lambda: torch.ops.aten.convolution_backward(
        gz, xc, w, [w.shape[0]], [stride], [padding], [1], False, [0], 1,
        [need_dx, True, True])


def conv3x3_backward_call(x: torch.Tensor, taps: torch.Tensor, g: torch.Tensor):
    """One aten.convolution_backward call (cuDNN, TF32 off) of one of K7's
    3x3 reflect-pad convs on the same data as a channels-last NCHW view
    (the padded input and the taps prepared outside the timed call; its dx
    is the padded input's). It stands beside K7b as the time of two of the
    four conv-sized products K7b computes, not as its library time."""
    with torch.no_grad():
        xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect").contiguous(
            memory_format=torch.channels_last)
        w = taps.detach().permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        gc = g.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    return lambda: torch.ops.aten.convolution_backward(
        gc, xp, w, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [True, True, False])


def mlp_bwd_site(name: str, head, replaces: str, b: int, rand, rand_yard) -> dict:
    """K4b's call at a head at batch b, from the pre-activations K4 saves: the backward site
    dict of backward_sites, two fp32 torch.mm calls (dx and dW of the head's largest layer) on
    ``rand_yard``'s data as its double-dagger yardstick."""
    n = len(head.slopes)
    ws = [getattr(head, f"w{j}") for j in range(n)]
    bs = [getattr(head, f"b{j}") for j in range(n)]
    x = rand(b, ws[0].shape[0])
    with torch.no_grad():
        _, ds = fused.launch_mlp_chain(x, ws, bs, head.slopes, save_pre=True)
    g = rand(b, ws[-1].shape[1])
    # the yardstick: dx and dW of the largest layer (the restorers' 512 -> 256), two
    # fp32 torch.mm calls on the same batch
    j = max(range(n), key=lambda i: ws[i].numel())
    y_j, gd_j = rand_yard(b, ws[j].shape[0]), rand_yard(b, ws[j].shape[1])
    w_t = ws[j].detach().t()
    args = (g, x, ws, bs, head.slopes, ds)
    return dict(
        name=name, kernel=backward.mlp_chain_bwd.__name__, replaces=replaces, calls_per_batch=1,
        run=lambda: backward.mlp_chain_bwd(*args),
        plain=lambda: backward.PLAIN[backward.mlp_chain_bwd](*args), library=None,
        bytes=nbytes(x, *ws, *ds, g, x, *ws, *bs), flops=2 * 2.0 * b * sum(w.numel() for w in ws),
        cudnn_conv=lambda: (torch.mm(gd_j, w_t), torch.mm(y_j.t(), gd_j)),
        yardstick=f"torch.mm pair (dx, dW) of its {ws[j].shape[0]}->{ws[j].shape[1]} layer")


def backward_sites(model: IInsVAE, gen: torch.Generator, b: int = BATCH) -> list[dict]:
    """Every backward kernel call of one training step at batch b (500 unless
    a ragged check asks for another): the
    forward call sites with the model's weights, seeded random inputs and
    upstream gradients of the right shape, and the input gradient only where
    the step needs one (not at the two convs that read the pooled CIR).
    Bound: each input read once and each output written once; operations of
    d(taps), dx and, where the kernel recomputes it, the forward."""
    re_, ee = model.encoder.range_encoder, model.encoder.env_encoder
    dec = model.decoder.decoder
    dev = next(model.parameters()).device
    fp = "iinsvae_tpu/ops/pallas/fused.py"
    sites = []

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    yard_gen = torch.Generator().manual_seed(99)  # the yardsticks' data, apart from the sites'

    def rand_yard(*shape):
        return torch.randn(shape, generator=yard_gen).to(dev)

    def add(name, wrapper, replaces, calls, args, kw, nbytes_, flops, library=None,
            plain_kw=None, **more):
        plain = backward.PLAIN[wrapper]
        sites.append(dict(
            name=name, kernel=wrapper.__name__, replaces=replaces, calls_per_batch=calls,
            run=lambda: wrapper(*args, **kw), plain=lambda: plain(*args, **kw, **(plain_kw or {})),
            library=library, bytes=nbytes_, flops=flops, **more))

    def in_chain_site(name, x, stages, replaces, residual=False, calls=1, need_dx=True,
                      **more):
        l, conv, widest = x.shape[1], 0.0, (0.0, None)
        for taps, st, pd, mode in stages:
            f = conv_flops(b, l, taps, st, pd, mode)
            conv += f
            widest = max(widest, (f, (l, taps, st, pd, mode)), key=lambda w: w[0])
            l = out_len(l, taps.shape[0], st, pd)
        taps = [st[0] for st in stages]
        g = rand(b, l, taps[-1].shape[2])
        first = conv_flops(b, x.shape[1], *stages[0])
        if "cudnn_conv" not in more:  # the widest conv's backward, input gradient included
            l_w, t_w, st_w, pd_w, mode_w = widest[1]
            x_w = rand_yard(b, l_w, t_w.shape[1])
            y_w = torch.ones((b, out_len(l_w, t_w.shape[0], st_w, pd_w), t_w.shape[2]),
                             device=dev)
            more["cudnn_conv"] = conv_backward_call(x_w, t_w, y_w, rand_yard(*y_w.shape), st_w,
                                                    pd_w, mode_w, True)
        add(name, backward.in_chain_bwd, replaces, calls, (g, x, stages),
            dict(residual=residual, need_dx=need_dx),
            nbytes(x, g, *taps, *taps) + (nbytes(x) if need_dx else 0),
            3 * conv - (0 if need_dx else first), **more)

    def conv_site(name, wrapper, x, taps, bias, st, pd, mode, replaces, need_dx=True):
        with torch.no_grad():
            y = fused.conv_bias_act(x, taps, bias, stride=st, padding=pd, pad_mode=mode)
        g = rand(*y.shape)
        kw, more = dict(need_dx=need_dx), {}
        if wrapper is backward.conv_bias_act_bwd:
            kw.update(stride=st, padding=pd, pad_mode=mode)
            more["general"] = lambda: wrapper(g, x, taps, bias, y, **kw, general=True)
        add(name, wrapper, replaces, 1, (g, x, taps, bias, y), kw,
            nbytes(x, taps, bias, y, g, taps, bias) + (nbytes(x) if need_dx else 0),
            (2 if need_dx else 1) * conv_flops(b, x.shape[1], taps, st, pd, mode),
            library=conv_backward_call(x, taps, y, g, st, pd, mode, need_dx), **more)

    def add_mlp(name, head, replaces):
        sites.append(mlp_bwd_site(name, head, replaces, b, rand, rand_yard))

    if model.encoder.conv_type == 2:
        for name, mod, affine in (("range.res2d", re_, []),
                                  ("dec.res2d", dec, [rand(b, 64) for _ in range(4)])):
            x, k1, k2, g = rand(b, 8, 8, 64), mod.res0_kernel1, mod.res0_kernel2, \
                rand(b, 8, 8, 64)
            with torch.no_grad():  # the pre-norm conv outputs K7 saves for K7b
                _, d1, d2 = res2d.launch_res_block_2d(x, k1, k2, *affine, save=True)
            # four conv-sized products: dk2, dy1, dk1, dx
            add(name, backward.res_block_2d_bwd, f"{RES2D}:377", 3, (g, x, k1, k2, *affine),
                dict(saved=(d1, d2)),
                nbytes(x, d1, d2, k1, k2, *affine[:3], g, x, k1, k2, *affine),
                4 * res2d_flops(b), tf32x3=True, cudnn_conv=conv3x3_backward_call(x, k1, g))
        add_mlp("restorer.2d", model.restorer.restorer, f"{fp}:1136")
        return sites
    stages = [(re_.in_kernel, 1, 3, "reflect")] + [
        (getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)]
    in_chain_site("range.pair0", rand(b, 128, 1), stages[0:2], f"{fp}:333", need_dx=False)
    in_chain_site("range.pair1", rand(b, 64, 8), stages[2:4], f"{fp}:333")
    in_chain_site("range.single", rand(b, 16, 32), stages[4:5], f"{fp}:1201")
    x = rand(b, 8, 64)
    in_chain_site("range.res", x,
                  [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")],
                  f"{fp}:225", residual=True, calls=3,
                  cudnn_conv=conv_backward_call(x, re_.res0_kernel1, torch.ones_like(x),
                                                torch.randn_like(x), 1, 1, "reflect", True))
    conv_site("range.out", backward.conv_bias_act_bwd, rand(b, 8, 64), re_.out_kernel,
              re_.out_bias, 1, 0, "zero", f"{fp}:1268")
    c0, c1, c2 = ee.ConvINAct_0, ee.ConvINAct_1, ee.ConvINAct_2
    conv_site("env.in", backward.conv_bias_act_bwd, rand(b, 128, 1), c0.kernel, c0.bias, 1,
              3, "reflect", f"{fp}:1268", need_dx=False)
    sc = "iinsvae_tpu/ops/pallas/strided_conv.py:211"
    conv_site("env.down0", backward.strided_conv_bwd, rand(b, 128, 16), c1.kernel, c1.bias,
              2, 1, "zero", sc)
    conv_site("env.down1", backward.strided_conv_bwd, rand(b, 64, 32), c2.kernel, c2.bias,
              2, 1, "zero", sc)
    add_mlp("restorer", model.restorer.restorer, f"{fp}:1136")
    add_mlp("classifier", model.classifier.classifier, f"{fp}:1136")
    conv_site("dec.in", backward.conv_bias_act_bwd, rand(b, 8, 2), dec.in_kernel,
              dec.in_bias, 1, 0, "zero", f"{fp}:1268")

    x, k1, k2 = rand(b, 8, 64), dec.res0_kernel1, dec.res0_kernel2
    affine = [rand(b, 64) for _ in range(4)]
    g = rand(b, 8, 64)
    add("dec.res", backward.adain_res_block_bwd, f"{fp}:524", 3, (g, x, k1, k2, *affine), {},
        nbytes(x, k1, k2, *affine[:3], g, x, k1, k2, *affine),
        3 * 2 * conv_flops(b, 8, k1, 1, 1, "reflect"),
        cudnn_conv=conv_backward_call(x, k1, torch.ones_like(g), g, 1, 1, "reflect", True))

    xt = rand(b, 8, 64)
    up = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
          for j in range(4)]
    flops, l = 0.0, xt.shape[1]
    for taps, *_ in up:
        k, c_in, c_out = taps.shape
        flops += 2.0 * b * upsampled_rows(l, k, 2) * c_in * c_out
        l *= 2
    flops += conv_flops(b, l, dec.out_kernel, 1, 3, "reflect")
    params = [t for st in up for t in st] + [dec.out_kernel, dec.out_bias]
    l_pool = model.cir_len  # 157, or 152 for the eWine model
    g = rand(b, l_pool)
    xu = upsample_nearest1d(xt, 2)  # stage 0's conv input, (B, 16, 64)
    add("dec.tail", backward.sln_chain_bwd, f"{fp}:996", 1,
        (g, xt, up, dec.out_kernel, dec.out_bias, l_pool), {},
        nbytes(xt, *params, g, xt, *params), 3 * flops,
        plain_kw=dict(pool=adaptive_avg_pool_matrix(l, l_pool, device=dev)),
        cudnn_conv=conv_backward_call(xu, up[0][0], torch.ones_like(xu[..., :32]),
                                      torch.randn_like(xu[..., :32]), 1, 2, "zero", True))
    return sites


def ragged_checks(model: IInsVAE) -> dict:
    """Every 1-D forward and backward kernel call at the batches in RAGGED,
    none a whole number of any kernel's tiles of samples or rows, held to
    its plain version (compare_forward, compare_backward). Returns the
    largest absolute error by batch and call site."""
    out = {}
    for b in RAGGED:
        gen = torch.Generator().manual_seed(20 + b)
        with torch.inference_mode():
            sites = call_sites(model, gen, b)
            errs = {f"{s['kernel']}:{s['name']}": compare_forward(s, f" (batch {b})")[0]
                    for s in sites}
            for s in sites:
                if ("general" in s or "general_close" in s) and not bit_equal_calls(s["run"]):
                    raise AssertionError(f"{s['name']} (batch {b}): two calls of the kernel are "
                                         "not bit-equal")
        errs.update({f"{s['kernel']}:{s['name']}": max(compare_backward(s, f" (batch {b})")[0])
                     for s in backward_sites(model, gen, b)})
        out[b] = errs
        k3 = max(v for k, v in errs.items() if k.startswith("strided_conv"))
        print(f"[ragged] batch {b}: all {len(errs)} 1-D kernel calls within tolerance of their "
              f"plain versions, largest error {max(errs.values()):.3e} (K3, K3b: {k3:.3e}); "
              "K1 at the range chains and the residual blocks, K2 at its call sites, K5 at the "
              "residual blocks and K6 at the decoder tail bit-equal to the general kernel, K4 "
              "within tolerance of it; each of those bit-equal over two calls", flush=True)
    return out


def device_kernels(fn) -> dict[str, int]:
    """The device kernels a call of ``fn`` launches and how many of each, each name without
    its namespace's anonymous part, template arguments and parameters: the kernel nodes of a
    CUDA graph of one call (graph_kernels.launched_kernels; a torch.profiler trace sometimes
    held no device event on the card), the graph replayed and its outputs bit-equal to an
    eager call's, so that the named kernels are the ones that computed them."""
    return graph_kernels.launched_kernels(fn)


def bit_equal_calls(fn) -> bool:
    """Whether two calls of ``fn`` give bit-equal tensors."""
    a, b = _tensors(fn()), _tensors(fn())
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def check_and_time_backward(sites: list[dict], tag: str = "backward") -> list[dict]:
    """Each backward site: every gradient of the kernel against the plain
    version's (compare_backward), bit-equal over two calls, the device kernels a
    call launches, then device times of kernel, plain version and library call
    (CUDA-graph replay); where the site has a general kernel beside its own
    (``general``: K2b's sites), that one held to the plain version too and timed."""
    rows = []
    for s in sites:
        errs, scaled = compare_backward(s)
        if not bit_equal_calls(s["run"]):
            raise AssertionError(f"{s['name']}: two calls of the kernel are not bit-equal")
        general = {}
        if "general" in s:
            compare_backward(dict(s, run=s["general"]), " (general kernel)")
            general = dict(general_ms=device_ms(s["general"]))
        bytes_ms = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        flops_ms, fma_ms, more = ops_bound_ms(s)
        rows.append(dict(
            name=s["name"], kernel=s["kernel"], replaces=s["replaces"],
            calls_per_batch=s["calls_per_batch"], max_abs_err=max(errs),
            max_err_over_scale=max(scaled), grad_max_abs_errs=errs, bit_equal_over_two_calls=True,
            device_kernels=device_kernels(s["run"]),
            ms=device_ms(s["run"]), eager_ms=eager_ms(s["run"]), plain_ms=device_ms(s["plain"]),
            library_ms=device_ms(s["library"]) if s["library"] else None,
            cudnn_conv_ms=device_ms(s["cudnn_conv"]) if "cudnn_conv" in s else None,
            yardstick=s.get("yardstick", "cuDNN conv backward") if "cudnn_conv" in s else None,
            bytes=s["bytes"], flops=s["flops"], bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations", **more, **general))
        r = rows[-1]
        lib = f"{r['library_ms'] * 1e3:8.2f}" if r["library_ms"] is not None else "       -"
        print(f"[{tag}] {r['name']:<13} {r['kernel']:<20} max_abs_err {r['max_abs_err']:.3e} "
              f"(/scale {r['max_err_over_scale']:.2e})  {r['ms'] * 1e3:8.2f} us (eager "
              f"{r['eager_ms'] * 1e3:.2f})  plain {r['plain_ms'] * 1e3:8.2f} us  library {lib} "
              f"us  bound {r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']}"
              + (f", 3xTF32; as fp32 FMAs {fma_ms * 1e3:.2f} us" if more else "") + ")"
              + (f"  {r['yardstick']} (double dagger) {r['cudnn_conv_ms'] * 1e3:.2f} us"
                 if r["cudnn_conv_ms"] is not None else "")
              + "  kernels " + ", ".join(f"{k} x{v}" for k, v in r["device_kernels"].items())
              + (f"  general kernel {r['general_ms'] * 1e3:.2f} us (within tolerance)"
                 if general else ""), flush=True)
    return rows


def train_config(key) -> Config:
    """bench.py's training setting on the synthetic room_full fixture (the eWine fixture for the
    eWine model), for the model ``MODELS[key]``."""
    m = MODELS[key]
    return Config(conv_type=m["conv_type"], env_conv_init=m.get("env_conv_init", "reference"),
                  use_soft=m.get("soft", False), dataset_env="room_full", env_dim=16,
                  dataset_name="ewine" if m["cir_len"] == 152 else "zenodo",
                  synthetic_n=10000, batch_size=BATCH, n_epochs=500, decay_epoch=100,
                  supervision_rate=0.1)


def soft_eps(key, device) -> dict:
    """{"soft_eps": a seeded standard-normal (BATCH, 1) on ``device``} for a model with the
    soft restorer, injected into its step like the mask; {} for any other."""
    if not MODELS[key].get("soft"):
        return {}
    return {"soft_eps": torch.randn((BATCH, 1), generator=torch.Generator().manual_seed(6))
            .to(device)}


def traced_train_steps(trainer, n: int) -> dict:
    """``n`` train steps under torch.profiler (CUDA activity): the card's
    busy time a step and its idle share of the host's wall time."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(7)
    bs, data = trainer.cfg.batch_size, trainer.data
    nb = data["cir"].shape[0] // bs
    batches = [{k: v[(i % nb) * bs:(i % nb + 1) * bs] for k, v in data.items()}
               for i in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(trainer.state, b, gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    n_events, busy_us = device_busy(prof)
    top = top_device_ops(prof, n)
    print("[train] device time a step by op (traced): " + ", ".join(
        f"{o['name'][:48]} {o['device_us']:.1f} us x{o['calls']:g}" for o in top), flush=True)
    return dict(steps=n, device_events_per_step=n_events / n, device_busy_us_per_step=busy_us / n,
                wall_us_per_step=wall_us / n,
                device_idle_share=1.0 - busy_us / wall_us if n_events else None,
                top_device_ops_per_step=top)


def host_profile(trainer, n: int = 5, top: int = 12) -> dict:
    """``n`` train steps under torch.profiler with CPU activity: the host's
    time a step in the optimizer and in the backward pass (inclusive), and
    the ops that take the most self CPU time. The profiler's own cost is
    inside these times."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(8)
    bs, data = trainer.cfg.batch_size, trainer.data
    batches = [{k: v[i * bs:(i + 1) * bs] for k, v in data.items()} for i in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            trainer.train_step(trainer.state, b, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()

    def inclusive_us(prefix):
        return sum(e.cpu_time_total for e in events if e.key.startswith(prefix)) / n

    ops = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return dict(
        steps=n, optimizer_us_per_step=inclusive_us("Optimizer.step"),
        backward_us_per_step=inclusive_us("autograd::engine::evaluate_function"),
        top_self_cpu=[dict(name=e.key, calls_per_step=e.count / n,
                           self_cpu_us_per_step=e.self_cpu_time_total / n) for e in ops])


def _double(a):
    if torch.is_tensor(a):
        return a.detach().double()
    if isinstance(a, (list, tuple)):
        return type(a)(_double(x) for x in a)
    return a


def step_calls_vs_f64(data: dict, key) -> dict:
    """Every backward kernel call of one real training step (the fixture's
    first batch, seeded weights), recorded with its inputs; the kernel's and
    the plain version's (fp32) gradients each against the plain version in
    float64 on the same inputs, as the largest error over the gradient's
    largest magnitude, per backward wrapper. Reported, not asserted: the
    kernels are held to the plain version by check_and_time_backward."""
    calls = []
    originals = list(backward.BACKWARD)
    for w in originals:
        def record(*args, _w=w, **kw):
            out = _w(*args, **kw)
            calls.append((_w, args, kw, out))
            return out
        record.launches = 0
        setattr(backward, w.__name__, record)
    try:
        model = IInsVAE(**MODELS[key], generator=torch.Generator().manual_seed(3)).cuda()
        mask = steps.draw_sup_mask(BATCH, 0.1, "sample",
                                   torch.Generator(device="cuda").manual_seed(5))
        steps.make_semi_grads_fn(0.1)(model, {k: v[:BATCH] for k, v in data.items()},
                                      sup_mask=mask, **soft_eps(key, "cuda"))
        torch.cuda.synchronize()
    finally:
        for w in originals:
            setattr(backward, w.__name__, w)
    out = {}
    for w, args, kw, got in calls:
        plain = backward.PLAIN[w]
        ref = _tensors(plain(*_double(args), **kw))
        row = out.setdefault(w.__name__, dict(kernel=0.0, plain_fp32=0.0, calls=0))
        row["calls"] += 1
        for a, b, c in zip(_tensors(got), _tensors(plain(*args, **kw)), ref):
            scale = c.abs().max().item() or 1.0
            row["kernel"] = max(row["kernel"], (a.double() - c).abs().max().item() / scale)
            row["plain_fp32"] = max(row["plain_fp32"], (b.double() - c).abs().max().item() / scale)
    for name, row in out.items():
        print(f"[train] {name:<20} x{row['calls']} in a step: largest error vs float64, over "
              f"the gradient's scale: kernel {row['kernel']:.2e}, plain fp32 "
              f"{row['plain_fp32']:.2e}", flush=True)
    return out


def step_grads_vs_cpu(data: dict, key) -> dict:
    """One step's gradients on the card and on the CPU (fp32), on the same
    seeded weights, the first batch of the fixture and one injected mask (and
    a soft restorer's eps), each against the CPU port's in float64; for the
    models of CLEAR_STEP on the batch's samples clear of MASK_MARGIN
    (relu_margins of the float64 forward), at least CLEAR_SHARE of it."""
    cpu = IInsVAE(**MODELS[key], generator=torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).cuda()
    f64 = copy.deepcopy(cpu).double()
    batch = {k: v[:BATCH] for k, v in data.items()}
    mask = steps.draw_sup_mask(BATCH, 0.1, "sample", torch.Generator(device="cuda").manual_seed(5))
    eps = soft_eps(key, "cpu")
    n_batch = BATCH
    if key in CLEAR_STEP:
        with torch.no_grad():
            keep = relu_margins(lambda: f64(batch["cir"].cpu().double(),
                                            **{k: v.double() for k, v in eps.items()}))
        keep = keep >= MASK_MARGIN
        if keep.sum().item() < CLEAR_SHARE * BATCH:
            raise AssertionError(f"{keep.sum().item()} of {BATCH} samples clear of MASK_MARGIN")
        batch, mask = {k: v[keep.to(v.device)] for k, v in batch.items()}, mask[keep.cuda()]
        eps = {k: v[keep] for k, v in eps.items()}
        n_batch = int(keep.sum().item())
    grads_fn = steps.make_semi_grads_fn(0.1)
    mg = grads_fn(gpu, batch, sup_mask=mask, **{k: v.cuda() for k, v in eps.items()})
    mc = grads_fn(cpu, {k: v.cpu() for k, v in batch.items()}, sup_mask=mask.cpu(), **eps)
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in batch.items()},
                   sup_mask=mask.cpu().double(), **{k: v.double() for k, v in eps.items()})
    torch.cuda.synchronize()
    loss = {k: (mg[k].item(), mc[k].item(), m64[k].item())
            for k in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env")}
    for k, (a, _, b) in loss.items():
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b) + 1e-6):
            raise AssertionError(f"{k}: {a} on the card, {b} in float64 on the CPU")
    cpu_params, ref = dict(cpu.named_parameters()), dict(f64.named_parameters())
    largest = max(p.grad.abs().max().item() for p in ref.values())
    rows, zero_grad = [], {}
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        scale = want.abs().max().item()
        e_card = (p.grad.cpu().double() - want).abs().max().item()
        if ZERO_GRAD.fullmatch(name):
            zero_grad[name] = e_card / largest
            if not e_card <= ZERO_GRAD_SHARE * largest:
                raise AssertionError(f"gradient {name} (exactly 0): {e_card:.3e} on the card, "
                                     f"the model's largest gradient {largest:.3e}")
            continue
        e_cpu = (cpu_params[name].grad.double() - want).abs().max().item()
        rows.append((e_card / max(e_cpu, 1e-300), e_card, e_cpu, scale, name))
    rows.sort(reverse=True)
    for ratio, e_card, e_cpu, scale, name in rows[:5]:
        print(f"[train] gradient {name}: off float64 by {e_card:.3e} on the card, {e_cpu:.3e} "
              f"on the CPU (largest magnitude {scale:.3e})", flush=True)
    for ratio, e_card, e_cpu, scale, name in rows:
        if not e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * scale:
            raise AssertionError(f"gradient {name}: card off float64 by {e_card:.3e}, the "
                                 f"CPU by {e_cpu:.3e} (largest magnitude {scale:.3e})")
    ratio, _, _, _, ratio_name = rows[0]
    max_err = max(r[1] for r in rows)
    return dict(loss_card_cpu_f64=loss, max_abs_err_vs_f64=max_err, samples=n_batch,
                worst_card_over_cpu_err=ratio, worst_param=ratio_name,
                mask_labeled=int(mask.sum().item()), zero_grad_err_over_largest=zero_grad,
                err_over_scale_card_cpu={r[4]: [r[1] / (r[3] or 1.0), r[2] / (r[3] or 1.0)]
                                         for r in rows})


def train_main_path(key, expected: dict[str, int], expected_bwd: dict[str, int]) -> dict:
    """The training main path of the model ``MODELS[key]`` (the 1-D, the expanded 2-D or the
    column-image model): 3 epochs counted (``expected`` forward and ``expected_bwd`` backward
    launches a step), then throughput, trace and the card-vs-CPU gradients."""
    cfg = train_config(key)
    conv_type = cfg.conv_type
    trainer = train_semi.build(cfg, "cuda")
    data = trainer.data
    n_real = int(data["weight"].sum().item())
    steps_per_epoch = data["cir"].shape[0] // cfg.batch_size
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = loop.train_epochs(trainer.state, trainer.run_epoch, data, 3, seed=cfg.seed)
    torch.cuda.synchronize()
    wall_3 = time.perf_counter() - t0
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    bf16 = {**bf16_counts(backward=False), **bf16_counts(backward=True)}
    soft = {**soft_counts(False), **soft_counts(True)}
    if any(bf16.values()) or any(soft.values()):
        raise AssertionError(f"float32 training launched bfloat16 instances or the soft "
                             f"restorer's: {bf16} {soft}")
    n_steps = trainer.state.step
    for counts, want in ((fwd, expected), (bwd, expected_bwd)):
        for name, per in want.items():
            if counts[name] != per * n_steps:
                raise AssertionError(f"{name}: {counts[name]} launches in {n_steps} training "
                                     f"steps, expected {per} a step")
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite training metrics: {history}")
    if not losses[2] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    print(f"[train] conv_type {conv_type}: 3 epochs of {steps_per_epoch} steps ({n_real} CIRs, "
          f"batch {cfg.batch_size}) "
          f"in {wall_3:.3f} s; loss by epoch {losses}; launches a step: forward "
          f"{sum(fwd.values()) / n_steps:g}, backward {sum(bwd.values()) / n_steps:g}", flush=True)
    for epoch, h in enumerate(history):
        print(f"[train] epoch {epoch}: " + " ".join(f"{k} {h[k]:.6f}" for k in train_semi.LOGGED),
              flush=True)

    timed = 5
    t0 = time.perf_counter()
    loop.train_epochs(trainer.state, trainer.run_epoch, data, 3 + timed, seed=cfg.seed,
                      start_epoch=3)
    wall = time.perf_counter() - t0
    cir_per_s = n_real * timed / wall
    trace = traced_train_steps(trainer, 20)
    host = host_profile(trainer)
    grads = step_grads_vs_cpu(data, key)
    calls_f64 = step_calls_vs_f64(data, key)
    result = dict(
        config=dict(conv_type=conv_type, synthetic_n=cfg.synthetic_n, train_cirs=n_real,
                    batch=cfg.batch_size,
                    supervision_rate=cfg.supervision_rate, n_epochs_schedule=cfg.n_epochs,
                    decay_epoch=cfg.decay_epoch),
        history=history, steps=n_steps, launches=fwd, launches_bwd=bwd, launches_bf16=bf16,
        launches_soft=soft,
        launches_per_step=sum(fwd.values()) / n_steps,
        launches_bwd_per_step=sum(bwd.values()) / n_steps,
        train_cir_per_s=cir_per_s, step_wall_ms=wall / (timed * steps_per_epoch) * 1e3,
        timed_epochs=timed, trace=trace, host_profile=host, grads_vs_cpu=grads,
        backward_calls_vs_f64=calls_f64)
    print(f"[train] conv_type {conv_type}: {cir_per_s:.1f} training CIR/s at batch "
          f"{cfg.batch_size} over {timed} epochs "
          f"(step {result['step_wall_ms']:.3f} ms host wall); traced 20 steps: device busy "
          f"{trace['device_busy_us_per_step']:.1f} us a step of {trace['wall_us_per_step']:.1f} us, "
          f"idle {trace['device_idle_share']}; grads vs float64: card max abs err "
          f"{grads['max_abs_err_vs_f64']:.3e}, at most {grads['worst_card_over_cpu_err']:.2f}x "
          f"the CPU's ({grads['worst_param']})", flush=True)
    print(f"[train] host, profiled: optimizer {host['optimizer_us_per_step']:.1f} us a step, "
          f"backward nodes {host['backward_us_per_step']:.1f} us a step (inclusive); most self "
          "CPU a step: " + ", ".join(f"{o['name']} {o['self_cpu_us_per_step']:.1f} us "
                                     f"x{o['calls_per_step']:g}" for o in host["top_self_cpu"]),
          flush=True)
    return result


def decoder_weights(model: IInsVAE) -> dict:
    """The 1-D decoder's weights that the one-stage ops take, detached: the
    AdaIN block's taps, each up-stage's taps, gamma and beta (the one-stage
    op has no conv bias) and the tail conv."""
    dec = model.decoder.decoder
    return dict(k1=dec.res0_kernel1.detach(), k2=dec.res0_kernel2.detach(),
                ups=[tuple(getattr(dec, f"up{j}_{n}").detach()
                           for n in ("kernel", "gamma", "beta")) for j in range(4)],
                ko=dec.out_kernel.detach(), bo=dec.out_bias.detach())


def one_stage_chain(w: dict, x: torch.Tensor, tables, pool: torch.Tensor,
                    plain: bool = False) -> torch.Tensor:
    """The one-stage phase's chain: x (B, 8, 64) -> the AdaIN block as two
    K8 calls (relu; none with x as the residual) -> four K9 up-stages -> the
    K10 tail -> (B, 157); the plain versions with ``plain``."""
    adain_layer = fused.adain_layer_ref if plain else fused.adain_layer
    sln_layer = fused.sln_layer_ref if plain else fused.sln_layer
    tanh_pool = fused.tanh_pool_ref if plain else fused.tanh_pool
    geo = dict(padding=1, pad_mode="reflect")
    y = adain_layer(x, w["k1"], tables[0], tables[1], act="relu", **geo)
    y = adain_layer(y, w["k2"], tables[2], tables[3], act="none", residual=x, **geo)
    for taps, gamma, beta in w["ups"]:
        y = sln_layer(y, taps, gamma, beta)
    return tanh_pool(y, w["ko"], w["bo"], pool, padding=3, pad_mode="reflect")


def chain_clear_samples(w: dict, x: torch.Tensor, tables) -> torch.Tensor:
    """Whether each sample's every value before a ReLU of the one-stage chain
    (K8's relu stage, the four K9 stages), in float64, is at least
    MASK_MARGIN of the sample's largest such value away from 0: there the
    mask does not depend on the summation order."""
    geo = dict(padding=1, pad_mode="reflect")
    xd, td = x.double(), [t.double() for t in tables]
    h = adain(conv1d(xd, w["k1"].double(), **geo), td[0], td[1])
    pre = [h]
    y = adain(conv1d(torch.relu(h), w["k2"].double(), **geo), td[2], td[3]) + xd
    for taps, gamma, beta in w["ups"]:
        h = sample_layer_norm(conv1d(upsample_nearest1d(y, 2), taps.double(), padding=2),
                              gamma.double(), beta.double())
        pre.append(h)
        y = torch.relu(h)
    clear = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    for h in pre:
        a = h.abs().flatten(1)
        clear &= a.amin(dim=1) >= MASK_MARGIN * a.amax(dim=1)
    return clear


def one_stage_path(w: dict, seed: int) -> dict:
    """The one-stage chain once at batch 500 under autograd (inputs drawn
    from ``seed``), every launch counter set to 0 just before and read just
    after (ONE_STAGE forward and ONE_STAGE_BWD backward launches, none of any
    other kernel). Its output and the gradients of its input, taps and
    tables on the card and of the plain chain in fp32, each against the
    plain chain in float64, are held to the step limit (the card's largest
    error at most STEP_FACTOR times the plain fp32 one's plus STEP_FLOOR of
    the largest magnitude):
    - every tensor, on the samples whose ReLU masks the summation order
      cannot flip (chain_clear_samples), which must be at least CLEAR_SHARE
      of the batch;
    - on the whole batch, sample by sample, the tensors with a row a sample
      (PER_SAMPLE): a sample over the limit must be one whose masks may flip
      (ROADMAP Queue 3, degenerate rows).
    The whole batch's largest errors, card and plain fp32, are reported."""
    gen = torch.Generator().manual_seed(seed)
    dev = w["k1"].device
    x = torch.randn((BATCH, 8, 64), generator=gen).to(dev)
    tables = [torch.randn((BATCH, 64), generator=gen).to(dev) for _ in range(4)]
    gout = torch.randn((BATCH, 157), generator=gen).to(dev)
    pool = adaptive_avg_pool_matrix(128, 157, device=dev)
    names = ["y", "x", "k1", "k2", "gamma1", "beta1", "gamma2", "beta2"] + [
        f"up{j}_{n}" for j in range(4) for n in ("kernel", "gamma", "beta")] + ["ko", "bo"]

    def run(dtype, plain, keep=None):
        rows = [x, *tables] if keep is None else [t[keep] for t in (x, *tables)]
        leaves = [t.detach().to(dtype).requires_grad_(True) for t in
                  [rows[0], w["k1"], w["k2"], *rows[1:], *(t for up in w["ups"] for t in up),
                   w["ko"], w["bo"]]]
        lw = dict(k1=leaves[1], k2=leaves[2], ko=leaves[-2], bo=leaves[-1],
                  ups=[tuple(leaves[7 + 3 * j:10 + 3 * j]) for j in range(4)])
        y = one_stage_chain(lw, leaves[0], leaves[3:7], pool.to(dtype), plain=plain)
        g = gout if keep is None else gout[keep]
        return [y.detach()] + list(torch.autograd.grad(y, leaves, g.to(dtype)))

    def errors(card, plain32, ref):
        out = {}
        for name, a, b, c in zip(names, card, plain32, ref):
            if not torch.isfinite(a).all():
                raise AssertionError(f"one-stage chain: non-finite {name}")
            out[name] = ((a.double() - c).abs().max().item(), (b.double() - c).abs().max().item(),
                         c.abs().max().item())
        return out

    kernels.reset_launch_counts()
    card = run(torch.float32, False)
    torch.cuda.synchronize()
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    want_fwd = {k: ONE_STAGE.get(k, 0) for k in fwd}
    want_bwd = {k: ONE_STAGE_BWD.get(k, 0) for k in bwd}
    if fwd != want_fwd or bwd != want_bwd:
        raise AssertionError(f"one-stage chain: launches {fwd}, {bwd}; expected {ONE_STAGE}, "
                             f"{ONE_STAGE_BWD} and no other kernel")
    plain32, ref = run(torch.float32, True), run(torch.float64, True)
    whole = errors(card, plain32, ref)
    clear = chain_clear_samples(w, x, tables)
    keep = clear.nonzero().flatten()
    if len(keep) < CLEAR_SHARE * BATCH:
        raise AssertionError(f"one-stage chain (seed {seed}): only {len(keep)} of {BATCH} "
                             f"samples clear, fewer than {CLEAR_SHARE:g} of the batch")
    held = errors(run(torch.float32, False, keep), run(torch.float32, True, keep),
                  run(torch.float64, True, keep))
    for name, (e_card, e_plain, scale) in held.items():
        if not e_card <= STEP_FACTOR * e_plain + STEP_FLOOR * scale:
            raise AssertionError(f"one-stage chain {name}: card off float64 by {e_card:.3e}, "
                                 f"the plain fp32 chain by {e_plain:.3e} (scale {scale:.3e}), "
                                 f"on the {len(keep)} clear samples (seed {seed})")
    over = torch.zeros(BATCH, dtype=torch.bool, device=dev)
    for name, a, b, c in zip(names, card, plain32, ref):
        if name in PER_SAMPLE:
            e_card = (a.double() - c).abs().flatten(1).amax(dim=1)
            e_plain = (b.double() - c).abs().flatten(1).amax(dim=1)
            over |= e_card > STEP_FACTOR * e_plain + STEP_FLOOR * c.abs().max()
    if (over & clear).any():
        raise AssertionError(f"one-stage chain (seed {seed}): {int((over & clear).sum())} "
                             f"samples with no ReLU input within {MASK_MARGIN:g} of 0 are off "
                             f"float64 beyond the step limit on the whole batch's run")

    def over_scale(errs):
        return {k: [e_card / (scale or 1.0), e_plain / (scale or 1.0)]
                for k, (e_card, e_plain, scale) in errs.items()}

    whole, held = over_scale(whole), over_scale(held)
    w_card, w_plain, w_held = (max(e, key=lambda k, i=i: e[k][i])
                               for e, i in ((whole, 0), (whole, 1), (held, 0)))
    print(f"[one_stage] chain at batch {BATCH}, seed {seed}: launches {ONE_STAGE} forward, "
          f"{ONE_STAGE_BWD} backward; largest error vs float64 over scale, whole batch: card "
          f"{whole[w_card][0]:.2e} ({w_card}; plain fp32 {whole[w_card][1]:.2e} there), plain "
          f"fp32 {whole[w_plain][1]:.2e} ({w_plain}); {int(over.sum())} samples over the step "
          f"limit, none of the {len(keep)} with no ReLU input within {MASK_MARGIN:g} of 0, on "
          f"which: card {held[w_held][0]:.2e} ({w_held}), plain fp32 {held[w_held][1]:.2e}",
          flush=True)
    return dict(seed=seed, launches=fwd, launches_bwd=bwd, clear_samples=len(keep),
                samples_over_limit=int(over.sum()), err_over_scale_card_plain_whole=whole,
                err_over_scale_card_plain_clear=held)


def one_stage_sites(w: dict, b: int, gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    """Each K8-K10 call of the one-stage chain (seeded inputs of its shape
    at batch b) as a forward site and a backward site, the way call_sites
    and backward_sites build theirs; beside each, one cuDNN conv (or its
    backward) of the same data (TF32 off), marked with a double dagger in
    PERF.md: no single PyTorch call computes the op."""
    dev = w["k1"].device
    fp = "iinsvae_tpu/ops/pallas/fused.py"

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    fwd, bwd = [], []

    def add(name, kernel, replaces, args, kw, bwd_kw, out_shape, in_bytes, flops, bwd_flops,
            yard, yard_bwd):
        """args: the inputs both the forward and the backward wrapper take;
        kw: the forward's keywords (the residual: a forward input only)."""
        f, f_ref = getattr(fused, kernel), getattr(fused, f"{kernel}_ref")
        bw = getattr(backward, f"{kernel}_bwd")
        g = rand(*out_shape)
        grads_bytes = nbytes(*args[:-1]) if kernel == "tanh_pool" else nbytes(*args)
        fwd.append(dict(
            name=name, kernel=kernel, replaces=f"{fp}:{replaces[0]}", calls_per_batch=1,
            shape=f"{tuple(args[0].shape)}->{tuple(out_shape)}",
            run=lambda: f(*args, **kw), plain=lambda: f_ref(*args, **kw), library=None,
            cudnn_conv=yard, bytes=in_bytes + 4 * math.prod(out_shape), flops=flops))
        bwd.append(dict(
            name=name, kernel=f"{kernel}_bwd", replaces=f"{fp}:{replaces[1]}",
            calls_per_batch=1, run=lambda: bw(g, *args, **bwd_kw),
            plain=lambda: backward.PLAIN[bw](g, *args, **bwd_kw), library=None,
            cudnn_conv=yard_bwd, bytes=nbytes(g, *args) + grads_bytes, flops=bwd_flops))

    def conv_bwd(x, taps, padding, pad_mode):
        """The conv's backward (dx and d(taps)) on a random output gradient,
        no ReLU mask."""
        l_out = out_len(x.shape[1], taps.shape[0], 1, padding)
        g = rand(b, l_out, taps.shape[2])
        return conv_backward_call(x, taps, torch.ones_like(g), g, 1, padding, pad_mode, True)

    x, y = rand(b, 8, 64), rand(b, 8, 64)
    conv = conv_flops(b, 8, w["k1"], 1, 1, "reflect")
    for name, inp, taps, act, res in (("adain.relu", x, w["k1"], "relu", None),
                                      ("adain.res", y, w["k2"], "none", x)):
        args = (inp, taps, rand(b, 64), rand(b, 64))
        geo = dict(padding=1, pad_mode="reflect", act=act)
        add(name, "adain_layer", (828, 686), args, dict(geo, residual=res), geo,
            (b, 8, 64), nbytes(*args, *([res] if res is not None else [])), conv, 3 * conv,
            ncl_conv(inp, taps, None, 1, 1, "reflect"), conv_bwd(inp, taps, 1, "reflect"))
    l, c = 8, 64
    for j, (taps, gamma, beta) in enumerate(w["ups"]):
        xs = rand(b, l, c)
        up = upsample_nearest1d(xs, 2)
        flops = 2.0 * b * upsampled_rows(l, 5, 2) * c * (c // 2)
        add(f"sln{j}", "sln_layer", (844, 753), (xs, taps, gamma, beta), {}, {},
            (b, 2 * l, c // 2), nbytes(xs, taps, gamma, beta), flops, 3 * flops,
            ncl_conv(up, taps, None, 1, 2, "zero"), conv_bwd(up, taps, 2, "zero"))
        l, c = 2 * l, c // 2
    xt = rand(b, l, c)
    pool = adaptive_avg_pool_matrix(l, 157, device=dev)
    geo = dict(padding=3, pad_mode="reflect")
    # the pool's operations: its nonzeros (1 or 2 a column), not the dense product
    conv, pooling = conv_flops(b, l, w["ko"], 1, 3, "reflect"), 2.0 * b * int((pool != 0).sum())
    add("tail", "tanh_pool", (855, 799), (xt, w["ko"], w["bo"], pool), geo, geo, (b, 157),
        nbytes(xt, w["ko"], w["bo"], pool), conv + pooling, 3 * conv + pooling,
        ncl_conv(xt, w["ko"], w["bo"], 1, 3, "reflect"), conv_bwd(xt, w["ko"], 3, "reflect"))
    return fwd, bwd


def one_stage_phase(model: IInsVAE) -> dict:
    """[one_stage]: the chain under autograd with its launches counted, every
    call at batch 500 checked and timed, the ragged batch of 5, and the
    cross-checks K8 o K8 = K5 and K9^4 o K10 = K6 (zero stage biases)."""
    w = decoder_weights(model)
    paths = [one_stage_path(w, seed) for seed in (11, 15)]
    fwd_sites, bwd_sites = one_stage_sites(w, BATCH, torch.Generator().manual_seed(12))
    with torch.inference_mode():
        fwd_rows = check_and_time(fwd_sites, tag="one_stage")
    bwd_rows = check_and_time_backward(bwd_sites, tag="one_stage")
    fwd5, bwd5 = one_stage_sites(w, 5, torch.Generator().manual_seed(13))
    ragged = {s["name"]: compare_forward(s, " (batch 5)")[0] for s in fwd5}
    ragged.update({f"{s['kernel']}:{s['name']}": max(compare_backward(s, " (batch 5)")[0])
                   for s in bwd5})
    print(f"[one_stage] batch 5 (ragged tiles): every call within tolerance of its plain "
          f"version, largest error {max(ragged.values()):.3e}", flush=True)

    gen = torch.Generator().manual_seed(14)
    dev = w["k1"].device
    x = torch.randn((BATCH, 8, 64), generator=gen).to(dev)
    g1, b1, g2, b2 = (torch.randn((BATCH, 64), generator=gen).to(dev) for _ in range(4))
    zero = [(t, torch.zeros_like(gm), gm, bt) for t, gm, bt in w["ups"]]
    pool = adaptive_avg_pool_matrix(128, 157, device=dev)
    with torch.inference_mode():
        geo = dict(padding=1, pad_mode="reflect")
        y = fused.adain_layer(x, w["k1"], g1, b1, act="relu", **geo)
        y = fused.adain_layer(y, w["k2"], g2, b2, act="none", residual=x, **geo)
        k5 = fused.adain_res_block(x, w["k1"], w["k2"], g1, b1, g2, b2)
        z = x
        for taps, _, gamma, beta in zero:
            z = fused.sln_layer(z, taps, gamma, beta)
        k10 = fused.tanh_pool(z, w["ko"], w["bo"], pool, padding=3, pad_mode="reflect")
        k6 = fused.sln_chain(x, zero, w["ko"], w["bo"], 157)
    cross = {}
    for name, a, b in (("adain_layer x2 vs adain_res_block", y, k5),
                       ("sln_layer x4 + tanh_pool vs sln_chain", k10, k6)):
        torch.testing.assert_close(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                   msg=lambda m: f"cross-check {name}: {m}")
        cross[name] = (a - b).abs().max().item()
        print(f"[one_stage] cross-check {name}: max abs err {cross[name]:.3e}", flush=True)
    return dict(paths=paths, sites=fwd_rows, backward_sites=bwd_rows, ragged_max_abs_err=ragged,
                cross_checks=cross)


def counted_eval(model: IInsVAE, test: dict, expected: dict[str, int] | None = None) -> dict:
    """``evaluation.evaluate_semi`` on the test split at batch 500, on the model's device; on
    the card with every launch counter set to 0 just before and read just after, ``expected``
    forward launches a batch and no backward launch checked. -> metrics, outputs (the real
    rows), launches."""
    nb = -(-test["cir"].shape[0] // BATCH)
    kernels.reset_launch_counts()
    metrics, outs = evaluate_semi(model, test, BATCH, outputs=True)  # ends on the host
    fwd, bwd = kernels.launch_counts(), kernels.backward_launch_counts()
    if expected is not None:
        for name in fwd:
            if fwd[name] != expected.get(name, 0) * nb:
                raise AssertionError(f"{name}: {fwd[name]} launches in {nb} evaluation batches, "
                                     f"expected {expected.get(name, 0)} a batch")
        if any(bwd.values()):
            raise AssertionError(f"an evaluation launched backward kernels: {bwd}")
    return dict(metrics=metrics, outputs=outs, launches=fwd, launches_bwd=bwd, batches=nb)


def card_vs_cpu(card: dict, cpu: dict, what: str) -> dict:
    """Two counted_eval results of one model on the card and on the CPU: every output within
    the serving tolerance, argmax flips only where the CPU's top-two margin is under
    FLIP_MARGIN (and at most as many), rmse and abs within the serving tolerance, the correct
    count apart by at most the flips."""
    errs = {}
    for k, want in cpu["outputs"].items():
        got = card["outputs"][k]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"{what} {k}: shape {got.shape} (want {want.shape}) or non-finite")
        np.testing.assert_allclose(got, want, rtol=SERVE_RTOL, atol=SERVE_ATOL,
                                   err_msg=f"{what} {k}")
        errs[k] = float(np.abs(got - want).max())
    top2 = np.sort(cpu["outputs"]["logits"], axis=1)[:, -2:]
    near = int(((top2[:, 1] - top2[:, 0]) < FLIP_MARGIN).sum())
    flips = int((card["outputs"]["logits"].argmax(1) != cpu["outputs"]["logits"].argmax(1)).sum())
    if flips > near:
        raise AssertionError(f"{what}: {flips} argmax flips, {near} samples within the margin")
    m, w = card["metrics"], cpu["metrics"]
    for k in ("rmse", "abs"):
        if not abs(m[k] - w[k]) <= SERVE_ATOL + SERVE_RTOL * abs(w[k]):
            raise AssertionError(f"{what} {k}: card {m[k]!r}, CPU {w[k]!r}")
    n = cpu["outputs"]["logits"].shape[0]
    if abs(m["accuracy"] - w["accuracy"]) * n > flips + 1e-3:
        raise AssertionError(f"{what} accuracy: card {m['accuracy']!r}, CPU {w['accuracy']!r}")
    return dict(max_abs_err_vs_cpu=errs, argmax_flips=flips, within_margin=near,
                card_metrics=m, cpu_metrics=w)


def eval_phase() -> dict:
    """[eval] The evaluation slice's paths on the card, in a temporary directory:

    - ``cli.train_semi.main`` at full width (1-D, room_full, 10000 CIRs, batch 500,
      --kl_free_bits 0.5) for EVAL_EPOCHS epochs with EVAL_SCHEDULE: the checkpoint
      directories, ``best.json`` and the keep-last cleanup it leaves; its final checkpoint
      evaluated on the card (17 forward launches a batch, no backward) and restored on the
      CPU and evaluated there (card_vs_cpu), the card's metrics equal to the entry point's
      final ones; the evaluated CIR/s;
    - a run of 2 epochs resumed with ``--epoch 2`` to EVAL_EPOCHS: parameters bit-equal to
      the continuous run's;
    - one epoch with the default environment (nlos), trained and evaluated;
    - the seeded 2-D model's eval step over the fixture's 2000-row test split (8 forward
      launches a batch, no backward), card against CPU."""
    import argparse
    import tempfile

    from iinsvae_torch.cli.common import resolve_data
    from iinsvae_torch.config import add_args, add_train_args, from_args
    from iinsvae_torch.training import checkpoint as ckpt

    def split(cfg: Config) -> dict:
        return dict(zip(("cir", "err", "label"), (torch.from_numpy(a) for a in
                                                  resolve_data(cfg)[1])))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        def run(name: str, *args: str):
            """train_semi.main on EVAL_FLAGS and ``args`` -> its state and final metrics, its
            wall time and its Config (the same flags parsed as it parses them)."""
            argv = EVAL_FLAGS + ["--model_dir", f"{tmp}/{name}/models",
                                 "--out_dir", f"{tmp}/{name}/results", *args]
            t0 = time.perf_counter()
            state, final = train_semi.main(argv)
            wall = time.perf_counter() - t0
            parser = argparse.ArgumentParser()
            parser.add_argument("--device")
            return state, final, wall, from_args(add_train_args(add_args(parser)).parse_args(argv))

        state, final, wall, cfg = run("continuous", "--n_epochs", str(EVAL_EPOCHS),
                                      *EVAL_SCHEDULE)
        model_path, result_path = ckpt.semi_model_dir(cfg), ckpt.semi_result_dir(cfg)
        best, epochs = ckpt.best_epoch(model_path), ckpt.list_epochs(model_path)
        # epoch 0 and 2 checkpointed, each new best of epochs 1-3 saved; keep-last 1 leaves
        # the final epoch and the best
        if best is None or best["epoch"] not in range(1, EVAL_EPOCHS):
            raise AssertionError(f"best.json: {best}")
        if epochs != sorted({best["epoch"], EVAL_EPOCHS}):
            raise AssertionError(f"checkpoints {epochs}, best {best}")
        files = [Path(model_path, f"epoch_{e}", "state.pt") for e in epochs] + [
            Path(result_path, "train_log.log"),
            Path(result_path, f"residuals_zenodo_room_full_{EVAL_EPOCHS}.npz")]
        if not all(f.is_file() for f in files):
            raise AssertionError(f"missing: {[str(f) for f in files if not f.is_file()]}")

        test = split(cfg)
        cpu_model = IInsVAE(**cfg.model_kwargs())
        cpu_model.load_state_dict(ckpt.read_checkpoint(model_path, EVAL_EPOCHS)["model"])
        gpu_model = copy.deepcopy(cpu_model).cuda()
        card = counted_eval(gpu_model, test, EXPECTED_RECON)
        for k in ("rmse", "abs", "accuracy"):
            if card["metrics"][k] != final[k]:
                raise AssertionError(f"{k}: the restored checkpoint's {card['metrics'][k]!r} on "
                                     f"the card, the entry point's final {final[k]!r}")
        # timed before the CPU's evaluation, whose idle worker threads would share the host
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            counted_eval(gpu_model, test)
        eval_cir_per_s = reps * test["cir"].shape[0] / (time.perf_counter() - t0)
        agree = card_vs_cpu(card, counted_eval(cpu_model, test), "1-D checkpoint")

        run("resumed", "--n_epochs", "2", *EVAL_SCHEDULE)
        resumed, final_r, _, _ = run("resumed", "--n_epochs", str(EVAL_EPOCHS), "--epoch", "2",
                                     *EVAL_SCHEDULE)
        differ = [n for (n, p), q in zip(state.model.named_parameters(),
                                         resumed.model.parameters()) if not torch.equal(p, q)]
        if differ or resumed.step != state.step or final_r != final:
            raise AssertionError(f"the resumed run differs from the continuous one: {differ}, "
                                 f"steps {resumed.step} / {state.step}")

        _, final_nlos, wall_nlos, cfg_nlos = run("nlos", "--dataset_env", "nlos", "--n_epochs",
                                                 "1", "--sample_interval", "0",
                                                 "--checkpoint_interval", "-1")
        if not all(np.isfinite(final_nlos[k]) for k in ("rmse", "abs", "accuracy")) or \
                ckpt.list_epochs(ckpt.semi_model_dir(cfg_nlos)) != [1]:
            raise AssertionError(f"the nlos epoch: {final_nlos}")

    cfg_2d = train_config(2)
    test_2d = split(cfg_2d)
    cpu_2d = IInsVAE(**FLAGSHIP_2D, generator=torch.Generator().manual_seed(0))
    card_2d = counted_eval(copy.deepcopy(cpu_2d).cuda(), test_2d, EXPECTED_2D_RECON)
    agree_2d = card_vs_cpu(card_2d, counted_eval(cpu_2d, test_2d), "2-D seeded")

    result = dict(
        config=dict(flags=EVAL_FLAGS, schedule=EVAL_SCHEDULE, epochs=EVAL_EPOCHS),
        final_metrics=final, wall_s=wall, checkpoints=epochs, best=best,
        launches=card["launches"], launches_bwd=card["launches_bwd"],
        batches=card["batches"], launches_per_batch=sum(card["launches"].values()) / card["batches"],
        card_vs_cpu=agree, eval_cir_per_s=eval_cir_per_s, eval_rows=int(test["cir"].shape[0]),
        resumed_bit_equal=True, nlos=dict(final_metrics=final_nlos, wall_s=wall_nlos),
        launches_2d=card_2d["launches"], launches_bwd_2d=card_2d["launches_bwd"],
        launches_per_batch_2d=sum(card_2d["launches"].values()) / card_2d["batches"],
        card_vs_cpu_2d=agree_2d)
    print(f"[eval] 1-D: {EVAL_EPOCHS} epochs through cli.train_semi in {wall:.1f} s, final "
          f"{final}; checkpoints {epochs}, best {best}; an evaluation batch "
          f"{result['launches_per_batch']:g} forward launches, 0 backward; card vs CPU "
          f"{agree['max_abs_err_vs_cpu']}, {agree['argmax_flips']} argmax flips "
          f"({agree['within_margin']} within {FLIP_MARGIN}); {eval_cir_per_s:.1f} evaluated "
          f"CIR/s ({test['cir'].shape[0]} rows, batch {BATCH}); resumed 2 -> {EVAL_EPOCHS} "
          f"bit-equal", flush=True)
    print(f"[eval] nlos: one epoch, final {final_nlos} in {wall_nlos:.1f} s", flush=True)
    print(f"[eval] 2-D seeded: {result['launches_per_batch_2d']:g} forward launches a batch, "
          f"0 backward; card vs CPU {agree_2d['max_abs_err_vs_cpu']}, "
          f"{agree_2d['argmax_flips']} argmax flips ({agree_2d['within_margin']} within "
          f"{FLIP_MARGIN})", flush=True)
    return result


def _times(per: dict[str, int], n: int) -> dict[str, int]:
    return {k: v * n for k, v in per.items()}


def _add(*counts: dict[str, int]) -> dict[str, int]:
    out: dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            out[k] = out.get(k, 0) + v
    return out


def bf16_counts(backward: bool) -> dict[str, int]:
    """The bfloat16 instances' launch counters since the last reset, forward or backward ones,
    each under its ``kernels`` line name (the wrapper's name with ``_bf16``)."""
    return {f"{k}_bf16": v for k, v in kernels.bf16_launch_counts().items()
            if k.endswith("_bwd") == backward}


def soft_counts(backward: bool) -> dict[str, int]:
    """K4's or K4b's launches at the soft restorer since the last reset, under their
    ``kernels`` line names (``mlp_chain[_bwd][_bf16]_soft``)."""
    return {k: v for k, v in kernels.soft_launch_counts().items() if ("_bwd" in k) == backward}


def counted(fn, fwd: dict[str, int], bwd: dict[str, int], what: str):
    """Run ``fn`` with every launch counter set to 0 just before and read just after: every
    forward wrapper launched as ``fwd`` says, every backward one as ``bwd`` (the names of the
    forward wrappers, each with its ``_bwd``, or a backward counter's own name), 0 where they
    say nothing (so every bfloat16 instance, ``<wrapper>_bf16``, and the soft restorer's
    launches, ``<wrapper>_soft``, 0 unless named). -> (fn's result, the forward counts, the
    backward counts), the bfloat16 instances' and the soft restorer's among them."""
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    got_f = {**kernels.launch_counts(), **bf16_counts(backward=False), **soft_counts(False)}
    got_b = {**kernels.backward_launch_counts(), **bf16_counts(backward=True),
             **soft_counts(True)}
    want_b = {k if "_bwd" in k else f"{k}_bwd": v for k, v in bwd.items()}
    for got, want in ((got_f, fwd), (got_b, want_b)):
        for name, n in got.items():
            if n != want.get(name, 0):
                raise AssertionError(f"{what}: {name} launched {n} times, expected "
                                     f"{want.get(name, 0)}")
    return out, got_f, got_b


def relu_margins(fn) -> torch.Tensor:
    """Run ``fn`` (a forward on the CPU, in float64) and return, per sample, the smallest
    |input| of every ReLU and LeakyReLU it applies, each over that input's largest in the
    sample: where it is under MASK_MARGIN, the summation order of an fp32 forward decides
    the unit's mask, and with it the sample's gradient."""
    seen = []
    relu, leaky = torch.relu, F.leaky_relu

    def record(a):
        a = a.detach().abs().flatten(1)
        seen.append(a.amin(1) / a.amax(1).clamp_min(1e-300))

    def relu_(a, *args, **kw):
        record(a)
        return relu(a, *args, **kw)

    def leaky_(a, *args, **kw):
        record(a)
        return leaky(a, *args, **kw)

    torch.relu, F.leaky_relu = relu_, leaky_
    try:
        fn()
    finally:
        torch.relu, F.leaky_relu = relu, leaky
    return torch.stack(seen).amin(0)


def joint_grads_vs_cpu(cpu: torch.nn.Module, batch: dict) -> dict:
    """One joint step's gradients on the card and on the CPU (fp32), on the same seeded weights,
    the fixture's first batch and injected Dropout masks, each against the CPU port's in float64,
    held as step_grads_vs_cpu holds them; the BatchNormEps running stats after the step too.
    The step runs on the batch's samples whose every ReLU and LeakyReLU input (relu_margins, the
    float64 forward in train mode) clears MASK_MARGIN: a unit within it takes its mask from the
    summation order, and with the joint loss's few terms (no reconstruction) one such unit moves
    the range encoder's weight gradients far beyond the fp32 rounding this check bounds. At
    least CLEAR_SHARE of the batch must be clear."""
    from iinsvae_torch.models.layers import dropout_source, draw_dropout_masks

    masks = draw_dropout_masks(cpu, torch.Generator().manual_seed(5), batch["cir"].cpu())
    keep = torch.arange(batch["cir"].shape[0])
    for _ in range(3):  # the heads' batch statistics change with the samples kept
        probe = copy.deepcopy(cpu).double().train()
        with torch.no_grad(), dropout_source(probe, masks={k: v[keep] for k, v in masks.items()}):
            m = relu_margins(lambda: probe(batch["cir"][keep].cpu().double()))
        if bool((m >= MASK_MARGIN).all()):
            break
        keep = keep[m >= MASK_MARGIN]
    else:
        raise AssertionError("no sub-batch clear of MASK_MARGIN in three rounds")
    n_batch = len(batch["cir"])
    if len(keep) < CLEAR_SHARE * n_batch:
        raise AssertionError(f"{len(keep)} of {n_batch} samples clear of MASK_MARGIN")
    batch = {k: v[keep.to(v.device)] for k, v in batch.items()}
    masks = {k: v[keep] for k, v in masks.items()}
    gpu, f64 = copy.deepcopy(cpu).cuda(), copy.deepcopy(cpu).double()
    grads_fn = steps.make_joint_grads_fn()
    mg = grads_fn(gpu, batch, dropout_masks={k: v.cuda() for k, v in masks.items()})
    grads_fn(cpu, {k: v.cpu() for k, v in batch.items()}, dropout_masks=masks)
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in batch.items()}, dropout_masks=masks)
    torch.cuda.synchronize()
    for k in ("loss", "loss_idy", "loss_reg"):
        a, b = mg[k].item(), m64[k].item()
        if not (np.isfinite(a) and abs(a - b) <= 1e-4 * abs(b) + 1e-6):
            raise AssertionError(f"{k}: {a} on the card, {b} in float64 on the CPU")
    rows = []
    for kind, card, fp32, ref in (
            ("gradient", {n: p.grad for n, p in gpu.named_parameters()},
             {n: p.grad for n, p in cpu.named_parameters()},
             {n: p.grad for n, p in f64.named_parameters()}),
            ("running stat", dict(gpu.state_dict()), dict(cpu.state_dict()),
             dict(f64.state_dict()))):
        for name, t in card.items():
            if kind == "running stat" and not name.endswith(("mean", "var")):
                continue
            want = ref[name]
            scale = want.abs().max().item()
            e_card = (t.cpu().double() - want).abs().max().item()
            e_cpu = (fp32[name].double() - want).abs().max().item()
            if not e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * scale:
                raise AssertionError(f"{kind} {name}: card off float64 by {e_card:.3e}, the CPU "
                                     f"by {e_cpu:.3e} (largest magnitude {scale:.3e})")
            rows.append((e_card / max(e_cpu, 1e-300), e_card, e_cpu, scale, f"{kind} {name}"))
    rows.sort(reverse=True)
    return dict(samples=len(keep), batch=n_batch, dropout_masks=sorted(masks),
                loss_card_f64={k: (mg[k].item(), m64[k].item())
                               for k in ("loss", "loss_idy", "loss_reg")},
                checked=len(rows), worst_card_over_cpu_err=rows[0][0], worst=rows[0][4],
                max_abs_err_vs_f64=max(r[1] for r in rows))


def epoch_losses(log_path: Path, tag: str = "") -> list[float]:
    """The loss of each ``[Epoch i/n]`` line of an entry point's log (the lines holding
    ``tag``)."""
    return [float(re.search(r"\[loss: ([-+0-9.eE]+|nan|inf)\]", ln).group(1))
            for ln in log_path.read_text().splitlines() if "[Epoch " in ln and tag in ln]


def joint_head_sites() -> tuple[list[dict], list[dict]]:
    """[joint] K4 and K4b at the joint path's 2-class classifier (nlos: 16 -> 16 -> 32 -> 16 ->
    2, the small-head kernel's <Any> instance; EMNet's seeded weights) against their plain
    versions at batch 500 and at a ragged batch, each K4 call within tolerance of the general
    kernel, bit-equal over two calls and launching head::mlp_head_kernel, timed beside the
    double-dagger yardstick and the bound. Run with the serving sites, before the long
    profiler sessions of the later phases (an empty trace confirms no kernel name)."""
    from iinsvae_torch.models.emnet import EMNet

    head = EMNet(num_classes=2, generator=torch.Generator().manual_seed(0)).cuda() \
        .identifier.classifier
    fp = "iinsvae_tpu/ops/pallas/fused.py"
    k4_rows, k4b_rows = [], []
    for b in (BATCH, RAGGED[1]):
        gen, yard = torch.Generator().manual_seed(40 + b), torch.Generator().manual_seed(97)

        def rand(*shape, gen=gen):
            return torch.randn(shape, generator=gen).cuda()

        def rand_yard(*shape, yard=yard):
            return torch.randn(shape, generator=yard).cuda()

        name = f"classifier.2class (batch {b})"
        with torch.inference_mode():
            site = mlp_site(name, head, f"{fp}:1164", b, rand, rand_yard)
            if site["device_kernel"] != "head::mlp_head_kernel":
                raise AssertionError(f"the 2-class classifier takes {site['device_kernel']}")
            k4_rows += check_and_time([site], tag="joint")
        k4b_rows += check_and_time_backward(
            [mlp_bwd_site(name, head, f"{fp}:1136", b, rand, rand_yard)], tag="joint")
    return k4_rows, k4b_rows


def joint_phase(head_rows: tuple[list[dict], list[dict]]) -> dict:
    """[joint] The supervised joint and separated paths on the card, at full width, batch 500,
    on the synthetic nlos fixture (2 classes):

    - each model's steps counted: EMNet and EMNetLoop (Linear heads, JOINT_STEP launches a step
      each way), EMNetLoop with Conv1d heads (no K4), IdentifierSep (sep-E, SEP_E_STEP),
      RegressorSep (sep-M, SEP_M_STEP); the sep-EM inference of one batch (the identifier once,
      the regressor once a class, no backward);
    - one step's gradients and running stats, card and CPU against float64, for EMNet and for
      EMNetLoop with Conv1d heads (BatchNormEps and Dropout on the card, masks injected);
    - ``head_rows``: joint_head_sites' rows (K4 and K4b at the 2-class classifier);
    - ``cli.run.main`` for JOINT_EPOCHS epochs (counted: each step's and each evaluation batch's
      launches), its loss finite and falling, its checkpoints, a 2 -> 3 resume bit-equal to the
      continuous run, ``cli.evaluate --net joint`` on its final checkpoint;
    - ``cli.run_sep.main`` for SEP_EPOCHS epochs a stage (counted), finite sep-EM soft and hard
      RMSE;
    - EMNet's training CIR/s (host clock, 2 epochs) and the device's busy time a step and idle
      share from a trace of 20 steps (no claim)."""
    import tempfile
    from types import SimpleNamespace

    from iinsvae_torch.cli import evaluate as evaluate_cli
    from iinsvae_torch.cli import run, run_sep
    from iinsvae_torch.cli.common import device_data, parse, train_state
    from iinsvae_torch.models.emnet import EMNet, EMNetLoop, IdentifierSep, RegressorSep
    from iinsvae_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    args, cfg = parse("the entry points' flags", JOINT_FLAGS)
    nc = cfg.num_classes
    data, test = device_data(cfg, torch.device(args.device))
    n_real = int(data["weight"].sum().item())
    steps_per_epoch = data["cir"].shape[0] // BATCH
    batches = [{k: v[i * BATCH:(i + 1) * BATCH] for k, v in data.items()} for i in range(3)]
    no_k4 = {**JOINT_STEP, "mlp_chain": 0}
    conv = dict(enet_type="Conv1d", mnet_type="Conv1d")
    models = {
        "EMNet": (lambda g: EMNet(num_classes=nc, generator=g), steps.make_joint_train_step(),
                  JOINT_STEP),
        "EMNetLoop": (lambda g: EMNetLoop(num_classes=nc, generator=g),
                      steps.make_joint_train_step(), JOINT_STEP),
        "EMNetLoop_conv1d": (lambda g: EMNetLoop(num_classes=nc, **conv, generator=g),
                             steps.make_joint_train_step(), no_k4),
        "IdentifierSep": (lambda g: IdentifierSep(num_classes=nc, generator=g),
                          steps.make_sep_e_train_step(), SEP_E_STEP),
        "RegressorSep": (lambda g: RegressorSep(num_classes=nc, generator=g),
                         steps.make_sep_m_train_step(), SEP_M_STEP)}
    per_step, trained = {}, {}
    for name, (make, step, want) in models.items():
        model = make(torch.Generator().manual_seed(0)).cuda()
        state = train_state(model, cfg, steps_per_epoch)
        gen = torch.Generator(device="cuda").manual_seed(7)
        metrics, fwd, bwd = counted(lambda: [step(state, b, gen) for b in batches],
                                    _times(want, 3), _times(want, 3), f"{name} steps")
        if not all(torch.isfinite(v).all() for m in metrics for v in m.values()):
            raise AssertionError(f"{name}: non-finite step metrics")
        per_step[name] = dict(forward=sum(fwd.values()) / 3, backward=sum(bwd.values()) / 3,
                              by_kernel={k: v // 3 for k, v in fwd.items() if v})
        trained[name] = model
    infer_want = _add(SEP_E_STEP, _times(SEP_M_STEP, nc))
    (_, _, err_est), infer_fwd, _ = counted(
        lambda: steps.sep_em_marginalized_inference(trained["IdentifierSep"],
                                                    trained["RegressorSep"],
                                                    test["cir"][:BATCH], nc),
        infer_want, {}, "sep-EM inference")
    if err_est.shape != (BATCH, 1) or not torch.isfinite(err_est).all():
        raise AssertionError(f"sep-EM inference: {tuple(err_est.shape)} or non-finite")
    print("[joint] launches a step (forward, backward): " + ", ".join(
        f"{k} {v['forward']:g} / {v['backward']:g}" for k, v in per_step.items())
        + f"; sep-EM inference a batch {sum(infer_fwd.values())} forward, 0 backward",
        flush=True)

    grads = {name: joint_grads_vs_cpu(make(torch.Generator().manual_seed(3)), batches[0])
             for name, (make, _, _) in models.items() if name in ("EMNet", "EMNetLoop_conv1d")}
    for name, g in grads.items():
        print(f"[joint] {name} step vs float64 ({g['samples']} of {BATCH} samples clear of "
              f"MASK_MARGIN): {g['checked']} gradients and running stats, "
              f"card max abs err {g['max_abs_err_vs_f64']:.3e}, at most "
              f"{g['worst_card_over_cpu_err']:.2f}x the CPU's ({g['worst']}); dropout masks "
              f"{len(g['dropout_masks'])}", flush=True)

    del trained

    with tempfile.TemporaryDirectory(prefix="chip_smoke_joint_") as tmp:
        def dirs(name: str) -> list[str]:
            return ["--model_dir", f"{tmp}/{name}/models", "--out_dir", f"{tmp}/{name}/results"]

        eval_batches = -(-test["cir"].shape[0] // BATCH)
        n_steps = JOINT_EPOCHS * steps_per_epoch
        t0 = time.perf_counter()
        (state, final), run_fwd, run_bwd = counted(
            lambda: run.main(JOINT_FLAGS + dirs("continuous") + [
                "--n_epochs", str(JOINT_EPOCHS), "--checkpoint_interval", "1",
                "--sample_interval", "0"]),
            _add(_times(JOINT_STEP, n_steps), _times(JOINT_STEP, eval_batches)),
            _times(JOINT_STEP, n_steps), "cli.run")
        wall = time.perf_counter() - t0
        run_cfg = Config(**{**cfg.to_dict(), "model_dir": f"{tmp}/continuous/models",
                            "out_dir": f"{tmp}/continuous/results"})
        losses = epoch_losses(Path(ckpt.joint_result_dir(run_cfg), "training_log.log"))
        if len(losses) != JOINT_EPOCHS or not all(np.isfinite(losses)) or \
                not losses[-1] < losses[0] or \
                not all(np.isfinite(final[k]) for k in ("rmse", "abs", "accuracy")):
            raise AssertionError(f"cli.run: losses {losses}, final {final}")
        epochs = ckpt.list_epochs(ckpt.joint_model_dir(run_cfg))
        if epochs != list(range(JOINT_EPOCHS + 1)):
            raise AssertionError(f"cli.run checkpoints {epochs}")
        run.main(JOINT_FLAGS + dirs("resumed") + ["--n_epochs", "2", "--checkpoint_interval",
                                                  "-1"])
        resumed, final_r = run.main(JOINT_FLAGS + dirs("resumed") + [
            "--n_epochs", str(JOINT_EPOCHS), "--epoch", "2", "--checkpoint_interval", "-1"])
        differ = [n for (n, p), q in zip(state.model.state_dict().items(),
                                         resumed.model.state_dict().values())
                  if not torch.equal(p, q)]
        if differ or resumed.step != state.step or final_r != final:
            raise AssertionError(f"cli.run resumed 2 -> {JOINT_EPOCHS} differs: {differ}")
        evaluated = evaluate_cli.main(JOINT_FLAGS + dirs("continuous") + ["--net", "joint"])
        if {k: evaluated[k] for k in ("rmse", "abs", "accuracy")} != \
                {k: final[k] for k in ("rmse", "abs", "accuracy")}:
            raise AssertionError(f"evaluate --net joint {evaluated}, cli.run's final {final}")
        print(f"[joint] cli.run: {JOINT_EPOCHS} epochs in {wall:.1f} s, loss by epoch {losses}, "
              f"final {final}; checkpoints {epochs}; resumed 2 -> {JOINT_EPOCHS} bit-equal; "
              f"evaluate --net joint equal", flush=True)

        sep_steps = SEP_EPOCHS * steps_per_epoch
        t0 = time.perf_counter()
        sep, sep_fwd, sep_bwd = counted(
            lambda: run_sep.main(JOINT_FLAGS + dirs("sep") + [
                "--n_epochs", str(SEP_EPOCHS), "--checkpoint_interval", "-1"]),
            _add(_times(SEP_E_STEP, sep_steps), _times(SEP_M_STEP, sep_steps),
                 _times(infer_want, eval_batches), _times(SEP_M_STEP, eval_batches)),
            _add(_times(SEP_E_STEP, sep_steps), _times(SEP_M_STEP, sep_steps)), "cli.run_sep")
        wall_sep = time.perf_counter() - t0
        if not all(np.isfinite(sep[k]) for k in ("rmse", "rmse_hard", "accuracy")):
            raise AssertionError(f"cli.run_sep: {sep}")
        print(f"[joint] cli.run_sep: {SEP_EPOCHS} epochs a stage in {wall_sep:.1f} s, {sep}",
              flush=True)

    model = EMNet(num_classes=nc, generator=torch.Generator().manual_seed(0)).cuda()
    state = train_state(model, cfg, steps_per_epoch)
    step = steps.make_joint_train_step()
    run_epoch = loop.make_epoch_runner(step, BATCH)
    loop.train_epochs(state, run_epoch, data, 1, seed=1)  # warm
    timed = 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loop.train_epochs(state, run_epoch, data, 1 + timed, seed=1, start_epoch=1)
    cir_per_s = n_real * timed / (time.perf_counter() - t0)
    trace = traced_train_steps(SimpleNamespace(cfg=cfg, data=data, train_step=step, state=state),
                               20)
    result = dict(
        config=dict(flags=JOINT_FLAGS, joint_epochs=JOINT_EPOCHS, sep_epochs=SEP_EPOCHS,
                    train_cirs=n_real, batch=BATCH),
        launches_per_step=per_step, sep_em_inference_launches=infer_fwd,
        grads_vs_cpu=grads, k4_two_class=head_rows[0], k4b_two_class=head_rows[1],
        run=dict(final=final, losses=losses, wall_s=wall, checkpoints=epochs,
                 resumed_bit_equal=True, evaluate_equal=True),
        run_sep=dict(metrics=sep, wall_s=wall_sep),
        launches_run=run_fwd, launches_run_bwd=run_bwd, launches_sep=sep_fwd,
        launches_sep_bwd=sep_bwd, train_cir_per_s=cir_per_s, timed_epochs=timed, trace=trace,
        wall_s=time.perf_counter() - t_phase)
    print(f"[joint] EMNet: {cir_per_s:.1f} training CIR/s at batch {BATCH} over {timed} epochs "
          f"(host clock); traced 20 steps: device busy {trace['device_busy_us_per_step']:.1f} us "
          f"a step of {trace['wall_us_per_step']:.1f} us, idle {trace['device_idle_share']}; "
          f"phase {result['wall_s']:.1f} s", flush=True)
    return result


def _join_all(threads: list, timeout_s: float = 600.0) -> None:
    """Start the threads and wait for all of them, timeout_s in all."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.0, deadline - time.monotonic()))
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread of the server phase hung")


def served_vs_cpu(cpu_model: IInsVAE, cirs: np.ndarray, err: np.ndarray, label: np.ndarray,
                  extra: np.ndarray, what: str) -> dict:
    """Served rows (err, label, probs, recon) against Predictor(device='cpu') on the same
    weights and CIRs (float32, as the server hands them over): SERVE_RTOL / SERVE_ATOL, a
    label flipped only where the CPU's top two classes tie within tolerance (serve_main_path)."""
    if not (np.isfinite(err).all() and np.isfinite(extra).all()) or (label < 0).any():
        raise AssertionError(f"{what}: a NaN or -1 row came back")
    want = Predictor(cpu_model, batch_size=SERVER_BATCH, return_recon=True,
                     device="cpu")(cirs.astype(np.float32))
    k = want.label_probs.shape[1]
    errs = {}
    for f, a, b in (("err_est", err, want.err_est[:, 0]), ("label_probs", extra[:, :k],
                    want.label_probs), ("recon", extra[:, k:], want.recon)):
        np.testing.assert_allclose(a, b, rtol=SERVE_RTOL, atol=SERVE_ATOL, err_msg=f"{what} {f}")
        errs[f] = float(np.abs(a - b).max())
    top2 = np.sort(want.label_probs, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * SERVE_ATOL
    if (label[clear] != want.label[clear]).any():
        raise AssertionError(f"{what}: labels differ from the CPU path")
    return dict(max_abs_err_vs_cpu=errs,
                label_mismatches_within_ties=int((label != want.label).sum()))


def counted_server(stats: dict, per_batch: dict[str, int], what: str) -> dict:
    """The launch counts since the last reset: each forward kernel per_batch times the
    server's batches, no backward launch, no launch of a bfloat16 instance and none at the
    soft restorer."""
    launches = {**kernels.launch_counts(), **bf16_counts(backward=False), **soft_counts(False)}
    bwd = {**kernels.backward_launch_counts(), **bf16_counts(backward=True), **soft_counts(True)}
    for name, per in per_batch.items():
        if launches[name] != per * stats["batches"]:
            raise AssertionError(f"{what}: {name} launched {launches[name]} times, expected "
                                 f"{per} x {stats['batches']} batches")
    if any(v for k, v in launches.items() if k.endswith(("_bf16", "_soft"))) \
            or any(bwd.values()):
        raise AssertionError(f"{what}: bfloat16, soft or backward launches {launches} {bwd}")
    return {**launches, **bwd}


def check_server_stats(st: dict, rows: int, what: str) -> None:
    if not st["submitted"] == st["rows_posted"] == st["rows_dispatched"] == rows:
        raise AssertionError(f"{what}: {rows} rows sent, stats {st}")
    if st["wait_timeouts"] or st["reclaimed"] or st["pending"]:
        raise AssertionError(f"{what}: timeouts, reclaims or pending rows: {st}")


def serve_entry_point(tmp: str) -> dict:
    """``python -m iinsvae_torch.cli.serve --socket`` in a subprocess (the flagship, seeded):
    one framed request answered, then SIGINT: exit code 0 and the stats line."""
    import os
    import signal
    import threading

    from iinsvae_torch.runtime import socket_client_request

    sock = os.path.join(tmp, "cli.sock")
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "iinsvae_torch.cli.serve", "--dataset_env", "room_full",
           "--socket", sock, "--serve_batch", str(SERVER_BATCH), "--probs", "--recon"]
    proc = subprocess.Popen(cmd, cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(600.0, proc.kill)
    watchdog.start()
    t0 = time.perf_counter()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "Ctrl-C to stop" in line:
                break
        ready_s = time.perf_counter() - t0
        if not any("plane=native" in ln for ln in lines):
            raise AssertionError("serve --socket did not come up:\n" + "".join(lines))
        cirs = np.random.default_rng(9).normal(size=(5, 157))
        err, label, extra = socket_client_request(sock, cirs, timeout_s=120.0, n_extra=5 + 157)
        if not (np.isfinite(err).all() and np.isfinite(extra).all()) or (label < 0).any():
            raise AssertionError("serve --socket answered with NaN or -1 rows")
        proc.send_signal(signal.SIGINT)
        out = "".join(lines) + proc.communicate(timeout=120)[0]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stats = [ln for ln in out.splitlines() if ln.startswith("[serve] stats:")]
    if proc.returncode != 0 or not stats or "5 submitted" not in stats[0]:
        raise AssertionError(f"serve --socket exit code {proc.returncode} after SIGINT:\n{out}")
    return dict(cmd=" ".join(cmd[1:]), ready_s=ready_s, exit_code=proc.returncode,
                stats_line=stats[0])


def server_phase(card: str) -> dict:
    """[server] The serving deployment path on the card (runtime.serve_predictor, the native
    plane, both fronts, serve --socket), before any torch.profiler session:

    - the flagship 1-D model (seeded) as Predictor(device='cuda', batch SERVER_BATCH,
      return_recon=True), one padded batch run first (as the serve CLI does), behind
      serve_predictor(with_probs, with_recon, deadline SERVER_DEADLINE_MS), a SocketFront on
      a temporary path and a TcpFront on an ephemeral port of the loopback;
    - SERVER_CLIENTS client threads, half on each front, each sending SERVER_FRAMES frames of
      1-SERVER_MAX_FRAME CIRs drawn from a seed, and SERVER_LOCAL threads submitting
      in-process beside them, with every launch counter set to 0 just before and read just
      after: each kernel's launches equal the server's batches times its recon count (17 a
      batch); the native plane, every row posted, no timeout, reclaim or rejected frame;
      every row against the CPU Predictor (served_vs_cpu);
    - the 2-D model (seeded) through an in-process server: SERVER_2D_N requests, 8 launches a
      batch, card against CPU;
    - serve_entry_point.
    Prints served rows/s through the fronts, frame latency (median, p90), mean occupancy and
    queue time beside the card (no claim)."""
    import tempfile
    import threading

    from iinsvae_torch.runtime import (SocketFront, TcpFront, serve_predictor,
                                       socket_client_request)

    t_phase = time.perf_counter()
    n_extra = FLAGSHIP["num_classes"] + FLAGSHIP["cir_len"]
    cpu_model = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    gpu = Predictor(copy.deepcopy(cpu_model).cuda(), batch_size=SERVER_BATCH,
                    return_recon=True, device="cuda")
    gpu(np.zeros((1, FLAGSHIP["cir_len"]), np.float32))
    rng = np.random.default_rng(8)
    frames = [[rng.normal(size=(int(rng.integers(1, SERVER_MAX_FRAME + 1)), 157))
               for _ in range(SERVER_FRAMES)] for _ in range(SERVER_CLIENTS)]
    local = rng.normal(size=(SERVER_LOCAL, SERVER_LOCAL_N, 157))
    got = [[None] * SERVER_FRAMES for _ in range(SERVER_CLIENTS)]
    lat_ms = [[] for _ in range(SERVER_CLIENTS)]
    got_local = [[None] * SERVER_LOCAL_N for _ in range(SERVER_LOCAL)]
    with tempfile.TemporaryDirectory(prefix="iins_") as tmp:
        kernels.reset_launch_counts()
        with serve_predictor(gpu, with_probs=True, with_recon=True,
                             deadline_ms=SERVER_DEADLINE_MS) as srv, \
                SocketFront(srv, f"{tmp}/serve.sock") as unix, TcpFront(srv, 0) as tcp:
            addrs = [unix.sock_path, ("127.0.0.1", tcp.port)]

            def client(i):
                for k, f in enumerate(frames[i]):
                    t0 = time.perf_counter()
                    got[i][k] = socket_client_request(addrs[i % 2], f, timeout_s=120.0,
                                                      n_extra=n_extra)
                    lat_ms[i].append((time.perf_counter() - t0) * 1e3)

            def in_process(j):
                for k in range(SERVER_LOCAL_N):
                    got_local[j][k] = srv.submit(local[j, k], timeout_s=120.0)

            t0 = time.perf_counter()
            _join_all([threading.Thread(target=client, args=(i,)) for i in range(SERVER_CLIENTS)]
                      + [threading.Thread(target=in_process, args=(j,))
                         for j in range(SERVER_LOCAL)])
            wall_s = time.perf_counter() - t0
            st, native = srv.stats(), srv.native
            rejected = [unix.rejected_frames, tcp.rejected_frames]
        launches = counted_server(st, EXPECTED_RECON, "[server] 1-D")
        entry = serve_entry_point(tmp)
    if not native:
        raise AssertionError("[server] the server is not on the native plane")
    if any(rejected):
        raise AssertionError(f"[server] rejected frames {rejected}")
    if any(o is None for row in got_local for o in row):
        raise AssertionError("[server] an in-process request timed out")
    front_rows = sum(len(f) for fs in frames for f in fs)
    check_server_stats(st, front_rows + SERVER_LOCAL * SERVER_LOCAL_N, "[server] 1-D")
    cirs = np.concatenate([f for fs in frames for f in fs] + [local.reshape(-1, 157)])
    outs = [g for gs in got for g in gs]
    local_outs = [o for row in got_local for o in row]
    err = np.concatenate([g[0] for g in outs] + [[o[0] for o in local_outs]])
    label = np.concatenate([g[1] for g in outs] + [[o[1] for o in local_outs]])
    extra = np.concatenate([g[2] for g in outs] + [np.stack([o[2] for o in local_outs])])
    vs_cpu = served_vs_cpu(cpu_model, cirs, err, label, extra, "[server] 1-D")
    lat = [x for xs in lat_ms for x in xs]
    one_d = dict(model="1-D flagship, recon and probs", batch=SERVER_BATCH,
                 deadline_ms=SERVER_DEADLINE_MS, clients=SERVER_CLIENTS,
                 frames=SERVER_CLIENTS * SERVER_FRAMES, front_rows=front_rows,
                 in_process_rows=SERVER_LOCAL * SERVER_LOCAL_N, wall_s=wall_s,
                 front_rows_per_s=front_rows / wall_s,
                 rows_per_s=(front_rows + SERVER_LOCAL * SERVER_LOCAL_N) / wall_s,
                 frame_latency_ms_median=statistics.median(lat),
                 frame_latency_ms_p90=float(np.percentile(lat, 90)), stats=st,
                 rejected_frames=rejected, native=native, launches=launches, **vs_cpu)
    print(f"[server] 1-D recon+probs, batch {SERVER_BATCH}, deadline {SERVER_DEADLINE_MS} ms: "
          f"{front_rows} rows in {one_d['frames']} frames through the fronts and "
          f"{one_d['in_process_rows']} in-process in {wall_s:.3f} s: "
          f"{one_d['front_rows_per_s']:.1f} rows/s through the fronts, frame latency median "
          f"{one_d['frame_latency_ms_median']:.3f} ms, p90 {one_d['frame_latency_ms_p90']:.3f} "
          f"ms; {st['batches']} batches, mean occupancy {st['mean_occupancy']:.2f}, mean queue "
          f"{st['mean_queue_ms']:.3f} ms; {sum(launches.values())} launches = 17 x "
          f"{st['batches']}; max err vs CPU {vs_cpu['max_abs_err_vs_cpu']} | {card} (no claim)",
          flush=True)

    cpu_2d = IInsVAE(**FLAGSHIP_2D, generator=torch.Generator().manual_seed(0))
    gpu_2d = Predictor(copy.deepcopy(cpu_2d).cuda(), batch_size=SERVER_BATCH,
                       return_recon=True, device="cuda")
    gpu_2d(np.zeros((1, FLAGSHIP_2D["cir_len"]), np.float32))
    cirs_2d = np.random.default_rng(10).normal(size=(SERVER_2D_N, 157))
    got_2d = [None] * SERVER_2D_N
    kernels.reset_launch_counts()
    with serve_predictor(gpu_2d, with_probs=True, with_recon=True,
                         deadline_ms=SERVER_DEADLINE_MS) as srv:
        def submit_2d(j):
            for k in range(j, SERVER_2D_N, SERVER_CLIENTS):
                got_2d[k] = srv.submit(cirs_2d[k], timeout_s=120.0)

        t0 = time.perf_counter()
        _join_all([threading.Thread(target=submit_2d, args=(j,)) for j in range(SERVER_CLIENTS)])
        wall_2d = time.perf_counter() - t0
        st_2d = srv.stats()
    launches_2d = counted_server(st_2d, EXPECTED_2D_RECON, "[server] 2-D")
    if any(o is None for o in got_2d):
        raise AssertionError("[server] 2-D: a request timed out")
    check_server_stats(st_2d, SERVER_2D_N, "[server] 2-D")
    vs_cpu_2d = served_vs_cpu(cpu_2d, cirs_2d, np.array([o[0] for o in got_2d]),
                              np.array([o[1] for o in got_2d]),
                              np.stack([o[2] for o in got_2d]), "[server] 2-D")
    two_d = dict(model="expanded 2-D, recon and probs, in-process", requests=SERVER_2D_N,
                 wall_s=wall_2d, rows_per_s=SERVER_2D_N / wall_2d, stats=st_2d,
                 launches=launches_2d, **vs_cpu_2d)
    print(f"[server] 2-D recon+probs in-process: {SERVER_2D_N} requests in {wall_2d:.3f} s, "
          f"{st_2d['batches']} batches (mean occupancy {st_2d['mean_occupancy']:.2f}, queue "
          f"{st_2d['mean_queue_ms']:.3f} ms), {sum(launches_2d.values())} launches = 8 x "
          f"{st_2d['batches']}; max err vs CPU "
          f"{vs_cpu_2d['max_abs_err_vs_cpu']} | {card} (no claim)", flush=True)
    print(f"[server] serve --socket: ready in {entry['ready_s']:.1f} s, answered, SIGINT -> "
          f"exit {entry['exit_code']}: {entry['stats_line']}", flush=True)
    result = dict(one_d=one_d, two_d=two_d, entry_point=entry, card=card,
                  launches={k: launches[k] + launches_2d[k] for k in launches},
                  wall_s=time.perf_counter() - t_phase)
    print(f"[server] phase {result['wall_s']:.1f} s", flush=True)
    return result


# ------------------------------------ [bf16] ------------------------------------

BF16 = torch.bfloat16
# H100 SXM data sheet: dense bfloat16 on the tensor cores (the bound of every bfloat16 instance)
PEAK_BF16_FLOP_PER_S = 989e12
# A bfloat16 kernel against float64 on the same bfloat16-rounded inputs: its largest error at
# most BF16_FACTOR times the plain bfloat16 version's, plus BF16_FLOOR of the float64 result's
# largest magnitude (where the plain version happens to be exact); K7's and K7b's per-sample
# tensors on the samples whose every pre-ReLU value clears MASK_MARGIN.
BF16_FACTOR, BF16_FLOOR = 2.0, 2.0**-9
# launches of one bfloat16 training step of the 2-D model: the bfloat16 instances of K7 (3 IN,
# 3 AdaIN blocks) and K4 (2 heads) forward, one backward launch for each; nothing else
EXPECTED_BF16_STEP = {"res_block_2d": 6, "mlp_chain": 2, "res_block_2d_bwd": 6,
                      "mlp_chain_bwd": 2}
# the device kernels a call of each bfloat16 instance launches (a CUDA graph of the call), by
# kernel, or by kernel and site: K4's and K4b's are the bfloat16 instances of the float32
# paths' kernels (the restorer's backward one launch a layer, the weight gradient and the sum)
BF16_DEVICE_KERNELS = {
    "res_block_2d_bf16": {"res2d_bf16_wgmma_kernel": 1},
    "res_block_2d_bwd_bf16": {"res2d_bf16_bwd_wgmma_kernel": 1, "res2d_bf16_dk_kernel": 1,
                              "reduce_rows_bf16_kernel": 1},
    "mlp_chain_bf16 restorer.2d": {"cluster::mlp_cluster_kernel": 1},
    "mlp_chain_bf16 restorer.2d.soft": {"cluster::mlp_cluster_kernel": 1},
    "mlp_chain_bf16 classifier": {"head::mlp_head_kernel": 1},
    "mlp_chain_bf16 classifier.4": {"head::mlp_head_kernel": 1},
    "mlp_chain_bwd_bf16 restorer.2d": {"layer::chain_kernel": 4, "layer::wgrad_kernel": 1,
                                       "reduce_partials_bf16_kernel": 1},
    "mlp_chain_bwd_bf16 restorer.2d.soft": {"layer::chain_kernel": 4, "layer::wgrad_kernel": 1,
                                            "reduce_partials_bf16_kernel": 1},
    "mlp_chain_bwd_bf16 classifier": {"small::small_kernel": 1,
                                      "reduce_partials_bf16_kernel": 1},
    "mlp_chain_bwd_bf16 classifier.4": {"small::small_kernel": 1,
                                        "reduce_partials_bf16_kernel": 1}}
# one bfloat16 step's gradients, card and CPU (the rows of BF16_GRAD_ROWS), each against the
# CPU port in float64 (tests/test_torch_bf16.py holds the CPU port to JAX the same way): the
# mean over the parameters of each one's relative RMS error, the card's at most 1.5 times the
# CPU's plus 2^-8, and each parameter's at most 6 times the CPU's plus 2^-8; bfloat16 rounding
# decides the L1 loss's signs and the ReLU masks in different places on the two devices, so a
# small tensor's error swings by several times between them
BF16_GRAD_ROWS = 200


def _clear_rows(a1: torch.Tensor) -> torch.Tensor:
    """The samples whose every value of a1 (float64, before a ReLU) clears MASK_MARGIN of the
    sample's largest |a1|."""
    a = a1.abs().flatten(1)
    return a.amin(dim=1) >= MASK_MARGIN * a.amax(dim=1)


def _vs_f64(name: str, got, plain, f64, rows=None) -> dict:
    """Each tensor's largest error against float64, kernel and plain bfloat16 version (on
    ``rows`` of the per-sample ones where given), the kernel's at most BF16_FACTOR times the
    plain version's plus BF16_FLOOR of the float64 tensor's largest magnitude."""
    out = []
    for i, (a, p, w) in enumerate(zip(got, plain, f64)):
        if a.shape != w.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{name} tensor {i}: shape {tuple(a.shape)} or non-finite")
        if rows is not None and a.shape[0] == rows.shape[0]:
            a, p, w = a[rows], p[rows], w[rows]
        e, e_plain = ((t.double() - w).abs().max().item() for t in (a, p))
        scale = w.abs().max().item()
        if e > BF16_FACTOR * e_plain + BF16_FLOOR * scale:
            raise AssertionError(f"{name} tensor {i}: {e:.3e} off float64, the plain bfloat16 "
                                 f"version {e_plain:.3e} (largest magnitude {scale:.3e})")
        out.append(dict(err_vs_f64=e, plain_err_vs_f64=e_plain, scale=scale))
    return dict(tensors=out, max_abs_err=max(
        (a.double() - p.double()).abs().max().item() for a, p in zip(got, plain)))


def res2d_library_block(x: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, aff, g):
    """K7's whole bfloat16 block composed of library calls on the same data, as a channels-last
    NCHW view: two cuDNN bfloat16 3x3 convs (F.pad reflect, F.conv2d), the norms
    (ops.norms.instance_norm / adain) and the ReLU and skip as torch ops. -> (forward, forward
    and backward) callables for device_ms (one CUDA graph each): the composition's forward, and
    a forward with the autograd backward to x, the taps and the tables (a backward alone cannot
    be captured: autograd makes the forward's stream wait on it, the legacy stream during
    capture). The backward's time is the second graph's less the first's. A whole-block
    yardstick beside K7 and K7b (its rounding is cuDNN's, with no edge slices), which the port
    never calls."""
    cl = torch.channels_last
    xc = x.permute(0, 3, 1, 2).contiguous(memory_format=cl).requires_grad_(True)
    w1, w2 = (k.detach().permute(3, 2, 0, 1).contiguous(memory_format=cl).requires_grad_(True)
              for k in (k1, k2))
    tables = [t.detach().clone().requires_grad_(True) for t in aff]

    def norm(d, i):
        v = d.permute(0, 2, 3, 1)
        v = adain(v, tables[2 * i], tables[2 * i + 1]) if tables else instance_norm(v)
        return v.permute(0, 3, 1, 2)

    def forward():
        d1 = F.conv2d(F.pad(xc, (1, 1, 1, 1), mode="reflect"), w1)
        d2 = F.conv2d(F.pad(torch.relu(norm(d1, 0)), (1, 1, 1, 1), mode="reflect"), w2)
        return xc + norm(d2, 1)

    def forward_no_grad():
        with torch.no_grad():
            return forward()

    gc = g.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    leaves = [xc, w1, w2, *tables]
    return forward_no_grad, lambda: torch.autograd.grad(forward(), leaves, gc)


def bf16_sites(model: IInsVAE, gen: torch.Generator, b: int = BATCH, extra_heads=()):
    """K7's and K7b's bfloat16 instances at the 2-D model's IN and AdaIN blocks, K4's and K4b's
    at its restorer and classifier (and at ``extra_heads``, (name, Linear head) pairs: the soft
    2-D restorer), at batch b on the model's weights rounded to bfloat16 and
    seeded bfloat16 inputs: each held against float64 on the same inputs beside its plain
    bfloat16 version and timed (CUDA graph replay) beside its bound, its plain version and a
    bfloat16 yardstick (double dagger); K7 and K7b also beside the whole block composed of
    library calls, forward and backward (res2d_library_block). -> (forward rows, backward
    rows)."""
    dev = next(model.parameters()).device

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev).to(BF16)

    fwd, bwd, blocks = [], [], []
    for name, blk, adain_ in (("range.res2d", model.encoder.range_encoder, False),
                              ("dec.res2d", model.decoder.decoder, True)):
        k1, k2 = (getattr(blk, f"res0_kernel{n}").detach().to(BF16) for n in (1, 2))
        x, g = rand(b, 8, 8, 64), rand(b, 8, 8, 64)
        aff = [rand(b, 64) for _ in range(4)] if adain_ else []
        args = (x, k1, k2, *aff)
        a64 = [t.double() for t in args]
        y64, d1_64, d2_64 = res2d.res_block_2d_ref(*a64, save=True)
        a1 = adain(d1_64, a64[3], a64[4]) if adain_ else instance_norm(d1_64)
        rows = _clear_rows(a1)
        if rows.sum().item() < CLEAR_SHARE * b:
            raise AssertionError(f"{name}: {rows.sum().item()} of {b} samples clear")
        y, d1, d2 = res2d.launch_res_block_2d(*args, save=True)
        if not torch.equal(y, res2d.launch_res_block_2d(*args)):
            raise AssertionError(f"{name}: K7's bfloat16 y differs when it saves d1 and d2")
        plain = res2d.res_block_2d_bf16_ref(*args, save=True)
        checks = _vs_f64(name, (y, d1, d2), plain, (y64, d1_64, d2_64), rows)
        flops = 2 * res2d_flops(b)
        bytes_ = nbytes(x, k1, k2, *aff, x)
        fwd.append(dict(
            name=name, kernel="res_block_2d_bf16", replaces=f"{RES2D}:339", per_step=3,
            max_abs_err=checks["max_abs_err"], vs_f64=checks["tensors"],
            clear_samples=int(rows.sum().item()),
            ms=device_ms(lambda: res2d.launch_res_block_2d(*args)),
            save_ms=device_ms(lambda: res2d.launch_res_block_2d(*args, save=True)),
            plain_ms=device_ms(lambda: res2d.res_block_2d_bf16_ref(*args)),
            yardstick_ms=device_ms(nchw_conv3x3(x, k1)),
            yardstick="one cuDNN channels-last bfloat16 3x3 conv of the block",
            flops=flops, bytes=bytes_,
            bound_ms=max(flops / PEAK_BF16_FLOP_PER_S, bytes_ / PEAK_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / PEAK_BF16_FLOP_PER_S >= bytes_ / PEAK_BYTES_PER_S
            else "bytes",
            device_kernels=device_kernels(lambda: res2d.launch_res_block_2d(*args))))
        saved = (d1, d2)
        run = lambda: backward.res_block_2d_bwd(g, *args, saved=saved)  # noqa: E731
        got = _tensors(run())
        want = _tensors(backward.res_block_2d_bwd_bf16_ref(g, *args, saved=saved))
        ref = _tensors(backward.res_block_2d_bwd_closed(g.double(), *a64, saved=(d1_64, d2_64)))
        checks = _vs_f64(name + " backward", got, want, ref, rows)
        flops, bytes_ = 4 * res2d_flops(b), nbytes(x, d1, d2, g, x, k1, k2, k1, k2, *aff)
        bwd.append(dict(
            name=name, kernel="res_block_2d_bwd_bf16", replaces=f"{RES2D}:377", per_step=3,
            max_abs_err=checks["max_abs_err"], vs_f64=checks["tensors"],
            ms=device_ms(run),
            plain_ms=device_ms(lambda: backward.res_block_2d_bwd_bf16_ref(g, *args, saved=saved)),
            yardstick_ms=device_ms(conv3x3_backward_call(x, k1, g)),
            yardstick="one cuDNN bfloat16 3x3 conv backward (dx, dW) of the block",
            flops=flops, bytes=bytes_,
            bound_ms=max(flops / PEAK_BF16_FLOP_PER_S, bytes_ / PEAK_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / PEAK_BF16_FLOP_PER_S >= bytes_ / PEAK_BYTES_PER_S
            else "bytes",
            bit_equal_over_two_calls=bit_equal_calls(run), device_kernels=device_kernels(run)))
        blocks.append((fwd[-1], bwd[-1], (x, k1, k2, aff, g)))
    heads = (("restorer.2d", model.restorer.restorer),
             ("classifier", model.classifier.classifier), *extra_heads)
    head_fwd, head_bwd = bf16_head_sites(heads, b, rand)
    fwd += head_fwd
    bwd += head_bwd
    # K7's and K7b's whole-block library yardsticks, after every other site's timing: their
    # large CUDA graphs timed before the K4 sites left the classifier's saving instance 3.4%
    # slower than its parent's in an A/B
    for rf, rb, data in blocks:
        lib_fwd, lib_both = res2d_library_block(*data)
        rf["composite_ms"] = device_ms(lib_fwd)
        rf["composite"] = ("the whole block as library calls in one CUDA graph: two cuDNN "
                           "channels-last bfloat16 3x3 convs, the norms, ReLU and skip as torch "
                           "ops")
        rb["composite_ms"] = device_ms(lib_both) - rf["composite_ms"]
        rb["composite"] = ("the autograd backward of the whole block as library calls (one "
                           "CUDA graph of its forward and backward, less the forward's)")
    check_bf16_rows(fwd + bwd)
    return fwd, bwd


def bf16_head_sites(heads, b: int, rand) -> tuple[list[dict], list[dict]]:
    """K4's and K4b's bfloat16 instances at ``heads`` ((name, Linear head) pairs), at batch b on
    the heads' weights rounded to bfloat16 and ``rand``'s bfloat16 inputs: each held against
    float64 beside its plain bfloat16 version and timed (CUDA graph replay) beside its bound,
    its plain version and a bfloat16 torch.mm yardstick (double dagger). -> (forward rows,
    backward rows); check_bf16_rows checks their kernels and prints them."""
    fp = "iinsvae_tpu/ops/pallas/fused.py"
    fwd, bwd = [], []
    for name, head in heads:
        n, slopes = len(head.slopes), head.slopes
        ws = [getattr(head, f"w{j}").detach().to(BF16) for j in range(n)]
        bs = [getattr(head, f"b{j}").detach().to(BF16) for j in range(n)]
        x = rand(b, ws[0].shape[0])
        g = rand(b, ws[-1].shape[1])
        y, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
        plain_y, plain_ds = fused.mlp_chain_bf16_ref(x, ws, bs, slopes, save_pre=True)
        h, ds64 = x.double(), []
        for w, v, s in zip(ws, bs, slopes):
            ds64.append(h @ w.double() + v.double())
            h = ds64[-1] if s == 1.0 else F.leaky_relu(ds64[-1], s)
        checks = _vs_f64(name, (y, *ds), (plain_y, *plain_ds), (h, *ds64))
        j = max(range(n), key=lambda i: ws[i].numel())
        xj, gj = rand(b, ws[j].shape[0]), rand(b, ws[j].shape[1])
        flops, bytes_ = 2.0 * b * sum(w.numel() for w in ws), nbytes(x, *ws, *bs, g)
        serve = lambda: fused.mlp_chain(x, ws, bs, slopes)  # noqa: E731
        fwd.append(dict(
            name=name, kernel="mlp_chain_bf16", replaces=f"{fp}:1164", per_step=1,
            max_abs_err=checks["max_abs_err"], vs_f64=checks["tensors"], ms=device_ms(serve),
            save_ms=device_ms(lambda: fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)),
            plain_ms=device_ms(lambda: fused.mlp_chain_bf16_ref(x, ws, bs, slopes)),
            yardstick_ms=device_ms(lambda: torch.mm(xj, ws[j])),
            yardstick=f"one bfloat16 torch.mm of its {ws[j].shape[0]}->{ws[j].shape[1]} layer",
            flops=flops, bytes=bytes_,
            bound_ms=max(flops / PEAK_BF16_FLOP_PER_S, bytes_ / PEAK_BYTES_PER_S) * 1e3,
            bound_by="operations" if flops / PEAK_BF16_FLOP_PER_S >= bytes_ / PEAK_BYTES_PER_S
            else "bytes",
            fp32_fma_bound_ms=flops / PEAK_FP32_FLOP_PER_S * 1e3,
            device_kernels=device_kernels(serve)))
        args = (g, x, ws, bs, slopes, ds)
        run = lambda: backward.mlp_chain_bwd(*args)  # noqa: E731
        got = _tensors(run())
        want = _tensors(backward.mlp_chain_bwd_bf16_ref(*args))
        ref = _tensors(backward.plain_grads(
            lambda x_, *p: fused.mlp_chain_ref(x_, p[:n], p[n:], slopes),
            [x.double(), *(t.double() for t in ws), *(t.double() for t in bs)], g.double()))
        checks = _vs_f64(name + " backward", got, want, ref)
        w_t, bytes_b = ws[j].t(), nbytes(g, x, *ws, *ds, x, *ws, *bs)
        bwd.append(dict(
            name=name, kernel="mlp_chain_bwd_bf16", replaces=f"{fp}:1136", per_step=1,
            max_abs_err=checks["max_abs_err"], vs_f64=checks["tensors"], ms=device_ms(run),
            plain_ms=device_ms(lambda: backward.mlp_chain_bwd_bf16_ref(*args)),
            yardstick_ms=device_ms(lambda: (torch.mm(gj, w_t), torch.mm(xj.t(), gj))),
            yardstick=f"bfloat16 torch.mm pair (dx, dW) of its {ws[j].shape[0]}->"
                      f"{ws[j].shape[1]} layer",
            flops=2 * flops, bytes=bytes_b,
            bound_ms=max(2 * flops / PEAK_BF16_FLOP_PER_S, bytes_b / PEAK_BYTES_PER_S) * 1e3,
            bound_by="operations" if 2 * flops / PEAK_BF16_FLOP_PER_S
            >= bytes_b / PEAK_BYTES_PER_S else "bytes",
            fp32_fma_bound_ms=2 * flops / PEAK_FP32_FLOP_PER_S * 1e3,
            bit_equal_over_two_calls=bit_equal_calls(run), device_kernels=device_kernels(run)))
    return fwd, bwd


def check_bf16_rows(rows: list[dict]) -> None:
    """Each bfloat16 row's device kernels against BF16_DEVICE_KERNELS and a backward call
    bit-equal over two calls (each failure raises); one line a row."""
    for r in rows:
        if r["kernel"].endswith("_bwd_bf16") and not r["bit_equal_over_two_calls"]:
            raise AssertionError(f"{r['name']} {r['kernel']}: two calls are not bit-equal")
        want = BF16_DEVICE_KERNELS.get(f"{r['kernel']} {r['name']}",
                                       BF16_DEVICE_KERNELS.get(r["kernel"]))
        if r["device_kernels"] != want:
            raise AssertionError(f"{r['name']} {r['kernel']}: the call launched "
                                 f"{r['device_kernels']}, not {want}")
        errs = ", ".join(f"{t['err_vs_f64']:.2e} (plain {t['plain_err_vs_f64']:.2e})"
                         for t in r["vs_f64"])
        print(f"[bf16] {r['name']:<12} {r['kernel']:<22} vs plain {r['max_abs_err']:.3e}; "
              f"vs float64 {errs}; {r['ms'] * 1e3:8.2f} us"
              + (f" (saving {r['save_ms'] * 1e3:.2f})" if "save_ms" in r else "")
              + f"  plain {r['plain_ms'] * 1e3:8.2f} us  bound {r['bound_ms'] * 1e3:6.2f} us "
              f"({r['bound_by']}"
              + (f"; as fp32 FMAs {r['fp32_fma_bound_ms'] * 1e3:.2f} us"
                 if "fp32_fma_bound_ms" in r else "")
              + f")  {r['yardstick']} (double dagger) "
              f"{r['yardstick_ms'] * 1e3:.2f} us"
              + (f"  {r['composite']}: {r['composite_ms'] * 1e3:.2f} us" if "composite_ms" in r
                 else "")
              + "  kernels "
              + ", ".join(f"{k} x{v}" for k, v in r["device_kernels"].items()), flush=True)


def _rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = got.detach().cpu().double() - ref
    return math.sqrt((d * d).mean().item() / max((ref * ref).mean().item(), 1e-300))


def bf16_grads_vs_cpu(data: dict) -> dict:
    """One bfloat16 step's gradients on the card and on the CPU (seeded weights, the fixture's
    first BF16_GRAD_ROWS rows, one injected mask), each against the CPU port in float64 on
    the same inputs (BF16_GRAD_ROWS' rule)."""
    cpu = IInsVAE(**FLAGSHIP_2D, generator=torch.Generator().manual_seed(3))
    gpu = copy.deepcopy(cpu).cuda()
    f64 = copy.deepcopy(cpu).double()
    batch = {k: v[:BF16_GRAD_ROWS] for k, v in data.items()}
    mask = steps.draw_sup_mask(BF16_GRAD_ROWS, 0.1, "sample",
                               torch.Generator(device="cuda").manual_seed(5))
    grads_fn = steps.make_semi_grads_fn(0.1)
    t0 = time.perf_counter()
    mg = grads_fn(gpu, batch, sup_mask=mask)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mc = grads_fn(cpu, {k: v.cpu() for k, v in batch.items()}, sup_mask=mask.cpu())
    t2 = time.perf_counter()
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in batch.items()},
                   sup_mask=mask.cpu().double())
    loss = {}
    for k in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env"):
        a, c, w = mg[k].item(), mc[k].item(), m64[k].item()
        loss[k] = (a, c, w)
        if not (np.isfinite(a) and abs(a - w) <= 1.5 * abs(c - w) + 2.0**-8 * abs(w)):
            raise AssertionError(f"{k}: {a} on the card, {c} on the CPU, {w} in float64")
    ref = dict(f64.named_parameters())
    largest = max(p.grad.abs().max().item() for p in ref.values())
    cpu_params = dict(cpu.named_parameters())
    card_err, cpu_err, rows = [], [], {}
    for name, p in gpu.named_parameters():
        want, c = ref[name].grad, cpu_params[name].grad
        if ZERO_GRAD.fullmatch(name):  # exactly 0 in exact arithmetic: rounding noise
            for what, t in (("card", p.grad), ("CPU", c)):
                if t.abs().max().item() > 2.0**-8 * largest:
                    raise AssertionError(f"gradient {name} (exactly 0) on the {what}: "
                                         f"{t.abs().max().item():.3e}, largest {largest:.3e}")
            continue
        if not want.any():  # the residual blocks' conv biases: no K7 input
            if p.grad.any() or c.any():
                raise AssertionError(f"gradient {name}: not exactly 0")
            continue
        e_card, e_cpu = _rel_rms(p.grad, want), _rel_rms(c, want)
        rows[name] = (e_card, e_cpu)
        card_err.append(e_card)
        cpu_err.append(e_cpu)
        if not e_card <= 6 * e_cpu + 2.0**-8:
            raise AssertionError(f"gradient {name}: relative RMS error {e_card:.3e} on the card, "
                                 f"{e_cpu:.3e} on the CPU")
    mean_card, mean_cpu = float(np.mean(card_err)), float(np.mean(cpu_err))
    if not mean_card <= 1.5 * mean_cpu + 2.0**-8:
        raise AssertionError(f"mean relative RMS gradient error {mean_card:.3e} on the card, "
                             f"{mean_cpu:.3e} on the CPU")
    worst = max(rows, key=lambda k: rows[k][0] / (rows[k][1] + 2.0**-8))
    print(f"[bf16] one step's gradients ({BF16_GRAD_ROWS} rows) vs float64: mean relative RMS "
          f"error card {mean_card:.3e}, CPU {mean_cpu:.3e}; worst {worst} card "
          f"{rows[worst][0]:.3e} CPU {rows[worst][1]:.3e}; loss card / CPU / float64 "
          f"{loss['loss']}; step on the card {t1 - t0:.2f} s (first), on the CPU {t2 - t1:.2f} s",
          flush=True)
    return dict(rows=BF16_GRAD_ROWS, loss_card_cpu_f64=loss, mean_rel_rms_card=mean_card,
                mean_rel_rms_cpu=mean_cpu, worst_param=worst, rel_rms_card_cpu=rows,
                mask_labeled=int(mask.sum().item()))


def bf16_train_path(fp32_2d: dict) -> dict:
    """``--compute_dtype bfloat16`` training of the expanded 2-D model through
    cli.train_semi.build and train_epochs: 3 epochs with every launch counter set to 0 just
    before and read just after (EXPECTED_BF16_STEP a step, every float32 instance 0), a finite
    loss that falls; training CIR/s over 5 more epochs and a traced step's device busy time
    beside the float32 2-D step's (``fp32_2d``, train_main_path(2, ...)); one step's gradients
    card and CPU against float64."""
    cfg = train_config(2)
    cfg.compute_dtype = "bfloat16"
    trainer = train_semi.build(cfg, "cuda")
    data = trainer.data
    if data["cir"].dtype != BF16 or data["weight"].dtype != BF16:
        raise AssertionError("the bfloat16 trainer's data is not bfloat16")
    n_real = int(data["weight"].sum().item())
    steps_per_epoch = data["cir"].shape[0] // cfg.batch_size
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = loop.train_epochs(trainer.state, trainer.run_epoch, data, 3, seed=cfg.seed)
    torch.cuda.synchronize()
    wall_3 = time.perf_counter() - t0
    n_steps = trainer.state.step
    got, fp32 = kernels.bf16_launch_counts(), {**kernels.launch_counts(),
                                              **kernels.backward_launch_counts()}
    if got != {k: v * n_steps for k, v in EXPECTED_BF16_STEP.items()} or any(fp32.values()):
        raise AssertionError(f"bfloat16 launches {got}, float32 {fp32} in {n_steps} steps; "
                             f"expected {EXPECTED_BF16_STEP} a step and no float32 instance")
    losses = [h["loss"] for h in history]
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"non-finite bfloat16 training metrics: {history}")
    if not losses[2] < losses[0]:
        raise AssertionError(f"the bfloat16 loss did not fall: {losses}")
    print(f"[bf16] conv_type 2, bfloat16: 3 epochs of {steps_per_epoch} steps ({n_real} CIRs, "
          f"batch {cfg.batch_size}) in {wall_3:.3f} s; loss by epoch {losses}; launches a "
          f"step: " + ", ".join(f"{k} {v / n_steps:g}" for k, v in got.items()), flush=True)
    timed = 5
    t0 = time.perf_counter()
    loop.train_epochs(trainer.state, trainer.run_epoch, data, 3 + timed, seed=cfg.seed,
                      start_epoch=3)
    wall = time.perf_counter() - t0
    cir_per_s = n_real * timed / wall
    trace = traced_train_steps(trainer, 20)
    grads = bf16_grads_vs_cpu(data)
    t32 = fp32_2d["trace"]["device_busy_us_per_step"]
    print(f"[bf16] conv_type 2: {cir_per_s:.1f} training CIR/s at batch {cfg.batch_size} over "
          f"{timed} epochs (float32 {fp32_2d['train_cir_per_s']:.1f}, host clock, no claim); "
          f"traced 20 steps: device busy {trace['device_busy_us_per_step']:.1f} us a step "
          f"(float32 {t32:.1f}) of {trace['wall_us_per_step']:.1f} us, idle "
          f"{trace['device_idle_share']}", flush=True)
    return dict(history=history, steps=n_steps, launches=got,
                launches_per_step={k: v / n_steps for k, v in got.items()},
                train_cir_per_s=cir_per_s, fp32_train_cir_per_s=fp32_2d["train_cir_per_s"],
                step_wall_ms=wall / (timed * steps_per_epoch) * 1e3, trace=trace,
                fp32_device_busy_us_per_step=t32, grads_vs_cpu=grads)


def bf16_cli_check() -> dict:
    """``--conv_type 2 --compute_dtype bfloat16`` through the entry points on the card (no
    device flag), in a temporary directory: ``cli.train_semi.main`` for 2 epochs; a 1-epoch run
    resumed to 2 from its checkpoint, parameters (float32) bit-equal to the continuous run's and
    the final metrics equal; ``cli.evaluate.main`` of the continuous run's final checkpoint, its
    metrics those of the entry point's final evaluation."""
    import tempfile

    from iinsvae_torch.cli import evaluate as evaluate_cli

    flags = ["--conv_type", "2", "--compute_dtype", "bfloat16", "--dataset_env", "room_full",
             "--synthetic_n", "2000", "--batch_size", str(BATCH), "--sample_interval", "0",
             "--checkpoint_interval", "-1"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        def dirs(name):
            return ["--model_dir", f"{tmp}/{name}/models", "--out_dir", f"{tmp}/{name}/results"]

        state_a, m_a = train_semi.main(flags + dirs("a") + ["--n_epochs", "2"])
        train_semi.main(flags + dirs("b") + ["--n_epochs", "1"])
        state_b, m_b = train_semi.main(flags + dirs("b") + ["--n_epochs", "2", "--epoch", "1"])
        params = list(zip(state_a.model.parameters(), state_b.model.parameters()))
        if not all(p.is_cuda and p.dtype == torch.float32 and torch.equal(p, q)
                   for p, q in params) or m_a != m_b:
            raise AssertionError("the bfloat16 run resumed 1 -> 2 differs from the continuous one")
        m_eval = evaluate_cli.main(flags + dirs("a") + ["--test_epoch", "2"])
        if m_eval != m_a:
            raise AssertionError(f"evaluate {m_eval} != the entry point's final {m_a}")
    wall = time.perf_counter() - t0
    print(f"[bf16] train_semi --conv_type 2 --compute_dtype bfloat16 on the card: 2 epochs, a "
          f"resume 1 -> 2 bit-equal, evaluate equal to the final evaluation (rmse "
          f"{m_a['rmse']:.6f}, accuracy {m_a['accuracy']:.6f}); {wall:.1f} s", flush=True)
    return dict(final=m_a, resumed_bit_equal=True, evaluate_equal_final=True, wall_s=wall)


def bf16_kernel_rows(fwd: list[dict], bwd: list[dict], launches: dict[str, int]) -> list[dict]:
    """The ``kernels`` line's rows of the bfloat16 instances: each summed over its sites (the
    2-D model's; the soft restorer's has rows of its own, soft_kernel_rows), each site times its
    calls a step; ``launches`` those of the bfloat16 training run."""
    out = []
    for name, wrapper, rows in (
            ("res_block_2d_bf16", "res_block_2d", fwd), ("mlp_chain_bf16", "mlp_chain", fwd),
            ("res_block_2d_bwd_bf16", "res_block_2d_bwd", bwd),
            ("mlp_chain_bwd_bf16", "mlp_chain_bwd", bwd)):
        rs = [r for r in rows if r["kernel"] == name and not r["name"].endswith(".soft")]

        def total(key):
            return sum(r[key] * r["per_step"] for r in rs)

        out.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=rs[0]["replaces"],
            launches=launches[wrapper], max_abs_err=max(r["max_abs_err"] for r in rs),
            ms=total("ms"), plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by=rs[0]["bound_by"], library_ms=None,
            per="one bfloat16 training step of the 2-D model at batch 500 (sum over its sites)",
            yardstick_ms=total("yardstick_ms"), yardstick=rs[0]["yardstick"],
            **({"save_ms": total("save_ms")} if all("save_ms" in r for r in rs) else {}),
            **({"fp32_fma_bound_ms": total("fp32_fma_bound_ms")}
               if all("fp32_fma_bound_ms" in r for r in rs) else {}),
            **({"composite_ms": total("composite_ms"), "composite": rs[0]["composite"]}
               if all("composite_ms" in r for r in rs) else {})))
    return out



def step_graph(model: IInsVAE, batch: dict, **inject) -> dict[str, int]:
    """The port's kernels one training step's forward and backward launch (the semi step's
    gradients, ``inject``: the mask and a soft restorer's eps), read from a CUDA graph of the
    call: its replay's loss, metrics and gradients bit-equal to an eager call's."""
    grads_fn = steps.make_semi_grads_fn(0.1)

    def step():
        metrics = grads_fn(model, batch, **inject)
        return [*metrics.values(), *(p.grad for p in model.parameters())]

    return graph_kernels.port_kernels(device_kernels(step))


def head_kernels(heads, b: int = BATCH) -> dict[str, int]:
    """The port's kernels that K4 (as training launches it, saving the d_j) and K4b launch at
    ``heads`` (Linear heads), one call each, at batch b on seeded inputs."""
    gen, out = torch.Generator().manual_seed(31), {}
    for head in heads:
        n = len(head.slopes)
        ws = [getattr(head, f"w{j}").detach() for j in range(n)]
        bs = [getattr(head, f"b{j}").detach() for j in range(n)]
        x = torch.randn((b, ws[0].shape[0]), generator=gen).cuda()
        g = torch.randn((b, ws[-1].shape[1]), generator=gen).cuda()
        _, ds = fused.launch_mlp_chain(x, ws, bs, head.slopes, save_pre=True)
        for fn in (lambda: fused.launch_mlp_chain(x, ws, bs, head.slopes, save_pre=True),
                   lambda: backward.mlp_chain_bwd(g, x, ws, bs, head.slopes, ds)):
            out = _add(out, graph_kernels.port_kernels(device_kernels(fn)))
    return out


def noexpand_phase() -> dict:
    """[noexpand] The column-image model (conv_type 3, FLAGSHIP_3D: full width, 3 residual
    blocks, 4 downsamples, --env_conv_init torch, seeded weights) on the card: served through
    Predictor at batch 500 without and with the reconstruction, counted (EXPECTED_3D a batch)
    and held to the CPU Predictor; the port's kernels of one forward batch read from a CUDA
    graph (K4's cluster kernel at the restorer, its head kernel at the classifier, nothing
    else); serving CIR/s, device busy time and idle share; its training main path (3 epochs
    counted, EXPECTED_3D forward and backward launches a step, a falling loss, training CIR/s,
    a traced step's busy time and idle share, one step's gradients card vs CPU against
    float64); and the port's kernels of one step's forward and backward from a CUDA graph: those
    of K4 and K4b at the two heads, nothing else."""
    t0 = time.perf_counter()
    cpu = IInsVAE(**FLAGSHIP_3D, generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu).cuda()
    main_path, launches = serve_main_path(model, cpu, False, EXPECTED_3D)
    main_path_recon, launches_recon = serve_main_path(model, cpu, True, EXPECTED_3D)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(BATCH, 157))
                         .astype(np.float32)).cuda()
    pred = Predictor(model, batch_size=BATCH, return_recon=True, device="cuda")
    with torch.inference_mode():
        graph_fwd = graph_kernels.port_kernels(device_kernels(lambda: pred.forward_batch(x)))
    want_fwd = {"cluster::mlp_cluster_kernel": 1, "head::mlp_head_kernel": 1}
    if graph_fwd != want_fwd:
        raise AssertionError(f"[noexpand] a forward batch launched {graph_fwd}, not {want_fwd}")
    print(f"[noexpand] a forward batch with the reconstruction, from a CUDA graph: the port's "
          f"kernels {graph_fwd}", flush=True)
    serving = throughput(model, recon=False, sizes=(BATCH,), n_batches=40)
    serving_recon = throughput(model, recon=True, sizes=(BATCH,), n_batches=40)
    training = train_main_path(3, EXPECTED_3D, EXPECTED_3D_TRAIN_BWD)
    gen = torch.Generator().manual_seed(4)
    batch = {"cir": torch.randn((BATCH, 157), generator=gen).cuda(),
             "err": torch.rand((BATCH, 1), generator=gen).cuda(),
             "label": torch.randint(0, 5, (BATCH, 1), generator=gen).float().cuda(),
             "weight": torch.ones(BATCH).cuda()}
    mask = steps.draw_sup_mask(BATCH, 0.1, "sample", torch.Generator(device="cuda").manual_seed(5))
    graph_step = step_graph(model, batch, sup_mask=mask)
    want_step = head_kernels([model.restorer.restorer, model.classifier.classifier])
    if graph_step != want_step:
        raise AssertionError(f"[noexpand] a step launched {graph_step}, not {want_step}")
    t = training["trace"]
    busy = serving[BATCH]["trace"]["device_busy_us_per_batch"]
    print(f"[noexpand] a step's forward and backward, from a CUDA graph: the port's kernels "
          f"{graph_step}; serving {serving[BATCH]['cir_per_s']:.1f} CIR/s at batch {BATCH} "
          f"(recon {serving_recon[BATCH]['cir_per_s']:.1f}), device busy {busy:.1f} us a batch; "
          f"training {training['train_cir_per_s']:.1f} CIR/s, device busy "
          f"{t['device_busy_us_per_step']:.1f} us a step of {t['wall_us_per_step']:.1f} us, idle "
          f"{t['device_idle_share']}; phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(config=FLAGSHIP_3D, main_path=main_path, main_path_recon=main_path_recon,
                launches_per_batch=launches, graph_forward=graph_fwd, graph_step=graph_step,
                serving=serving, serving_recon=serving_recon, training=training,
                wall_s=time.perf_counter() - t0)


def soft_phase() -> dict:
    """[soft] The soft restorer (--use_soft): K4 (the cluster kernel's instance of last width
    2) and K4b at the 1-D soft restorer (16 -> 512 -> 256 -> 256 -> 2) and the 2-D one (128 ->
    ... -> 2) at batch 500 and 261, against their plain versions, K4 within tolerance of the
    general kernel and launching cluster::mlp_cluster_kernel, each bit-equal over two calls,
    timed beside its bound and yardstick; the 1-D soft step through cli.train_semi.build: one
    epoch counted (17 forward and 17 backward launches a step), a finite loss, one step's
    gradients card vs CPU against float64 (the eps injected), the cluster kernel once in a CUDA
    graph of a step; the bfloat16 2-D soft step (--conv_type 2 --compute_dtype bfloat16
    --use_soft): one epoch counted (EXPECTED_BF16_STEP bfloat16 launches a step, no float32
    instance), a finite loss, the cluster kernel once in a CUDA graph of a step. The soft 2-D
    restorer's bfloat16 K4 and K4b sites run in [bf16] (bf16_sites)."""
    from iinsvae_torch.models.heads import RestorerLinear

    t0 = time.perf_counter()
    fp = "iinsvae_tpu/ops/pallas/fused.py"
    k4_rows, k4b_rows = [], []
    for name, shape in (("restorer.soft", (8, 2)), ("restorer.2d.soft", (8, 8, 2))):
        head = RestorerLinear(shape, soft=True, generator=torch.Generator().manual_seed(0)).cuda()
        for b in (BATCH, RAGGED[1]):
            gen, yard = torch.Generator().manual_seed(50 + b), torch.Generator().manual_seed(96)

            def rand(*shape_, gen=gen):
                return torch.randn(shape_, generator=gen).cuda()

            def rand_yard(*shape_, yard=yard):
                return torch.randn(shape_, generator=yard).cuda()

            site_name = f"{name} (batch {b})"
            with torch.inference_mode():
                site = mlp_site(site_name, head, f"{fp}:1164", b, rand, rand_yard)
                if site["device_kernel"] != "cluster::mlp_cluster_kernel":
                    raise AssertionError(f"{name} takes {site['device_kernel']}")
                k4_rows += check_and_time([site], tag="soft")
            k4b_rows += check_and_time_backward(
                [mlp_bwd_site(site_name, head, f"{fp}:1136", b, rand, rand_yard)], tag="soft")

    cfg = train_config("soft")
    trainer = train_semi.build(cfg, "cuda")
    per_epoch = trainer.data["cir"].shape[0] // cfg.batch_size
    history, fwd, bwd = counted(
        lambda: loop.train_epochs(trainer.state, trainer.run_epoch, trainer.data, 1,
                                  seed=cfg.seed),
        {**_times(EXPECTED_RECON, per_epoch), "mlp_chain_soft": per_epoch},
        {**_times(EXPECTED_RECON, per_epoch), "mlp_chain_bwd_soft": per_epoch}, "soft 1-D step")
    if not all(np.isfinite(v) for h in history for v in h.values()):
        raise AssertionError(f"[soft] non-finite 1-D metrics: {history}")
    grads = step_grads_vs_cpu(trainer.data, "soft")
    batch = {k: v[:BATCH] for k, v in trainer.data.items()}
    mask = steps.draw_sup_mask(BATCH, 0.1, "sample", torch.Generator(device="cuda").manual_seed(5))
    graph_1d = step_graph(trainer.state.model, batch, sup_mask=mask, **soft_eps("soft", "cuda"))

    cfg_bf = train_config(2)
    cfg_bf.compute_dtype, cfg_bf.use_soft = "bfloat16", True
    trainer_bf = train_semi.build(cfg_bf, "cuda")
    kernels.reset_launch_counts()
    history_bf = loop.train_epochs(trainer_bf.state, trainer_bf.run_epoch, trainer_bf.data, 1,
                                   seed=cfg_bf.seed)
    torch.cuda.synchronize()
    n_bf = trainer_bf.state.step
    got, fp32 = kernels.bf16_launch_counts(), {**kernels.launch_counts(),
                                              **kernels.backward_launch_counts()}
    got_soft = kernels.soft_launch_counts()
    want_soft = dict(mlp_chain_soft=0, mlp_chain_bf16_soft=n_bf, mlp_chain_bwd_soft=0,
                     mlp_chain_bwd_bf16_soft=n_bf)
    if got != _times(EXPECTED_BF16_STEP, n_bf) or any(fp32.values()) or got_soft != want_soft:
        raise AssertionError(f"[soft] bfloat16 launches {got}, float32 {fp32}, at the soft "
                             f"restorer {got_soft} in {n_bf} steps")
    if not all(np.isfinite(v) for h in history_bf for v in h.values()):
        raise AssertionError(f"[soft] non-finite bfloat16 metrics: {history_bf}")
    batch_bf = {k: v[:BATCH] for k, v in trainer_bf.data.items()}
    eps_bf = soft_eps("soft", "cuda")["soft_eps"].to(BF16)
    graph_bf = step_graph(trainer_bf.state.model, batch_bf, sup_mask=mask.to(BF16),
                          soft_eps=eps_bf)
    for what, graph in (("the 1-D soft step", graph_1d), ("the bfloat16 2-D soft step", graph_bf)):
        if graph.get("cluster::mlp_cluster_kernel") != 1:
            raise AssertionError(f"[soft] {what} launched {graph}: not the cluster kernel once")
    whole_f = sum(v for k, v in fwd.items() if not k.endswith("_soft"))
    whole_b = sum(v for k, v in bwd.items() if not k.endswith("_soft"))
    print(f"[soft] 1-D soft step: {whole_f // per_epoch} + {whole_b // per_epoch} launches a "
          f"step, {fwd['mlp_chain_soft'] // per_epoch} + {bwd['mlp_chain_bwd_soft'] // per_epoch} "
          f"of them at the soft restorer, loss {history[0]['loss']:.6f}, "
          f"grads vs float64: card max abs err {grads['max_abs_err_vs_f64']:.3e} (at most "
          f"{grads['worst_card_over_cpu_err']:.2f}x the CPU's); bfloat16 2-D soft step: "
          f"{sum(got.values()) // n_bf} launches a step, loss {history_bf[0]['loss']:.6f}; the "
          f"port's kernels of a step from CUDA graphs: 1-D {graph_1d}, bfloat16 2-D {graph_bf}; "
          f"phase {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(sites=k4_rows, backward_sites=k4b_rows, history_1d=history,
                launches_1d=fwd, launches_bwd_1d=bwd, grads_vs_cpu=grads, graph_1d=graph_1d,
                history_bf16=history_bf, launches_bf16=got, launches_soft_bf16=got_soft,
                graph_bf16=graph_bf,
                wall_s=time.perf_counter() - t0)


def soft_kernel_rows(soft: dict, bf16_fwd: list[dict], bf16_bwd: list[dict]) -> list[dict]:
    """The ``kernels`` line's rows of K4 and K4b at the soft restorers: fp32 at the 1-D soft
    restorer, batch 500 ([soft]; launches: those at the soft restorer over the 1-D soft epoch),
    bfloat16 at the 2-D one ([bf16]; launches: those at the soft restorer over the bfloat16
    soft epoch)."""
    out = []
    for name, kernel, rs, launches in (
            ("mlp_chain_soft", "mlp_chain", soft["sites"], soft["launches_1d"][
                "mlp_chain_soft"]),
            ("mlp_chain_bwd_soft", "mlp_chain_bwd", soft["backward_sites"],
             soft["launches_bwd_1d"]["mlp_chain_bwd_soft"]),
            ("mlp_chain_bf16_soft", "mlp_chain_bf16", bf16_fwd,
             soft["launches_soft_bf16"]["mlp_chain_bf16_soft"]),
            ("mlp_chain_bwd_bf16_soft", "mlp_chain_bwd_bf16", bf16_bwd,
             soft["launches_soft_bf16"]["mlp_chain_bwd_bf16_soft"])):
        site = "restorer.2d.soft" if kernel.endswith("bf16") else f"restorer.soft (batch {BATCH})"
        r = next(r for r in rs if r["kernel"] == kernel and r["name"] == site)
        out.append(dict(
            name=name, route="cuda", source=SOURCES[kernel], replaces=r["replaces"],
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            **({"fp32_fma_bound_ms": r["fp32_fma_bound_ms"]} if "fp32_fma_bound_ms" in r
               else {}),
            per=f"one call at {site.split(' ')[0]}, batch {BATCH}; launches: those at the soft "
                "restorer",
            yardstick_ms=r.get("cudnn_conv_ms", r.get("yardstick_ms")),
            yardstick=r["yardstick"]))
    return out


# ------------------------------------ [data] ------------------------------------

# [data]: the fixtures' size (the training-quality recipe's), the paper protocol's bfloat16 2-D
# step (K7 6, K4 2 a step: the restorer's cluster kernel and the 4-class classifier's head
# kernel; one backward launch each), and the serve CLI's clients on the eWine model
DATA_N = 10000
EXPECTED_PAPER_STEP = {"res_block_2d_bf16": 6, "mlp_chain_bf16": 2}
EXPECTED_PAPER_STEP_BWD = {"res_block_2d_bwd_bf16": 6, "mlp_chain_bwd_bf16": 2}
DATA_CLIENTS, DATA_FRAMES = 4, 6


def data_resolution() -> dict:
    """resolve_data on the card's machine (pandas or not, in the working directory): the eWine
    fixture (two CSVs of DATA_N / 2 rows written from the seed, parsed by the native plane, read
    back bit-equal to the rows they were written from; the 'full' split, then again from the
    mmap cache) and the 'paper' split of fixture v2 (written to the cache cold, read warm; its
    test split exactly the rows of the medium room, Room == 2). Each second read equal to the
    first and read-only (a view of the mapping)."""
    from importlib.util import find_spec

    from iinsvae_torch.cli.common import resolve_data
    from iinsvae_torch.data.synthetic import synthetic_arrays, synthetic_ewine_rows
    from iinsvae_torch.runtime.native import read_csv

    out, first = dict(pandas=find_spec("pandas") is not None), {}
    for name, cfg in (("ewine", Config(dataset_name="ewine", synthetic_n=DATA_N)),
                      ("paper", Config(dataset_env="paper", mode="paper", synthetic_n=DATA_N))):
        times, splits = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            splits.append(resolve_data(cfg))
            times.append(time.perf_counter() - t0)
        first[name] = splits[0]
        (train, test), (train_w, test_w) = splits
        for a, b in zip(train + test, train_w + test_w):
            if a.dtype != np.float32 or not np.array_equal(a, b) or b.flags.writeable:
                raise AssertionError(f"[data] {name}: the cached split differs from the first")
        out[name] = dict(train=train[0].shape[0], test=test[0].shape[0], taps=train[0].shape[1],
                         classes=int(np.unique(np.concatenate([train[2], test[2]])).size),
                         cold_s=times[0], warm_s=times[1])
    for i, path in enumerate(("data/data_ewine/dataset1/tag_room0.csv",
                              "data/data_ewine/dataset1/tag_room1.csv")):
        if not np.array_equal(read_csv(path), synthetic_ewine_rows(DATA_N // 2, i)):
            raise AssertionError(f"[data] {path} does not parse back to the rows written")
    _, err, label, room = synthetic_arrays(DATA_N, 0, "paper")
    held = room[:, 0] == 2
    _, (_, test_err, test_label) = first["paper"]
    if not (np.array_equal(test_err, err[held].astype(np.float32))
            and np.array_equal(test_label, label[held].astype(np.float32))):
        raise AssertionError("[data] the paper split's test part is not the Room == 2 rows")
    e, p = out["ewine"], out["paper"]
    if (e["taps"], e["classes"], e["train"], e["test"]) != (152, 2, 8000, 2000) \
            or p["classes"] != 4 or p["test"] != int(held.sum()):
        raise AssertionError(f"[data] splits {out}")
    out["paper"]["held_out_room"] = 2
    print(f"[data] pandas {'present' if out['pandas'] else 'absent'}; eWine fixture (2 CSVs of "
          f"{DATA_N // 2} rows, parsed by the native plane, bit-equal to the rows written): "
          f"{e['train']} train / {e['test']} test CIRs of {e['taps']} taps, 2 classes, "
          f"{e['cold_s']:.3f} s cold, {e['warm_s']:.4f} s from the cache; paper split of "
          f"fixture v2: {p['train']} train / {p['test']} test, the test split exactly the "
          f"{int(held.sum())} Room == 2 rows, 4 classes, {p['cold_s']:.3f} s cold (cache "
          f"written), {p['warm_s']:.4f} s warm (mmap)", flush=True)
    return out


def serve_cli_fronts(tmp: str, cpu_model: IInsVAE, flags: list[str], what: str) -> dict:
    """``python -m iinsvae_torch.cli.serve <flags> --socket --tcp_port 0 --probs --recon`` in a
    subprocess: DATA_CLIENTS client threads, half on each front, send DATA_FRAMES frames of
    1-SERVER_MAX_FRAME seeded CIRs each; every row against the CPU Predictor of the same seeded
    weights (served_vs_cpu), the server's counters (every row submitted, no timeout), then
    SIGINT: exit code 0 and the stats line."""
    import os
    import signal
    import threading

    from iinsvae_torch.runtime import socket_client_request, socket_stats_request

    sock = os.path.join(tmp, "data.sock")
    root = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m", "iinsvae_torch.cli.serve", *flags, "--socket", sock,
           "--tcp_port", "0", "--serve_batch", str(SERVER_BATCH), "--probs", "--recon"]
    proc = subprocess.Popen(cmd, cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(600.0, proc.kill)
    watchdog.start()
    cir_len, k = cpu_model.cir_len, cpu_model.num_classes
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "Ctrl-C to stop" in line:
                break
        ports = [ln.split()[-1] for ln in lines if "listening on tcp port" in ln]
        if not any("plane=native" in ln for ln in lines) or not ports:
            raise AssertionError(f"{what} did not come up:\n" + "".join(lines))
        addrs = [sock, ("127.0.0.1", int(ports[0]))]
        results, failures = [], []

        def client(i):
            rng = np.random.default_rng(70 + i)
            try:
                for _ in range(DATA_FRAMES):
                    cirs = rng.normal(size=(int(rng.integers(1, SERVER_MAX_FRAME + 1)), cir_len))
                    err, label, extra = socket_client_request(addrs[i % 2], cirs, timeout_s=120.0,
                                                              n_extra=k + cir_len)
                    results.append((cirs, err, label, extra))
            except Exception as e:  # noqa: BLE001 - raised below, in the phase's thread
                failures.append(e)

        _join_all([threading.Thread(target=client, args=(i,)) for i in range(DATA_CLIENTS)])
        if failures:
            raise failures[0]
        rows = sum(len(r[0]) for r in results)
        st = socket_stats_request(sock)
        if st["submitted"] != rows or st["wait_timeouts"]:
            raise AssertionError(f"{what}: {rows} rows sent, stats {st}")
        check = served_vs_cpu(cpu_model, *(np.concatenate([r[j] for r in results])
                                           for j in range(4)), what)
        proc.send_signal(signal.SIGINT)
        out = "".join(lines) + proc.communicate(timeout=120)[0]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    stats = [ln for ln in out.splitlines() if ln.startswith("[serve] stats:")]
    if proc.returncode != 0 or not stats:
        raise AssertionError(f"{what}: exit code {proc.returncode} after SIGINT:\n{out}")
    return dict(cmd=" ".join(cmd[1:]), rows=rows, frames=len(results), exit_code=0,
                stats_line=stats[0], **check)


def data_phase() -> dict:
    """[data] The data pipeline and the two model paths it opens, in a temporary working
    directory (the entry points resolve the data under ./data): data_resolution; K6 and K6b at
    the eWine model's decoder tail (pool 128 -> 152) at batch 500 against their plain versions
    (K6 on the tail kernel, bit-equal to the general kernel, as check_and_time holds the 157
    sites; K6b on its tail path); K4 and K4b bfloat16 at the paper protocol's 4-class
    classifier against float64 beside the plain bfloat16 version; the eWine semi step's main
    path (train_main_path: 3 epochs counted, the 1-D step's launches, a falling loss, CIR/s,
    busy time and idle share, gradients card and CPU against float64); the port's kernels of a
    CUDA graph of the eWine step, exactly those of the 157-tap step's; the eWine model served
    (serve_main_path, counted, against the CPU) and through ``serve --dataset_name ewine`` on
    both fronts (serve_cli_fronts); the paper protocol's bfloat16 2-D step (--mode paper
    --dataset_env paper --conv_type 2 --compute_dtype bfloat16 --supervision_rate 1.0), one
    epoch counted, a finite loss, the cluster and head kernels once each in a CUDA graph of a
    step."""
    import os
    import tempfile

    from iinsvae_torch.models.heads import ClassifierLinear

    t0 = time.perf_counter()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
        os.chdir(tmp)
        try:
            resolution = data_resolution()
            cpu = IInsVAE(**FLAGSHIP_EWINE, generator=torch.Generator().manual_seed(0))
            model = copy.deepcopy(cpu).cuda()
            with torch.inference_mode():
                tail = [dict(s, name="dec.tail.152", device_kernel="tail::tail_fwd_kernel")
                        for s in call_sites(model, torch.Generator().manual_seed(1))
                        if s["name"] == "dec.tail"]
                k6 = check_and_time(tail, tag="data")
            k6b = check_and_time_backward(
                [dict(s, name="dec.tail.152") for s in
                 backward_sites(model, torch.Generator().manual_seed(2))
                 if s["name"] == "dec.tail"], tag="data")
            if "tail::tail_bwd_kernel" not in k6b[0]["device_kernels"]:
                raise AssertionError(f"[data] K6b at 152 launched {k6b[0]['device_kernels']}")
            head4 = ClassifierLinear(16, 4, generator=torch.Generator().manual_seed(0)).cuda()
            gen = torch.Generator().manual_seed(12)
            k4_fwd, k4_bwd = bf16_head_sites(
                [("classifier.4", head4)], BATCH,
                lambda *shape: torch.randn(shape, generator=gen).cuda().to(BF16))
            check_bf16_rows(k4_fwd + k4_bwd)

            training = train_main_path("ewine", EXPECTED_TRAIN, EXPECTED_TRAIN_BWD)
            gen_b = torch.Generator().manual_seed(4)
            mask = steps.draw_sup_mask(BATCH, 0.1, "sample",
                                       torch.Generator(device="cuda").manual_seed(5))
            graphs = {}
            for key in (1, "ewine"):
                m = MODELS[key]
                batch = {"cir": torch.randn((BATCH, m["cir_len"]), generator=gen_b).cuda(),
                         "err": torch.rand((BATCH, 1), generator=gen_b).cuda(),
                         "label": torch.randint(0, m["num_classes"], (BATCH, 1),
                                                generator=gen_b).float().cuda(),
                         "weight": torch.ones(BATCH).cuda()}
                graphs[key] = step_graph(IInsVAE(**m).cuda(), batch, sup_mask=mask)
            if graphs["ewine"] != graphs[1]:
                raise AssertionError(f"[data] the eWine step launched {graphs['ewine']}, the "
                                     f"157-tap step {graphs[1]}")
            serving, _ = serve_main_path(model, cpu, True, EXPECTED_RECON)
            server = serve_cli_fronts(tmp, cpu, ["--dataset_name", "ewine"],
                                      "serve --dataset_name ewine")

            cfg = Config(conv_type=2, compute_dtype="bfloat16", mode="paper",
                         dataset_env="paper", supervision_rate=1.0, synthetic_n=DATA_N,
                         batch_size=BATCH, n_epochs=800, decay_epoch=300, env_dim=16)
            trainer = train_semi.build(cfg, "cuda")
            n_paper = trainer.data["cir"].shape[0] // BATCH
            history, fwd, bwd = counted(
                lambda: loop.train_epochs(trainer.state, trainer.run_epoch, trainer.data, 1,
                                          seed=0),
                _times(EXPECTED_PAPER_STEP, n_paper), _times(EXPECTED_PAPER_STEP_BWD, n_paper),
                "[data] the paper protocol's bfloat16 step")
            if not all(np.isfinite(v) for h in history for v in h.values()):
                raise AssertionError(f"[data] non-finite paper metrics: {history}")
            batch = {k: v[:BATCH] for k, v in trainer.data.items()}
            graph_paper = step_graph(trainer.state.model, batch, sup_mask=mask.to(BF16))
            if graph_paper.get("cluster::mlp_cluster_kernel") != 1 \
                    or graph_paper.get("head::mlp_head_kernel") != 1:
                raise AssertionError(f"[data] the paper step launched {graph_paper}")
        finally:
            os.chdir(cwd)
    t = training["trace"]
    print(f"[data] eWine step: {training['launches_per_step']:g} + "
          f"{training['launches_bwd_per_step']:g} launches a step, the 157-tap step's kernels in "
          f"its CUDA graph, loss by epoch {[round(h['loss'], 6) for h in training['history']]}, "
          f"device busy {t['device_busy_us_per_step']:.1f} us a step, idle "
          f"{t['device_idle_share']}; served at 152 taps (17 launches a batch) and through "
          f"serve --dataset_name ewine on both fronts: {server['rows']} rows in "
          f"{server['frames']} frames equal to the CPU's; the paper protocol's bfloat16 step: "
          f"{n_paper} steps an epoch, K7 6 + K4 2 bfloat16 launches a step and one backward "
          f"each, loss {history[0]['loss']:.6f}; phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return dict(resolution=resolution, sites=k6, backward_sites=k6b, bf16_sites=k4_fwd,
                bf16_backward_sites=k4_bwd, training=training, graph_step=graphs["ewine"],
                serving=serving, server=server,
                paper=dict(steps=n_paper, history=history, launches=fwd, launches_bwd=bwd,
                           graph_step=graph_paper),
                wall_s=time.perf_counter() - t0)


def data_kernel_rows(data: dict) -> list[dict]:
    """The ``kernels`` line's rows of this phase's new shapes: K6 and K6b at the pool of 152
    (launches: the eWine main path's 3 counted epochs) and K4 and K4b bfloat16 at the 4-class
    head (launches: the paper step's epoch, one at the classifier a step, as its CUDA graph
    shows; ``launches_wrapper`` the wrapper's, the restorer's among them). ``counter`` names
    the launch counter the other phases' launches are read from."""
    tr, paper = data["training"], data["paper"]
    out = []
    for name, counter, r, launches, wrapper in (
            ("sln_chain_152", "sln_chain", data["sites"][0], tr["launches"]["sln_chain"],
             tr["launches"]["sln_chain"]),
            ("sln_chain_bwd_152", "sln_chain_bwd", data["backward_sites"][0],
             tr["launches_bwd"]["sln_chain_bwd"], tr["launches_bwd"]["sln_chain_bwd"]),
            ("mlp_chain_bf16_4class", "mlp_chain_bf16", data["bf16_sites"][0], paper["steps"],
             paper["launches"]["mlp_chain_bf16"]),
            ("mlp_chain_bwd_bf16_4class", "mlp_chain_bwd_bf16", data["bf16_backward_sites"][0],
             paper["steps"], paper["launches_bwd"]["mlp_chain_bwd_bf16"])):
        kernel = r["kernel"]
        out.append(dict(
            name=name, counter=counter, route="cuda", source=SOURCES[kernel],
            replaces=r["replaces"], launches=launches, launches_wrapper=wrapper,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            **({"fp32_fma_bound_ms": r["fp32_fma_bound_ms"]} if "fp32_fma_bound_ms" in r
               else {}),
            per=f"one call at {r['name']}, batch {BATCH}",
            yardstick_ms=r.get("cudnn_conv_ms", r.get("yardstick_ms")),
            yardstick=r["yardstick"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bfloat16 products reduce in fp32 ([bf16]: as the entry points' ops.conv.fp32_reduction)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all(("-Xptxas", "-v"))
    build_s = time.perf_counter() - t0
    print(f"[build] {len(logs)} libraries built in {build_s:.1f} s "
          f"({len(_build.SOURCES) - len(logs)} already built)", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # the serving deployment path, before any torch.profiler session
    server = server_phase(card)

    # the 1-D model
    cpu_model = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).cuda()
    with torch.inference_mode():
        site_rows = check_and_time(call_sites(model, torch.Generator().manual_seed(1)))
    head_rows = joint_head_sites()
    main_path, launches_no_recon = serve_main_path(model, cpu_model, False, EXPECTED_NO_RECON)
    main_path_recon, launches = serve_main_path(model, cpu_model, True, EXPECTED_RECON)
    serving = throughput(model, recon=False)
    serving_recon = throughput(model, recon=True)
    bwd_rows = check_and_time_backward(backward_sites(model, torch.Generator().manual_seed(2)))
    ragged = ragged_checks(model)
    training = train_main_path(1, EXPECTED_TRAIN, EXPECTED_TRAIN_BWD)
    one_stage = one_stage_phase(model)
    del model, cpu_model

    # the expanded 2-D model
    cpu_2d = IInsVAE(**FLAGSHIP_2D, generator=torch.Generator().manual_seed(0))
    model_2d = copy.deepcopy(cpu_2d).cuda()
    with torch.inference_mode():
        site_rows_2d = check_and_time(call_sites(model_2d, torch.Generator().manual_seed(3)))
    main_path_2d, launches_2d_no_recon = serve_main_path(model_2d, cpu_2d, False,
                                                         EXPECTED_2D_NO_RECON)
    main_path_2d_recon, launches_2d = serve_main_path(model_2d, cpu_2d, True, EXPECTED_2D_RECON)
    serving_2d = throughput(model_2d, recon=False, sizes=(500,), n_batches=40)
    serving_2d_recon = throughput(model_2d, recon=True, sizes=(500,), n_batches=40)
    bwd_rows_2d = check_and_time_backward(
        backward_sites(model_2d, torch.Generator().manual_seed(4)))
    training_2d = train_main_path(2, EXPECTED_2D_RECON, EXPECTED_2D_TRAIN_BWD)
    # the 2-D model in bfloat16: its kernel sites, then its training path
    from iinsvae_torch.models.heads import RestorerLinear

    soft_2d = RestorerLinear((8, 8, 2), soft=True,
                             generator=torch.Generator().manual_seed(0)).cuda()
    bf16_fwd, bf16_bwd = bf16_sites(model_2d, torch.Generator().manual_seed(6),
                                    extra_heads=[("restorer.2d.soft", soft_2d)])
    bf16_train = bf16_train_path(training_2d)
    bf16_train["cli"] = bf16_cli_check()
    del model_2d, cpu_2d

    # evaluation, checkpoints and resume through the entry points
    evaluation = eval_phase()
    # the supervised joint and separated paths through their entry points
    joint = joint_phase(head_rows)
    # the column-image model (conv_type 3) and the soft restorer
    noexpand = noexpand_phase()
    soft = soft_phase()
    # the data pipeline, the eWine model and the paper protocol's split
    data = data_phase()

    per_fwd = "one forward batch of 500 (sum over its call sites)"
    per_step = "one training step at batch 500 (sum over its call sites)"
    names_1d = [k for k, v in EXPECTED_RECON.items() if v]
    kernel_table = kernel_rows(
        site_rows, names_1d, launches, per_fwd,
        {k: dict(launches_no_recon=launches_no_recon[k], launches_train=training["launches"][k],
                 launches_eval=evaluation["launches"][k],
                 **conv_yardstick(site_rows, k, "mm_ms" if k == "mlp_chain" else "cudnn_conv_ms"))
         for k in names_1d})
    kernel_table += kernel_rows(
        site_rows_2d, ["res_block_2d"], launches_2d, per_fwd + ", conv_type 2",
        {"res_block_2d": dict(launches_no_recon=launches_2d_no_recon["res_block_2d"],
                              launches_train=training_2d["launches"]["res_block_2d"],
                              launches_eval=evaluation["launches_2d"]["res_block_2d"],
                              save_ms=per_call_sum(site_rows_2d, "res_block_2d", "save_ms"),
                              bound="3xTF32 on the tensor cores",
                              tf32x3_bound_ms=per_call_sum(site_rows_2d, "res_block_2d",
                                                           "tf32x3_bound_ms"),
                              fp32_fma_bound_ms=per_call_sum(site_rows_2d, "res_block_2d",
                                                             "fp32_fma_bound_ms"),
                              **conv_yardstick(site_rows_2d, "res_block_2d", "cudnn_conv_ms"))})
    kernel_table += kernel_rows(
        bwd_rows, [f"{k}_bwd" for k in names_1d], training["launches_bwd"], per_step,
        {f"{k}_bwd": conv_yardstick(bwd_rows, f"{k}_bwd", "mm_pair_ms" if k == "mlp_chain"
                                    else "cudnn_conv_backward_ms") for k in names_1d})
    kernel_table += kernel_rows(
        bwd_rows_2d, ["res_block_2d_bwd"], training_2d["launches_bwd"],
        per_step + ", conv_type 2",
        {"res_block_2d_bwd": dict(
            bound="3xTF32 on the tensor cores",
            fp32_fma_bound_ms=per_call_sum(bwd_rows_2d, "res_block_2d_bwd", "fp32_fma_bound_ms"),
            **conv_yardstick(bwd_rows_2d, "res_block_2d_bwd", "cudnn_conv_backward_ms"))})
    # K8-K10 run on no model path (0 launches there): their launches are the
    # one-stage chain's
    per_chain = "the one-stage phase's chain at batch 500 (sum over its call sites)"
    kernel_table += kernel_rows(
        one_stage["sites"], list(ONE_STAGE), one_stage["paths"][0]["launches"], per_chain,
        {k: dict(launches_serving=launches[k], launches_serving_2d=launches_2d[k],
                 launches_train=training["launches"][k],
                 launches_train_2d=training_2d["launches"][k],
                 **conv_yardstick(one_stage["sites"], k, "cudnn_conv_ms")) for k in ONE_STAGE})
    kernel_table += kernel_rows(
        one_stage["backward_sites"], list(ONE_STAGE_BWD), one_stage["paths"][0]["launches_bwd"],
        per_chain,
        {k: dict(launches_train=training["launches_bwd"][k],
                 launches_train_2d=training_2d["launches_bwd"][k],
                 **conv_yardstick(one_stage["backward_sites"], k, "cudnn_conv_backward_ms"))
         for k in ONE_STAGE_BWD})

    kernel_table += bf16_kernel_rows(bf16_fwd, bf16_bwd, bf16_train["launches"])
    kernel_table += soft_kernel_rows(soft, bf16_fwd, bf16_bwd)
    kernel_table += data_kernel_rows(data)
    # each kernel's launches on the joint and separated entry points' main paths (cli.run,
    # cli.run_sep: training steps, evaluation and inference)
    # and on the server's ([server]: the 1-D recon server through both fronts and the 2-D
    # in-process server), and on the column-image model's training run ([noexpand]: 3 epochs);
    # the bfloat16 instances' and the soft restorer's as read there (each run fails unless 0)
    tr3 = noexpand["training"]
    for row in kernel_table:
        name = row.get("counter", row["name"])
        row["launches_joint"] = {**joint["launches_run"], **joint["launches_run_bwd"]}[name]
        row["launches_sep"] = {**joint["launches_sep"], **joint["launches_sep_bwd"]}[name]
        row["launches_server"] = server["launches"][name]
        row["launches_noexpand"] = {**tr3["launches"], **tr3["launches_bwd"],
                                    **tr3["launches_bf16"], **tr3["launches_soft"]}[name]

    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        sites=site_rows + site_rows_2d, kernels=kernel_table, main_path=main_path,
        main_path_recon=main_path_recon, serving=serving, serving_recon=serving_recon,
        main_path_2d=main_path_2d, main_path_2d_recon=main_path_2d_recon,
        serving_2d=serving_2d, serving_2d_recon=serving_2d_recon,
        backward_sites=bwd_rows + bwd_rows_2d, ragged_max_abs_err=ragged, training=training,
        training_2d=training_2d,
        one_stage=one_stage, evaluation=evaluation, joint=joint, server=server,
        noexpand=noexpand, soft=soft, data=data,
        bf16=dict(sites=bf16_fwd, backward_sites=bf16_bwd, training=bf16_train,
                  tolerance=[BF16_FACTOR, BF16_FLOOR]),
        kernel_tolerance=[KERNEL_RTOL, KERNEL_ATOL], serve_tolerance=[SERVE_RTOL, SERVE_ATOL],
        backward_tolerance=[BWD_RTOL, BWD_ATOL], step_tolerance=[STEP_FACTOR, STEP_FLOOR],
        wall_s=time.perf_counter() - t_start),
        indent=1))
    print(json.dumps({"sites": site_rows + site_rows_2d}), flush=True)
    print(json.dumps({"serving": serving, "serving_recon": serving_recon,
                      "serving_2d": serving_2d, "serving_2d_recon": serving_2d_recon,
                      "card": card}), flush=True)
    print(json.dumps({"backward": bwd_rows + bwd_rows_2d}), flush=True)
    print(json.dumps({"training": training, "card": card}), flush=True)
    print(json.dumps({"training_2d": training_2d, "card": card}), flush=True)
    print(json.dumps({"one_stage": one_stage, "card": card}), flush=True)
    print(json.dumps({"eval": evaluation, "card": card}), flush=True)
    print(json.dumps({"joint": joint, "card": card}), flush=True)
    print(json.dumps({"server": server}), flush=True)
    print(json.dumps({"noexpand": noexpand, "soft": soft, "card": card}), flush=True)
    print(json.dumps({"data": data, "card": card}), flush=True)
    print(json.dumps({"bf16": dict(sites=bf16_fwd, backward_sites=bf16_bwd, training=bf16_train),
                      "card": card}), flush=True)
    print(json.dumps({"kernels": kernel_table}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
