"""Hand-written CUDA kernels of the 1-D and expanded 2-D models' forward and
backward, and their plain versions.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(``*_ref``) on CPU tensors; it never falls back from one to the other. Each
counts its kernel launches in a plain int attribute, ``<wrapper>.launches``.
Under autograd the forward wrappers go through autograd.py's Functions,
whose backward launches the backward wrappers of backward.py (K1b, K2b,
K3b, K4b, K6b, K7b, K8b-K10b: one backward wrapper for each forward wrapper).

  K1 fused.in_chain          conv -> IN -> ReLU|skip, 1-2 stages
  K2 fused.conv_bias_act     conv + bias + ReLU
  K3 strided_conv.strided_conv  k4 s2 zero-pad-1 conv + bias + ReLU (window product)
  K4 fused.mlp_chain         Dense + LeakyReLU chain
  K5 fused.adain_res_block   AdaIN residual block (K1's kernel, per-sample affine)
  K6 fused.sln_chain         decoder tail: 4 x (up, conv, LayerNorm, ReLU), conv, tanh, pool
  K7 res2d.res_block_2d      2-D IN or AdaIN residual block on (B, 8, 8, 64)
  K8 fused.adain_layer       conv -> AdaIN -> ReLU|none [+ residual] (K1's kernel, one stage)
  K9 fused.sln_layer         x2 upsample, conv k5, LayerNorm, ReLU (one stage of K6)
  K10 fused.tanh_pool        conv + bias -> tanh -> pool matrix (K6's tail)

K8-K10 are the counterparts of the one-stage Pallas entries
(fused_adain_layer, fused_sln_layer, fused_tanh_pool_layer); no model calls
them.

K4, K7 and their backward K4b, K7b also have bfloat16 instances, the 2-D
model's kernels under ``--compute_dtype bfloat16`` (K4's and K4b's kernels
templated on the storage type in csrc/mlp_chain.cu and mlp_chain_bwd.cu;
csrc/res_block_2d_bf16.cu, res_block_2d_bf16_bwd.cu), counted apart in
``<wrapper>.launches_bf16`` (bf16_launch_counts). Of K4's and K4b's launches, those at the
soft restorer (the cluster kernel's widths with a last width of 2) are also counted in
``fused.SOFT_LAUNCHES`` (soft_launch_counts).
"""

from iinsvae_torch.ops.kernels import backward, fused, res2d, strided_conv

WRAPPERS = (fused.in_chain, fused.conv_bias_act, strided_conv.strided_conv, fused.mlp_chain,
            fused.adain_res_block, fused.sln_chain, res2d.res_block_2d, fused.adain_layer,
            fused.sln_layer, fused.tanh_pool)
BACKWARD = backward.BACKWARD


BF16 = (fused.mlp_chain, res2d.res_block_2d, backward.mlp_chain_bwd, backward.res_block_2d_bwd)


def reset_launch_counts() -> None:
    for w in WRAPPERS + BACKWARD:
        w.launches = 0
    for w in BF16:
        w.launches_bf16 = 0
    for k in fused.SOFT_LAUNCHES:
        fused.SOFT_LAUNCHES[k] = 0


def bf16_launch_counts() -> dict[str, int]:
    """The bfloat16 instances' launches (forward and backward) by wrapper."""
    return {w.__name__: w.launches_bf16 for w in BF16}


def soft_launch_counts() -> dict[str, int]:
    """K4's and K4b's launches at the soft restorer, fp32 as ``<wrapper>_soft`` and bfloat16
    as ``<wrapper>_bf16_soft`` (forward and backward)."""
    return dict(fused.SOFT_LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Forward launches by wrapper."""
    return {w.__name__: w.launches for w in WRAPPERS}


def backward_launch_counts() -> dict[str, int]:
    return {w.__name__: w.launches for w in BACKWARD}
