"""The port's kernel wrappers against the JAX package's Pallas entries.

Each of the eight Pallas entry variants on the serving forward (six on the
encoders and heads, two on the decoder) runs as the JAX tests run it on
the CPU (interpret mode; dense conv matrices built by
``dense_conv_matrix(..., centered=True)`` from the same taps where the
entry takes one) and is compared with the port wrapper on CPU tensors,
which runs the kernel's plain PyTorch version. Inputs come from numpy with
a seed. Tolerance: fp32, rtol 5e-4 / atol 5e-5 (tests/test_lowering_parity.py).
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.ops import conv as jconv
from iinsvae_tpu.ops import dense_conv
from iinsvae_tpu.ops import norms as jnorms
from iinsvae_tpu.ops.pallas import fused as pf
from iinsvae_tpu.ops.pallas import strided_conv as psc
from iinsvae_tpu.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.ops import kernels, norms
from iinsvae_torch.ops.conv import conv1d, upsample_nearest1d
from iinsvae_torch.ops.kernels import _build, backward, fused, res2d, strided_conv

RTOL, ATOL = 5e-4, 5e-5
B = 6

# (name, l_in, c_in, stages as (k, c_out, stride, padding, pad_mode)) — the
# range encoder's K1 call sites at flagship width
IN_CHAINS = {
    "pair0": (128, 1, [(7, 4, 1, 3, "reflect"), (4, 8, 2, 1, "zero")]),
    "pair1": (64, 8, [(4, 16, 2, 1, "zero"), (4, 32, 2, 1, "zero")]),
    "single": (16, 32, [(4, 64, 2, 1, "zero")]),
    "res": (8, 64, [(3, 64, 1, 1, "reflect"), (3, 64, 1, 1, "reflect")]),
}
# K1b's, K5b's and K8b's shapes: K1b's at IN_CHAINS (its "res" shape is also K5b's decoder
# block) and K8b's one AdaIN stage of the decoder block
BWD_SHAPES = {**IN_CHAINS, "adain": (8, 64, [(3, 64, 1, 1, "reflect")])}
# (l_in, c_in, k, c_out, padding, pad_mode) — K2 call sites
CONV_BIAS_ACT = {
    "range_out": (8, 64, 1, 2, 0, "zero"),
    "env_in": (128, 1, 7, 16, 3, "reflect"),
}
# (l_in, c_in, c_out) — K3 call sites
STRIDED = {"env_down0": (128, 16, 32), "env_down1": (64, 32, 64)}
# (dims, slopes) — K4 call sites
MLPS = {
    "restorer": ((16, 512, 256, 256, 1), (0.2, 0.2, 0.2, 1.0)),
    "classifier": ((16, 16, 32, 16, 5), (0.01, 0.01, 0.01, 0.2)),
}


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(sum(map(ord, name)))


def _taps(rng, k, c_in, c_out):
    return (rng.normal(size=(k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)


def _in_chain_case(name):
    rng = _rng(name)
    l, c, spec = IN_CHAINS[name]
    x = rng.normal(size=(B, l, c)).astype(np.float32)
    taps, shapes = [], []
    for k, c_out, s, p, mode in spec:
        taps.append(_taps(rng, k, c, c_out))
        l_out = (l + 2 * p - k) // s + 1
        shapes.append((l, l_out, c_out))
        l, c = l_out, c_out
    return x, taps, shapes, spec


def _torch_stages(taps, spec, device="cpu"):
    return [(torch.tensor(t, device=device), s, p, mode)
            for t, (_, _, s, p, mode) in zip(taps, spec)]


def _m(t, l_in, s, p, mode, centered):
    return dense_conv.dense_conv_matrix(jnp.asarray(t), l_in, stride=s, padding=p,
                                        pad_mode=mode, centered=centered)


@pytest.mark.parametrize("name", list(IN_CHAINS))
def test_in_chain_matches_pallas_entry(name):
    """pair0/pair1 vs fused_in_pair, single vs fused_dense_layer(norm='in'),
    res vs fused_res_block."""
    x, taps, shapes, spec = _in_chain_case(name)
    ms = [_m(t, l_in, s, p, mode, True)
          for t, (l_in, _, _), (_, _, s, p, mode) in zip(taps, shapes, spec)]
    x2 = jnp.asarray(x.reshape(B, -1))
    if name == "res":
        want = pf.fused_res_block(x2, *ms, l_out=8, c_out=64, centered=True)
    elif name == "single":
        (_, l1, c1), = shapes
        want = pf.fused_dense_layer(x2, ms[0], l_out=l1, c_out=c1, norm="in",
                                    act="relu", centered=True)
    else:
        (_, l1, c1), (_, l2, c2) = shapes
        want = pf.fused_in_pair(x2, *ms, l1=l1, c1=c1, l2=l2, c2=c2, centered=True)
    got = fused.in_chain(torch.tensor(x), _torch_stages(taps, spec), residual=name == "res")
    _, l_out, c_out = shapes[-1]
    assert got.shape == (B, l_out, c_out)
    np.testing.assert_allclose(got.numpy().reshape(B, -1), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(CONV_BIAS_ACT))
def test_conv_bias_act_matches_pallas_entry(name):
    """vs fused_dense_layer(norm='none') with the bias tiled over L."""
    rng = _rng(name)
    l, c, k, c_out, p, mode = CONV_BIAS_ACT[name]
    x = rng.normal(size=(B, l, c)).astype(np.float32)
    taps = _taps(rng, k, c, c_out)
    bias = rng.uniform(-0.5, 0.5, size=c_out).astype(np.float32)
    l_out = l + 2 * p - k + 1
    m = _m(taps, l, 1, p, mode, False)
    want = pf.fused_dense_layer(jnp.asarray(x.reshape(B, -1)), m, l_out=l_out, c_out=c_out,
                                norm="none", act="relu", bias=jnp.tile(jnp.asarray(bias), l_out))
    got = fused.conv_bias_act(torch.tensor(x), torch.tensor(taps), torch.tensor(bias),
                              padding=p, pad_mode=mode)
    np.testing.assert_allclose(got.numpy().reshape(B, -1), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", list(STRIDED))
def test_strided_conv_matches_pallas_entry(name):
    rng = _rng(name)
    l, c, c_out = STRIDED[name]
    x = rng.normal(size=(B, l, c)).astype(np.float32)
    taps = _taps(rng, 4, c, c_out)
    bias = rng.uniform(-0.5, 0.5, size=c_out).astype(np.float32)
    want = psc.fused_strided_conv(jnp.asarray(x), jnp.asarray(taps), jnp.asarray(bias),
                                  l_in=l, c_in=c)
    got = strided_conv.strided_conv(torch.tensor(x), torch.tensor(taps), torch.tensor(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _mlp_case(name):
    rng = _rng(name)
    dims, slopes = MLPS[name]
    x = rng.normal(size=(B, dims[0])).astype(np.float32)
    ws = [(rng.uniform(-1, 1, size=(a, b)) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    bs = [(rng.uniform(-1, 1, size=b) / np.sqrt(a)).astype(np.float32)
          for a, b in zip(dims, dims[1:])]
    return x, ws, bs, slopes


@pytest.mark.parametrize("name", list(MLPS))
def test_mlp_chain_matches_pallas_entry(name):
    x, ws, bs, slopes = _mlp_case(name)
    want = pf.fused_mlp_chain(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                              [jnp.asarray(b) for b in bs], slopes)
    got = fused.mlp_chain(torch.tensor(x), [torch.tensor(w) for w in ws],
                          [torch.tensor(b) for b in bs], slopes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _adain_case():
    """One decoder AdaIN block at flagship width: x (B, 8, 64), taps
    (3, 64, 64), per-sample g, b (B, 64)."""
    rng = _rng("adain_res_block")
    l, c = 8, 64
    x = rng.normal(size=(B, l, c)).astype(np.float32)
    k1, k2 = _taps(rng, 3, c, c), _taps(rng, 3, c, c)
    g1, b1, g2, b2 = (rng.normal(size=(B, c)).astype(np.float32) for _ in range(4))
    return x, k1, k2, g1, b1, g2, b2


def test_adain_res_block_matches_pallas_entry():
    """vs fused_adain_res_block with the centered reflect conv matrices and
    g, b tiled over L, as decoders.py:135-148 builds them."""
    x, k1, k2, g1, b1, g2, b2 = _adain_case()
    _, l, c = x.shape
    ms = [_m(k, l, 1, 1, "reflect", True) for k in (k1, k2)]
    tiles = [jnp.tile(jnp.asarray(t), (1, l)) for t in (g1, b1, g2, b2)]
    want = pf.fused_adain_res_block(jnp.asarray(x.reshape(B, -1)), *ms, *tiles,
                                    l_out=l, c_out=c, centered=True)
    got = fused.adain_res_block(*(torch.tensor(a) for a in (x, k1, k2, g1, b1, g2, b2)))
    assert got.shape == (B, l, c)
    np.testing.assert_allclose(got.numpy().reshape(B, -1), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def _sln_case():
    """The decoder tail at flagship width: x (B, 8, 64), four (taps, bias,
    gamma, beta) stages 64 -> 32 -> 16 -> 8 -> 4, the k7 out-conv, pool to 157."""
    rng = _rng("sln_chain")
    x = rng.normal(size=(B, 8, 64)).astype(np.float32)
    stages, d = [], 64
    for _ in range(4):
        stages.append((_taps(rng, 5, d, d // 2),
                       rng.uniform(-0.3, 0.3, size=d // 2).astype(np.float32),
                       rng.uniform(0.0, 1.0, size=d // 2).astype(np.float32),
                       rng.normal(scale=0.1, size=d // 2).astype(np.float32)))
        d //= 2
    ko = _taps(rng, 7, d, 1)
    bo = rng.uniform(-0.3, 0.3, size=1).astype(np.float32)
    return x, stages, ko, bo


def test_sln_chain_matches_pallas_entry():
    """vs fused_sln_chain with the dense_upconv_matrix stages, tiled biases,
    gammas and betas, the reflect out-matrix and the 128 -> 157 pool, as
    decoders.py:150-165 builds them."""
    x, stages, ko, bo = _sln_case()
    l = x.shape[1]
    ms, biases, gammas, betas = [], [], [], []
    for taps, bias, gamma, beta in stages:
        ms.append(dense_conv.dense_upconv_matrix(jnp.asarray(taps), l, padding=2))
        l *= 2
        for rows, v in ((biases, bias), (gammas, gamma), (betas, beta)):
            rows.append(jnp.tile(jnp.asarray(v), l).reshape(1, -1))
    m_out = _m(ko, l, 1, 3, "reflect", False)
    want = pf.fused_sln_chain(jnp.asarray(x.reshape(B, -1)), tuple(ms), tuple(gammas),
                              tuple(betas), m_out, jnp.tile(jnp.asarray(bo), l).reshape(1, -1),
                              adaptive_avg_pool_matrix(l, 157), biases=tuple(biases))
    got = fused.sln_chain(torch.tensor(x), [tuple(map(torch.tensor, st)) for st in stages],
                          torch.tensor(ko), torch.tensor(bo), 157)
    assert got.shape == (B, 157)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_sln_chain_ref_takes_the_callers_pool_matrix():
    """A pool matrix passed in (here the JAX package's) gives the result of
    the one sln_chain_ref builds; one of the wrong shape is refused."""
    x, stages, ko, bo = _sln_case()
    args = (torch.tensor(x), [tuple(map(torch.tensor, st)) for st in stages],
            torch.tensor(ko), torch.tensor(bo), 157)
    pool = torch.tensor(np.asarray(adaptive_avg_pool_matrix(128, 157)))
    np.testing.assert_allclose(fused.sln_chain_ref(*args, pool=pool).numpy(),
                               fused.sln_chain_ref(*args).numpy(), rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="pool must be"):
        fused.sln_chain_ref(*args, pool=pool[:, :156])


@pytest.mark.parametrize("op",["adain", "sample_layer_norm", "upsample_nearest1d"])
def test_decoder_ops_match_jax(op):
    """The plain ops under K5's and K6's plain versions vs iinsvae_tpu.ops."""
    rng = _rng(op)
    x = rng.normal(loc=0.5, size=(B, 16, 8)).astype(np.float32)
    g, b = (rng.normal(size=(B, 8)).astype(np.float32) for _ in range(2))
    if op == "adain":
        want, got = jnorms.adain(x, g, b), norms.adain(torch.tensor(x), torch.tensor(g),
                                                       torch.tensor(b))
    elif op == "sample_layer_norm":
        want = jnorms.sample_layer_norm(x, g[0], b[0])
        got = norms.sample_layer_norm(torch.tensor(x), torch.tensor(g[0]), torch.tensor(b[0]))
    else:
        want, got = jconv.upsample_nearest1d(x, 2), upsample_nearest1d(torch.tensor(x), 2)
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    kernels.reset_launch_counts()
    x, taps, _, spec = _in_chain_case("pair0")
    fused.in_chain(torch.tensor(x), _torch_stages(taps, spec))
    fused.adain_res_block(*(torch.tensor(a) for a in _adain_case()))
    x, stages, ko, bo = _sln_case()
    fused.sln_chain(torch.tensor(x), [tuple(map(torch.tensor, st)) for st in stages],
                    torch.tensor(ko), torch.tensor(bo), 157)
    res2d.res_block_2d(torch.zeros((2, 8, 8, 64)), torch.zeros((3, 3, 64, 64)),
                       torch.zeros((3, 3, 64, 64)))
    xd, tab = torch.zeros((2, 8, 64)), torch.zeros((2, 64))
    fused.adain_layer(xd, torch.zeros((3, 64, 64)), tab, tab, padding=1, pad_mode="reflect")
    fused.sln_layer(xd, torch.zeros((5, 64, 32)), torch.zeros(32), torch.zeros(32))
    fused.tanh_pool(torch.zeros((2, 128, 4)), torch.zeros((7, 4, 1)), torch.zeros(1),
                    torch.zeros((128, 157)), padding=3, pad_mode="reflect")
    assert kernels.launch_counts() == {
        "in_chain": 0, "conv_bias_act": 0, "strided_conv": 0, "mlp_chain": 0,
        "adain_res_block": 0, "sln_chain": 0, "res_block_2d": 0, "adain_layer": 0,
        "sln_layer": 0, "tanh_pool": 0}


def test_soft_restorer_counts_reset_and_count_no_cpu_launch():
    """K4's and K4b's launches at the soft restorer are counted apart, under the ``kernels``
    line's row names; reset sets them to 0, and the soft restorer's widths on CPU tensors
    (the plain versions) count nothing."""
    for k in fused.SOFT_LAUNCHES:
        fused.SOFT_LAUNCHES[k] = 3
    kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(0)
    dims = (16, 512, 256, 256, 2)
    ws = [0.05 * torch.randn((a, k), generator=gen) for a, k in zip(dims, dims[1:])]
    bs = [torch.zeros(k) for k in dims[1:]]
    x = torch.randn((3, 16), generator=gen)
    assert fused.takes_mlp_cluster(dims)
    slopes = [0.2, 0.2, 0.2, 1.0]
    y, h, ds = fused.mlp_chain(x, ws, bs, slopes), x, []
    for w, b, s in zip(ws, bs, slopes):
        ds.append(h @ w + b)
        h = torch.nn.functional.leaky_relu(ds[-1], s)
    backward.mlp_chain_bwd(torch.ones_like(y), x, ws, bs, slopes, ds)
    assert kernels.soft_launch_counts() == {
        "mlp_chain_soft": 0, "mlp_chain_bf16_soft": 0, "mlp_chain_bwd_soft": 0,
        "mlp_chain_bwd_bf16_soft": 0}


def test_conv1d_reflect_padding_excludes_the_edge():
    """k3 reflect at L=8: output 0 reads inputs (1, 0, 1), output 7 reads (6, 7, 6)."""
    x = torch.arange(8, dtype=torch.float32).reshape(1, 8, 1)
    taps = torch.tensor([1.0, 10.0, 100.0]).reshape(3, 1, 1)
    y = conv1d(x, taps, padding=1, pad_mode="reflect").flatten()
    assert y[0].item() == 1 * 1 + 10 * 0 + 100 * 1
    assert y[7].item() == 1 * 6 + 10 * 7 + 100 * 6


@pytest.mark.parametrize("batch", [1, 5, 37, 261, 500])
def test_k1b_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K1b's and K5b's residual-block path: block j of the grid takes tiles j, j + blocks, ...
    (csrc/in_chain_bwd.cu), so every sample must lie in exactly one of those tiles, with the
    H100's 132 SMs and with fewer SMs than tiles. And every K1b, K5b and K8b launch at these
    shapes stays within the 227 KB of shared memory a block can have on the H100."""
    for sms in (132, 7):
        tiles, blocks = backward.res_block_plan(batch, sms)
        assert 1 <= blocks <= min(sms, tiles)
        seen = np.zeros(batch, dtype=int)
        for j in range(blocks):
            for t in range(j, tiles, blocks):
                assert t * backward.RES_TILE < batch
                seen[t * backward.RES_TILE:(t + 1) * backward.RES_TILE] += 1
        assert (seen == 1).all()
    for name, (l_in, c_in, stages) in BWD_SHAPES.items():
        c_ins = [c_in] + [st[1] for st in stages]
        rows, _, _ = fused.stage_rows(torch.zeros((batch, l_in, c_in)),
                                      [(torch.zeros((k, c, c_out)), s, p, m)
                                       for (k, c_out, s, p, m), c in zip(stages, c_ins)])
        if name == "res":
            assert rows == 2 * backward.RES_STAGE
            smem = backward.RES_SMEM
        else:
            floats = backward.chain_floats(rows)
            smem = 4 * floats * _build.samples_per_block(batch, floats)
        assert smem <= 227 * 1024, name


@pytest.mark.parametrize("batch", [1, 5, 37, 256, 261, 500])
def test_k1_k5_res_block_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K1's and K5's forward at the residual blocks (csrc/in_chain.cu, namespace res): block j
    of the grid takes tiles j, j + blocks, ..., so every sample must lie in exactly one of those
    tiles, with the H100's 132 SMs and with fewer SMs than tiles. Tiles of 4 samples, or of 2
    where tiles of 4 would leave more than half the SMs without one, so that the training and
    Predictor batch (500) and serve.py's (256) both spread over at least 90% of the H100's SMs.
    And a block's shared memory stays within the 227 KB a block can have on the H100."""
    for sms in (132, 7):
        tile, tiles, blocks = backward.res_fwd_plan(batch, sms)
        assert tile in (2, 4) and tiles == -(-batch // tile)
        assert (tile == 4) == (-(-batch // 4) > sms // 2)
        assert 1 <= blocks <= min(sms, tiles)
        seen = np.zeros(batch, dtype=int)
        for j in range(blocks):
            for t in range(j, tiles, blocks):
                assert t * tile < batch
                seen[t * tile:(t + 1) * tile] += 1
        assert (seen == 1).all()
        assert backward.RES_FWD_SMEM[tile] <= 227 * 1024
    if batch in (256, 500):
        assert backward.res_fwd_plan(batch, 132)[2] >= 0.9 * 132


@pytest.mark.parametrize("batch", [1, 5, 37, 261, 500])
def test_k6b_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K6b's path at the decoder's shape (csrc/sln_chain_bwd.cu, namespace tail): block j of the
    grid takes tiles j, j + blocks, ..., so every sample must lie in exactly one of those tiles,
    with the H100's 132 SMs and with fewer SMs than tiles. And a block's shared memory (the
    four stages' taps, the tile's buffers, the per-channel sums) stays within the 227 KB a block
    can have on the H100."""
    for sms in (132, 7):
        tiles, blocks = backward.sln_tail_plan(batch, sms)
        assert 1 <= blocks <= min(sms, tiles)
        seen = np.zeros(batch, dtype=int)
        for j in range(blocks):
            for t in range(j, tiles, blocks):
                assert t * backward.SLN_TAIL_TILE < batch
                seen[t * backward.SLN_TAIL_TILE:(t + 1) * backward.SLN_TAIL_TILE] += 1
        assert (seen == 1).all()
    assert backward.SLN_TAIL_SMEM <= 227 * 1024


@pytest.mark.parametrize("batch", [1, 5, 37, 261, 500])
def test_k1b_range_chain_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K1b's path at the range encoder's stride-2 chains (csrc/in_chain_bwd.cu, namespace
    down): block j of the grid takes tiles j, j + blocks, ..., so every sample must lie in
    exactly one of those tiles, with the H100's 132 SMs and with fewer SMs than tiles. Its
    three sites are the rows the flagship's range chains give (IN_CHAINS), and a block's shared
    memory stays within the 227 KB a block can have on the H100."""
    for sms in (132, 7):
        tiles, blocks = backward.down_chain_plan(batch, sms)
        assert 1 <= blocks <= min(sms, tiles)
        seen = np.zeros(batch, dtype=int)
        for j in range(blocks):
            for t in range(j, tiles, blocks):
                assert t * backward.DOWN_TILE < batch
                seen[t * backward.DOWN_TILE:(t + 1) * backward.DOWN_TILE] += 1
        assert (seen == 1).all()
    for name in ("pair0", "pair1", "single"):
        l_in, c_in, stages = IN_CHAINS[name]
        c_ins = [c_in] + [st[1] for st in stages]
        rows, _, _ = fused.stage_rows(torch.zeros((batch, l_in, c_in)),
                                      [(torch.zeros((k, c, c_out)), s, p, m)
                                       for (k, c_out, s, p, m), c in zip(stages, c_ins)])
        assert rows == backward.DOWN_SITES[f"range.{name}"]
        assert backward.DOWN_SMEM[f"range.{name}"] == 4 * backward.down_floats(rows)
        assert backward.DOWN_SMEM[f"range.{name}"] <= 227 * 1024, name


@pytest.mark.parametrize("batch", [1, 5, 37, 261, 500, 1001])
@pytest.mark.parametrize("head", list(MLPS) + ["restorer_2d"])
def test_k4b_batch_split_covers_every_row_once(batch, head):
    """K4b's weight gradient sums the batch in chunks, each into its own partial row
    (csrc/mlp_chain_bwd.cu): the chunks are in order, contiguous, cover every sample exactly
    once, and hold at most the samples a block stages; the partial rows of the largest head
    (the 2-D restorer, 128 -> 512 -> 256 -> 256 -> 1) stay a few MB at batch 500."""
    dims = MLPS[head][0] if head in MLPS else (128, 512, 256, 256, 1)
    chunks = backward.mlp_split_plan(batch, dims)
    small = max(dims) <= backward.MLP_SMALL_WIDTH
    assert small == (head == "classifier")
    limit = backward.MLP_SMALL_ROWS if small else backward.MLP_CHUNK_ROWS
    assert len(chunks) >= (1 if small else backward.MLP_MIN_SPLIT)
    seen = np.zeros(batch, dtype=int)
    end = 0
    for a, b in chunks:
        assert a == end and a <= b <= min(batch, a + limit)
        seen[a:b] += 1
        end = b
    assert (seen == 1).all()
    total = sum((a + 1) * k for a, k in zip(dims, dims[1:]))
    if batch <= 500:
        assert 4 * len(chunks) * total < 8 * 2 ** 20


RESTORER_DIMS = {"restorer": (16, 512, 256, 256, 1), "restorer_2d": (128, 512, 256, 256, 1),
                 "restorer_soft": (16, 512, 256, 256, 2),
                 "restorer_2d_soft": (128, 512, 256, 256, 2)}


@pytest.mark.parametrize("batch", [1, 5, 37, 256, 261, 500])
@pytest.mark.parametrize("head", list(RESTORER_DIMS))
def test_k4_cluster_plan_covers_every_sample_and_column_once_within_shared_memory(batch, head):
    """K4's path at the restorers (csrc/mlp_chain.cu, namespace cluster): cluster c of the grid
    takes tiles c, c + clusters, ..., so every sample must lie in exactly one of those tiles,
    with the 15 clusters of 8 blocks the H100 holds at once, with 16 and with fewer than the
    tiles. Each block rank owns a slice of every layer's columns (of the last layer's weight
    rows), and the slices cover each layer once. A block's shared memory stays within the 227
    KB a block can have on the H100."""
    dims = RESTORER_DIMS[head]
    assert fused.takes_mlp_cluster(dims)
    for slots in (15, 16, 3):
        tile, tiles, clusters, smem = fused.mlp_cluster_plan(batch, dims[0], slots)
        assert tile in (12, 24, 36) and tiles == -(-batch // tile)
        assert 1 <= clusters <= min(slots, tiles)
        if tiles > clusters:
            assert tile == 36
        seen = np.zeros(batch, dtype=int)
        for c in range(clusters):
            for t in range(c, tiles, clusters):
                assert t * tile < batch
                seen[t * tile:(t + 1) * tile] += 1
        assert (seen == 1).all()
        assert smem == fused.mlp_cluster_smem(dims[0], tile) <= 227 * 1024
    for j, slices in enumerate(fused.mlp_cluster_columns(dims)):
        width = dims[j + 1] if j < len(dims) - 2 else dims[-2]
        assert len(slices) == fused.MLP_CLUSTER
        cover = np.zeros(width, dtype=int)
        for a, b in slices:
            cover[a:b] += 1
        assert (cover == 1).all(), j


def test_k4_other_widths_take_the_general_kernel():
    """Only the restorers' widths (the last 1, or 2 for the soft restorers) take K4's cluster
    path, and the classifier (16 -> 16 -> 32 -> 16 -> 5) its small-head path; chains that
    differ from the restorers in any width, with a width over 64, keep the general kernel."""
    assert not fused.takes_mlp_cluster(MLPS["classifier"][0])
    assert fused.takes_mlp_head(MLPS["classifier"][0])
    for dims in ((16, 512, 256, 256, 3), (24, 512, 256, 256, 1), (144, 512, 256, 256, 1),
                 (16, 512, 256, 1), (16, 256, 256, 256, 1), (8, 512, 256, 256, 1)):
        assert not fused.takes_mlp_cluster(dims), dims
        assert not fused.takes_mlp_head(dims), dims


@pytest.mark.parametrize("batch", [1, 5, 37, 256, 261, 500])
def test_k6_tail_forward_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K6's path at the decoder's shape (csrc/sln_chain.cu, namespace tail, on the forward of
    csrc/sln_tail.cuh that K6b's tail path recomputes): block j of the grid takes tiles j,
    j + blocks, ..., so every sample must lie in exactly one of those tiles, with the H100's
    132 SMs and with fewer SMs than tiles. A block's shared memory (the four stages' taps, the
    tile's buffers, the statistics) stays within the 227 KB a block can have, and K6b's lies
    after it."""
    for sms in (132, 7):
        tiles, blocks = fused.sln_tail_plan(batch, sms)
        assert 1 <= blocks <= min(sms, tiles)
        seen = np.zeros(batch, dtype=int)
        for j in range(blocks):
            for t in range(j, tiles, blocks):
                assert t * fused.SLN_TAIL_TILE < batch
                seen[t * fused.SLN_TAIL_TILE:(t + 1) * fused.SLN_TAIL_TILE] += 1
        assert (seen == 1).all()
    assert fused.SLN_TAIL_FWD_SMEM <= 227 * 1024
    assert fused.SLN_TAIL_FWD_SMEM < backward.SLN_TAIL_SMEM


def _cover_once(tiles: int, blocks: int, tile: int, batch: int) -> None:
    """Block j of a persistent grid takes tiles j, j + blocks, ...: every sample in one tile."""
    seen = np.zeros(batch, dtype=int)
    for j in range(blocks):
        for t in range(j, tiles, blocks):
            assert t * tile < batch
            seen[t * tile:(t + 1) * tile] += 1
    assert (seen == 1).all()


def _cuda_site_rows(source: str, pattern: str) -> dict[int, list[int]]:
    """{site id: the numbers of the template arguments (true 1, false 0), in order} of the
    `using` lines of a CUDA source that match ``pattern`` (a regex with the id and the
    arguments as its two groups)."""
    text = (Path(backward.__file__).parent / "csrc" / source).read_text()
    return {int(i): [{"true": 1, "false": 0}.get(a) if a in ("true", "false") else int(a)
                     for a in re.findall(r"\d+|true|false", args)]
            for i, args in re.findall(pattern, text)}


# K2b's call sites in a 1-D training step, (l_in, c_in, k, c_out, padding, pad_mode)
K2B_SITES = {"range.out": (8, 64, 1, 2, 0, "zero"), "env.in": (128, 1, 7, 16, 3, "reflect"),
             "dec.in": (8, 2, 1, 64, 0, "zero")}


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 261, 500])
def test_k2b_site_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K2b's path at its three call sites (csrc/conv_bias_act_bwd.cu, namespace site): block j
    of the grid takes tiles j, j + blocks, ..., so every sample must lie in exactly one of those
    tiles, with the H100's 132 SMs and with fewer SMs than tiles, and a block writes one partial
    row (at most 132). Its sites are the rows the flagship's K2 calls give and the source's
    template instances (site id, k, pad, reflect, l_in, c_in, c_out), and a block's shared
    memory (two tile buffers) stays within the 227 KB a block can have on the H100."""
    for sms in (132, 7):
        tiles, blocks = backward.cba_bwd_plan(batch, sms)
        assert tiles == -(-batch // backward.CBA_TILE) and 1 <= blocks <= min(sms, tiles)
        _cover_once(tiles, blocks, backward.CBA_TILE, batch)
    cuda = _cuda_site_rows("conv_bias_act_bwd.cu",
                           r"using \w+ = Site<(\d+), ([^>]*)>;")
    assert sorted(cuda) == [0, 1, 2]
    for i, (name, (l_in, c_in, k, c_out, pad, mode)) in enumerate(K2B_SITES.items()):
        rows, _, _ = fused.stage_rows(torch.zeros((batch, l_in, c_in)),
                                      [(torch.zeros((k, c_in, c_out)), 1, pad, mode)])
        assert rows == backward.CBA_SITES[name] == list(backward.CBA_SITES.values())[i]
        assert cuda[i][:6] == [k, pad, int(mode == "reflect"), l_in, c_in, c_out], name
        assert cuda[i][6] == int(mode == "zero")  # dx at the 1x1 sites, none at env.in
        assert backward.CBA_SMEM[name] == 4 * backward.cba_floats(rows) <= 227 * 1024, name
        row = backward.CBA_ROW[name]
        assert row % 4 == 0 and k * c_in * c_out + c_out <= row < k * c_in * c_out + c_out + 4


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 256, 261, 500])
def test_k1_range_chain_forward_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K1's forward at the range encoder's stride-2 chains (csrc/in_chain.cu, namespace down, on
    csrc/down_chain.cuh): block j of the grid takes tiles j, j + blocks, ..., so every sample
    must lie in exactly one of those tiles, with the H100's 132 SMs and with fewer SMs than
    tiles. Tiles of 4 samples, or of 2 where tiles of 4 would leave more than half the SMs
    without one, so that batches 500 and 256 spread over at least 90% of the H100's SMs. Its
    sites are the rows the flagship's range chains give and down_chain.cuh's template instances,
    and a block's shared memory stays within the 227 KB a block can have, below K1b's."""
    for sms in (132, 7):
        tile, tiles, blocks = fused.res_fwd_plan(batch, sms)
        assert tile in (2, 4) and tiles == -(-batch // tile)
        assert (tile == 4) == (-(-batch // 4) > sms // 2)
        assert 1 <= blocks <= min(sms, tiles)
        _cover_once(tiles, blocks, tile, batch)
    if batch in (256, 500):
        assert fused.res_fwd_plan(batch, 132)[2] >= 0.9 * 132
    cuda = _cuda_site_rows("down_chain.cuh", r"using \w+ = Chain<(\d+), ([^;]*)>;")
    for i, name in enumerate(("pair0", "pair1", "single")):
        l_in, c_in, stages = IN_CHAINS[name]
        c_ins = [c_in] + [st[1] for st in stages]
        rows, _, _ = fused.stage_rows(torch.zeros((batch, l_in, c_in)),
                                      [(torch.zeros((k, c, c_out)), s, p, m)
                                       for (k, c_out, s, p, m), c in zip(stages, c_ins)])
        site = f"range.{name}"
        assert rows == fused.DOWN_SITES[site] and list(fused.DOWN_SITES)[i] == site
        # Chain<id, Stage<k, s, p, reflect, l_in, c_in, c_out>, Stage<...>, two>
        args = cuda[i]
        assert args[-1] == len(rows) // 8 - 1, site
        for j in range(len(rows) // 8):
            assert args[7 * j:7 * j + 6] == rows[8 * j:8 * j + 6] and \
                args[7 * j + 6] == rows[8 * j + 7], site
        for t in (2, 4):
            smem = fused.DOWN_FWD_SMEM[site, t]
            assert smem == 4 * fused.down_fwd_floats(rows, t) <= 227 * 1024
            assert smem < backward.DOWN_SMEM[site]


def test_other_shapes_take_the_general_kernels():
    """Only the flagship's call sites take K1's range-chain path and K2's and K2b's site paths
    (range.pair0 without dx at K1b, env.in without dx at K2b): other widths, lengths, strides,
    k, pads, pad modes and depths, and the residual block, keep the general kernels (or the
    residual block's own)."""
    for name, rows in fused.DOWN_SITES.items():
        assert fused.down_site(rows) == name
    pair1 = fused.DOWN_SITES["range.pair1"]
    for rows in ([4, 2, 1, 0, 64, 4, 32, 8, 4, 2, 1, 0, 32, 8, 16, 16],  # half width
                 pair1[:8], pair1[8:],  # one stage of a pair
                 [4, 2, 1, 0, 32, 32, 16, 64],  # another length
                 [3, 2, 1, 0, 16, 32, 8, 64],  # another k
                 2 * backward.RES_STAGE):
        assert fused.down_site(rows) is None, rows
    for name, rows in backward.CBA_SITES.items():
        assert backward.cba_site(rows, need_dx=False) == name
        assert backward.cba_site(rows, need_dx=True) == (None if name == "env.in" else name)
    for name, rows in fused.CBA_SITES.items():
        assert fused.cba_site(rows) == name
    for rows in ([1, 1, 0, 0, 8, 64, 8, 4], [1, 1, 0, 0, 16, 64, 16, 2],
                 [5, 1, 2, 1, 128, 1, 128, 16], [7, 1, 3, 0, 128, 1, 128, 16],
                 [1, 1, 0, 0, 8, 4, 8, 64], [3, 1, 1, 0, 8, 2, 8, 64]):
        assert backward.cba_site(rows, need_dx=False) is None, rows
        assert fused.cba_site(rows) is None, rows
    # K2's forward routing on the stage rows the wrapper builds: another length, width, k,
    # stride, pad or pad mode than a call site's keeps the general kernel
    for l_in, c_in, k, c_out, stride, pad, mode in (
            (16, 64, 1, 2, 1, 0, "zero"), (8, 32, 1, 2, 1, 0, "zero"), (8, 64, 1, 4, 1, 0, "zero"),
            (8, 64, 3, 2, 1, 1, "zero"), (8, 64, 1, 2, 2, 0, "zero"),
            (128, 1, 7, 16, 1, 3, "zero"), (128, 1, 5, 16, 1, 2, "reflect"),
            (64, 1, 7, 16, 1, 3, "reflect"), (128, 2, 7, 16, 1, 3, "reflect"),
            (128, 1, 7, 16, 2, 3, "reflect"), (8, 2, 1, 32, 1, 0, "zero"),
            (8, 2, 3, 64, 1, 1, "reflect"), (16, 2, 1, 64, 1, 0, "zero")):
        rows, _, _ = fused.stage_rows(torch.zeros((2, l_in, c_in)),
                                      [(torch.zeros((k, c_in, c_out)), stride, pad, mode)])
        assert fused.cba_site(rows) is None, rows


@pytest.mark.parametrize("batch", [1, 3, 4, 5, 256, 261, 500])
def test_k2_site_tiles_cover_every_sample_once_within_shared_memory(batch):
    """K2's forward at its three call sites (csrc/in_chain.cu, namespace cba): block j of the grid
    takes tiles j, j + blocks, ..., so every sample must lie in exactly one of those tiles, with
    the H100's 132 SMs and with fewer SMs than tiles; tiles of 4 samples, or of 2 where tiles of
    4 would leave more than half the SMs without one. Its sites are the rows the flagship's K2
    calls give, K2b's and the source's template instances (site id, k, pad, reflect, l_in, c_in,
    c_out, items a thread), and a block's shared memory (two buffers of the tile's x) stays
    within the 48 KB a block has by default."""
    for sms in (132, 7):
        tile, tiles, blocks = fused.res_fwd_plan(batch, sms)
        assert tile in (2, 4) and tiles == -(-batch // tile)
        assert (tile == 4) == (-(-batch // 4) > sms // 2)
        assert 1 <= blocks <= min(sms, tiles)
        _cover_once(tiles, blocks, tile, batch)
    cuda = _cuda_site_rows("in_chain.cu", r"using \w+ = CbaSite<(\d+), ([^>]*)>;")
    assert sorted(cuda) == [0, 1, 2] and list(fused.CBA_SITES) == list(K2B_SITES)
    for i, (name, (l_in, c_in, k, c_out, pad, mode)) in enumerate(K2B_SITES.items()):
        rows, l_out, _ = fused.stage_rows(torch.zeros((batch, l_in, c_in)),
                                          [(torch.zeros((k, c_in, c_out)), 1, pad, mode)])
        assert rows == fused.CBA_SITES[name] == backward.CBA_SITES[name]
        assert fused.cba_site(rows) == name
        assert cuda[i][:6] == [k, pad, int(mode == "reflect"), l_in, c_in, c_out], name
        per = cuda[i][6]
        for t in (2, 4):  # a block's threads: the tile's items (a row's 4 channels, or 1) / per
            items = t * l_out * (c_out // 4 if c_out % 4 == 0 else c_out)
            assert items % per == 0 and (items // per) % 32 == 0 and items // per <= 1024, name
            smem = fused.CBA_FWD_SMEM[name, t]
            assert smem == 4 * fused.cba_fwd_floats(rows, t) <= 48 * 1024, name


@pytest.mark.parametrize("batch", [1, 5, 7, 8, 9, 256, 261, 500])
def test_k4_head_plan_covers_every_sample_once_within_shared_memory(batch):
    """K4's small-head path (csrc/mlp_chain.cu, namespace head): block j of the grid takes tiles
    j, j + blocks, ..., a warp a sample, so every sample must lie in exactly one tile, with the
    H100's 132 SMs and with fewer SMs than tiles. It takes the classifier and any chain of 1-8
    layers whose every width is at most 64, not the restorers; a block's shared memory (every
    layer's weights and biases) stays within the 227 KB a block can have, eight 64-wide layers
    included."""
    for sms in (132, 7):
        tiles, blocks = fused.mlp_head_plan(batch, sms)
        assert tiles == -(-batch // fused.MLP_HEAD_TILE) and 1 <= blocks <= min(sms, tiles)
        _cover_once(tiles, blocks, fused.MLP_HEAD_TILE, batch)
    classifier = MLPS["classifier"][0]
    assert fused.takes_mlp_head(classifier)
    assert fused.mlp_head_smem(classifier) == 4 * (256 + 16 + 512 + 32 + 512 + 16 + 80 + 8
                                                   + fused.MLP_HEAD_TILE * 2 * 64)
    for dims in RESTORER_DIMS.values():
        assert not fused.takes_mlp_head(dims)
    for dims in ((65, 16), (16, 65), (16, 64, 65, 5), (64,) * 10):
        assert not fused.takes_mlp_head(dims), dims
    for dims in ((1, 1), (64,) * 9, (7, 3, 1, 9)):
        assert fused.takes_mlp_head(dims), dims
        assert fused.mlp_head_smem(dims) <= 227 * 1024


def test_port_kernels_keeps_the_csrc_global_functions_only():
    """graph_kernels.port_kernels keeps a graph's kernels whose name's last part is a
    __global__ function of csrc/ (with or without a namespace) and drops PyTorch's: the checks
    of chip_smoke.py's [noexpand] and [soft] phases count the port's kernels among plain ops."""
    from iinsvae_torch.ops.kernels import graph_kernels

    seen = {"cluster::mlp_cluster_kernel": 1, "head::mlp_head_kernel": 1,
            "iins::reduce_partials_kernel": 2, "res2d_bf16_wgmma_kernel": 1,
            "at::native::reduce_kernel": 7, "at::native::vectorized_elementwise_kernel": 9,
            "cutlass::Kernel2": 2, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n": 3}
    assert graph_kernels.port_kernels(seen) == {
        "cluster::mlp_cluster_kernel": 1, "head::mlp_head_kernel": 1,
        "iins::reduce_partials_kernel": 2, "res2d_bf16_wgmma_kernel": 1}
