"""The CPU-side parts of the bfloat16 K7 / K7b designs (csrc/res_block_2d_bf16*.cu): the
backward's launch plan and scratch, the phase-time cuts that phase_times.py applies to their
sources, and chip_smoke.py's whole-block yardstick composed of library calls. The kernels
themselves run on the card only (tests/test_torch_gpu.py, chip_smoke.py)."""

from __future__ import annotations

from pathlib import Path

import pytest
import torch

import chip_smoke
import phase_times
from iinsvae_torch.ops.kernels import backward, res2d

ROOT = Path(__file__).resolve().parents[1]
BF16 = torch.bfloat16
H100_SMS = 132


@pytest.mark.parametrize("slots", [2, 30])
@pytest.mark.parametrize("batch", [1, 5, 263, 500, 1031])
def test_bf16_bwd_plan_fits_the_card_and_covers_the_batch(batch, slots):
    """The input gradients' grid is at most one block a SM and a block a sample; the taps'
    gradient's chunks a conv are whole clusters of 4, both convs' clusters at most the card's
    slots (more would run in a second wave), and at most the batch rounded up to a cluster; the
    scratch holds one partial row a cluster and the three bfloat16 fields, 16-byte aligned."""
    blocks, chunks = backward.res2d_bf16_bwd_plan(batch, H100_SMS, slots)
    n = backward.RES2D_BF16_DK_CLUSTER
    assert 1 <= blocks <= min(H100_SMS, batch)
    assert 2 * blocks >= min(batch, 2 * H100_SMS)  # every warpgroup slot a sample, if enough
    assert chunks % n == 0 and chunks >= n
    assert 2 * chunks // n <= max(slots, 2)
    assert chunks <= n * -(-batch // n)
    rows = 2 * chunks // n * 9 * 64 * 64
    scratch = backward.res2d_bf16_bwd_scratch(batch, chunks)
    assert rows % 4 == 0 and scratch * 4 >= rows * 4 + 3 * batch * 64 * 64 * 2
    # block (conv, c) takes the samples c, c + chunks, ...: each sample exactly once a conv
    taken = sorted(s for c in range(chunks) for s in range(c, batch, chunks))
    assert taken == list(range(batch))


@pytest.mark.parametrize("kernel, design, last", [
    ("res2d_bf16", "res2d_bf16_wgmma_kernel", "constexpr int kLastPhase = 4;"),
    ("res2d_bf16_bwd", "res2d_bf16_bwd_wgmma_kernel", "constexpr int kLastPhase = 6;")])
def test_phase_cuts_apply_to_the_bf16_sources(kernel, design, last):
    """phase_times.py --kernel res2d_bf16 / res2d_bf16_bwd finds the new design in the current
    source and every cut applies once: each variant differs from the source, sets a smaller
    kLastPhase than the whole kernel's (or returns at the start), and the last is the source
    itself."""
    src = (ROOT / phase_times.CSRC / f"{phase_times.KERNELS[kernel][0]}.cu").read_text()
    assert src.count(last) == 1
    name, variants = phase_times.variants(src, kernel)
    assert name == design
    texts = [t for _, t in variants]
    assert texts[-1] == src and len(set(texts)) == len(texts)
    whole = int(last.split("= ")[1][:-1])
    for phase, text in variants[:-1]:
        cut = next((int(line.split("= ")[1][:-1]) for line in text.splitlines()
                    if line.startswith("constexpr int kLastPhase = ")), whole)
        assert cut < whole or "phase_times" in text or "return;" in text, phase


@pytest.mark.parametrize("adain_", [False, True])
def test_library_block_yardstick_computes_the_block(adain_):
    """chip_smoke.res2d_library_block's composition (two library convs, the norms, ReLU and
    skip on the channels-last NCHW view) is K7's block, and its forward-and-backward callable
    gives the block's gradients: run in float64 (the card runs it in bfloat16, as a yardstick of time), on
    bfloat16-valued inputs, it matches float64 autograd of the plain block within 1e-9 of each
    tensor's largest magnitude."""
    gen = torch.Generator().manual_seed(11)
    b = 3
    x, g = (torch.randn((b, 8, 8, 64), generator=gen).to(BF16).double() for _ in range(2))
    k1, k2 = ((0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(BF16).double()
              for _ in range(2))
    aff = [torch.randn((b, 64), generator=gen).to(BF16).double() for _ in range(4)] \
        if adain_ else []
    fwd, bwd = chip_smoke.res2d_library_block(x, k1, k2, aff, g)
    y = fwd().permute(0, 2, 3, 1)
    grads = bwd()
    leaves = [t.clone().requires_grad_(True) for t in (x, k1, k2, *aff)]
    y64 = res2d.res_block_2d_ref(*leaves)
    want = torch.autograd.grad(y64, leaves, g)
    got = [grads[0].permute(0, 2, 3, 1), grads[1].permute(2, 3, 1, 0),
           grads[2].permute(2, 3, 1, 0), *grads[3:]]
    assert len(got) == len(want)
    for name, a, w in zip(["y", "dx", "dk1", "dk2", "dg1", "db1", "dg2", "db2"],
                          [y, *got], [y64, *want]):
        assert a.shape == w.shape and a.dtype == torch.float64, name
        err = (a - w).abs().max().item()
        assert err <= 1e-9 * w.abs().max().item(), (name, err, w.abs().max().item())
