"""Where K1b's residual-block backward spends its time, phase by phase, on one NVIDIA card.

    python3 phase_times.py [--tree DIR] [--out FILE]

Reads DIR's ``iinsvae_torch/ops/kernels/csrc/in_chain_bwd.cu`` (DIR defaults to this
checkout) and builds one variant of it for each phase of the residual block's backward, which
stops the kernel after that phase (one nvcc each, all at once, under ``build/phases/``). Then
it times each variant through DIR's own wrappers at the two residual-block sites of a 1-D
training step at batch 500: K1b at the range encoder's IN block (``in_chain_bwd``) and K5b at
the decoder's AdaIN block (``adain_res_block_bwd``), with the flagship's seeded weights and
seeded inputs, by chip_smoke.py's CUDA-graph replay (median of 25). A variant's time less the
one before is its phase's time; the first row (the kernel returns at once) is the launch and
the fixed-order reduction of the partial rows. Every variant computes garbage past its cut,
so nothing is checked here: chip_smoke.py holds the whole kernel to its plain version.

The cut points are written for two designs of the kernel, named by the kernel that runs the
residual block: ``in_chain_bwd_kernel`` (one kernel for every K1b site, before the residual
block got its own path) and ``res_block_bwd_kernel``. Prints one JSON line and writes it to
FILE (default ``build/phase_times.json``). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
CSRC = "iinsvae_torch/ops/kernels/csrc"

# (phase, text after which the variant stops, the statement that stops it; None: the whole
# kernel), in the order the kernel runs them. A cut after the new design's d(taps) work has
# begun continues to the block's partial-row write, or the compiler would drop that work.
_CONT = "{ cp_async_wait<0>(); continue; }"
CUTS = {
    "in_chain_bwd_kernel": [
        ("launch + reduce", "  const float* gg = g + static_cast<size_t>(s0) * n_last;\n"),
        ("stage x", "    a0[s * n0 + (i - s * x_len)] = xg[i];\n  }\n  __syncthreads();\n"),
        ("(1) z1 = conv(x)", "  conv_stage4(a0, n0, w1, z1, n1, s1, ns);\n  __syncthreads();\n"),
        ("(2) y1 = relu(IN(z1))",
         "    norm_relu<kAdain>(z1, y1, s1.l_out, s1.c_out, ns, n1, af.g1, af.b1);\n"
         "    __syncthreads();\n"),
        ("(3) z2 = conv(y1)",
         "    conv_stage4(y1, n1, w2, z2, n2, s2, ns);\n    __syncthreads();\n"),
        ("(4) gz2", "                          ag.dg2, ag.db2);\n    __syncthreads();\n"),
        ("(5a) dW2", "    taps_grad_partial(y1, n1, z2, n2, s2, ns, mine + n_w1);\n"),
        ("(5b) gy1", "    conv_input_grad<4>(z2, n2, w2, s2, ns, y1, n1, nullptr, 0);\n"),
        ("(6) gz1", "af.g1, af.b1, ag.dg1,\n                          ag.db1);\n"),
        ("(7a) dW1", "  taps_grad_partial(a0, n0, z1, n1, s1, ns, mine);\n"),
        ("(7b) dx: the whole kernel", None),
    ],
    "res_block_bwd_kernel": [
        ("launch + reduce", "  float dw1[2][3][4] = {}, dw2[2][3][4] = {};\n"),
        ("stage taps, x, g", "      cp_async_wait<0>();\n    }\n    __syncthreads();\n",
         "{ cp_async_wait<0>(); return; }"),
        ("(1) z1 = conv(x)",
         "    if (recompute) conv_tile(xs, w1s, gy);  // (1)\n    __syncthreads();\n",
         "{ cp_async_wait<0>(); return; }"),
        ("(2) y1 = relu(IN(z1))", "    if (first) cp_async_wait<0>();\n    __syncthreads();\n"),
        ("(3) z2 = conv(y1)",
         "    if (recompute) conv_tile(y1, w2s, z2);  // (3)\n    __syncthreads();\n"),
        ("(4) gz2", "out ? ag.db2 + tab : nullptr);\n    }\n    __syncthreads();\n"),
        ("(4) + the partial-row write",
         "out ? ag.db2 + tab : nullptr);\n    }\n    __syncthreads();\n", _CONT),
        ("(5) dW2, gy1", "    taps_grad(y1, z2, ns, dw2);\n    __syncthreads();\n", _CONT),
        ("(6) gz1", "out ? ag.db1 + tab : nullptr);\n    }\n    __syncthreads();\n", _CONT),
        ("(7) dW1, dx: the whole kernel", None),
    ],
}


def variants(src: str) -> tuple[str, list[tuple[str, str]]]:
    """-> (the design's kernel name, [(phase, variant source)]). A cut without a statement of
    its own returns."""
    name = "res_block_bwd_kernel" if "res_block_bwd_kernel" in src else "in_chain_bwd_kernel"
    out = []
    for phase, anchor, *stop in CUTS[name]:
        if anchor is None:
            out.append((phase, src))
            continue
        if src.count(anchor) != 1:
            raise SystemExit(f"phase_times: the cut after {phase!r} is not in the source once")
        j = src.index(anchor) + len(anchor)
        out.append((phase, src[:j] + f"{stop[0] if stop else 'return;'}  // phase_times\n"
                    + src[j:]))
    return name, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--out", type=Path, default=HERE / "build" / "phase_times.json")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    if not torch.cuda.is_available():
        print("phase_times: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from chip_smoke import card_line, device_ms
    from iinsvae_torch.models.vae import IInsVAE
    from iinsvae_torch.ops.kernels import _build, backward

    torch.backends.cudnn.allow_tf32 = False
    src = (tree / CSRC / "in_chain_bwd.cu").read_text()
    kernel, vs = variants(src)
    out_dir = HERE / "build" / "phases" / tree.name
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, (phase, text) in enumerate(vs):
        cu = out_dir / f"in_chain_bwd_{i}.cu"
        cu.write_text(text)
        so = out_dir / f"in_chain_bwd_{i}.so"
        procs.append((so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(tree / CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for so, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"phase_times: nvcc {so.name} failed:\n{log}")

    model = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                    generator=torch.Generator().manual_seed(0)).cuda()
    re_, dec = model.encoder.range_encoder, model.decoder.decoder
    gen = torch.Generator().manual_seed(2)

    def rand(*shape):
        return torch.randn(shape, generator=gen).cuda()

    b = 500
    x, g = rand(b, 8, 64), rand(b, 8, 64)
    block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
    tables = [rand(b, 64) for _ in range(4)]
    sites = {
        "range.res": lambda: backward.in_chain_bwd(g, x, block, residual=True),
        "dec.res": lambda: backward.adain_res_block_bwd(g, x, dec.res0_kernel1,
                                                        dec.res0_kernel2, *tables),
    }
    rows = []
    with torch.no_grad():
        for (phase, _), (so, _) in zip(vs, procs):
            _build._fns.clear()
            _build._libs["in_chain_bwd"] = ctypes.CDLL(str(so))
            rows.append(dict(phase=phase, **{f"{k}_ms": device_ms(f) for k, f in sites.items()}))
            print(f"[phase] {phase:<30} " + "  ".join(
                f"{k} {rows[-1][f'{k}_ms'] * 1e3:8.2f} us" for k in sites), flush=True)
    res = dict(card=card_line(), torch=torch.__version__, tree=str(tree), kernel=kernel,
               batch=b, phases=rows)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
