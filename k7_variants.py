"""K7's accuracy devices on one NVIDIA card: what each costs and what it buys.

    python3 k7_variants.py [--parent DIR] [--out FILE]

K7 (``iinsvae_torch/ops/kernels/csrc/res_block_2d.cu``) sums its 3xTF32 products in partial sums
of kFlush k-steps, and centres each conv's input by its mean per (sample, channel), adding
conv(mean) back, summed in fp32. This script builds variants of that source, one nvcc each, all
at once, under ``build/k7_variants/``:

- ``kept``: the source as it is;
- ``one_accumulator``: every product of a conv into one mma accumulator;
- ``flush1``, ``flush4``, ``flush8``: partial sums of 1, 4 or 8 k-steps;
- ``no_centring``: the means set to 0 (so conv(mean) = 0; its sums are still taken);
- ``mean_conv_fp64``: conv(mean) summed in fp64 (each slice's share in fp32);
- ``parent`` (with --parent DIR, a checkout of another commit): DIR's K7 as it is.

For each it prints ptxas's registers and spills, the device time of a call at batch 500
(chip_smoke.py's CUDA-graph replay, both instances, IN and AdaIN), the largest error of y, d1
and d2 against the float64 block over the plain fp32 block's, at batch 500, 261, 5 and 1 (the
data of tests/test_torch_gpu.py), and the 2-D training step's gradients against float64 under
the two step checks, over 12 seeded steps: tests/test_torch_gpu.py's
(test_gpu_training_step_gradients_match_cpu: batch 64, model seed 9, data seed 1, and 7
other seed pairs) and chip_smoke.py's (step_grads_vs_cpu: the fixture's first 500 CIRs, model
seed 3, and 3 other model seeds): how many gradients are over the limit and the worst ratio
to it. The variants' names match the source's text, so the script fails loudly if the kernel
changes: update VARIANTS with it. Prints one JSON line and writes it to FILE (default
build/k7_variants.json). Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import copy
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
CSRC = "iinsvae_torch/ops/kernels/csrc"
_MMA = ("      if (j == 0)\n        tf32x3::mma3<true>(part, a, b);\n      else\n"
        "        tf32x3::mma3(part, a, b);\n")
_FLUSH = "constexpr int kFlush = 2;"
_CENTRE = "  center(f, c);\n"
# each variant: text replacements of the kept source (each text must be there once, or with
# a count as a third element)
VARIANTS = {
    "kept": [],
    "one_accumulator": [(_MMA, "      tf32x3::mma3(acc, a, b);\n"),
                        ("    add(acc, part);\n", "")],
    "flush1": [(_FLUSH, "constexpr int kFlush = 1;")],
    "flush4": [(_FLUSH, "constexpr int kFlush = 4;")],
    "flush8": [(_FLUSH, "constexpr int kFlush = 8;")],
    "no_centring": [(_CENTRE, "  for (int i = threadIdx.x; i < kSamples * kC; i += kThreads) "
                              "c[i] = 0.f;\n  __syncthreads();\n", 2)],
    "mean_conv_fp64": [("float (&kp)[kSamples]", "double (&kp)[kSamples]", 2),
                       ("  float kp[kSamples] = {};", "  double kp[kSamples] = {};")],
}
ZERO_GRAD = re.compile(r"encoder\.range_encoder\.(in|down\d+)_bias")
STEP_FACTOR, STEP_FLOOR = 10.0, 1e-4  # both step checks' limit: 10 x the CPU's + 1e-4 of scale


def variant_source(src: str, edits) -> str:
    for old, new, *count in edits:
        n = count[0] if count else 1
        if src.count(old) != n:
            raise SystemExit(f"k7_variants: {old!r} is not in the source {n} time(s)")
        src = src.replace(old, new)
    return src


def build(sources: dict[str, tuple[str, Path]], out: Path, nvcc: str, flags) -> dict:
    """One nvcc a variant, all at once -> {name: (ctypes library, ptxas lines)}."""
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (text, inc) in sources.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-I", str(inc), "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"k7_variants: nvcc {name} failed:\n{log}")
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.iins_res_block_2d.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_void_p]
        libs[name] = (lib, [ln.split("info    : ")[-1].strip() for ln in log.splitlines()
                            if "registers" in ln or "spill" in ln])
    return libs


def launch(lib, x, k1, k2, *affine, save=False):
    y = torch.empty_like(x)
    d = [torch.empty_like(x), torch.empty_like(x)] if save else []
    tables = [t.data_ptr() for t in affine] if affine else [None] * 4
    err = lib.iins_res_block_2d(x.data_ptr(), k1.data_ptr(), k2.data_ptr(), *tables,
                                y.data_ptr(), *([t.data_ptr() for t in d] or [None, None]),
                                x.shape[0], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"res_block_2d variant: CUDA error {err}")
    return (y, *d) if save else y


def block_inputs(b: int, adain: bool):
    """tests/test_torch_gpu.py's data for the res_block_2d tests."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, 8, 8, 64), generator=gen).cuda()
    k1 = (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).cuda()
    k2 = (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).cuda()
    affine = [torch.randn((b, 64), generator=gen).cuda() for _ in range(4)] if adain else []
    return x, k1, k2, affine


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="a checkout of another commit: its K7 too")
    ap.add_argument("--out", type=Path, default=HERE / "build" / "k7_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_variants: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import card_line, device_ms, train_config
    from iinsvae_torch.cli import train_semi
    from iinsvae_torch.models.vae import IInsVAE
    from iinsvae_torch.ops.kernels import _build, res2d
    from iinsvae_torch.training import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = (HERE / CSRC / "res_block_2d.cu").read_text()
    sources = {k: (variant_source(src, e), HERE / CSRC) for k, e in VARIANTS.items()}
    if args.parent:
        pc = args.parent.resolve() / CSRC
        sources["parent"] = ((pc / "res_block_2d.cu").read_text(), pc)
    libs = build(sources, HERE / "build" / "k7_variants", _build.nvcc(), _build.NVCC_FLAGS)
    card = card_line()
    print(card, flush=True)
    res = {k: dict(ptxas=p) for k, (_, p) in libs.items()}
    for k, (_, p) in libs.items():
        print(f"[ptxas] {k}: " + "; ".join(p), flush=True)

    for adain in (False, True):  # device time a call at batch 500
        x, k1, k2, aff = block_inputs(500, adain)
        for k, (lib, _) in libs.items():
            res[k][f"us_{'adain' if adain else 'in'}"] = device_ms(
                lambda: launch(lib, x, k1, k2, *aff)) * 1e3
            res[k][f"save_us_{'adain' if adain else 'in'}"] = device_ms(
                lambda: launch(lib, x, k1, k2, *aff, save=True)) * 1e3
    for b in (500, 261, 5, 1):  # error against float64 over the plain fp32 block's
        for adain in (False, True):
            x, k1, k2, aff = block_inputs(b, adain)
            plain = res2d.res_block_2d_ref(x, k1, k2, *aff, save=True)
            want = res2d.res_block_2d_ref(*(t.double() for t in (x, k1, k2, *aff)), save=True)
            e_plain = [(t.double() - w).abs().max().item() for t, w in zip(plain, want)]
            for k, (lib, _) in libs.items():
                got = launch(lib, x, k1, k2, *aff, save=True)
                ratio = max((t.double() - w).abs().max().item() / e
                            for t, w, e in zip(got, want, e_plain))
                key = f"f64_err_over_plain_b{b}"
                res[k][key] = max(res[k].get(key, 0.0), ratio)

    def small(ms, ds):
        rng = np.random.default_rng(ds)
        batch = {"cir": rng.normal(size=(64, 157)), "err": np.abs(0.3 * rng.normal(size=(64, 1))),
                 "label": rng.integers(0, 5, size=(64, 1)), "weight": np.ones(64)}
        mask = (rng.random(64) < 0.5).astype(np.float32)
        return ("test", ms, ds, {k: torch.tensor(v, dtype=torch.float32, device="cuda")
                                 for k, v in batch.items()}, torch.tensor(mask, device="cuda"), 0.5)

    fixture = train_semi.build(train_config(2), "cuda").data
    mask500 = steps.draw_sup_mask(500, 0.1, "sample", torch.Generator(device="cuda").manual_seed(5))
    cases = [small(ms, ds) for ms, ds in ((9, 1), (9, 2), (3, 1), (5, 1), (7, 3), (11, 4),
                                          (13, 5), (2, 7))]
    cases += [("chip_smoke", ms, 5, {k: v[:500] for k, v in fixture.items()}, mask500, 0.1)
              for ms in (3, 4, 5, 6)]
    for check, ms, ds, data, mask, rate in cases:
        cpu = IInsVAE(cir_len=157, num_classes=5, style_dim=16, conv_type=2,
                      generator=torch.Generator().manual_seed(ms))
        f64 = copy.deepcopy(cpu).double()
        grads = steps.make_semi_grads_fn(rate)
        grads(cpu, {k: v.cpu() for k, v in data.items()}, sup_mask=mask.cpu())
        grads(f64, {k: v.cpu().double() for k, v in data.items()}, sup_mask=mask.cpu().double())
        ref, fp32 = dict(f64.named_parameters()), dict(cpu.named_parameters())
        line = f"[step] {check} model seed {ms} data seed {ds}:"
        for k, (lib, _) in libs.items():
            _build._fns.clear()
            _build._libs["res_block_2d"] = lib
            gpu = copy.deepcopy(cpu).cuda()
            grads(gpu, data, sup_mask=mask)
            over, worst = 0, (0.0, "")
            for name, p in gpu.named_parameters():
                if ZERO_GRAD.fullmatch(name):
                    continue
                want = ref[name].grad
                e = (p.grad.cpu().double() - want).abs().max().item()
                limit = (STEP_FACTOR * (fp32[name].grad.double() - want).abs().max().item()
                         + STEP_FLOOR * want.abs().max().item())
                r = e / limit if limit else float(e > 0)
                over += r > 1
                worst = max(worst, (r, name))
            res[k].setdefault("steps", []).append(dict(
                check=check, model_seed=ms, data_seed=ds, over=over, worst=worst[0],
                worst_param=worst[1]))
            line += f"  {k} {over} over (worst {worst[0]:.2f})"
        print(line, flush=True)
    for k, r in res.items():
        r["steps_failed"] = sum(s["over"] > 0 for s in r["steps"])
        print(f"[variant] {k}: " + " ".join(
            f"{n} {v:.2f}" for n, v in r.items() if isinstance(v, float))
            + f"  steps failed {r['steps_failed']} of {len(r['steps'])}", flush=True)
    out = dict(card=card, torch=torch.__version__, variants=res)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
