"""Smoke test of the PyTorch/CUDA port (iinsvae_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. prints the card (nvidia-smi name and power limit) and the versions;
2. builds the CUDA kernels from iinsvae_torch/ops/kernels/csrc with nvcc;
3. at batch 500, calls every kernel at every shape the serving forward gives
   it, holds the result against the kernel's plain PyTorch version on the
   same inputs, and times kernel, plain version and (where one PyTorch call
   computes the same conv) that call on the device: CUDA graphs of 20 calls
   replayed between CUDA events after a warmup, median of 25 replays; the
   kernel's eager back-to-back time (the host's dispatch) beside it;
4. serves the flagship 1-D model at full width (seeded weights) through
   ``Predictor(device="cuda")`` on two paths, each on 3 batches of 500 CIRs
   and a ragged 137 with every launch counter set to 0 just before and
   read just after: without the decoder (12 launches a batch) and with
   ``return_recon=True`` (17 a batch); checks that every kernel ran its
   expected count and that the outputs, the reconstruction included, match
   the same weights' ``Predictor(device="cpu")``;
5. measures serving throughput at batch 500 and 256, without and with the
   reconstruction, and the device's idle share of served batches from a
   torch.profiler trace of the card.

Prints a ``sites`` line (per call site), a ``serving`` line, a ``kernels``
line, the nvidia-smi line and, last, ``{"ok": true, "device": {...}}``.
The whole result also goes to chiprun_out/chip_smoke.json. Any failure
raises and exits non-zero; without a CUDA device it exits 2 and prints no
result.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops import kernels
from iinsvae_torch.ops.conv import out_len
from iinsvae_torch.ops.kernels import _build, fused, strided_conv
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.serving import Predictor

BATCH = 500
# H100 SXM data-sheet peaks: HBM bytes/s, and
# float32 outside the tensor cores (the kernels use fp32 FMAs)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
# Kernel vs plain version on the card: both fp32, but the kernels sum in
# another order (conv sums of up to 192 terms, dense sums of up to 512) and
# InstanceNorm divides by a per-channel std, which can scale that rounding up.
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-4
# Predictor on the card vs on the CPU: 12 (17) launches' reorderings compound.
SERVE_RTOL, SERVE_ATOL = 1e-3, 1e-4
# launches per forward batch of the flagship (n_downsample 4, n_residual 3)
# without the decoder: in_chain 3 stage groups + 3 residual blocks;
# conv_bias_act the range out-conv and the env in-conv; strided_conv two
# env stages; mlp_chain 2 heads. The decoder adds its 1x1 in-conv
# (conv_bias_act), 3 AdaIN blocks and the tail.
EXPECTED_NO_RECON = {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2,
                     "adain_res_block": 0, "sln_chain": 0}
EXPECTED_RECON = {**EXPECTED_NO_RECON, "conv_bias_act": 3, "adain_res_block": 3,
                  "sln_chain": 1}
SOURCES = {
    "in_chain": "iinsvae_torch/ops/kernels/csrc/in_chain.cu",
    "conv_bias_act": "iinsvae_torch/ops/kernels/csrc/in_chain.cu",
    "strided_conv": "iinsvae_torch/ops/kernels/csrc/in_chain.cu",
    "mlp_chain": "iinsvae_torch/ops/kernels/csrc/mlp_chain.cu",
    "adain_res_block": "iinsvae_torch/ops/kernels/csrc/in_chain.cu",
    "sln_chain": "iinsvae_torch/ops/kernels/csrc/sln_chain.cu",
}
FLAGSHIP = dict(conv_type=1, cir_len=157, num_classes=5, style_dim=16, dim=4,
                n_residual=3, n_downsample=4, range_dim=2)
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


def call_sites(model: IInsVAE, gen: torch.Generator) -> list[dict]:
    """Every kernel call of one serving forward with the reconstruction, at
    batch 500, with the model's own weights and seeded random inputs of the
    right shape."""
    re_, ee = model.encoder.range_encoder, model.encoder.env_encoder
    dec = model.decoder.decoder
    dev = next(model.parameters()).device

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    sites = []

    def add_in_chain(name, x, stages, replaces, residual=False, calls=1):
        l, flops = x.shape[1], 0.0
        for taps, s, p, mode in stages:
            flops += conv_flops(BATCH, l, taps, s, p, mode)
            l = out_len(l, taps.shape[0], s, p)
        y_numel = BATCH * l * stages[-1][0].shape[2]
        sites.append(dict(
            name=name, kernel="in_chain", replaces=replaces, calls_per_batch=calls,
            shape=f"{tuple(x.shape)}->({BATCH}, {l}, {stages[-1][0].shape[2]})",
            run=lambda: fused.in_chain(x, stages, residual=residual),
            plain=lambda: fused.in_chain_ref(x, stages, residual=residual), library=None,
            bytes=nbytes(x, *[s[0] for s in stages]) + 4 * y_numel, flops=flops))

    def add_conv(name, kernel, x, taps, bias, s, p, mode, replaces):
        l_out = out_len(x.shape[1], taps.shape[0], s, p)
        if kernel == "strided_conv":
            run = lambda: strided_conv.strided_conv(x, taps, bias)
            plain = lambda: strided_conv.strided_conv_ref(x, taps, bias)
        else:
            run = lambda: fused.conv_bias_act(x, taps, bias, stride=s, padding=p, pad_mode=mode)
            plain = lambda: fused.conv_bias_act_ref(x, taps, bias, stride=s, padding=p,
                                                    pad_mode=mode)
        sites.append(dict(
            name=name, kernel=kernel, replaces=replaces, calls_per_batch=1,
            shape=f"{tuple(x.shape)}->({BATCH}, {l_out}, {taps.shape[2]})",
            run=run, plain=plain, library=ncl_conv(x, taps, bias, s, p, mode),
            bytes=nbytes(x, taps, bias) + 4 * BATCH * l_out * taps.shape[2],
            flops=conv_flops(BATCH, x.shape[1], taps, s, p, mode)))

    def add_mlp(name, head, replaces):
        n = len(head.slopes)
        ws = [getattr(head, f"w{j}") for j in range(n)]
        bs = [getattr(head, f"b{j}") for j in range(n)]
        x = rand(BATCH, ws[0].shape[0])
        sites.append(dict(
            name=name, kernel="mlp_chain", replaces=replaces, calls_per_batch=1,
            shape="->".join(str(d) for d in [ws[0].shape[0]] + [w.shape[1] for w in ws]),
            run=lambda: fused.mlp_chain(x, ws, bs, head.slopes),
            plain=lambda: fused.mlp_chain_ref(x, ws, bs, head.slopes), library=None,
            bytes=nbytes(x, *ws, *bs) + 4 * BATCH * ws[-1].shape[1],
            flops=2.0 * BATCH * sum(w.numel() for w in ws)))

    fp = "iinsvae_tpu/ops/pallas/fused.py"
    stages = [(re_.in_kernel, 1, 3, "reflect")] + [
        (getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)]
    add_in_chain("range.pair0", rand(BATCH, 128, 1), stages[0:2], f"{fp}:361")
    add_in_chain("range.pair1", rand(BATCH, 64, 8), stages[2:4], f"{fp}:361")
    add_in_chain("range.single", rand(BATCH, 16, 32), stages[4:5], f"{fp}:1320")
    add_in_chain("range.res", rand(BATCH, 8, 64),
                 [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")],
                 f"{fp}:253", residual=True, calls=3)
    add_conv("range.out", "conv_bias_act", rand(BATCH, 8, 64), re_.out_kernel, re_.out_bias,
             1, 0, "zero", f"{fp}:1320")
    c0, c1, c2 = ee.ConvINAct_0, ee.ConvINAct_1, ee.ConvINAct_2
    add_conv("env.in", "conv_bias_act", rand(BATCH, 128, 1), c0.kernel, c0.bias, 1, 3,
             "reflect", f"{fp}:1320")
    sc = "iinsvae_tpu/ops/pallas/strided_conv.py:250"
    add_conv("env.down0", "strided_conv", rand(BATCH, 128, 16), c1.kernel, c1.bias, 2, 1,
             "zero", sc)
    add_conv("env.down1", "strided_conv", rand(BATCH, 64, 32), c2.kernel, c2.bias, 2, 1,
             "zero", sc)
    add_mlp("restorer", model.restorer.restorer, f"{fp}:1164")
    add_mlp("classifier", model.classifier.classifier, f"{fp}:1164")

    add_conv("dec.in", "conv_bias_act", rand(BATCH, 8, 2), dec.in_kernel, dec.in_bias, 1, 0,
             "zero", f"{fp}:1320")
    x, k1, k2 = rand(BATCH, 8, 64), dec.res0_kernel1, dec.res0_kernel2
    affine = [rand(BATCH, 64) for _ in range(4)]
    sites.append(dict(
        name="dec.res", kernel="adain_res_block", replaces=f"{fp}:557", calls_per_batch=3,
        shape=f"{tuple(x.shape)}->{tuple(x.shape)}",
        run=lambda: fused.adain_res_block(x, k1, k2, *affine),
        plain=lambda: fused.adain_res_block_ref(x, k1, k2, *affine), library=None,
        bytes=nbytes(x, k1, k2, *affine, x),
        flops=2 * conv_flops(BATCH, 8, k1, 1, 1, "reflect")))
    xt = rand(BATCH, 8, 64)
    stages = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
              for j in range(4)]
    flops, l = 0.0, xt.shape[1]
    for taps, *_ in stages:  # x2 upsample, then a k5 zero-pad-2 conv
        k, c_in, c_out = taps.shape
        flops += 2.0 * BATCH * upsampled_rows(l, k, 2) * c_in * c_out
        l *= 2
    flops += conv_flops(BATCH, l, dec.out_kernel, 1, 3, "reflect")
    pool = adaptive_avg_pool_matrix(l, 157, device=dev)  # a buffer, as the encoder's is
    sites.append(dict(
        name="dec.tail", kernel="sln_chain", replaces=f"{fp}:1027", calls_per_batch=1,
        shape=f"{tuple(xt.shape)}->({BATCH}, 157)",
        run=lambda: fused.sln_chain(xt, stages, dec.out_kernel, dec.out_bias, 157),
        plain=lambda: fused.sln_chain_ref(xt, stages, dec.out_kernel, dec.out_bias, 157,
                                          pool=pool),
        library=None,
        bytes=nbytes(xt, *[t for st in stages for t in st], dec.out_kernel, dec.out_bias)
        + 4 * BATCH * 157,
        flops=flops))
    return sites


def check_and_time(sites: list[dict]) -> list[dict]:
    rows = []
    for s in sites:
        got, want = s["run"](), s["plain"]()
        torch.cuda.synchronize()
        err = (got - want).abs()
        rel = (err / want.abs().clamp_min(1e-12)).max().item()
        if not torch.isfinite(got).all():
            raise AssertionError(f"{s['name']}: non-finite kernel output")
        torch.testing.assert_close(got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL,
                                   msg=lambda m: f"{s['name']} kernel vs plain: {m}")
        bytes_ms = s["bytes"] / PEAK_BYTES_PER_S * 1e3
        flops_ms = s["flops"] / PEAK_FP32_FLOP_PER_S * 1e3
        rows.append(dict(
            name=s["name"], kernel=s["kernel"], shape=s["shape"], replaces=s["replaces"],
            calls_per_batch=s["calls_per_batch"], max_abs_err=err.max().item(),
            max_rel_err=rel, ms=device_ms(s["run"]), eager_ms=eager_ms(s["run"]),
            plain_ms=device_ms(s["plain"]),
            library_ms=device_ms(s["library"]) if s["library"] else None,
            bytes=s["bytes"], flops=s["flops"], bound_ms=max(bytes_ms, flops_ms),
            bound_by="bytes" if bytes_ms >= flops_ms else "operations"))
        r = rows[-1]
        print(f"[kernel] {r['name']:<16} {r['shape']:<34} max_abs_err {r['max_abs_err']:.3e} "
              f"max_rel_err {r['max_rel_err']:.3e}  {r['ms'] * 1e3:8.2f} us (eager "
              f"{r['eager_ms'] * 1e3:.2f})  plain "
              f"{r['plain_ms'] * 1e3:8.2f} us  bound {r['bound_ms'] * 1e3:6.2f} us "
              f"({r['bound_by']})", flush=True)
    return rows


def kernel_rows(site_rows: list[dict], launches: dict[str, int],
                launches_no_recon: dict[str, int]) -> list[dict]:
    """One row per kernel, its numbers summed over one forward batch's calls
    (with the reconstruction); launches from the recon main path, and from
    the path without it beside them."""
    out = []
    for name in EXPECTED_RECON:
        rs = [r for r in site_rows if r["kernel"] == name]

        def total(key):
            return sum(r[key] * r["calls_per_batch"] for r in rs)

        bytes_ms = sum(r["bound_ms"] * r["calls_per_batch"] for r in rs if r["bound_by"] == "bytes")
        replaces = list(dict.fromkeys(r["replaces"] for r in rs))
        out.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=replaces[0],
            also_replaces=replaces[1:], launches=launches[name],
            launches_no_recon=launches_no_recon[name],
            max_abs_err=max(r["max_abs_err"] for r in rs), ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by="bytes" if bytes_ms >= total("bound_ms") / 2 else "operations",
            library_ms=(total("library_ms") if all(r["library_ms"] is not None for r in rs)
                        else None),
            per="one forward batch of 500 (sum over its call sites)"))
    return out


def serve_main_path(model: IInsVAE, cpu_model: IInsVAE, recon: bool) -> tuple[dict, dict]:
    """3 batches of 500 and one of 137 through Predictor(device='cuda'),
    without or with the reconstruction, counted, and compared with the CPU
    Predictor on the same weights."""
    rng = np.random.default_rng(0)
    requests = [rng.normal(size=(n, 157)).astype(np.float32) for n in (500, 500, 500, 137)]
    gpu = Predictor(model, batch_size=BATCH, return_recon=recon, device="cuda")
    kernels.reset_launch_counts()
    outs = [gpu(r) for r in requests]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    expected = EXPECTED_RECON if recon else EXPECTED_NO_RECON
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
    result = dict(recon=recon, requests=[len(r) for r in requests], launches=launches,
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            p(b)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return dict(device_events=len(spans), device_busy_us=busy_us, wall_us=wall_us,
                device_busy_us_per_batch=busy_us / len(batches),
                device_idle_share=1.0 - busy_us / wall_us if spans else None)


def throughput(model: IInsVAE, recon: bool) -> dict:
    """Per-request path (host arrays in, host arrays out) at each batch size,
    without or with the reconstruction; one forward of that path on a
    resident batch, on the device (graph) and eager; the device's idle
    share over 40 served batches, from a trace."""
    rng = np.random.default_rng(1)
    res = {}
    for bs in (500, 256):
        p = Predictor(model, batch_size=bs, return_recon=recon, device="cuda")
        n_batches = 120  # p90 then has 12 batches beyond it
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
        print(f"[serve] {'recon' if recon else 'no recon'} batch {bs}: "
              f"{res[bs]['cir_per_s']:.1f} CIR/s, latency median "
              f"{median_lat:.3f} ms, forward {fwd_ms:.4f} ms on the device "
              f"({fwd_eager_ms:.4f} ms eager), device idle over 40 traced batches "
              f"{'not measured (no device events)' if idle is None else f'{idle:.4f}'} "
              f"({trace['device_events']} device events)", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    cpu_model = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).cuda()

    with torch.inference_mode():
        site_rows = check_and_time(call_sites(model, torch.Generator().manual_seed(1)))
    main_path, launches_no_recon = serve_main_path(model, cpu_model, recon=False)
    main_path_recon, launches = serve_main_path(model, cpu_model, recon=True)
    serving = throughput(model, recon=False)
    serving_recon = throughput(model, recon=True)
    kernel_table = kernel_rows(site_rows, launches, launches_no_recon)

    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(dict(
        card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
        sites=site_rows, kernels=kernel_table, main_path=main_path,
        main_path_recon=main_path_recon, serving=serving, serving_recon=serving_recon,
        kernel_tolerance=[KERNEL_RTOL, KERNEL_ATOL], serve_tolerance=[SERVE_RTOL, SERVE_ATOL]),
        indent=1))
    print(json.dumps({"sites": site_rows}), flush=True)
    print(json.dumps({"serving": serving, "card": card}), flush=True)
    print(json.dumps({"serving_recon": serving_recon, "card": card}), flush=True)
    print(json.dumps({"kernels": kernel_table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
