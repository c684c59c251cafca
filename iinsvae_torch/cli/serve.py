"""`serve` entry of the port: the deployment surface (iinsvae_tpu/cli/serve.py).

Builds a ``Predictor`` from an export_serving ``weights.npz`` (``--npz``),
from the port's checkpoint of epoch ``--epoch N`` (``-1``: the latest) in
the directory the training flags name (``--model_dir``, ``--dataset_env``,
``--supervision_rate``, ...; training/checkpoint.py), or, without either,
from the seeded initialisation, and puts the request batcher in front of it
(runtime/batcher.py: batches of ``--serve_batch``, a partial batch flushed
``--deadline_ms`` after its oldest request). ``--probs`` appends the
env-class probabilities to every result, ``--recon`` the reconstructed CIR;
``--conv_type 2`` serves the expanded 2-D model, ``--conv_type 3`` the
column-image one; ``--use_soft`` a soft restorer's checkpoint (its mu).

With ``--socket PATH`` and/or ``--tcp_port PORT`` (0: an ephemeral port) it
listens until Ctrl-C (SIGINT); clients speak the framed protocol
(``runtime.socket_client_request``, or the JAX package's client of the same
name). Without either it sends ``--selftest_n`` CIRs of the data's test split
(cli/common.resolve_data, as training resolves it; ``--dataset_name ewine``: 152 taps)
through the server and exits. Either way it prints the server's counters on exit.

    python -m iinsvae_torch.cli.serve --dataset_env room_full --socket /tmp/iins.sock --probs
    python -m iinsvae_torch.cli.serve --dataset_env room_full --conv_type 2 --recon
    python -m iinsvae_torch.cli.serve --device cpu --dataset_env room_full --selftest_n 300
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from iinsvae_torch.cli.common import resolve_data
from iinsvae_torch.config import add_args, add_train_args, from_args
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.runtime.batcher import SocketFront, TcpFront, serve_predictor
from iinsvae_torch.serving import Predictor, resolve_device
from iinsvae_torch.training.checkpoint import latest_epoch, semi_model_dir


def build_predictor(args, cfg) -> tuple[Predictor, str]:
    """The predictor the flags name, and where its weights came from."""
    kw = dict(batch_size=args.serve_batch, return_recon=args.recon, device=args.device)
    if args.npz:
        return Predictor.from_npz(args.npz, cir_len=cfg.cir_len, **kw), args.npz
    if cfg.epoch:
        epoch = latest_epoch(semi_model_dir(cfg)) if cfg.epoch == -1 else cfg.epoch
        return Predictor.from_checkpoint(cfg, epoch, **kw), f"checkpoint epoch {epoch}"
    model = IInsVAE(**cfg.model_kwargs(), generator=torch.Generator().manual_seed(cfg.seed))
    return Predictor(model, **kw), "seeded init"


def self_test(server, n: int, cfg, recon: bool) -> None:
    """``n`` CIRs of the test split (repeated where it has fewer) through the server, one
    in-process request at a time."""
    cir_len = cfg.cir_len
    test_cir = resolve_data(cfg)[1][0]
    cirs = test_cir[np.arange(n) % test_cir.shape[0]]
    t0 = time.perf_counter()
    outs = [server.submit(c, timeout_s=300.0) for c in cirs]
    dt = time.perf_counter() - t0
    if any(o is None for o in outs):
        raise RuntimeError("self-test: a request timed out")
    errs = np.array([o[0] for o in outs])
    labels = np.array([o[1] for o in outs])
    counts = np.bincount(labels, minlength=cfg.num_classes).tolist() if (labels >= 0).all() else None
    if not np.isfinite(errs).all() or counts is None:
        raise RuntimeError("self-test: the server returned failure rows")
    print(f"[serve] self-test ok: {n} requests through the server in {dt:.3f}s, err range "
          f"({errs.min():.4f}, {errs.max():.4f}), labels {counts}", flush=True)
    if recon:
        rec = np.stack([o[2][-cir_len:] for o in outs])
        if not np.isfinite(rec).all():
            raise RuntimeError("self-test: non-finite reconstruction")
        print(f"[serve] recon {rec.shape}, range ({rec.min():.4f}, {rec.max():.4f})", flush=True)


def listen(server, sock_path: str, tcp_port: int) -> None:
    """The fronts the flags ask for, open until Ctrl-C (SIGINT)."""
    fronts = []
    try:
        if sock_path:
            fronts.append(SocketFront(server, sock_path))
            print(f"[serve] listening on {sock_path}", flush=True)
        if tcp_port >= 0:
            fronts.append(TcpFront(server, tcp_port))
            print(f"[serve] listening on tcp port {fronts[-1].port}", flush=True)
        print("[serve] Ctrl-C to stop", flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        for f in fronts:
            f.stop()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--npz", default="", help="export_serving weights.npz; empty = seeded init")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--socket", default="", help="unix socket path; empty = no unix front")
    parser.add_argument("--tcp_port", type=int, default=-1,
                        help="TCP listen port (0 = ephemeral); -1 = no TCP front")
    parser.add_argument("--probs", action="store_true",
                        help="append the env-class probabilities to every result")
    parser.add_argument("--recon", action="store_true",
                        help="append the reconstructed CIR to every result (runs the decoder)")
    parser.add_argument("--serve_batch", type=int, default=256)
    parser.add_argument("--deadline_ms", type=float, default=3.0)
    parser.add_argument("--selftest_n", type=int, default=64)
    parser.add_argument("--serve_devices", type=int, default=1,
                        help="devices to serve on, one predictor and worker each")
    add_args(parser)
    add_train_args(parser)  # --epoch and the flags that name the checkpoint directory
    args = parser.parse_args(argv)
    cfg = from_args(args)

    device = resolve_device(args.device)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1  # the CPU is one
    if args.serve_devices > visible:
        raise ValueError(f"--serve_devices {args.serve_devices} > {visible} visible devices")
    if args.serve_devices > 1:
        raise NotImplementedError(
            "serving on several cards is not ported: the kernel wrappers launch on the "
            "current device of the calling thread")

    predictor, source = build_predictor(args, cfg)
    # One padded batch before the server opens: the first launch of each kernel
    # builds its library with nvcc, which takes seconds, and that must not
    # happen inside a client's wait.
    predictor(np.zeros((1, cfg.cir_len), np.float32))
    server = serve_predictor(predictor, cir_len=cfg.cir_len, batch_size=args.serve_batch,
                             deadline_ms=args.deadline_ms, with_probs=args.probs,
                             with_recon=args.recon)
    print(f"[serve] predictor ready (cir_len={cfg.cir_len}, batch={args.serve_batch}, "
          f"device={predictor.device}, workers={server.workers}, "
          f"plane={'native' if server.native else 'python'}, "
          f"payload=err,label+{server.n_extra}, {source})", flush=True)
    try:
        if args.socket or args.tcp_port >= 0:
            listen(server, args.socket, args.tcp_port)
        else:
            self_test(server, args.selftest_n, cfg, args.recon)
    finally:
        st = server.stats()
        print(f"[serve] stats: {st['submitted']} submitted, {st['batches']} batches (mean "
              f"occupancy {st['mean_occupancy']:.1f}/{args.serve_batch}, "
              f"{st['full_batches']} full), mean queue {st['mean_queue_ms']:.2f} ms, "
              f"{st['wait_timeouts']} client timeouts, {st['reclaimed']} reclaimed", flush=True)
        server.stop()


if __name__ == "__main__":
    main()
