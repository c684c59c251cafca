"""`serve` entry of the port, self-test mode (iinsvae_tpu/cli/serve.py:95-106).

Builds a ``Predictor`` from an export_serving ``weights.npz`` (``--npz``),
from the port's checkpoint of epoch ``--epoch N`` (``-1``: the latest) in
the directory the training flags name (``--model_dir``, ``--dataset_env``,
``--supervision_rate``, ...; training/checkpoint.py), or, without either,
from the seeded initialisation, sends ``--selftest_n``
random CIRs through it in padded batches of ``--serve_batch``, and prints a
summary; with ``--recon`` the predictor also returns the reconstructed CIR
and the summary gives its shape and range. ``--conv_type 2`` serves the
expanded 2-D model. The native batcher and the socket/TCP fronts are a
later slice.

    python -m iinsvae_torch.cli.serve --dataset_env room_full --serve_batch 256 --recon
    python -m iinsvae_torch.cli.serve --dataset_env room_full --conv_type 2 --recon
    python -m iinsvae_torch.cli.serve --dataset_env room_full --synthetic_n 10000 --epoch 400
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from iinsvae_torch.config import add_args, add_train_args, from_args
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training.checkpoint import latest_epoch, semi_model_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--npz", default="", help="export_serving weights.npz; empty = seeded init")
    parser.add_argument("--serve_batch", type=int, default=256)
    parser.add_argument("--selftest_n", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--recon", action="store_true",
                        help="also return the reconstructed CIR (runs the decoder)")
    add_args(parser)
    add_train_args(parser)  # --epoch and the flags that name the checkpoint directory
    args = parser.parse_args(argv)
    cfg = from_args(args)

    if args.npz:
        predictor = Predictor.from_npz(args.npz, cir_len=cfg.cir_len,
                                       batch_size=args.serve_batch, return_recon=args.recon,
                                       device=args.device)
        source = args.npz
    elif cfg.epoch:
        epoch = latest_epoch(semi_model_dir(cfg)) if cfg.epoch == -1 else cfg.epoch
        predictor = Predictor.from_checkpoint(cfg, epoch, batch_size=args.serve_batch,
                                              return_recon=args.recon, device=args.device)
        source = f"checkpoint epoch {epoch}"
    else:
        model = IInsVAE(**cfg.model_kwargs(),
                        generator=torch.Generator().manual_seed(cfg.seed))
        predictor = Predictor(model, batch_size=args.serve_batch, return_recon=args.recon,
                              device=args.device)
        source = "seeded init"
    print(f"[serve] predictor ready (cir_len={cfg.cir_len}, batch={args.serve_batch}, "
          f"device={predictor.device}, {source})", flush=True)

    cirs = np.random.default_rng(cfg.seed).normal(size=(args.selftest_n, cfg.cir_len))
    t0 = time.perf_counter()
    pred = predictor(cirs)
    if predictor.device.type == "cuda":
        torch.cuda.synchronize(predictor.device)
    dt = time.perf_counter() - t0
    if not (np.isfinite(pred.err_est).all() and np.isfinite(pred.label_probs).all()):
        raise RuntimeError("self-test produced non-finite outputs")
    n_batches = -(-args.selftest_n // args.serve_batch)
    print(f"[serve] self-test ok: {args.selftest_n} requests in {n_batches} batches, "
          f"{dt:.3f}s, err range ({pred.err_est.min():.4f}, {pred.err_est.max():.4f}), "
          f"labels {np.bincount(pred.label, minlength=cfg.num_classes).tolist()}", flush=True)
    if args.recon:
        if pred.recon.shape != (args.selftest_n, cfg.cir_len) or not np.isfinite(pred.recon).all():
            raise RuntimeError(f"self-test recon: shape {pred.recon.shape} or non-finite values")
        print(f"[serve] recon {pred.recon.shape}, range ({pred.recon.min():.4f}, "
              f"{pred.recon.max():.4f})", flush=True)


if __name__ == "__main__":
    main()
