"""`run_sep` entry of the port: the separated two-stage path
(iinsvae_tpu/cli/run_sep.py, one process).

Trains the identifier (IdentifierSep, sep-E: cross-entropy), then the
label-conditional regressor (RegressorSep, sep-M: L1 on the true labels),
each ``--n_epochs`` epochs on the train split (cli/common.resolve_data), each from
its own seeded stream; then, on the test split, the sep-E accuracy, the
soft marginalised sep-EM estimate p(dd | r) = sum_k p(k | r) p(dd | r, k)
and its RMSE, the hard-assignment RMSE (the regressor under the argmax
label) and the plurality share of the test labels.

Checkpoints ``ENet_epoch_N`` / ``MNet_epoch_N`` go under ``<--model_dir>_sep``
(every ``--checkpoint_interval`` epochs, -1: none, and at the end);
``--epoch N`` (``-1``: the latest) resumes both models. The log
``training_log_sep.log`` goes under ``<--out_dir>_sep``. The SVM baseline
and the CDF plot are not ported.

    python -m iinsvae_torch.cli.run_sep --dataset_env room_full --n_epochs 400 \\
        --synthetic_n 10000 --batch_size 500
"""

from __future__ import annotations

import time

import numpy as np
import torch

from iinsvae_torch.cli.common import (EpochLogger, device_data, fmt_metrics, parse,
                                      setup_logging, start_epoch, train_state)
from iinsvae_torch.config import reject_bf16, reject_parallel
from iinsvae_torch.evaluation.evaluate import add_plurality_share
from iinsvae_torch.models.emnet import IdentifierSep, RegressorSep
from iinsvae_torch.serving import resolve_device
from iinsvae_torch.training.checkpoint import (gc_checkpoints, restore_checkpoint,
                                               save_checkpoint, sep_model_dir)
from iinsvae_torch.training.loop import make_epoch_runner, pad_to_batches, train_epochs
from iinsvae_torch.training.steps import (eval_forward, make_sep_e_train_step,
                                          make_sep_m_train_step, sep_em_marginalized_inference)

# sep-M's epochs draw from this stream of the seed, sep-E's from 0 (training/loop.py)
SEP_M_STREAM = 10_000


def infer(enet, mnet, test: dict, batch_size: int, num_classes: int) -> dict[str, np.ndarray]:
    """The sep-EM inference over the test split in padded batches: -> the
    real rows' label_est (logits), err_est (soft) and err_hard (the regressor
    under the argmax label), as numpy."""
    padded = pad_to_batches(test, batch_size)
    outs = {"label_est": [], "err_est": [], "err_hard": []}
    for i in range(0, padded["cir"].shape[0], batch_size):
        cir = padded["cir"][i:i + batch_size]
        label_est, _, err_est = sep_em_marginalized_inference(enet, mnet, cir, num_classes)
        hard = label_est.argmax(dim=1, keepdim=True).to(cir.dtype)
        for k, v in zip(outs, (label_est, err_est, eval_forward(mnet, cir, hard))):
            outs[k].append(v)
    n = test["cir"].shape[0]
    return {k: torch.cat(v)[:n].cpu().numpy() for k, v in outs.items()}


def main(argv=None) -> dict:
    """-> the test metrics (host floats): accuracy, rmse, rmse_hard, abs,
    plurality_share."""
    args, cfg = parse(__doc__, argv)
    reject_parallel(cfg)
    reject_bf16(cfg, "run_sep")
    t0 = time.perf_counter()
    data, test = device_data(cfg, resolve_device(args.device))
    device = data["cir"].device
    model_path = sep_model_dir(cfg)
    result_path = model_path.replace(cfg.model_dir, cfg.out_dir, 1)
    logger = setup_logging(result_path, "training_log_sep.log")
    logger.info(str(cfg.to_dict()))
    gen = torch.Generator().manual_seed(cfg.seed)
    enet = IdentifierSep(cfg.cir_len, cfg.num_classes, cfg.env_dim, cfg.filters,
                         cfg.identifier_type, cfg.env_conv_init, generator=gen).to(device)
    mnet = RegressorSep(cfg.cir_len, cfg.num_classes, cfg.regressor_type,
                        generator=gen).to(device)
    steps_per_epoch = data["cir"].shape[0] // cfg.batch_size
    states = {"ENet": train_state(enet, cfg, steps_per_epoch),
              "MNet": train_state(mnet, cfg, steps_per_epoch)}
    cfg.epoch = start_epoch(cfg, model_path, "ENet")
    if cfg.epoch != 0:
        for tag, state in states.items():
            restore_checkpoint(model_path, cfg.epoch, state, tag)
        logger.info(f"resumed from epoch {cfg.epoch}")

    stages = (("ENet", make_sep_e_train_step(), 0, f"[Sep-E Identifier{cfg.identifier_type}]"),
              ("MNet", make_sep_m_train_step(), SEP_M_STREAM,
               f"[Sep-M Regressor{cfg.regressor_type}]"))
    for tag, step, stream, header in stages:
        state = states[tag]

        def checkpoint(epoch: int, state, tag=tag) -> None:
            save_checkpoint(model_path, epoch, state, tag)
            gc_checkpoints(model_path, cfg.keep_last, tag)

        train_epochs(state, make_epoch_runner(step, cfg.batch_size), data, cfg.n_epochs,
                     seed=cfg.seed, start_epoch=cfg.epoch, stream=stream,
                     log_fn=EpochLogger(logger, cfg.n_epochs, header),
                     checkpoint_fn=checkpoint,
                     checkpoint_interval=max(cfg.checkpoint_interval, 0))
        checkpoint(cfg.n_epochs, state)

    out = infer(enet, mnet, test, min(500, test["cir"].shape[0]), cfg.num_classes)
    err_gt = test["err"].cpu().numpy()
    label_gt = test["label"].cpu().numpy().reshape(-1)
    m = {"accuracy": float(np.mean(np.argmax(out["label_est"], axis=1) == label_gt)),
         "rmse": float(np.sqrt(np.mean((out["err_est"] - err_gt) ** 2))),
         "rmse_hard": float(np.sqrt(np.mean((out["err_hard"] - err_gt) ** 2))),
         "abs": float(np.mean(np.abs(out["err_est"] - err_gt)))}
    add_plurality_share(m, label_gt)
    logger.info(f"[Sep-EM test] {fmt_metrics(m)} [wall: {time.perf_counter() - t0:.3f}s]")
    return m


if __name__ == "__main__":
    main()
