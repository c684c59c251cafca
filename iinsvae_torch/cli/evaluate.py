"""`evaluate` entry of the port: a saved checkpoint on the held-out split
(iinsvae_tpu/cli/evaluate.py, ``--net semi``).

Restores the checkpoint of ``--test_epoch`` (or, where that epoch was not
saved, the latest) from the directory the training flags name, evaluates
the test part of the data's split (cli/common.resolve_data, as training resolved it), logs the metrics to
``val_log.log`` and writes the residual exports. Exits when the directory
holds no checkpoint. ``--compute_dtype bfloat16`` evaluates in bfloat16, as
the training run did (iinsvae_tpu/cli/evaluate.py:68). The SVM baseline and
the plots are not ported.

    python -m iinsvae_torch.cli.evaluate --dataset_env room_full --synthetic_n 10000 \\
        --test_epoch 400
"""

from __future__ import annotations

import argparse
import os

from iinsvae_torch.cli.common import batch_dict, fmt_metrics, resolve_data, setup_logging
from iinsvae_torch.config import add_args, add_train_args, from_args, reject_bf16
from iinsvae_torch.cli.run import build_model
from iinsvae_torch.evaluation.evaluate import evaluate_joint, evaluate_semi
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.conv import fp32_reduction
from iinsvae_torch.serving import resolve_device
from iinsvae_torch.training.checkpoint import (joint_model_dir, joint_result_dir, latest_epoch,
                                               read_checkpoint, semi_model_dir, semi_result_dir)


@fp32_reduction()
def main(argv=None) -> dict:
    """-> the metrics (host floats)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--net", type=str, default="semi", choices=["semi", "joint"])
    parser.add_argument("--disentangle", action="store_true",
                        help="also run the disentanglement evaluation (not ported)")
    add_args(parser)
    add_train_args(parser)
    args = parser.parse_args(argv)
    cfg = from_args(args)
    if args.disentangle:
        raise NotImplementedError("--disentangle: the disentanglement evaluation is not "
                                  "ported; ROADMAP.md Queue 1 item 11")
    reject_bf16(cfg, "train_semi" if args.net == "semi" else "evaluate --net joint")
    device = resolve_device(args.device)
    if args.net == "semi":
        model_path, result_path = semi_model_dir(cfg), semi_result_dir(cfg)
        model, eval_fn = IInsVAE(**cfg.model_kwargs()), evaluate_semi
    else:
        model_path, result_path = joint_model_dir(cfg), joint_result_dir(cfg, test=True)
        model, eval_fn = build_model(cfg), evaluate_joint
    latest = latest_epoch(model_path)
    if latest is None:
        raise SystemExit(f"No saved models in {model_path}.")
    epoch = cfg.test_epoch or latest
    if not os.path.isdir(os.path.join(model_path, f"epoch_{epoch}")):
        epoch = latest
    logger = setup_logging(result_path, "val_log.log")
    _, test = resolve_data(cfg)
    model.load_state_dict(read_checkpoint(model_path, epoch)["model"])
    m = eval_fn(model.to(device), batch_dict(test, cfg), min(500, test[0].shape[0]),
                result_path=result_path, epoch=epoch, dataset_env=cfg.dataset_env,
                dataset_name=cfg.dataset_name, export=True)
    logger.info(f"[test epoch {epoch}] {fmt_metrics(m)}")
    return m


if __name__ == "__main__":
    main()
