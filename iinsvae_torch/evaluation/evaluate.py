"""Evaluation of the semi model and of the joint EMNet / EMNetLoop: their
metrics and residual exports (iinsvae_tpu/evaluation/evaluate.py:26-185,
without the plots, the latent scatter and the SVM).

  * range RMSE / mean absolute error / env accuracy over the held-out split,
    with the plurality share of its labels beside the accuracy;
  * residual exports: .mat (scipy.io) and .npz.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from iinsvae_torch.training.loop import make_evaluator, pad_to_batches
from iinsvae_torch.training.steps import make_joint_eval_step, make_semi_eval_step


def _unpad(arr_batched: np.ndarray, weight_batched: np.ndarray) -> np.ndarray:
    """(nb, B, ...) stacked outputs -> (N, ...) real samples only."""
    arr = np.asarray(arr_batched)
    flat = arr.reshape((-1,) + arr.shape[2:])
    w = np.asarray(weight_batched).reshape(-1) > 0
    return flat[w]


def add_plurality_share(metrics: dict, label_gt: np.ndarray) -> dict:
    """Report the majority-class share of the test labels next to accuracy,
    and flag a degenerate env head: an accuracy at most 0.005 above that
    share means the classifier predicts (at most) the majority class."""
    labels = np.asarray(label_gt).astype(int).ravel()
    counts = np.bincount(labels, minlength=1)
    share = float(counts.max() / max(1, counts.sum()))
    metrics["plurality_share"] = share
    acc = metrics.get("accuracy")
    if acc is not None and acc <= share + 0.005:
        metrics["env_head_degenerate"] = 1.0
        logging.getLogger(__name__).warning(
            "env accuracy %.4f <= plurality-class share %.4f: the env head "
            "is predicting (at most) the majority class — degenerate result",
            acc, share,
        )
    return metrics


def export_residuals(result_path: str, tag: str, res_em, original) -> None:
    """The residuals and the original errors as .mat files (the reference's
    key ``residual_em`` in each) and one .npz. The SVM baseline's residuals
    are not ported."""
    import scipy.io as sio

    os.makedirs(result_path, exist_ok=True)
    sio.savemat(os.path.join(result_path, f"residual_em_{tag}.mat"), {"residual_em": res_em})
    sio.savemat(os.path.join(result_path, f"original_{tag}.mat"), {"residual_em": original})
    np.savez(os.path.join(result_path, f"residuals_{tag}.npz"), residual_em=res_em,
             original=original)


def _evaluate(eval_step, model, data_test: dict, batch_size: int, result_path: str | None,
              epoch: int, dataset_env: str, dataset_name: str, export: bool, outputs: bool):
    device = next(model.parameters()).device
    padded = {k: v.to(device) for k, v in pad_to_batches(data_test, batch_size).items()}
    metrics, outs = make_evaluator(eval_step, batch_size)(model, padded)

    w = padded["weight"].float().reshape(-1, batch_size).cpu().numpy()
    err_gt = _unpad(padded["err"].reshape(-1, batch_size, 1).cpu().numpy(), w)
    outs = {k: _unpad(v, w) for k, v in outs.items()}
    label_gt = _unpad(padded["label"].reshape(-1, batch_size, 1).cpu().numpy(), w)
    res_em = np.abs(err_gt - outs["err_est"])
    add_plurality_share(metrics, label_gt)
    if result_path is not None and export:
        export_residuals(result_path, "%s_%s_%d" % (dataset_name, dataset_env, epoch),
                         res_em, err_gt)
    return (metrics, outs) if outputs else metrics


def evaluate_semi(model, data_test: dict, batch_size: int = 500, result_path: str | None = None,
                  epoch: int = 0, dataset_env: str = "room_full", dataset_name: str = "zenodo",
                  export: bool = False, outputs: bool = False):
    """Evaluate ``model`` on ``data_test`` ({cir, err, label}, numpy or
    tensors, moved to the model's device) in padded batches: rmse, abs, accuracy and the
    plurality share (host floats); with ``export`` and a ``result_path`` the
    residuals |err - err_est| and the errors go to
    ``residual_em_<tag>.mat``, ``original_<tag>.mat`` and
    ``residuals_<tag>.npz``, tag ``<dataset_name>_<dataset_env>_<epoch>``.
    -> the metrics; with ``outputs``, (metrics, the eval step's outputs on
    the real rows: err_est, logits, env_code and recon as numpy arrays)."""
    return _evaluate(make_semi_eval_step(), model, data_test, batch_size, result_path, epoch,
                     dataset_env, dataset_name, export, outputs)


def evaluate_joint(model, data_test: dict, batch_size: int = 500, result_path: str | None = None,
                   epoch: int = 0, dataset_env: str = "nlos", dataset_name: str = "zenodo",
                   export: bool = False, outputs: bool = False):
    """``evaluate_semi`` for EMNet / EMNetLoop (evaluate.py:146-185): the same
    metrics and residual exports; with ``outputs`` the real rows' err_est,
    logits and env_latent."""
    return _evaluate(make_joint_eval_step(), model, data_test, batch_size, result_path, epoch,
                     dataset_env, dataset_name, export, outputs)
