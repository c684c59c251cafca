"""Checkpoints: the model's parameters, the optimizer's state and the step
(iinsvae_tpu/training/checkpoint.py, with torch.save in place of orbax).

A checkpoint is ``<model_dir>/epoch_N/state.pt``, ``torch.save`` of
``{"step", "model", "optimizer"}`` state dicts (the model's holds the
BatchNormEps running stats beside the parameters). The separated path keeps
two models in one directory, ``ENet_epoch_N`` and ``MNet_epoch_N``: every
function takes the ``tag`` that prefixes the name. The directory names
mirror the reference's hyperparameter-encoding scheme (train_semi.py:87-88,
run.py:77, run_sep.py:62), so runs stay identifiable. Retention keeps the newest N epochs and the one
that ``best.json`` points at, which is swapped in with ``os.replace``, so a
crash never leaves a torn pointer.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch

_STATE_FILE = "state.pt"
_BEST_FILE = "best.json"


def semi_model_dir(cfg) -> str:
    return os.path.join(
        cfg.model_dir,
        "%s_mode_%s" % (cfg.dataset_env, cfg.mode),
        "SEMI%f_AE%d_Res%s_Cls%s_Rdim%dEdim%d"
        % (cfg.supervision_rate, cfg.conv_type, cfg.restorer_type, cfg.classifier_type,
           cfg.range_dim, cfg.env_dim),
    )


def semi_result_dir(cfg) -> str:
    return semi_model_dir(cfg).replace(cfg.model_dir, cfg.out_dir, 1)


def joint_model_dir(cfg) -> str:
    return os.path.join(
        cfg.model_dir + "_" + cfg.net_ablation,
        "data_%s_%s_mode_%s" % (cfg.dataset_name, cfg.dataset_env, cfg.mode),
        "enet%s_mnet%s" % (cfg.identifier_type, cfg.regressor_type),
    )


def joint_result_dir(cfg, test: bool = False) -> str:
    return os.path.join(
        cfg.out_dir + "_" + cfg.net_ablation, *(("test",) if test else ()),
        "data_%s_%s_mode_%s" % (cfg.dataset_name, cfg.dataset_env, cfg.mode),
        "enet%s_mnet%s" % (cfg.identifier_type, cfg.regressor_type),
    )


def sep_model_dir(cfg) -> str:
    return os.path.join(
        cfg.model_dir + "_sep",
        "data_%s_%s_mode_%s" % (cfg.dataset_name, cfg.dataset_env, cfg.mode),
        "enet%s_mnet%s" % (cfg.identifier_type, cfg.regressor_type),
    )


def _prefix(tag: str) -> str:
    return f"{tag}_epoch_" if tag else "epoch_"


def _ckpt_path(model_dir: str, epoch: int, tag: str = "") -> str:
    return os.path.abspath(os.path.join(model_dir, f"{_prefix(tag)}{epoch}"))


def save_checkpoint(model_dir: str, epoch: int, state, tag: str = "") -> str:
    """Write ``state`` (training.state.TrainState) as epoch ``epoch``; the
    file is written beside its name and moved there, so a reader never sees a
    torn one. -> the checkpoint's directory."""
    path = _ckpt_path(model_dir, epoch, tag)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(state.step), "model": state.model.state_dict(),
               "optimizer": state.optimizer.state_dict()}
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    return path


def read_checkpoint(model_dir: str, epoch: int, tag: str = "") -> dict:
    """The saved payload {step, model, optimizer}, its tensors on the CPU."""
    return torch.load(os.path.join(_ckpt_path(model_dir, epoch, tag), _STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(model_dir: str, epoch: int, state, tag: str = ""):
    """Load epoch ``epoch`` into ``state`` (a freshly created one of the same
    model and optimizer), in place, and return it. The tensors are read to
    the CPU and ``load_state_dict`` copies each where the state's own
    parameters are, so a checkpoint written on the card restores on the CPU
    and the other way round; Adam's step counts stay on the host, as a fresh
    Adam keeps them. The LR schedule reads the restored step."""
    payload = read_checkpoint(model_dir, epoch, tag)
    state.model.load_state_dict(payload["model"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])
    return state


def list_epochs(model_dir: str, tag: str = "") -> list:
    if not os.path.isdir(model_dir):
        return []
    p = _prefix(tag)
    return sorted(int(d[len(p):]) for d in os.listdir(model_dir)
                  if d.startswith(p) and d[len(p):].isdigit())


def latest_epoch(model_dir: str, tag: str = "") -> Optional[int]:
    epochs = list_epochs(model_dir, tag)
    return epochs[-1] if epochs else None


def best_epoch(model_dir: str) -> Optional[dict]:
    """{'epoch': int, 'metric': float} for the current best, or None."""
    path = os.path.join(model_dir, _BEST_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def update_best(model_dir: str, epoch: int, metric: float) -> bool:
    """Atomically point ``best`` at ``epoch`` when ``metric`` improves
    (lower is better, e.g. the validation RMSE). Returns True on a new best."""
    cur = best_epoch(model_dir)
    if cur is not None and cur["metric"] <= metric:
        return False
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, _BEST_FILE)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"epoch": int(epoch), "metric": float(metric)}, f)
    os.replace(tmp, path)
    return True


def restore_best(model_dir: str, state):
    """Restore the best-pointed checkpoint; raises FileNotFoundError when
    no best has been recorded."""
    best = best_epoch(model_dir)
    if best is None:
        raise FileNotFoundError(f"no {_BEST_FILE} under {model_dir}")
    return restore_checkpoint(model_dir, best["epoch"], state)


def gc_checkpoints(model_dir: str, keep_last: int, tag: str = "") -> list:
    """Delete all but the newest ``keep_last`` epoch checkpoints of ``tag``
    (and never the best-pointed epoch). keep_last <= 0 keeps everything (the
    reference's behavior). Returns the removed epochs."""
    if keep_last <= 0:
        return []
    epochs = list_epochs(model_dir, tag)
    protect = set(epochs[-keep_last:])
    best = best_epoch(model_dir)
    if best is not None:
        protect.add(best["epoch"])
    removed = []
    for e in epochs:
        if e not in protect:
            shutil.rmtree(_ckpt_path(model_dir, e, tag), ignore_errors=True)
            removed.append(e)
    return removed
