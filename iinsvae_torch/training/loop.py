"""Epoch loop and evaluator (iinsvae_tpu/training/loop.py:22-133).

The whole train split lives on the device; each epoch draws its
permutation and every step's supervision mask there from its own seeded
``torch.Generator``, and the per-batch metrics stay on the device until the
epoch ends: one host fetch an epoch. An epoch's draws depend only on the
seed and the epoch, so a run resumed from a checkpoint repeats what the
continuous run would have done.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from iinsvae_torch.training.steps import SUM_KEYS, finalize_metrics, reduce_metrics


def pad_to_batches(data: dict, batch_size: int) -> dict[str, torch.Tensor]:
    """Pad every array (numpy or tensor) with zero rows to a multiple of
    ``batch_size`` and add a 'weight' mask, 1 on real rows and 0 on padding,
    so padded samples add nothing to losses or metrics."""
    out = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
           for k, v in data.items()}
    n = out["cir"].shape[0]
    pad = -(-n // batch_size) * batch_size - n
    out = {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))]) for k, v in out.items()}
    weight = torch.zeros(n + pad, dtype=out["cir"].dtype, device=out["cir"].device)
    weight[:n] = 1.0
    out["weight"] = weight
    return out


def make_epoch_runner(train_step: Callable, batch_size: int, shuffle: bool = True) -> Callable:
    """-> run_epoch(state, data, generator) -> exactly reduced epoch sums
    (device tensors). ``data`` holds whole batches (pad_to_batches) on the
    device; the permutation and the masks come from ``generator``."""

    def run_epoch(state, data: dict, generator: torch.Generator) -> dict:
        n = data["cir"].shape[0]
        if n % batch_size:
            raise ValueError(f"{n} rows are not whole batches of {batch_size}: pad_to_batches")
        if shuffle:
            perm = torch.randperm(n, generator=generator, device=generator.device)
            data = {k: v[perm] for k, v in data.items()}
        ms = [train_step(state, {k: v[i:i + batch_size] for k, v in data.items()}, generator)
              for i in range(0, n, batch_size)]
        return reduce_metrics({k: torch.stack([m[k] for m in ms]) for k in ms[0]},
                              lambda v: v.sum(dim=0))

    return run_epoch


def _to_host(metrics: dict) -> dict[str, float]:
    values = torch.stack([v.float() for v in metrics.values()]).cpu().tolist()  # one fetch
    return dict(zip(metrics, values))


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A device tensor as numpy; bfloat16 (which numpy lacks) as float32, exactly."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def make_evaluator(eval_step: Callable, batch_size: int) -> Callable:
    """-> evaluate(model, data) -> (metrics, outputs). ``data`` holds whole
    batches (pad_to_batches). The metrics are ``finalize_metrics`` of the
    split's summed ``SUM_KEYS`` (host floats, one fetch); each output comes
    back stacked over the whole padded split, (n_batches, batch_size, ...),
    as numpy, one fetch an output."""

    def evaluate(model, data: dict) -> tuple[dict, dict]:
        n = data["cir"].shape[0]
        if n % batch_size:
            raise ValueError(f"{n} rows are not whole batches of {batch_size}: pad_to_batches")
        ms, outs = zip(*(eval_step(model, {k: v[i:i + batch_size] for k, v in data.items()})
                         for i in range(0, n, batch_size)))
        acc = {k: torch.stack([m[k] for m in ms]).sum() for k in ms[0] if k in SUM_KEYS}
        outputs = {k: _host_array(torch.stack([o[k] for o in outs])) for k in outs[0]}
        return _to_host(finalize_metrics(acc)), outputs

    return evaluate


def train_epochs(state, run_epoch: Callable, data: dict, n_epochs: int, seed: int = 0,
                 start_epoch: int = 0, stream: int = 0,
                 log_fn: Optional[Callable[[int, dict], None]] = None,
                 eval_fn: Optional[Callable] = None, eval_interval: int = 0,
                 checkpoint_fn: Optional[Callable] = None,
                 checkpoint_interval: int = 0) -> list[dict]:
    """Run epochs ``start_epoch .. n_epochs - 1``; returns each epoch's
    finalized metrics (host floats), which ``log_fn(epoch, metrics)`` also
    receives. Epoch e draws from the generator seeded ``seed * 1_000_003 +
    stream + e``: a second model trained on the same data (sep-M after sep-E)
    takes another ``stream``, as the JAX CLI folds ``10_000 + epoch`` into its
    key (cli/run_sep.py:76). After an epoch whose index is a multiple of
    ``checkpoint_interval`` ``checkpoint_fn(epoch, state)`` runs, then, at a
    multiple of ``eval_interval``, ``eval_fn(epoch, state)``: the order of the
    reference's train_semi CLI, which saves and collects before it evaluates.
    An interval of 0 turns its hook off."""
    history = []
    for epoch in range(start_epoch, n_epochs):
        # each (seed, epoch) draws its permutation and masks from its own stream
        gen = torch.Generator(device=data["cir"].device).manual_seed(
            seed * 1_000_003 + stream + epoch)
        metrics = _to_host(finalize_metrics(run_epoch(state, data, gen)))
        history.append(metrics)
        if log_fn is not None:
            log_fn(epoch, metrics)
        if checkpoint_fn is not None and checkpoint_interval and epoch % checkpoint_interval == 0:
            checkpoint_fn(epoch, state)
        if eval_fn is not None and eval_interval and epoch % eval_interval == 0:
            eval_fn(epoch, state)
    return history
