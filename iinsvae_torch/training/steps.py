"""The semi-supervised train and eval steps (iinsvae_tpu/training/steps.py:25-188).

Batches are dicts of device tensors:

    {"cir": (B, L), "err": (B, 1), "label": (B, 1), "weight": (B,)}

``weight`` is the padding mask (training/loop.py pads every split to whole
batches). The step returns its metrics as device tensors: nothing in it
reads a value back to the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from iinsvae_torch.training.losses import semi_loss
from iinsvae_torch.training.state import TrainState


def _metrics(err_est, err, logits, label, weight) -> dict[str, torch.Tensor]:
    w = weight.reshape(-1)
    diff = (err_est - err).reshape(-1)
    pred = torch.argmax(logits, dim=-1)
    correct = torch.sum((pred == label.reshape(-1).to(pred.dtype)) * w)
    # count is the true weight sum (an all-padding batch reports 0); the
    # clamp happens only where it divides (finalize_metrics / reduce_metrics)
    return {"se": torch.sum(diff**2 * w), "ae": torch.sum(diff.abs() * w), "correct": correct,
            "count": torch.sum(w)}


# Metric reduction across batches:
#   * SUM_KEYS are per-batch sums: reduce by summation;
#   * every other key is a weighted mean whose denominator is the metric
#     named in MEAN_DENOMS (default 'count'): reduce as
#     sum(mean * denom) / sum(denom), exact under a padded tail or uneven
#     supervision masks (a mean of means is not);
#   * 'loss' mixes denominators (recon/KL over all samples, res/env over
#     the supervised ones) and is recomposed from its reduced parts.
SUM_KEYS = ("se", "ae", "correct", "count", "sup_count")
MEAN_DENOMS = {"loss_res": "sup_count", "loss_env": "sup_count"}
_LOSS_PARTS = ("loss_ae", "loss_kl", "loss_res", "loss_env")


def reduce_metrics(metrics: dict, sum_fn: Callable) -> dict:
    """Exactly reduce per-batch metric dicts (stacked) to global values;
    ``sum_fn(v)`` sums v over the stacking axis."""
    out = {k: sum_fn(v) for k, v in metrics.items() if k in SUM_KEYS}
    for k, v in metrics.items():
        if k in SUM_KEYS:
            continue
        d = MEAN_DENOMS.get(k, "count")
        if d in metrics:
            out[k] = sum_fn(v * metrics[d]) / out[d].clamp_min(1.0)
        else:
            out[k] = sum_fn(v) / sum_fn(torch.ones_like(v)).clamp_min(1.0)
    if "loss" in out and all(p in out for p in _LOSS_PARTS):
        out["loss"] = sum(out[p] for p in _LOSS_PARTS)
    return out


def finalize_metrics(acc: dict) -> dict:
    """Accumulated sums -> epoch metrics (exact, not a mean of batch means)."""
    n = acc["count"].clamp_min(1.0)
    out = {"rmse": torch.sqrt(acc["se"] / n), "abs": acc["ae"] / n,
           "accuracy": acc["correct"] / n}
    out.update({k: v for k, v in acc.items() if k not in SUM_KEYS})
    return out


def draw_sup_mask(batch_size: int, supervision_rate: float, mask_mode: str,
                  generator: torch.Generator) -> torch.Tensor:
    """The labeled mask, drawn on the generator's device (steps.py:140-144):
    per-sample Bernoulli(rate) ('sample'), or one draw for the whole batch
    ('batch')."""
    shape = (batch_size,) if mask_mode == "sample" else (1,)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u < supervision_rate).float().expand(batch_size)


def make_semi_grads_fn(supervision_rate: float = 1.0, lambda_res: float = 10.0,
                       mask_mode: str = "sample", kl_free_bits: float = 0.0) -> Callable:
    """grads_fn(model, batch, generator=None, sup_mask=None) -> metrics.

    The update-free half of the step: the forward, ``semi_loss`` and its
    backward, which leaves the gradients in the parameters' ``.grad``. The
    mask is drawn from ``generator`` unless ``sup_mask`` (B,) is given."""
    if mask_mode not in ("sample", "batch"):
        raise ValueError(f"mask_mode must be 'sample' or 'batch', got {mask_mode!r}")

    def grads_fn(model, batch: dict, generator: Optional[torch.Generator] = None,
                 sup_mask: Optional[torch.Tensor] = None) -> dict:
        cir, err, label = batch["cir"], batch["err"], batch["label"]
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(cir.shape[0], dtype=cir.dtype, device=cir.device)
        if sup_mask is None:
            if generator is None:
                raise ValueError("give a generator to draw the mask from, or a sup_mask")
            sup_mask = draw_sup_mask(cir.shape[0], supervision_rate, mask_mode, generator)
        for p in model.parameters():
            p.grad = None
        out = model(cir)
        total, aux = semi_loss(out, cir, err, label, sup_mask, weight, lambda_res=lambda_res,
                               kl_free_bits=kl_free_bits)
        total.backward()
        # a parameter the loss does not read has gradient 0: the 2-D residual
        # blocks' conv biases, which K7 does not take (its norms remove them)
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        metrics = _metrics(out["err_est"].detach(), err, out["logits"].detach(), label, weight)
        metrics.update({k: v.detach() for k, v in aux.items()})
        # denominator of the supervised terms, for their exact reduction
        metrics["sup_count"] = torch.sum(weight.reshape(-1) * sup_mask)
        return metrics

    return grads_fn


def make_semi_train_step(supervision_rate: float = 1.0, lambda_res: float = 10.0,
                         mask_mode: str = "sample", kl_free_bits: float = 0.0) -> Callable:
    """step(state, batch, generator=None, sup_mask=None) -> metrics: the
    gradients of ``make_semi_grads_fn``, then one Adam update of ``state``.

    mask_mode 'sample' draws a per-sample Bernoulli(supervision_rate) mask;
    'batch' one draw that masks the whole batch (the reference's per-batch
    semantics, train_semi.py:203, without its np.random.randn defect)."""
    grads_fn = make_semi_grads_fn(supervision_rate, lambda_res, mask_mode, kl_free_bits)

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             sup_mask: Optional[torch.Tensor] = None) -> dict:
        metrics = grads_fn(state.model, batch, generator, sup_mask)
        state.apply_gradients()
        return metrics

    return step


EVAL_OUTPUTS = ("err_est", "logits", "env_code", "recon")


def make_semi_eval_step() -> Callable:
    """step(model, batch) -> (metrics, outputs): the forward in eval mode with
    grad off, so every kernel runs its serving instance and no backward is
    recorded; ``_metrics`` of the batch (device tensors) and the outputs
    ``EVAL_OUTPUTS``."""

    def step(model, batch: dict) -> tuple[dict, dict]:
        cir, err, label = batch["cir"], batch["err"], batch["label"]
        weight = batch.get("weight")
        if weight is None:
            weight = torch.ones(cir.shape[0], dtype=cir.dtype, device=cir.device)
        was_training = model.training
        model.eval()
        with torch.no_grad():
            out = model(cir)
        model.train(was_training)
        metrics = _metrics(out["err_est"], err, out["logits"], label, weight)
        return metrics, {k: out[k] for k in EVAL_OUTPUTS}

    return step
