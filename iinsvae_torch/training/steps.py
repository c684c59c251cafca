"""The train and eval steps of the semi-supervised, the supervised joint
and the separated paths (iinsvae_tpu/training/steps.py).

Batches are dicts of device tensors:

    {"cir": (B, L), "err": (B, 1), "label": (B, 1), "weight": (B,)}

``weight`` is the padding mask (training/loop.py pads every split to whole
batches). The step returns its metrics as device tensors: nothing in it
reads a value back to the host. A train step runs the model in train mode
(the Conv heads' Dropout and BatchNormEps on the batch, as flax's
``train=True``); its Dropout masks come from the step's generator unless
``dropout_masks`` injects them (layers.dropout_source). An eval step and
the sep-EM inference run it in eval mode under ``no_grad``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from iinsvae_torch.models.layers import dropout_source
from iinsvae_torch.training.losses import cross_entropy, joint_loss, l1, semi_loss
from iinsvae_torch.training.state import TrainState

Masks = Optional[dict[str, torch.Tensor]]


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
    """Accumulated sums -> epoch metrics (exact, not a mean of batch means):
    rmse and abs where the sums hold se and ae, accuracy where they hold
    correct (sep-E's hold no se, sep-M's no correct)."""
    n = acc["count"].clamp_min(1.0)
    out = {}
    if "se" in acc:
        out["rmse"] = torch.sqrt(acc["se"] / n)
        out["abs"] = acc["ae"] / n
    if "correct" in acc:
        out["accuracy"] = acc["correct"] / n
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


def _weight(batch: dict) -> torch.Tensor:
    cir = batch["cir"]
    weight = batch.get("weight")
    if weight is None:
        weight = torch.ones(cir.shape[0], dtype=cir.dtype, device=cir.device)
    return weight


def _forward(model, generator: Optional[torch.Generator], dropout_masks: Masks, *args):
    """The model's forward in train mode, its parameters' gradients cleared,
    its Dropout drawing from ``generator`` or taking ``dropout_masks``."""
    model.train()
    for p in model.parameters():
        p.grad = None
    with dropout_source(model, generator, dropout_masks):
        return model(*args)


def _backward(model, loss: torch.Tensor) -> None:
    """The loss's backward; a parameter the loss does not read gets gradient 0
    (the 2-D residual blocks' conv biases, which K7 does not take, since its
    norms remove them)."""
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


def make_semi_grads_fn(supervision_rate: float = 1.0, lambda_res: float = 10.0,
                       mask_mode: str = "sample", kl_free_bits: float = 0.0) -> Callable:
    """grads_fn(model, batch, generator=None, sup_mask=None, dropout_masks=None,
    soft_eps=None) -> metrics.

    The update-free half of the step: the forward, ``semi_loss`` and its
    backward, which leaves the gradients in the parameters' ``.grad``. The
    mask is drawn from ``generator`` unless ``sup_mask`` (B,) is given; a soft
    restorer's standard-normal eps (B, 1) after it, unless ``soft_eps`` is
    given (JAX draws it from the step's key, steps.py:135-150, vae.py:79-84);
    the Conv heads' Dropout masks last."""
    if mask_mode not in ("sample", "batch"):
        raise ValueError(f"mask_mode must be 'sample' or 'batch', got {mask_mode!r}")

    def grads_fn(model, batch: dict, generator: Optional[torch.Generator] = None,
                 sup_mask: Optional[torch.Tensor] = None, dropout_masks: Masks = None,
                 soft_eps: Optional[torch.Tensor] = None) -> dict:
        cir, err, label = batch["cir"], batch["err"], batch["label"]
        weight = _weight(batch)
        soft = getattr(model, "soft", False)
        if (sup_mask is None or (soft and soft_eps is None)) and generator is None:
            raise ValueError("give a generator to draw the mask and a soft restorer's eps "
                             "from, or a sup_mask (and soft_eps)")
        if sup_mask is None:
            sup_mask = draw_sup_mask(cir.shape[0], supervision_rate, mask_mode, generator)
        # in the CIRs' dtype, as the weight (steps.py:139-144): under bfloat16 the supervised
        # terms' weight sums round to bfloat16, as JAX's do
        sup_mask = sup_mask.to(cir.dtype)
        if soft and soft_eps is None:
            # in the CIRs' dtype, as JAX draws it in mu's (heads.py:22)
            soft_eps = torch.randn((cir.shape[0], 1), generator=generator,
                                   device=generator.device).to(cir.dtype)
        out = _forward(model, generator, dropout_masks, cir, soft_eps)
        total, aux = semi_loss(out, cir, err, label, sup_mask, weight, lambda_res=lambda_res,
                               kl_free_bits=kl_free_bits)
        _backward(model, total)
        metrics = _metrics(out["err_est"].detach(), err, out["logits"].detach(), label, weight)
        metrics.update({k: v.detach() for k, v in aux.items()})
        # denominator of the supervised terms, for their exact reduction
        metrics["sup_count"] = torch.sum(weight.reshape(-1) * sup_mask)
        return metrics

    return grads_fn


def make_semi_train_step(supervision_rate: float = 1.0, lambda_res: float = 10.0,
                         mask_mode: str = "sample", kl_free_bits: float = 0.0) -> Callable:
    """step(state, batch, generator=None, sup_mask=None, dropout_masks=None, soft_eps=None)
    -> metrics: the gradients of ``make_semi_grads_fn``, then one Adam update of ``state``.

    mask_mode 'sample' draws a per-sample Bernoulli(supervision_rate) mask;
    'batch' one draw that masks the whole batch (the reference's per-batch
    semantics, train_semi.py:203, without its np.random.randn defect)."""
    grads_fn = make_semi_grads_fn(supervision_rate, lambda_res, mask_mode, kl_free_bits)

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             sup_mask: Optional[torch.Tensor] = None, dropout_masks: Masks = None,
             soft_eps: Optional[torch.Tensor] = None) -> dict:
        metrics = grads_fn(state.model, batch, generator, sup_mask, dropout_masks, soft_eps)
        state.apply_gradients()
        return metrics

    return step


def eval_forward(model, *args):
    """The forward in eval mode with grad off, so every kernel runs its
    serving instance and no backward is recorded; the mode restored after."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            return model(*args)
    finally:
        model.train(was_training)


EVAL_OUTPUTS = ("err_est", "logits", "env_code", "recon")


def make_semi_eval_step() -> Callable:
    """step(model, batch) -> (metrics, outputs): the forward in eval mode (a soft
    restorer's mu, steps.py:183), ``_metrics`` of the batch (device tensors) and the outputs
    ``EVAL_OUTPUTS``."""

    def step(model, batch: dict) -> tuple[dict, dict]:
        out = eval_forward(model, batch["cir"])
        metrics = _metrics(out["err_est"], batch["err"], out["logits"], batch["label"],
                           _weight(batch))
        return metrics, {k: out[k] for k in EVAL_OUTPUTS}

    return step


def make_joint_grads_fn() -> Callable:
    """grads_fn(model, batch, generator=None, dropout_masks=None) -> metrics:
    the update-free half of the joint step on EMNet / EMNetLoop
    (steps.py:222-254): the forward, ``joint_loss`` (CE + L1) and its
    backward. The metrics: the loss and its two parts and ``_metrics``."""

    def grads_fn(model, batch: dict, generator: Optional[torch.Generator] = None,
                 dropout_masks: Masks = None) -> dict:
        err, label, weight = batch["err"], batch["label"], _weight(batch)
        label_est, _, err_est = _forward(model, generator, dropout_masks, batch["cir"])
        total, aux = joint_loss(label_est, err_est, err, label, weight)
        _backward(model, total)
        metrics = _metrics(err_est.detach(), err, label_est.detach(), label, weight)
        metrics.update({k: v.detach() for k, v in aux.items()})
        return metrics

    return grads_fn


def make_joint_train_step() -> Callable:
    """step(state, batch, generator=None, dropout_masks=None) -> metrics: the
    gradients of ``make_joint_grads_fn``, then one Adam update (steps.py:208-219)."""
    grads_fn = make_joint_grads_fn()

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             dropout_masks: Masks = None) -> dict:
        metrics = grads_fn(state.model, batch, generator, dropout_masks)
        state.apply_gradients()
        return metrics

    return step


JOINT_OUTPUTS = ("err_est", "logits", "env_latent")


def make_joint_eval_step() -> Callable:
    """step(model, batch) -> (metrics, outputs) on EMNet / EMNetLoop in eval
    mode (steps.py:257-272): ``_metrics`` and the outputs ``JOINT_OUTPUTS``."""

    def step(model, batch: dict) -> tuple[dict, dict]:
        label_est, env_latent, err_est = eval_forward(model, batch["cir"])
        metrics = _metrics(err_est, batch["err"], label_est, batch["label"], _weight(batch))
        return metrics, dict(zip(JOINT_OUTPUTS, (err_est, label_est, env_latent)))

    return step


def make_sep_e_train_step() -> Callable:
    """step(state, batch, generator=None, dropout_masks=None) -> {loss,
    correct, count}: one CE step of IdentifierSep (steps.py:275-311)."""

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             dropout_masks: Masks = None) -> dict:
        label, weight = batch["label"], _weight(batch)
        label_est, _ = _forward(state.model, generator, dropout_masks, batch["cir"])
        loss = cross_entropy(label_est, label, weight)
        _backward(state.model, loss)
        state.apply_gradients()
        pred = torch.argmax(label_est.detach(), dim=-1)
        w = weight.reshape(-1)
        return {"loss": loss.detach(),
                "correct": torch.sum((pred == label.reshape(-1).to(pred.dtype)) * w),
                "count": torch.sum(w)}

    return step


def make_sep_m_train_step() -> Callable:
    """step(state, batch, generator=None, dropout_masks=None) -> {loss, se,
    ae, count}: one L1 step of RegressorSep on the true labels
    (steps.py:314-354)."""

    def step(state: TrainState, batch: dict, generator: Optional[torch.Generator] = None,
             dropout_masks: Masks = None) -> dict:
        err, weight = batch["err"], _weight(batch)
        err_est = _forward(state.model, generator, dropout_masks, batch["cir"], batch["label"])
        loss = l1(err_est, err, weight)
        _backward(state.model, loss)
        state.apply_gradients()
        w = weight.reshape(-1)
        diff = (err_est.detach() - err).reshape(-1)
        return {"loss": loss.detach(), "se": torch.sum(diff**2 * w),
                "ae": torch.sum(diff.abs() * w), "count": torch.sum(w)}

    return step


def sep_em_marginalized_inference(enet, mnet, cir: torch.Tensor, num_classes: int):
    """The soft two-stage inference p(dd | r) = sum_k p(k | r) p(dd | r, k)
    (steps.py:357-379), both models in eval mode: the softmax of the
    identifier's logits weighs the regressor's estimate under each label
    (the range code is recomputed for each, as in the JAX package).
    -> (label_est, env_latent, err_est)."""
    label_est, env_latent = eval_forward(enet, cir)
    probs = torch.softmax(label_est, dim=-1)
    ests = [eval_forward(mnet, cir, torch.full((cir.shape[0], 1), float(k), dtype=cir.dtype,
                                                device=cir.device))
            for k in range(num_classes)]
    err_est = sum(probs[:, k:k + 1] * ests[k] for k in range(num_classes))
    return label_est, env_latent, err_est
