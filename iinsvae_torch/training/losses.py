"""Loss terms of the semi-supervised and the supervised joint objectives
(iinsvae_tpu/training/losses.py:29-127).

* recon: L1(cir, recon); kl: mean KL of the env posterior, each latent
  dimension optionally floored at ``kl_free_bits``; res: L1(err, err_est);
  env: cross-entropy on 0-based labels.
* Every term takes a per-sample weight (the padding mask); the supervised
  terms take weight * sup_mask, so unlabeled samples add recon + KL only.
* The KL is computed here from ``env_code`` = (mu, log_sigma): the model's
  forward computes none.
"""

from __future__ import annotations

from typing import Optional

import torch

LAMBDA_AE = 1.0
LAMBDA_RES = 10.0
LAMBDA_KL = 1.0
LAMBDA_ENV = 1.0


def _wmean(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    """Weighted mean over the batch axis; x reduced over its other axes first."""
    per_sample = x.float().reshape(x.shape[0], -1).mean(dim=1)
    if w is None:
        return per_sample.mean()
    w = w.reshape(-1)
    return torch.sum(per_sample * w) / torch.sum(w).clamp_min(1.0)


def l1(a: torch.Tensor, b: torch.Tensor, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _wmean(torch.abs(a - b), w)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  w: Optional[torch.Tensor] = None) -> torch.Tensor:
    labels = labels.reshape(-1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    if w is None:
        return nll.mean()
    w = w.reshape(-1)
    return torch.sum(nll * w) / torch.sum(w).clamp_min(1.0)


def env_kl_per_sample(env_code: torch.Tensor, free_bits: float = 0.0) -> torch.Tensor:
    """Per-sample KL(q || N(0, I)) from the concatenated (mu, log_sigma)
    code; ``free_bits`` > 0 floors each dimension's KL at that value."""
    half = env_code.shape[-1] // 2
    mu, ls = env_code[..., :half], env_code[..., half:]
    kl_d = 0.5 * (torch.exp(2.0 * ls) + mu**2 - 1.0 - 2.0 * ls)
    if free_bits > 0.0:
        kl_d = torch.clamp_min(kl_d, free_bits)
    return torch.sum(kl_d, dim=-1)


def semi_loss(outputs: dict, cir: torch.Tensor, err: torch.Tensor, label: torch.Tensor,
              sup_mask: torch.Tensor, sample_weight: Optional[torch.Tensor] = None,
              lambda_ae: float = LAMBDA_AE, lambda_kl: float = LAMBDA_KL,
              lambda_res: float = LAMBDA_RES, lambda_env: float = LAMBDA_ENV,
              kl_free_bits: float = 0.0) -> tuple[torch.Tensor, dict]:
    """sup_mask (B,) in {0, 1}; sample_weight (B,) or None. -> (total, parts)."""
    w = sample_weight if sample_weight is not None else torch.ones(
        cir.shape[0], dtype=cir.dtype, device=cir.device)
    loss_ae = lambda_ae * l1(cir, outputs["recon"], w)
    loss_kl = lambda_kl * _wmean(env_kl_per_sample(outputs["env_code"], kl_free_bits)[:, None], w)
    sup_w = w * sup_mask.reshape(-1)
    loss_res = lambda_res * l1(err, outputs["err_est"], sup_w)
    loss_env = lambda_env * cross_entropy(outputs["logits"], label, sup_w)
    total = loss_ae + loss_kl + loss_res + loss_env
    aux = {"loss": total, "loss_ae": loss_ae, "loss_kl": loss_kl, "loss_res": loss_res,
           "loss_env": loss_env}
    return total, aux


def joint_loss(label_est: torch.Tensor, err_est: torch.Tensor, err: torch.Tensor,
               label: torch.Tensor, sample_weight: Optional[torch.Tensor] = None,
               lambda_idy: float = 1.0, lambda_reg: float = 1.0) -> tuple[torch.Tensor, dict]:
    """The supervised joint objective, CE + L1 (losses.py:113-127). -> (total, parts)."""
    loss_idy = lambda_idy * cross_entropy(label_est, label, sample_weight)
    loss_reg = lambda_reg * l1(err_est, err, sample_weight)
    total = loss_idy + loss_reg
    return total, {"loss": total, "loss_idy": loss_idy, "loss_reg": loss_reg}
