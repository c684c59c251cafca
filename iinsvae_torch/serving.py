"""Batched inference: the port of iinsvae_tpu/serving.py's ``Predictor``.

Inputs are padded with zero rows to the fixed batch size (every launch
sees one shape), outputs come back unpadded; zero rows change no real row,
because every op of the forward is per sample. The mitigated distance is
d_measured - err_est. With ``return_recon`` the decoder runs too and
``Prediction.recon`` holds the reconstructed CIR; without it the decoder
does not run (eager PyTorch drops no dead code).

The predictor runs on the card unless the caller asks for the CPU: with no
CUDA device, ``Predictor(model)`` raises instead of falling back.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from iinsvae_torch.bridge import load_npz, model_geometry
from iinsvae_torch.models.vae import IInsVAE


@dataclass
class Prediction:
    err_est: np.ndarray       # (N, 1) predicted ranging error (m)
    label_probs: np.ndarray   # (N, num_classes) softmax env probabilities
    label: np.ndarray         # (N,) argmax class
    env_code: np.ndarray      # (N, style_dim) latent env stats
    recon: Optional[np.ndarray] = None  # (N, L) reconstructed CIR, with return_recon


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port serves on the card; pass device='cpu' "
            "to run the plain PyTorch path on the CPU")
    return device


class Predictor:
    def __init__(self, model: IInsVAE, batch_size: int = 500, return_recon: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.return_recon = return_recon

    @classmethod
    def from_npz(cls, path: str, *, cir_len: int = 157, batch_size: int = 500,
                 return_recon: bool = False,
                 device: str | torch.device = "cuda") -> "Predictor":
        """Serve the weights of an iinsvae_tpu ``export_serving`` npz."""
        state = load_npz(path)
        model = IInsVAE(cir_len=cir_len, **model_geometry(state))
        model.load_state_dict(state)
        return cls(model, batch_size=batch_size, return_recon=return_recon, device=device)

    @classmethod
    def from_checkpoint(cls, cfg, epoch: Optional[int] = None, **kw) -> "Predictor":
        """Serve the model of a port checkpoint (training/checkpoint.py): epoch
        ``epoch`` of the directory that ``cfg`` names, or its latest."""
        from iinsvae_torch.training.checkpoint import (latest_epoch, read_checkpoint,
                                                       semi_model_dir)

        model_path = semi_model_dir(cfg)
        epoch = epoch if epoch is not None else latest_epoch(model_path)
        if epoch is None:
            raise FileNotFoundError(f"No saved models in {model_path}.")
        model = IInsVAE(**cfg.model_kwargs())
        model.load_state_dict(read_checkpoint(model_path, epoch)["model"])
        return cls(model, batch_size=kw.pop("batch_size", 500), **kw)

    def forward_batch(self, x: torch.Tensor) -> list[torch.Tensor]:
        """err_est, label probs, env_code[, recon] of one padded batch
        (batch_size, L) already on the device, as device tensors."""
        m = self.model
        range_code, env_code = m.encode(x)
        parts = [m.restore(range_code), torch.softmax(m.classify(env_code), dim=-1), env_code]
        if self.return_recon:
            parts.append(m.decode(range_code, env_code))
        return parts

    def _prediction(self, outs: list[list[torch.Tensor]], n: int) -> Prediction:
        # one device -> host copy per output
        err_est, probs, env_code, *recon = (
            torch.cat(parts)[:n].cpu().numpy() for parts in zip(*outs))
        return Prediction(err_est=err_est, label_probs=probs, label=np.argmax(probs, axis=-1),
                          env_code=env_code, recon=recon[0] if recon else None)

    @torch.inference_mode()
    def __call__(self, cir: np.ndarray) -> Prediction:
        """Per-request path: one upload and one forward per padded batch."""
        cir = np.asarray(cir, dtype=np.float32)
        n, bs = cir.shape[0], self.batch_size
        outs = []
        for i in range(0, n, bs):
            chunk = cir[i:i + bs]
            pad = bs - chunk.shape[0]
            if pad:
                chunk = np.pad(chunk, ((0, pad), (0, 0)))
            outs.append(self.forward_batch(torch.from_numpy(chunk).to(self.device)))
        return self._prediction(outs, n)

    @torch.inference_mode()
    def predict_dataset(self, cir: np.ndarray) -> Prediction:
        """Bulk path: one upload of the padded set, the batches run on the
        device back to back, one fetch."""
        cir = np.asarray(cir, dtype=np.float32)
        n, bs = cir.shape[0], self.batch_size
        nb = -(-n // bs)
        dev = torch.from_numpy(np.pad(cir, ((0, nb * bs - n), (0, 0)))).to(self.device)
        outs = [self.forward_batch(dev[i * bs:(i + 1) * bs]) for i in range(nb)]
        return self._prediction(outs, n)

    def mitigate(self, cir: np.ndarray, d_measured: np.ndarray) -> np.ndarray:
        """Error-mitigated distance: d_measured - err_est."""
        return np.asarray(d_measured).reshape(-1, 1) - self(cir).err_est
