"""Batched inference: the port of iinsvae_tpu/serving.py's ``Predictor``.

Inputs are padded with zero rows to the fixed batch size (every launch
sees one shape), outputs come back unpadded; zero rows change no real row,
because every op of the forward is per sample. The mitigated distance is
d_measured - err_est.

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
    recon: Optional[np.ndarray] = None  # (N, L), with the decoder slice


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
        if return_recon:
            raise NotImplementedError(
                "return_recon needs the decoder, which is the next slice of the port "
                "(fused_adain_res_block, fused_sln_chain)")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size
        self.return_recon = return_recon

    @classmethod
    def from_npz(cls, path: str, *, cir_len: int = 157, batch_size: int = 500,
                 device: str | torch.device = "cuda") -> "Predictor":
        """Serve the weights of an iinsvae_tpu ``export_serving`` npz."""
        state = load_npz(path)
        model = IInsVAE(cir_len=cir_len, **model_geometry(state))
        model.load_state_dict(state)
        return cls(model, batch_size=batch_size, device=device)

    def _forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        out = self.model(x)
        return out["err_est"], torch.softmax(out["logits"], dim=-1), out["env_code"]

    def _prediction(self, parts: list[torch.Tensor], n: int) -> Prediction:
        # one device -> host copy per output
        err_est, probs, env_code = (p[:n].cpu().numpy() for p in parts)
        return Prediction(err_est=err_est, label_probs=probs,
                          label=np.argmax(probs, axis=-1), env_code=env_code)

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
            outs.append(self._forward(torch.from_numpy(chunk).to(self.device)))
        return self._prediction([torch.cat([o[j] for o in outs]) for j in range(3)], n)

    @torch.inference_mode()
    def predict_dataset(self, cir: np.ndarray) -> Prediction:
        """Bulk path: one upload of the padded set, the batches run on the
        device back to back, one fetch."""
        cir = np.asarray(cir, dtype=np.float32)
        n, bs = cir.shape[0], self.batch_size
        nb = -(-n // bs)
        dev = torch.from_numpy(np.pad(cir, ((0, nb * bs - n), (0, 0)))).to(self.device)
        outs = [self._forward(dev[i * bs:(i + 1) * bs]) for i in range(nb)]
        return self._prediction([torch.cat([o[j] for o in outs]) for j in range(3)], n)

    def mitigate(self, cir: np.ndarray, d_measured: np.ndarray) -> np.ndarray:
        """Error-mitigated distance: d_measured - err_est."""
        return np.asarray(d_measured).reshape(-1, 1) - self(cir).err_est
