"""The dataset facade (iinsvae_tpu/data/pipeline.py): ``UWBDataset`` keeps the reference's
item API ({"CIR", "Err", "Label"}, reference dataset.py:93-136) for code ported from it. The
training path never iterates items: the whole split goes to the device once and the epoch
loop batches there (training/loop.py)."""

from __future__ import annotations

import numpy as np
import torch


class UWBDataset:
    """An array-backed dataset with the reference's ``__getitem__`` contract."""

    def __init__(self, data):
        cir, err, label = data
        self.cir = np.asarray(cir, dtype=np.float32)
        self.err = np.asarray(err, dtype=np.float32)
        self.label = np.asarray(label, dtype=np.float32)

    def __getitem__(self, index: int) -> dict:
        i = index % len(self.cir)
        return {"CIR": self.cir[i], "Err": self.err[i % len(self.err)],
                "Label": self.label[i % len(self.label)]}

    def __len__(self) -> int:
        return len(self.cir)

    def as_device_batches(self, device: str | torch.device) -> dict[str, torch.Tensor]:
        """{cir, err, label} as float32 tensors on ``device``, which the caller names."""
        return {k: torch.tensor(getattr(self, k), device=device) for k in ("cir", "err", "label")}

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0):
        """Host-side batches of items (evaluation and debugging)."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for i in range(0, len(self), batch_size):
            idx = order[i:i + batch_size]
            yield {"CIR": self.cir[idx], "Err": self.err[idx], "Label": self.label[idx]}
