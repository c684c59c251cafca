"""Train/test assembly (iinsvae_tpu/data/splits.py): the 'full' split (the
first ``split_factor`` of the rows train) and StandardScaler scaling, a
per-tap mean and std fit on the train split and applied to both."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Standardizer:
    mean: np.ndarray
    std: np.ndarray

    @classmethod
    def fit(cls, x: np.ndarray) -> "Standardizer":
        mean = x.mean(axis=0)
        std = x.std(axis=0)  # biased, matching sklearn StandardScaler
        return cls(mean=mean, std=np.where(std == 0.0, 1.0, std))

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean) / self.std

    def inverse(self, x: np.ndarray) -> np.ndarray:
        return x * self.std + self.mean


def full_split(cir: np.ndarray, err: np.ndarray, label: np.ndarray,
               split_factor: float = 0.8):
    """-> (train, test), each (cir, err, label) as contiguous float32, the
    CIRs standardized with the train split's statistics, as the JAX CLI
    builds them (err_mitigation_dataset(mode='full', scaling=True),
    splits.py:64-102)."""
    n_train = int(cir.shape[0] * split_factor)
    scaler = Standardizer.fit(cir[:n_train])
    train_cir, test_cir = scaler.transform(cir[:n_train]), scaler.transform(cir[n_train:])

    def f32(*arrays):
        return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays)

    return (f32(train_cir, err[:n_train], label[:n_train]),
            f32(test_cir, err[n_train:], label[n_train:]))
