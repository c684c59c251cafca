"""Train/test assembly (iinsvae_tpu/data/splits.py; reference dataset.py:15-89): the 'full'
split (the first ``split_factor`` of the rows train), the 'paper' split (the medium room,
Room == 2, held out as the test split), and StandardScaler scaling, a per-tap mean and std
fit on the train split and applied to both."""

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


def err_mitigation_dataset(root, dataset_name: str = "zenodo", dataset_env: str | None = None,
                           split_factor: float = 0.8, scaling: bool = False, mode: str = "full",
                           feature_flag: bool = False, seed: int = 0, arrays=None):
    """-> (train, test, train_features, test_features), train and test (cir, err, label) as
    contiguous float32 (iinsvae_tpu/data/splits.py:37-105). ``root``: the Zenodo pickle, or
    the eWine CSV files and folders; ``arrays``: the Zenodo environment's (cir, err, label,
    room) already loaded (the synthetic fixture), read in place of ``root``. 'full' trains on
    the first ``split_factor`` of the rows; 'paper' holds out the medium room (Room == 2) as
    the test split (every eWine row is room 0). ``scaling`` standardizes the CIRs with the
    train split's statistics. ``feature_flag`` (the SVM's features) is not ported yet."""
    if feature_flag:
        raise NotImplementedError("feature_flag: the SVM baseline's features are not ported yet "
                                  "(ROADMAP.md Queue 1 item 8)")
    if dataset_name == "ewine":
        from iinsvae_torch.data.ewine import load_reg_data

        cir, err, label = load_reg_data(root, seed=seed)
        room = np.zeros_like(label)
    elif dataset_name == "zenodo":
        from iinsvae_torch.data.zenodo import load_pkl_data

        cir, err, label, room = arrays if arrays is not None else load_pkl_data(
            root, option=dataset_env or "room_full", seed=seed)
    else:
        raise ValueError(f"Unknown dataset: {dataset_name}")

    if mode == "full":
        n_train = int(cir.shape[0] * split_factor)
        train_rows, test_rows = slice(0, n_train), slice(n_train, None)
    elif mode == "paper":
        test_rows = room.reshape(-1) == 2
        train_rows = ~test_rows
    else:
        raise ValueError(f"Unknown split mode: {mode}")
    train_cir, test_cir = cir[train_rows], cir[test_rows]
    if scaling:
        scaler = Standardizer.fit(train_cir)
        train_cir, test_cir = scaler.transform(train_cir), scaler.transform(test_cir)

    def f32(*arrays_):
        return tuple(np.ascontiguousarray(a, dtype=np.float32) for a in arrays_)

    return (f32(train_cir, err[train_rows], label[train_rows]),
            f32(test_cir, err[test_rows], label[test_rows]), None, None)
