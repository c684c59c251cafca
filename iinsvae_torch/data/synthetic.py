"""The synthetic Zenodo-shaped fixture as plain numpy arrays.

A copy of the arithmetic of iinsvae_tpu/data/synthetic.py:66-125 at its
default fixture version 2 (the same random draws in the same order, so a
seed gives bit-equal CIRs), selected and shuffled for each environment by
``data.zenodo.select_env`` as iinsvae_tpu/data/zenodo.py:122-162 does,
without the pandas frame and pickle round trip (the card's machine has no
pandas).
"""

from __future__ import annotations

import numpy as np

from iinsvae_torch.data.zenodo import select_env

CIR_LEN = 157
# ~40% LOS; obstacle k is the one-hot string with its '1' at position 10-k-1
# from the right (zenodo.py:29-41); LOS is all zeros
_LOS_SHARE = 0.4

# v2 per-obstacle damped-resonance signature: idx -> (freq cycles/tap, tau
# taps, echo amplitude ratio vs first path) (synthetic.py:46-61)
_MATERIAL_SIG = np.array([
    (0.34, 12.0, 0.95),  # metal window
    (0.22, 10.0, 0.70),  # glass plate
    (0.13, 9.0, 0.60),   # wood door
    (0.36, 13.0, 1.00),  # metal plate
    (0.28, 10.0, 0.75),  # LCD TV
    (0.10, 7.0, 0.45),   # cardboard box
    (0.14, 8.0, 0.55),   # plywood plate
    (0.06, 7.0, 0.50),   # plastic
    (0.05, 5.0, 0.30),   # polystyrene plate
    (0.18, 9.0, 0.80),   # wall
])


def synthetic_zenodo_arrays(n: int = 4096, seed: int = 0) -> dict[str, np.ndarray]:
    """The fixture's columns: cir (n, 157) float64, err (n,) in metres,
    room (n,) int 0-4, obstacle (n,) int 0-9 or -1 for LOS."""
    rng = np.random.default_rng(seed)
    rooms = rng.integers(0, 5, size=n)
    is_los = rng.random(n) < _LOS_SHARE
    obstacle_idx = rng.integers(0, 10, size=n)

    t = np.arange(CIR_LEN, dtype=np.float64)
    # first-path delay shifts with obstacle (NLOS delays + attenuates)
    fp_delay = 20 + rng.integers(0, 6, size=n) + np.where(is_los, 0, 4 + obstacle_idx // 2)
    amp = np.where(is_los, 1.0, 0.45 + 0.04 * obstacle_idx) * (1.0 + 0.1 * rng.standard_normal(n))
    # room-dependent multipath decay constant
    decay = 6.0 + 3.0 * rooms + rng.uniform(0, 1, size=n)

    dt = t[None, :] - fp_delay[:, None]
    pulse = np.exp(-0.5 * (dt / 1.5) ** 2)
    tail = np.where(dt > 0, np.exp(-dt / decay[:, None]), 0.0) * (
        0.35 + 0.1 * rng.random((n, CIR_LEN)))
    noise = 0.02 * np.abs(rng.standard_normal((n, CIR_LEN)))
    cir = amp[:, None] * (pulse + tail) + noise
    # material resonance after the first path, jittered per sample; LOS
    # samples carry no obstacle, hence no signature
    f = _MATERIAL_SIG[obstacle_idx, 0] * (1.0 + 0.08 * rng.standard_normal(n))
    tau = _MATERIAL_SIG[obstacle_idx, 1] * (1.0 + 0.15 * rng.standard_normal(n))
    ratio = _MATERIAL_SIG[obstacle_idx, 2] * (1.0 + 0.20 * rng.standard_normal(n))
    tau = np.clip(tau, 2.0, None)
    phase = rng.uniform(0, 2 * np.pi, size=n)
    ring = np.where(
        dt > 0,
        np.exp(-dt / tau[:, None]) * np.cos(2 * np.pi * f[:, None] * dt + phase[:, None]),
        0.0,
    )
    cir = cir + np.where(is_los, 0.0, amp * ratio)[:, None] * ring
    cir = cir * rng.uniform(800, 1200)  # raw zenodo CIRs are O(1e3-1e4)

    err = np.abs(
        0.05
        + np.where(is_los, 0.02, 0.15 + 0.02 * obstacle_idx) * (fp_delay - 20) / 6.0
        + 0.03 * rng.standard_normal(n)
    )
    return {"cir": cir, "err": err, "room": rooms.astype(np.int64),
            "obstacle": np.where(is_los, -1, obstacle_idx)}


def synthetic_arrays(n: int = 4096, seed: int = 0, option: str = "room_full",
                     dataset_name: str = "zenodo"):
    """(cir, err, label, room) of environment ``option``, shapes (N, 157),
    (N, 1), (N, 1), (N, 1), float64, in the order zenodo.load_pkl_data gives
    them: the selected rows shuffled by ``default_rng(seed).permutation``."""
    if dataset_name != "zenodo":
        raise NotImplementedError(
            f"dataset_name {dataset_name!r}: only the zenodo fixture is ported; the eWine "
            "fixture (152 taps) comes with the data pipeline slice")
    return select_env(synthetic_zenodo_arrays(n, seed), option, seed)
