"""The synthetic fixtures as plain numpy arrays and CSV files.

The Zenodo-shaped fixture: a copy of the arithmetic of
iinsvae_tpu/data/synthetic.py:66-125 at both fixture versions (the same random
draws in the same order, so a seed gives bit-equal CIRs; version 1 draws no
material resonance), selected and shuffled for each environment by
``data.zenodo.select_env`` as iinsvae_tpu/data/zenodo.py:122-162 does, without
the pandas frame and pickle round trip (the card's machine has no pandas).

The eWine fixture (synthetic.py:140-175): measurement CSVs of the eWine column
layout, the same draws, written without pandas: each value as Python's
shortest round-trip repr, so the text parses back to the doubles pandas'
``to_csv`` would have written, under the same ``c0..cN`` header.
"""

from __future__ import annotations

import os

import numpy as np

from iinsvae_torch.data.zenodo import select_env

CIR_LEN = 157
DEFAULT_FIXTURE_VERSION = 2
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


def synthetic_zenodo_arrays(n: int = 4096, seed: int = 0,
                            version: int = DEFAULT_FIXTURE_VERSION) -> dict[str, np.ndarray]:
    """The fixture's columns: cir (n, 157) float64, err (n,) in metres,
    room (n,) int 0-4, obstacle (n,) int 0-9 or -1 for LOS."""
    if version not in (1, 2):
        raise ValueError(f"unknown fixture version {version!r} (1 or 2)")
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
    if version >= 2:
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
                     version: int = DEFAULT_FIXTURE_VERSION):
    """(cir, err, label, room) of environment ``option``, shapes (N, 157),
    (N, 1), (N, 1), (N, 1), float64, in the order zenodo.load_pkl_data gives
    them: the selected rows shuffled by ``default_rng(seed).permutation``."""
    return select_env(synthetic_zenodo_arrays(n, seed, version), option, seed)


def fixture_path(root: str, n: int, seed: int, version: int = DEFAULT_FIXTURE_VERSION) -> str:
    """The name iinsvae_tpu/data/synthetic.py:178-192 (``ensure_dataset``) gives the fixture
    beside ``root``: n, seed and the version are in it (v1 unversioned)."""
    base, ext = os.path.splitext(root)
    vtag = "" if version == 1 else f"_v{version}"
    return f"{base}_synthetic{vtag}_{n}_{seed}{ext or '.pkl'}"


def synthetic_ewine_rows(n: int = 512, seed: int = 0, taps: int = 200) -> np.ndarray:
    """One synthetic eWine measurement file's rows, (n, 18 + taps) float64 (column layout of
    reference data_tools.py:93-107): tag and anchor coordinates, the measured distance, the
    NLOS label, the first-path index at column 8, the max amplitude at 17, raw CIR taps from
    18."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 18 + taps))
    rows[:, 0:2] = rng.uniform(0, 10, (n, 2))       # tag xy
    rows[:, 2:4] = rng.uniform(0, 10, (n, 2))       # anchor xy
    d_gt = np.hypot(rows[:, 0] - rows[:, 2], rows[:, 1] - rows[:, 3])
    nlos = rng.integers(0, 2, n)
    rows[:, 5] = nlos
    rows[:, 4] = d_gt + np.abs(0.05 + 0.25 * nlos * rng.random(n) + 0.03 * rng.standard_normal(n))
    rows[:, 8] = rng.integers(0, taps - 170, n)     # first-path index
    rows[:, 17] = rng.uniform(1000, 2000, n)        # max amplitude
    t = np.arange(taps)
    fp = rows[:, 8:9] + 15
    pulse = np.exp(-0.5 * ((t[None, :] - fp - 5) / 2.0) ** 2)
    tail = np.where(t[None, :] > fp, np.exp(-(t[None, :] - fp) / (8 + 6 * nlos[:, None])), 0)
    rows[:, 18:] = rows[:, 17:18] * (pulse + 0.4 * tail) + 20 * np.abs(rng.standard_normal((n, taps)))
    return rows


def write_csv(path: str, rows: np.ndarray) -> str:
    """``rows`` as a CSV under a ``c0..cN`` header, each value its shortest round-trip repr."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    lines = [",".join(f"c{i}" for i in range(rows.shape[1]))]
    lines += [",".join(map(repr, r)) for r in rows.tolist()]
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


def synthetic_ewine_csv(path: str, n: int = 512, seed: int = 0, taps: int = 200) -> str:
    """Write one synthetic eWine-format measurement CSV (synthetic_ewine_rows)."""
    return write_csv(path, synthetic_ewine_rows(n, seed, taps))


def ensure_ewine_dataset(base_dir: str = "./data/data_ewine", n: int = 2048, seed: int = 0):
    """Create a synthetic eWine CSV tree (dataset1/tag_room{0,1}.csv, n // 2 rows each) where
    no file of that name exists; returns the CSV paths."""
    paths = [os.path.join(base_dir, "dataset1", "tag_room0.csv"),
             os.path.join(base_dir, "dataset1", "tag_room1.csv")]
    for i, p in enumerate(paths):
        if not os.path.exists(p):
            synthetic_ewine_csv(p, n=n // 2, seed=seed + i)
    return paths
