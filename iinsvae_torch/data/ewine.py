"""The eWine UWB CSV loader (iinsvae_tpu/data/ewine.py; reference data_tools.py:14-109).

CSV row layout (reference data_tools.py:93-107): cols 0-1 tag (x, y); cols 2-3 anchor
(x, y); col 4 the measured distance; col 5 the NLOS label; col 8 the first-path index;
col 17 the max amplitude; the CIR's 152 taps start at column first-path + 15.

Every CSV is read and every row extracted by the port's native plane
(runtime/native.py: ``read_csv``, ``ewine_extract``), which is built at first use; there is
no pandas path. ``extract_reg_arrays`` is the same extraction in numpy, the plain version
the tests hold the native one to.
"""

from __future__ import annotations

import os

import numpy as np

from iinsvae_torch.runtime import native

CIR_LEN = native.EWINE_CIR_LEN


def load_data_from_file(filepath: str) -> np.ndarray:
    """One CSV -> its rows (header dropped), float64."""
    return native.read_csv(filepath)


def load_data_from_folder(folderpath: str) -> np.ndarray:
    """The CSVs at the top level of ``folderpath`` (sorted), stacked; FileNotFoundError where
    there is none (the reference walks the top level only, data_tools.py:45-57)."""
    arrays = []
    for dirpath, _dirnames, filenames in os.walk(folderpath):
        for fname in sorted(filenames):
            if fname.endswith(".csv"):
                arrays.append(load_data_from_file(os.path.join(dirpath, fname)))
        break
    if not arrays:
        raise FileNotFoundError(f"No csv files in {folderpath}")
    return np.vstack(arrays)


def extract_reg_arrays(input_arr: np.ndarray):
    """(rows, cols) -> (cir (N, 152), err (N, 1), label (N, 1)) in numpy: the first-path
    index comes from file data, so the 152-tap window is clamped into the row (a NaN first
    path reads from 15); the clamp is the identity on valid rows."""
    input_arr = np.asarray(input_arr, dtype=np.float64)
    cols = input_arr.shape[1]
    if cols < native.EWINE_MIN_COLS:
        raise ValueError(f"ewine rows need >= {native.EWINE_MIN_COLS} columns (metadata + one "
                         f"CIR window), got {cols}")
    d_gt = np.sqrt((input_arr[:, 0] - input_arr[:, 2]) ** 2
                   + (input_arr[:, 1] - input_arr[:, 3]) ** 2)
    err = np.abs(d_gt - input_arr[:, 4]).reshape(-1, 1)
    label = input_arr[:, 5:6]
    fp = input_arr[:, 8]
    start_f = np.where(np.isfinite(fp), fp, 0.0) + 15.0
    start = np.clip(start_f, 0, cols - CIR_LEN).astype(np.int64)
    idx = start[:, None] + np.arange(CIR_LEN)[None, :]
    cir = np.take_along_axis(input_arr, idx, axis=1) / input_arr[:, 17:18]
    return cir, err, label


def load_reg_data(paths, seed: int = 0):
    """One or more CSV files or folders: their rows stacked in order, shuffled by
    ``default_rng(seed).shuffle``, extracted. -> (cir, err, label), float64."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    arrays = []
    for p in map(str, paths):
        arrays.append(load_data_from_folder(p) if os.path.isdir(p) else load_data_from_file(p))
    input_arr = np.vstack(arrays)
    np.random.default_rng(seed).shuffle(input_arr)
    return native.ewine_extract(input_arr)


def load_cls_data(paths, seed: int = 0):
    """The NLOS-classification view of the same rows: (cir, label). The reference imports it
    for the eWine path (dataset.py:24) and never defines it; its call site unpacks two
    arrays."""
    cir, _err, label = load_reg_data(paths, seed=seed)
    return cir, label
