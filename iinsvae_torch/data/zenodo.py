"""The Zenodo environments: label tables and the nine row selections
(iinsvae_tpu/data/zenodo.py:29-162), written over numpy columns instead of
a pandas frame (the card's machine has no pandas).

``select_env(columns, option, seed)`` takes the fixture's columns (cir,
err, room, and obstacle as the index 0-9 of ``OBSTACLE_ONEHOT``, -1 for
LOS, -2 for any other string) and returns what ``load_pkl_data`` returns
for the same rows: each part's rows in their order, the parts concatenated
in their listed order, then permuted by ``default_rng(seed).permutation``.
``load_pkl_data`` reads the real ``dataset.pkl`` into those columns; it
imports pandas when called, so on a machine without pandas it raises an
ImportError that names it.
"""

from __future__ import annotations

import numpy as np

# one-hot obstacle strings in the reference's label order 0..9
OBSTACLE_ONEHOT = [
    "0000000001",  # 0 metal window
    "0000000010",  # 1 glass plate
    "0000000100",  # 2 wood door
    "0000001000",  # 3 metal plate
    "0000010000",  # 4 LCD TV
    "0000100000",  # 5 cardboard box
    "0001000000",  # 6 plywood plate
    "0010000000",  # 7 plastic
    "0100000000",  # 8 polystyrene plate
    "1000000000",  # 9 wall
]
LOS_STR = "0000000000"

# material groups of obstacle_part
_OBSTACLE_PART = {
    0: ["0000000001", "0000001000"],  # metal (window + plate)
    1: ["0000000100"],                # wood
    2: ["0010000000"],                # plastic
    3: ["0000000010"],                # glass
}

ZENODO_ENVS = (
    "nlos",
    "room_full",
    "obstacle_full",
    "room_part",
    "obstacle_part",
    "room_full_rough",
    "room_full_rough2",
    "obstacle_part2",
    "paper",
)

# a one-hot string -> the obstacle column's index (-1 for LOS)
_OBSTACLE_INDEX = {LOS_STR: -1, **{s: k for k, s in enumerate(OBSTACLE_ONEHOT)}}
# the obstacle column's index of a string no selection names (a multi-obstacle string)
OTHER_OBSTACLE = -2


def label_dictionary(dataset_env: str) -> dict:
    """int -> class-name maps."""
    if dataset_env == "nlos":
        return {0: "los", 1: "nlos"}
    if dataset_env == "room_full":
        return {0: "cross-room", 1: "big room", 2: "medium room", 3: "small room", 4: "outdoor"}
    if dataset_env == "obstacle_full":
        return {
            0: "metal window", 1: "glass plate", 2: "wood door", 3: "metal plate",
            4: "LCD TV", 5: "cardboard box", 6: "plywood plate", 7: "plastic",
            8: "polystyrene plate", 9: "wall",
        }
    if dataset_env == "room_part":
        return {0: "big room", 1: "medium room", 2: "small room"}
    if dataset_env in ("obstacle_part", "paper"):
        return {0: "metal", 1: "wood", 2: "plastic", 3: "glass"}
    if dataset_env == "room_full_rough":
        return {0: "cross-room", 1: "indoor", 2: "outdoor"}
    if dataset_env == "room_full_rough2":
        return {0: "indoor", 1: "outdoor"}
    if dataset_env == "obstacle_part2":
        return {0: "metal", 1: "non-metal"}
    raise ValueError(f"Unknown environment: {dataset_env}")


def _select(columns: dict, obstacles=None, rooms=None) -> np.ndarray:
    """Boolean row mask: the obstacle one-hot strings and rooms asked for."""
    keep = np.ones(columns["room"].shape[0], dtype=bool)
    if obstacles is not None:
        keep &= np.isin(columns["obstacle"], [_OBSTACLE_INDEX[s] for s in obstacles])
    if rooms is not None:
        keep &= np.isin(columns["room"], rooms)
    return keep


def _parts(columns: dict, option: str) -> list:
    """[(row mask, label int or 'room'), ...] of one environment, in order."""
    if option == "nlos":
        return [(_select(columns, obstacles=[LOS_STR]), 0),
                (_select(columns, obstacles=OBSTACLE_ONEHOT), 1)]
    if option == "room_full":
        return [(_select(columns), "room")]
    if option == "obstacle_full":
        return [(_select(columns, obstacles=[s]), k) for k, s in enumerate(OBSTACLE_ONEHOT)]
    if option == "room_part":
        return [(_select(columns, rooms=[r]), k) for k, r in enumerate((1, 2, 3))]
    if option in ("obstacle_part", "paper"):
        return [(_select(columns, obstacles=s), k) for k, s in _OBSTACLE_PART.items()]
    if option == "room_full_rough":
        return [(_select(columns, rooms=[0]), 0), (_select(columns, rooms=[1, 2, 3]), 1),
                (_select(columns, rooms=[4]), 2)]
    if option == "room_full_rough2":
        return [(_select(columns, rooms=[0, 1, 2, 3]), 0), (_select(columns, rooms=[4]), 1)]
    if option == "obstacle_part2":
        metal = _OBSTACLE_PART[0]
        return [(_select(columns, obstacles=metal), 0),
                (_select(columns, obstacles=[s for s in OBSTACLE_ONEHOT if s not in metal]), 1)]
    raise ValueError(f"Unknown environment option: {option}")


def select_env(columns: dict, option: str | None = None, seed: int = 0):
    """-> (cir, err, label, room), shapes (N, L), (N, 1), (N, 1), (N, 1),
    float64: the rows of environment ``option`` (default 'nlos'), shuffled."""
    parts = [(np.flatnonzero(keep), lab) for keep, lab in _parts(columns, option or "nlos")]
    rows = np.concatenate([r for r, _ in parts])
    room = columns["room"].astype(np.float64).reshape(-1, 1)
    label = np.concatenate([room[r] if lab == "room" else np.full((r.size, 1), float(lab))
                            for r, lab in parts])
    perm = np.random.default_rng(seed).permutation(rows.size)
    rows, label = rows[perm], label[perm]
    err = np.asarray(columns["err"], np.float64).reshape(-1, 1)
    return columns["cir"][rows], err[rows], label, room[rows]


def label_int2str(dataset_env: str, label_int: int) -> str:
    return label_dictionary(dataset_env)[int(label_int)]


def frame_columns(frame) -> dict[str, np.ndarray]:
    """A dataset.pkl frame (columns CIR, Error, Room, Obstacles) -> select_env's columns."""
    obstacles = frame["Obstacles"].to_numpy()
    return {"cir": np.vstack(frame["CIR"].to_numpy()),
            "err": np.asarray(frame["Error"].to_numpy(), dtype=np.float64),
            "room": np.asarray(frame["Room"].to_numpy()),
            "obstacle": np.array([_OBSTACLE_INDEX.get(s, OTHER_OBSTACLE) for s in obstacles],
                                 dtype=np.int64)}


def load_pkl_data(filepath: str, option: str | None = None, seed: int = 0):
    """Load, select, shuffle (iinsvae_tpu/data/zenodo.py:122-162). -> (cir, err, label,
    room), shapes (N, 157), (N, 1), (N, 1), (N, 1). Needs pandas (an ImportError naming it
    where it is missing): the pickle is a pandas frame."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"reading the Zenodo pickle {filepath} needs pandas, which this "
                          "machine does not have") from e
    return select_env(frame_columns(pd.read_pickle(filepath)), option, seed)
