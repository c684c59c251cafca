"""Verification of a real dataset's placement (iinsvae_tpu/data/verify.py): checks that a
``dataset.pkl`` or an eWine CSV tree under the data root matches the documented schema and
scale before a run reads it:

    python -m iinsvae_torch.cli.inspect_data --verify_data            # zenodo
    python -m iinsvae_torch.cli.inspect_data --verify_data --dataset_name ewine

Schema facts come from the dataset README (reference data/data_zenodo/README_diverse.md:6-38):
columns CIR (157 floats) / Error (m) / Room (int 0-4) / Obstacles (10-char 0/1 string).
Scale facts come from the reference's comments (SURVEY.md §2.1): room_full = 55,158 rows,
obstacle_full = 26,553, obstacle_part = 13,592, the paper split 25,191/6,298, per-obstacle
counts data_tools.py:176-239. Schema violations are ERRORS; count drift is a WARNING (a
fixture, a subset or an updated Zenodo deposit is still usable).

The pickle needs pandas (imported when a file is there to read: an ImportError naming it
where it is missing). The eWine CSVs are read as the loader reads them, by the port's native
parser (runtime/native.py), where a non-numeric field reads as NaN.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

from iinsvae_torch.data.zenodo import LOS_STR, OBSTACLE_ONEHOT

CIR_LEN = 157

# documented per-obstacle sample counts in label order 0..9
# (reference data_tools.py:176-239)
_OBSTACLE_COUNTS = [954, 1971, 3354, 2966, 2888, 4182, 3581, 417, 2253, 3987]
_DOCUMENTED = {
    "total rows (room_full selection, data_tools.py:167)": 55158,
    "obstacle_full rows (data_tools.py:250)": 26553,
    "obstacle_part rows (data_tools.py:334)": 13592,
    "big-room rows (data_tools.py:259)": 18422,
    "medium-room rows (data_tools.py:266)": 13210,
}


def _sha256(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def verify_zenodo(path: str) -> dict:
    """Validate a Zenodo dataset.pkl. Returns
    {"ok", "errors", "warnings", "stats"} — ok means the schema is usable
    by every loader path; warnings flag scale drift vs the documented
    counts (e.g. a synthetic fixture)."""
    errors, warnings, stats = [], [], {}
    if not os.path.exists(path):
        return {
            "ok": False,
            "errors": [
                f"{path} not found — download the Deep UWB dataset "
                "(DOI 10.5281/zenodo.4290069) and place dataset.pkl there"
            ],
            "warnings": [],
            "stats": {},
        }
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(f"verifying the Zenodo pickle {path} needs pandas, which this "
                          "machine does not have") from e
    stats["path"] = path
    stats["bytes"] = os.path.getsize(path)
    stats["sha256"] = _sha256(path)
    try:
        frame = pd.read_pickle(path)
    except Exception as e:  # noqa: BLE001 — report, don't crash the CLI
        return {
            "ok": False,
            "errors": [f"unreadable pickle: {type(e).__name__}: {e}"],
            "warnings": [],
            "stats": stats,
        }

    missing = [c for c in ("CIR", "Error", "Room", "Obstacles") if c not in frame.columns]
    if missing:
        errors.append(f"missing columns: {missing} (README_diverse.md sample structure)")
        return {"ok": False, "errors": errors, "warnings": warnings, "stats": stats}

    n = len(frame)
    stats["rows"] = n
    if n == 0:
        errors.append("dataset frame has 0 rows")
        return {"ok": False, "errors": errors, "warnings": warnings, "stats": stats}
    lens = frame["CIR"].map(
        lambda c: len(c) if hasattr(c, "__len__") else -1
    ).to_numpy()
    bad_len = int((lens != CIR_LEN).sum())
    if bad_len:
        errors.append(
            f"{bad_len}/{n} CIR rows are not {CIR_LEN} taps "
            f"(lengths seen: {sorted(set(lens.tolist()))[:5]}; -1 = not a sequence)"
        )

    try:
        err = np.asarray(frame["Error"].to_numpy(), dtype=np.float64)
    except (TypeError, ValueError) as e:
        errors.append(f"Error column is not numeric: {e}")
        return {"ok": False, "errors": errors, "warnings": warnings, "stats": stats}
    n_nonfinite = int((~np.isfinite(err)).sum())
    if n_nonfinite:
        errors.append(f"{n_nonfinite}/{n} non-finite Error values")
    if np.isfinite(err).any():
        stats["error_range_m"] = (float(np.nanmin(err[np.isfinite(err)])),
                                  float(np.nanmax(err[np.isfinite(err)])))

    rooms = np.asarray(frame["Room"].to_numpy())
    bad_rooms = sorted(set(rooms.tolist()) - {0, 1, 2, 3, 4})
    if bad_rooms:
        errors.append(f"Room values outside 0-4: {bad_rooms}")
    stats["room_counts"] = {int(r): int((rooms == r).sum()) for r in sorted(set(rooms.tolist()))}

    obs = frame["Obstacles"].to_numpy()
    malformed = [
        s for s in set(obs.tolist())
        if not (isinstance(s, str) and len(s) == 10 and set(s) <= {"0", "1"})
    ]
    if malformed:
        errors.append(f"malformed Obstacles strings (need 10-char 0/1): {malformed[:5]}")
    known = set(OBSTACLE_ONEHOT) | {LOS_STR}
    multi = int(sum(1 for s in obs if isinstance(s, str) and s not in known
                    and len(s) == 10 and set(s) <= {"0", "1"}))
    if multi:
        warnings.append(
            f"{multi}/{n} rows use multi-obstacle strings — valid per the "
            "README reading code but unused by every reference selection"
        )
    stats["los_rows"] = int(sum(1 for s in obs if s == LOS_STR))

    # documented-scale comparison (warnings only)
    if n != _DOCUMENTED["total rows (room_full selection, data_tools.py:167)"]:
        warnings.append(
            f"row count {n} != documented 55,158 — synthetic fixture, "
            "subset, or updated deposit"
        )
    else:
        onehot_counts = [int(sum(1 for s in obs if s == o)) for o in OBSTACLE_ONEHOT]
        if onehot_counts != _OBSTACLE_COUNTS:
            warnings.append(
                f"per-obstacle counts {onehot_counts} differ from the "
                f"reference's documented {_OBSTACLE_COUNTS}"
            )
        paper_test = int((rooms == 2).sum())
        if paper_test != 6298:
            warnings.append(
                f"paper-mode test split (Room==2) has {paper_test} rows, "
                "documented 6,298 (dataset.py:193)"
            )

    return {"ok": not errors, "errors": errors, "warnings": warnings, "stats": stats}


def verify_ewine(base_dir: str) -> dict:
    """Validate an eWine CSV tree against the loader's contract (data/ewine.py,
    runtime/native.py ``ewine_extract``): rows need >= max(18, 152) columns; the 152-tap
    window is read at ABSOLUTE column first-path(col 8) + 15, clamped into [0, cols-152] —
    the verifier flags exactly the rows where that clamp is not the identity."""
    from iinsvae_torch.runtime.native import read_csv

    errors, warnings, stats = [], [], {}
    if not os.path.isdir(base_dir):
        return {
            "ok": False,
            "errors": [
                f"{base_dir} not found — place the eWine measurement CSVs "
                "under it (e.g. dataset1/tag_room0.csv)"
            ],
            "warnings": [],
            "stats": {},
        }
    # The loaders read ONLY this path set (cli/common.py EWINE_DEFAULT_PATHS;
    # directory entries walked top-level only, data/ewine.py). Schema violations
    # there are hard errors; any other CSV in the tree (real eWine downloads
    # ship other-schema measurement files) is checked advisorily and reported
    # as a warning — the loader never touches it.
    loader_relpaths = (
        os.path.join("dataset1", "tag_room0.csv"),
        os.path.join("dataset1", "tag_room1.csv"),
        os.path.join("dataset2", "tag_room0.csv"),
        os.path.join("dataset2", "tag_room1"),
    )
    loader_set = set()
    for rel in loader_relpaths:
        p = os.path.normpath(os.path.join(base_dir, rel))
        if os.path.isdir(p):
            for f in sorted(os.listdir(p)):
                if f.endswith(".csv"):
                    loader_set.add(os.path.normpath(os.path.join(p, f)))
        elif os.path.isfile(p):
            loader_set.add(p)

    csvs = sorted(
        os.path.normpath(os.path.join(r, f))
        for r, _, files in os.walk(base_dir)
        for f in files
        if f.endswith(".csv")
    )
    stats["csv_files"] = len(csvs)
    stats["loader_csv_files"] = len(loader_set)
    if not csvs:
        errors.append(f"no .csv files under {base_dir}")
        return {"ok": False, "errors": errors, "warnings": warnings, "stats": stats}
    if not loader_set:
        warnings.append(
            f"no CSVs at the loader's default paths under {base_dir} "
            "(dataset{1,2}/tag_room*) — the CLIs read only those; the files "
            "found elsewhere were checked advisorily"
        )

    rows = 0
    for path in csvs:
        sink = errors if (not loader_set or path in loader_set) else warnings
        note = "" if sink is errors else " (outside loader paths — ignored by the loader)"
        # an unreadable CSV must produce a report entry, not crash --verify_data
        try:
            arr = read_csv(path)
        except OSError as e:
            sink.append(f"{path}: unreadable ({type(e).__name__}: {e}){note}")
            continue
        rows += arr.shape[0]
        cols = arr.shape[1]
        if cols < max(18, 152):
            sink.append(
                f"{path}: {cols} columns < {max(18, 152)} "
                f"(metadata + one 152-tap CIR window — data/ewine.py){note}"
            )
            continue
        fp = arr[:, 8]
        n_bad_fp = int((~np.isfinite(fp)).sum())
        if n_bad_fp:
            warnings.append(
                f"{path}: {n_bad_fp}/{arr.shape[0]} non-finite first-path "
                "indices (loader reads those windows from column 15)"
            )
        start = np.where(np.isfinite(fp), fp, 0.0) + 15.0
        clamped = int((start != np.clip(start, 0, cols - 152)).sum())
        if clamped:
            warnings.append(
                f"{path}: {clamped}/{arr.shape[0]} rows where the 152-tap "
                f"window at first-path+15 falls outside [0, {cols - 152}] "
                "(loader clamps it into the row)"
            )
        if (arr[:, 17] == 0).any():
            sink.append(f"{path}: zero max-amplitude rows (divide-by-zero){note}")
        # the parser reads a field that is no number as NaN: flag the cells the loader reads
        # (the metadata columns 0-5 and 17, each row's window) that are not finite
        window = np.clip(start, 0, cols - 152).astype(np.int64)[:, None] + np.arange(152)
        read = np.concatenate([arr[:, [0, 1, 2, 3, 4, 5, 17]],
                               np.take_along_axis(arr, window, axis=1)], axis=1)
        n_bad = int((~np.isfinite(read)).any(axis=1).sum())
        if n_bad:
            sink.append(f"{path}: {n_bad}/{arr.shape[0]} rows with a non-numeric or non-finite "
                        f"field the loader reads (it reads a non-number as NaN){note}")
    stats["rows"] = rows
    if rows != 31489:
        warnings.append(
            f"total rows {rows} != documented 31,489 (dataset.py:171) — "
            "synthetic fixture or partial download"
        )
    return {"ok": not errors, "errors": errors, "warnings": warnings, "stats": stats}


def print_report(name: str, report: dict) -> None:
    print(f"[verify_data] {name}: {'OK' if report['ok'] else 'FAILED'}")
    for k, v in report["stats"].items():
        print(f"  {k}: {v}")
    for w in report["warnings"]:
        print(f"  WARNING: {w}")
    for e in report["errors"]:
        print(f"  ERROR: {e}")
