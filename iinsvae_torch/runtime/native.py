"""Build the port's native plane (csrc/batcher.cc and csrc/server.cc for
serving, csrc/io.cc for the data: the CSV parser, the eWine extraction and
the mmap split cache) with the host C++ compiler and bind it by ctypes.

The sources become one shared library,
``build/iinsvae_torch/runtime-<hash>.so`` under the repository root, where
the hash covers the sources, the compiler and its flags: a changed source is
rebuilt, an unchanged one is loaded as it is. The compiler is ``$CXX``, or
``g++``. Nothing here runs at import time: the first ``load()`` builds what
is missing, and a failed build raises with the compiler's output. Nothing
carries on without the plane. ``read_csv`` and ``ewine_extract`` are the
data entries (iinsvae_tpu/runtime/native.py:73-115, with no pandas fallback);
runtime/cache.py binds the cache's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from iinsvae_torch.ops.kernels._build import BUILD_DIR

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("batcher.cc", "server.cc", "io.cc")
# -ffp-contract=off: no multiply-add is fused, so the data entries compute numpy's float64
# arithmetic on every host (the JAX package's build, -march=native, fuses eWine's
# dx * dx + dy * dy into one FMA there and rounds its error differently by an ulp)
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")
LIBS = ("-lpthread",)

i64 = ctypes.c_int64
p_i64 = ctypes.POINTER(ctypes.c_int64)
p_d = ctypes.POINTER(ctypes.c_double)

# (name, result type, argument types) of the entries called from Python
_SIGNATURES = (
    ("iins_batcher_create", ctypes.c_void_p, [i64, i64, i64, i64, ctypes.c_double]),
    ("iins_batcher_destroy", None, [ctypes.c_void_p]),
    ("iins_batcher_submit", i64, [ctypes.c_void_p, p_d]),
    ("iins_batcher_next_batch", i64, [ctypes.c_void_p, p_d, p_i64, ctypes.c_double]),
    ("iins_batcher_post", None, [ctypes.c_void_p, p_i64, p_d, p_i64, p_d, i64]),
    ("iins_batcher_wait", ctypes.c_int, [ctypes.c_void_p, i64, p_d, p_i64, p_d, ctypes.c_double]),
    ("iins_batcher_abandon", None, [ctypes.c_void_p, i64]),
    ("iins_batcher_pending", i64, [ctypes.c_void_p]),
    ("iins_batcher_stats", None, [ctypes.c_void_p, p_i64]),
    ("iins_batcher_set_reclaim_grace_ms", None, [ctypes.c_void_p, ctypes.c_double]),
    ("iins_server_start", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_char_p, i64]),
    ("iins_server_start_tcp", ctypes.c_void_p, [ctypes.c_void_p, ctypes.c_int32, i64]),
    ("iins_server_port", ctypes.c_int32, [ctypes.c_void_p]),
    ("iins_server_stop", None, [ctypes.c_void_p]),
    ("iins_server_set_max_rows", None, [ctypes.c_void_p, i64]),
    ("iins_server_set_recv_timeout_ms", None, [ctypes.c_void_p, i64]),
    ("iins_server_rejected", i64, [ctypes.c_void_p]),
    ("iins_read_csv", p_d, [ctypes.c_char_p, ctypes.c_int, p_i64, p_i64]),
    ("iins_free", None, [p_d]),
    ("iins_ewine_extract", None, [p_d, i64, i64, p_d, p_d, p_d]),
    ("iins_cache_write", i64, [ctypes.c_char_p, i64, ctypes.POINTER(ctypes.c_char_p), p_i64,
                               p_i64, p_i64, ctypes.POINTER(ctypes.c_void_p)]),
    ("iins_cache_open", ctypes.c_void_p, [ctypes.c_char_p]),
    ("iins_cache_count", i64, [ctypes.c_void_p]),
    ("iins_cache_array", ctypes.c_void_p, [ctypes.c_void_p, i64, ctypes.c_char_p, p_i64,
                                           p_i64, p_i64]),
    ("iins_cache_close", None, [ctypes.c_void_p]),
)
# the eWine CIR window (csrc/io.cc's kCirLen) and the columns a row needs: the metadata
# (0-17) and one window
EWINE_CIR_LEN = 152
EWINE_MIN_COLS = max(18, EWINE_CIR_LEN)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def library_path() -> Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((compiler(), *CXX_FLAGS, *LIBS)).encode())
    return BUILD_DIR / f"runtime-{h.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """Compile both sources into ``out``: a temporary file first, moved into
    place when the compiler succeeds, so that processes building at once
    never load a half-written library. Raises with the compiler's output."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the native serving plane: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native serving plane failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The plane's library, built on first use, every entry's types declared."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
            for name, restype, argtypes in _SIGNATURES:
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
    return _lib


def _as_c(arr: np.ndarray):
    return arr.ctypes.data_as(p_d)


def read_csv(path: str, skip_header: bool = True) -> np.ndarray:
    """A numeric CSV -> (rows, cols) float64 (a non-numeric field reads NaN, a short row is
    padded with NaN, a long one cut to the first row's width). Raises OSError where the file
    cannot be read."""
    lib = load()
    rows, cols = i64(0), i64(0)
    ptr = lib.iins_read_csv(str(path).encode(), 1 if skip_header else 0, ctypes.byref(rows),
                            ctypes.byref(cols))
    if not ptr:
        raise OSError(f"native csv parse failed: {path}")
    try:
        return np.ctypeslib.as_array(ptr, shape=(rows.value, cols.value)).copy()
    finally:
        lib.iins_free(ptr)


def ewine_extract(rows: np.ndarray):
    """(N, cols) raw eWine rows -> (cir (N, 152), err (N, 1), label (N, 1)), float64: the
    152-tap window from column first-path (col 8) + 15, clamped into the row (a NaN first path
    reads from 15), over the max amplitude (col 17); err |hypot(tag - anchor) - measured|;
    label col 5."""
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n, cols = rows.shape
    if cols < EWINE_MIN_COLS:
        raise ValueError(f"ewine rows need >= {EWINE_MIN_COLS} columns (metadata + one CIR "
                         f"window), got {cols}")
    cir = np.empty((n, EWINE_CIR_LEN), dtype=np.float64)
    err = np.empty((n, 1), dtype=np.float64)
    label = np.empty((n, 1), dtype=np.float64)
    load().iins_ewine_extract(_as_c(rows), n, cols, _as_c(cir), _as_c(err), _as_c(label))
    return cir, err, label
