"""Build the port's native serving plane (csrc/batcher.cc, csrc/server.cc)
with the host C++ compiler and bind it by ctypes.

Both sources become one shared library,
``build/iinsvae_torch/runtime-<hash>.so`` under the repository root, where
the hash covers the sources, the compiler and its flags: a changed source is
rebuilt, an unchanged one is loaded as it is. The compiler is ``$CXX``, or
``g++``. Nothing here runs at import time: the first ``load()`` builds what
is missing, and a failed build raises with the compiler's output. Nothing
carries on without the plane.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

from iinsvae_torch.ops.kernels._build import BUILD_DIR

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("batcher.cc", "server.cc")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
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
)

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
