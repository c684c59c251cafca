"""The memory-mapped binary cache of an assembled split (iinsvae_tpu/runtime/cache.py).

After the first load and split, the split's arrays are written once to one aligned binary
file by the native plane (csrc/io.cc ``iins_cache_*``); later runs mmap it: no parse, pages
fault in on first touch. The key covers the source file's (size, mtime) and the split's
parameters, so a changed dataset or config misses. The file's layout is the JAX package's
byte for byte, so a cache written by either package reads in the other. There is no
fallback: the native plane is built at first use, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os

import numpy as np

from iinsvae_torch.runtime import native

_DTYPES = {0: np.float32, 1: np.float64, 2: np.int64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int64): 2}


def cache_key(source_path: str, **params) -> str:
    """The cache's file name: the source's (path, size, mtime), or its path where it does
    not exist, and the parameters."""
    try:
        st = os.stat(source_path)
        ident = f"{source_path}:{st.st_size}:{st.st_mtime_ns}"
    except OSError:
        ident = source_path
    blob = ident + "|" + "|".join(f"{k}={params[k]}" for k in sorted(params))
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def write_cache(path: str, arrays: dict[str, np.ndarray]) -> bool:
    """Write ``arrays`` (1-4 dimensions, names of at most 15 bytes; any dtype but float32,
    float64 and int64 stored as float64) to ``path`` atomically. -> whether it was written."""
    lib = native.load()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    norm = {}
    for k, v in arrays.items():
        a = np.ascontiguousarray(v)
        if a.dtype not in _DTYPE_CODES:
            a = a.astype(np.float64)
        if not (1 <= a.ndim <= 4 and len(k.encode()) <= 15):
            raise ValueError(f"cache array {k!r} of shape {a.shape}: 1-4 dimensions and a name "
                             "of at most 15 bytes")
        norm[k] = a
    n = len(norm)
    names = (ctypes.c_char_p * n)(*[k.encode() for k in norm])
    dtypes = np.array([_DTYPE_CODES[a.dtype] for a in norm.values()], np.int64)
    ndims = np.array([a.ndim for a in norm.values()], np.int64)
    dims = np.ones((n, 4), np.int64)
    for i, a in enumerate(norm.values()):
        dims[i, : a.ndim] = a.shape
    datas = (ctypes.c_void_p * n)(*[a.ctypes.data for a in norm.values()])
    rc = lib.iins_cache_write(str(path).encode(), n, names, dtypes.ctypes.data_as(native.p_i64),
                              ndims.ctypes.data_as(native.p_i64),
                              dims.ctypes.data_as(native.p_i64), datas)
    return rc == 0


class _MappedCache:
    """Keeps the mapping alive as long as any array read from it is."""

    def __init__(self, lib, handle):
        self._lib, self._handle = lib, handle

    def __del__(self):
        if self._handle:
            self._lib.iins_cache_close(self._handle)
            self._handle = None


def read_cache(path: str) -> dict[str, np.ndarray] | None:
    """mmap ``path`` -> {name: read-only array viewing the mapping}, or None on a miss (no
    file, a bad magic, a record out of bounds: the plane validates the header at open, and
    any other surprise in a record is a miss too, so the caller rebuilds)."""
    if not os.path.isfile(path):
        return None
    lib = native.load()
    handle = lib.iins_cache_open(str(path).encode())
    if not handle:
        return None
    owner = _MappedCache(lib, handle)
    out = {}
    try:
        for i in range(lib.iins_cache_count(handle)):
            name = ctypes.create_string_buffer(16)
            dtype, ndim, dims = native.i64(), native.i64(), (ctypes.c_int64 * 4)()
            ptr = lib.iins_cache_array(handle, i, name, ctypes.byref(dtype),
                                       ctypes.byref(ndim), dims)
            if not ptr:
                return None
            np_dtype = np.dtype(_DTYPES[dtype.value])
            shape = tuple(dims[d] for d in range(ndim.value))
            count = int(np.prod(shape))
            buf = (ctypes.c_char * max(count * np_dtype.itemsize, 1)).from_address(ptr)
            buf._iins_cache_owner = owner  # the mapping lives as long as the buffer
            arr = np.frombuffer(buf, dtype=np_dtype, count=count).reshape(shape)
            arr.flags.writeable = False
            out[name.value.decode()] = arr
    except (KeyError, UnicodeDecodeError, ValueError):
        return None
    return out
