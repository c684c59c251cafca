"""Build the CUDA sources in csrc/ with nvcc and bind them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/iinsvae_torch/<name>-<hash>.so`` under the repository root,
where the hash covers the source, the shared headers (``csrc/*.cuh``) and
the nvcc flags: a changed source is rebuilt, an unchanged one is loaded as
it is. ``build_all`` starts one nvcc
per missing library, all at once, and waits for them. Nothing here runs at
import time; the first launch of a kernel builds what is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "iinsvae_torch"
SOURCES = ("in_chain", "strided_conv", "mlp_chain", "sln_chain", "res_block_2d", "sln_layer",
           "in_chain_bwd", "conv_bias_act_bwd", "strided_conv_bwd", "mlp_chain_bwd",
           "sln_chain_bwd", "res_block_2d_bwd", "sln_layer_bwd", "res_block_2d_bf16",
           "res_block_2d_bf16_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "kernels are built on the machine with the card")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, str]:
    """Build every missing library, one nvcc each, in parallel.

    Returns nvcc's output (with ``-Xptxas -v`` in ``extra_flags``, the
    register and shared-memory report) for each library it built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (p, tmp, out) in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({p.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def function(lib_name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``fn_name`` of library ``lib_name``, built if needed,
    with its argument types declared and an int (cudaError_t) result."""
    fn = _fns.get((lib_name, fn_name))
    if fn is not None:
        return fn
    with _lock:
        lib = _libs.get(lib_name)
        if lib is None:
            path = library_path(lib_name)
            if not path.exists():
                build_all()
            lib = _libs[lib_name] = ctypes.CDLL(str(path))
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn


def check(err: int, lib_name: str, what: str) -> None:
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        fn = _libs[lib_name].iins_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {fn(err).decode()}")


def require_cuda(what: str, dtype: torch.dtype, *tensors: torch.Tensor) -> None:
    """A kernel takes contiguous tensors of one dtype (float32, or bfloat16 for the bfloat16
    instances) on one CUDA device."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: float32 or bfloat16 tensors only, got {dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: every tensor must be on {dev} (CUDA), got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: {str(dtype)[6:]} tensors only, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def require_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """The float32 kernels take contiguous float32 tensors on one CUDA device."""
    require_cuda(what, torch.float32, *tensors)


# a grid of about two blocks per SM on the H100's 132 SMs
_TARGET_BLOCKS = 264
_MAX_SMEM = 48 * 1024


def samples_per_block(batch: int, floats_per_sample: int) -> int:
    """Samples a block stages in shared memory: enough blocks to fill the
    card, and never more shared memory than a block gets by default."""
    cap = _MAX_SMEM // (4 * floats_per_sample)
    if cap < 1:
        raise ValueError(
            f"one sample needs {4 * floats_per_sample} bytes of shared memory, "
            f"over the {_MAX_SMEM} a block gets")
    return max(1, min(cap, -(-batch // _TARGET_BLOCKS)))


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
