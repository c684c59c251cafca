"""The device kernels one call launches, read from a CUDA graph of the call.

A torch.profiler trace names the kernels a call ran, but on the card it now
and then holds no device event at all, so a check of the kernel a wrapper
launches could fail with that kernel in place. Here the call is captured in
a CUDA graph instead: the CUDA driver lists the kernel nodes of the graph being
captured and names each node's function (cuStreamGetCaptureInfo,
cuGraphGetNodes, cuGraphKernelNodeGetParams, cuFuncGetName or
cuKernelGetName, demangled by the C++ runtime's __cxa_demangle), and the
graph is then replayed once and its outputs held bit-equal to an eager
call's, so the named kernels are the ones that computed the outputs the
caller gets. Nothing here depends on CUPTI. A check, not a part of any model
path: used by tests/test_torch_gpu.py and chip_smoke.py; it runs only where
a CUDA driver is.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Callable

import torch

_KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL
_CAPTURING = 1  # CU_STREAM_CAPTURE_STATUS_ACTIVE


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_libs: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(name)
    return _libs[name]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA driver error {err}")


def demangle(name: str) -> str:
    """An Itanium C++ name as the C++ runtime demangles it (unchanged if it is not one)."""
    fn = _lib("libstdc++.so.6").__cxa_demangle
    fn.restype = ctypes.c_void_p
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    status = ctypes.c_int(0)
    p = fn(name.encode(), None, None, ctypes.byref(status))
    if status.value != 0 or not p:
        return name
    try:
        return ctypes.string_at(p).decode()
    finally:
        free = _lib("libc.so.6").free
        free.argtypes = [ctypes.c_void_p]
        free(p)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, the anonymous namespace, template arguments and
    parameters: ``res::res_block_kernel``."""
    name = demangle(name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", re.sub(r"^void ", "", name))[0]


def _captured_kernels(stream: int) -> dict[str, int]:
    """The kernel nodes of the graph that ``stream`` is capturing, by short name and count."""
    cu = _lib("libcuda.so.1")
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    deps, n_deps, cid = ctypes.c_void_p(), ctypes.c_size_t(0), ctypes.c_uint64(0)
    _check(cu.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream), ctypes.byref(status),
                                        ctypes.byref(cid), ctypes.byref(graph),
                                        ctypes.byref(deps), ctypes.byref(n_deps)),
           "cuStreamGetCaptureInfo")
    if status.value != _CAPTURING:
        raise RuntimeError("the stream is not capturing a graph")
    n = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    _check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    out: dict[str, int] = {}
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        _check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            continue
        params = _KernelNodeParams()
        _check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                   "cuFuncGetName")
        else:
            _check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                   "cuKernelGetName")
        k = short_name(name.value.decode())
        out[k] = out.get(k, 0) + 1
    return out


def _flat(out) -> list[torch.Tensor]:
    if torch.is_tensor(out):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return []


def launched_kernels(fn: Callable) -> dict[str, int]:
    """-> the device kernels one call of ``fn`` launches, by short name and count. ``fn`` runs
    once on a side stream first (its first call may build its library and raise its
    shared-memory limit, which a capture must not see); then one call is captured in a CUDA
    graph, the graph's kernel nodes named and the graph replayed once. The replay's outputs
    (its tensors, nested in lists and tuples) must be bit-equal to an eager call's, so that the
    named kernels are the ones that computed what the caller gets: AssertionError if not."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
        names = _captured_kernels(torch.cuda.current_stream().cuda_stream)
    graph.replay()
    torch.cuda.synchronize()
    replayed = [t.clone() for t in _flat(out)]
    torch.cuda.synchronize()
    del graph
    eager = _flat(fn())
    if len(replayed) != len(eager) or not all(torch.equal(a, b) for a, b in zip(replayed, eager)):
        raise AssertionError("a CUDA graph of the call gives other outputs than an eager call")
    return names


_GLOBAL = re.compile(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")


def port_kernels(launched: dict[str, int]) -> dict[str, int]:
    """The port's own kernels among ``launched`` (launched_kernels' names and counts): those
    whose name's last part is a ``__global__`` function of the CUDA sources beside this file;
    the rest are PyTorch's, the plain ops'."""
    csrc = Path(__file__).resolve().parent / "csrc"
    own = {n for f in csrc.glob("*.cu*") for n in _GLOBAL.findall(f.read_text())}
    return {k: v for k, v in launched.items()
            if k.split("::")[-1] in own and not k.startswith("at::")}
