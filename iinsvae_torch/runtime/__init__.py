"""The port's serving runtime: the request batcher, its native plane and the
unix-socket and TCP fronts (iinsvae_tpu/runtime/batcher.py). The native
plane (csrc/) is built with the host C++ compiler at first use."""

from iinsvae_torch.runtime.batcher import (
    BatchServer,
    SocketFront,
    TcpFront,
    serve_predictor,
    socket_client_request,
    socket_stats_request,
)

__all__ = ["BatchServer", "SocketFront", "TcpFront", "serve_predictor",
           "socket_client_request", "socket_stats_request"]
