"""The port's unix-socket and TCP fronts (iinsvae_torch/runtime/csrc/server.cc):
the server cases of tests/test_robustness.py, the wire protocol against the
JAX package's clients and front, the two faults of the JAX package's plane
the port's copy fixes, the build of the native plane, and the runtime with
JAX and the JAX package blocked.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from iinsvae_tpu.runtime import batcher as jax_batcher
from iinsvae_torch.runtime.batcher import (BatchServer, SocketFront, TcpFront,
                                           socket_client_request, socket_stats_request)

L = 16
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compute(cirs: np.ndarray):
    return cirs.mean(axis=1), np.round(cirs[:, 0]).astype(np.int64)


def _compute_extra(cirs: np.ndarray):
    err, label = _compute(cirs)
    return err, label, np.stack([cirs.mean(axis=1), cirs[:, 0], cirs[:, 1]], axis=1)


def _well_formed_roundtrip(addr, value: float = 3.0):
    err, label = socket_client_request(addr, np.full((2, L), value), timeout_s=20.0)
    np.testing.assert_allclose(err, value)
    assert (label == round(value)).all()


def _raw_send(sock_path, payload: bytes, expect_close: bool = True):
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(10.0)
        s.connect(sock_path)
        s.sendall(payload)
        if expect_close:
            assert s.recv(1) == b"", "the server should close on a bad header"


def _frames(n: int, seed: int) -> np.ndarray:
    cirs = np.random.default_rng(seed).normal(size=(n, L))
    cirs[:, 0] = np.arange(n) % 5
    return cirs


@pytest.fixture
def sock(tmp_path):
    return str(tmp_path / "iins.sock")


def test_server_rejects_malformed_headers(sock):
    """Zero, negative and absurd row counts close the connection without
    wedging the server; well-formed traffic keeps working after."""
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock):
        for bad_n in (0, -5, 1 << 30, -(1 << 60)):
            _raw_send(sock, struct.pack("<q", bad_n))
            _well_formed_roundtrip(sock)


def test_server_survives_disconnect_mid_request(sock):
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock):
        row = np.full(L, 1.0).tobytes()
        # a header for 4 rows, 1.5 rows delivered, hang up
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock)
            s.sendall(struct.pack("<q", 4) + row + row[: len(row) // 2])
        # half a header, hang up
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.connect(sock)
            s.sendall(b"\x02\x00\x00")
        _well_formed_roundtrip(sock)
        _well_formed_roundtrip(sock)


def test_server_counts_rejected_frames_and_enforces_max_rows(sock):
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock, max_request_rows=4) as front:
        _raw_send(sock, struct.pack("<q", 5))            # over the cap
        _raw_send(sock, struct.pack("<q", 0))            # zero
        _raw_send(sock, struct.pack("<q", -(1 << 40)))   # garbage negative
        _well_formed_roundtrip(sock)
        assert front.rejected_frames == 3
        assert socket_stats_request(sock)["rejected_frames"] == 3


def test_server_random_bytes_fuzz(sock):
    """Random bytes on both fronts: the server neither hangs nor dies, and a
    well-formed request succeeds after every burst. Deterministic seed."""
    rng = np.random.default_rng(1234)
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock, recv_timeout_ms=500), \
            TcpFront(srv, 0, recv_timeout_ms=500) as tf:
        addrs = [sock, ("127.0.0.1", tf.port)]
        for trial in range(24):
            addr = addrs[trial % 2]
            family = socket.AF_UNIX if isinstance(addr, str) else socket.AF_INET
            with socket.socket(family, socket.SOCK_STREAM) as s:
                s.settimeout(10.0)
                s.connect(addr)
                s.sendall(rng.bytes(int(rng.integers(1, 2048))))
                # a random header can be a small positive n: the server may
                # answer NaN rows or close at the receive timeout; it may not hang
                s.settimeout(3.0)
                try:
                    while s.recv(4096):
                        pass
                except (socket.timeout, ConnectionError):
                    pass
        _well_formed_roundtrip(sock)
        _well_formed_roundtrip(addrs[1], 4.0)


def test_server_recv_timeout_frees_stalled_connection(sock):
    """A peer that sends a header and stalls is disconnected at the receive
    timeout instead of pinning a handler thread."""
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock, recv_timeout_ms=300):
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(30.0)
            s.connect(sock)
            s.sendall(struct.pack("<q", 2))  # promise 2 rows, send none
            t0 = time.monotonic()
            assert s.recv(1) == b""
            assert time.monotonic() - t0 < 20.0
        _well_formed_roundtrip(sock)


def test_socket_front_rejects_a_path_the_kernel_would_cut(tmp_path):
    with BatchServer(_compute, cir_len=L, batch_size=8) as srv:
        with pytest.raises(ValueError, match="at most 107 bytes"):
            SocketFront(srv, str(tmp_path / ("s" * 120)))


@pytest.mark.parametrize("n", [1, 7, 40])
@pytest.mark.parametrize("front", ["unix", "tcp"])
def test_jax_clients_and_the_ports_agree_on_the_ports_fronts(sock, front, n):
    """The JAX package's socket_client_request and socket_stats_request
    against the port's fronts give what the port's own client does."""
    cirs = _frames(n, seed=n)
    with BatchServer(_compute_extra, cir_len=L, batch_size=8, n_extra=3,
                     deadline_ms=2.0) as srv:
        f = SocketFront(srv, sock) if front == "unix" else TcpFront(srv, 0)
        with f:
            addr = sock if front == "unix" else ("127.0.0.1", f.port)
            ours = socket_client_request(addr, cirs, n_extra=3)
            theirs = jax_batcher.socket_client_request(addr, cirs, n_extra=3)
            st_ours, st_theirs = socket_stats_request(addr), jax_batcher.socket_stats_request(addr)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ours[0], cirs.mean(axis=1), rtol=1e-12)
    np.testing.assert_array_equal(ours[1], np.arange(n) % 5)
    np.testing.assert_allclose(ours[2][:, 1:], cirs[:, :2], rtol=1e-12)
    assert st_ours == st_theirs
    assert st_ours["submitted"] == st_ours["rows_posted"] == 2 * n


@pytest.mark.parametrize("n", [1, 7, 40])
def test_the_ports_client_on_the_jax_front(sock, n):
    cirs = _frames(n, seed=100 + n)
    with jax_batcher.BatchServer(_compute_extra, cir_len=L, batch_size=8, n_extra=3,
                                 deadline_ms=2.0) as srv:
        assert srv.native
        with jax_batcher.SocketFront(srv, sock):
            ours = socket_client_request(sock, cirs, n_extra=3)
            theirs = jax_batcher.socket_client_request(sock, cirs, n_extra=3)
            st = socket_stats_request(sock)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ours[0], cirs.mean(axis=1), rtol=1e-12)
    assert st["rows_posted"] == 2 * n and st["rejected_frames"] == 0


def test_a_batch_slower_than_a_wait_slice_loses_no_row(sock):
    """The fronts wait for a ticket in 250 ms slices. A compute that takes
    400 ms a batch (the first launch of a kernel builds it, which takes
    longer) still delivers every row computed: no NaN, no -1."""
    def slow(cirs):
        time.sleep(0.4)
        return _compute(cirs)

    cirs = _frames(6, seed=3)
    with BatchServer(slow, cir_len=L, batch_size=4, deadline_ms=2.0) as srv, \
            SocketFront(srv, sock):
        err, label = socket_client_request(sock, cirs, timeout_s=60.0)
        st = srv.stats()
    assert np.isfinite(err).all() and (label >= 0).all()
    np.testing.assert_allclose(err, cirs.mean(axis=1), rtol=1e-12)
    np.testing.assert_array_equal(label, np.arange(6) % 5)
    assert st["wait_timeouts"] == 0 and st["reclaimed"] == 0


def test_a_disconnect_frees_its_outstanding_tickets_at_once(sock):
    """Eight clients each leave a ticket behind (a header for two rows, one
    row sent, hang up) on a ring of 8 with a 60 s reclaim grace. Their
    slots are freed when their connections end, so a second client's
    request completes within 2 s instead of waiting out the grace."""
    row = np.full(L, 1.0).tobytes()
    with BatchServer(_compute, cir_len=L, batch_size=4, max_pending=8, deadline_ms=2.0,
                     reclaim_grace_s=60.0) as srv, SocketFront(srv, sock):
        for _ in range(8):
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.connect(sock)
                s.sendall(struct.pack("<q", 2) + row)
        deadline = time.monotonic() + 10.0
        while srv.stats()["reclaimed"] < 8 and time.monotonic() < deadline:
            time.sleep(0.01)
        t0 = time.monotonic()
        err, label = socket_client_request(sock, np.full((2, L), 3.0), timeout_s=2.0)
        assert time.monotonic() - t0 < 2.0
        st = srv.stats()
    np.testing.assert_allclose(err, 3.0)
    assert (label == 3).all()
    assert st["reclaimed"] == st["wait_timeouts"] == 8
    assert st["submitted"] == 10


def _python(code: str, env: dict | None = None) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": "", **(env or {})}
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_failed_build_raises_and_never_falls_back():
    r = _python(
        "from iinsvae_torch.runtime.batcher import BatchServer\n"
        "try:\n"
        "    BatchServer(lambda c: (c[:, 0], c[:, 0]), cir_len=4)\n"
        "except RuntimeError as e:\n"
        "    assert 'building the native serving plane failed' in str(e), e\n"
        "    print('raised')\n"
        "else:\n"
        "    raise SystemExit('a BatchServer came up without its native plane')\n",
        env={"CXX": "false"})
    assert r.returncode == 0, r.stderr
    assert "raised" in r.stdout


def test_the_runtime_serves_with_jax_and_the_jax_package_blocked(tmp_path):
    sock_path = str(tmp_path / "iso.sock")
    r = _python(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['iinsvae_tpu'] = None\n"
        "import numpy as np\n"
        "from iinsvae_torch.models.vae import IInsVAE\n"
        "from iinsvae_torch.serving import Predictor\n"
        "from iinsvae_torch.runtime import SocketFront, serve_predictor, socket_client_request\n"
        "p = Predictor(IInsVAE(style_dim=16), batch_size=4, return_recon=True, device='cpu')\n"
        "with serve_predictor(p, with_probs=True, with_recon=True) as srv, "
        f"SocketFront(srv, {sock_path!r}):\n"
        f"    err, label, extra = socket_client_request({sock_path!r}, np.zeros((3, 157)),\n"
        "                                              n_extra=5 + 157)\n"
        "assert np.isfinite(err).all() and (label >= 0).all() and extra.shape == (3, 162)\n"
        "print('isolated ok')\n")
    assert r.returncode == 0, r.stderr
    assert "isolated ok" in r.stdout
