"""The request batcher of the port's serving path (iinsvae_tpu/runtime/batcher.py).

``BatchServer`` sits between concurrent per-request clients and the compute
workers that drive ``serving.Predictor`` on the card: clients submit single
CIRs and block on their ticket; a worker pulls fixed-size batches — full
batches at once, partial batches once the oldest request is ``deadline_ms``
old — runs the compute function, and posts per-ticket results. The queueing
and wakeup plane is native C++ (csrc/batcher.cc, built by native.py);
``SocketFront`` and ``TcpFront`` (csrc/server.cc) put a unix-socket or TCP
listener in front of it that speaks the JAX package's framed protocol, so
``socket_client_request`` and the JAX package's client of the same name talk
to servers of either package.

A waiter that gives up abandons its ticket: the slot of a posted result is
freed at once, that of a result still in flight when it is posted. A wait
that merely times out keeps its ticket, so the fronts wait in slices and
lose no row to a batch that takes longer than a slice.
"""

from __future__ import annotations

import ctypes
import logging
import os
import socket
import struct
import threading
import time

import numpy as np

from iinsvae_torch.runtime import native
from iinsvae_torch.runtime.native import i64, p_d, p_i64

log = logging.getLogger("iinsvae_torch.serving")

# stop() waits this long for a worker inside compute_fn before it leaks the
# native handle rather than free it under a live thread
_STOP_JOIN_S = 600.0
# sizeof(sockaddr_un.sun_path) on Linux: a longer path would be cut short
_SUN_PATH = 108


class _PyBatcher:
    """The native plane's contract in Python (a condition-variable slot
    table), for ``BatchServer(..., prefer_native=False)`` only."""

    def __init__(self, cir_len, batch_size, max_pending, deadline_ms, reclaim_grace_s):
        self.cir_len, self.batch_size = cir_len, batch_size
        self.deadline = deadline_ms / 1e3
        self.max_pending = max_pending
        self.cv = threading.Condition()
        self.pending = {}    # ticket -> cir
        self.in_flight = set()
        self.done = {}       # ticket -> (err, label[, extra])
        self.next_ticket = 0
        self.oldest = None
        self.shutdown = False
        self.arrivals = {}   # ticket -> submit time (queue-latency stats)
        self.done_at = {}    # ticket -> post time (grace-period reclaim)
        self.abandoned = set()
        # a posted result may only be stolen after this grace: its owner may
        # merely not have been scheduled yet (the native plane's reclaim grace)
        self.reclaim_grace_s = reclaim_grace_s
        # the native plane's counters, in iins_batcher_stats order
        self.st = dict(submitted=0, batches=0, full_batches=0, rows=0,
                       posted=0, reclaimed=0, wait_timeouts=0, queue_ns=0)

    def submit(self, cir):
        with self.cv:
            while (len(self.pending) + len(self.in_flight) + len(self.done) >= self.max_pending
                   and not self.shutdown):
                now = time.monotonic()
                stale = [t for t in self.done
                         if now - self.done_at.get(t, now) > self.reclaim_grace_s]
                if stale:
                    # grace expired: the owner died between submit and wait;
                    # drop its result so the ring cannot deadlock
                    t0 = min(stale)
                    self.done.pop(t0)
                    self.done_at.pop(t0, None)
                    self.st["reclaimed"] += 1
                    break
                self.cv.wait(0.1)
            if self.shutdown:
                return -1
            t = self.next_ticket
            self.next_ticket += 1
            self.pending[t] = np.array(cir, dtype=np.float64)
            self.arrivals[t] = time.monotonic()
            if self.oldest is None:
                self.oldest = self.arrivals[t]
            self.st["submitted"] += 1
            self.cv.notify_all()
            return t

    def next_batch(self, wait_s):
        with self.cv:
            overall = time.monotonic() + wait_s
            while not self.shutdown:
                if len(self.pending) >= self.batch_size:
                    break
                if self.pending:
                    until = min(self.oldest + self.deadline, overall)
                    if time.monotonic() >= until:
                        break
                    self.cv.wait(until - time.monotonic())
                else:
                    if time.monotonic() >= overall:
                        return [], np.zeros((0, self.cir_len))
                    self.cv.wait(overall - time.monotonic())
            if self.shutdown:
                return None, None
            ts = sorted(self.pending)[: self.batch_size]
            cirs = np.stack([self.pending.pop(t) for t in ts])
            self.in_flight.update(ts)
            now = time.monotonic()
            self.st["batches"] += 1
            self.st["full_batches"] += len(ts) == self.batch_size
            self.st["rows"] += len(ts)
            self.st["queue_ns"] += int(sum((now - self.arrivals.pop(t)) * 1e9 for t in ts))
            self.oldest = now if self.pending else None
            return ts, cirs

    def post(self, tickets, err, label, extra=None):
        with self.cv:
            for i, (t, e, c) in enumerate(zip(tickets, err, label)):
                t = int(t)
                self.in_flight.discard(t)
                if t in self.abandoned:
                    # the owner gave up: free the slot instead of parking a
                    # result nobody will collect
                    self.abandoned.discard(t)
                    self.st["reclaimed"] += 1
                    continue
                self.done[t] = ((float(e), int(c)) if extra is None
                                else (float(e), int(c), np.array(extra[i])))
                self.done_at[t] = time.monotonic()
                self.st["posted"] += 1
            self.cv.notify_all()

    def wait(self, ticket, wait_s):
        """The ticket's result, or None at the timeout (the ticket stays
        live) or on shutdown."""
        with self.cv:
            until = time.monotonic() + wait_s
            while ticket not in self.done and not self.shutdown:
                left = until - time.monotonic()
                if left <= 0:
                    return None
                self.cv.wait(left)
            if self.shutdown:
                return None
            res = self.done.pop(ticket)
            self.done_at.pop(ticket, None)
            self.cv.notify_all()
            return res

    def abandon(self, ticket):
        with self.cv:
            if ticket in self.done:
                self.done.pop(ticket)
                self.done_at.pop(ticket, None)
                self.st["reclaimed"] += 1
                self.cv.notify_all()
            elif (ticket in self.pending or ticket in self.in_flight) \
                    and ticket not in self.abandoned:
                self.abandoned.add(ticket)
            else:
                return
            self.st["wait_timeouts"] += 1

    def stop(self):
        with self.cv:
            self.shutdown = True
            self.cv.notify_all()


def _derive_stats(buf) -> dict:
    """9-counter snapshot (iins_batcher_stats order) -> the stats dict."""
    raw = dict(submitted=int(buf[0]), batches=int(buf[1]),
               full_batches=int(buf[2]), rows_dispatched=int(buf[3]),
               rows_posted=int(buf[4]), reclaimed=int(buf[5]),
               wait_timeouts=int(buf[6]), pending=int(buf[8]))
    queue_ns = int(buf[7])
    raw["mean_occupancy"] = raw["rows_dispatched"] / raw["batches"] if raw["batches"] else 0.0
    raw["mean_queue_ms"] = (queue_ns / raw["rows_dispatched"] / 1e6
                            if raw["rows_dispatched"] else 0.0)
    return raw


class BatchServer:
    """compute_fn: (B, cir_len) float64 -> (err (B,), label (B,)), or, with
    ``n_extra > 0``, (err (B,), label (B,), extra (B, n_extra)) for a richer
    payload (env-class probabilities, reconstructed CIR). A worker thread
    pulls batches from the plane and posts results; ``submit`` is
    thread-safe and blocks until this request's result lands. Use as a
    context manager: ``stop()`` joins the workers before the native handle
    is destroyed.

    ``compute_fn`` may be a list: one worker thread for each, all pulling
    from the same queue.

    The plane is native (``native.load()`` builds it, and a failed build
    raises); ``prefer_native=False`` asks for the Python plane instead."""

    def __init__(self, compute_fn, cir_len: int, batch_size: int = 64,
                 max_pending: int = 1024, deadline_ms: float = 5.0,
                 prefer_native: bool = True, n_extra: int = 0,
                 reclaim_grace_s: float = 60.0):
        fns = list(compute_fn) if isinstance(compute_fn, (list, tuple)) else [compute_fn]
        if not fns:
            raise ValueError("BatchServer needs at least one compute_fn")
        self._compute_fns = fns
        self.cir_len, self.batch_size, self.n_extra = cir_len, batch_size, n_extra
        self._lib, self._h, self._py = None, None, None
        if prefer_native:
            self._lib = native.load()
            self._h = ctypes.c_void_p(self._lib.iins_batcher_create(
                cir_len, n_extra, batch_size, max_pending, deadline_ms))
            if not self._h:
                raise ValueError("iins_batcher_create rejected the configuration "
                                 f"(cir_len {cir_len}, n_extra {n_extra}, batch_size "
                                 f"{batch_size}, max_pending {max_pending})")
            self._lib.iins_batcher_set_reclaim_grace_ms(self._h, reclaim_grace_s * 1e3)
        else:
            self._py = _PyBatcher(cir_len, batch_size, max_pending, deadline_ms, reclaim_grace_s)
        self._stop = threading.Event()
        self._workers = [threading.Thread(target=self._run, args=(fn,), daemon=True)
                         for fn in fns]
        for w in self._workers:
            w.start()

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def workers(self) -> int:
        return len(self._workers)

    def _run(self, compute_fn):
        bs, length = self.batch_size, self.cir_len
        cir_buf = np.empty((bs, length), dtype=np.float64)
        tik_buf = np.empty(bs, dtype=np.int64)
        while not self._stop.is_set():
            if self._h is not None:
                n = self._lib.iins_batcher_next_batch(
                    self._h, cir_buf.ctypes.data_as(p_d), tik_buf.ctypes.data_as(p_i64), 50.0)
                if n <= 0:
                    continue
                ts, cirs = tik_buf[:n].copy(), cir_buf[:n]
            else:
                ts, cirs = self._py.next_batch(0.05)
                if ts is None or not len(ts):
                    continue
                ts = np.asarray(ts, dtype=np.int64)
            try:
                out = compute_fn(cirs)
                err = np.ascontiguousarray(np.asarray(out[0], np.float64).reshape(-1))
                label = np.ascontiguousarray(np.asarray(out[1], np.int64).reshape(-1))
                extra = None
                if self.n_extra:
                    extra = np.ascontiguousarray(
                        np.asarray(out[2], np.float64).reshape(len(ts), self.n_extra))
            except Exception:  # noqa: BLE001 - the worker must outlive a failed batch
                # post honest failure rows (err NaN, label -1) so the batch's
                # clients unblock now instead of timing out, and keep serving
                log.exception("compute_fn failed for a %d-row batch; posting NaN "
                              "failure rows and continuing", len(ts))
                err = np.full(len(ts), np.nan)
                label = np.full(len(ts), -1, dtype=np.int64)
                extra = np.full((len(ts), self.n_extra), np.nan) if self.n_extra else None
            if self._h is not None:
                self._lib.iins_batcher_post(
                    self._h, ts.ctypes.data_as(p_i64), err.ctypes.data_as(p_d),
                    label.ctypes.data_as(p_i64),
                    extra.ctypes.data_as(p_d) if extra is not None else None, len(ts))
            else:
                self._py.post(ts, err, label, extra)

    def submit(self, cir: np.ndarray, timeout_s: float = 30.0):
        """One request: (err_est, env_label), plus the (n_extra,) payload row
        as a third element when n_extra > 0, or None on timeout (the ticket
        is then abandoned). A compute_fn failure for this request's batch
        comes back as (NaN, -1)."""
        cir = np.ascontiguousarray(cir, dtype=np.float64).reshape(-1)
        if cir.shape[0] != self.cir_len:
            raise ValueError(f"a request holds {self.cir_len} taps, got {cir.shape[0]}")
        if self._h is None:
            t = self._py.submit(cir)
            if t < 0:
                return None
            res = self._py.wait(t, timeout_s)
            if res is None:
                self._py.abandon(t)
            return res
        t = self._lib.iins_batcher_submit(self._h, cir.ctypes.data_as(p_d))
        if t < 0:
            return None
        err, label = ctypes.c_double(0.0), i64(-1)
        extra = np.zeros(self.n_extra, dtype=np.float64)
        rc = self._lib.iins_batcher_wait(
            self._h, t, ctypes.byref(err), ctypes.byref(label),
            extra.ctypes.data_as(p_d) if self.n_extra else None, timeout_s * 1e3)
        if rc == 0:
            self._lib.iins_batcher_abandon(self._h, t)
        if rc != 1:
            return None
        return (err.value, label.value, extra) if self.n_extra else (err.value, label.value)

    def pending(self) -> int:
        if self._h is not None:
            return int(self._lib.iins_batcher_pending(self._h))
        with self._py.cv:
            return len(self._py.pending)

    def stats(self) -> dict:
        """One consistent snapshot of the serving counters, the same on both
        planes: submitted / batches / full_batches / rows_dispatched /
        rows_posted / reclaimed / wait_timeouts (tickets abandoned by their
        waiter) / pending, and the derived mean_occupancy (rows a dispatched
        batch) and mean_queue_ms (submit to dispatch)."""
        if self._h is not None:
            buf = np.zeros(9, dtype=np.int64)
            self._lib.iins_batcher_stats(self._h, buf.ctypes.data_as(p_i64))
            return _derive_stats(buf)
        with self._py.cv:
            st = dict(self._py.st)
            pending = len(self._py.pending)
        return _derive_stats([st["submitted"], st["batches"], st["full_batches"], st["rows"],
                              st["posted"], st["reclaimed"], st["wait_timeouts"],
                              st["queue_ns"], pending])

    def stop(self):
        self._stop.set()
        if self._py is not None:
            self._py.stop()
        # workers leave within one next_batch slice (50 ms) unless one is
        # inside compute_fn; freeing the native handle under a live worker
        # would be a use-after-free in post, so wait it out, and leak the
        # handle if the compute hangs
        t0 = time.monotonic()
        for w in self._workers:
            w.join(timeout=max(0.0, _STOP_JOIN_S - (time.monotonic() - t0)))
        if any(w.is_alive() for w in self._workers):
            log.error("a serving worker is still inside compute_fn after %.0f s; leaking the "
                      "native batcher handle instead of freeing it under a live thread",
                      _STOP_JOIN_S)
            self._h = None
            return
        if self._h is not None:
            h, self._h = self._h, None
            self._lib.iins_batcher_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class _Front:
    """A listener of csrc/server.cc in front of a native BatchServer. Its
    protocol bounds: ``max_request_rows`` caps the rows of a frame (default
    1 << 20; a larger, zero or negative header other than the stats op is
    rejected, counted and the connection closed) and ``recv_timeout_ms``
    bounds every read (default 5 min; a peer stalling mid-frame is
    disconnected)."""

    def __init__(self, server: BatchServer, what: str,
                 max_request_rows: int | None, recv_timeout_ms: int | None):
        if not server.native:
            raise RuntimeError(f"{type(self).__name__} requires the native batcher plane")
        self._lib = server._lib
        self._h = ctypes.c_void_p(self._start(server))
        if not self._h:
            raise OSError(f"{type(self).__name__}: could not listen on {what}")
        if max_request_rows is not None:
            self._lib.iins_server_set_max_rows(self._h, int(max_request_rows))
        if recv_timeout_ms is not None:
            self._lib.iins_server_set_recv_timeout_ms(self._h, int(recv_timeout_ms))

    def _start(self, server: BatchServer) -> int:
        raise NotImplementedError

    @property
    def rejected_frames(self) -> int:
        """Bad or oversized request headers rejected so far (also the 10th
        field of the wire stats op, socket_stats_request)."""
        return int(self._lib.iins_server_rejected(self._h))

    def stop(self):
        if self._h:
            h, self._h = self._h, None
            self._lib.iins_server_stop(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class SocketFront(_Front):
    """Unix-socket listener: clients connect to ``sock_path`` and speak the
    framed protocol ([int64 n][n x cir_len f64] -> n x [f64 err, int64
    label, n_extra f64]); their rows share batches with in-process submits."""

    def __init__(self, server: BatchServer, sock_path: str,
                 max_request_rows: int | None = None, recv_timeout_ms: int | None = None):
        if len(os.fsencode(sock_path)) >= _SUN_PATH:
            raise ValueError(f"a unix socket path holds at most {_SUN_PATH - 1} bytes, got "
                             f"{len(os.fsencode(sock_path))}: {sock_path}")
        self.sock_path = sock_path
        super().__init__(server, sock_path, max_request_rows, recv_timeout_ms)

    def _start(self, server: BatchServer) -> int:
        return self._lib.iins_server_start(server._h, self.sock_path.encode(), server.cir_len)


class TcpFront(_Front):
    """TCP listener with the SocketFront protocol. ``port=0`` binds an
    ephemeral port; read the bound one from ``.port``. It binds all
    interfaces: put TLS termination in front of it on untrusted networks."""

    def __init__(self, server: BatchServer, port: int = 0,
                 max_request_rows: int | None = None, recv_timeout_ms: int | None = None):
        self.port = port
        super().__init__(server, f"tcp port {port}", max_request_rows, recv_timeout_ms)
        self.port = int(self._lib.iins_server_port(self._h))

    def _start(self, server: BatchServer) -> int:
        return self._lib.iins_server_start_tcp(server._h, self.port, server.cir_len)


def _recv_exactly(s: socket.socket, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise IOError(f"server closed mid-{what}")
        buf += chunk
    return bytes(buf)


def _connect(addr, timeout_s: float) -> socket.socket:
    family = socket.AF_UNIX if isinstance(addr, str) else socket.AF_INET
    s = socket.socket(family, socket.SOCK_STREAM)
    try:
        s.settimeout(timeout_s)
        s.connect(addr)
    except OSError:
        s.close()
        raise
    return s


def socket_client_request(addr, cirs: np.ndarray, timeout_s: float = 60.0, n_extra: int = 0):
    """Client half of the listener protocol: (n, L) CIRs -> (err (n,),
    label (n,)), plus extra (n, n_extra) when the server carries a richer
    payload. ``addr``: a unix-socket path (str) or a (host, port) tuple for a
    TcpFront. One connection a call. Rows the server could not compute
    (shutdown, compute failure, per-ticket timeout) come back as err NaN,
    label -1."""
    cirs = np.ascontiguousarray(cirs, dtype=np.float64)
    n = cirs.shape[0]
    with _connect(addr, timeout_s) as s:
        s.sendall(struct.pack("<q", n) + cirs.tobytes())
        buf = _recv_exactly(s, n * (16 + 8 * n_extra), "response")
    rec = np.frombuffer(buf, dtype=[("err", "<f8"), ("label", "<i8"),
                                    ("extra", "<f8", (n_extra,))])
    if n_extra:
        return rec["err"].copy(), rec["label"].copy(), rec["extra"].copy()
    return rec["err"].copy(), rec["label"].copy()


def socket_stats_request(addr, timeout_s: float = 10.0) -> dict:
    """A front's counters over the wire (header n = -1; the response is the
    9 batcher int64s and the server's rejected_frames): the dict of
    ``BatchServer.stats()`` plus ``rejected_frames``."""
    with _connect(addr, timeout_s) as s:
        s.sendall(struct.pack("<q", -1))
        raw = np.frombuffer(_recv_exactly(s, 10 * 8, "stats response"), dtype="<i8")
    out = _derive_stats(raw[:9])
    out["rejected_frames"] = int(raw[9])
    return out


def serve_predictor(predictor, with_probs: bool = False, with_recon: bool = False,
                    **kw) -> BatchServer:
    """A BatchServer over a ``serving.Predictor``: one forward a pulled batch
    (padded to the predictor's batch size), the plane's float64 rows handed
    to it as float32. ``cir_len`` defaults to the model's. ``predictor`` may
    be a list of Predictors: one worker thread each, pulling from the shared
    queue.

    with_probs appends the env-class probabilities to every result,
    with_recon the reconstructed CIR (it needs Predictor(return_recon=True)):
    a result row is (err, label, [probs...][recon...])."""
    predictors = list(predictor) if isinstance(predictor, (list, tuple)) else [predictor]
    first = predictors[0]
    cir_len = kw.pop("cir_len", None) or int(first.model.cir_len)
    n_extra = 0
    if with_probs:
        n_extra += int(first.model.num_classes)
    if with_recon:
        if not all(p.return_recon for p in predictors):
            raise ValueError("with_recon needs Predictor(return_recon=True)")
        n_extra += cir_len

    def make_compute(p):
        def compute(cirs: np.ndarray):
            pred = p(cirs.astype(np.float32))
            err, label = pred.err_est.reshape(-1), pred.label.reshape(-1)
            if not n_extra:
                return err, label
            parts = ([pred.label_probs] if with_probs else []) + (
                [pred.recon] if with_recon else [])
            return err, label, np.concatenate(parts, axis=1)
        return compute

    return BatchServer([make_compute(p) for p in predictors], cir_len=cir_len,
                       batch_size=kw.pop("batch_size", first.batch_size), n_extra=n_extra, **kw)
