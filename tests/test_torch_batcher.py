"""The port's request batcher (iinsvae_torch/runtime/batcher.py and its
native plane, runtime/csrc/batcher.cc): the cases of tests/test_batcher.py
on both planes, and ``serve_predictor`` over the port's CPU ``Predictor``
against the JAX ``Predictor`` on the same weights (an ``export_serving``
npz): fp32, rtol 5e-4 / atol 5e-5, identical labels
(tests/test_torch_serving.py).

The compute of the plane tests is a deterministic function of the CIR, so
every concurrent client can check that its result came back on its ticket.
"""

import ctypes
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.serving import Predictor as JaxPredictor
from iinsvae_torch.runtime import native
from iinsvae_torch.runtime.batcher import (BatchServer, SocketFront, TcpFront, serve_predictor,
                                           socket_client_request, socket_stats_request)
from iinsvae_torch.runtime.native import p_d, p_i64
from iinsvae_torch.serving import Predictor

L = 16
RTOL, ATOL = 5e-4, 5e-5
PLANES = pytest.mark.parametrize("prefer_native", [True, False], ids=["native", "python"])


def _compute(cirs: np.ndarray):
    # deterministic per-request signature: err = mean, label = round(row[0])
    return cirs.mean(axis=1), np.round(cirs[:, 0]).astype(np.int64)


def _compute_extra(cirs: np.ndarray):
    # a richer payload: three doubles derived from the request
    err, label = _compute(cirs)
    return err, label, np.stack([cirs.mean(axis=1), cirs[:, 0], cirs[:, 1]], axis=1)


def _run_threads(fn, n: int, timeout_s: float = 120.0) -> None:
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def _exercise(server: BatchServer, n_clients: int = 32):
    rng = np.random.default_rng(0)
    cirs = rng.normal(size=(n_clients, L))
    cirs[:, 0] = rng.integers(0, 5, n_clients)
    results = [None] * n_clients

    def client(i):
        # a generous timeout: this checks that every client gets its own
        # result, not latency, and a loaded machine can stall a thread
        results[i] = server.submit(cirs[i], timeout_s=300.0)

    _run_threads(client, n_clients)
    for i in range(n_clients):
        assert results[i] is not None, f"client {i} timed out"
        err, label = results[i]
        np.testing.assert_allclose(err, cirs[i].mean(), rtol=1e-12)
        assert label == int(round(cirs[i, 0]))


def _raw_submit(srv: BatchServer, cir: np.ndarray) -> int:
    cir = np.ascontiguousarray(cir, dtype=np.float64)
    if srv.native:
        return srv._lib.iins_batcher_submit(srv._h, cir.ctypes.data_as(p_d))
    return srv._py.submit(cir)


def _raw_wait(srv: BatchServer, ticket: int, timeout_s: float):
    """(err, label) of a ticket, or None at the timeout; the ticket is not
    abandoned."""
    if not srv.native:
        return srv._py.wait(ticket, timeout_s)
    err, label = ctypes.c_double(0.0), ctypes.c_int64(-1)
    rc = srv._lib.iins_batcher_wait(srv._h, ticket, ctypes.byref(err), ctypes.byref(label),
                                    None, timeout_s * 1e3)
    assert rc in (0, 1), rc
    return (err.value, label.value) if rc == 1 else None


def _wait_for(cond, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert cond()


@PLANES
def test_concurrent_clients_get_their_own_results(prefer_native):
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0,
                     prefer_native=prefer_native) as srv:
        assert srv.native == prefer_native
        _exercise(srv)


@PLANES
def test_stress_more_workers_and_clients_than_cores(prefer_native):
    """16 workers and 96 clients on a small ring with the interpreter
    switching threads every 10 us: every client gets its own result and
    the counters add up (a lost update in the plane's bookkeeping breaks
    one or the other)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchServer([_compute] * 16, cir_len=L, batch_size=4, max_pending=16,
                         deadline_ms=1.0, prefer_native=prefer_native) as srv:
            _exercise(srv, n_clients=96)
            st = srv.stats()
    finally:
        sys.setswitchinterval(old)
    assert st["submitted"] == st["rows_dispatched"] == st["rows_posted"] == 96
    assert st["pending"] == st["reclaimed"] == st["wait_timeouts"] == 0


def test_partial_batch_flushes_on_deadline():
    # a single request (< batch_size) must come back through the deadline flush
    with BatchServer(_compute, cir_len=L, batch_size=64, deadline_ms=20.0) as srv:
        t0 = time.monotonic()
        out = srv.submit(np.full(L, 2.0), timeout_s=60.0)
        assert out is not None and out[1] == 2
        np.testing.assert_allclose(out[0], 2.0)
        # a full-batch wait would hang to the submit timeout; loose bound for a loaded machine
        assert time.monotonic() - t0 < 30.0


def test_first_request_wakes_the_worker():
    """A worker asleep in a long next_batch wait takes a lone request
    deadline_ms after it arrives, not when its own wait ends: the submit
    of the first pending request wakes it."""
    lib = native.load()
    h = ctypes.c_void_p(lib.iins_batcher_create(L, 0, 64, 128, 5.0))
    try:
        cir_buf = np.empty((64, L))
        tik_buf = np.empty(64, dtype=np.int64)
        got = []

        def worker():
            t0 = time.monotonic()
            n = lib.iins_batcher_next_batch(h, cir_buf.ctypes.data_as(p_d),
                                            tik_buf.ctypes.data_as(p_i64), 20000.0)
            got.append((n, time.monotonic() - t0))

        th = threading.Thread(target=worker)
        th.start()
        time.sleep(0.2)  # the worker is inside its 20 s wait
        x = np.full(L, 1.0)
        t0 = time.monotonic()
        assert lib.iins_batcher_submit(h, x.ctypes.data_as(p_d)) == 0
        th.join(30.0)
        assert not th.is_alive()
        assert got[0][0] == 1
        assert got[0][1] < 10.0, f"the lone request waited {got[0][1]:.1f} s for the worker"
        assert time.monotonic() - t0 < 10.0
    finally:
        lib.iins_batcher_destroy(h)


def test_sequential_reuse_and_backpressure():
    # more requests than max_pending: slot reuse and back-pressure
    with BatchServer(_compute, cir_len=L, batch_size=4, max_pending=8, deadline_ms=2.0) as srv:
        for _ in range(4):
            _exercise(srv, n_clients=16)


def test_socket_front_end_to_end(tmp_path):
    sock = str(tmp_path / "iins.sock")
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock):
        outs = [None] * 6

        def client(i):
            cirs = np.random.default_rng(3 + i).normal(size=(4, L)) + i
            cirs[:, 0] = i
            outs[i] = (cirs, *socket_client_request(sock, cirs))

        _run_threads(client, 6)
        for i, (cirs, err, label) in enumerate(outs):
            np.testing.assert_allclose(err, cirs.mean(axis=1), rtol=1e-12)
            assert (label == i).all()
        # in-process submits keep working beside socket traffic
        out = srv.submit(np.full(L, 3.0))
        assert out is not None and out[1] == 3


@PLANES
def test_abandoned_results_are_reclaimed(prefer_native):
    """Results nobody waits for (their owner died between submit and wait)
    fill the ring; after the reclaim grace a submitter takes their slots
    instead of deadlocking."""
    with BatchServer(_compute, cir_len=L, batch_size=2, max_pending=4, deadline_ms=1.0,
                     prefer_native=prefer_native, reclaim_grace_s=0.2) as srv:
        for _ in range(4):
            assert _raw_submit(srv, np.zeros(L)) >= 0
        _wait_for(lambda: srv.stats()["rows_posted"] == 4)
        out = srv.submit(np.full(L, 4.0), timeout_s=10.0)
        assert out is not None
        np.testing.assert_allclose(out[0], 4.0)
        assert srv.stats()["reclaimed"] >= 1


@PLANES
def test_extras_payload_roundtrip(prefer_native):
    rng = np.random.default_rng(7)
    cirs = rng.normal(size=(24, L))
    cirs[:, 0] = rng.integers(0, 5, 24)
    with BatchServer(_compute_extra, cir_len=L, batch_size=8, n_extra=3, deadline_ms=5.0,
                     prefer_native=prefer_native) as srv:
        results = [None] * 24

        def client(i):
            results[i] = srv.submit(cirs[i])

        _run_threads(client, 24)
    for i, out in enumerate(results):
        assert out is not None and len(out) == 3
        err, label, extra = out
        np.testing.assert_allclose(err, cirs[i].mean(), rtol=1e-12)
        np.testing.assert_allclose(extra, [cirs[i].mean(), cirs[i, 0], cirs[i, 1]], rtol=1e-12)


def test_tcp_front_end_to_end():
    with BatchServer(_compute_extra, cir_len=L, batch_size=8, n_extra=3,
                     deadline_ms=5.0) as srv, TcpFront(srv, port=0) as front:
        assert front.port > 0
        outs = [None] * 4

        def client(i):
            cirs = np.random.default_rng(11 + i).normal(size=(5, L)) + i
            cirs[:, 0] = i
            outs[i] = (cirs, *socket_client_request(("127.0.0.1", front.port), cirs,
                                                    n_extra=3))

        _run_threads(client, 4)
        for i, (cirs, err, label, extra) in enumerate(outs):
            np.testing.assert_allclose(err, cirs.mean(axis=1), rtol=1e-12)
            assert (label == i).all()
            np.testing.assert_allclose(extra[:, 1:], cirs[:, :2], rtol=1e-12)
        out = srv.submit(np.full(L, 3.0))
        assert out is not None and out[1] == 3


def test_request_larger_than_ring(tmp_path):
    """One socket request with more rows than the ring streams through: the
    connection's handler drains its own tickets instead of wedging submit."""
    sock = str(tmp_path / "iins_big.sock")
    with BatchServer(_compute, cir_len=L, batch_size=8, max_pending=32,
                     deadline_ms=2.0) as srv, SocketFront(srv, sock):
        n = 100
        cirs = np.random.default_rng(7).normal(size=(n, L))
        cirs[:, 0] = np.arange(n) % 5
        err, label = socket_client_request(sock, cirs, timeout_s=120.0)
        np.testing.assert_allclose(err, cirs.mean(axis=1), rtol=1e-12)
        np.testing.assert_array_equal(label, np.arange(n) % 5)


def test_oversized_concurrent_requests(tmp_path):
    """Connections whose rows together exceed the ring share it without
    deadlock, each getting its own results back in order."""
    sock = str(tmp_path / "iins_many.sock")
    with BatchServer(_compute, cir_len=L, batch_size=8, max_pending=32,
                     deadline_ms=2.0) as srv, SocketFront(srv, sock):
        outs = [None] * 4

        def client(i):
            cirs = np.random.default_rng(11 + i).normal(size=(40, L))
            cirs[:, 0] = i
            outs[i] = (cirs, *socket_client_request(sock, cirs, timeout_s=120.0))

        _run_threads(client, 4)
        for i, (cirs, err, label) in enumerate(outs):
            np.testing.assert_allclose(err, cirs.mean(axis=1), rtol=1e-12)
            assert (label == i).all()


def test_compute_failure_posts_nan_and_recovers():
    """A compute_fn exception does not kill the worker: the batch's clients
    get failure rows (err NaN, label -1) at once, and the next batch is
    served."""
    calls = {"n": 0}

    def flaky(cirs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient backend failure")
        return _compute(cirs)

    with BatchServer(flaky, cir_len=L, batch_size=4, deadline_ms=5.0) as srv:
        bad = srv.submit(np.full(L, 2.0), timeout_s=10.0)
        assert bad is not None and np.isnan(bad[0]) and bad[1] == -1
        good = srv.submit(np.full(L, 2.0), timeout_s=10.0)
        assert good is not None and good[1] == 2
        np.testing.assert_allclose(good[0], 2.0, rtol=1e-12)


@PLANES
def test_stats_counters(prefer_native):
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0,
                     prefer_native=prefer_native) as srv:
        n = 32
        _exercise(srv, n_clients=n)
        st = srv.stats()
        assert st["submitted"] == st["rows_dispatched"] == st["rows_posted"] == n
        assert st["pending"] == 0
        assert 1 <= st["batches"] <= n
        assert st["full_batches"] <= st["batches"]
        assert st["mean_occupancy"] == pytest.approx(n / st["batches"])
        assert st["wait_timeouts"] == 0 and st["reclaimed"] == 0
        assert 0.0 < st["mean_queue_ms"] < 1000.0


@PLANES
def test_stats_sees_timeout_and_reclaim(prefer_native):
    """A submit that times out abandons its ticket: the worker's post frees
    the slot at once (a reclaim), and the next submit goes through."""
    ev = threading.Event()

    def slow_compute(cirs):
        ev.wait(2.0)  # outlive the client's wait below
        return _compute(cirs)

    with BatchServer(slow_compute, cir_len=L, batch_size=1, max_pending=1, deadline_ms=1.0,
                     prefer_native=prefer_native) as srv:
        assert srv.submit(np.zeros(L), timeout_s=0.05) is None
        ev.set()
        _wait_for(lambda: srv.stats()["reclaimed"] >= 1, 5.0)
        out = srv.submit(np.full(L, 3.0), timeout_s=10.0)
        assert out is not None and out[1] == 3
        st = srv.stats()
        assert (st["wait_timeouts"], st["reclaimed"], st["submitted"]) == (1, 1, 2)


@PLANES
def test_timed_out_wait_keeps_its_ticket(prefer_native):
    """A wait that times out gives up nothing: a later wait on the same
    ticket collects the result (the fronts wait in slices)."""
    ev = threading.Event()

    def gated(cirs):
        ev.wait(30.0)
        return _compute(cirs)

    with BatchServer(gated, cir_len=L, batch_size=1, max_pending=2, deadline_ms=1.0,
                     prefer_native=prefer_native) as srv:
        t = _raw_submit(srv, np.full(L, 4.0))
        assert _raw_wait(srv, t, 0.05) is None
        ev.set()
        got = _raw_wait(srv, t, 10.0)
        assert got is not None and got[1] == 4
        np.testing.assert_allclose(got[0], 4.0)
        st = srv.stats()
        assert (st["wait_timeouts"], st["reclaimed"], st["rows_posted"]) == (0, 0, 1)


def test_socket_stats_query(tmp_path):
    sock = str(tmp_path / "iins_stats.sock")
    with BatchServer(_compute, cir_len=L, batch_size=8, deadline_ms=5.0) as srv, \
            SocketFront(srv, sock):
        cirs = np.random.default_rng(3).normal(size=(12, L))
        err, _ = socket_client_request(sock, cirs)
        assert np.isfinite(err).all()
        st = socket_stats_request(sock)
        assert st["submitted"] == st["rows_posted"] == 12
        # the wire stats: the in-process stats and the front's rejected frames
        assert st.pop("rejected_frames") == 0
        assert st == srv.stats()
        err2, _ = socket_client_request(sock, cirs[:3])
        assert np.isfinite(err2).all()


@PLANES
def test_multi_worker_pulls_concurrently(prefer_native):
    """Two workers are inside compute at once: each waits on a two-party
    barrier, which breaks at its timeout unless the other worker pulled the
    second batch meanwhile. The deadline is far away, so the 8 requests form
    exactly two full batches of 4, whatever the machine's load."""
    barrier = threading.Barrier(2)
    broken = []

    def fn(cirs):
        try:
            barrier.wait(timeout=30.0)
        except threading.BrokenBarrierError:
            broken.append(len(cirs))
        return _compute(cirs)

    rng = np.random.default_rng(5)
    cirs = rng.normal(size=(8, L))
    cirs[:, 0] = rng.integers(0, 5, 8)
    results = [None] * 8
    with BatchServer([fn, fn], cir_len=L, batch_size=4, deadline_ms=60000.0,
                     prefer_native=prefer_native) as srv:
        assert srv.workers == 2

        def client(i):
            results[i] = srv.submit(cirs[i], timeout_s=60.0)

        _run_threads(client, 8)
        st = srv.stats()
    assert not broken, "the two workers never overlapped in compute"
    assert (st["batches"], st["full_batches"]) == (2, 2)
    for i in range(8):
        assert results[i] is not None
        np.testing.assert_allclose(results[i][0], cirs[i].mean(), rtol=1e-12)
        assert results[i][1] == int(round(cirs[i, 0]))


@PLANES
def test_slow_collector_keeps_its_result(prefer_native):
    """A client whose result is posted but who has not yet collected it
    keeps it: a submitter that wraps the ring onto its slot blocks until it
    collects (or the reclaim grace expires), and never takes the slot."""
    with BatchServer(_compute, cir_len=L, batch_size=1, max_pending=2, deadline_ms=1.0,
                     prefer_native=prefer_native) as srv:
        t_a = _raw_submit(srv, np.full(L, 4.0))
        assert t_a >= 0
        _wait_for(lambda: srv.stats()["rows_posted"] >= 1)
        churn_done = []

        def churn():
            for v in (5.0, 6.0):
                churn_done.append(srv.submit(np.full(L, v), timeout_s=30.0))

        th = threading.Thread(target=churn)
        th.start()
        time.sleep(0.3)  # churn reaches A's slot
        got = _raw_wait(srv, t_a, 10.0)
        assert got is not None, "A lost its posted result"
        np.testing.assert_allclose(got[0], 4.0)
        assert got[1] == 4
        th.join(timeout=30.0)
        assert not th.is_alive()
        assert len(churn_done) == 2 and all(o is not None for o in churn_done)
        assert srv.stats()["reclaimed"] == 0


# the slice against JAX: serve_predictor over the port's Predictor on a JAX export


@pytest.fixture(scope="module")
def jax_rows(tmp_path_factory):
    """The flagship 1-D model in JAX, its recon Predictor's outputs at batch 8
    on 13 CIRs (one compile), and its export_serving weights."""
    model = JaxIInsVAE(cir_len=157, num_classes=5, style_dim=16)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.ones((2, 157)))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables.get("batch_stats", {}))
    pred = JaxPredictor(model, state, batch_size=8, return_recon=True)
    cirs = np.random.default_rng(7).normal(size=(13, 157)).astype(np.float32)
    art = tmp_path_factory.mktemp("serving")
    pred.export_serving(str(art))
    return cirs, pred(cirs), str(art / "weights.npz")


def _served(server: BatchServer, cirs: np.ndarray) -> list:
    out = [None] * len(cirs)

    def client(i):
        out[i] = server.submit(cirs[i], timeout_s=120.0)

    _run_threads(client, len(cirs))
    assert all(o is not None for o in out)
    return out


def test_serve_predictor_integration(jax_rows):
    cirs, want, npz = jax_rows
    with serve_predictor(Predictor.from_npz(npz, batch_size=8, device="cpu"),
                         deadline_ms=10.0) as srv:
        assert srv.n_extra == 0 and srv.native
        got = _served(srv, cirs)
    np.testing.assert_allclose([o[0] for o in got], want.err_est[:, 0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal([o[1] for o in got], want.label)


def test_serve_predictor_probs_and_recon(jax_rows):
    cirs, want, npz = jax_rows
    with serve_predictor(Predictor.from_npz(npz, batch_size=8, return_recon=True, device="cpu"),
                         with_probs=True, with_recon=True, deadline_ms=10.0) as srv:
        assert srv.n_extra == 5 + 157
        got = _served(srv, cirs)
    extra = np.stack([o[2] for o in got])
    np.testing.assert_allclose([o[0] for o in got], want.err_est[:, 0], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal([o[1] for o in got], want.label)
    np.testing.assert_allclose(extra[:, :5], want.label_probs, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(extra[:, 5:], want.recon, rtol=RTOL, atol=ATOL)


def test_serve_predictor_multi_device(jax_rows):
    """A list of predictors: one worker each, pulling from the shared queue;
    every row is the single predictor's, whichever worker computed it."""
    cirs, want, npz = jax_rows
    preds = [Predictor.from_npz(npz, batch_size=4, device="cpu") for _ in range(2)]
    with serve_predictor(preds, deadline_ms=10.0) as srv:
        assert srv.workers == 2
        got = _served(srv, np.concatenate([cirs, cirs]))
    np.testing.assert_allclose([o[0] for o in got], np.tile(want.err_est[:, 0], 2),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal([o[1] for o in got], np.tile(want.label, 2))


def test_serve_predictor_rejects_recon_without_the_decoder(jax_rows):
    with pytest.raises(ValueError, match="return_recon"):
        serve_predictor(Predictor.from_npz(jax_rows[2], batch_size=4, device="cpu"),
                        with_recon=True)
