"""The port's serving path against the JAX package's.

The JAX ``Predictor`` (Pallas in interpret mode on the CPU) exports its
weights with ``export_serving``; the port loads that npz with
``Predictor.from_npz(..., device="cpu")`` and must give the same outputs on
the same CIRs: fp32, rtol 5e-4 / atol 5e-5 (tests/test_lowering_parity.py),
identical labels, and with ``return_recon`` the same reconstructed CIR.
13 CIRs at batch 8 pad the tail batch.
"""

import os
import signal
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iinsvae_tpu.models import IInsVAE as JaxIInsVAE
from iinsvae_tpu.serving import Predictor as JaxPredictor
from iinsvae_torch import bridge
from iinsvae_torch.models.encoders import env_kl, split_env_stats
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.serving import Predictor

RTOL, ATOL = 5e-4, 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The flagship 1-D model (style_dim 16, 5 classes) in JAX, its
    Predictor at batch 8, and its export_serving weights."""
    model = JaxIInsVAE(cir_len=157, num_classes=5, style_dim=16)
    variables = jax.jit(model.init)({"params": jax.random.PRNGKey(0)}, jnp.ones((2, 157)))
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables.get("batch_stats", {}))
    pred = JaxPredictor(model, state, batch_size=8)
    art = tmp_path_factory.mktemp("serving")
    pred.export_serving(str(art))
    return model, variables, pred, str(art / "weights.npz")


@pytest.fixture(scope="module")
def cirs():
    return np.random.default_rng(7).normal(size=(13, 157)).astype(np.float32)


@pytest.fixture(scope="module")
def forwards(exported, cirs):
    """The JAX forward and the port's forward (weights from the npz) on the CIRs."""
    model, variables, _, npz = exported
    want = jax.jit(lambda v, c: model.apply(v, c, sample_key=None, train=False))(
        variables, jnp.asarray(cirs))
    port = IInsVAE(cir_len=157, num_classes=5, style_dim=16)
    port.load_state_dict(bridge.load_npz(npz))
    with torch.inference_mode():
        got = port(torch.tensor(cirs))
        got["kl"] = env_kl(*split_env_stats(got["env_code"]))
    return got, want


@pytest.fixture(scope="module")
def recon_predictor(exported):
    return Predictor.from_npz(exported[3], batch_size=8, return_recon=True, device="cpu")


def test_predictor_matches_jax(exported, cirs):
    _, _, jpred, npz = exported
    want = jpred(cirs)
    got = Predictor.from_npz(npz, batch_size=8, device="cpu")(cirs)
    for field in ("err_est", "label_probs", "env_code"):
        assert getattr(got, field).shape == getattr(want, field).shape
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_array_equal(got.label, want.label)


def test_mitigate_matches_jax(exported, cirs):
    _, _, jpred, npz = exported
    d = np.linspace(1.0, 12.0, len(cirs))
    got = Predictor.from_npz(npz, batch_size=8, device="cpu").mitigate(cirs, d)
    np.testing.assert_allclose(got, jpred.mitigate(cirs, d), rtol=RTOL, atol=ATOL)


def test_forward_codes_and_kl_match_jax(forwards):
    got, want = forwards
    for key in ("range_code", "env_code", "err_est", "logits", "kl"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


def test_forward_recon_matches_jax(forwards):
    """The decoder (MLP, K2, 3 x K5, K6 on their plain versions) vs the JAX
    Decoder1d on the same range and env codes."""
    got, want = forwards
    assert got["recon"].shape == (13, 157)
    np.testing.assert_allclose(got["recon"].numpy(), np.asarray(want["recon"]),
                               rtol=RTOL, atol=ATOL)


def test_recon_predictor_matches_jax(exported, recon_predictor, cirs):
    model, variables, _, _ = exported
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables.get("batch_stats", {}))
    want = JaxPredictor(model, state, batch_size=8, return_recon=True)(cirs)
    got = recon_predictor(cirs)
    for field in ("recon", "err_est", "label_probs", "env_code"):
        assert getattr(got, field).shape == getattr(want, field).shape
        np.testing.assert_allclose(getattr(got, field), getattr(want, field),
                                   rtol=RTOL, atol=ATOL, err_msg=field)
    np.testing.assert_array_equal(got.label, want.label)


def test_recon_predict_dataset_matches_per_request_path(recon_predictor, cirs):
    a, b = recon_predictor(cirs), recon_predictor.predict_dataset(cirs)
    np.testing.assert_allclose(a.recon, b.recon, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(a.err_est, b.err_est, rtol=1e-6, atol=1e-7)


def test_padding_rows_do_not_change_real_rows_recon(exported, recon_predictor, cirs):
    whole = Predictor.from_npz(exported[3], batch_size=13, return_recon=True,
                               device="cpu")(cirs)
    np.testing.assert_allclose(whole.recon, recon_predictor(cirs).recon, rtol=1e-6, atol=1e-7)


def test_predict_dataset_matches_per_request_path(exported, cirs):
    pred = Predictor.from_npz(exported[3], batch_size=8, device="cpu")
    a, b = pred(cirs), pred.predict_dataset(cirs)
    np.testing.assert_allclose(a.err_est, b.err_est, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(a.label, b.label)


def test_padding_rows_do_not_change_real_rows(exported, cirs):
    whole = Predictor.from_npz(exported[3], batch_size=13, device="cpu")(cirs)
    padded = Predictor.from_npz(exported[3], batch_size=5, device="cpu")(cirs)
    np.testing.assert_allclose(whole.err_est, padded.err_est, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(whole.env_code, padded.env_code, rtol=1e-6, atol=1e-7)


def test_bridge_ignores_decoder_and_rejects_unknown_keys(exported):
    """The bridge maps every decoder key (no transposes: each lands at the
    port's parameter of the same shape) and rejects an unknown one."""
    with np.load(exported[3]) as z:
        flat = {k: z[k] for k in z.files}
    state = bridge.from_flax_numpy(flat)
    dec = {k: v for k, v in state.items() if k.startswith("decoder.decoder.")}
    d = "decoder.decoder."
    assert dec[d + "in_kernel"].shape == (1, 2, 64)
    assert dec[d + "up0_kernel"].shape == (5, 64, 32)
    assert dec[d + "mlp.Dense_2.kernel"].shape == (256, 768)
    assert len(dec) == 2 + 6 + 16 + 2 + 6
    port = IInsVAE(cir_len=157, num_classes=5, style_dim=16).state_dict()
    assert set(state) == set(port)
    assert all(state[k].shape == port[k].shape for k in state)
    assert bridge.model_geometry(state) == dict(
        conv_type=1, dim=4, n_downsample=4, n_residual=3, range_dim=2, style_dim=16, num_classes=5)
    with pytest.raises(KeyError, match="unknown JAX parameter"):  # Conv1d heads are known
        bridge.from_flax_numpy({**flat, "params/restorer/restorer/Conv3d_0/kernel": np.zeros(1)})
    with pytest.raises(KeyError, match="unknown JAX parameter"):
        bridge.from_flax_numpy({**flat, "params/decoder/decoder/up9_scale": np.zeros(1)})


def test_seeded_init_follows_the_reference_distributions():
    m = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                generator=torch.Generator().manual_seed(3))
    taps = m.encoder.range_encoder.res0_kernel1
    assert abs(taps.std().item() - 0.02) < 0.002
    w1 = m.restorer.restorer.w1  # (512, 256): U(+-1/sqrt(512))
    assert w1.shape == (512, 256)
    assert w1.abs().max().item() <= 512 ** -0.5
    again = IInsVAE(cir_len=157, num_classes=5, style_dim=16,
                    generator=torch.Generator().manual_seed(3))
    assert torch.equal(again.restorer.restorer.w1, w1)


def test_predictor_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(IInsVAE())


def test_recon_is_the_decoder_slice():
    """return_recon gives the decoder's (N, cir_len) reconstruction."""
    out = Predictor(IInsVAE(), batch_size=4, return_recon=True, device="cpu")(
        np.random.default_rng(2).normal(size=(6, 157)).astype(np.float32))
    assert out.recon.shape == (6, 157) and np.isfinite(out.recon).all()
    assert Predictor(IInsVAE(), batch_size=4, device="cpu")(np.zeros((6, 157))).recon is None


def test_conv_types_other_than_1_2_3_raise_value_error():
    """conv_type 1, 2 and 3 are the port's models; any other raises (the JAX package runs
    every other value as the column-image model)."""
    with pytest.raises(ValueError, match="conv_type"):
        IInsVAE(conv_type=4)


def _run(code_or_args, **kw):
    # the time limit leaves room for a machine loaded by the suite's other workers
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, *code_or_args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600, **kw)


def test_port_serves_with_jax_and_the_jax_package_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['iinsvae_tpu'] = None\n"
        "import numpy as np, iinsvae_torch\n"
        "from iinsvae_torch.cli import serve\n"
        "from iinsvae_torch.models.vae import IInsVAE\n"
        "p = iinsvae_torch.Predictor(IInsVAE(style_dim=16), batch_size=4, return_recon=True,\n"
        "                            device='cpu')\n"
        "out = p(np.zeros((6, 157), np.float32))\n"
        "assert out.err_est.shape == (6, 1) and np.isfinite(out.err_est).all()\n"
        "assert out.recon.shape == (6, 157) and np.isfinite(out.recon).all()\n"
        "print('isolated ok')\n"
    )
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr
    assert "isolated ok" in r.stdout


def test_cli_self_test_on_cpu():
    r = _run(["-m", "iinsvae_torch.cli.serve", "--device", "cpu", "--dataset_env",
              "room_full", "--selftest_n", "9", "--serve_batch", "4"])
    assert r.returncode == 0, r.stderr
    assert "plane=native, payload=err,label+0" in r.stdout
    assert "self-test ok: 9 requests through the server" in r.stdout
    assert "[serve] stats: 9 submitted" in r.stdout and "0 client timeouts" in r.stdout


def test_cli_self_test_with_recon_on_cpu():
    r = _run(["-m", "iinsvae_torch.cli.serve", "--device", "cpu", "--dataset_env",
              "room_full", "--selftest_n", "9", "--serve_batch", "4", "--recon"])
    assert r.returncode == 0, r.stderr
    assert "self-test ok: 9 requests through the server" in r.stdout
    assert "[serve] stats: 9 submitted" in r.stdout
    assert "recon (9, 157)" in r.stdout


def test_cli_socket_mode_answers_then_stops_on_sigint(tmp_path):
    """``serve --socket`` in a subprocess: one framed request answered (the
    error, label, probabilities and reconstruction), then SIGINT stops it
    with exit code 0 and its stats line."""
    from iinsvae_torch.runtime import socket_client_request

    sock = str(tmp_path / "serve.sock")
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.Popen(
        [sys.executable, "-m", "iinsvae_torch.cli.serve", "--device", "cpu", "--dataset_env",
         "room_full", "--socket", sock, "--serve_batch", "4", "--probs", "--recon"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(300.0, proc.kill)  # a hung server fails the test, not the suite
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "Ctrl-C to stop" in line:
                break
        assert any(f"listening on {sock}" in ln for ln in lines), "".join(lines)
        cirs = np.random.default_rng(4).normal(size=(3, 157))
        err, label, extra = socket_client_request(sock, cirs, timeout_s=120.0, n_extra=5 + 157)
        assert np.isfinite(err).all() and ((label >= 0) & (label < 5)).all()
        np.testing.assert_allclose(extra[:, :5].sum(axis=1), 1.0, rtol=1e-5)
        assert np.isfinite(extra[:, 5:]).all()
        proc.send_signal(signal.SIGINT)
        out = proc.communicate(timeout=120)[0]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "[serve] stats: 3 submitted" in out and "0 client timeouts" in out


def test_cli_serve_devices_beyond_the_visible_raises():
    r = _run(["-m", "iinsvae_torch.cli.serve", "--device", "cpu", "--dataset_env",
              "room_full", "--serve_devices", "2"])
    assert r.returncode != 0
    assert "ValueError: --serve_devices 2 > 1 visible devices" in r.stderr
