"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor iinsvae_tpu, so it runs on a machine that has only
PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The kernels sum in another order than the plain versions, and
InstanceNorm divides by a per-channel std, which can scale that rounding
up: fp32 with rtol 1e-4 / atol 1e-4 per kernel call, 1e-3 / 1e-4 through
a whole forward (the 1-D model's 12 launches without the decoder and 17
with it; the expanded 2-D model's 5 and 8, with its plain convs between). A
backward kernel's gradients: rtol 1e-3, atol 1e-4 of each gradient's
largest magnitude (a weight gradient sums B*L products, and the norms'
gradients scale by 1/std). A training step's gradients on the card and on
the CPU (fp32) are each held against the CPU port's in float64: the card's
largest error per parameter at most 10 times the CPU's plus 1e-4 of the
gradient's largest magnitude (some weight gradients sum thousands of terms
that cancel, so no per-tensor tolerance fits both fp32 orders); a gradient
that is exactly 0 in exact arithmetic (ZERO_GRAD) within 1e-6 of the
model's largest.
"""

import copy
import re
import threading

import numpy as np
import pytest
import torch

from iinsvae_torch.models import emnet
from iinsvae_torch.models.layers import draw_dropout_masks
from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops import kernels
from iinsvae_torch.ops.conv import conv1d, conv2d
from iinsvae_torch.ops.kernels import backward, fused, graph_kernels, res2d, strided_conv
from iinsvae_torch.ops.norms import adain, instance_norm
from iinsvae_torch.ops.pooling import adaptive_avg_pool_matrix
from iinsvae_torch.serving import Predictor
from iinsvae_torch.training import steps

RTOL, ATOL = 1e-4, 1e-4
FLAGSHIP = dict(cir_len=157, num_classes=5, style_dim=16)
# the 1-D, the expanded 2-D and the column-image model (with the env encoder's conv taps from
# torch's default, the configuration [noexpand] of chip_smoke.py serves); the 1-D and 2-D
# models with the soft restorer
MODELS = {1: dict(FLAGSHIP), 2: dict(FLAGSHIP, conv_type=2),
          3: dict(FLAGSHIP, conv_type=3, env_conv_init="torch"),
          "soft": dict(FLAGSHIP, soft=True), "soft2d": dict(FLAGSHIP, conv_type=2, soft=True)}
# (module, wrapper, plain version); the models call each wrapper through its module
WRAPPED = [(fused, "in_chain", fused.in_chain_ref),
           (fused, "conv_bias_act", fused.conv_bias_act_ref),
           (strided_conv, "strided_conv", strided_conv.strided_conv_ref),
           (fused, "mlp_chain", fused.mlp_chain_ref),
           (fused, "adain_res_block", fused.adain_res_block_ref),
           (fused, "sln_chain", fused.sln_chain_ref),
           (res2d, "res_block_2d", res2d.res_block_2d_ref),
           (fused, "adain_layer", fused.adain_layer_ref),
           (fused, "sln_layer", fused.sln_layer_ref),
           (fused, "tanh_pool", fused.tanh_pool_ref)]
# launches of one forward batch of each conv_type, without and with the decoder
# (the one-stage ops K8-K10 run on no model path)
STANDALONE = {"adain_layer": 0, "sln_layer": 0, "tanh_pool": 0}
NO_RECON = {1: {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2,
                "adain_res_block": 0, "sln_chain": 0, "res_block_2d": 0, **STANDALONE},
            2: {"in_chain": 0, "conv_bias_act": 0, "strided_conv": 0, "mlp_chain": 2,
                "adain_res_block": 0, "sln_chain": 0, "res_block_2d": 3, **STANDALONE}}
# the column-image model: K4 at its two heads, every conv and norm a plain op
NO_RECON[3] = {**{k: 0 for k in NO_RECON[1]}, "mlp_chain": 2}
RECON = {1: {**NO_RECON[1], "conv_bias_act": 3, "adain_res_block": 3, "sln_chain": 1},
         2: {**NO_RECON[2], "res_block_2d": 6}, 3: NO_RECON[3]}
# backward launches of one training step: one for each forward launch
TRAIN_BWD = {t: {f"{k}_bwd": v for k, v in r.items()} for t, r in RECON.items()}
BWD_RTOL, BWD_ATOL = 1e-3, 1e-4
STEP_FACTOR, STEP_FLOOR = 10.0, 1e-4
# a pre-ReLU value this close to 0, relative to its sample's largest, may get
# its mask from the summation order (ten times the spread of fp32 orders seen)
MASK_MARGIN = 1e-5
# the 2-D range encoder's conv biases before an InstanceNorm: their exact
# gradient is 0, so each fp32 gradient is rounding noise (~1e-7 of the
# model's largest gradient) and is held below 1e-6 of it
ZERO_GRAD = re.compile(r"encoder\.range_encoder\.(in|down\d+)_bias")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("conv_type", [1, 2, 3])
@pytest.mark.parametrize("recon", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 500])
def test_gpu_every_kernel_call_of_the_forward_matches_plain(cuda, monkeypatch, batch, recon,
                                                            conv_type):
    """Record each wrapper call of one flagship forward (real activations at
    every shape the path gives), the 1-D model's or the expanded 2-D
    model's: the serving path without the decoder (encode, restore,
    classify) or the whole forward with it. Then hold each launch against
    the plain version on the same inputs."""
    calls = []
    for mod, name, ref in WRAPPED:
        def record(*args, _kernel=getattr(mod, name), _ref=ref, _name=name, **kw):
            out = _kernel(*args, **kw)
            calls.append((_name, out, _ref(*args, **kw)))
            return out
        # a wrapper counts on whatever its module name holds: the recorder here
        record.launches = 0
        monkeypatch.setattr(mod, name, record)
    model = IInsVAE(**MODELS[conv_type]).to(cuda)
    x = torch.randn((batch, 157), generator=torch.Generator().manual_seed(batch)).to(cuda)
    with torch.inference_mode():
        if recon:
            assert model(x)["recon"].shape == (batch, 157)
        else:
            range_code, env_code = model.encode(x)
            model.restore(range_code), model.classify(env_code)
    torch.cuda.synchronize()
    counts = {name: getattr(mod, name).launches for mod, name, _ in WRAPPED}
    want = (RECON if recon else NO_RECON)[conv_type]
    assert counts == want
    assert len(calls) == sum(want.values())
    for name, got, want in calls:
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("conv_type", [1, 2, 3])
@pytest.mark.parametrize("recon", [False, True])
def test_gpu_predictor_matches_cpu_predictor(cuda, recon, conv_type):
    model = IInsVAE(**MODELS[conv_type], generator=torch.Generator().manual_seed(5))
    cpu = Predictor(copy.deepcopy(model), batch_size=8, return_recon=recon, device="cpu")
    gpu = Predictor(model, batch_size=8, return_recon=recon, device="cuda")
    cirs = np.random.default_rng(5).normal(size=(13, 157)).astype(np.float32)
    a, b = gpu(cirs), cpu(cirs)
    for f in ("err_est", "label_probs", "env_code") + (("recon",) if recon else ()):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-3, atol=1e-4,
                                   err_msg=f)


@pytest.mark.gpu
def test_gpu_recon_server_over_both_fronts_matches_cpu(cuda, tmp_path):
    """The 1-D recon server on the card (runtime.serve_predictor with the
    probabilities and the reconstruction) behind a unix-socket and a TCP
    front: four clients on each send frames of 1-32 CIRs; every row is the
    CPU Predictor's, and each kernel ran its recon count a served batch."""
    from iinsvae_torch.runtime import SocketFront, TcpFront, serve_predictor, socket_client_request

    model = IInsVAE(**MODELS[1], generator=torch.Generator().manual_seed(6))
    cpu = Predictor(copy.deepcopy(model), batch_size=64, return_recon=True, device="cpu")
    gpu = Predictor(model, batch_size=64, return_recon=True, device="cuda")
    gpu(np.zeros((1, 157), np.float32))  # builds the kernels before the server opens
    rng = np.random.default_rng(6)
    frames = [rng.normal(size=(int(rng.integers(1, 33)), 157)) for _ in range(8)]
    got = [None] * len(frames)
    sock = str(tmp_path / "gpu.sock")
    kernels.reset_launch_counts()
    with serve_predictor(gpu, with_probs=True, with_recon=True, deadline_ms=2.0) as srv, \
            SocketFront(srv, sock), TcpFront(srv, 0) as tcp:
        addrs = [sock, ("127.0.0.1", tcp.port)]

        def client(i):
            got[i] = socket_client_request(addrs[i % 2], frames[i], n_extra=5 + 157)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(frames))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120.0)
        assert not any(t.is_alive() for t in threads)
        st = srv.stats()
    launches = kernels.launch_counts()
    for name, per in RECON[1].items():
        assert launches[name] == per * st["batches"], (name, launches[name], st["batches"])
    rows = sum(len(f) for f in frames)
    assert st["submitted"] == st["rows_posted"] == rows
    assert st["wait_timeouts"] == st["reclaimed"] == 0
    want = cpu(np.concatenate(frames).astype(np.float32))
    err, label, extra = (np.concatenate(x) for x in zip(*got))
    np.testing.assert_allclose(err, want.err_est[:, 0], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(extra[:, :5], want.label_probs, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(extra[:, 5:], want.recon, rtol=1e-3, atol=1e-4)
    top2 = np.sort(want.label_probs, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2e-4  # a label may flip only at a tie
    np.testing.assert_array_equal(label[clear], want.label[clear])


@pytest.mark.gpu
def test_gpu_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 16, 32), device=cuda, dtype=torch.float64)
    taps = torch.zeros((4, 32, 64), device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError):
        fused.in_chain(x, [(taps, 2, 1, "zero")])
    with pytest.raises(ValueError):
        fused.in_chain(x.float(), [(taps.float()[:, :16], 2, 1, "zero")])
    with pytest.raises(ValueError):
        fused.in_chain(x.float().transpose(0, 1), [(taps.float(), 2, 1, "zero")])
    with pytest.raises(ValueError):
        fused.in_chain(x.float(), [(taps.float()[:, :, :62], 2, 1, "zero")])
    with pytest.raises(ValueError):
        fused.in_chain(x.float(), [(taps.float(), 2, 1, "zero")], residual=True)
    with pytest.raises(ValueError):
        strided_conv.strided_conv(x.float(), taps.float(), torch.zeros(63, device=cuda))
    bias = torch.zeros(64, device=cuda)
    with pytest.raises(TypeError):
        strided_conv.strided_conv(x, taps, bias.double())
    with pytest.raises(ValueError):  # C_in not a multiple of 4
        strided_conv.strided_conv(x.float()[:, :, :30].contiguous(),
                                  taps.float()[:, :30].contiguous(), bias)
    with pytest.raises(ValueError):  # C_out not a multiple of 4
        strided_conv.strided_conv(x.float(), taps.float()[:, :, :62].contiguous(), bias[:62])
    with pytest.raises(ValueError):  # non-contiguous
        strided_conv.strided_conv(x.float().transpose(0, 1).contiguous().transpose(0, 1),
                                  taps.float(), bias)
    with pytest.raises(ValueError):  # not a k4 conv
        strided_conv.strided_conv(x.float(), taps.float()[:3].contiguous(), bias)
    assert strided_conv.strided_conv(x.float(), taps.float(), bias).shape == (4, 8, 64)


# (L_in, C_in, C_out) of K3 and K3b: the env encoder's two stride-2 stages,
# the constant-depth stage the Pallas entry also takes, and an odd length
STRIDED = {"env.down0": (128, 16, 32), "env.down1": (64, 32, 64), "const": (32, 64, 64),
           "odd": (9, 8, 12)}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(STRIDED))
@pytest.mark.parametrize("batch", [5, 261, 500])
def test_gpu_strided_conv_and_its_backward_match_plain(cuda, batch, shape):
    """K3 and K3b against their plain versions; a batch of 5 or 261 leaves a
    ragged last tile of rows. K3b also without dx, and bit-reproducible
    over two calls. K3b takes its ReLU mask from the saved output, the
    plain backward from its own forward: both get the plain forward's
    output, since a pre-activation within rounding of 0 (about one in a
    million here) may be cut by one and not by the other."""
    l_in, c_in, c_out = STRIDED[shape]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, l_in, c_in), generator=gen).to(cuda)
    taps = (torch.randn((4, c_in, c_out), generator=gen) / (4 * c_in) ** 0.5).to(cuda)
    bias = (0.1 * torch.randn(c_out, generator=gen)).to(cuda)
    g = torch.randn((batch, l_in // 2, c_out), generator=gen).to(cuda)
    with torch.no_grad():
        got = strided_conv.strided_conv(x, taps, bias)
        y = strided_conv.strided_conv_ref(x, taps, bias)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, y, rtol=RTOL, atol=ATOL)
    first = backward.strided_conv_bwd(g, x, taps, bias, y)
    want = backward.strided_conv_bwd_ref(g, x, taps, bias, y)
    for i, (a, w) in enumerate(zip(first, want)):
        assert torch.isfinite(a).all(), i
        _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"{shape} gradient {i}")
    for a, b in zip(first, backward.strided_conv_bwd(g, x, taps, bias, y)):
        assert torch.equal(a, b)
    no_dx = backward.strided_conv_bwd(g, x, taps, bias, y, need_dx=False)
    assert no_dx[0] is None
    assert torch.equal(no_dx[1], first[1]) and torch.equal(no_dx[2], first[2])


def _decoder_inputs(cuda, b=4):
    dec = IInsVAE(**FLAGSHIP).decoder.decoder.to(cuda)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((b, 8, 64), generator=gen).to(cuda)
    g = [torch.randn((b, 64), generator=gen).to(cuda) for _ in range(4)]
    stages = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
              for j in range(4)]
    return dec, x, g, stages


@pytest.mark.gpu
def test_gpu_adain_res_block_rejects_what_the_kernel_does_not_take(cuda):
    dec, x, (g1, b1, g2, b2), _ = _decoder_inputs(cuda)
    k1, k2 = dec.res0_kernel1, dec.res0_kernel2
    with pytest.raises(TypeError):
        fused.adain_res_block(x.double(), k1.double(), k2.double(), g1, b1, g2, b2)
    with pytest.raises(ValueError):  # taps that are not (3, C, C)
        fused.adain_res_block(x, k1[:2], k2, g1, b1, g2, b2)
    with pytest.raises(ValueError):  # per-sample tables of the wrong batch
        fused.adain_res_block(x, k1, k2, g1[:3], b1, g2, b2)
    with pytest.raises(ValueError):  # non-contiguous
        fused.adain_res_block(x, k1, k2, g1.t().contiguous().t(), b1, g2, b2)
    assert torch.isfinite(fused.adain_res_block(x, k1, k2, g1, b1, g2, b2)).all()


def _res_block_forward(cuda, batch, which):
    """(wrapper, kernel call, general kernel call, plain version) of K1 at the range encoder's
    residual block (which 'in_chain') or K5 at the decoder's ('adain_res_block'), on the
    flagship's seeded weights and seeded inputs at the batch."""
    m = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(6)).to(cuda)
    re_, dec = m.encoder.range_encoder, m.decoder.decoder
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, 8, 64), generator=gen).to(cuda)
    if which == "in_chain":
        block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
        return (fused.in_chain, lambda: fused.in_chain(x, block, residual=True),
                lambda: fused.launch_in_chain(x, block, True, general=True),
                lambda: fused.in_chain_ref(x, block, residual=True))
    args = (x, dec.res0_kernel1, dec.res0_kernel2,
            *(torch.randn((batch, 64), generator=gen).to(cuda) for _ in range(4)))
    return (fused.adain_res_block, lambda: fused.adain_res_block(*args),
            lambda: fused.launch_adain_res_block(*args, general=True),
            lambda: fused.adain_res_block_ref(*args))


def _device_kernel_names(fn) -> set[str]:
    """The device kernels a call of ``fn`` launches, each name without ``void``, the anonymous
    namespace, template arguments and parameters (as chip_smoke.device_kernels names them):
    the kernel nodes of a CUDA graph of the call (graph_kernels.launched_kernels; a
    torch.profiler trace of the call sometimes held no device event on the card). The graph is
    replayed, and its outputs must be bit-equal to an eager call's: the named kernels are the
    ones that computed them on the card."""
    return set(graph_kernels.launched_kernels(fn))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["in_chain", "adain_res_block"])
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_res_block_forward_matches_plain_and_the_general_kernel(cuda, batch, which):
    """K1 and K5 at the residual blocks run a kernel of their own (csrc/in_chain.cu, namespace
    res; tiles of 2 samples at 1, 5 and 261, of 4 at 500, the last tile short at 1, 5 and 261):
    one launch a call, within tolerance of the plain version, bit-equal to the general kernel
    on the same inputs (the backward's recompute relies on it) and over two calls."""
    wrapper, run, general, plain = _res_block_forward(cuda, batch, which)
    with torch.no_grad():
        n = wrapper.launches
        got = run()
        assert wrapper.launches == n + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, plain(), rtol=RTOL, atol=ATOL)
        assert torch.equal(got, general())
        assert torch.equal(got, run())
        assert _device_kernel_names(run) == {"res::res_block_kernel"}


@pytest.mark.gpu
def test_gpu_res_block_forward_rejects_what_the_kernel_does_not_take(cuda):
    """The residual block's wrappers raise, rather than launch another kernel, on unaligned
    taps, an unaligned x and K5 tables of the wrong shape."""
    dec, x, tables, _ = _decoder_inputs(cuda, b=5)
    k = dec.res0_kernel1.detach()

    def unaligned(t):
        u = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        return u.copy_(t)

    block = [(k, 1, 1, "reflect"), (k, 1, 1, "reflect")]
    with torch.no_grad():
        with pytest.raises(ValueError):  # unaligned taps
            fused.in_chain(x, [(unaligned(k), 1, 1, "reflect"), block[1]], residual=True)
        with pytest.raises(ValueError):
            fused.adain_res_block(x, k, unaligned(k), *tables)
        with pytest.raises(ValueError):  # an unaligned x
            fused.in_chain(unaligned(x), block, residual=True)
        with pytest.raises(ValueError):
            fused.adain_res_block(unaligned(x), k, k, *tables)
        with pytest.raises(ValueError):  # tables of the wrong width or batch
            fused.adain_res_block(x, k, k, tables[0][:, :32].contiguous(), *tables[1:])
        with pytest.raises(ValueError):
            fused.adain_res_block(x, k, k, *tables[:3], tables[3][:4])
        assert torch.equal(fused.in_chain(x, block, residual=True),
                           fused.launch_in_chain(x, block, True, general=True))


@pytest.mark.gpu
def test_gpu_sln_chain_rejects_what_the_kernel_does_not_take(cuda):
    dec, x, _, stages = _decoder_inputs(cuda)
    ko, bo = dec.out_kernel, dec.out_bias
    with pytest.raises(TypeError):
        fused.sln_chain(x.double(), [tuple(t.double() for t in st) for st in stages],
                        ko.double(), bo.double(), 157)
    with pytest.raises(ValueError):  # a stage count other than the flagship's four
        fused.sln_chain(x, stages[:3], ko, bo, 157)
    with pytest.raises(ValueError):  # wrong shape: the input's channels do not follow
        fused.sln_chain(x[:, :, :32].contiguous(), stages, ko, bo, 157)
    with pytest.raises(ValueError):  # non-contiguous
        fused.sln_chain(x.transpose(1, 2).contiguous().transpose(1, 2), stages, ko, bo, 157)
    assert fused.sln_chain(x, stages, ko, bo, 157).shape == (x.shape[0], 157)


# K6 at the decoder's shape runs the tail kernel (csrc/sln_chain.cu, namespace tail): (batch,
# pool length); the last tile of 4 samples is short at 1, 5, 261 and 7
SLN_TAIL_CASES = [(1, 157), (5, 157), (261, 157), (500, 157), (7, 152), (7, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("batch,l_pool", SLN_TAIL_CASES)
def test_gpu_sln_chain_tail_path_is_bit_equal_to_the_general_kernel(cuda, batch, l_pool):
    """K6 at the decoder tail, input (8, 64), runs its own kernel on the forward K6b's tail
    path recomputes (csrc/sln_tail.cuh): one launch a call, bit-equal to the general kernel on
    the same inputs (K6b's ReLU masks and statistics rely on it) and over two calls, within
    tolerance of the plain version."""
    dec, _, _, stages = _decoder_inputs(cuda)
    ko, bo = dec.out_kernel, dec.out_bias
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, 8, 64), generator=gen).to(cuda)
    with torch.no_grad():
        n = fused.sln_chain.launches
        got = fused.sln_chain(x, stages, ko, bo, l_pool)
        assert fused.sln_chain.launches == n + 1
        assert got.shape == (batch, l_pool) and torch.isfinite(got).all()
        assert torch.equal(got, fused.launch_sln_chain(x, stages, ko, bo, l_pool, general=True))
        assert torch.equal(got, fused.sln_chain(x, stages, ko, bo, l_pool))
        torch.testing.assert_close(got, fused.sln_chain_ref(x, stages, ko, bo, l_pool),
                                   rtol=RTOL, atol=ATOL)
        assert _device_kernel_names(lambda: fused.sln_chain(x, stages, ko, bo, l_pool)) == {
            "tail::tail_fwd_kernel"}


def _head(cuda, head, batch):
    """(ws, bs, slopes, x) of a head of the seeded model (MLP_HEADS) and seeded inputs."""
    conv_type, attr = MLP_HEADS[head]
    model = IInsVAE(**MODELS[conv_type], generator=torch.Generator().manual_seed(5)).to(cuda)
    mod = getattr(getattr(model, attr), attr)
    n = len(mod.slopes)
    ws = [getattr(mod, f"w{j}").detach() for j in range(n)]
    bs = [getattr(mod, f"b{j}").detach() for j in range(n)]
    x = torch.randn((batch, ws[0].shape[0]), generator=torch.Generator().manual_seed(batch))
    return ws, bs, mod.slopes, x.to(cuda)


def _pre_activations(x, ws, bs, slopes):
    """Each layer's plain pre-activation d_j, as K4 saves them."""
    out = []
    for w, b, s in zip(ws, bs, slopes):
        out.append(x @ w + b)
        x = out[-1] if s == 1.0 else torch.nn.functional.leaky_relu(out[-1], s)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["restorer", "restorer.2d"])
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_mlp_chain_restorer_path_matches_plain(cuda, batch, head):
    """K4 at the restorers runs the cluster kernel (csrc/mlp_chain.cu, namespace cluster: a
    cluster of 8 blocks a tile of samples, each block an eighth of every layer's columns; the
    last tile short at 1, 5 and 261): one launch a call, within tolerance of the plain version,
    bit-equal over two calls and when it also saves the pre-activations, each saved d_j within
    tolerance of the plain one."""
    ws, bs, slopes, x = _head(cuda, head, batch)
    with torch.no_grad():
        n = fused.mlp_chain.launches
        y, ds = fused.launch_mlp_chain(x, ws, bs, slopes)
        assert fused.mlp_chain.launches == n + 1 and ds == []
        assert y.shape == (batch, 1) and torch.isfinite(y).all()
        torch.testing.assert_close(y, fused.mlp_chain_ref(x, ws, bs, slopes), rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(y, fused.launch_mlp_chain(x, ws, bs, slopes)[0])
        y_saving, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
        assert torch.equal(y, y_saving)
        for j, (d, want) in enumerate(zip(ds, _pre_activations(x, ws, bs, slopes))):
            torch.testing.assert_close(d, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"d_{j}: {m}")
        assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
            "cluster::mlp_cluster_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 500])
def test_gpu_mlp_chain_classifier_keeps_the_general_kernel(cuda, batch):
    """The classifier's widths (16 -> 16 -> 32 -> 16 -> 5) run K4's small-head kernel
    (csrc/mlp_chain.cu, namespace head: a warp a sample, tiles of 8, the last short at 5 and
    500): one launch a call, within tolerance of the plain version, bit-equal over two calls and
    when it also saves the pre-activations, each saved d_j within tolerance of the plain one.
    The general kernel stays reachable with ``general=True``, within tolerance of it."""
    ws, bs, slopes, x = _head(cuda, "classifier", batch)
    assert fused.takes_mlp_head([ws[0].shape[0]] + [w.shape[1] for w in ws])
    with torch.no_grad():
        n = fused.mlp_chain.launches
        y, ds = fused.launch_mlp_chain(x, ws, bs, slopes)
        assert fused.mlp_chain.launches == n + 1 and ds == []
        assert y.shape == (batch, 5) and torch.isfinite(y).all()
        torch.testing.assert_close(y, fused.mlp_chain_ref(x, ws, bs, slopes), rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(y, fused.mlp_chain(x, ws, bs, slopes))
        y_saving, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
        assert torch.equal(y, y_saving)
        for j, (d, want) in enumerate(zip(ds, _pre_activations(x, ws, bs, slopes))):
            torch.testing.assert_close(d, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"d_{j}: {m}")
        general = fused.launch_mlp_chain(x, ws, bs, slopes, general=True)[0]
        torch.testing.assert_close(y, general, rtol=RTOL, atol=ATOL)
        assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
            "head::mlp_head_kernel"}
        assert _device_kernel_names(
            lambda: fused.launch_mlp_chain(x, ws, bs, slopes, general=True)) == {
            "mlp_chain_kernel"}


# (widths, slopes) of small chains no head has, on K4's small-head path: one layer, eight
# layers, a width of 64 (two columns a lane), widths 1 and 3, and weights whose float counts
# are no multiple of 4 (4-byte staging)
MLP_SMALL = {"one": ((16, 5), (0.2,)), "eight": ((8, 64, 33, 17, 64, 3, 12, 40, 2),
                                                 (0.1, 0.2, 1.0, 0.3, 0.01, 0.2, 0.5, 1.0)),
             "odd": ((7, 3, 1, 9), (0.2, 0.1, 1.0)), "wide": ((64, 64), (0.3,))}


@pytest.mark.gpu
@pytest.mark.parametrize("chain", list(MLP_SMALL))
@pytest.mark.parametrize("batch", [1, 7, 300])
def test_gpu_mlp_chain_head_path_takes_other_small_widths(cuda, batch, chain):
    """Chains of 1-8 layers whose every width is at most 64 run the small-head kernel: y and each
    saved d_j within tolerance of the plain version, bit-equal over two calls."""
    dims, slopes = MLP_SMALL[chain]
    assert fused.takes_mlp_head(dims)
    gen = torch.Generator().manual_seed(batch)
    ws = [(torch.randn((a, k), generator=gen) / a ** 0.5).to(cuda) for a, k in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(k, generator=gen)).to(cuda) for k in dims[1:]]
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    with torch.no_grad():
        y, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
        torch.testing.assert_close(y, fused.mlp_chain_ref(x, ws, bs, slopes), rtol=RTOL,
                                   atol=ATOL)
        for j, (d, want) in enumerate(zip(ds, _pre_activations(x, ws, bs, slopes))):
            torch.testing.assert_close(d, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"d_{j}: {m}")
        assert torch.equal(y, fused.mlp_chain(x, ws, bs, slopes))
        assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
            "head::mlp_head_kernel"}


@pytest.mark.gpu
def test_gpu_mlp_chain_restorer_path_rejects_unaligned_weights(cuda):
    """The restorer path raises on a weight that is not 16-byte aligned, rather than launch
    another kernel."""
    ws, bs, slopes, x = _head(cuda, "restorer", 5)
    w = torch.empty(ws[1].numel() + 1, device=cuda)[1:].view(ws[1].shape).copy_(ws[1])
    with torch.no_grad(), pytest.raises(ValueError):
        fused.mlp_chain(x, [ws[0], w, *ws[2:]], bs, slopes)


def _train_batch(b, device, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"cir": rng.normal(size=(b, 157)), "err": np.abs(0.3 * rng.normal(size=(b, 1))),
             "label": rng.integers(0, 5, size=(b, 1)), "weight": np.ones(b)}
    mask = (rng.random(b) < 0.5).astype(np.float32)
    return ({k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()},
            torch.tensor(mask, device=device))


def _tensors(out):
    if out is None:
        return []
    if torch.is_tensor(out):
        return [out]
    return [t for o in out for t in _tensors(o)]


def _close_scaled(got, want, rtol, atol, what):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol * scale,
                               msg=lambda m: f"{what}: {m}")


def _clear_samples(x, k1, *affine) -> torch.Tensor:
    """The samples of a K7 block whose ReLU mask is not decided by rounding:
    every value a1 before the ReLU, in float64, at least MASK_MARGIN of the
    sample's largest |a1| away from 0."""
    d1 = conv2d(x.double(), k1.double(), padding=1, pad_mode="reflect")
    a1 = adain(d1, affine[0].double(), affine[1].double()) if affine else instance_norm(d1)
    a1 = a1.abs().flatten(1)
    return (a1.amin(dim=1) >= MASK_MARGIN * a1.amax(dim=1)).nonzero().flatten()


@pytest.mark.gpu
@pytest.mark.parametrize("conv_type", [1, 2, 3])
@pytest.mark.parametrize("batch", [37, 500])
def test_gpu_every_backward_kernel_call_of_a_step_matches_plain(cuda, monkeypatch, batch,
                                                                conv_type):
    """Record each backward wrapper call of one flagship training step (the
    real activations and gradients at every shape the path gives), hold each
    against its plain version on the same inputs, and count the step's
    forward and backward launches.

    A pre-ReLU value within rounding of 0 gets its mask, and the gradient
    through it, from the summation order (a degenerate row, ROADMAP Queue
    3); in the 2-D decoder at init one such value set K7b and its plain
    version apart by far more than this tolerance, each as far from float64
    as the other (chip run, PR 4). So each K7b call is held to its plain
    version again on the samples whose every pre-ReLU value clears
    MASK_MARGIN (at least half of them)."""
    calls = []
    originals = {w.__name__: w for w in backward.BACKWARD}
    for w in backward.BACKWARD:
        def record(*args, _w=w, **kw):
            out = _w(*args, **kw)
            calls.append((_w.__name__, args, kw, out))
            return out
        record.launches = 0  # the wrapper counts on its module name: the recorder here
        monkeypatch.setattr(backward, w.__name__, record)
    model = IInsVAE(**MODELS[conv_type]).to(cuda)
    data, mask = _train_batch(batch, cuda)
    kernels.reset_launch_counts()
    metrics = steps.make_semi_grads_fn(0.5)(model, data, sup_mask=mask)
    torch.cuda.synchronize()
    assert torch.isfinite(metrics["loss"])
    assert kernels.launch_counts() == RECON[conv_type]
    assert {w.__name__: getattr(backward, w.__name__).launches
            for w in backward.BACKWARD} == TRAIN_BWD[conv_type]
    assert len(calls) == sum(TRAIN_BWD[conv_type].values())
    for name, args, kw, got in calls:
        wrapper = originals[name]
        if name == "res_block_2d_bwd":
            g, x, k1, k2, *affine = args
            keep = _clear_samples(x, k1, *affine)
            assert 2 * len(keep) >= x.shape[0], f"{name}: {len(keep)} of {x.shape[0]} samples clear"
            args = (g[keep], x[keep], k1, k2, *(t[keep] for t in affine))
            kw = dict(kw, saved=tuple(t[keep] for t in kw["saved"]))
            got = wrapper(*args, **kw)
        got, want = _tensors(got), _tensors(backward.PLAIN[wrapper](*args, **kw))
        assert len(got) == len(want), name
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), (name, i)
            _close_scaled(a, b, BWD_RTOL, BWD_ATOL, f"{name} gradient {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("conv_type", [1, 2, 3])
def test_gpu_training_step_gradients_match_cpu(cuda, conv_type):
    cpu = IInsVAE(**MODELS[conv_type], generator=torch.Generator().manual_seed(9))
    gpu = copy.deepcopy(cpu).to(cuda)
    f64 = copy.deepcopy(cpu).double()
    data, mask = _train_batch(64, cuda, seed=1)
    grads_fn = steps.make_semi_grads_fn(0.5)
    mg = grads_fn(gpu, data, sup_mask=mask)
    grads_fn(cpu, {k: v.cpu() for k, v in data.items()}, sup_mask=mask.cpu())
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in data.items()},
                   sup_mask=mask.cpu().double())
    for k in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env"):
        assert mg[k].item() == pytest.approx(m64[k].item(), rel=1e-4, abs=1e-6), k
    fp32, ref = dict(cpu.named_parameters()), dict(f64.named_parameters())
    largest = max(p.grad.abs().max().item() for p in ref.values())
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        e_card = (p.grad.cpu().double() - want).abs().max().item()
        if ZERO_GRAD.fullmatch(name):
            assert e_card <= 1e-6 * largest, name
            continue
        e_cpu = (fp32[name].grad.double() - want).abs().max().item()
        assert e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * want.abs().max().item(), name


@pytest.mark.gpu
@pytest.mark.parametrize("conv_type", [1, 2, 3])
def test_gpu_backward_is_bit_reproducible(cuda, conv_type):
    """No atomics: two backward passes give bit-equal weight gradients."""
    model = IInsVAE(**MODELS[conv_type]).to(cuda)
    data, mask = _train_batch(500, cuda, seed=2)
    grads_fn = steps.make_semi_grads_fn(0.5)
    grads_fn(model, data, sup_mask=mask)
    first = {n: p.grad.clone() for n, p in model.named_parameters()}
    grads_fn(model, data, sup_mask=mask)
    for n, p in model.named_parameters():
        assert torch.equal(p.grad, first[n]), n


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 261])
def test_gpu_res_block_backward_matches_plain_on_a_partial_tile(cuda, batch):
    """K1b at the range encoder's residual block and K5b at the decoder's, on the residual
    block's own path (persistent blocks over tiles of backward.RES_TILE samples): at 261 the
    last tile holds one sample, at 1 the only tile does. Each held against its plain version,
    bit-equal over two calls, without dx too, one launch a call."""
    assert batch % backward.RES_TILE
    m = IInsVAE(**FLAGSHIP).to(cuda)
    re_, dec = m.encoder.range_encoder, m.decoder.decoder
    gen = torch.Generator().manual_seed(batch)
    x, g = (torch.randn((batch, 8, 64), generator=gen).to(cuda) for _ in range(2))
    tables = [torch.randn((batch, 64), generator=gen).to(cuda) for _ in range(4)]
    block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
    for wrapper, args, kw in ((backward.in_chain_bwd, (g, x, block), dict(residual=True)),
                              (backward.adain_res_block_bwd,
                               (g, x, dec.res0_kernel1, dec.res0_kernel2, *tables), {})):
        n = wrapper.launches
        got = _tensors(wrapper(*args, **kw))
        assert wrapper.launches == n + 1
        want = _tensors(backward.PLAIN[wrapper](*args, **kw))
        assert len(got) == len(want)
        for i, (a, w) in enumerate(zip(got, want)):
            assert torch.isfinite(a).all(), (wrapper.__name__, i)
            _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"{wrapper.__name__} gradient {i}")
        for a, b in zip(got, _tensors(wrapper(*args, **kw))):
            assert torch.equal(a, b)
        no_dx = wrapper(*args, **kw, need_dx=False)
        assert no_dx[0] is None
        for a, b in zip(got[1:], _tensors(no_dx)):
            assert torch.equal(a, b)


def _tail_grads_match(args, what):
    """Hold K6b's gradients against its plain version's, bit-equal over two calls and without
    dx, one launch a call."""
    n = backward.sln_chain_bwd.launches
    got = _tensors(backward.sln_chain_bwd(*args))
    assert backward.sln_chain_bwd.launches == n + 1
    want = _tensors(backward.sln_chain_bwd_ref(*args))
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), (what, i)
        _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"{what} gradient {i}")
    for a, b in zip(got, _tensors(backward.sln_chain_bwd(*args))):
        assert torch.equal(a, b)
    no_dx = backward.sln_chain_bwd(*args, need_dx=False)
    assert no_dx[0] is None
    for a, b in zip(got[1:], _tensors(no_dx)):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 5, 261])
def test_gpu_sln_chain_backward_matches_plain_on_a_partial_tile(cuda, batch):
    """K6b at the decoder tail, input (8, 64), on the decoder shape's own path (persistent
    blocks over tiles of backward.SLN_TAIL_TILE samples): at 5 and 261 the last tile holds one
    sample, at 1 the only tile does."""
    assert batch % backward.SLN_TAIL_TILE
    dec, _, _, stages = _decoder_inputs(cuda)
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, 8, 64), generator=gen).to(cuda)
    g = torch.randn((batch, 157), generator=gen).to(cuda)
    _tail_grads_match((g, x, stages, dec.out_kernel, dec.out_bias, 157), f"batch {batch}")


@pytest.mark.gpu
def test_gpu_sln_chain_backward_general_path_matches_plain(cuda):
    """K6b's general kernel, which every shape but the decoder's (8, 64) runs: input (16, 64),
    four up-stages to (256, 4), the pool 256 -> 157, seeded weights, a ragged batch."""
    gen = torch.Generator().manual_seed(11)

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen)).to(cuda)

    stages, c = [], 64
    for _ in range(4):
        stages.append((rand(5, c, c // 2, scale=0.2), rand(c // 2, scale=0.1),
                       rand(c // 2, scale=0.1, shift=1.0), rand(c // 2, scale=0.1)))
        c //= 2
    x, g = rand(7, 16, 64), rand(7, 157)
    _tail_grads_match((g, x, stages, rand(7, c, 1, scale=0.3), rand(1), 157), "general path")


def _grads_match(wrapper, args, kw, what, need_dx=True, same_without_dx=True):
    """Hold a backward wrapper's gradients against its plain version's, one launch a call,
    bit-equal over two calls; with need_dx also without dx (the other gradients bit-equal where
    same_without_dx: both calls take one path)."""
    n = wrapper.launches
    got = _tensors(wrapper(*args, **kw, need_dx=need_dx))
    assert wrapper.launches == n + 1
    want = _tensors(backward.PLAIN[wrapper](*args, **kw, need_dx=need_dx))
    assert len(got) == len(want)
    for i, (a, w) in enumerate(zip(got, want)):
        assert torch.isfinite(a).all(), (what, i)
        _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"{what} gradient {i}")
    for a, b in zip(got, _tensors(wrapper(*args, **kw, need_dx=need_dx))):
        assert torch.equal(a, b), what
    if need_dx and same_without_dx:
        no_dx = wrapper(*args, **kw, need_dx=False)
        assert no_dx[0] is None
        for a, b in zip(got[1:], _tensors(no_dx)):
            assert torch.equal(a, b), what


def _spy(monkeypatch, name):
    """Count the calls of backward.<name> (a path's launcher) in a list."""
    calls, fn = [], getattr(backward, name)

    def spy(*args, **kw):
        calls.append(args)
        return fn(*args, **kw)
    monkeypatch.setattr(backward, name, spy)
    return calls


# (input (L, C), first stage, stage count) of the range encoder's three stride-2 chains
RANGE_CHAINS = {"range.pair0": ((128, 1), 0, 2), "range.pair1": ((64, 8), 2, 2),
                "range.single": ((16, 32), 4, 1)}


@pytest.mark.gpu
@pytest.mark.parametrize("site", list(RANGE_CHAINS))
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_range_chain_backward_matches_plain(cuda, monkeypatch, batch, site):
    """K1b at the range encoder's stride-2 chains, on their own path (persistent blocks over
    tiles of backward.DOWN_TILE samples; at 1, 5 and 261 the last tile is short): against the
    plain version, bit-equal over two calls, range.pair0 without dx as the step calls it."""
    (l, c), first, n = RANGE_CHAINS[site]
    re_ = IInsVAE(**FLAGSHIP).encoder.range_encoder.to(cuda)
    stages = ([(re_.in_kernel, 1, 3, "reflect")]
              + [(getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)])
    stages = stages[first:first + n]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, l, c), generator=gen).to(cuda)
    rows, lo, co = fused.stage_rows(x, stages)
    assert rows == backward.DOWN_SITES[site]
    g = torch.randn((batch, lo, co), generator=gen).to(cuda)
    calls = _spy(monkeypatch, "_down_chain_bwd")
    _grads_match(backward.in_chain_bwd, (g, x, stages), {}, f"{site} batch {batch}",
                 need_dx=site != "range.pair0")
    assert len(calls) == (2 if site == "range.pair0" else 3)


@pytest.mark.gpu
def test_gpu_in_chain_backward_general_path_matches_plain(cuda, monkeypatch):
    """K1b's general kernel, which every chain but the residual block and the three range
    chains runs: a stride-2 pair at half the flagship's width ((64, 4) -> (32, 8) -> (16, 16)),
    a ragged batch, and range.pair0 with dx (its path computes none). Neither touches the range
    chains' path."""
    gen = torch.Generator().manual_seed(12)
    x = torch.randn((7, 64, 4), generator=gen).to(cuda)
    stages = [((torch.randn((4, 4, 8), generator=gen) / 4).to(cuda), 2, 1, "zero"),
              ((torch.randn((4, 8, 16), generator=gen) / 6).to(cuda), 2, 1, "zero")]
    g = torch.randn((7, 16, 16), generator=gen).to(cuda)
    calls = _spy(monkeypatch, "_down_chain_bwd")
    _grads_match(backward.in_chain_bwd, (g, x, stages), {}, "stride-2 pair")
    re_ = IInsVAE(**FLAGSHIP).encoder.range_encoder.to(cuda)
    pair0 = [(re_.in_kernel, 1, 3, "reflect"), (re_.down0_kernel, 2, 1, "zero")]
    x0 = torch.randn((7, 128, 1), generator=gen).to(cuda)
    g0 = torch.randn((7, 64, 8), generator=gen).to(cuda)
    _grads_match(backward.in_chain_bwd, (g0, x0, pair0), {}, "range.pair0 with dx",
                 same_without_dx=False)
    assert not calls


def _range_chain(cuda, site, batch):
    """(stages, x) of K1 at one of the range encoder's stride-2 chains, on the flagship's seeded
    weights and seeded inputs at the batch."""
    (l, c), first, n = RANGE_CHAINS[site]
    re_ = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(6)).encoder.range_encoder
    re_ = re_.to(cuda)
    stages = ([(re_.in_kernel, 1, 3, "reflect")]
              + [(getattr(re_, f"down{j}_kernel"), 2, 1, "zero") for j in range(4)])
    x = torch.randn((batch, l, c), generator=torch.Generator().manual_seed(batch)).to(cuda)
    return stages[first:first + n], x


@pytest.mark.gpu
@pytest.mark.parametrize("site", list(RANGE_CHAINS))
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_range_chain_forward_is_bit_equal_to_the_general_kernel(cuda, batch, site):
    """K1 at the range encoder's stride-2 chains runs a kernel of its own (csrc/in_chain.cu,
    namespace down, on csrc/down_chain.cuh; tiles of 2 samples at 1, 5 and 261, of 4 at 500,
    the last tile short at 1, 5 and 261): one launch a call, within tolerance of the plain
    version, bit-equal to the general kernel on the same inputs (K1b's recompute relies on it)
    and over two calls."""
    stages, x = _range_chain(cuda, site, batch)
    with torch.no_grad():
        n = fused.in_chain.launches
        got = fused.in_chain(x, stages)
        assert fused.in_chain.launches == n + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, fused.in_chain_ref(x, stages), rtol=RTOL, atol=ATOL)
        assert torch.equal(got, fused.launch_in_chain(x, stages, False, general=True))
        assert torch.equal(got, fused.in_chain(x, stages))
        assert _device_kernel_names(lambda: fused.in_chain(x, stages)) == {
            "down::down_chain_kernel"}


# K2b's call sites in a 1-D training step: (input (L, C), padding, pad mode, dx as the step asks)
K2B_SITES = {"range.out": ((8, 64), 0, "zero", True), "env.in": ((128, 1), 3, "reflect", False),
             "dec.in": ((8, 2), 0, "zero", True)}


def _k2b_site(cuda, site, batch):
    """(args, kw) of K2b at one of its call sites, on the flagship's seeded weights, seeded x
    and g, and y from K2. The plain version takes its ReLU mask from its own recompute, so a
    sample with a pre-ReLU value (in float64) within MASK_MARGIN of its largest from 0 gets a
    zero g: its mask then moves no gradient (at least half the samples are clear)."""
    (l, c), pad, mode, _ = K2B_SITES[site]
    m = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(7)).to(cuda)
    taps, bias = {"range.out": (m.encoder.range_encoder.out_kernel,
                                m.encoder.range_encoder.out_bias),
                  "env.in": (m.encoder.env_encoder.ConvINAct_0.kernel,
                             m.encoder.env_encoder.ConvINAct_0.bias),
                  "dec.in": (m.decoder.decoder.in_kernel, m.decoder.decoder.in_bias)}[site]
    taps, bias = taps.detach(), bias.detach()
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, l, c), generator=gen).to(cuda)
    kw = dict(padding=pad, pad_mode=mode)
    y = fused.conv_bias_act(x, taps, bias, **kw)
    z = conv1d(x.double(), taps.double(), bias.double(), **kw).abs().flatten(1)
    clear = z.amin(dim=1) >= MASK_MARGIN * z.amax(dim=1)
    assert 2 * int(clear.sum()) >= batch, f"{site}: {int(clear.sum())} of {batch} samples clear"
    g = torch.randn(y.shape, generator=gen).to(cuda) * clear[:, None, None]
    return (g, x, taps, bias, y), kw


@pytest.mark.gpu
@pytest.mark.parametrize("site", list(K2B_SITES))
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_conv_bias_act_backward_sites_match_plain(cuda, monkeypatch, batch, site):
    """K2b at its three call sites runs a kernel of its own (csrc/conv_bias_act_bwd.cu, namespace
    site: persistent blocks over tiles of backward.CBA_TILE samples, the last block to finish
    summing the partial rows; at 1, 5 and 261 the last tile is short): one launch a call,
    within tolerance of the plain version, bit-equal over two calls, with and without dx
    (env.in without, as the step calls it), one device kernel a call."""
    args, kw = _k2b_site(cuda, site, batch)
    need_dx = K2B_SITES[site][3]
    calls = _spy(monkeypatch, "_cba_site_bwd")
    _grads_match(backward.conv_bias_act_bwd, args, kw, f"{site} batch {batch}", need_dx=need_dx)
    assert len(calls) == (3 if need_dx else 2)
    assert _device_kernel_names(
        lambda: backward.conv_bias_act_bwd(*args, **kw, need_dx=need_dx)) == {
        "site::cba_site_bwd_kernel"}


@pytest.mark.gpu
def test_gpu_conv_bias_act_backward_general_path_matches_plain(cuda, monkeypatch):
    """K2b's general kernel, which every other conv runs: a k3 zero-pad conv on a ragged batch,
    env.in with dx (its path computes none) and ``general=True`` at range.out. None touches the
    sites' path, and each matches the plain version."""
    calls = _spy(monkeypatch, "_cba_site_bwd")
    gen = torch.Generator().manual_seed(13)
    x = torch.randn((7, 16, 8), generator=gen).to(cuda)
    taps = (torch.randn((3, 8, 12), generator=gen) / 4).to(cuda)
    bias = (torch.randn(12, generator=gen) / 4).to(cuda)
    y = fused.conv_bias_act(x, taps, bias, padding=1)
    g = torch.randn(y.shape, generator=gen).to(cuda)
    _grads_match(backward.conv_bias_act_bwd, (g, x, taps, bias, y), dict(padding=1), "k3 conv")
    args, kw = _k2b_site(cuda, "env.in", 5)
    _grads_match(backward.conv_bias_act_bwd, args, kw, "env.in with dx", same_without_dx=False)
    args, kw = _k2b_site(cuda, "range.out", 261)
    got = backward.conv_bias_act_bwd(*args, **kw, general=True)
    want = backward.conv_bias_act_bwd_ref(*args, **kw)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"range.out general kernel gradient {i}")
    assert not calls
    assert _device_kernel_names(
        lambda: backward.conv_bias_act_bwd(*args, **kw, general=True)) == {
        "conv_bias_act_bwd_kernel", "iins::reduce_partials_kernel"}


def _k2_site(cuda, site, batch):
    """(x, taps, bias, kw) of K2 at one of its call sites, on the flagship's seeded weights and
    a seeded x at the batch."""
    (l, c), pad, mode, _ = K2B_SITES[site]
    m = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(8)).to(cuda)
    taps, bias = {"range.out": (m.encoder.range_encoder.out_kernel,
                                m.encoder.range_encoder.out_bias),
                  "env.in": (m.encoder.env_encoder.ConvINAct_0.kernel,
                             m.encoder.env_encoder.ConvINAct_0.bias),
                  "dec.in": (m.decoder.decoder.in_kernel, m.decoder.decoder.in_bias)}[site]
    x = torch.randn((batch, l, c), generator=torch.Generator().manual_seed(batch)).to(cuda)
    return x, taps.detach(), bias.detach(), dict(padding=pad, pad_mode=mode)


@pytest.mark.gpu
@pytest.mark.parametrize("site", list(K2B_SITES))
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_conv_bias_act_sites_are_bit_equal_to_the_general_kernel(cuda, batch, site):
    """K2 at its three call sites runs a kernel of its own (csrc/in_chain.cu, namespace cba: tiles
    of 2 samples at 1, 5 and 261, of 4 at 500, the last tile short at 1, 5 and 261): one launch a
    call, within tolerance of the plain version, bit-equal to the general kernel on the same
    inputs and over two calls."""
    x, taps, bias, kw = _k2_site(cuda, site, batch)
    assert fused.cba_site(fused.stage_rows(x, [(taps, 1, kw["padding"], kw["pad_mode"])])[0]) \
        == site
    with torch.no_grad():
        n = fused.conv_bias_act.launches
        got = fused.conv_bias_act(x, taps, bias, **kw)
        assert fused.conv_bias_act.launches == n + 1
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, fused.conv_bias_act_ref(x, taps, bias, **kw), rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(got, fused.launch_conv_bias_act(x, taps, bias, 1, kw["padding"],
                                                           kw["pad_mode"], general=True))
        assert torch.equal(got, fused.conv_bias_act(x, taps, bias, **kw))
        assert _device_kernel_names(lambda: fused.conv_bias_act(x, taps, bias, **kw)) == {
            "cba::cba_fwd_kernel"}
        assert _device_kernel_names(lambda: fused.launch_conv_bias_act(
            x, taps, bias, 1, kw["padding"], kw["pad_mode"], general=True)) == {
            "conv_bias_act_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("site", list(K2B_SITES))
def test_gpu_conv_bias_act_under_autograd_feeds_k2b_the_sites_y(cuda, site):
    """In training (autograd.ConvBiasAct) K2's call sites run the same kernel: y bit-equal to the
    serving call's, and the gradients autograd gives bit-equal to K2b's on that y (dx where the
    step asks for it: not at env.in, whose input is the pooled CIR)."""
    x, taps, bias, kw = _k2_site(cuda, site, 261)
    need_dx = K2B_SITES[site][3]
    with torch.no_grad():
        y_serving = fused.conv_bias_act(x, taps, bias, **kw)
    leaves = [x.clone().requires_grad_(need_dx), taps.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    n = fused.conv_bias_act.launches
    y = fused.conv_bias_act(*leaves, **kw)
    assert fused.conv_bias_act.launches == n + 1
    assert torch.equal(y.detach(), y_serving)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(9)).to(cuda)
    y.backward(g)
    want = backward.conv_bias_act_bwd(g, x, taps, bias, y_serving, **kw, need_dx=need_dx)
    got = [leaf.grad for leaf in leaves]
    for i, (a, w) in enumerate(zip(got, want)):
        assert (a is None) == (w is None) and (a is None or torch.equal(a, w)), (site, i)


@pytest.mark.gpu
def test_gpu_conv_bias_act_sites_reject_what_their_kernel_does_not_take(cuda):
    """K2's call-site kernel raises, rather than take another kernel, on an x, taps or bias that is
    not 16-byte aligned (a view 4 bytes into a buffer) and on float64 operands; the general
    kernel (``general=True``) still takes the unaligned ones."""
    def unaligned(t):
        u = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        u.copy_(t)
        return u

    x, taps, bias, kw = _k2_site(cuda, "dec.in", 5)
    with torch.no_grad():
        for i in range(3):
            args = [x, taps, bias]
            args[i] = unaligned(args[i])
            with pytest.raises(ValueError):
                fused.conv_bias_act(*args, **kw)
            assert torch.equal(fused.launch_conv_bias_act(*args, 1, 0, "zero", general=True),
                               fused.conv_bias_act(x, taps, bias, **kw))
        with pytest.raises(TypeError):
            fused.conv_bias_act(x.double(), taps.double(), bias.double(), **kw)


@pytest.mark.gpu
def test_gpu_range_chain_and_k2b_site_paths_reject_what_their_kernels_do_not_take(cuda):
    """K1's range-chain path and K2b's site path raise, rather than take another kernel, on an x,
    y or g that is not 16-byte aligned (a view 4 bytes into a buffer) and on operands of the
    wrong shape."""
    def unaligned(t):
        u = torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape)
        u.copy_(t)
        return u

    stages, x = _range_chain(cuda, "range.pair1", 5)
    with torch.no_grad():
        assert fused.in_chain(x, stages).shape == (5, 16, 32)
        with pytest.raises(ValueError):
            fused.in_chain(unaligned(x), stages)
        with pytest.raises(ValueError):  # taps that do not take the input's channels
            fused.in_chain(x, [(stages[0][0][:, :4].contiguous(), *stages[0][1:]), stages[1]])
    (g, x, taps, bias, y), kw = _k2b_site(cuda, "range.out", 5)
    for i in (0, 1, 4):  # g, x, y
        args = [g, x, taps, bias, y]
        args[i] = unaligned(args[i])
        with pytest.raises(ValueError):
            backward.conv_bias_act_bwd(*args, **kw)
    with pytest.raises(ValueError):  # y of another shape than g
        backward.conv_bias_act_bwd(g, x, taps, bias, y[:, :4].contiguous(), **kw)
    with pytest.raises(ValueError):  # g of another batch
        backward.conv_bias_act_bwd(g[:4].contiguous(), x, taps, bias, y, **kw)


# K4b's call sites: the 1-D restorer, the classifier and the 2-D restorer
MLP_HEADS = {"restorer": (1, "restorer"), "classifier": (1, "classifier"),
             "restorer.2d": (2, "restorer"), "restorer.soft": ("soft", "restorer"),
             "restorer.2d.soft": ("soft2d", "restorer")}


@pytest.mark.gpu
@pytest.mark.parametrize("head", list(MLP_HEADS))
@pytest.mark.parametrize("batch", [1, 5, 261, 500])
def test_gpu_mlp_chain_backward_matches_plain(cuda, batch, head):
    """K4b at its three heads, batches that leave the tiles of samples and the chunks of the
    weight gradient short: against the plain version, bit-equal over two calls and without dx,
    from the pre-activations K4 saved."""
    conv_type, attr = MLP_HEADS[head]
    model = IInsVAE(**MODELS[conv_type]).to(cuda)
    mod = getattr(getattr(model, attr), attr)
    n = len(mod.slopes)
    ws = [getattr(mod, f"w{j}") for j in range(n)]
    bs = [getattr(mod, f"b{j}") for j in range(n)]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, ws[0].shape[0]), generator=gen).to(cuda)
    with torch.no_grad():
        _, ds = fused.launch_mlp_chain(x, ws, bs, mod.slopes, save_pre=True)
    g = torch.randn((batch, ws[-1].shape[1]), generator=gen).to(cuda)
    _grads_match(backward.mlp_chain_bwd, (g, x, ws, bs, mod.slopes, ds), {},
                 f"{head} batch {batch}")


# (widths, slopes) of chains no head has, on K4b's layer path (a width over 64): a last layer
# 12 wide, one layer 9 or 4 wide, and widths no multiple of 4 (4-byte staging) with 16-input
# chain tiles
MLP_OTHER = {"wide_out": ((32, 96, 12), (0.2, 0.1)), "one_wide": ((80, 9), (0.3,)),
             "one_narrow": ((100, 4), (0.3,)), "two_narrow": ((20, 70, 3), (0.2, 1.0))}


@pytest.mark.gpu
@pytest.mark.parametrize("chain", list(MLP_OTHER))
@pytest.mark.parametrize("batch", [7, 300])
def test_gpu_mlp_chain_backward_other_widths_match_plain(cuda, batch, chain):
    """K4b's layer path at widths the heads do not give, against the plain version, bit-equal
    over two calls and without dx."""
    dims, slopes = MLP_OTHER[chain]
    gen = torch.Generator().manual_seed(batch)
    ws = [(torch.randn((a, k), generator=gen) / a ** 0.5).to(cuda) for a, k in zip(dims, dims[1:])]
    bs = [(0.1 * torch.randn(k, generator=gen)).to(cuda) for k in dims[1:]]
    x = torch.randn((batch, dims[0]), generator=gen).to(cuda)
    with torch.no_grad():
        _, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
    g = torch.randn((batch, dims[-1]), generator=gen).to(cuda)
    _grads_match(backward.mlp_chain_bwd, (g, x, ws, bs, slopes, ds), {}, f"{chain} batch {batch}")


@pytest.mark.gpu
def test_gpu_backward_wrappers_reject_what_the_kernels_do_not_take(cuda):
    m = IInsVAE(**FLAGSHIP).to(cuda)
    re_, dec = m.encoder.range_encoder, m.decoder.decoder
    x = torch.randn((4, 8, 64), device=cuda)
    g = torch.randn((4, 8, 64), device=cuda)
    block = [(re_.res0_kernel1, 1, 1, "reflect"), (re_.res0_kernel2, 1, 1, "reflect")]
    with pytest.raises(ValueError):  # g of another shape than the output
        backward.in_chain_bwd(g[:, :4].contiguous(), x, block, residual=True)
    with pytest.raises(TypeError):
        backward.in_chain_bwd(g.double(), x.double(), [(t.double(), *r) for t, *r in block],
                              residual=True)
    with pytest.raises(ValueError):  # three stages
        backward.in_chain_bwd(g, x, block + block[:1])
    with pytest.raises(ValueError):  # C_out not a multiple of 4
        backward.in_chain_bwd(torch.zeros((4, 8, 2), device=cuda), x,
                              [(re_.out_kernel.detach().repeat(3, 1, 1), 1, 1, "reflect")])
    affine = [torch.randn((4, 64), device=cuda) for _ in range(4)]
    with pytest.raises(ValueError):  # tables of another batch
        backward.adain_res_block_bwd(g, x, dec.res0_kernel1, dec.res0_kernel2, affine[0][:3],
                                     *affine[1:])
    y = torch.zeros((4, 8, 2), device=cuda)
    with pytest.raises(ValueError):  # y of another shape than g
        backward.conv_bias_act_bwd(torch.zeros((4, 8, 2), device=cuda), x, re_.out_kernel,
                                   re_.out_bias, y[:, :4])
    with pytest.raises(ValueError):  # not a k4 conv
        backward.strided_conv_bwd(g, x, re_.res0_kernel1, torch.zeros(64, device=cuda), g)
    xs, taps = torch.randn((4, 16, 32), device=cuda), torch.randn((4, 32, 64), device=cuda)
    gs, bias = torch.randn((4, 8, 64), device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(ValueError):  # g of another length than the output
        backward.strided_conv_bwd(gs[:, :4].contiguous(), xs, taps, bias, gs[:, :4].contiguous())
    with pytest.raises(TypeError):
        backward.strided_conv_bwd(gs.double(), xs.double(), taps.double(), bias.double(),
                                  gs.double())
    with pytest.raises(ValueError):  # C_in not a multiple of 4
        backward.strided_conv_bwd(gs, xs[:, :, :30].contiguous(), taps[:, :30].contiguous(),
                                  bias, gs)
    with pytest.raises(ValueError):  # non-contiguous
        backward.strided_conv_bwd(gs.transpose(0, 1).contiguous().transpose(0, 1), xs, taps,
                                  bias, gs)
    head = m.restorer.restorer
    ws = [getattr(head, f"w{j}") for j in range(4)]
    bs = [getattr(head, f"b{j}") for j in range(4)]
    xr = torch.randn((4, 16), device=cuda)
    with pytest.raises(ValueError):  # no saved pre-activations
        backward.mlp_chain_bwd(torch.zeros((4, 1), device=cuda), xr, ws, bs, head.slopes, [])
    stages = [tuple(getattr(dec, f"up{j}_{n}") for n in ("kernel", "bias", "gamma", "beta"))
              for j in range(4)]
    with pytest.raises(ValueError):  # g of another length than the pool
        backward.sln_chain_bwd(torch.zeros((4, 150), device=cuda), x, stages, dec.out_kernel,
                               dec.out_bias, 157)
    with pytest.raises(ValueError):  # three stages
        backward.sln_chain_bwd(torch.zeros((4, 157), device=cuda), x, stages[:3],
                               dec.out_kernel, dec.out_bias, 157)


@pytest.mark.gpu
@pytest.mark.parametrize("adain", [False, True])
@pytest.mark.parametrize("b", [500, 261, 5, 1])
def test_gpu_res_block_2d_and_its_backward_match_plain(cuda, b, adain):
    """K7 and K7b at batches with a whole number of tiles of two samples, a
    ragged last tile and one sample, IN and AdaIN. K7 against the plain
    version; when it saves d1 and d2 its y is bit-equal and d1, d2 match the
    plain convs. K7b reading them is bit-equal over two calls, gives no dx
    without need_dx (and the same other gradients), and matches autograd
    through the plain block on the samples whose ReLU mask rounding cannot
    decide (_clear_samples, at least half of the batch; where some are not
    clear, K7b runs again on the clear ones alone)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, 8, 8, 64), generator=gen).to(cuda)
    k1, k2 = (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda), \
        (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda)
    affine = [torch.randn((b, 64), generator=gen).to(cuda) for _ in range(4)] if adain else []
    g = torch.randn((b, 8, 8, 64), generator=gen).to(cuda)
    torch.testing.assert_close(res2d.res_block_2d(x, k1, k2, *affine),
                               res2d.res_block_2d_ref(x, k1, k2, *affine), rtol=RTOL, atol=ATOL)
    y, d1, d2 = res2d.launch_res_block_2d(x, k1, k2, *affine, save=True)
    assert torch.equal(y, res2d.launch_res_block_2d(x, k1, k2, *affine))
    _, p1, p2 = res2d.res_block_2d_ref(x, k1, k2, *affine, save=True)
    torch.testing.assert_close(d1, p1, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(d2, p2, rtol=RTOL, atol=ATOL)
    got = backward.res_block_2d_bwd(g, x, k1, k2, *affine, saved=(d1, d2))
    again = backward.res_block_2d_bwd(g, x, k1, k2, *affine, saved=(d1, d2))
    assert len(got) == 3 + len(affine)
    assert all(torch.isfinite(a).all() and torch.equal(a, c) for a, c in zip(got, again))
    no_dx = backward.res_block_2d_bwd(g, x, k1, k2, *affine, saved=(d1, d2), need_dx=False)
    assert no_dx[0] is None and all(torch.equal(a, c) for a, c in zip(no_dx[1:], got[1:]))
    keep = _clear_samples(x, k1, *affine)
    assert 2 * len(keep) >= b, f"{len(keep)} of {b} samples clear"
    if len(keep) < b:
        x, g, d1, d2 = (t[keep] for t in (x, g, d1, d2))
        affine = [t[keep] for t in affine]
        got = backward.res_block_2d_bwd(g, x, k1, k2, *affine, saved=(d1, d2))
    want = backward.res_block_2d_bwd_ref(g, x, k1, k2, *affine)
    for i, (a, w) in enumerate(zip(got, want)):
        _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"res_block_2d_bwd gradient {i}")


@pytest.mark.gpu
@pytest.mark.parametrize("adain", [False, True])
@pytest.mark.parametrize("b", [500, 261, 5, 1])
def test_gpu_res_block_2d_is_as_accurate_as_the_plain_fp32_block(cuda, b, adain):
    """K7 runs both convs on the tensor cores in 3xTF32. The d1 it saves, and its d2 and y,
    against the float64 block: each largest error at most twice the plain fp32 block's on the
    card (its convs fp32 matrix products, TF32 off)."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, 8, 8, 64), generator=gen).to(cuda)
    k1, k2 = (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda), \
        (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda)
    affine = [torch.randn((b, 64), generator=gen).to(cuda) for _ in range(4)] if adain else []
    got = res2d.launch_res_block_2d(x, k1, k2, *affine, save=True)
    plain = res2d.res_block_2d_ref(x, k1, k2, *affine, save=True)
    want = res2d.res_block_2d_ref(*(t.double() for t in (x, k1, k2, *affine)), save=True)
    for name, a, p, w in zip(("y", "d1", "d2"), got, plain, want):
        err, err_plain = ((t.double() - w).abs().max().item() for t in (a, p))
        assert err <= 2 * err_plain, \
            f"{name}: {err:.3e} against float64, plain fp32 {err_plain:.3e}"


@pytest.mark.gpu
@pytest.mark.parametrize("adain", [False, True])
@pytest.mark.parametrize("b", [500, 261, 5, 1])
def test_gpu_res_block_2d_backward_is_as_accurate_as_the_plain_fp32_block(cuda, b, adain):
    """K7b runs its four products on the tensor cores in 3xTF32, reading the d1, d2 that K7
    saved. Each of its gradients against autograd through the float64 block: the largest
    error at most twice the plain fp32 backward's on the card (TF32 off). On the samples
    whose ReLU mask rounding cannot decide (_clear_samples): elsewhere the mask, not the
    summation, sets the error."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((b, 8, 8, 64), generator=gen).to(cuda)
    k1, k2 = (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda), \
        (0.05 * torch.randn((3, 3, 64, 64), generator=gen)).to(cuda)
    affine = [torch.randn((b, 64), generator=gen).to(cuda) for _ in range(4)] if adain else []
    g = torch.randn((b, 8, 8, 64), generator=gen).to(cuda)
    keep = _clear_samples(x, k1, *affine)
    assert 2 * len(keep) >= b, f"{len(keep)} of {b} samples clear"
    x, g = x[keep].contiguous(), g[keep].contiguous()
    affine = [t[keep].contiguous() for t in affine]
    _, d1, d2 = res2d.launch_res_block_2d(x, k1, k2, *affine, save=True)
    got = backward.res_block_2d_bwd(g, x, k1, k2, *affine, saved=(d1, d2))
    plain = backward.res_block_2d_bwd_ref(g, x, k1, k2, *affine)
    want = backward.res_block_2d_bwd_ref(*(t.double() for t in (g, x, k1, k2, *affine)))
    names = ("dx", "dk1", "dk2", "dgamma1", "dbeta1", "dgamma2", "dbeta2")
    for name, a, p, w in zip(names, got, plain, want):
        err, err_plain = ((t.double() - w).abs().max().item() for t in (a, p))
        assert err <= 2 * err_plain, \
            f"{name}: {err:.3e} against float64, plain fp32 {err_plain:.3e}"


@pytest.mark.gpu
def test_gpu_res_block_2d_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn((4, 8, 8, 64), device=cuda)
    k = torch.randn((3, 3, 64, 64), device=cuda)
    t = [torch.randn((4, 64), device=cuda) for _ in range(4)]
    with pytest.raises(TypeError):
        res2d.res_block_2d(x.double(), k.double(), k.double())
    with pytest.raises(ValueError):  # another field than (8, 8, 64)
        res2d.res_block_2d(x[:, :4].contiguous(), k, k)
    with pytest.raises(ValueError):  # taps that are not (3, 3, 64, 64)
        res2d.res_block_2d(x, k[:2], k)
    with pytest.raises(ValueError):  # two tables, not four
        res2d.res_block_2d(x, k, k, *t[:2])
    with pytest.raises(ValueError):  # tables of another batch
        res2d.res_block_2d(x, k, k, t[0][:3], *t[1:])
    with pytest.raises(ValueError):  # non-contiguous
        res2d.res_block_2d(x.transpose(1, 2), k, k)
    with pytest.raises(ValueError):  # g of another shape than x
        backward.res_block_2d_bwd(x[:3].contiguous(), x, k, k, saved=(x, x))
    with pytest.raises(ValueError):  # no saved d1, d2
        backward.res_block_2d_bwd(x, x, k, k)
    with pytest.raises(ValueError):  # d1 of another batch
        backward.res_block_2d_bwd(x, x, k, k, saved=(x[:3].contiguous(), x))
    with pytest.raises(ValueError):  # d2 of another field
        backward.res_block_2d_bwd(x, x, k, k, saved=(x, x[:, :4].contiguous()))
    with pytest.raises(ValueError):  # one tensor, not the pair
        backward.res_block_2d_bwd(x, x, k, k, saved=(x,))
    with pytest.raises(TypeError):  # float64 saves
        backward.res_block_2d_bwd(x, x, k, k, saved=(x.double(), x.double()))
    with pytest.raises(ValueError):  # non-contiguous d1
        backward.res_block_2d_bwd(x, x, k, k, saved=(x.transpose(1, 2), x))


def _one_stage_ops(cuda, b):
    """K8-K10 at the flagship decoder's shapes, seeded decoder weights and
    inputs at batch b: the AdaIN block's two halves (relu; none with the
    block input as residual), the four up-stages (8, 64) -> (16, 32) -> (32,
    16) -> (64, 8) -> (128, 4), the tail (128, 4) -> k7 reflect -> pool 157.
    name -> (forward, its plain version, backward(g, need_dx), its plain
    version)."""
    dec = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(4)).decoder.decoder
    dec = dec.to(cuda).requires_grad_(False)
    gen = torch.Generator().manual_seed(b)

    def rand(*shape):
        return torch.randn(shape, generator=gen).to(cuda)

    def op(fwd, fwd_ref, bwd, bwd_ref, args, kw, bwd_kw):
        return (lambda: fwd(*args, **kw), lambda: fwd_ref(*args, **kw),
                lambda g, need_dx=True: bwd(g, *args, **bwd_kw, need_dx=need_dx),
                lambda g, need_dx=True: bwd_ref(g, *args, **bwd_kw, need_dx=need_dx))

    x, y = rand(b, 8, 64), rand(b, 8, 64)
    ops = {}
    for name, inp, taps, act, res in (("adain_relu", x, dec.res0_kernel1, "relu", None),
                                      ("adain_res", y, dec.res0_kernel2, "none", x)):
        geo = dict(padding=1, pad_mode="reflect", act=act)
        ops[name] = op(fused.adain_layer, fused.adain_layer_ref, backward.adain_layer_bwd,
                       backward.adain_layer_bwd_ref, (inp, taps, rand(b, 64), rand(b, 64)),
                       dict(geo, residual=res), geo)
    l, c = 8, 64
    for j in range(4):
        args = (rand(b, l, c), *(getattr(dec, f"up{j}_{n}") for n in ("kernel", "gamma", "beta")))
        ops[f"sln{j}"] = op(fused.sln_layer, fused.sln_layer_ref, backward.sln_layer_bwd,
                            backward.sln_layer_bwd_ref, args, {}, {})
        l, c = 2 * l, c // 2
    geo = dict(padding=3, pad_mode="reflect")
    ops["tail"] = op(fused.tanh_pool, fused.tanh_pool_ref, backward.tanh_pool_bwd,
                     backward.tanh_pool_bwd_ref,
                     (rand(b, l, c), dec.out_kernel, dec.out_bias,
                      adaptive_avg_pool_matrix(l, 157, device=cuda)), geo, geo)
    return ops


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 500])
def test_gpu_one_stage_kernels_and_their_backward_match_plain(cuda, batch):
    """K8-K10 and K8b-K10b at every flagship decoder shape against the plain
    versions (at batch 5 a block holds a ragged tile), each backward
    bit-reproducible across two calls."""
    gen = torch.Generator().manual_seed(batch + 1)
    for name, (fwd, fwd_ref, bwd, bwd_ref) in _one_stage_ops(cuda, batch).items():
        got = fwd()
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, fwd_ref(), rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{name}: {m}")
        g = torch.randn(got.shape, generator=gen).to(cuda)
        first, want = _tensors(bwd(g)), _tensors(bwd_ref(g))
        assert len(first) == len(want), name
        for i, (a, w) in enumerate(zip(first, want)):
            assert torch.isfinite(a).all(), (name, i)
            _close_scaled(a, w, BWD_RTOL, BWD_ATOL, f"{name} gradient {i}")
        for i, (a, b) in enumerate(zip(first, _tensors(bwd(g)))):
            assert torch.equal(a, b), (name, i)
        assert bwd(g, need_dx=False)[0] is None


@pytest.mark.gpu
def test_gpu_one_stage_kernels_compose_into_adain_res_block_and_sln_chain(cuda):
    """Two K8 calls (relu; none with the block input as residual) are one K5
    call; four K9 calls and K10 with the adaptive pool matrix are K6 with
    zero stage biases."""
    dec, x, (g1, b1, g2, b2), stages = _decoder_inputs(cuda, b=37)
    k1, k2, ko, bo = dec.res0_kernel1, dec.res0_kernel2, dec.out_kernel, dec.out_bias
    with torch.no_grad():
        geo = dict(padding=1, pad_mode="reflect")
        y = fused.adain_layer(x, k1, g1, b1, act="relu", **geo)
        y = fused.adain_layer(y, k2, g2, b2, act="none", residual=x, **geo)
        torch.testing.assert_close(y, fused.adain_res_block(x, k1, k2, g1, b1, g2, b2),
                                   rtol=RTOL, atol=ATOL)
        zero = [(t, torch.zeros_like(bias), g, b) for t, bias, g, b in stages]
        z = x
        for taps, _, gamma, beta in zero:
            z = fused.sln_layer(z, taps, gamma, beta)
        pool = adaptive_avg_pool_matrix(z.shape[1], 157, device=cuda)
        torch.testing.assert_close(fused.tanh_pool(z, ko, bo, pool, padding=3, pad_mode="reflect"),
                                   fused.sln_chain(x, zero, ko, bo, 157), rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_gpu_one_stage_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x, k = torch.randn((4, 8, 64), device=cuda), torch.randn((3, 64, 64), device=cuda)
    t = torch.randn((4, 64), device=cuda)
    geo = dict(padding=1, pad_mode="reflect")
    with pytest.raises(TypeError):
        fused.adain_layer(x.double(), k.double(), t.double(), t.double(), **geo)
    with pytest.raises(ValueError):  # tables of another batch
        fused.adain_layer(x, k, t[:3], t, **geo)
    with pytest.raises(ValueError):  # C_out not a multiple of 4
        fused.adain_layer(x, k[:, :, :62].contiguous(), t[:, :62].contiguous(),
                          t[:, :62].contiguous(), **geo)
    with pytest.raises(ValueError):  # a residual of another shape than the output
        fused.adain_layer(x, k, t, t, residual=x[:, :4].contiguous(), **geo)
    with pytest.raises(ValueError):
        fused.adain_layer(x, k, t, t, act="gelu", **geo)
    with pytest.raises(ValueError):  # non-contiguous
        fused.adain_layer(x.transpose(1, 2).contiguous().transpose(1, 2), k, t, t, **geo)
    with pytest.raises(ValueError):  # g of another shape than the output
        backward.adain_layer_bwd(x[:3].contiguous(), x, k, t, t, **geo)
    assert torch.isfinite(fused.adain_layer(x, k, t, t, act="relu", residual=x, **geo)).all()

    up, v = torch.randn((5, 64, 32), device=cuda), torch.randn(32, device=cuda)
    with pytest.raises(TypeError):
        fused.sln_layer(x.double(), up.double(), v.double(), v.double())
    with pytest.raises(ValueError):  # not a k5 conv
        fused.sln_layer(x, up[:3].contiguous(), v, v)
    with pytest.raises(ValueError):  # gamma of another width than C_out
        fused.sln_layer(x, up, v[:16].contiguous(), v)
    with pytest.raises(ValueError):  # C_out not a multiple of 4
        fused.sln_layer(x, up[:, :, :30].contiguous(), v[:30].contiguous(), v[:30].contiguous())
    with pytest.raises(ValueError):  # g of another shape than the output
        backward.sln_layer_bwd(x, x, up, v, v)
    assert fused.sln_layer(x, up, v, v).shape == (4, 16, 32)

    xt, ko = torch.randn((4, 128, 4), device=cuda), torch.randn((7, 4, 1), device=cuda)
    bo, pool = torch.randn(1, device=cuda), torch.randn((128, 157), device=cuda)
    tail = dict(padding=3, pad_mode="reflect")
    with pytest.raises(TypeError):
        fused.tanh_pool(xt.double(), ko.double(), bo.double(), pool.double(), **tail)
    with pytest.raises(ValueError):  # a pool matrix of another height than L * C_mid
        fused.tanh_pool(xt, ko, bo, pool[:100], **tail)
    with pytest.raises(ValueError):  # bias of another width than C_mid
        fused.tanh_pool(xt, ko, torch.zeros(2, device=cuda), pool, **tail)
    with pytest.raises(ValueError):  # a reflect pad as long as the input
        fused.tanh_pool(xt[:, :3].contiguous(), ko, bo, pool[:3], **tail)
    with pytest.raises(ValueError):  # g of another length than the pool's
        backward.tanh_pool_bwd(torch.zeros((4, 150), device=cuda), xt, ko, bo, pool, **tail)
    assert fused.tanh_pool(xt, ko, bo, pool, **tail).shape == (4, 157)


# The joint path (EMNet, nlos: 2 classes): one step's launches a kernel, forward and backward.
# Linear heads: K1 6 (the range encoder), K2 2 (range.out, env.in), K3 2 (the env stages), K4 2
# (the heads); the Conv heads are plain ops, so K4 does not run.
JOINT_STEP = {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("net,heads", [("EMNet", "Linear"), ("EMNetLoop", "Conv1d")])
def test_gpu_joint_step_gradients_match_cpu(cuda, net, heads):
    """One joint step of EMNet (Linear heads) and EMNetLoop (Conv1d heads, so BatchNormEps and
    Dropout run on the card, on injected masks) on the card and on the CPU (fp32), each against
    the CPU port in float64: loss, every gradient and the running stats after the step, held as
    test_gpu_training_step_gradients_match_cpu holds them; its launches counted."""
    cpu = getattr(emnet, net)(num_classes=2, enet_type=heads, mnet_type=heads,
                              generator=torch.Generator().manual_seed(9))
    gpu, f64 = copy.deepcopy(cpu).to(cuda), copy.deepcopy(cpu).double()
    data, _ = _train_batch(64, cuda, seed=2)
    data["label"] = (data["label"] % 2)
    masks = draw_dropout_masks(cpu, torch.Generator().manual_seed(3), data["cir"].cpu())
    assert len(masks) == (0 if heads == "Linear" else 4)
    grads_fn = steps.make_joint_grads_fn()
    kernels.reset_launch_counts()
    mg = grads_fn(gpu, data, dropout_masks={k: v.to(cuda) for k, v in masks.items()})
    torch.cuda.synchronize()
    want = {k: v - (k == "mlp_chain" and heads != "Linear") * 2 for k, v in JOINT_STEP.items()}
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        k: v for k, v in want.items() if v}
    assert {k: v for k, v in kernels.backward_launch_counts().items() if v} == {
        f"{k}_bwd": v for k, v in want.items() if v}
    grads_fn(cpu, {k: v.cpu() for k, v in data.items()}, dropout_masks=masks)
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in data.items()}, dropout_masks=masks)
    for k in ("loss", "loss_idy", "loss_reg"):
        assert mg[k].item() == pytest.approx(m64[k].item(), rel=1e-4, abs=1e-6), k
    fp32, ref = dict(cpu.named_parameters()), dict(f64.named_parameters())
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        e_card = (p.grad.cpu().double() - want).abs().max().item()
        e_cpu = (fp32[name].grad.double() - want).abs().max().item()
        assert e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * want.abs().max().item(), name
    fp32, ref = dict(cpu.named_buffers()), dict(f64.named_buffers())
    for name, b in gpu.named_buffers():
        want = ref[name]
        e_card = (b.cpu().double() - want).abs().max().item()
        e_cpu = (fp32[name].double() - want).abs().max().item()
        assert e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * want.abs().max().item(), name


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 7, 300, 500])
def test_gpu_mlp_chain_two_class_classifier_matches_plain(cuda, batch):
    """K4 and K4b at the classifier of the joint path's default environment (nlos, 2 classes:
    16 -> 16 -> 32 -> 16 -> 2), which takes the small-head kernel's <Any> instance: K4 within
    tolerance of the plain version and bit-equal over two calls, one head::mlp_head_kernel a
    call; K4b's gradients against the plain version's."""
    mod = emnet.EMNet(num_classes=2, generator=torch.Generator().manual_seed(6)).to(
        cuda).identifier.classifier
    ws = [getattr(mod, f"w{j}").detach() for j in range(4)]
    bs = [getattr(mod, f"b{j}").detach() for j in range(4)]
    assert [ws[0].shape[0]] + [w.shape[1] for w in ws] == [16, 16, 32, 16, 2]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, 16), generator=gen).to(cuda)
    with torch.no_grad():
        y, ds = fused.launch_mlp_chain(x, ws, bs, mod.slopes, save_pre=True)
        torch.testing.assert_close(y, fused.mlp_chain_ref(x, ws, bs, mod.slopes), rtol=RTOL,
                                   atol=ATOL)
        assert torch.equal(y, fused.mlp_chain(x, ws, bs, mod.slopes))
        assert torch.equal(y, fused.mlp_chain(x, ws, bs, mod.slopes))
        for j, (d, want) in enumerate(zip(ds, _pre_activations(x, ws, bs, mod.slopes))):
            torch.testing.assert_close(d, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"d_{j}: {m}")
    assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, mod.slopes)) == {
        "head::mlp_head_kernel"}
    g = torch.randn((batch, 2), generator=gen).to(cuda)
    _grads_match(backward.mlp_chain_bwd, (g, x, ws, bs, mod.slopes, ds), {},
                 f"2-class classifier batch {batch}")


# ------------------------------ bfloat16 ------------------------------
# The bfloat16 instances of K7, K7b, K4 and K4b (the 2-D model under --compute_dtype bfloat16)
# against float64 on the same bfloat16-rounded inputs, beside their plain bfloat16 versions:
# each tensor's largest error at most BF16_FACTOR times the plain version's plus BF16_FLOOR of
# the float64 tensor's largest magnitude; K7's and K7b's per-sample tensors on the samples whose
# every pre-ReLU value clears MASK_MARGIN (chip_smoke.py's [bf16] phase, the same rule).
BF16 = torch.bfloat16
BF16_FACTOR, BF16_FLOOR = 2.0, 2.0**-9
BF16_STEP = {"res_block_2d": 6, "mlp_chain": 2, "res_block_2d_bwd": 6, "mlp_chain_bwd": 2}


def _bf16_vs_f64(got, plain, f64, rows=None, what=""):
    for i, (a, p, w) in enumerate(zip(got, plain, f64)):
        assert a.shape == w.shape and a.dtype == BF16 and torch.isfinite(a).all(), f"{what} {i}"
        if rows is not None and a.shape[0] == rows.shape[0]:
            a, p, w = a[rows], p[rows], w[rows]
        e, e_plain = ((t.double() - w).abs().max().item() for t in (a, p))
        assert e <= BF16_FACTOR * e_plain + BF16_FLOOR * w.abs().max().item(), \
            f"{what} tensor {i}: {e:.3e} off float64, plain bfloat16 {e_plain:.3e}"


def _bf16_block(cuda, batch, adain_, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, 8, 8, 64), generator=gen).to(BF16).to(cuda)
    k1, k2 = ((0.02 * torch.randn((3, 3, 64, 64), generator=gen)).to(BF16).to(cuda)
              for _ in range(2))
    aff = [torch.randn((batch, 64), generator=gen).to(BF16).to(cuda) for _ in range(4)] \
        if adain_ else []
    g = torch.randn((batch, 8, 8, 64), generator=gen).to(BF16).to(cuda)
    a64 = [t.double() for t in (x, k1, k2, *aff)]
    y64, d1_64, d2_64 = res2d.res_block_2d_ref(*a64, save=True)
    a1 = (adain(d1_64, a64[3], a64[4]) if adain_ else instance_norm(d1_64)).abs().flatten(1)
    rows = a1.amin(dim=1) >= MASK_MARGIN * a1.amax(dim=1)
    assert rows.float().mean().item() >= 0.5
    return (x, k1, k2, *aff), g, a64, (y64, d1_64, d2_64), rows


@pytest.mark.gpu
@pytest.mark.parametrize("adain_", [False, True])
@pytest.mark.parametrize("batch", [1, 5, 263, 500, 1031])
def test_gpu_res_block_2d_bf16_matches_plain_against_float64(cuda, batch, adain_):
    """K7's bfloat16 instance, serving and saving (y bit-equal), and K7b's from its saves,
    against float64 beside the plain bfloat16 versions; one launch a call, one device kernel
    (three for K7b: the input gradients, the taps' gradient and the sum of its partial rows),
    bit-equal over two calls. The batches: one sample (a block with an idle warpgroup), a
    ragged last block, fewer samples than SMs, the model's 500, and more than one sample a
    warpgroup and a taps' gradient block beyond a whole round."""
    args, g, a64, f64, rows = _bf16_block(cuda, batch, adain_)
    n = res2d.res_block_2d.launches_bf16
    y, d1, d2 = res2d.launch_res_block_2d(*args, save=True)
    assert res2d.res_block_2d.launches_bf16 == n + 1
    assert torch.equal(y, res2d.launch_res_block_2d(*args))
    _bf16_vs_f64((y, d1, d2), res2d.res_block_2d_bf16_ref(*args, save=True), f64, rows, "K7")
    assert _device_kernel_names(lambda: res2d.launch_res_block_2d(*args)) == {
        "res2d_bf16_wgmma_kernel"}
    n = backward.res_block_2d_bwd.launches_bf16
    got = _tensors(backward.res_block_2d_bwd(g, *args, saved=(d1, d2)))
    assert backward.res_block_2d_bwd.launches_bf16 == n + 1
    plain = _tensors(backward.res_block_2d_bwd_bf16_ref(g, *args, saved=(d1, d2)))
    ref = _tensors(backward.res_block_2d_bwd_closed(g.double(), *a64, saved=f64[1:]))
    _bf16_vs_f64(got, plain, ref, rows, "K7b")
    assert all(torch.equal(a, b) for a, b in zip(
        got, _tensors(backward.res_block_2d_bwd(g, *args, saved=(d1, d2)))))
    assert _device_kernel_names(lambda: backward.res_block_2d_bwd(g, *args, saved=(d1, d2))) \
        == {"res2d_bf16_bwd_wgmma_kernel", "res2d_bf16_dk_kernel", "reduce_rows_bf16_kernel"}


@pytest.mark.gpu
@pytest.mark.parametrize("adain_", [False, True])
def test_gpu_res_block_2d_bf16_backward_is_bit_equal_over_two_calls_at_1031(cuda, adain_):
    """K7b's bfloat16 instance at batch 1031 (more samples than a round of the persistent grid
    and of the taps' gradient's clusters): two calls give bit-equal gradients, the taps'
    gradient included (partial rows summed in a fixed order, no atomics), and d1, d2 saved
    twice are bit-equal too."""
    args, g, _, _, _ = _bf16_block(cuda, 1031, adain_, seed=5)
    y, d1, d2 = res2d.launch_res_block_2d(*args, save=True)
    y_, d1_, d2_ = res2d.launch_res_block_2d(*args, save=True)
    assert torch.equal(y, y_) and torch.equal(d1, d1_) and torch.equal(d2, d2_)
    first = _tensors(backward.res_block_2d_bwd(g, *args, saved=(d1, d2)))
    for _ in range(2):
        again = _tensors(backward.res_block_2d_bwd(g, *args, saved=(d1, d2)))
        assert len(again) == len(first) and all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("adain_", [False, True])
def test_gpu_res_block_2d_bf16_save_writes_what_k7b_reads(cuda, monkeypatch, adain_):
    """Under autograd K7's bfloat16 saving instance writes d1 and d2, and K7b reads exactly
    those: the tensors autograd.ResBlock2d hands the backward are bit-equal to a saving
    launch's, and its y to the serving launch's."""
    args, g, _, _, _ = _bf16_block(cuda, 37, adain_, seed=3)
    seen = []
    real = backward.res_block_2d_bwd

    def record(*a, saved=None, **kw):
        seen.append(saved)
        return real(*a, saved=saved, **kw)

    record.launches = record.launches_bf16 = 0  # the wrapper counts on its module name
    monkeypatch.setattr(backward, "res_block_2d_bwd", record)
    leaves = [t.clone().requires_grad_(True) for t in args]
    y = res2d.res_block_2d(*leaves)
    y.backward(g)
    y0, d1, d2 = res2d.launch_res_block_2d(*args, save=True)
    assert len(seen) == 1 and torch.equal(y.detach(), y0)
    assert torch.equal(seen[0][0], d1) and torch.equal(seen[0][1], d2)
    assert all(t.grad.dtype == BF16 and torch.isfinite(t.grad).all() for t in leaves)


@pytest.mark.gpu
@pytest.mark.parametrize("head", ["restorer", "classifier"])
@pytest.mark.parametrize("batch", [5, 500])
def test_gpu_mlp_chain_bf16_matches_plain_against_float64(cuda, batch, head):
    """K4's and K4b's bfloat16 instances at the 2-D restorer (128 -> 512 -> 256 -> 256 -> 1)
    and the classifier, on the model's weights rounded to bfloat16, against float64 beside the
    plain bfloat16 versions (K4b from the d_j that K4 saved); the bfloat16 instances of the
    float32 paths' kernels: K4 the cluster kernel at the restorer and the head kernel at the
    classifier, K4b one launch a layer, the weight gradient and the partial rows' sum at the
    restorer, the small-head kernel and the sum at the classifier."""
    model = IInsVAE(**MODELS[2], generator=torch.Generator().manual_seed(4)).to(cuda)
    mod = getattr(model, head)
    mod = getattr(mod, head)
    n, slopes = len(mod.slopes), mod.slopes
    ws = [getattr(mod, f"w{j}").detach().to(BF16) for j in range(n)]
    bs = [getattr(mod, f"b{j}").detach().to(BF16) for j in range(n)]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, ws[0].shape[0]), generator=gen).to(BF16).to(cuda)
    g = torch.randn((batch, ws[-1].shape[1]), generator=gen).to(BF16).to(cuda)
    m = fused.mlp_chain.launches_bf16
    y, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
    assert fused.mlp_chain.launches_bf16 == m + 1
    assert torch.equal(y, fused.mlp_chain(x, ws, bs, slopes))
    h, ds64 = x.double(), []
    for w, v, s in zip(ws, bs, slopes):
        ds64.append(h @ w.double() + v.double())
        h = ds64[-1] if s == 1.0 else torch.nn.functional.leaky_relu(ds64[-1], s)
    py, pds = fused.mlp_chain_bf16_ref(x, ws, bs, slopes, save_pre=True)
    _bf16_vs_f64((y, *ds), (py, *pds), (h, *ds64), what="K4")
    assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
        "restorer": {"cluster::mlp_cluster_kernel"},
        "classifier": {"head::mlp_head_kernel"}}[head]
    args = (g, x, ws, bs, slopes, ds)
    got = _tensors(backward.mlp_chain_bwd(*args))
    plain = _tensors(backward.mlp_chain_bwd_bf16_ref(*args))
    ref = _tensors(backward.plain_grads(
        lambda x_, *p: fused.mlp_chain_ref(x_, p[:n], p[n:], slopes),
        [x.double(), *(t.double() for t in ws), *(t.double() for t in bs)], g.double()))
    _bf16_vs_f64(got, plain, ref, what="K4b")
    assert all(torch.equal(a, b) for a, b in zip(got, _tensors(backward.mlp_chain_bwd(*args))))
    assert _device_kernel_names(lambda: backward.mlp_chain_bwd(*args)) == {
        "restorer": {"layer::chain_kernel", "layer::wgrad_kernel", "reduce_partials_bf16_kernel"},
        "classifier": {"small::small_kernel", "reduce_partials_bf16_kernel"}}[head]


def _rel_rms(got, ref):
    d = got.detach().cpu().double() - ref
    return (d.square().mean() / ref.square().mean()).sqrt().item()


@pytest.mark.gpu
def test_gpu_bf16_training_step_matches_cpu_against_float64(cuda):
    """One bfloat16 step of the 2-D model on the card and on the CPU port, the same weights,
    batch and mask, each against the CPU port in float64: the step launches the bfloat16
    instances only (K7 6, K4 2 forward, one backward each); the losses within 1.5 times the
    CPU's error plus 2^-8 of the value; the gradients' mean relative RMS error at most 1.5 times
    the CPU's plus 2^-8 and each at most 6 times plus 2^-8 (bfloat16 rounding decides the L1
    loss's signs and the ReLU masks in other places on each device, tests/test_torch_bf16.py);
    the range encoder's normed biases (exactly 0 in exact arithmetic) within 2^-8 of the
    largest gradient, the residual blocks' biases exactly 0."""
    _bf16_step_vs_f64(cuda, 2)


@pytest.mark.gpu
def test_gpu_bf16_soft_training_step_matches_cpu_against_float64(cuda):
    """The same with the soft restorer (128 -> ... -> 2, the cluster kernel of last width 2),
    a bfloat16 eps injected on both devices."""
    _bf16_step_vs_f64(cuda, "soft2d")


def _bf16_step_vs_f64(cuda, key):
    cpu = IInsVAE(**MODELS[key], generator=torch.Generator().manual_seed(5))
    gpu, f64 = copy.deepcopy(cpu).to(cuda), copy.deepcopy(cpu).double()
    data, mask = _train_batch(64, "cpu", seed=2)
    data = {k: (v.to(BF16) if k in ("cir", "weight") else v) for k, v in data.items()}
    grads_fn = steps.make_semi_grads_fn(0.5)
    kernels.reset_launch_counts()
    eps = {"soft_eps": torch.randn((64, 1), generator=torch.Generator().manual_seed(3)).to(BF16)
           } if MODELS[key].get("soft") else {}
    mg = grads_fn(gpu, {k: v.to(cuda) for k, v in data.items()}, sup_mask=mask.to(cuda),
                  **{k: v.to(cuda) for k, v in eps.items()})
    torch.cuda.synchronize()
    assert kernels.bf16_launch_counts() == BF16_STEP
    soft = int(bool(MODELS[key].get("soft")))
    assert kernels.soft_launch_counts() == {"mlp_chain_soft": 0, "mlp_chain_bf16_soft": soft,
                                            "mlp_chain_bwd_soft": 0,
                                            "mlp_chain_bwd_bf16_soft": soft}
    assert not any(kernels.launch_counts().values())
    assert not any(kernels.backward_launch_counts().values())
    mc = grads_fn(cpu, data, sup_mask=mask, **eps)
    m64 = grads_fn(f64, {k: v.double() for k, v in data.items()}, sup_mask=mask.double(),
                   **{k: v.double() for k, v in eps.items()})
    for k in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env"):
        a, c, w = mg[k].item(), mc[k].item(), m64[k].item()
        assert abs(a - w) <= 1.5 * abs(c - w) + 2.0**-8 * abs(w), (k, a, c, w)
    ref, cpu_p = dict(f64.named_parameters()), dict(cpu.named_parameters())
    largest = max(p.grad.abs().max().item() for p in ref.values())
    e_card, e_cpu = [], []
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        assert p.grad.dtype == torch.float32, name
        if ZERO_GRAD.fullmatch(name):
            assert p.grad.abs().max().item() <= 2.0**-8 * largest, name
            continue
        if not want.any():
            assert not p.grad.any() and not cpu_p[name].grad.any(), name
            continue
        e_card.append(_rel_rms(p.grad, want))
        e_cpu.append(_rel_rms(cpu_p[name].grad, want))
        assert e_card[-1] <= 6 * e_cpu[-1] + 2.0**-8, (name, e_card[-1], e_cpu[-1])
    assert np.mean(e_card) <= 1.5 * np.mean(e_cpu) + 2.0**-8, (np.mean(e_card), np.mean(e_cpu))


# ------------------------- the soft restorer and conv_type 3 -------------------------

SOFT_HEADS = {"restorer.soft": "soft", "restorer.2d.soft": "soft2d"}


def _soft_head(cuda, head, batch, dtype=torch.float32):
    model = IInsVAE(**MODELS[SOFT_HEADS[head]], generator=torch.Generator().manual_seed(7))
    mod = model.restorer.restorer
    n = len(mod.slopes)
    ws = [getattr(mod, f"w{j}").detach().to(dtype).to(cuda) for j in range(n)]
    bs = [getattr(mod, f"b{j}").detach().to(dtype).to(cuda) for j in range(n)]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, ws[0].shape[0]), generator=gen).to(dtype).to(cuda)
    g = torch.randn((batch, 2), generator=gen).to(dtype).to(cuda)
    return ws, bs, mod.slopes, x, g


@pytest.mark.gpu
@pytest.mark.parametrize("head", list(SOFT_HEADS))
@pytest.mark.parametrize("batch", [1, 13, 500])
def test_gpu_mlp_chain_soft_restorers_take_the_cluster_kernel(cuda, batch, head):
    """K4 at the soft restorers (16 or 128 -> 512 -> 256 -> 256 -> 2: the cluster kernel's
    instance of last width 2, each block rank's two partial dot products summed across the
    cluster): one launch, counted at the soft restorer too (the general kernel's is not),
    within tolerance of the plain version and of the general kernel, bit-equal over two calls
    and when saving the pre-activations, each saved d_j within tolerance; the cluster kernel
    named in a graph of the call. K4b at those widths from the saved d_j against its plain
    version, counted at the soft restorer."""
    ws, bs, slopes, x, g = _soft_head(cuda, head, batch)
    assert fused.takes_mlp_cluster([x.shape[1]] + [w.shape[1] for w in ws])
    with torch.no_grad():
        n, s = fused.mlp_chain.launches, fused.SOFT_LAUNCHES["mlp_chain_soft"]
        y, _ = fused.launch_mlp_chain(x, ws, bs, slopes)
        assert fused.mlp_chain.launches == n + 1
        assert fused.SOFT_LAUNCHES["mlp_chain_soft"] == s + 1
        assert y.shape == (batch, 2) and torch.isfinite(y).all()
        torch.testing.assert_close(y, fused.mlp_chain_ref(x, ws, bs, slopes), rtol=RTOL,
                                   atol=ATOL)
        general, _ = fused.launch_mlp_chain(x, ws, bs, slopes, general=True)
        assert fused.SOFT_LAUNCHES["mlp_chain_soft"] == s + 1
        torch.testing.assert_close(y, general, rtol=RTOL, atol=ATOL)
        assert torch.equal(y, fused.launch_mlp_chain(x, ws, bs, slopes)[0])
        y_saving, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
        assert torch.equal(y, y_saving)
        for j, (d, want) in enumerate(zip(ds, _pre_activations(x, ws, bs, slopes))):
            torch.testing.assert_close(d, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"d_{j}: {m}")
        assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
            "cluster::mlp_cluster_kernel"}
    sb = fused.SOFT_LAUNCHES["mlp_chain_bwd_soft"]
    _grads_match(backward.mlp_chain_bwd, (g, x, ws, bs, slopes, ds), {}, f"{head} {batch}")
    assert fused.SOFT_LAUNCHES["mlp_chain_bwd_soft"] > sb


@pytest.mark.gpu
@pytest.mark.parametrize("head", list(SOFT_HEADS))
@pytest.mark.parametrize("batch", [1, 13, 500])
def test_gpu_mlp_chain_bf16_soft_restorers_match_plain_against_float64(cuda, batch, head):
    """The bfloat16 instances of K4 (the cluster kernel of last width 2) and K4b at the soft
    restorers, on the model's weights rounded to bfloat16, against float64 beside the plain
    bfloat16 versions; the cluster kernel named in a graph of the K4 call; both counted at the
    soft restorer."""
    ws, bs, slopes, x, g = _soft_head(cuda, head, batch, BF16)
    m, s = fused.mlp_chain.launches_bf16, fused.SOFT_LAUNCHES["mlp_chain_bf16_soft"]
    y, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
    assert fused.mlp_chain.launches_bf16 == m + 1 and y.shape == (batch, 2)
    assert fused.SOFT_LAUNCHES["mlp_chain_bf16_soft"] == s + 1
    assert torch.equal(y, fused.mlp_chain(x, ws, bs, slopes))
    h, ds64 = x.double(), []
    for w, v, s in zip(ws, bs, slopes):
        ds64.append(h @ w.double() + v.double())
        h = ds64[-1] if s == 1.0 else torch.nn.functional.leaky_relu(ds64[-1], s)
    py, pds = fused.mlp_chain_bf16_ref(x, ws, bs, slopes, save_pre=True)
    _bf16_vs_f64((y, *ds), (py, *pds), (h, *ds64), what="K4")
    assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == {
        "cluster::mlp_cluster_kernel"}
    n = len(ws)
    args = (g, x, ws, bs, slopes, ds)
    sb = fused.SOFT_LAUNCHES["mlp_chain_bwd_bf16_soft"]
    got = _tensors(backward.mlp_chain_bwd(*args))
    assert fused.SOFT_LAUNCHES["mlp_chain_bwd_bf16_soft"] == sb + 1
    plain = _tensors(backward.mlp_chain_bwd_bf16_ref(*args))
    ref = _tensors(backward.plain_grads(
        lambda x_, *p: fused.mlp_chain_ref(x_, p[:n], p[n:], slopes),
        [x.double(), *(t.double() for t in ws), *(t.double() for t in bs)], g.double()))
    _bf16_vs_f64(got, plain, ref, what="K4b")
    assert all(torch.equal(a, b) for a, b in zip(got, _tensors(backward.mlp_chain_bwd(*args))))


@pytest.mark.gpu
@pytest.mark.parametrize("recon", [False, True])
def test_gpu_noexpand_forward_launches_k4_only(cuda, recon):
    """The column-image model's forward at batch 500: two launches (K4 at the restorer and at
    the classifier), the port's kernels of a CUDA graph of the call the cluster and the head
    kernel, outputs within tolerance of the CPU model's."""
    cpu = IInsVAE(**MODELS[3], generator=torch.Generator().manual_seed(3)).eval()
    model = copy.deepcopy(cpu).to(cuda)
    x = torch.randn((500, 157), generator=torch.Generator().manual_seed(1))
    xc = x.to(cuda)
    kernels.reset_launch_counts()
    with torch.inference_mode():
        out = model(xc) if recon else model.encode(xc)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["mlp_chain"] == (2 if recon else 0)
        assert not any(v for k, v in kernels.launch_counts().items() if k != "mlp_chain")
        names = graph_kernels.port_kernels(graph_kernels.launched_kernels(lambda: model(xc)))
        assert names == {"cluster::mlp_cluster_kernel": 1, "head::mlp_head_kernel": 1}
        if recon:
            want = cpu(x)
            for k in ("recon", "err_est", "logits", "env_code", "range_code"):
                torch.testing.assert_close(out[k].cpu(), want[k], rtol=1e-3, atol=1e-4,
                                           msg=lambda m: f"{k}: {m}")


@pytest.mark.gpu
def test_gpu_soft_training_step_gradients_match_cpu(cuda):
    """One 1-D step with the soft restorer on the card and on the CPU, the mask and the eps
    injected, each against the CPU port in float64 (as test_gpu_training_step_gradients_match_
    cpu); K4 and K4b launch once each at the restorer and the classifier."""
    cpu = IInsVAE(**MODELS["soft"], generator=torch.Generator().manual_seed(9))
    gpu, f64 = copy.deepcopy(cpu).to(cuda), copy.deepcopy(cpu).double()
    data, mask = _train_batch(64, cuda, seed=3)
    eps = torch.randn((64, 1), generator=torch.Generator().manual_seed(4))
    grads_fn = steps.make_semi_grads_fn(0.5)
    kernels.reset_launch_counts()
    mg = grads_fn(gpu, data, sup_mask=mask, soft_eps=eps.to(cuda))
    torch.cuda.synchronize()
    assert kernels.launch_counts() == RECON[1]
    assert kernels.soft_launch_counts() == {"mlp_chain_soft": 1, "mlp_chain_bf16_soft": 0,
                                            "mlp_chain_bwd_soft": 1, "mlp_chain_bwd_bf16_soft": 0}
    grads_fn(cpu, {k: v.cpu() for k, v in data.items()}, sup_mask=mask.cpu(), soft_eps=eps)
    m64 = grads_fn(f64, {k: v.cpu().double() for k, v in data.items()},
                   sup_mask=mask.cpu().double(), soft_eps=eps.double())
    for k in ("loss", "loss_ae", "loss_kl", "loss_res", "loss_env"):
        assert mg[k].item() == pytest.approx(m64[k].item(), rel=1e-4, abs=1e-6), k
    fp32, ref = dict(cpu.named_parameters()), dict(f64.named_parameters())
    assert ref["restorer.restorer.w3"].grad[:, 1].abs().max() > 0  # logvar's weights learn
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        e_card = (p.grad.cpu().double() - want).abs().max().item()
        e_cpu = (fp32[name].grad.double() - want).abs().max().item()
        assert e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * want.abs().max().item(), name


# ------------------------------ eWine (152 taps) ------------------------------
# The eWine model: the 1-D flagship at 152 taps and 2 classes. Its encoders pool 152 -> 128,
# so every kernel but K6 / K6b sees the shapes of the 157-tap model; the decoder tail pools
# 128 -> 152.
EWINE = dict(FLAGSHIP, cir_len=152, num_classes=2)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 500])
def test_gpu_sln_chain_and_its_backward_at_the_ewine_pool_match_plain(cuda, batch):
    """K6 at the decoder tail pooling to 152 on the tail kernel, bit-equal to the general
    kernel (whose forward K6b's tail path recomputes) and within tolerance of the plain
    version; K6b's gradients against the plain version's, bit-equal over two calls, on the
    tail path's kernels."""
    dec, _, _, stages = _decoder_inputs(cuda)
    ko, bo = dec.out_kernel, dec.out_bias
    gen = torch.Generator().manual_seed(152 + batch)
    x = torch.randn((batch, 8, 64), generator=gen).to(cuda)
    with torch.no_grad():
        y = fused.sln_chain(x, stages, ko, bo, 152)
        assert y.shape == (batch, 152)
        assert torch.equal(y, fused.launch_sln_chain(x, stages, ko, bo, 152, general=True))
        torch.testing.assert_close(y, fused.sln_chain_ref(x, stages, ko, bo, 152), rtol=RTOL,
                                   atol=ATOL)
    g = torch.randn((batch, 152), generator=gen).to(cuda)
    _tail_grads_match((g, x, stages, ko, bo, 152), f"pool 152, batch {batch}")
    assert _device_kernel_names(lambda: fused.sln_chain(x, stages, ko, bo, 152)) == {
        "tail::tail_fwd_kernel"}
    # K6b takes its tail path at 152 as at 157: the same device kernels
    names = _device_kernel_names(lambda: backward.sln_chain_bwd(g, x, stages, ko, bo, 152))
    g157 = torch.randn((batch, 157), generator=gen).to(cuda)
    assert "tail::tail_bwd_kernel" in names and names == _device_kernel_names(
        lambda: backward.sln_chain_bwd(g157, x, stages, ko, bo, 157))


def _mlp_bf16_matches_plain(head, batch, kernels_fwd, kernels_bwd):
    """K4's and K4b's bfloat16 instances at a Linear head (its weights rounded to bfloat16),
    against float64 beside the plain bfloat16 versions (K4b from the d_j that K4 saved), each
    call one bfloat16 launch, the device kernels named, K4b bit-equal over two calls."""
    n, slopes = len(head.slopes), head.slopes
    ws = [getattr(head, f"w{j}").detach().to(BF16) for j in range(n)]
    bs = [getattr(head, f"b{j}").detach().to(BF16) for j in range(n)]
    gen = torch.Generator().manual_seed(batch)
    x = torch.randn((batch, ws[0].shape[0]), generator=gen).to(BF16).to(ws[0].device)
    g = torch.randn((batch, ws[-1].shape[1]), generator=gen).to(BF16).to(ws[0].device)
    m = fused.mlp_chain.launches_bf16
    y, ds = fused.launch_mlp_chain(x, ws, bs, slopes, save_pre=True)
    assert fused.mlp_chain.launches_bf16 == m + 1
    assert torch.equal(y, fused.mlp_chain(x, ws, bs, slopes))
    h, ds64 = x.double(), []
    for w, v, s in zip(ws, bs, slopes):
        ds64.append(h @ w.double() + v.double())
        h = ds64[-1] if s == 1.0 else torch.nn.functional.leaky_relu(ds64[-1], s)
    py, pds = fused.mlp_chain_bf16_ref(x, ws, bs, slopes, save_pre=True)
    _bf16_vs_f64((y, *ds), (py, *pds), (h, *ds64), what="K4")
    assert _device_kernel_names(lambda: fused.mlp_chain(x, ws, bs, slopes)) == kernels_fwd
    args = (g, x, ws, bs, slopes, ds)
    m = backward.mlp_chain_bwd.launches_bf16
    got = _tensors(backward.mlp_chain_bwd(*args))
    assert backward.mlp_chain_bwd.launches_bf16 == m + 1
    plain = _tensors(backward.mlp_chain_bwd_bf16_ref(*args))
    ref = _tensors(backward.plain_grads(
        lambda x_, *p: fused.mlp_chain_ref(x_, p[:n], p[n:], slopes),
        [x.double(), *(t.double() for t in ws), *(t.double() for t in bs)], g.double()))
    _bf16_vs_f64(got, plain, ref, what="K4b")
    assert all(torch.equal(a, b) for a, b in zip(got, _tensors(backward.mlp_chain_bwd(*args))))
    assert _device_kernel_names(lambda: backward.mlp_chain_bwd(*args)) == kernels_bwd


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [5, 261, 500])
def test_gpu_mlp_chain_bf16_at_the_4_class_head_matches_plain(cuda, batch):
    """The paper protocol's classifier (16 -> 16 -> 32 -> 16 -> 4, the head kernel's <Any>
    instance) of the 2-D model in bfloat16: K4 and K4b against float64 beside the plain
    bfloat16 versions."""
    model = IInsVAE(**dict(MODELS[2], num_classes=4),
                    generator=torch.Generator().manual_seed(4)).to(cuda)
    head = model.classifier.classifier
    assert head.w3.shape == (16, 4)
    _mlp_bf16_matches_plain(head, batch, {"head::mlp_head_kernel"},
                            {"small::small_kernel", "reduce_partials_bf16_kernel"})


def _clear_of_relu_ties(model64, cir64) -> torch.Tensor:
    """The samples whose every ReLU and LeakyReLU input in the float64 forward clears
    MASK_MARGIN of its largest |value| in the sample: within it an fp32 forward's summation order
    decides the mask (chip_smoke.relu_margins, the same rule)."""
    seen = []
    relu, leaky = torch.relu, torch.nn.functional.leaky_relu

    def record(fn):
        def hooked(a, *args, **kw):
            a_ = a.detach().abs().flatten(1)
            seen.append(a_.amin(1) / a_.amax(1).clamp_min(1e-300))
            return fn(a, *args, **kw)
        return hooked

    torch.relu, torch.nn.functional.leaky_relu = record(relu), record(leaky)
    try:
        with torch.no_grad():
            model64(cir64)
    finally:
        torch.relu, torch.nn.functional.leaky_relu = relu, leaky
    return torch.stack(seen).amin(0) >= MASK_MARGIN


@pytest.mark.gpu
def test_gpu_ewine_step_launches_the_1d_steps_kernels(cuda):
    """One semi step of the eWine model at batch 500: the same launches a step as the 157-tap
    model (17 forward, 17 backward), the port's kernels of a CUDA graph of the step the same as
    the 157-tap step's; then the step on the batch's samples clear of ReLU ties
    (_clear_of_relu_ties, at least 3/4 of them), its gradients on the card and the CPU each
    against float64 (as test_gpu_training_step_gradients_match_cpu)."""
    grads_fn = steps.make_semi_grads_fn(0.5)
    seen = {}
    for name, kw in (("157", MODELS[1]), ("152", EWINE)):
        cpu = IInsVAE(**kw, generator=torch.Generator().manual_seed(9))
        gpu = copy.deepcopy(cpu).to(cuda)
        data, mask = _train_batch(500, cuda, seed=3)
        data["cir"] = data["cir"][:, :kw["cir_len"]].contiguous()
        data["label"] = data["label"] % kw["num_classes"]

        def step():
            metrics = grads_fn(gpu, data, sup_mask=mask)
            return [*metrics.values(), *(p.grad for p in gpu.parameters())]

        kernels.reset_launch_counts()
        step()
        torch.cuda.synchronize()
        assert kernels.launch_counts() == RECON[1], name
        assert kernels.backward_launch_counts() == TRAIN_BWD[1], name
        seen[name] = graph_kernels.port_kernels(graph_kernels.launched_kernels(step))
    assert seen["152"] == seen["157"] and seen["152"]["tail::tail_fwd_kernel"] == 1
    f64 = copy.deepcopy(cpu).double()
    keep = _clear_of_relu_ties(f64, data["cir"].cpu().double())
    assert keep.sum().item() >= 375
    data, mask = {k: v[keep.to(cuda)] for k, v in data.items()}, mask[keep.to(cuda)]
    grads_fn(gpu, data, sup_mask=mask)
    cpu_data = {k: v.cpu() for k, v in data.items()}
    grads_fn(cpu, cpu_data, sup_mask=mask.cpu())
    grads_fn(f64, {k: v.double() for k, v in cpu_data.items()}, sup_mask=mask.cpu().double())
    fp32, ref = dict(cpu.named_parameters()), dict(f64.named_parameters())
    for name, p in gpu.named_parameters():
        want = ref[name].grad
        e_card = (p.grad.cpu().double() - want).abs().max().item()
        e_cpu = (fp32[name].grad.double() - want).abs().max().item()
        assert e_card <= STEP_FACTOR * e_cpu + STEP_FLOOR * want.abs().max().item(), name
