"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. This file
imports neither JAX nor iinsvae_tpu, so it runs on a machine that has only
PyTorch (tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

The kernels sum in another order than the plain versions, and
InstanceNorm divides by a per-channel std, which can scale that rounding
up: fp32 with rtol 1e-4 / atol 1e-4 per kernel call, 1e-3 / 1e-4 through
the 12 launches of a forward without the decoder and the 17 with it.
"""

import copy

import numpy as np
import pytest
import torch

from iinsvae_torch.models.vae import IInsVAE
from iinsvae_torch.ops.kernels import fused, strided_conv
from iinsvae_torch.serving import Predictor

RTOL, ATOL = 1e-4, 1e-4
FLAGSHIP = dict(cir_len=157, num_classes=5, style_dim=16)
# (module, wrapper, plain version); the models call each wrapper through its module
WRAPPED = [(fused, "in_chain", fused.in_chain_ref),
           (fused, "conv_bias_act", fused.conv_bias_act_ref),
           (strided_conv, "strided_conv", strided_conv.strided_conv_ref),
           (fused, "mlp_chain", fused.mlp_chain_ref),
           (fused, "adain_res_block", fused.adain_res_block_ref),
           (fused, "sln_chain", fused.sln_chain_ref)]
# launches of one forward batch, without and with the decoder
NO_RECON = {"in_chain": 6, "conv_bias_act": 2, "strided_conv": 2, "mlp_chain": 2,
            "adain_res_block": 0, "sln_chain": 0}
RECON = {**NO_RECON, "conv_bias_act": 3, "adain_res_block": 3, "sln_chain": 1}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("recon", [False, True])
@pytest.mark.parametrize("batch", [1, 7, 500])
def test_gpu_every_kernel_call_of_the_forward_matches_plain(cuda, monkeypatch, batch, recon):
    """Record each wrapper call of one flagship forward (real activations at
    every shape the path gives): the serving path without the decoder
    (encode, restore, classify) or the whole forward with it. Then hold
    each launch against the plain version on the same inputs."""
    calls = []
    for mod, name, ref in WRAPPED:
        def record(*args, _kernel=getattr(mod, name), _ref=ref, _name=name, **kw):
            out = _kernel(*args, **kw)
            calls.append((_name, out, _ref(*args, **kw)))
            return out
        # a wrapper counts on whatever its module name holds: the recorder here
        record.launches = 0
        monkeypatch.setattr(mod, name, record)
    model = IInsVAE(**FLAGSHIP).to(cuda)
    x = torch.randn((batch, 157), generator=torch.Generator().manual_seed(batch)).to(cuda)
    with torch.inference_mode():
        if recon:
            assert model(x)["recon"].shape == (batch, 157)
        else:
            range_code, env_code = model.encode(x)
            model.restore(range_code), model.classify(env_code)
    torch.cuda.synchronize()
    counts = {name: getattr(mod, name).launches for mod, name, _ in WRAPPED}
    want = RECON if recon else NO_RECON
    assert counts == want
    assert len(calls) == sum(want.values())
    for name, got, want in calls:
        assert torch.isfinite(got).all(), name
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL, msg=lambda m: f"{name}: {m}")


@pytest.mark.gpu
@pytest.mark.parametrize("recon", [False, True])
def test_gpu_predictor_matches_cpu_predictor(cuda, recon):
    model = IInsVAE(**FLAGSHIP, generator=torch.Generator().manual_seed(5))
    cpu = Predictor(copy.deepcopy(model), batch_size=8, return_recon=recon, device="cpu")
    gpu = Predictor(model, batch_size=8, return_recon=recon, device="cuda")
    cirs = np.random.default_rng(5).normal(size=(13, 157)).astype(np.float32)
    a, b = gpu(cirs), cpu(cirs)
    for f in ("err_est", "label_probs", "env_code") + (("recon",) if recon else ()):
        np.testing.assert_allclose(getattr(a, f), getattr(b, f), rtol=1e-3, atol=1e-4,
                                   err_msg=f)


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
