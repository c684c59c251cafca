"""iinsvae_torch — the PyTorch/CUDA port of iinsvae_tpu for one NVIDIA H100.

It serves the IIns-VAE forward (range and env encoders, the Linear or
Conv restorer and classifier heads, and, with ``return_recon``, the AdaIN
decoder's reconstruction), trains it with the semi-supervised step,
checkpoints, resumes and evaluates it (training/, evaluation/,
cli/train_semi.py, cli/evaluate.py), trains and evaluates the supervised
joint EMNet / EMNetLoop and the separated IdentifierSep / RegressorSep
(models/emnet.py, cli/run.py, cli/run_sep.py), and serves it to other processes through
the request batcher and its unix-socket and TCP fronts (runtime/, cli/serve.py; a native
plane in C++ built with g++ at first use), for the 1-D model (conv_type=1) and the
expanded 2-D model (conv_type=2: the encoders on the column-grouped square
image, ops/colgroups.py; the decoder's subpixel 'fast' lowering,
ops/subpixel.py), and the column image (conv_type=3). Its data pipeline (data/,
runtime/cache.py, cli/inspect_data.py) reads the Zenodo pickle (with pandas) or the eWine
CSVs (152 taps, by the native plane's parser), else their synthetic fixtures, assembles the
'full' or 'paper' split and keeps it in an mmap cache. Activations stay channels-last ``(B, L, C)`` or
``(B, H, W, C)``, conv taps ``(k, C_in, C_out)`` or ``(kh, kw, C_in,
C_out)`` and dense weights ``(D_in, D_out)``, the JAX package's layouts, so
parameters carry across without transposes (bridge.py). Every kernel on the path is hand-written
CUDA for sm_90a (ops/kernels/csrc), built with nvcc at first use and bound
by ctypes, and each has a hand-written backward kernel behind a
``torch.autograd.Function``; on CPU tensors each wrapper runs its plain
PyTorch version, which autograd differentiates.

The package imports torch, numpy and scipy (the .mat exports) only, pandas only to read a
Zenodo pickle and matplotlib only for inspect_data's plot: never jax, flax or iinsvae_tpu.
"""

__version__ = "0.1.0"

# lazy exports (PEP 562): importing the package loads no submodule
_EXPORTS = {
    "IInsVAE": "iinsvae_torch.models.vae",
    "Predictor": "iinsvae_torch.serving",
    "load_npz": "iinsvae_torch.bridge",
    "serve_predictor": "iinsvae_torch.runtime",
    "socket_client_request": "iinsvae_torch.runtime",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module 'iinsvae_torch' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
