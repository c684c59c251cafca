"""JAX parameters (as numpy) -> the port's state.

The port keeps the JAX layouts (conv taps (k, C_in, C_out), dense weights
(D_in, D_out)) and mirrors the flax module names, so a flattened flax key
``params/a/b/c`` is the port's state key ``a.b.c`` with no transpose, and a
``batch_stats/a/b/c`` (BatchNormEps's running mean and var) its buffer ``a.b.c``. The
weights file is the ``weights.npz`` that iinsvae_tpu's
``Predictor.export_serving`` writes: '/'-joined keys, with
``<collection>/__empty__`` sentinels for empty collections.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RANGE = (r"(in_kernel|in_bias|down\d+_(kernel|bias)|res\d+_(kernel|bias)[12]"
          r"|out_kernel|out_bias)")
_ENV = (r"((ConvINAct_\d+|Conv1d_0)/(kernel|bias)|in_kernel|in_bias|down\d+_(kernel|bias)"
        r"|out_kernel|out_bias)")
_DEC = (r"(in_kernel|in_bias|res\d+_(kernel|bias)[12]|up\d+_(kernel|bias|gamma|beta)"
        r"|out_kernel|out_bias|mlp/Dense_\d+/(kernel|bias))")
# a head: a Linear head's chain, or a Conv head's convs, BatchNormEps and Dense
_HEADS = r"(restorer/restorer|classifier/classifier|identifier/classifier|regressor/restorer)"
_HEAD = r"([wb]\d+|(Conv[12]d_\d+|Dense_0)/(kernel|bias)|BatchNormEps_0/(scale|bias))"
# the 1-D and the expanded 2-D IInsVAE (encoder, decoder, restorer, classifier); EMNet and
# EMNetLoop (backbone, identifier, regressor, loop_proj); IdentifierSep (env_encoder,
# identifier) and RegressorSep (range_encoder, label_proj, regressor)
_PARAMS = re.compile(
    rf"params/((encoder/|backbone/)?range_encoder/{_RANGE}|(encoder/|backbone/)?env_encoder/{_ENV}"
    rf"|decoder/decoder/{_DEC}|{_HEADS}/{_HEAD}|(loop_proj|label_proj)/(kernel|bias))")
# the Conv heads' BatchNormEps running stats, buffers of the port's modules
_STATS = re.compile(rf"batch_stats/{_HEADS}/BatchNormEps_0/(mean|var)")
_EMPTY = "/__empty__"


def _known(name: str) -> bool:
    return bool(_PARAMS.fullmatch(name) or _STATS.fullmatch(name))


def from_flax_numpy(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flattened flax variables (``params/...`` and ``batch_stats/...``) ->
    the port's state dict (float32, CPU)."""
    state = {}
    for key, value in flat.items():
        if key.endswith(_EMPTY):
            continue
        if not _known(key):
            raise KeyError(f"unknown JAX parameter {key!r}: the port takes the 1-D and the "
                           "expanded 2-D IInsVAE, EMNet, EMNetLoop, IdentifierSep and "
                           "RegressorSep, with Linear, Conv1d or Conv2d heads")
        state[key.split("/", 1)[1].replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state


def to_flax_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state (or any tensors keyed by its parameter names, such
    as their gradients) -> flattened flax names ``params/a/b/c``, and
    ``batch_stats/a/b/c`` for the BatchNormEps running stats, as float32
    numpy; the inverse of ``from_flax_numpy``."""
    flat = {}
    for key, value in state.items():
        path = key.replace(".", "/")
        name = next((n for n in ("params/" + path, "batch_stats/" + path) if _known(n)), None)
        if name is None:
            raise KeyError(f"{key!r} has no JAX variable")
        flat[name] = value.detach().to("cpu", torch.float32).numpy()
    return flat


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """The port's state from an export_serving ``weights.npz``."""
    with np.load(path) as z:
        return from_flax_numpy({k: z[k] for k in z.files})


def _head_type(state: dict[str, torch.Tensor], head: str) -> str:
    """The net type of the head at ``head`` ('restorer.restorer', ...): Conv1d
    or Conv2d where its first conv is there, else Linear."""
    return next((t for t in ("Conv1d", "Conv2d") if f"{head}.{t}_0.kernel" in state), "Linear")


def model_geometry(state: dict[str, torch.Tensor]) -> dict:
    """The IInsVAE constructor fields that the weights fix (all but
    cir_len): conv_type 2 where the range encoder's taps are 2-D, and
    ``restorer_type`` / ``classifier_type`` where a head is a Conv head (the
    constructor's default is Linear)."""
    rk, ek = "encoder.range_encoder.", "encoder.env_encoder."
    conv_type = 2 if state[rk + "in_kernel"].dim() == 4 else 1
    env_head = ek + ("out_kernel" if conv_type == 2 else "Conv1d_0.kernel")
    heads = {f"{h}_type": t for h in ("restorer", "classifier")
             if (t := _head_type(state, f"{h}.{h}")) != "Linear"}
    return dict(
        conv_type=conv_type,
        dim=state[rk + "in_kernel"].shape[-1],
        n_downsample=sum(1 for k in state if re.fullmatch(rk + r"down\d+_kernel", k)),
        n_residual=sum(1 for k in state if re.fullmatch(rk + r"res\d+_kernel1", k)),
        range_dim=state[rk + "out_kernel"].shape[-1],
        style_dim=state[env_head].shape[-1],
        num_classes=state["classifier.classifier." + (
            "Dense_0.kernel" if "classifier_type" in heads else "w3")].shape[-1],
        **heads,
    )
