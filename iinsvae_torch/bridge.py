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

# the column-image model's (conv_type 3) flax-named convs and residual blocks
_COLUMN = r"Conv2d_\d+/(kernel|bias)|ResidualBlock2dNoExpand_\d+/Conv2d_[01]/(kernel|bias)"
_RANGE = (r"(in_kernel|in_bias|down\d+_(kernel|bias)|res\d+_(kernel|bias)[12]"
          rf"|out_kernel|out_bias|{_COLUMN})")
_ENV = (r"((ConvINAct_\d+|Conv[12]d_\d+)/(kernel|bias)|in_kernel|in_bias|down\d+_(kernel|bias)"
        r"|out_kernel|out_bias)")
_DEC = (r"(in_kernel|in_bias|res\d+_(kernel|bias)[12]|up\d+_(kernel|bias|gamma|beta)"
        rf"|out_kernel|out_bias|mlp/Dense_\d+/(kernel|bias)|{_COLUMN}"
        r"|SampleLayerNorm_\d+/(gamma|beta))")
# a head: a Linear head's chain, or a Conv head's convs, BatchNormEps and Dense
_HEADS = r"(restorer/restorer|classifier/classifier|identifier/classifier|regressor/restorer)"
_HEAD = r"([wb]\d+|(Conv[12]d_\d+|Dense_0)/(kernel|bias)|BatchNormEps_\d+/(scale|bias))"
# the 1-D, the expanded 2-D and the column-image IInsVAE (encoder, decoder, restorer,
# classifier); EMNet and EMNetLoop (backbone, identifier, regressor, loop_proj);
# IdentifierSep (env_encoder, identifier) and RegressorSep (range_encoder, label_proj,
# regressor)
_PARAMS = re.compile(
    rf"params/((encoder/|backbone/)?range_encoder/{_RANGE}|(encoder/|backbone/)?env_encoder/{_ENV}"
    rf"|decoder/decoder/{_DEC}|{_HEADS}/{_HEAD}|(loop_proj|label_proj)/(kernel|bias))")
# the Conv heads' BatchNormEps running stats, buffers of the port's modules
_STATS = re.compile(rf"batch_stats/{_HEADS}/BatchNormEps_\d+/(mean|var)")
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
            raise KeyError(f"unknown JAX parameter {key!r}: the port takes the 1-D, the "
                           "expanded 2-D and the column-image IInsVAE, EMNet, EMNetLoop, "
                           "IdentifierSep and RegressorSep, with Linear, Conv1d, Conv2d or "
                           "Conv2dNoExpand heads")
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
    or Conv2d where its first conv is there (Conv2dNoExpand where it has four
    convs), else Linear."""
    if f"{head}.Conv2d_3.kernel" in state:
        return "Conv2dNoExpand"
    return next((t for t in ("Conv1d", "Conv2d") if f"{head}.{t}_0.kernel" in state), "Linear")


def _count(state: dict[str, torch.Tensor], pattern: str) -> int:
    return sum(1 for k in state if re.fullmatch(pattern, k))


def model_geometry(state: dict[str, torch.Tensor]) -> dict:
    """The IInsVAE constructor fields that the weights fix (all but cir_len
    and env_conv_init): conv_type 3 where the range encoder has the column
    model's flax-named convs (``Conv2d_0`` ...), 2 where its in-conv's taps
    are 2-D, else 1; ``restorer_type`` / ``classifier_type`` where a head is
    a Conv head and ``soft`` where the restorer ends in two outputs (mu,
    logvar) (the constructor's defaults are Linear and not soft)."""
    rk, ek = "encoder.range_encoder.", "encoder.env_encoder."
    heads = {h: _head_type(state, f"{h}.{h}") for h in ("restorer", "classifier")}
    if rk + "Conv2d_0.kernel" in state:
        # range: the 1x1 in-conv, n_downsample stride-2 convs, the 1x1 out-conv; env: its
        # 1x1 head last
        n_down = _count(state, re.escape(rk) + r"Conv2d_\d+\.kernel") - 2
        env_head = _count(state, re.escape(ek) + r"Conv2d_\d+\.kernel") - 1
        geometry = dict(
            conv_type=3, dim=state[rk + "Conv2d_0.kernel"].shape[-1], n_downsample=n_down,
            n_residual=_count(state, re.escape(rk) + r"ResidualBlock2dNoExpand_\d+\.Conv2d_0"
                                                     r"\.kernel"),
            range_dim=state[f"{rk}Conv2d_{n_down + 1}.kernel"].shape[-1],
            style_dim=state[f"{ek}Conv2d_{env_head}.kernel"].shape[-1])
    else:
        conv_type = 2 if state[rk + "in_kernel"].dim() == 4 else 1
        geometry = dict(
            conv_type=conv_type, dim=state[rk + "in_kernel"].shape[-1],
            n_downsample=_count(state, re.escape(rk) + r"down\d+_kernel"),
            n_residual=_count(state, re.escape(rk) + r"res\d+_kernel1"),
            range_dim=state[rk + "out_kernel"].shape[-1],
            style_dim=state[ek + ("out_kernel" if conv_type == 2 else "Conv1d_0.kernel")]
            .shape[-1])
    last = "restorer.restorer." + ("w3" if heads["restorer"] == "Linear" else "Dense_0.kernel")
    return dict(
        **geometry,
        num_classes=state["classifier.classifier." + (
            "w3" if heads["classifier"] == "Linear" else "Dense_0.kernel")].shape[-1],
        **({"soft": True} if state[last].shape[-1] == 2 else {}),
        **{f"{h}_type": t for h, t in heads.items() if t != "Linear"},
    )
