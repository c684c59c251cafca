"""JAX parameters (as numpy) -> the port's state.

The port keeps the JAX layouts (conv taps (k, C_in, C_out), dense weights
(D_in, D_out)) and mirrors the flax module names, so a flattened flax key
``params/a/b/c`` is the port's state key ``a.b.c`` with no transpose. The
weights file is the ``weights.npz`` that iinsvae_tpu's
``Predictor.export_serving`` writes: '/'-joined keys, with
``<collection>/__empty__`` sentinels for empty collections.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# the 1-D model's keys, and the expanded 2-D model's (conv_type=2): its
# biases before a norm and its residual blocks' biases, and its env
# encoder's explicit taps
_SERVED = re.compile(
    r"params/("
    r"encoder/range_encoder/(in_kernel|in_bias|down\d+_(kernel|bias)|res\d+_(kernel|bias)[12]"
    r"|out_kernel|out_bias)"
    r"|encoder/env_encoder/((ConvINAct_\d+|Conv1d_0)/(kernel|bias)"
    r"|in_kernel|in_bias|down\d+_(kernel|bias)|out_kernel|out_bias)"
    r"|decoder/decoder/(in_kernel|in_bias|res\d+_(kernel|bias)[12]|up\d+_(kernel|bias|gamma|beta)"
    r"|out_kernel|out_bias|mlp/Dense_\d+/(kernel|bias))"
    r"|(restorer/restorer|classifier/classifier)/[wb]\d+"
    r")")
_EMPTY = "/__empty__"


def from_flax_numpy(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flattened flax variables -> the port's state dict (float32, CPU)."""
    state = {}
    for key, value in flat.items():
        if key.endswith(_EMPTY):
            continue
        if not _SERVED.fullmatch(key):
            raise KeyError(f"unknown JAX parameter {key!r}: the port serves the 1-D and "
                           "the expanded 2-D model with Linear heads")
        state[key[len("params/"):].replace("/", ".")] = torch.from_numpy(
            np.array(value, dtype=np.float32))
    return state


def to_flax_numpy(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The port's state (or any tensors keyed by its parameter names, such
    as their gradients) -> flattened flax names ``params/a/b/c``, as float32
    numpy; the inverse of ``from_flax_numpy``."""
    flat = {}
    for key, value in state.items():
        name = "params/" + key.replace(".", "/")
        if not _SERVED.fullmatch(name):
            raise KeyError(f"{key!r} has no JAX parameter")
        flat[name] = value.detach().to("cpu", torch.float32).numpy()
    return flat


def load_npz(path: str) -> dict[str, torch.Tensor]:
    """The port's state from an export_serving ``weights.npz``."""
    with np.load(path) as z:
        return from_flax_numpy({k: z[k] for k in z.files})


def model_geometry(state: dict[str, torch.Tensor]) -> dict[str, int]:
    """The IInsVAE constructor fields that the weights fix (all but
    cir_len): conv_type 2 where the range encoder's taps are 2-D."""
    rk, ek = "encoder.range_encoder.", "encoder.env_encoder."
    conv_type = 2 if state[rk + "in_kernel"].dim() == 4 else 1
    env_head = ek + ("out_kernel" if conv_type == 2 else "Conv1d_0.kernel")
    return dict(
        conv_type=conv_type,
        dim=state[rk + "in_kernel"].shape[-1],
        n_downsample=sum(1 for k in state if re.fullmatch(rk + r"down\d+_kernel", k)),
        n_residual=sum(1 for k in state if re.fullmatch(rk + r"res\d+_kernel1", k)),
        range_dim=state[rk + "out_kernel"].shape[-1],
        style_dim=state[env_head].shape[-1],
        num_classes=state["classifier.classifier.w3"].shape[-1],
    )
