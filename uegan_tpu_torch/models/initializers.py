"""Weight initializers, counterpart of uegan_tpu/models/initializers.py.

The reference initializes every conv with ``init_weights`` (reference
trainer.py:357-390): default ``orthogonal`` with gain 0.02 and zero bias.
Each type maps onto the ``torch.nn.init`` function the JAX package mirrors,
drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from uegan_tpu_torch.models.blocks import SpectralConv2d
from uegan_tpu_torch.ops.spectral_norm import init_uv


def get_initializer(init_type: str, gain: float = 0.02) -> Callable:
    """init_type -> fn(weight, generator) that fills an OIHW weight in place."""
    init = nn.init
    table = {
        "normal": lambda w, g: init.normal_(w, 0.0, gain, generator=g),
        "xavier": lambda w, g: init.xavier_normal_(w, gain, generator=g),
        "xavier_uniform": lambda w, g: init.xavier_uniform_(w, 1.0, generator=g),
        "kaiming": lambda w, g: init.kaiming_normal_(w, 0.0, "fan_in", generator=g),
        "kaiming_uniform": lambda w, g: init.kaiming_uniform_(w, 0.0, "fan_in", generator=g),
        "orthogonal": lambda w, g: init.orthogonal_(w, gain, generator=g),
        # torch Conv2d.reset_parameters: U(+-1/sqrt(fan_in))
        "none": lambda w, g: init.kaiming_uniform_(w, math.sqrt(5), generator=g),
    }
    if init_type in ("", None):
        init_type = "none"
    if init_type not in table:
        raise NotImplementedError(f"Initialization method [{init_type}] is not implemented")
    return table[init_type]


@torch.no_grad()
def init_weights(
    model: nn.Module,
    init_type: str = "orthogonal",
    gain: float = 0.02,
    generator: Optional[torch.Generator] = None,
) -> nn.Module:
    """Initialize every conv weight of ``model``; biases are zero.  A
    spectrally normalized conv also gets random normalized u and v."""
    fill = get_initializer(init_type, gain)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fill(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, SpectralConv2d):
            w = m.weight_orig if m.use_sn else m.weight
            fill(w, generator)
            if m.bias is not None:
                m.bias.zero_()
            if m.use_sn:
                u, v = init_uv(w.shape, generator)
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)
    return model


def fan_in_normal_state(model: nn.Module, seed: int) -> Dict[str, np.ndarray]:
    """Random float32 weights for checks: N(0, 1/fan_in) for conv weights and
    N(0, 0.1^2) for biases, made with numpy from ``seed``.

    The 0.02 orthogonal init leaves the generator's residual near zero, so
    the output is about the input and a comparison of two implementations
    proves little; these weights keep every layer's output of order one.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith(("weight", "weight_orig")) and len(shape) == 4:
            std = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
        else:
            std = 0.1
        v = rng.standard_normal(shape) * std
        if name.endswith("running_var"):
            v = 1.0 + np.abs(v)
        elif name.endswith(("weight_u", "weight_v")):  # spectral norm: unit vectors
            v = v / np.linalg.norm(v)
        out[name] = v.astype(np.float32)
    return out
