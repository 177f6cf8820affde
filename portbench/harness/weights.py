"""Seeded weights and traffic images, made on the device from ``--seed``.

Weights follow the fan-in recipe: every conv kernel N(0, 1/fan_in), every
bias N(0, 0.1^2), spectral-norm u and v random unit vectors.  A 0.02 init
would leave G's output about equal to its input, so that a comparison with
the reference proves little; these keep every layer's output of order one.
G's own u and v (under spectral norm in G) are then set to each kernel's
leading singular vectors, the fixed point where a trained run's power
iterations sit: random ones make eval-mode sigmas far below the top singular
value and blow the activations up layer by layer.

All of a net's numbers come from one ``torch.randn`` call on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Spec = Dict[str, Tuple[int, ...]]


def fan_in_weights(spec: Spec, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for s in spec.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in spec.items():
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if len(shape) == 4:
            t = t * (1.0 / math.sqrt(shape[1] * shape[2] * shape[3]))
        elif name.endswith(("weight_u", "weight_v")):
            t = t / torch.linalg.vector_norm(t)
        else:
            t = t * 0.1
        out[name] = t.contiguous()
    return out


def set_uv_fixed_point(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each ``<prefix>.weight_u`` / ``weight_v`` set to the leading left and
    right singular vectors of ``<prefix>.weight_orig`` (SVD in float64 on the
    host), with the signs one power iteration from them keeps."""
    for k in [k for k in params if k.endswith(".weight_orig")]:
        w = params[k]
        left, _, right = torch.linalg.svd(w.detach().double().reshape(w.shape[0], -1).cpu(),
                                          full_matrices=False)
        stem = k[:-len("orig")]
        params[stem + "u"] = left[:, 0].float().contiguous().to(w.device)
        params[stem + "v"] = right[0].float().contiguous().to(w.device)
    return params


def make_nets(specs: Dict[str, Spec], seed: int, device, fixed_uv: Tuple[str, ...] = ()
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """{net: {name: tensor}} for each net of ``specs``, in order, from one
    generator seeded with ``seed``; the nets named in ``fixed_uv`` get their u
    and v at the fixed point."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for net, spec in specs.items():
        out[net] = fan_in_weights(spec, gen, device)
        if net in fixed_uv:
            set_uv_fixed_point(out[net])
    return out


def photos(n: int, h: int, w: int, seed: int, device) -> torch.Tensor:
    """n (h, w, 3) uint8 photos: smooth colour gradients with N(0, 12^2) noise,
    each with its own seeded tints, made on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tint = torch.rand((n, 1, 1, 3), generator=gen, device=device) * 0.7 + 0.3
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1) / max(h, w)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w) / max(h, w)
    base = torch.stack([yy.expand(1, h, w), xx.expand(1, h, w),
                        ((yy + xx) / 2).expand(1, h, w)], dim=-1) * tint
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 12.0
    return torch.clamp(base * 255.0 + noise, 0, 255).to(torch.uint8)
