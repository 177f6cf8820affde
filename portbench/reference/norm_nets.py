"""Plain PyTorch reference of UEGAN's generator and discriminator with
train-mode norm layers (eezkni/UEGAN ``models.py``: the norm factory at
272-281, ``BatchNorm2d`` / ``InstanceNorm2d`` with ``affine=True,
track_running_stats=True``, after the conv of each of G's nine blocks and
D's five stages; ``--g_norm_fun`` / ``--d_norm_fun``).

Written from the equations of a norm layer in training, per channel
(per image and channel for instance norm): the mean and the biased
variance of the batch (``torch.var_mean``, float32), (x - mean) /
sqrt(var + eps) * weight + bias, and the running statistics moved by
momentum 0.1 towards the mean and the unbiased variance (instance norm:
their mean over the images).  The convs, the reflect pad, spectral norm,
the GAM and the losses are ``nets.py``'s.  Running statistics live in the
``state`` dict beside D's u and v (``enc1.main.2.running_mean``,
``d1.0.2.running_var``), and each forward replaces them with new tensors.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference import nets

Params = nets.Params
G_BLOCKS = ("enc1", "enc2", "enc3", "enc4", "enc5", "dec1", "dec2", "dec3", "dec4")
STATS = ("running_mean", "running_var")
MOMENTUM = 0.1
EPS = 1e-5


def _norm_spec(spec: dict, prefix: str, c: int) -> None:
    for name in ("weight", "bias") + STATS:
        spec[f"{prefix}.{name}"] = (c,)


def g_spec(cd: int, g_norm: str) -> Dict[str, Tuple[int, ...]]:
    """G's parameters and statistics (no spectral norm), with a norm layer
    after each block's conv unless ``g_norm`` is "none"."""
    spec = nets.g_spec(cd, False)
    if g_norm != "none":
        for name in G_BLOCKS:
            _norm_spec(spec, f"{name}.main.2", spec[f"{name}.main.1.weight"][0])
    return spec


def d_spec(dd: int, d_norm: str) -> Dict[str, Tuple[int, ...]]:
    spec = nets.d_spec(dd)
    if d_norm != "none":
        for i, (mult, _) in enumerate(nets.D_STAGES, 1):
            _norm_spec(spec, f"d{i}.0.2", dd * mult)
    return spec


def is_norm_key(name: str) -> bool:
    return name.endswith(tuple(f".main.2.{k}" for k in ("weight", "bias") + STATS)) or any(
        name.startswith(f"d{i}.0.2.") for i in range(1, len(nets.D_STAGES) + 1))


def seed_norm_layers(params: Params) -> Params:
    """The fan-in recipe's draws (``harness/weights.py``: 0.1 N(0, 1) for a
    vector) turned into a norm layer's: weight 1 + w, bias w, running mean
    w, running variance 1 + |w|.  In place; returns ``params``."""
    for k, v in params.items():
        if not is_norm_key(k):
            continue
        if k.endswith(".weight"):
            params[k] = 1.0 + v
        elif k.endswith(".running_var"):
            params[k] = 1.0 + v.abs()
    return params


def norm_layer(params: Params, state: Params, prefix: str, x: torch.Tensor, kind: str,
               update: bool = True, unbiased: bool = True) -> torch.Tensor:
    """A norm layer in train mode on x (N, C, H, W) float32: normalized with
    its own statistics; with ``update`` the running statistics in ``state``
    move towards the batch's (``unbiased`` False: the biased variance, a
    planted fault)."""
    if kind == "none":
        return x
    instance = kind == "InstanceNorm"
    dims = (2, 3) if instance else (0, 2, 3)
    var, mean = torch.var_mean(x, dim=dims, keepdim=True, correction=0)
    w = params[prefix + ".weight"].view(1, -1, 1, 1)
    b = params[prefix + ".bias"].view(1, -1, 1, 1)
    y = (x - mean) / torch.sqrt(var + EPS) * w + b
    if update:
        n, _, h, wd = x.shape
        cnt = h * wd if instance else n * h * wd
        with torch.no_grad():
            m = mean.reshape(-1, x.shape[1]).mean(dim=0)
            v = var.reshape(-1, x.shape[1]).mean(dim=0)
            if unbiased:
                v = v * cnt / max(cnt - 1, 1)
            rm, rv = state[prefix + ".running_mean"], state[prefix + ".running_var"]
            state[prefix + ".running_mean"] = (1 - MOMENTUM) * rm + MOMENTUM * m
            state[prefix + ".running_var"] = (1 - MOMENTUM) * rv + MOMENTUM * v
    return y


def g_forward(params: Params, state: Params, x_nhwc: torch.Tensor, nm: nets.Numerics,
              g_norm: str, update: bool = True, unbiased: bool = True) -> torch.Tensor:
    """G in train mode on x (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) float32:
    ``nets.g_forward``'s network with each block's conv followed by its norm
    layer and then the LeakyReLU."""
    x = x_nhwc.float().permute(0, 3, 1, 2)

    def block(name, h, stride):
        conv = f"{name}.main.1"
        y = nets.reflect_conv(nm, h, params[conv + ".weight"], params[conv + ".bias"], stride)
        return nets.leaky(norm_layer(params, state, f"{name}.main.2", y, g_norm, update,
                                     unbiased))

    skips = []
    h = x
    for i in range(1, 6):
        h = block(f"enc{i}", h, 1 if i == 1 else 2)
        skips.append(h)
    y = nets.gam(params, state, nm, 5, skips[4], False)
    for i in range(1, 5):
        u = nets.upsample2x(y)
        p = f"upsample{i}.1.main.1"
        u = nm.conv(u, params[p + ".weight"], params[p + ".bias"])
        g = nets.gam(params, state, nm, 5 - i, skips[4 - i], False)
        y = block(f"dec{i}", torch.cat([u, g], dim=1), 1)
    r = nets.reflect_conv(nm, y * skips[0], params["dec5.0.main.1.weight"],
                          params["dec5.0.main.1.bias"])
    r = torch.tanh(nets.reflect_conv(nm, r, params["dec5.1.main.1.weight"],
                                     params["dec5.1.main.1.bias"]))
    return torch.clamp(r + x, -1.0, 1.0).permute(0, 2, 3, 1)


def d_forward(params: Params, state: Params, xs_nhwc: Sequence[torch.Tensor],
              nm: nets.Numerics, d_norm: str, update: bool = True,
              unbiased: bool = True) -> List[List[torch.Tensor]]:
    """D in train mode: one forward of each input in ``xs_nhwc`` in turn, each
    normalized with its own batch's statistics (each stage's u and v advance
    once a forward) -> each input's five tanh prediction maps."""
    return [_d_one(params, state, x, nm, d_norm, update, unbiased) for x in xs_nhwc]


def _d_one(params, state, x_nhwc, nm, d_norm, update, unbiased) -> List[torch.Tensor]:
    h = x_nhwc.float().permute(0, 3, 1, 2)
    preds = []
    for i in range(1, len(nets.D_STAGES) + 1):
        w = nets.sn_weight(params, state, f"d{i}.0.1", True)
        h = nets.reflect_conv(nm, h, w, params[f"d{i}.0.1.bias"], 2)
        h = nets.leaky(norm_layer(params, state, f"d{i}.0.2", h, d_norm, update, unbiased))
        preds.append(torch.tanh(nets.reflect_conv(nm, h, params[f"d{i}_pred.0.1.weight"],
                                                  None)))
    return preds


def d_forward_fused(params: Params, state: Params, xs_nhwc: Sequence[torch.Tensor],
                    nm: nets.Numerics, d_norm: str) -> List[List[torch.Tensor]]:
    """A planted fault: the inputs as sequential forwards for spectral norm
    (each input's conv scaled by its own power iteration's sigma) but as one
    batch for the norm, whose statistics then mix them, updated once."""
    hs = [x.float().permute(0, 3, 1, 2) for x in xs_nhwc]
    preds: List[List[torch.Tensor]] = [[] for _ in hs]
    for i in range(1, len(nets.D_STAGES) + 1):
        ws = [nets.sn_weight(params, state, f"d{i}.0.1", True) for _ in hs]
        ys = [nets.reflect_conv(nm, h, w, params[f"d{i}.0.1.bias"], 2) for h, w in zip(hs, ws)]
        both = nets.leaky(norm_layer(params, state, f"d{i}.0.2", torch.cat(ys), d_norm))
        hs = list(torch.split(both, [y.shape[0] for y in ys]))
        for p, h in zip(preds, hs):
            p.append(torch.tanh(nets.reflect_conv(nm, h, params[f"d{i}_pred.0.1.weight"],
                                                  None)))
    return preds

