"""NIMA aesthetic scorer, counterpart of uegan_tpu/models/nima.py.

A width-1.0 MobileNetV2 trunk (classifier stripped, global average pool)
feeding [ReLU, Dropout 0.75, Linear 1280 -> 10, Softmax].  Inputs are
(N, H, W, 3) floats in [0, 1] with no ImageNet normalization.

The modules carry the reference's torch names, which
uegan_tpu/convert/torch_import.py:import_nima reads: ``base_model.0.0`` the
stem, ``base_model.0.{i+1}.conv`` the 17 inverted residual blocks (pw conv
and BN at 0/1, dw at 3/4, pw_linear at 6/7), ``base_model.0.18`` the head
conv and ``head.2`` the linear layer; so a reference ``pretrain-model.pth``
loads (``load_reference``) and ``save_nima_pth`` writes one.

The forward follows the JAX module's numerics rather than torch's modules:
each conv runs in ``dtype`` with f32 parameters; BatchNorm runs in f32 and
the activation (ReLU for the stem and the head conv, ReLU6 inside the
blocks, none after pw_linear) follows before the result is cast back to
``dtype``.  In training each BatchNorm and its activation are one call of
``ops/norm_act.py:norm_act`` (the hand-written kernel pair on a card): the
batch's mean and biased variance normalize, and the running averages move
by flax's momentum 0.9 with the biased variance; ReLU6 and ReLU keep the
derivatives of torch.clamp and F.relu.  In eval mode the running statistics
normalize (``batch_norm``).  The global pool sums in f32; the linear layer
runs in ``dtype`` and the softmax in f32.  In float32 the convs and the
linear layer run with TF32 off, the counterpart of JAX's
``Precision.HIGHEST``.  Without weights the trunk is seeded from a
``torch.Generator`` with the distributions of the JAX module's init, not
its values.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uegan_tpu_torch.ops.conv import exact_f32
from uegan_tpu_torch.ops.norm_act import norm_act
from uegan_tpu_torch.ops.pooling import avg_pool

# (expand_ratio t, out_channels c, repeats n, stride s)
INVERTED_RESIDUAL_SETTING: List[Tuple[int, int, int, int]] = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
LAST_CHANNEL = 1280
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax: running = momentum * running + (1 - momentum) * batch
# the standard deviation of a unit normal truncated to [-2, 2], by which
# jax.nn.initializers' truncated variance scaling divides its scale
TRUNC_STD = 0.87962566103423978


def _conv_bn(cin: int, cout: int, k: int, stride: int, groups: int = 1) -> List[nn.Module]:
    return [nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, groups=groups, bias=False),
            nn.BatchNorm2d(cout, eps=BN_EPS)]


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int):
        super().__init__()
        hidden = cin * expand_ratio
        self.use_res = stride == 1 and cin == cout
        # blocks with t = 1 keep their pw conv, as the JAX module does
        self.conv = nn.Sequential(*_conv_bn(cin, hidden, 1, 1), nn.ReLU6(),
                                  *_conv_bn(hidden, hidden, 3, stride, hidden), nn.ReLU6(),
                                  *_conv_bn(hidden, cout, 1, 1))


def batch_norm(y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """flax ``BatchNorm(use_running_average=True, epsilon=1e-5)`` of NCHW
    ``y``, computed in f32 (f64 for f64)."""
    acc = torch.promote_types(y.dtype, torch.float32)
    y = y.to(acc)
    mean, var = bn.running_mean.to(acc), bn.running_var.to(acc)
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(acc)
    return (y - mean[:, None, None]) * mul[:, None, None] + bn.bias.to(acc)[:, None, None]


def _act_args(act: Optional[nn.Module]) -> dict:
    """``norm_act``'s activation for the module after a BN: ReLU6 (torch.clamp
    to [0, 6], whose derivative passes at both ends), ReLU (F.relu's, none at
    0) or none."""
    if isinstance(act, nn.ReLU6):
        return {"slope": 0.0, "cap": 6.0}
    if isinstance(act, nn.ReLU):
        return {"slope": 0.0, "strict": True}
    return {"slope": 1.0}


def _run(layers: nn.Sequential, x: torch.Tensor, dtype: torch.dtype, train: bool) -> torch.Tensor:
    """conv -> BN -> [ReLU | ReLU6] -> cast, for each conv of ``layers``;
    in training BN and activation are one ``norm_act`` call."""
    mods = list(layers)
    for i, m in enumerate(mods):
        if not isinstance(m, nn.Conv2d):
            continue
        y = F.conv2d(x.to(dtype), m.weight.to(dtype), None, m.stride, m.padding, 1, m.groups)
        bn = mods[i + 1]
        act = mods[i + 2] if i + 2 < len(mods) else None
        if train:
            x = norm_act(y, bn.weight, bn.bias, bn.running_mean, bn.running_var, False,
                         momentum=1 - BN_MOMENTUM, eps=bn.eps, unbiased=False, **_act_args(act))
            continue
        y = batch_norm(y, bn)
        if isinstance(act, nn.ReLU6):
            y = torch.clamp(y, 0.0, 6.0)
        elif isinstance(act, nn.ReLU):
            y = F.relu(y)
        x = y.to(dtype)
    return x


def dropout(h: torch.Tensor, rate: float, generator: Optional[torch.Generator] = None):
    """flax ``nn.Dropout``: keep with probability 1 - rate, kept values
    scaled by 1 / (1 - rate)."""
    keep_prob = 1.0 - rate
    keep = torch.rand(h.shape, generator=generator, device=h.device) < keep_prob
    return torch.where(keep, h / keep_prob, torch.zeros((), dtype=h.dtype, device=h.device))


class NIMA(nn.Module):
    """MobileNetV2 features + [ReLU, Dropout, Linear 1280 -> 10, Softmax].

    ``forward(x01)`` takes (N, H, W, 3) in [0, 1] and returns (N, 10) f32
    probabilities; in training mode (``.train()``) BatchNorm uses the batch's
    statistics and dropout draws from ``generator``."""

    def __init__(self, dtype: torch.dtype = torch.float32, dropout_rate: float = 0.75):
        super().__init__()
        self.dtype = dtype
        layers: List[nn.Module] = [nn.Sequential(*_conv_bn(3, 32, 3, 2), nn.ReLU())]
        cin = 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for j in range(n):
                layers.append(InvertedResidual(cin, c, s if j == 0 else 1, t))
                cin = c
        layers.append(nn.Sequential(*_conv_bn(cin, LAST_CHANNEL, 1, 1), nn.ReLU()))
        self.base_model = nn.Sequential(nn.Sequential(*layers))
        self.head = nn.Sequential(nn.ReLU(), nn.Dropout(dropout_rate), nn.Linear(LAST_CHANNEL, 10))

    @property
    def dropout_rate(self) -> float:
        return self.head[1].p

    def forward(self, x01: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dtype, train = self.dtype, self.training
        with exact_f32(dtype):
            h = x01.permute(0, 3, 1, 2)
            for block in self.base_model[0]:
                if isinstance(block, InvertedResidual):
                    y = _run(block.conv, h, dtype, train)
                    h = h.to(dtype) + y if block.use_res else y
                else:
                    h = _run(block, h, dtype, train)
            side = h.shape[2]  # global pool: a VALID window of the map's height
            h = avg_pool(h.permute(0, 2, 3, 1), side, side).reshape(h.shape[0], -1)
            h = F.relu(h)
            if train and self.dropout_rate > 0:
                h = dropout(h, self.dropout_rate, generator)
            fc = self.head[2]
            logits = F.linear(h, fc.weight.to(dtype), fc.bias.to(dtype))
        return torch.softmax(logits.to(torch.promote_types(dtype, torch.float32)), dim=-1)

    @torch.no_grad()
    def seed(self, generator: torch.Generator) -> "NIMA":
        """The JAX module's init distributions from ``generator``: conv
        kernels he_normal and the linear layer lecun_normal (both truncated
        normals with fan_in from the kernel's receptive field), zero bias,
        BN scale 1, bias 0, running mean 0, running var 1."""
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                gain = 2.0 if isinstance(m, nn.Conv2d) else 1.0
                fan_in = m.weight[0].numel()
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
                m.weight.copy_(w * (math.sqrt(gain / fan_in) / TRUNC_STD))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
        return self

    @torch.no_grad()
    def load_reference(self, state: Dict[str, torch.Tensor]) -> "NIMA":
        """Take a reference-named NIMA state dict (``{"state_dict": ...}``
        unwrapped; ``num_batches_tracked`` counters optional)."""
        if "state_dict" in state:
            state = state["state_dict"]
        state = {k: v for k, v in state.items() if not k.endswith("num_batches_tracked")}
        missing, unexpected = self.load_state_dict(state, strict=False)
        missing = [k for k in missing if not k.endswith("num_batches_tracked")]
        if missing or unexpected:
            raise KeyError(f"not a NIMA state dict: missing {missing}, unexpected {unexpected}")
        return self


def score_stats(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """mean = sum j p_j (j = 1..10); std = sqrt(sum p_j (j - mean)^2)."""
    buckets = torch.arange(1, 11, dtype=probs.dtype, device=probs.device)
    mean = (probs * buckets).sum(-1)
    std = torch.sqrt((probs * (buckets - mean[:, None]) ** 2).sum(-1))
    return mean, std


def load_nima_pth(path: str) -> Dict[str, torch.Tensor]:
    """A reference NIMA ``.pth`` (a state dict, or one under ``state_dict``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_nima_pth(model: NIMA, path: str) -> str:
    """Write ``model``'s state dict under the reference names (what
    ``import_nima`` reads), through a temporary file."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, tmp)
    os.replace(tmp, path)
    return path
