"""Generator building blocks, counterparts of uegan_tpu/models/blocks.py.

Module and parameter names follow the reference's torch modules
(reference models.py:77-281), so that a reference ``G_net`` state dict loads
with ``load_state_dict``.  Where the reference has a stateless module at an
index of an ``nn.Sequential`` (the ``ReflectionPad2d`` before each conv, the
``Interpolate`` before each decoder 1x1), the index holds an ``nn.Identity``
and ``forward`` does that step itself.

Activations are NCHW tensors in ``torch.channels_last`` memory; the two CUDA
kernels take the NHWC view of them, which is contiguous, at no cost.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from uegan_tpu_torch.ops.conv import conv2d_reflect
from uegan_tpu_torch.ops.gam_stats import gam_mean_std
from uegan_tpu_torch.ops.norms import instance_norm

ROADMAP_SN = "spectral norm in the generator (--g_use_sn true) is not ported yet (ROADMAP queue 1 item 3)"


def get_act_fun(act_fun_type: str = "LeakyReLU") -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation factory (reference models.py:249-264)."""
    if act_fun_type == "LeakyReLU":
        return lambda x: F.leaky_relu(x, negative_slope=0.2)
    if act_fun_type == "ReLU":
        return F.relu
    if act_fun_type == "Swish":
        return lambda x: x * torch.sigmoid(x)
    if act_fun_type == "SELU":
        return F.selu
    if act_fun_type == "none":
        return lambda x: x
    raise NotImplementedError(f"activation function [{act_fun_type}] is not found")


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW channels_last -> contiguous NHWC view (a copy only for other layouts)."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC -> NCHW view in channels_last memory."""
    return x.permute(0, 3, 1, 2)


class SNConv(nn.Module):
    """ReflectionPad + conv (reference models.py:77-86); ``main.1`` is the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 bias: bool = True, use_sn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        if use_sn:
            raise NotImplementedError(ROADMAP_SN)
        self.stride = stride
        self.dtype = dtype
        self.main = nn.Sequential(
            nn.Identity(), nn.Conv2d(in_ch, out_ch, kernel_size, stride, bias=bias, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.main[1]
        return conv2d_reflect(x, conv.weight, conv.bias, self.stride, dtype=self.dtype)


class NormLayer(nn.Module):
    """BatchNorm / InstanceNorm (affine, running statistics) in eval mode
    (reference models.py:272-281): normalizes with the running statistics,
    in f32, eps 1e-5."""

    def __init__(self, kind: str, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        if kind not in ("BatchNorm", "InstanceNorm"):
            raise NotImplementedError(f"normalization function [{kind}] is not found")
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "train-mode normalization comes with the train slice (ROADMAP queue 1 item 6)")
        shape = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class ConvBlock(nn.Module):
    """ReflectionPad + conv + norm + activation (reference models.py:88-101);
    ``main.1`` is the conv and ``main.2`` the norm, when there is one."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 norm_fun: str = "none", act_fun: str = "LeakyReLU", use_sn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if use_sn:
            raise NotImplementedError(ROADMAP_SN)
        self.stride = stride
        self.dtype = dtype
        layers = [nn.Identity(), nn.Conv2d(in_ch, out_ch, kernel_size, stride, device=device)]
        if norm_fun != "none":
            layers.append(NormLayer(norm_fun, out_ch, device=device))
        self.main = nn.Sequential(*layers)
        self.act = get_act_fun(act_fun)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.main[1]
        y = conv2d_reflect(x, conv.weight, conv.bias, self.stride, dtype=self.dtype)
        if len(self.main) > 2:
            y = self.main[2](y)
        return self.act(y)


class GAM(nn.Module):
    """Global attention module (reference models.py:215-237): per-channel
    mean and unbiased std over H*W -> 1x1 squeeze (``conv.0``), ReLU, 1x1
    excite (``conv.2``) -> broadcast and concat with the input -> 1x1 fuse
    (``fuse.0``) -> non-affine instance norm."""

    def __init__(self, nc: int, reduction: int = 8, use_sn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if use_sn:
            raise NotImplementedError(ROADMAP_SN)
        self.dtype = dtype
        self.conv = nn.Sequential(
            nn.Conv2d(2 * nc, nc // reduction, 1, bias=False, device=device),
            nn.ReLU(),
            nn.Conv2d(nc // reduction, nc, 1, bias=False, device=device),
        )
        self.fuse = nn.Sequential(nn.Conv2d(2 * nc, nc, 1, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = to_nhwc(x)
        n, h, w, c = xh.shape
        mean, std = gam_mean_std(xh)  # (N, 1, 1, C) each, in x.dtype
        stats = to_nchw(torch.cat([mean, std], dim=-1))
        sq, ex = self.conv[0], self.conv[2]
        g = F.relu(conv2d_reflect(stats, sq.weight, dtype=self.dtype))
        g = to_nhwc(conv2d_reflect(g, ex.weight, dtype=self.dtype))
        out = to_nchw(torch.cat([xh, g.expand(n, h, w, c)], dim=-1))
        fuse = self.fuse[0]
        out = conv2d_reflect(out, fuse.weight, fuse.bias, dtype=self.dtype)
        return instance_norm(out)
