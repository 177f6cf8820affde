"""Generator building blocks, counterparts of uegan_tpu/models/blocks.py.

Module and parameter names follow the reference's torch modules
(reference models.py:77-281), so that a reference ``G_net`` state dict loads
with ``load_state_dict``.  Where the reference has a stateless module at an
index of an ``nn.Sequential`` (the ``ReflectionPad2d`` before each conv, the
``Interpolate`` before each decoder 1x1), the index holds an ``nn.Identity``
and ``forward`` does that step itself.

Activations are NCHW tensors in ``torch.channels_last`` memory; the two CUDA
kernels take the NHWC view of them, which is contiguous, at no cost.

Spectral norm (the discriminator's default; the generator's under
``--g_use_sn true``) keeps the names of ``torch.nn.utils.spectral_norm``
(``weight_orig``, ``weight_u``, ``weight_v``) and the JAX package's
semantics: one power iteration per train-mode forward, the stored u and v
in eval mode, and ``sn_branches`` > 1 scales each branch of a fused
forward by the sigma of its own iteration (ops/spectral_norm.py).  In the
generator it covers what JAX normalizes: the encoder and decoder
ConvBlocks, the ``upsample{i}`` 1x1 SNConvs and each GAM's fuse conv
(over the concat's 2 * nc input channels); never the GAM's squeeze and
excite convs or the ``dec5`` head.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from uegan_tpu_torch.ops.conv import conv2d_reflect
from uegan_tpu_torch.ops.gam_stats import gam_mean_std
from uegan_tpu_torch.ops.norms import instance_norm
from uegan_tpu_torch.ops.spectral_norm import spectral_sigmas

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


# a conv's input: one map, or the channel parts of a concat that the
# reflect pad writes padded (ops/conv.py:conv2d_reflect)
ConvInput = Union[torch.Tensor, Sequence[torch.Tensor]]


class SpectralConv2d(nn.Module):
    """A conv's parameters, with spectral norm under the names
    ``torch.nn.utils.spectral_norm`` gives them (``weight_orig`` and the
    ``weight_u``, ``weight_v`` buffers), or a plain ``weight``.  ``forward``
    is ReflectionPad + conv in ``dtype`` (+ bias), as SNConv's in JAX.
    u and v are filled by models/initializers.py:init_weights."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 bias: bool = True, use_sn: bool = False, device=None):
        super().__init__()
        self.stride, self.use_sn = stride, use_sn
        shape = (out_ch, in_ch, kernel_size, kernel_size)
        w = nn.Parameter(torch.empty(shape, device=device))
        if use_sn:
            self.weight_orig = w
            self.register_buffer("weight_u", torch.zeros(out_ch, device=device))
            self.register_buffer("weight_v", torch.zeros(in_ch * kernel_size ** 2,
                                                         device=device))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.zeros(out_ch, device=device)) if bias else None

    def forward(self, x: ConvInput, dtype: torch.dtype, update_sn: bool = True,
                sn_branches: int = 1) -> torch.Tensor:
        """x (N, C, H, W), or its channel parts -> (N, out, H', W') in
        ``dtype``.  With spectral norm and ``self.training`` and
        ``update_sn``, u and v advance by ``sn_branches`` power iterations;
        ``sn_branches`` > 1 takes x as that many equal batch slices that
        torch would run as sequential forwards."""
        if not self.use_sn:
            return conv2d_reflect(x, self.weight, self.bias, self.stride, dtype=dtype)
        update = update_sn and self.training
        sig, u, v = spectral_sigmas(self.weight_orig, self.weight_u, self.weight_v,
                                    sn_branches, update=update)
        if update:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        if sn_branches == 1:
            y = conv2d_reflect(x, self.weight_orig / sig[0], None, self.stride, dtype=dtype)
        else:
            n = (x if torch.is_tensor(x) else x[0]).shape[0]
            if n % sn_branches:
                raise ValueError(f"sn_branches {sn_branches} does not divide the batch {n}")
            y = conv2d_reflect(x, self.weight_orig, None, self.stride, dtype=dtype)
            scale = torch.repeat_interleave(1.0 / sig, n // sn_branches)
            y = (y.float() * scale.view(n, 1, 1, 1)).to(dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype).view(1, -1, 1, 1)
        return y


def block_conv(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1, bias: bool = True,
               use_sn: bool = False, device=None) -> nn.Module:
    """A generator block's conv: ``SpectralConv2d`` under spectral norm, else
    ``nn.Conv2d`` (its parameters are what the packed and int8 paths read)."""
    if use_sn:
        return SpectralConv2d(in_ch, out_ch, kernel_size, stride, bias=bias, use_sn=True,
                              device=device)
    return nn.Conv2d(in_ch, out_ch, kernel_size, stride, bias=bias, device=device)


def run_conv(conv: nn.Module, x: ConvInput, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """ReflectionPad + ``conv`` (from :func:`block_conv`) in ``dtype`` on x or
    the concat of its channel parts; a spectrally normalized one advances u
    and v in train mode."""
    if isinstance(conv, SpectralConv2d):
        return conv(x, dtype)
    return conv2d_reflect(x, conv.weight, conv.bias, stride, dtype=dtype)


class SNConv(nn.Module):
    """ReflectionPad + (SN) conv (reference models.py:77-86); ``main.1`` is the conv."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 bias: bool = True, use_sn: bool = False, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.main = nn.Sequential(
            nn.Identity(), block_conv(in_ch, out_ch, kernel_size, stride, bias, use_sn, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return run_conv(self.main[1], x, self.stride, self.dtype)


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
                "train-mode normalization (--g_norm_fun / --d_norm_fun other than none) is not "
                "ported yet (ROADMAP queue 1 item 3)")
        shape = (1, -1, 1, 1)
        y = (x.float() - self.running_mean.view(shape)) * torch.rsqrt(
            self.running_var.view(shape) + self.eps)
        return (y * self.weight.view(shape) + self.bias.view(shape)).to(x.dtype)


class ConvBlock(nn.Module):
    """ReflectionPad + (SN) conv + norm + activation (reference models.py:88-101);
    ``main.1`` is the conv and ``main.2`` the norm, when there is one."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
                 norm_fun: str = "none", act_fun: str = "LeakyReLU", use_sn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        layers = [nn.Identity(), block_conv(in_ch, out_ch, kernel_size, stride, True, use_sn,
                                            device)]
        if norm_fun != "none":
            layers.append(NormLayer(norm_fun, out_ch, device=device))
        self.main = nn.Sequential(*layers)
        self.act = get_act_fun(act_fun)

    def forward(self, x: ConvInput) -> torch.Tensor:
        """x (N, C, H, W), or the channel parts of the concat it reads."""
        y = run_conv(self.main[1], x, self.stride, self.dtype)
        if len(self.main) > 2:
            y = self.main[2](y)
        return self.act(y)


class DisConvBlock(nn.Sequential):
    """The discriminator's stage (reference models.py:158-167, the same
    structure as ConvBlock): index 0 the reflect pad, 1 the (spectrally
    normalized) conv, 2 the norm when there is one; then the activation.
    Train-mode norms are not ported (``--d_norm_fun none`` is the default)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int, stride: int = 2,
                 norm_fun: str = "none", act_fun: str = "LeakyReLU", use_sn: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        if norm_fun != "none":
            raise NotImplementedError(
                f"--d_norm_fun {norm_fun}: train-mode normalization in the discriminator is "
                "not ported yet (ROADMAP queue 1 item 3)")
        super().__init__(nn.Identity(), SpectralConv2d(in_ch, out_ch, kernel_size, stride,
                                                       bias=True, use_sn=use_sn, device=device))
        self.dtype = dtype
        self.act = get_act_fun(act_fun)

    def forward(self, x: torch.Tensor, update_sn: bool = True,
                sn_branches: int = 1) -> torch.Tensor:
        return self.act(self[1](x, self.dtype, update_sn, sn_branches))


class PredConvBlock(nn.Sequential):
    """The discriminator's prediction head (reference models.py:170-182):
    ReflectionPad + conv (no bias, no spectral norm), then tanh for
    hinge/rahinge, sigmoid for ls/rals, and the raw logits for original and w
    (the JAX package's extension, uegan_tpu/models/blocks.py:273-281).
    Index 1 is the conv."""

    def __init__(self, in_ch: int, kernel_size: int, adv_loss_type: str = "rahinge",
                 dtype: torch.dtype = torch.float32, device=None):
        if adv_loss_type not in ("ls", "rals", "hinge", "rahinge", "original", "w"):
            raise NotImplementedError(f"Adversarial loss [{adv_loss_type}] is not found")
        super().__init__(nn.Identity(), SpectralConv2d(in_ch, 1, kernel_size, 1, bias=False,
                                                       device=device))
        self.dtype = dtype
        self.adv_loss_type = adv_loss_type

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self[1](x, self.dtype)
        if self.adv_loss_type in ("ls", "rals"):
            return torch.sigmoid(y)
        if self.adv_loss_type in ("hinge", "rahinge"):
            return torch.tanh(y)
        return y


class GAM(nn.Module):
    """Global attention module (reference models.py:215-237): per-channel
    mean and unbiased std over H*W -> 1x1 squeeze (``conv.0``), ReLU, 1x1
    excite (``conv.2``) -> broadcast and concat with the input -> 1x1 fuse
    (``fuse.0``, spectrally normalized under ``use_sn``; squeeze and excite
    never are) -> non-affine instance norm."""

    def __init__(self, nc: int, reduction: int = 8, use_sn: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Sequential(
            nn.Conv2d(2 * nc, nc // reduction, 1, bias=False, device=device),
            nn.ReLU(),
            nn.Conv2d(nc // reduction, nc, 1, bias=False, device=device),
        )
        self.fuse = nn.Sequential(block_conv(2 * nc, nc, 1, use_sn=use_sn, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xh = to_nhwc(x)
        n, h, w, c = xh.shape
        mean, std = gam_mean_std(xh)  # (N, 1, 1, C) each, in x.dtype
        stats = to_nchw(torch.cat([mean, std], dim=-1))
        sq, ex = self.conv[0], self.conv[2]
        g = F.relu(conv2d_reflect(stats, sq.weight, dtype=self.dtype))
        g = to_nhwc(conv2d_reflect(g, ex.weight, dtype=self.dtype))
        out = to_nchw(torch.cat([xh, g.expand(n, h, w, c)], dim=-1))
        return instance_norm(run_conv(self.fuse[0], out, 1, self.dtype))
