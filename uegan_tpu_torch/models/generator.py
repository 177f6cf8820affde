"""UEGAN generator, counterpart of uegan_tpu/models/generator.py.

A fully convolutional U-Net with GAM-modulated skips (reference
models.py:10-74):

- encoder: five ConvBlocks, k7/s1 then four k3/s2 (3 -> cd -> ... -> 16cd);
- a GAM on the bottleneck;
- decoder: four stages of x2 align-corners upsample + 1x1 conv, concatenated
  with the GAM of the skip and refined by a k3 ConvBlock;
- head ``dec5``: k3 conv and k7 conv on (y4 * x1), tanh;
- global residual: out = clip(tanh(...) + x, -1, 1), added and clipped in f32.

``forward`` takes and returns NHWC, as the JAX module does; inside, tensors
are NCHW in ``torch.channels_last`` memory.  H and W must be multiples of 16
and at least 32.  The parameter names are the reference's
(convert/torch_import.py), 4,158,435 parameters at conv_dim 32.
"""

from __future__ import annotations

import torch
from torch import nn

from uegan_tpu_torch.models.blocks import GAM, ConvBlock, SNConv, to_nchw, to_nhwc
from uegan_tpu_torch.ops.resize2x import upsample2x


def check_input_hw(h: int, w: int) -> None:
    if h % 16 or w % 16 or h < 32 or w < 32:
        raise ValueError(f"generator input H, W must be multiples of 16 and >= 32, got {h}x{w}")


class Generator(nn.Module):
    def __init__(self, conv_dim: int = 32, norm_fun: str = "none", act_fun: str = "LeakyReLU",
                 use_sn: bool = False, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        cd = conv_dim
        self.conv_dim, self.norm_fun, self.act_fun, self.use_sn = cd, norm_fun, act_fun, use_sn
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        block = dict(norm_fun=norm_fun, act_fun=act_fun, use_sn=use_sn, **kw)
        self.enc1 = ConvBlock(3, cd, 7, 1, **block)
        self.enc2 = ConvBlock(cd, cd * 2, 3, 2, **block)
        self.enc3 = ConvBlock(cd * 2, cd * 4, 3, 2, **block)
        self.enc4 = ConvBlock(cd * 4, cd * 8, 3, 2, **block)
        self.enc5 = ConvBlock(cd * 8, cd * 16, 3, 2, **block)
        for i, c in enumerate((cd, cd * 2, cd * 4, cd * 8, cd * 16), 1):
            setattr(self, f"ga{i}", GAM(c, use_sn=use_sn, **kw))
        for i, c in enumerate((cd * 8, cd * 4, cd * 2, cd), 1):
            # index 0 is the reference's Interpolate, which forward runs
            up = nn.Sequential(nn.Identity(), SNConv(c * 2, c, 1, use_sn=use_sn, **kw))
            setattr(self, f"upsample{i}", up)
            setattr(self, f"dec{i}", ConvBlock(c * 2, c, 3, 1, **block))
        # the output head has no spectral norm whatever use_sn says
        self.dec5 = nn.Sequential(SNConv(cd, cd, 3, **kw), SNConv(cd, 3, 7, **kw))

    def _up(self, i: int, y: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        u = to_nchw(upsample2x(to_nhwc(y)))
        u = getattr(self, f"upsample{i}")[1](u)
        g = getattr(self, f"ga{5 - i}")(skip)
        return getattr(self, f"dec{i}")((u, g))  # the pad writes the concat

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) in [-1, 1] -> tanh residual (N, H, W, 3) in ``dtype``,
        before the add and clip."""
        n, h, w, c = x.shape
        check_input_hw(h, w)
        xc = to_nchw(x.contiguous())
        x1 = self.enc1(xc)
        x2 = self.enc2(x1)
        x3 = self.enc3(x2)
        x4 = self.enc4(x3)
        y = self.ga5(self.enc5(x4))
        for i, skip in enumerate((x4, x3, x2, x1), 1):
            y = self._up(i, y, skip)
        r = torch.tanh(self.dec5[1](self.dec5[0](y * x1)))
        return to_nhwc(r)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, 3) in [-1, 1] -> enhanced (N, H, W, 3) in ``dtype``."""
        out = torch.clamp(self.residual(x).float() + x.float(), -1.0, 1.0)
        return out.to(self.dtype)
