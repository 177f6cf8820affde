"""Bilinear resize with ``align_corners=True`` parity (NHWC).

Counterpart of uegan_tpu/ops/resize.py.  The reference decoder upsamples
with ``F.interpolate(scale_factor=2, mode='bilinear', align_corners=True)``;
``F.interpolate`` defaults to ``align_corners=False``, so it is passed
explicitly here.  ``upsample2x_align_corners`` is the plain version of the
``upsample2x`` CUDA kernel (ops/resize2x.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(
    x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = True
) -> torch.Tensor:
    """Resize an NHWC tensor with torch bilinear semantics; f32 math (f64 for
    an f64 input), output in x.dtype."""
    n, h, w, c = x.shape
    if h == out_h and w == out_w:
        return x
    acc = x.permute(0, 3, 1, 2).to(torch.promote_types(x.dtype, torch.float32))
    y = F.interpolate(acc, size=(out_h, out_w), mode="bilinear",
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``Interpolate(2, 'bilinear', True)``: (N,H,W,C) -> (N,2H,2W,C)."""
    n, h, w, c = x.shape
    return resize_bilinear_align_corners(x, 2 * h, 2 * w, align_corners=True)
