"""Pooling ops (NHWC), counterpart of uegan_tpu/ops/pooling.py."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of (N, H, W, C), ``count_include_pad=False``:
    the windows never pad, odd trailing rows and columns are dropped; the sum
    is f32 (f64 for f64), the result in x.dtype."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32)).permute(0, 3, 1, 2)
    y = F.avg_pool2d(acc, 2, 2, count_include_pad=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def avg_pool(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """VALID average pool of (N, H, W, C) (MobileNetV2's global pool): the
    sum is f32 (f64 for f64), the result in x.dtype."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32)).permute(0, 3, 1, 2)
    y = F.avg_pool2d(acc, window, stride)
    return y.permute(0, 2, 3, 1).to(x.dtype)
