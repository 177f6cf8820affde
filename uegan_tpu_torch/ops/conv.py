"""Reflect-padded convolution, counterpart of uegan_tpu/ops/padding.py and
uegan_tpu/ops/conv.py:conv2d_reflect.

Every reference conv pads its input with ``nn.ReflectionPad2d`` of
``(k + (k-1)(d-1) - 1) // 2`` first (reference models.py:80).  Here that is
``F.pad(mode="reflect")`` followed by ``F.conv2d`` on cuDNN.  Tensors are
NCHW in ``torch.channels_last`` memory, and the pad keeps them so.

Dtype points follow the JAX package: the conv runs in ``dtype`` (input and
f32 parameters cast to it; cuDNN accumulates bf16 in f32) and returns
``dtype``.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_f32(dtype: torch.dtype):
    """TF32 off for cuDNN convs and cuBLAS matmuls while float32 work that JAX
    runs at ``Precision.HIGHEST`` runs, the process's flags restored after."""
    if dtype != torch.float32:
        yield
        return
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def same_reflect_padding(kernel_size: int, dilation: int = 1) -> int:
    """Padding used by every reference conv block (reference models.py:80)."""
    return (kernel_size + (kernel_size - 1) * (dilation - 1) - 1) // 2


def reflect_indices(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the n + 2 * pad positions of a reflect-padded
    axis, as numpy's ``mode="reflect"`` gives them for any pad: period
    2(n - 1), the border not repeated."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    m = torch.remainder(idx, 2 * (n - 1))
    return torch.where(m > n - 1, 2 * (n - 1) - m, m)


def conv2d_reflect(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """ReflectionPad2d + conv.  x (N, C, H, W), weight (O, I, k, k)."""
    pad = same_reflect_padding(int(weight.shape[-1]), dilation)
    x = x.to(dtype)
    if pad and (pad >= x.shape[2] or pad >= x.shape[3]):
        # F.pad refuses a reflect pad as wide as the map (the discriminator's
        # last stages at small sizes); numpy's and so jnp.pad's reflect goes
        # on reflecting, which is a gather of periodic indices
        x = x[:, :, reflect_indices(x.shape[2], pad, x.device)][
            :, :, :, reflect_indices(x.shape[3], pad, x.device)]
    elif pad:
        # pad the NHWC view as a 5-d (N, 1, H, W, C) map: the result stays
        # channels-last, where F.pad of the NCHW tensor returns NCHW memory
        # on the card and cuDNN then converts around every conv
        xh = x.permute(0, 2, 3, 1).unsqueeze(1)
        xh = F.pad(xh, (0, 0, pad, pad, pad, pad), mode="reflect")
        x = xh.squeeze(1).permute(0, 3, 1, 2)
    b = None if bias is None else bias.to(dtype)
    return F.conv2d(x, weight.to(dtype), b, stride=stride, dilation=dilation)
