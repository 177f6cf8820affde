"""Reflect-padded convolution, counterpart of uegan_tpu/ops/padding.py and
uegan_tpu/ops/conv.py:conv2d_reflect.

Every reference conv pads its input with ``nn.ReflectionPad2d`` of
``(k + (k-1)(d-1) - 1) // 2`` first (reference models.py:80).  Here that is
the reflect-pad kernel (ops/reflect_pad.py), which also takes a conv's input
as two channel parts and writes their concat padded, followed by
``F.conv2d`` on cuDNN.  Tensors are NCHW in ``torch.channels_last`` memory,
and the pad keeps them so.

Dtype points follow the JAX package: the conv runs in ``dtype`` (input and
f32 parameters cast to it; cuDNN accumulates bf16 in f32) and returns
``dtype``.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from uegan_tpu_torch.ops.reflect_pad import reflect_pad


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


def conv2d_reflect(
    x: Union[torch.Tensor, Sequence[torch.Tensor]],
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """ReflectionPad2d + conv.  x (N, C, H, W), or a tuple of channel parts
    (N, Ci, H, W) that the conv reads as their concat; weight (O, I, k, k).
    Any pad, as numpy's reflect (the discriminator's last stages at small
    sizes pad as wide as the map)."""
    pad = same_reflect_padding(int(weight.shape[-1]), dilation)
    parts = [t.to(dtype) for t in (x if isinstance(x, (tuple, list)) else (x,))]
    if pad:
        x = reflect_pad(parts, pad)
    else:
        x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    b = None if bias is None else bias.to(dtype)
    return F.conv2d(x, weight.to(dtype), b, stride=stride, dilation=dilation)
