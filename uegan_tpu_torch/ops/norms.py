"""Normalization primitives (NHWC), counterparts of uegan_tpu/ops/norms.py.

- ``instance_norm``: per-instance, per-channel normalization over H, W with
  the *biased* variance and eps 1e-5 (``nn.InstanceNorm2d``), non-affine
  inside the GAM.
- ``feature_mean_std``: the GAM statistics, per-(N, C) mean and *unbiased*
  std over H*W with eps inside the root.  It is the plain version of the
  ``gam_stats`` CUDA kernel (ops/gam_stats.py).

Both take the one-pass f32 form of the JAX functions, E[x^2] - E[x]^2, so
the two packages round alike.
"""

from __future__ import annotations

from typing import Tuple

import torch


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (N, C, H, W), any memory format -> normalized, in x.dtype."""
    acc = x.float()
    mean = acc.mean(dim=(2, 3), keepdim=True)
    sq = (acc * acc).mean(dim=(2, 3), keepdim=True)
    var = torch.clamp(sq - mean * mean, min=0.0)
    return ((acc - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def feature_mean_std(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) -> mean, std each (N, 1, 1, C) in x.dtype; f32 math
    (f64 for an f64 input)."""
    n, h, w, c = x.shape
    hw = h * w
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = acc.mean(dim=(1, 2), keepdim=True)
    sq = (acc * acc).mean(dim=(1, 2), keepdim=True)
    var = (sq - mean * mean) * (hw / max(hw - 1, 1))
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    return mean.to(x.dtype), std.to(x.dtype)
