"""Auxiliary losses, counterpart of uegan_tpu/losses/extra.py.

- ``tv_loss``      total-variation smoothness (unused by the train loop,
                   part of the reference's loss API)
- ``angular_loss`` mean angular error in degrees
- ``emd_loss``     squared earth-mover's distance over score distributions,
                   NIMA's training loss
"""

from __future__ import annotations

import math

import torch


def tv_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """x is NHWC; the reference TVLoss's normalization (per-sample counts)."""
    n, h, w, c = x.shape
    count_h = c * (h - 1) * w
    count_w = c * h * (w - 1)
    h_tv = ((x[:, 1:, :, :] - x[:, : h - 1, :, :]) ** 2).sum()
    w_tv = ((x[:, :, 1:, :] - x[:, :, : w - 1, :]) ** 2).sum()
    return weight * 2.0 * (h_tv / count_h + w_tv / count_w) / n


def angular_loss(f1: torch.Tensor, f2: torch.Tensor, eps_bound: float = 0.999999) -> torch.Tensor:
    """Mean arccos of the channel-wise cosine similarity, in degrees (NHWC)."""
    num = (f1 * f2).sum(-1)
    den = torch.linalg.vector_norm(f1, dim=-1) * torch.linalg.vector_norm(f2, dim=-1)
    cos = torch.clamp(num / torch.clamp(den, min=1e-8), -eps_bound, eps_bound)
    return torch.arccos(cos).mean() * 180.0 / math.pi


def emd_loss(p_target: torch.Tensor, p_pred: torch.Tensor, r: int = 2) -> torch.Tensor:
    """Squared EMD between per-image score distributions, shape (N, buckets)."""
    cdf_t = torch.cumsum(p_target, dim=-1)
    cdf_p = torch.cumsum(p_pred, dim=-1)
    per_image = torch.sqrt(((cdf_t - cdf_p) ** 2).mean(-1))
    return per_image.mean()
