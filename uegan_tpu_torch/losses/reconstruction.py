"""Multi-scale reconstruction ("identity") loss, counterpart of
uegan_tpu/losses/reconstruction.py: the criterion over 3 scales made by
repeated 2x2 average pooling, weights 1, 1/2, 1/4 (reference
losses.py:202-231); l1 (default), l2 or smoothl1 (beta 1)."""

from __future__ import annotations

from typing import Callable

import torch

from uegan_tpu_torch.ops.pooling import avg_pool_2x2


def rec_criterion(kind: str) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    if kind == "l1":
        return lambda a, b: (a - b).abs().mean()
    if kind == "l2":
        return lambda a, b: ((a - b) ** 2).mean()
    if kind == "smoothl1":
        def smooth_l1(a, b):
            d = (a - b).abs()
            return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()
        return smooth_l1
    raise NotImplementedError(f"Loss [{kind}] is not implemented")


def multiscale_rec_loss(pred: torch.Tensor, target: torch.Tensor, rec_loss_type: str = "l1",
                        scale: int = 3, multiscale: bool = True) -> torch.Tensor:
    """pred, target (N, H, W, C) -> f32 scalar."""
    crit = rec_criterion(rec_loss_type)
    p, t = pred.float(), target.float()
    if not multiscale:
        return crit(p, t)
    weights = [1.0, 1.0 / 2, 1.0 / 4][:scale]
    loss = None
    for i, w in enumerate(weights):
        term = w * crit(p, t)
        loss = term if loss is None else loss + term
        if i != len(weights) - 1:
            p, t = avg_pool_2x2(p), avg_pool_2x2(t)
    return loss
