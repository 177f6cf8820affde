"""Adversarial losses, counterpart of uegan_tpu/losses/gan.py.

Every mode of the reference GANLoss (reference losses.py:255-411): ``ls``,
``original`` (BCE with logits), ``w`` (wasserstein), ``hinge``, ``rahinge``
(relativistic average hinge, the default) and ``rals``.  The relativistic
modes follow the reference exactly; the others take the JAX package's
standard D/G compositions, since the reference trainer's call makes them
raise (ROADMAP "Divergences", PARITY C8).  Losses are f32; the multiscale
loss sums the five D scales.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def _bce(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Mean binary cross entropy with logits, in the JAX package's stable form."""
    return torch.mean(F.relu(logits) - logits * target + torch.log1p(torch.exp(-logits.abs())))


def gan_loss(real_preds: torch.Tensor, fake_preds: torch.Tensor, mode: str = "rahinge",
             for_discriminator: bool = True) -> torch.Tensor:
    """Single-scale adversarial loss, f32."""
    r = real_preds.float()
    f = fake_preds.float()
    if mode == "rahinge":
        r_f = r - f.mean()
        f_r = f - r.mean()
        if for_discriminator:
            return (F.relu(1.0 - r_f).mean() + F.relu(1.0 + f_r).mean()) / 2.0
        return (F.relu(1.0 + r_f).mean() + F.relu(1.0 - f_r).mean()) / 2.0
    if mode == "rals":
        r_f = r - f.mean()
        f_r = f - r.mean()
        if for_discriminator:
            return (((r_f - 1.0) ** 2).mean() + ((f_r + 1.0) ** 2).mean()) / 2.0
        return (((r_f + 1.0) ** 2).mean() + ((f_r - 1.0) ** 2).mean()) / 2.0
    if mode == "hinge":
        if for_discriminator:
            return F.relu(1.0 - r).mean() + F.relu(1.0 + f).mean()
        return -f.mean()
    if mode == "ls":
        if for_discriminator:
            return ((r - 1.0) ** 2).mean() + (f ** 2).mean()
        return ((f - 1.0) ** 2).mean()
    if mode == "original":
        if for_discriminator:
            return _bce(r, 1.0) + _bce(f, 0.0)
        return _bce(f, 1.0)
    if mode == "w":
        if for_discriminator:
            return f.mean() - r.mean()
        return -f.mean()
    raise ValueError(f"Unexpected gan_mode {mode}")


def multiscale_gan_loss(real_preds: Union[torch.Tensor, Sequence[torch.Tensor]],
                        fake_preds: Union[torch.Tensor, Sequence[torch.Tensor]],
                        mode: str = "rahinge", for_discriminator: bool = True) -> torch.Tensor:
    """Sum of the per-scale losses (reference losses.py:393-409)."""
    if not isinstance(real_preds, (list, tuple)):
        return gan_loss(real_preds, fake_preds, mode, for_discriminator)
    total = None
    for r, f in zip(real_preds, fake_preds, strict=True):
        term = gan_loss(r, f, mode, for_discriminator)
        total = term if total is None else total + term
    return total
