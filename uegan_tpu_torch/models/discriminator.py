"""Multi-scale PatchGAN discriminator, counterpart of
uegan_tpu/models/discriminator.py.

Five stride-2 stages (kernels 7, 7, 7, 5, 5; 3 -> cd -> 2cd -> 4cd -> 8cd ->
16cd), each with a bias-free one-channel prediction head of the stage's
kernel size; spectral norm on the stages by default (reference
models.py:104-155).  Returns the five prediction maps, at 1/2 ... 1/32 of
the input.  Module names are the reference's (``d{i}.0.1`` the stage conv,
``d{i}_pred.0.1`` the head), as uegan_tpu/convert/torch_import.py:
import_discriminator maps them; 4,633,632 parameters at conv_dim 32.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from uegan_tpu_torch.models.blocks import DisConvBlock, PredConvBlock, to_nchw

STAGES = ((1, 7), (2, 7), (4, 7), (8, 5), (16, 5))  # (width in conv_dim, kernel)


class Discriminator(nn.Module):
    def __init__(self, conv_dim: int = 32, norm_fun: str = "none", act_fun: str = "LeakyReLU",
                 use_sn: bool = True, adv_loss_type: str = "rahinge",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        cin = 3
        for i, (mult, k) in enumerate(STAGES, 1):
            cout = conv_dim * mult
            setattr(self, f"d{i}", nn.Sequential(DisConvBlock(
                cin, cout, k, 2, norm_fun, act_fun, use_sn, dtype=dtype, device=device)))
            setattr(self, f"d{i}_pred", nn.Sequential(PredConvBlock(
                cout, k, adv_loss_type, dtype=dtype, device=device)))
            cin = cout

    def forward(self, x: torch.Tensor, update_sn: bool = True,
                sn_branches: int = 1) -> List[torch.Tensor]:
        """x (N, H, W, 3) -> five (N, 1, H/2^i, W/2^i) NCHW prediction maps in
        ``dtype``.  ``sn_branches`` > 1: x batch-concatenates that many
        branches that torch would run as sequential forwards; each spectrally
        normalized conv scales each branch by its own iteration's sigma."""
        h = to_nchw(x.contiguous()).to(self.dtype)
        preds = []
        for i in range(1, len(STAGES) + 1):
            h = getattr(self, f"d{i}")[0](h, update_sn, sn_branches)
            preds.append(getattr(self, f"d{i}_pred")[0](h))
        return preds
