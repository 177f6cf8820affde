"""Instance-normalized VGG perceptual ("fidelity") loss, counterpart of
uegan_tpu/losses/perceptual.py:perceptual_loss.

Inputs in [0, 1] are ImageNet-normalized and run through VGG19; the
relu{1..5}_1 taps are instance-normalized (non-affine) in f32 before an MSE
with stage weights 1/64, 1/64, 1/32, 1/32, 1 (reference losses.py:12-36).
relu1_1 is computed canonically: the JAX package's ``packed_stage1`` is a
TPU layout lever, equal in math (ROADMAP, retired levers).
"""

from __future__ import annotations

import torch

from uegan_tpu_torch.models.vgg import PERCEPTUAL_TAPS, VGG19Features
from uegan_tpu_torch.ops.norms import instance_norm

WEIGHTS = {"relu1_1": 1.0 / 64, "relu2_1": 1.0 / 64, "relu3_1": 1.0 / 32,
           "relu4_1": 1.0 / 32, "relu5_1": 1.0}


def perceptual_loss(vgg: VGG19Features, x01: torch.Tensor, y01: torch.Tensor,
                    split_label: bool = True) -> torch.Tensor:
    """MSE over instance-normalized VGG taps of x01 and y01 ((N, H, W, 3) in
    [0, 1]); gradients flow through x01 only.  ``split_label`` runs the label
    branch as its own VGG call under no_grad, so the backward never visits
    it; otherwise one batched call takes both."""
    if x01.shape[-1] != 3:
        x01 = x01.repeat_interleave(3, dim=-1)
        y01 = y01.repeat_interleave(3, dim=-1)
    if split_label:
        fx = vgg(x01)
        with torch.no_grad():
            fy = vgg(y01)
    else:
        b = x01.shape[0]
        both = vgg(torch.cat([x01, y01], dim=0))
        fx = {k: v[:b] for k, v in both.items()}
        fy = {k: v[b:] for k, v in both.items()}
    loss = None
    for tap in PERCEPTUAL_TAPS:
        a = instance_norm(fx[tap].float())
        c = instance_norm(fy[tap].float())
        term = WEIGHTS[tap] * ((a - c) ** 2).mean()
        loss = term if loss is None else loss + term
    return loss
