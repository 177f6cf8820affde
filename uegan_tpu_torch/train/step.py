"""The generator's inference step, counterpart of uegan_tpu/train/step.py:make_eval_step.

The train step comes with the train slice (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Callable

import torch

from uegan_tpu_torch.models.generator import Generator


def make_eval_step(g: Generator) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inference forward: G in eval mode (running statistics), no autograd.
    (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) in G's dtype."""
    g.eval()

    def eval_step(img_raw: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return g(img_raw)

    return eval_step
