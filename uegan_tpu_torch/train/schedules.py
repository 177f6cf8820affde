"""Learning-rate schedule and optimizers, counterpart of
uegan_tpu/train/schedules.py.

- Adam with betas (0.5, 0.999), eps 1e-8 and the reference's coupled L2
  weight decay 1e-4, which enters the gradient before the moments:
  ``torch.optim.Adam(weight_decay=...)``, not AdamW (reference
  trainer.py:335-351).
- The reference's LambdaLR linear decay, lr(epoch) = base * (1 - max(0,
  epoch + 1 - 50) / 50), with epoch = step // steps_per_epoch, as
  ``make_lr_schedule`` steps it in JAX: the train step sets each group's lr
  from its step count before the update.
- RMSprop is not ported: optax's ``scale_by_rms`` adds eps inside the root,
  ``torch.optim.RMSprop`` outside it.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch


def lambda_linear_decay(epoch: int, num_epochs_decay: int = 50, decay_ratio: int = 50) -> float:
    factor = 1.0 - max(0.0, epoch + 1.0 - num_epochs_decay) / decay_ratio
    return max(factor, 0.0)


def make_lr_schedule(base_lr: float, steps_per_epoch: int, lr_decay: bool = True,
                     num_epochs_decay: int = 50, decay_ratio: int = 50) -> Callable[[int], float]:
    """step -> learning rate."""
    def schedule(step: int) -> float:
        if not lr_decay:
            return base_lr
        epoch = step // max(steps_per_epoch, 1)
        return base_lr * lambda_linear_decay(epoch, num_epochs_decay, decay_ratio)

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter], optimizer_type: str, base_lr: float,
                   beta1: float = 0.5, beta2: float = 0.999,
                   weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    if optimizer_type == "adam":
        return torch.optim.Adam(params, lr=base_lr, betas=(beta1, beta2), eps=1e-8,
                                weight_decay=weight_decay)
    if optimizer_type == "rmsprop":
        raise NotImplementedError(
            "--optimizer_type rmsprop is not ported: optax's scale_by_rms adds eps inside "
            "the root and torch.optim.RMSprop outside it (ROADMAP queue 1 item 6)")
    raise NotImplementedError(f"Optimizer [{optimizer_type}] is not found")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
