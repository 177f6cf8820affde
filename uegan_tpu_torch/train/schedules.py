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
- On a card the Adam is capturable (its step counts on the device) and
  ``set_lr`` keeps its learning rate as a 0-d tensor on the parameters'
  device, written in place: a CUDA graph of the train step (train/step.py)
  reads it at each replay.  A checkpoint holds the optimizer's state in the
  form a plain Adam writes (``optimizer_state``), whichever device wrote
  it, and ``load_optimizer_state`` restores it into either form.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

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
    """The optimizer of ``params``; on CUDA parameters a capturable Adam, whose
    learning rate ``set_lr`` makes a 0-d tensor on their device (a float
    here: Adam checks a tensor's sign on the host, which waits for the card)."""
    if optimizer_type == "adam":
        params = list(params)
        capturable = bool(params) and params[0].device.type == "cuda"
        return torch.optim.Adam(params, lr=base_lr, betas=(beta1, beta2), eps=1e-8,
                                weight_decay=weight_decay, capturable=capturable)
    if optimizer_type == "rmsprop":
        raise NotImplementedError(
            "--optimizer_type rmsprop is not ported: optax's scale_by_rms adds eps inside "
            "the root and torch.optim.RMSprop outside it (ROADMAP queue 1 item 6)")
    raise NotImplementedError(f"Optimizer [{optimizer_type}] is not found")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    """Each group's learning rate: written in place into a capturable group's
    0-d tensor on its parameters' device (made there if it has none), else
    set as a float."""
    for group in opt.param_groups:
        if not group.get("capturable"):
            group["lr"] = lr
            continue
        dev = group["params"][0].device
        if not (isinstance(group["lr"], torch.Tensor) and group["lr"].device == dev):
            group["lr"] = torch.zeros((), device=dev)
        group["lr"].fill_(lr)


def optimizer_state(opt: torch.optim.Optimizer) -> Dict:
    """``opt.state_dict()`` as a plain Adam writes it: float learning rates and
    ``capturable`` off (the step counts stay tensors)."""
    sd = opt.state_dict()
    for group in sd["param_groups"]:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"] = float(group["lr"])
        group["capturable"] = False
    return sd


def load_optimizer_state(opt: torch.optim.Optimizer, sd: Dict) -> None:
    """``opt.load_state_dict(sd)``, with ``opt``'s own ``capturable`` and
    learning rates kept (the train step sets the rate before each update):
    a capturable group's step counts go to its parameters' device as float32."""
    own = [(group["capturable"], group["lr"]) for group in opt.param_groups]
    opt.load_state_dict(sd)
    for group, (capturable, lr) in zip(opt.param_groups, own):
        group["lr"], group["capturable"] = lr, capturable
        if not capturable:
            continue
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(device=p.device, dtype=torch.float32)
