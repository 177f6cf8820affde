"""Reading the reference's checkpoints, counterpart of uegan_tpu/utils/checkpoint.py.

A reference checkpoint is a seven-key ``.pth`` dict {G_net, D_net, epoch,
g_optimizer, d_optimizer, lr_scheduler_g, lr_scheduler_d} named
``{version}_{adv_loss_type}_{epoch}.pth`` (reference trainer.py:186-208).
The JAX package also writes orbax directories of the same stem; the port
does not read those yet.  Writing checkpoints comes with the train slice.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

from uegan_tpu_torch.config import Config

ROADMAP_ORBAX = ("orbax checkpoint directories are not read by the port; export the "
                 "weights to the reference .pth first (ROADMAP queue 1 item 4)")


def ckpt_name(version: str, adv_loss_type: str, epoch) -> str:
    return f"{version}_{adv_loss_type}_{Config.epoch_tag(epoch)}"


def load_pth(path: str) -> Dict:
    """Load a reference checkpoint on the CPU; tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "G_net" not in ckpt:
        raise KeyError(f"{path} is not a reference checkpoint: no G_net")
    return ckpt


def generator_state(ckpt: Dict) -> Dict[str, torch.Tensor]:
    """The ``G_net`` state dict, without the ``num_batches_tracked`` counters
    of the reference's norm layers, which eval mode does not read."""
    return {k: v for k, v in ckpt["G_net"].items() if not k.endswith("num_batches_tracked")}


def find_checkpoint(model_save_path: str, config: Config, epoch) -> str:
    """Path of the ``.pth`` for ``epoch``; raises if there is none."""
    stem = os.path.join(model_save_path, ckpt_name(config.version, config.adv_loss_type, epoch))
    if os.path.exists(stem + ".pth"):
        return stem + ".pth"
    if os.path.isdir(stem):
        raise NotImplementedError(f"{stem}: {ROADMAP_ORBAX}")
    raise FileNotFoundError(f"no checkpoint for epoch {epoch}: {stem}[.pth]")
