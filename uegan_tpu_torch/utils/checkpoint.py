"""The reference's checkpoints, counterpart of uegan_tpu/utils/checkpoint.py.

A reference checkpoint is a seven-key ``.pth`` dict {G_net, D_net, epoch,
g_optimizer, d_optimizer, lr_scheduler_g, lr_scheduler_d} named
``{version}_{adv_loss_type}_{epoch}.pth`` (reference trainer.py:186-208).
The port's trainer writes that dict (``save_pth``), which the port's Tester
and the JAX Tester both read, and under ``g_ema_decay > 0`` one key more,
``G_ema`` (``EMA_KEY``): the EMA copy of G's parameters, by parameter name,
which the port's Tester, server and exporter take under ``ema_eval`` and a
resumed run restores.  JAX's ``.pth`` reader indexes only the keys it needs
(uegan_tpu/convert/torch_import.py:import_uegan_checkpoint), so the extra
key is harmless there.  The JAX package writes orbax directories of
the same stem instead.  The port does not read those: ``orbax_to_pth.py``
at the repository root exports one to the reference ``.pth`` (where flax is
installed), and every refusal here names that command.  Where both forms of
one epoch exist the port refuses to pick one (``find_checkpoint``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

from uegan_tpu_torch.config import Config

EXPORT_SCRIPT = "orbax_to_pth.py"


def export_command(orbax_dir: str, out: str, flag: str = "--ckpt") -> str:
    """The command that exports ``orbax_dir`` to a reference ``.pth`` under
    ``out`` (``--nima`` for a NIMA checkpoint)."""
    return f"python {EXPORT_SCRIPT} {flag} {orbax_dir} --out {out}"


def orbax_refusal(orbax_dir: str, out: str, flag: str = "--ckpt") -> str:
    return (f"{orbax_dir} is an orbax checkpoint directory, which the port does not read; "
            f"export it to the reference .pth with `{export_command(orbax_dir, out, flag)}` "
            "(where flax is installed)")
KEYS = ("G_net", "D_net", "epoch", "g_optimizer", "d_optimizer", "lr_scheduler_g",
        "lr_scheduler_d")
EMA_KEY = "G_ema"


def ckpt_name(version: str, adv_loss_type: str, epoch) -> str:
    return f"{version}_{adv_loss_type}_{Config.epoch_tag(epoch)}"


def load_pth(path: str) -> Dict:
    """Load a reference checkpoint on the CPU; tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or "G_net" not in ckpt:
        raise KeyError(f"{path} is not a reference checkpoint: no G_net")
    return ckpt


def generator_state(ckpt: Dict, ema: bool = False) -> Dict[str, torch.Tensor]:
    """The ``G_net`` state dict, without the ``num_batches_tracked`` counters
    of the reference's norm layers, which eval mode does not read; with
    ``ema`` (``Config.ema_eval``) its parameters are the EMA copy where the
    checkpoint keeps one, as JAX's Tester swaps in ``g_ema``."""
    sd = {k: v for k, v in ckpt["G_net"].items() if not k.endswith("num_batches_tracked")}
    if ema and ckpt.get(EMA_KEY):
        sd.update(ckpt[EMA_KEY])
    return sd


def uses_spectral_norm(g_state: Dict) -> bool:
    """Whether ``g_state`` (a ``G_net`` state dict) is a ``--g_use_sn true``
    generator's: its normalized convs keep ``weight_orig``."""
    return any(k.endswith(".weight_orig") for k in g_state)


def find_checkpoint(model_save_path: str, config: Config, epoch) -> str:
    """Path of the ``.pth`` for ``epoch``; raises if there is none, and if an
    orbax directory of the same stem exists beside it: the JAX Tester reads
    the directory, so the two packages would enhance with different weights."""
    stem = os.path.join(model_save_path, ckpt_name(config.version, config.adv_loss_type, epoch))
    pth, orbax = os.path.exists(stem + ".pth"), os.path.isdir(stem)
    # the export goes to another models directory: beside the orbax one it
    # would make this same pair
    other = os.path.join("NEW_ROOT", config.version, config.model_save_path)
    if pth and orbax:
        raise RuntimeError(
            f"{stem}.pth and the orbax directory {stem} both exist: the JAX Tester reads the "
            "directory and the port the .pth, so which weights enhance would depend on the "
            f"package; move one away, or export the directory with "
            f"`{export_command(stem, other)}` and run with --save_root_dir NEW_ROOT")
    if pth:
        return stem + ".pth"
    if orbax:
        raise NotImplementedError(f"{orbax_refusal(stem, other)}, then run with "
                                  "--save_root_dir NEW_ROOT")
    raise FileNotFoundError(f"no checkpoint for epoch {epoch}: {stem}[.pth]")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


def save_pth(path: str, g_state: Dict, d_state: Dict, epoch: float, g_optimizer: Dict,
             d_optimizer: Dict, lr_scheduler_g: Dict, lr_scheduler_d: Dict,
             g_ema: Optional[Dict] = None) -> str:
    """Write the reference's seven-key dict to ``path`` (tensors on the CPU),
    with ``EMA_KEY`` for ``g_ema`` when one is given, through a temporary
    file, so that a reader never sees half a checkpoint."""
    ckpt = dict(zip(KEYS, (g_state, d_state, float(epoch), g_optimizer, d_optimizer,
                           lr_scheduler_g, lr_scheduler_d)))
    if g_ema is not None:
        ckpt[EMA_KEY] = g_ema
    tmp = path + ".tmp"
    torch.save(_cpu(ckpt), tmp)
    os.replace(tmp, path)
    return path
