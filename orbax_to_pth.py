#!/usr/bin/env python3
"""Export a JAX checkpoint (orbax) to the reference ``.pth`` the PyTorch port reads.

The JAX package writes orbax directories: a training run's
``{version}_{adv_loss_type}_{epoch}/`` with its config beside it as
``{dir}.config.json`` (uegan_tpu/utils/checkpoint.py), and NIMA training's
``nima_best/`` (uegan_tpu/nima_train/train.py).  uegan_tpu_torch reads the
reference's ``.pth`` instead, so this script carries one into the other:

    python orbax_to_pth.py --ckpt results/UEGAN-FiveK/models/UEGAN-FiveK_rahinge_92 \
        --out other_root/UEGAN-FiveK/models [--weights live]
    python orbax_to_pth.py --nima experiments/nima_best --out exported/

``--ckpt`` writes the reference's seven-key dict (``utils/checkpoint.py:
save_pth`` of the port): ``G_net``, ``D_net`` (spectral-norm kernels as
``weight_orig`` with their ``weight_u``/``weight_v``), ``epoch`` (from the
directory's name), ``g_optimizer``/``d_optimizer`` and the lr schedulers as
LambdaLR's state.  ``--weights eval`` (the default) makes ``G_net`` the EMA
copy when the checkpoint has one and the run's ``ema_eval`` is on, the
weights the JAX Tester and server enhance with, and leaves the optimizers
empty; ``--weights live`` writes the live weights with both optimizers'
Adam moments and, where the run keeps one (``g_ema_decay > 0``), the EMA
copy of G as the port's ``G_ema`` key, which is what a resumed run needs.
``--nima`` writes the reference NIMA state dict, which the port's
``metrics/nima.py:init_nima`` and JAX's ``convert/torch_import.py:
import_nima`` both read.

``--out`` is a ``.pth`` path, or a directory that takes ``{dir name}.pth``.
The ``.pth`` may not sit beside its own orbax directory: there the JAX
Tester would read the directory and the port the file.  The restore
template is the JAX package's (``create_train_state``, traced for its
shapes only), so this runs where flax and orbax are installed; the port
itself imports neither.
"""

from __future__ import annotations

import argparse
import os

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import torch

from uegan_tpu.config import Config
from uegan_tpu.models.nima import NIMA
from uegan_tpu.train.state import create_train_state
from uegan_tpu.utils.checkpoint import restore_eval_state
from uegan_tpu_torch.convert.from_flax import (adam_state_dict, discriminator_state_dict,
                                               generator_state_dict, nima_state_dict)
from uegan_tpu_torch.models.discriminator import Discriminator
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.utils.checkpoint import save_pth


def out_path(src: str, out: str) -> str:
    """The ``.pth`` that ``--out`` names for the orbax directory ``src``."""
    src = os.path.abspath(os.path.normpath(src))
    path = os.path.abspath(out if out.endswith(".pth")
                           else os.path.join(out, os.path.basename(src) + ".pth"))
    if path == src + ".pth":
        raise ValueError(f"{path} would sit beside its own orbax directory {src}: the JAX "
                         "Tester would read the directory and the port the .pth; give --out "
                         "another directory")
    return path


def read_config(ckpt: str) -> Config:
    path = os.path.normpath(ckpt) + ".config.json"
    if not os.path.isfile(path):
        raise FileNotFoundError(f"{path}: the run's config, which CheckpointManager.save "
                                "writes beside the checkpoint")
    with open(path) as f:
        return Config.from_json(f.read())


def train_state_template(cfg):
    """The run's TrainState as shapes and dtypes: ``create_train_state``
    traced, not run (its jitted init of G, D and VGG19 costs a minute on a
    CPU)."""
    hw = (cfg.resize_size, cfg.resize_size)  # the image pool's, as the Trainer builds it
    return jax.eval_shape(lambda key: create_train_state(cfg, key, hw, 1)[0],
                          jax.random.PRNGKey(0))


def epoch_of(ckpt: str) -> float:
    tag = os.path.basename(os.path.normpath(ckpt)).rsplit("_", 1)[-1]
    try:
        return float(tag)
    except ValueError:
        raise ValueError(f"{ckpt}: the directory's name does not end in an epoch "
                         "({version}_{adv_loss_type}_{epoch})") from None


def export_checkpoint(ckpt: str, out: str, weights: str = "eval") -> str:
    """Write the orbax training checkpoint ``ckpt`` as the reference's
    seven-key ``.pth`` under ``out``; returns its path."""
    if weights not in ("eval", "live"):
        raise ValueError(f"--weights {weights!r}: eval or live")
    path = out_path(ckpt, out)
    cfg = read_config(ckpt)
    if cfg.optimizer_type != "adam":
        raise NotImplementedError(f"--optimizer_type {cfg.optimizer_type}: the port trains "
                                  "with Adam only")
    state = jax.device_get(restore_eval_state(ckpt, train_state_template(cfg), use_ema=False))
    g_params = state.g_params
    if weights == "eval" and cfg.ema_eval and state.g_ema is not None:
        g_params = state.g_ema
    g_sd = generator_state_dict({"params": g_params, **state.g_extra})
    d_sd = discriminator_state_dict({"params": state.d_params, **state.d_extra})

    g_opt = d_opt = {}
    g_ema = None
    if weights == "live":
        g = Generator(conv_dim=cfg.g_conv_dim, norm_fun=cfg.g_norm_fun, act_fun=cfg.g_act_fun,
                      use_sn=cfg.g_use_sn, device="meta")
        d = Discriminator(conv_dim=cfg.d_conv_dim, norm_fun=cfg.d_norm_fun,
                          act_fun=cfg.d_act_fun, use_sn=cfg.d_use_sn,
                          adv_loss_type=cfg.adv_loss_type, device="meta")
        g_names = [n for n, _ in g.named_parameters()]
        if state.g_ema is not None and cfg.g_ema_decay > 0:
            # the average a resumed run goes on with, by parameter name as
            # the port keeps it (an SN kernel's weight_orig; u and v stay
            # the live ones in G_net, as JAX applies g_ema with g_extra)
            ema = generator_state_dict({"params": state.g_ema, **state.g_extra})
            g_ema = {n: ema[n] for n in g_names}
        betas = (cfg.beta1, cfg.beta2)
        # index 1 of the chain (add_decayed_weights, scale_by_adam, schedule)
        g_adam, d_adam = state.g_opt[1], state.d_opt[1]
        g_opt = adam_state_dict(
            g_adam.count, g_adam.mu, g_adam.nu,
            lambda t: generator_state_dict({"params": t, **state.g_extra}),
            g_names, cfg.g_lr, betas, cfg.weight_decay)
        d_opt = adam_state_dict(
            d_adam.count, d_adam.mu, d_adam.nu,
            lambda t: discriminator_state_dict({"params": t, **state.d_extra}),
            [n for n, _ in d.named_parameters()], cfg.d_lr, betas, cfg.weight_decay)

    epoch = epoch_of(ckpt)
    step = int(state.step)
    steps_per_epoch = max(1, round(step / epoch)) if epoch > 0 else 1
    last = step // steps_per_epoch
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return save_pth(path, g_sd, d_sd, epoch, g_opt, d_opt,
                    {"last_epoch": last, "base_lrs": [cfg.g_lr]},
                    {"last_epoch": last, "base_lrs": [cfg.d_lr]}, g_ema=g_ema)


def export_nima(nima_dir: str, out: str) -> str:
    """Write the orbax NIMA checkpoint ``nima_dir`` ({params, batch_stats})
    as the reference NIMA state dict under ``out``; returns its path."""
    path = out_path(nima_dir, out)
    template = jax.eval_shape(lambda key: NIMA().init(key, jnp.zeros((1, 224, 224, 3))),
                              jax.random.PRNGKey(0))
    variables = jax.device_get(ocp.StandardCheckpointer().restore(
        os.path.abspath(nima_dir), jax.tree_util.tree_map(ocp.utils.to_shape_dtype_struct,
                                                          template)))
    sd = nima_state_dict({"params": variables["params"],
                          "batch_stats": variables["batch_stats"]})
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)
    return path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="an orbax training checkpoint directory")
    src.add_argument("--nima", help="an orbax NIMA checkpoint directory (nima_best)")
    p.add_argument("--out", required=True, help="a .pth path, or a directory for {dir}.pth")
    p.add_argument("--weights", default="eval", choices=("eval", "live"),
                   help="eval: G_net is the EMA copy where the run keeps one and ema_eval is "
                        "on, no optimizer state; live: the live weights and Adam moments")
    a = p.parse_args(argv)
    if a.ckpt:
        print(export_checkpoint(a.ckpt, a.out, a.weights))
    else:
        print(export_nima(a.nima, a.out))


if __name__ == "__main__":
    main()
