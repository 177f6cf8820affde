"""Train state, counterpart of uegan_tpu/train/state.py.

Everything a train step changes: the generator (with its spectral-norm u/v
buffers under ``--g_use_sn``), the discriminator (with its), the two
optimizers, the image pool and its generator of draws, the step count, and
the EMA copy of G's parameters when ``g_ema_decay > 0`` (by parameter name:
a spectrally normalized kernel's ``weight_orig`` is averaged, its u and v
are not, as JAX's ``g_ema`` averages ``g_params`` and not ``g_extra``).  The frozen VGG19 rides along.  Models hold float32
parameters and compute in ``compute_dtype``.  Every random draw comes from
an explicit ``torch.Generator`` seeded from ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.models.discriminator import Discriminator
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import init_weights
from uegan_tpu_torch.models.vgg import VGG19Features
from uegan_tpu_torch.train.image_pool import ImagePool
from uegan_tpu_torch.train.schedules import load_optimizer_state, make_optimizer, optimizer_state
from uegan_tpu_torch.utils.checkpoint import EMA_KEY, save_pth
from uegan_tpu_torch.utils.device import compute_dtype


@dataclass
class TrainState:
    config: Config
    g: Generator
    d: Discriminator
    vgg: VGG19Features
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    pool: ImagePool
    steps_per_epoch: int
    step: int = 0
    g_ema: Optional[Dict[str, torch.Tensor]] = None


def build_models(config: Config, device=None) -> Tuple[Generator, Discriminator, VGG19Features]:
    dt = compute_dtype(config.compute_dtype)
    g = Generator(conv_dim=config.g_conv_dim, norm_fun=config.g_norm_fun,
                  act_fun=config.g_act_fun, use_sn=config.g_use_sn, dtype=dt, device=device)
    d = Discriminator(conv_dim=config.d_conv_dim, norm_fun=config.d_norm_fun,
                      act_fun=config.d_act_fun, use_sn=config.d_use_sn,
                      adv_loss_type=config.adv_loss_type, dtype=dt, device=device)
    return g, d, VGG19Features(dtype=dt, device=device)


def create_train_state(config: Config, device, image_hw: Tuple[int, int], steps_per_epoch: int,
                       vgg_state: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
    """Models initialized from ``config.seed`` (G, then D, then VGG unless
    ``vgg_state`` gives torchvision weights), optimizers, an empty pool."""
    if config.param_dtype != "float32":
        raise NotImplementedError(f"--param_dtype {config.param_dtype}: the port keeps "
                                  "float32 parameters")
    device = torch.device(device)
    gen = torch.Generator().manual_seed(config.seed)
    g, d, vgg = build_models(config)
    init_weights(g, config.init_type, 0.02, gen)
    init_weights(d, config.init_type, 0.02, gen)
    if vgg_state is not None:
        vgg.load_torchvision(vgg_state)
    else:
        vgg.seed(gen)
    g, d, vgg = g.to(device), d.to(device), vgg.to(device)
    g_opt = make_optimizer(g.parameters(), config.optimizer_type, config.g_lr, config.beta1,
                           config.beta2, config.weight_decay)
    d_opt = make_optimizer(d.parameters(), config.optimizer_type, config.d_lr, config.beta1,
                           config.beta2, config.weight_decay)
    pool_gen = torch.Generator(device=device).manual_seed(config.seed + 1)
    pool = ImagePool(config.pool_size, (image_hw[0], image_hw[1], 3), device, pool_gen)
    state = TrainState(config, g, d, vgg, g_opt, d_opt, pool, steps_per_epoch)
    if config.g_ema_decay > 0:
        state.g_ema = {k: v.detach().clone() for k, v in g.named_parameters()}
    return state


def save_checkpoint(state: TrainState, path: str, epoch) -> str:
    """The reference's seven-key ``.pth`` of ``state`` at ``path``, with the
    EMA copy of G under ``utils/checkpoint.py:EMA_KEY`` when one is kept; the
    lr schedulers' entries hold LambdaLR's state (the epoch and the base lrs)."""
    cfg = state.config
    last = int(state.step // state.steps_per_epoch)
    return save_pth(path, state.g.state_dict(), state.d.state_dict(), epoch,
                    optimizer_state(state.g_opt), optimizer_state(state.d_opt),
                    {"last_epoch": last, "base_lrs": [cfg.g_lr]},
                    {"last_epoch": last, "base_lrs": [cfg.d_lr]}, g_ema=state.g_ema)


def load_checkpoint(state: TrainState, ckpt: Dict) -> None:
    """Resume ``state`` from a reference checkpoint dict (``utils/checkpoint.py:
    load_pth``): G's and D's weights (D's spectral-norm u/v with them) and,
    where the dict has them, both optimizers' moments and step counts.  A
    state that keeps an EMA copy (``g_ema_decay > 0``) takes the dict's
    (``EMA_KEY``), or starts it again from the loaded weights where the dict
    has none; a state that keeps none drops the dict's, so a run resumed
    with ``g_ema_decay=0`` never validates with a stale average."""
    state.g.load_state_dict({k: v for k, v in ckpt["G_net"].items()
                             if not k.endswith("num_batches_tracked")})
    state.d.load_state_dict({k: v for k, v in ckpt["D_net"].items()
                             if not k.endswith("num_batches_tracked")})
    for opt, key in ((state.g_opt, "g_optimizer"), (state.d_opt, "d_optimizer")):
        if ckpt.get(key):
            load_optimizer_state(opt, ckpt[key])
    if state.g_ema is not None:
        stored = ckpt.get(EMA_KEY) or {}
        state.g_ema = {k: stored.get(k, p).detach().to(p.device, p.dtype).clone()
                       for k, p in state.g.named_parameters()}


def count_params(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
