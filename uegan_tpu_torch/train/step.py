"""The GAN train step and the generator's inference step, counterparts of
uegan_tpu/train/step.py:make_train_step and make_eval_step.

One step, in the reference's order (reference trainer.py:75-119):

1. ``fuse_g`` (G without spectral norm or norm layers): one G forward on
   cat[raw, exp]; its raw half is the fake image, kept with its autograd
   graph for the G update, and its exp half the identity output.  Under
   ``--g_use_sn`` or a ``--g_norm_fun``, G(raw) alone (G's u and v advance
   once; its norm layers take G(raw)'s statistics);
2. the pool query on the detached fake;
3. the D update: one fused D forward over [exp, store, raw] with
   ``sn_branches=3`` (each branch scaled by the sigma of its own power
   iteration), rahinge sums, backward into D only, Adam on D.  Under a
   ``--d_norm_fun`` (``fuse_d`` off) three D forwards, each normalized
   with its own batch's statistics and each updating the running ones;
4. the G update against the updated D: unfused, first the identity output
   G(exp), a second forward (G's u and v advance a second time, after the
   raw forward's, as in JAX); with ``split_g_adv`` (the
   default) D(exp) and D(fake) as two forwards, so D's spectral norm
   advances twice; the adversarial loss, VGG fidelity on (x + 1) / 2 and
   the multiscale identity loss on the identity output; one backward into
   G only (under spectral norm it reaches each kernel through both
   forwards' sigmas, the sum of JAX's two gradients), Adam on G;
5. the EMA of G's parameters with the Karras warmup, when ``g_ema_decay > 0``.

Spans (utils/spans.py) mark the phases, in the root ``train.step``:
``train.g_forward`` (1), ``train.pool`` (2), ``train.d_update`` (3: its
``train.d_forward`` with the loss, ``train.d_backward``, and
``train.d_optim`` around ``zero_grad`` and again around ``step``),
``train.g_update`` (4: ``train.g_forward_exp`` under spectral norm,
``train.g_losses``, ``train.g_backward``, ``train.g_optim`` twice) and
``train.ema`` (5).  They time the host's side of each phase, its launches;
the device runs behind it.

On a card G's GAM statistics and upsamples run kernels A and B forward and
their backward kernels A' and B' (ops/gam_stats.py, ops/resize2x.py).  The
JAX package's ``packed_train`` (a layout lever, equal math to float
tolerance) has no counterpart: the port runs this canonical step under both
values.  Train-mode norm layers in G and D run the norm_act kernels
(ops/norm_act.py), forward and backward.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from uegan_tpu_torch.losses.gan import multiscale_gan_loss
from uegan_tpu_torch.losses.perceptual import perceptual_loss
from uegan_tpu_torch.losses.reconstruction import multiscale_rec_loss
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.train.schedules import make_lr_schedule, set_lr
from uegan_tpu_torch.train.state import TrainState
from uegan_tpu_torch.utils.spans import span


def make_train_step(state: TrainState) -> Callable[[torch.Tensor, torch.Tensor],
                                                   Tuple[Dict, Dict]]:
    """-> train_step(img_raw, img_exp) for (B, H, W, 3) float32 batches in
    [-1, 1] on the state's device; it updates ``state`` in place and returns
    (metrics, images): the five losses as 0-d device tensors under JAX's
    names, and the fake, pool and identity images."""
    cfg = state.config
    g, d, vgg = state.g, state.d, state.vgg
    mode = cfg.adv_loss_type
    # G(raw) and G(exp) as one batched forward where G is stateless per
    # sample; spectral norm takes one power iteration a forward, and a norm
    # layer its statistics from each forward's own batch, so two
    fuse_g = not cfg.g_use_sn and cfg.g_norm_fun == "none"
    fuse_d = cfg.fused_d and cfg.d_norm_fun == "none"
    g_params, d_params = list(g.parameters()), list(d.parameters())
    g_lr = make_lr_schedule(cfg.g_lr, state.steps_per_epoch, cfg.lr_decay,
                            cfg.lr_num_epochs_decay, cfg.lr_decay_ratio)
    d_lr = make_lr_schedule(cfg.d_lr, state.steps_per_epoch, cfg.lr_decay,
                            cfg.lr_num_epochs_decay, cfg.lr_decay_ratio)

    def train_step(img_raw: torch.Tensor, img_exp: torch.Tensor):
        with span("train.step"):
            return _step(img_raw, img_exp)

    def _step(img_raw: torch.Tensor, img_exp: torch.Tensor):
        b = img_raw.shape[0]
        g.train()
        d.train()
        set_lr(state.g_opt, g_lr(state.step))
        set_lr(state.d_opt, d_lr(state.step))

        # 1. the fake (and, fused, the identity output)
        with span("train.g_forward"):
            if fuse_g:
                g_both = g(torch.cat([img_raw, img_exp], dim=0))
                fake, idt_out = g_both[:b], g_both[b:]
            else:
                fake = g(img_raw)

        # 2. the pool
        with span("train.pool"):
            store = state.pool.query(fake) if cfg.pool_size > 0 else fake.detach()

        # 3. the D update
        with span("train.d_update"):
            with span("train.d_forward"):
                if fuse_d:
                    parts = [img_exp, store] + ([img_raw] if cfg.adv_input else [])
                    preds = d(torch.cat(parts, dim=0), sn_branches=len(parts))
                    real = [p[:b] for p in preds]
                    d_loss = multiscale_gan_loss(real, [p[b:2 * b] for p in preds], mode, True)
                    if cfg.adv_input:
                        d_loss = d_loss + multiscale_gan_loss(real, [p[2 * b:] for p in preds],
                                                              mode, True)
                else:
                    real = d(img_exp)
                    d_loss = multiscale_gan_loss(real, d(store), mode, True)
                    if cfg.adv_input:
                        d_loss = d_loss + multiscale_gan_loss(real, d(img_raw), mode, True)
            with span("train.d_optim"):
                state.d_opt.zero_grad(set_to_none=True)
            with span("train.d_backward"):
                d_loss.backward(inputs=d_params)
            with span("train.d_optim"):
                state.d_opt.step()

        # 4. the G update against the updated D
        with span("train.g_update"):
            if not fuse_g:
                with span("train.g_forward_exp"):
                    idt_out = g(img_exp)
            with span("train.g_losses"):
                if fuse_d and not cfg.split_g_adv:
                    preds = d(torch.cat([img_exp, fake], dim=0), sn_branches=2)
                    preds_real, preds_fake = [p[:b] for p in preds], [p[b:] for p in preds]
                else:
                    with torch.no_grad():  # no path to G's parameters; u, v still advance
                        preds_real = d(img_exp)
                    preds_fake = d(fake)
                adv = cfg.lambda_adv * multiscale_gan_loss(preds_real, preds_fake, mode, False)
                percep = cfg.lambda_percep * perceptual_loss(
                    vgg, (fake + 1.0) / 2.0, (img_raw + 1.0) / 2.0,
                    split_label=cfg.split_percep_label)
                idt = cfg.lambda_idt * multiscale_rec_loss(idt_out, img_exp, cfg.idt_loss_type)
                g_loss = adv + percep + idt
            with span("train.g_optim"):
                state.g_opt.zero_grad(set_to_none=True)
            with span("train.g_backward"):
                g_loss.backward(inputs=g_params)
            with span("train.g_optim"):
                state.g_opt.step()

        # 5. EMA, decay min(d, (1 + t) / (10 + t)) at the step before this one
        if state.g_ema is not None:
            with span("train.ema"):
                t = float(state.step)
                keep = 1.0 - min(cfg.g_ema_decay, (1.0 + t) / (10.0 + t))
                with torch.no_grad():
                    for name, p in g.named_parameters():
                        e = state.g_ema[name]
                        e.add_(p.detach().to(e.dtype) - e, alpha=keep)
        state.step += 1
        metrics = {"D/Total": d_loss.detach(), "G/Total": g_loss.detach(),
                   "G/adv_loss": adv.detach(), "G/percep_loss": percep.detach(),
                   "G/idt_loss": idt.detach()}
        images = {"fake_exp": fake.detach(), "fake_exp_store": store,
                  "real_exp_idt": idt_out.detach()}
        return metrics, images

    return train_step


def make_eval_step(g: Generator) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inference forward: G in eval mode (running statistics), no autograd.
    (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) in G's dtype."""
    g.eval()

    def eval_step(img_raw: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return g(img_raw)

    return eval_step
