"""The GAN train step, counterpart of uegan_tpu/train/step.py:make_train_step
(its make_eval_step is infer/packed.py's).

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

On a card the steady step is replayed as one CUDA graph (:class:`StepGraph`):
the first step whose host control flow is the steady one is captured (its
phases issued once, on a side stream, into the graph) and replayed, and so
is every later step of the same input shape.  The steady flow needs the
image pool full (or ``pool_size`` 0): while it fills, a query takes its
images in and branches on the host's count.  The step runs eagerly (the
phases above, issued by the host) while the pool fills, on an input shape
other than the captured one, off the card, and while a torch profiler
records host ops with their shapes (:func:`host_ops_recorded`), so that a
profile of the step names its ops.  The replay runs the same kernels in the
same order on the same tensors: the learning rates and the EMA's factor are
0-d device tensors the host writes before each step (the optimizers are
capturable Adams on a card, ``schedules.make_optimizer``), the inputs are
copied into the graph's own, and the pool's draws come from its generator,
registered with the graph, so a replay draws what an eager step would.  The
returned losses and images are then the graph's outputs, which the next
replay rewrites: read them before the next step.  A replayed step records
the span ``train.replay`` (the input copies and the replay) in its
``train.step`` and no phase span; the capture's phases record theirs inside
``train.capture``.  The counters ``train_step.captures``, ``.replays`` and
``.eager_steps`` count the step's calls by path (the captured step counts as
a capture and a replay).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
from torch.autograd import profiler as _profiler

from uegan_tpu_torch.losses.gan import multiscale_gan_loss
from uegan_tpu_torch.losses.perceptual import perceptual_loss
from uegan_tpu_torch.losses.reconstruction import multiscale_rec_loss
from uegan_tpu_torch.train.schedules import make_lr_schedule, set_lr
from uegan_tpu_torch.train.state import TrainState
from uegan_tpu_torch.utils.spans import span

_NOT_A_VALUE = object()  # an argument that no record function can take as a value


def host_ops_recorded() -> bool:
    """Whether a torch profiler records the host's ops with their shapes (as
    ``torch.profiler.profile(activities=[CPU, ...], record_shapes=True)``
    does), or marks every op as ``emit_nvtx`` and ``emit_itt`` do.  Every
    torch profiler sets ``_is_profiler_enabled``, one that records the
    device's activity alone too; a profiler that records ops with their
    shapes makes a record function convert its arguments, which fails on an
    object that is no value."""
    if not _profiler._is_profiler_enabled:
        return False
    if torch._C._autograd._profiler_type() != torch._C._profiler.ActiveProfilerType.KINETO:
        return True
    try:
        handle = torch._C._autograd._record_function_with_args_enter("train.probe",
                                                                     _NOT_A_VALUE)
    except RuntimeError:
        return True
    torch._C._autograd._record_function_with_args_exit(handle)
    return False


class StepGraph:
    """A step captured once as a CUDA graph, for replay.  ``step(raw, exp)``
    is issued once, on a side stream, into the graph; it reads copies of its
    inputs, which each replay refills, and its outputs are the graph's own
    tensors, which each replay rewrites.  ``generators``, the explicit
    ``torch.Generator`` objects it draws from, are registered with the graph, so
    each replay advances them as an eager step would.  What the step
    allocates comes from the graph's private pool, which keeps it while the
    graph lives: a per-stream ticket the kernels first make under the
    capture (ops/gam_stats.py:_ticket) is zeroed by a node of the graph."""

    @staticmethod
    def supports(device: torch.device) -> bool:
        return device.type == "cuda"

    def __init__(self, step: Callable, raw: torch.Tensor, exp: torch.Tensor,
                 generators: Sequence[torch.Generator] = ()):
        self.raw, self.exp = raw.clone(), exp.clone()
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        # thread_local: other threads (a loader's) may call the CUDA API meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = step(self.raw, self.exp)

    def fits(self, raw: torch.Tensor, exp: torch.Tensor) -> bool:
        return all(a.shape == b.shape and a.dtype == b.dtype and a.device == b.device
                   for a, b in ((raw, self.raw), (exp, self.exp)))

    def replay(self, raw: torch.Tensor, exp: torch.Tensor):
        self.raw.copy_(raw)
        self.exp.copy_(exp)
        self.graph.replay()
        return self.out


def make_train_step(state: TrainState) -> Callable[[torch.Tensor, torch.Tensor],
                                                   Tuple[Dict, Dict]]:
    """-> train_step(img_raw, img_exp) for (B, H, W, 3) float32 batches in
    [-1, 1] on the state's device; it updates ``state`` in place and returns
    (metrics, images): the five losses as 0-d device tensors under JAX's
    names, and the fake, pool and identity images.  On a card, once the
    step replays a CUDA graph, these are the graph's tensors, which the next
    step rewrites.  ``train_step.eager`` is the eager step alone."""
    cfg = state.config
    g, d, vgg = state.g, state.d, state.vgg
    mode = cfg.adv_loss_type
    # G(raw) and G(exp) as one batched forward where G is stateless per
    # sample; spectral norm takes one power iteration a forward, and a norm
    # layer its statistics from each forward's own batch, so two
    fuse_g = not cfg.g_use_sn and cfg.g_norm_fun == "none"
    fuse_d = cfg.fused_d and cfg.d_norm_fun == "none"
    g_named = list(g.named_parameters())
    g_params, d_params = [p for _, p in g_named], list(d.parameters())
    g_lr = make_lr_schedule(cfg.g_lr, state.steps_per_epoch, cfg.lr_decay,
                            cfg.lr_num_epochs_decay, cfg.lr_decay_ratio)
    d_lr = make_lr_schedule(cfg.d_lr, state.steps_per_epoch, cfg.lr_decay,
                            cfg.lr_num_epochs_decay, cfg.lr_decay_ratio)
    device = g_params[0].device
    # the EMA's factor, which the host writes before each step
    keep = torch.zeros((), device=device) if state.g_ema is not None else None
    graph, bound = None, ()

    def schedule() -> None:
        """This step's learning rates and EMA factor, where the step reads them."""
        set_lr(state.g_opt, g_lr(state.step))
        set_lr(state.d_opt, d_lr(state.step))
        if keep is not None:  # decay min(d, (1 + t) / (10 + t)) at the step before this one
            t = float(state.step)
            keep.fill_(1.0 - min(cfg.g_ema_decay, (1.0 + t) / (10.0 + t)))

    def steady() -> bool:
        """The pool is full (or off): from here on every step takes the same
        path on the host."""
        return cfg.pool_size == 0 or state.pool.count >= state.pool.pool_size

    def state_objects() -> tuple:
        """What a graph of the step reads and writes besides the models: it
        stays valid while the state holds these same objects (a resume that
        loads new optimizer state replaces them)."""
        lrs = [grp["lr"] for opt in (state.g_opt, state.d_opt) for grp in opt.param_groups]
        return (state.g_opt.state, state.d_opt.state, state.pool.images, state.g_ema,
                *(lr for lr in lrs if isinstance(lr, torch.Tensor)))

    def train_step(img_raw: torch.Tensor, img_exp: torch.Tensor):
        nonlocal graph, bound
        with span("train.step"):
            schedule()
            now = state_objects()
            if graph is not None and not (len(now) == len(bound)
                                          and all(a is b for a, b in zip(now, bound))):
                graph = None
            if (StepGraph.supports(device) and steady() and not host_ops_recorded()
                    and (graph is None or graph.fits(img_raw, img_exp))):
                if graph is None:
                    with span("train.capture"):
                        gens = [state.pool.generator] if state.pool.generator is not None else []
                        graph, bound = StepGraph(_step, img_raw, img_exp, gens), now
                    train_step.captures += 1
                with span("train.replay"):
                    out = graph.replay(img_raw, img_exp)
                train_step.replays += 1
            else:
                out = _step(img_raw, img_exp)
                train_step.eager_steps += 1
            state.step += 1
            return out

    def eager(img_raw: torch.Tensor, img_exp: torch.Tensor):
        with span("train.step"):
            schedule()
            out = _step(img_raw, img_exp)
            train_step.eager_steps += 1
            state.step += 1
            return out

    def _step(img_raw: torch.Tensor, img_exp: torch.Tensor):
        b = img_raw.shape[0]
        g.train()
        d.train()

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

        # 5. EMA: e += keep * (p - e)
        if state.g_ema is not None:
            with span("train.ema"), torch.no_grad():
                emas = [state.g_ema[name] for name, _ in g_named]
                moves = torch._foreach_sub(g_params, emas)
                torch._foreach_mul_(moves, keep)
                torch._foreach_add_(emas, moves)
        metrics = {"D/Total": d_loss.detach(), "G/Total": g_loss.detach(),
                   "G/adv_loss": adv.detach(), "G/percep_loss": percep.detach(),
                   "G/idt_loss": idt.detach()}
        images = {"fake_exp": fake.detach(), "fake_exp_store": store,
                  "real_exp_idt": idt_out.detach()}
        return metrics, images

    train_step.captures = train_step.replays = train_step.eager_steps = 0
    train_step.eager = eager
    return train_step
