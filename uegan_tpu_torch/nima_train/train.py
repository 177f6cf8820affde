"""NIMA training, counterpart of uegan_tpu/nima_train/train.py.

Squared-EMD (r=2) loss between the predicted and the ground-truth 10-bucket
distributions, Adam (optax.adam's defaults: betas 0.9/0.999, eps 1e-8, no
weight decay), validation each epoch.  BatchNorm in training follows flax,
not ``nn.BatchNorm2d`` (models/nima.py: each BN and its activation one
``norm_act`` call): the batch's biased variance normalizes and goes into
the running average, moved by momentum 0.9; the statistics are buffers,
updated by the forward and never optimized.  A float32 step runs its
forward and backward with TF32 off.  The best model is saved as
``nima_best.pth`` under the reference's names, which JAX's ``import_nima``
reads; the JAX package writes an orbax directory there instead.

On a card the step is replayed as one CUDA graph (train/step.py:StepGraph),
as the GAN's steady step is: the first step runs eagerly, and the next one
of the same input shapes is captured and replayed, as is every later one of
those shapes.  The optimizer must be capturable for that
(:func:`make_nima_optimizer` makes it so on a card); the step also runs
eagerly on another input shape, off the card and while a torch profiler
records host ops with their shapes (train/step.py:host_ops_recorded).  A
replay draws its dropout from ``generator``, registered with the graph, as
an eager step would, and returns the graph's loss tensor, which the next
replay rewrites: read it before the next step.

Spans (utils/spans.py): ``nima.step`` (root); an eager step's holds
``nima.forward`` (the forward and the loss), ``nima.backward`` and
``nima.optim`` (``zero_grad``, then ``step``), a replayed one's
``nima.replay`` (the input copies and the replay), and the captured one's
``nima.capture`` (over the eager phases' spans) before it;
``nima.to_device`` and ``nima.loss_read``, roots of their own, in
``train_batch``.  The step function counts its calls in ``.steps``, its
captures in ``.captures`` and its replays in ``.replays``; ``.eager`` is the
eager step alone.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from uegan_tpu_torch.losses.extra import emd_loss
from uegan_tpu_torch.metrics.nima import init_nima
from uegan_tpu_torch.models.nima import NIMA, save_nima_pth
from uegan_tpu_torch.nima_train.dataset import AVADataset
from uegan_tpu_torch.ops.conv import exact_f32
from uegan_tpu_torch.train.step import StepGraph, host_ops_recorded
from uegan_tpu_torch.utils.spans import span


def make_nima_optimizer(model: NIMA, lr: float) -> torch.optim.Adam:
    """Adam over ``model``'s parameters (betas 0.9/0.999, eps 1e-8); on a card
    a capturable one, whose step counts stay on the device, so that the
    train step can replay as a CUDA graph."""
    params = list(model.parameters())
    return torch.optim.Adam(params, lr=lr, eps=1e-8, capturable=params[0].device.type == "cuda")


def make_nima_train_step(model: NIMA, opt: torch.optim.Optimizer,
                         generator: Optional[torch.Generator] = None):
    """-> ``step(images, targets)``: one training-mode forward (dropout drawn
    from ``generator``), the EMD loss, its backward and an optimizer step;
    returns the loss (a 0-d tensor on the device).  On a card with a
    capturable ``opt``, a replay of the step's CUDA graph after its first
    eager step (module docstring)."""
    device = next(model.parameters()).device
    can_graph = StepGraph.supports(device) and all(group.get("capturable")
                                                  for group in opt.param_groups)
    gens = [generator] if generator is not None else []
    graph, warm = None, None  # the graph; the input shapes of the last eager step

    def nima_train_step(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        nonlocal graph, warm
        nima_train_step.steps += 1
        with span("nima.step"):
            model.train()
            shapes = (images.shape, targets.shape)
            if can_graph and not host_ops_recorded() and (
                    graph.fits(images, targets) if graph is not None else warm == shapes):
                if graph is None:
                    with span("nima.capture"):
                        graph = StepGraph(_step, images, targets, gens)
                    nima_train_step.captures += 1
                with span("nima.replay"):
                    loss = graph.replay(images, targets)
                nima_train_step.replays += 1
                return loss
            loss = _step(images, targets)
            warm = shapes
            return loss

    def eager(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        nima_train_step.steps += 1
        with span("nima.step"):
            model.train()
            return _step(images, targets)

    def _step(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        with span("nima.optim"):
            opt.zero_grad(set_to_none=True)
        with exact_f32(model.dtype):
            with span("nima.forward"):
                loss = emd_loss(targets, model(images, generator=generator))
            with span("nima.backward"):
                loss.backward()
        with span("nima.optim"):
            opt.step()
        return loss.detach()

    nima_train_step.steps = nima_train_step.captures = nima_train_step.replays = 0
    nima_train_step.eager = eager
    return nima_train_step


def train_batch(step, images: np.ndarray, targets: np.ndarray, device) -> float:
    """One batch of ``train_nima``'s loop: the float32 images and targets
    uploaded to ``device`` (pageable copies), ``step``, and the loss read
    back, which waits for the device to finish the step."""
    with span("nima.to_device"):
        x = torch.from_numpy(images).to(device)
        t = torch.from_numpy(targets).to(device)
    loss = step(x, t)
    with span("nima.loss_read"):
        return float(loss)


def validate_nima(model: NIMA, dataset: AVADataset, batch_size: int = 16) -> float:
    """Mean over batches of the EMD loss in eval mode (the model's mode is
    restored after)."""
    device = next(model.parameters()).device
    batch_size = max(1, min(batch_size, len(dataset)))
    was_training = model.training
    model.eval()
    losses = []
    try:
        with torch.inference_mode():
            for images, targets in dataset.batches(batch_size, shuffle=False):
                probs = model(torch.from_numpy(images).to(device))
                losses.append(float(emd_loss(torch.from_numpy(targets).to(device), probs)))
    finally:
        model.train(was_training)
    return float(np.mean(losses)) if losses else float("nan")


def train_nima(
    train_csv: str,
    val_csv: str,
    out_dir: str,
    epochs: int = 5,
    batch_size: int = 32,
    lr: float = 3e-4,
    seed: int = 1990,
    init_weights: str = "",
    verbose: bool = True,
    compute_dtype: str = "float32",
    device=None,
) -> Dict[str, float]:
    """Train NIMA on the AVA splits; returns {"epoch<i>": val EMD, ...,
    "best_val": ...} and writes ``out_dir/nima_best.pth``.  Parameters and
    the optimizer's state stay f32 under ``compute_dtype`` bfloat16."""
    os.makedirs(out_dir, exist_ok=True)
    model = init_nima(init_weights, rng_seed=seed, compute_dtype=compute_dtype, device=device)
    device = next(model.parameters()).device
    opt = make_nima_optimizer(model, lr)
    step = make_nima_train_step(model, opt, torch.Generator(device=device).manual_seed(seed))

    train_ds = AVADataset(train_csv, train=True, seed=seed)
    val_ds = AVADataset(val_csv, train=False, seed=seed)

    best_val = float("inf")
    history = {}
    batch_size = max(1, min(batch_size, len(train_ds)))
    for epoch in range(epochs):
        losses = []
        for images, targets in train_ds.batches(batch_size, epoch=epoch):
            losses.append(train_batch(step, images, targets, device))
        val_loss = validate_nima(model, val_ds)
        history[f"epoch{epoch}"] = val_loss
        if verbose:
            print(f"[nima] epoch {epoch}: train EMD {np.mean(losses):.4f}, val EMD {val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            save_nima_pth(model, os.path.join(out_dir, "nima_best.pth"))
    history["best_val"] = best_val
    return history
