"""NIMA training, counterpart of uegan_tpu/nima_train/train.py.

Squared-EMD (r=2) loss between the predicted and the ground-truth 10-bucket
distributions, Adam (optax.adam's defaults: betas 0.9/0.999, eps 1e-8, no
weight decay), validation each epoch.  BatchNorm in training follows flax,
not ``nn.BatchNorm2d`` (models/nima.py:batch_norm): the batch's biased
variance normalizes and goes into the running average, moved by momentum
0.9; the statistics are buffers, updated by the forward and never
optimized.  A float32 step runs its forward and backward with TF32 off.
The best model is saved as ``nima_best.pth`` under the reference's names,
which JAX's ``import_nima`` reads; the JAX package writes an orbax
directory there instead.
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


def make_nima_train_step(model: NIMA, opt: torch.optim.Optimizer,
                         generator: Optional[torch.Generator] = None):
    """-> ``step(images, targets)``: one training-mode forward (dropout drawn
    from ``generator``), the EMD loss, its backward and an optimizer step;
    returns the loss (a 0-d tensor on the device)."""

    def step(images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        opt.zero_grad(set_to_none=True)
        with exact_f32(model.dtype):
            loss = emd_loss(targets, model(images, generator=generator))
            loss.backward()
        opt.step()
        return loss.detach()

    return step


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
    opt = torch.optim.Adam(model.parameters(), lr=lr, eps=1e-8)
    step = make_nima_train_step(model, opt, torch.Generator(device=device).manual_seed(seed))

    train_ds = AVADataset(train_csv, train=True, seed=seed)
    val_ds = AVADataset(val_csv, train=False, seed=seed)

    best_val = float("inf")
    history = {}
    batch_size = max(1, min(batch_size, len(train_ds)))
    for epoch in range(epochs):
        losses = []
        for images, targets in train_ds.batches(batch_size, epoch=epoch):
            loss = step(torch.from_numpy(images).to(device), torch.from_numpy(targets).to(device))
            losses.append(float(loss))
        val_loss = validate_nima(model, val_ds)
        history[f"epoch{epoch}"] = val_loss
        if verbose:
            print(f"[nima] epoch {epoch}: train EMD {np.mean(losses):.4f}, val EMD {val_loss:.4f}")
        if val_loss < best_val:
            best_val = val_loss
            save_nima_pth(model, os.path.join(out_dir, "nima_best.pth"))
    history["best_val"] = best_val
    return history
