"""NIMA training (``python -m uegan_tpu_torch.nima_train.cli train-model``)
through the program's own loop body: ``make_nima_train_step(model, opt,
generator)``'s step, with ``make_nima_optimizer``'s Adam, called by
``train_batch``, which uploads a batch of float32 images and rating
histograms from host memory (pageable copies), runs the step and reads the
loss back, as ``train_nima``'s loop does.  On a card the step replays a
CUDA graph from its second call on, so the checked steps hold the eager
step, the captured one and replays to the reference, and the window holds
replays alone.

Traffic parameters: ``batch``, ``image_hw``, ``examples`` (seeded examples
held in host memory, taken in turn, a multiple of ``batch``),
``checked_steps`` (set-up's first steps, which the reference follows),
``warmup_steps`` (set-up's further steps), ``trace_start_s``,
``trace_seconds``.  The configuration gives the dtype, the dropout and
Adam's learning rate.

Set-up builds the model from the seed (``seeded_weights``), drives it
through its first steps with the window's own call, and hands it to the
window.  Compared with the plain reference
(``portbench/reference/nima_train.py``) after the window, by the numbers of
``compare``: the checked steps' losses, each leaf's first gradient, each
leaf's change over the checked steps, and each BN's running mean and
variance, which no loss reaches, so only ``stats_med`` sees them.  With
``run.control`` ("fp8", "half_batch", "stats_left" or "no_dropout") the
reference itself, so computed, stands in for the program.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.drivers.train import changed, norms
from portbench.drivers.train_norm import leaf_gaps
from portbench.harness import core
from portbench.harness.weights import photos
from portbench.reference import nima_train as ref

CONTROLS = ("fp8", "half_batch", "stats_left", "no_dropout")
TRUNC_STD = 0.87962566103423978  # a unit normal truncated to [-2, 2]


def seeded_weights(seed: int, device) -> ref.Params:
    """Every parameter and running statistic from one generator on ``device``:
    conv kernels truncated he normals (sqrt(2 / fan_in)), the linear layer a
    truncated lecun normal (sqrt(1 / fan_in)), both cut at two standard
    deviations, as the program's ``NIMA.seed`` draws them; each BN's weight
    1 + 0.1 z, bias 0.1 z, running mean 0.1 z, running variance 1 + 0.1 |z|
    (z standard normal), so that no BN starts at a symmetric point; the
    linear bias 0.1 z."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in ref.spec().items():
        if len(shape) > 1:
            t = torch.empty(shape, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            gain = 2.0 if len(shape) == 4 else 1.0
            out[name] = t * (math.sqrt(gain / math.prod(shape[1:])) / TRUNC_STD)
            continue
        z = 0.1 * torch.randn(shape, generator=gen, device=device)
        if name.endswith(".running_var"):
            z = 1.0 + z.abs()
        elif name.endswith(".weight"):
            z = 1.0 + z
        out[name] = z
    return out


def seeded_examples(tr: dict, seed: int, device):
    """(examples, hw, hw, 3) float32 photos in [0, 1] and (examples, 10)
    rating histograms (seeded vote counts normalized to 1), in host memory."""
    n, hw = tr["examples"], tr["image_hw"]
    images = (photos(n, hw, hw, seed + 1, device).float() / 255.0).cpu().numpy()
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    votes = torch.rand((n, ref.BUCKETS), generator=gen, device=device) ** 2
    targets = (votes / votes.sum(dim=-1, keepdim=True)).cpu().numpy()
    return images, targets


def rows(arr: np.ndarray, k: int, b: int) -> np.ndarray:
    """Step k's rows: the next b examples, taken in turn (a view)."""
    at = (k * b) % len(arr)
    return arr[at:at + b]


class Record:
    """What one side of the comparison produced."""

    def __init__(self):
        self.losses: List[float] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.stats: Dict[str, float] = {}


def compare(got: Record, want: Record) -> Dict[str, float]:
    """The numbers compared, each a gap of norms over the larger of the
    reference's norm and the median one's (``leaf_gap``'s rule):

    - ``loss_rel``: the worst of the checked steps' losses, relative;
    - ``grad_med``: the median leaf's gap of first-gradient norms;
    - ``change_med``: the median leaf's gap of the norms of its change over
      the checked steps (a state left unchanged reads 1);
    - ``stats_med``: the median running statistic's gap of the norms of its
      change (statistics left in place read 1).

    Medians, not the worst: in bfloat16 the first layers' gradients, which
    pass back through all 53 BNs, are off by 35-124% of their norm (the
    parent's float32 BN chain reads as much), and a worst leaf or buffer
    reads as high under the float8 control.  Leaves whose reference
    gradient is under a thousandth of the median leaf's take no part: the
    loss does not reach them (each projection BN's bias adds a constant per
    channel that the next conv's BN takes out), and Adam turns both sides'
    round-off there into steps of about lr."""
    med = float(np.median(list(want.grad.values())))
    moved = [k for k, v in want.grad.items() if v >= 1e-3 * med]
    return {"loss_rel": max(abs(g - w) / abs(w) for g, w in zip(got.losses, want.losses)),
            "grad_med": float(np.median(leaf_gaps(got.grad, want.grad, moved))),
            "change_med": float(np.median(leaf_gaps(got.change, want.change, moved))),
            "stats_med": float(np.median(leaf_gaps(got.stats, want.stats, want.stats)))}


def reference_record(cfg: dict, tr: dict, seed: int, weights: ref.Params, images, targets,
                     device, control: str = "") -> Record:
    """The reference's record of the checked steps on the same rows, with
    ``control`` planted ("" for the float32 reference itself)."""
    t = ref.ReferenceTrainer(weights, seed + 3, lr=cfg["lr"],
                             numerics="fp8" if control == "fp8" else "f32",
                             dropout=0.0 if control == "no_dropout" else cfg["dropout_rate"],
                             half_batch=control == "half_batch",
                             stats_left=control == "stats_left")
    before = {k: v.detach().clone() for k, v in t.leaves.items()}
    stats_before = {k: v.clone() for k, v in t.running_stats().items()}
    rec, b = Record(), tr["batch"]
    for k in range(tr["checked_steps"]):
        x = torch.from_numpy(rows(images, k, b)).to(device)
        y = torch.from_numpy(rows(targets, k, b)).to(device)
        rec.losses.append(float(t.step(x, y)))
        if k == 0:
            rec.grad = norms(t.last_grads())
    rec.change = changed({k: v.detach() for k, v in t.leaves.items()}, before)
    rec.stats = changed(t.running_stats(), stats_before)
    return rec


def run(r: core.Run) -> core.Outcome:
    from uegan_tpu_torch.models.nima import NIMA
    from uegan_tpu_torch.nima_train.train import (make_nima_optimizer, make_nima_train_step,
                                                  train_batch)
    from uegan_tpu_torch.utils.device import DTYPES

    cfg, tr, dev = r.config, r.traffic, r.device
    b = tr["batch"]
    if tr["examples"] % b:
        raise ValueError(f"examples {tr['examples']} is not a multiple of batch {b}")
    weights = seeded_weights(r.seed, dev)
    images, targets = seeded_examples(tr, r.seed, dev)
    r.mark("weights and examples made")
    if r.control:  # readings only: the reference in the program's place, no window
        if r.control not in CONTROLS:
            raise ValueError(f"control {r.control!r}: one of {CONTROLS}")
        got = reference_record(cfg, tr, r.seed, weights, images, targets, dev, r.control)
        want = reference_record(cfg, tr, r.seed, weights, images, targets, dev)
        return core.Outcome(0.0, {}, tr["checked_steps"] * b, 0, compare(got, want), {}, 0)

    # train_nima's model, optimizer and dropout generator, with the seeded
    # weights in place of init_nima's
    model = NIMA(dtype=DTYPES[cfg["compute_dtype"]], dropout_rate=cfg["dropout_rate"]).to(dev)
    model.load_reference(weights)
    opt = make_nima_optimizer(model, cfg["lr"])
    step = make_nima_train_step(model, opt, torch.Generator(device=dev).manual_seed(r.seed + 3))
    r.mark("model built and loaded")
    leaves = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in leaves.items()}

    def buffers():
        return {k: v.detach().clone() for k, v in model.named_buffers() if k.endswith(ref.STATS)}

    stats_before = buffers()

    def call(k):
        with r.tracer.span("train_batch"):
            return train_batch(step, rows(images, k, b), rows(targets, k, b), dev)

    got = Record()
    for k in range(tr["checked_steps"]):
        got.losses.append(call(k))
        if k == 0:  # the step sets the gradients to None before its backward
            got.grad = norms({n: p.grad for n, p in leaves.items()})
    got.change = changed(leaves, before)
    got.stats = changed(buffers(), stats_before)
    r.mark("checked steps run")
    del before, stats_before
    first = tr["checked_steps"]
    for k in range(first, first + tr["warmup_steps"]):
        call(k)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - r.t_process

    steps, window_s, traced = core.closed_loop(r, lambda k: call(first + tr["warmup_steps"] + k),
                                               sync)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del model, opt, step, leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_record(cfg, tr, r.seed, weights, images, targets, dev)
    return core.Outcome(
        setup_s=setup_s, values={"train_pairs_per_s": steps * b / window_s},
        attempted=steps * b, failed=0, checks=compare(got, want),
        units={"steps": traced, "pairs": traced * b}, memory_peak_bytes=peak)
