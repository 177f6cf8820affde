"""GAN training through ``make_train_step(state)``'s ``train_step`` (``--mode
train``'s call): a closed loop of steps on uint8 pairs held in host memory,
each step's rows normalized on the card as the Trainer's ``_to_device``
does, the losses left on the card.

Traffic parameters: ``batch``, ``image_hw``, ``pairs`` (seeded pairs, taken
in turn), ``checked_steps`` (set-up's first steps, which the reference
follows: enough that the image pool fills and its swap draws run in them),
``warmup_steps`` (set-up's further steps, so that the window runs only
warmed code), ``pool_size``, ``trace_start_s``, ``trace_seconds``.

Set-up builds one train state from the seed, drives it through its first
steps with the window's own call on rows that all differ, and hands it to
the window.  Compared with the reference after the window: each checked
step's five losses, each leaf's first gradient as Adam took it (its first
moment after step 1 over 1 - beta1), each leaf's change over the
checked steps, and under spectral norm in G the change of each of G's u and
v vectors over them.  With ``run.control`` ("fp8", or the planted fault
"half_batch") the reference itself, so computed, stands in for the program.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import core
from portbench.harness.weights import make_nets, photos
from portbench.reference import nets
from portbench.reference.train import LOSS_NAMES, ReferenceTrainer

BETA1 = 0.5


def seeded_nets(cfg: dict, seed: int, device) -> Dict[str, dict]:
    specs = {"G": nets.g_spec(cfg["g_conv_dim"], cfg["g_use_sn"]),
             "D": nets.d_spec(cfg["d_conv_dim"]), "VGG": nets.vgg_spec()}
    return make_nets(specs, seed, device, fixed_uv=("G",))


def seeded_pairs(tr: dict, seed: int, device):
    n, hw = tr["pairs"], tr["image_hw"]
    both = photos(2 * n, hw, hw, seed + 1, device).cpu().numpy()
    return both[:n], both[n:]


def rows(arr: np.ndarray, k: int, b: int) -> np.ndarray:
    """Step k's rows: the next b of the pairs, taken in turn."""
    return np.ascontiguousarray(arr[(np.arange(b) + k * b) % len(arr)])


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


class Record:
    """What one side of the comparison produced."""

    def __init__(self):
        self.losses: List[Dict[str, float]] = []
        self.grad: Dict[str, float] = {}
        self.change: Dict[str, float] = {}
        self.uv: Dict[str, float] = {}  # G's u and v: the norm of each one's change


def leaf_gap(got: Dict[str, float], want: Dict[str, float], leaves) -> float:
    """Worst leaf's |got - want| over the larger of its reference norm and
    the median leaf's."""
    med = float(np.median([want[k] for k in want]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in leaves)


def compare(got: Record, want: Record) -> Dict[str, float]:
    """The numbers compared.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move under Adam by round-off alone and
    are left out of the change."""
    loss = max(abs(g[k] - w[k]) / abs(w[k]) for g, w in zip(got.losses, want.losses)
               for k in LOSS_NAMES)
    med = float(np.median(list(want.grad.values())))
    moved = [k for k, v in want.grad.items() if v >= 1e-3 * med]
    out = {"loss_rel": loss, "grad_leaf": leaf_gap(got.grad, want.grad, want.grad),
           "change_leaf": leaf_gap(got.change, want.change, moved)}
    if want.uv:
        out["uv_leaf"] = leaf_gap(got.uv, want.uv, want.uv)
    return out


def uv_of(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """G's spectral-norm vectors, by net-qualified name, copied."""
    return {f"G:{k}": v.detach().clone() for k, v in tensors.items()
            if k.endswith(("weight_u", "weight_v"))}


def changed(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return norms({k: after[k].detach() - v for k, v in before.items()})


def reference_record(cfg: dict, tr: dict, seed: int, weights: Dict[str, dict], raw, exp,
                     device, numerics: str = "f32", half_batch: bool = False) -> Record:
    """The reference's record of the checked steps on the same rows."""
    t = ReferenceTrainer(weights["G"], weights["D"], weights["VGG"],
                         (tr["image_hw"], tr["image_hw"]), tr["pool_size"], seed + 1,
                         numerics=numerics, half_batch=half_batch)
    before = {k: v.clone() for k, v in t.leaves().items()}
    uv_before = uv_of(t.g_uv() or {})
    rec, b = Record(), tr["batch"]
    for k in range(tr["checked_steps"]):
        xr = nets.normalize_u8(torch.from_numpy(rows(raw, k, b)).to(device))
        xe = nets.normalize_u8(torch.from_numpy(rows(exp, k, b)).to(device))
        rec.losses.append({n: float(v) for n, v in t.step(xr, xe).items()})
        if k == 0:
            rec.grad = norms(t.last_grads())
    rec.change = changed(t.leaves(), before)
    rec.uv = changed(uv_of(t.g_uv() or {}), uv_before)
    return rec


def run(r: core.Run) -> core.Outcome:
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.train.image_pool import ImagePool
    from uegan_tpu_torch.train.schedules import make_optimizer
    from uegan_tpu_torch.train.state import TrainState, build_models
    from uegan_tpu_torch.train.step import make_train_step
    from uegan_tpu_torch.utils.image_io import normalize_u8

    cfg, tr, dev = r.config, r.traffic, r.device
    b, hw = tr["batch"], tr["image_hw"]
    weights = seeded_nets(cfg, r.seed, dev)
    raw, exp = seeded_pairs(tr, r.seed, dev)
    r.mark("weights and pairs made")
    if r.control:  # readings only: the reference in the program's place, no window
        got = reference_record(cfg, tr, r.seed, weights, raw, exp, dev,
                               numerics="fp8" if r.control == "fp8" else "f32",
                               half_batch=r.control == "half_batch")
        want = reference_record(cfg, tr, r.seed, weights, raw, exp, dev)
        return core.Outcome(0.0, {}, tr["checked_steps"] * b, 0, compare(got, want), {}, 0)

    args = Config(mode="train", g_conv_dim=cfg["g_conv_dim"], d_conv_dim=cfg["d_conv_dim"],
                  g_use_sn=cfg["g_use_sn"], compute_dtype=cfg["compute_dtype"],
                  image_size=2 * hw, resize_size=hw, train_batch_size=b,
                  pool_size=tr["pool_size"], seed=r.seed, is_print_network=False).validate()
    # create_train_state's parts, built on the card, minus its initialization
    # on the host: the seeded weights replace it
    g, d, vgg = build_models(args, device=dev)
    for net, key in ((g, "G"), (d, "D"), (vgg, "VGG")):
        net.load_state_dict(weights[key])
    opts = [make_optimizer(net.parameters(), args.optimizer_type, lr, args.beta1, args.beta2,
                           args.weight_decay) for net, lr in ((g, args.g_lr), (d, args.d_lr))]
    pool = ImagePool(args.pool_size, (hw, hw, 3), dev,
                     torch.Generator(device=dev).manual_seed(args.seed + 1))
    state = TrainState(args, g, d, vgg, opts[0], opts[1], pool, steps_per_epoch=1_000_000)
    del g, d, vgg, opts, pool
    step_fn = make_train_step(state)
    r.mark("train state built and loaded")
    leaves = {f"G:{k}": p for k, p in state.g.named_parameters()}
    leaves.update({f"D:{k}": p for k, p in state.d.named_parameters()})
    before = {k: p.detach().clone() for k, p in leaves.items()}
    uv_before = uv_of(dict(state.g.named_buffers()))

    def call(k):
        with r.tracer.span("to_device"):
            xr = normalize_u8(torch.from_numpy(rows(raw, k, b)).to(dev))
            xe = normalize_u8(torch.from_numpy(rows(exp, k, b)).to(dev))
        with r.tracer.span("train_step"):
            return step_fn(xr, xe)[0]

    got = Record()
    for k in range(tr["checked_steps"]):
        got.losses.append({n: float(v) for n, v in call(k).items()})
        if k == 0:
            opt_of = {id(p): opt for opt in (state.g_opt, state.d_opt)
                      for group in opt.param_groups for p in group["params"]}
            # a leaf the optimizer took no step on has no moment: no gradient
            got.grad = norms({n: opt_of[id(p)].state[p].get("exp_avg", torch.zeros_like(p))
                              / (1 - BETA1) for n, p in leaves.items()})
    got.change = changed(leaves, before)
    got.uv = changed(uv_of(dict(state.g.named_buffers())), uv_before)
    r.mark("checked steps run")
    del before
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
    del state, step_fn, leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_record(cfg, tr, r.seed, weights, raw, exp, dev)
    return core.Outcome(
        setup_s=setup_s, values={"train_pairs_per_s": steps * b / window_s},
        attempted=steps * b, failed=0, checks=compare(got, want),
        units={"steps": traced, "pairs": traced * b}, memory_peak_bytes=peak)
