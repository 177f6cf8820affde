"""GAN training with train-mode norm layers in G and D (``--g_norm_fun`` /
``--d_norm_fun``) through ``make_train_step(state)``'s ``train_step``: the
``train`` driver's closed loop of steps on uint8 pairs held in host memory,
its traffic parameters, set-up and window, for a configuration with
``g_norm_fun`` and ``d_norm_fun``.

Under a norm in G the step runs G twice (G(raw), then G(exp)); under a
norm in D its D update runs three D forwards, each normalized with its own
batch's statistics.  Compared with the plain reference
(``portbench/reference/norm_train.py``) after the window, by the numbers of
``compare_norm``: the first step's losses, the leaves' first gradients
(the norm layers' weights and biases are leaves), the median leaf's change
over the checked steps, and each norm layer's running mean and running
variance, which touch no train loss, so only ``stats_leaf`` sees them.
With ``run.control`` ("fp8", "half_batch", "fused_d" or "stats_once") the
reference itself, so computed, stands in for the program.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.drivers.train import BETA1, Record, changed, leaf_gap, norms, rows, seeded_pairs
from portbench.harness import core
from portbench.harness.weights import make_nets
from portbench.reference import nets, norm_nets
from portbench.reference.norm_train import ReferenceTrainer
from portbench.reference.train import LOSS_NAMES

CONTROLS = ("fp8", "half_batch", "fused_d", "stats_once")


def seeded_nets(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """G, D and VGG from ``seed`` by the fan-in recipe, each norm layer's
    weight 1 + w, bias w, running mean w and running variance 1 + |w|."""
    specs = {"G": norm_nets.g_spec(cfg["g_conv_dim"], cfg["g_norm_fun"]),
             "D": norm_nets.d_spec(cfg["d_conv_dim"], cfg["d_norm_fun"]), "VGG": nets.vgg_spec()}
    out = make_nets(specs, seed, device)
    for net in ("G", "D"):
        norm_nets.seed_norm_layers(out[net])
    return out


def stats_of(g: Dict[str, torch.Tensor], d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The running statistics of G's and D's buffers or state, by net-qualified name, copied."""
    out = {f"G:{k}": v.detach().clone() for k, v in g.items() if k.endswith(norm_nets.STATS)}
    out.update({f"D:{k}": v.detach().clone() for k, v in d.items()
                if k.endswith(norm_nets.STATS)})
    return out


class NormRecord(Record):
    """``train.Record`` and the running statistics' changes; on the
    reference's side also each leaf's first gradient with its weight decay
    taken out (``loss_grad``), which decides the leaves compared."""

    def __init__(self):
        super().__init__()
        self.stats: Dict[str, float] = {}
        self.loss_grad: Dict[str, float] = {}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], leaves) -> List[float]:
    """Each leaf's |got - want| over the larger of its reference norm and the
    median leaf's (``train.leaf_gap`` is their largest)."""
    med = float(np.median(list(want.values())))
    return [abs(got[k] - want[k]) / max(want[k], med) for k in leaves]


def compare_norm(got: NormRecord, want: NormRecord) -> Dict[str, float]:
    """The numbers compared:

    - ``loss1_rel``: the worst of the five losses at the first step, relative
      (no step has moved the weights apart yet, so the gap is the arithmetic's);
    - ``grad_leaf``: the worst leaf's gap of first gradients;
    - ``change_med``: the median leaf's gap of the change over the checked
      steps (a state left unchanged reads about 1);
    - ``stats_leaf``: the worst running statistic's gap of its change.

    Leaves whose first gradient, its weight decay taken out, is under a
    thousandth of the median leaf's gradient in the reference take no part:
    the loss does not reach them, since what they add is a constant per
    channel that a norm takes out (the conv biases that a norm follows; each
    GAM's squeeze-excitation convs and fuse bias, ahead of its instance norm;
    the upsampling convs' biases, ahead of the next block's norm), and both
    sides' gradients there are weight decay and round-off, which Adam turns
    into steps of about lr either way."""
    med = float(np.median(list(want.grad.values())))
    moved = [k for k, v in want.loss_grad.items() if v >= 1e-3 * med]
    first = max(abs(got.losses[0][k] - want.losses[0][k]) / abs(want.losses[0][k])
                for k in LOSS_NAMES)
    return {"loss1_rel": first, "grad_leaf": leaf_gap(got.grad, want.grad, moved),
            "change_med": float(np.median(leaf_gaps(got.change, want.change, moved))),
            "stats_leaf": leaf_gap(got.stats, want.stats, want.stats)}


def reference_record(cfg: dict, tr: dict, seed: int, weights: Dict[str, dict], raw, exp,
                     device, control: str = "") -> Record:
    """The reference's record of the checked steps on the same rows, with
    ``control`` planted ("" for the float32 reference itself)."""
    t = ReferenceTrainer(weights["G"], weights["D"], weights["VGG"],
                         (tr["image_hw"], tr["image_hw"]), tr["pool_size"], seed + 1,
                         g_norm=cfg["g_norm_fun"], d_norm=cfg["d_norm_fun"],
                         numerics="fp8" if control == "fp8" else "f32",
                         half_batch=control == "half_batch",
                         fault=control if control in ("fused_d", "stats_once") else "")
    before = {k: v.clone() for k, v in t.leaves().items()}
    stats_before = t.running_stats()
    rec, b = NormRecord(), tr["batch"]
    for k in range(tr["checked_steps"]):
        xr = nets.normalize_u8(torch.from_numpy(rows(raw, k, b)).to(device))
        xe = nets.normalize_u8(torch.from_numpy(rows(exp, k, b)).to(device))
        rec.losses.append({n: float(v) for n, v in t.step(xr, xe).items()})
        if k == 0:  # each net's first step: its leaves were still ``before``
            grads = t.last_grads()
            decay = {"G": t.g_opt.wd, "D": t.d_opt.wd}
            rec.grad = norms(grads)
            rec.loss_grad = norms({n: g - decay[n[0]] * before[n] for n, g in grads.items()})
    rec.change = changed(t.leaves(), before)
    rec.stats = changed(t.running_stats(), stats_before)
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
        if r.control not in CONTROLS:
            raise ValueError(f"control {r.control!r}: one of {CONTROLS}")
        got = reference_record(cfg, tr, r.seed, weights, raw, exp, dev, r.control)
        want = reference_record(cfg, tr, r.seed, weights, raw, exp, dev)
        return core.Outcome(0.0, {}, tr["checked_steps"] * b, 0, compare_norm(got, want), {}, 0)

    args = Config(mode="train", g_conv_dim=cfg["g_conv_dim"], d_conv_dim=cfg["d_conv_dim"],
                  g_use_sn=cfg["g_use_sn"], g_norm_fun=cfg["g_norm_fun"],
                  d_norm_fun=cfg["d_norm_fun"], compute_dtype=cfg["compute_dtype"],
                  image_size=2 * hw, resize_size=hw, train_batch_size=b,
                  pool_size=tr["pool_size"], seed=r.seed, is_print_network=False).validate()
    # create_train_state's parts, built on the card, minus its initialization
    # on the host: the seeded weights and statistics replace it
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

    def buffers():
        return stats_of(dict(state.g.named_buffers()), dict(state.d.named_buffers()))

    stats_before = buffers()

    def call(k):
        with r.tracer.span("to_device"):
            xr = normalize_u8(torch.from_numpy(rows(raw, k, b)).to(dev))
            xe = normalize_u8(torch.from_numpy(rows(exp, k, b)).to(dev))
        with r.tracer.span("train_step"):
            return step_fn(xr, xe)[0]

    got = NormRecord()
    for k in range(tr["checked_steps"]):
        got.losses.append({n: float(v) for n, v in call(k).items()})
        if k == 0:
            opt_of = {id(p): opt for opt in (state.g_opt, state.d_opt)
                      for group in opt.param_groups for p in group["params"]}
            # a leaf the optimizer took no step on has no moment: no gradient
            got.grad = norms({n: opt_of[id(p)].state[p].get("exp_avg", torch.zeros_like(p))
                              / (1 - BETA1) for n, p in leaves.items()})
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
    del state, step_fn, leaves
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_record(cfg, tr, r.seed, weights, raw, exp, dev)
    return core.Outcome(
        setup_s=setup_s, values={"train_pairs_per_s": steps * b / window_s},
        attempted=steps * b, failed=0, checks=compare_norm(got, want),
        units={"steps": traced, "pairs": traced * b}, memory_peak_bytes=peak)
