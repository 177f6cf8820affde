"""Model FLOPs of each path, counted on the reference with
``torch.utils.flop_counter.FlopCounterMode`` on the meta device: 2 x the
multiply-adds of every conv and matmul, forward and backward.  What it does
not count (power iterations, norms, the bilinear resizes, elementwise work)
is no model FLOP here, whatever the program spends on it."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import nets
from portbench.reference.train import ReferenceTrainer

META = torch.device("meta")


def _meta(spec):
    return {k: torch.empty(s, device=META) for k, s in spec.items()}


def enhance_per_image(cd: int, use_sn: bool, hw: int) -> int:
    """FLOPs of one G forward on one hw x hw image."""
    params = _meta(nets.g_spec(cd, use_sn))
    state = {k: v for k, v in params.items() if k.endswith(("weight_u", "weight_v"))}
    with FlopCounterMode(display=False) as counter:
        nets.g_forward(params, state, torch.empty((1, hw, hw, 3), device=META),
                       nets.Numerics("f32"))
    return counter.get_total_flops()


def train_per_pair(cd: int, dd: int, use_sn: bool, hw: int, batch: int) -> int:
    """FLOPs of one train step of ``batch`` pairs at hw px, over the pairs."""
    t = ReferenceTrainer(_meta(nets.g_spec(cd, use_sn)), _meta(nets.d_spec(dd)),
                         _meta(nets.vgg_spec()), (hw, hw), pool_size=batch + 1, pool_seed=0)
    x = torch.empty((batch, hw, hw, 3), device=META)
    with FlopCounterMode(display=False) as counter:
        t.step(x, x)
    return counter.get_total_flops() // batch
