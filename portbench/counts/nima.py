"""NIMA's train step (``portbench/reference/nima_train.py``): the maps of
its 53 train-mode BatchNorms, the bytes their norm calls must move at least
(``csrc/norm_act.cu``, kernels named ``norm_act_nhwc_*``), and its model
FLOPs.

Every BN normalizes one group for the batch (G = 1) and runs one forward
and one backward call a step; the bytes of each are
``norm_layers.forward_bytes`` and ``backward_bytes`` (x read and y written;
dy and x read and dx written; the f32 statistics, weight and bias).  The
FLOPs are counted on the reference with ``FlopCounterMode`` on the meta
device, as ``flops.py`` counts the other paths (2 x the multiply-adds of
every conv and of the linear layer), on the forward, and the backward
counted as twice the forward (each layer's input gradient and weight
gradient take as many multiply-adds as its forward): ``FlopCounterMode``'s
rule for a conv's backward counts a grouped conv as a dense one, 96 to 960
times the depthwise convs' work.

Not named ``kernel_*``: the norm calls launch without a host op to read
shapes from (``norm_layers.py`` says why); the readers take the shapes from
the configuration and the traffic.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import norm_layers
from portbench.reference import nima_train as ref

KERNEL_NAMES = norm_layers.KERNEL_NAMES

Shape = Tuple[int, int, int, int]


def bn_maps(hw: int, batch: int) -> List[Shape]:
    """The 53 normalized maps (N, C, H, W) of one forward, in order."""
    out = []
    for block in ref.blocks():
        for c in block.convs:
            hw = (hw + 1) // 2 if c.stride == 2 else hw
            out.append((batch, c.cout, hw, hw))
    return out


def norm_step_bytes(cfg: dict, traffic: dict) -> int:
    """The least bytes one train step's 53 forward and 53 backward norm
    calls move, for the cell's ``compute_dtype``, ``image_hw`` and ``batch``."""
    es = norm_layers.ITEMSIZE[cfg["compute_dtype"]]
    return sum(norm_layers.forward_bytes(s, es, False) + norm_layers.backward_bytes(s, es, False)
               for s in bn_maps(traffic["image_hw"], traffic["batch"]))


@functools.lru_cache(maxsize=None)
def train_flops_per_pair(hw: int) -> int:
    """Model FLOPs of one train step at hw px, an example: 3 x the forward's."""
    meta = torch.device("meta")
    params = {k: torch.empty(s, device=meta) for k, s in ref.spec().items()}
    state = {k: v for k, v in params.items() if k.endswith(ref.STATS)}
    with FlopCounterMode(display=False) as counter:
        ref.forward(params, state, torch.empty((1, hw, hw, 3), device=meta))
    return 3 * counter.get_total_flops()
