"""The norm layers of a train step with train-mode norms in G and D
(``csrc/norm_act.cu``, kernels named ``norm_act_nhwc_*``): the maps each
call normalizes, and the bytes each call must move at least.

A step runs G twice (G(raw), then G(exp)), nine norm layers a G, and D
five times (D(exp), D(pool), D(raw) in the D update, then D(exp) without
gradient and D(fake)), five a D: 43 forward calls at the cell's shapes.
Backward: both G graphs, the D update's three forwards and D(fake): 38.
A forward call reads x and writes y, and its statistics: the f32 mean and
variance of each group (G groups: N under instance norm, 1 under batch
norm), the weight and bias, and the running mean and variance read and
written.  A backward call reads dy and x and writes dx, reads the mean,
variance, weight and bias and writes the weight's and bias's gradients.

Not named ``kernel_*``: its calls launch without a host op to read shapes
from, so ``counts.kernels()`` and ``kernels_roofline.*`` leave it out; the
reader ``norm_roofline.train`` takes the shapes from the configuration.
"""

from __future__ import annotations

from typing import List, Tuple

from portbench.counts import numel

KERNEL_NAMES = ("norm_act_nhwc",)
ITEMSIZE = {"bfloat16": 2, "float32": 4}
# (channels in conv_dim, the map's side as a shift of the image's) of G's
# nine blocks in order, and of D's five stages
G_MAPS = ((1, 0), (2, 1), (4, 2), (8, 3), (16, 4), (8, 3), (4, 2), (2, 1), (1, 0))
D_MAPS = ((1, 1), (2, 2), (4, 3), (8, 4), (16, 5))

Shape = Tuple[int, int, int, int]


def maps(cd: int, dd: int, hw: int, batch: int) -> Tuple[List[Shape], List[Shape]]:
    """(G's nine, D's five) normalized maps (N, C, H, W) of one forward."""
    g = [(batch, cd * m, hw >> s, hw >> s) for m, s in G_MAPS]
    d = [(batch, dd * m, hw >> s, hw >> s) for m, s in D_MAPS]
    return g, d


def launches(cd: int, dd: int, hw: int, batch: int) -> Tuple[List[Shape], List[Shape]]:
    """The maps of a step's forward calls and of its backward calls, in the
    step's order (43 and 38)."""
    g, d = maps(cd, dd, hw, batch)
    fwd = g + d * 3 + g + d * 2
    bwd = d * 3 + g * 2 + d  # the D backward, then G's through D(fake)
    return fwd, bwd


def forward_bytes(shape: Shape, itemsize: int, instance: bool) -> int:
    n, c, _, _ = shape
    groups = n if instance else 1
    return 2 * numel(shape) * itemsize + 4 * (2 * groups * c + 2 * c + 4 * c)


def backward_bytes(shape: Shape, itemsize: int, instance: bool) -> int:
    n, c, _, _ = shape
    groups = n if instance else 1
    return 3 * numel(shape) * itemsize + 4 * (2 * groups * c + 2 * c + 2 * c)


def step_bytes(cfg: dict, traffic: dict) -> int:
    """The least bytes one train step's norm calls move, for a cell's
    configuration and traffic (``g_norm_fun``, ``d_norm_fun``, widths,
    ``compute_dtype``; ``image_hw``, ``batch``)."""
    es = ITEMSIZE[cfg["compute_dtype"]]
    g, d = maps(cfg["g_conv_dim"], cfg["d_conv_dim"], traffic["image_hw"], traffic["batch"])
    g_in, d_in = cfg["g_norm_fun"] == "InstanceNorm", cfg["d_norm_fun"] == "InstanceNorm"
    total = 0
    for shape in g:
        total += 2 * forward_bytes(shape, es, g_in) + 2 * backward_bytes(shape, es, g_in)
    for shape in d:
        total += 5 * forward_bytes(shape, es, d_in) + 4 * backward_bytes(shape, es, d_in)
    return total
