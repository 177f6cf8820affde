"""Plain PyTorch reference of NIMA's train step: the aesthetic scorer of
Talebi & Milanfar, "NIMA: Neural Image Assessment", IEEE T-IP 2018
(arXiv:1709.05424), on a width-1.0 MobileNetV2 trunk (Sandler et al., CVPR
2018, arXiv:1801.04381), as eezkni/UEGAN vendors it
(``metrics/NIMA/mobile_net_v2.py:28-120``; the training in
``metrics/NIMA/nima/train/main.py:81-107``, the loss in
``nima/train/emd_loss.py:6-18``).

Written from the published equations, with no kernel, no layout trick and
no batching trick, in float32 with TF32 off (``nets.exact``).  It imports
nothing of the program under test.  Parameters are plain tensors in a dict
keyed by the reference checkpoint's names (``base_model.0.0.0.weight``, the
stem conv; ``base_model.0.{i}.conv.{0,1,3,4,6,7}`` the 17 inverted
residual blocks' convs and BNs; ``base_model.0.18.{0,1}`` the head conv;
``head.2`` the linear layer), so one seeded dict loads into the program and
feeds these functions alike.

One step on (B, H, W, 3) images in [0, 1] and (B, 10) rating histograms:

- the trunk: a 3x3 stride-2 conv to 32 channels, 17 inverted residual
  blocks (a 1x1 expansion by t, a 3x3 depthwise conv of the block's stride,
  a linear 1x1 projection; the input added back where the stride is 1 and
  the widths agree), a 1x1 conv to 1280; each conv followed by a train-mode
  BatchNorm (53 in all) and ReLU6 inside the blocks, ReLU after the stem and
  the head conv, none after a projection;
- BatchNorm: the batch's mean and biased variance over (N, H, W) normalize,
  eps 1e-5, then the affine weight and bias; the running statistics move as
  ``running = 0.9 running + 0.1 batch``, the biased variance included;
- the head: the global mean over the map, ReLU, dropout 0.75 (keep where a
  uniform draw of a seeded ``torch.Generator`` on the step's device is
  under 0.25, the kept values times 4; one (B, 1280) draw a step, as the
  program draws it), Linear 1280 -> 10, softmax;
- the loss: the squared earth mover's distance (r = 2) between the
  cumulative distributions, sqrt of the mean over the 10 bins of the squared
  gap, averaged over the batch;
- Adam (betas 0.9, 0.999, eps 1e-8, no weight decay) at lr 3e-4.

Departures from the reference repo, each the program's own (and the JAX
package's):

- BatchNorm is flax's: ``running_var`` takes the biased variance, where
  ``nn.BatchNorm2d`` puts in the unbiased one;
- the stem and the head conv take ReLU where the reference's MobileNetV2
  takes ReLU6 (ROADMAP queue 2);
- the first block (expansion 1) keeps a 1x1 expansion conv (32 -> 32) and
  its BN, as the JAX module does, where the reference's block has the
  depthwise conv and the projection alone: 53 BNs, not 52;
- the images enter in [0, 1] with no ImageNet normalization, as
  ``CalcNIMA.py`` scores them.

Controls for the harness (``ReferenceTrainer``'s arguments): ``numerics``
"fp8", every conv's operands rounded to float8 (e4m3) under a per-tensor
scale and multiplied in bfloat16; ``half_batch``, the step seeing the first
half of its rows; ``stats_left``, the running statistics left where they
were; ``dropout`` 0, the dropout skipped.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.nets import exact, fp8_round
from portbench.reference.train import Adam

Params = Dict[str, torch.Tensor]

# (expansion t, out channels c, repeats n, first stride s), MobileNetV2 1.0
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
           (6, 160, 3, 2), (6, 320, 1, 1))
STEM, LAST, BUCKETS = 32, 1280, 10
BN_EPS, MOMENTUM = 1e-5, 0.1  # running = (1 - MOMENTUM) running + MOMENTUM batch
STATS = ("running_mean", "running_var")
DROPOUT = 0.75


class Conv(NamedTuple):
    """A conv and the BN after it: names, widths, kernel, stride, groups and
    the activation after the BN ("relu6", "relu" or "none")."""
    conv: str
    bn: str
    cin: int
    cout: int
    k: int
    stride: int
    groups: int
    act: str


class Block(NamedTuple):
    convs: Tuple[Conv, ...]
    residual: bool


def blocks() -> List[Block]:
    """The trunk in order: the stem, the 17 inverted residual blocks, the
    head conv."""
    out = [Block((Conv("base_model.0.0.0", "base_model.0.0.1", 3, STEM, 3, 2, 1, "relu"),),
                 False)]
    cin, i = STEM, 1
    for t, c, n, s in SETTING:
        for j in range(n):
            stride, hid, p = s if j == 0 else 1, cin * t, f"base_model.0.{i}.conv"
            out.append(Block((Conv(f"{p}.0", f"{p}.1", cin, hid, 1, 1, 1, "relu6"),
                              Conv(f"{p}.3", f"{p}.4", hid, hid, 3, stride, hid, "relu6"),
                              Conv(f"{p}.6", f"{p}.7", hid, c, 1, 1, 1, "none")),
                             stride == 1 and cin == c))
            cin, i = c, i + 1
    out.append(Block((Conv(f"base_model.0.{i}.0", f"base_model.0.{i}.1", cin, LAST, 1, 1, 1,
                           "relu"),), False))
    return out


def spec() -> Dict[str, Tuple[int, ...]]:
    """Every parameter's and running statistic's name and shape."""
    out: Dict[str, Tuple[int, ...]] = {}
    for block in blocks():
        for c in block.convs:
            out[c.conv + ".weight"] = (c.cout, c.cin // c.groups, c.k, c.k)
            for name in ("weight", "bias") + STATS:
                out[f"{c.bn}.{name}"] = (c.cout,)
    out["head.2.weight"] = (BUCKETS, LAST)
    out["head.2.bias"] = (BUCKETS,)
    return out


def conv(x: torch.Tensor, w: torch.Tensor, c: Conv, numerics: str) -> torch.Tensor:
    pad = (c.k - 1) // 2
    if numerics == "f32":
        return F.conv2d(x, w, None, c.stride, pad, 1, c.groups)
    return F.conv2d(fp8_round(x).bfloat16(), fp8_round(w).bfloat16(), None, c.stride, pad, 1,
                    c.groups).float()


def batch_norm(params: Params, state: Params, prefix: str, y: torch.Tensor,
               update: bool) -> torch.Tensor:
    """Train-mode BatchNorm of y (N, C, H, W) from its two-pass statistics,
    mean = E[y], var = E[(y - mean)^2], differentiated by autograd as
    written (``F.batch_norm`` or ``torch.var_mean`` in their place lose
    digits in the backward where a channel has few values: 4.8% against
    0.75% of the gradients' float64 values at batch 4 and 64 px, in
    float32); with ``update`` the running statistics in ``state`` move
    towards the batch's mean and biased variance."""
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = torch.square(y - mean).mean(dim=(0, 2, 3), keepdim=True)
    if update:
        with torch.no_grad():
            for name, batch in (("running_mean", mean), ("running_var", var)):
                key = f"{prefix}.{name}"
                state[key] = (1 - MOMENTUM) * state[key] + MOMENTUM * batch.flatten()
    w = params[prefix + ".weight"].view(1, -1, 1, 1)
    b = params[prefix + ".bias"].view(1, -1, 1, 1)
    return (y - mean) * torch.rsqrt(var + BN_EPS) * w + b


def activation(z: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu6":
        return torch.clamp(z, 0.0, 6.0)
    if act == "relu":
        return F.relu(z)
    return z


def forward(params: Params, state: Params, x01: torch.Tensor, numerics: str = "f32",
            keep: Optional[torch.Tensor] = None, update: bool = True) -> torch.Tensor:
    """x01 (B, H, W, 3) in [0, 1] -> (B, 10) probabilities, train mode;
    ``keep``: dropout's (B, 1280) mask of kept features (None: no dropout)."""
    h = x01.permute(0, 3, 1, 2)
    for block in blocks():
        inp = h
        for c in block.convs:
            y = conv(h, params[c.conv + ".weight"], c, numerics)
            h = activation(batch_norm(params, state, c.bn, y, update), c.act)
        if block.residual:
            h = inp + h
    h = F.relu(h.mean(dim=(2, 3)))
    if keep is not None:
        h = torch.where(keep, h / (1.0 - DROPOUT), torch.zeros_like(h))
    return torch.softmax(F.linear(h, params["head.2.weight"], params["head.2.bias"]), dim=-1)


def emd_loss(target: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Squared EMD (r = 2) over the CDFs, averaged over the batch."""
    gap = torch.cumsum(target, dim=-1) - torch.cumsum(pred, dim=-1)
    return torch.sqrt(torch.mean(gap * gap, dim=-1)).mean()


class ReferenceTrainer:
    """The train state and step of the reference from the weights it is
    given (copied: the caller's tensors are not changed), the dropout drawn
    from a generator on their device seeded with ``dropout_seed``."""

    def __init__(self, params: Params, dropout_seed: int, lr: float = 3e-4,
                 numerics: str = "f32", dropout: float = DROPOUT, half_batch: bool = False,
                 stats_left: bool = False):
        if numerics not in ("f32", "fp8"):
            raise ValueError(f"numerics {numerics!r}: f32 or fp8")
        self.leaves = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in params.items() if not k.endswith(STATS)}
        self.state = {k: v.detach().clone().float() for k, v in params.items()
                      if k.endswith(STATS)}
        self.opt = Adam(self.leaves, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
        dev = next(iter(self.leaves.values())).device
        # on the meta device (FLOP counting) the draws need no generator
        self.gen = (None if dev.type == "meta"
                    else torch.Generator(device=dev).manual_seed(dropout_seed))
        self.numerics, self.dropout = numerics, dropout
        self.half_batch, self.stats_left = half_batch, stats_left

    def step(self, images: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) float32 in [0, 1], targets (B, 10) -> the loss (0-d)."""
        if self.half_batch:
            images, targets = images[:images.shape[0] // 2], targets[:targets.shape[0] // 2]
        keep = None
        if self.dropout > 0:
            draw = torch.rand((images.shape[0], LAST), generator=self.gen, device=images.device)
            keep = draw < 1.0 - self.dropout
        with exact():
            probs = forward(self.leaves, self.state, images, self.numerics, keep,
                            update=not self.stats_left)
            loss = emd_loss(targets, probs)
            grads = torch.autograd.grad(loss, list(self.leaves.values()))
        self.opt.step(dict(zip(self.leaves, grads)))
        return loss.detach()

    def last_grads(self) -> Params:
        """The gradient Adam took at its last step, by leaf name."""
        return dict(self.opt.last_grad)

    def running_stats(self) -> Params:
        return dict(self.state)
