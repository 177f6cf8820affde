"""The GAM's instance norm at inference, as the norm layers' kernel pair.

Every GAM of the inference forwards ends in a non-affine instance norm
(infer/packed.py: ``gam_norm_eval`` for ga2 to ga5, ``packed_instance_norm``
for ga1 on the packed map): per (image, channel), y = (x - mean) *
rsqrt(var + eps) with the biased variance, f32 statistics and y in x's
dtype, ops/norms.py:instance_norm.  ``gam_norm`` takes the map as NHWC and
runs it on a card as the norm layers' forward (ops/norm_act.py,
csrc/norm_act.cu: a statistics and an apply launch from one ctypes call)
with weight 1, bias 0, slope 1 and no running statistics.  Each image is
cut into the runs that a batch of ``PLAN_IMAGES`` gets, whatever the batch,
so that an image's sums, and so its output, do not depend on the batch it
came in (a served photo is the same alone or batched).

It is the custom op ``uegan_torch::gam_norm`` (ops/_build.py:custom_op):
its CPU impl is ``plain``, ``instance_norm`` itself on the NCHW view, so
the CPU forwards compute what they computed before the kernels, bit for
bit; its fake kernel lets ``torch.export`` record the op, and the exported
program launches the pair.  An eager call on a card launches directly, as
``reflect_pad`` does.  The train step's GAMs differentiate their norm and
keep ``instance_norm`` (models/blocks.py:GAM); a call that autograd would
record is refused (``_build.refuse_grad``).

``gam_norm.launches`` counts the calls that launch or run the plain
version, on the CPU too, so that a CPU forward shows what a card forward
launches (a packed forward: 5); a trace (the fake kernel) counts none.
"""

from __future__ import annotations

import torch

from uegan_tpu_torch.ops import _build, norm_act
from uegan_tpu_torch.ops.norms import instance_norm
from uegan_tpu_torch.utils.cache import tensor_cache

_DTYPES = (torch.float32, torch.bfloat16)
# the launch plan cuts each image as the norm layers' plan cuts a batch of
# this many images (one wave of blocks at the service's largest batch)
PLAN_IMAGES = 16


def plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The norm in PyTorch: x (N, H, W, C) -> (N, H, W, C) in x.dtype.  In
    float32 and bfloat16 it is ``instance_norm`` of the NCHW view, op for
    op; a float64 x keeps float64 math (``instance_norm`` would take it to
    float32), so that the kernels can be held to it."""
    t = x.permute(0, 3, 1, 2)
    if x.dtype != torch.float64:
        return instance_norm(t, eps).permute(0, 2, 3, 1)
    mean = t.mean(dim=(2, 3), keepdim=True)
    var = torch.clamp((t * t).mean(dim=(2, 3), keepdim=True) - mean * mean, min=0.0)
    return ((t - mean) * torch.rsqrt(var + eps)).permute(0, 2, 3, 1)


@tensor_cache(maxsize=None)
def _unit(c: int, device: torch.device) -> tuple:
    """The norm's affine weight and bias, ones and zeros (c,) float32."""
    return (torch.ones(c, dtype=torch.float32, device=device),
            torch.zeros(c, dtype=torch.float32, device=device))


def _launch(x: torch.Tensor, eps: float) -> torch.Tensor:
    """The pair on a contiguous NHWC CUDA map: the op's CUDA impl and the
    eager route."""
    if not (x.dtype in _DTYPES and x.dim() == 4 and x.is_contiguous() and x.numel()):
        _build.check_nhwc(x, "gam_norm")  # raises, naming what is wrong
    _build.load()  # raises where the kernels cannot be built
    index = x.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return _launch(x, eps)
    weight, bias = _unit(x.shape[3], x.device)
    y, _ = norm_act._launch(x.permute(0, 3, 1, 2), weight, bias, None, None, True, 1.0, 0.0,
                            eps, PLAN_IMAGES)
    gam_norm.launches += 1
    return y.permute(0, 2, 3, 1)


def _cpu(x: torch.Tensor, eps: float) -> torch.Tensor:
    gam_norm.launches += 1
    return _build.fresh(plain(x, eps), x)


gam_norm_op = _build.custom_op("gam_norm(Tensor x, float eps) -> Tensor", cpu=_cpu,
                               cuda=_launch, fake=lambda x, eps: torch.empty_like(x))


def gam_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> the non-affine
    instance norm per (image, channel) over H, W, (N, H, W, C) in x.dtype:
    the biased variance, eps inside the root, f32 statistics."""
    _build.refuse_grad("gam_norm", x)
    if _build.eager_cuda(x):
        return _launch(x, eps)
    return gam_norm_op(x, eps)


gam_norm.launches = 0
