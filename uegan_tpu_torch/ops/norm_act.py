"""Train-mode BatchNorm / InstanceNorm with the block's activation folded in.

The forward and backward kernels (csrc/norm_act.cu; the design note is in
its header) normalize a conv's output with its own statistics, apply the
affine weight and bias and the activation, and update the running
statistics on the card, as JAX's ``uegan_tpu/models/blocks.py:NormLayer``
does with ``train=True`` (momentum 0.1, eps 1e-5, the biased variance to
normalize, the unbiased one into ``running_var``; under instance norm the
running statistics take the mean over the images).  The activation is a
LeakyReLU of negative ``slope`` (1: none) capped at ``cap``: NIMA's
train-mode BatchNorms (models/nima.py, flax's rule: the biased variance into
``running_var``, ``unbiased=False``) take ReLU6 (slope 0, cap 6) and ReLU
(slope 0, ``strict``: F.relu's zero derivative at 0).  ``plain`` and
``plain_backward`` are the same functions in PyTorch, which the CPU runs.

Tensors are NCHW in ``torch.channels_last`` memory, as the port's
activations are.  The norm runs only in training, which nothing exports,
so it is no ``torch.library`` op: a call on a card launches directly, under
autograd through ``_NormAct``, whose backward launches the backward
kernels; on the CPU the same Function runs the plain versions.  A train step
makes 81 of these calls (the cell ``g32inbn_train256``), a NIMA train
step 53 forward and 53 backward (``nima_train224_b128``), and the host's
launches can hold a step, so each call is one ctypes call of two launches.
The GAM's non-affine instance norm at inference (ops/gam_norm.py) launches
the same forward (``_launch``) with weight 1, bias 0 and slope 1.

``norm_act.launches`` and ``norm_act_backward.launches`` count the calls,
on the CPU too, so that a CPU step shows the launches a card step makes
(two kernels each).  The spans ``norm.forward`` and ``norm.backward``
(utils/spans.py) mark each call's host work.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.gam_stats import _ticket, split_plan
from uegan_tpu_torch.utils.spans import span

CL = torch.channels_last

def _groups(shape: tuple, instance: bool) -> Tuple[int, int, int]:
    """(groups, rows a group, count a statistic) of an (N, C, H, W) map."""
    n, _, h, w = shape
    return (n, h * w, h * w) if instance else (1, n * h * w, n * h * w)


def _unbias(cnt: int) -> float:
    return cnt / max(cnt - 1, 1)


def _act(z: torch.Tensor, slope: float, cap: float) -> torch.Tensor:
    return torch.where(z >= 0, z.clamp(max=cap), z * slope)


def _act_grad(z: torch.Tensor, g: torch.Tensor, slope: float, cap: float,
              strict: bool) -> torch.Tensor:
    """g times the activation's derivative at z: 0 above ``cap``, 1 on
    (0, cap], ``slope`` below 0, and at 0 itself ``slope`` if ``strict``
    (F.relu's rule), else 1 (torch.clamp's and jnp.where(z >= 0)'s)."""
    up = (z > 0) if strict else (z >= 0)
    return torch.where(z > cap, torch.zeros_like(g), torch.where(up, g, g * slope))


def plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
          instance: bool, slope: float = 1.0, momentum: float = 0.1, eps: float = 1e-5,
          cap: float = math.inf,
          unbiased: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward in PyTorch: x (N, C, H, W) -> y = act(((x - mean) *
    rsqrt(var + eps)) * weight + bias) in x.dtype, act(z) = min(z, cap) for
    z >= 0 and slope * z below, and the mean and the biased variance, each
    (G, C) with G = N (instance) or 1 (batch), in f32 (f64 for f64 x), the
    two-pass statistics of JAX's NormLayer.  The running statistics, when
    given, are updated in place, ``running_var`` with the unbiased variance
    (torch's and JAX's NormLayer's rule) or, ``unbiased`` false, the biased
    one (flax's BatchNorm)."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (2, 3) if instance else (0, 2, 3)
    mean = acc.mean(dim=dims, keepdim=True)
    var = torch.square(acc - mean).mean(dim=dims, keepdim=True)
    z = (acc - mean) * torch.rsqrt(var + eps) * weight.view(1, -1, 1, 1).to(acc.dtype) \
        + bias.view(1, -1, 1, 1).to(acc.dtype)
    y = _act(z, slope, cap).to(x.dtype)
    groups, _, cnt = _groups(tuple(x.shape), instance)
    mean, var = mean.reshape(groups, -1), var.reshape(groups, -1)
    if running_mean is not None:
        with torch.no_grad():
            run_var = var.mean(dim=0) * (_unbias(cnt) if unbiased else 1.0)
            running_mean.copy_((1 - momentum) * running_mean
                               + momentum * mean.mean(dim=0).to(running_mean.dtype))
            running_var.copy_((1 - momentum) * running_var
                              + momentum * run_var.to(running_var.dtype))
    return y, mean, var


def plain_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, instance: bool, slope: float = 1.0,
                   eps: float = 1e-5, cap: float = math.inf,
                   strict: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward in PyTorch: dy (N, C, H, W) and the forward's x, mean
    and var -> dx in x.dtype, and the weight's and bias's gradients (C,) in
    the statistics' dtype: the activation's derivative (``_act_grad``) at z
    recomputed from x,
    dx = weight * rstd * (dz - mean(dz) - xh * mean(dz * xh)) over each
    group, dweight and dbias summed over every row."""
    acc = mean.dtype
    n, c, _, _ = x.shape
    shape = (n, c, 1, 1) if instance else (1, c, 1, 1)
    dims = (2, 3) if instance else (0, 2, 3)
    _, _, cnt = _groups(tuple(x.shape), instance)
    w, b = weight.view(1, -1, 1, 1).to(acc), bias.view(1, -1, 1, 1).to(acc)
    rs = torch.rsqrt(var.view(shape) + eps)
    xh = (x.to(acc) - mean.view(shape)) * rs
    g = dy.to(acc)
    dz = _act_grad(xh * w + b, g, slope, cap, strict)
    sdz = dz.sum(dim=dims, keepdim=True)
    sdzx = (dz * xh).sum(dim=dims, keepdim=True)
    dx = (w * rs) * (dz - sdz / cnt - xh * (sdzx / cnt))
    return dx.to(x.dtype), sdzx.reshape(-1, c).sum(dim=0), sdz.reshape(-1, c).sum(dim=0)


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous(memory_format=CL) else t.contiguous(memory_format=CL)


class Plan(NamedTuple):
    """The launch arguments that a map's shape, dtype, kind and pointers'
    alignment fix (``_plan``): the C entry points' dtype code and
    partition, ``unbias`` = cnt / max(cnt - 1, 1), and the float32 scratch
    each direction takes (the forward's: mean, var, the splits' partials;
    the backward's: dweight, dbias, each group's two sums, the partials)."""
    code: int
    groups: int
    rows: int
    c: int
    vec: int
    gt: int
    splits: int
    chunk: int
    unbias: float
    tickets: int
    fwd_scratch: int
    bwd_scratch: int


@functools.lru_cache(maxsize=None)
def _plan(shape: torch.Size, dtype: torch.dtype, instance: bool, address: int,
          plan_groups: Optional[int] = None) -> Plan:
    """``Plan`` for an (N, C, H, W) map, checked once per shape, dtype, kind
    and alignment (the pointers or-ed, mod 16).  ``plan_groups``: cut each
    group into the runs that a map of that many groups gets, whatever the
    map's own count, so that a group's sums do not depend on it."""
    if len(shape) != 4 or 0 in shape:
        raise ValueError(f"norm_act: expected a non-empty rank-4 NCHW map, got {tuple(shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"norm_act: dtype {dtype} is not float32 or bfloat16")
    groups, rows, cnt = _groups(shape, instance)
    c = shape[1]
    if groups > 65535 or groups * rows * c >= 2 ** 62:
        raise ValueError(f"norm_act: {tuple(shape)} is outside the kernel's grid")
    p = split_plan(plan_groups or groups, rows, c, dtype.itemsize, address)
    part = groups * p.splits * 2 * c
    return Plan(0 if dtype == torch.float32 else 1, groups, rows, c, p.vec, p.groups, p.splits,
                p.chunk, _unbias(cnt), groups * p.tiles, 2 * groups * c + part,
                2 * c + 2 * groups * c + part)


def _check_params(c: int, *vectors: Optional[torch.Tensor]) -> None:
    for v in vectors:
        if v is not None and (v.dtype is not torch.float32 or not v.is_cuda or v.numel() != c
                              or not v.is_contiguous()):
            raise ValueError(f"norm_act: weight, bias and running statistics must be "
                             f"contiguous float32 ({c},) CUDA vectors, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def split_stats(stats: torch.Tensor, shape: tuple, instance: bool) -> tuple:
    """The forward's statistics (``stats``: the mean then the biased
    variance, each (G, C), first in a float32 vector) -> (mean, var) views."""
    groups, _, _ = _groups(tuple(shape), instance)
    gc = groups * shape[1]
    return stats[:gc].view(groups, -1), stats[gc:2 * gc].view(groups, -1)


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
            running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
            instance: bool, slope: float, momentum: float, eps: float,
            plan_groups: Optional[int] = None, cap: float = math.inf,
            unbiased: bool = True) -> tuple:
    """The forward kernels on a channels-last CUDA map -> (y, stats)."""
    y = torch.empty_like(x, memory_format=CL)
    xp, yp = x.data_ptr(), y.data_ptr()
    p = _plan(x.shape, x.dtype, instance, (xp | yp) % 16, plan_groups)
    _check_params(p.c, weight, bias, running_mean, running_var)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    stats = torch.empty(p.fwd_scratch, dtype=torch.float32, device=x.device)
    sp = stats.data_ptr()
    gc = p.groups * p.c
    lib = _build.load()
    err = lib.uegan_norm_act(
        xp, yp, sp + 8 * gc, _ticket(x.device, p.tickets, stream).data_ptr(), sp,
        sp + 4 * gc, weight.data_ptr(), bias.data_ptr(),
        None if running_mean is None else running_mean.data_ptr(),
        None if running_var is None else running_var.data_ptr(), p.code, p.groups, p.rows, p.c,
        p.vec, p.gt, p.splits, p.chunk, eps, slope, momentum, p.unbias if unbiased else 1.0,
        cap, stream)
    if err:
        _build.check(lib, err, "norm_act")
    return y, stats


def _launch_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stats: torch.Tensor, instance: bool, slope: float,
                     eps: float, cap: float, strict: bool) -> tuple:
    """The backward kernels -> (dx, dweight, dbias)."""
    dx = torch.empty_like(x, memory_format=CL)
    xp, dyp, dxp = x.data_ptr(), dy.data_ptr(), dx.data_ptr()
    p = _plan(x.shape, x.dtype, instance, (xp | dyp | dxp) % 16)
    if (dy.shape != x.shape or dy.dtype != x.dtype or stats.dtype is not torch.float32
            or stats.numel() < 2 * p.groups * p.c or not stats.is_contiguous()):
        raise ValueError(f"norm_act_backward: dy {dy.dtype} {tuple(dy.shape)} and stats "
                         f"{stats.dtype} {tuple(stats.shape)} do not match x {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_params(p.c, weight, bias)
    index = x.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    c, gc = p.c, p.groups * p.c
    # dweight, dbias, the groups' two sums, the splits' partials
    scratch = torch.empty(p.bwd_scratch, dtype=torch.float32, device=x.device)
    at, sp = scratch.data_ptr(), stats.data_ptr()
    lib = _build.load()
    err = lib.uegan_norm_act_bwd(
        dyp, xp, dxp, at + 4 * (2 * c + 2 * gc),
        _ticket(x.device, p.tickets, stream).data_ptr(), sp, sp + 4 * gc,
        weight.data_ptr(), bias.data_ptr(), at + 8 * c, at + 4 * (2 * c + gc), at, at + 4 * c,
        p.code, p.groups, p.rows, c, p.vec, p.gt, p.splits, p.chunk, eps, slope, cap,
        int(strict), stream)
    if err:
        _build.check(lib, err, "norm_act_backward")
    return dx, scratch[:c], scratch[c:2 * c]


def _forward(x, weight, bias, running_mean, running_var, instance, slope, momentum, eps,
             cap=math.inf, unbiased=True):
    """-> (y, stats): the kernels on a card, the plain version on the CPU;
    ``stats`` holds the mean and the biased variance that the backward
    takes (``split_stats``)."""
    norm_act.launches += 1
    if x.is_cuda:
        return _launch(_channels_last(x), weight, bias, running_mean, running_var, instance,
                       slope, momentum, eps, cap=cap, unbiased=unbiased)
    y, mean, var = plain(x, weight, bias, running_mean, running_var, instance, slope, momentum,
                         eps, cap, unbiased)
    return y, torch.cat([mean.reshape(-1), var.reshape(-1)])


class _NormAct(torch.autograd.Function):
    """The norm under autograd: the forward kernels (the plain version on
    the CPU), and the backward kernels as its backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, instance, slope, momentum,
                eps, cap, strict, unbiased):
        y, stats = _forward(x, weight, bias, running_mean, running_var, instance, slope,
                            momentum, eps, cap, unbiased)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.args = instance, slope, eps, cap, strict
        return y

    @staticmethod
    def backward(ctx, dy):
        with span("norm.backward"):
            x, weight, bias, stats = ctx.saved_tensors
            dx, dw, db = norm_act_backward(dy, x, weight, bias, stats, *ctx.args)
        return (dx, dw, db) + (None,) * 9


def norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             running_mean: Optional[torch.Tensor], running_var: Optional[torch.Tensor],
             instance: bool, slope: float = 1.0, momentum: float = 0.1, eps: float = 1e-5,
             cap: float = math.inf, strict: bool = False,
             unbiased: bool = True) -> torch.Tensor:
    """x (N, C, H, W) in float32 or bfloat16 -> act(norm(x) * weight +
    bias) in x.dtype, channels-last: act a LeakyReLU of negative ``slope``
    (1: none) capped at ``cap`` (ReLU6: slope 0, cap 6), with F.relu's
    derivative at 0 under ``strict`` (``_act_grad``); ``instance``:
    per-image statistics, else per batch.  The running statistics (float32
    (C,), or both None) are updated on x's device, whether or not autograd
    records the call, ``running_var`` with the unbiased variance or, with
    ``unbiased`` false, flax's biased one."""
    with span("norm.forward"):
        if _build.needs_grad(x, weight, bias):
            return _NormAct.apply(x, weight, bias, running_mean, running_var, instance, slope,
                                  momentum, eps, cap, strict, unbiased)
        return _forward(x, weight, bias, running_mean, running_var, instance, slope, momentum,
                        eps, cap, unbiased)[0]


def norm_act_backward(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, stats: torch.Tensor, instance: bool,
                      slope: float = 1.0, eps: float = 1e-5, cap: float = math.inf,
                      strict: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels on CUDA maps (channels-last), given the forward's
    ``stats`` (``_forward``'s, ``split_stats``) -> dx, dweight, dbias; a CPU
    map takes ``plain_backward``."""
    norm_act_backward.launches += 1
    if x.is_cuda:
        return _launch_backward(_channels_last(dy), _channels_last(x), weight, bias, stats,
                                instance, slope, eps, cap, strict)
    mean, var = split_stats(stats, x.shape, instance)
    return plain_backward(dy, x, weight, bias, mean, var, instance, slope, eps, cap, strict)


norm_act.launches = 0
norm_act_backward.launches = 0
