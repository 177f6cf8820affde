"""GAM statistics kernel: per-(N, C) mean and unbiased std over H*W.

Port of uegan_tpu/ops/pallas/gam_stats.py:gam_mean_std_pallas to a CUDA
kernel for Hopper (csrc/gam_stats.cu; the design note is in its header).
``gam_mean_std`` checks its input and calls the custom op
``uegan_torch::gam_mean_std`` (ops/_build.py:custom_op), which launches the
kernel for a CUDA tensor and raises if it cannot, and for a CPU tensor runs
``plain``, the PyTorch version of the same function; a CPU call that
autograd records takes ``plain`` directly, whose autograd is the CPU
gradient.  Where autograd needs the gradient of a CUDA call, the call is
the op ``uegan_torch::gam_mean_std_train``: the same kernel, which then
also writes the f32 mean and var, with a registered backward that calls
``gam_mean_std_backward``, the op ``uegan_torch::gam_mean_std_backward``
(csrc/gam_stats_bwd.cu, on A's partition), whose plain version is
``plain_backward``.  ``<wrapper>.launches`` counts kernel launches, in the
CUDA impls only, so a trace (the fake kernels) counts none.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.norms import feature_mean_std as plain

# as in the .cu file: threads a block, pixels a thread loads before adding,
# blocks an SM
THREADS = 256
UNROLL = 8
_BLOCKS_PER_SM = 2
# one wave of blocks on the card's 132 SMs
_TARGET_BLOCKS = _BLOCKS_PER_SM * 132
# groups of channels a block covers at most: 8 words of 16 bytes, so at least
# 32 pixels side by side and few partials for each tile's combine
_MAX_GROUPS = 8

# per (device, stream): the combine's counters.  Blocks of two calls in flight
# on two streams must not add to one ticket, or a combine could run before
# its splits are written, or not at all.
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


class Plan(NamedTuple):
    """The kernel's partition of an (N, H*W, C) map: each thread reads
    ``vec`` channels as one word; a block covers ``groups`` groups of them
    (``tiles`` blocks across C) and runs ``rows`` = THREADS // groups pixels
    side by side; each image's pixels are cut into ``splits`` runs of
    ``chunk``."""
    vec: int
    groups: int
    tiles: int
    rows: int
    splits: int
    chunk: int


def load_width(c: int, itemsize: int, address: int) -> int:
    """Channels a thread reads as one word: the most, up to 16 bytes, that
    divide C and leave every pixel's first channel aligned to the word."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or address % (vec * itemsize)):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def split_plan(n: int, hw: int, c: int, itemsize: int, address: int = 0) -> Plan:
    """The launch plan for x (n, hw pixels, c) at ``address`` (mod 16): at most
    _TARGET_BLOCKS blocks where the map allows (a block past one wave would
    run alone in a second), each thread with at least UNROLL pixels."""
    vec = load_width(c, itemsize, address)
    words = c // vec
    tiles = -(-words // _MAX_GROUPS)
    groups = -(-words // tiles)
    rows = THREADS // groups
    want = _TARGET_BLOCKS // (n * tiles)
    most = max(1, hw // (rows * UNROLL))
    chunk = -(-hw // max(1, min(want, most)))
    return Plan(vec, groups, tiles, rows, -(-hw // chunk), chunk)


def _ticket(device: torch.device, count: int, stream: Optional[int] = None) -> torch.Tensor:
    """The current stream's zeroed counters on ``device``, at least ``count``
    (``stream``: its raw handle, when the caller has it); the kernels
    (fixed_sum.cuh: this one and norm_act's) leave them zeroed, so they are
    allocated once per stream (and again only to grow).  Calls on one stream
    run in its order, so they share them safely; calls on two streams have
    two sets."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets[key] = t
    return t


def _launch(x: torch.Tensor, eps: float, keep32: bool) -> tuple:
    """Kernel A on x: (mean, std) in x.dtype, and with ``keep32`` also the f32
    mean and the f32 var before the clamp that the backward reads."""
    n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"gam_mean_std: batch {n} exceeds the grid's 65535")
    p = split_plan(n, h * w, c, x.element_size(), x.data_ptr() % 16)
    lib = _build.load()
    with torch.cuda.device(x.device):
        ticket = _ticket(x.device, n * p.tiles)
        part = torch.empty((n, p.splits, 2, c), dtype=torch.float32, device=x.device)
        mean = torch.empty((n, 1, 1, c), dtype=x.dtype, device=x.device)
        std = torch.empty_like(mean)
        mean32 = var32 = None
        if keep32:
            mean32 = torch.empty((n, 1, 1, c), dtype=torch.float32, device=x.device)
            var32 = torch.empty_like(mean32)
        err = lib.uegan_gam_stats(
            x.data_ptr(), part.data_ptr(), ticket.data_ptr(), mean.data_ptr(), std.data_ptr(),
            0 if mean32 is None else mean32.data_ptr(), 0 if var32 is None else var32.data_ptr(),
            _build.dtype_code(x), n, h * w, c, p.vec, p.groups, p.splits, p.chunk, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "gam_mean_std")
    gam_mean_std.launches += 1
    return mean, std, mean32, var32


def _fake_stats(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], 1, 1, x.shape[3]))


def _fake_stats32(x: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], 1, 1, x.shape[3]), dtype=torch.float32)


gam_mean_std_op = _build.custom_op(
    "gam_mean_std(Tensor x, float eps) -> (Tensor, Tensor)",
    cpu=lambda x, eps: tuple(_build.fresh(t, x) for t in plain(x, eps)),
    cuda=lambda x, eps: _launch(x, eps, keep32=False)[:2],
    fake=lambda x, eps: (_fake_stats(x), _fake_stats(x)))

# A under autograd: the same kernel, which then also writes the f32 mean and
# the f32 var before the clamp, the two vectors A' reads; a second op, since
# an op's outputs are fixed by its schema
gam_mean_std_train_op = _build.custom_op(
    "gam_mean_std_train(Tensor x, float eps) -> (Tensor, Tensor, Tensor, Tensor)",
    cpu=lambda x, eps: tuple(_build.fresh(t, x) for t in (*plain(x, eps), *plain_stats32(x))),
    cuda=lambda x, eps: _launch(x, eps, keep32=True),
    fake=lambda x, eps: (_fake_stats(x), _fake_stats(x), _fake_stats32(x), _fake_stats32(x)))


def gam_mean_std(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> mean, std each
    (N, 1, 1, C) in x.dtype; unbiased variance, eps inside the root."""
    _build.check_nhwc(x, "gam_mean_std")
    if _build.needs_grad(x):
        if x.device.type == "cpu":
            return plain(x, eps)  # the CPU gradient, as before the op
        mean, std, _, _ = gam_mean_std_train_op(x, eps)
        return mean, std
    return gam_mean_std_op(x, eps)


def plain_stats32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 mean and the f32 var before the clamp that kernel A writes for
    the backward, by ``plain``'s arithmetic; each (N, 1, 1, C)."""
    n, h, w, c = x.shape
    hw = h * w
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = acc.mean(dim=(1, 2), keepdim=True)
    sq = (acc * acc).mean(dim=(1, 2), keepdim=True)
    return mean, (sq - mean * mean) * (hw / max(hw - 1, 1))


def plain_backward(x: torch.Tensor, mean32: torch.Tensor, var32: torch.Tensor,
                   dmean: torch.Tensor, dstd: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """A' in PyTorch: dx (N, H, W, C) in x.dtype from dmean, dstd (N, 1, 1, C)
    and the f32 mean and var before the clamp; f32 math (f64 for f64 inputs).
    dx = dmean/hw + dstd * f * (x - mean) / (std * max(hw - 1, 1)), with f the
    gradient of jnp.maximum(var, 0): 1, 1/2 at var == 0, 0 below."""
    n, h, w, c = x.shape
    hw = h * w
    acc = torch.promote_types(x.dtype, torch.float32)
    var = var32.to(acc)
    std = torch.sqrt(torch.clamp(var, min=0.0) + eps)
    f = torch.where(var > 0, 1.0, torch.where(var == 0, 0.5, 0.0)).to(acc)
    a = dmean.to(acc) / hw
    b = dstd.to(acc) * f / (std * max(hw - 1, 1))
    return (a + b * (x.to(acc) - mean32.to(acc))).to(x.dtype)


def backward_plan(x: torch.Tensor, dx: torch.Tensor, dmean: torch.Tensor,
                  dstd: torch.Tensor) -> Plan:
    """A's launch plan, which A' takes too, with the word width that every
    x-dtype pointer allows at once (the f32 vectors are read a channel at a
    time): ``split_plan`` at the or of their residues mod 16."""
    n, h, w, c = x.shape
    address = 0
    for t in (x, dx, dmean, dstd):
        address |= t.data_ptr() % 16
    return split_plan(n, h * w, c, x.element_size(), address)


def _backward_cuda(x: torch.Tensor, mean32: torch.Tensor, var32: torch.Tensor,
                   dmean: torch.Tensor, dstd: torch.Tensor, eps: float) -> torch.Tensor:
    """The launch of kernel A': the CUDA impl of ``uegan_torch::gam_mean_std_backward``."""
    n, h, w, c = x.shape
    for name, t in (("mean32", mean32), ("var32", var32)):
        if t.dtype != torch.float32 or t.shape != (n, 1, 1, c) or not t.is_contiguous():
            raise ValueError(f"gam_mean_std_backward: {name} must be contiguous float32 "
                             f"({n}, 1, 1, {c}), got {t.dtype} {tuple(t.shape)}")
    if x.numel() >= 2 ** 31 or n > 65535:
        raise ValueError(f"gam_mean_std_backward: shape {tuple(x.shape)} has 2^31 elements "
                         "or more, or a batch over the grid's 65535")
    lib = _build.load()
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x)
        p = backward_plan(x, dx, dmean, dstd)
        err = lib.uegan_gam_stats_bwd(
            x.data_ptr(), dmean.data_ptr(), dstd.data_ptr(), mean32.data_ptr(),
            var32.data_ptr(), dx.data_ptr(), _build.dtype_code(x), n, h * w, c, p.vec, p.groups,
            p.splits, p.chunk, eps, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "gam_mean_std_backward")
    gam_mean_std_backward.launches += 1
    return dx


gam_mean_std_backward_op = _build.custom_op(
    "gam_mean_std_backward(Tensor x, Tensor mean32, Tensor var32, Tensor dmean, Tensor dstd, "
    "float eps) -> Tensor",
    cpu=lambda x, mean32, var32, dmean, dstd, eps: _build.fresh(
        plain_backward(x, mean32, var32, dmean, dstd, eps), x),
    cuda=_backward_cuda, fake=lambda x, mean32, var32, dmean, dstd, eps: torch.empty_like(x))


def gam_mean_std_backward(x: torch.Tensor, mean32: torch.Tensor, var32: torch.Tensor,
                          dmean: Optional[torch.Tensor], dstd: Optional[torch.Tensor],
                          eps: float = 1e-5) -> torch.Tensor:
    """Kernel A': the gradient of ``gam_mean_std`` at x (CUDA, contiguous
    NHWC) given dmean and dstd (N, 1, 1, C) in x.dtype (None for zero) and
    kernel A's f32 mean and var of x -> dx in x.dtype.  A CPU tensor takes
    ``plain_backward``."""
    _build.check_nhwc(x, "gam_mean_std_backward")
    n, h, w, c = x.shape
    zeros = lambda: torch.zeros((n, 1, 1, c), dtype=x.dtype, device=x.device)
    dmean = zeros() if dmean is None else dmean.to(x.dtype).contiguous()
    dstd = zeros() if dstd is None else dstd.to(x.dtype).contiguous()
    return gam_mean_std_backward_op(x, mean32, var32, dmean, dstd, eps)


def _train_setup(ctx, inputs, output) -> None:
    x, eps = inputs
    _, _, mean32, var32 = output
    ctx.mark_non_differentiable(mean32, var32)
    ctx.save_for_backward(x, mean32, var32)
    ctx.eps = eps


def _train_backward(ctx, dmean, dstd, _dmean32, _dvar32):
    x, mean32, var32 = ctx.saved_tensors
    return gam_mean_std_backward(x, mean32, var32, dmean, dstd, ctx.eps), None


# A' is the backward of A under autograd (once differentiable: A' has no
# backward of its own)
torch.library.register_autograd(gam_mean_std_train_op, _train_backward,
                                setup_context=_train_setup, lib=_build.ops_library)


gam_mean_std.launches = 0
gam_mean_std_backward.launches = 0
