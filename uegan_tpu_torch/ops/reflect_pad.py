"""Reflect pad of a conv's input, from one or two channel parts.

The kernel (csrc/reflect_pad.cu; the design note is in its header) writes
the padded input of a reflect-padded conv in one pass: from one map, or from
the two channel parts of the decoder's concat, so the concat is never
written on its own.  It replaces no TPU kernel: JAX leaves the pad to XLA,
which fuses it into the conv.

Tensors are NCHW in ``torch.channels_last`` memory, as the port's
activations are (a part in another layout is made channels-last first), and
the padded map comes back the same way.  The custom op
``uegan_torch::reflect_pad`` (ops/_build.py:custom_op) launches the kernel
for a CUDA tensor and raises if it cannot, and for a CPU tensor runs
``plain``, ``F.pad(mode="reflect")`` of the concat.  Its registered backward
is ``_backward``: ``uegan_torch::reflect_pad_backward``, a gather into the
same parts with f32 sums in a fixed order, whose plain version is
``plain_backward`` (so a CPU train step differentiates the pad through it).

``reflect_pad`` calls the op on the CPU and in a trace (``torch.export``
records it).  An eager call on a card launches directly, and under autograd
through ``_ReflectPad``, whose backward is the same ``_backward``: a train
step pads 41 to 52 times and is held by the host's issue, and the
dispatcher's round trip through Python and the op's autograd wrapper cost it
more than the aten ops they replace.  The checks that a shape settles are
made once per shape (``_plan``, ``_plan_backward``).
``reflect_pad.launches`` and ``reflect_pad_backward.launches`` count kernel
launches (``.two_part`` those that read or wrote two parts), in the launches
only, so a trace (the fake kernels) counts none.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.utils.cache import tensor_cache

CL = torch.channels_last


def reflect_indices(n: int, pad: int, device=None) -> torch.Tensor:
    """Source index of each of the n + 2 * pad positions of a reflect-padded
    axis, as numpy's ``mode="reflect"`` gives them for any pad: period
    2(n - 1), the border not repeated."""
    idx = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    m = torch.remainder(idx, 2 * (n - 1))
    return torch.where(m > n - 1, 2 * (n - 1) - m, m)


@functools.lru_cache(maxsize=None)
def taps(n: int, pad: int) -> np.ndarray:
    """(n, T) int64: for each source index y of a padded axis, the padded
    positions whose source is y, in the kernel's order (the centre y + pad
    first, then the others ascending), -1 past the last."""
    src = reflect_indices(n, pad).numpy()
    lists = [[y + pad] + [i for i in np.flatnonzero(src == y) if i != y + pad] for y in range(n)]
    out = np.full((n, max(map(len, lists))), -1, dtype=np.int64)
    for y, row in enumerate(lists):
        out[y, :len(row)] = row
    return out


@tensor_cache(maxsize=None)
def _taps_on(n: int, pad: int, device: torch.device) -> torch.Tensor:
    # made once per size, pad and device, so that later calls copy nothing
    # from the host (a CUDA graph can capture them)
    with torch.inference_mode(False):
        return torch.from_numpy(taps(n, pad)).to(device)


def _pad_shape(x: torch.Tensor, c: int, pad: int) -> tuple:
    return (x.shape[0], c, x.shape[2] + 2 * pad, x.shape[3] + 2 * pad)


def plain(x: torch.Tensor, y: Optional[torch.Tensor], pad: int) -> torch.Tensor:
    """The pad in PyTorch: x (N, C1, H, W) and optionally y (N, C2, H, W) ->
    (N, C1 + C2, H + 2 pad, W + 2 pad), ``F.pad(mode="reflect")`` of their
    concat, channels-last; where the pad reaches H or W, which ``F.pad``
    refuses, an index gather (numpy's and so jnp.pad's reflect goes on
    reflecting), in the gather's layout."""
    t = x if y is None else torch.cat([x, y], dim=1)
    h, w = t.shape[2], t.shape[3]
    if pad >= h or pad >= w:
        rows, cols = reflect_indices(h, pad, t.device), reflect_indices(w, pad, t.device)
        return t[:, :, rows][:, :, :, cols]
    # pad the NHWC view as a 5-d (N, 1, H, W, C) map: the result stays
    # channels-last, where F.pad of the NCHW tensor returns NCHW memory
    th = F.pad(t.permute(0, 2, 3, 1).unsqueeze(1), (0, 0, pad, pad, pad, pad), mode="reflect")
    return th.squeeze(1).permute(0, 3, 1, 2)


def plain_backward(dy: torch.Tensor, pad: int, c1: int) -> List[torch.Tensor]:
    """The backward in PyTorch: dy (N, C, H + 2 pad, W + 2 pad) -> [dx1 (N,
    c1, H, W)] and, where c1 < C, dx2 (N, C - c1, H, W), channels-last, in
    dy.dtype.  Each dx element sums its dy taps in f32 (f64 for f64 dy) in
    the kernel's order, column taps outer and row taps inner, each axis's
    centre first, and is rounded once."""
    h, w = dy.shape[2] - 2 * pad, dy.shape[3] - 2 * pad
    acc_t = torch.promote_types(dy.dtype, torch.float32)
    rt, ct = _taps_on(h, pad, dy.device), _taps_on(w, pad, dy.device)
    d = dy.to(acc_t)
    acc = None
    for q in range(ct.shape[1]):
        for r in range(rt.shape[1]):
            v = d[:, :, rt[:, r].clamp_min(0)][:, :, :, ct[:, q].clamp_min(0)]
            if acc is None:
                acc = v
            else:
                ok = (rt[:, r] >= 0).view(1, 1, h, 1) & (ct[:, q] >= 0).view(1, 1, 1, w)
                acc = torch.where(ok, acc + v, acc)
    dx = acc.to(dy.dtype).contiguous(memory_format=CL)
    if c1 == dy.shape[1]:
        return [dx]
    return [dx[:, :c1].contiguous(memory_format=CL), dx[:, c1:].contiguous(memory_format=CL)]


def _check_shape(shape: tuple, dtype: torch.dtype, what: str) -> None:
    """Raise on a part the kernels do not take: rank-4, non-empty, float32
    or bfloat16."""
    if len(shape) != 4 or 0 in shape:
        raise ValueError(f"{what}: expected a non-empty rank-4 NCHW tensor, got {tuple(shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: dtype {dtype} is not float32 or bfloat16")


def _check_layout(t: torch.Tensor, what: str) -> None:
    """Raise on a tensor that is not in contiguous channels-last memory."""
    if not t.is_contiguous(memory_format=CL):
        raise ValueError(f"{what}: input must be channels-last contiguous (strides {t.stride()})")


@functools.lru_cache(maxsize=None)
def word_bytes(itemsize: int, c1: int, c2: int, address: int) -> int:
    """Bytes a thread moves at once: the most, up to 16, that divide both
    parts' bytes a pixel and ``address`` (the pointers or-ed, mod 16)."""
    word = 16
    while word > itemsize and (c1 * itemsize % word or c2 * itemsize % word or address % word):
        word //= 2
    return word


@functools.lru_cache(maxsize=None)
def _plan(xshape: tuple, yshape: Optional[tuple], dtype: torch.dtype, ydtype, pad: int) -> tuple:
    """The forward's launch arguments that the shapes fix, checked once per
    shapes, dtypes and pad: (padded shape, item size, c1, c2)."""
    _check_shape(xshape, dtype, "reflect_pad")
    n, c1, h, w = xshape
    c2 = 0
    if yshape is not None:
        _check_shape(yshape, ydtype, "reflect_pad")
        if ydtype != dtype or yshape[0] != n or yshape[2:] != xshape[2:]:
            raise ValueError(f"reflect_pad: parts {tuple(xshape)} {dtype} and "
                             f"{tuple(yshape)} {ydtype} differ beyond their channels")
        c2 = yshape[1]
    if pad < 0 or h + 2 * pad >= 2 ** 31 or (w + 2 * pad) * (c1 + c2) >= 2 ** 31:
        raise ValueError(f"reflect_pad: pad {pad} on {tuple(xshape)} is outside the kernel")
    size = dtype.itemsize
    return (n, c1 + c2, h + 2 * pad, w + 2 * pad), size, c1, c2


@functools.lru_cache(maxsize=None)
def _plan_backward(dyshape: tuple, dtype: torch.dtype, pad: int, c1: int) -> tuple:
    """The backward's launch arguments that the shape fixes, checked once
    per shape, dtype and split: (dx parts' shapes, h, w, c2)."""
    _check_shape(dyshape, dtype, "reflect_pad_backward")
    n, c, hp, wp = dyshape
    h, w = hp - 2 * pad, wp - 2 * pad
    if pad < 0 or h < 1 or w < 1 or not 0 < c1 <= c:
        raise ValueError(f"reflect_pad_backward: dy {tuple(dyshape)}, pad {pad}, c1 {c1}")
    return tuple((n, k, h, w) for k in ((c1,) if c1 == c else (c1, c - c1))), h, w, c - c1


def _stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the C entry points take it."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _on(t: torch.Tensor):
    """The context that makes t's device current: none where it already is
    (the usual case, and the cheap one for the host)."""
    if t.get_device() == torch._C._cuda_getDevice():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _launch(x: torch.Tensor, y: Optional[torch.Tensor], pad: int) -> torch.Tensor:
    """The op's CUDA impl: the parts' layout and device checked, then the
    launch."""
    _check_layout(x, "reflect_pad")
    if y is not None:
        _check_layout(y, "reflect_pad")
        if y.get_device() != x.get_device():
            raise ValueError(f"reflect_pad: parts on {x.device} and {y.device}")
    return _go(x, y, pad)


def _go(x: torch.Tensor, y: Optional[torch.Tensor], pad: int) -> torch.Tensor:
    """The forward's launch, on channels-last parts of one device; the rest
    of its checks are made once per shape (``_plan``)."""
    shape, size, c1, c2 = _plan(x.shape, None if y is None else y.shape, x.dtype,
                                None if y is None else y.dtype, pad)
    lib = _build.load()
    with _on(x):
        out = torch.empty(shape, dtype=x.dtype, device=x.device, memory_format=CL)
        xp, yp, op = x.data_ptr(), None if y is None else y.data_ptr(), out.data_ptr()
        err = lib.uegan_reflect_pad(
            xp, yp, op, shape[0], shape[2] - 2 * pad, shape[3] - 2 * pad, pad, c1 * size,
            c2 * size, word_bytes(size, c1, c2, (xp | op | (yp or 0)) % 16), _stream(x))
    if err:
        _build.check(lib, err, "reflect_pad")
    reflect_pad.launches += 1
    reflect_pad.two_part += y is not None
    return out


reflect_pad_op = _build.custom_op(
    "reflect_pad(Tensor x, Tensor? y, int pad) -> Tensor",
    cpu=lambda x, y, pad: _build.fresh(plain(x, y, pad), x, y, memory_format=CL), cuda=_launch,
    fake=lambda x, y, pad: torch.empty(
        _pad_shape(x, x.shape[1] + (0 if y is None else y.shape[1]), pad), dtype=x.dtype,
        device=x.device, memory_format=CL))


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t if t.is_contiguous(memory_format=CL) else t.contiguous(memory_format=CL)


def _setup(ctx, inputs, output) -> None:
    x, y, pad = inputs
    ctx.pad, ctx.c1, ctx.two = pad, x.shape[1], y is not None


def _backward(ctx, dout: torch.Tensor) -> tuple:
    """The pad's one backward: the op's registered autograd and
    ``_ReflectPad`` both run it."""
    dxs = reflect_pad_backward(dout, ctx.pad, ctx.c1)
    return dxs[0], (dxs[1] if ctx.two else None), None


class _ReflectPad(torch.autograd.Function):
    """An eager pad on the card under autograd: the launch, and ``_backward``
    as its backward, as the op's registered autograd has it, without the
    dispatcher's round trip through the op."""

    @staticmethod
    def forward(ctx, x, y, pad):
        _setup(ctx, (x, y, pad), None)
        return _go(x, y, pad)

    backward = staticmethod(_backward)


def reflect_pad(parts: Sequence[torch.Tensor], pad: int) -> torch.Tensor:
    """``parts``: one or two maps (N, Ci, H, W) of one dtype -> their channel
    concat reflect-padded by ``pad`` on H and W, (N, C1 [+ C2], H + 2 pad,
    W + 2 pad) in channels-last memory; any pad, as numpy's reflect."""
    if len(parts) == 1:
        x, y = _channels_last(parts[0]), None
    elif len(parts) == 2:
        x, y = _channels_last(parts[0]), _channels_last(parts[1])
    else:
        raise ValueError(f"reflect_pad: takes one or two parts, got {len(parts)}")
    if not _build.eager_cuda(x):
        return reflect_pad_op(x, y, pad)  # the CPU, and a trace, which records the op
    if y is not None and y.get_device() != x.get_device():
        raise ValueError(f"reflect_pad: parts on {x.device} and {y.device}")
    if _build.needs_grad(x, y):
        return _ReflectPad.apply(x, y, pad)
    return _go(x, y, pad)


def _launch_backward(dy: torch.Tensor, pad: int, c1: int) -> List[torch.Tensor]:
    """The backward op's CUDA impl: dy checked, then the launch."""
    _check_layout(dy, "reflect_pad_backward")
    return _go_backward(dy, pad, c1)


def _go_backward(dy: torch.Tensor, pad: int, c1: int) -> List[torch.Tensor]:
    shapes, h, w, c2 = _plan_backward(dy.shape, dy.dtype, pad, c1)
    lib = _build.load()
    size = dy.element_size()
    with _on(dy):
        dxs = [torch.empty(s, dtype=dy.dtype, device=dy.device, memory_format=CL)
               for s in shapes]
        address = dy.data_ptr()
        for t in dxs:
            address |= t.data_ptr()
        err = lib.uegan_reflect_pad_bwd(
            dy.data_ptr(), dxs[0].data_ptr(), dxs[1].data_ptr() if c2 else None,
            _build.dtype_code(dy), shapes[0][0], h, w, pad, c1, c2,
            word_bytes(size, c1, c2, address % 16) // size, _stream(dy))
    if err:
        _build.check(lib, err, "reflect_pad_backward")
    reflect_pad_backward.launches += 1
    reflect_pad_backward.two_part += c2 > 0
    return dxs


def _fake_backward(dy: torch.Tensor, pad: int, c1: int) -> List[torch.Tensor]:
    n, c, hp, wp = dy.shape
    return [torch.empty((n, k, hp - 2 * pad, wp - 2 * pad), dtype=dy.dtype, device=dy.device,
                        memory_format=CL) for k in ((c1,) if c1 == c else (c1, c - c1))]


reflect_pad_backward_op = _build.custom_op(
    "reflect_pad_backward(Tensor dy, int pad, int c1) -> Tensor[]",
    cpu=lambda dy, pad, c1: [_build.fresh(t, dy, memory_format=CL)
                             for t in plain_backward(dy, pad, c1)],
    cuda=_launch_backward, fake=_fake_backward)


def reflect_pad_backward(dy: torch.Tensor, pad: int, c1: int) -> List[torch.Tensor]:
    """The gradient of ``reflect_pad`` given dy (N, C, H + 2 pad, W + 2 pad),
    float32 or bfloat16 -> [dx1 (N, c1, H, W)] and, where c1 < C, dx2
    (N, C - c1, H, W), channels-last, in dy.dtype, f32 sums.  A CPU tensor
    takes ``plain_backward``; an eager one on a card launches without the
    dispatcher, as ``reflect_pad`` does."""
    dy = _channels_last(dy)
    if _build.eager_cuda(dy):
        return _go_backward(dy, pad, c1)
    return reflect_pad_backward_op(dy, pad, c1)


# the backward kernel is the pad's backward (once differentiable: it has no
# backward of its own)
torch.library.register_autograd(reflect_pad_op, _backward, setup_context=_setup,
                                lib=_build.ops_library)


reflect_pad.launches = 0
reflect_pad.two_part = 0
reflect_pad_backward.launches = 0
reflect_pad_backward.two_part = 0
