"""x2 bilinear align-corners upsample kernel (NHWC).

Port of uegan_tpu/ops/pallas/resize2x.py:upsample2x_ac_pallas to a CUDA
kernel for Hopper (csrc/upsample2x.cu; the design note is in its header).
``upsample2x`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``plain``, the PyTorch version of the same
function, whose autograd is the CPU gradient.  Where autograd needs the
gradient of a CUDA call, the call is a ``torch.autograd.Function``: its
forward launches the kernel and its backward launches
``upsample2x_backward`` (B', the adjoint as a gather, in the same source),
whose plain version is ``plain_backward``.  ``<wrapper>.launches`` counts
kernel launches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.resize import upsample2x_align_corners as plain

_GRID_YZ_MAX = 65535  # CUDA's limit on gridDim.y (output rows) and gridDim.z (batch)


def vector_width(x: torch.Tensor, out: torch.Tensor) -> int:
    """Channels per thread: a 16-byte pack where C and both pointers allow it."""
    v = 16 // x.element_size()
    aligned = x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return v if x.shape[-1] % v == 0 and aligned else 1


def _launch(x: torch.Tensor) -> torch.Tensor:
    n, h, w, c = x.shape
    if n > _GRID_YZ_MAX or 2 * h > _GRID_YZ_MAX:
        raise ValueError(f"upsample2x: shape {tuple(x.shape)} exceeds the kernel's grid")
    lib = _build.load()
    with torch.cuda.device(x.device):
        out = torch.empty((n, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
        err = lib.uegan_upsample2x(
            x.data_ptr(), out.data_ptr(), _build.dtype_code(x), n, h, w, c,
            vector_width(x, out), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "upsample2x")
    upsample2x.launches += 1
    return out


class _Upsample2x(torch.autograd.Function):
    """Kernel B forward, kernel B' backward."""

    @staticmethod
    def forward(ctx, x):
        return _launch(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return upsample2x_backward(dy)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> (N, 2H, 2W, C) in
    x.dtype, torch bilinear ``align_corners=True`` semantics, f32 math."""
    _build.check_nhwc(x, "upsample2x")
    if x.device.type == "cpu":
        return plain(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return _Upsample2x.apply(x)
    return _launch(x)


@functools.lru_cache(maxsize=None)
def adjoint_matrix(n: int) -> np.ndarray:
    """(2n, n) float64 matrix of the x2 align-corners axis, from the kernel's
    closed form: output 2o = g x[o-1] + (1-g) x[o], g = o/(2n-1); output
    2o+1 = (1-f) x[o] + f x[o+1], f = (n-1-o)/(2n-1); taps out of range carry
    zero weight.  The forward is M @ x along the axis, the backward M.T @ dy."""
    m = np.zeros((2 * n, n))
    den = 2.0 * n - 1.0
    for o in range(n):
        g, f = o / den, (n - 1 - o) / den
        m[2 * o, max(o - 1, 0)] += g
        m[2 * o, o] += 1.0 - g
        m[2 * o + 1, o] += 1.0 - f
        m[2 * o + 1, min(o + 1, n - 1)] += f
    return m


@functools.lru_cache(maxsize=None)
def _matrix(n: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # made once per size, device and dtype, so that later calls copy nothing
    # from the host (a CUDA graph can capture them)
    with torch.inference_mode(False):
        return torch.from_numpy(adjoint_matrix(n)).to(device=device, dtype=dtype)


def plain_backward(dy: torch.Tensor) -> torch.Tensor:
    """B' in PyTorch: dy (N, 2H, 2W, C) -> dx (N, H, W, C) in dy.dtype, the
    transposed interpolation matrices applied in f32 (f64 for f64 dy)."""
    n, h2, w2, c = dy.shape
    acc = torch.promote_types(dy.dtype, torch.float32)
    mh, mw = _matrix(h2 // 2, dy.device, acc), _matrix(w2 // 2, dy.device, acc)
    t = torch.einsum("oh,nowc->nhwc", mh, dy.to(acc))
    return torch.einsum("pw,nhpc->nhwc", mw, t).to(dy.dtype)


def upsample2x_backward(dy: torch.Tensor) -> torch.Tensor:
    """Kernel B': the gradient of ``upsample2x`` given dy (N, 2H, 2W, C),
    float32 or bfloat16 -> dx (N, H, W, C) in dy.dtype, f32 sums.  A CPU
    tensor takes ``plain_backward``."""
    if dy.dim() == 4 and (dy.shape[1] % 2 or dy.shape[2] % 2):
        raise ValueError(f"upsample2x_backward: dy {tuple(dy.shape)} has an odd H or W")
    dy = dy.contiguous()
    _build.check_nhwc(dy, "upsample2x_backward")
    if dy.device.type == "cpu":
        return plain_backward(dy)
    n, h2, w2, c = dy.shape
    h, w = h2 // 2, w2 // 2
    if n > _GRID_YZ_MAX or h > _GRID_YZ_MAX:
        raise ValueError(f"upsample2x_backward: shape {tuple(dy.shape)} exceeds the grid")
    lib = _build.load()
    with torch.cuda.device(dy.device):
        dx = torch.empty((n, h, w, c), dtype=dy.dtype, device=dy.device)
        err = lib.uegan_upsample2x_bwd(
            dy.data_ptr(), dx.data_ptr(), _build.dtype_code(dy), n, h, w, c,
            vector_width(dy, dx), torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "upsample2x_backward")
    upsample2x_backward.launches += 1
    return dx


upsample2x.launches = 0
upsample2x_backward.launches = 0
