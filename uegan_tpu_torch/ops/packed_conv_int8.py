"""Kernel E: int8 packed conv with a fused dequant / activation / multiply /
requant epilogue.

Port of uegan_tpu/ops/pallas/packed_conv_int8.py:packed_conv_int8_pallas
(its 1x1 and SxS bodies) to a CUDA kernel for Hopper
(csrc/packed_conv_int8.cu, on the tensor-core body it shares with kernel
F, csrc/packed_conv_body.cuh: TMA + wgmma s8 -> s32; the design note is in
the header).
``packed_conv_int8`` checks its inputs and calls the custom op
``uegan_torch::packed_conv_int8`` (ops/_build.py:custom_op; ``mul`` and
``out_scale`` optional in its schema), which launches the kernel for a CUDA
tensor and raises if it cannot, and for a CPU tensor runs
``plain_packed_conv_int8``, the PyTorch version:
:func:`~uegan_tpu_torch.ops.conv_int8.conv2d_int8` on the zero-padded
input, then :func:`int8_epilogue` in f32 in the TPU kernel's order.
``packed_conv_int8.launches`` counts kernel launches, in the CUDA impl only.
``eligible`` stays host code outside the op.

Both zero-pad the rows and the columns.  The TPU kernel wraps its columns
instead, so only output columns [s0, W - s1) are specified by it; callers
overwrite the others (the reflect border strips of
``infer/quantized.py:_conv_q_fused``).

Channel padding: the body's TMA loads need 16-byte rows, so
``kernel_operands`` zero-pads x's and k's channels to a multiple of 16
where Cin is not one (a copy; no main-path shape needs it).  Zero channels
add nothing to the int32 sums.

``eligible`` and its ``_pick_th`` are the TPU kernel's shape gate, copied so
that ``--quantized_inference int8_pallas`` routes the same convs to kernel
E as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.conv_int8 import conv2d_int8

_INDEX_LIMIT = 2 ** 31  # the kernel indexes elements with 32-bit offsets


def inv_scale(out_scale: float) -> float:
    """1 / out_scale computed in float32, as the TPU kernel's requant does."""
    return float(np.float32(1.0) / np.float32(out_scale))


def int8_epilogue(acc: torch.Tensor, w_scale: torch.Tensor, bias: torch.Tensor,
                  act: str = "none", mul: Optional[torch.Tensor] = None,
                  out_scale: Optional[float] = None, requant: bool = False,
                  divide: bool = False) -> torch.Tensor:
    """int32 sums -> ``acc * w_scale + bias`` -> act -> ``* mul`` -> bf16, or
    with ``requant`` int8 ``clip(round(y * (1 / out_scale)), -127, 127)``, in
    f32 with one rounding an op.  ``divide`` rounds ``y / out_scale``
    instead, the formula of the JAX reflect border strips
    (uegan_tpu/infer/quantized.py:169)."""
    y = acc.float() * w_scale.float()
    y = y + bias.float()
    if act == "leaky":
        y = torch.where(y >= 0, y, y * 0.2)
    elif act == "tanh":
        y = torch.tanh(y)
    elif act != "none":
        raise ValueError(f"unknown act {act!r}")
    if mul is not None:
        y = y * mul.float()
    if not requant:
        return y.to(torch.bfloat16)
    osc = float(np.float32(1.0 if out_scale is None else out_scale))
    y = y / osc if divide else y * inv_scale(osc)
    return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)


def plain_packed_conv_int8(xp: torch.Tensor, kp: torch.Tensor, w_scale: torch.Tensor,
                           bias: torch.Tensor, s0: int, act: str = "none",
                           mul: Optional[torch.Tensor] = None, out_scale: Optional[float] = None,
                           requant: bool = False) -> torch.Tensor:
    S = kp.shape[-1]
    s1 = S - 1 - s0
    acc = conv2d_int8(xp, kp, 1, ((s0, s1), (s0, s1)))
    return int8_epilogue(acc, w_scale, bias, act, mul, out_scale, requant)


def _check(xp, kp, w_scale, bias, s0, act, mul) -> None:
    if xp.dim() != 4 or kp.dim() != 4:
        raise ValueError(f"packed_conv_int8: xp {tuple(xp.shape)} must be NHWC and kp "
                         f"{tuple(kp.shape)} OIHW")
    if xp.dtype != torch.int8 or kp.dtype != torch.int8:
        raise TypeError(f"packed_conv_int8: xp {xp.dtype} and kp {kp.dtype} must be int8")
    cout, cin, kh, kw = kp.shape
    if kh != kw or xp.shape[-1] != cin or not 0 <= s0 < kh or kp.device != xp.device:
        raise ValueError(f"packed_conv_int8: kp {tuple(kp.shape)} on {kp.device} (s0 {s0}) "
                         f"does not fit xp {tuple(xp.shape)} on {xp.device}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if t.shape != (cout,) or t.dtype != torch.float32 or t.device != xp.device:
            raise ValueError(f"packed_conv_int8: {name} must be ({cout},) float32 on "
                             f"{xp.device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    if act not in _build.ACTS:
        raise ValueError(f"packed_conv_int8: unknown act {act!r}")
    if mul is not None and (mul.shape != (*xp.shape[:3], cout) or mul.dtype != torch.bfloat16
                            or mul.device != xp.device):
        raise ValueError(f"packed_conv_int8: mul must be {(*xp.shape[:3], cout)} bfloat16 on "
                         f"{xp.device}, got {tuple(mul.shape)} {mul.dtype} {mul.device}")
    if xp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"packed_conv_int8: device {xp.device} is neither cpu nor cuda")


def kernel_operands(xp: torch.Tensor, kp: torch.Tensor) -> tuple:
    """(x, wts) as the kernel reads them: x (N, L, W, Cpad) and the weights
    K-major, (Cout, S, S, Cpad), int8, Cpad = Cin rounded up to a multiple
    of 16 with zero channels (16-byte TMA rows), 16-byte aligned."""
    return _build.tma_operand(xp, 16), _build.tma_operand(kp.permute(0, 2, 3, 1), 16)


def _packed_conv_int8_cuda(xp: torch.Tensor, kp: torch.Tensor, w_scale: torch.Tensor,
                           bias: torch.Tensor, s0: int, act: str, mul: Optional[torch.Tensor],
                           out_scale: Optional[float], requant: bool) -> torch.Tensor:
    """Kernel E's launch: the CUDA impl of ``uegan_torch::packed_conv_int8``."""
    n, l, w, _ = xp.shape
    cout = kp.shape[0]
    if max(xp.numel(), n * l * w * cout) >= _INDEX_LIMIT:
        raise ValueError(f"packed_conv_int8: shape {tuple(xp.shape)} -> {cout} channels has "
                         "2^31 elements or more")
    x, wts = kernel_operands(xp, kp)
    ws, b = w_scale.contiguous(), bias.contiguous()  # referenced until the launch
    if mul is not None:
        mul = mul.contiguous()
    inv = inv_scale(out_scale if out_scale is not None else 1.0)
    lib = _build.load()
    with torch.cuda.device(xp.device):
        out = torch.empty((n, l, w, cout), dtype=torch.int8 if requant else torch.bfloat16,
                          device=xp.device)
        err = lib.uegan_packed_conv_int8(
            x.data_ptr(), wts.data_ptr(), ws.data_ptr(), b.data_ptr(),
            0 if mul is None else mul.data_ptr(), out.data_ptr(), n, l, w, x.shape[-1], cout,
            kp.shape[-1], s0, _build.ACTS[act], int(requant), inv,
            int(mul is not None and cout % 8 == 0 and mul.data_ptr() % 16 == 0),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "packed_conv_int8")
    packed_conv_int8.launches += 1
    return out


def _packed_conv_int8_fake(xp, kp, w_scale, bias, s0, act, mul, out_scale, requant):
    return xp.new_empty((*xp.shape[:3], kp.shape[0]),
                        dtype=torch.int8 if requant else torch.bfloat16)


packed_conv_int8_op = _build.custom_op(
    "packed_conv_int8(Tensor xp, Tensor kp, Tensor w_scale, Tensor bias, int s0, str act, "
    "Tensor? mul, float? out_scale, bool requant) -> Tensor",
    cpu=lambda xp, kp, w_scale, bias, s0, act, mul, out_scale, requant: _build.fresh(
        plain_packed_conv_int8(xp, kp, w_scale, bias, s0, act, mul, out_scale, requant), xp),
    cuda=_packed_conv_int8_cuda, fake=_packed_conv_int8_fake)


def packed_conv_int8(xp: torch.Tensor, kp: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, s0: int, act: str = "none",
                     mul: Optional[torch.Tensor] = None, out_scale: Optional[float] = None,
                     requant: bool = False) -> torch.Tensor:
    """int8 conv of xp (N, L, W, Cin) with kp (Cout, Cin, S, S), zero-padded
    by s0 lead and S-1-s0 trail rows and columns, then the epilogue:
    ``y = acc * w_scale + bias`` (both (Cout,) float32), ``act`` (none,
    leaky, tanh), ``y *= mul`` ((N, L, W, Cout) bfloat16) when given, and
    bfloat16 out, or int8 ``clip(round(y / out_scale), -127, 127)`` with
    ``requant`` (the reciprocal taken in float32)."""
    _check(xp, kp, w_scale, bias, s0, act, mul)
    xp = xp.contiguous()
    if xp.device.type == "cpu" and _build.needs_grad(w_scale, bias, mul):
        # the CPU gradient, as before the op
        return plain_packed_conv_int8(xp, kp, w_scale, bias, s0, act, mul, out_scale, requant)
    if xp.device.type == "cuda":
        _build.refuse_grad("packed_conv_int8", w_scale, bias, mul)
    return packed_conv_int8_op(xp, kp, w_scale, bias, s0, act, mul,
                               None if out_scale is None else float(out_scale), requant)


packed_conv_int8.launches = 0


# ---------------------------------------------------------------------------
# the TPU kernel's shape gate (uegan_tpu/ops/pallas/packed_conv_int8.py:147,265)
# ---------------------------------------------------------------------------
def _pick_th(l: int, w: int, cin: int, cout: int, s: int, has_mul: bool,
             budget: int = 10 * 1024 * 1024) -> int:
    """Largest row tile dividing l whose buffers fit the TPU kernel's VMEM
    budget (bulk block and mul block double-buffered, hence x2)."""
    th = l
    while th > 1:
        bulk_b = 2 * th * w * cin
        slab_b = (th + s + 1) * w * cin if s > 1 else 0
        acc_b = th * w * cout * 4
        mul_b = 2 * th * w * cout * 2 if has_mul else 0
        if bulk_b + slab_b + acc_b + mul_b <= budget and l % th == 0:
            return th
        th //= 2
    return 1


def eligible(xp_shape: Tuple[int, ...], kp_shape: Tuple[int, ...]) -> bool:
    """The shapes the TPU kernel takes: 128-lane channels, aligned W tiles.
    ``kp_shape`` is HWIO, (S, S, Cin, Cout), as in the JAX package."""
    n, l, w, cin = xp_shape
    S, _, _, cout = kp_shape
    return (
        cin % 128 == 0
        and cout % 128 == 0
        and w % 128 == 0
        and l % 8 == 0
        and l // _pick_th(l, w, cin, cout, S, False) >= 2
    )
