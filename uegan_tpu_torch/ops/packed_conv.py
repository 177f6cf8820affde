"""Kernel F: stride-1 packed conv + bias + activation, float32 or bfloat16.

Port of uegan_tpu/ops/pallas/packed_conv.py:packed_conv_pallas to a CUDA
kernel for Hopper (csrc/packed_conv.cu; the design notes are in it and in
csrc/packed_conv_body.cuh).  bfloat16 runs on the tensor-core body it
shares with kernel E (TMA + wgmma); float32 runs on the CUDA cores, since
TF32 tensor cores would miss its tolerance.  The JAX
package wires the TPU kernel nowhere (only its tests call it), and so does
the port: ``chip_smoke.py`` holds the kernel against its plain version and
times it.  ``packed_conv`` checks its inputs and calls the custom op
``uegan_torch::packed_conv`` (ops/_build.py:custom_op), which launches the
kernel for a CUDA tensor and raises if it cannot, and for a CPU tensor runs
``plain_packed_conv``, the PyTorch version (``F.conv2d`` in f32 on the
zero-padded input, bias, act).  ``packed_conv.launches`` counts kernel
launches, in the CUDA impl only.

Both zero-pad the rows and the columns; the TPU kernel wraps its columns,
so only output columns [s0, W - s1) are specified by it.

Channel padding: the tensor-core body's TMA loads need 16-byte rows, so
for bfloat16 ``kernel_operands`` zero-pads x's and k's channels to a
multiple of 8 where Cin is not one (a copy; no main-path shape needs it).
Zero channels add nothing to the sums.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from uegan_tpu_torch.ops import _build

_INDEX_LIMIT = 2 ** 31  # the kernel indexes elements with 32-bit offsets


def plain_packed_conv(xp: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor, s0: int,
                      act: str = "none") -> torch.Tensor:
    """The same function in PyTorch, in f32 (f64 for f64 inputs), rounded
    to xp's dtype."""
    S = kp.shape[-1]
    s1 = S - 1 - s0
    acc = torch.promote_types(xp.dtype, torch.float32)
    x = F.pad(xp.to(acc).permute(0, 3, 1, 2), (s0, s1, s0, s1))
    y = F.conv2d(x, kp.to(acc), bias.to(acc)).permute(0, 2, 3, 1)
    if act == "leaky":
        y = torch.where(y >= 0, y, y * 0.2)
    elif act == "tanh":
        y = torch.tanh(y)
    elif act != "none":
        raise ValueError(f"unknown act {act!r}")
    return y.to(xp.dtype).contiguous()


def kernel_operands(xp: torch.Tensor, kp: torch.Tensor) -> tuple:
    """(x, wts) as the kernel reads them: wts K-major, (Cout, S, S, Cin),
    float32 for a float32 xp; for bfloat16 both in bfloat16 with their
    channels zero-padded to a multiple of 8 (16-byte TMA rows)."""
    wts = kp.permute(0, 2, 3, 1)
    if xp.dtype == torch.float32:
        return xp.contiguous(), wts.float().contiguous()
    return _build.tma_operand(xp, 8), _build.tma_operand(wts, 8)


def _packed_conv_cuda(xp: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor, s0: int,
                      act: str) -> torch.Tensor:
    """Kernel F's launch: the CUDA impl of ``uegan_torch::packed_conv``."""
    n, l, w, _ = xp.shape
    cout, _, kh, _ = kp.shape
    if max(xp.numel(), n * l * w * cout) >= _INDEX_LIMIT:
        raise ValueError(f"packed_conv: shape {tuple(xp.shape)} -> {cout} channels has 2^31 "
                         "elements or more")
    x, wts = kernel_operands(xp, kp)
    b = bias.float().contiguous()
    lib = _build.load()
    with torch.cuda.device(xp.device):
        out = torch.empty((n, l, w, cout), dtype=xp.dtype, device=xp.device)
        err = lib.uegan_packed_conv(
            x.data_ptr(), wts.data_ptr(), b.data_ptr(), out.data_ptr(), _build.dtype_code(xp),
            n, l, w, x.shape[-1], cout, kh, s0, _build.ACTS[act],
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "packed_conv")
    packed_conv.launches += 1
    return out


packed_conv_op = _build.custom_op(
    "packed_conv(Tensor xp, Tensor kp, Tensor bias, int s0, str act) -> Tensor",
    cpu=lambda xp, kp, bias, s0, act: _build.fresh(plain_packed_conv(xp, kp, bias, s0, act), xp),
    cuda=_packed_conv_cuda,
    fake=lambda xp, kp, bias, s0, act: xp.new_empty((*xp.shape[:3], kp.shape[0])))


def packed_conv(xp: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor, s0: int,
                act: str = "none") -> torch.Tensor:
    """xp (N, L, W, Cin) float32 or bfloat16, kp (Cout, Cin, S, S) and bias
    (Cout,) in xp's dtype -> act(conv(xp zero-padded by s0 lead and S-1-s0
    trail rows and columns, kp) + bias), (N, L, W, Cout) in xp's dtype,
    summed in f32; act is none, leaky or tanh."""
    _build.check_nhwc(xp, "packed_conv")
    cout, cin, kh, kw = kp.shape
    if kh != kw or xp.shape[-1] != cin or not 0 <= s0 < kh:
        raise ValueError(f"packed_conv: kp {tuple(kp.shape)} (s0 {s0}) does not fit "
                         f"xp {tuple(xp.shape)}")
    if (kp.dtype != xp.dtype or bias.dtype != xp.dtype or bias.shape != (cout,)
            or kp.device != xp.device or bias.device != xp.device):
        raise ValueError(f"packed_conv: kp {kp.dtype} {kp.device} and bias {tuple(bias.shape)} "
                         f"{bias.dtype} {bias.device} must be in xp's dtype and on its device "
                         f"({xp.dtype}, {xp.device}), bias ({cout},)")
    if act not in _build.ACTS:
        raise ValueError(f"packed_conv: unknown act {act!r}")
    if xp.device.type == "cpu" and _build.needs_grad(xp, kp, bias):
        return plain_packed_conv(xp, kp, bias, s0, act)  # the CPU gradient, as before the op
    if xp.device.type == "cuda":
        _build.refuse_grad("packed_conv", xp, kp, bias)
    return packed_conv_op(xp, kp, bias, s0, act)


packed_conv.launches = 0
