"""int8 x int8 -> int32 convolution, for the convs the JAX package hands to XLA.

The JAX int8 path computes its unfused int8 convs with
``lax.conv_general_dilated(..., preferred_element_type=jnp.int32)``
(uegan_tpu/infer/packed.py:packed_conv with ``dtype=int8``, and
uegan_tpu/infer/quantized.py: the 1x1 ga1 conv, the reflect border strips of
the fused path and the stride-2 deep head).  PyTorch has no int8 conv:
``F.conv2d`` on int8 tensors returns int8 and wraps on the CPU, and is not
implemented on CUDA.  So :func:`conv2d_int8` gathers the taps into an im2col
matrix (one copy, moving each pixel's channels as 8-, 4- or 2-byte words
where the channel count allows) and multiplies it with ``torch._int_mm``, an
int8 GEMM with an int32 result (cuBLAS on the card), which is exact.

On CUDA ``torch._int_mm`` wants more than 16 rows and both the depth and the
width a multiple of 8; the im2col matrix and the kernel are zero-padded to
that, and the padding is cut from the result.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[int, Sequence[Sequence[int]]]


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pads(padding: Padding) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) from an int or ((top, bottom), (left, right))."""
    if isinstance(padding, int):
        return padding, padding, padding, padding
    (t, b), (l, r) = padding
    return int(t), int(b), int(l), int(r)


def gemm_weight(k: torch.Tensor) -> torch.Tensor:
    """OIHW int8 kernel -> (Cout rounded up to 8, K rounded up to 8) int8,
    rows ordered as im2col's (kh, kw, cin) columns, zero-padded."""
    cout, cin, kh, kw = k.shape
    w = k.permute(0, 2, 3, 1).reshape(cout, kh * kw * cin)
    return F.pad(w, (0, _round_up(w.shape[1], 8) - w.shape[1],
                     0, _round_up(cout, 8) - cout)).contiguous()


def conv2d_int8(x: torch.Tensor, k: torch.Tensor, stride: int = 1,
                padding: Padding = 0) -> torch.Tensor:
    """x (N, H, W, Cin) int8 NHWC, k (Cout, Cin, KH, KW) int8 OIHW ->
    (N, Ho, Wo, Cout) int32: the exact integer conv with zero padding
    ``padding`` (an int, or ((top, bottom), (left, right)))."""
    if x.dtype != torch.int8 or k.dtype != torch.int8:
        raise TypeError(f"conv2d_int8: x {x.dtype} and k {k.dtype} must both be int8")
    if x.dim() != 4 or k.dim() != 4 or x.shape[-1] != k.shape[1]:
        raise ValueError(f"conv2d_int8: x {tuple(x.shape)} (NHWC) and k {tuple(k.shape)} "
                         "(OIHW) do not fit")
    cout, cin, kh, kw = k.shape
    # the gather moves each pixel's channels as words of up to 8 bytes: a
    # copy of single bytes runs far below the card's memory rate
    word = next(v for v in (8, 4, 2, 1) if cin % v == 0)
    xw = x.contiguous().view({8: torch.int64, 4: torch.int32, 2: torch.int16,
                              1: torch.int8}[word])
    t, b, l, r = _pads(padding)
    if t or b or l or r:
        xw = F.pad(xw, (0, 0, l, r, t, b))
    n, hp, wp, _ = xw.shape
    ho = (hp - kh) // stride + 1
    wo = (wp - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv2d_int8: padded input {hp}x{wp} is smaller than the kernel")
    depth = kh * kw * cin
    taps = [xw[:, i:i + stride * (ho - 1) + 1:stride, j:j + stride * (wo - 1) + 1:stride]
            for i in range(kh) for j in range(kw)]
    if _round_up(depth, 8) != depth:
        taps.append(xw.new_zeros((n, ho, wo, (_round_up(depth, 8) - depth) // word)))
    m = n * ho * wo
    cols = torch.cat(taps, dim=-1).view(torch.int8).reshape(m, -1)
    if m <= 16:
        cols = F.pad(cols, (0, 0, 0, 17 - m))
    y = torch._int_mm(cols, gemm_weight(k).t())
    return y[:m, :cout].reshape(n, ho, wo, cout)
