"""The packed path's two space-to-depth boundary passes, as CUDA kernels.

Port of uegan_tpu/ops/pallas/s2d_fuse.py to Hopper (csrc/s2d_fuse.cu; the
design note is in its header):

- ``s2d_convert``: float (N,H,W,C) -> space_to_depth in ``out_dtype``,
  (N,H/2,W/2,4C), the packed forward's entry (kernel C);
- ``residual_tail_d2s``: depth_to_space(clip(res + xp, -1, 1)) with the add
  and clip in f32, the packed forward's exit (kernel D).

Each wrapper launches its kernel for a CUDA tensor and raises if it cannot;
for a CPU tensor it runs the plain PyTorch version (``plain_s2d_convert``,
``plain_residual_tail_d2s``).  ``<wrapper>.launches`` counts kernel launches.

``space_to_depth`` and ``depth_to_space`` are the layout transforms both
plain versions are built from.  Channels are phase-major: packed channel
``(pi*2 + pj)*C + c`` holds original pixel (2i + pi, 2j + pj), channel c.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from uegan_tpu_torch.ops import _build

_INDEX_LIMIT = 2 ** 31  # the kernels index elements with 32-bit offsets
_SMEM_TARGET = 24 * 1024  # C: a block's shared memory, 9 blocks to an SM
_SMEM_MOST = 227 * 1024  # what a block may have on Hopper


class S2dPlan(NamedTuple):
    """Kernel C's launch plan for one image row pair: a block takes
    ``pairs`` pixel pairs (``blocks`` blocks across W/2), reads its two
    source runs as ``in_word``-byte words and writes its output run as
    ``out_word``-byte words; its shared memory holds the source runs in
    ``in_span`` bytes, then the output run, ``smem`` bytes in all."""
    pairs: int
    blocks: int
    in_word: int
    out_word: int
    in_span: int
    smem: int


def _widest_word(nbytes: list, least: int) -> int:
    """The widest word of at most 16 bytes that divides every count."""
    word = 16
    while word > least and any(b % word for b in nbytes):
        word //= 2
    return word


@functools.lru_cache(maxsize=None)
def s2d_plan(w: int, c: int, in_size: int, out_size: int, in_address: int = 0,
             out_address: int = 0) -> S2dPlan:
    """Kernel C's plan for rows of W pixels of C channels, element sizes
    ``in_size`` and ``out_size``, at addresses taken mod 16 (16 bytes is the
    widest word): the whole row pair in one block where its
    shared memory stays under _SMEM_TARGET, else runs of a multiple of 8
    pixel pairs; words as wide as every run's start and length allow."""
    wq = w // 2
    most = max(1, _SMEM_TARGET // (4 * c * (in_size + out_size)))
    pairs = wq if wq <= most else (most - most % 8 if most >= 8 else most)
    blocks = -(-wq // pairs)
    last = wq - (blocks - 1) * pairs
    in_word = _widest_word([in_address, w * c * in_size, pairs * 2 * c * in_size,
                            last * 2 * c * in_size], in_size)
    out_word = _widest_word([out_address, 2 * w * c * out_size, pairs * 4 * c * out_size,
                             last * 4 * c * out_size], out_size)
    in_span = -(-(pairs * 4 * c * in_size) // 16) * 16
    return S2dPlan(pairs, blocks, in_word, out_word, in_span, in_span + pairs * 4 * c * out_size)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/2,W/2,4C), phase-major channels; contiguous."""
    n, h, w, c = x.shape
    t = x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n, h // 2, w // 2, 4 * c)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`: (N,Hp,Wp,4C) -> (N,2Hp,2Wp,C)."""
    n, hp, wp, c4 = x.shape
    t = x.reshape(n, hp, wp, 2, 2, c4 // 4).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(n, 2 * hp, 2 * wp, c4 // 4)


def plain_s2d_convert(x: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return space_to_depth(x).to(out_dtype)


def plain_residual_tail_d2s(res: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    out = torch.clamp(res.float() + xp.float(), -1.0, 1.0).to(res.dtype)
    return depth_to_space(out)


def s2d_convert(x: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x (N, H, W, C) contiguous float32 or bfloat16, H and W even ->
    space_to_depth(x) in ``out_dtype`` (float32 or bfloat16)."""
    _build.check_nhwc(x, "s2d_convert")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"s2d_convert: out_dtype {out_dtype} is not float32 or bfloat16")
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"s2d_convert: H and W must be even, got {h}x{w}")
    if x.device.type == "cpu":
        return plain_s2d_convert(x, out_dtype)
    if x.numel() >= _INDEX_LIMIT:
        raise ValueError(f"s2d_convert: shape {tuple(x.shape)} has 2^31 elements or more")
    lib = _build.load()
    with torch.cuda.device(x.device):
        out = torch.empty((n, h // 2, w // 2, 4 * c), dtype=out_dtype, device=x.device)
        p = s2d_plan(w, c, x.element_size(), out.element_size(), x.data_ptr() % 16,
                     out.data_ptr() % 16)
        if p.smem > _SMEM_MOST or p.blocks > 65535:
            raise ValueError(f"s2d_convert: shape {tuple(x.shape)} needs {p.smem} B of shared "
                             f"memory in {p.blocks} blocks a row pair")
        err = lib.uegan_s2d_convert(
            x.data_ptr(), out.data_ptr(), _build.dtype_code(x), _build.dtype_code(out),
            n, h, w, c, p.pairs, p.in_word, p.out_word, p.in_span, p.smem,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "s2d_convert")
    s2d_convert.launches += 1
    return out


def residual_tail_d2s(res: torch.Tensor, xp: torch.Tensor) -> torch.Tensor:
    """res, xp (N, Hp, Wp, 4C) contiguous, one dtype (float32 or bfloat16) ->
    depth_to_space(clip(res + xp, -1, 1)) (N, 2Hp, 2Wp, C) in that dtype; the
    add and clip run in f32, and NaN passes through as torch.clamp lets it."""
    _build.check_nhwc(res, "residual_tail_d2s")
    _build.check_nhwc(xp, "residual_tail_d2s")
    if res.shape != xp.shape or res.dtype != xp.dtype or res.device != xp.device:
        raise ValueError(f"residual_tail_d2s: res {tuple(res.shape)} {res.dtype} {res.device} "
                         f"and xp {tuple(xp.shape)} {xp.dtype} {xp.device} differ")
    n, hp, wp, c4 = res.shape
    if c4 % 4:
        raise ValueError(f"residual_tail_d2s: packed channels {c4} are not a multiple of 4")
    if res.device.type == "cpu":
        return plain_residual_tail_d2s(res, xp)
    if res.numel() >= _INDEX_LIMIT:
        raise ValueError(f"residual_tail_d2s: shape {tuple(res.shape)} has 2^31 elements or more")
    lib = _build.load()
    with torch.cuda.device(res.device):
        out = torch.empty((n, 2 * hp, 2 * wp, c4 // 4), dtype=res.dtype, device=res.device)
        err = lib.uegan_residual_tail_d2s(
            res.data_ptr(), xp.data_ptr(), out.data_ptr(), _build.dtype_code(res),
            n, hp, wp, c4 // 4, torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "residual_tail_d2s")
    residual_tail_d2s.launches += 1
    return out


s2d_convert.launches = 0
residual_tail_d2s.launches = 0
