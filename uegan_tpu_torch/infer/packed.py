"""Space-to-depth packed inference, the inference subset of uegan_tpu/infer/packed.py.

The generator's full-resolution tensors (the 512 px ones: enc1's output, the
ga1/up4/dec4 stage and the dec5 head) run packed: each 2x2 block of pixels
becomes one pixel with 4x the channels, ``(N,H,W,C) -> (N,H/2,W/2,4C)``,
channel ``(pi*2 + pj)*C + c``.  A conv on the original tensor becomes a conv
on the packed tensor with a packed kernel:

    conv_packed(s2d(pad_reflect(x)), K_p) == s2d(conv(pad_reflect(x), k))

with packed window S = S0 + S1 + 1, where the packed tap s and input phase pi
for original tap u and output phase d solve 2s + pi = d + u - P.  A stride-2
conv on a packed input emits an ordinary half-res output with a 2x2 packed
kernel.  Reflect padding in the packed domain mixes the two phases of
neighbouring packed rows (:func:`packed_reflect_pad`).  The interior (<= half
res) runs the canonical modules of the Generator on its own weights.

The entry (float image -> packed compute dtype) is kernel C and the exit
(residual add, clip, unpack) is kernel D, ops/s2d_fuse.py; the interior
upsamples are kernel B.  The kernel transforms are numpy, applied once to the
LOADED weights (:func:`make_fast_eval` runs after the checkpoint load).

Packed tensors are NHWC here, as in the JAX package; a conv takes the NCHW
view of one in ``torch.channels_last`` memory, which costs no copy.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.models.blocks import to_nchw, to_nhwc
from uegan_tpu_torch.models.generator import Generator, check_input_hw
from uegan_tpu_torch.models.initializers import init_weights
from uegan_tpu_torch.ops.conv_int8 import conv2d_int8
from uegan_tpu_torch.ops.gam_norm import gam_norm
from uegan_tpu_torch.ops.resize2x import upsample2x
from uegan_tpu_torch.ops.s2d_fuse import (depth_to_space, residual_tail_d2s, s2d_convert,
                                          space_to_depth)
from uegan_tpu_torch.utils.cache import tensor_cache
from uegan_tpu_torch.utils.checkpoint import uses_spectral_norm
from uegan_tpu_torch.utils.device import compute_dtype
from uegan_tpu_torch.utils.seed import setup_seed

__all__ = ["space_to_depth", "depth_to_space", "pack_generator_params", "make_packed_eval",
           "served_generator", "make_eval_step", "make_fast_eval"]

Channels = Union[int, Sequence[int]]


# ---------------------------------------------------------------------------
# kernel transforms (numpy HWIO, applied once to the loaded weights)
# ---------------------------------------------------------------------------
def _tap_ranges(k: int, pad: int) -> Tuple[int, int]:
    """Packed tap range [s_min, s_max] for original kernel size k, pad P."""
    vals = [d + u - pad for d in (0, 1) for u in range(k)]
    ss = [(v - (v & 1)) // 2 for v in vals]
    return min(ss), max(ss)


def pack_kernel_s1(kernel: np.ndarray, pad: int) -> Tuple[np.ndarray, int]:
    """Stride-1 conv kernel (K,K,Cin,Cout) -> packed kernel, plus S0.

    Packed conv: VALID over input packed-padded by S0 (lead) / S1 (trail);
    output is packed (4*Cout) phase-major.
    """
    kk, _, cin, cout = kernel.shape
    s_min, s_max = _tap_ranges(kk, pad)
    S = s_max - s_min + 1
    out = np.zeros((S, S, 4 * cin, 4 * cout), kernel.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            for u in range(kk):
                for v in range(kk):
                    ri = di + u - pad
                    rj = dj + v - pad
                    pi, pj = ri & 1, rj & 1
                    si = (ri - pi) // 2 - s_min
                    sj = (rj - pj) // 2 - s_min
                    pin = pi * 2 + pj
                    pout = di * 2 + dj
                    out[si, sj, pin * cin:(pin + 1) * cin, pout * cout:(pout + 1) * cout] += kernel[u, v]
    return out, -s_min


def pack_kernel_s2(kernel: np.ndarray, pad: int) -> Tuple[np.ndarray, int]:
    """Stride-2 conv kernel -> packed kernel consuming packed input, emitting
    ordinary (unpacked) half-res output.  out[i,j] = sum_u k[u] x[2i+u-P]."""
    kk, _, cin, cout = kernel.shape
    vals = [u - pad for u in range(kk)]
    ss = [(v - (v & 1)) // 2 for v in vals]
    s_min, s_max = min(ss), max(ss)
    S = s_max - s_min + 1
    out = np.zeros((S, S, 4 * cin, cout), kernel.dtype)
    for u in range(kk):
        for v in range(kk):
            ri, rj = u - pad, v - pad
            pi, pj = ri & 1, rj & 1
            si = (ri - pi) // 2 - s_min
            sj = (rj - pj) // 2 - s_min
            pin = pi * 2 + pj
            out[si, sj, pin * cin:(pin + 1) * cin, :] += kernel[u, v]
    return out, -s_min


def pack_kernel_1x1(kernel: np.ndarray) -> np.ndarray:
    """1x1 conv (1,1,Cin,Cout) -> block-diagonal packed (1,1,4Cin,4Cout)."""
    _, _, cin, cout = kernel.shape
    out = np.zeros((1, 1, 4 * cin, 4 * cout), kernel.dtype)
    for p in range(4):
        out[0, 0, p * cin:(p + 1) * cin, p * cout:(p + 1) * cout] = kernel[0, 0]
    return out


def _interleave_perm(parts: Tuple[int, ...]) -> np.ndarray:
    """Permutation mapping kernel-input-row index -> packed-tensor channel.

    The kernel's input order is [p, (part, c)]; the packed concat lays the
    channels out as [(part, p, c)].
    """
    perm = []
    offsets = np.cumsum([0] + list(parts[:-1]))
    for p in range(4):
        for part, cp in enumerate(parts):
            base = offsets[part] * 4 + p * cp
            perm.extend(range(base, base + cp))
    return np.asarray(perm)


def interleave_input_channels(packed_kernel: np.ndarray, parts: List[int]) -> np.ndarray:
    """Reorder a packed kernel's input channels from phase-major-per-part
    concat order to concat-per-phase order.

    A packed concat of tensors A (4*Ca) and B (4*Cb) lays channels as
    [A_p0..A_p3, B_p0..B_p3], but the packed kernel built from the canonical
    concat [A|B] expects [p0:(A|B), p1:(A|B), ...].  Folding the permutation
    into the kernel keeps the concat free.
    """
    total = sum(parts)
    inv = _interleave_perm(tuple(parts))
    out = np.zeros_like(packed_kernel)
    out[:, :, inv, :] = packed_kernel[:, :, np.arange(4 * total), :]
    return out


def compose_dec5_kernels(
    k0: np.ndarray, b0: np.ndarray, k1: np.ndarray, b1: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Fold dec5_0 (3x3 C->C) and dec5_1 (7x7 C->3) into ONE 9x9 C->3 conv.

    The output head has no activation between its two convs (reference:
    models.py:32-36), so they compose linearly: K[u,v,c,o] =
    sum_{a+p=u, b+q=v} k0[a,b,c,m] k1[p,q,m,o] with pad 4, and
    b = b1 + sum_{pqm} k1[p,q,m,o] b0[m].  Composition holds in the interior
    only: the sequential head reflect-pads the intermediate, not the input,
    so :func:`packed_dec5_head` overwrites the border band with the exact
    sequential values.
    """
    K0 = k0.shape[0]
    K1 = k1.shape[0]
    c, o = k0.shape[2], k1.shape[3]
    out = np.zeros((K0 + K1 - 1, K0 + K1 - 1, c, o), np.float32)
    for a in range(K0):
        for b in range(K0):
            out[a:a + K1, b:b + K1] += np.einsum(
                "cm,pqmo->pqco", k0[a, b].astype(np.float64), k1.astype(np.float64)
            ).astype(np.float32)
    bias = b1.astype(np.float32) + np.einsum(
        "pqmo,m->o", k1.astype(np.float64), b0.astype(np.float64)
    ).astype(np.float32)
    return out, bias


def compose_dec5_deep_kernel(pk9: np.ndarray) -> np.ndarray:
    """The packed composed head (S,S,4C,12) stride 1 as a STRIDE-2 conv
    (S+1,S+1,4C,48) emitting the twice-packed output (one deep pixel = 2x2
    packed pixels): deep output (i,j,P=(di,dj),oc) = packed_out[2i+di,
    2j+dj, oc] = sum_{si,sj} pk9[si,sj,:,oc] . zpad[2i+di+si, 2j+dj+sj], so
    K6[di+si, dj+sj, :, P*12+oc] += pk9[si,sj,:,oc].  Output channels are
    [P, p, rgb], so one :func:`depth_to_space` gives the packed head output.
    """
    S, _, cin4, cout = pk9.shape
    k6 = np.zeros((S + 1, S + 1, cin4, 4 * cout), pk9.dtype)
    for di in (0, 1):
        for dj in (0, 1):
            P = di * 2 + dj
            k6[di:di + S, dj:dj + S, :, P * cout:(P + 1) * cout] += pk9
    return k6


# (kernel size, original pad) of each packed layer: the one source for the
# packers and the static lead offsets
_PACK_PADS = {
    "enc1": (7, 3),
    "enc2": (3, 1),  # stride-2 consumer
    "dec4": (3, 1),
    "dec5_0": (3, 1),
    "dec5_1": (7, 3),
}


def packed_s0_statics() -> Dict[str, int]:
    """The lead-pad offset of each packed kernel, from _PACK_PADS."""
    out = {}
    for name, (k, pad) in _PACK_PADS.items():
        if name == "enc2":  # stride-2 consumer: s0 from pack_kernel_s2's taps
            vals = [u - pad for u in range(k)]
            out[f"{name}_s0"] = -min((v - (v & 1)) // 2 for v in vals)
        else:
            out[f"{name}_s0"] = -_tap_ranges(k, pad)[0]
    return out


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def pack_generator_params(state: Dict, conv_dim: int,
                          device: Union[str, torch.device] = "cpu") -> Dict:
    """Pack the full-res kernels of a port Generator's state dict.

    Covers enc1, enc2 (stride-2 consumer), ga1's fuse (its x-part), dec4 and
    the dec5 head (sequential kernels for the border, and for the interior
    the stride-2 deep form of the composed 9x9).  Torch OIHW weights are
    turned into HWIO, packed with the JAX package's numpy algebra (so the
    packed values are the same bits), and handed back as OIHW float32
    tensors on ``device``; the lead offsets ``*_s0`` are ints, ``dec5c_b``
    the composed head's bias.
    """
    cd = conv_dim
    hwio = lambda key: np.ascontiguousarray(np.transpose(_numpy(state[key]), (2, 3, 1, 0)))
    packed: Dict = {}
    packed["enc1_k"], packed["enc1_s0"] = pack_kernel_s1(
        hwio("enc1.main.1.weight"), _PACK_PADS["enc1"][1])
    packed["enc2_k"], packed["enc2_s0"] = pack_kernel_s2(
        hwio("enc2.main.1.weight"), _PACK_PADS["enc2"][1])
    # only the x-part of ga1's fuse kernel: the SE part is dead at inference
    # (gam_norm_eval)
    packed["ga1_fuse_x_k"] = pack_kernel_1x1(hwio("ga1.fuse.0.weight")[:, :, :cd, :])
    dec4_k, packed["dec4_s0"] = pack_kernel_s1(hwio("dec4.main.1.weight"), _PACK_PADS["dec4"][1])
    packed["dec4_k"] = interleave_input_channels(dec4_k, [cd, cd])
    packed["dec5_0_k"], packed["dec5_0_s0"] = pack_kernel_s1(
        hwio("dec5.0.main.1.weight"), _PACK_PADS["dec5_0"][1])
    packed["dec5_1_k"], packed["dec5_1_s0"] = pack_kernel_s1(
        hwio("dec5.1.main.1.weight"), _PACK_PADS["dec5_1"][1])
    k9, b9 = compose_dec5_kernels(
        hwio("dec5.0.main.1.weight"), _numpy(state["dec5.0.main.1.bias"]),
        hwio("dec5.1.main.1.weight"), _numpy(state["dec5.1.main.1.bias"]))
    packed["dec5d_k"] = compose_dec5_deep_kernel(pack_kernel_s1(k9, 4)[0])
    packed["dec5c_b"] = b9
    out: Dict = {}
    for k, v in packed.items():
        if isinstance(v, np.ndarray):
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v
            v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# packed ops (NHWC)
# ---------------------------------------------------------------------------
@tensor_cache(maxsize=64)
def _pad_sources(length: int, pad: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Rows that feed the pad rows of one axis: (phase-0 and phase-1 sources
    of the lead rows, the same of the trail rows), as index tensors.  Like
    every cached tensor here it is made outside inference mode, so that a
    forward with autograd on can use it after one under inference mode, and
    never kept from a trace (utils/cache.py)."""
    lead, trail = range(pad, 0, -1), range(1, pad + 1)
    srcs = ([m for m in lead], [m - 1 for m in lead],
            [length - m for m in trail], [length - m - 1 for m in trail])
    with torch.inference_mode(False):
        return tuple(torch.tensor(s, device=device) for s in srcs)


@tensor_cache(maxsize=64)
def _phase0_channels(parts: Tuple[int, ...], axis: int, device: torch.device) -> torch.Tensor:
    """Bool mask over the packed channels: True where the channel's phase
    along ``axis`` (0: rows, pi; 1: columns, pj) is 0."""
    masks = []
    for cp in parts:
        k = np.arange(4 * cp)
        masks.append((k // (2 * cp) if axis == 0 else (k // cp) % 2) == 0)
    with torch.inference_mode(False):
        return torch.from_numpy(np.concatenate(masks)).to(device)


def packed_reflect_pad(x: torch.Tensor, pad: int, c: Channels) -> torch.Tensor:
    """Reflect-pad with ORIGINAL-domain semantics, done in the packed domain.

    Packed row m holds original rows (2m, 2m+1).  With torch-style reflect
    (no edge repeat: original row -r is row r, row H-1+r is row H-1-r):

    - leading packed pad row -m  = (phase0 <- packed[m].phase0,
                                    phase1 <- packed[m-1].phase1)
    - trailing packed pad row L-1+m = (phase0 <- packed[L-m].phase0,
                                       phase1 <- packed[L-m-1].phase1)

    The same along W with the column phase.  ``pad`` is in packed rows (two
    original rows).  ``c`` is the original channel count, or a list of them
    when ``x`` is a channel concat of separately packed tensors (each part
    keeps its own phase grouping).  Each side of each axis takes two row
    gathers and one select; the concat then sees contiguous parts only.
    """
    if pad == 0:
        return x
    parts = (c,) if isinstance(c, int) else tuple(c)
    for axis, dim in enumerate((1, 2)):
        lead0, lead1, trail0, trail1 = _pad_sources(x.shape[dim], pad, x.device)
        phase0 = _phase0_channels(parts, axis, x.device)
        side = lambda i0, i1: torch.where(phase0, x.index_select(dim, i0),
                                          x.index_select(dim, i1))
        x = torch.cat([side(lead0, lead1), x, side(trail0, trail1)], dim)
    return x


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def _conv(t: torch.Tensor, kp: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype,
          act: Optional[Callable] = None, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """VALID (or zero-padded) conv of an NHWC tensor with an OIHW kernel, in
    ``dtype``; a bias of fewer channels than the output is tiled (per packed
    phase group); ``act`` runs on the conv's output."""
    w = kp.to(dtype)
    b = None
    if bias is not None:
        b = bias.to(dtype)
        if b.shape[0] != w.shape[0]:
            b = b.repeat(w.shape[0] // b.shape[0])
    y = F.conv2d(to_nchw(t.to(dtype)), w, b, stride=stride, padding=padding)
    if act is not None:
        y = act(y)
    return to_nhwc(y)


def packed_conv(xp: torch.Tensor, kp: torch.Tensor, s0: int, c_in: Channels,
                bias: Optional[torch.Tensor] = None, dtype: torch.dtype = torch.bfloat16,
                act: Optional[Callable] = None) -> torch.Tensor:
    """Conv of a packed tensor with a packed kernel, original-reflect padding
    applied in the packed domain: :func:`packed_reflect_pad` by
    p = max(S0, S1) packed rows, cropped to S0 lead and S1 trail rows, then a
    VALID conv.  ``c_in`` is the ORIGINAL channel count (or one per concat
    part); ``bias`` is the original (Cout,) bias, tiled per output phase group
    when the output is packed.  With ``dtype=torch.int8`` xp and kp are int8
    and the result is the exact int32 sum (:func:`conv2d_int8`; no bias or
    act), as the JAX function returns it for int8."""
    if dtype == torch.int8:
        if bias is not None or act is not None:
            raise ValueError("packed_conv: the int8 form returns the int32 sum, "
                             "without bias or act")
        conv = lambda t: conv2d_int8(t, kp)
    else:
        conv = lambda t: _conv(t, kp, bias, dtype, act)
    S = kp.shape[-1]
    s1 = S - 1 - s0
    p = max(s0, s1)
    if p == 0:
        return conv(xp)
    lp, wp = xp.shape[1], xp.shape[2]
    xpad = packed_reflect_pad(xp, p, c_in)
    r0 = p - s0
    return conv(xpad[:, r0:r0 + lp + s0 + s1, r0:r0 + wp + s0 + s1])


def _interp_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Align-corners bilinear row-interpolation matrix (out_size, in_size)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if in_size == 1:
        m[:, 0] = 1.0
        return m.astype(np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    m[np.arange(out_size), lo] += 1.0 - frac
    m[np.arange(out_size), hi] += frac
    return m.astype(np.float32)


@tensor_cache(maxsize=16)
def _phase_matrix(in_size: int, out_size: int, device: torch.device,
                  dtype: torch.dtype) -> torch.Tensor:
    """(2, out/2, in): the interpolation matrix's rows split by output phase,
    on ``device`` in ``dtype``; made once per shape."""
    m = _interp_matrix_np(in_size, out_size).reshape(out_size // 2, 2, in_size)
    with torch.inference_mode(False):
        return torch.from_numpy(np.ascontiguousarray(m.transpose(1, 0, 2))).to(device, dtype)


def packed_resize2x_align_corners(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear align-corners resize of an NHWC tensor to ``out_hw`` (twice
    its size), emitting the PACKED output: output phase (e, f) holds output
    rows 2o+e and columns 2p+f, so the phase-split interpolation matrices
    give all four phases in two products, one per axis, with the phases next
    to the channels.  The matrices are in x's dtype."""
    n, h, w, c = x.shape
    oh, ow = out_hw
    mhp = _phase_matrix(h, oh, x.device, x.dtype)
    mwp = _phase_matrix(w, ow, x.device, x.dtype)
    t = torch.einsum("eoh,nhwc->neowc", mhp, x)
    y = torch.einsum("fpw,neowc->nopefc", mwp, t)
    return y.reshape(n, oh // 2, ow // 2, 4 * c)  # phase-major: (e*2+f)*C + c


def packed_gam_stats(xp: torch.Tensor, c: int,
                     eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAM mean and unbiased std per ORIGINAL channel of a packed tensor,
    each (N, C) float32, eps inside the root."""
    n, hp, wp, _ = xp.shape
    acc = xp.float().reshape(n, hp, wp, 4, c)
    hw = hp * wp * 4
    mean = acc.mean(dim=(1, 2, 3))
    sq = (acc * acc).mean(dim=(1, 2, 3))
    var = (sq - mean * mean) * (hw / max(hw - 1, 1))
    return mean, torch.sqrt(torch.clamp(var, min=0.0) + eps)


def packed_instance_norm(xp: torch.Tensor, c: int, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine instance norm per ORIGINAL channel (biased var) on packed:
    ``gam_norm`` of the (N, H/2, W/2 * 4, C) view, whose pixels are the
    packed pixels' four phases (channels are phase-major), in xp's dtype."""
    n, hp, wp, _ = xp.shape
    return gam_norm(xp.contiguous().view(n, hp, wp * 4, c), eps).view(n, hp, wp, 4 * c)


def gam_x_weight(gam, dtype: torch.dtype) -> torch.Tensor:
    """The x-part of a GAM's fuse kernel, (C, C, 1, 1) in ``dtype``."""
    w = gam.fuse[0].weight.detach()
    return w[:, :w.shape[0]].contiguous().to(dtype)


def gam_norm_eval(x: torch.Tensor, w_x: torch.Tensor) -> torch.Tensor:
    """GAM with norm=True at inference: ``IN(conv1x1(x, W_x))`` exactly.

    The SE branch (global stats -> squeeze -> relu -> excite) and the fuse
    bias enter the 1x1 fuse conv as per-(image, channel) constants, which the
    non-affine instance norm after it removes (reference: models.py:230-237),
    so only the x-part of the fuse kernel (:func:`gam_x_weight`) runs, and
    the norm is ``gam_norm``.  x (N, C, H, W), computed in w_x's dtype."""
    return to_nchw(gam_norm(to_nhwc(F.conv2d(x.to(w_x.dtype), w_x))))


# the head's border band: packed rows overwritten with the sequential values
# (the 3-original-pixel band where composed reflect != sequential reflect,
# which also covers the deep stride-2 conv's zero-pad reach of S0 = 2 packed
# rows), and the slab depth whose fake inner edge stays outside that band
_DEC5_FIX = 2
_DEC5_SLAB = 6


def packed_dec5_head(z: torch.Tensor, k6: torch.Tensor, b9: torch.Tensor,
                     pk0: torch.Tensor, s0_0: int, b0: torch.Tensor,
                     pk1: torch.Tensor, s0_1: int, b1: torch.Tensor, cd: int,
                     dt: torch.dtype, act: Optional[Callable] = None) -> torch.Tensor:
    """The dec5 head on the packed modulated tensor z = y4p * x1p: the
    interior from the composed 9x9 conv in its stride-2 deep form ``k6``
    (zero-padded by 2, whose zero-pad reach is exactly the band the
    sequential strips overwrite), the border band from the sequential
    two-conv chain on narrow slabs (full-height column slabs and full-width
    row slabs carry real reflect on their outer edges, so the strips, corners
    included, equal the sequential values).  The packed dims must be even
    and wider than a slab, which every input the generator takes gives
    (H and W multiples of 16, at least 32)."""
    r, slab = _DEC5_FIX, _DEC5_SLAB
    lp, wp = z.shape[1], z.shape[2]
    if lp % 2 or wp % 2 or min(lp, wp) <= slab + r:
        raise ValueError(f"packed_dec5_head: packed dims {lp}x{wp} must be even and > {slab + r}")

    def seq(t: torch.Tensor) -> torch.Tensor:
        h = packed_conv(t, pk0, s0_0, cd, b0, dt)
        return packed_conv(h, pk1, s0_1, cd, b1, dt, act=act)

    y = depth_to_space(_conv(z, k6, b9, dt, act, stride=2, padding=2))  # (N, lp, wp, 12)
    # full-height W strips first (exact incl. corners), then full-width H
    # strips (also exact incl. corners: the same values where they overlap)
    y[:, :, :r] = seq(z[:, :, :slab])[:, :, :r]
    y[:, :, wp - r:] = seq(z[:, :, wp - slab:])[:, :, slab - r:]
    y[:, :r] = seq(z[:, :slab])[:, :r]
    y[:, lp - r:] = seq(z[:, lp - slab:])[:, slab - r:]
    return y


# ---------------------------------------------------------------------------
# the packed generator forward
# ---------------------------------------------------------------------------
def _off_default(g: Generator) -> List[str]:
    """The flags that take ``g`` off the default generator config (no norm,
    LeakyReLU, no SN), which packing needs."""
    return [flag for hit, flag in ((g.use_sn, "--g_use_sn true"),
                                   (g.norm_fun != "none", f"--g_norm_fun {g.norm_fun}"),
                                   (g.act_fun != "LeakyReLU", f"--g_act_fun {g.act_fun}"))
            if hit]


def is_default_generator(g: Generator) -> bool:
    return not _off_default(g)


def check_default_generator(g: Generator, what: str) -> None:
    """Raise ``ValueError`` naming each flag that takes ``g`` off the
    packed, int8 and strip forwards, where JAX asserts the same gate
    (uegan_tpu/infer/strips.py:437, uegan_tpu/infer/quantized.py:431);
    ``make_fast_eval`` routes such a generator to the canonical forward."""
    flags = _off_default(g)
    if flags:
        raise ValueError(f"{what} supports the default generator config only, not "
                         f"{', '.join(flags)}: make_fast_eval runs the canonical forward there")


def make_packed_eval(g: Generator, packed: Dict) -> Callable[[torch.Tensor], torch.Tensor]:
    """Packed forward ``fn(x)``: x (N, H, W, 3) float in [-1, 1] -> enhanced
    (N, H, W, 3) in G's dtype.  ``packed`` comes from
    :func:`pack_generator_params` on G's current weights; the interior reads
    G's modules.  Runs kernels C (entry), B (up1..up3) and D (exit) on a card.
    """
    check_default_generator(g, "packed inference")
    cd, dt = g.conv_dim, g.dtype
    s0 = packed_s0_statics()
    # the packed kernels and the full-res biases in the compute dtype once,
    # the biases of packed outputs tiled per phase group: no per-call casts
    pk = {k: v.to(dt) if torch.is_tensor(v) else v for k, v in packed.items()}
    tiled = lambda block, n: block.main[1].bias.detach().to(dt).repeat(n)
    b_enc1, b_enc2, b_dec4 = tiled(g.enc1, 4), tiled(g.enc2, 1), tiled(g.dec4, 4)
    b_dec5_0, b_dec5_1 = tiled(g.dec5[0], 4), tiled(g.dec5[1], 4)
    up4 = g.upsample4[1].main[1]
    w_up4, b_up4 = up4.weight.detach().to(dt), up4.bias.detach().to(dt)
    w_ga = {i: gam_x_weight(getattr(g, f"ga{i}"), dt) for i in (2, 3, 4, 5)}

    def up_stage(i: int, t: torch.Tensor) -> torch.Tensor:
        return getattr(g, f"upsample{i}")[1](to_nchw(upsample2x(to_nhwc(t))))

    def fn(x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        check_input_hw(h, w)
        xp = s2d_convert(x.contiguous(), dt)  # (N, H/2, W/2, 12)
        x1p = packed_conv(xp, pk["enc1_k"], s0["enc1_s0"], 3, b_enc1, dt, act=leaky)
        x2 = to_nchw(packed_conv(x1p, pk["enc2_k"], s0["enc2_s0"], cd, b_enc2, dt,
                                 act=leaky))
        # interior at <= half res: the canonical modules, dead-SE GAMs
        x3 = g.enc3(x2)
        x4 = g.enc4(x3)
        x5 = gam_norm_eval(g.enc5(x4), w_ga[5])
        # dec1 .. dec3 read the concat of two parts, which their pad writes
        y1 = g.dec1((up_stage(1, x5), gam_norm_eval(x4, w_ga[4])))
        y2 = g.dec2((up_stage(2, y1), gam_norm_eval(x3, w_ga[3])))
        y3 = g.dec3((up_stage(3, y2), gam_norm_eval(x2, w_ga[2])))
        # ga1 on the packed x1: block-diagonal x-part of the fuse, then IN
        ga1p = packed_instance_norm(_conv(x1p, pk["ga1_fuse_x_k"], None, dt), cd)
        # up4: the 1x1 conv first (2cd -> cd at half res), then the packed resize
        z4 = to_nhwc(F.conv2d(y3, w_up4, b_up4))
        u4 = packed_resize2x_align_corners(z4, (h, w))
        y4p = packed_conv(torch.cat([u4, ga1p], dim=-1), pk["dec4_k"], s0["dec4_s0"],
                          [cd, cd], b_dec4, dt, act=leaky)
        res = packed_dec5_head(
            y4p * x1p, pk["dec5d_k"], pk["dec5c_b"],
            pk["dec5_0_k"], s0["dec5_0_s0"], b_dec5_0,
            pk["dec5_1_k"], s0["dec5_1_s0"], b_dec5_1, cd, dt, act=torch.tanh)
        return residual_tail_d2s(res, xp)  # clip(res + x, -1, 1), unpacked

    return fn


def served_generator(config, state: Optional[Dict[str, torch.Tensor]],
                     device) -> Generator:
    """The generator that the Tester, the service and the exporter serve:
    ``config``'s G in its compute dtype, with spectral norm under
    ``--g_use_sn`` or where ``state`` (a ``G_net`` state dict) keeps
    ``weight_orig``; its weights are ``state``, or the Tester's seeded init
    when ``state`` is None.  On ``device``, in the mode a new module has."""
    g = Generator(conv_dim=config.g_conv_dim, norm_fun=config.g_norm_fun,
                  act_fun=config.g_act_fun,
                  use_sn=config.g_use_sn or (state is not None and uses_spectral_norm(state)),
                  dtype=compute_dtype(config.compute_dtype))
    if state is None:
        init_weights(g, config.init_type, 0.02, setup_seed(config.seed))
    else:
        g.load_state_dict(state)
    return g.to(device)


def make_eval_step(g: Generator) -> Callable[[torch.Tensor], torch.Tensor]:
    """Inference forward: G in eval mode (running statistics), no autograd.
    (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) in G's dtype."""
    g.eval()

    def eval_step(img_raw: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return g(img_raw)

    return eval_step


def make_fast_eval(g: Generator, config,
                   calib_batch: Optional[torch.Tensor] = None) -> Callable[[torch.Tensor],
                                                                           torch.Tensor]:
    """The inference forward for ``config``: packed when
    ``config.packed_inference`` is set and G has the default config, else
    the canonical eval step; the same routing as the JAX package, by the
    model's semantics, not by device.  Under ``--quantized_inference int8``
    or ``int8_pallas`` the packed route is the int8 forward
    (``infer/quantized.py:make_int8_eval``), its activation scales
    calibrated on ``calib_batch`` (in [-1, 1]; a seeded random batch when
    None).  Call it after the weights are loaded: the packed (and quantized)
    kernels are made from G's weights at this call.

    On the packed route an input takes the exact strip executor
    (infer/strips.py) where its strip height r passes JAX's gate: r is
    ``--strip_rows`` when > 0, else ``pick_strip_rows`` of the input's
    packed height (0 below 1024 packed rows), and the strips run when r is
    even, > 2 * _M_EXIT, divides the packed height and leaves two strips or
    more; ``--strip_rows -1`` never strips.  The strips chunk their exit by
    ``--strip_chunks`` and recompute their entry per chunk past 4096 packed
    rows.  The int8 routes take the int8 strip executor, which runs no
    kernel E, as in JAX.

    Returns ``fn(x)``: (N, H, W, 3) in [-1, 1] -> (N, H, W, 3), in G's dtype
    (bfloat16 on the int8 route).
    """
    if not (config.packed_inference and is_default_generator(g)):
        return make_eval_step(g)
    from uegan_tpu_torch.infer import strips

    g.eval()
    if config.quantized_inference:
        from uegan_tpu_torch.infer.quantized import build_quant_tables, make_int8_eval

        tabs = build_quant_tables(g, calib_batch)
        fn = make_int8_eval(g, tabs, use_pallas=config.quantized_inference == "int8_pallas")
        make_strips = functools.partial(strips.make_int8_strip_eval, g, tabs)
    else:
        packed = pack_generator_params(g.state_dict(), g.conv_dim,
                                       device=g.enc1.main[1].weight.device)
        fn = make_packed_eval(g, packed)
        make_strips = functools.partial(strips.make_strip_eval, g, packed)
    strip_fns: Dict[Tuple[int, bool], Callable] = {}

    def packed_step(img_raw: torch.Tensor) -> torch.Tensor:
        n, hp = img_raw.shape[0], img_raw.shape[1] // 2
        if config.strip_rows >= 0:
            r = config.strip_rows or strips.pick_strip_rows(hp, n)
            if r and hp % r == 0 and hp >= 2 * r and r % 2 == 0 and r > 2 * strips._M_EXIT:
                key = (r, hp > 4096)
                if key not in strip_fns:
                    strip_fns[key] = make_strips(r, config.strip_chunks, entry_chunked=key[1])
                return strip_fns[key](img_raw)
        with torch.inference_mode():
            return fn(img_raw)

    return packed_step
