"""Exact H-strip execution of the packed forward, counterpart of
uegan_tpu/infer/strips.py.

Every full-height stage runs on a batch of overlapping row strips ("slabs"):
nothing at full height is materialized but the packed input and the output.
The JAX package built it for a TPU layout problem (XLA space-blocks maps of
about 1024 rows, and the layout copies then took 80% of the device time at
2048 px); here it is the high-resolution path of ``make_fast_eval`` as in
JAX, and bounds the live set of the full-resolution stages by the strips
(and, with a chunked exit, by one chunk of them).

Slabs carry a reflect-extended halo: the entry chain (enc1, enc2, enc3) has
``_M_ENTRY`` rows each side, wide enough that the exit chain's slabs (halo
``_M_EXIT``) are plain slices of the entry outputs.  Each conv contaminates
at most its own reach at the slab edges (the slab convs pad H with zeros and
W by the packed reflect: :func:`slab_conv`); the margins cover the
cumulative reach and are discarded.  At the image borders (a first or last
strip) the canonical model reflect-pads each layer's own input, which does
not commute with a conv, so after every conv the border slabs' halo rows
are rebuilt as the reflect of their real rows (:func:`refix_halos`), and the
up3/up4 resize matrices emit reflect-indexed halo rows.  Pointwise stages
(the GAM 1x1s, the instance norms' application, leaky, the residual)
commute and need nothing.  The result equals the direct packed forward,
border rows included, to float rounding.

Global-extent ops stay exact: the ga1/ga2 instance-norm moments are reduced
over the strips' interior rows (each pixel once), the middle (maps of at
most Hp/2 rows) runs directly on the canonical modules, and the up3/up4 x2
resizes cross strip boundaries through per-strip slices of the global
align-corners matrices.

On a card the entry's float -> packed conversion is kernel C, the middle's
up1/up2 resizes kernel B and the exit's residual add, clip and unpack kernel
D, which reads each slab's window of kept rows in place.  A CPU tensor takes
their plain versions.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.infer.packed import (_DEC5_FIX, _DEC5_SLAB, _conv, _interp_matrix_np,
                                          _pad_sources, _phase0_channels, depth_to_space,
                                          check_default_generator, gam_norm_eval, gam_x_weight,
                                          leaky, pack_generator_params, packed_s0_statics)
from uegan_tpu_torch.models.blocks import to_nchw, to_nhwc
from uegan_tpu_torch.models.generator import Generator, check_input_hw
from uegan_tpu_torch.ops.conv_int8 import conv2d_int8
from uegan_tpu_torch.ops.resize2x import upsample2x
from uegan_tpu_torch.ops.s2d_fuse import residual_tail_d2s, s2d_convert
from uegan_tpu_torch.utils.cache import tensor_cache

Channels = Union[None, int, Sequence[int]]
BF16 = torch.bfloat16

# Entry halo (packed rows): enc1 (packed reach 2) and enc2 (reach 1) leave at
# least 7 valid halo rows on x1/x2, so the exit chain's halo-6 slabs are
# slices of the entry slabs.  Even, so that enc3's stride-2 grid stays aligned.
_M_ENTRY = 10
# Exit halo: dec3 (1) + up4 resize (1) + dec4 (1) + dec5_0 (1) + dec5_1 (2).
_M_EXIT = 6
# Packed rows or columns from which the unchunked exit unpacks per slab (D on
# each slab's window of kept rows) rather than on the reassembled full-height
# map; the chunked exit always unpacks per slab.  A module attribute, so that
# a test can shrink it to reach the per-slab form on small maps.
_SLAB_UNPACK_MIN = 2048


def pick_strip_rows(hp: int, n: int = 4, target: int = 128) -> int:
    """Packed strip rows for an ``hp``-row packed image of batch n; 0 = don't
    strip (uegan_tpu/infer/strips.py:pick_strip_rows, whose target and batch
    rule were measured on a TPU).  From 1024 packed rows: the even divisor of
    hp nearest ``target`` in log scale (ties to the larger) that leaves room
    for the halos, halved while the batch gives fewer than 8 slabs."""
    if hp < 1024:
        return 0
    r = 0
    for d in range(2 * _M_EXIT + 2, min(hp // 2, 4 * target) + 1, 2):
        if hp % d == 0 and (
                r == 0 or (abs(math.log2(d / target)), -d) < (abs(math.log2(r / target)), -r)):
            r = d
    while r and n * (hp // r) < 8 and r % 4 == 0 and (r // 2) > 2 * _M_EXIT:
        r //= 2
    return r


def pick_strip_chunks(n: int, s: int, hs: int, wp: int) -> int:
    """Strips per exit chunk; ``s`` (every strip in one chunk) = don't chunk
    (uegan_tpu/infer/strips.py:pick_strip_chunks, its anchors measured on a
    16 GB TPU).  Unchunked up to 2 * 16 * 140 * 2048 slab pixels; above it,
    the largest divisor of the strip count whose chunk holds at most
    8 * 140 * 4096 slab pixels, raised until a chunk holds 8 slabs of 512
    columns' worth."""
    fit_sp = 2 * 16 * 140 * 2048
    chunk_sp = 8 * 140 * 4096
    if n * s * hs * wp <= fit_sp:
        return s
    cs = max(1, chunk_sp // (n * hs * wp))
    while s % cs:
        cs -= 1
    min_feed = max(1, (8 * 512) // max(n * wp, 1))
    while cs < min(min_feed, s) and cs < s:
        cs += 1
        while s % cs:
            cs += 1
    return cs


# ---------------------------------------------------------------------------
# rows, slabs and halos (NHWC, dim 1 = rows)
# ---------------------------------------------------------------------------
@tensor_cache(maxsize=64)
def _reflect_rows(length: int, pad: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The rows the torch-reflect pad rows of an unpacked axis copy: (the
    leading pad rows' sources, the trailing ones'), made outside inference
    mode."""
    with torch.inference_mode(False):
        return (torch.arange(pad, 0, -1, device=device),
                torch.arange(length - 2, length - 2 - pad, -1, device=device))


def pad_rows(x: torch.Tensor, pad: int, c: Channels = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(top, bottom): the ``pad`` torch-reflect pad rows above and below x.
    ``c`` None: unpacked rows; else the packed tensor's original channel
    count (or one per concat part), and each pad row mixes the row phases of
    two real rows, as infer/packed.py:packed_reflect_pad builds them."""
    if c is None:
        top, bot = _reflect_rows(x.shape[1], pad, x.device)
        return x.index_select(1, top), x.index_select(1, bot)
    parts = (c,) if isinstance(c, int) else tuple(c)
    lead0, lead1, trail0, trail1 = _pad_sources(x.shape[1], pad, x.device)
    phase0 = _phase0_channels(parts, 0, x.device)
    side = lambda i0, i1: torch.where(phase0, x.index_select(1, i0), x.index_select(1, i1))
    return side(lead0, lead1), side(trail0, trail1)


def refix_halos(t: torch.Tensor, n: int, ids: Sequence[int], s_total: int, m: int,
                c: Channels = None) -> torch.Tensor:
    """Rebuild, in place, the outer ``m`` halo rows of the slabs that are an
    image's first or last strip as the reflect of their real rows.  t holds
    ``n`` images' slabs for the strips ``ids`` (consecutive, image-major:
    ``(n * len(ids), rows, W, C)``, contiguous); ``c`` as in
    :func:`pad_rows`.  Interior slab edges are real rows and stay."""
    hs = t.shape[1]
    tr = t.view(n, len(ids), *t.shape[1:])
    if ids[0] == 0:
        tr[:, 0, :m] = pad_rows(tr[:, 0, m:], m, c)[0]
    if ids[-1] == s_total - 1:
        tr[:, -1, hs - m:] = pad_rows(tr[:, -1, :hs - m], m, c)[1]
    return t


def extend_rows(x: torch.Tensor, m: int, c: Channels = None) -> torch.Tensor:
    """(N, Hp, W, C) -> (N, Hp + 2m, W, C): the map with its reflect pad rows."""
    top, bot = pad_rows(x, m, c)
    return torch.cat([top, x, bot], dim=1)


def slabs_chunk(xe: torch.Tensor, c0: int, cs: int, r: int, m: int) -> torch.Tensor:
    """The slabs of strips c0 .. c0 + cs - 1 from a row-extended map
    (:func:`extend_rows`): strip i spans its rows [i r, i r + r + 2m), so
    ``(N * cs, r + 2m, W, C)``, image-major."""
    n, _, w, c = xe.shape
    st = xe.stride()
    win = xe.as_strided((n, cs, r + 2 * m, w, c), (st[0], r * st[1], st[1], st[2], st[3]),
                        xe.storage_offset() + c0 * r * st[1])
    return win.reshape(n * cs, r + 2 * m, w, c)


def slabs(x: torch.Tensor, s: int, r: int, m: int, c: Channels = None) -> torch.Tensor:
    """(N, s r, W, C) -> overlapping slabs (N s, r + 2m, W, C), image-major;
    the first and last strips' halos are reflect rows."""
    return slabs_chunk(extend_rows(x, m, c), 0, s, r, m)


def unslab(y: torch.Tensor, n: int) -> torch.Tensor:
    """(N s, R, W, C) -> (N, s R, W, C)."""
    ns, rr, w, c = y.shape
    return y.reshape(n, ns // n * rr, w, c)


def slab_conv(parts, kp: torch.Tensor, s0: int, c_in, bias: Optional[torch.Tensor] = None,
              dtype: torch.dtype = BF16, act: Optional[Callable] = None) -> torch.Tensor:
    """The packed conv of a slab batch (infer/packed.py:packed_conv with
    JAX's ``h_fixups=False``): W keeps its packed reflect border, and H is
    zero-padded, since a slab's H edges are margin that the halos discard.
    ``parts`` is a tensor or a list of tensors concatenated along the
    channels, with ``c_in`` one original channel count a part; they are
    copied once, into the padded buffer the conv reads.  With
    ``dtype=torch.int8`` the parts are int8 and the result the exact int32
    sums (no bias or act)."""
    parts = [parts] if torch.is_tensor(parts) else list(parts)
    c_in = [c_in] if isinstance(c_in, int) else list(c_in)
    S = kp.shape[-1]
    s1 = S - 1 - s0
    ns, lp, wp = parts[0].shape[:3]
    ctot = sum(t.shape[-1] for t in parts)
    buf = parts[0].new_empty((ns, lp + s0 + s1, wp + s0 + s1, ctot), dtype=dtype)
    buf[:, :s0].zero_()
    buf[:, s0 + lp:].zero_()
    off = 0
    for t in parts:
        buf[:, s0:s0 + lp, s0:s0 + wp, off:off + t.shape[-1]] = t
        off += t.shape[-1]
    if s0 or s1:
        inner = buf[:, s0:s0 + lp]
        lead0, lead1, trail0, trail1 = (i + s0 for i in _pad_sources(wp, max(s0, s1), buf.device))
        phase0 = _phase0_channels(tuple(c_in), 1, buf.device)
        side = lambda i0, i1: torch.where(phase0, inner.index_select(2, i0),
                                          inner.index_select(2, i1))
        if s0:
            inner[:, :, :s0] = side(lead0[len(lead0) - s0:], lead1[len(lead1) - s0:])
        if s1:
            inner[:, :, s0 + wp:] = side(trail0[:s1], trail1[:s1])
    if dtype == torch.int8:
        return conv2d_int8(buf, kp)
    return _conv(buf, kp, bias, dtype, act)


def slab_block(block, x: torch.Tensor) -> torch.Tensor:
    """A canonical 3x3 ConvBlock (conv + bias + leaky) on a slab batch x
    (NHWC): W reflect-padded as the block pads it, H zero-padded (slab
    margin).  Returns NHWC."""
    conv = block.main[1]
    pad = 1
    xw = F.pad(x.unsqueeze(1), (0, 0, pad, pad, 0, 0), mode="reflect").squeeze(1)
    dt = block.dtype
    y = F.conv2d(to_nchw(xw.to(dt)), conv.weight.to(dt), conv.bias.to(dt),
                 stride=block.stride, padding=(pad, 0))
    return to_nhwc(block.act(y))


# ---------------------------------------------------------------------------
# per-strip resize matrices (numpy, as the JAX package builds them)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def _strip_resize_matrices(hp: int, s: int, r: int, m: int) -> np.ndarray:
    """(s, 2, R + 2M, R + 2M): per-strip slices of the phase-split x2
    align-corners H matrix of up4 (rows in packed rows; phase e).  Slab row j
    is global row sR - M + j; entries whose source row falls outside the
    slab are zero (margin rows only).  Border-slab halo rows (outside
    [0, hp)) are the original-domain torch reflect of the resize output, per
    packed phase, so up4's halo rows are dec4's canonical reflect pad."""
    mh = _interp_matrix_np(hp, 2 * hp)  # (2hp, hp)
    mhp = mh.reshape(hp, 2, hp).transpose(1, 0, 2)  # (2, hp, hp)
    hs = r + 2 * m
    out = np.zeros((s, 2, hs, hs), np.float32)
    for i in range(s):
        base = i * r - m
        lo, hi = max(base, 0), min(base + hs, hp)
        for j in range(hs):
            g = base + j
            for e in (0, 1):
                if g < 0:
                    o = -g - e  # leading packed reflect, per phase
                elif g >= hp:
                    o = 2 * hp - 1 - g - e  # trailing packed reflect
                else:
                    o = g
                o = min(max(o, 0), hp - 1)
                out[i, e, j, lo - base:hi - base] = mhp[e, o, lo:hi]
    return out


@functools.lru_cache(maxsize=16)
def _strip_up3_matrices(hp: int, s: int, r: int, m: int):
    """Banded per-strip H matrices of up3 (hp/2 -> hp rows): (mats (s,
    R + 2M, win), the window starts, win).  Border-slab halo rows are the
    torch reflect of the resize output; each strip reads only a band of
    ``win`` source rows, so the matrices keep just that window (the columns
    dropped are zero)."""
    h2 = hp // 2
    mh = _interp_matrix_np(h2, hp)  # (hp, h2)
    hs = r + 2 * m

    def refl(a):
        a = np.abs(a)  # leading reflect: row -t -> t
        a = np.where(a >= hp, 2 * (hp - 1) - a, a)  # trailing reflect
        return np.clip(a, 0, hp - 1)

    rows = [refl(np.arange(i * r - m, i * r - m + hs)) for i in range(s)]
    bands = []
    for i in range(s):
        nz = np.nonzero(mh[rows[i]].any(axis=0))[0]
        bands.append((int(nz[0]), int(nz[-1])))
    win = min(max(b - a + 1 for a, b in bands), h2)
    starts = tuple(min(a, h2 - win) for a, _ in bands)
    mats = np.stack([mh[rows[i], starts[i]:starts[i] + win] for i in range(s)])
    return mats.astype(np.float32), starts, win


@tensor_cache(maxsize=16)
def _strip_constants(hp: int, s: int, r: int, m: int, device: torch.device,
                     dtype: torch.dtype) -> Dict:
    """The H resize matrices of one input shape's strips, on ``device`` in
    ``dtype``, made once per shape and outside inference mode: ``m3`` (s,
    R + 2M, win) and ``starts3``, up3's banded matrices, and ``m4`` (s,
    2 (R + 2M), R + 2M), up4's, rows (phase, row)."""
    mats3, starts3, win3 = _strip_up3_matrices(hp, s, r, m)
    m4 = _strip_resize_matrices(hp, s, r, m).reshape(s, 2 * (r + 2 * m), r + 2 * m)
    on = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)
    with torch.inference_mode(False):
        return {"m3": on(mats3), "starts3": starts3, "win3": win3, "m4": on(m4)}


@tensor_cache(maxsize=32)
def _col_taps(w: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """The x2 align-corners resize of w columns as two taps an output column
    (the rows of infer/packed.py:_interp_matrix_np): (lo, hi, weight of lo,
    weight of hi), the weights in f32, made outside inference mode."""
    src = np.arange(2 * w, dtype=np.float64) * (w - 1) / max(2 * w - 1, 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, w - 1)
    frac = src - lo
    with torch.inference_mode(False):
        t = lambda a, dt: torch.from_numpy(a).to(device, dt)
        return (t(lo, torch.int64), t(hi, torch.int64),
                t((1.0 - frac).astype(np.float32), torch.float32)[:, None],
                t(frac.astype(np.float32), torch.float32)[:, None])


def resize2x_cols(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(..., W, C) -> (..., 2W, C): the x2 align-corners bilinear resize of
    the columns, in f32, rounded to ``dtype``: the W half of the strips' up3
    and up4 (JAX multiplies by the dense resize matrix; two taps a column
    give the same sums without a W x 2W product)."""
    lo, hi, wlo, whi = _col_taps(t.shape[-2], t.device)
    y = t.index_select(-2, lo).float() * wlo + t.index_select(-2, hi).float() * whi
    return y.to(dtype)


# ---------------------------------------------------------------------------
# the strip executor
# ---------------------------------------------------------------------------
def _deq(acc: torch.Tensor, w_scale: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int32 sums -> bf16: ``acc * w_scale (+ bias)`` in f32 (JAX's _deq)."""
    y = acc.float() * w_scale
    return (y if bias is None else y + bias).to(BF16)


def _partials(t: torch.Tensor, n: int, sc: int, phases: int, c: int):
    """Per-slab f32 mean and mean square of t (n sc, rows, W, phases c) over
    rows and columns, as (n, sc, phases, c) each."""
    tf = t.float()
    pm = tf.mean(dim=(1, 2)).view(n, sc, phases, c)
    ps = (tf * tf).mean(dim=(1, 2)).view(n, sc, phases, c)
    return pm, ps


def _finish(pm: torch.Tensor, ps: torch.Tensor, eps: float = 1e-5):
    """Per-(image, channel) mean and 1/std of the non-affine instance norm
    (biased variance) from every strip's partials."""
    mean, sq = pm.mean(dim=(1, 2)), ps.mean(dim=(1, 2))
    return mean, torch.rsqrt(torch.clamp(sq - mean * mean, min=0.0) + eps)


def _apply_in(t: torch.Tensor, norm, sc: int, phases: int) -> torch.Tensor:
    """(t - mean) * scale per image and original channel, in f32, back to
    t's dtype; t holds ``sc`` slabs an image."""
    mean, scale = norm
    b = lambda v: v.repeat(1, phases).repeat_interleave(sc, dim=0)[:, None, None, :]
    return ((t.float() - b(mean)) * b(scale)).to(t.dtype)


def make_strip_eval(g: Generator, packed: Dict, strip_rows: int, chunk_strips: int = 0,
                    quant: Optional[Dict] = None,
                    entry_chunked: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The strip-wise packed forward ``fn(x)``: x (N, H, W, 3) float in
    [-1, 1], with H/2 a multiple of ``strip_rows`` -> enhanced (N, H, W, 3)
    in G's dtype (bfloat16 with ``quant``).  ``packed`` is
    :func:`~uegan_tpu_torch.infer.packed.pack_generator_params` of G's
    weights; the middle reads G's modules.  The default generator config
    only; ``strip_rows`` even and > 2 * _M_EXIT.

    ``chunk_strips``: strips a chunk of the exit chain (dec3 .. output),
    which then runs one chunk at a time, after a pre-pass of the GAM
    instance-norm moments over the same 1x1 convs; 0 = auto
    (:func:`pick_strip_chunks`), -1 = never, > 0 = forced (rounded down to a
    divisor of the strip count).

    ``quant`` (infer/quantized.py:build_quant_tables): the exit chain's
    full-resolution convs (ga1, dec4, the dec5 head) in int8, the rest in
    bf16 (the tables' default ``entry_int8`` False); with ``entry_int8``
    True the entry's enc1/enc2 too.  The interior and the middle run a
    bfloat16 copy of G, whatever G's dtype, as the port's int8 forward does.

    ``entry_chunked``: recompute enc1/enc2 per exit chunk instead of holding
    every strip's entry slabs (one pass computes enc3's kept rows and the
    moment partials, the exit pass recomputes enc1/enc2): the same per-slab
    ops on the same inputs as the resident chunked path, at twice the entry
    chain's work.  Only with a chunked exit and a bf16 entry.
    """
    check_default_generator(g, "strip inference")
    r = strip_rows
    if r <= 2 * _M_EXIT or r % 2:
        raise ValueError(f"strip_rows {r} must be even and > {2 * _M_EXIT}")
    qt = quant
    if qt is not None:
        from uegan_tpu_torch.infer.quantized import INPUT_SCALE, bf16_interior, quantize_act

        gm, dt = bf16_interior(g), BF16
    else:
        gm, dt = g, g.dtype
    int8_entry = qt is not None and qt["entry_int8"]
    cd = g.conv_dim
    c2 = 2 * cd
    dev = g.enc1.main[1].weight.device
    s0s = packed_s0_statics()
    E, m = _M_ENTRY, _M_EXIT
    hs = r + 2 * m
    pk = {k: v.to(dev, dt) if torch.is_tensor(v) else v for k, v in packed.items()}
    bias = lambda mod: mod.main[1].bias.detach().to(dt)
    b_enc1, b_enc2, b_dec4 = bias(g.enc1), bias(g.enc2), bias(g.dec4)
    b_dec5_0, b_dec5_1 = bias(g.dec5[0]), bias(g.dec5[1])
    w_ga = {i: gam_x_weight(getattr(gm, f"ga{i}"), dt) for i in (2, 3, 4, 5)}
    up3, up4 = gm.upsample3[1].main[1], gm.upsample4[1].main[1]
    w_up3, b_up3 = up3.weight.detach().to(dt), up3.bias.detach().to(dt)
    w_up4, b_up4 = up4.weight.detach().to(dt), up4.bias.detach().to(dt).repeat(4)
    FIXB, LW = _DEC5_FIX, _DEC5_SLAB

    if qt is not None:
        on_dev = lambda a, t=None: torch.as_tensor(np.ascontiguousarray(a), dtype=t).to(dev)
        q = {k: on_dev(np.transpose(v, (3, 2, 0, 1))) for k, v in qt["q"].items()}  # OIHW
        qw = {k: on_dev(v, torch.float32) for k, v in qt["w"].items()}
        qb = {k: on_dev(v, torch.float32) for k, v in qt["b"].items()}
        qb4 = {k: v.repeat(4) for k, v in qb.items()}
        qb9 = on_dev(qt["b9"], torch.float32).repeat(16)
        scales = qt["sc"]
        conv_q = lambda xq, name, s0, c_in: slab_conv(xq, q[name], s0, c_in, dtype=torch.int8)

    def ga2_vals(x2part: torch.Tensor) -> torch.Tensor:
        # ga2 and ga1 at inference: IN(x-part 1x1) (infer/packed.py:gam_norm_eval)
        return _conv(x2part, w_ga[2], None, dt)

    def ga1_vals(x1part: torch.Tensor) -> torch.Tensor:
        if qt is not None:
            return _deq(conv2d_int8(quantize_act(x1part, scales["x1p"]), q["ga1"]), qw["ga1"])
        return _conv(x1part, pk["ga1_fuse_x_k"], None, dt)

    def entry_slabs(xs: torch.Tensor, n: int, ids: Sequence[int], s: int):
        """enc1 and enc2 on input slabs, each border halo refixed."""
        if int8_entry:
            xqs = quantize_act(xs, INPUT_SCALE)
            x1 = leaky(_deq(conv_q(xqs, "enc1", s0s["enc1_s0"], 3), qw["enc1"], qb4["enc1"]))
            x1 = refix_halos(x1, n, ids, s, E, cd)
            x2 = leaky(_deq(conv_q(quantize_act(x1, scales["x1p"]), "enc2", s0s["enc2_s0"], cd),
                            qw["enc2"], qb["enc2"]))
        else:
            x1 = slab_conv(xs, pk["enc1_k"], s0s["enc1_s0"], 3, b_enc1, dt, act=leaky)
            x1 = refix_halos(x1, n, ids, s, E, cd)
            x2 = slab_conv(x1, pk["enc2_k"], s0s["enc2_s0"], cd, b_enc2, dt, act=leaky)
        return x1, refix_halos(x2, n, ids, s, E, None)

    def moments(x1c: torch.Tensor, x2c: torch.Tensor, n: int, sc: int):
        """The ga1/ga2 moment partials of sc strips from their interior rows."""
        g2 = ga2_vals(x2c[:, E:E + r])
        g1 = ga1_vals(x1c[:, E:E + r])
        return _partials(g1, n, sc, 4, cd) + _partials(g2, n, sc, 1, c2)

    def up_stage(i: int, t: torch.Tensor) -> torch.Tensor:
        # on maps whose resize output passes 1024 rows the 1x1 conv runs first
        # (pointwise-linear: it commutes with the resize, whose rows sum to
        # 1), halving the resize's channels, as in JAX
        conv = getattr(gm, f"upsample{i}")[1]
        if 2 * t.shape[2] > 1024:
            return to_nchw(upsample2x(to_nhwc(conv(t))))
        return conv(to_nchw(upsample2x(to_nhwc(t))))

    def seq5(slab: torch.Tensor) -> torch.Tensor:
        """The sequential dec5_0 -> dec5_1 + tanh chain on a slab."""
        if qt is not None:
            h = _deq(conv_q(slab, "dec5_0", s0s["dec5_0_s0"], cd), qw["dec5_0"], qb4["dec5_0"])
            h = conv_q(quantize_act(h, scales["h5"]), "dec5_1", s0s["dec5_1_s0"], cd)
            return torch.tanh(_deq(h, qw["dec5_1"], qb4["dec5_1"]))
        h = slab_conv(slab, pk["dec5_0_k"], s0s["dec5_0_s0"], cd, b_dec5_0, dt)
        return slab_conv(h, pk["dec5_1_k"], s0s["dec5_1_s0"], cd, b_dec5_1, dt, act=torch.tanh)

    def dec5_band(zedge: torch.Tensor, top: bool) -> torch.Tensor:
        """The sequential head's values on the image's top (bottom) band of
        _DEC5_FIX packed rows, from a narrow slab of an image's first (last)
        strip: dec5_0, its rows past the image edge rebuilt as the packed
        reflect of its real rows (the canonical per-layer pad), then dec5_1."""
        zb = zedge[:, :m + 6] if top else zedge[:, -(m + 6):]
        if qt is not None:
            hb = _deq(conv_q(zb, "dec5_0", s0s["dec5_0_s0"], cd), qw["dec5_0"], qb4["dec5_0"])
        else:
            hb = slab_conv(zb, pk["dec5_0_k"], s0s["dec5_0_s0"], cd, b_dec5_0, dt)
        if top:
            hband = torch.cat([pad_rows(hb[:, m:], 2, cd)[0], hb[:, m:m + 4]], dim=1)
        else:
            hband = torch.cat([hb[:, 2:6], pad_rows(hb[:, :6], 2, cd)[1]], dim=1)
        if qt is not None:
            band = torch.tanh(_deq(conv_q(quantize_act(hband, scales["h5"]), "dec5_1",
                                          s0s["dec5_1_s0"], cd), qw["dec5_1"], qb4["dec5_1"]))
        else:
            band = slab_conv(hband, pk["dec5_1_k"], s0s["dec5_1_s0"], cd, b_dec5_1, dt,
                             act=torch.tanh)
        return band[:, 2:4]

    def strip_dec5(z: torch.Tensor, n: int, ids: Sequence[int], s: int) -> torch.Tensor:
        """The dec5 head on the modulated slabs z (int8 with ``quant``): the
        interior from the composed 9x9 head in its stride-2 deep form, the
        real W borders from sequential column slabs, and an image's top and
        bottom band from :func:`dec5_band` (the only rows where the composed
        and the sequential reflect differ); the slab H edges contaminate
        only the margin (m covers the composed reach 2 and the deep form's
        zero-pad reach 2)."""
        hs_, wp_ = z.shape[1], z.shape[2]  # even, and wp_ >= 16 (check_input_hw)
        if qt is not None:
            yd = conv2d_int8(z, q["dec5d"], stride=2, padding=2)
            y = depth_to_space(torch.tanh(yd.float() * qw["dec5d"] + qb9).to(BF16))
        else:
            y = depth_to_space(_conv(z, pk["dec5d_k"], pk["dec5c_b"], dt, torch.tanh,
                                     stride=2, padding=2))
        y[:, :, :FIXB] = seq5(z[:, :, :LW])[:, :, :FIXB]
        y[:, :, wp_ - FIXB:] = seq5(z[:, :, wp_ - LW:])[:, :, LW - FIXB:]
        zr = z.view(n, len(ids), *z.shape[1:])
        yr = y.view(n, len(ids), *y.shape[1:])
        if ids[0] == 0:
            yr[:, 0, m:m + FIXB] = dec5_band(zr[:, 0], True)
        if ids[-1] == s - 1:
            yr[:, -1, hs_ - m - FIXB:hs_ - m] = dec5_band(zr[:, -1], False)
        return y

    def exit_strips(x1c, x2c, y2t, consts, n: int, c0: int, sc: int, s: int, norm1,
                    norm2) -> torch.Tensor:
        """dec3 .. the head on strips c0 .. c0 + sc - 1 of every image: x1c,
        x2c their entry slabs (n sc, r + 2E, wp, C); y2t up3's input after
        its 1x1 conv and W resize; norm1, norm2 the ga1/ga2 moments, or None
        to take them from these strips (when they are all of them).  Returns
        the head's packed slabs (n sc, R + 2M, wp, 12): the kept rows are
        [M, M + r)."""
        ids = range(c0, c0 + sc)
        ns = n * sc
        wp = x1c.shape[2]
        # up3 in slab form: each strip's band of rows of the resized map
        win = consts["win3"]
        y2w = torch.stack([y2t[:, st:st + win] for st in consts["starts3"][c0:c0 + sc]], 1)
        up3s = torch.matmul(consts["m3"][c0:c0 + sc], y2w.flatten(3))
        up3s = (up3s.view(ns, hs, wp, c2) + b_up3).to(dt)

        ga2 = ga2_vals(x2c)
        ga1 = ga1_vals(x1c)
        if norm1 is None:
            norm1 = _finish(*_partials(ga1[:, E:E + r], n, sc, 4, cd))
            norm2 = _finish(*_partials(ga2[:, E:E + r], n, sc, 1, c2))
        ga2s = _apply_in(ga2[:, E - m:E + r + m], norm2, sc, 1)
        ga1s = _apply_in(ga1[:, E - m:E + r + m], norm1, sc, 4)
        y3s = slab_block(gm.dec3, torch.cat([up3s, ga2s], dim=-1))

        # up4: the 1x1 conv at half res, the W resize, then each strip's H
        # matrices of both row phases; the phases move next to the channels
        z4 = resize2x_cols(_conv(y3s, w_up4, None, dt), dt)  # (ns, hs, 2wp, cd)
        zh = torch.matmul(consts["m4"][c0:c0 + sc], z4.view(n, sc, hs, 2 * wp * cd))
        zh = zh.view(n, sc, 2, hs, wp, 2, cd).permute(0, 1, 3, 4, 2, 5, 6)
        up4s = torch.empty((n, sc, hs, wp, 2, 2, cd), dtype=dt, device=zh.device)
        torch.add(zh, b_up4.view(2, 2, cd), out=up4s)
        up4s = up4s.view(ns, hs, wp, 4 * cd)

        x1es = x1c[:, E - m:E + r + m]
        if qt is not None:
            acc = conv_q([quantize_act(up4s, scales["up4"]), quantize_act(ga1s, scales["ga1p"])],
                         "dec4", s0s["dec4_s0"], [cd, cd])
            y4s = leaky(_deq(acc, qw["dec4"], qb4["dec4"]))
        else:
            y4s = slab_conv([up4s, ga1s], pk["dec4_k"], s0s["dec4_s0"], [cd, cd], b_dec4, dt,
                            act=leaky)
        # dec5_0 reflect-pads y4 * x1; x1's halos are reflect already
        y4s = refix_halos(y4s, n, ids, s, m, cd)
        z = y4s * x1es
        if qt is not None:
            z = quantize_act(z, scales["mod"])
        return strip_dec5(z, n, ids, s)

    def fn(x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        check_input_hw(h, w)
        hp, wp = h // 2, w // 2
        if hp % r:
            raise ValueError(f"packed height {hp} is not a multiple of strip_rows {r}")
        s = hp // r
        if chunk_strips > 0:
            cs = min(chunk_strips, s)
            while s % cs:
                cs -= 1
        elif chunk_strips < 0:
            cs = s
        else:
            cs = pick_strip_chunks(n, s, hs, wp)
        ec = entry_chunked and cs < s and not int8_entry
        consts = _strip_constants(hp, s, r, m, x.device, dt)
        with torch.inference_mode():
            xp = s2d_convert(x.contiguous(), dt)  # kernel C: (N, Hp, Wp, 12)
            # ---- the entry chain: enc1, enc2, enc3 on strips ----
            if ec:
                xpe = extend_rows(xp, E, 3)
                x3 = xp.new_empty((n, hp // 2, wp // 2, 4 * cd))
                parts = []
                for c0 in range(0, s, cs):
                    x1c, x2c = entry_slabs(slabs_chunk(xpe, c0, cs, r, E), n,
                                           range(c0, c0 + cs), s)
                    parts.append(moments(x1c, x2c, n, cs))
                    x3c = slab_block(gm.enc3, x2c)[:, E // 2:E // 2 + r // 2]
                    x3.view(n, s, r // 2, wp // 2, -1)[:, c0:c0 + cs] = x3c.view(
                        n, cs, r // 2, wp // 2, -1)
                    del x1c, x2c, x3c
            else:
                x1s, x2s = entry_slabs(slabs(xp, s, r, E, 3), n, range(s), s)
                x3 = unslab(slab_block(gm.enc3, x2s)[:, E // 2:E // 2 + r // 2], n)
            # ---- the middle: every map at most Hp/2 rows, directly ----
            x3n = to_nchw(x3)
            x4 = gm.enc4(x3n)
            x5 = gam_norm_eval(gm.enc5(x4), w_ga[5])
            y1 = gm.dec1(torch.cat([up_stage(1, x5), gam_norm_eval(x4, w_ga[4])], dim=1))
            y2 = gm.dec2(torch.cat([up_stage(2, y1), gam_norm_eval(x3n, w_ga[3])], dim=1))
            del x3, x3n, x4, x5, y1
            # up3's 1x1 conv and W resize at half res, once; its H resize runs
            # per strip in the exit
            y2t = resize2x_cols(to_nhwc(F.conv2d(y2, w_up3)), dt)
            del y2
            xin = xp.view(n, s, r, wp, xp.shape[-1])  # each strip's kept input rows

            if cs >= s:
                ress = exit_strips(x1s, x2s, y2t, consts, n, 0, s, s, None, None)
                if max(hp, wp) >= _SLAB_UNPACK_MIN:
                    # kernel D reads each slab's window of kept rows in place
                    return residual_tail_d2s(ress[:, m:m + r], xin.view(n * s, r, wp, -1)).view(
                        n, h, w, -1)
                return residual_tail_d2s(unslab(ress[:, m:m + r], n), xp)

            # ---- the chunked exit: moments first, then one chunk at a time ----
            if ec:
                pm1, ps1, pm2, ps2 = (torch.cat(t, 1) for t in zip(*parts))
            else:
                x1r = x1s.view(n, s, *x1s.shape[1:])
                x2r = x2s.view(n, s, *x2s.shape[1:])
                chunk = lambda t, c0: t[:, c0:c0 + cs].reshape(n * cs, *t.shape[2:])
                pm1, ps1, pm2, ps2 = (torch.cat(t, 1) for t in zip(*[
                    moments(chunk(x1r, c0), chunk(x2r, c0), n, cs) for c0 in range(0, s, cs)]))
            norm1, norm2 = _finish(pm1, ps1), _finish(pm2, ps2)
            out = torch.empty((n, h, w, 3), dtype=dt, device=x.device)
            outr = out.view(n, s, 2 * r, w, 3)
            for c0 in range(0, s, cs):
                if ec:
                    x1c, x2c = entry_slabs(slabs_chunk(xpe, c0, cs, r, E), n,
                                           range(c0, c0 + cs), s)
                else:
                    x1c, x2c = chunk(x1r, c0), chunk(x2r, c0)
                ress = exit_strips(x1c, x2c, y2t, consts, n, c0, cs, s, norm1, norm2)
                y = residual_tail_d2s(ress[:, m:m + r],
                                      xin[:, c0:c0 + cs].reshape(n * cs, r, wp, -1))
                outr[:, c0:c0 + cs] = y.view(n, cs, 2 * r, w, 3)
                del x1c, x2c, ress, y
            return out

    return fn


def make_int8_strip_eval(g: Generator, tables: Dict, strip_rows: int, chunk_strips: int = 0,
                         entry_chunked: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The int8 strip executor from the quant tables
    (infer/quantized.py:build_quant_tables): ``fn(x)`` -> bfloat16, the
    512 px int8 scheme extended to the strips' full-resolution convs."""
    return make_strip_eval(g, tables["pk"], strip_rows, chunk_strips, quant=tables,
                           entry_chunked=entry_chunked)


def make_strip_fast_eval(g: Generator, strip_rows: int, chunk_strips: int = 0,
                         entry_chunked: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """The bf16/f32 strip executor packed from G's current weights."""
    check_default_generator(g, "strip inference")
    packed = pack_generator_params(g.state_dict(), g.conv_dim,
                                   device=g.enc1.main[1].weight.device)
    return make_strip_eval(g, packed, strip_rows, chunk_strips, entry_chunked=entry_chunked)
