"""int8 quantized packed inference, counterpart of uegan_tpu/infer/quantized.py.

``--quantized_inference int8`` (or ``int8_pallas``) runs the packed forward
with its full-resolution convs in int8:

- weights: per-output-channel symmetric int8 over the PACKED kernels, each
  input tensor's activation scale folded into its kernel rows first (so a
  concat of differently scaled int8 tensors needs no per-channel dequant);
- activations: per-tensor scales from one calibration forward (the bf16
  packed forward with max-|x| taps); the [-1, 1] input is scale 1/127;
- the convs sum in int32 (:func:`~uegan_tpu_torch.ops.conv_int8.conv2d_int8`,
  or kernel E with its fused epilogue); dequant + bias + activation run in
  f32 and round to bf16; the next conv's input is requantized to int8;
- the interior (<= half res: the canonical blocks with their full GAMs),
  the GAM statistics, the instance norms, the up4 resize and the global
  residual stay bf16/f32.

The whole path is bfloat16 whatever ``--compute_dtype`` says, as in the JAX
package: the interior runs a bfloat16 copy of G's modules.  Kernels on a
card: C at the entry, A in the interior's GAMs (ga2..ga5), B in up1..up3,
D at the exit, and under ``int8_pallas`` E for the convs the TPU kernel's
gate passes (``_pl_ok``: 1x1 only, in practice ga1).

The output differs from the bf16 forward by the quantization error (the JAX
tests hold it to >= 30 dB), hence opt in.  The reference has no
quantization; this path is the JAX package's addition.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.infer.packed import (_DEC5_FIX, _DEC5_SLAB, _conv, depth_to_space,
                                          check_default_generator, leaky, pack_generator_params,
                                          packed_conv, packed_gam_stats, packed_instance_norm,
                                          packed_reflect_pad, packed_resize2x_align_corners,
                                          packed_s0_statics)
from uegan_tpu_torch.models.blocks import to_nchw, to_nhwc
from uegan_tpu_torch.models.generator import Generator, check_input_hw
from uegan_tpu_torch.ops.conv_int8 import conv2d_int8
from uegan_tpu_torch.ops.packed_conv_int8 import eligible, int8_epilogue, packed_conv_int8
from uegan_tpu_torch.ops.s2d_fuse import residual_tail_d2s, s2d_convert

# the int8 packed conv (reflect semantics) -> int32 sums
_conv_q = functools.partial(packed_conv, dtype=torch.int8)

INPUT_SCALE = 1.0 / 127.0  # the network input is [-1, 1] by contract

# activation-scale taps, in forward order (up4 = the up4 stage's output)
SCALE_KEYS = ("x1p", "ga1p", "up4", "mod", "h5")

BF16 = torch.bfloat16


def quantize_weights(w: np.ndarray, in_scale) -> Tuple[np.ndarray, np.ndarray]:
    """Per-output-channel symmetric int8 quantization of an HWIO kernel.

    ``in_scale`` (scalar or per-input-channel vector) is folded into the
    kernel before quantization, so int8 inputs feed the conv directly and
    one per-output-channel dequant recovers the float result:
    ``conv(x, w * s_in) == conv(x_q, w_q) * s_out`` up to rounding.
    """
    w = np.asarray(w, np.float64)
    if np.ndim(in_scale) > 0:
        w = w * np.asarray(in_scale, np.float64)[None, None, :, None]
    else:
        w = w * float(in_scale)
    s_out = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
    s_out = np.where(s_out > 0, s_out, 1.0)
    wq = np.clip(np.rint(w / s_out), -127, 127).astype(np.int8)
    return wq, s_out.astype(np.float32)


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric per-tensor int8: clip(round(x * (1 / scale)), -127, 127),
    round half to even; the reciprocal is taken in double and rounded to
    float32, as JAX multiplies a float32 array by a Python float."""
    inv = float(np.float32(1.0 / scale))
    return torch.clamp(torch.round(x.float() * inv), -127.0, 127.0).to(torch.int8)


def _conv_q_fused(xq: torch.Tensor, kq: torch.Tensor, w_scale: torch.Tensor,
                  bias_t: torch.Tensor, s0: int, c_in, act: str = "none",
                  mul: Optional[torch.Tensor] = None, out_scale: Optional[float] = None,
                  requant: bool = False) -> torch.Tensor:
    """int8 packed conv + fused epilogue through kernel E, with the reflect
    border strips applied after it (uegan_tpu/infer/quantized.py:113-198).

    Kernel E zero-pads; its border rows and columns are overwritten here
    with strips computed from packed-reflect-padded slabs, whose epilogue
    divides by ``out_scale`` where the kernel multiplies by its reciprocal,
    as in the JAX package."""
    S = kq.shape[-1]
    s1 = S - 1 - s0
    p = max(s0, s1)
    m = max(s0 + s1, p + 1)
    lp, wp = xq.shape[1], xq.shape[2]
    y = packed_conv_int8(xq, kq, w_scale, bias_t, s0, act=act, mul=mul, out_scale=out_scale,
                         requant=requant)
    if p == 0:
        return y  # 1x1: exact everywhere, no strips

    def epi(slab: torch.Tensor, rows: slice, cols: slice) -> torch.Tensor:
        return int8_epilogue(conv2d_int8(slab, kq), w_scale, bias_t, act,
                             None if mul is None else mul[:, rows, cols], out_scale, requant,
                             divide=True)

    wslice = slice(p - s0, p + wp + s1)
    if s0:
        slab = packed_reflect_pad(xq[:, :m], p, c_in)
        y[:, :s0] = epi(slab[:, p - s0:p + s0 + s1, wslice], slice(0, s0), slice(None))
    if s1:
        slab = packed_reflect_pad(xq[:, lp - m:], p, c_in)
        y[:, lp - s1:] = epi(slab[:, p + m - s0 - s1:p + m + s1, wslice],
                             slice(lp - s1, None), slice(None))
    if s0:
        slab = packed_reflect_pad(xq[:, :, :m], p, c_in)
        y[:, s0:lp - s1, :s0] = epi(slab[:, p:p + lp, p - s0:p + s0 + s1],
                                    slice(s0, lp - s1), slice(0, s0))
    if s1:
        slab = packed_reflect_pad(xq[:, :, wp - m:], p, c_in)
        y[:, s0:lp - s1, wp - s1:] = epi(slab[:, p:p + lp, p + m - s0 - s1:p + m + s1],
                                         slice(s0, lp - s1), slice(wp - s1, None))
    return y


def bf16_interior(g: Generator) -> Generator:
    """G itself when it computes in bfloat16, else a copy whose modules
    compute in bfloat16 (the parameters stay float32, cast at each conv)."""
    if g.dtype == BF16:
        return g
    gb = copy.deepcopy(g)
    for mod in gb.modules():
        if hasattr(mod, "dtype"):
            mod.dtype = BF16
    return gb


def _interior(gb: Generator, x2: torch.Tensor) -> torch.Tensor:
    """The canonical bf16 interior (enc3 .. dec3, full GAMs: kernels A and B
    on a card) on the packed path's half-res x2 (N, H/2, W/2, 2cd) ->
    y3 (N, H/2, W/2, 2cd)."""
    x2c = to_nchw(x2)
    x3 = gb.enc3(x2c)
    x4 = gb.enc4(x3)
    y = gb.ga5(gb.enc5(x4))
    for i, skip in enumerate((x4, x3, x2c), 1):
        y = gb._up(i, y, skip)
    return to_nhwc(y)


def _up4(y3: torch.Tensor, w_up4: torch.Tensor, b_up4: torch.Tensor,
         out_hw: Tuple[int, int]) -> torch.Tensor:
    """up4 on the packed path: the 1x1 conv at half res (with its bias),
    then the packed x2 resize, as the port's packed forward runs it."""
    z4 = to_nhwc(F.conv2d(to_nchw(y3), w_up4, b_up4))
    return packed_resize2x_align_corners(z4, out_hw)


def calibrate(g: Generator, x: torch.Tensor, packed: Optional[Dict] = None,
              gb: Optional[Generator] = None) -> Dict[str, float]:
    """Per-tensor activation scales, max |value| / 127 at each of
    SCALE_KEYS, from one calibration forward on ``x`` (a representative
    batch in [-1, 1]; any size the generator takes): the bf16 packed forward
    of uegan_tpu/infer/quantized.py:_forward_bf16_taps, up to the last
    quantization point (``h5`` is the full sequential dec5_0 output).
    ``packed`` is :func:`pack_generator_params` of G's weights on G's
    device."""
    cd = g.conv_dim
    dev = g.enc1.main[1].weight.device
    if packed is None:
        packed = pack_generator_params(g.state_dict(), cd, device=dev)
    gb = gb if gb is not None else bf16_interior(g)
    s0 = packed_s0_statics()
    pk = {k: v.to(BF16) if torch.is_tensor(v) else v for k, v in packed.items()}
    sd = g.state_dict()
    bias = lambda key, n: sd[key].detach().to(BF16).repeat(n)
    maxes = {}

    def tap(name: str, t: torch.Tensor) -> torch.Tensor:
        maxes[name] = float(t.float().abs().max())
        return t

    with torch.inference_mode():
        h, w = x.shape[1], x.shape[2]
        check_input_hw(h, w)
        xp = s2d_convert(x.to(dev).float().contiguous(), BF16)
        x1p = tap("x1p", packed_conv(xp, pk["enc1_k"], s0["enc1_s0"], 3,
                                     bias("enc1.main.1.bias", 4), BF16, act=leaky))
        x2 = packed_conv(x1p, pk["enc2_k"], s0["enc2_s0"], cd, bias("enc2.main.1.bias", 1),
                         BF16, act=leaky)
        y3 = _interior(gb, x2)
        mean, std = packed_gam_stats(x1p, cd)
        stats = torch.cat([mean, std], -1).to(BF16)
        sq = sd["ga1.conv.0.weight"][:, :, 0, 0].t().to(BF16)
        ex = sd["ga1.conv.2.weight"][:, :, 0, 0].t().to(BF16)
        kh = sd["ga1.fuse.0.weight"][:, cd:, 0, 0].t().to(BF16)
        hh = F.relu(stats @ sq) @ ex
        ga1p = _conv(x1p, pk["ga1_fuse_x_k"], bias("ga1.fuse.0.bias", 4), BF16)
        ga1p = ga1p + (hh @ kh).repeat(1, 4)[:, None, None, :]
        ga1p = tap("ga1p", packed_instance_norm(ga1p, cd))
        up4 = tap("up4", _up4(y3, sd["upsample4.1.main.1.weight"].to(BF16),
                              sd["upsample4.1.main.1.bias"].to(BF16), (h, w)))
        y4p = packed_conv(torch.cat([up4, ga1p], -1), pk["dec4_k"], s0["dec4_s0"], [cd, cd],
                          bias("dec4.main.1.bias", 4), BF16, act=leaky)
        mod = tap("mod", y4p * x1p)
        tap("h5", packed_conv(mod, pk["dec5_0_k"], s0["dec5_0_s0"], cd,
                              bias("dec5.0.main.1.bias", 4), BF16))
    return {k: max(v, 1e-6) / 127.0 for k, v in maxes.items()}


def build_quant_tables(g: Generator, calib_batch=None,
                       scales: Optional[Dict[str, float]] = None) -> Dict:
    """Quantize the packed full-res kernels and calibrate the activation
    scales (uegan_tpu/infer/quantized.py:build_quant_tables).  Returns numpy
    tables, kernels HWIO as in the JAX package:

    - ``q``: int8 packed kernels (enc1/enc2/ga1/dec4/dec5_0/dec5_1/dec5d)
    - ``w``: their per-output-channel dequant scales
    - ``sc``: per-tensor activation scales (SCALE_KEYS); ``scales`` when given
    - ``b``: original-channel float32 biases per conv
    - ``b9``: the composed dec5 head's 3-channel bias
    - ``se``: ga1's (squeeze, excite, fuse-h) float kernels for the SE branch
    - ``pk``: :func:`pack_generator_params` of G's weights (OIHW tensors on
      G's device), the float kernels of the int8 strip executor's bf16 entry
    - ``entry_int8``: False, so the strip executor (infer/strips.py) keeps
      its entry chain in bf16 and quantizes the exit chain, JAX's default
      hybrid; True quantizes the entry too
    """
    check_default_generator(g, "int8 packed inference")
    cd = g.conv_dim
    dev = g.enc1.main[1].weight.device
    packed = pack_generator_params(g.state_dict(), cd, device=dev)
    if scales is None:
        if calib_batch is None:  # the JAX package's default: seeded, uniform in [-1, 1]
            calib_batch = np.random.default_rng(1990).uniform(-1, 1, (2, 64, 64, 3))
        scales = calibrate(g, torch.as_tensor(np.asarray(calib_batch, np.float32)
                                              if not torch.is_tensor(calib_batch)
                                              else calib_batch), packed=packed)
    sc = dict(scales)
    hwio = lambda key: np.transpose(packed[key].cpu().numpy(), (2, 3, 1, 0))
    sd = {k: v.detach().cpu().numpy() for k, v in g.state_dict().items()}

    q: Dict[str, np.ndarray] = {}
    w: Dict[str, np.ndarray] = {}
    q["enc1"], w["enc1"] = quantize_weights(hwio("enc1_k"), INPUT_SCALE)
    q["enc2"], w["enc2"] = quantize_weights(hwio("enc2_k"), sc["x1p"])
    q["ga1"], w["ga1"] = quantize_weights(hwio("ga1_fuse_x_k"), sc["x1p"])
    in_sc = np.concatenate([np.full(4 * cd, sc["up4"]), np.full(4 * cd, sc["ga1p"])])
    q["dec4"], w["dec4"] = quantize_weights(hwio("dec4_k"), in_sc)
    q["dec5_0"], w["dec5_0"] = quantize_weights(hwio("dec5_0_k"), sc["mod"])
    q["dec5_1"], w["dec5_1"] = quantize_weights(hwio("dec5_1_k"), sc["h5"])
    q["dec5d"], w["dec5d"] = quantize_weights(hwio("dec5d_k"), sc["mod"])
    biases = {
        "enc1": sd["enc1.main.1.bias"], "enc2": sd["enc2.main.1.bias"],
        "ga1": sd["ga1.fuse.0.bias"], "up4": sd["upsample4.1.main.1.bias"],
        "dec4": sd["dec4.main.1.bias"], "dec5_0": sd["dec5.0.main.1.bias"],
        "dec5_1": sd["dec5.1.main.1.bias"],
    }
    se = {
        "squeeze": sd["ga1.conv.0.weight"][:, :, 0, 0].T,
        "excite": sd["ga1.conv.2.weight"][:, :, 0, 0].T,
        "fuse_h": sd["ga1.fuse.0.weight"][:, cd:, 0, 0].T,
    }
    return {"q": q, "w": w, "sc": sc, "b": biases,
            "b9": packed["dec5c_b"].cpu().numpy().astype(np.float32), "se": se,
            "pk": packed, "entry_int8": False}


def make_int8_eval(g: Generator, tables: Optional[Dict] = None, use_pallas: bool = False,
                   calib_batch=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """The int8 packed forward ``fn(x)``: x (N, H, W, 3) float in [-1, 1]
    -> (N, H, W, 3) bfloat16 (uegan_tpu/infer/quantized.py:make_int8_eval).

    ``tables`` from :func:`build_quant_tables` (made here from G's weights,
    calibrated on ``calib_batch``, when None).  ``use_pallas`` routes the
    convs that the TPU kernel's gate passes (``_pl_ok``: 1x1 with eligible
    shapes, in practice ga1) through kernel E with its fused epilogue; the
    fused dec4 and dec5_0 sites are gated off by the 1x1 check, as in JAX.
    """
    check_default_generator(g, "int8 packed inference")
    tabs = tables if tables is not None else build_quant_tables(g, calib_batch)
    cd = g.conv_dim
    dev = g.enc1.main[1].weight.device
    s0s = packed_s0_statics()
    gb = bf16_interior(g)
    sc = tabs["sc"]
    on_dev = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a), dtype=dt).to(dev)
    q = {k: on_dev(np.transpose(v, (3, 2, 0, 1))) for k, v in tabs["q"].items()}  # OIHW
    w = {k: on_dev(v, torch.float32) for k, v in tabs["w"].items()}
    b = {k: on_dev(v, torch.float32) for k, v in tabs["b"].items()}
    b4 = {k: v.repeat(4) for k, v in b.items()}
    b9 = on_dev(tabs["b9"], torch.float32).repeat(16)
    sq, ex, kh = (on_dev(tabs["se"][k], BF16) for k in ("squeeze", "excite", "fuse_h"))
    up4 = g.upsample4[1].main[1]
    w_up4, b_up4 = up4.weight.detach().to(BF16), b["up4"].to(BF16)
    r, L = _DEC5_FIX, _DEC5_SLAB

    def _pl_ok(xq_shape, name: str) -> bool:
        # kernel E for the 1x1 convs only, as the JAX package routes them
        # (it measured its TPU kernel slower than XLA's conv at 3x3)
        kq = q[name]
        if not use_pallas or kq.shape[-1] != 1:
            return False
        return eligible(tuple(xq_shape), (1, 1, kq.shape[1], kq.shape[0]))

    def _plq(name: str):
        return q[name], w[name], b4[name]

    def seq_tail(mq: torch.Tensor) -> torch.Tensor:
        """The sequential int8 dec5_0 -> requant -> dec5_1 + tanh chain
        (canonical border semantics), for the head's border band."""
        if _pl_ok(mq.shape, "dec5_0"):
            h5q = _conv_q_fused(mq, *_plq("dec5_0"), s0s["dec5_0_s0"], cd, out_scale=sc["h5"],
                                requant=True)
        else:
            h5 = int8_epilogue(_conv_q(mq, q["dec5_0"], s0s["dec5_0_s0"], cd), w["dec5_0"],
                               b4["dec5_0"])
            h5q = quantize_act(h5, sc["h5"])
        return torch.tanh(int8_epilogue(_conv_q(h5q, q["dec5_1"], s0s["dec5_1_s0"], cd),
                                        w["dec5_1"], b4["dec5_1"]))

    def fn(x: torch.Tensor) -> torch.Tensor:
        n, h, w_img, _ = x.shape
        check_input_hw(h, w_img)
        xp = s2d_convert(x.contiguous(), BF16)
        xq = quantize_act(xp, INPUT_SCALE)  # the input's own 8-bit quantization
        x1p = leaky(int8_epilogue(_conv_q(xq, q["enc1"], s0s["enc1_s0"], 3), w["enc1"],
                                  b4["enc1"]))
        x1q = quantize_act(x1p, sc["x1p"])
        x2 = leaky(int8_epilogue(_conv_q(x1q, q["enc2"], s0s["enc2_s0"], cd), w["enc2"],
                                 b["enc2"]))
        y3 = _interior(gb, x2)

        # ga1: the SE term from the bf16 x1's statistics, added before the IN
        mean, std = packed_gam_stats(x1p, cd)
        stats = torch.cat([mean, std], -1).to(BF16)
        hh = F.relu(stats @ sq) @ ex
        if _pl_ok(x1q.shape, "ga1"):
            ga1p = _conv_q_fused(x1q, *_plq("ga1"), 0, cd)
        else:
            ga1p = int8_epilogue(conv2d_int8(x1q, q["ga1"]), w["ga1"], b4["ga1"])
        ga1p = packed_instance_norm(ga1p + (hh @ kh).repeat(1, 4)[:, None, None, :], cd)
        ga1q = quantize_act(ga1p, sc["ga1p"])

        up4q = quantize_act(_up4(y3, w_up4, b_up4, (h, w_img)), sc["up4"])
        d4in = torch.cat([up4q, ga1q], -1)
        if _pl_ok(d4in.shape, "dec4"):
            # conv + leaky + (y4 * x1) modulation + requantize in one pass
            modq = _conv_q_fused(d4in, *_plq("dec4"), s0s["dec4_s0"], [cd, cd], act="leaky",
                                 mul=x1p, out_scale=sc["mod"], requant=True)
        else:
            y4p = leaky(int8_epilogue(_conv_q(d4in, q["dec4"], s0s["dec4_s0"], [cd, cd]),
                                      w["dec4"], b4["dec4"]))
            modq = quantize_act(y4p * x1p, sc["mod"])

        lp, wp = modq.shape[1], modq.shape[2]
        if lp % 2 or wp % 2 or min(lp, wp) <= L + r:
            raise ValueError(f"int8 dec5 head: packed dims {lp}x{wp} must be even and > {L + r}")
        # interior: ONE stride-2 int8 conv (the composed head in its deep
        # form) with dequant + composed bias + tanh, then depth_to_space;
        # the border band from the sequential int8 chain on narrow slabs
        yd = conv2d_int8(modq, q["dec5d"], stride=2, padding=2)
        v = torch.tanh(yd.float() * w["dec5d"] + b9)
        res = depth_to_space(v.to(BF16))  # (N, lp, wp, 12)
        res[:, :, :r] = seq_tail(modq[:, :, :L])[:, :, :r]
        res[:, :, wp - r:] = seq_tail(modq[:, :, wp - L:])[:, :, L - r:]
        res[:, :r] = seq_tail(modq[:, :L])[:, :r]
        res[:, lp - r:] = seq_tail(modq[:, lp - L:])[:, L - r:]
        return residual_tail_d2s(res, xp)  # clip(res + x, -1, 1), unpacked

    return fn
