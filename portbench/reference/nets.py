"""Plain PyTorch reference of UEGAN's generator, discriminator and VGG19 trunk.

A frozen restatement of the published model (Ni et al., IEEE T-IP 2020;
eezkni/UEGAN ``models.py`` and ``losses.py``) written from its equations,
with no kernel, no packing and no batching trick.  It imports nothing of the
program under test.  Parameters are plain tensors in a dict keyed by the
reference checkpoint's names (``enc1.main.1.weight``, ``d1.0.1.weight_orig``,
``features.0.weight``), so one seeded dict can be handed to the program's
``load_state_dict`` and to these functions alike.

Every tensor is NCHW inside.  Convs go through ``Numerics.conv``: float32
with TF32 off (``exact``), or, for the control, float8 (e4m3) operands with
a per-tensor scale, multiplied in bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

G_REDUCTION = 8  # the GAM's squeeze ratio
D_STAGES = ((1, 7), (2, 7), (4, 7), (8, 5), (16, 5))  # (width in conv_dim, kernel)
VGG_CONVS = ((0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256), (16, 256),
             (19, 512), (21, 512), (23, 512), (25, 512), (28, 512))  # to conv5_1
VGG_POOLS = (4, 9, 18, 27)
VGG_TAPS = {0: "relu1_1", 5: "relu2_1", 10: "relu3_1", 19: "relu4_1", 28: "relu5_1"}
PERCEPTUAL_WEIGHTS = {"relu1_1": 1.0 / 64, "relu2_1": 1.0 / 64, "relu3_1": 1.0 / 32,
                      "relu4_1": 1.0 / 32, "relu5_1": 1.0}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0  # the largest float8_e4m3fn


@contextlib.contextmanager
def exact():
    """TF32 off for cuDNN and cuBLAS while the block runs; the flags restored."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    back in t's dtype; the gradient passes straight through."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Numerics:
    """How a conv computes: ``"f32"`` (call under :func:`exact`) or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"numerics {kind!r}: f32 or fp8")
        self.kind = kind

    def conv(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             stride: int = 1, padding: int = 0) -> torch.Tensor:
        if self.kind == "f32":
            return F.conv2d(x, w, b, stride=stride, padding=padding)
        y = F.conv2d(fp8_round(x.float()).bfloat16(), fp8_round(w.float()).bfloat16(),
                     None if b is None else b.bfloat16(), stride=stride, padding=padding)
        return y.float()


# ---------------------------------------------------------------------------
# parameter names and shapes


def sn_prefixes_g() -> List[str]:
    """G's spectrally normalized convs under ``use_sn``: the encoder and decoder
    blocks, the decoder's 1x1 convs after each upsample, and each GAM's fuse
    conv; never the GAM's squeeze and excite nor the output head."""
    return ([f"enc{i}.main.1" for i in range(1, 6)]
            + [f"upsample{i}.1.main.1" for i in range(1, 5)]
            + [f"dec{i}.main.1" for i in range(1, 5)] + [f"ga{i}.fuse.0" for i in range(1, 6)])


def _conv_spec(spec: dict, prefix: str, cout: int, cin: int, k: int, bias: bool,
               sn: bool) -> None:
    spec[prefix + (".weight_orig" if sn else ".weight")] = (cout, cin, k, k)
    if bias:
        spec[prefix + ".bias"] = (cout,)
    if sn:
        spec[prefix + ".weight_u"] = (cout,)
        spec[prefix + ".weight_v"] = (cin * k * k,)


def g_spec(cd: int, use_sn: bool) -> Dict[str, Tuple[int, ...]]:
    spec: dict = {}
    widths = (cd, cd * 2, cd * 4, cd * 8, cd * 16)
    cin = 3
    for i, (c, k) in enumerate(zip(widths, (7, 3, 3, 3, 3)), 1):
        _conv_spec(spec, f"enc{i}.main.1", c, cin, k, True, use_sn)
        cin = c
    for i, c in enumerate(widths, 1):
        _conv_spec(spec, f"ga{i}.conv.0", c // G_REDUCTION, 2 * c, 1, False, False)
        _conv_spec(spec, f"ga{i}.conv.2", c, c // G_REDUCTION, 1, False, False)
        _conv_spec(spec, f"ga{i}.fuse.0", c, 2 * c, 1, True, use_sn)
    for i, c in enumerate((cd * 8, cd * 4, cd * 2, cd), 1):
        _conv_spec(spec, f"upsample{i}.1.main.1", c, 2 * c, 1, True, use_sn)
        _conv_spec(spec, f"dec{i}.main.1", c, 2 * c, 3, True, use_sn)
    _conv_spec(spec, "dec5.0.main.1", cd, cd, 3, True, False)
    _conv_spec(spec, "dec5.1.main.1", 3, cd, 7, True, False)
    return spec


def d_spec(dd: int) -> Dict[str, Tuple[int, ...]]:
    spec: dict = {}
    cin = 3
    for i, (mult, k) in enumerate(D_STAGES, 1):
        _conv_spec(spec, f"d{i}.0.1", dd * mult, cin, k, True, True)
        _conv_spec(spec, f"d{i}_pred.0.1", 1, dd * mult, k, False, False)
        cin = dd * mult
    return spec


def vgg_spec() -> Dict[str, Tuple[int, ...]]:
    spec: dict = {}
    cin = 3
    for idx, c in VGG_CONVS:
        _conv_spec(spec, f"features.{idx}", c, cin, 3, True, False)
        cin = c
    return spec


# ---------------------------------------------------------------------------
# building blocks


def reflect_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """ReflectionPad2d(p) with numpy's ``mode="reflect"`` for pads as wide as
    the map (the discriminator's last stages at small sizes)."""
    if p == 0:
        return x
    h, w = x.shape[2], x.shape[3]
    if p < h and p < w:
        return F.pad(x, (p, p, p, p), mode="reflect")

    def idx(n):
        i = torch.arange(-p, n + p, device=x.device)
        if n == 1:
            return torch.zeros_like(i)
        m = torch.remainder(i, 2 * (n - 1))
        return torch.where(m > n - 1, 2 * (n - 1) - m, m)
    return x[:, :, idx(h)][:, :, :, idx(w)]


def l2normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def sn_weight(params: Params, state: Params, prefix: str, update: bool) -> torch.Tensor:
    """W / sigma for a spectrally normalized conv: with ``update`` one power
    iteration first (u and v written back to ``state``, no gradient), then
    sigma = u^T W v with the gradient through W only."""
    w = params[prefix + ".weight_orig"]
    mat = w.reshape(w.shape[0], -1)
    u, v = state[prefix + ".weight_u"], state[prefix + ".weight_v"]
    if update:
        with torch.no_grad():
            v = l2normalize(mat.detach().T @ u)
            u = l2normalize(mat.detach() @ v)
        state[prefix + ".weight_u"], state[prefix + ".weight_v"] = u, v
    sigma = torch.dot(u, mat @ v)
    return w / sigma


def conv_weight(params: Params, state: Params, prefix: str, update: bool) -> torch.Tensor:
    if prefix + ".weight_orig" in params:
        return sn_weight(params, state, prefix, update)
    return params[prefix + ".weight"]


def reflect_conv(nm: Numerics, x, w, b, stride: int = 1) -> torch.Tensor:
    k = w.shape[-1]
    return nm.conv(reflect_pad(x, (k - 1) // 2), w, b, stride)


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Non-affine, biased variance over H, W."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear resize with aligned corners (the reference's ``Interpolate``)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


# ---------------------------------------------------------------------------
# the generator


def gam(params: Params, state: Params, nm: Numerics, i: int, x: torch.Tensor,
        update: bool) -> torch.Tensor:
    """Global attention: the per-channel mean and unbiased std over H, W
    (eps inside the root) -> 1x1 squeeze, ReLU, 1x1 excite -> broadcast and
    concatenated with x -> 1x1 fuse conv -> instance norm."""
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=1)
    stats = torch.cat([mean, torch.sqrt(var + 1e-5)], dim=1)
    g = F.relu(nm.conv(stats, params[f"ga{i}.conv.0.weight"], None))
    g = nm.conv(g, params[f"ga{i}.conv.2.weight"], None)
    both = torch.cat([x, g.expand_as(x)], dim=1)
    w = conv_weight(params, state, f"ga{i}.fuse.0", update)
    return instance_norm(nm.conv(both, w, params[f"ga{i}.fuse.0.bias"]))


def g_forward(params: Params, state: Params, x_nhwc: torch.Tensor, nm: Numerics,
              train: bool = False) -> torch.Tensor:
    """Enhance x (N, H, W, 3) in [-1, 1] -> (N, H, W, 3) float32 in [-1, 1]:
    clip(x + tanh(head(U-Net(x))), -1, 1).  Under spectral norm ``train``
    advances each normalized conv's u and v by one power iteration."""
    x = x_nhwc.float().permute(0, 3, 1, 2)

    def block(prefix, h, stride):
        w = conv_weight(params, state, prefix, train)
        return leaky(reflect_conv(nm, h, w, params[prefix + ".bias"], stride))

    skips = []
    h = x
    for i in range(1, 6):
        h = block(f"enc{i}.main.1", h, 1 if i == 1 else 2)
        skips.append(h)
    y = gam(params, state, nm, 5, skips[4], train)
    for i in range(1, 5):
        u = upsample2x(y)
        p = f"upsample{i}.1.main.1"
        u = nm.conv(u, conv_weight(params, state, p, train), params[p + ".bias"])
        g = gam(params, state, nm, 5 - i, skips[4 - i], train)
        y = block(f"dec{i}.main.1", torch.cat([u, g], dim=1), 1)
    r = reflect_conv(nm, y * skips[0], params["dec5.0.main.1.weight"],
                     params["dec5.0.main.1.bias"])
    r = torch.tanh(reflect_conv(nm, r, params["dec5.1.main.1.weight"],
                                params["dec5.1.main.1.bias"]))
    return torch.clamp(r + x, -1.0, 1.0).permute(0, 2, 3, 1)


def quantize_u8(y_nhwc: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 as a saved PNG holds it: round(clip((y + 1) / 2) * 255)."""
    a = torch.clamp((y_nhwc.float() + 1.0) / 2.0, 0.0, 1.0)
    return torch.round(a * 255.0).to(torch.uint8)


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 -> float32 in [-1, 1]."""
    return (x_u8.float() / 255.0 - 0.5) / 0.5


@torch.no_grad()
def enhance_u8(params: Params, x_u8: torch.Tensor, block: int = 4) -> torch.Tensor:
    """uint8 NHWC in -> uint8 NHWC out through the float32 eval forward, ``block``
    images at a time; the stored u and v of a spectrally normalized G."""
    state = {k: v for k, v in params.items() if k.endswith(("weight_u", "weight_v"))}
    nm = Numerics("f32")
    with exact():
        return torch.cat([quantize_u8(g_forward(params, state, normalize_u8(x_u8[i:i + block]),
                                                nm)) for i in range(0, x_u8.shape[0], block)])


# ---------------------------------------------------------------------------
# the discriminator and VGG19


def d_forward(params: Params, state: Params, x_nhwc: torch.Tensor, nm: Numerics,
              train: bool = True) -> List[torch.Tensor]:
    """One forward of the multi-scale discriminator (rahinge: tanh heads):
    five stride-2 spectrally normalized stages, each with a one-channel head;
    in train mode each stage's u and v advance by one power iteration."""
    h = x_nhwc.float().permute(0, 3, 1, 2)
    preds = []
    for i in range(1, len(D_STAGES) + 1):
        w = sn_weight(params, state, f"d{i}.0.1", train)
        h = leaky(reflect_conv(nm, h, w, params[f"d{i}.0.1.bias"], 2))
        preds.append(torch.tanh(reflect_conv(nm, h, params[f"d{i}_pred.0.1.weight"], None)))
    return preds


def vgg_features(params: Params, x01_nhwc: torch.Tensor, nm: Numerics) -> Dict[str, torch.Tensor]:
    """torchvision VGG19 ``features`` to relu5_1 on ImageNet-normalized input;
    the relu{1..5}_1 taps."""
    mean = torch.tensor(IMAGENET_MEAN, device=x01_nhwc.device)
    std = torch.tensor(IMAGENET_STD, device=x01_nhwc.device)
    h = ((x01_nhwc.float() - mean) / std).permute(0, 3, 1, 2)
    out = {}
    for idx, _ in VGG_CONVS:
        if idx - 1 in VGG_POOLS:
            h = F.max_pool2d(h, 2, 2)
        h = F.relu(nm.conv(h, params[f"features.{idx}.weight"], params[f"features.{idx}.bias"],
                           padding=1))
        if idx in VGG_TAPS:
            out[VGG_TAPS[idx]] = h
    return out


def perceptual_loss(params: Params, x01: torch.Tensor, y01: torch.Tensor,
                    nm: Numerics) -> torch.Tensor:
    """Weighted MSE of the instance-normalized VGG taps; y01's branch carries
    no gradient."""
    fx = vgg_features(params, x01, nm)
    with torch.no_grad():
        fy = vgg_features(params, y01, nm)
    return sum(wt * ((instance_norm(fx[t]) - instance_norm(fy[t])) ** 2).mean()
               for t, wt in PERCEPTUAL_WEIGHTS.items())


def rahinge(real: List[torch.Tensor], fake: List[torch.Tensor], for_d: bool) -> torch.Tensor:
    """Relativistic average hinge loss, summed over the scales."""
    total = 0.0
    for r, f in zip(real, fake, strict=True):
        r_f, f_r = r - f.mean(), f - r.mean()
        if for_d:
            total = total + (F.relu(1.0 - r_f).mean() + F.relu(1.0 + f_r).mean()) / 2.0
        else:
            total = total + (F.relu(1.0 + r_f).mean() + F.relu(1.0 - f_r).mean()) / 2.0
    return total


def rec_loss(pred_nhwc: torch.Tensor, target_nhwc: torch.Tensor) -> torch.Tensor:
    """L1 at three scales of 2x2 average pooling, weights 1, 1/2, 1/4."""
    p, t = pred_nhwc.permute(0, 3, 1, 2).float(), target_nhwc.permute(0, 3, 1, 2).float()
    total = 0.0
    for i, wt in enumerate((1.0, 0.5, 0.25)):
        total = total + wt * (p - t).abs().mean()
        if i < 2:
            p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)
    return total
