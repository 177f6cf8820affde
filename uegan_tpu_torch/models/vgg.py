"""VGG19 feature extractor for the perceptual loss, counterpart of
uegan_tpu/models/vgg.py.

torchvision's VGG19 ``features`` trunk up to relu5_1 (index 29), tapped at
relu1_1, relu2_1, relu3_1, relu4_1 and relu5_1 (reference losses.py:30-34):
3x3 convs zero padded, ReLU, 2x2 max pools.  Its ``features.{idx}`` names
are torchvision's, so a torchvision ``vgg19`` state dict loads
(``load_torchvision``).  Without a weights file the trunk is seeded from a
``torch.Generator``, as the JAX package seeds its own; nothing is
downloaded.  The weights are frozen.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from uegan_tpu_torch.utils.cache import tensor_cache

# (name, torchvision features index, out channels), up to relu5_1
VGG19_CONVS = (
    ("conv1_1", 0, 64), ("conv1_2", 2, 64),
    ("conv2_1", 5, 128), ("conv2_2", 7, 128),
    ("conv3_1", 10, 256), ("conv3_2", 12, 256), ("conv3_3", 14, 256), ("conv3_4", 16, 256),
    ("conv4_1", 19, 512), ("conv4_2", 21, 512), ("conv4_3", 23, 512), ("conv4_4", 25, 512),
    ("conv5_1", 28, 512),
)
# the three convs of torchvision's trunk past the last tap, which a full
# torchvision or JAX VGG19 state holds and this trunk does not run
VGG19_TAIL = (("conv5_2", 30, 512), ("conv5_3", 32, 512), ("conv5_4", 34, 512))
POOLS = (4, 9, 18, 27)  # max pools before conv2_1 .. conv5_1
PERCEPTUAL_TAPS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@tensor_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    # made once per device, so that later calls copy nothing from the host
    # (a CUDA graph of the train step can capture them)
    with torch.inference_mode(False):
        return (torch.tensor(IMAGENET_MEAN, device=device),
                torch.tensor(IMAGENET_STD, device=device))


def normalize_imagenet(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3) -> ImageNet-normalized, f32 (reference losses.py:19-20)."""
    mean, std = _imagenet_stats(x01.device)
    return (x01.float() - mean) / std


class VGG19Features(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        layers = []
        cin = 3
        convs = {idx: cout for _, idx, cout in VGG19_CONVS}
        for idx in range(VGG19_CONVS[-1][1] + 2):
            if idx in convs:
                layers.append(nn.Conv2d(cin, convs[idx], 3, padding=1, device=device))
                cin = convs[idx]
            elif idx in POOLS:
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers.append(nn.ReLU())
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)

    @torch.no_grad()
    def seed(self, generator: torch.Generator) -> "VGG19Features":
        """He-normal weights N(0, 2 / fan_in) and zero biases from ``generator``."""
        for m in self.features:
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
                m.weight.copy_(w)
                m.bias.zero_()
        return self

    @torch.no_grad()
    def load_torchvision(self, state: Dict[str, torch.Tensor]) -> "VGG19Features":
        """Take the trunk's weights from a torchvision ``vgg19`` state dict."""
        self.load_state_dict({k: v for k, v in state.items() if k in self.state_dict()})
        return self

    def forward(self, x01: torch.Tensor,
                taps: Tuple[str, ...] = PERCEPTUAL_TAPS) -> Dict[str, torch.Tensor]:
        """x01 (N, H, W, 3) in [0, 1] -> {tap: (N, C, h, w) NCHW in ``dtype``}.
        Convs run in ``dtype``; the bias is added in ``dtype``, as in JAX."""
        h = normalize_imagenet(x01).permute(0, 3, 1, 2).to(self.dtype)
        out: Dict[str, torch.Tensor] = {}
        last = max(idx for name, idx, _ in VGG19_CONVS if "relu" + name[4:] in taps)
        for name, idx, _ in VGG19_CONVS:
            if idx > last:
                break
            if idx - 1 in POOLS:
                h = F.max_pool2d(h, 2, 2)
            conv = self.features[idx]
            h = F.conv2d(h, conv.weight.to(self.dtype), None, padding=1)
            h = F.relu(h + conv.bias.to(h.dtype).view(1, -1, 1, 1))
            tap = "relu" + name[4:]
            if tap in taps:
                out[tap] = h
        return out


def load_vgg_weights(path: Optional[str]) -> Optional[Dict[str, torch.Tensor]]:
    """A torchvision vgg19 state dict from ``path`` (a state dict or a
    pickled model), or None without a path."""
    if not path:
        return None
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:  # noqa: BLE001 - a whole pickled model, as torch.save(model) writes
        sd = torch.load(path, map_location="cpu", weights_only=False)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd
