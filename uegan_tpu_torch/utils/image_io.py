"""Image IO and the u8 normalize / quantize, counterpart of
uegan_tpu/utils/image_io.py.

PNGs are written with torchvision ``save_image`` rounding
(round(x * 255) after clamping), which is part of the reference's metric
protocol.  ``normalize_u8`` and ``quantize_u8`` run on the tensor's device
with the op sequences of uegan_tpu/data/pipeline.py:device_normalize and
uegan_tpu/utils/image_io.py:device_quantize_u8, so only 1-byte pixels
cross to and from the card.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from PIL import Image


def to_uint8(img01: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 with save_image rounding; uint8 passes through."""
    img01 = np.asarray(img01)
    if img01.dtype == np.uint8:
        return img01
    return np.clip(np.rint(img01.astype(np.float32) * 255.0), 0, 255).astype(np.uint8)


def normalize_u8(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1] (Normalize(0.5, 0.5)); floats pass through."""
    if x.dtype != torch.uint8:
        return x
    a = x.float() / 255.0
    return (a - 0.5) / 0.5


def quantize_u8(y: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> PNG-ready uint8: clip((y + 1) / 2, 0, 1), then rint(* 255)."""
    a = torch.clamp((y.float() + 1.0) / 2.0, 0.0, 1.0)
    return torch.clamp(torch.round(a * 255.0), 0.0, 255.0).to(torch.uint8)


def save_image(img01: np.ndarray, path: str) -> None:
    """Save one HWC image ([0,1] float or uint8) as PNG."""
    Image.fromarray(to_uint8(img01)).save(path, format="PNG")


def save_image_grid(imgs01: Sequence[np.ndarray], path: str, axis: int = 1) -> None:
    """Concatenate HWC images along width and save: the reference's
    side-by-side compare panels."""
    save_image(np.concatenate([np.asarray(i) for i in imgs01], axis=axis), path)


def read_png_rgb(path: str) -> np.ndarray:
    """PNG -> HWC uint8 RGB."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
