"""Overlap-tile high-resolution inference with feathered stitching,
counterpart of uegan_tpu/infer/tiles.py.

The image is covered with overlapping tiles, each tile runs through the
generator, and the outputs are blended with a linear feathering window over
the overlap so that the seams vanish.  The GAMs' global mean and std become
per-tile statistics here, an approximation; the exact high-resolution path
is the strip executor (infer/strips.py).  The reference had no
high-resolution path (it resized everything to 512 px, reference:
data_loader.py:95-101).

:func:`enhance_tiled` stitches on the host in numpy (tile batches of 8, the
last one padded with zero tiles); :func:`make_device_tiled_enhancer` cuts,
enhances and stitches on the tensor's device and hands back one image.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from uegan_tpu_torch.ops.conv import reflect_indices

TILE_BATCH = 8


def _starts(full: int, tile: int, stride: int) -> List[int]:
    if full <= tile:
        return [0]
    s = list(range(0, full - tile, stride))
    s.append(full - tile)
    return s


def _feather_window(tile: int, overlap: int) -> np.ndarray:
    w = np.ones(tile, np.float32)
    if overlap > 0:
        ramp = (np.arange(overlap, dtype=np.float32) + 1.0) / (overlap + 1.0)
        w[:overlap] = ramp
        w[-overlap:] = ramp[::-1]
    return w


def _grid(h: int, w: int, tile: int, overlap: int) -> Tuple[List[int], List[int]]:
    if tile % 16:
        raise ValueError(f"tile size {tile} must be divisible by 16")
    stride = tile - 2 * overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} too large for tile size {tile}")
    return _starts(max(h, tile), tile, stride), _starts(max(w, tile), tile, stride)


def enhance_tiled(enhance_batch: Callable[[np.ndarray], np.ndarray], image: np.ndarray,
                  tile: int = 512, overlap: int = 32) -> np.ndarray:
    """Enhance one HWC [-1, 1] image of any size: ``enhance_batch`` maps an
    NHWC [-1, 1] batch to its enhancement.  The image is reflect-padded up
    to one tile where it is smaller."""
    h, w, c = image.shape
    ys, xs = _grid(h, w, tile, overlap)
    ph, pw = max(0, tile - h), max(0, tile - w)
    if ph or pw:
        image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    tiles = np.stack([image[y:y + tile, x:x + tile] for y in ys for x in xs])
    outs = []
    for i in range(0, len(tiles), TILE_BATCH):
        chunk = tiles[i:i + TILE_BATCH]
        if len(chunk) < TILE_BATCH and len(tiles) > TILE_BATCH:
            pad = np.zeros((TILE_BATCH - len(chunk), tile, tile, c), tiles.dtype)
            outs.append(np.asarray(enhance_batch(np.concatenate([chunk, pad])))[:len(chunk)])
        else:
            outs.append(np.asarray(enhance_batch(chunk)))
    outs = np.concatenate(outs)

    fw = _feather_window(tile, overlap)
    win = (fw[:, None] * fw[None, :])[..., None]
    acc = np.zeros(image.shape[:2] + (c,), np.float32)
    wacc = np.zeros(image.shape[:2] + (1,), np.float32)
    for k, (y, x) in enumerate((y, x) for y in ys for x in xs):
        acc[y:y + tile, x:x + tile] += outs[k] * win
        wacc[y:y + tile, x:x + tile] += win
    return (acc / np.maximum(wacc, 1e-8))[:h, :w]


def make_device_tiled_enhancer(enhance_batch: Callable[[torch.Tensor], torch.Tensor],
                               image_hw: Tuple[int, int], tile: int = 512,
                               overlap: int = 32) -> Callable[[torch.Tensor], torch.Tensor]:
    """The tile-and-stitch on the device, for one image size: ``fn(image)``
    takes an (H, W, 3) [-1, 1] tensor, cuts every tile, enhances them in one
    call of ``enhance_batch`` (NHWC -> NHWC, such as the canonical eval step),
    and blends them in float32 with the same window as
    :func:`enhance_tiled`, on the image's device."""
    h, w = image_hw
    ys, xs = _grid(h, w, tile, overlap)
    fw = torch.from_numpy(_feather_window(tile, overlap))
    win_np = (fw[:, None] * fw[None, :])[..., None]

    def fn(image: torch.Tensor) -> torch.Tensor:
        img = image
        ph, pw = max(0, tile - h), max(0, tile - w)
        if ph or pw:  # numpy's reflect, as np.pad takes it, for any pad
            img = img[reflect_indices(h, ph, img.device)[ph:]]
            img = img[:, reflect_indices(w, pw, img.device)[pw:]]
        win = win_np.to(img.device)
        tiles = torch.stack([img[y:y + tile, x:x + tile] for y in ys for x in xs])
        outs = enhance_batch(tiles).float() * win
        acc = img.new_zeros(img.shape[:2] + (3,), dtype=torch.float32)
        wacc = img.new_zeros(img.shape[:2] + (1,), dtype=torch.float32)
        for k, (y, x) in enumerate((y, x) for y in ys for x in xs):
            acc[y:y + tile, x:x + tile] += outs[k]
            wacc[y:y + tile, x:x + tile] += win
        return (acc / torch.clamp(wacc, min=1e-8))[:h, :w]

    return fn
