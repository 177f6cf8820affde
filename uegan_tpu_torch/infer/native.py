"""Native-resolution enhancement, counterpart of uegan_tpu/infer/native.py:
reflect-pad to a bucketed multiple of 16, enhance, crop back.

The reference squashes every test image to ``test_img_size`` squared
(reference: data_loader.py:95-101, tester.py:41-103).  ``--test_keep_aspect``
keeps the native size instead.  The generator is fully convolutional, but
its four stride-2 stages need H and W divisible by 16, so each batch is
reflect-padded at the bottom and right up to a bucketed size, enhanced (the
packed route takes the exact strip executor for large inputs:
infer/packed.py:make_fast_eval) and cropped back.

Bucketing (``round_up``): padded sizes round up to a multiple of ``bucket``
(default 64), so a folder of mixed photo sizes runs O(sizes / 64) distinct
shapes; the bucket is linear because a conv's cost grows with the area.
Reflect padding keeps the border statistics natural; the pad is cropped
away, but the kept pixels near the seam do see it (the receptive field
crosses it), as in every pad-and-crop pipeline.  Host numpy, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np


def round_up(n: int, bucket: int = 64, mult: int = 16) -> int:
    """The least multiple of ``bucket`` that is >= n, or of ``mult`` when
    ``bucket`` is not a multiple of ``mult``."""
    step = bucket if bucket % mult == 0 else mult
    return -(-n // step) * step


def pad_to_grid(batch: np.ndarray, bucket: int = 64) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Reflect-pad an NHWC batch at the bottom and right to the bucketed
    size.  Returns (padded, (H, W) native size).  A pad wider than the image
    is applied as a chain of reflect pads (numpy's reflect takes at most
    dim - 1 at a time)."""
    _, h, w, _ = batch.shape
    ph, pw = round_up(h, bucket) - h, round_up(w, bucket) - w
    out = np.asarray(batch)
    while ph > 0 or pw > 0:
        dh, dw = min(ph, out.shape[1] - 1), min(pw, out.shape[2] - 1)
        out = np.pad(out, ((0, 0), (0, dh), (0, dw), (0, 0)), mode="reflect")
        ph -= dh
        pw -= dw
    return out, (h, w)


def crop_back(batch: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Crop the padded enhancement back to the native size."""
    h, w = hw
    return batch[:, :h, :w]


def enhance_native(enhance_fn: Callable[[np.ndarray], np.ndarray], batch: np.ndarray,
                   bucket: int = 64) -> np.ndarray:
    """Run ``enhance_fn`` (a same-shape NHWC batch enhancer, such as
    Tester.enhance_u8) at native resolution: pad, enhance, crop."""
    padded, hw = pad_to_grid(np.asarray(batch), bucket)
    return crop_back(np.asarray(enhance_fn(padded)), hw)
