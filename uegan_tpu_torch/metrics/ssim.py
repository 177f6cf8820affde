"""SSIM in the reference's disk/CSV protocol, counterpart of
uegan_tpu/metrics/ssim.py:calc_ssim.

The reference computes skimage ``structural_similarity(multichannel=True,
data_range=255)`` after a 4-px border crop: a 7x7 uniform window, K1 0.01,
K2 0.03, covariances scaled by NP/(NP-1) with NP = 49, the map averaged over
the valid region of each channel and then over channels.  As in the JAX
package, that uniform filter over the valid region is a depthwise VALID
conv with weights 1/49, run in f32 with TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.metrics.psnr import disk_protocol
from uegan_tpu_torch.ops.conv import exact_f32


def ssim_batch(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
               win_size: int = 7, k1: float = 0.01, k2: float = 0.03,
               crop_border: int = 0) -> torch.Tensor:
    """Per-image SSIM of NHWC batches in f32 -> (N,)."""
    if crop_border > 0:
        c = crop_border
        pred = pred[:, c:-c, c:-c, :]
        target = target[:, c:-c, c:-c, :]
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    c = x.shape[1]
    np_win = win_size * win_size
    kernel = torch.full((c, 1, win_size, win_size), 1.0 / np_win, device=x.device)
    mean = lambda t: F.conv2d(t, kernel, groups=c)
    cov_norm = np_win / (np_win - 1.0)
    with exact_f32(torch.float32):
        ux, uy = mean(x), mean(y)
        uxx, uyy, uxy = mean(x * x), mean(y * y), mean(x * y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux**2 + uy**2 + c1) * (vx + vy + c2))
    return s.mean(dim=(1, 2, 3))


def ssim_image(gen: np.ndarray, gt: np.ndarray) -> float:
    """SSIM of two [0, 1] float64 HWC images on the 255 scale, in f32."""
    a = torch.from_numpy((gt * 255.0).astype(np.float32)[None])
    b = torch.from_numpy((gen * 255.0).astype(np.float32)[None])
    return float(ssim_batch(a, b)[0])


def calc_ssim(
    folder_gen: str,
    folder_gt: str,
    result_save_path: str,
    epoch,
    crop_border: int = 4,
    legacy_average: bool = False,
    verbose: bool = True,
) -> float:
    return disk_protocol("SSIM", ssim_image, folder_gen, folder_gt, result_save_path, epoch,
                         crop_border, legacy_average, verbose)
