"""SSIM in the reference's disk/CSV protocol, counterpart of
uegan_tpu/metrics/ssim.py:calc_ssim.

The reference computes skimage ``structural_similarity(multichannel=True,
data_range=255)`` after a 4-px border crop: a 7x7 uniform window, K1 0.01,
K2 0.03, covariances scaled by NP/(NP-1) with NP = 49, the map averaged over
the valid region of each channel and then over channels.  A stride-1 7x7
average pool is that uniform filter over the valid region.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from uegan_tpu_torch.metrics.psnr import disk_protocol


def ssim_batch(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0,
               win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Per-image SSIM of NHWC batches in f32 -> (N,)."""
    x = pred.float().permute(0, 3, 1, 2)
    y = target.float().permute(0, 3, 1, 2)
    mean = lambda t: F.avg_pool2d(t, win_size, stride=1)
    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1.0)
    ux, uy = mean(x), mean(y)
    vx = cov_norm * (mean(x * x) - ux * ux)
    vy = cov_norm * (mean(y * y) - uy * uy)
    vxy = cov_norm * (mean(x * y) - ux * uy)
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
