"""PSNR in the reference's disk/CSV protocol, counterpart of
uegan_tpu/metrics/psnr.py:calc_psnr.

Generated PNGs are matched to ground truth by stripping the last two
'_'-separated fields of the stem; both get a 4-pixel border crop; PSNR is
10*log10(255^2 / MSE) in float64.  Per-image values go to
``PSNR_epoch_<epoch>.csv`` and the average is appended to
``PSNR_total_results_epoch_avgpsnr.csv``.  The average divides by N;
``legacy_average=True`` divides by N-1 as the reference does.

Images are read with Pillow in RGB and flipped to BGR, the channel order of
the reference's ``cv2.imread``, which the Y-channel formula assumes.
"""

from __future__ import annotations

import datetime
import glob
import os

import numpy as np

from uegan_tpu_torch.utils.image_io import read_png_rgb


def gt_name_from_generated(path: str) -> str:
    """'a4690-X_92.00_testFakeExp.png' -> 'a4690-X.png'."""
    base = os.path.splitext(os.path.basename(path))[0]
    return base.rsplit("_", 2)[0] + ".png"


def imread_bgr01(path: str) -> np.ndarray:
    """PNG -> HWC float64 BGR in [0, 1]."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return read_png_rgb(path)[:, :, ::-1].astype(np.float64) / 255.0


def bgr_to_y(img01: np.ndarray) -> np.ndarray:
    """MATLAB rgb2ycbcr Y channel of a [0,1] BGR image."""
    return (img01 @ np.asarray([24.966, 128.553, 65.481])) / 255.0 + 16.0 / 255.0


def disk_protocol(name: str, per_image, folder_gen: str, folder_gt: str,
                  result_save_path: str, epoch, crop_border: int = 4,
                  legacy_average: bool = False, verbose: bool = True) -> float:
    """Score every generated PNG against its ground truth with
    ``per_image(gen, gt)`` (cropped HWC float64 BGR [0, 1]) and write the
    reference's two CSVs: ``{name}_epoch_{epoch}.csv`` and the appended
    ``{name}_total_results_epoch_avg{name.lower()}.csv``."""
    os.makedirs(result_save_path, exist_ok=True)
    epoch_csv = os.path.join(result_save_path, f"{name}_epoch_{epoch}.csv")
    total_csv = os.path.join(result_save_path,
                             f"{name}_total_results_epoch_avg{name.lower()}.csv")
    img_list = sorted(glob.glob(os.path.join(folder_gen, "*")))
    total, n = 0.0, 0
    start = datetime.datetime.now()
    c = crop_border
    with open(epoch_csv, "w") as ef:
        ef.write(f"image_name,{name.lower()}\n")
        for i, img_path in enumerate(img_list):
            gt_name = gt_name_from_generated(img_path)
            gen = imread_bgr01(img_path)[c:-c, c:-c]
            gt = imread_bgr01(os.path.join(folder_gt, gt_name))[c:-c, c:-c]
            val = per_image(gen, gt)
            ef.write(f"{gt_name},{round(val, 6)}\n")
            total += val
            n += 1
            if verbose and i % 50 == 0:
                print(f"=== {name} is processing {i:>3d}-th image ===")
        denom = max(n - 1, 1) if legacy_average else max(n, 1)
        avg = total / denom
        ef.write(f"Average,{round(avg, 6)}\n")
    with open(total_csv, "a+") as tf:
        tf.write(f"{epoch},{round(avg, 6)}\n")
    if verbose:
        secs = (datetime.datetime.now() - start).seconds
        print(f"======= Complete the {name} test of {n:>3d} images, take {secs} seconds =======")
    return avg


def psnr_image(gen: np.ndarray, gt: np.ndarray) -> float:
    """PSNR of two [0, 1] float64 images on the 255 scale."""
    mse = np.mean((gt * 255.0 - gen * 255.0) ** 2, dtype=np.float64)
    return float("inf") if mse == 0 else float(10.0 * np.log10(255.0**2 / mse))


def calc_psnr(
    folder_gen: str,
    folder_gt: str,
    result_save_path: str,
    epoch,
    crop_border: int = 4,
    legacy_average: bool = False,
    test_y: bool = False,
    verbose: bool = True,
) -> float:
    if test_y:  # Y-channel mode, off by default as in the reference
        fn = lambda gen, gt: psnr_image(bgr_to_y(gen), bgr_to_y(gt))
    else:
        fn = psnr_image
    return disk_protocol("PSNR", fn, folder_gen, folder_gt, result_save_path, epoch,
                         crop_border, legacy_average, verbose)
