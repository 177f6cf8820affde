"""NIMA scoring in the reference's disk/CSV protocol, counterpart of
uegan_tpu/metrics/nima.py.

Every image in a folder is resized (short side 256, PIL bilinear) and
centre-cropped to 224 on the host, scored on the model's device in chunks,
and ``NIMA_epoch_<epoch>__mean_std.csv`` records each image's mean and std
(6 decimals) with an ``Average`` row; the average is appended to
``NIMA_total_results_epoch_mean_std.csv``.  The average divides by N;
``legacy_average=True`` divides by N-1 as the reference does.  Rows are
independent in eval mode, so the last chunk is scored at its own size.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from uegan_tpu_torch.models.nima import NIMA, load_nima_pth, score_stats
from uegan_tpu_torch.utils.device import DTYPES, resolve_device


def prepare_image_np(image: Image.Image) -> np.ndarray:
    """Resize(short side 256) -> CenterCrop(224) -> [0,1] float32 HWC, no
    normalization."""
    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    if w <= h:
        nw, nh = 256, max(1, round(256 * h / w))
    else:
        nh, nw = 256, max(1, round(256 * w / h))
    image = image.resize((nw, nh), Image.BILINEAR)
    left = (nw - 224) // 2
    top = (nh - 224) // 2
    image = image.crop((left, top, left + 224, top + 224))
    return np.asarray(image, dtype=np.float32) / 255.0


def load_images(folder: str, names) -> np.ndarray:
    """The prepared (N, 224, 224, 3) batch of ``names`` under ``folder``."""
    arrs = []
    for name in names:
        with Image.open(os.path.join(folder, name)) as im:
            arrs.append(prepare_image_np(im))
    return np.stack(arrs)


def nima_scores(model: NIMA, batch01) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score a (N, 224, 224, 3) [0, 1] batch (numpy or tensor) with a model
    in eval mode, on its device -> (means, stds)."""
    device = next(model.parameters()).device
    x = batch01 if torch.is_tensor(batch01) else torch.from_numpy(np.asarray(batch01))
    with torch.inference_mode():
        return score_stats(model(x.to(device)))


def init_nima(weights_path: str = "", rng_seed: int = 0, compute_dtype: str = "float32",
              device=None) -> NIMA:
    """NIMA in eval mode on ``device`` (default: the ``UEGAN_TORCH_DEVICE``
    rule), with the reference ``.pth`` at ``weights_path`` when it exists,
    else seeded from ``rng_seed``.  ``compute_dtype`` float32 (the default
    here, for reference numerics) or bfloat16 (``Config.nima_dtype``'s
    default): parameters, BN statistics and the softmax stay f32."""
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, got {compute_dtype!r}")
    if device is None:
        device = resolve_device()
    model = NIMA(dtype=DTYPES[compute_dtype])
    if weights_path and os.path.exists(weights_path):
        model.load_reference(load_nima_pth(weights_path))
    else:
        model.seed(torch.Generator().manual_seed(rng_seed))
    return model.to(device).eval()


def calc_nima(
    img_path: str,
    result_save_path: str,
    epoch,
    weights_path: str = "",
    batch_size: int = 16,
    legacy_average: bool = False,
    verbose: bool = True,
    compute_dtype: str = "float32",
    model: Optional[NIMA] = None,
) -> float:
    """Score every image under ``img_path`` with ``model`` (built by
    ``init_nima(weights_path, compute_dtype=compute_dtype)`` when None) and
    write the two CSVs; returns the average mean score."""
    os.makedirs(result_save_path, exist_ok=True)
    epoch_csv = os.path.join(result_save_path, f"NIMA_epoch_{epoch}__mean_std.csv")
    total_csv = os.path.join(result_save_path, "NIMA_total_results_epoch_mean_std.csv")
    if model is None:
        model = init_nima(weights_path, compute_dtype=compute_dtype)

    test_imgs = sorted(os.listdir(img_path))
    total_mean, total_std, n = 0.0, 0.0, 0
    with open(epoch_csv, "w") as ef:
        ef.write("image_name,mean,std\n")
        for i in range(0, len(test_imgs), batch_size):
            chunk = test_imgs[i : i + batch_size]
            means, stds = nima_scores(model, load_images(img_path, chunk))
            means, stds = means.cpu().numpy(), stds.cpu().numpy()
            for j, fname in enumerate(chunk):
                ef.write(f"{fname},{round(float(means[j]), 6)},{round(float(stds[j]), 6)}\n")
                total_mean += float(means[j])
                total_std += float(stds[j])
                n += 1
            if verbose and (i // batch_size) % 4 == 0:
                print(f"=== NIMA is processing {i:>3d}-th image ===")
        denom = max(n - 1, 1) if legacy_average else max(n, 1)
        avg_mean = total_mean / denom
        avg_std = total_std / denom
        ef.write(f"Average,{round(avg_mean, 6)},{round(avg_std, 6)}\n")
    with open(total_csv, "a+") as tf:
        tf.write(f"{epoch},{round(avg_mean, 6)},{round(avg_std, 6)}\n")
    if verbose:
        print(f"======= Complete the NIMA test of {n:>3d} images =======")
    return avg_mean
