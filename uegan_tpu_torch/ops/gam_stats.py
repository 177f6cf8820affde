"""GAM statistics kernel: per-(N, C) mean and unbiased std over H*W.

Port of uegan_tpu/ops/pallas/gam_stats.py:gam_mean_std_pallas to a CUDA
kernel for Hopper (csrc/gam_stats.cu; the design note is in its header).
``gam_mean_std`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``plain``, the PyTorch version of the same
function.  ``gam_mean_std.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.norms import feature_mean_std as plain

# pass-1 blocks to aim for: a few waves of the card's 132 SMs
_TARGET_BLOCKS = 1024
_TILE_C = 32  # channels per pass-1 block, as in the .cu file


def split_plan(n: int, hw: int, c: int) -> Tuple[int, int]:
    """(splits, chunk): HW is cut into ``splits`` runs of ``chunk`` pixels so
    that the pass-1 grid holds about _TARGET_BLOCKS blocks."""
    base = n * -(-c // _TILE_C)
    want = max(1, min(hw, -(-_TARGET_BLOCKS // base)))
    chunk = -(-hw // want)
    return -(-hw // chunk), chunk


def gam_mean_std(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> mean, std each
    (N, 1, 1, C) in x.dtype; unbiased variance, eps inside the root."""
    _build.check_nhwc(x, "gam_mean_std")
    if x.device.type == "cpu":
        return plain(x, eps)
    n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"gam_mean_std: batch {n} exceeds the grid's 65535")
    splits, chunk = split_plan(n, h * w, c)
    lib = _build.load()
    with torch.cuda.device(x.device):
        part = torch.empty((n, splits, 2, c), dtype=torch.float32, device=x.device)
        mean = torch.empty((n, 1, 1, c), dtype=x.dtype, device=x.device)
        std = torch.empty_like(mean)
        err = lib.uegan_gam_stats(
            x.data_ptr(), part.data_ptr(), mean.data_ptr(), std.data_ptr(),
            _build.dtype_code(x), n, h * w, c, splits, chunk, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "gam_mean_std")
    gam_mean_std.launches += 1
    return mean, std


gam_mean_std.launches = 0
