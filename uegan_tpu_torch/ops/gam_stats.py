"""GAM statistics kernel: per-(N, C) mean and unbiased std over H*W.

Port of uegan_tpu/ops/pallas/gam_stats.py:gam_mean_std_pallas to a CUDA
kernel for Hopper (csrc/gam_stats.cu; the design note is in its header).
``gam_mean_std`` launches the kernel for a CUDA tensor and raises if it
cannot; for a CPU tensor it runs ``plain``, the PyTorch version of the same
function.  ``gam_mean_std.launches`` counts kernel launches.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import torch

from uegan_tpu_torch.ops import _build
from uegan_tpu_torch.ops.norms import feature_mean_std as plain

# as in the .cu file: threads a block, pixels a thread loads before adding,
# blocks an SM
THREADS = 256
UNROLL = 8
_BLOCKS_PER_SM = 2
# one wave of blocks on the card's 132 SMs
_TARGET_BLOCKS = _BLOCKS_PER_SM * 132
# groups of channels a block covers at most: 8 words of 16 bytes, so at least
# 32 pixels side by side and few partials for each tile's combine
_MAX_GROUPS = 8

_tickets: Dict[int, torch.Tensor] = {}  # per device: the combine's counters


class Plan(NamedTuple):
    """The kernel's partition of an (N, H*W, C) map: each thread reads
    ``vec`` channels as one word; a block covers ``groups`` groups of them
    (``tiles`` blocks across C) and runs ``rows`` = THREADS // groups pixels
    side by side; each image's pixels are cut into ``splits`` runs of
    ``chunk``."""
    vec: int
    groups: int
    tiles: int
    rows: int
    splits: int
    chunk: int


def load_width(c: int, itemsize: int, address: int) -> int:
    """Channels a thread reads as one word: the most, up to 16 bytes, that
    divide C and leave every pixel's first channel aligned to the word."""
    vec = 16 // itemsize
    while vec > 1 and (c % vec or address % (vec * itemsize)):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def split_plan(n: int, hw: int, c: int, itemsize: int, address: int = 0) -> Plan:
    """The launch plan for x (n, hw pixels, c) at ``address`` (mod 16): at most
    _TARGET_BLOCKS blocks where the map allows (a block past one wave would
    run alone in a second), each thread with at least UNROLL pixels."""
    vec = load_width(c, itemsize, address)
    words = c // vec
    tiles = -(-words // _MAX_GROUPS)
    groups = -(-words // tiles)
    rows = THREADS // groups
    want = _TARGET_BLOCKS // (n * tiles)
    most = max(1, hw // (rows * UNROLL))
    chunk = -(-hw // max(1, min(want, most)))
    return Plan(vec, groups, tiles, rows, -(-hw // chunk), chunk)


def _ticket(device: torch.device, count: int) -> torch.Tensor:
    """The device's zeroed counters, at least ``count``; the kernel leaves
    them zeroed, so they are allocated once per device (and again only to
    grow).  Calls on one device share them, so they run in stream order."""
    t = _tickets.get(device.index)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _tickets[device.index] = t
    return t


def gam_mean_std(x: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, H, W, C) contiguous, float32 or bfloat16 -> mean, std each
    (N, 1, 1, C) in x.dtype; unbiased variance, eps inside the root."""
    _build.check_nhwc(x, "gam_mean_std")
    if x.device.type == "cpu":
        return plain(x, eps)
    n, h, w, c = x.shape
    if n > 65535:
        raise ValueError(f"gam_mean_std: batch {n} exceeds the grid's 65535")
    p = split_plan(n, h * w, c, x.element_size(), x.data_ptr() % 16)
    lib = _build.load()
    with torch.cuda.device(x.device):
        ticket = _ticket(x.device, n * p.tiles)
        part = torch.empty((n, p.splits, 2, c), dtype=torch.float32, device=x.device)
        mean = torch.empty((n, 1, 1, c), dtype=x.dtype, device=x.device)
        std = torch.empty_like(mean)
        err = lib.uegan_gam_stats(
            x.data_ptr(), part.data_ptr(), ticket.data_ptr(), mean.data_ptr(), std.data_ptr(),
            _build.dtype_code(x), n, h * w, c, p.vec, p.groups, p.splits, p.chunk, eps,
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(lib, err, "gam_mean_std")
    gam_mean_std.launches += 1
    return mean, std


gam_mean_std.launches = 0
