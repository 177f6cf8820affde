"""Where the port runs and in which compute dtype: ``UEGAN_TORCH_DEVICE``
and the dtypes the port's kernels take."""

from __future__ import annotations

import os
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``UEGAN_TORCH_DEVICE`` (default ``cuda``) -> torch.device; raises when
    a CUDA device is requested and none is present."""
    device = torch.device(name or os.environ.get("UEGAN_TORCH_DEVICE") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "set UEGAN_TORCH_DEVICE=cpu to run the plain PyTorch versions on the CPU")
    return device


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute dtype [{name}]: the port's kernels take float32 and bfloat16")
    return DTYPES[name]
