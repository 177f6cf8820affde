"""Determinism plumbing, counterpart of uegan_tpu/utils/seed.py.

Seeds the host RNGs the input pipeline uses and returns a ``torch.Generator``
for everything the port draws itself; the global torch RNG is left alone.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup_seed(seed: int) -> torch.Generator:
    np.random.seed(seed)
    random.seed(seed)
    return torch.Generator().manual_seed(seed)
