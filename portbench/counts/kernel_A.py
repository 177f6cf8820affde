"""Kernel A, the GAM's per-channel mean and std (``csrc/gam_stats.cu``): it
reads x once and writes the (N, C) mean and std; under autograd it also
writes the float32 mean and variance that A' reads (the phase 7 count of
``chip_smoke.py``: x + 2 N C items)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("gam_stats_kernel",)


def _stats(shapes, dtypes, keep32: bool):
    n, _, _, c = shapes[0]
    es = itemsize(dtypes[0])
    return numel(shapes[0]) * es + 2 * n * c * es + (2 * n * c * 4 if keep32 else 0), 0, None


OPS = {"gam_mean_std": lambda s, d: _stats(s, d, False),
       "gam_mean_std_train": lambda s, d: _stats(s, d, True)}
