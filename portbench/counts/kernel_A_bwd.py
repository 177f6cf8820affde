"""Kernel A', A's backward (``csrc/gam_stats_bwd.cu``): it reads x, the
incoming mean and std gradients and the float32 mean and variance, and
writes dx (phase 7: 2 x + 4 N C items + 2 N C float32 words)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("gam_stats_bwd_kernel",)


def _bwd(shapes, dtypes):
    n, _, _, c = shapes[0]
    es = itemsize(dtypes[0])
    return 2 * numel(shapes[0]) * es + 4 * n * c * es + 2 * n * c * 4, 0, None


OPS = {"gam_mean_std_backward": _bwd}
