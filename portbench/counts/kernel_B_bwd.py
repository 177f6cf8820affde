"""Kernel B', B's backward (``csrc/upsample2x.cu:upsample2x_bwd_kernel``): it
reads dy and writes the 4x smaller dx (phase 7: dy + dy / 4)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("upsample2x_bwd_kernel",)


def _bwd(shapes, dtypes):
    dy = numel(shapes[0]) * itemsize(dtypes[0])
    return dy + dy // 4, 0, None


OPS = {"upsample2x_backward": _bwd}
