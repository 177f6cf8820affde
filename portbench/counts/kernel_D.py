"""Kernel D, the packed forward's exit (``csrc/s2d_fuse.cu:residual_tail_d2s``):
it reads the residual and the packed input and writes the clipped sum,
depth-to-space (phase 7: 3 x the residual)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("residual_tail_d2s_kernel",)

OPS = {"residual_tail_d2s": lambda s, d: (3 * numel(s[0]) * itemsize(d[0]), 0, None)}
