"""Kernel B, the align-corners x2 bilinear upsample (``csrc/upsample2x.cu``):
it reads x once and writes the 4x larger output (phase 7: 5 x)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("upsample2x_ac",)

OPS = {"upsample2x": lambda s, d: (5 * numel(s[0]) * itemsize(d[0]), 0, None)}
