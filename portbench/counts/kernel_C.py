"""Kernel C, the packed forward's entry (``csrc/s2d_fuse.cu:s2d_convert``):
it reads the float32 image once and writes it space-to-depth packed in
bfloat16, the output dtype every caller of the port asks for (phase 7:
4 + 2 bytes an element)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("s2d_convert_kernel",)

OPS = {"s2d_convert": lambda s, d: (numel(s[0]) * (itemsize(d[0]) + 2), 0, None)}
