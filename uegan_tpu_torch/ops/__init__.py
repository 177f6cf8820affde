"""Convolutions, norms, resizes and the hand-written CUDA kernels.

Importing this package registers every kernel as a ``torch.library`` custom
op in the ``uegan_torch`` namespace (ops/_build.py:custom_op), which is what
a program exported by tools/export_model.py needs to load.
"""

from uegan_tpu_torch.ops import gam_stats, packed_conv, packed_conv_int8, resize2x, s2d_fuse

__all__ = ["gam_stats", "packed_conv", "packed_conv_int8", "resize2x", "s2d_fuse"]
