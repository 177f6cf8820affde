"""uegan_tpu_torch: the PyTorch/CUDA port of uegan_tpu for NVIDIA Hopper.

The JAX package ``uegan_tpu`` stays the reference; this package mirrors its
module names and keeps its own copies of the host code it needs (config,
test loader).  It imports ``torch`` and never ``jax`` or ``uegan_tpu``.

- :mod:`uegan_tpu_torch.ops`      reflect-pad conv, norms, resize, and the
  hand-written CUDA kernels (``gam_stats``, ``resize2x``, ``s2d_fuse``)
  built from ``csrc/``
- :mod:`uegan_tpu_torch.models`   the generator and its blocks
- :mod:`uegan_tpu_torch.infer`    the packed (space-to-depth) inference path
- :mod:`uegan_tpu_torch.train`    the inference step and the Tester
- :mod:`uegan_tpu_torch.data`     the test-set loader
- :mod:`uegan_tpu_torch.metrics`  PSNR/SSIM in the reference's disk/CSV protocol
- :mod:`uegan_tpu_torch.convert`  flax generator variables -> torch state dict
- :mod:`uegan_tpu_torch.utils`    image IO, seeds, reference checkpoints
"""
