"""uegan_tpu_torch: the PyTorch/CUDA port of uegan_tpu for NVIDIA Hopper.

The JAX package ``uegan_tpu`` stays the reference; this package mirrors its
module names and imports its JAX-free host modules (config, test loader,
checkpoint name map).  It imports ``torch`` and never ``jax``.

- :mod:`uegan_tpu_torch.ops`      reflect-pad conv, norms, resize, and the
  hand-written CUDA kernels (``gam_stats``, ``resize2x``) built from ``csrc/``
- :mod:`uegan_tpu_torch.models`   the generator and its blocks
- :mod:`uegan_tpu_torch.train`    the inference step and the Tester
- :mod:`uegan_tpu_torch.metrics`  PSNR/SSIM in the reference's disk/CSV protocol
- :mod:`uegan_tpu_torch.convert`  flax generator variables -> torch state dict
- :mod:`uegan_tpu_torch.utils`    image IO, seeds, reference checkpoints
"""
