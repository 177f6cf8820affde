"""uegan_tpu_torch: the PyTorch/CUDA port of uegan_tpu for NVIDIA Hopper.

The JAX package ``uegan_tpu`` stays the reference; this package mirrors its
module names and keeps its own copies of the host code it needs (config,
test loader).  It imports ``torch`` and never ``jax`` or ``uegan_tpu``.

- :mod:`uegan_tpu_torch.ops`      reflect-pad conv, norms, resize, pooling,
  spectral norm, and the hand-written CUDA kernels (``gam_stats``,
  ``resize2x`` with their backward kernels, ``s2d_fuse``, ``packed_conv``,
  ``packed_conv_int8``) built from ``csrc/``
- :mod:`uegan_tpu_torch.models`   the generator, the discriminator, VGG19
- :mod:`uegan_tpu_torch.losses`   adversarial, perceptual, reconstruction
- :mod:`uegan_tpu_torch.infer`    the served generator, the inference step,
  the packed (space-to-depth) and int8 paths
- :mod:`uegan_tpu_torch.train`    the train step, pool, schedules, state, the
  Trainer and the Tester
- :mod:`uegan_tpu_torch.data`     the train and test loaders
- :mod:`uegan_tpu_torch.metrics`  PSNR/SSIM in the reference's disk/CSV protocol
- :mod:`uegan_tpu_torch.convert`  flax G, D and VGG variables -> torch state dicts
- :mod:`uegan_tpu_torch.utils`    image IO, seeds, the device and compute dtype,
  reading and writing reference checkpoints
"""
