"""Fake-image history pool, counterpart of uegan_tpu/train/image_pool.py:pool_query.

The reference ImagePool (reference utils.py:23-50), per image: while the
pool is not full, insert the image and return it; after that, with
probability 1/2 swap it with a uniformly drawn slot and return the evicted
image, else return the image itself.  Later images of a batch can evict
earlier ones, so the images are taken in order.  The pool lives on the
device and nothing of it crosses to the host: whether it is full is a count
the host knows, and the draws (one uniform and one slot a image, from an
explicit ``torch.Generator``) stay on the device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


class ImagePool:
    def __init__(self, pool_size: int, image_shape: Tuple[int, int, int],
                 device=None, generator: Optional[torch.Generator] = None):
        self.pool_size = pool_size
        self.images = torch.zeros((max(pool_size, 1),) + tuple(image_shape),
                                  dtype=torch.float32, device=device)
        self.count = 0
        self.generator = generator

    def draws(self, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(uniforms (b,), slots (b,)) for one query of b images."""
        dev = self.images.device
        p = torch.rand((b,), generator=self.generator, device=dev)
        slot = torch.randint(0, max(self.pool_size, 1), (b,), generator=self.generator,
                             device=dev)
        return p, slot

    def query(self, batch: torch.Tensor,
              draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """batch (B, H, W, C) -> the returned batch, float32; updates the pool
        in place.  ``draws`` defaults to ``self.draws(B)``; no gradient flows."""
        batch = batch.detach()
        if self.pool_size == 0:
            return batch.float()
        p, slot = self.draws(batch.shape[0]) if draws is None else draws
        out = []
        for i in range(batch.shape[0]):
            img = batch[i:i + 1].float()
            if self.count < self.pool_size:
                self.images[self.count:self.count + 1] = img
                self.count += 1
                out.append(img)
                continue
            s = slot[i:i + 1]
            old = self.images.index_select(0, s)
            swap = p[i] > 0.5
            out.append(torch.where(swap, old, img))
            self.images.index_copy_(0, s, torch.where(swap, img, old))
        return torch.cat(out)
