"""Two-domain paired-by-index dataset.

The reference pairing contract (reference: data_loader.py:39-69): the
dataset root holds two (or more) subdirectories; the alphabetically first is
domain 1 ("exp" for train, "label" for val/test), the second is domain 2
("raw").  Both file lists are sorted (the reference's unsorted listdir order
was nondeterministic) and zipped index by index, truncating to the shorter
list.  The per-item name is the stem of the domain-2 file.

Images are decoded with PIL.  The JAX package decodes PNGs with OpenCV where
it is installed; PNG is lossless, so both give the same pixels.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Tuple

from PIL import Image

from uegan_tpu_torch.data.files import list_image_files


def decode_image(path) -> Image.Image:
    """Decode an image to a PIL RGB image."""
    with Image.open(str(path)) as im:
        return im.convert("RGB")


class PairedImageDataset:
    def __init__(self, root):
        self.root = str(root)
        self.samples = self._make_pairs(self.root)

    @staticmethod
    def _make_pairs(root) -> List[Tuple[Path, Path]]:
        domains = sorted(os.listdir(root))
        fnames: List[Path] = []
        fnames2: List[Path] = []
        for idx, domain in enumerate(domains):
            cls_files = sorted(list_image_files(os.path.join(root, domain)))
            if idx == 0:
                fnames += cls_files
            elif idx == 1:
                fnames2 += cls_files
        return list(zip(fnames, fnames2))

    def __len__(self) -> int:
        return len(self.samples)

    def name(self, index: int) -> str:
        """Image name = domain-2 stem (reference: data_loader.py:58-60)."""
        fname2 = str(self.samples[index][1])
        base = fname2.split(".", 1)[0]
        return base.rsplit("/", 1)[-1]

    def load_pair(self, index: int) -> Tuple[Image.Image, Image.Image, str]:
        f1, f2 = self.samples[index]
        return decode_image(f1), decode_image(f2), self.name(index)
