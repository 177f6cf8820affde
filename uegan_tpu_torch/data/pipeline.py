"""Host-side test loader: decode -> resize -> batch, with thread prefetch.

The test/val transform of the reference (reference: data_loader.py:95-101):
Resize(test_img_size^2, bilinear) then Normalize(0.5, 0.5) to [-1, 1].  With
``emit="uint8"`` the normalize is skipped and uint8 batches are yielded, so
only 1-byte pixels cross to the device, which normalizes them there
(utils/image_io.py:normalize_u8).  One process; batches follow the
dataset's sorted order, as the JAX Tester's unshuffled test loader does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator

import numpy as np
from PIL import Image

from uegan_tpu_torch.data.dataset import PairedImageDataset


def _to_float_norm(img: Image.Image) -> np.ndarray:
    """HWC uint8 -> float32 in [-1, 1] (Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


def _test_transform(img: Image.Image, size: int, emit_uint8: bool = False) -> np.ndarray:
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img) if emit_uint8 else _to_float_norm(img)


class _Loader:
    """Batched test loader with thread prefetch.

    Yields dicts: img_exp (B,H,W,3) domain 1 (the labels), img_raw the same
    for domain 2, img_name list[str], the Munch contract of the reference
    fetcher (reference: data_loader.py:124-129).  The tail batch is short.
    """

    def __init__(self, dataset: PairedImageDataset, batch_size: int, image_size: int = 512,
                 num_threads: int = 4, prefetch: int = 2, emit: str = "float32"):
        if emit not in ("float32", "uint8"):
            raise ValueError(f"emit must be float32|uint8, got {emit!r}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.emit = emit

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _load_item(self, index: int) -> Dict:
        img1, img2, name = self.dataset.load_pair(index)
        u8 = self.emit == "uint8"
        return {"exp": _test_transform(img1, self.image_size, u8),
                "raw": _test_transform(img2, self.image_size, u8), "name": name}

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n)) for i in range(0, n, self.batch_size)]
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # the last item is None at the end of the data, or the error that
            # stopped it: an unreadable image fails the run, not shortens it
            end = None
            try:
                with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self._load_item, b))
                        q.put({"img_exp": np.stack([it["exp"] for it in items]),
                               "img_raw": np.stack([it["raw"] for it in items]),
                               "img_name": [it["name"] for it in items]})
            except Exception as exc:  # noqa: BLE001 - handed to the consumer
                end = exc
            finally:
                q.put(end)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()


def get_test_loader(root, img_size: int = 512, batch_size: int = 8, num_workers: int = 4,
                    emit: str = "float32") -> _Loader:
    return _Loader(PairedImageDataset(root), batch_size=batch_size, image_size=img_size,
                   num_threads=num_workers, emit=emit)
