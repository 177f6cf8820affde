"""Host-side loaders: decode -> augment -> batch, with thread prefetch.

Counterpart of uegan_tpu/data/pipeline.py (reference data_loader.py:72-108):

- train: RandomCrop(image_size) -> Resize(resize_size^2, bilinear) -> random
  horizontal flip (p = .5) -> random vertical flip (p = .5) -> Normalize(0.5,
  0.5) to [-1, 1]; each image of the (exp, raw) pair draws its own
  randomness, from ``np.random.default_rng((seed, epoch, index, k))`` with k
  0 for exp and 1 for raw, and the epoch's order from
  ``np.random.default_rng((seed, epoch))``, as in the JAX package, so both
  packages give the same batches bit for bit;
- test/val: Resize(test_img_size^2, bilinear) then Normalize(0.5, 0.5);
  with ``keep_native`` (``--test_keep_aspect``) no resize: the images keep
  their native size, and batches group images of one (raw, label) size.

With ``emit="uint8"`` the normalize is skipped and uint8 batches are
yielded, so only 1-byte pixels cross to the device, which normalizes them
there (utils/image_io.py:normalize_u8).  One process; test batches follow
the dataset's sorted order, as the JAX Tester's unshuffled test loader does.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List

import numpy as np
from PIL import Image

from uegan_tpu_torch.data.dataset import PairedImageDataset


def _to_float_norm(img: Image.Image) -> np.ndarray:
    """HWC uint8 -> float32 in [-1, 1] (Normalize(0.5, 0.5))."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return (arr - 0.5) / 0.5


def _random_crop(img: Image.Image, size: int, rng: np.random.Generator) -> Image.Image:
    w, h = img.size
    if w == size and h == size:
        return img
    if w < size or h < size:
        # RandomCrop would raise; the JAX package reflect-pads up to the size
        # instead so that tiny fixtures work, and so does the port
        arr = np.asarray(img)
        ph, pw = max(0, size - h), max(0, size - w)
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        img = Image.fromarray(arr)
        w, h = img.size
    left = int(rng.integers(0, w - size + 1))
    top = int(rng.integers(0, h - size + 1))
    return img.crop((left, top, left + size, top + size))


def _train_transform(img: Image.Image, crop: int, resize: int, rng: np.random.Generator,
                     emit_uint8: bool = False) -> np.ndarray:
    img = _random_crop(img, crop, rng)
    img = img.resize((resize, resize), Image.BILINEAR)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    return np.asarray(img) if emit_uint8 else _to_float_norm(img)


def _test_transform(img: Image.Image, size: int, emit_uint8: bool = False) -> np.ndarray:
    img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img) if emit_uint8 else _to_float_norm(img)


def _native_transform(img: Image.Image, emit_uint8: bool = False) -> np.ndarray:
    """The keep_native test transform: no resize.  The pad to a multiple of
    16 happens on the enhance path (infer/native.py), so the saved outputs
    keep the native size."""
    return np.asarray(img) if emit_uint8 else _to_float_norm(img)


class _Loader:
    """Batched loader with thread prefetch.

    Yields dicts: img_exp (B,H,W,3) domain 1 (exp for train, the labels for
    test), img_raw the same for domain 2, img_name list[str], the Munch
    contract of the reference fetcher (reference: data_loader.py:124-129).
    A train loader shuffles each epoch and drops the short tail batch; a
    test loader keeps the order and yields the short tail.  A
    ``keep_native`` test loader yields native sizes, each batch of one size.
    """

    def __init__(self, dataset: PairedImageDataset, batch_size: int, image_size: int = 512,
                 num_threads: int = 4, prefetch: int = 2, emit: str = "float32",
                 train: bool = False, resize_size: int = 256, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 1990, keep_native: bool = False):
        if emit not in ("float32", "uint8"):
            raise ValueError(f"emit must be float32|uint8, got {emit!r}")
        if keep_native and train:
            raise ValueError("keep_native applies to test/val loaders only")
        self.dataset = dataset
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_threads = max(1, num_threads)
        self.prefetch = prefetch
        self.emit = emit
        self.train = train
        self.resize_size = resize_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.keep_native = keep_native
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx

    def _load_item(self, index: int, epoch: int) -> Dict:
        img1, img2, name = self.dataset.load_pair(index)
        u8 = self.emit == "uint8"
        if self.train:
            r1 = np.random.default_rng((self.seed, epoch, index, 0))
            r2 = np.random.default_rng((self.seed, epoch, index, 1))
            exp = _train_transform(img1, self.image_size, self.resize_size, r1, u8)
            raw = _train_transform(img2, self.image_size, self.resize_size, r2, u8)
        elif self.keep_native:
            exp, raw = _native_transform(img1, u8), _native_transform(img2, u8)
        else:
            exp = _test_transform(img1, self.image_size, u8)
            raw = _test_transform(img2, self.image_size, u8)
        return {"exp": exp, "raw": raw, "name": name}

    def _native_batches(self, order: np.ndarray) -> List[np.ndarray]:
        """Indices grouped by native (raw, label) size, read from the image
        headers without decoding, so that every batch stacks; the order
        within a group is kept."""
        groups: Dict[tuple, list] = {}
        for i in order:
            f1, f2 = self.dataset.samples[int(i)]
            with Image.open(f2) as im2, Image.open(f1) as im1:
                groups.setdefault((im2.size, im1.size), []).append(int(i))
        bs = self.batch_size
        return [np.asarray(idxs[j:j + bs]) for idxs in groups.values()
                for j in range(0, len(idxs), bs)]

    def __iter__(self) -> Iterator[Dict]:
        epoch = self.epoch
        self.epoch += 1
        order = self._epoch_order(epoch)
        bs = self.batch_size
        if self.keep_native:
            batches = self._native_batches(order)
        else:
            batches = [order[i:i + bs] for i in range(0, len(self) * bs, bs)]
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
                        items = list(pool.map(lambda i: self._load_item(int(i), epoch), b))
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


def get_train_loader(root, img_size: int = 512, resize_size: int = 256, batch_size: int = 8,
                     shuffle: bool = True, num_workers: int = 8, drop_last: bool = True,
                     seed: int = 1990, emit: str = "float32") -> _Loader:
    return _Loader(PairedImageDataset(root), batch_size=batch_size, image_size=img_size,
                   num_threads=num_workers, emit=emit, train=True, resize_size=resize_size,
                   shuffle=shuffle, drop_last=drop_last, seed=seed)


def get_test_loader(root, img_size: int = 512, batch_size: int = 8, num_workers: int = 4,
                    emit: str = "float32", keep_native: bool = False) -> _Loader:
    return _Loader(PairedImageDataset(root), batch_size=batch_size, image_size=img_size,
                   num_threads=num_workers, emit=emit, keep_native=keep_native)
