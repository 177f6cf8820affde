"""AVA dataset handling for NIMA training, counterpart of
uegan_tpu/nima_train/dataset.py (a copy: the same files, splits and, for a
seed, the same batches).

The AVA.txt label file holds, per image, an id and 10 score-bucket counts;
cleaning drops entries whose image file is missing or corrupt and splits
train/val/test; the dataset yields (image, normalized 10-bucket
distribution).
"""

from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from uegan_tpu_torch.metrics.nima import prepare_image_np


def parse_ava_txt(path: str) -> List[Tuple[str, np.ndarray]]:
    """AVA.txt rows: idx image_id s1..s10 tag tag challenge -> (id, counts)."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 12:
                continue
            image_id = parts[1]
            counts = np.asarray([float(x) for x in parts[2:12]], np.float32)
            out.append((image_id, counts))
    return out


def clean_and_split(
    ava_txt: str,
    image_dir: str,
    out_dir: str,
    val_frac: float = 0.1,
    test_frac: float = 0.05,
    seed: int = 1990,
) -> Tuple[str, str, str]:
    """Drop missing/corrupt images, split, write {train,val,test}.csv."""
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    for image_id, counts in parse_ava_txt(ava_txt):
        p = os.path.join(image_dir, f"{image_id}.jpg")
        if not os.path.exists(p):
            p = os.path.join(image_dir, f"{image_id}.png")
            if not os.path.exists(p):
                continue
        try:
            with Image.open(p) as im:
                im.verify()
        except Exception:
            continue
        entries.append((p, counts))
    rng = np.random.default_rng(seed)
    rng.shuffle(entries)
    n = len(entries)
    n_test = int(n * test_frac)
    n_val = int(n * val_frac)
    splits = {
        "test": entries[:n_test],
        "val": entries[n_test : n_test + n_val],
        "train": entries[n_test + n_val :],
    }
    paths = []
    for name in ("train", "val", "test"):
        csv_path = os.path.join(out_dir, f"{name}.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["path"] + [f"s{i}" for i in range(1, 11)])
            for p, counts in splits[name]:
                w.writerow([p] + [str(c) for c in counts])
        paths.append(csv_path)
    return tuple(paths)  # type: ignore[return-value]


class AVADataset:
    """CSV-backed dataset yielding (image01 HWC, target distribution)."""

    def __init__(self, csv_path: str, train: bool = True, size: int = 224, seed: int = 0):
        self.rows: List[Tuple[str, np.ndarray]] = []
        with open(csv_path) as f:
            r = csv.reader(f)
            next(r)  # header
            for row in r:
                counts = np.asarray([float(x) for x in row[1:11]], np.float32)
                total = counts.sum()
                if total > 0:
                    self.rows.append((row[0], counts / total))
        self.train = train
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.rows)

    def load(self, index: int, epoch: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        path, target = self.rows[index]
        img = Image.open(path).convert("RGB")
        s = self.size
        if self.train:
            rng = np.random.default_rng((self.seed, epoch, index))
            # RandomCrop(224 of short-side-256 resize) + h-flip, NIMA-style aug
            w, h = img.size
            if w <= h:
                img = img.resize((256, max(1, round(256 * h / w))), Image.BILINEAR)
            else:
                img = img.resize((max(1, round(256 * w / h)), 256), Image.BILINEAR)
            w, h = img.size
            left = int(rng.integers(0, w - s + 1))
            top = int(rng.integers(0, h - s + 1))
            img = img.crop((left, top, left + s, top + s))
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            return prepare_image_np(img), target
        return np.asarray(img, np.float32) / 255.0, target

    def batches(self, batch_size: int, epoch: int = 0, shuffle: Optional[bool] = None):
        shuffle = self.train if shuffle is None else shuffle
        order = np.arange(len(self.rows))
        if shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            idx = order[i : i + batch_size]
            imgs, tgts = zip(*[self.load(int(j), epoch) for j in idx])
            yield np.stack(imgs), np.stack(tgts)
