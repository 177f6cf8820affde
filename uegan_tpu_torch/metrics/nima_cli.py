"""Standalone NIMA batch scorer CLI, counterpart of uegan_tpu/metrics/nima_cli.py.

Scores every .png/.jpg/.jpeg under ``--test_images`` in batches and writes a
CSV of each file's mean and std (6 decimals).  The device comes from
``UEGAN_TORCH_DEVICE`` (default ``cuda``), as for ``python -m
uegan_tpu_torch``; JAX's ``--platform`` has no counterpart.

Usage:  python -m uegan_tpu_torch.metrics.nima_cli --test_images DIR \
            [--model PATH.pth] [--out results.csv] [--batch 16] \
            [--compute_dtype float32|bfloat16]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="nima-score")
    p.add_argument("--test_images", type=str, required=True, help="folder of images to score")
    p.add_argument("--model", type=str, default="", help="NIMA .pth weights (reference names)")
    p.add_argument("--out", type=str, default="nima_result.csv")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   help="float32 (reference parity) or bfloat16")
    args = p.parse_args(argv)

    from uegan_tpu_torch.metrics.nima import init_nima, load_images, nima_scores
    from uegan_tpu_torch.utils.device import resolve_device

    model = init_nima(args.model, compute_dtype=args.compute_dtype, device=resolve_device())
    files = sorted(
        f for f in os.listdir(args.test_images)
        if f.lower().endswith((".png", ".jpg", ".jpeg"))
    )
    rows = []
    for i in range(0, len(files), args.batch):
        chunk = files[i : i + args.batch]
        means, stds = nima_scores(model, load_images(args.test_images, chunk))
        means, stds = means.cpu().numpy(), stds.cpu().numpy()
        for j, f in enumerate(chunk):
            rows.append((f, round(float(means[j]), 6), round(float(stds[j]), 6)))
        print(f"scored {min(i + args.batch, len(files))}/{len(files)}", file=sys.stderr)

    with open(args.out, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["image_name", "mean", "std"])
        w.writerows(rows)
    print(f"wrote {len(rows)} scores to {args.out}")


if __name__ == "__main__":
    main()
