"""NIMA sub-project CLI, counterpart of uegan_tpu/nima_train/cli.py:

  prepare-dataset   clean AVA.txt against the image folder, write splits
  train-model       EMD-loss training with per-epoch validation
  validate-model    EMD on the validation split
  get-image-score   score one image

Usage: python -m uegan_tpu_torch.nima_train.cli <command> [options]

The device comes from ``UEGAN_TORCH_DEVICE`` (default ``cuda``), as for
``python -m uegan_tpu_torch``; JAX's ``--platform`` has no counterpart.
Weights are the reference's ``.pth``; an orbax directory (what the JAX
trainer writes) is refused with the ``orbax_to_pth.py --nima`` command that
exports it.
"""

from __future__ import annotations

import argparse
import os

def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="nima")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("prepare-dataset")
    sp.add_argument("--path_to_ava_txt", required=True)
    sp.add_argument("--path_to_save_csv", required=True)
    sp.add_argument("--path_to_images", required=True)
    sp.add_argument("--val_frac", type=float, default=0.1)
    sp.add_argument("--test_frac", type=float, default=0.05)

    st = sub.add_parser("train-model")
    st.add_argument("--path_to_save_csv", required=True, help="dir with train/val csv")
    st.add_argument("--experiment_dir", required=True)
    st.add_argument("--batch_size", type=int, default=32)
    st.add_argument("--num_epoch", type=int, default=5)
    st.add_argument("--init_lr", type=float, default=3e-4)
    st.add_argument("--init_weights", type=str, default="")
    st.add_argument("--compute_dtype", type=str, default="float32", help="float32 or bfloat16")

    sv = sub.add_parser("validate-model")
    sv.add_argument("--path_to_model_weight", required=True, help=".pth")
    sv.add_argument("--path_to_save_csv", required=True)
    sv.add_argument("--batch_size", type=int, default=16)

    sg = sub.add_parser("get-image-score")
    sg.add_argument("--path_to_model_weight", default="")
    sg.add_argument("--path_to_image", required=True)

    args = p.parse_args(argv)

    if args.cmd == "prepare-dataset":
        from uegan_tpu_torch.nima_train.dataset import clean_and_split

        paths = clean_and_split(
            args.path_to_ava_txt, args.path_to_images, args.path_to_save_csv,
            val_frac=args.val_frac, test_frac=args.test_frac,
        )
        print("wrote:", *paths)
        return

    from uegan_tpu_torch.utils.device import resolve_device

    if args.cmd == "train-model":
        from uegan_tpu_torch.nima_train.train import train_nima

        hist = train_nima(
            os.path.join(args.path_to_save_csv, "train.csv"),
            os.path.join(args.path_to_save_csv, "val.csv"),
            args.experiment_dir,
            epochs=args.num_epoch,
            batch_size=args.batch_size,
            lr=args.init_lr,
            init_weights=args.init_weights,
            compute_dtype=args.compute_dtype,
            device=resolve_device(),
        )
        print("best val EMD:", hist["best_val"])
    elif args.cmd == "validate-model":
        from uegan_tpu_torch.metrics.nima import init_nima
        from uegan_tpu_torch.nima_train.dataset import AVADataset
        from uegan_tpu_torch.nima_train.train import validate_nima

        if os.path.isdir(args.path_to_model_weight):
            from uegan_tpu_torch.utils.checkpoint import orbax_refusal

            raise NotImplementedError(orbax_refusal(args.path_to_model_weight, "OUT_DIR",
                                                    "--nima"))
        if not args.path_to_model_weight.endswith(".pth"):
            raise ValueError(f"{args.path_to_model_weight}: not a reference .pth")
        if not os.path.exists(args.path_to_model_weight):
            raise FileNotFoundError(args.path_to_model_weight)
        model = init_nima(args.path_to_model_weight, device=resolve_device())
        ds = AVADataset(os.path.join(args.path_to_save_csv, "val.csv"), train=False)
        print("val EMD:", validate_nima(model, ds, args.batch_size))
    elif args.cmd == "get-image-score":
        from PIL import Image

        from uegan_tpu_torch.metrics.nima import init_nima, nima_scores, prepare_image_np

        model = init_nima(args.path_to_model_weight, device=resolve_device())
        with Image.open(args.path_to_image) as im:
            batch = prepare_image_np(im)[None]
        mean, std = nima_scores(model, batch)
        print(f"mean: {float(mean[0]):.6f}  std: {float(std[0]):.6f}")


if __name__ == "__main__":
    main()
