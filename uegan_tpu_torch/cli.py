"""CLI entry point: ``python -m uegan_tpu_torch --mode train|test ...``.

Takes the JAX package's flags (the port's copy in config.py), so a command
line runs unchanged on either package.  The device comes from
``UEGAN_TORCH_DEVICE`` (default ``cuda``); when CUDA is asked for and there
is none, the run stops rather than moving to the CPU.  Options this slice of
the port does not cover raise ``NotImplementedError`` naming the ROADMAP
item that will.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from uegan_tpu_torch.config import Config, get_config
from uegan_tpu_torch.utils.device import resolve_device


def check_supported(args: Config) -> None:
    """Raise for each option outside this slice of the port."""
    unsupported = [
        (args.mesh_spatial > 1, "--mesh_spatial > 1: spatial sharding across devices is "
                                "ROADMAP queue 1 items 8-9"),
        (args.param_dtype != "float32", f"--param_dtype {args.param_dtype}: the port keeps "
                                        "float32 parameters"),
    ]
    for hit, why in unsupported:
        if hit:
            raise NotImplementedError(why)
    if args.mode == "train":
        train_unsupported = [
            (args.optimizer_type != "adam", "--optimizer_type rmsprop: not ported (optax adds "
                                            "eps inside the root, torch outside it)"),
            (args.use_tensorboard, "--use_tensorboard true: TensorBoard logging is not ported"),
            (args.remat, "--remat true: rematerializing the conv blocks (torch.utils.checkpoint) "
                         "is ROADMAP queue 1 item 6"),
            (args.cache_data, "--cache_data true: the RAM cache of decoded train images is "
                              "ROADMAP queue 1 item 6"),
        ]
        for hit, why in train_unsupported:
            if hit:
                raise NotImplementedError(why)
    elif args.mode != "test":
        raise ValueError(f"unknown mode [{args.mode}]")


def main(args: Config) -> Dict:
    check_supported(args)
    device = resolve_device()
    from uegan_tpu_torch.data.pipeline import get_test_loader

    for sub in (args.model_save_path, args.sample_path, args.log_path,
                args.val_result_path, args.test_result_path):
        os.makedirs(os.path.join(args.save_root_dir, args.version, sub), exist_ok=True)
    emit = "uint8" if args.device_image_io else "float32"
    if args.mode == "train":
        from uegan_tpu_torch.data.pipeline import get_train_loader
        from uegan_tpu_torch.train.trainer import Trainer

        loaders = {
            "ref": get_train_loader(
                args.train_img_dir, img_size=args.image_size, resize_size=args.resize_size,
                batch_size=args.train_batch_size, shuffle=args.shuffle,
                num_workers=args.num_workers, drop_last=args.drop_last, seed=args.seed,
                emit=emit),
            "val": get_test_loader(args.val_img_dir, img_size=args.test_img_size,
                                   batch_size=args.val_batch_size,
                                   num_workers=args.num_workers, emit=emit),
        }
        return Trainer(loaders, args, device).train()
    from uegan_tpu_torch.train.tester import Tester

    loaders = {
        "tes": get_test_loader(
            args.test_img_dir,
            img_size=args.test_img_size,
            batch_size=args.val_batch_size,
            num_workers=args.num_workers,
            emit=emit,
            # native sizes, batches of one size; the Tester pads to /16 and
            # crops back (infer/native.py)
            keep_native=args.test_keep_aspect,
        )
    }
    return Tester(loaders, args, device).test()


def run(argv: Optional[List[str]] = None) -> Dict:
    return main(get_config(argv))


if __name__ == "__main__":
    run()
