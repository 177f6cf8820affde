"""CLI entry point: ``python -m uegan_tpu_torch --mode test ...``.

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

import torch

from uegan_tpu_torch.config import Config, get_config
from uegan_tpu_torch.infer.packed import check_packed_options
from uegan_tpu_torch.models.blocks import ROADMAP_SN


def resolve_device(name: Optional[str] = None) -> torch.device:
    """``UEGAN_TORCH_DEVICE`` (default ``cuda``) -> torch.device; raises when
    a CUDA device is requested and none is present."""
    device = torch.device(name or os.environ.get("UEGAN_TORCH_DEVICE") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but CUDA is not available; "
            "set UEGAN_TORCH_DEVICE=cpu to run the plain PyTorch versions on the CPU")
    return device


def check_supported(args: Config) -> None:
    """Raise for each option outside this slice of the port."""
    unsupported = [
        (args.mode == "train", "--mode train: the train slice is ROADMAP queue 1 item 6"),
        (args.is_test_nima, "--is_test_nima true: NIMA is ROADMAP queue 1 item 7 "
                            "(pass --is_test_nima false)"),
        (args.tile_size > 0, "--tile_size > 0: tiled inference is ROADMAP queue 1 item 8"),
        (args.mesh_spatial > 1, "--mesh_spatial > 1: spatial sharding is ROADMAP queue 1 "
                                "items 8-9"),
        (args.test_keep_aspect, "--test_keep_aspect true: native-resolution inference is "
                                "ROADMAP queue 1 item 8"),
        (args.g_use_sn, ROADMAP_SN),
        (args.param_dtype != "float32", f"--param_dtype {args.param_dtype}: the port keeps "
                                        "float32 parameters"),
    ]
    for hit, why in unsupported:
        if hit:
            raise NotImplementedError(why)
    if args.packed_inference:
        check_packed_options(args)
    if args.mode != "test":
        raise ValueError(f"unknown mode [{args.mode}]")


def main(args: Config) -> Dict:
    check_supported(args)
    device = resolve_device()
    from uegan_tpu_torch.data.pipeline import get_test_loader
    from uegan_tpu_torch.train.tester import Tester

    for sub in (args.model_save_path, args.sample_path, args.log_path,
                args.val_result_path, args.test_result_path):
        os.makedirs(os.path.join(args.save_root_dir, args.version, sub), exist_ok=True)
    loaders = {
        "tes": get_test_loader(
            args.test_img_dir,
            img_size=args.test_img_size,
            batch_size=args.val_batch_size,
            num_workers=args.num_workers,
            emit="uint8" if args.device_image_io else "float32",
        )
    }
    return Tester(loaders, args, device).test()


def run(argv: Optional[List[str]] = None) -> Dict:
    return main(get_config(argv))


if __name__ == "__main__":
    run()
