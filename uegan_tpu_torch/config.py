"""Typed configuration: the port's own copy of uegan_tpu/config.py.

The same flags, defaults and ``validate()`` as the JAX package, so a command
line runs unchanged on either package; the port keeps its own copy because it
imports nothing of ``uegan_tpu``.  Every flag of the reference CLI
(reference config.py:7-83) is here, plus the JAX package's additions (mesh
shape, dtype policy, packed/strip/int8 inference).  Flags outside the port's
current slice are accepted here and refused by ``cli.check_supported``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Tuple

# Enumerations (reference: config.py:12,21,25-28,42,49)
ADV_LOSS_TYPES = ("ls", "original", "w", "hinge", "rahinge", "rals")
ACT_FUNS = ("LeakyReLU", "ReLU", "Swish", "SELU", "none")
NORM_FUNS = ("BatchNorm", "InstanceNorm", "none")
INIT_TYPES = (
    "normal",
    "xavier",
    "xavier_uniform",
    "kaiming",
    "kaiming_uniform",
    "orthogonal",
    "none",
)
IDT_LOSS_TYPES = ("l1", "l2", "smoothl1")
OPTIMIZER_TYPES = ("adam", "rmsprop")


def str2bool(v) -> bool:
    """Truthiness used by the reference CLI (reference: utils.py:133-134)."""
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes")


@dataclass(frozen=True)
class Config:
    # ---- model configuration (reference: config.py:11-28) ----
    mode: str = "train"  # train | test
    adv_loss_type: str = "rahinge"
    image_size: int = 512  # random-crop size before resize (train)
    resize_size: int = 256  # resolution after resizing (train)
    test_img_size: int = 512  # test/val resize resolution
    g_conv_dim: int = 32
    d_conv_dim: int = 32
    shuffle: bool = True
    drop_last: bool = True
    version: str = "UEGAN-FiveK"
    init_type: str = "orthogonal"
    adv_input: bool = True  # D also sees the raw input as a fake distribution
    g_use_sn: bool = False
    d_use_sn: bool = True
    g_act_fun: str = "LeakyReLU"
    d_act_fun: str = "LeakyReLU"
    g_norm_fun: str = "none"
    d_norm_fun: str = "none"

    # ---- training configuration (reference: config.py:31-50) ----
    pretrained_model: float = 0.0  # epoch to resume from / test with
    total_epochs: int = 100
    train_batch_size: int = 10
    val_batch_size: int = 1
    num_workers: int = 8  # host pipeline decode threads
    seed: int = 1990
    g_lr: float = 1e-4
    d_lr: float = 4e-4
    lr_decay: bool = True
    lr_num_epochs_decay: int = 50
    lr_decay_ratio: int = 50
    optimizer_type: str = "adam"
    beta1: float = 0.5
    beta2: float = 0.999
    alpha: float = 0.9  # rmsprop decay
    weight_decay: float = 1e-4  # torch-Adam style L2 (reference: trainer.py:337)
    lambda_adv: float = 0.10
    lambda_percep: float = 1.0
    lambda_idt: float = 0.10
    idt_loss_type: str = "l1"
    pool_size: int = 50

    # ---- validation / test configuration (reference: config.py:53-54) ----
    num_epochs_start_val: int = 8
    val_each_epochs: int = 2

    # ---- directories (reference: config.py:57-67) ----
    train_img_dir: str = "./data/fivek/train"
    val_img_dir: str = "./data/fivek/val"
    test_img_dir: str = "./data/fivek/test"
    save_root_dir: str = "./results"
    val_label_dir: str = "./data/fivek/val/label/"
    test_label_dir: str = "./data/fivek/test/label/"
    model_save_path: str = "models"
    sample_path: str = "samples"
    log_path: str = "logs"
    val_result_path: str = "validation"
    test_result_path: str = "test"

    # ---- step sizes (reference: config.py:70-73) ----
    log_step: int = 100
    info_step: int = 100
    sample_step: int = 100
    model_save_epoch: int = 1

    # ---- misc (reference: config.py:76-81) ----
    parallel: bool = False  # kept for CLI parity; unused
    gpu_ids: Tuple[int, ...] = (0, 1, 2, 3)  # kept for CLI parity; unused
    use_tensorboard: bool = False
    is_print_network: bool = True
    is_test_nima: bool = True
    is_test_psnr_ssim: bool = False

    # ---- additions of the JAX package (no reference analog) ----
    mesh_data: int = 0  # devices on the data axis (0 = all)
    mesh_spatial: int = 1  # spatial (H) sharding factor for high-res inference
    compute_dtype: str = "bfloat16"  # conv compute dtype; params stay fp32
    param_dtype: str = "float32"
    on_device_metrics: bool = True  # batched PSNR/SSIM/NIMA on the device
    legacy_metrics: bool = False  # replicate the reference's divide-by-(N-1)
    vgg_weights: str = ""  # optional torchvision vgg19 .pth for conversion
    nima_weights: str = ""  # optional NIMA .pth for conversion
    nima_dtype: str = "bfloat16"  # NIMA eval conv dtype
    tile_size: int = 0  # >0: overlap-tile inference tile edge (single device)
    tile_overlap: int = 32
    remat: bool = False  # rematerialize conv blocks (512px training memory)
    cache_data: bool = False  # RAM-cache decoded images (small datasets)
    device_image_io: bool = True  # ship uint8 pixels to and from the device
    # and normalize / quantize there; False moves float batches instead
    packed_inference: bool = True  # space-to-depth packed generator inference
    # (infer/packed.py); the default generator config only, the canonical
    # forward otherwise
    fused_d: bool = True  # batch all D inputs of a phase into one forward
    split_percep_label: bool = True  # the perceptual loss's label branch as
    # its own stop-gradiented VGG call
    split_g_adv: bool = True  # D(exp) and D(fake) as two forwards in the G update
    packed_train: bool = True  # the G forward of the train step packed
    packed_train_l2: bool = False  # a second space-to-depth level on the
    # half-res stage group of the packed train forward; requires packed_train
    strip_rows: int = 0  # exact H-strip execution for huge images:
    # 0 = auto (strips once the packed height reaches 1024, i.e. images
    # >= 2048px), -1 = off, >0 = forced packed rows per strip
    strip_chunks: int = 0  # strips per exit-chain chunk of the strip executor:
    # 0 = auto, -1 = never chunk, >0 = forced
    quantized_inference: str = ""  # "" (off), "int8", or "int8_pallas": the
    # packed full-res convs in int8; opt-in and lossy, requires
    # packed_inference and the default G config
    test_keep_aspect: bool = False  # keep native resolution (pad to /16)
    profile_dir: str = ""  # profiler trace output
    checkpoint_async: bool = True
    g_ema_decay: float = 0.0  # > 0: keep a Polyak/EMA copy of the G params
    # (Karras-style warmup min(decay, (1+t)/(10+t))); 0.0 is off
    ema_eval: bool = True  # when an EMA copy exists, validate/test with it

    # ------------------------------------------------------------------
    def validate(self) -> "Config":
        if self.adv_loss_type not in ADV_LOSS_TYPES:
            raise ValueError(f"adv_loss_type [{self.adv_loss_type}] is not found")
        for a in (self.g_act_fun, self.d_act_fun):
            if a not in ACT_FUNS:
                raise ValueError(f"activation function [{a}] is not found")
        for n in (self.g_norm_fun, self.d_norm_fun):
            if n not in NORM_FUNS:
                raise ValueError(f"normalization function [{n}] is not found")
        if self.init_type and self.init_type not in INIT_TYPES:
            raise ValueError(f"initialization method [{self.init_type}] is not implemented")
        if self.idt_loss_type not in IDT_LOSS_TYPES:
            raise ValueError(f"identity loss type [{self.idt_loss_type}] is not implemented")
        if self.optimizer_type not in OPTIMIZER_TYPES:
            raise ValueError(f"optimizer [{self.optimizer_type}] is not found")
        if self.quantized_inference not in ("", "int8", "int8_pallas"):
            raise ValueError(
                f"quantized_inference [{self.quantized_inference}] is not implemented"
            )
        for d in (self.compute_dtype, self.param_dtype, self.nima_dtype):
            if d not in ("float32", "bfloat16", "float16"):
                raise ValueError(f"dtype [{d}] is not supported")
        if not (0.0 <= self.g_ema_decay < 1.0):
            raise ValueError(f"g_ema_decay [{self.g_ema_decay}] must be in [0, 1)")
        return self

    # epoch tag used in checkpoint / result filenames: the reference formats a
    # float epoch ('92.0'); published checkpoints use '92'.  Accept both.
    @staticmethod
    def epoch_tag(epoch) -> str:
        f = float(epoch)
        return str(int(f)) if f == int(f) else str(f)


def build_parser() -> argparse.ArgumentParser:
    """CLI mirroring the reference flag-for-flag (reference: config.py:7-83)."""
    p = argparse.ArgumentParser(prog="uegan_tpu_torch")
    d = Config()
    for f in dataclasses.fields(Config):
        name = "--" + f.name
        default = getattr(d, f.name)
        if f.type in ("bool", bool) or isinstance(default, bool):
            p.add_argument(name, type=str2bool, default=default)
        elif isinstance(default, tuple):
            p.add_argument(name, type=int, nargs="*", default=list(default))
        elif isinstance(default, int):
            p.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(name, type=float, default=default)
        else:
            p.add_argument(name, type=str, default=default)
    return p


def get_config(argv: Optional[List[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    d = vars(ns)
    d["gpu_ids"] = tuple(d["gpu_ids"])
    return Config(**d).validate()
