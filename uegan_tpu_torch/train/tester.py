"""Inference engine, counterpart of uegan_tpu/train/tester.py.

Loads the epoch's reference ``.pth``, enhances the whole test set, saves the
outputs and side-by-side compare PNGs, then runs PSNR/SSIM over the saved
files.  The batch is normalized, enhanced and quantized to uint8 on the
device, so only 1-byte pixels cross to and from it.  Every batch runs at
``val_batch_size``: the tail batch is padded with zeros and cropped back,
as in the JAX package.  The forward is ``infer/packed.py:make_fast_eval``
(packed under the default ``--packed_inference true``; int8 under
``--quantized_inference int8`` or ``int8_pallas``), built at the first
batch, after the checkpoint load, so that the packed kernels are made from
the loaded weights and not from the random init.  The int8 forward's
activation scales are calibrated on that first batch as it runs: padded to
``val_batch_size`` and normalized to [-1, 1] in f32, as in the JAX Tester.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer.packed import make_fast_eval
from uegan_tpu_torch.metrics.psnr import calc_psnr
from uegan_tpu_torch.metrics.ssim import calc_ssim
from uegan_tpu_torch.models.generator import Generator
from uegan_tpu_torch.models.initializers import init_weights
from uegan_tpu_torch.utils.checkpoint import find_checkpoint, generator_state, load_pth
from uegan_tpu_torch.utils.image_io import (normalize_u8, quantize_u8, save_image,
                                            save_image_grid, to_uint8)
from uegan_tpu_torch.utils.seed import setup_seed

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise NotImplementedError(
            f"compute dtype [{name}]: the port's kernels take float32 and bfloat16")
    return DTYPES[name]


def _pad_batch(raw: np.ndarray, target_b: int) -> np.ndarray:
    b = raw.shape[0]
    if b >= target_b:
        return raw
    pad = np.zeros((target_b - b,) + raw.shape[1:], raw.dtype)
    return np.concatenate([raw, pad])


class Tester:
    def __init__(self, loaders, args: Config, device: torch.device):
        self.loaders = loaders
        self.args = args
        self.device = torch.device(device)
        root = os.path.join(args.save_root_dir, args.version)
        self.model_save_path = os.path.join(root, args.model_save_path)
        self.test_result_path = os.path.join(root, args.test_result_path)
        os.makedirs(self.test_result_path, exist_ok=True)
        self.build_model()

    def build_model(self) -> None:
        args = self.args
        g = Generator(conv_dim=args.g_conv_dim, norm_fun=args.g_norm_fun, act_fun=args.g_act_fun,
                      use_sn=args.g_use_sn, dtype=compute_dtype(args.compute_dtype))
        init_weights(g, args.init_type, 0.02, setup_seed(args.seed))
        self.G = g.to(self.device)
        if args.is_print_network:
            n = sum(p.numel() for p in self.G.parameters())
            print(f"=== The number of parameters of [Generator] is [{n}] or [{n / 1e6:>.4f}M] ===")
        self._fast_fn = None  # built from the loaded weights at the first batch
        print("=== Models have been created ===")

    def load_pretrained_model(self, resume_epochs) -> None:
        path = find_checkpoint(self.model_save_path, self.args, resume_epochs)
        self.G.load_state_dict(generator_state(load_pth(path)))
        self._fast_fn = None  # re-pack from the loaded weights
        print(f"=========== loaded trained models (epochs: {resume_epochs})! ===========")

    def _fast_eval(self, calib_batch: torch.Tensor):
        if self._fast_fn is None:
            self._fast_fn = make_fast_eval(self.G, self.args, calib_batch=calib_batch)
        return self._fast_fn

    def _run(self, raw_batch: np.ndarray, u8_out: bool) -> np.ndarray:
        b = raw_batch.shape[0]
        raw = _pad_batch(np.asarray(raw_batch), max(b, self.args.val_batch_size))
        x = normalize_u8(torch.from_numpy(np.ascontiguousarray(raw)).to(self.device))
        with torch.inference_mode():
            y = self._fast_eval(x)(x)
            y = quantize_u8(y) if u8_out else y.float()
        return y.cpu().numpy()[:b]

    def enhance(self, raw_batch: np.ndarray) -> np.ndarray:
        """Enhance a batch (uint8 [0, 255] or float [-1, 1] NHWC) -> float32 [-1, 1]."""
        return self._run(raw_batch, u8_out=False)

    def enhance_u8(self, raw_batch: np.ndarray) -> np.ndarray:
        """Enhance a batch (uint8 [0, 255] or float [-1, 1] NHWC) -> PNG-ready uint8."""
        return self._run(raw_batch, u8_out=True)

    def test(self) -> Dict:
        args = self.args
        if args.pretrained_model:
            self.load_pretrained_model(args.pretrained_model)
        start_time = time.time()
        test_save_path = os.path.join(self.test_result_path, "test_results")
        test_compare_save_path = os.path.join(self.test_result_path, "test_compare")
        os.makedirs(test_save_path, exist_ok=True)
        os.makedirs(test_compare_save_path, exist_ok=True)
        tag = args.pretrained_model

        print("==================== Start testing ====================")
        n_done = 0
        for batch in self.loaders["tes"]:
            raw = np.asarray(batch["img_raw"])
            out_u8 = self.enhance_u8(raw)
            raw_u8 = raw if raw.dtype == np.uint8 else to_uint8((raw + 1.0) / 2.0)
            for i in range(out_u8.shape[0]):
                name = batch["img_name"][i]
                save_image(out_u8[i], os.path.join(
                    test_save_path, f"{name}_{tag:0>3.2f}_testFakeExp.png"))
                save_image_grid([raw_u8[i], out_u8[i]], os.path.join(
                    test_compare_save_path, f"{name}_{tag:0>3.2f}_testRealRaw_testFakeExp.png"))
                n_done += 1
        print(f"=== Saved {n_done} enhanced images into {test_save_path} "
              f"({time.time() - start_time:.1f}s) ===")

        results = {"n_images": n_done, "output_dir": test_save_path}
        if args.is_test_psnr_ssim:
            psnr_path = os.path.join(args.save_root_dir, "psnr_test_results")
            curr = calc_psnr(test_save_path, args.test_label_dir, psnr_path, tag,
                             legacy_average=args.legacy_metrics)
            print(f"====== Avg. PSNR: {curr:>.4f} dB ======")
            results["psnr"] = float(curr)
            ssim_path = os.path.join(args.save_root_dir, "ssim_test_results")
            curr = calc_ssim(test_save_path, args.test_label_dir, ssim_path, tag,
                             legacy_average=args.legacy_metrics)
            print(f"====== Avg. SSIM: {curr:>.4f}  ======")
            results["ssim"] = float(curr)
        return results
