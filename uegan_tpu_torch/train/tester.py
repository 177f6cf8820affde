"""Inference engine, counterpart of uegan_tpu/train/tester.py.

Loads the epoch's reference ``.pth`` (its EMA copy of G under
``--ema_eval``, the default, where the file keeps one), enhances the whole test set (at
native resolution under ``--test_keep_aspect``: each batch reflect-padded to
a bucketed multiple of 16 and cropped back, infer/native.py), saves the
outputs and side-by-side compare PNGs, then runs NIMA (``--is_test_nima``,
on by default as in JAX) and PSNR/SSIM over the saved files.  NIMA is built
once per Tester, from ``--nima_weights`` (seeded without one) in
``--nima_dtype``, on the Tester's device.  The batch is normalized,
enhanced and quantized to uint8 on the device, so only 1-byte pixels cross
to and from it.  Every batch runs at
``val_batch_size``: the tail batch is padded with zeros and cropped back,
as in the JAX package.  The forward is ``infer/packed.py:make_fast_eval``
(packed under the default ``--packed_inference true``; int8 under
``--quantized_inference int8`` or ``int8_pallas``; a generator with
spectral norm, ``--g_use_sn true``, takes the canonical forward on every
route, tiles and native sizes included, as JAX's Tester does), built at the
first batch, after the checkpoint load, so that the packed kernels are made from
the loaded weights and not from the random init.  The int8 forward's
activation scales are calibrated on that first batch as it runs: padded to
``val_batch_size`` and normalized to [-1, 1] in f32, as in the JAX Tester.
Under ``--tile_size > 0`` each image is enhanced in overlapping tiles by the
canonical eval step and stitched on the host (infer/tiles.py), then
quantized on the host, as the JAX Tester's tile route does.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.infer.native import enhance_native
from uegan_tpu_torch.infer.packed import make_eval_step, make_fast_eval, served_generator
from uegan_tpu_torch.infer.tiles import enhance_tiled
from uegan_tpu_torch.metrics.nima import calc_nima, init_nima
from uegan_tpu_torch.metrics.psnr import calc_psnr
from uegan_tpu_torch.metrics.ssim import calc_ssim
from uegan_tpu_torch.utils.checkpoint import find_checkpoint, generator_state, load_pth
from uegan_tpu_torch.utils.image_io import (normalize_u8, quantize_u8, save_image,
                                            save_image_grid, to_uint8)
from uegan_tpu_torch.utils.spans import span


def _host_norm_u8(u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 [-1, 1] on the host (the tile route's input)."""
    return (np.asarray(u8, np.float32) / 255.0 - 0.5) / 0.5


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
        # seeded; spectral norm from --g_use_sn (the checkpoint loads later)
        self.G = served_generator(args, None, self.device)
        if args.is_print_network:
            n = sum(p.numel() for p in self.G.parameters())
            print(f"=== The number of parameters of [Generator] is [{n}] or [{n / 1e6:>.4f}M] ===")
        self._fast_fn = None  # built from the loaded weights at the first batch
        self._nima = None  # built at the first NIMA scoring
        print("=== Models have been created ===")

    def nima(self):
        if self._nima is None:
            self._nima = init_nima(self.args.nima_weights, compute_dtype=self.args.nima_dtype,
                                   device=self.device)
        return self._nima

    def load_pretrained_model(self, resume_epochs) -> None:
        path = find_checkpoint(self.model_save_path, self.args, resume_epochs)
        # the EMA copy of G where the checkpoint keeps one, under --ema_eval
        self.G.load_state_dict(generator_state(load_pth(path), ema=self.args.ema_eval))
        self._fast_fn = None  # re-pack from the loaded weights
        print(f"=========== loaded trained models (epochs: {resume_epochs})! ===========")

    def _fast_eval(self, calib_batch: torch.Tensor):
        if self._fast_fn is None:
            self._fast_fn = make_fast_eval(self.G, self.args, calib_batch=calib_batch)
        return self._fast_fn

    def _run(self, raw_batch: np.ndarray, u8_out: bool) -> np.ndarray:
        """One padded batch through the fast forward, under the spans
        ``tester.run`` > ``tester.h2d`` (pad, the pageable copy up,
        normalize), ``tester.forward`` (the host's launches of the forward and
        the quantize) and ``tester.d2h`` (the wait for the card and the
        copy back)."""
        with span("tester.run"):
            b = raw_batch.shape[0]
            with span("tester.h2d"):
                raw = _pad_batch(np.asarray(raw_batch), max(b, self.args.val_batch_size))
                x = normalize_u8(torch.from_numpy(np.ascontiguousarray(raw)).to(self.device))
            with torch.inference_mode(), span("tester.forward"):
                y = self._fast_eval(x)(x)
                y = quantize_u8(y) if u8_out else y.float()
            with span("tester.d2h"):
                return y.cpu().numpy()[:b]

    def _tiled(self, raw_batch: np.ndarray) -> np.ndarray:
        """Each image in overlapping ``--tile_size`` tiles through the
        canonical eval step (JAX's ``_eval_fn``), stitched on the host."""
        step = make_eval_step(self.G)
        fn = lambda b: step(torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(
            self.device)).float().cpu().numpy()
        raw = np.asarray(raw_batch)
        raw = _host_norm_u8(raw) if raw.dtype == np.uint8 else raw
        return np.stack([enhance_tiled(fn, img, self.args.tile_size, self.args.tile_overlap)
                         for img in raw])

    def enhance(self, raw_batch: np.ndarray) -> np.ndarray:
        """Enhance a batch (uint8 [0, 255] or float [-1, 1] NHWC) -> float32 [-1, 1]."""
        if self.args.tile_size > 0:
            return self._tiled(raw_batch)
        return self._run(raw_batch, u8_out=False)

    def enhance_u8(self, raw_batch: np.ndarray) -> np.ndarray:
        """Enhance a batch (uint8 [0, 255] or float [-1, 1] NHWC) -> PNG-ready
        uint8; the tile route quantizes on the host."""
        if self.args.tile_size > 0:
            return to_uint8(np.clip((self._tiled(raw_batch) + 1.0) / 2.0, 0.0, 1.0))
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
            if args.test_keep_aspect:  # native size: pad to the bucketed grid, crop back
                out_u8 = enhance_native(self.enhance_u8, raw)
            else:
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
        if args.is_test_nima:
            nima_path = os.path.join(args.save_root_dir, "nima_test_results")
            curr = calc_nima(test_save_path, nima_path, tag, legacy_average=args.legacy_metrics,
                             model=self.nima())
            print(f"====== Avg. NIMA: {curr:>.4f} ======")
            results["nima"] = float(curr)
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
