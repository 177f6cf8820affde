"""Training engine, counterpart of uegan_tpu/train/trainer.py:Trainer.

The epoch loop around ``train/step.py:make_train_step`` (reference flow
trainer.py:39-146): the lr printed at each epoch's start, a loss line every
``info_step`` steps, sample panels (raw | fake | exp) every ``sample_step``
steps, the reference's seven-key ``.pth`` every ``model_save_epoch``
epochs (with the EMA copy of G under ``g_ema_decay > 0``), validation every ``val_each_epochs`` after ``num_epochs_start_val``
(the canonical eval forward; under ``on_device_metrics`` PSNR and SSIM of
the output against the paired label on the device, printed; then NIMA and
PSNR/SSIM over the saved PNGs in the reference's disk/CSV protocol, the
authoritative numbers) with the best epochs written at the end.
SIGTERM or SIGINT asks for a checkpoint at the next step and ends the loop;
``--pretrained_model E`` (or -1, the newest) resumes from epoch E's
``.pth``: weights, spectral-norm vectors, optimizer moments and the EMA
copy of G where both the run and the file keep one, at step
E * steps_per_epoch.  The image pool starts empty on a resume, as the JAX
package's ``.pth`` resume does.

The run records its spans (utils/spans.py): ``trainer.fetch`` (the
loader's next batch), ``trainer.to_device``, the step's own
(train/step.py) and ``trainer.post_step`` (loss lines, whose ``float``
waits for the card, samples, checkpoints, validation), and ends with JAX's
``=== step timing: {...} ===`` line read from them (:func:`step_timing`).
``--profile_dir DIR`` writes a ``torch.profiler`` trace of five steps (the
11th to the 15th of the run, or its last five) into DIR, as JAX's
``StepTimer.maybe_trace`` does with ``jax.profiler``.
"""

from __future__ import annotations

import copy
import datetime
import os
import signal
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.metrics.nima import calc_nima, init_nima
from uegan_tpu_torch.metrics.psnr import calc_psnr, psnr_batch
from uegan_tpu_torch.metrics.ssim import calc_ssim, ssim_batch
from uegan_tpu_torch.models.vgg import load_vgg_weights
from uegan_tpu_torch.train.schedules import make_lr_schedule
from uegan_tpu_torch.train.state import (count_params, create_train_state, load_checkpoint,
                                         save_checkpoint)
from uegan_tpu_torch.train.step import make_train_step
from uegan_tpu_torch.utils import spans
from uegan_tpu_torch.utils.checkpoint import ckpt_name, find_checkpoint, load_pth
from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, save_image, save_image_grid


def _denorm_np(x) -> np.ndarray:
    return np.clip((np.asarray(x, dtype=np.float32) + 1.0) / 2.0, 0.0, 1.0)


def _u8_01(x: np.ndarray) -> np.ndarray:
    """A loader batch (uint8, or float in [-1, 1]) -> [0, 1] float32 or uint8 for PNGs."""
    return x if x.dtype == np.uint8 else _denorm_np(x)


def _label255(x: np.ndarray) -> np.ndarray:
    """A loader's label batch (uint8, or float in [-1, 1]) -> float32 on the 255 scale."""
    return x.astype(np.float32) if x.dtype == np.uint8 else _denorm_np(x) * 255.0


def step_timing(records: List[spans.Span]) -> Dict[str, float]:
    """JAX's step timing (``mean_s``, ``p50_s``, ``p90_s``, ``steps_per_s``
    over the host's time in ``train.step``, without the first two steps,
    as JAX's ``StepTimer.summary``), and each other span's p50 host ms a
    step (``<span>_p50_ms``: its time summed within each root span, the
    first two left out alike), from the spans of a run, in order of start.
    A run longer than the recorder's ring reads its last steps."""
    per_root: Dict[Tuple[str, int], float] = {}
    for s in records:
        key = (s.name, s.root)
        per_root[key] = per_root.get(key, 0.0) + (s.end_ns - s.start_ns) * 1e-9
    by_name: Dict[str, List[float]] = {}
    for (name, _), seconds in per_root.items():  # dicts keep the roots' order
        by_name.setdefault(name, []).append(seconds)
    steps = by_name.pop("train.step", [])
    if not steps:
        return {}
    arr = np.asarray(steps[2:] or steps)
    out = {"mean_s": float(arr.mean()), "p50_s": float(np.percentile(arr, 50)),
           "p90_s": float(np.percentile(arr, 90)), "steps_per_s": float(1.0 / arr.mean())}
    for name, seconds in by_name.items():
        out[f"{name}_p50_ms"] = float(np.percentile(np.asarray(seconds[2:] or seconds), 50) * 1e3)
    return out


def info_line(start: float, step: int, total_steps: int, losses: Dict[str, float]) -> str:
    """The reference's loss line (trainer.py:174-177), as the JAX ProgressMeter prints it."""
    elapsed = str(datetime.timedelta(seconds=time.time() - start))
    parts = ", ".join(f"{k}:{v:>.4f}" for k, v in losses.items())
    return f"Elapse:{elapsed:>.12s}, Step:{step + 1:>6d}/{total_steps}, {parts}"


class Trainer:
    def __init__(self, loaders, args: Config, device: torch.device):
        self.loaders = loaders
        self.args = args
        self.device = torch.device(device)
        root = os.path.join(args.save_root_dir, args.version)
        self.model_save_path = os.path.join(root, args.model_save_path)
        self.sample_path = os.path.join(root, args.sample_path)
        self.val_result_path = os.path.join(root, args.val_result_path)
        for p in (self.model_save_path, self.sample_path, self.val_result_path):
            os.makedirs(p, exist_ok=True)
        self.train_steps_per_epoch = max(1, len(loaders["ref"]))
        self.model_save_step = max(1, int(args.model_save_epoch * self.train_steps_per_epoch))
        self.build_model()
        self.best_nima_epoch, self.best_nima = 0.0, 0.0
        self.best_psnr_epoch, self.best_psnr = 0.0, 0.0
        self.best_ssim_epoch, self.best_ssim = 0.0, 0.0
        self.nima_result_save_path = os.path.join(args.save_root_dir, "nima_val_results")
        self.psnr_save_path = os.path.join(args.save_root_dir, "psnr_val_results")
        self.ssim_save_path = os.path.join(args.save_root_dir, "ssim_val_results")
        self.start_time = time.time()
        self._stop_requested = False
        self._nima = None  # built at the first validation that scores NIMA

    # ------------------------------------------------------------------
    def build_model(self) -> None:
        args = self.args
        vgg_state = None
        if args.vgg_weights and os.path.exists(args.vgg_weights):
            vgg_state = load_vgg_weights(args.vgg_weights)
        self.state = create_train_state(args, self.device, (args.resize_size, args.resize_size),
                                        self.train_steps_per_epoch, vgg_state)
        if args.is_print_network:
            for name, m in (("Generator", self.state.g), ("Discriminator", self.state.d)):
                n = count_params(m)
                print(f"=== The number of parameters of [{name}] is [{n}] or "
                      f"[{n / 1e6:>.4f}M] ===")
        if args.packed_train:
            print("=== --packed_train: the port runs the canonical train step (the packed "
                  "step is a TPU layout lever, equal math to float tolerance) ===")
        self._step_fn = make_train_step(self.state)
        spe = self.train_steps_per_epoch
        self._g_lr = make_lr_schedule(args.g_lr, spe, args.lr_decay, args.lr_num_epochs_decay,
                                      args.lr_decay_ratio)
        self._d_lr = make_lr_schedule(args.d_lr, spe, args.lr_decay, args.lr_num_epochs_decay,
                                      args.lr_decay_ratio)
        print("=== Models have been created ===")

    def eval_generator(self):
        """G for validation and samples: a copy holding the EMA parameters when
        one is kept and ``ema_eval`` is on, with the live spectral-norm u and
        v (JAX applies ``g_ema`` with the live ``g_extra``), else the live G."""
        if not (self.args.ema_eval and self.state.g_ema is not None):
            return self.state.g
        g = copy.deepcopy(self.state.g)
        with torch.no_grad():
            for name, p in g.named_parameters():
                p.copy_(self.state.g_ema[name])
        return g

    def nima(self):
        if self._nima is None:
            self._nima = init_nima(self.args.nima_weights, compute_dtype=self.args.nima_dtype,
                                   device=self.device)
        return self._nima

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return normalize_u8(torch.from_numpy(np.ascontiguousarray(a)).to(self.device))

    # ------------------------------------------------------------------
    def train(self) -> Dict:
        args = self.args
        spe = self.train_steps_per_epoch
        total_steps = int(args.total_epochs * spe)
        self.val_start_steps = int(args.num_epochs_start_val * spe)
        self.val_each_steps = max(1, int(args.val_each_epochs * spe))

        resume_epoch = args.pretrained_model
        if resume_epoch == -1:  # the newest checkpoint
            resume_epoch = self.latest_epoch() or 0.0
        start_step = 0
        if resume_epoch:
            start_step = int(resume_epoch * spe)
            self.load_pretrained_model(resume_epoch)
            self.state.step = start_step

        def on_signal(signum, frame):
            self._stop_requested = True
            print(f"=== received signal {signum}: checkpointing at the next step boundary ===")

        old_handlers = {}
        try:  # handlers install only in the main thread
            for sig in (signal.SIGTERM, signal.SIGINT):
                old_handlers[sig] = signal.signal(sig, on_signal)
        except ValueError:
            old_handlers = {}

        print("======================= start training =======================")
        it = None
        last: Dict[str, float] = {}
        # --profile_dir: torch.profiler over five steps, the 11th to the 15th
        # of the run, or its last five when it has fewer
        prof_first = start_step + min(10, max(0, total_steps - start_step - 5))
        prof_end = min(prof_first + 5, total_steps)
        prof, done = None, start_step
        was_on = spans.enabled()
        spans.enable()
        t_run = time.time_ns()
        try:
            for step in range(start_step, total_steps):
                if self._stop_requested:
                    path = self.save_checkpoint(step / spe)
                    print(f"=== preemption checkpoint saved: {path} "
                          f"(resume with --pretrained_model -1) ===")
                    break
                if step % spe == 0:
                    epoch = step // spe
                    print(f"====== Epoch: {epoch:>3d}/{args.total_epochs}, "
                          f"G lr: [{self._g_lr(step):.6g}], D lr: [{self._d_lr(step):.6g}] ======")
                    it = None
                if args.profile_dir and step == prof_first:
                    prof = self._start_profile()
                with spans.span("trainer.fetch"):
                    if it is None:
                        it = iter(self.loaders["ref"])
                    batch = next(it)
                with spans.span("trainer.to_device"):
                    raw, exp = self._to_device(batch["img_raw"]), self._to_device(batch["img_exp"])
                metrics, images = self._step_fn(raw, exp)
                with spans.span("trainer.post_step"):
                    last = self._post_step(step, total_steps, metrics, batch, images) or last
                done = step
                if prof is not None and step + 1 == prof_end:
                    self._stop_profile(prof, prof_first, step)
                    prof = None
        finally:
            if prof is not None:  # stopped early: keep what the profiler saw
                self._stop_profile(prof, prof_first, max(done, prof_first))
            spans.enable(was_on)
            for sig, h in old_handlers.items():
                signal.signal(sig, h)
        self.val_best_results()
        print(f"=== step timing: {step_timing(spans.recorded(t_run))} ===")
        print("=========== Complete training ===========")
        return {"steps": self.state.step, "last_losses": last}

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof, first: int, last: int) -> None:
        """Close the profiler and write its trace (Chrome trace format, which
        TensorBoard's PyTorch profiler plugin and Perfetto read) into
        ``--profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.args.profile_dir, exist_ok=True)
        path = os.path.join(self.args.profile_dir, f"steps_{first}-{last}.pt.trace.json")
        prof.export_chrome_trace(path)
        print(f"=== profiler trace of steps {first}-{last} written to {path} ===")

    def _post_step(self, step: int, total_steps: int, metrics, batch, images) -> Optional[Dict]:
        args = self.args
        spe = self.train_steps_per_epoch
        current_epoch = (step + 1) / spe
        losses = None
        if (step + 1) % args.info_step == 0:
            losses = {k: float(v) for k, v in metrics.items()}
            print(info_line(self.start_time, step, total_steps, losses))
        if (step + 1) % args.sample_step == 0:
            raw01 = _u8_01(batch["img_raw"])
            exp01 = _u8_01(batch["img_exp"])
            fake = quantize_u8(images["fake_exp"]).cpu().numpy()
            for i in range(fake.shape[0]):
                name = batch["img_name"][i]
                save_image_grid([raw01[i], fake[i], exp01[i]], os.path.join(
                    self.sample_path,
                    f"{name}_{current_epoch:0>3.2f}_{i:0>2d}_realRaw_fakeExp_realExp.png"))
        if (step + 1) % self.model_save_step == 0:
            self.save_checkpoint(current_epoch)
            print(f"======= Save model checkpoints into {self.model_save_path} ======")
        self.model_validation(step)
        return losses

    # ------------------------------------------------------------------
    def model_validation(self, step: int) -> None:
        args = self.args
        if (step + 1) <= self.val_start_steps or (step + 1) % self.val_each_steps != 0:
            return
        current_epoch = (step + 1) / self.train_steps_per_epoch
        val_save_path = os.path.join(self.val_result_path, f"validation_{current_epoch}")
        val_compare_save_path = os.path.join(self.val_result_path,
                                             f"validation_compare_{current_epoch}")
        os.makedirs(val_save_path, exist_ok=True)
        os.makedirs(val_compare_save_path, exist_ok=True)
        print("==================== Start validation ====================")
        g = self.eval_generator()
        was_training = g.training
        g.eval()
        od_psnr, od_ssim = [], []
        try:
            for batch in self.loaders["val"]:
                raw = np.asarray(batch["img_raw"])
                with torch.inference_mode():
                    out = g(self._to_device(raw))
                    out_u8 = quantize_u8(out).cpu().numpy()
                    if args.on_device_metrics and "img_exp" in batch:
                        # batched PSNR/SSIM against the paired label straight
                        # from the output tensor; the disk protocol below
                        # stays the authoritative one
                        out255 = torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0) * 255.0
                        label255 = torch.from_numpy(_label255(np.asarray(batch["img_exp"])))
                        label255 = label255.to(self.device)
                        od_psnr.extend(psnr_batch(out255, label255, crop_border=4).tolist())
                        od_ssim.extend(ssim_batch(out255, label255, crop_border=4).tolist())
                raw_u8 = _u8_01(raw)
                for i in range(out_u8.shape[0]):
                    name = batch["img_name"][i]
                    save_image(out_u8[i], os.path.join(
                        val_save_path, f"{name}_{current_epoch:0>3.2f}_valFakeExp.png"))
                    save_image_grid([raw_u8[i], out_u8[i]], os.path.join(
                        val_compare_save_path,
                        f"{name}_{current_epoch:0>3.2f}_valRealRaw_valFakeExp.png"))
        finally:
            g.train(was_training)
        if od_psnr:
            print(f"====== On-device Avg. PSNR: {np.mean(od_psnr):>.4f} dB, "
                  f"SSIM: {np.mean(od_ssim):>.4f} ======")
        if args.is_test_nima:
            curr = calc_nima(val_save_path, self.nima_result_save_path, current_epoch,
                             legacy_average=args.legacy_metrics, model=self.nima())
            if self.best_nima < curr:
                self.best_nima, self.best_nima_epoch = curr, current_epoch
            print(f"====== Avg. NIMA: {curr:>.4f} ======")
        if args.is_test_psnr_ssim:
            curr_p = calc_psnr(val_save_path, args.val_label_dir, self.psnr_save_path,
                               current_epoch, legacy_average=args.legacy_metrics)
            if self.best_psnr < curr_p:
                self.best_psnr, self.best_psnr_epoch = curr_p, current_epoch
            print(f"====== Avg. PSNR: {curr_p:>.4f} dB ======")
            curr_s = calc_ssim(val_save_path, args.val_label_dir, self.ssim_save_path,
                               current_epoch, legacy_average=args.legacy_metrics)
            if self.best_ssim < curr_s:
                self.best_ssim, self.best_ssim_epoch = curr_s, current_epoch
            print(f"====== Avg. SSIM: {curr_s:>.4f}  ======")

    def val_best_results(self) -> None:
        """The best epochs' lines, in the JAX trainer's formats."""
        lines = []
        if self.args.is_test_psnr_ssim:
            lines += [(self.psnr_save_path, "PSNR_total_results_epoch_avgpsnr.csv",
                       f"Best epoch: {self.best_psnr_epoch},{round(self.best_psnr, 6)}"),
                      (self.ssim_save_path, "SSIM_total_results_epoch_avgssim.csv",
                       f"Best epoch: {self.best_ssim_epoch},{round(self.best_ssim, 6)}")]
        if self.args.is_test_nima:
            lines.append((self.nima_result_save_path, "NIMA_total_results_epoch_mean_std.csv",
                          f"Best epoch:{self.best_nima_epoch},{round(self.best_nima, 6)}"))
        for path, csv, line in lines:
            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, csv), "a+") as f:
                f.write(line + "\n")

    # ------------------------------------------------------------------
    def ckpt_path(self, epoch) -> str:
        return os.path.join(self.model_save_path,
                            ckpt_name(self.args.version, self.args.adv_loss_type, epoch) + ".pth")

    def save_checkpoint(self, epoch) -> str:
        """The reference's seven-key ``.pth``, with the EMA copy of G when one
        is kept (train/state.py:save_checkpoint)."""
        return save_checkpoint(self.state, self.ckpt_path(epoch), epoch)

    def latest_epoch(self) -> Optional[float]:
        prefix = f"{self.args.version}_{self.args.adv_loss_type}_"
        epochs = []
        for name in os.listdir(self.model_save_path):
            if name.startswith(prefix) and name.endswith(".pth"):
                try:
                    epochs.append(float(name[len(prefix):-len(".pth")]))
                except ValueError:
                    continue
        return max(epochs) if epochs else None

    def load_pretrained_model(self, resume_epoch) -> None:
        load_checkpoint(self.state, load_pth(find_checkpoint(self.model_save_path, self.args,
                                                             resume_epoch)))
        print(f"=========== loaded trained models (epochs: {resume_epoch})! ===========")
