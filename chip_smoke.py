#!/usr/bin/env python3
"""Smoke run of uegan_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from uegan_tpu_torch/csrc/ and runs
six phases, each of which ends the run with a non-zero exit on failure:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: nvcc for sm_90a, with the seconds it took;
3. kernels vs plain: each kernel against its plain PyTorch version, run in
   float64 and rounded, at the shapes the 512 px generator gives it (batch
   4), in float32 and bfloat16, and at ragged shapes.  Tolerance: float32
   |d| <= 1e-5 + 1e-5 |ref|; bfloat16 |d| <= max(one bfloat16 ulp of the
   reference, 1e-5);
4. model: the default generator (conv_dim 32, seeded N(0, 1/fan_in) weights)
   at 512 px in float32 with TF32 off, kernels against plain versions,
   max |d| <= 1e-4; one forward launches gam_stats 5 times, upsample2x 4 times;
5. end to end: ``--mode test`` through uegan_tpu_torch.cli.run on a synthetic
   FiveK-layout test set of 8 images at 512 px with a reference-format .pth,
   bfloat16, batch 4: 8 result PNGs, the PSNR and SSIM CSVs, launch counts of
   5 and 4 per batch, and outputs within 35 dB PSNR of a float32 forward;
6. timing: generator images/s at 512 px, batch 8, bfloat16, with kernels and
   with plain versions, and each kernel's time per call beside its plain
   version's, from CUDA events.

It then prints the kernels' JSON line and, last, the device JSON line.  It
exits non-zero without a result where CUDA is unavailable or where the
uegan_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 1990
IMG = 512
GAM_SHAPES = [(IMG >> s, 32 << s) for s in range(5)]  # (H = W, C) at ga1 .. ga5
UP_SHAPES = [(IMG >> s, 32 << s) for s in range(4, 0, -1)]  # inputs of upsample1 .. 4
RAGGED = [(2, 12, 10, 3), (1, 1, 1, 5)]


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def bf16_ulp(t):
    import torch

    a = t.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def compare(got, want, dtype) -> tuple:
    """(max abs err, max rel err, within tolerance)."""
    import torch

    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    if dtype == torch.float32:
        ok = bool((d <= 1e-5 + 1e-5 * w).all())
    else:
        # one ulp, with a floor for results that cancel to ~0, where f32
        # math before the rounding leaves ~1e-7 of the inputs' magnitude
        ok = bool((d <= torch.clamp(bf16_ulp(want), min=1e-5)).all())
    rel = float((d / w.clamp_min(1e-30)).max())
    return float(d.max()), rel, ok


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


@contextlib.contextmanager
def plain_versions():
    """Route the generator through the kernels' plain PyTorch versions."""
    from uegan_tpu_torch.models import blocks, generator
    from uegan_tpu_torch.ops import gam_stats, resize2x

    saved = blocks.gam_mean_std, generator.upsample2x
    blocks.gam_mean_std, generator.upsample2x = gam_stats.plain, resize2x.plain
    try:
        yield
    finally:
        blocks.gam_mean_std, generator.upsample2x = saved


def seeded_generator(dtype, device):
    import torch

    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state

    g = Generator(conv_dim=32, dtype=dtype)
    sd = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, SEED).items()}
    g.load_state_dict(sd)
    return g.to(device).eval(), sd


def counts() -> tuple:
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std
    from uegan_tpu_torch.ops.resize2x import upsample2x

    return gam_mean_std.launches, upsample2x.launches


def reset_counts() -> None:
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std
    from uegan_tpu_torch.ops.resize2x import upsample2x

    gam_mean_std.launches = 0
    upsample2x.launches = 0


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version evaluated in float64 on the same
    inputs and rounded to the kernel's dtype.  float64, because the float32
    F.interpolate rounds its source index (in-1)/(out-1)*k in float32: at
    256 -> 512 its weights are off by up to ~3e-5, more than the tolerance.
    The plain float32 version's own distance from float64 is printed beside."""
    import torch

    from uegan_tpu_torch.ops import gam_stats, resize2x

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"gam_stats": [0.0, 0.0], "upsample2x": [0.0, 0.0]}  # f32, bf16 max abs
    cases = [("gam_stats", (4, h, h, c)) for h, c in GAM_SHAPES]
    cases += [("upsample2x", (4, h, h, c)) for h, c in UP_SHAPES]
    cases += [(k, s) for s in RAGGED for k in ("gam_stats", "upsample2x")]
    run = {"gam_stats": (lambda x: torch.cat(gam_stats.gam_mean_std(x), -1),
                         lambda x: torch.cat(gam_stats.plain(x), -1)),
           "upsample2x": (resize2x.upsample2x, resize2x.plain)}
    for name, shape in cases:
        kern, plain = run[name]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
            got = kern(x)
            want = plain(x.double()).to(dtype)
            plain32 = plain(x)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dtype:
                raise AssertionError(f"{name} {shape} {dtype}: got {got.shape} {got.dtype}")
            err, rel, ok = compare(got, want, dtype)
            perr = compare(plain32, want, dtype)[0]
            tag = "f32" if dtype == torch.float32 else "bf16"
            log("3 kernels", f"{name} {shape} {tag}: max abs {err:.3e} max rel {rel:.3e} "
                             f"{'ok' if ok else 'OUT OF TOLERANCE'} (plain in {tag}: "
                             f"max abs {perr:.3e})")
            if not ok:
                raise AssertionError(f"{name} {shape} {tag} disagrees with its plain version")
            i = 0 if dtype == torch.float32 else 1
            worst[name][i] = max(worst[name][i], err)
    return worst


def phase_model(dev) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g, _ = seeded_generator(torch.float32, dev)
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    with torch.inference_mode():
        reset_counts()
        out_k = g(x)
        torch.cuda.synchronize()
        launched = counts()
        with plain_versions():
            out_p = g(x)
        torch.cuda.synchronize()
    if launched != (5, 4) or counts() != (5, 4):
        raise AssertionError(f"one forward launched (gam_stats, upsample2x) = {launched}, "
                             f"then {counts()} after the plain run; want (5, 4)")
    if not bool(torch.isfinite(out_k).all()):
        raise AssertionError("non-finite generator output")
    d = float((out_k - out_p).abs().max())
    log("4 model", f"cd32 {IMG}px f32 (TF32 off) B=2: kernels vs plain max abs {d:.3e} "
                   f"(limit 1e-4); launches per forward gam_stats {launched[0]}, "
                   f"upsample2x {launched[1]}")
    if d > 1e-4:
        raise AssertionError(f"generator with kernels differs from plain by {d}")
    torch.backends.cudnn.allow_tf32 = True


def phase_end_to_end(dev, tmp: str) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    rng = np.random.default_rng(SEED)
    test_dir = os.path.join(tmp, "fivek", "test")
    yy, xx = np.mgrid[0:IMG, 0:IMG] / IMG
    for i in range(8):
        for sub in ("label", "raw"):
            os.makedirs(os.path.join(test_dir, sub), exist_ok=True)
            base = np.stack([yy * rng.uniform(0.3, 1), xx * rng.uniform(0.3, 1),
                             (yy + xx) / 2 * rng.uniform(0.3, 1)], -1)
            img = np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(test_dir, sub, f"a{i:04d}.png"))
    _, sd = seeded_generator(torch.float32, "cpu")
    models = os.path.join(tmp, "results", "UEGAN-FiveK", "models")
    os.makedirs(models)
    torch.save({"G_net": sd, "D_net": {}, "epoch": 92.0, "g_optimizer": {}, "d_optimizer": {},
                "lr_scheduler_g": {}, "lr_scheduler_d": {}},
               os.path.join(models, "UEGAN-FiveK_rahinge_92.pth"))
    argv = ["--mode", "test", "--test_img_dir", test_dir,
            "--test_label_dir", os.path.join(test_dir, "label") + os.sep,
            "--save_root_dir", os.path.join(tmp, "results"), "--g_conv_dim", "32",
            "--test_img_size", str(IMG), "--val_batch_size", "4", "--pretrained_model", "92",
            "--is_test_nima", "false", "--is_test_psnr_ssim", "true",
            "--compute_dtype", "bfloat16", "--num_workers", "4"]
    t0 = time.time()
    reset_counts()
    res = cli.run(argv)
    torch.cuda.synchronize()
    launched = counts()
    secs = time.time() - t0
    out_dir = os.path.join(tmp, "results", "UEGAN-FiveK", "test", "test_results")
    names = sorted(os.listdir(out_dir))
    if len(names) != 8 or res["n_images"] != 8:
        raise AssertionError(f"--mode test wrote {names}")
    if launched != (10, 8):
        raise AssertionError(f"--mode test launched (gam_stats, upsample2x) = {launched}; "
                             "want (10, 8) for 2 batches")
    for sub, csv in (("psnr_test_results", "PSNR_epoch_92.0.csv"),
                     ("ssim_test_results", "SSIM_epoch_92.0.csv")):
        if not os.path.exists(os.path.join(tmp, "results", sub, csv)):
            raise AssertionError(f"missing {sub}/{csv}")
    if not (math.isfinite(res["psnr"]) and math.isfinite(res["ssim"])):
        raise AssertionError(f"metrics not finite: {res}")
    # the bf16 PNGs against a float32 forward with the plain versions
    got = np.stack([read_png_rgb(os.path.join(out_dir, n)) for n in names])
    raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n.split("_")[0] + ".png"))
                    for n in names])
    g32, _ = seeded_generator(torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode(), plain_versions():
        want = torch.cat([quantize_u8(g32(normalize_u8(torch.from_numpy(raw[i:i + 4]).to(dev))))
                          for i in (0, 4)]).cpu().numpy()
    torch.backends.cudnn.allow_tf32 = True
    if got.shape != (8, IMG, IMG, 3):
        raise AssertionError(f"result PNGs have shape {got.shape}")
    diff = np.abs(got.astype(np.float64) - want)
    psnr = 10 * math.log10(255.0 ** 2 / max(float((diff ** 2).mean()), 1e-12))
    log("5 end to end", f"--mode test bf16 B=4: 8 PNGs {IMG}x{IMG}, PSNR {res['psnr']:.4f} dB, "
                        f"SSIM {res['ssim']:.4f} vs labels; launches gam_stats {launched[0]}, "
                        f"upsample2x {launched[1]} for 2 batches; vs f32 plain forward: "
                        f"PSNR {psnr:.2f} dB (limit >= 35), max |du8| {int(diff.max())}, "
                        f"mean |du8| {diff.mean():.4f}; {secs:.1f} s")
    if psnr < 35.0:
        raise AssertionError(f"bf16 outputs only {psnr:.2f} dB from the f32 forward")
    return {"gam_stats": launched[0], "upsample2x": launched[1]}


def phase_timing(dev, card: str) -> dict:
    import torch

    from uegan_tpu_torch.ops import gam_stats, resize2x

    b = 8
    g, _ = seeded_generator(torch.bfloat16, dev)
    x = torch.rand((b, IMG, IMG, 3), device=dev) * 2 - 1
    step = lambda: g(x)
    times = {"kernels": [], "plain": []}
    with torch.inference_mode():
        for which in ("kernels", "plain", "plain", "kernels"):
            ctx = plain_versions() if which == "plain" else contextlib.nullcontext()
            with ctx:
                times[which].append(cuda_ms(step, iters=10))
    fwd = {k: sum(v) / len(v) for k, v in times.items()}
    for k in ("kernels", "plain"):
        log("6 timing", f"generator {IMG}px B={b} bf16 with {k}: {fwd[k]:.3f} ms/forward, "
                        f"{b * 1000 / fwd[k]:.1f} img/s (runs {times[k]}) [{card}]")

    per = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = [("gam_stats", gam_stats.gam_mean_std, gam_stats.plain, s) for s in GAM_SHAPES]
    cases += [("upsample2x", resize2x.upsample2x, resize2x.plain, s) for s in UP_SHAPES]
    with torch.inference_mode():
        for name, kern, plain, (h, c) in cases:
            x = torch.randn((b, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
            k1 = cuda_ms(lambda: kern(x), 50)
            p1 = cuda_ms(lambda: plain(x), 50)
            p2 = cuda_ms(lambda: plain(x), 50)
            k2 = cuda_ms(lambda: kern(x), 50)
            k, p = (k1 + k2) / 2, (p1 + p2) / 2
            tot = per.setdefault(name, [0.0, 0.0])
            tot[0] += k
            tot[1] += p
            log("6 timing", f"{name} ({b},{h},{h},{c}) bf16: kernel {k * 1000:.1f} us, "
                            f"plain {p * 1000:.1f} us per call [{card}]")
    return {"forward": fwd, "per_kernel": per}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "uegan_tpu_torch", "csrc")):
        print(f"chip_smoke: the uegan_tpu_torch package is not beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from uegan_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card, flush=True)
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    log("1 environment", f"{card}; {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
                         f"CUDA {torch.version.cuda}; nvcc {nvcc}")

    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log("2 build", f"{lib_path.name} from {[s.name for s in _build.sources()]} "
                   f"in {time.time() - t0:.1f} s")

    worst = phase_kernels(dev)
    phase_model(dev)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_") as tmp:
        launches = phase_end_to_end(dev, tmp)
    timing = phase_timing(dev, card)

    src = {"gam_stats": ("uegan_tpu_torch/csrc/gam_stats.cu",
                         "uegan_tpu/ops/pallas/gam_stats.py:66"),
           "upsample2x": ("uegan_tpu_torch/csrc/upsample2x.cu",
                          "uegan_tpu/ops/pallas/resize2x.py:116")}
    kernels = [{
        "name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
        "launches": launches[name], "max_abs_err": worst[name][0],
        "max_abs_err_bf16": worst[name][1],
        "ms": timing["per_kernel"][name][0], "plain_ms": timing["per_kernel"][name][1],
    } for name in ("gam_stats", "upsample2x")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
