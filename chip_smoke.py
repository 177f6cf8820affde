#!/usr/bin/env python3
"""Smoke run of uegan_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from uegan_tpu_torch/csrc/ and runs
seven phases, each of which ends the run with a non-zero exit on failure:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: nvcc for sm_90a, with the seconds it took;
3. kernels vs plain: gam_stats (A) and upsample2x (B) against their plain
   PyTorch versions run in float64 and rounded, at the shapes the 512 px
   canonical forward gives them (batch 4), in float32 and bfloat16, and at
   ragged shapes.  Tolerance: float32 |d| <= 1e-5 + 1e-5 |ref|; bfloat16
   |d| <= max(one bfloat16 ulp of the reference, 1e-5).  s2d_convert (C)
   and residual_tail_d2s (D) against their plain versions at the 512 px
   packed shapes (batch 4) and ragged ones, float32 and bfloat16, with NaN
   and +-inf inputs to D: bit-equal (NaN compared as NaN);
4. model: the default generator (conv_dim 32, seeded N(0, 1/fan_in) weights)
   at 512 px in float32 with TF32 off.  Canonical forward: kernels against
   plain versions, max |d| <= 1e-4, launches gam_stats 5, upsample2x 4.
   Packed forward: kernels against plain versions <= 1e-4, against the
   canonical forward <= 2e-3, launches s2d_convert 1, residual_tail_d2s 1,
   upsample2x 3, gam_stats 0;
5. end to end: ``--mode test`` through uegan_tpu_torch.cli.run on a synthetic
   FiveK-layout test set of 8 images at 512 px with a reference-format .pth,
   bfloat16, batch 4, twice: with ``--packed_inference false`` (launches
   gam_stats 10, upsample2x 8) and with the default packed path
   (s2d_convert 2, residual_tail_d2s 2, upsample2x 6, gam_stats 0).  Each
   writes 8 result PNGs and the PSNR and SSIM CSVs, within 35 dB PSNR of a
   float32 canonical forward with the plain versions;
6. timing: images/s of the canonical and the packed forward at 512 px,
   batch 8, bfloat16, with kernels and with plain versions, and each
   kernel's time beside its plain version's and, for A, B and C, the one
   PyTorch library call that computes the same function, from CUDA events;
7. profile: both forwards at 512 px, batch 8, bfloat16, under
   torch.profiler: wall and device-busy time per forward, the device's idle
   share, and device time in buckets of kernel names.

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
GAM_SHAPES = [(IMG >> s, 32 << s) for s in range(5)]  # (H = W, C) at ga1 .. ga5
UP_SHAPES = [(IMG >> s, 32 << s) for s in range(4, 0, -1)]  # inputs of upsample1 .. 4
RAGGED = [(2, 12, 10, 3), (1, 1, 1, 5)]
# original (N, H, W, C) images for kernels C and D: the 512 px batch-4 input
# and ragged ones; D takes the packed shapes (N, H/2, W/2, 4C)
S2D_SHAPES = [(4, IMG, IMG, 3), (2, 12, 10, 3), (1, 2, 2, 5), (1, 4, 6, 1)]
KERNELS = ("gam_stats", "upsample2x", "s2d_convert", "residual_tail_d2s")
# phase 7: (bucket, substrings of the kernel name), first match wins
BUCKETS = [
    ("gam_stats kernel (A)", ("partial_sums", "finish<")),
    ("upsample2x kernel (B)", ("upsample2x_ac",)),
    ("s2d_convert kernel (C)", ("s2d_convert_kernel",)),
    ("residual_tail_d2s kernel (D)", ("residual_tail_d2s_kernel",)),
    ("reflect pad", ("reflection_pad",)),
    ("concat", ("CatArrayBatchedCopy", "cat_")),
    ("row gathers (index_select)", ("indexSelect", "index_select")),
    ("convolutions (cuDNN)", ("fprop", "conv", "implicit", "cudnn", "winograd")),
    ("matmuls (einsum)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "nchwToNhwc", "nhwcToNchw")),
    ("other elementwise", ("elementwise", "vectorized", "Elementwise")),
]


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


def bits_equal(got, want) -> bool:
    """Same shape, dtype and bits; NaN matches NaN whatever its payload."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    as_int = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = got.view(as_int) == want.view(as_int)
    return bool(torch.equal(nan_g, nan_w) and (same | nan_g).all())


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
    """Route both generator forwards through the kernels' plain PyTorch versions."""
    from uegan_tpu_torch.infer import packed
    from uegan_tpu_torch.models import blocks, generator
    from uegan_tpu_torch.ops import gam_stats, resize2x, s2d_fuse

    saved = (blocks.gam_mean_std, generator.upsample2x, packed.upsample2x, packed.s2d_convert,
             packed.residual_tail_d2s)
    blocks.gam_mean_std, generator.upsample2x, packed.upsample2x = (
        gam_stats.plain, resize2x.plain, resize2x.plain)
    packed.s2d_convert = s2d_fuse.plain_s2d_convert
    packed.residual_tail_d2s = s2d_fuse.plain_residual_tail_d2s
    try:
        yield
    finally:
        (blocks.gam_mean_std, generator.upsample2x, packed.upsample2x, packed.s2d_convert,
         packed.residual_tail_d2s) = saved


def seeded_generator(dtype, device):
    import torch

    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state

    g = Generator(conv_dim=32, dtype=dtype)
    sd = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, SEED).items()}
    g.load_state_dict(sd)
    return g.to(device).eval(), sd


def packed_forward(g):
    """The packed forward of G, its kernels packed from G's current weights."""
    from uegan_tpu_torch.infer.packed import make_packed_eval, pack_generator_params

    return make_packed_eval(g, pack_generator_params(g.state_dict(), g.conv_dim,
                                                     device=g.enc1.main[1].weight.device))


def _wrappers() -> dict:
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std
    from uegan_tpu_torch.ops.resize2x import upsample2x
    from uegan_tpu_torch.ops.s2d_fuse import residual_tail_d2s, s2d_convert

    return {"gam_stats": gam_mean_std, "upsample2x": upsample2x, "s2d_convert": s2d_convert,
            "residual_tail_d2s": residual_tail_d2s}


def counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def reset_counts() -> None:
    for w in _wrappers().values():
        w.launches = 0


def check_counts(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what} launched {got}; want {want}")


def phase_kernels(dev) -> dict:
    """A and B against their plain versions evaluated in float64 on the same
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


def phase_s2d_kernels(dev) -> dict:
    """C and D against their plain versions on the card: bit-equal.  D also
    gets NaN, +-inf and inf - inf, which its clip must pass as torch.clamp
    does."""
    import torch

    from uegan_tpu_torch.ops import s2d_fuse

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    f32, bf16 = torch.float32, torch.bfloat16
    tag = {f32: "f32", bf16: "bf16"}
    worst = {"s2d_convert": 0.0, "residual_tail_d2s": 0.0}

    def check(name, shape, what, got, want):
        torch.cuda.synchronize()
        ok = bits_equal(got, want)
        d = (got.float() - want.float()).abs().nan_to_num(0.0)
        err = float(d.max()) if d.numel() else 0.0
        worst[name] = max(worst[name], err)
        log("3 kernels", f"{name} {shape} {what}: {'bit-equal' if ok else 'DIFFERS'} "
                         f"(max abs {err:.3e})")
        if not ok:
            raise AssertionError(f"{name} {shape} {what} differs from its plain version")

    for n, h, w, c in S2D_SHAPES:
        x = torch.rand((n, h, w, c), generator=gen, device=dev) * 2 - 1
        for tin in (f32, bf16):
            for tout in (f32, bf16):
                xi = x.to(tin)
                check("s2d_convert", (n, h, w, c), f"{tag[tin]} -> {tag[tout]}",
                      s2d_fuse.s2d_convert(xi, tout), s2d_fuse.plain_s2d_convert(xi, tout))
        packed_shape = (n, h // 2, w // 2, 4 * c)
        for dt in (f32, bf16):
            res = (torch.rand(packed_shape, generator=gen, device=dev) * 4 - 2).to(dt)
            xp = (torch.rand(packed_shape, generator=gen, device=dev) * 2 - 1).to(dt)
            check("residual_tail_d2s", packed_shape, tag[dt],
                  s2d_fuse.residual_tail_d2s(res, xp), s2d_fuse.plain_residual_tail_d2s(res, xp))
            special = torch.tensor([math.nan, math.inf, -math.inf, math.inf, 0.5, -math.inf],
                                   device=dev, dtype=dt)
            res_s, xp_s = res.clone().view(-1), xp.clone().view(-1)
            k = min(special.numel(), res_s.numel())
            res_s[:k] = special[:k]
            xp_s[:k] = torch.tensor([0.25, 0.5, 0.5, -math.inf, math.nan, math.inf],
                                    device=dev, dtype=dt)[:k]
            res_s, xp_s = res_s.view(packed_shape), xp_s.view(packed_shape)
            got = s2d_fuse.residual_tail_d2s(res_s, xp_s)
            want = s2d_fuse.plain_residual_tail_d2s(res_s, xp_s)
            if int(torch.isnan(want).sum()) < min(k, 4):
                raise AssertionError(f"the NaN case of {packed_shape} has too few NaN: {want}")
            check("residual_tail_d2s", packed_shape, f"{tag[dt]} with NaN/inf", got, want)
    return worst


def phase_model(dev) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g, _ = seeded_generator(torch.float32, dev)
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    zero = dict.fromkeys(KERNELS, 0)
    fwd = packed_forward(g)
    with torch.inference_mode():
        reset_counts()
        out_k = g(x)
        torch.cuda.synchronize()
        canon = counts()
        with plain_versions():
            out_p = g(x)
        torch.cuda.synchronize()
        check_counts("one canonical forward", canon, {**zero, "gam_stats": 5, "upsample2x": 4})
        check_counts("the plain canonical forward", counts(), canon)
        reset_counts()
        pk_k = fwd(x)
        torch.cuda.synchronize()
        pk = counts()
        with plain_versions():
            pk_p = fwd(x)
        torch.cuda.synchronize()
        check_counts("one packed forward", pk, {**zero, "s2d_convert": 1,
                                                "residual_tail_d2s": 1, "upsample2x": 3})
        check_counts("the plain packed forward", counts(), pk)
    for name, t in (("canonical", out_k), ("packed", pk_k)):
        if not bool(torch.isfinite(t).all()) or t.shape != x.shape:
            raise AssertionError(f"{name} output: shape {tuple(t.shape)}, finite "
                                 f"{bool(torch.isfinite(t).all())}")
    d = float((out_k - out_p).abs().max())
    dp = float((pk_k - pk_p).abs().max())
    dpc = float((pk_k - out_k).abs().max())
    log("4 model", f"cd32 {IMG}px f32 (TF32 off) B=2 canonical: kernels vs plain max abs "
                   f"{d:.3e} (limit 1e-4); launches per forward {canon}")
    log("4 model", f"cd32 {IMG}px f32 (TF32 off) B=2 packed: kernels vs plain max abs "
                   f"{dp:.3e} (limit 1e-4), vs canonical max abs {dpc:.3e} (limit 2e-3); "
                   f"launches per forward {pk}")
    if d > 1e-4 or dp > 1e-4:
        raise AssertionError(f"a forward with kernels differs from plain: {d}, {dp}")
    if dpc > 2e-3:
        raise AssertionError(f"the packed forward differs from the canonical by {dpc}")
    torch.backends.cudnn.allow_tf32 = True


def phase_end_to_end(dev, tmp: str) -> dict:
    """``--mode test`` twice, canonical then packed; each run's launches."""
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
    names = [f"a{i:04d}" for i in range(8)]
    raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in names])
    g32, _ = seeded_generator(torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode(), plain_versions():
        want = torch.cat([quantize_u8(g32(normalize_u8(torch.from_numpy(raw[i:i + 4]).to(dev))))
                          for i in (0, 4)]).cpu().numpy()
    torch.backends.cudnn.allow_tf32 = True

    zero = dict.fromkeys(KERNELS, 0)
    expect = {"canonical": {**zero, "gam_stats": 10, "upsample2x": 8},
              "packed": {**zero, "s2d_convert": 2, "residual_tail_d2s": 2, "upsample2x": 6}}
    launches = {}
    for path, flag in (("canonical", "false"), ("packed", None)):
        root = os.path.join(tmp, f"results_{path}")
        models = os.path.join(root, "UEGAN-FiveK", "models")
        os.makedirs(models)
        torch.save({"G_net": sd, "D_net": {}, "epoch": 92.0, "g_optimizer": {},
                    "d_optimizer": {}, "lr_scheduler_g": {}, "lr_scheduler_d": {}},
                   os.path.join(models, "UEGAN-FiveK_rahinge_92.pth"))
        argv = ["--mode", "test", "--test_img_dir", test_dir,
                "--test_label_dir", os.path.join(test_dir, "label") + os.sep,
                "--save_root_dir", root, "--g_conv_dim", "32",
                "--test_img_size", str(IMG), "--val_batch_size", "4", "--pretrained_model", "92",
                "--is_test_nima", "false", "--is_test_psnr_ssim", "true",
                "--compute_dtype", "bfloat16", "--num_workers", "4"]
        if flag is not None:
            argv += ["--packed_inference", flag]
        t0 = time.time()
        reset_counts()
        res = cli.run(argv)
        torch.cuda.synchronize()
        launched = counts()
        secs = time.time() - t0
        out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")
        outs = sorted(os.listdir(out_dir))
        if outs != [f"{n}_92.00_testFakeExp.png" for n in names] or res["n_images"] != 8:
            raise AssertionError(f"--mode test ({path}) wrote {outs}")
        check_counts(f"--mode test ({path}, 2 batches)", launched, expect[path])
        for sub, csv in (("psnr_test_results", "PSNR_epoch_92.0.csv"),
                         ("ssim_test_results", "SSIM_epoch_92.0.csv")):
            if not os.path.exists(os.path.join(root, sub, csv)):
                raise AssertionError(f"missing {sub}/{csv} ({path})")
        if not (math.isfinite(res["psnr"]) and math.isfinite(res["ssim"])):
            raise AssertionError(f"metrics not finite ({path}): {res}")
        got = np.stack([read_png_rgb(os.path.join(out_dir, n)) for n in outs])
        if got.shape != (8, IMG, IMG, 3):
            raise AssertionError(f"result PNGs have shape {got.shape}")
        diff = np.abs(got.astype(np.float64) - want)
        psnr = 10 * math.log10(255.0 ** 2 / max(float((diff ** 2).mean()), 1e-12))
        log("5 end to end", f"--mode test {path} bf16 B=4: 8 PNGs {IMG}x{IMG}, PSNR "
                            f"{res['psnr']:.4f} dB, SSIM {res['ssim']:.4f} vs labels; launches "
                            f"{launched} for 2 batches; vs f32 plain canonical forward: PSNR "
                            f"{psnr:.2f} dB (limit >= 35), max |du8| {int(diff.max())}, mean "
                            f"|du8| {diff.mean():.4f}; {secs:.1f} s")
        if psnr < 35.0:
            raise AssertionError(f"{path} bf16 outputs only {psnr:.2f} dB from the f32 forward")
        launches[path] = launched
    return launches


def phase_timing(dev, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from uegan_tpu_torch.ops import gam_stats, resize2x, s2d_fuse

    b = 8
    g, _ = seeded_generator(torch.bfloat16, dev)
    x = torch.rand((b, IMG, IMG, 3), device=dev) * 2 - 1
    fwd = {}
    with torch.inference_mode():
        for model, step in (("canonical", g), ("packed", packed_forward(g))):
            times = {"kernels": [], "plain": []}
            for which in ("kernels", "plain", "plain", "kernels"):
                ctx = plain_versions() if which == "plain" else contextlib.nullcontext()
                with ctx:
                    times[which].append(cuda_ms(lambda: step(x), iters=10))
            fwd[model] = {k: sum(v) / len(v) for k, v in times.items()}
            for k in ("kernels", "plain"):
                log("6 timing", f"{model} generator {IMG}px B={b} bf16 with {k}: "
                                f"{fwd[model][k]:.3f} ms/forward, "
                                f"{b * 1000 / fwd[model][k]:.1f} img/s (runs {times[k]}) [{card}]")
    log("6 timing", f"packed vs canonical with kernels: {fwd['packed']['kernels']:.3f} vs "
                    f"{fwd['canonical']['kernels']:.3f} ms/forward, "
                    f"{b * 1000 / fwd['packed']['kernels']:.1f} vs "
                    f"{b * 1000 / fwd['canonical']['kernels']:.1f} img/s [{card}]")

    def turns(kern, plain, lib, iters):
        """Kernel, plain, library call: CUDA-event ms per call, each the mean
        of two runs in the order kernel, plain, lib, lib, plain, kernel."""
        fns = {"kernel": kern, "plain": plain, "library": lib}
        t = {k: [] for k in fns}
        for k in ("kernel", "plain", "library", "library", "plain", "kernel"):
            if fns[k] is not None:
                t[k].append(cuda_ms(fns[k], iters))
        return {k: (sum(v) / len(v) if v else None) for k, v in t.items()}

    per = {name: {"kernel": 0.0, "plain": 0.0, "library": 0.0, "bytes": 0} for name in KERNELS}

    def add(name, t, nbytes):
        for k in ("kernel", "plain", "library"):
            if t[k] is None:
                per[name][k] = None
            else:
                per[name][k] += t[k]
        per[name]["bytes"] += nbytes

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        for h, c in GAM_SHAPES:
            xa = torch.randn((b, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
            t = turns(lambda: gam_stats.gam_mean_std(xa), lambda: gam_stats.plain(xa),
                      lambda: torch.var_mean(xa, dim=(1, 2), correction=1), 50)
            add("gam_stats", t, xa.numel() * 2 + 2 * b * c * 2)
            log("6 timing", f"gam_stats ({b},{h},{h},{c}) bf16: kernel {t['kernel'] * 1e3:.1f} us, "
                            f"plain {t['plain'] * 1e3:.1f} us, torch.var_mean "
                            f"{t['library'] * 1e3:.1f} us per call [{card}]")
        for h, c in UP_SHAPES:
            xb = torch.randn((b, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
            lib = lambda: F.interpolate(xb.permute(0, 3, 1, 2), scale_factor=2, mode="bilinear",
                                        align_corners=True)
            t = turns(lambda: resize2x.upsample2x(xb), lambda: resize2x.plain(xb), lib, 50)
            add("upsample2x", t, xb.numel() * 2 * 5)
            log("6 timing", f"upsample2x ({b},{h},{h},{c}) bf16: kernel {t['kernel'] * 1e3:.1f} "
                            f"us, plain {t['plain'] * 1e3:.1f} us, F.interpolate "
                            f"{t['library'] * 1e3:.1f} us per call [{card}]")
        # C and D: their inputs fit in the 50 MB L2, so each timed call takes
        # the next of 4 input sets (151 MB together) and finds its inputs cold
        ring = 4
        xs = [torch.rand((b, IMG, IMG, 3), generator=gen, device=dev) * 2 - 1 for _ in range(ring)]
        pshape = (b, IMG // 2, IMG // 2, 12)
        rs = [torch.rand(pshape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(ring)]
        ps = [torch.rand(pshape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(ring)]

        def library_s2d(x):
            """C's function in one PyTorch call: the permuted view cast into
            contiguous bfloat16 memory (one copy kernel), viewed packed."""
            n, h, w, c = x.shape
            return x.view(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).to(
                torch.bfloat16, memory_format=torch.contiguous_format).view(n, h // 2, w // 2, 4 * c)

        if not bits_equal(library_s2d(xs[0]), s2d_fuse.plain_s2d_convert(xs[0])):
            raise AssertionError("C's library call differs from its plain version")

        def cycling(fn):
            state = {"i": 0}

            def call():
                state["i"] = (state["i"] + 1) % ring
                return fn(state["i"])
            return call

        t = turns(cycling(lambda i: s2d_fuse.s2d_convert(xs[i])),
                  cycling(lambda i: s2d_fuse.plain_s2d_convert(xs[i])),
                  cycling(lambda i: library_s2d(xs[i])), 40)
        add("s2d_convert", t, xs[0].numel() * 4 + xs[0].numel() * 2)
        log("6 timing", f"s2d_convert ({b},{IMG},{IMG},3) f32 -> bf16: kernel "
                        f"{t['kernel'] * 1e3:.1f} us, plain {t['plain'] * 1e3:.1f} us, one "
                        f"permuted .to() {t['library'] * 1e3:.1f} us per call [{card}]")
        t = turns(cycling(lambda i: s2d_fuse.residual_tail_d2s(rs[i], ps[i])),
                  cycling(lambda i: s2d_fuse.plain_residual_tail_d2s(rs[i], ps[i])), None, 40)
        add("residual_tail_d2s", t, rs[0].numel() * 2 * 3)
        log("6 timing", f"residual_tail_d2s {pshape} bf16: kernel {t['kernel'] * 1e3:.1f} us, "
                        f"plain {t['plain'] * 1e3:.1f} us per call [{card}]")
    for name in KERNELS:
        p = per[name]
        p["bound"] = p["bytes"] / HBM_BYTES_PER_S * 1e3
        lib = "n/a" if p["library"] is None else f"{p['library']:.4f}"
        log("6 timing", f"{name} per forward: kernel {p['kernel']:.4f} ms, plain "
                        f"{p['plain']:.4f} ms, library {lib} ms, bound {p['bound']:.4f} ms "
                        f"({p['bytes'] / 1e6:.1f} MB at 3.35 TB/s), "
                        f"{p['bound'] / p['kernel']:.0%} of the bound [{card}]")
    return {"forward": fwd, "per_kernel": per}


def bucket_of(name: str) -> str:
    for bucket, keys in BUCKETS:
        if any(k in name for k in keys):
            return bucket
    return "other"


def profile(step, iters: int = 10, warmup: int = 5) -> dict:
    """torch.profiler over ``iters`` calls of step() after ``warmup``: host
    wall ms per call, device-busy ms per call (the union of kernel
    intervals), the idle share of the kernels' span, and per bucket of
    kernel names (ms per call, kernels per call)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    events = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        raise AssertionError("torch.profiler recorded no device kernel")
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((e.time_range.start, e.time_range.end) for e in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    buckets = {}
    for e in events:
        b = buckets.setdefault(bucket_of(e.name), [0.0, 0])
        b[0] += e.time_range.elapsed_us() / 1e3 / iters
        b[1] += 1 / iters
    return {"wall_ms": wall, "busy_ms": busy / 1e3 / iters, "idle_share": 1.0 - busy / span,
            "buckets": buckets, "longest": sorted(((e.time_range.elapsed_us(), e.name)
                                                   for e in events), reverse=True)}


def phase_profile(dev, card: str) -> None:
    """Where the device time of each forward goes (512 px, B=8, bf16)."""
    import torch

    g, _ = seeded_generator(torch.bfloat16, dev)
    x = torch.rand((8, IMG, IMG, 3), device=dev) * 2 - 1
    with torch.inference_mode():
        for name, fn in (("canonical", g), ("packed", packed_forward(g))):
            r = profile(lambda: fn(x))
            log("7 profile", f"{name} forward {IMG}px B=8 bf16 under torch.profiler: wall "
                             f"{r['wall_ms']:.3f} ms per forward, device busy {r['busy_ms']:.3f} "
                             f"ms, idle share {r['idle_share']:.3f} [{card}]")
            log("7 profile", "| bucket | ms per forward | kernels per forward | share of busy |")
            for k, (ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
                log("7 profile", f"| {k} | {ms:.3f} | {n:g} | {ms / r['busy_ms']:.1%} |")
            seen = set()
            for us, kname in r["longest"]:
                if kname not in seen and len(seen) < 8:
                    seen.add(kname)
                    log("7 profile", f"longest: {us:9.1f} us [{bucket_of(kname)}] {kname[:120]}")


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
    worst_s2d = phase_s2d_kernels(dev)
    phase_model(dev)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_") as tmp:
        launches = phase_end_to_end(dev, tmp)
    timing = phase_timing(dev, card)
    phase_profile(dev, card)

    src = {"gam_stats": ("uegan_tpu_torch/csrc/gam_stats.cu",
                         "uegan_tpu/ops/pallas/gam_stats.py:66"),
           "upsample2x": ("uegan_tpu_torch/csrc/upsample2x.cu",
                          "uegan_tpu/ops/pallas/resize2x.py:116"),
           "s2d_convert": ("uegan_tpu_torch/csrc/s2d_fuse.cu",
                           "uegan_tpu/ops/pallas/s2d_fuse.py:60"),
           "residual_tail_d2s": ("uegan_tpu_torch/csrc/s2d_fuse.cu",
                                 "uegan_tpu/ops/pallas/s2d_fuse.py:97")}
    err = {"gam_stats": worst["gam_stats"][0], "upsample2x": worst["upsample2x"][0],
           **worst_s2d}
    kernels = []
    for name in KERNELS:
        p = timing["per_kernel"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
            "launches": sum(run[name] for run in launches.values()),
            "launches_by_path": {path: run[name] for path, run in launches.items()},
            "max_abs_err": err[name], "ms": p["kernel"], "plain_ms": p["plain"],
            "bound_ms": p["bound"], "bound_by": "bytes", "library_ms": p["library"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
