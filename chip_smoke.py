#!/usr/bin/env python3
"""Smoke run of uegan_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from uegan_tpu_torch/csrc/ (one nvcc
a source, started together) and runs eight phases, each of which ends the
run with a non-zero exit on failure:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: nvcc for sm_90a, with the seconds it took, and from ptxas's -v
   report (kept beside the library, so a cached build has it too) one line
   a kernel of the sources of E, F, A, A', B' and C (and D, which shares
   C's): registers, spills and shared memory; it fails where the report
   names no tensor-core kernel of E or F, or no kernel of A, A', B' or C;
3. kernels vs plain: gam_stats (A) and upsample2x (B) against their plain
   PyTorch versions run in float64 and rounded, at the shapes the 512 px
   canonical forward gives them (batch 4), in float32 and bfloat16, and at
   ragged shapes; A also at one pixel with C = 3, 5, 12 (narrow words), 32
   and 512 (16-byte words), at batch 1 and 512 px, and on an input one
   element past a 16-byte boundary, each called twice for identical bits.
   Tolerance: float32 |d| <= 1e-5 + 1e-5 |ref|; bfloat16 |d| <= max(one
   bfloat16 ulp of the reference, 1e-5).  s2d_convert (C) and
   residual_tail_d2s (D) against their plain versions at the 512 px packed
   shapes (batch 4) and ragged ones, float32 and bfloat16, C in all four
   dtype pairs with NaN and +-inf inputs and on an input 4 bytes past a
   16-byte boundary, D with NaN and +-inf: bit-equal (NaN compared as NaN,
   and NaN payloads too where C's dtypes are equal).
   packed_conv_int8 (E) against its plain version at the ga1 shape, the
   dec4 site (3x3, leaky, multiply, requant) and the dec5_0 site (requant)
   of the 512 px int8 forward (batch 4), a 5x5 12-channel tanh case, ragged
   shapes and the tensor-core body's tile edges (a partial last M tile,
   W = 200, Cout = 192): bit-equal in every column, tanh within one bfloat16
   ulp or one int8 step.  packed_conv (F) against its plain version run in
   float64, in float32 and bfloat16, at the dec4 shape (batch 2), a 5x5
   case, ragged ones and the same tile edges, with A's and B's tolerances.
   The backward kernels gam_stats_bwd (A') and upsample2x_bwd (B') against
   their plain versions run in float64, at every shape the 256 px train step
   (batch 10, 20 images through G) gives them and at the edges of their
   tiles (GAM_BWD_EDGES, UP_BWD_EDGES: one pixel, constant channels, H or W
   of one, H and W not a multiple of the tile, C = 3, 6, 12 and 520, an
   input one element past 16 bytes, more tiles than a wave, and B' on a
   small wave whose blocks walk several tiles), float32 and bfloat16, with
   A's and B's tolerances; each autograd Function's gradient against central
   differences of its plain forward in float64; C, D, E and F refusing
   inputs that require grad; A on two streams at once bit-equal to serial
   calls, every stream's tickets back at zero;
4. model: the default generator (conv_dim 32, seeded N(0, 1/fan_in) weights)
   at 512 px in float32 with TF32 off.  Canonical forward: kernels against
   plain versions, max |d| <= 1e-4, launches gam_stats 5, upsample2x 4.
   Packed forward: kernels against plain versions <= 1e-4, against the
   canonical forward <= 2e-3, launches s2d_convert 1, residual_tail_d2s 1,
   upsample2x 3, gam_stats 0.  Then the int8 and int8_pallas forwards in
   bfloat16 (batch 2, calibrated on their input): >= 30 dB from the bf16
   packed forward, int8_pallas vs int8 max |d| <= 0.02, kernels vs plain
   >= 40 dB and max |d| <= 0.05; launches a forward gam_stats 4,
   upsample2x 3, s2d_convert 1, residual_tail_d2s 1, and packed_conv_int8
   1 under int8_pallas (ga1), 0 under int8;
5. end to end: ``--mode test`` through uegan_tpu_torch.cli.run on a synthetic
   FiveK-layout test set of 8 images at 512 px with a reference-format .pth,
   bfloat16, batch 4, three times: with ``--packed_inference false``
   (launches gam_stats 10, upsample2x 8), with the default packed path
   (s2d_convert 2, residual_tail_d2s 2, upsample2x 6, gam_stats 0), and with
   ``--quantized_inference int8_pallas`` (packed_conv_int8 2; with the
   calibration forward on the first batch gam_stats 12, upsample2x 9,
   s2d_convert 3, residual_tail_d2s 2).  Each writes 8 result PNGs and the
   PSNR and SSIM CSVs, within 35 dB PSNR (30 dB for int8) of a float32
   canonical forward with the plain versions;
6. train: ``--mode train`` through uegan_tpu_torch.cli.run at the default
   width (cd 32, dd 32, 256 px crops of 512, batch 10, pool 50, bf16) on a
   synthetic FiveK layout of 30 pairs, 3 steps and a validation batch
   (launches A 20, B 16, A' 15, B' 12), then ``--mode test`` on the .pth it
   wrote; in process, 2 steps from one seeded state with the kernels and
   with the plain versions in float32 with TF32 off and deterministic cuDNN
   (losses within rel 1e-4; parameters within 1e-4 but for at most 1e-3 of
   them, where Adam's first steps divide a nearly cancelling gradient, by at
   most 4 lr; how many of those had gradients of 1e-6 or more is printed, and
   step 1's gradients against each other, per tensor and in L2, with the
   tensors whose gradients are rounding noise left out and named); 2
   bf16 steps finite with both nets moved; one step's launches A 5, B 4,
   A' 5, B' 4; step time and images/s with kernels and with plain versions,
   peak memory, and the step's device time by bucket under torch.profiler;
7. timing: images/s of the canonical and the packed forward at 512 px,
   batch 8, bfloat16, with kernels and with plain versions, and of the int8
   and int8_pallas forwards beside the packed one; each kernel's time beside
   its plain version's, its bound and, for A, B, C and F, the one PyTorch
   library call that computes the same function (E at ga1 beside
   torch._int_mm alone, and at the dec4 and dec5_0 sites beside the int8
   mode's unfused chain), each two ways: eager (CUDA events around calls
   made from the host) and device-only (CUDA events around replays of a
   CUDA graph that captured the calls; the profiler's device time where
   capture fails).  The share of the bound and the JSON line's times are
   the device-only ones.  A's calls (its five canonical shapes), C's and
   D's go round rings of inputs of over 100 MB, so they find them cold, and
   so do B's (its four canonical shapes) and A' and B' at the train step's
   shapes, beside their plain versions and the library's (for A' the
   autograd of a torch.var_mean-based mean and std, device time from the
   profiler, as autograd's stream rules keep it out of a CUDA graph; for B'
   aten.upsample_bilinear2d_backward);
8. profile: the canonical, packed and int8_pallas forwards at 512 px, batch
   8, bfloat16, under torch.profiler: wall and device-busy time per forward,
   the device's idle share, and device time in buckets of kernel names.

It then prints the kernels' JSON line and, last, the device JSON line.  It
exits non-zero without a result where CUDA is unavailable or where the
uegan_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
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
# more A cases: one pixel at C = 3, 5, 12 (narrow words) and 32, 512 (16-byte
# words), and a batch of one at 512 px, whose plan cuts each image finer
GAM_EXTRA = [(2, 1, 1, c) for c in (3, 5, 12, 32, 512)] + [(1, IMG, IMG, 32)]
# original (N, H, W, C) images for kernels C and D: the 512 px batch-4 input
# and ragged ones (narrow words); D takes the packed shapes (N, H/2, W/2, 4C)
S2D_SHAPES = [(4, IMG, IMG, 3), (2, 12, 10, 3), (1, 2, 2, 5), (1, 4, 6, 1), (1, 4, 6, 3)]
KERNELS = ("gam_stats", "upsample2x", "s2d_convert", "residual_tail_d2s", "packed_conv_int8",
           "packed_conv", "gam_stats_bwd", "upsample2x_bwd")
# the train slice: 256 px crops of 512, batch 10, so G runs on 20 images
TRAIN_HW = 256
TRAIN_B = 10
TRAIN_B2 = 2 * TRAIN_B
TRAIN_GAM_SHAPES = [(TRAIN_HW >> s, 32 << s) for s in range(5)]  # (H = W, C) at ga1 .. ga5
TRAIN_UP_SHAPES = [(TRAIN_HW >> s, 32 << s) for s in range(4, 0, -1)]  # inputs of upsample1 .. 4
# A' beyond the train shapes: one pixel, constant channels, C = 3, 12, 520
# (narrow words, a ragged channel tile), pixels not a multiple of the
# plan's rows and chunks, and x or dmean one element past 16 bytes
GAM_BWD_EDGES = [((2, 12, 10, 3), False, None), ((2, 1, 1, 5), False, None),
                 ((1, 16, 16, 8), True, None), ((2, 7, 3, 16), True, None),
                 ((2, 9, 11, 12), False, None), ((2, 6, 7, 520), False, None),
                 ((3, 1, 1, 520), False, None), ((3, 37, 41, 64), False, None),
                 ((2, 16, 16, 32), False, "x"), ((2, 16, 16, 32), False, "dmean")]
# B' beyond the train shapes (dx shapes): H and W not a multiple of the tile
# (rows ragged too at batch 20), H = 1, W = 1, C = 3, 6, 12 and 520 (2-, 4-
# and 8-byte words, a ragged channel tile), more tiles than a wave, dy one
# element past 16 bytes, and a wave of 2 blocks that walk 3 tiles of the
# most rows a tile takes, the last one ragged
UP_BWD_EDGES = [((2, 12, 10, 3), False, None), ((1, 1, 5, 2), False, None),
                ((2, 3, 1, 4), False, None), ((2, 13, 37, 64), False, None),
                ((20, 37, 45, 64), False, None), ((1, 1, 9, 16), False, None),
                ((2, 7, 1, 16), False, None), ((2, 5, 6, 3), False, None),
                ((2, 5, 6, 6), False, None), ((1, 9, 17, 12), False, None),
                ((2, 3, 20, 520), False, None), ((8, 6, 300, 512), False, None),
                ((2, 6, 10, 16), True, None), ((2, 150, 20, 16), False, 2)]
INT8_PEAK_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
BF16_PEAK_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
CD = 32
HP = IMG // 2  # packed height and width
# kernel E's cases: (what, (N, L, W, Cin), Cout, S, s0, act, mul, requant); the
# main path's ga1 (1x1), the dec4 and dec5_0 sites the fused path has, an
# enc1-like 5x5 with 12 channels and tanh, ragged shapes, and the edges of
# the tensor-core body's tiles: an M count that leaves a partial last tile,
# W = 200 (not a multiple of the 128-column box) and Cout = 192 (a ragged
# second N tile)
E_CASES = [
    ("ga1", (4, HP, HP, 4 * CD), 4 * CD, 1, 0, "none", False, False),
    ("dec4 site", (4, HP, HP, 8 * CD), 4 * CD, 3, 1, "leaky", True, True),
    ("dec5_0 site", (4, HP, HP, 4 * CD), 4 * CD, 3, 1, "none", False, True),
    ("S=5 cin=12", (4, HP, HP, 12), 4 * CD, 5, 2, "tanh", False, False),
    ("ragged", (2, 7, 9, 5), 6, 3, 1, "leaky", True, False),
    ("ragged requant", (2, 7, 9, 5), 6, 3, 1, "leaky", True, True),
    ("ragged S=4", (1, 7, 9, 5), 3, 4, 2, "tanh", False, True),
    ("ragged 1x1", (3, 7, 9, 5), 70, 1, 0, "none", False, False),
    ("partial M tile", (1, 5, 27, 4 * CD), 4 * CD, 3, 1, "leaky", True, False),
    ("W=200", (2, 6, 200, 4 * CD), 4 * CD, 3, 1, "none", True, True),
    ("Cout=192", (2, 8, 64, 4 * CD), 192, 3, 1, "leaky", True, True),
]
# kernel F's cases: (what, (N, L, W, Cin), Cout, S, s0, act)
F_CASES = [
    ("dec4 shape", (2, HP, HP, 8 * CD), 4 * CD, 3, 1, "leaky"),
    ("S=5", (2, 64, 64, 4 * CD), 4 * CD, 5, 2, "tanh"),
    ("ragged S=4", (2, 7, 9, 5), 6, 4, 2, "none"),
    ("ragged 1x1", (1, 7, 9, 5), 70, 1, 0, "leaky"),
    ("partial M tile", (1, 5, 27, 4 * CD), 4 * CD, 3, 1, "leaky"),
    ("W=200", (2, 6, 200, 4 * CD), 4 * CD, 3, 1, "none"),
    ("Cout=192", (2, 8, 64, 4 * CD), 192, 3, 1, "tanh"),
]
# phase 7: (bucket, substrings of the kernel name), first match wins
BUCKETS = [
    ("packed_conv_int8 kernel (E)", ("Int8Epilogue",)),
    ("packed_conv kernel (F)", ("FloatEpilogue", "conv_f32")),
    ("gam_stats kernel (A)", ("gam_stats_kernel",)),
    ("gam_stats_bwd kernel (A')", ("gam_stats_bwd_kernel",)),
    ("upsample2x_bwd kernel (B')", ("upsample2x_bwd_kernel",)),
    ("upsample2x kernel (B)", ("upsample2x_ac",)),
    ("s2d_convert kernel (C)", ("s2d_convert_kernel",)),
    ("residual_tail_d2s kernel (D)", ("residual_tail_d2s_kernel",)),
    ("reflect pad", ("reflection_pad",)),
    ("concat", ("CatArrayBatchedCopy", "cat_")),
    ("row gathers (index_select)", ("indexSelect", "index_select")),
    ("optimizer (Adam)", ("multi_tensor_apply", "Adam", "adam")),
    ("conv backward (cuDNN dgrad, wgrad)", ("dgrad", "wgrad")),
    ("convolutions (cuDNN)", ("fprop", "conv", "implicit", "cudnn", "winograd")),
    ("max pool", ("max_pool",)),
    ("matmuls (einsum, int8 _int_mm)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "imma")),
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


PTXAS_SOURCES = ("packed_conv.cu", "packed_conv_int8.cu", "gam_stats.cu", "s2d_fuse.cu",
                 "gam_stats_bwd.cu", "upsample2x.cu")


def kernel_name(mangled: str) -> str:
    """A readable name for a kernel's mangled name: E's and F's tensor-core
    instantiations by epilogue, the others by template arguments."""
    e = re.search(r"(Int8Epilogue|FloatEpilogue)I((?:L[ib]\d+E)+)E", mangled)
    if e:
        return f"conv_kernel<{e.group(1)}<{','.join(re.findall(r'\d+', e.group(2)))}>>"
    if "conv_f32" in mangled:
        return "conv_f32"
    found = None  # the last length-prefixed name that ends in _kernel<...>
    for m in re.finditer(r"(?=(\d+))", mangled):  # each digit run and its tails
        at = m.start() + len(m.group(1))
        base = mangled[at:at + int(m.group(1))]
        if base.endswith("_kernel") and mangled[at + len(base):].startswith("I"):
            found = (base, at + len(base) + 1)
    if found is None:
        return mangled[:60]
    base, rest, args = found[0], mangled[found[1]:], []
    while rest:
        t = re.match(r"f|13__nv_bfloat16|Li(\d+)E|S\w*?_", rest)
        if not t:
            break
        tok = t.group(0)
        args.append(args[-1] if tok.startswith("S") and args else
                    {"f": "f32", "13__nv_bfloat16": "bf16"}.get(tok, t.group(1)))
        rest = rest[t.end():]
    return f"{base}<{','.join(args)}>"


def ptxas_summary(report: dict, tc_smem: int) -> list:
    """One line a kernel of the sources of E, F, A, A', B' and C (D and B
    share the sources of C and B') from ptxas's -v report: registers,
    spills and static shared memory (the tensor-core body's and C's are
    dynamic)."""
    out = []
    for src in PTXAS_SOURCES:
        name, spill = None, "?"
        for ln in report.get(src, []):
            m = re.search(r"Compiling entry function '(\w+)'", ln)
            if m:
                name = kernel_name(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", ln)
            if m and name:
                static = re.search(r"(\d+) bytes smem", ln)
                if static:
                    smem = f"{static.group(1)} B static shared memory"
                elif "Epilogue" in name:
                    smem = f"{tc_smem} B dynamic shared memory"
                elif name.startswith("s2d_convert"):
                    smem = "dynamic shared memory from its plan"
                else:
                    smem = "no shared memory"
                out.append(f"{src} {name}: {m.group(1)} registers, {spill}, {smem}")
                name, spill = None, "?"
    return out


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
    if not got.is_floating_point():
        return bool(torch.equal(got, want))
    as_int = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    same = got.view(as_int) == want.view(as_int)
    return bool(torch.equal(nan_g, nan_w) and (same | nan_g).all())


def one_past(t):
    """A contiguous copy of t that starts one element past a 16-byte boundary."""
    import torch

    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


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


def graph_ms(fn, iters: int, replays: int = 5) -> float:
    """Device-only ms per call of fn(): ``iters`` calls captured in one CUDA
    graph (after warm-up on the capture stream), the graph replayed
    ``replays`` times between CUDA events, so no host work sits between the
    calls' kernels."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the warm-up stream, whose kernel-A tickets already exist
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (replays * iters)
    del graph
    return ms


def profiler_ms(fn, iters: int) -> float:
    """Device ms per call of fn(): the summed device time of the kernels its
    ``iters`` calls launch, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if str(getattr(e, "device_type", "")).endswith("CUDA")]
    if not events:
        raise AssertionError("torch.profiler recorded no device kernel")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters


DEVICE_METHODS = set()  # how the device-only times were taken: "graph", "profiler"


def device_ms(fn, iters: int) -> float:
    """Device-only ms per call: CUDA-graph replay, or where fn() cannot be
    captured, the profiler's device time of its own kernels."""
    import torch

    try:
        ms = graph_ms(fn, iters)
        DEVICE_METHODS.add("graph")
    except Exception as e:  # capture refused: no graph, take the profiler's view
        torch.cuda.synchronize()
        log("7 timing", f"graph capture failed ({type(e).__name__}: {str(e)[:120]}); "
                        f"profiler device time instead")
        ms = profiler_ms(fn, iters)
        DEVICE_METHODS.add("profiler")
    return ms


def turns(fns: dict, iters: int) -> dict:
    """Each function's ms per call two ways, each the mean of two runs in
    the order of ``fns`` and back: ``eager`` from CUDA events around
    back-to-back calls from the host, ``device`` device-only (device_ms)."""
    order = list(fns) + list(fns)[::-1]
    out = {}
    for how, timer in (("eager", cuda_ms), ("device", device_ms)):
        t = {k: [] for k in fns}
        for k in order:
            t[k].append(timer(fns[k], iters))
        out[how] = {k: sum(v) / len(v) for k, v in t.items()}
    return out


def ring_calls(fn, ring: int):
    """A function that calls fn(i) with i going round 0 .. ring - 1, one step
    a call, so that each call takes the next of ``ring`` input sets."""
    state = {"i": 0}

    def call():
        state["i"] = (state["i"] + 1) % ring
        return fn(state["i"])
    return call


@contextlib.contextmanager
def plain_versions():
    """Route both generator forwards through the kernels' plain PyTorch versions."""
    from uegan_tpu_torch.infer import packed, quantized
    from uegan_tpu_torch.models import blocks, generator
    from uegan_tpu_torch.ops import gam_stats, packed_conv_int8, resize2x, s2d_fuse

    swaps = [(blocks, "gam_mean_std", gam_stats.plain),
             (generator, "upsample2x", resize2x.plain), (packed, "upsample2x", resize2x.plain)]
    for mod in (packed, quantized):
        swaps += [(mod, "s2d_convert", s2d_fuse.plain_s2d_convert),
                  (mod, "residual_tail_d2s", s2d_fuse.plain_residual_tail_d2s)]
    swaps.append((quantized, "packed_conv_int8", packed_conv_int8.plain_packed_conv_int8))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def library_s2d(x):
    """C's function in one PyTorch call: the permuted view cast into
    contiguous bfloat16 memory (one copy kernel), viewed packed."""
    import torch

    n, h, w, c = x.shape
    return x.view(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5).to(
        torch.bfloat16, memory_format=torch.contiguous_format).view(n, h // 2, w // 2, 4 * c)


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
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std, gam_mean_std_backward
    from uegan_tpu_torch.ops.packed_conv import packed_conv
    from uegan_tpu_torch.ops.packed_conv_int8 import packed_conv_int8
    from uegan_tpu_torch.ops.resize2x import upsample2x, upsample2x_backward
    from uegan_tpu_torch.ops.s2d_fuse import residual_tail_d2s, s2d_convert

    return {"gam_stats": gam_mean_std, "upsample2x": upsample2x, "s2d_convert": s2d_convert,
            "residual_tail_d2s": residual_tail_d2s, "packed_conv_int8": packed_conv_int8,
            "packed_conv": packed_conv, "gam_stats_bwd": gam_mean_std_backward,
            "upsample2x_bwd": upsample2x_backward}


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
    cases += [("gam_stats", s) for s in GAM_EXTRA]
    cases += [("gam_stats misaligned", (4, 64, 64, 32))]
    run = {"gam_stats": (lambda x: torch.cat(gam_stats.gam_mean_std(x), -1),
                         lambda x: torch.cat(gam_stats.plain(x), -1)),
           "upsample2x": (resize2x.upsample2x, resize2x.plain)}
    run["gam_stats misaligned"] = run["gam_stats"]
    for what, shape in cases:
        name = what.split()[0]
        kern, plain = run[what]
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
            if what.endswith("misaligned"):
                x = one_past(x)
            got = kern(x)
            if name == "gam_stats":
                again = kern(x)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.uint8), again.view(torch.uint8)):
                    raise AssertionError(f"gam_stats {shape} {dtype}: two calls differ in bits")
            want = plain(x.double()).to(dtype)
            plain32 = plain(x)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dtype:
                raise AssertionError(f"{name} {shape} {dtype}: got {got.shape} {got.dtype}")
            err, rel, ok = compare(got, want, dtype)
            perr = compare(plain32, want, dtype)[0]
            tag = "f32" if dtype == torch.float32 else "bf16"
            same = ", two calls bit-equal" if name == "gam_stats" else ""
            log("3 kernels", f"{what} {shape} {tag}: max abs {err:.3e} max rel {rel:.3e} "
                             f"{'ok' if ok else 'OUT OF TOLERANCE'} (plain in {tag}: "
                             f"max abs {perr:.3e}){same}")
            if not ok:
                raise AssertionError(f"{what} {shape} {tag} disagrees with its plain version")
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

    def check(name, shape, what, got, want, payloads=False):
        """Bit-equal; with ``payloads``, NaN payloads included."""
        torch.cuda.synchronize()
        ok = bits_equal(got, want)
        if payloads:
            as_int = torch.int16 if got.dtype == bf16 else torch.int32
            ok = ok and torch.equal(got.view(as_int), want.view(as_int))
        d = (got.float() - want.float()).abs().nan_to_num(0.0)
        err = float(d.max()) if d.numel() else 0.0
        worst[name] = max(worst[name], err)
        log("3 kernels", f"{name} {shape} {what}: {'bit-equal' if ok else 'DIFFERS'} "
                         f"(max abs {err:.3e})")
        if not ok:
            raise AssertionError(f"{name} {shape} {what} differs from its plain version")

    def with_nans(x):
        """x with NaNs of several payloads (and +-inf) at its first elements."""
        as_int = torch.int16 if x.dtype == bf16 else torch.int32
        bits = ([0x7FC1, 0xFF81, 0x7F81, 0x7F80, 0xFF80] if x.dtype == bf16 else
                [0x7FC00001, 0xFF800005, 0x7F800123, 0x7F800000, 0xFF800000])
        bits = [b - (b >> (x.element_size() * 8 - 1) << x.element_size() * 8) for b in bits]
        x = x.clone()
        flat = x.view(-1).view(as_int)
        k = min(len(bits), flat.numel())
        flat[:k] = torch.tensor(bits[:k], dtype=as_int, device=dev)
        return x

    for n, h, w, c in S2D_SHAPES:
        x = torch.rand((n, h, w, c), generator=gen, device=dev) * 2 - 1
        for tin in (f32, bf16):
            for tout in (f32, bf16):
                xi = with_nans(x.to(tin))
                check("s2d_convert", (n, h, w, c), f"{tag[tin]} -> {tag[tout]} with NaN/inf",
                      s2d_fuse.s2d_convert(xi, tout), s2d_fuse.plain_s2d_convert(xi, tout),
                      payloads=tin == tout)
    # a contiguous input 4 bytes past a 16-byte boundary: C's narrow words
    shape = S2D_SHAPES[0]
    for tin in (f32, bf16):
        x = (torch.rand(shape, generator=gen, device=dev) * 2 - 1).to(tin)
        step = 4 // x.element_size()
        xm = torch.empty(x.numel() + step, dtype=tin, device=dev)[step:].view(shape).copy_(x)
        if xm.data_ptr() % 16 != 4 or not xm.is_contiguous():
            raise AssertionError(f"the misaligned input sits at {xm.data_ptr() % 16} mod 16")
        for tout in (f32, bf16):
            check("s2d_convert", shape, f"{tag[tin]} -> {tag[tout]}, input 4 B misaligned",
                  s2d_fuse.s2d_convert(xm, tout), s2d_fuse.plain_s2d_convert(xm, tout),
                  payloads=tin == tout)
    for n, h, w, c in S2D_SHAPES:
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


def e_inputs(shape, cout, S, use_mul, gen, dev) -> tuple:
    """Kernel E's operands: int8 x and OIHW k over the whole int8 range,
    per-channel scales that put the dequantized sums near N(0, 1), a small
    bias, and a bf16 factor of the output's shape when ``use_mul``."""
    import torch

    n, l, w, cin = shape
    xq = torch.randint(-127, 128, shape, generator=gen, device=dev).to(torch.int8)
    kq = torch.randint(-127, 128, (cout, cin, S, S), generator=gen, device=dev).to(torch.int8)
    unit = 1.0 / (73.3 * 73.3 * math.sqrt(S * S * cin))  # 1 / std of the int32 sums
    ws = (torch.rand(cout, generator=gen, device=dev) + 0.5) * unit
    bias = torch.randn(cout, generator=gen, device=dev) * 0.1
    mul = None
    if use_mul:
        mul = torch.randn((n, l, w, cout), generator=gen, device=dev).to(torch.bfloat16)
    return xq, kq, ws, bias, mul


def phase_int8_kernels(dev) -> dict:
    """E against its plain version (conv2d_int8, an exact int32 sum, then
    the same f32 epilogue): bit-equal in every column (both zero-pad), tanh
    within one bf16 ulp or one int8 step.  F against its plain version run
    in float64 and rounded, with A's and B's tolerances."""
    import torch

    from uegan_tpu_torch.ops import packed_conv as fmod
    from uegan_tpu_torch.ops import packed_conv_int8 as emod

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = {"packed_conv_int8": 0.0, "packed_conv": 0.0}
    for what, shape, cout, S, s0, act, use_mul, requant in E_CASES:
        xq, kq, ws, bias, mul = e_inputs(shape, cout, S, use_mul, gen, dev)
        kw = dict(act=act, mul=mul, out_scale=0.02, requant=requant)
        got = emod.packed_conv_int8(xq, kq, ws, bias, s0, **kw)
        want = emod.plain_packed_conv_int8(xq, kq, ws, bias, s0, **kw)
        torch.cuda.synchronize()
        d = (got.float() - want.float()).abs()
        err = float(d.max())
        worst["packed_conv_int8"] = max(worst["packed_conv_int8"], err)
        if act == "tanh":
            lim = torch.ones_like(d) if requant else bf16_ulp(want)
            ok = got.dtype == want.dtype and bool((d <= lim).all())
            verdict = f"within one {'int8 step' if requant else 'bf16 ulp'}"
        else:
            ok = bits_equal(got, want)
            verdict = "bit-equal"
        log("3 kernels", f"packed_conv_int8 {what} {shape} -> {cout}, S={S} s0={s0} {act}"
                         f"{' mul' if use_mul else ''}{' requant' if requant else ''}: "
                         f"{verdict if ok else 'DIFFERS'} (max abs {err:.3e}, differing "
                         f"{int((d > 0).sum())} of {d.numel()})")
        if not ok:
            raise AssertionError(f"packed_conv_int8 {what} differs from its plain version")
    for what, shape, cout, S, s0, act in F_CASES:
        x = torch.randn(shape, generator=gen, device=dev)
        k = torch.randn((cout, shape[-1], S, S), generator=gen, device=dev) / math.sqrt(
            S * S * shape[-1])
        b = torch.randn(cout, generator=gen, device=dev) * 0.1
        for dtype in (torch.float32, torch.bfloat16):
            xd, kd, bd = x.to(dtype), k.to(dtype), b.to(dtype)
            got = fmod.packed_conv(xd, kd, bd, s0, act)
            want = fmod.plain_packed_conv(xd.double(), kd.double(), bd.double(), s0, act).to(dtype)
            torch.cuda.synchronize()
            err, rel, ok = compare(got, want, dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            log("3 kernels", f"packed_conv {what} {shape} -> {cout}, S={S} s0={s0} {act} {tag}: "
                             f"max abs {err:.3e} max rel {rel:.3e} "
                             f"{'ok' if ok else 'OUT OF TOLERANCE'} (plain in f64)")
            if not ok:
                raise AssertionError(f"packed_conv {what} {tag} disagrees with its plain version")
            if dtype == torch.float32:
                worst["packed_conv"] = max(worst["packed_conv"], err)
    return worst


def phase_backward_kernels(dev) -> dict:
    """A' and B' against their plain versions run in float64 and rounded, at
    every shape the 256 px train step (batch 10, so 20 images through G)
    gives them and at ragged ones, float32 and bfloat16, with A's and B's
    tolerances; A' on the f32 mean and var that kernel A writes for it (and
    A's mean and std with them bit-equal to A's without).  Then each
    autograd Function's gradient (kernels, float32) against central
    differences of its plain forward in float64 at a small shape; the
    refusal of C, D, E and F to run where autograd would need their
    gradient; and kernel A on two streams at once, against serial calls."""
    import torch

    from uegan_tpu_torch.ops import gam_stats, packed_conv, packed_conv_int8, resize2x, s2d_fuse

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    f32, bf16 = torch.float32, torch.bfloat16
    worst = {"gam_stats_bwd": 0.0, "upsample2x_bwd": 0.0}
    randn = lambda shape: torch.randn(shape, generator=gen, device=dev)
    # (shape, a constant channel, which input lies one element past 16 bytes)
    for shape, const, shifted in [((TRAIN_B2, h, h, c), False, None)
                                  for h, c in TRAIN_GAM_SHAPES] + GAM_BWD_EDGES:
        n, _, _, c = shape
        for dtype in (f32, bf16):
            x = randn(shape) * 2 + 1
            if const:
                x[..., 0] = 0.3
            x = x.to(dtype)
            if shifted == "x":
                x = one_past(x)
            mean, std, m32, v32 = gam_stats._launch(x, 1e-5, keep32=True)
            m0, s0 = gam_stats.gam_mean_std(x)
            dm, ds = randn((n, 1, 1, c)).to(dtype), randn((n, 1, 1, c)).to(dtype)
            if shifted == "dmean":
                dm = one_past(dm)
            got = gam_stats.gam_mean_std_backward(x, m32, v32, dm, ds)
            want = gam_stats.plain_backward(x.double(), m32.double(), v32.double(), dm.double(),
                                            ds.double()).to(dtype)
            torch.cuda.synchronize()
            same = torch.equal(mean.view(torch.uint8), m0.view(torch.uint8)) and torch.equal(
                std.view(torch.uint8), s0.view(torch.uint8))
            err, rel, ok = compare(got, want, dtype)
            tag = "f32" if dtype == f32 else "bf16"
            edge = ((" constant channel" if const else "")
                    + (f" {shifted} shifted" if shifted else ""))
            log("3 kernels", f"gam_stats_bwd {shape}{edge} {tag}: "
                             f"max abs {err:.3e} max rel {rel:.3e} "
                             f"{'ok' if ok else 'OUT OF TOLERANCE'} (plain in f64); A's mean and "
                             f"std with the f32 outputs {'bit-equal' if same else 'DIFFER'}")
            if not (ok and same):
                raise AssertionError(f"gam_stats_bwd {shape} {tag} disagrees with its plain version")
            if dtype == f32:
                worst["gam_stats_bwd"] = max(worst["gam_stats_bwd"], err)
    # (dx shape, dy one element past 16 bytes, the plan's wave where not one
    # of the card's)
    for (n, h, w, c), shifted, wave in [((TRAIN_B2, h, h, c), False, None)
                                        for h, c in TRAIN_UP_SHAPES] + UP_BWD_EDGES:
        for dtype in (f32, bf16):
            dy = randn((n, 2 * h, 2 * w, c)).to(dtype)
            if shifted:
                dy = one_past(dy)
            plan = resize2x.backward_plan(n, h, w, c, dy.element_size(), dy.data_ptr() % 16,
                                          **({} if wave is None else {"wave": wave}))
            got = (resize2x.upsample2x_backward(dy) if wave is None
                   else resize2x._launch_backward(dy, plan))
            want = resize2x.plain_backward(dy.double()).to(dtype)
            torch.cuda.synchronize()
            err, rel, ok = compare(got, want, dtype)
            tag = "f32" if dtype == f32 else "bf16"
            log("3 kernels", f"upsample2x_bwd dy {(n, 2 * h, 2 * w, c)}"
                             f"{' shifted' if shifted else ''} {tag}, {plan}: max abs {err:.3e} "
                             f"max rel {rel:.3e} {'ok' if ok else 'OUT OF TOLERANCE'} "
                             f"(plain in f64)")
            if not ok:
                raise AssertionError(f"upsample2x_bwd {(n, h, w, c)} {tag} disagrees with its "
                                     "plain version")
            if dtype == f32:
                worst["upsample2x_bwd"] = max(worst["upsample2x_bwd"], err)

    # the Functions' gradients against central differences in float64
    def numeric_vjp(fn, x64, cot, h=1e-6):
        flat = x64.view(-1)
        out = torch.empty_like(flat)
        for i in range(flat.numel()):
            keep = float(flat[i])
            flat[i] = keep + h
            up = fn(x64)
            flat[i] = keep - h
            down = fn(x64)
            flat[i] = keep
            out[i] = sum(((a - b) * c).sum() for a, b, c in zip(up, down, cot)) / (2 * h)
        return out.view_as(x64)

    for name, shape, fn, plain, outs in (
            ("gam_stats", (2, 4, 3, 8), gam_stats.gam_mean_std, gam_stats.plain,
             lambda s: [(s[0], 1, 1, s[3])] * 2),
            ("upsample2x", (2, 4, 3, 8), resize2x.upsample2x, lambda t: (resize2x.plain(t),),
             lambda s: [(s[0], 2 * s[1], 2 * s[2], s[3])])):
        x64 = randn(shape).double() * 2 + 1
        cot = [randn(s).double() for s in outs(shape)]
        x32 = x64.float().requires_grad_()
        got = fn(x32)
        got = got if isinstance(got, tuple) else (got,)
        (g,) = torch.autograd.grad(got, x32, [c.float() for c in cot])
        want = numeric_vjp(lambda t: tuple(plain(t)), x64.clone(), cot)
        err = float((g.double() - want).abs().max())
        lim = 1e-4 * float(want.abs().max()) + 1e-5
        log("3 kernels", f"{name} Function {shape} f32: gradient (kernels) vs central "
                         f"differences of the plain forward in f64: max abs {err:.3e} (limit "
                         f"{lim:.3e})")
        if err > lim:
            raise AssertionError(f"{name}'s autograd Function disagrees with finite differences")

    # C, D, E and F have no backward: they refuse inputs that need a gradient
    x = torch.rand((1, 4, 4, 3), device=dev, requires_grad=True)
    r = torch.rand((1, 2, 2, 12), device=dev, requires_grad=True)
    xq = torch.randint(-127, 128, (1, 4, 4, 8), device=dev, dtype=torch.int8)
    kq = torch.randint(-127, 128, (8, 8, 1, 1), device=dev, dtype=torch.int8)
    ws = torch.rand(8, device=dev, requires_grad=True)
    xf = torch.rand((1, 4, 4, 8), device=dev, requires_grad=True)
    kf, bf = torch.rand((8, 8, 3, 3), device=dev), torch.rand(8, device=dev)
    before = counts()
    for name, call in (("s2d_convert", lambda: s2d_fuse.s2d_convert(x)),
                       ("residual_tail_d2s", lambda: s2d_fuse.residual_tail_d2s(r, r.detach())),
                       ("packed_conv_int8", lambda: packed_conv_int8.packed_conv_int8(
                           xq, kq, ws, bf, 0)),
                       ("packed_conv", lambda: packed_conv.packed_conv(xf, kf, bf, 1))):
        try:
            call()
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            log("3 kernels", f"{name} on an input that requires grad: refused ({str(e)[:60]}...)")
        else:
            raise AssertionError(f"{name} ran on an input that requires grad")
    check_counts("the refused calls", counts(), before)

    # kernel A on two streams at once: each stream has its own tickets.  Small
    # maps (one split an image, 8 blocks a call) run side by side whole;
    # large ones (a wave of blocks a call) overlap at their tails
    for shape, n, rounds in (((8, 16, 16, 64), 16, 5), ((8, 256, 256, 64), 6, 3)):
        if not two_streams_agree(gam_stats, [[randn(shape).to(bf16) for _ in range(n)]
                                             for _ in range(rounds)]):
            raise AssertionError("kernel A on two streams disagrees with serial calls")
    return worst


def two_streams_agree(gam_stats, rounds: list, what: str = "3 kernels") -> bool:
    """Kernel A over each round's inputs on two streams at once, alternating,
    against serial calls: the same bits, and every stream's tickets back at
    zero.  Every round takes new inputs, so an output that a call left
    unwritten holds another round's numbers and shows."""
    import torch

    serial = [[torch.cat(gam_stats.gam_mean_std(x), -1) for x in xs] for xs in rounds]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    same = True
    for xs, want in zip(rounds, serial):
        # each stream first sleeps ~10 ms on the card, so that the host has
        # queued every call behind it and the two streams' kernels then run
        # side by side, not one per host launch
        for s in streams:
            with torch.cuda.stream(s):
                torch.cuda._sleep(20_000_000)
        outs = [None] * len(xs)
        for i, x in enumerate(xs):
            with torch.cuda.stream(streams[i % 2]):
                outs[i] = torch.cat(gam_stats.gam_mean_std(x), -1)
        torch.cuda.synchronize()
        same &= all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(outs, want))
    zero = all(int(t.abs().sum()) == 0 for t in gam_stats._tickets.values())
    log(what, f"gam_stats on two streams at once, {len(rounds)} rounds of {len(rounds[0])} "
              f"inputs {tuple(rounds[0][0].shape)}: results "
              f"{'bit-equal to serial calls' if same else 'DIFFER'}, {len(gam_stats._tickets)} "
              f"ticket sets {'all back at zero' if zero else 'NOT ZERO'}")
    return same and zero


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


def psnr_pm1(a, b) -> float:
    """PSNR of two [-1, 1] images (peak 2), as tests/test_quantized.py takes it."""
    mse = float(((a.double() - b.double()) ** 2).mean())
    return 10 * math.log10(4.0 / max(mse, 1e-12))


def phase_int8_model(dev) -> None:
    """The int8 and int8_pallas forwards of the default generator (cd 32,
    seeded weights, 512 px, B=2), calibrated on their input: against the
    bf16 packed forward (>= 30 dB), against each other (<= 0.02), with the
    kernels against the plain versions (>= 40 dB, max abs <= 0.05: in bf16,
    A's and B's last-ulp differences from their plain versions move the
    interior, and an int8 code that flips at a rounding boundary moves the
    output by a few bf16 steps; the tolerance of the port-vs-JAX test of
    this forward), and their launches."""
    import torch

    from uegan_tpu_torch.infer import quantized

    g, _ = seeded_generator(torch.bfloat16, dev)
    x = torch.rand((2, IMG, IMG, 3), generator=torch.Generator(device=dev).manual_seed(SEED),
                   device=dev) * 2 - 1
    zero = dict.fromkeys(KERNELS, 0)
    outs = {}
    with torch.inference_mode():
        tabs = quantized.build_quant_tables(g, calib_batch=x)
        bf = packed_forward(g)(x)
        for mode in ("int8", "int8_pallas"):
            fwd = quantized.make_int8_eval(g, tabs, use_pallas=mode == "int8_pallas")
            reset_counts()
            outs[mode] = fwd(x)
            torch.cuda.synchronize()
            run = counts()
            with plain_versions():
                plain = fwd(x)
            torch.cuda.synchronize()
            check_counts(f"the plain {mode} forward", counts(), run)
            check_counts(f"one {mode} forward", run, {
                **zero, "gam_stats": 4, "upsample2x": 3, "s2d_convert": 1,
                "residual_tail_d2s": 1, "packed_conv_int8": int(mode == "int8_pallas")})
            t = outs[mode]
            if not bool(torch.isfinite(t).all()) or t.shape != x.shape:
                raise AssertionError(f"{mode} output: shape {tuple(t.shape)}, finite "
                                     f"{bool(torch.isfinite(t).all())}")
            p = psnr_pm1(t, bf)
            dk = (t.float() - plain.float()).abs()
            pk = psnr_pm1(t, plain)
            log("4 model", f"cd32 {IMG}px B=2 {mode}: vs bf16 packed forward {p:.2f} dB (limit "
                           f">= 30), max abs {float((t.float() - bf.float()).abs().max()):.4f}; "
                           f"kernels vs plain {pk:.2f} dB (limit >= 40), max abs "
                           f"{float(dk.max()):.3e} (limit 0.05), {int((dk > 0.02).sum())} of "
                           f"{dk.numel()} over 0.02; launches per forward {run}")
            if p < 30.0 or pk < 40.0 or float(dk.max()) > 0.05:
                raise AssertionError(f"{mode}: {p:.2f} dB from bf16, kernels vs plain {pk:.2f} "
                                     f"dB, max {float(dk.max())}")
    d = float((outs["int8_pallas"].float() - outs["int8"].float()).abs().max())
    log("4 model", f"int8_pallas vs int8: max abs {d:.3e} (limit 0.02); scales {tabs['sc']}")
    if d > 0.02:
        raise AssertionError(f"int8_pallas differs from int8 by {d}")


def phase_end_to_end(dev, tmp: str) -> dict:
    """``--mode test`` three times: canonical, packed, and int8 packed with
    kernel E (``--quantized_inference int8_pallas``); each run's launches.
    The int8 run calibrates once on its first batch, a bf16 packed forward
    that launches A 4, B 3 and C 1 times."""
    import numpy as np
    import torch

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    rng = np.random.default_rng(SEED)
    test_dir = os.path.join(tmp, "fivek", "test")
    names = write_pairs(test_dir, ("label", "raw"), 8, (IMG, IMG), rng)
    _, sd = seeded_generator(torch.float32, "cpu")
    raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in names])
    g32, _ = seeded_generator(torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode(), plain_versions():
        want = torch.cat([quantize_u8(g32(normalize_u8(torch.from_numpy(raw[i:i + 4]).to(dev))))
                          for i in (0, 4)]).cpu().numpy()
    torch.backends.cudnn.allow_tf32 = True

    zero = dict.fromkeys(KERNELS, 0)
    expect = {"canonical": {**zero, "gam_stats": 10, "upsample2x": 8},
              "packed": {**zero, "s2d_convert": 2, "residual_tail_d2s": 2, "upsample2x": 6},
              "int8_pallas": {**zero, "packed_conv_int8": 2, "gam_stats": 12, "upsample2x": 9,
                              "s2d_convert": 3, "residual_tail_d2s": 2}}
    flags = {"canonical": ["--packed_inference", "false"], "packed": [],
             "int8_pallas": ["--quantized_inference", "int8_pallas"]}
    limit = {"canonical": 35.0, "packed": 35.0, "int8_pallas": 30.0}
    launches = {}
    for path in ("canonical", "packed", "int8_pallas"):
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
        argv += flags[path]
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
                            f"{psnr:.2f} dB (limit >= {limit[path]:g}), max |du8| "
                            f"{int(diff.max())}, mean |du8| {diff.mean():.4f}; {secs:.1f} s")
        if psnr < limit[path]:
            raise AssertionError(f"{path} bf16 outputs only {psnr:.2f} dB from the f32 forward")
        launches[path] = launched
    return launches


def write_pairs(root: str, subs, n: int, hw, rng, stem: str = "a") -> list:
    """n PNG pairs of smooth gradients with noise under root/{subs}; names."""
    import numpy as np
    from PIL import Image

    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    names = [f"{stem}{i:04d}" for i in range(n)]
    for name in names:
        for sub in subs:
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            base = np.stack([yy * rng.uniform(0.3, 1), xx * rng.uniform(0.3, 1),
                             (yy + xx) / 2 * rng.uniform(0.3, 1)], -1)
            img = np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, sub, name + ".png"))
    return names


def train_config(dtype: str, **kw):
    from uegan_tpu_torch.config import Config

    return Config(mode="train", g_conv_dim=CD, d_conv_dim=CD, image_size=2 * TRAIN_HW,
                  resize_size=TRAIN_HW, train_batch_size=TRAIN_B, compute_dtype=dtype,
                  is_test_nima=False, **kw)


def seeded_train_state(dtype: str, dev):
    """The train state at full width (cd 32, dd 32, VGG19 to relu5_1) with
    N(0, 1/fan_in) weights from the seed, as phase 4's generator has."""
    import torch

    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.train.state import create_train_state

    state = create_train_state(train_config(dtype), dev, (TRAIN_HW, TRAIN_HW), 1000)
    for i, m in enumerate((state.g, state.d, state.vgg)):
        sd = fan_in_normal_state(m, SEED + i)
        m.load_state_dict({k: torch.from_numpy(v).to(dev) for k, v in sd.items()})
    return state


def train_batches(dev, k: int) -> list:
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    shape = (TRAIN_B, TRAIN_HW, TRAIN_HW, 3)
    return [(torch.rand(shape, generator=gen, device=dev) * 2 - 1,
             torch.rand(shape, generator=gen, device=dev) * 2 - 1) for _ in range(k)]


def train_step_ms(step, batches: list, k: int = 5) -> float:
    """ms per train step: host clock around k steps on the batches in turn,
    after 2 of warm-up, each end synchronized."""
    import torch

    for b in batches[:2]:
        step(*b)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(k):
        step(*batches[i % len(batches)])
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / k * 1e3


def phase_train(dev, card: str, tmp: str) -> dict:
    """The train slice at full width (cd 32, dd 32, 256 px crops of 512,
    batch 10, rahinge with adv_input, spectral norm in D, fused D phases,
    pool 50, bf16 with f32 parameters, seeded weights):

    - ``--mode train`` through uegan_tpu_torch.cli.run (what ``python -m
      uegan_tpu_torch`` calls) on a synthetic FiveK layout of 30 pairs
      (3 steps, validation at the end of the epoch), launches counted, then
      ``--mode test`` on the .pth it wrote;
    - in process, 2 steps from one state with the kernels and with the plain
      versions in float32, TF32 off, deterministic cuDNN: losses within rel
      1e-4; parameters within 1e-4 but for at most 1e-3 of them (where
      Adam's normalized first steps divide a gradient that nearly cancels),
      by at most the two steps' 4 lr;
    - 2 bf16 steps: finite losses, both nets' parameters moved;
    - one bf16 step's launches: A 5, B 4, A' 5, B' 4;
    - step time and images/s with the kernels and with the plain versions,
      peak memory, and the step's device time by bucket under torch.profiler."""
    import numpy as np
    import torch

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.train.step import make_train_step

    zero = dict.fromkeys(KERNELS, 0)
    per_step = {**zero, "gam_stats": 5, "upsample2x": 4, "gam_stats_bwd": 5, "upsample2x_bwd": 4}
    rng = np.random.default_rng(SEED)
    data = os.path.join(tmp, "fivek_train")
    write_pairs(os.path.join(data, "train"), ("exp", "raw"), 3 * TRAIN_B,
                (2 * TRAIN_HW + 32, 2 * TRAIN_HW + 64), rng)
    for part in ("val", "test"):
        write_pairs(os.path.join(data, part), ("label", "raw"), 2, (IMG, IMG), rng)
    root = os.path.join(tmp, "results_train")
    common = ["--save_root_dir", root, "--g_conv_dim", str(CD), "--d_conv_dim", str(CD),
              "--test_img_size", str(IMG), "--val_batch_size", "2", "--is_test_nima", "false",
              "--is_test_psnr_ssim", "true", "--compute_dtype", "bfloat16", "--num_workers", "8"]
    argv = ["--mode", "train", "--train_img_dir", os.path.join(data, "train"),
            "--val_img_dir", os.path.join(data, "val"),
            "--val_label_dir", os.path.join(data, "val", "label") + os.sep,
            "--image_size", str(2 * TRAIN_HW), "--resize_size", str(TRAIN_HW),
            "--train_batch_size", str(TRAIN_B), "--pool_size", "50", "--total_epochs", "1",
            "--num_epochs_start_val", "0", "--val_each_epochs", "1", "--info_step", "1",
            "--sample_step", "3"] + common
    t0 = time.time()
    reset_counts()
    res = cli.run(argv)
    torch.cuda.synchronize()
    cli_counts = counts()
    secs = time.time() - t0
    want = {k: 3 * v for k, v in per_step.items()}
    want["gam_stats"] += 5  # the validation forward (2 images, one batch)
    want["upsample2x"] += 4
    check_counts("--mode train (3 steps and one validation batch)", cli_counts, want)
    losses = res["last_losses"]
    pth = os.path.join(root, "UEGAN-FiveK", "models", "UEGAN-FiveK_rahinge_1.pth")
    if res["steps"] != 3 or not os.path.exists(pth) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"--mode train: {res}, checkpoint {os.path.exists(pth)}")
    log("6 train", f"python -m uegan_tpu_torch --mode train, cd {CD} dd {CD}, {TRAIN_HW} px crops "
                   f"of {2 * TRAIN_HW}, B={TRAIN_B}, bf16, 30 pairs: 3 steps in {secs:.1f} s with "
                   f"validation, last losses {losses}; launches {cli_counts}; wrote "
                   f"{os.path.basename(pth)}")
    test_dir = os.path.join(data, "test")
    res = cli.run(["--mode", "test", "--test_img_dir", test_dir, "--test_label_dir",
                   os.path.join(test_dir, "label") + os.sep, "--pretrained_model", "1"] + common)
    if res["n_images"] != 2 or not math.isfinite(res["psnr"]):
        raise AssertionError(f"--mode test on the trained .pth: {res}")
    log("6 train", f"--mode test on {os.path.basename(pth)}: {res['n_images']} PNGs, PSNR "
                   f"{res['psnr']:.4f} dB, SSIM {res['ssim']:.4f}")

    # kernels against plain versions, 2 steps from one state, float32, with
    # TF32 off and cuDNN's deterministic algorithms (its weight gradients
    # otherwise add in a run-to-run order)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batches = train_batches(dev, 2)
    runs = {}
    for which in ("kernels", "plain"):
        state = seeded_train_state("float32", dev)
        step = make_train_step(state)
        named = [(k, p) for m in (state.g, state.d) for k, p in m.named_parameters()]
        grad_least = {k: torch.full_like(p, math.inf) for k, p in named}
        losses, first = [], None
        with plain_versions() if which == "plain" else contextlib.nullcontext():
            for b in batches:
                losses.append({k: float(v) for k, v in step(*b)[0].items()})
                first = first or {k: p.grad.clone() for k, p in named}
                for k, p in named:  # the step's gradient with its decay term
                    g = (p.grad + state.config.weight_decay * p.detach()).abs()
                    torch.minimum(grad_least[k], g, out=grad_least[k])
        runs[which] = (losses, {k: p.detach().clone() for k, p in named}, grad_least, first)
        del step, state
    torch.backends.cudnn.deterministic = False
    worst_rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                    for a, b in zip(runs["kernels"][0], runs["plain"][0]) for k in a)
    # step 1's gradients, before Adam normalizes them, printed: per tensor the
    # largest difference against the largest gradient, and all of them in L2.
    # The GAMs' squeeze and excite weights and fuse biases feed only
    # spatially constant terms, which the instance norm after the fuse
    # removes, so their gradients are rounding noise (under 1e-5 of the
    # model's largest): listed, not compared.  The hinge losses' masks flip
    # where a prediction lies within rounding of a hinge, which moves whole
    # pixels' gradients, so no tolerance is set on these
    first_k, first_p = runs["kernels"][3], runs["plain"][3]
    top = max(float(g.abs().max()) for g in first_p.values())
    dead = [k for k, g in first_p.items() if float(g.abs().max()) < 1e-5 * top]
    grad_rel, grad_worst = max((float((first_k[k] - g).abs().max()) / float(g.abs().max()), k)
                               for k, g in first_p.items() if k not in dead)
    grad_l2 = math.sqrt(sum(float(((first_k[k] - g) ** 2).sum()) for k, g in first_p.items())
                        / sum(float((g ** 2).sum()) for g in first_p.values()))
    pk, pp, gk = runs["kernels"][1], runs["plain"][1], runs["kernels"][2]
    diffs = torch.cat([(pk[k] - pp[k]).abs().flatten() for k in pk])
    grads = torch.cat([gk[k].flatten() for k in pk])
    off = diffs > 1e-4
    n_off, n_off_steady = int(off.sum()), int((off & (grads >= 1e-6)).sum())
    by_name = sorted(((int(((pk[k] - pp[k]).abs() > 1e-4).sum()), k) for k in pk), reverse=True)
    cfg = train_config("float32")
    log("6 train", f"2 steps f32 (TF32 off, deterministic cuDNN), kernels vs plain: losses "
                   f"{runs['kernels'][0]} vs {runs['plain'][0]}, max rel {worst_rel:.3e} (limit "
                   f"1e-4); step 1's gradients: relative L2 {grad_l2:.3e}, per tensor at most "
                   f"{grad_rel:.3e} of its largest ({grad_worst}), {len(dead)} tensors whose "
                   f"gradients are under 1e-5 of the largest not compared {dead}; "
                   f"parameters max abs {float(diffs.max()):.3e}, {n_off} of "
                   f"{diffs.numel()} over 1e-4, of which {n_off_steady} had a gradient of 1e-6 "
                   f"or more at both steps; most in {[x for x in by_name[:5] if x[0]]}; median "
                   f"smaller |gradient| of the two steps of those over 1e-4: "
                   f"{float(grads[off].median()) if n_off else 0.0:.3e}")
    if (worst_rel > 1e-4 or float(diffs.max()) > 4 * max(cfg.g_lr, cfg.d_lr)
            or n_off > 1e-3 * diffs.numel()):
        raise AssertionError("the train step with the kernels disagrees with the plain versions")
    del runs, diffs, grads
    torch.backends.cudnn.allow_tf32 = True

    # bf16: finite, both nets moved; one step's launches
    state = seeded_train_state("bfloat16", dev)
    step = make_train_step(state)
    before = {n: {k: v.detach().clone() for k, v in m.named_parameters()}
              for n, m in (("G", state.g), ("D", state.d))}
    batches = train_batches(dev, 3)
    got = [step(*b)[0] for b in batches[:2]]
    moved = {n: max(float((p.detach() - before[n][k]).abs().max()) for k, p in m.named_parameters())
             for n, m in (("G", state.g), ("D", state.d))}
    reset_counts()
    step(*batches[2])
    torch.cuda.synchronize()
    check_counts("one bf16 train step", counts(), per_step)
    finite = all(math.isfinite(float(v)) for m in got for v in m.values())
    log("6 train", f"bf16 steps: losses {[{k: round(float(v), 4) for k, v in m.items()} for m in got]}"
                   f", finite {finite}; largest move G {moved['G']:.3e}, D {moved['D']:.3e}; "
                   f"launches a step {per_step}")
    if not finite or min(moved.values()) <= 0:
        raise AssertionError(f"bf16 train steps: finite {finite}, moved {moved}")

    # time: kernels, plain, plain, kernels (5 steps each, after 2 of warm-up)
    times = {"kernels": [], "plain": []}
    for which in ("kernels", "plain", "plain", "kernels"):
        with plain_versions() if which == "plain" else contextlib.nullcontext():
            times[which].append(train_step_ms(step, batches))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    torch.cuda.reset_peak_memory_stats()
    step(*batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in ("kernels", "plain"):
        log("6 train", f"train step {TRAIN_HW}px B={TRAIN_B} bf16 with {k}: {ms[k]:.3f} ms/step, "
                       f"{TRAIN_B * 1000 / ms[k]:.2f} img/s (runs {times[k]}) [{card}]")
    log("6 train", f"peak device memory of a step: {peak:.3f} GiB [{card}]")
    r = profile(lambda: step(*batches[0]), iters=5, warmup=2)
    log("6 train", f"train step under torch.profiler: wall {r['wall_ms']:.3f} ms per step, device "
                   f"busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f} [{card}]")
    log("6 train", "| bucket | ms per step | kernels per step | share of busy |")
    for k, (b_ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
        log("6 train", f"| {k} | {b_ms:.3f} | {n:g} | {b_ms / r['busy_ms']:.1%} |")
    return {"launches": cli_counts, "ms": ms, "peak_gib": peak, "profile": r}


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
                log("7 timing", f"{model} generator {IMG}px B={b} bf16 with {k}: "
                                f"{fwd[model][k]:.3f} ms/forward, "
                                f"{b * 1000 / fwd[model][k]:.1f} img/s (runs {times[k]}) [{card}]")
    log("7 timing", f"packed vs canonical with kernels: {fwd['packed']['kernels']:.3f} vs "
                    f"{fwd['canonical']['kernels']:.3f} ms/forward, "
                    f"{b * 1000 / fwd['packed']['kernels']:.1f} vs "
                    f"{b * 1000 / fwd['canonical']['kernels']:.1f} img/s [{card}]")
    # the int8 forwards (calibrated on x) beside the bf16 packed one, kernels on,
    # in the order packed, int8, int8_pallas, int8_pallas, int8, packed
    from uegan_tpu_torch.infer import quantized

    with torch.inference_mode():
        tabs = quantized.build_quant_tables(g, calib_batch=x)
        steps = {"packed bf16": packed_forward(g),
                 "int8": quantized.make_int8_eval(g, tabs),
                 "int8_pallas": quantized.make_int8_eval(g, tabs, use_pallas=True)}
        times = {k: [] for k in steps}
        for k in ("packed bf16", "int8", "int8_pallas", "int8_pallas", "int8", "packed bf16"):
            times[k].append(cuda_ms(lambda: steps[k](x), iters=10))
    for k, v in times.items():
        fwd[k] = {"kernels": sum(v) / len(v)}
        log("7 timing", f"{k} forward {IMG}px B={b} with kernels: {fwd[k]['kernels']:.3f} "
                        f"ms/forward, {b * 1000 / fwd[k]['kernels']:.1f} img/s (runs {v}) [{card}]")

    def three(kern, plain, lib, iters):
        """Kernel, plain, library call (where there is one), in turns."""
        fns = {"kernel": kern, "plain": plain}
        if lib is not None:
            fns["library"] = lib
        t = turns(fns, iters)
        for how in ("eager", "device"):
            t[how].setdefault("library", None)
        return t

    per = {name: {how: {"kernel": 0.0, "plain": 0.0, "library": 0.0}
                  for how in ("eager", "device")} | {"bytes": 0, "ops": 0, "peak": None}
           for name in KERNELS}

    def add(name, t, nbytes, ops=0, peak=None):
        for how in ("eager", "device"):
            for k in ("kernel", "plain", "library"):
                if t[how][k] is None or per[name][how][k] is None:
                    per[name][how][k] = None
                else:
                    per[name][how][k] += t[how][k]
        per[name]["bytes"] += nbytes
        per[name]["ops"] += ops
        per[name]["peak"] = peak

    def us(t, k):
        e, d = t["eager"][k], t["device"][k]
        return f"{e * 1e3:.1f} us eager / {d * 1e3:.2f} us device-only"

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.inference_mode():
        # A: the five canonical shapes; each takes the next of a ring of input
        # sets that together exceed 100 MB, so that no call finds its input in
        # the 50 MB L2
        for h, c in GAM_SHAPES:
            nbytes = b * h * h * c * 2
            ring = 100_000_000 // nbytes + 1
            xa = [torch.randn((b, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(ring)]
            t = three(ring_calls(lambda i: gam_stats.gam_mean_std(xa[i]), ring),
                      ring_calls(lambda i: gam_stats.plain(xa[i]), ring),
                      ring_calls(lambda i: torch.var_mean(xa[i], dim=(1, 2), correction=1), ring),
                      50)
            add("gam_stats", t, nbytes + 2 * b * c * 2)
            log("7 timing", f"gam_stats ({b},{h},{h},{c}) bf16, ring of {ring} ("
                            f"{ring * nbytes / 1e6:.0f} MB): kernel {us(t, 'kernel')}, plain "
                            f"{us(t, 'plain')}, torch.var_mean {us(t, 'library')} per call "
                            f"[{card}]")
            del xa
        # B: the four canonical shapes, cold, as A's
        for h, c in UP_SHAPES:
            nbytes = b * h * h * c * 2
            ring = 100_000_000 // nbytes + 1
            xb = [torch.randn((b, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(ring)]
            t = three(ring_calls(lambda i: resize2x.upsample2x(xb[i]), ring),
                      ring_calls(lambda i: resize2x.plain(xb[i]), ring),
                      ring_calls(lambda i: F.interpolate(xb[i].permute(0, 3, 1, 2),
                                                         scale_factor=2, mode="bilinear",
                                                         align_corners=True), ring), 50)
            add("upsample2x", t, nbytes * 5)
            log("7 timing", f"upsample2x ({b},{h},{h},{c}) bf16, ring of {ring} ("
                            f"{ring * nbytes / 1e6:.0f} MB): kernel {us(t, 'kernel')}, plain "
                            f"{us(t, 'plain')}, F.interpolate {us(t, 'library')} per call [{card}]")
            del xb
        with torch.inference_mode(False):  # the library call of A' is an autograd backward
            timing_backward(dev, card, gen, three, add, us)
        # C and D: their inputs fit in the 50 MB L2, so each timed call takes
        # the next of 4 input sets (151 MB together) and finds its inputs cold
        ring = 4
        xs = [torch.rand((b, IMG, IMG, 3), generator=gen, device=dev) * 2 - 1 for _ in range(ring)]
        pshape = (b, IMG // 2, IMG // 2, 12)
        rs = [torch.rand(pshape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(ring)]
        ps = [torch.rand(pshape, generator=gen, device=dev).to(torch.bfloat16) for _ in range(ring)]

        if not bits_equal(library_s2d(xs[0]), s2d_fuse.plain_s2d_convert(xs[0])):
            raise AssertionError("C's library call differs from its plain version")
        t = three(ring_calls(lambda i: s2d_fuse.s2d_convert(xs[i]), ring),
                  ring_calls(lambda i: s2d_fuse.plain_s2d_convert(xs[i]), ring),
                  ring_calls(lambda i: library_s2d(xs[i]), ring), 40)
        add("s2d_convert", t, xs[0].numel() * 4 + xs[0].numel() * 2)
        log("7 timing", f"s2d_convert ({b},{IMG},{IMG},3) f32 -> bf16: kernel {us(t, 'kernel')}, "
                        f"plain {us(t, 'plain')}, one permuted .to() {us(t, 'library')} per call "
                        f"[{card}]")
        t = three(ring_calls(lambda i: s2d_fuse.residual_tail_d2s(rs[i], ps[i]), ring),
                  ring_calls(lambda i: s2d_fuse.plain_residual_tail_d2s(rs[i], ps[i]), ring),
                  None, 40)
        add("residual_tail_d2s", t, rs[0].numel() * 2 * 3)
        log("7 timing", f"residual_tail_d2s {pshape} bf16: kernel {us(t, 'kernel')}, plain "
                        f"{us(t, 'plain')} per call [{card}]")
        timing_int8(dev, card, gen, b, add)
    methods = " and ".join(sorted(DEVICE_METHODS))
    for name in KERNELS:
        p = per[name]
        t_bytes = p["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = p["ops"] / p["peak"] * 1e3 if p["ops"] else 0.0
        p["bound"], p["bound_by"] = max((t_bytes, "bytes"), (t_ops, "operations"))
        dv, ev = p["device"], p["eager"]
        lib = "none" if dv["library"] is None else (
            f"{dv['library']:.4f} (eager {ev['library']:.4f})")
        per_what = {"packed_conv": "dec4-shape call", "gam_stats_bwd": "train step",
                    "upsample2x_bwd": "train step"}.get(name, "forward")
        log("7 timing", f"{name} per {per_what}, "
                        f"device-only ({methods}): kernel {dv['kernel']:.4f} ms (eager "
                        f"{ev['kernel']:.4f}), plain {dv['plain']:.4f} (eager {ev['plain']:.4f}), "
                        f"library {lib} ms, bound {p['bound']:.4f} ms by {p['bound_by']} "
                        f"({p['bytes'] / 1e6:.1f} MB at 3.35 TB/s: {t_bytes:.4f} ms; "
                        f"{p['ops'] / 1e9:.1f} G operations: {t_ops:.4f} ms), "
                        f"{p['bound'] / dv['kernel']:.0%} of the bound [{card}]")
    return {"forward": fwd, "per_kernel": per}


def timing_backward(dev, card: str, gen, three, add, us) -> None:
    """A' and B' at the train step's shapes (256 px, 20 images through G,
    bf16), each call on the next of a ring of inputs of over 100 MB (cold),
    beside their plain versions and the library's: for A' the autograd of a
    torch.var_mean-based mean and std, for B'
    aten.upsample_bilinear2d_backward with align_corners."""
    import torch

    from uegan_tpu_torch.ops import gam_stats, resize2x

    def rate(t, moved):
        """A call's bound and the rate its device-only time moves its bytes at."""
        return (f"bound {moved / HBM_BYTES_PER_S * 1e6:.2f} us, "
                f"{moved / (t['device']['kernel'] * 1e-3) / 1e12:.2f} TB/s device-only")

    n = TRAIN_B2
    for h, c in TRAIN_GAM_SHAPES:
        nbytes = n * h * h * c * 2
        ring = 100_000_000 // nbytes + 1
        sets = []
        for _ in range(ring):
            x = torch.randn((n, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
            _, _, m32, v32 = gam_stats._launch(x, 1e-5, keep32=True)
            dm = torch.randn((n, 1, 1, c), generator=gen, device=dev).to(torch.bfloat16)
            ds = torch.randn((n, 1, 1, c), generator=gen, device=dev).to(torch.bfloat16)
            xg = x.detach().requires_grad_()
            var, mean = torch.var_mean(xg, dim=(1, 2), keepdim=True, correction=1)
            sets.append((x, m32, v32, dm, ds, xg, mean, torch.sqrt(var + 1e-5)))
        t = three(ring_calls(lambda i: gam_stats.gam_mean_std_backward(*sets[i][:5]), ring),
                  ring_calls(lambda i: gam_stats.plain_backward(*sets[i][:5]), ring), None, 20)
        # autograd runs each backward op on its forward's stream, which a CUDA
        # graph captured on another stream cannot take: the profiler's device
        # time of its kernels instead
        lib = ring_calls(lambda i: torch.autograd.grad(
            (sets[i][6], sets[i][7]), sets[i][5], (sets[i][3], sets[i][4]), retain_graph=True),
            ring)
        t["eager"]["library"], t["device"]["library"] = cuda_ms(lib, 20), profiler_ms(lib, 20)
        DEVICE_METHODS.add("profiler")
        moved = 2 * nbytes + 4 * n * c * 2 + 2 * n * c * 4
        add("gam_stats_bwd", t, moved)
        log("7 timing", f"gam_stats_bwd ({n},{h},{h},{c}) bf16, ring of {ring} ("
                        f"{ring * nbytes / 1e6:.0f} MB): kernel {us(t, 'kernel')}, plain "
                        f"{us(t, 'plain')}, autograd of torch.var_mean {us(t, 'library')} per "
                        f"call; {rate(t, moved)} [{card}]")
        del sets
    for h, c in TRAIN_UP_SHAPES:
        nbytes = n * 4 * h * h * c * 2  # dy
        ring = 100_000_000 // nbytes + 1
        dys = [torch.randn((n, 2 * h, 2 * h, c), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(ring)]
        lib = lambda i: torch.ops.aten.upsample_bilinear2d_backward(
            dys[i].permute(0, 3, 1, 2), [2 * h, 2 * h], [n, c, h, h], True, None, None)
        t = three(ring_calls(lambda i: resize2x.upsample2x_backward(dys[i]), ring),
                  ring_calls(lambda i: resize2x.plain_backward(dys[i]), ring),
                  ring_calls(lib, ring), 20)
        add("upsample2x_bwd", t, nbytes + nbytes // 4)
        log("7 timing", f"upsample2x_bwd dy ({n},{2 * h},{2 * h},{c}) bf16, ring of {ring} ("
                        f"{ring * nbytes / 1e6:.0f} MB): kernel {us(t, 'kernel')}, plain "
                        f"{us(t, 'plain')}, aten.upsample_bilinear2d_backward "
                        f"{us(t, 'library')} per call; {rate(t, nbytes + nbytes // 4)} [{card}]")
        del dys


def timing_int8(dev, card: str, gen, b: int, add) -> None:
    """E at the main path's ga1 site (one call a forward) against its plain
    version (the unfused chain the int8 mode runs there) and torch._int_mm
    alone; E's SxS body at the dec4 site against the int8 mode's unfused
    chain there; F at the dec4 shape (bf16, act none) against its plain
    version and F.conv2d with bias."""
    import torch
    import torch.nn.functional as F

    from uegan_tpu_torch.infer import quantized
    from uegan_tpu_torch.ops import packed_conv as fmod
    from uegan_tpu_torch.ops import packed_conv_int8 as emod
    from uegan_tpu_torch.ops.conv_int8 import gemm_weight

    def ms(t, k):
        return f"{t['eager'][k]:.4f} ms eager / {t['device'][k]:.4f} ms device-only"

    # ga1: (B, 256, 256, 128) s8 (x) (128, 128) -> bf16
    shape, c4 = (b, HP, HP, 4 * CD), 4 * CD
    xq, kq, ws, bias, _ = e_inputs(shape, c4, 1, False, gen, dev)
    cols, wt = xq.view(-1, c4), gemm_weight(kq).t()
    t = turns({"kernel": lambda: emod.packed_conv_int8(xq, kq, ws, bias, 0),
               "plain": lambda: emod.plain_packed_conv_int8(xq, kq, ws, bias, 0),
               "int_mm": lambda: torch._int_mm(cols, wt)}, 20)
    m = xq.numel() // c4
    add("packed_conv_int8", {how: {**t[how], "library": None} for how in t},
        xq.numel() + m * c4 * 2 + kq.numel(), 2 * m * c4 * c4, INT8_PEAK_OPS)
    log("7 timing", f"packed_conv_int8 ga1 {shape} -> {c4} bf16: kernel {ms(t, 'kernel')}, "
                    f"plain (the int8 mode's conv2d_int8 + dequant) {ms(t, 'plain')}, "
                    f"torch._int_mm alone {ms(t, 'int_mm')} per call [{card}]")

    # the dec4 site: (B, 256, 256, 256) s8 (x) 3x3 -> 128, leaky, * x1p, requant
    shape, c8 = (b, HP, HP, 8 * CD), 8 * CD
    xq, kq, ws, bias, mul = e_inputs(shape, c4, 3, True, gen, dev)
    fused = dict(act="leaky", mul=mul, out_scale=0.02, requant=True)

    def chain():
        acc = quantized._conv_q(xq, kq, 1, [CD, CD])
        y = quantized.leaky(quantized.int8_epilogue(acc, ws, bias))
        return quantized.quantize_act(y * mul, 0.02)

    t = turns({"kernel": lambda: emod.packed_conv_int8(xq, kq, ws, bias, 1, **fused),
               "kernel + strips": lambda: quantized._conv_q_fused(xq, kq, ws, bias, 1, [CD, CD],
                                                                  **fused),
               "unfused chain": chain}, 5)
    m = xq.numel() // c8
    bound = max((xq.numel() + 2 * m * c4 + m * c4) / HBM_BYTES_PER_S,
                2 * m * c8 * 9 * c4 / INT8_PEAK_OPS) * 1e3
    log("7 timing", f"packed_conv_int8 dec4 site {shape} -> {c4} s8 (leaky, mul, requant): "
                    f"kernel {ms(t, 'kernel')}, kernel + reflect strips (_conv_q_fused) "
                    f"{ms(t, 'kernel + strips')}, the int8 mode's unfused chain "
                    f"{ms(t, 'unfused chain')} per call; bound {bound:.4f} ms, "
                    f"{bound / t['device']['kernel']:.0%} of it device-only [{card}]")

    # the dec5_0 site: (B, 256, 256, 128) s8 (x) 3x3 -> 128, requant
    xq, kq, ws, bias, _ = e_inputs((b, HP, HP, c4), c4, 3, False, gen, dev)
    fused = dict(out_scale=0.02, requant=True)

    def chain5():
        acc = quantized._conv_q(xq, kq, 1, CD)
        return quantized.quantize_act(quantized.int8_epilogue(acc, ws, bias), 0.02)

    t5 = turns({"kernel": lambda: emod.packed_conv_int8(xq, kq, ws, bias, 1, **fused),
                "unfused chain": chain5}, 5)
    m5 = xq.numel() // c4
    bound5 = max((xq.numel() + m5 * c4 + kq.numel()) / HBM_BYTES_PER_S,
                 2 * m5 * c4 * 9 * c4 / INT8_PEAK_OPS) * 1e3
    log("7 timing", f"packed_conv_int8 dec5_0 site {(b, HP, HP, c4)} -> {c4} s8 (requant): "
                    f"kernel {ms(t5, 'kernel')}, the int8 mode's unfused chain "
                    f"{ms(t5, 'unfused chain')} per call; bound {bound5:.4f} ms, "
                    f"{bound5 / t5['device']['kernel']:.0%} of it device-only [{card}]")

    # F at the dec4 shape, bf16, act none: F.conv2d with bias computes the same
    x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    k = (torch.randn((c4, c8, 3, 3), generator=gen, device=dev) / 48).to(torch.bfloat16)
    bf = (torch.randn(c4, generator=gen, device=dev) * 0.1).to(torch.bfloat16)
    t = turns({"kernel": lambda: fmod.packed_conv(x, k, bf, 1),
               "plain": lambda: fmod.plain_packed_conv(x, k, bf, 1),
               "library": lambda: F.conv2d(x.permute(0, 3, 1, 2), k, bf, padding=1)}, 5)
    add("packed_conv", t, x.numel() * 2 + m * c4 * 2 + k.numel() * 2, 2 * m * c8 * 9 * c4,
        BF16_PEAK_FLOPS)
    log("7 timing", f"packed_conv dec4 shape {shape} -> {c4} bf16: kernel {ms(t, 'kernel')}, "
                    f"plain {ms(t, 'plain')}, F.conv2d {ms(t, 'library')} per call, kernel / "
                    f"F.conv2d {t['device']['kernel'] / t['device']['library']:.2f} device-only, "
                    f"{t['eager']['kernel'] / t['eager']['library']:.2f} eager [{card}]")


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
    """Where the device time of each forward goes (512 px, B=8, bf16):
    canonical, packed, and int8 packed with kernel E."""
    import torch

    from uegan_tpu_torch.infer import quantized

    g, _ = seeded_generator(torch.bfloat16, dev)
    x = torch.rand((8, IMG, IMG, 3), device=dev) * 2 - 1
    with torch.inference_mode():
        int8 = quantized.make_int8_eval(g, quantized.build_quant_tables(g, calib_batch=x),
                                        use_pallas=True)
        for name, fn in (("canonical", g), ("packed", packed_forward(g)), ("int8_pallas", int8)):
            r = profile(lambda: fn(x))
            log("8 profile", f"{name} forward {IMG}px B=8 bf16 under torch.profiler: wall "
                             f"{r['wall_ms']:.3f} ms per forward, device busy {r['busy_ms']:.3f} "
                             f"ms, idle share {r['idle_share']:.3f} [{card}]")
            log("8 profile", "| bucket | ms per forward | kernels per forward | share of busy |")
            for k, (ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
                log("8 profile", f"| {k} | {ms:.3f} | {n:g} | {ms / r['busy_ms']:.1%} |")
            seen = set()
            for us, kname in r["longest"]:
                if kname not in seen and len(seen) < 8:
                    seen.add(kname)
                    log("8 profile", f"longest: {us:9.1f} us [{bucket_of(kname)}] {kname[:120]}")


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
    ptxas = ptxas_summary(_build.ptxas_report, _build.load().uegan_tc_conv_smem_bytes())
    for line in ptxas:
        log("2 build", line)
    for key in ("Int8Epilogue", "FloatEpilogue", "gam_stats_kernel", "s2d_convert_kernel",
                "gam_stats_bwd_kernel", "upsample2x_bwd_kernel"):
        if not any(key in line for line in ptxas):
            raise AssertionError(f"ptxas's report names no {key} kernel")

    worst = phase_kernels(dev)
    worst_s2d = phase_s2d_kernels(dev)
    worst_int8 = phase_int8_kernels(dev)
    worst_bwd = phase_backward_kernels(dev)
    phase_model(dev)
    phase_int8_model(dev)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_") as tmp:
        launches = phase_end_to_end(dev, tmp)
        launches["train"] = phase_train(dev, card, tmp)["launches"]
    timing = phase_timing(dev, card)
    phase_profile(dev, card)

    src = {"gam_stats": ("uegan_tpu_torch/csrc/gam_stats.cu",
                         "uegan_tpu/ops/pallas/gam_stats.py:66"),
           "upsample2x": ("uegan_tpu_torch/csrc/upsample2x.cu",
                          "uegan_tpu/ops/pallas/resize2x.py:116"),
           "s2d_convert": ("uegan_tpu_torch/csrc/s2d_fuse.cu",
                           "uegan_tpu/ops/pallas/s2d_fuse.py:60"),
           "residual_tail_d2s": ("uegan_tpu_torch/csrc/s2d_fuse.cu",
                                 "uegan_tpu/ops/pallas/s2d_fuse.py:97"),
           "packed_conv_int8": ("uegan_tpu_torch/csrc/packed_conv_int8.cu",
                                "uegan_tpu/ops/pallas/packed_conv_int8.py:236"),
           "packed_conv": ("uegan_tpu_torch/csrc/packed_conv.cu",
                           "uegan_tpu/ops/pallas/packed_conv.py:155"),
           # the backward kernels stand where JAX differentiates the plain
           # functions its train step runs (it has no backward kernel)
           "gam_stats_bwd": ("uegan_tpu_torch/csrc/gam_stats_bwd.cu",
                             "uegan_tpu/ops/norms.py:47"),
           "upsample2x_bwd": ("uegan_tpu_torch/csrc/upsample2x.cu",
                              "uegan_tpu/ops/resize.py:105")}
    err = {"gam_stats": worst["gam_stats"][0], "upsample2x": worst["upsample2x"][0],
           **worst_s2d, **worst_int8, **worst_bwd}
    kernels = []
    for name in KERNELS:
        p = timing["per_kernel"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src[name][0], "replaces": src[name][1],
            "launches": sum(run[name] for run in launches.values()),
            "launches_by_path": {path: run[name] for path, run in launches.items()},
            "max_abs_err": err[name], "ms": p["device"]["kernel"],
            "plain_ms": p["device"]["plain"], "bound_ms": p["bound"], "bound_by": p["bound_by"],
            "library_ms": p["device"]["library"], "eager_ms": p["eager"]["kernel"],
            "eager_plain_ms": p["eager"]["plain"], "eager_library_ms": p["eager"]["library"],
            "device_time": sorted(DEVICE_METHODS),
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
