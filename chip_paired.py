#!/usr/bin/env python3
"""Time two or more copies of uegan_tpu_torch on one NVIDIA GPU, in turns.

    python3 chip_paired.py --tree parent=path/to/old --tree change=. \\
        --order parent,change,change,parent [--runs 3] [--out result.json]

A tree is a directory that holds a ``uegan_tpu_torch`` package (a
``git archive`` of an older commit, or the repository root).  Each entry of
``--order`` starts one process that builds that tree's kernels (its own
``csrc/build/``) and, at 512 px, batch 8, bfloat16, with the default
generator (conv_dim 32, weights N(0, 1/fan_in) from seed 1990), times
``--runs`` rounds of:

- the packed forward, the canonical forward and the int8_pallas forward
  (calibrated on its input), each 10 forwards after warm-up;
- kernel E at its main-path site ga1 ((8, 256, 256, 128) int8, 1x1 -> 128,
  bf16 out), 20 calls;

as the mean ms per call from CUDA events around calls made from the host;
the 256 px train step (batch 10, bf16, the default configuration at full
width from seeded weights, as ``chip_smoke.py`` phase 6 runs it) as the
mean ms per step on the host clock around 5 steps after 2 of warm-up;
and device-only, from CUDA events around replays of a CUDA graph that
captured 50 calls (40 for C):

- kernel A at the canonical forward's five GAM shapes ((8, 512 >> s,
  512 >> s, 32 << s) bf16), summed over the five, each shape's calls going
  round a ring of inputs of more than 100 MB, so that none finds its input
  in the 50 MB L2;
- kernel C at (8, 512, 512, 3) f32 -> bf16, round a ring of 4 inputs
  (101 MB);
- the backward kernels A' and B' at the 256 px train step's shapes (batch
  10, so 20 images through G; bf16), each summed over its shapes (A' the
  five GAM sites (20, 256 >> s, 256 >> s, 32 << s), B' the four upsample
  inputs, dy (20, 512 >> s, 512 >> s, 32 << s) for s = 1 .. 4), each
  shape's calls round a ring of inputs of more than 100 MB (20 calls).

Each process also hashes the outputs of A' and B' at those shapes, in
bfloat16 and float32, on inputs made from the seed, so the summary says
whether every tree's backward kernels give the same bits.

The processes run one after another on one card, so that the trees take
turns and the card's drift falls on both.  The script prints each
process's runs, then the mean of every measurement per tree, with the
card's name and power limit, and writes all of it as JSON to ``--out`` if
given.  It exits non-zero where CUDA is unavailable or a process fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

SEED = 1990
IMG = 512
B = 8
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import (cuda_ms, graph_ms, ring_calls, seeded_train_state,  # noqa: E402
                        train_batches, train_step_ms)  # (the smoke run's timers and train state)

TRAIN_N = 20  # images through G in a 256 px train step of batch 10
TRAIN_GAM = [(256 >> s, 32 << s) for s in range(5)]  # (H = W, C) at ga1 .. ga5
TRAIN_UP = [(256 >> s, 32 << s) for s in range(4, 0, -1)]  # inputs of upsample1 .. 4
MEASURES = ("packed forward", "canonical forward", "int8_pallas forward", "E ga1",
            "A five shapes, device-only", "C, device-only", "A' train shapes, device-only",
            "B' train shapes, device-only", "train step")


def backward_sets(gen, dev) -> tuple:
    """Rings of inputs of A' (x, f32 mean and var from kernel A, dmean,
    dstd) and B' (dy) at the train step's shapes, bf16, each ring over 100 MB."""
    import torch

    from uegan_tpu_torch.ops import gam_stats

    a_rings, b_rings = [], []
    for h, c in TRAIN_GAM:
        ring = []
        for _ in range(100_000_000 // (TRAIN_N * h * h * c * 2) + 1):
            x = torch.randn((TRAIN_N, h, h, c), generator=gen, device=dev).to(torch.bfloat16)
            _, _, m32, v32 = gam_stats._launch(x, 1e-5, keep32=True)
            dm, ds = (torch.randn((TRAIN_N, 1, 1, c), generator=gen, device=dev).to(torch.bfloat16)
                      for _ in range(2))
            ring.append((x, m32, v32, dm, ds))
        a_rings.append(ring)
    for h, c in TRAIN_UP:
        b_rings.append([torch.randn((TRAIN_N, 2 * h, 2 * h, c), generator=gen,
                                    device=dev).to(torch.bfloat16)
                        for _ in range(100_000_000 // (TRAIN_N * 4 * h * h * c * 2) + 1)])
    return a_rings, b_rings


def backward_digests(dev) -> dict:
    """sha256 of the outputs of A' and B' at the train shapes, bf16 and f32,
    on inputs made from the seed (the same in every tree: kernel A, which
    makes the f32 mean and var that A' reads, is the same in the trees
    compared)."""
    import torch

    from uegan_tpu_torch.ops import gam_stats
    from uegan_tpu_torch.ops.resize2x import upsample2x_backward

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {"A'": hashlib.sha256(), "B'": hashlib.sha256()}
    for dtype in (torch.bfloat16, torch.float32):
        for h, c in TRAIN_GAM:
            x = (torch.randn((TRAIN_N, h, h, c), generator=gen, device=dev) * 2 + 1).to(dtype)
            _, _, m32, v32 = gam_stats._launch(x, 1e-5, keep32=True)
            dm, ds = (torch.randn((TRAIN_N, 1, 1, c), generator=gen, device=dev).to(dtype)
                      for _ in range(2))
            dx = gam_stats.gam_mean_std_backward(x, m32, v32, dm, ds)
            out["A'"].update(dx.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        for h, c in TRAIN_UP:
            dy = torch.randn((TRAIN_N, 2 * h, 2 * h, c), generator=gen, device=dev).to(dtype)
            dx = upsample2x_backward(dy)
            out["B'"].update(dx.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return {k: v.hexdigest() for k, v in out.items()}


def worker(root: str, runs: int, device: str = "cuda") -> dict:
    """The measurements of the package under ``root``, on ``device``."""
    sys.path.insert(0, os.path.abspath(root))
    import time

    import torch

    from uegan_tpu_torch.infer import quantized
    from uegan_tpu_torch.infer.packed import make_packed_eval, pack_generator_params
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.ops import _build
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std, gam_mean_std_backward
    from uegan_tpu_torch.ops.packed_conv_int8 import packed_conv_int8
    from uegan_tpu_torch.ops.resize2x import upsample2x_backward
    from uegan_tpu_torch.ops.s2d_fuse import s2d_convert

    if not _build.__file__.startswith(os.path.abspath(root) + os.sep):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    dev = torch.device(device)
    t0 = time.time()
    _build.load()
    build_s = time.time() - t0
    g = Generator(conv_dim=32, dtype=torch.bfloat16)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in fan_in_normal_state(g, SEED).items()})
    g = g.to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand((B, IMG, IMG, 3), generator=gen, device=dev) * 2 - 1
    c = 128
    xq = torch.randint(-127, 128, (B, IMG // 2, IMG // 2, c), generator=gen,
                       device=dev).to(torch.int8)
    kq = torch.randint(-127, 128, (c, c, 1, 1), generator=gen, device=dev).to(torch.int8)
    ws = (torch.rand(c, generator=gen, device=dev) + 0.5) / (73.3 * 73.3 * c ** 0.5)
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    gam_rings = []
    for s in range(5):
        h, ch = IMG >> s, 32 << s
        ring = 100_000_000 // (B * h * h * ch * 2) + 1
        gam_rings.append([torch.randn((B, h, h, ch), generator=gen, device=dev).to(torch.bfloat16)
                          for _ in range(ring)])
    s2d_ring = [torch.rand((B, IMG, IMG, 3), generator=gen, device=dev) * 2 - 1 for _ in range(4)]
    a_rings, b_rings = backward_sets(gen, dev)
    with torch.inference_mode():
        packed = make_packed_eval(g, pack_generator_params(g.state_dict(), g.conv_dim, device=dev))
        int8 = quantized.make_int8_eval(g, quantized.build_quant_tables(g, calib_batch=x),
                                        use_pallas=True)
        steps = {"packed forward": (lambda: packed(x), 10),
                 "canonical forward": (lambda: g(x), 10),
                 "int8_pallas forward": (lambda: int8(x), 10),
                 "E ga1": (lambda: packed_conv_int8(xq, kq, ws, bias, 0), 20)}
        times = {k: [] for k in MEASURES}
        for _ in range(runs):
            for k in MEASURES[:4]:
                fn, iters = steps[k]
                times[k].append(cuda_ms(fn, iters))
            times["A five shapes, device-only"].append(sum(
                graph_ms(ring_calls(lambda i: gam_mean_std(xs[i]), len(xs)), 50)
                for xs in gam_rings))
            times["C, device-only"].append(
                graph_ms(ring_calls(lambda i: s2d_convert(s2d_ring[i]), len(s2d_ring)), 40))
            times["A' train shapes, device-only"].append(sum(
                graph_ms(ring_calls(lambda i: gam_mean_std_backward(*sets[i]), len(sets)), 20)
                for sets in a_rings))
            times["B' train shapes, device-only"].append(sum(
                graph_ms(ring_calls(lambda i: upsample2x_backward(dys[i]), len(dys)), 20)
                for dys in b_rings))
        digests = backward_digests(dev)
    from uegan_tpu_torch.train.step import make_train_step

    step = make_train_step(seeded_train_state("bfloat16", dev))
    batches = train_batches(dev, 3)
    for _ in range(runs):
        times["train step"].append(train_step_ms(step, batches))
    return {"build_s": build_s, "ms": times, "digests": digests}


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--order", default="", help="comma-separated tree names")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_paired: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(args.worker, args.runs)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    order = [n for n in args.order.split(",") if n]
    if not order or any(n not in trees for n in order):
        ap.error(f"--order {args.order!r} must name trees of {sorted(trees)}")
    for name, root in trees.items():
        if not os.path.isdir(os.path.join(root, "uegan_tpu_torch", "csrc")):
            ap.error(f"tree {name}: no uegan_tpu_torch package under {root}")
    card = card_line()
    print(card, flush=True)
    results = []
    for name in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               trees[name], "--runs", str(args.runs)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            print(f"chip_paired: the process for {name} exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        r = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append({"tree": name, **r})
        print(f"{name}: build {r['build_s']:.1f} s; " + "; ".join(
            f"{k} {[round(v, 4) for v in r['ms'][k]]} ms" for k in MEASURES) + f" [{card}]",
            flush=True)
    means = {}
    for name in dict.fromkeys(order):
        mine = [r for r in results if r["tree"] == name]
        means[name] = {k: sum(v for r in mine for v in r["ms"][k]) /
                       sum(len(r["ms"][k]) for r in mine) for k in MEASURES}
        print(f"{name} mean over {len(mine)} processes: " + "; ".join(
            f"{k} {means[name][k]:.4f} ms" for k in MEASURES) + f" [{card}]", flush=True)
    for k in ("A'", "B'"):
        seen = {r["tree"]: r["digests"][k] for r in results}
        same = len(set(seen.values())) == 1
        print(f"{k} outputs at the train shapes (bf16 and f32): "
              f"{'bit-equal in every tree' if same else 'DIFFER'} {seen}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "order": order, "trees": trees, "runs": results,
                       "means": means}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
