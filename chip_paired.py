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
and device-only, from CUDA events around replays of a CUDA graph that
captured 50 calls (40 for C):

- kernel A at the canonical forward's five GAM shapes ((8, 512 >> s,
  512 >> s, 32 << s) bf16), summed over the five, each shape's calls going
  round a ring of inputs of more than 100 MB, so that none finds its input
  in the 50 MB L2;
- kernel C at (8, 512, 512, 3) f32 -> bf16, round a ring of 4 inputs
  (101 MB).

The processes run one after another on one card, so that the trees take
turns and the card's drift falls on both.  The script prints each
process's runs, then the mean of every measurement per tree, with the
card's name and power limit, and writes all of it as JSON to ``--out`` if
given.  It exits non-zero where CUDA is unavailable or a process fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SEED = 1990
IMG = 512
B = 8
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from chip_smoke import cuda_ms, graph_ms, ring_calls  # noqa: E402  (the smoke run's timers)

MEASURES = ("packed forward", "canonical forward", "int8_pallas forward", "E ga1",
            "A five shapes, device-only", "C, device-only")


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
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std
    from uegan_tpu_torch.ops.packed_conv_int8 import packed_conv_int8
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
    return {"build_s": build_s, "ms": times}


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
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "order": order, "trees": trees, "runs": results,
                       "means": means}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
