"""Batch enhancement through ``Tester.enhance_u8`` (``--mode test``'s call):
a closed loop of uint8 batches held in host memory, back to back.

Traffic parameters: ``batch`` (rows a call), ``image_hw`` (square side),
``distinct_images`` (seeded photos, taken in turn a batch at a time),
``warmup_calls``, ``sample`` (window calls kept for the check, a seeded
reservoir over all of them), ``quantized_inference`` ("" for the packed
bf16 route), ``trace_start_s``, ``trace_seconds``.

The check: every kept call's images against the reference's float32 forward
of the same uint8 rows (normalize, G, quantize); the number compared is the
worst image's mean squared error in 8-bit levels.  With ``run.control``
set, the program's own int8_pallas route stands in for the default one.
"""

from __future__ import annotations

import gc
import random
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench.harness import core
from portbench.harness.weights import make_nets, photos
from portbench.reference import nets


def image_mse(got_u8: np.ndarray, want_u8: np.ndarray) -> np.ndarray:
    """Per-image mean squared error in 8-bit levels of (N, H, W, 3) uint8 pairs."""
    d = got_u8.astype(np.float64) - want_u8.astype(np.float64)
    return (d * d).reshape(d.shape[0], -1).mean(axis=1)


def seeded_generator(cfg: dict, seed: int, device) -> dict:
    """G's weights for ``cfg`` from ``seed`` (fan-in recipe; u and v at the fixed point)."""
    spec = nets.g_spec(cfg["g_conv_dim"], cfg["g_use_sn"])
    return make_nets({"G": spec}, seed, device, fixed_uv=("G",))["G"]


def reference_u8(weights: dict, batches: dict, device) -> dict:
    """{batch index: the reference's uint8 output} for the given uint8 batches."""
    with torch.no_grad():
        return {i: nets.enhance_u8(weights, torch.tensor(b, device=device)).cpu().numpy()
                for i, b in batches.items()}


def run(r: core.Run) -> core.Outcome:
    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.train.tester import Tester

    cfg, tr, dev = r.config, r.traffic, r.device
    b, hw = tr["batch"], tr["image_hw"]
    weights = seeded_generator(cfg, r.seed, dev)
    imgs = photos(tr["distinct_images"], hw, hw, r.seed + 1, dev).cpu().numpy()
    batches = [np.ascontiguousarray(imgs[i:i + b]) for i in range(0, len(imgs), b)]
    r.mark("weights and images made")
    workdir = tempfile.mkdtemp(prefix="portbench-tester-")
    quant = r.control or tr.get("quantized_inference", "")
    args = Config(mode="test", g_conv_dim=cfg["g_conv_dim"], g_use_sn=cfg["g_use_sn"],
                  compute_dtype=cfg["compute_dtype"], test_img_size=hw, val_batch_size=b,
                  quantized_inference=quant, is_test_nima=False, is_print_network=False,
                  save_root_dir=workdir).validate()
    try:
        tester = Tester({}, args, dev)
        tester.G.load_state_dict(weights)
        r.mark("Tester built and loaded")
        for k in range(tr["warmup_calls"]):
            tester.enhance_u8(batches[k % len(batches)])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - r.t_process

        rng, kept = random.Random(r.seed), []  # reservoir of (call, batch index, output)

        def step(k):
            i = k % len(batches)
            with r.tracer.span("enhance_u8"):
                out = tester.enhance_u8(batches[i])
            if len(kept) < tr["sample"]:
                kept.append((k, i, out))
            else:
                j = rng.randrange(k + 1)
                if j < tr["sample"]:
                    kept[j] = (k, i, out)

        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
        calls, window_s, traced = core.closed_loop(r, step, sync)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        del tester
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    want = reference_u8(weights, {i: batches[i] for i in {i for _, i, _ in kept}}, dev)
    worst = max(float(image_mse(out, want[i]).max()) for _, i, out in kept)
    return core.Outcome(
        setup_s=setup_s, values={"enhance_img_per_s": calls * b / window_s},
        attempted=calls * b, failed=0, checks={"worst_image_mse": worst},
        units={"calls": traced, "images": traced * b}, memory_peak_bytes=peak)
