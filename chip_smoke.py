#!/usr/bin/env python3
"""Smoke run of uegan_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from uegan_tpu_torch/csrc/ (one nvcc
a source, started together) and runs fourteen phases, each of which ends the
run with a non-zero exit on failure:

1. environment: the card's name and power limit, torch, CUDA and nvcc versions;
2. build: nvcc for sm_90a, with the seconds it took, and from ptxas's -v
   report (kept beside the library, so a cached build has it too) one line
   a kernel of the sources of E, F, A, A', B' and C (and D, which shares
   C's): registers, spills and shared memory; it fails where the report
   names no tensor-core kernel of E or F, or no kernel of A, A', B' or C;
3. kernels vs plain: gam_stats (A) and upsample2x (B) against their plain
   PyTorch versions run in float64 and rounded, at the shapes the 512 px
   canonical forward gives them (batch 4) and the 256 px train steps' (20
   images a forward fused, 10 under spectral norm), in float32 and
   bfloat16, and at ragged shapes; A also at one pixel with C = 3, 5, 12 (narrow words), 32
   and 512 (16-byte words), at batch 1 and 512 px, and on an input one
   element past a 16-byte boundary, each called twice for identical bits.
   Tolerance: float32 |d| <= 1e-5 + 1e-5 |ref|; bfloat16 |d| <= max(one
   bfloat16 ulp of the reference, 1e-5).  s2d_convert (C) and
   residual_tail_d2s (D) against their plain versions at the 512 px packed
   shapes (batch 4) and ragged ones, float32 and bfloat16, C in all four
   dtype pairs with NaN and +-inf inputs and on an input 4 bytes past a
   16-byte boundary, D with NaN and +-inf: bit-equal (NaN compared as NaN,
   and NaN payloads too where C's dtypes are equal).  The high-resolution
   path's shapes too: B at up1 and up2 of 2048 px B=4 and of 8192 px B=1
   (up2 after its 1x1, the commuted order), C at 8192 px (201 M elements),
   and D on windows of rows of slabs (each image a batch stride apart, as
   the strip executor's exit reads them: the 4096 px exit, an 8192 px
   chunk, ragged ones), with NaN and +-inf, bit-equal.
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
   (batch 10, 20 images through G; 10 a forward under spectral norm) gives
   them and at the edges of their
   tiles (GAM_BWD_EDGES, UP_BWD_EDGES: one pixel, constant channels, H or W
   of one, H and W not a multiple of the tile, C = 3, 6, 12 and 520, an
   input one element past 16 bytes, more tiles than a wave, and B' on a
   small wave whose blocks walk several tiles), float32 and bfloat16, with
   A's and B's tolerances; each autograd Function's gradient against central
   differences of its plain forward in float64; C, D, E and F refusing
   inputs that require grad; A on two streams at once bit-equal to serial
   calls, every stream's tickets back at zero.  The reflect pad
   (ops/reflect_pad.py) at the packed forward's six shapes (B=16), G's
   and D's in the train steps and PAD_EDGES (narrow words, misaligned
   parts, pads as wide as the map or wider), float32 and bfloat16: the
   forward bit-equal to F.pad of the concat, the backward bit-equal to
   plain_backward and within one rounding of it in float64, the autograd of
   the op and of the eager path bit-equal to plain_backward;
4. model: the default generator (conv_dim 32, seeded N(0, 1/fan_in) weights)
   at 512 px in float32 with TF32 off.  Canonical forward: kernels against
   plain versions, max |d| <= 1e-4, launches gam_stats 5, upsample2x 4.
   Packed forward: kernels against plain versions <= 1e-4, against the
   canonical forward <= 2e-3, launches s2d_convert 1, residual_tail_d2s 1,
   upsample2x 3, gam_stats 0; reflect pads a forward (PAD_LAUNCHES) 11 (4
   of two parts) and 6 (3).  Then the int8 and int8_pallas forwards in
   bfloat16 (batch 2, calibrated on their input): >= 30 dB from the bf16
   packed forward, int8_pallas vs int8 max |d| <= 0.02, kernels vs plain
   >= 40 dB and max |d| <= 0.05; launches a forward gam_stats 4,
   upsample2x 3, s2d_convert 1, residual_tail_d2s 1, and packed_conv_int8
   1 under int8_pallas (ga1), 0 under int8;
5. end to end: ``--mode test`` through uegan_tpu_torch.cli.run on a synthetic
   FiveK-layout test set of 8 images at 512 px with a reference-format .pth,
   bfloat16, batch 4, NIMA on (the JAX default: bf16, seeded weights; it
   launches none of the kernels), three times: with ``--packed_inference false``
   (launches gam_stats 10, upsample2x 8), with the default packed path
   (s2d_convert 2, residual_tail_d2s 2, upsample2x 6, gam_stats 0), and with
   ``--quantized_inference int8_pallas`` (packed_conv_int8 2; with the
   calibration forward on the first batch gam_stats 12, upsample2x 9,
   s2d_convert 3, residual_tail_d2s 2); reflect pads twice a canonical and a
   packed forward's, and three packed forwards' under int8_pallas (its
   interior pads as the packed one).  Each writes 8 result PNGs and the
   PSNR, SSIM and NIMA CSVs, within 35 dB PSNR (30 dB for int8) of a float32
   canonical forward with the plain versions; then seconds per image of the
   packed default over 32 images with NIMA on and off (off, on, on, off);
6. train: ``--mode train`` through uegan_tpu_torch.cli.run at the default
   width (cd 32, dd 32, 256 px crops of 512, batch 10, pool 50, bf16) on a
   synthetic FiveK layout of 30 pairs, 3 steps and a validation batch
   (launches A 20, B 16, A' 15, B' 12; reflect pads three steps' and a
   canonical forward's) with NIMA and the on-device PSNR/SSIM
   on (the JAX defaults: both printed, NIMA's CSVs and best-epoch line
   written), then ``--mode test`` on the .pth it wrote; in process, 2 steps from one seeded state with the kernels and
   with the plain versions in float32 with TF32 off and deterministic cuDNN
   (losses within rel 1e-4; parameters within 1e-4 but for at most 1e-3 of
   them, where Adam's first steps divide a nearly cancelling gradient, by at
   most 4 lr; how many of those had gradients of 1e-6 or more is printed, and
   step 1's gradients against each other, per tensor and in L2, with the
   tensors whose gradients are rounding noise left out and named); 2
   bf16 steps finite with both nets moved; one step's launches A 5, B 4,
   A' 5, B' 4, reflect pad 41 forward and 29 backward; step time and images/s with kernels and with plain versions,
   peak memory, and the step's device time by bucket under torch.profiler;
6b. sn: spectral norm in the generator (``--g_use_sn true``) at the same
   width, whose train step is the unfused one (G(raw), the D update, then
   G(exp): G's u and v advance twice a step): ``--mode train --g_use_sn
   true`` through uegan_tpu_torch.cli.run on 20 synthetic pairs (2 steps
   and a validation batch, NIMA off), then ``--mode test --g_use_sn true``
   on the .pth it wrote and on one of seeded weights (u and v at the
   leading singular vectors): the canonical route, A 5 and B 4 a forward,
   C and D 0, PNGs >= 35 dB from the f32 plain canonical forward; 2 f32
   steps, kernels vs plain, with phase 6's limits and G's u and v within
   1e-5; one bf16 step's launches A 10, B 8, A' 10, B' 8, C-F 0, reflect
   pad 52 forward and 39 backward; ms per
   bf16 step with the kernels and the plain versions beside the fused
   default step, in turns, the peak device memory of an SN step, and its
   device time by bucket under torch.profiler;
6c. norm cli: train-mode norm layers (``--g_norm_fun InstanceNorm
   --d_norm_fun BatchNorm``) through uegan_tpu_torch.cli.run at the same
   width on 20 synthetic pairs: 2 steps and a validation batch with 43
   forward and 38 backward norm calls a step and the running statistics
   moved in the .pth; a resume from it that restores them bit for bit and
   runs 2 more steps; ``--mode test`` on the result and on a .pth of seeded
   weights by the canonical route (A 5, B 4, no norm call), PNGs >= 35 dB
   from the f32 plain canonical forward with the same running statistics;
6d. graph: the train step replayed as one CUDA graph (train/step.py:
   StepGraph) under the default, the spectral-norm and the instance/batch
   norm configurations at the same width: 10 bf16 steps from one seeded
   state (the pool of 50 fills in steps 1-5 and swaps from step 6; the
   learning rates fall from step 9; an EMA of G), replayed against the eager
   step twice, with cuDNN's deterministic algorithms: losses, parameters,
   buffers (u and v, running statistics), Adam's moments and step counts,
   the pool and the EMA bit-equal wherever the two eager runs are, else no
   further apart than they; the counters (one capture, five replays, five
   eager steps), the capture's seconds, ms a step replayed and eager, the
   peak memory of each; then which path a step takes under the benchmark's
   device-only profiler (a replay), under its host-op profiler with shapes
   (eager) and on another batch size (eager); ``--mode train`` with a pool
   of one batch (4 steps: one eager, one capture, three replays, with
   samples, a checkpoint, a validation batch and the EMA) and its resume for
   4 more, the resumed Adams going on from the .pth's step counts;
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
   aten.upsample_bilinear2d_backward); the reflect pad's forward at the
   packed forward's six shapes (B=16) and forward and backward at G's
   eleven in the fused and the SN step, beside its plain version (F.pad of
   the 5-d view after torch.cat) and the library's (F.pad of the NCHW
   concat; aten.reflection_pad3d_backward); the GAM norm (ops/gam_norm.py,
   the norm layers' forward pair) at the packed forward's five maps (B=16)
   against float64, beside its plain version (the PyTorch chain) and
   F.instance_norm, and at one image (512 px, and a 2048 px strip
   forward's three maps) beside the chain;
8. profile: the canonical, packed and int8_pallas forwards at 512 px, batch
   8, bfloat16, under torch.profiler: wall and device-busy time per forward,
   the device's idle share, and device time in buckets of kernel names;
   every profile of a forward or a train step fails where it holds an aten
   reflect-pad kernel;
9. NIMA (cuDNN convs and a cuBLAS linear layer; in training its 53
   BatchNorms with their activations on the norm_act pair): the f32
   forward at 224 px, batch 16, TF32 off, against the module run on the
   CPU in float64 (probabilities <= 2e-5); bf16 against f32 (each mean
   score <= 0.3); images/s of the forward at batch 16 and 128 in bf16 and
   f32; calc_nima over 64 PNGs of 512 px, its host preparation and device
   scoring timed apart; the norm_act pair at the 53 BN maps at B=128,
   224 px with each BN's activation (ReLU6, ReLU, none) and flax's biased
   running variance against its plain form in float64 (``norm_check``);
   the train step's norm calls (53 forward and 53 backward on the eager
   step and on the captured one, none on a replay), its CUDA graph's
   losses and parameters against the eager step's over 4 steps;
   train_nima one epoch on a synthetic AVA layout in bf16 and f32 (finite
   EMD) and ms per train step at 224 px, batch 32; the bf16 forward and the
   train steps under torch.profiler (busy and idle time, kernels a call).

10. high resolution, at the default generator's full width (seeded as in
   phase 4): the strip executor at 2048 px B=2 in float32 with TF32 off
   against the direct packed forward (max |d| <= 1e-4; kernels vs plain
   <= 1e-4; launches a forward C 1, B 2, D 1, A 0); chunked (2 strips a
   chunk) against unchunked and entry-chunked against resident chunked at
   2048 px B=1 (<= 1e-5; D once a chunk); bf16 at 4096 px B=1 (unchunked)
   and 8192 px B=1 (8 strips a chunk, entry resident) with their peak
   memory and ms per forward, and at 8192 px the entry-chunked route within
   one bf16 ulp of the auto route; the int8 and int8_pallas routes at
   2048 px B=2 (the int8 strips, E launched 0 times: >= 30 dB from the bf16
   strips, <= 0.02 from each other, kernels vs plain >= 40 dB and <= 0.05);
   strips against the direct packed forward at 2048 px B=4 in bf16 (ms,
   img/s and peak memory, in turns); ``--mode test --test_keep_aspect
   true`` through uegan_tpu_torch.cli.run on photos of 2000 x 3000 (the
   strips), 1000 x 667 and 512 x 512, two each (PNGs at native size, each
   >= 35 dB from the f32 plain canonical forward of the same padded input;
   launches C 3, B 8, D 3), then the Tester's enhance step per size in s
   per image; and ``--tile_size 512 --tile_overlap 32`` on two photos of
   1024 x 1536 (>= 35 dB from the host tiling over the f32 plain canonical
   forward; launches A 20, B 16).

11. serve: ``uegan_tpu_torch.serve.app`` in process on 127.0.0.1 with a
   reference .pth of the phase-4 generator (cd 32), test_img_size 512,
   bf16, max_batch 16, clients sending 600 x 800 PNGs.  One /api/enhance:
   bit-equal to make_fast_eval at B=1 on the same resized input, >= 35 dB
   from the f32 plain canonical forward, launches C 1, D 1, B 3, A 0.  32
   concurrent requests: fewer batched calls than requests, each call's
   launches one forward's, every PNG within one gray level of its
   single-request PNG.  /api/get_scores (NIMA f32, seeded) while enhance
   requests are in flight: probabilities within 2e-5 of the scorer run at
   B=1 (how many are equal to the printed 6 decimals is printed).  Timings:
   each bucket's first device call and its later ones, p50/p99 of 50
   sequential requests, img/s with 16 and 64 concurrent clients (threads
   of this process), the server's PNG decode, resize and encode alone, and
   the device's busy share of sequential requests under torch.profiler.  Then
   ``--quantized_inference int8_pallas`` (the calibration forward, then E
   once a batched call; >= 30 dB from the bf16 server's PNG) and
   ``--keep_aspect`` with a 2000 x 3000 photo (the strips: C 1, B 2, D 1;
   the PNG at native size, >= 35 dB from the f32 plain canonical forward of
   the padded input; the peak device memory and seconds with 4 such
   requests at once).

12. export: uegan_tpu_torch/tools/export_model.py from a reference .pth of
   the phase-4 generator (cd 32, bf16): the packed forward at 512 px B=8,
   int8_pallas at 512 px B=2, --u8_io at 512 px B=2 and the strips at
   2048 px B=1, each exported (seconds and size printed), loaded and run in
   a fresh interpreter that loads no jax and no uegan_tpu module: bit-equal
   to the eager make_fast_eval on the same weights and input (u8 in u8),
   one call's launches equal to one eager call's (packed and u8: C 1, B 3,
   D 1; int8_pallas: A 4, B 3, C 1, D 1, E 1; strips: C 1, B 2, D 1; the
   reflect pads as the eager call) and to the ops in the program's graph; each program's ms per forward beside the
   eager forward's (CUDA events, in turns); then torch.library.opcheck on
   every kernel's op at a main-path shape on the card.

13. norm: the train-mode norm layers' kernel pair (ops/norm_act.py,
   csrc/norm_act.cu) against its plain versions run in float64 at the maps
   of the cell g32inbn_train256 and at edge cases, float32 and bfloat16
   (y, the statistics, the running statistics, dx, dweight, dbias; two
   calls bit-equal); device-only ms of G's nine instance-norm and D's five
   batch-norm calls beside the bound and aten's; a train step of the cell's
   configuration: 43 forward and 38 backward norm calls, the norm kernels'
   share of their bound under torch.profiler.

It then prints the kernels' JSON line (each kernel's launches as counted on
each path, the reflect pad's included) and, last, the device JSON line.  It
exits non-zero without a result where CUDA is unavailable or where the
uegan_tpu_torch package is not beside this file.
"""

from __future__ import annotations

import contextlib
import gc
import http.client
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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
# phase 10, high resolution: the strip executor's inputs (2048, 4096 and
# 8192 px), B's inputs on its path (up1 and up2 at 2048 px B=4; at 8192 px
# up1, and up2 after its 1x1, the commuted order), C's input at 8192 px, and
# D on windows of rows of slabs, (slabs, rows a slab, Wp, 12 channels, first
# kept row, kept rows): the 4096 px exit (16 slabs of 140 rows, rows 6 ..
# 134), an 8192 px chunk of 8 slabs, and ragged ones
HR = (2048, 4096, 8192)
HR_UP_SHAPES = [(4, 128, 128, 512), (4, 256, 256, 256), (1, 512, 512, 512),
                (1, 1024, 1024, 128)]
HR_S2D_SHAPES = [(1, 8192, 8192, 3)]
D_WINDOWS = [(16, 140, 2048, 12, 6, 128), (8, 140, 4096, 12, 6, 128), (3, 11, 6, 12, 2, 7),
             (2, 9, 5, 20, 3, 3)]
# phase 10's photos (rows, columns), 2 of each: 2000 x 3000 pads to 2048 x
# 3008 (packed height 1024: the strips), the others take the direct forward;
# and the tiled photos
NATIVE_SIZES = [(2000, 3000), (1000, 667), (512, 512)]
TILE_HW = (1024, 1536)
TILE, TILE_OVERLAP = 512, 32
# the strip height the auto route picks at every HR size, and its strips a
# chunk of the exit at 4096 px (unchunked) and 8192 px
STRIP_R = 128
HR_CHUNKS = {4096: 16, 8192: 8}
# phase 11, the HTTP service: the clients' photos for the square route
# (resized to IMG by the server), the concurrent and sequential request
# counts, the concurrent clients timed, and the native-size photo
SERVE_PHOTO = (600, 800)
SERVE_CONCURRENT = 32
SERVE_SEQUENTIAL = 50
SERVE_CLIENTS = (16, 64)
SERVE_NATIVE = (2000, 3000)
SERVE_NATIVE_AT_ONCE = 4
# phase 12, export: (name, hw, batch, --quantized, --u8_io) of each program
# exported and held to the eager forward, and the launches one call makes
EXPORT_CASES = [("packed", IMG, 8, "", False), ("int8_pallas", IMG, 2, "int8_pallas", False),
                ("u8", IMG, 2, "", True), ("strips", 2048, 1, "", False)]
EXPORT_LAUNCHES = {"packed": {"s2d_convert": 1, "upsample2x": 3, "residual_tail_d2s": 1,
                              "gam_norm": 5},
                   "int8_pallas": {"gam_stats": 4, "upsample2x": 3, "s2d_convert": 1,
                                   "residual_tail_d2s": 1, "packed_conv_int8": 1, "gam_norm": 1},
                   "u8": {"s2d_convert": 1, "upsample2x": 3, "residual_tail_d2s": 1,
                          "gam_norm": 5},
                   "strips": {"s2d_convert": 1, "upsample2x": 2, "residual_tail_d2s": 1,
                              "gam_norm": 3}}
KERNELS = ("gam_stats", "upsample2x", "s2d_convert", "residual_tail_d2s", "packed_conv_int8",
           "packed_conv", "gam_stats_bwd", "upsample2x_bwd", "gam_norm")
# phase 7: the GAM norm pair at the enhancement cell's five maps (B = 16,
# 512 px): ga1's packed view (N, H/2, W/2 * 4, C), then ga2 .. ga5
GAM_NORM_B = 16
GAM_NORM_SHAPES = [(IMG // 2, IMG // 2 * 4, 32)] + [(IMG >> s, IMG >> s, 32 << s)
                                                    for s in range(1, 5)]
# and at one image, as the service's sequential requests and the strips run
# it: the same five maps, and a 2048 px strip forward's ga3 .. ga5
GAM_NORM_ONE = {"512 px": GAM_NORM_SHAPES,
                "2048 px strips": [(2048 >> s, 2048 >> s, 32 << s) for s in range(2, 5)]}
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
# the reflect pad (ops/reflect_pad.py), (what, c1, c2, H = W, pad) of each
# padded conv input: the packed forward's six at IMG (B = PAD_B: enc3 ..
# enc5 on one part, dec1 .. dec3 on the two parts of their concat), G's
# eleven in a train step at TRAIN_HW (the canonical route: enc1 .. enc5,
# dec1 .. dec4, dec5's two) and D's ten (five stages, five heads)
PAD_B = 16
PAD_ENHANCE = [("enc3", 2 * CD, 0, IMG // 2, 1), ("enc4", 4 * CD, 0, IMG // 4, 1),
               ("enc5", 8 * CD, 0, IMG // 8, 1), ("dec1", 8 * CD, 8 * CD, IMG // 8, 1),
               ("dec2", 4 * CD, 4 * CD, IMG // 4, 1), ("dec3", 2 * CD, 2 * CD, IMG // 2, 1)]
PAD_TRAIN_G = [("enc1", 3, 0, TRAIN_HW, 3), ("enc2", CD, 0, TRAIN_HW, 1),
               ("enc3", 2 * CD, 0, TRAIN_HW // 2, 1), ("enc4", 4 * CD, 0, TRAIN_HW // 4, 1),
               ("enc5", 8 * CD, 0, TRAIN_HW // 8, 1),
               ("dec1", 8 * CD, 8 * CD, TRAIN_HW // 16, 1),
               ("dec2", 4 * CD, 4 * CD, TRAIN_HW // 8, 1),
               ("dec3", 2 * CD, 2 * CD, TRAIN_HW // 4, 1),
               ("dec4", CD, CD, TRAIN_HW // 2, 1), ("dec5_0", CD, 0, TRAIN_HW, 1),
               ("dec5_1", CD, 0, TRAIN_HW, 3)]
PAD_TRAIN_D = [(f"d{i}", c, 0, TRAIN_HW >> (i - 1), p) for i, (c, p) in enumerate(
    ((3, 3), (CD, 3), (2 * CD, 3), (4 * CD, 2), (8 * CD, 2)), 1)]
PAD_TRAIN_D += [(f"d{i}_pred", CD << (i - 1), 0, TRAIN_HW >> i, p) for i, p in enumerate(
    (3, 3, 3, 2, 2), 1)]
# beyond them: channels that take 8-, 4- and 2-byte words, a part one element
# past 16 bytes, pads as wide as the map or wider (n = 1, 2, 3), one pixel,
# H != W, and a batch of one: (what, (N, c1, c2, H, W), pad, misaligned part)
PAD_EDGES = [("ragged", (2, 12, 4, 7, 9), 1, None), ("3 ch", (2, 3, 0, 11, 6), 3, None),
             ("5 + 3 ch", (2, 5, 3, 6, 10), 2, None), ("misaligned a", (2, 16, 16, 9, 8), 1, 0),
             ("misaligned b", (2, 16, 16, 9, 8), 1, 1), ("n = 1", (2, 8, 8, 1, 1), 3, None),
             ("n = 2", (2, 8, 0, 2, 2), 3, None), ("n = 3", (3, 8, 8, 3, 5), 3, None),
             ("batch 1", (1, 64, 64, 33, 17), 1, None), ("pad 0", (2, 8, 8, 5, 5), 0, None)]
# a step's reflect-pad launches (ops/reflect_pad.py's counters): forward,
# of which two-part, backward, of which two-part
PAD_LAUNCHES = {"canonical": {"reflect_pad": 11, "reflect_pad_two_part": 4,
                              "reflect_pad_bwd": 0, "reflect_pad_bwd_two_part": 0},
                "packed": {"reflect_pad": 6, "reflect_pad_two_part": 3,
                           "reflect_pad_bwd": 0, "reflect_pad_bwd_two_part": 0},
                "train": {"reflect_pad": 41, "reflect_pad_two_part": 4,
                          "reflect_pad_bwd": 29, "reflect_pad_bwd_two_part": 4},
                "sn_train": {"reflect_pad": 52, "reflect_pad_two_part": 8,
                             "reflect_pad_bwd": 39, "reflect_pad_bwd_two_part": 8}}
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
    ("norm_act", ("norm_act_nhwc",)),
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


class Tee(io.TextIOBase):
    """Writes to several text streams: stdout and a buffer a check reads."""

    def __init__(self, *streams):
        super().__init__()
        self.streams = streams

    def write(self, text: str) -> int:
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self) -> None:
        for stream in self.streams:
            stream.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


PTXAS_SOURCES = ("packed_conv.cu", "packed_conv_int8.cu", "gam_stats.cu", "s2d_fuse.cu",
                 "gam_stats_bwd.cu", "upsample2x.cu", "reflect_pad.cu", "norm_act.cu")


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
    """Route the generator's forwards (canonical, packed, int8, strips)
    through the kernels' plain PyTorch versions."""
    from uegan_tpu_torch.infer import packed, quantized, strips
    from uegan_tpu_torch.models import blocks, generator
    from uegan_tpu_torch.ops import (conv, gam_norm, gam_stats, packed_conv_int8, reflect_pad,
                                     resize2x, s2d_fuse)

    # packed's gam_norm serves the strips' and the int8 forwards' GAM norms too
    swaps = [(blocks, "gam_mean_std", gam_stats.plain), (packed, "gam_norm", gam_norm.plain),
             (conv, "reflect_pad", lambda parts, pad: reflect_pad.plain(
                 parts[0], parts[1] if len(parts) == 2 else None, pad)),
             (generator, "upsample2x", resize2x.plain), (packed, "upsample2x", resize2x.plain)]
    swaps.append((strips, "upsample2x", resize2x.plain))
    for mod in (packed, quantized, strips):
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
    from uegan_tpu_torch.ops.gam_norm import gam_norm
    from uegan_tpu_torch.ops.gam_stats import gam_mean_std, gam_mean_std_backward
    from uegan_tpu_torch.ops.packed_conv import packed_conv
    from uegan_tpu_torch.ops.packed_conv_int8 import packed_conv_int8
    from uegan_tpu_torch.ops.resize2x import upsample2x, upsample2x_backward
    from uegan_tpu_torch.ops.s2d_fuse import residual_tail_d2s, s2d_convert

    return {"gam_stats": gam_mean_std, "upsample2x": upsample2x, "s2d_convert": s2d_convert,
            "residual_tail_d2s": residual_tail_d2s, "packed_conv_int8": packed_conv_int8,
            "packed_conv": packed_conv, "gam_stats_bwd": gam_mean_std_backward,
            "upsample2x_bwd": upsample2x_backward, "gam_norm": gam_norm}


def counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def pad_counts() -> dict:
    """The reflect pad's launches, forward and backward, and of each those
    that read or wrote two parts (a concat folded into the pad)."""
    from uegan_tpu_torch.ops.reflect_pad import reflect_pad, reflect_pad_backward

    return {"reflect_pad": reflect_pad.launches, "reflect_pad_two_part": reflect_pad.two_part,
            "reflect_pad_bwd": reflect_pad_backward.launches,
            "reflect_pad_bwd_two_part": reflect_pad_backward.two_part}


# the reflect pad's launches on each path that the kernels line reports,
# taken beside that path's counts() (note_pads) and printed as measured
PADS_BY_PATH: dict = {}


def note_pads(path: str, pads: dict | None = None) -> dict:
    """Keep ``pads`` (by default pad_counts() now) as ``path``'s measured
    reflect-pad launches, and return them."""
    PADS_BY_PATH[path] = pad_counts() if pads is None else pads
    return PADS_BY_PATH[path]


def scaled_pads(*terms: tuple) -> dict:
    """Σ k * PAD_LAUNCHES[path] over the (k, path) terms: the pads a run of
    several forwards and steps should launch."""
    return {key: sum(k * PAD_LAUNCHES[path][key] for k, path in terms)
            for key in PAD_LAUNCHES["canonical"]}


def reset_counts() -> None:
    from uegan_tpu_torch.ops.reflect_pad import reflect_pad, reflect_pad_backward

    for w in _wrappers().values():
        w.launches = 0
    for w in (reflect_pad, reflect_pad_backward):
        w.launches = w.two_part = 0


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
    cases += [("upsample2x", shape) for shape in HR_UP_SHAPES]
    # the train steps': 20 images through G (fused), 10 a forward (spectral norm)
    cases += [("gam_stats", (b, h, h, c)) for b in (TRAIN_B2, TRAIN_B)
              for h, c in TRAIN_GAM_SHAPES]
    cases += [("upsample2x", (b, h, h, c)) for b in (TRAIN_B2, TRAIN_B)
              for h, c in TRAIN_UP_SHAPES]
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

    for n, h, w, c in S2D_SHAPES + HR_S2D_SHAPES:
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
    # D on windows of rows of slabs, as the strip executor's exit reads them
    # (res a batch stride of a whole slab apart; xp contiguous, or a window
    # too), NaN and +-inf in both
    for ns, rows, wp, c4, lo, kept in D_WINDOWS:
        for dt in (f32, bf16):
            res = (torch.rand((ns, rows, wp, c4), generator=gen, device=dev) * 4 - 2).to(dt)
            xpw = (torch.rand((ns, rows, wp, c4), generator=gen, device=dev) * 2 - 1).to(dt)
            res[:, lo, 0, :3] = torch.tensor([math.nan, math.inf, -math.inf], device=dev, dtype=dt)
            xpw[:, lo, 0, 3:6] = torch.tensor([math.nan, math.inf, -math.inf], device=dev,
                                              dtype=dt)
            window = res[:, lo:lo + kept]
            xp_flat = xpw[:, lo:lo + kept].contiguous()
            for what, xin in (("contiguous xp", xp_flat), ("xp a window too",
                                                           xpw[:, lo:lo + kept])):
                got = s2d_fuse.residual_tail_d2s(window, xin)
                want = s2d_fuse.plain_residual_tail_d2s(window.contiguous(), xin.contiguous())
                check("residual_tail_d2s", (ns, rows, wp, c4),
                      f"{tag[dt]} rows {lo}..{lo + kept} of each slab, {what}, NaN/inf",
                      got, want)
            del res, xpw, window, xp_flat
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
    for shape, const, shifted in [((b, h, h, c), False, None) for b in (TRAIN_B2, TRAIN_B)
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
    for (n, h, w, c), shifted, wave in [((b, h, h, c), False, None) for b in (TRAIN_B2, TRAIN_B)
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


def pad_cases() -> list:
    """The reflect pad's cases: (what, (N, c1, c2, H, W), pad, misaligned
    part) at the packed forward's shapes (B = PAD_B), G's and D's in the
    fused train step (2 * TRAIN_B images through G, 3 * TRAIN_B through D's
    update), G's under spectral norm (TRAIN_B), and PAD_EDGES."""
    cases = [(f"enhance {w}", (PAD_B, c1, c2, hw, hw), p, None)
             for w, c1, c2, hw, p in PAD_ENHANCE]
    cases += [(f"train {w}", (TRAIN_B2, c1, c2, hw, hw), p, None)
              for w, c1, c2, hw, p in PAD_TRAIN_G]
    cases += [(f"sn {w}", (TRAIN_B, c1, c2, hw, hw), p, None)
              for w, c1, c2, hw, p in PAD_TRAIN_G if c2]
    cases += [(f"train {w}", (3 * TRAIN_B, c1, c2, hw, hw), p, None)
              for w, c1, c2, hw, p in PAD_TRAIN_D]
    return cases + PAD_EDGES


def pad_parts(shape, dtype, gen, dev, misaligned=None) -> list:
    """The pad's one or two channels-last parts of ``shape`` (N, c1, c2, H,
    W), part ``misaligned`` one element past a 16-byte boundary."""
    import torch

    n, c1, c2, h, w = shape
    parts = []
    for i, c in enumerate((c1, c2) if c2 else (c1,)):
        t = (torch.randn((n, h, w, c), generator=gen, device=dev) * 2 + 1).to(dtype)
        if i == misaligned:
            t = one_past(t)
        parts.append(t.permute(0, 3, 1, 2))  # NCHW in channels-last memory
    return parts


def one_ulp(t, dtype):
    """One ulp of ``t``'s values in ``dtype`` (bf16 or f32), with a floor for
    sums that cancel to about 0."""
    import torch

    bits = 7 if dtype == torch.bfloat16 else 23
    a = t.double().abs().clamp_min(2.0 ** -100)
    return torch.exp2(torch.floor(torch.log2(a)) - bits).clamp_min(2.0 ** -100)


def phase_pad_kernels(dev) -> dict:
    """The reflect pad (ops/reflect_pad.py) against its plain versions at
    every main-path shape and PAD_EDGES, float32 and bfloat16: the forward
    bit-equal to F.pad(mode="reflect") of the concat (the gather where the
    pad reaches the map), the backward bit-equal to plain_backward (the
    same f32 sums in the same order) and within one rounding of it run in
    float64 (one ulp, and the f32 additions' roundings); then the op's autograd on a two-part case against
    plain_backward.  Returns the backward's worst |d| against float64."""
    import torch

    from uegan_tpu_torch.ops import reflect_pad as rp

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    worst, n_cases = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    reset_counts()
    for what, shape, pad, mis in pad_cases():
        for dtype in (torch.float32, torch.bfloat16):
            parts = pad_parts(shape, dtype, gen, dev, mis)
            got = rp.reflect_pad(parts, pad)
            want = rp.plain(parts[0], parts[1] if len(parts) == 2 else None, pad)
            dy = (torch.randn(got.shape, generator=gen, device=dev) * 2 + 1).to(dtype).contiguous(
                memory_format=torch.channels_last)
            if mis is not None:  # dy one element past 16 bytes too
                dy = one_past(dy.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            dx = rp.reflect_pad_backward(dy, pad, shape[1])
            dx_plain = rp.plain_backward(dy, pad, shape[1])
            dx64 = rp.plain_backward(dy.double(), pad, shape[1])
            mag64 = rp.plain_backward(dy.double().abs(), pad, shape[1])
            torch.cuda.synchronize()
            if not bits_equal(got, want) or not got.is_contiguous(
                    memory_format=torch.channels_last):
                raise AssertionError(f"reflect_pad {what} {shape} pad {pad} {dtype}: differs "
                                     f"from F.pad of the concat")
            if len(dx) != len(parts) or not all(bits_equal(a, b) for a, b in zip(dx, dx_plain)):
                raise AssertionError(f"reflect_pad_backward {what} {shape} pad {pad} {dtype}: "
                                     f"differs from plain_backward")
            # the final rounding (one ulp), and the f32 additions' roundings
            # before it: at most 3 half-ulps of f32 of the taps' magnitudes
            err = max(float((a.double() - b).abs().max()) for a, b in zip(dx, dx64))
            within = all(bool(((a.double() - b).abs() <= one_ulp(b, dtype) + 3 * 2.0 ** -24 * m)
                              .all()) for a, b, m in zip(dx, dx64, mag64))
            if not within:
                raise AssertionError(f"reflect_pad_backward {what} {shape} pad {pad} {dtype}: "
                                     f"{err:.3e} from float64, over one rounding")
            worst[dtype] = max(worst[dtype], err)
            n_cases += 1
        log("3 kernels", f"reflect_pad {what} (N, c1, c2, H, W) {shape} pad {pad}"
                         f"{' misaligned part ' + str(mis) if mis is not None else ''}: forward "
                         f"bit-equal to F.pad of the concat, backward bit-equal to plain_backward, "
                         f"f32 and bf16")
    # autograd, both routes: the op's registered backward, and the eager
    # path's (reflect_pad under autograd on a card; on the CPU it is aten's)
    # are the backward kernel
    parts = [t.detach().requires_grad_() for t in pad_parts((2, 16, 8, 12, 10), torch.bfloat16,
                                                            gen, dev)]
    routes = {"the op": lambda: rp.reflect_pad_op(*parts, 1)}
    if dev.type == "cuda":
        routes["the eager path"] = lambda: rp.reflect_pad(parts, 1)
    for route, fn in routes.items():
        out = fn()
        dy = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        grads = torch.autograd.grad(out, parts, dy)
        want = rp.plain_backward(dy.contiguous(memory_format=torch.channels_last), 1, 16)
        if not all(bits_equal(a, b) for a, b in zip(grads, want)):
            raise AssertionError(f"reflect_pad's autograd through {route} differs from "
                                 f"plain_backward")
    pads = pad_counts()
    log("3 kernels", f"reflect_pad over {n_cases} cases: backward max abs from float64 f32 "
                     f"{worst[torch.float32]:.3e}, bf16 {worst[torch.bfloat16]:.3e} (each within "
                     f"one rounding); autograd through the op and the eager path bit-equal to "
                     f"plain_backward; launches {pads}")
    want_pads = 2 * len(pad_cases()) + 2
    check_counts("the reflect pad's checks", (pads["reflect_pad"], pads["reflect_pad_bwd"]),
                 (want_pads, want_pads))
    return {"f32": worst[torch.float32], "bf16": worst[torch.bfloat16]}


# the norm_act pair's edge cases (instance?, (N, C, H, W), misaligned x):
# N = 1, one pixel, channels that take narrow words or a partial tile, an x
# one element past a 16-byte boundary (one-channel words)
NORM_EDGES = [(True, (1, 24, 7, 5), False), (False, (1, 24, 7, 5), False),
              (False, (3, 12, 1, 1), False), (True, (2, 12, 1, 1), False),
              (True, (2, 520, 3, 5), False), (False, (4, 40, 9, 9), True),
              (True, (3, 64, 33, 17), True)]


def norm_close(got, want, dtype, scale: float) -> tuple:
    """(max |d|, within): float32 within 1e-4 of the tensor's scale plus
    1e-5 of each value; bfloat16 within one ulp of each value plus 1e-4 of
    the scale (the f32 statistics' round-off, before the rounding)."""
    import torch

    d = (got.double() - want).abs()
    if dtype == torch.float32:
        tol = 1e-4 * scale + 1e-5 * want.abs()
    else:
        tol = bf16_ulp(want).double() + 1e-4 * scale
    return float(d.max()), bool((d <= tol).all())


def norm_check(instance: bool, shape: tuple, dtype, gen, dev, misaligned: bool,
               slope: float = 0.2, cap: float = math.inf, strict: bool = False,
               unbiased: bool = True) -> dict:
    """One call of the forward and backward kernels against ``plain`` and
    ``plain_backward`` run in float64 on the same inputs: y, the mean and
    variance, the running statistics, dx, dweight and dbias; dx leaves out
    the elements whose float64 z is within 1e-4 of zero or of ``cap``, where
    the activation's slope may fall either way (counted).  The activation is
    the LeakyReLU of the norm layers by default; NIMA's BNs pass ReLU6
    (slope 0, cap 6), ReLU (slope 0, ``strict``) or none (slope 1), and
    flax's biased running variance (``unbiased`` False).  Returns each
    output's max |d|; raises where one is over its tolerance, or where a
    second call's bits differ."""
    import torch

    from uegan_tpu_torch.ops import norm_act as na

    n, c, h, w = shape
    x = (torch.randn(shape, generator=gen, device=dev) * 1.5 + 0.3).to(dtype).contiguous(
        memory_format=torch.channels_last)
    if misaligned:
        x = one_past(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    wt = 1 + 0.2 * torch.randn(c, generator=gen, device=dev)
    b = 0.2 * torch.randn(c, generator=gen, device=dev)
    rm0 = 0.1 * torch.randn(c, generator=gen, device=dev)
    rv0 = 1 + torch.rand(c, generator=gen, device=dev)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype).contiguous(
        memory_format=torch.channels_last)
    rm, rv = rm0.clone(), rv0.clone()
    act = dict(cap=cap, unbiased=unbiased)
    with torch.no_grad():
        y, stats = na._forward(x, wt, b, rm, rv, instance, slope, 0.1, 1e-5, **act)
        y2, _ = na._forward(x, wt, b, rm0.clone(), rv0.clone(), instance, slope, 0.1, 1e-5,
                            **act)
    mean, var = na.split_stats(stats, shape, instance)
    dx, dw, db = na.norm_act_backward(dy, x, wt, b, stats, instance, slope, 1e-5, cap, strict)
    dx2, _, _ = na.norm_act_backward(dy, x, wt, b, stats, instance, slope, 1e-5, cap, strict)
    d64 = lambda t: t.double()
    rm64, rv64 = d64(rm0), d64(rv0)
    y64, mean64, var64 = na.plain(d64(x), d64(wt), d64(b), rm64, rv64, instance, slope, 0.1,
                                  1e-5, cap, unbiased)
    dx64, dw64, db64 = na.plain_backward(d64(dy), d64(x), d64(wt), d64(b), mean64, var64,
                                         instance, slope, 1e-5, cap, strict)
    torch.cuda.synchronize()
    if not (bits_equal(y, y2) and bits_equal(dx, dx2)):
        raise AssertionError(f"norm_act {shape} {dtype}: two calls differ in bits")
    if not (y.is_contiguous(memory_format=torch.channels_last)
            and dx.is_contiguous(memory_format=torch.channels_last)):
        raise AssertionError(f"norm_act {shape} {dtype}: outputs not channels-last")
    gshape = (n, c, 1, 1) if instance else (1, c, 1, 1)
    xh = (d64(x) - mean64.view(gshape)) * torch.rsqrt(var64.view(gshape) + 1e-5)
    z = xh * d64(wt).view(1, -1, 1, 1) + d64(b).view(1, -1, 1, 1)
    at0, atcap = z.abs() < 1e-4, (z - cap).abs() < 1e-4
    kink = at0 | atcap
    dims = (0, 2, 3)
    mag = (d64(dy).abs() * (xh.abs() + 1)).sum(dim=dims)
    # where the f32 z and the f64 z fall either side of zero, dz differs by
    # (1 - slope) dy, and either side of the cap by dy: an element of dbias
    # and dweight may take that much
    flip = d64(dy).abs() * (at0 * (1 - slope) + atcap)
    allow = {"dweight": (flip * xh.abs()).sum(dim=dims), "dbias": flip.sum(dim=dims)}
    out, bad = {}, []
    for name, got, want, scale, dt in (
            ("y", y, y64, float(y64.abs().max()), dtype),
            ("mean", mean, mean64, float(mean64.abs().max()) + 1, torch.float32),
            ("var", var, var64, float(var64.abs().max()), torch.float32),
            ("running_mean", rm, rm64, 1.0, torch.float32),
            ("running_var", rv, rv64, float(rv64.abs().max()), torch.float32),
            ("dx", torch.where(kink, dx64.to(dx.dtype), dx), dx64, float(dx64.abs().max()),
             dtype)):
        err, ok = norm_close(got, want, dt, scale)
        out[name] = err
        if not ok:
            bad.append(f"{name} {err:.3e}")
    for name, got, want in (("dweight", dw, dw64), ("dbias", db, db64)):
        d = (got.double() - want).abs()
        out[name] = float(d.max())
        if not bool((d <= 1e-5 * mag + allow[name] + 1e-6).all()):
            bad.append(f"{name} {out[name]:.3e}")
    if bad:
        raise AssertionError(f"norm_act {'instance' if instance else 'batch'} {shape} {dtype}"
                             f"{' misaligned' if misaligned else ''}: {', '.join(bad)} over "
                             "tolerance against float64")
    out["kinks"] = int(kink.sum())
    return out


def norm_step_shapes() -> tuple:
    """(G's nine, D's five) normalized maps of one forward of the cell
    g32inbn_train256 (portbench/counts/norm_layers.py)."""
    from portbench.counts import norm_layers

    return norm_layers.maps(CD, CD, TRAIN_HW, TRAIN_B)


def phase_norm(dev, card: str) -> dict:
    """13. norm: the norm_act pair (ops/norm_act.py, csrc/norm_act.cu), the
    train-mode instance and batch norms with the LeakyReLU folded in,
    against its plain versions run in float64 (``norm_check``) at the maps
    of the cell g32inbn_train256 (instance norm at G's nine, batch norm at
    D's five, B=10 at 256 px; and each kind at the other's maps) and at
    NORM_EDGES, float32 and bfloat16; then device-only ms of G's nine and
    D's five calls, forward and backward, beside the bound (the bytes of
    portbench/counts/norm_layers.py at 3.35 TB/s) and aten's
    (``F.instance_norm`` and ``F.batch_norm`` on the channels-last maps,
    then ``F.leaky_relu``; forward alone, and forward and backward through
    ``torch.autograd.grad``, eager); then a train step of the cell's
    configuration (bf16, seeded) on the card: its norm calls (43 forward,
    38 backward), its norm kernels' device ms and share of the bound under
    torch.profiler, and its host ms.  Returns the worst |d| and the times."""
    import torch
    import torch.nn.functional as F

    from portbench.counts import norm_layers
    from uegan_tpu_torch.ops import norm_act as na

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    g_maps, d_maps = norm_step_shapes()
    worst = {}
    cases = ([(True, s, False) for s in g_maps] + [(False, s, False) for s in d_maps]
             + [(False, s, False) for s in g_maps[:5]] + [(True, s, False) for s in d_maps]
             + NORM_EDGES)
    for instance, shape, mis in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = norm_check(instance, shape, dtype, gen, dev, mis)
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            for k, v in r.items():
                if k != "kinks":
                    worst[f"{key} {k}"] = max(worst.get(f"{key} {k}", 0.0), v)
        log("13 norm", f"norm_act {'instance' if instance else 'batch'} {shape}"
                       f"{' misaligned' if mis else ''}: f32 and bf16 within tolerance of "
                       f"float64 (bf16 y {r['y']:.3e}, dx {r['dx']:.3e}, dweight "
                       f"{r['dweight']:.3e}; {r['kinks']} dx elements at the slope's kink "
                       "left out)")
    log("13 norm", "worst |d| from float64 over " + str(2 * len(cases)) + " cases: "
        + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items())))

    # device-only times at the cell's maps, bf16
    bf16 = torch.bfloat16
    timings = {}
    for what, instance, shapes in (("G instance norm, 9 maps", True, g_maps),
                                   ("D batch norm, 5 maps", False, d_maps)):
        xs = [torch.randn(s, generator=gen, device=dev).to(bf16).contiguous(
            memory_format=torch.channels_last) for s in shapes]
        dys = [torch.randn(s, generator=gen, device=dev).to(bf16).contiguous(
            memory_format=torch.channels_last) for s in shapes]
        ps = [(torch.ones(s[1], device=dev), torch.zeros(s[1], device=dev),
               torch.zeros(s[1], device=dev), torch.ones(s[1], device=dev)) for s in shapes]
        stats = [na._forward(x, *p, instance, 0.2, 0.1, 1e-5)[1] for x, p in zip(xs, ps)]

        def fwd():
            for x, p in zip(xs, ps):
                na._forward(x, *p, instance, 0.2, 0.1, 1e-5)

        def bwd():
            for x, dy, p, st in zip(xs, dys, ps, stats):
                na.norm_act_backward(dy, x, p[0], p[1], st, instance, 0.2)

        def aten(x, p):
            if instance:
                y = F.instance_norm(x, p[2], p[3], p[0], p[1], use_input_stats=True,
                                    momentum=0.1, eps=1e-5)
            else:
                y = F.batch_norm(x, p[2], p[3], p[0], p[1], training=True, momentum=0.1,
                                 eps=1e-5)
            return F.leaky_relu(y, 0.2)

        def aten_fwd():
            for x, p in zip(xs, ps):
                aten(x, p)

        leaves = [x.detach().requires_grad_() for x in xs]
        wl = [(p[0].clone().requires_grad_(), p[1].clone().requires_grad_(), p[2], p[3])
              for p in ps]

        def aten_both():
            for x, p, dy in zip(leaves, wl, dys):
                torch.autograd.grad(aten(x, p), (x, p[0], p[1]), dy)

        def ours_both():
            for x, p, dy in zip(leaves, wl, dys):
                torch.autograd.grad(na.norm_act(x, p[0], p[1], p[2], p[3], instance, 0.2),
                                    (x, p[0], p[1]), dy)

        fb = sum(norm_layers.forward_bytes(s, 2, instance) for s in shapes)
        bb = sum(norm_layers.backward_bytes(s, 2, instance) for s in shapes)
        t = {"fwd_ms": graph_ms(fwd, 10), "bwd_ms": graph_ms(bwd, 10),
             "fwd_bound_ms": fb / 3.35e12 * 1e3, "bwd_bound_ms": bb / 3.35e12 * 1e3}
        try:
            t["aten_fwd_ms"] = graph_ms(aten_fwd, 10)
        except Exception as e:  # noqa: BLE001 - a library path that does not capture
            t["aten_fwd_ms"] = cuda_ms(aten_fwd, 20)
            log("13 norm", f"aten forward not captured ({type(e).__name__}); eager time")
        t["eager_both_ms"] = cuda_ms(ours_both, 20)
        t["aten_eager_both_ms"] = cuda_ms(aten_both, 20)
        timings[what] = t
        share_f, share_b = t["fwd_bound_ms"] / t["fwd_ms"], t["bwd_bound_ms"] / t["bwd_ms"]
        log("13 norm", f"{what} bf16 (B={TRAIN_B}, {TRAIN_HW} px; {card}): forward "
                       f"{t['fwd_ms']:.4f} ms device-only ({100 * share_f:.0f}% of the bound "
                       f"{t['fwd_bound_ms']:.4f}), aten {t['aten_fwd_ms']:.4f}; backward "
                       f"{t['bwd_ms']:.4f} ({100 * share_b:.0f}% of {t['bwd_bound_ms']:.4f}); "
                       f"forward and backward eager {t['eager_both_ms']:.4f} against aten's "
                       f"{t['aten_eager_both_ms']:.4f}")
        del xs, dys, leaves, stats

    # a train step of the cell's configuration
    state = seeded_train_state("bfloat16", dev, g_norm_fun="InstanceNorm",
                               d_norm_fun="BatchNorm")
    for m in (state.g, state.d):
        for name, t in m.named_parameters():
            if name.endswith((".main.2.weight", ".0.2.weight")):
                with torch.no_grad():
                    t.add_(1.0)  # a norm layer's weight about 1, not the recipe's 0.1 scale
    from uegan_tpu_torch.train.step import make_train_step

    step = make_train_step(state).eager  # the eager step's profile, as before the CUDA graph
    batches = train_batches(dev, 3)
    step(*batches[0])
    torch.cuda.synchronize()
    f0, b0 = na.norm_act.launches, na.norm_act_backward.launches
    step(*batches[1])
    torch.cuda.synchronize()
    got = (na.norm_act.launches - f0, na.norm_act_backward.launches - b0)
    fwd_list, bwd_list = norm_layers.launches(CD, CD, TRAIN_HW, TRAIN_B)
    check_counts("one norm train step's norm calls", got, (len(fwd_list), len(bwd_list)))
    r = profile(lambda: step(*batches[2]), iters=5, warmup=2)
    norm_ms = sum(ms for bucket, (ms, _) in r["buckets"].items() if bucket == "norm_act")
    cfg = {"g_conv_dim": CD, "d_conv_dim": CD, "compute_dtype": "bfloat16",
           "g_norm_fun": "InstanceNorm", "d_norm_fun": "BatchNorm"}
    bound = norm_layers.step_bytes(cfg, {"image_hw": TRAIN_HW, "batch": TRAIN_B}) / 3.35e12 * 1e3
    timings["step"] = {"norm_ms": norm_ms, "bound_ms": bound, "wall_ms": r["wall_ms"],
                       "busy_ms": r["busy_ms"], "launches": got}
    log("13 norm", f"train step of g32inbn_train256's configuration (bf16, {card}): "
                   f"{got[0]} forward and {got[1]} backward norm calls; norm kernels "
                   f"{norm_ms:.3f} ms a step, {100 * bound / max(norm_ms, 1e-9):.1f}% of the "
                   f"bound {bound:.3f} ms; step wall {r['wall_ms']:.1f} ms, busy "
                   f"{r['busy_ms']:.1f} ms (profiled)")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"worst": worst, "timings": timings}


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
        canon, canon_pads = counts(), pad_counts()
        with plain_versions():
            out_p = g(x)
        torch.cuda.synchronize()
        check_counts("one canonical forward", canon, {**zero, "gam_stats": 5, "upsample2x": 4})
        check_counts("one canonical forward's reflect pads", canon_pads,
                     PAD_LAUNCHES["canonical"])
        check_counts("the plain canonical forward", (counts(), pad_counts()),
                     (canon, canon_pads))
        reset_counts()
        pk_k = fwd(x)
        torch.cuda.synchronize()
        pk, pk_pads = counts(), pad_counts()
        with plain_versions():
            pk_p = fwd(x)
        torch.cuda.synchronize()
        check_counts("one packed forward", pk, {**zero, "s2d_convert": 1,
                                                "residual_tail_d2s": 1, "upsample2x": 3,
                                                "gam_norm": 5})
        check_counts("one packed forward's reflect pads", pk_pads, PAD_LAUNCHES["packed"])
        check_counts("the plain packed forward", (counts(), pad_counts()), (pk, pk_pads))
    for name, t in (("canonical", out_k), ("packed", pk_k)):
        if not bool(torch.isfinite(t).all()) or t.shape != x.shape:
            raise AssertionError(f"{name} output: shape {tuple(t.shape)}, finite "
                                 f"{bool(torch.isfinite(t).all())}")
    d = float((out_k - out_p).abs().max())
    dp = float((pk_k - pk_p).abs().max())
    dpc = float((pk_k - out_k).abs().max())
    log("4 model", f"cd32 {IMG}px f32 (TF32 off) B=2 canonical: kernels vs plain max abs "
                   f"{d:.3e} (limit 1e-4); launches per forward {canon}, {canon_pads}")
    log("4 model", f"cd32 {IMG}px f32 (TF32 off) B=2 packed: kernels vs plain max abs "
                   f"{dp:.3e} (limit 1e-4), vs canonical max abs {dpc:.3e} (limit 2e-3); "
                   f"launches per forward {pk}, {pk_pads}")
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
                "residual_tail_d2s": 1, "packed_conv_int8": int(mode == "int8_pallas"),
                "gam_norm": 1})
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
              "packed": {**zero, "s2d_convert": 2, "residual_tail_d2s": 2, "upsample2x": 6,
                         "gam_norm": 10},
              "int8_pallas": {**zero, "packed_conv_int8": 2, "gam_stats": 12, "upsample2x": 9,
                              "s2d_convert": 3, "residual_tail_d2s": 2, "gam_norm": 3}}
    # int8_pallas: the calibration's packed forward, then two int8 forwards,
    # whose canonical interior pads as the packed forward's does
    expect_pads = {"canonical": scaled_pads((2, "canonical")), "packed": scaled_pads((2, "packed")),
                   "int8_pallas": scaled_pads((3, "packed"))}
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
                "--is_test_psnr_ssim", "true", "--compute_dtype", "bfloat16",
                "--num_workers", "4"]
        argv += flags[path]
        t0 = time.time()
        reset_counts()
        res = cli.run(argv)
        torch.cuda.synchronize()
        launched, pads = counts(), note_pads(path)
        secs = time.time() - t0
        out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")
        outs = sorted(os.listdir(out_dir))
        if outs != [f"{n}_92.00_testFakeExp.png" for n in names] or res["n_images"] != 8:
            raise AssertionError(f"--mode test ({path}) wrote {outs}")
        check_counts(f"--mode test ({path}, 2 batches)", launched, expect[path])
        check_counts(f"--mode test ({path}, 2 batches)'s reflect pads", pads, expect_pads[path])
        for sub, csv in (("psnr_test_results", "PSNR_epoch_92.0.csv"),
                         ("ssim_test_results", "SSIM_epoch_92.0.csv"),
                         ("nima_test_results", "NIMA_total_results_epoch_mean_std.csv")):
            if not os.path.exists(os.path.join(root, sub, csv)):
                raise AssertionError(f"missing {sub}/{csv} ({path})")
        nima_rows = nima_csv(os.path.join(root, "nima_test_results", "NIMA_epoch_92.0__mean_std.csv"))
        if [r[0] for r in nima_rows] != outs + ["Average"]:
            raise AssertionError(f"NIMA CSV ({path}) rows {[r[0] for r in nima_rows]}")
        if not all(math.isfinite(res[k]) for k in ("psnr", "ssim", "nima")):
            raise AssertionError(f"metrics not finite ({path}): {res}")
        got = np.stack([read_png_rgb(os.path.join(out_dir, n)) for n in outs])
        if got.shape != (8, IMG, IMG, 3):
            raise AssertionError(f"result PNGs have shape {got.shape}")
        diff = np.abs(got.astype(np.float64) - want)
        psnr = 10 * math.log10(255.0 ** 2 / max(float((diff ** 2).mean()), 1e-12))
        log("5 end to end", f"--mode test {path} bf16 B=4: 8 PNGs {IMG}x{IMG}, PSNR "
                            f"{res['psnr']:.4f} dB, SSIM {res['ssim']:.4f} vs labels, NIMA (bf16, "
                            f"seeded) {res['nima']:.4f}; launches "
                            f"{launched} for 2 batches; vs f32 plain canonical forward: PSNR "
                            f"{psnr:.2f} dB (limit >= {limit[path]:g}), max |du8| "
                            f"{int(diff.max())}, mean |du8| {diff.mean():.4f}; {secs:.1f} s")
        if psnr < limit[path]:
            raise AssertionError(f"{path} bf16 outputs only {psnr:.2f} dB from the f32 forward")
        launches[path] = launched
    time_mode_test(tmp, os.path.join(tmp, "results_packed"), rng)
    return launches


def nima_csv(path: str) -> list:
    """The rows of a NIMA epoch CSV under its header, each mean and std
    finite."""
    import csv

    with open(path) as f:
        rows = list(csv.reader(f))[1:]
    if not all(math.isfinite(float(v)) for r in rows for v in r[1:]):
        raise AssertionError(f"{path}: {rows}")
    return rows


def time_mode_test(tmp: str, results: str, rng, n: int = 32) -> None:
    """Seconds per image of ``--mode test`` on the packed default at 512 px,
    bf16, batch 4, over n images (all of a run: loader, forwards, PNGs,
    metrics), with NIMA on (the default) and off, in the order off, on, on,
    off."""
    import torch

    from uegan_tpu_torch import cli

    test_dir = os.path.join(tmp, "fivek_timing", "test")
    write_pairs(test_dir, ("label", "raw"), n, (IMG, IMG), rng)
    secs = {"true": [], "false": []}
    for nima in ("false", "true", "true", "false"):
        t0 = time.time()
        res = cli.run(["--mode", "test", "--test_img_dir", test_dir,
                       "--save_root_dir", results, "--g_conv_dim", str(CD),
                       "--test_img_size", str(IMG), "--val_batch_size", "4",
                       "--pretrained_model", "92", "--compute_dtype", "bfloat16",
                       "--num_workers", "4", "--is_test_nima", nima])
        torch.cuda.synchronize()
        secs[nima].append(time.time() - t0)
        if res["n_images"] != n or (nima == "true") != ("nima" in res):
            raise AssertionError(f"--mode test (timing, NIMA {nima}): {res}")
    for nima, what in (("true", "on"), ("false", "off")):
        per = [s / n for s in secs[nima]]
        log("5 end to end", f"--mode test packed bf16 B=4, {n} images of {IMG} px, NIMA {what}: "
                            f"{sum(per) / 2:.4f} s per image (runs {[round(p, 4) for p in per]})")


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
                  resize_size=TRAIN_HW, train_batch_size=TRAIN_B, compute_dtype=dtype, **kw)


def converged_uv(sd: dict) -> dict:
    """``sd`` with each spectral-norm u and v set to its kernel's leading
    singular vectors: the fixed point where a trained run's power iterations
    sit.  Random unit vectors instead make eval-mode sigmas far below the
    top singular value, which scales the activations up layer by layer."""
    import torch

    for k in [k for k in sd if k.endswith(".weight_orig")]:
        w = sd[k]
        left, _, right = torch.linalg.svd(w.double().reshape(w.shape[0], -1).cpu(),
                                          full_matrices=False)
        stem = k[:-len("orig")]
        sd[stem + "u"] = left[:, 0].float().contiguous().to(w.device)
        sd[stem + "v"] = right[0].float().contiguous().to(w.device)
    return sd


def seeded_train_state(dtype: str, dev, steps_per_epoch: int = 1000, **kw):
    """The train state at full width (cd 32, dd 32, VGG19 to relu5_1; other
    config fields from ``kw``) with N(0, 1/fan_in) weights from the seed, as
    phase 4's generator has; D's spectral-norm u and v random unit vectors,
    G's (under ``g_use_sn``) at their fixed point (``converged_uv``)."""
    import torch

    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.train.state import create_train_state

    state = create_train_state(train_config(dtype, **kw), dev, (TRAIN_HW, TRAIN_HW),
                               steps_per_epoch)
    for i, m in enumerate((state.g, state.d, state.vgg)):
        sd = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(m, SEED + i).items()}
        if m is state.g:
            sd = converged_uv(sd)
        m.load_state_dict({k: v.to(dev) for k, v in sd.items()})
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


def steps_kernels_vs_plain(dev, phase: str, **kw) -> None:
    """2 train steps from one seeded state (``train_config`` with ``kw``)
    with the kernels and with the plain versions, in float32 with TF32 off
    and cuDNN's deterministic algorithms (its weight gradients otherwise add
    in a run-to-run order): losses within rel 1e-4; parameters within 1e-4
    but for at most 1e-3 of them (where Adam's normalized first steps divide
    a gradient that nearly cancels), by at most the two steps' 4 lr; G's
    spectral-norm u and v, where it has them, within 1e-5 after step 1
    and, after step 2, within 1e-5 + 4 ||dW||_F / sigma of their kernel's
    differences after step 1.  Step 1's gradients against each other are
    printed."""
    import torch

    from uegan_tpu_torch.train.step import make_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    batches = train_batches(dev, 2)
    runs = {}
    for which in ("kernels", "plain"):
        state = seeded_train_state("float32", dev, **kw)
        step = make_train_step(state)
        named = [(k, p) for m in (state.g, state.d) for k, p in m.named_parameters()]
        grad_least = {k: torch.full_like(p, math.inf) for k, p in named}
        losses, first, sn = [], None, []
        with plain_versions() if which == "plain" else contextlib.nullcontext():
            for b in batches:
                losses.append({k: float(v) for k, v in step(*b)[0].items()})
                first = first or {k: p.grad.clone() for k, p in named}
                for k, p in named:  # the step's gradient with its decay term
                    g = (p.grad + state.config.weight_decay * p.detach()).abs()
                    torch.minimum(grad_least[k], g, out=grad_least[k])
                sn.append({k: t.clone() for k, t in state.g.state_dict().items()
                           if k.endswith(("weight_orig", "weight_u", "weight_v"))})
        runs[which] = (losses, {k: p.detach().clone() for k, p in named}, grad_least, first, sn)
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
    cfg = train_config("float32", **kw)
    # G's spectral-norm u and v: after step 1 both runs iterate from the same
    # weights, so within 1e-5; step 2 iterates from step 1's weights, which
    # differ where Adam divides a nearly cancelling gradient (the rule
    # above), so there each vector may differ as far as two power iterations
    # carry those differences: 1e-5 + 4 ||dW||_F / sigma
    sk, sp = runs["kernels"][4], runs["plain"][4]
    uv_keys = [k for k in sk[0] if not k.endswith("weight_orig")]
    uv1 = max((float((sk[0][k] - sp[0][k]).abs().max()) for k in uv_keys), default=0.0)
    uv2 = []  # (share of its limit, max abs, limit, key)
    for k in uv_keys:
        stem = k.rsplit(".", 1)[0]
        w = sp[0][stem + ".weight_orig"]
        sigma = float(sp[0][stem + ".weight_u"] @ w.reshape(w.shape[0], -1)
                      @ sp[0][stem + ".weight_v"])
        lim = 1e-5 + 4 * float((sk[0][stem + ".weight_orig"] - w).norm()) / sigma
        d = float((sk[1][k] - sp[1][k]).abs().max())
        uv2.append((d / lim, d, lim, k))
    uv2.sort(reverse=True)
    log(phase, f"2 steps f32 (TF32 off, deterministic cuDNN), kernels vs plain: losses "
               f"{runs['kernels'][0]} vs {runs['plain'][0]}, max rel {worst_rel:.3e} (limit "
               f"1e-4); step 1's gradients: relative L2 {grad_l2:.3e}, per tensor at most "
               f"{grad_rel:.3e} of its largest ({grad_worst}), {len(dead)} tensors whose "
               f"gradients are under 1e-5 of the largest not compared {dead}; "
               f"parameters max abs {float(diffs.max()):.3e}, {n_off} of "
               f"{diffs.numel()} over 1e-4, of which {n_off_steady} had a gradient of 1e-6 "
               f"or more at both steps; most in {[x for x in by_name[:5] if x[0]]}; median "
               f"smaller |gradient| of the two steps of those over 1e-4: "
               f"{float(grads[off].median()) if n_off else 0.0:.3e}")
    if uv_keys:
        moved = sum(1 for k in uv_keys if k.endswith("weight_u") and not torch.equal(
            sk[0][k[:-1] + "orig"], sp[0][k[:-1] + "orig"]))
        log(phase, f"G's spectral-norm u and v, kernels vs plain, {len(uv_keys)} vectors: after "
                   f"step 1 max abs {uv1:.3e} (limit 1e-5); after step 2 max abs "
                   f"{max(x[1] for x in uv2):.3e}, {moved} of {len(uv_keys) // 2} kernels "
                   f"differing after step 1; the nearest their limits (share, max abs, limit): "
                   f"{[(round(r, 3), f'{d:.3e}', f'{lim:.3e}', k) for r, d, lim, k in uv2[:4]]}")
    if (worst_rel > 1e-4 or float(diffs.max()) > 4 * max(cfg.g_lr, cfg.d_lr)
            or n_off > 1e-3 * diffs.numel() or uv1 > 1e-5 or (uv2 and uv2[0][0] > 1)):
        raise AssertionError(f"{phase}: the train step with the kernels disagrees with the "
                             "plain versions")
    del runs, diffs, grads
    torch.backends.cudnn.allow_tf32 = True



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
              "--test_img_size", str(IMG), "--val_batch_size", "2",
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
    printed = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
        res = cli.run(argv)
    torch.cuda.synchronize()
    cli_counts, cli_pads = counts(), note_pads("train")
    secs = time.time() - t0
    # NIMA and the on-device PSNR/SSIM ran in the validation, on the JAX defaults
    nima_total = os.path.join(root, "nima_val_results", "NIMA_total_results_epoch_mean_std.csv")
    od = [ln for ln in printed.getvalue().splitlines() if "On-device Avg. PSNR" in ln]
    if (len(od) != 1 or "Avg. NIMA" not in printed.getvalue() or not os.path.exists(nima_total)
            or not open(nima_total).read().splitlines()[-1].startswith("Best epoch:1.0,")):
        raise AssertionError(f"--mode train: on-device metrics {od}, NIMA total CSV "
                             f"{os.path.exists(nima_total)}")
    nima_csv(os.path.join(root, "nima_val_results", "NIMA_epoch_1.0__mean_std.csv"))
    want = {k: 3 * v for k, v in per_step.items()}
    want["gam_stats"] += 5  # the validation forward (2 images, one batch)
    want["upsample2x"] += 4
    check_counts("--mode train (3 steps and one validation batch)", cli_counts, want)
    check_counts("--mode train (3 steps and one validation batch)'s reflect pads", cli_pads,
                 scaled_pads((3, "train"), (1, "canonical")))
    losses = res["last_losses"]
    pth = os.path.join(root, "UEGAN-FiveK", "models", "UEGAN-FiveK_rahinge_1.pth")
    if res["steps"] != 3 or not os.path.exists(pth) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"--mode train: {res}, checkpoint {os.path.exists(pth)}")
    log("6 train", f"python -m uegan_tpu_torch --mode train, cd {CD} dd {CD}, {TRAIN_HW} px crops "
                   f"of {2 * TRAIN_HW}, B={TRAIN_B}, bf16, 30 pairs: 3 steps in {secs:.1f} s with "
                   f"validation, last losses {losses}; launches {cli_counts}, {cli_pads}; wrote "
                   f"{os.path.basename(pth)}; validation: {od[0].strip('= ')}, NIMA "
                   f"{open(nima_total).read().splitlines()[0]}")
    test_dir = os.path.join(data, "test")
    res = cli.run(["--mode", "test", "--test_img_dir", test_dir, "--test_label_dir",
                   os.path.join(test_dir, "label") + os.sep, "--pretrained_model", "1"] + common)
    if res["n_images"] != 2 or not (math.isfinite(res["psnr"]) and math.isfinite(res["nima"])):
        raise AssertionError(f"--mode test on the trained .pth: {res}")
    log("6 train", f"--mode test on {os.path.basename(pth)}: {res['n_images']} PNGs, PSNR "
                   f"{res['psnr']:.4f} dB, SSIM {res['ssim']:.4f}, NIMA {res['nima']:.4f}")

    steps_kernels_vs_plain(dev, "6 train")

    # bf16: finite, both nets moved; one step's launches.  The eager step
    # alone: the plain versions swap functions that a CUDA graph of the step
    # (phase 6d) would have captured with the kernels
    state = seeded_train_state("bfloat16", dev)
    step = make_train_step(state).eager
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
    step_pads = pad_counts()
    check_counts("one bf16 train step's reflect pads", step_pads, PAD_LAUNCHES["train"])
    finite = all(math.isfinite(float(v)) for m in got for v in m.values())
    log("6 train", f"bf16 steps: losses {[{k: round(float(v), 4) for k, v in m.items()} for m in got]}"
                   f", finite {finite}; largest move G {moved['G']:.3e}, D {moved['D']:.3e}; "
                   f"launches a step {per_step}, {step_pads}")
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
    check_no_aten_pad("6 train", "the fused train step", r)
    log("6 train", "| bucket | ms per step | kernels per step | share of busy |")
    for k, (b_ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
        log("6 train", f"| {k} | {b_ms:.3f} | {n:g} | {b_ms / r['busy_ms']:.1%} |")
    return {"launches": cli_counts, "ms": ms, "peak_gib": peak, "profile": r}


def phase_sn(dev, card: str, tmp: str) -> dict:
    """Spectral norm in the generator (``--g_use_sn true``) at the default
    width (cd 32, dd 32, 256 px crops of 512, B=10).  Its train step is the
    unfused one: G(raw), the D update, then G(exp), so G's u and v advance
    twice a step and A, B, A' and B' run at B=10 twice a step.

    - ``--mode train --g_use_sn true`` through uegan_tpu_torch.cli.run on a
      synthetic FiveK layout of 20 pairs (2 steps and a validation batch,
      bf16, NIMA off), launches counted; then ``--mode test --g_use_sn
      true`` on the .pth it wrote and on one of seeded N(0, 1/fan_in)
      weights: the canonical route (A 5, B 4, C and D 0 each), PNGs >= 35 dB
      from the f32 plain canonical forward of the same weights;
    - 2 f32 steps from one seeded SN state with the kernels and with the
      plain versions (steps_kernels_vs_plain: phase 6's limits, and G's u
      and v within 1e-5);
    - one bf16 step's launches: A 10, B 8, A' 10, B' 8, C-F 0;
    - ms per bf16 step with the kernels and with the plain versions, beside
      the fused default step, in turns; the peak device memory of a step;
      the step's device time by bucket under torch.profiler."""
    import numpy as np
    import torch

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.train.step import make_train_step
    from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    t_phase = time.time()
    zero = dict.fromkeys(KERNELS, 0)
    per_forward = {**zero, "gam_stats": 5, "upsample2x": 4}
    per_step = {**zero, "gam_stats": 10, "upsample2x": 8, "gam_stats_bwd": 10,
                "upsample2x_bwd": 8}
    rng = np.random.default_rng(SEED + 20)
    data = os.path.join(tmp, "fivek_sn")
    write_pairs(os.path.join(data, "train"), ("exp", "raw"), 2 * TRAIN_B,
                (2 * TRAIN_HW + 32, 2 * TRAIN_HW + 64), rng)
    for part in ("val", "test"):
        write_pairs(os.path.join(data, part), ("label", "raw"), 2, (IMG, IMG), rng)
    root = os.path.join(tmp, "results_sn")
    common = ["--save_root_dir", root, "--g_conv_dim", str(CD), "--d_conv_dim", str(CD),
              "--g_use_sn", "true", "--test_img_size", str(IMG), "--val_batch_size", "2",
              "--is_test_nima", "false", "--is_test_psnr_ssim", "true",
              "--compute_dtype", "bfloat16", "--num_workers", "8"]
    reset_counts()
    res = cli.run(["--mode", "train", "--train_img_dir", os.path.join(data, "train"),
                   "--val_img_dir", os.path.join(data, "val"),
                   "--val_label_dir", os.path.join(data, "val", "label") + os.sep,
                   "--image_size", str(2 * TRAIN_HW), "--resize_size", str(TRAIN_HW),
                   "--train_batch_size", str(TRAIN_B), "--pool_size", "50",
                   "--total_epochs", "1", "--num_epochs_start_val", "0",
                   "--val_each_epochs", "1", "--info_step", "1", "--sample_step", "2"] + common)
    torch.cuda.synchronize()
    train_counts, train_pads = counts(), note_pads("sn_train")
    want = {k: 2 * v + per_forward[k] for k, v in per_step.items()}  # + the validation batch
    check_counts("--mode train --g_use_sn true (2 steps and one validation batch)",
                 train_counts, want)
    check_counts("--mode train --g_use_sn true (2 steps and one validation batch)'s reflect pads",
                 train_pads, scaled_pads((2, "sn_train"), (1, "canonical")))
    pth = os.path.join(root, "UEGAN-FiveK", "models", "UEGAN-FiveK_rahinge_1.pth")
    ckpt = load_pth(pth)
    losses = res["last_losses"]
    if (res["steps"] != 2 or "ga1.fuse.0.weight_u" not in ckpt["G_net"]
            or not all(math.isfinite(v) for v in losses.values())):
        raise AssertionError(f"--mode train --g_use_sn true: {res}, G_net {sorted(ckpt['G_net'])}")
    log("6b sn", f"python -m uegan_tpu_torch --mode train --g_use_sn true, cd {CD} dd {CD}, "
                 f"{TRAIN_HW} px crops, B={TRAIN_B}, bf16, 20 pairs: 2 steps with validation, "
                 f"last losses {losses}; launches {train_counts}, {train_pads}; wrote "
                 f"{os.path.basename(pth)} "
                 f"(G_net with weight_orig, weight_u, weight_v)")

    # --mode test on the trainer's .pth (epoch 1; its residual is small, as
    # the 0.02 orthogonal init leaves the unnormalized dec5 head), and on a
    # reference-format .pth of N(0, 1/fan_in) weights (epoch 2), whose
    # residual is of order one, with u and v at their fixed point
    seeded = converged_uv({k: torch.from_numpy(v) for k, v in fan_in_normal_state(
        Generator(conv_dim=CD, use_sn=True), SEED + 21).items()})
    models = os.path.dirname(pth)
    torch.save({"G_net": seeded,
                "D_net": {}, "epoch": 2.0, "g_optimizer": {}, "d_optimizer": {},
                "lr_scheduler_g": {}, "lr_scheduler_d": {}},
               os.path.join(models, "UEGAN-FiveK_rahinge_2.pth"))
    test_dir = os.path.join(data, "test")
    out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")
    names = sorted(n[:-len(".png")] for n in os.listdir(os.path.join(test_dir, "raw")))
    raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in names])
    test_counts = dict.fromkeys(KERNELS, 0)
    test_pads = dict.fromkeys(PAD_LAUNCHES["canonical"], 0)
    for epoch in (1, 2):
        reset_counts()
        res = cli.run(["--mode", "test", "--test_img_dir", test_dir, "--test_label_dir",
                       os.path.join(test_dir, "label") + os.sep, "--pretrained_model",
                       str(epoch)] + common)
        torch.cuda.synchronize()
        launched, pads = counts(), pad_counts()
        check_counts(f"--mode test --g_use_sn true, epoch {epoch} (one batch: the canonical "
                     "route)", (launched, pads), (per_forward, PAD_LAUNCHES["canonical"]))
        test_counts = {k: v + launched[k] for k, v in test_counts.items()}
        test_pads = note_pads("sn_test", {k: v + pads[k] for k, v in test_pads.items()})
        got = np.stack([read_png_rgb(os.path.join(out_dir, f"{n}_{epoch}.00_testFakeExp.png"))
                        for n in names])
        g32 = Generator(conv_dim=CD, use_sn=True)
        g32.load_state_dict(generator_state(load_pth(os.path.join(
            models, f"UEGAN-FiveK_rahinge_{epoch}.pth")), ema=True))
        g32 = g32.to(dev).eval()
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode(), plain_versions():
            ref = quantize_u8(g32(normalize_u8(torch.from_numpy(raw).to(dev)))).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = True
        diff = np.abs(got.astype(np.float64) - ref)
        psnr = 10 * math.log10(255.0 ** 2 / max(float((diff ** 2).mean()), 1e-12))
        moved = float(np.abs(ref.astype(np.float64) - raw).mean())
        what = "the trainer's" if epoch == 1 else "seeded N(0, 1/fan_in)"
        log("6b sn", f"--mode test --g_use_sn true on {what} UEGAN-FiveK_rahinge_{epoch}.pth: "
                     f"{res['n_images']} PNGs {IMG}x{IMG}, PSNR {res['psnr']:.4f} dB vs labels; "
                     f"launches {launched}; vs the f32 plain canonical forward: PSNR "
                     f"{psnr:.2f} dB (limit >= 35), max |du8| {int(diff.max())}; mean "
                     f"|output - input| {moved:.2f} gray levels")
        if psnr < 35.0 or res["n_images"] != 2:
            raise AssertionError(f"--mode test --g_use_sn true, epoch {epoch}: {psnr:.2f} dB, "
                                 f"{res}")

    steps_kernels_vs_plain(dev, "6b sn", g_use_sn=True)

    state = seeded_train_state("bfloat16", dev, g_use_sn=True)
    step = make_train_step(state).eager  # as phase 6's: eager, the kernels against plain
    batches = train_batches(dev, 3)
    for b in batches[:2]:
        step(*b)
    reset_counts()
    step(*batches[2])
    torch.cuda.synchronize()
    check_counts("one bf16 train step with --g_use_sn true", counts(), per_step)
    step_pads = pad_counts()
    check_counts("one bf16 train step with --g_use_sn true's reflect pads", step_pads,
                 PAD_LAUNCHES["sn_train"])
    fused_state = seeded_train_state("bfloat16", dev)
    steps = {"sn": step, "fused": make_train_step(fused_state).eager}
    times = {"sn kernels": [], "sn plain": [], "fused kernels": []}
    for which in ("sn kernels", "fused kernels", "sn plain", "sn plain", "fused kernels",
                  "sn kernels"):
        with plain_versions() if "plain" in which else contextlib.nullcontext():
            times[which].append(train_step_ms(steps[which.split()[0]], batches))
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    del steps, fused_state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step(*batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in ("sn kernels", "sn plain", "fused kernels"):
        log("6b sn", f"train step {TRAIN_HW}px B={TRAIN_B} bf16, {k}: {ms[k]:.3f} ms/step, "
                     f"{TRAIN_B * 1000 / ms[k]:.2f} img/s (runs {times[k]}) [{card}]")
    log("6b sn", f"launches a bf16 step {per_step}, {step_pads}; peak device memory of an SN step: "
                 f"{peak:.3f} GiB [{card}]")
    r = profile(lambda: step(*batches[0]), iters=5, warmup=2)
    n_kernels = sum(n for _, n in r["buckets"].values())
    log("6b sn", f"SN train step under torch.profiler: wall {r['wall_ms']:.3f} ms per step, "
                 f"device busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, "
                 f"{n_kernels:g} kernels a step [{card}]")
    check_no_aten_pad("6b sn", "the SN train step", r)
    log("6b sn", "| bucket | ms per step | kernels per step | share of busy |")
    for k, (b_ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
        log("6b sn", f"| {k} | {b_ms:.3f} | {n:g} | {b_ms / r['busy_ms']:.1%} |")
    log("6b sn", f"phase {time.time() - t_phase:.1f} s")
    del step, state
    return {"sn_train": train_counts, "sn_test": test_counts}


def phase_norm_cli(dev, card: str, tmp: str) -> None:
    """Train-mode norm layers through the CLI (``--g_norm_fun InstanceNorm
    --d_norm_fun BatchNorm``, the configuration of the cell g32inbn_train256)
    at the default width (cd 32, dd 32, 256 px crops of 512, B=10, bf16):

    - ``--mode train`` through uegan_tpu_torch.cli.run on a synthetic FiveK
      layout of 20 pairs (2 steps and a validation batch, NIMA off): the
      norm calls counted (portbench/counts/norm_layers.py's 43 forward and
      38 backward a step; the validation's eval-mode norms make none), the
      running statistics of G's 9 and D's 5 norm layers in the .pth, moved;
    - a resume from that .pth for a second epoch: the loaded state holds
      its running statistics bit for bit, and 2 more steps run;
    - ``--mode test --g_norm_fun InstanceNorm`` on the epoch-2 .pth and on
      one of seeded weights with running statistics away from 0 and 1: the
      canonical route (A 5, B 4, no norm call), PNGs >= 35 dB from the f32
      plain canonical forward of the same weights and running statistics."""
    import numpy as np
    import torch

    from portbench.counts import norm_layers
    from uegan_tpu_torch import cli
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.models.initializers import fan_in_normal_state
    from uegan_tpu_torch.ops import norm_act as na
    from uegan_tpu_torch.train import trainer as trainer_mod
    from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    t_phase = time.time()
    per_forward = {**dict.fromkeys(KERNELS, 0), "gam_stats": 5, "upsample2x": 4}
    fwd_list, bwd_list = norm_layers.launches(CD, CD, TRAIN_HW, TRAIN_B)
    rng = np.random.default_rng(SEED + 30)
    data = os.path.join(tmp, "fivek_norm")
    write_pairs(os.path.join(data, "train"), ("exp", "raw"), 2 * TRAIN_B,
                (2 * TRAIN_HW + 32, 2 * TRAIN_HW + 64), rng)
    for part in ("val", "test"):
        write_pairs(os.path.join(data, part), ("label", "raw"), 2, (IMG, IMG), rng)
    root = os.path.join(tmp, "results_norm")
    common = ["--save_root_dir", root, "--g_conv_dim", str(CD), "--d_conv_dim", str(CD),
              "--g_norm_fun", "InstanceNorm", "--test_img_size", str(IMG),
              "--val_batch_size", "2", "--is_test_nima", "false", "--is_test_psnr_ssim", "true",
              "--compute_dtype", "bfloat16", "--num_workers", "8"]

    def train(epochs: int, resume: int) -> dict:
        na.norm_act.launches = na.norm_act_backward.launches = 0
        reset_counts()
        res = cli.run(["--mode", "train", "--d_norm_fun", "BatchNorm",
                       "--train_img_dir", os.path.join(data, "train"),
                       "--val_img_dir", os.path.join(data, "val"),
                       "--val_label_dir", os.path.join(data, "val", "label") + os.sep,
                       "--image_size", str(2 * TRAIN_HW), "--resize_size", str(TRAIN_HW),
                       "--train_batch_size", str(TRAIN_B), "--pool_size", "50",
                       "--total_epochs", str(epochs), "--num_epochs_start_val", "0",
                       "--val_each_epochs", "1", "--info_step", "1", "--sample_step", "2",
                       "--pretrained_model", str(resume)] + common)
        torch.cuda.synchronize()
        calls = (na.norm_act.launches, na.norm_act_backward.launches)
        check_counts(f"--mode train with norms, epochs {resume} to {epochs} (2 steps and one "
                     "validation batch)'s norm calls", calls, (2 * len(fwd_list),
                                                              2 * len(bwd_list)))
        if not all(math.isfinite(v) for v in res["last_losses"].values()):
            raise AssertionError(f"--mode train with norms: {res}")
        log("6c norm", f"python -m uegan_tpu_torch --mode train --g_norm_fun InstanceNorm "
                       f"--d_norm_fun BatchNorm, epochs {resume} to {epochs}, cd {CD} dd {CD}, "
                       f"{TRAIN_HW} px crops, B={TRAIN_B}, bf16: {res['steps']} steps in all, "
                       f"last losses {res['last_losses']}; norm calls {calls}; launches "
                       f"{counts()} [{card}]")
        return res

    def running(ckpt: dict) -> dict:
        return {f"{net}.{k}": v for net in ("G_net", "D_net") for k, v in ckpt[net].items()
                if k.endswith(("running_mean", "running_var"))}

    models = os.path.join(root, "UEGAN-FiveK", "models")
    train(1, 0)
    first = running(load_pth(os.path.join(models, "UEGAN-FiveK_rahinge_1.pth")))
    init = {k: 0.0 if k.endswith("mean") else 1.0 for k in first}
    still = [k for k, v in first.items() if bool((v == init[k]).all())]
    if len(first) != 2 * (9 + 5) or still or not all(bool(v.isfinite().all())
                                                     for v in first.values()):
        raise AssertionError(f"epoch 1's .pth: running statistics {sorted(first)}, unmoved "
                             f"{still}")

    restored = {}
    real_load = trainer_mod.load_checkpoint

    def load_and_keep(state, loaded):
        real_load(state, loaded)
        for net, m in (("G_net", state.g), ("D_net", state.d)):
            restored.update({f"{net}.{k}": v.detach().cpu().clone()
                             for k, v in m.state_dict().items()})
    trainer_mod.load_checkpoint = load_and_keep
    try:
        res = train(2, 1)
    finally:
        trainer_mod.load_checkpoint = real_load
    unequal = [k for k, v in first.items() if not torch.equal(restored[k], v.cpu())]
    if res["steps"] != 4 or unequal:
        raise AssertionError(f"the resume: {res['steps']} steps; running statistics not "
                             f"restored bit for bit: {unequal}")
    second = running(load_pth(os.path.join(models, "UEGAN-FiveK_rahinge_2.pth")))
    moved = max(float((second[k].float() - v.float()).abs().max()) for k, v in first.items())
    log("6c norm", f"resume from epoch 1: {len(first)} running statistics restored bit for "
                   f"bit; epoch 2 moved them by up to {moved:.3e}")

    # --mode test on the trainer's epoch-2 .pth, and on a reference-format
    # .pth (epoch 3) of N(0, 1/fan_in) weights, norm weights about 1 and
    # running statistics away from 0 and 1, so that the output is of order
    # one away from the input and depends on the running statistics
    seeded = {k: torch.from_numpy(v) for k, v in fan_in_normal_state(
        Generator(conv_dim=CD, norm_fun="InstanceNorm"), SEED + 31).items()}
    for k in seeded:
        if k.endswith(".main.2.weight"):
            seeded[k] += 1.0
    torch.save({"G_net": seeded, "D_net": {}, "epoch": 3.0, "g_optimizer": {},
                "d_optimizer": {}, "lr_scheduler_g": {}, "lr_scheduler_d": {}},
               os.path.join(models, "UEGAN-FiveK_rahinge_3.pth"))
    test_dir = os.path.join(data, "test")
    out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")
    names = sorted(n[:-len(".png")] for n in os.listdir(os.path.join(test_dir, "raw")))
    raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in names])
    for epoch in (2, 3):
        na.norm_act.launches = 0
        reset_counts()
        res = cli.run(["--mode", "test", "--test_img_dir", test_dir, "--test_label_dir",
                       os.path.join(test_dir, "label") + os.sep, "--pretrained_model",
                       str(epoch)] + common)
        torch.cuda.synchronize()
        launched, pads = counts(), pad_counts()
        check_counts(f"--mode test --g_norm_fun InstanceNorm, epoch {epoch} (one batch: the "
                     "canonical route)", (launched, pads, na.norm_act.launches),
                     (per_forward, PAD_LAUNCHES["canonical"], 0))
        got = np.stack([read_png_rgb(os.path.join(out_dir, f"{n}_{epoch}.00_testFakeExp.png"))
                        for n in names])
        g32 = Generator(conv_dim=CD, norm_fun="InstanceNorm")
        g32.load_state_dict(generator_state(
            load_pth(os.path.join(models, f"UEGAN-FiveK_rahinge_{epoch}.pth")), ema=True))
        g32 = g32.to(dev).eval()
        torch.backends.cudnn.allow_tf32 = False
        with torch.inference_mode(), plain_versions():
            ref = quantize_u8(g32(normalize_u8(torch.from_numpy(raw).to(dev)))).cpu().numpy()
        torch.backends.cudnn.allow_tf32 = True
        diff = np.abs(got.astype(np.float64) - ref)
        psnr = 10 * math.log10(255.0 ** 2 / max(float((diff ** 2).mean()), 1e-12))
        moved = float(np.abs(ref.astype(np.float64) - raw).mean())
        what = "the trainer's" if epoch == 2 else "seeded N(0, 1/fan_in)"
        log("6c norm", f"--mode test --g_norm_fun InstanceNorm on {what} "
                       f"UEGAN-FiveK_rahinge_{epoch}.pth: {res['n_images']} PNGs {IMG}x{IMG}, "
                       f"PSNR {res['psnr']:.4f} dB vs labels; launches {launched}; vs the f32 "
                       f"plain canonical forward: PSNR {psnr:.2f} dB (limit >= 35), max |du8| "
                       f"{int(diff.max())}; mean |output - input| {moved:.2f} gray levels")
        if psnr < 35.0 or res["n_images"] != 2:
            raise AssertionError(f"--mode test --g_norm_fun InstanceNorm, epoch {epoch}: "
                                 f"{psnr:.2f} dB, {res}")
    log("6c norm", f"phase {time.time() - t_phase:.1f} s")


GRAPH_STEPS = 10  # a pool of 5 batches: steps 1-5 fill it, 6-10 replay
GRAPH_CONFIGS = {"fused": {}, "sn": {"g_use_sn": True},
                 "in_bn": {"g_norm_fun": "InstanceNorm", "d_norm_fun": "BatchNorm"}}


def train_record(state, losses: list) -> dict:
    """Everything the train steps changed, copied and named: each step's
    losses, G's and D's parameters and buffers, Adam's moments and step
    counts, the pool (its images and count) and the EMA."""
    import torch

    rec = {f"step{i + 1}:{k}": v.detach().clone() for i, m in enumerate(losses)
           for k, v in m.items()}
    for net, m, opt in (("G", state.g, state.g_opt), ("D", state.d, state.d_opt)):
        rec.update({f"{net}:{k}": v.detach().clone() for k, v in m.state_dict().items()})
        for k, p in m.named_parameters():
            rec.update({f"{net}:{k}:adam.{s}": v.detach().clone()
                        for s, v in opt.state[p].items()})
    rec["pool:images"] = state.pool.images.clone()
    rec["pool:count"] = torch.tensor(state.pool.count)
    rec.update({f"ema:{k}": v.clone() for k, v in (state.g_ema or {}).items()})
    return rec


def max_gap(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def graph_cli(card: str, tmp: str) -> None:
    """``--mode train`` through cli.run with a pool of one batch, so that the
    Trainer's steps replay from its second (4 steps, the losses printed each
    step, samples at step 3, a checkpoint and a validation batch with the
    EMA), then a resume from that .pth for 4 more (the pool starts empty
    again): each run's ``=== step timing`` line must count one capture,
    three replays and one eager step, and the resumed Adams must go on from
    the saved step counts, which the .pth holds as a plain Adam writes them."""
    import ast

    import numpy as np
    import torch

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.utils.checkpoint import load_pth

    rng = np.random.default_rng(SEED + 6)
    data = os.path.join(tmp, "fivek_graph")
    write_pairs(os.path.join(data, "train"), ("exp", "raw"), 4 * TRAIN_B,
                (2 * TRAIN_HW, 2 * TRAIN_HW), rng)
    write_pairs(os.path.join(data, "val"), ("label", "raw"), 2, (IMG, IMG), rng)
    root = os.path.join(tmp, "results_graph")
    models = os.path.join(root, "UEGAN-FiveK", "models")
    for epochs in (1, 2):
        printed = io.StringIO()
        with contextlib.redirect_stdout(Tee(sys.stdout, printed)):
            res = cli.run([
                "--mode", "train", "--train_img_dir", os.path.join(data, "train"),
                "--val_img_dir", os.path.join(data, "val"),
                "--val_label_dir", os.path.join(data, "val", "label") + os.sep,
                "--save_root_dir", root, "--g_conv_dim", str(CD), "--d_conv_dim", str(CD),
                "--image_size", str(2 * TRAIN_HW), "--resize_size", str(TRAIN_HW),
                "--test_img_size", str(IMG), "--train_batch_size", str(TRAIN_B),
                "--val_batch_size", "2", "--pool_size", str(TRAIN_B), "--g_ema_decay", "0.999",
                "--total_epochs", str(epochs), "--pretrained_model", str(epochs - 1),
                "--num_epochs_start_val", "0", "--val_each_epochs", "1", "--info_step", "1",
                "--sample_step", "3", "--compute_dtype", "bfloat16", "--is_test_nima", "false",
                "--is_test_psnr_ssim", "false", "--num_workers", "8"])
        torch.cuda.synchronize()
        line, = [ln for ln in printed.getvalue().splitlines() if ln.startswith("=== step timing")]
        timing = ast.literal_eval(line[len("=== step timing: "):-len(" ===")])
        ckpt = load_pth(os.path.join(models, f"UEGAN-FiveK_rahinge_{epochs}.pth"))
        opt = ckpt["g_optimizer"]
        steps = {float(v["step"]) for v in opt["state"].values()}
        group, = opt["param_groups"]
        counters = (timing["captures"], timing["replays"], timing["eager_steps"])
        log("6d graph", f"--mode train, epochs {epochs - 1} to {epochs}, pool of one batch: "
                        f"{res['steps']} steps in all, last losses {res['last_losses']}; "
                        f"counters (captures, replays, eager) {counters}, replay share "
                        f"{timing['replay_share']:.2f}, p50 step {timing['p50_s'] * 1e3:.2f} ms; "
                        f"the .pth's G Adam: step counts {steps}, lr {group['lr']!r}, "
                        f"capturable {group['capturable']} [{card}]")
        if (counters != (1, 3, 1) or res["steps"] != 4 * epochs or steps != {4.0 * epochs}
                or group["capturable"] or not isinstance(group["lr"], float)
                or not all(math.isfinite(v) for v in res["last_losses"].values())):
            raise AssertionError(f"6d graph: --mode train, epochs {epochs - 1} to {epochs}: "
                                 f"{res}, counters {counters}, Adam steps {steps}, {group}")


def phase_graph(dev, card: str, tmp: str) -> dict:
    """Phase 6d (the module's docstring): the replayed train step against the
    eager one, the profilers' paths, and the Trainer's replays."""
    import torch

    from uegan_tpu_torch.train.step import make_train_step

    t_phase = time.time()
    batches = train_batches(dev, GRAPH_STEPS)
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, kw in GRAPH_CONFIGS.items():
            recs, info = {}, {}
            for run in ("replay", "eager", "eager again"):
                state = seeded_train_state("bfloat16", dev, steps_per_epoch=1,
                                           pool_size=5 * TRAIN_B,
                                           g_ema_decay=0.999, lr_num_epochs_decay=8, **kw)
                fn = make_train_step(state)
                step = fn if run == "replay" else fn.eager
                losses, secs = [], []
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                for b in batches:
                    t = time.perf_counter()
                    metrics, _ = step(*b)
                    losses.append({k: v.clone() for k, v in metrics.items()})
                    torch.cuda.synchronize()
                    secs.append(time.perf_counter() - t)
                recs[run] = train_record(state, losses)
                info[run] = {"counters": (fn.captures, fn.replays, fn.eager_steps),
                             "step6_s": secs[5],
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                             "lr": [float(g["lr"]) for g in state.g_opt.param_groups],
                             "ms": train_step_ms(step, batches)}
                if run == "replay":
                    paths = graph_paths(fn, batches)
                del state, fn, step
                gc.collect()
                torch.cuda.empty_cache()
            rep, e1, e2 = recs["replay"], recs["eager"], recs["eager again"]
            equal = {k: bits_equal(rep[k], e1[k]) for k in e1}
            noisy = [k for k in e1 if not bits_equal(e2[k], e1[k])]
            worse = [(k, max_gap(rep[k], e1[k]), max_gap(e2[k], e1[k])) for k in e1
                     if not equal[k] and (k not in noisy or max_gap(rep[k], e1[k])
                                          > max_gap(e2[k], e1[k]))]
            counters = info["replay"]["counters"]
            log("6d graph", f"{name}: {len(e1)} tensors over {GRAPH_STEPS} steps, replay vs "
                            f"eager bit-equal {sum(equal.values())}, eager vs eager bit-equal "
                            f"{len(e1) - len(noisy)}; over the eager pair's gap "
                            f"{len(worse)} {worse[:4]}; counters (captures, replays, eager) "
                            f"{counters}; step 6 (capture and replay) "
                            f"{info['replay']['step6_s']:.3f} s against eager "
                            f"{info['eager']['step6_s']:.3f} s; ms a step replayed "
                            f"{info['replay']['ms']:.3f}, eager {info['eager']['ms']:.3f}; "
                            f"peak GiB replayed {info['replay']['peak_gib']:.3f}, eager "
                            f"{info['eager']['peak_gib']:.3f}; G lr after the steps "
                            f"{info['replay']['lr']}; paths {paths} [{card}]")
            if worse or counters != (1, GRAPH_STEPS - 5, 5) or paths != GRAPH_PATHS:
                raise AssertionError(f"6d graph: {name}: the replayed step differs from the "
                                     f"eager one: {worse[:8]}, counters {counters}, "
                                     f"paths {paths}")
            out[name] = info
    finally:
        torch.backends.cudnn.deterministic = False
    graph_cli(card, tmp)
    log("6d graph", f"phase {time.time() - t_phase:.1f} s")
    return out


# the path a step takes: under the benchmark's device-only profiler, under
# its host-op profiler with shapes, under a host-op profiler without shapes,
# on another batch size, and then once more on the captured one
GRAPH_PATHS = {"device-only profiler": "replay", "host ops with shapes": "eager",
               "host ops without shapes": "replay", "another batch size": "eager",
               "after them": "replay"}


def graph_paths(fn, batches: list) -> dict:
    """Which path ``fn`` (a make_train_step past its capture) takes in each
    case of GRAPH_PATHS, read from its counters; the device-only profiler's
    record must hold the replayed kernels."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from uegan_tpu_torch.train.step import host_ops_recorded

    cpu, cuda = ProfilerActivity.CPU, ProfilerActivity.CUDA
    half = tuple(t[:t.shape[0] // 2] for t in batches[0])
    cases = {"device-only profiler": (lambda: torch_profile(activities=[cuda]), batches[0]),
             "host ops with shapes": (lambda: torch_profile(activities=[cpu, cuda],
                                                            record_shapes=True), batches[1]),
             "host ops without shapes": (lambda: torch_profile(activities=[cpu, cuda]),
                                         batches[2]),
             "another batch size": (contextlib.nullcontext, half),
             "after them": (contextlib.nullcontext, batches[3])}
    paths, seen = {}, {}
    for what, (ctx, b) in cases.items():
        before = fn.replays
        with ctx() as prof:
            seen[what] = (str(torch._C._autograd._profiler_type()), host_ops_recorded())
            fn(*b)
            torch.cuda.synchronize()
        paths[what] = "replay" if fn.replays > before else "eager"
        if what == "device-only profiler":
            kernels = sum(1 for e in prof.profiler.kineto_results.events()
                          if str(e.device_type()).endswith("CUDA"))
            if kernels < 1000:
                raise AssertionError(f"6d graph: the device-only profiler recorded {kernels} "
                                     "device records of a replayed step")
            paths["device records of a replay"] = kernels
    log("6d graph", f"paths {paths}; profiler type and host_ops_recorded() under each {seen}")
    return {k: v for k, v in paths.items() if k in GRAPH_PATHS}


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
        pads = timing_pad(dev, card, gen, three, us)
        gam_norm_err = timing_gam_norm(dev, card, gen, three, add, us)
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
                    "upsample2x_bwd": "train step",
                    "gam_norm": f"forward at B={GAM_NORM_B}"}.get(name, "forward")
        log("7 timing", f"{name} per {per_what}, "
                        f"device-only ({methods}): kernel {dv['kernel']:.4f} ms (eager "
                        f"{ev['kernel']:.4f}), plain {dv['plain']:.4f} (eager {ev['plain']:.4f}), "
                        f"library {lib} ms, bound {p['bound']:.4f} ms by {p['bound_by']} "
                        f"({p['bytes'] / 1e6:.1f} MB at 3.35 TB/s: {t_bytes:.4f} ms; "
                        f"{p['ops'] / 1e9:.1f} G operations: {t_ops:.4f} ms), "
                        f"{p['bound'] / dv['kernel']:.0%} of the bound [{card}]")
    return {"forward": fwd, "per_kernel": per, "reflect_pad": pads, "gam_norm_err": gam_norm_err}


def timing_gam_norm(dev, card: str, gen, three, add, us) -> float:
    """The GAM norm pair (ops/gam_norm.py) device-only in bfloat16 at the
    enhancement cell's five maps (GAM_NORM_SHAPES, B = GAM_NORM_B), cold
    (each call takes the next of a ring of inputs over 100 MB), beside its
    plain version (the PyTorch chain the packed forward ran before it) and
    the library call (F.instance_norm of the NCHW view); bound: x read once
    and y written once at 3.35 TB/s.  At each map the pair is also held to
    the plain form run in float64, in float32 and in bfloat16 (chip_smoke's
    compare: 1e-5 in float32, one ulp in bfloat16), and two of its images
    alone must give the bits they get in the batch.  Then at one image
    (GAM_NORM_ONE), the pair against the chain alone, device-only.  Returns
    the largest error, as the kernels line's max_abs_err."""
    import torch
    import torch.nn.functional as F

    from uegan_tpu_torch.ops import gam_norm as gn

    worst = 0.0
    for h, w, c in GAM_NORM_SHAPES:
        shape = (GAM_NORM_B, h, w, c)
        nbytes = GAM_NORM_B * h * w * c * 2
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn(shape, generator=gen, device=dev) * 2 + 1).to(dtype)
            got = gn.gam_norm(x)
            want = gn.plain(x.double())
            err, _, ok = compare(got, want, dtype)
            perr = compare(gn.plain(x), want, dtype)[0]
            worst = max(worst, err)
            log("7 timing", f"gam_norm {shape} {dtype}: vs the plain form in float64 max abs "
                            f"{err:.3e} {'ok' if ok else 'OUT OF TOLERANCE'} (the plain form in "
                            f"{dtype}: {perr:.3e})")
            if not ok:
                raise AssertionError(f"gam_norm {shape} {dtype} disagrees with the plain form")
            # the plan cuts an image alike in any batch: alone, the same bits
            if not all(bits_equal(gn.gam_norm(x[i:i + 1].clone())[0], got[i])
                       for i in (0, GAM_NORM_B - 1)):
                raise AssertionError(f"gam_norm {shape} {dtype}: an image alone differs from "
                                     f"itself in the batch")
            del x, got, want
        ring = 100_000_000 // nbytes + 1
        xs = [torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(ring)]
        t = three(ring_calls(lambda i: gn.gam_norm(xs[i]), ring),
                  ring_calls(lambda i: gn.plain(xs[i]), ring),
                  ring_calls(lambda i: F.instance_norm(xs[i].permute(0, 3, 1, 2)), ring), 10)
        add("gam_norm", t, 2 * nbytes)
        bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        log("7 timing", f"gam_norm {shape} bf16, ring of {ring} ({ring * nbytes / 1e6:.0f} MB): "
                        f"kernel {us(t, 'kernel')}, plain {us(t, 'plain')}, F.instance_norm "
                        f"{us(t, 'library')} per call; bound {bound * 1e3:.2f} us, "
                        f"{bound / t['device']['kernel']:.0%} of it [{card}]")
        del xs
    for what, shapes in GAM_NORM_ONE.items():
        tot = {"kernel": 0.0, "plain": 0.0}
        for h, w, c in shapes:
            nbytes = h * w * c * 2
            ring = 100_000_000 // nbytes + 1
            xs = [torch.randn((1, h, w, c), generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(ring)]
            t = turns({"kernel": ring_calls(lambda i: gn.gam_norm(xs[i]), ring),
                       "plain": ring_calls(lambda i: gn.plain(xs[i]), ring)}, 10)
            for k in tot:
                tot[k] += t["device"][k]
            log("7 timing", f"gam_norm (1, {h}, {w}, {c}) bf16: kernel {us(t, 'kernel')}, "
                            f"plain {us(t, 'plain')} per call [{card}]")
            del xs
        log("7 timing", f"gam_norm at B=1, {what} ({len(shapes)} maps), device-only: kernel "
                        f"{tot['kernel']:.4f} ms, plain {tot['plain']:.4f} ms [{card}]")
    return worst


def timing_pad(dev, card: str, gen, three, us) -> dict:
    """The reflect pad device-only, in bfloat16, cold (each call takes the
    next of a ring of inputs over 100 MB): its forward at the packed
    forward's six shapes (B = PAD_B), forward and backward at G's eleven in
    the fused train step (2 * TRAIN_B images) and in one of the SN step's two
    G forwards (TRAIN_B); beside it the plain version (F.pad of the 5-d
    NHWC view after torch.cat, the path the port took before the kernel)
    and the library call (F.pad of the NCHW concat, aten's 4-d reflect
    pad; backward: aten's reflection_pad3d_backward on the 5-d view, whose
    dx the parts' split would still have to copy).  Bound: the bytes read
    and written at 3.35 TB/s.  Returns the sums of each set: {set: {"fwd" |
    "bwd": {"kernel", "plain", "library", "bound", "bytes"}}}."""
    import torch
    import torch.nn.functional as F

    from uegan_tpu_torch.ops import reflect_pad as rp

    bf16 = torch.bfloat16
    sets = {"enhance": (PAD_B, PAD_ENHANCE, False), "train": (TRAIN_B2, PAD_TRAIN_G, True),
            "sn": (TRAIN_B, PAD_TRAIN_G, True)}
    out = {}
    for name, (b, shapes, backward) in sets.items():
        tot = {d: dict.fromkeys(("kernel", "plain", "library", "bound", "bytes"), 0.0)
               for d in (("fwd", "bwd") if backward else ("fwd",))}
        for what, c1, c2, hw, p in shapes:
            in_bytes = b * hw * hw * (c1 + c2) * 2
            out_bytes = b * (hw + 2 * p) ** 2 * (c1 + c2) * 2

            def timed(d, kern, plain, lib, ring):
                t = three(ring_calls(kern, ring), ring_calls(plain, ring),
                          ring_calls(lib, ring), 20)
                nbytes = in_bytes + out_bytes
                bound = nbytes / HBM_BYTES_PER_S * 1e3
                for k in ("kernel", "plain", "library"):
                    tot[d][k] += t["device"][k]
                tot[d]["bound"] += bound
                tot[d]["bytes"] += nbytes
                log("7 timing", f"reflect_pad {d} {name} {what} B={b} ({c1}+{c2} ch, {hw} px, "
                                f"pad {p}) bf16: kernel {us(t, 'kernel')}, plain {us(t, 'plain')}, "
                                f"library {us(t, 'library')}; bound {bound * 1e3:.2f} us "
                                f"({nbytes / 1e6:.1f} MB), {bound / t['device']['kernel']:.0%} "
                                f"of it [{card}]")

            ring = 100_000_000 // in_bytes + 1
            xs = [pad_parts((b, c1, c2, hw, hw), bf16, gen, dev) for _ in range(ring)]
            cats = [x[0] if len(x) == 1 else torch.cat(x, dim=1) for x in xs]
            timed("fwd", lambda i: rp.reflect_pad(xs[i], p),
                  lambda i: rp.plain(xs[i][0], xs[i][1] if c2 else None, p),
                  lambda i: F.pad(cats[i], (p, p, p, p), mode="reflect"), ring)
            del xs, cats
            if backward:
                ring = 100_000_000 // out_bytes + 1
                dys = [torch.randn((b, hw + 2 * p, hw + 2 * p, c1 + c2), generator=gen,
                                   device=dev).to(bf16).permute(0, 3, 1, 2) for _ in range(ring)]
                x5 = torch.empty((b, 1, hw, hw, c1 + c2), dtype=bf16, device=dev)
                timed("bwd", lambda i: rp.reflect_pad_backward(dys[i], p, c1),
                      lambda i: rp.plain_backward(dys[i], p, c1),
                      lambda i: torch.ops.aten.reflection_pad3d_backward(
                          dys[i].permute(0, 2, 3, 1).unsqueeze(1), x5, [0, 0, p, p, p, p]), ring)
                del dys, x5
        for d, v in tot.items():
            log("7 timing", f"reflect_pad {d} per {'forward' if name == 'enhance' else 'G pass'} "
                            f"({name}, B={b}): kernel {v['kernel']:.4f} ms, plain "
                            f"{v['plain']:.4f}, library {v['library']:.4f}, bound "
                            f"{v['bound']:.4f} ms ({v['bytes'] / 1e9:.3f} GB: "
                            f"{v['bytes'] / v['kernel'] / 1e9:.3f} TB/s), "
                            f"{v['bound'] / v['kernel']:.0%} of the bound [{card}]")
        out[name] = tot
    return out


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


def check_no_aten_pad(phase: str, what: str, r: dict) -> None:
    """Fail where a profile() holds a reflect-pad kernel other than the
    port's own (aten's reflection_pad kernels on the main path)."""
    names = {name for _, name in r["longest"] if "reflection_pad" in name}
    aten = sorted(name for name in names if "reflection_pad_nhwc" not in name)
    log(phase, f"{what}: reflect-pad kernels under the profiler {sorted(names)}")
    if aten:
        raise AssertionError(f"{what} launched aten's reflect pad: {aten}")


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
            log_profile("8 profile", f"{name} forward {IMG}px B=8 bf16", r, card)
            check_no_aten_pad("8 profile", f"the {name} forward", r)


def log_profile(phase: str, what: str, r: dict, card: str) -> None:
    """Print a profile() result: wall, busy and idle, the buckets as a
    table, and the 8 longest distinct kernels."""
    log(phase, f"{what} under torch.profiler: wall {r['wall_ms']:.3f} ms per forward, device "
               f"busy {r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f} [{card}]")
    log(phase, "| bucket | ms per forward | kernels per forward | share of busy |")
    for k, (ms, n) in sorted(r["buckets"].items(), key=lambda kv: -kv[1][0]):
        log(phase, f"| {k} | {ms:.3f} | {n:g} | {ms / r['busy_ms']:.1%} |")
    seen = set()
    for us, kname in r["longest"]:
        if kname not in seen and len(seen) < 8:
            seen.add(kname)
            log(phase, f"longest: {us:9.1f} us [{bucket_of(kname)}] {kname[:120]}")


def nima_images(n: int, hw: int, rng):
    """n (hw, hw, 3) uint8 images of smooth gradients with noise, as
    write_pairs makes them."""
    import numpy as np

    yy, xx = np.mgrid[0:hw, 0:hw] / hw
    out = np.empty((n, hw, hw, 3), np.uint8)
    for i in range(n):
        base = np.stack([yy * rng.uniform(0.3, 1), xx * rng.uniform(0.3, 1),
                         (yy + xx) / 2 * rng.uniform(0.3, 1)], -1)
        out[i] = np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255)
    return out


def write_ava(root: str, n: int, rng) -> tuple:
    """A synthetic AVA layout: n JPEGs of 320x256 (landscape and portrait)
    under root/images and an AVA.txt of random score counts; returns the
    train/val/test CSVs of clean_and_split (val 0.1, test 0.05)."""
    from PIL import Image

    from uegan_tpu_torch.nima_train.dataset import clean_and_split

    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    imgs = nima_images(n, 320, rng)
    lines = []
    for i in range(n):
        img = imgs[i, :256] if i % 2 else imgs[i, :, :256]
        Image.fromarray(img).save(os.path.join(img_dir, f"{1000 + i}.jpg"), quality=90)
        counts = " ".join(str(int(c)) for c in rng.integers(0, 50, 10))
        lines.append(f"{i} {1000 + i} {counts} 1 22 1396")
    with open(os.path.join(root, "AVA.txt"), "w") as f:
        f.write("\n".join(lines))
    return clean_and_split(os.path.join(root, "AVA.txt"), img_dir, os.path.join(root, "splits"))


def log_nima_profile(what: str, r: dict, card: str) -> None:
    kernels = sum(n for _, n in r["buckets"].values())
    top = sorted(r["buckets"].items(), key=lambda kv: -kv[1][0])[:6]
    log("9 nima", f"{what} under torch.profiler: wall {r['wall_ms']:.3f} ms, device busy "
                  f"{r['busy_ms']:.3f} ms, idle share {r['idle_share']:.3f}, {kernels:g} kernels "
                  f"a call; ms (kernels): " + ", ".join(f"{k} {ms:.3f} ({n:g})"
                                                        for k, (ms, n) in top) + f" [{card}]")


def nima_pair_check(dev, card: str) -> None:
    """The norm_act pair at NIMA's 53 BN maps (B=128, 224 px, bf16; the
    first eight in float32 too), each with its BN's activation and flax's
    biased running variance, against its plain form in float64
    (``norm_check``)."""
    import torch

    from portbench.counts import nima as counts
    from portbench.reference import nima_train as ref

    args = {"relu6": {"slope": 0.0, "cap": 6.0}, "relu": {"slope": 0.0, "strict": True},
            "none": {"slope": 1.0}}  # models/nima.py:_act_args
    acts = [args[c.act] for block in ref.blocks() for c in block.convs]
    maps = counts.bn_maps(224, 128)
    if len(acts) != 53 or len(maps) != 53:
        raise AssertionError(f"NIMA: {len(acts)} activations for {len(maps)} BN maps")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    worst, kinks = {}, 0
    for i, (shape, act) in enumerate(zip(maps, acts)):
        for dtype in (torch.bfloat16,) + ((torch.float32,) if i < 8 else ()):
            r = norm_check(False, shape, dtype, gen, dev, False, act["slope"],
                           act.get("cap", math.inf), act.get("strict", False), False)
            key = "bf16" if dtype == torch.bfloat16 else "f32"
            kinks += r.pop("kinks")
            for k, v in r.items():
                worst[f"{key} {k}"] = max(worst.get(f"{key} {k}", 0.0), v)
            torch.cuda.empty_cache()
    kinds = sorted({(a["slope"], a.get("cap", math.inf), a.get("strict", False)) for a in acts})
    log("9 nima", f"norm_act at NIMA's 53 BN maps, B=128 224 px (bf16, the first 8 in f32 "
                  f"too), activations (slope, cap, strict) {kinds}, biased running variance: "
                  f"within tolerance of float64; {kinks} dx elements at a kink left out; worst "
                  "|d| " + ", ".join(f"{k} {v:.3e}" for k, v in sorted(worst.items()))
        + f" [{card}]")


def nima_graph_check(dev, card: str, dtype: str) -> None:
    """NIMA's train step (B=16, 224 px, seeded) with make_nima_optimizer's
    capturable Adam: 53 forward and 53 backward norm calls on the eager
    first step and on the captured second one, none on the replays after
    it; one capture and three replays over 4 steps; the losses and the
    parameters after them against ``step.eager``'s on a second model from
    the same seed and the same dropout generator's seed: bit-equal, or,
    where two eager runs already differ in bits, within twice their gap."""
    import torch

    from uegan_tpu_torch.metrics.nima import init_nima
    from uegan_tpu_torch.nima_train.train import make_nima_optimizer, make_nima_train_step
    from uegan_tpu_torch.ops import norm_act as na

    gen = torch.Generator(device=dev).manual_seed(SEED + 90)
    xs = [torch.rand((16, 224, 224, 3), generator=gen, device=dev) for _ in range(4)]
    ts = [torch.softmax(torch.randn((16, 10), generator=gen, device=dev), -1) for _ in range(4)]

    def run(graph: bool):
        model = init_nima(rng_seed=SEED, compute_dtype=dtype, device=dev)
        step = make_nima_train_step(model, make_nima_optimizer(model, 3e-4),
                                    torch.Generator(device=dev).manual_seed(SEED + 91))
        fn = step if graph else step.eager
        losses, calls = [], []
        for x, t in zip(xs, ts):
            before = (na.norm_act.launches, na.norm_act_backward.launches)
            losses.append(fn(x, t).clone())
            calls.append((na.norm_act.launches - before[0],
                          na.norm_act_backward.launches - before[1]))
        torch.cuda.synchronize()
        params = [p.detach().clone() for p in model.parameters()]
        return torch.stack(losses), params, calls, (step.captures, step.replays)

    g_loss, g_params, g_calls, counters = run(True)
    e_loss, e_params, e_calls, _ = run(False)
    e2_loss, e2_params, _, _ = run(False)
    if g_calls != [(53, 53), (53, 53), (0, 0), (0, 0)] or e_calls != [(53, 53)] * 4 \
            or counters != (1, 3):
        raise AssertionError(f"NIMA train step {dtype}: norm calls a step {g_calls} (graph), "
                             f"{e_calls} (eager); (captures, replays) {counters}")

    def gap(a, b, pa, pb):
        return max([float(((a - b).abs() / b.abs()).max())]
                   + [float((p - q).abs().max() / q.abs().max().clamp_min(1e-30))
                      for p, q in zip(pa, pb)])

    same = bits_equal(g_loss, e_loss) and all(bits_equal(p, q) for p, q in zip(g_params, e_params))
    eager_gap = gap(e2_loss, e_loss, e2_params, e_params)
    graph_gap = gap(g_loss, e_loss, g_params, e_params)
    log("9 nima", f"train step 224 px B=16 {dtype}: norm calls (forward, backward) a step "
                  f"{g_calls} (eager, capture, replay, replay), (captures, replays) {counters}; "
                  f"graph against eager over 4 steps: bit-equal {same}, largest relative gap "
                  f"{graph_gap:.3e} (two eager runs {eager_gap:.3e}) [{card}]")
    if not same and graph_gap > 2 * eager_gap:
        raise AssertionError(f"NIMA train step {dtype}: the graph's steps differ from the "
                             f"eager ones by {graph_gap:.3e}, two eager runs by {eager_gap:.3e}")


def phase_nima(dev, card: str, tmp: str) -> None:
    """NIMA (MobileNetV2, 224 px; the scorer behind the default ``--mode
    test`` and ``--mode train``, seeded weights) on the card:

    - the f32 forward (TF32 off) at B=16 against the same module run on the
      CPU in float64: probabilities <= 2e-5; the process's TF32 flags as
      they were;
    - bf16 against f32 on the card: each image's mean score <= 0.3 (JAX's
      own bf16 bound, tests/test_metrics.py);
    - images/s of the forward at B=16 (calc_nima's chunk) and B=128, bf16
      and f32, CUDA events;
    - calc_nima over 64 PNGs of 512 px: wall time, and apart the host's PIL
      decode, resize and crop and the device's scoring;
    - train_nima for one epoch on a synthetic AVA layout of 112 JPEGs (3
      steps of B=32 at 224 px, then validation), bf16 and f32: finite EMD,
      nima_best.pth written; and ms per step at B=32, bf16 and f32 (host
      clock around 5 steps ending in a synchronize, after 2 of warm-up);
    - the bf16 forward (B=16, 128) and both train steps under torch.profiler:
      wall and device-busy ms, idle share, kernels a call, the largest
      buckets.
    """
    import numpy as np
    import torch

    from uegan_tpu_torch.metrics.nima import calc_nima, init_nima, load_images, nima_scores
    from uegan_tpu_torch.models.nima import NIMA, score_stats
    from uegan_tpu_torch.nima_train.train import (make_nima_optimizer, make_nima_train_step,
                                                  train_nima)
    from uegan_tpu_torch.utils.image_io import save_image

    rng = np.random.default_rng(SEED)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    x = torch.from_numpy(nima_images(16, 224, rng).astype(np.float32) / 255.0)
    m32 = init_nima(compute_dtype="float32", device=dev)
    m16 = init_nima(compute_dtype="bfloat16", device=dev)
    with torch.inference_mode():
        p32 = m32(x.to(dev)).double().cpu()
        p16 = m16(x.to(dev)).double().cpu()
        m64 = NIMA(dtype=torch.float64).load_reference(m32.state_dict()).double().eval()
        p64 = m64(x.double())
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("the f32 NIMA forward left the TF32 flags changed")
    err = float((p32 - p64).abs().max())
    mean32, mean64, mean16 = score_stats(p32)[0], score_stats(p64)[0], score_stats(p16)[0]
    d16 = (mean16 - mean32).abs()
    log("9 nima", f"f32 forward on the card (TF32 off) vs float64 on the CPU, 224 px B=16: max "
                  f"|d prob| {err:.3e} (limit 2e-5), max |d mean score| "
                  f"{float((mean32 - mean64).abs().max()):.3e}; bf16 vs f32 on the card: "
                  f"|d mean score| max {float(d16.max()):.4f} (limit 0.3), mean "
                  f"{float(d16.mean()):.4f}, set average {float(mean16.mean()):.4f} vs "
                  f"{float(mean32.mean()):.4f}")
    if err > 2e-5 or float(d16.max()) > 0.3:
        raise AssertionError("NIMA on the card disagrees with its float64 or float32 forward")

    with torch.inference_mode():
        for b in (16, 128):
            xb = torch.rand((b, 224, 224, 3), device=dev)
            for name, m in (("bf16", m16), ("f32", m32)):
                ms = cuda_ms(lambda: m(xb), iters=20 if b == 16 else 5)
                log("9 nima", f"NIMA forward 224 px B={b} {name}: {ms:.3f} ms, "
                              f"{b * 1000 / ms:.1f} img/s [{card}]")
            log_nima_profile(f"NIMA forward 224 px B={b} bf16", profile(lambda: m16(xb)), card)

    folder = os.path.join(tmp, "nima_pngs")
    os.makedirs(folder)
    for i, img in enumerate(nima_images(64, IMG, rng)):
        save_image(img, os.path.join(folder, f"p{i:03d}.png"))
    names = sorted(os.listdir(folder))
    calc_nima(folder, os.path.join(tmp, "nima_warm"), 0, model=m16, verbose=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    avg = calc_nima(folder, os.path.join(tmp, "nima_out"), 1, model=m16, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    chunks = [load_images(folder, names[i:i + 16]) for i in range(0, len(names), 16)]
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in chunks:
        nima_scores(m16, c)
    torch.cuda.synchronize()
    device = time.perf_counter() - t0
    rows = nima_csv(os.path.join(tmp, "nima_out", "NIMA_epoch_1__mean_std.csv"))
    if len(rows) != 65 or not math.isfinite(avg):
        raise AssertionError(f"calc_nima over 64 PNGs: {len(rows)} rows, average {avg}")
    log("9 nima", f"calc_nima bf16 over 64 PNGs of {IMG} px, chunks of 16: wall {wall:.3f} s "
                  f"({64 / wall:.1f} img/s); host decode + resize + crop alone {host:.3f} s, "
                  f"device scoring alone (copy in, forward, stats out) {device:.3f} s; average "
                  f"{avg:.4f} [{card}]")

    nima_pair_check(dev, card)
    for dtype in ("bfloat16", "float32"):
        nima_graph_check(dev, card, dtype)

    train_csv, val_csv, _ = write_ava(os.path.join(tmp, "ava"), 112, rng)
    for dtype in ("bfloat16", "float32"):
        t0 = time.time()
        out = os.path.join(tmp, f"nima_train_{dtype}")
        hist = train_nima(train_csv, val_csv, out, epochs=1, batch_size=32, compute_dtype=dtype,
                          device=dev, verbose=False)
        if not (math.isfinite(hist["best_val"]) and os.path.exists(
                os.path.join(out, "nima_best.pth"))):
            raise AssertionError(f"train_nima {dtype}: {hist}")
        model = init_nima(compute_dtype=dtype, device=dev)
        step = make_nima_train_step(model, make_nima_optimizer(model, 3e-4),
                                    torch.Generator(device=dev).manual_seed(SEED))
        xb = torch.rand((32, 224, 224, 3), device=dev)
        tb = torch.softmax(torch.randn((32, 10), device=dev), -1)
        losses = [float(step(xb, tb)) for _ in range(2)]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            loss = step(xb, tb)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / 5 * 1e3
        log_nima_profile(f"NIMA train step 224 px B=32 {dtype}",
                         profile(lambda: step(xb, tb), iters=5, warmup=2), card)
        if not all(math.isfinite(v) for v in losses + [float(loss)]):
            raise AssertionError(f"nima train step {dtype}: losses {losses}, {float(loss)}")
        log("9 nima", f"train_nima {dtype}, 1 epoch of 3 steps B=32 at 224 px on a synthetic AVA "
                      f"layout: val EMD {hist['best_val']:.4f}, {time.time() - t0:.1f} s with "
                      f"decode; train step 224 px B=32 {dtype}: {ms:.3f} ms per step, "
                      f"{32 * 1000 / ms:.1f} img/s, EMD {float(loss):.4f} [{card}]")
    if (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) != flags:
        raise AssertionError("the f32 NIMA train step left the TF32 flags changed")


def peak_gib(fn):
    """(fn's result, the device memory fn took at its peak beyond what was
    allocated before it, in GiB)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def strip_counts(s: int, cs: int) -> dict:
    """One strip forward's launches: C at the entry, B at up1 and up2, the
    GAM norm at ga3 .. ga5, D once a chunk of the exit."""
    return {**dict.fromkeys(KERNELS, 0), "s2d_convert": 1, "upsample2x": 2,
            "residual_tail_d2s": s // cs, "gam_norm": 3}


def write_pth(root: str, sd: dict) -> None:
    import torch

    models = os.path.join(root, "UEGAN-FiveK", "models")
    os.makedirs(models)
    torch.save({"G_net": sd, "D_net": {}, "epoch": 92.0, "g_optimizer": {},
                "d_optimizer": {}, "lr_scheduler_g": {}, "lr_scheduler_d": {}},
               os.path.join(models, "UEGAN-FiveK_rahinge_92.pth"))


def highres_cli(tmp: str, what: str, test_dir: str, sd: dict, extra: list) -> tuple:
    """``--mode test`` at native size through uegan_tpu_torch.cli.run (bf16,
    batch 2, NIMA and PSNR/SSIM on); (its result, launches, seconds, the
    result PNGs by name)."""
    import torch

    from uegan_tpu_torch import cli
    from uegan_tpu_torch.utils.image_io import read_png_rgb

    root = os.path.join(tmp, f"results_{what}")
    write_pth(root, sd)
    argv = ["--mode", "test", "--test_img_dir", test_dir,
            "--test_label_dir", os.path.join(test_dir, "label") + os.sep,
            "--save_root_dir", root, "--g_conv_dim", str(CD), "--val_batch_size", "2",
            "--pretrained_model", "92", "--is_test_psnr_ssim", "true",
            "--compute_dtype", "bfloat16", "--num_workers", "4",
            "--test_keep_aspect", "true"] + extra
    t0 = time.time()
    reset_counts()
    res = cli.run(argv)
    torch.cuda.synchronize()
    launched, secs = counts(), time.time() - t0
    note_pads({"native": "strips"}.get(what, what))
    out_dir = os.path.join(root, "UEGAN-FiveK", "test", "test_results")
    pngs = {f.split("_92.00_")[0]: read_png_rgb(os.path.join(out_dir, f))
            for f in sorted(os.listdir(out_dir))}
    if not all(math.isfinite(res[k]) for k in ("psnr", "ssim", "nima")):
        raise AssertionError(f"--mode test ({what}): metrics not finite: {res}")
    return res, launched, secs, pngs


def phase_highres(dev, card: str, tmp: str) -> dict:
    """Phase 10: the strip executor, native resolution and overlap tiles at
    the default generator's full width (seeded as seeded_generator); the
    launches of the main paths it drives (strips, strips_int8, tiles)."""
    import numpy as np
    import torch

    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.infer import native, packed, quantized, strips, tiles
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8, read_png_rgb

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    rand = lambda shape: torch.rand(shape, generator=gen, device=dev) * 2 - 1
    big = HR[0]
    launches = {}

    def maxd(a, b) -> float:
        return float((a.float() - b.float()).abs().max())

    # -- strips against the direct packed forward: 2048 px, B=2, f32, TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g32, sd = seeded_generator(torch.float32, dev)
    r = strips.pick_strip_rows(big // 2, 2)
    sb = big // 2 // STRIP_R  # strips at 2048 px
    if r != STRIP_R:
        raise AssertionError(f"pick_strip_rows({big // 2}, 2) = {r}, want {STRIP_R}")
    auto = packed.make_fast_eval(g32, Config(compute_dtype="float32"))
    direct = packed.make_fast_eval(g32, Config(compute_dtype="float32", strip_rows=-1))
    x = rand((2, big, big, 3))
    with torch.inference_mode():
        want = direct(x)
        reset_counts()
        got = auto(x)
        torch.cuda.synchronize()
        run = counts()
        with plain_versions():
            plain = auto(x)
        torch.cuda.synchronize()
    check_counts(f"one strip forward ({big} px, B=2, f32)", run, strip_counts(sb, sb))
    if got.shape != x.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"strips output {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    d, dk = maxd(got, want), maxd(got, plain)
    log("10 high-res", f"strips cd32 {big}px B=2 f32 (TF32 off), r = {r}, {sb} strips: vs the direct "
                       f"packed forward max abs {d:.3e} (limit 1e-4); kernels vs plain max abs "
                       f"{dk:.3e} (limit 1e-4); launches a forward {run}")
    if d > 1e-4 or dk > 1e-4:
        raise AssertionError(f"strips vs direct {d}, kernels vs plain {dk}")
    del x, want, got, plain, auto, direct

    # -- chunked against unchunked, entry-chunked against resident chunked:
    # 2048 px, B=1, f32
    x = rand((1, big, big, 3))
    un = strips.make_strip_fast_eval(g32, r, -1)(x)
    reset_counts()
    ch = strips.make_strip_fast_eval(g32, r, 2)(x)
    torch.cuda.synchronize()
    run = counts()
    ec = strips.make_strip_fast_eval(g32, r, 2, entry_chunked=True)(x)
    check_counts(f"one chunked strip forward ({sb // 2} chunks)", run, strip_counts(sb, 2))
    d_ch, d_ec = maxd(ch, un), maxd(ec, ch)
    log("10 high-res", f"strips {big}px B=1 f32: chunked (2 strips a chunk) vs unchunked max abs "
                       f"{d_ch:.3e}, entry-chunked vs resident chunked max abs {d_ec:.3e} "
                       f"(bit-equal {bool(torch.equal(ec, ch))}; limits 1e-5); launches {run}")
    if d_ch > 1e-5 or d_ec > 1e-5:
        raise AssertionError(f"chunked {d_ch}, entry-chunked {d_ec}")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    del g32, x, un, ch, ec

    # -- memory modes at full size, bf16: 4096 px (unchunked) and 8192 px
    # (chunked, 8 strips a chunk, the entry resident) against entry_chunked
    gb, _ = seeded_generator(torch.bfloat16, dev)
    fast = packed.make_fast_eval(gb, Config())
    timing = {}
    for size in HR[1:]:
        s, cs = size // 2 // STRIP_R, HR_CHUNKS[size]
        if strips.pick_strip_rows(size // 2, 1) != STRIP_R or strips.pick_strip_chunks(
                1, s, STRIP_R + 2 * strips._M_EXIT, size // 2) != cs:
            raise AssertionError(f"{size} px routes differently than r = {STRIP_R}, {cs} "
                                 f"strips a chunk")
        x = rand((1, size, size, 3))
        reset_counts()
        y, peak = peak_gib(lambda: fast(x))
        run = counts()
        check_counts(f"one strip forward ({size} px, B=1)", run, strip_counts(s, cs))
        if y.shape != x.shape or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{size} px output {tuple(y.shape)} not finite")
        ms = [cuda_ms(lambda: fast(x), iters=2, warmup=1) for _ in range(2)]
        timing[size] = (sum(ms) / 2, peak)
        msg = (f"strips {size}px B=1 bf16 (auto: r = {STRIP_R}, {s} strips, {cs} a chunk): "
               f"{timing[size][0]:.2f} ms ({1000 / timing[size][0]:.3f} img/s; runs "
               f"{[round(v, 2) for v in ms]}), peak {peak:.2f} GiB above its input; "
               f"launches {run} [{card}]")
        if size == HR[2]:
            yec, peak_ec = peak_gib(lambda: strips.make_strip_fast_eval(
                gb, STRIP_R, 0, entry_chunked=True)(x))
            # one ulp of the larger of the two, counted from 2^-6 up (a
            # difference at an output near 0 is a few ulp of a larger sum)
            ulp = bf16_ulp(torch.maximum(y.abs(), yec.abs())).clamp(min=2.0 ** -13)
            ulps = ((yec.float() - y.float()).abs() / ulp).max()
            msg += (f"; entry-chunked peak {peak_ec:.2f} GiB, vs the auto route max "
                    f"{float(ulps):.2f} bf16 ulp of the output (limit 1), max abs {maxd(yec, y):.3e}")
            if float(ulps) > 1.0:
                raise AssertionError(f"entry-chunked differs from the resident route by "
                                     f"{float(ulps)} ulp")
            del yec
        log("10 high-res", msg)
        del x, y

    # -- int8 strips: 2048 px B=2 bf16, against the bf16 strips; int8_pallas
    # takes the same route (kernel E on no strip)
    x = rand((2, big, big, 3))
    with torch.inference_mode():
        bf = fast(x)
        i8 = packed.make_fast_eval(gb, Config(quantized_inference="int8"), calib_batch=x)
        i8p = packed.make_fast_eval(gb, Config(quantized_inference="int8_pallas"), calib_batch=x)
        yi = i8(x)
        reset_counts()
        yp = i8p(x)
        torch.cuda.synchronize()
        launches["strips_int8"] = counts()
        note_pads("strips_int8")
        with plain_versions():
            yplain = i8p(x)
    check_counts("one int8_pallas strip forward", launches["strips_int8"], strip_counts(sb, sb))
    p, pk_ = psnr_pm1(yi, bf), psnr_pm1(yp, yplain)
    log("10 high-res", f"int8 strips {big}px B=2 bf16: vs the bf16 strips {p:.2f} dB (limit >= 30), "
                       f"max abs {maxd(yi, bf):.4f}; int8_pallas vs int8 max abs {maxd(yp, yi):.3e} "
                       f"(limit 0.02); "
                       f"kernels vs plain {pk_:.2f} dB (limit >= 40), max abs {maxd(yp, yplain):.3e} "
                       f"(limit 0.05); launches {launches['strips_int8']}")
    if p < 30.0 or maxd(yp, yi) > 0.02 or pk_ < 40.0 or maxd(yp, yplain) > 0.05:
        raise AssertionError(f"int8 strips: {p:.2f} dB, int8_pallas vs int8 {maxd(yp, yi)}, "
                             f"kernels vs plain {pk_:.2f} dB")
    del x, bf, yi, yp, yplain, i8, i8p

    # -- timing: strips against the direct packed forward, 2048 px B=4, bf16
    x = rand((4, big, big, 3))
    direct = packed.make_fast_eval(gb, Config(strip_rows=-1))
    steps = {"strips": fast, "direct": direct}
    peaks = {k: peak_gib(lambda: steps[k](x))[1] for k in steps}
    t = {k: [] for k in steps}
    for k in ("strips", "direct", "direct", "strips"):
        t[k].append(cuda_ms(lambda: steps[k](x), iters=3, warmup=1))
    for k in steps:
        ms = sum(t[k]) / 2
        log("10 high-res", f"{k} packed forward {big}px B=4 bf16: {ms:.2f} ms/forward, "
                           f"{4000 / ms:.2f} img/s (runs {[round(v, 2) for v in t[k]]}), peak "
                           f"{peaks[k]:.2f} GiB above its input [{card}]")
    faster = min(t, key=lambda k: sum(t[k]))
    log("10 high-res", f"at {big}px B=4 the {faster} forward is the faster on this card")
    for k in steps:  # where each one's device time goes
        log_profile("10 high-res", f"{k} packed forward {big}px B=4 bf16",
                    profile(lambda: steps[k](x), iters=3, warmup=1), card)
    del x, direct, steps

    # -- --mode test --test_keep_aspect true on photos of native sizes
    rng = np.random.default_rng(SEED)
    test_dir = os.path.join(tmp, "native", "test")
    names = {}
    for i, (h, w) in enumerate(NATIVE_SIZES):
        for n in write_pairs(test_dir, ("label", "raw"), 2, (h, w), rng, stem=f"n{i}_"):
            names[n] = (h, w)
    _, sd_cpu = seeded_generator(torch.float32, "cpu")
    res, run, secs, pngs = highres_cli(tmp, "native", test_dir, sd_cpu, [])
    launches["strips"] = run
    # 2 batches direct (1024 x 704 and 512 x 512 padded, hp < 1024), one strips
    check_counts("--mode test --test_keep_aspect (3 batches)", run, {
        **dict.fromkeys(KERNELS, 0), "s2d_convert": 3, "upsample2x": 8, "residual_tail_d2s": 3,
        "gam_norm": 13})
    g32, _ = seeded_generator(torch.float32, dev)
    torch.backends.cudnn.allow_tf32 = False
    worst = math.inf
    for i, (h, w) in enumerate(NATIVE_SIZES):
        group = [n for n in sorted(names) if n.startswith(f"n{i}_")]
        raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in group])
        padded, hw = native.pad_to_grid(raw)
        with torch.inference_mode(), plain_versions():
            ref = quantize_u8(g32(normalize_u8(torch.from_numpy(padded).to(dev)))).cpu().numpy()
        ref = native.crop_back(ref, hw)
        for j, n in enumerate(group):
            if pngs[n].shape != (h, w, 3):
                raise AssertionError(f"{n}: PNG {pngs[n].shape}, native {(h, w, 3)}")
            mse = float(((pngs[n].astype(np.float64) - ref[j]) ** 2).mean())
            worst = min(worst, 10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
    torch.backends.cudnn.allow_tf32 = True
    log("10 high-res", f"--mode test --test_keep_aspect true bf16, {len(names)} photos "
                       f"({', '.join(f'{h}x{w}' for h, w in NATIVE_SIZES)}, 2 each; padded "
                       f"to the 64-px grid): PNGs at native size, each >= {worst:.2f} dB from "
                       f"the f32 plain canonical forward of the same padded input (limit 35); "
                       f"PSNR {res['psnr']:.4f} SSIM {res['ssim']:.4f} NIMA {res['nima']:.4f}; "
                       f"launches {run}; {secs:.1f} s, {secs / len(names):.3f} s per image "
                       f"(loader, forwards, PNGs, NIMA, PSNR/SSIM) [{card}]")
    if worst < 35.0:
        raise AssertionError(f"native-resolution PNGs only {worst:.2f} dB from the f32 forward")

    # -- the enhance step per size, s per image (pad, forward, crop; 1-byte
    # pixels each way), the Tester's own enhance_u8
    from uegan_tpu_torch.train.tester import Tester

    cfg = Config(mode="test", g_conv_dim=CD, compute_dtype="bfloat16", val_batch_size=2,
                 test_keep_aspect=True, save_root_dir=os.path.join(tmp, "results_native"))
    tester = Tester({}, cfg, dev)
    tester.G.load_state_dict(sd_cpu)
    for i, (h, w) in enumerate(NATIVE_SIZES):
        group = [n for n in sorted(names) if n.startswith(f"n{i}_")]
        raw = np.stack([read_png_rgb(os.path.join(test_dir, "raw", n + ".png")) for n in group])
        native.enhance_native(tester.enhance_u8, raw)  # warm-up
        per = []
        for _ in range(2):
            t0 = time.time()
            native.enhance_native(tester.enhance_u8, raw)
            per.append((time.time() - t0) / len(group))
        log("10 high-res", f"enhance_native(Tester.enhance_u8) {h}x{w} B=2 bf16: "
                           f"{sum(per) / 2:.4f} s per image (runs {[round(v, 4) for v in per]}) "
                           f"[{card}]")

    # -- --tile_size 512 --tile_overlap 32 on 2 photos of 1024 x 1536
    tile_dir = os.path.join(tmp, "tiles", "test")
    tnames = write_pairs(tile_dir, ("label", "raw"), 2, TILE_HW, rng, stem="t")
    res, run, secs, pngs = highres_cli(tmp, "tiles", tile_dir, sd_cpu,
                                       ["--tile_size", str(TILE), "--tile_overlap",
                                        str(TILE_OVERLAP)])
    launches["tiles"] = run
    # each image's tiles go through the canonical forward 8 at a time (the
    # last batch padded), each forward A 5, B 4
    ys, xs = tiles._grid(*TILE_HW, TILE, TILE_OVERLAP)
    fwd = 2 * -(-len(ys) * len(xs) // tiles.TILE_BATCH)
    check_counts(f"--mode test --tile_size {TILE} (2 images, {len(ys) * len(xs)} tiles each)",
                 run, {**dict.fromkeys(KERNELS, 0), "gam_stats": 5 * fwd, "upsample2x": 4 * fwd})
    torch.backends.cudnn.allow_tf32 = False
    worst = math.inf
    for n in tnames:
        raw = read_png_rgb(os.path.join(tile_dir, "raw", n + ".png"))

        def step(b):
            with torch.inference_mode(), plain_versions():
                return g32(torch.from_numpy(np.ascontiguousarray(b)).to(dev)).float().cpu().numpy()
        img = (raw.astype(np.float32) / 255.0 - 0.5) / 0.5
        ref = tiles.enhance_tiled(step, img, TILE, TILE_OVERLAP)
        ref = np.clip(np.rint(np.clip((ref + 1.0) / 2.0, 0.0, 1.0) * 255.0), 0, 255)
        if pngs[n].shape != TILE_HW + (3,):
            raise AssertionError(f"{n}: tiled PNG {pngs[n].shape}")
        mse = float(((pngs[n].astype(np.float64) - ref) ** 2).mean())
        worst = min(worst, 10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
    torch.backends.cudnn.allow_tf32 = True
    log("10 high-res", f"--mode test --tile_size {TILE} --tile_overlap {TILE_OVERLAP} bf16, 2 "
                       f"photos {TILE_HW[0]}x{TILE_HW[1]} ({len(ys) * len(xs)} tiles each): "
                       f"PNGs >= {worst:.2f} dB from "
                       f"the host tiling over the f32 plain canonical forward (limit 35); "
                       f"launches {run}; {secs:.1f} s [{card}]")
    if worst < 35.0:
        raise AssertionError(f"tiled PNGs only {worst:.2f} dB from the f32 tiling")
    return launches


def photo(h: int, w: int, rng):
    """One (h, w, 3) uint8 photo of smooth gradients with noise, as
    write_pairs makes them."""
    import numpy as np

    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = np.stack([yy * rng.uniform(0.3, 1), xx * rng.uniform(0.3, 1),
                     (yy + xx) / 2 * rng.uniform(0.3, 1)], -1)
    return np.clip(base * 255 + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def png_bytes(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def png_array(data: bytes):
    import numpy as np
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def start_server(**kw):
    """uegan_tpu_torch.serve.app's server on 127.0.0.1 (a free port),
    serving from a thread of this process."""
    from uegan_tpu_torch.serve.app import create_server

    srv = create_server(host="127.0.0.1", port=0, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def stop_server(srv) -> None:
    srv.shutdown()
    srv.server_close()


def post(srv, route: str, body: bytes) -> bytes:
    """POST ``body``; the response body, or a failure naming the status."""
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=600)
    try:
        conn.request("POST", route, body=body)
        r = conn.getresponse()
        data = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise AssertionError(f"{route}: HTTP {r.status}: {data[:300]!r}")
    return data


def concurrently(fn, items: list) -> list:
    """fn(item) on one thread per item, all released at once; the results in
    order (the first failure raised)."""
    gate = threading.Barrier(len(items))

    def call(item):
        gate.wait()
        return fn(item)
    with ThreadPoolExecutor(max_workers=len(items)) as pool:
        futures = [pool.submit(call, item) for item in items]
        return [f.result() for f in futures]


def psnr_u8(a, b) -> float:
    import numpy as np

    mse = float(((a.astype(np.float64) - b.astype(np.float64)) ** 2).mean())
    return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))


def phase_serve(dev, card: str, tmp: str) -> dict:
    """Phase 11: the HTTP service (uegan_tpu_torch.serve.app) on the card,
    in process, with a reference .pth of the phase-4 generator; the
    launches of the paths it drives (serve, serve_int8, serve_native)."""
    import numpy as np
    import torch
    from PIL import Image

    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.infer import native
    from uegan_tpu_torch.infer.packed import make_fast_eval
    from uegan_tpu_torch.metrics.nima import init_nima, prepare_image_np
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    rng = np.random.default_rng(SEED + 11)
    zero = dict.fromkeys(KERNELS, 0)
    fwd = {**zero, "s2d_convert": 1, "residual_tail_d2s": 1, "upsample2x": 3, "gam_norm": 5}
    _, sd = seeded_generator(torch.float32, "cpu")
    pth = os.path.join(tmp, "UEGAN-FiveK_rahinge_92.pth")
    torch.save({"G_net": sd, "D_net": {}, "epoch": 92.0, "g_optimizer": {}, "d_optimizer": {},
                "lr_scheduler_g": {}, "lr_scheduler_d": {}}, pth)
    photos = [photo(*SERVE_PHOTO, rng) for _ in range(SERVE_CONCURRENT)]
    bodies = [png_bytes(p) for p in photos]
    enhance = lambda srv: (lambda body: png_array(post(srv, "/api/enhance", body)))
    launches = {}
    g32, _ = seeded_generator(torch.float32, dev)

    def plain_f32(u8):
        """The f32 canonical forward with the plain versions (TF32 off: the
        server turned it off for the process) of a uint8 NHWC batch."""
        with torch.inference_mode(), plain_versions():
            return quantize_u8(g32(normalize_u8(torch.from_numpy(np.array(u8)).to(dev)))).cpu().numpy()

    # -- bf16, the default: one request, then 32 at once
    srv = start_server(generator_ckpt=pth, test_img_size=IMG, max_batch=16, device=dev)
    models = srv.models
    device_calls = []  # (rows, seconds) of each batched device call
    run_u8 = models._run_u8

    def timed(arrs):
        t0 = time.perf_counter()
        out = run_u8(arrs)
        device_calls.append((arrs.shape[0], time.perf_counter() - t0))
        return out
    models._run_u8 = timed
    try:
        reset_counts()
        t0 = time.perf_counter()
        first = enhance(srv)(bodies[0])
        first_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        one = counts()
        check_counts("one /api/enhance (bf16, B=1)", one, fwd)
        x = np.asarray(Image.fromarray(photos[0]).resize((IMG, IMG), Image.BILINEAR))[None]
        g16, _ = seeded_generator(torch.bfloat16, dev)
        with torch.inference_mode():
            want = quantize_u8(make_fast_eval(g16, Config())(
                normalize_u8(torch.from_numpy(x.copy()).to(dev)))).cpu().numpy()[0]
        p1 = psnr_u8(first, plain_f32(x)[0])
        same = bool(np.array_equal(first, want))
        log("11 serve", f"one /api/enhance {SERVE_PHOTO[0]}x{SERVE_PHOTO[1]} PNG -> {IMG}px bf16: "
                        f"bit-equal to make_fast_eval at B=1 on the same resized input: {same} "
                        f"(max |du8| {int(np.abs(first.astype(int) - want).max())}); "
                        f"{p1:.2f} dB from the f32 plain canonical forward (limit 35); launches "
                        f"{one}; {first_s:.3f} s with the server's build")
        if not same or p1 < 35.0:
            raise AssertionError(f"the served PNG: bit-equal {same}, {p1:.2f} dB")

        singles = [first] + [enhance(srv)(b) for b in bodies[1:]]
        calls0 = models._enhance_batcher.calls
        reset_counts()
        outs = concurrently(enhance(srv), bodies)
        torch.cuda.synchronize()
        conc = counts()
        note_pads("serve")
        calls = models._enhance_batcher.calls - calls0
        check_counts(f"{SERVE_CONCURRENT} concurrent /api/enhance ({calls} batched calls)", conc,
                     {k: v * calls for k, v in fwd.items()})
        worst = max(int(np.abs(o.astype(np.int16) - s).max()) for o, s in zip(outs, singles))
        log("11 serve", f"{SERVE_CONCURRENT} concurrent /api/enhance, max_batch 16: {calls} "
                        f"batched calls (limit < {SERVE_CONCURRENT}), rows "
                        f"{[n for n, _ in device_calls[-calls:]]}; largest |du8| against the "
                        f"single-request PNGs {worst} (limit 1); launches {conc}")
        if calls >= SERVE_CONCURRENT or worst > 1:
            raise AssertionError(f"concurrent requests: {calls} calls, |du8| {worst}")
        launches["serve"] = conc

        # -- NIMA (f32, seeded) under enhance load, against the scorer at B=1
        scorer = init_nima("", compute_dtype="float32", device=dev)
        stop, errors = threading.Event(), []

        def load(i):
            try:
                while not stop.is_set():
                    post(srv, "/api/enhance", bodies[i % len(bodies)])
                    i += 1
            except Exception as e:  # surfaced after the join
                errors.append(e)
        loaders = [threading.Thread(target=load, args=(i,)) for i in range(4)]
        for t in loaders:
            t.start()
        try:
            got = [json.loads(post(srv, "/api/get_scores", b))["scores"] for b in bodies[:8]]
        finally:
            stop.set()
            for t in loaders:
                t.join(600)
        if errors:
            raise errors[0]
        with torch.inference_mode():
            want = [scorer(torch.from_numpy(prepare_image_np(Image.fromarray(p))[None]).to(dev))
                    .cpu().numpy()[0] for p in photos[:8]]
        dn = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(got, want))
        exact = sum(a == [round(float(v), 6) for v in b] for a, b in zip(got, want))
        log("11 serve", f"/api/get_scores NIMA f32 with 4 clients of /api/enhance in flight: 8 "
                        f"images, probabilities max |d| {dn:.3e} from the scorer at B=1 (limit "
                        f"2e-5); {exact} of 8 equal to its 6 printed decimals")
        if dn > 2e-5:
            raise AssertionError(f"served NIMA scores {dn} from the scorer")

        # -- timings
        firsts, later = {}, {}
        for rows, sec in device_calls:
            (later.setdefault(rows, []) if rows in firsts else firsts.setdefault(rows, [])).append(
                sec)
        log("11 serve", "device call (normalize, forward, quantize, copies) by bucket, first / "
                        "median of later ms: " + ", ".join(
                            f"B={b} {firsts[b][0] * 1e3:.2f} / "
                            f"{np.median(later[b]) * 1e3 if b in later else float('nan'):.2f}"
                            for b in sorted(firsts)) + f" [{card}]")
        lat = []
        for i in range(SERVE_SEQUENTIAL):
            t0 = time.perf_counter()
            post(srv, "/api/enhance", bodies[i % len(bodies)])
            lat.append((time.perf_counter() - t0) * 1e3)
        log("11 serve", f"{SERVE_SEQUENTIAL} sequential /api/enhance ({SERVE_PHOTO[0]}x"
                        f"{SERVE_PHOTO[1]} PNG in, {IMG}px PNG out): p50 "
                        f"{np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms, "
                        f"mean {np.mean(lat):.2f} ms [{card}]")
        for clients in SERVE_CLIENTS:
            calls0, n0 = models._enhance_batcher.calls, len(device_calls)
            t0 = time.perf_counter()
            concurrently(lambda i: [post(srv, "/api/enhance", bodies[(i + k) % len(bodies)])
                                    for k in range(4)], list(range(clients)))
            secs = time.perf_counter() - t0
            rows = [n for n, _ in device_calls[n0:]]
            log("11 serve", f"{clients} concurrent clients x 4 /api/enhance: "
                            f"{4 * clients / secs:.1f} img/s ({secs:.3f} s), "
                            f"{models._enhance_batcher.calls - calls0} batched calls, mean "
                            f"{np.mean(rows):.2f} rows a call (padded) [{card}]")
        dec, enc = [], []
        for b in bodies[:10]:
            t0 = time.perf_counter()
            with Image.open(io.BytesIO(b)) as im:
                u8 = np.asarray(im.convert("RGB").resize((IMG, IMG), Image.BILINEAR))
            t1 = time.perf_counter()
            png_bytes(u8)
            dec.append((t1 - t0) * 1e3)
            enc.append((time.perf_counter() - t1) * 1e3)
        log("11 serve", f"the server's host work a request, alone (mean of 10): PNG decode and "
                        f"PIL resize {np.mean(dec):.2f} ms, PNG encode of the {IMG}px result "
                        f"{np.mean(enc):.2f} ms [{card}]")
        seq = iter(range(10))
        r = profile(lambda: post(srv, "/api/enhance", bodies[next(seq)]), iters=10, warmup=0)
        log("11 serve", f"10 sequential /api/enhance under torch.profiler: {r['wall_ms']:.2f} ms "
                        f"a request, device busy {r['busy_ms']:.3f} ms a request, device share "
                        f"{r['busy_ms'] / r['wall_ms']:.3f} (the rest: HTTP, PNG decode and "
                        f"encode, PIL resize, the batcher's window) [{card}]")
    finally:
        models._run_u8 = run_u8
        stop_server(srv)

    # -- int8_pallas: calibration on JAX's seeded batch at the first request
    srv = start_server(generator_ckpt=pth, test_img_size=IMG, quantized_inference="int8_pallas",
                       device=dev)
    try:
        reset_counts()
        out8 = enhance(srv)(bodies[0])
        concurrently(enhance(srv), bodies[1:5])
        torch.cuda.synchronize()
        run8 = counts()
        note_pads("serve_int8")
        calls8 = srv.models._enhance_batcher.calls
    finally:
        stop_server(srv)
    calib = {**zero, "gam_stats": 4, "upsample2x": 3, "s2d_convert": 1, "gam_norm": 1}
    fwd8 = {**fwd, "gam_stats": 4, "packed_conv_int8": 1, "gam_norm": 1}
    check_counts(f"/api/enhance int8_pallas (calibration, {calls8} batched calls)", run8,
                 {k: calib[k] + calls8 * fwd8[k] for k in KERNELS})
    p8 = psnr_u8(out8, first)
    log("11 serve", f"--quantized_inference int8_pallas: 5 requests, {calls8} batched calls; "
                    f"{p8:.2f} dB from the bf16 server's PNG (limit 30); launches {run8}")
    if p8 < 30.0:
        raise AssertionError(f"int8_pallas served PNG {p8:.2f} dB from bf16")
    launches["serve_int8"] = run8

    # -- --keep_aspect: a DSLR-sized photo through the strips, unbatched
    big = photo(*SERVE_NATIVE, rng)
    big_png = png_bytes(big)
    srv = start_server(generator_ckpt=pth, keep_aspect=True, device=dev)
    try:
        reset_counts()
        t0 = time.perf_counter()
        out_n = enhance(srv)(big_png)
        first_n = time.perf_counter() - t0
        torch.cuda.synchronize()
        run_n = counts()
        note_pads("serve_native")
        check_counts(f"one /api/enhance --keep_aspect {SERVE_NATIVE[0]}x{SERVE_NATIVE[1]} (the "
                     f"strips)", run_n,
                     {**zero, "s2d_convert": 1, "upsample2x": 2, "residual_tail_d2s": 1,
                      "gam_norm": 3})
        t0 = time.perf_counter()
        enhance(srv)(big_png)
        again_n = time.perf_counter() - t0
        t0 = time.perf_counter()
        outs, peak = peak_gib(lambda: concurrently(enhance(srv), [big_png] * SERVE_NATIVE_AT_ONCE))
        at_once = time.perf_counter() - t0
    finally:
        stop_server(srv)
    padded, hw = native.pad_to_grid(big[None])
    ref = native.crop_back(plain_f32(padded), hw)[0]
    pn = psnr_u8(out_n, ref)
    same = all(np.array_equal(o, out_n) for o in outs)
    log("11 serve", f"--keep_aspect {SERVE_NATIVE[0]}x{SERVE_NATIVE[1]} PNG: {out_n.shape[0]}x"
                    f"{out_n.shape[1]} back, {pn:.2f} dB from the f32 plain canonical forward "
                    f"of the padded input (limit 35); launches {run_n}; first request "
                    f"{first_n:.3f} s, the next {again_n:.3f} s; {SERVE_NATIVE_AT_ONCE} at once "
                    f"{at_once:.3f} s, peak {peak:.2f} GiB above what was held before them, outputs "
                    f"equal to the single request's: {same} [{card}]")
    if out_n.shape != SERVE_NATIVE + (3,) or pn < 35.0:
        raise AssertionError(f"--keep_aspect: shape {out_n.shape}, {pn:.2f} dB")
    launches["serve_native"] = run_n
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return launches


# each custom op (ops/_build.py:custom_op) by the kernel it launches
OP_KERNELS = {"gam_mean_std": "gam_stats", "gam_mean_std_train": "gam_stats",
              "gam_mean_std_backward": "gam_stats_bwd", "upsample2x": "upsample2x",
              "upsample2x_backward": "upsample2x_bwd", "s2d_convert": "s2d_convert",
              "residual_tail_d2s": "residual_tail_d2s", "packed_conv": "packed_conv",
              "packed_conv_int8": "packed_conv_int8", "reflect_pad": "reflect_pad",
              "gam_norm": "gam_norm"}

# a fresh interpreter for phase 12: load each exported program, run it once
# on its saved input with the launch counts set to 0, save its output, and
# fail where any jax or uegan_tpu module was loaded
EXPORT_LOAD = """
import json
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from uegan_tpu_torch.tools.export_model import kernel_calls, load_exported
torch.backends.cudnn.allow_tf32 = True
torch.backends.cuda.matmul.allow_tf32 = False
device, root, out = sys.argv[2], sys.argv[3], {}
for name in sys.argv[4:]:
    fn = load_exported(f"{root}/{name}.pt2")
    x = torch.from_numpy(np.load(f"{root}/{name}.in.npy")).to(device)
    chip_smoke.reset_counts()
    y = fn(x)
    if device == "cuda":
        torch.cuda.synchronize()
    out[name] = {"launches": chip_smoke.counts(), "pads": chip_smoke.pad_counts(),
                 "graph": kernel_calls(fn.program)}
    np.save(f"{root}/{name}.out.npy", (y if y.dtype == torch.uint8 else y.float()).cpu().numpy())
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'uegan_tpu') or m.startswith('jax_'))
assert not bad, bad
print(json.dumps(out))
"""


def export_opcheck(dev) -> None:
    """torch.library.opcheck on every kernel's op at one main-path shape on
    the card (the CUDA impls against their fake kernels; A and B with inputs
    that require grad, so A' and B' run as their registered backwards)."""
    import torch

    from uegan_tpu_torch.ops import gam_stats

    gen = torch.Generator(device=dev).manual_seed(SEED)
    r = lambda *shape, dt=torch.bfloat16: torch.randn(shape, generator=gen, device=dev).to(dt)
    i8 = lambda *shape: torch.randint(-127, 128, shape, generator=gen, device=dev,
                                      dtype=torch.int8)
    x = r(2, 64, 64, 128)  # ga3's input at 512 px
    mean32, var32 = gam_stats.plain_stats32(x)
    cl = lambda *shape: r(*shape).contiguous(memory_format=torch.channels_last)
    cases = {
        "s2d_convert": (r(2, IMG, IMG, 3, dt=torch.float32), torch.bfloat16),
        "residual_tail_d2s": (r(2, HP, HP, 12), r(2, HP, HP, 12)),
        "upsample2x": (r(2, 128, 128, 64).requires_grad_(),),
        "upsample2x_backward": (r(2, 256, 256, 64),),
        "gam_mean_std": (x, 1e-5),
        "gam_mean_std_train": (x.clone().requires_grad_(), 1e-5),
        "gam_mean_std_backward": (x, mean32.contiguous(), var32.contiguous(), r(2, 1, 1, 128),
                                  r(2, 1, 1, 128), 1e-5),
        "packed_conv": (r(2, HP, HP, 64), r(128, 64, 3, 3), r(128), 1, "leaky"),
        "packed_conv_int8": (i8(2, HP, HP, 128), i8(128, 128, 1, 1),
                             r(128, dt=torch.float32).abs() * 1e-3, r(128, dt=torch.float32), 0,
                             "none", None, None, False),
        # dec2's two parts at 512 px, requiring grad, so the backward runs too
        "reflect_pad": (cl(2, 128, 128, 128).requires_grad_(),
                        cl(2, 128, 128, 128).requires_grad_(), 1),
        "reflect_pad_backward": (cl(2, 256, 130, 130), 1, 128),
        "gam_norm": (x, 1e-5),
    }
    for name, args in cases.items():
        result = torch.library.opcheck(getattr(torch.ops.uegan_torch, name).default, args)
        torch.cuda.synchronize()
        if set(result.values()) != {"SUCCESS"}:
            raise AssertionError(f"opcheck {name}: {result}")
        log("12 export", f"opcheck uegan_torch::{name} on the card: {sorted(result)} passed")


def phase_export(dev, card: str, tmp: str) -> dict:
    """Phase 12: tools/export_model.py on the card at the default width (cd
    32, the seeded generator of phase 4 from a reference .pth): each program
    of EXPORT_CASES, loaded and run in a fresh interpreter that loads no jax
    and no uegan_tpu module, bit-equal to the eager make_fast_eval on the
    same weights and input (u8 in u8) and launching the kernels as one eager
    call does; its export seconds, size, and CUDA-event ms beside the eager
    forward's (in turns: eager, program, program, eager); then opcheck on
    every op.  Returns the launches of each program's call."""
    import numpy as np
    import torch

    from uegan_tpu_torch.config import Config
    from uegan_tpu_torch.infer.packed import make_fast_eval
    from uegan_tpu_torch.models.generator import Generator
    from uegan_tpu_torch.tools.export_model import export_generator, load_exported
    from uegan_tpu_torch.utils.checkpoint import generator_state, load_pth
    from uegan_tpu_torch.utils.image_io import normalize_u8, quantize_u8

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    _, sd = seeded_generator(torch.bfloat16, "cpu")
    write_pth(tmp, sd)
    pth = os.path.join(tmp, "UEGAN-FiveK", "models", "UEGAN-FiveK_rahinge_92.pth")
    zero = dict.fromkeys(KERNELS, 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    eager, programs = {}, {}
    for name, hw, b, quant, u8 in EXPORT_CASES:
        path = os.path.join(tmp, f"{name}.pt2")
        t0 = time.time()
        size = export_generator(path, pth, hw, b, quantized=quant, platforms=(dev.type,),
                                u8_io=u8)
        secs = time.time() - t0
        log("12 export", f"{name}: {hw}px B={b} exported in {secs:.1f} s, {size / 1e6:.2f} MB "
                         f"[{card}]")
        cfg = Config(quantized_inference=quant).validate()
        g = Generator(conv_dim=cfg.g_conv_dim, dtype=torch.bfloat16)
        g.load_state_dict(generator_state(load_pth(pth), ema=cfg.ema_eval))
        fn = make_fast_eval(g.to(dev).eval(), cfg)
        if u8:
            x = torch.randint(0, 256, (b, hw, hw, 3), generator=gen, device=dev,
                              dtype=torch.uint8)
            step = lambda x, fn=fn: quantize_u8(fn(normalize_u8(x)))
        else:
            x = torch.rand((b, hw, hw, 3), generator=gen, device=dev) * 2 - 1
            step = fn
        with torch.inference_mode():
            reset_counts()
            y = step(x)
            torch.cuda.synchronize()
            launched, pads = counts(), pad_counts()
        check_counts(f"one eager {name} forward", launched, {**zero, **EXPORT_LAUNCHES[name]})
        np.save(os.path.join(tmp, f"{name}.in.npy"), x.cpu().numpy())
        eager[name] = ((y if y.dtype == torch.uint8 else y.float()).cpu().numpy(), launched,
                       pads)
        program = load_exported(path)
        times = {"eager": [], "program": []}
        iters = 10 if hw == IMG else 3
        with torch.inference_mode():
            for which in ("eager", "program", "program", "eager"):
                f = step if which == "eager" else program
                times[which].append(cuda_ms(lambda: f(x), iters=iters))
        mean = {k: sum(v) / len(v) for k, v in times.items()}
        log("12 export", f"{name}: {hw}px B={b}: the program {mean['program']:.3f} ms/forward "
                         f"(runs {times['program']}), the eager forward {mean['eager']:.3f} "
                         f"(runs {times['eager']}) [{card}]")
        programs[name] = mean
        del program, fn, g

    # the fresh interpreter shares the card: hand back the blocks this
    # process's allocator keeps from the earlier phases (tens of GiB)
    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = HERE
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", EXPORT_LOAD, HERE, dev.type, tmp,
                           *[c[0] for c in EXPORT_CASES]],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"loading the exported programs in a fresh interpreter failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-8000:]}")
    fresh = json.loads(proc.stdout.splitlines()[-1])
    log("12 export", f"a fresh interpreter (no jax, no uegan_tpu module) loaded and ran the "
                     f"{len(fresh)} programs in {time.time() - t0:.1f} s")
    launches = {}
    for name, *_ in EXPORT_CASES:
        got = np.load(os.path.join(tmp, f"{name}.out.npy"))
        want, launched, pads = eager[name]
        if got.shape != want.shape or got.dtype != want.dtype or not np.array_equal(got, want):
            diff = (np.abs(got.astype(np.float64) - want.astype(np.float64)).max()
                    if got.shape == want.shape else "shape")
            raise AssertionError(f"the exported {name} program differs from the eager forward: "
                                 f"{got.shape} {got.dtype} vs {want.shape} {want.dtype}, "
                                 f"max |d| {diff}")
        check_counts(f"one call of the exported {name} program",
                     (fresh[name]["launches"], fresh[name]["pads"]), (launched, pads))
        graph = dict(zero, reflect_pad=0)
        for op, n in fresh[name]["graph"].items():
            graph[OP_KERNELS[op]] += n
        check_counts(f"the exported {name} program's graph", graph,
                     dict(launched, reflect_pad=pads["reflect_pad"]))
        launches[f"export_{name}"] = fresh[name]["launches"]
        note_pads(f"export_{name}", fresh[name]["pads"])
        log("12 export", f"{name}: the fresh interpreter's output bit-equal to the eager "
                         f"forward ({got.dtype}); launches {fresh[name]['launches']}, "
                         f"{fresh[name]['pads']}")
    export_opcheck(dev)
    return launches


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
                "gam_stats_bwd_kernel", "upsample2x_bwd_kernel", "reflection_pad_nhwc_kernel",
                "reflection_pad_nhwc_bwd_kernel", "norm_act_nhwc_stats_kernel",
                "norm_act_nhwc_bwd_apply_kernel"):
        if not any(key in line for line in ptxas):
            raise AssertionError(f"ptxas's report names no {key} kernel")

    worst = phase_kernels(dev)
    worst_s2d = phase_s2d_kernels(dev)
    worst_int8 = phase_int8_kernels(dev)
    worst_bwd = phase_backward_kernels(dev)
    worst_pad = phase_pad_kernels(dev)
    phase_model(dev)
    phase_int8_model(dev)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_") as tmp:
        launches = phase_end_to_end(dev, tmp)
        launches["train"] = phase_train(dev, card, tmp)["launches"]
        launches.update(phase_sn(dev, card, tmp))
        phase_norm_cli(dev, card, tmp)
        phase_graph(dev, card, tmp)
    timing = phase_timing(dev, card)
    phase_profile(dev, card)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_nima_") as tmp:
        phase_nima(dev, card, tmp)
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_highres_") as tmp:
        launches.update(phase_highres(dev, card, tmp))
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_serve_") as tmp:
        launches.update(phase_serve(dev, card, tmp))
    with tempfile.TemporaryDirectory(prefix="uegan_smoke_export_") as tmp:
        launches.update(phase_export(dev, card, tmp))
    norm = phase_norm(dev, card)

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
                              "uegan_tpu/ops/resize.py:105"),
           # the GAM's instance norm at inference, which XLA fuses on the TPU
           "gam_norm": ("uegan_tpu_torch/csrc/norm_act.cu", "uegan_tpu/ops/norms.py:17")}
    err = {"gam_stats": worst["gam_stats"][0], "upsample2x": worst["upsample2x"][0],
           **worst_s2d, **worst_int8, **worst_bwd, "gam_norm": timing["gam_norm_err"]}
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
    pad = timing["reflect_pad"]
    kernels.append({
        "name": "reflect_pad", "route": "cuda", "source": "uegan_tpu_torch/csrc/reflect_pad.cu",
        "replaces": "none (JAX's jnp.pad, which XLA fuses into the conv)",
        "launches": {key: sum(run[key] for run in PADS_BY_PATH.values())
                     for key in PAD_LAUNCHES["canonical"]},
        "launches_by_path": {path: PADS_BY_PATH[path] for path in launches},
        "max_abs_err_bwd": worst_pad,
        "ms": pad["enhance"]["fwd"]["kernel"], "plain_ms": pad["enhance"]["fwd"]["plain"],
        "library_ms": pad["enhance"]["fwd"]["library"],
        "bound_ms": pad["enhance"]["fwd"]["bound"], "bound_by": "bytes",
        "per": f"packed forward, {IMG} px B={PAD_B}", "train": pad["train"], "sn": pad["sn"],
        "device_time": sorted(DEVICE_METHODS),
    })
    kernels.append({
        "name": "norm_act", "route": "cuda", "source": "uegan_tpu_torch/csrc/norm_act.cu",
        "replaces": "none (JAX's NormLayer in train mode and the LeakyReLU, which XLA fuses)",
        "launches_a_step": norm["timings"]["step"]["launches"], "max_abs_err": norm["worst"],
        "timings": {k: v for k, v in norm["timings"].items() if k != "step"},
        "step": {k: v for k, v in norm["timings"]["step"].items() if k != "launches"},
    })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
