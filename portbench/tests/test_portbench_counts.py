"""The benchmark's counts: model FLOPs on the reference against the
FlopCounterMode counts of the port (67.75 GFLOP a 512 px image, 274.72 a
256 px pair), and each kernel's bytes against the bounds ``chip_smoke.py``
phase 7 printed (PERF.md, the table of kernels: ms at 3.35 TB/s, or at the
dense peak where the operations bound)."""

import pytest

from portbench import counts
from portbench.counts import flops
from portbench.harness.peaks import PEAKS

PEAK = PEAKS["NVIDIA H100 80GB HBM3"]
BF16, F32 = "c10::BFloat16", "float"


def test_flops_per_image_and_pair():
    assert flops.enhance_per_image(32, False, 512) == pytest.approx(67.75e9, rel=0.01)
    for sn in (False, True):  # power iterations are no model FLOPs
        assert flops.train_per_pair(32, 32, sn, 256, 10) == pytest.approx(274.72e9, rel=0.01)


def bound_ms(kernel: str, op: str, calls) -> float:
    fn = counts.kernels()[kernel].OPS[op]
    total = 0.0
    for shapes, dtypes in calls:
        nbytes, nops, key = fn(shapes, dtypes)
        total += max(nbytes / PEAK["hbm_bytes_per_s"], nops / PEAK[key] if nops else 0.0)
    return total * 1e3


def test_every_kernel_has_names_and_ops():
    found = counts.kernels()
    assert set(found) == {"kernel_A", "kernel_A_bwd", "kernel_B", "kernel_B_bwd", "kernel_C",
                          "kernel_D", "kernel_E", "kernel_F"}
    for mod in found.values():
        assert mod.KERNEL_NAMES and mod.OPS


# phase 7's shapes: B=8 at 512 px for A-F (canonical GAM and upsample shapes,
# the packed entry and exit, E at ga1 and F at the dec4 shape), 20 images at
# 256 px for A' and B' (one fused train step)
@pytest.mark.parametrize("kernel,op,calls,want", [
    ("kernel_A", "gam_mean_std",
     [([(8, 512 >> s, 512 >> s, 32 << s), []], [BF16, "Scalar"]) for s in range(5)], 0.0776),
    ("kernel_B", "upsample2x",
     [([(8, 512 >> s, 512 >> s, 32 << s)], [BF16]) for s in range(4, 0, -1)], 0.1878),
    ("kernel_C", "s2d_convert", [([(8, 512, 512, 3), []], [F32, "ScalarType"])], 0.0113),
    ("kernel_D", "residual_tail_d2s",
     [([(8, 256, 256, 12), (8, 256, 256, 12)], [BF16, BF16])], 0.0113),
    ("kernel_E", "packed_conv_int8",
     [([(8, 256, 256, 128), (128, 128, 1, 1), (128,), (128,)],
       ["signed char", "signed char", F32, F32])], 0.0601),
    ("kernel_F", "packed_conv",
     [([(8, 256, 256, 256), (128, 256, 3, 3), (128,)], [BF16, BF16, BF16])], 0.3127),
    ("kernel_A_bwd", "gam_mean_std_backward",
     [([(20, 256 >> s, 256 >> s, 32 << s)] + [(20, 1, 1, 32 << s)] * 4 + [[]],
       [BF16, F32, F32, BF16, BF16, "Scalar"]) for s in range(5)], 0.0971),
    ("kernel_B_bwd", "upsample2x_backward",
     [([(20, 2 * (256 >> s), 2 * (256 >> s), 32 << s)], [BF16]) for s in range(4, 0, -1)],
     0.1174),
])
def test_bounds_match_phase7(kernel, op, calls, want):
    assert round(bound_ms(kernel, op, calls), 4) == want
