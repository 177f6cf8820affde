"""Kernel F, the bfloat16 packed conv (``csrc/packed_conv.cu``): input, kernel
and output once each, and 2 M Cout Cin S^2 operations at the bfloat16 peak
(phase 7)."""

from portbench.counts import itemsize, numel

KERNEL_NAMES = ("FloatEpilogue", "conv_f32")


def _conv(shapes, dtypes):
    xp, kp = shapes[0], shapes[1]
    cout, cin, s, _ = kp
    es = itemsize(dtypes[0])
    m = numel(xp) // xp[-1]
    peak = "bf16_flops" if es == 2 else "f32_flops"
    return (numel(xp) * es + m * cout * es + numel(kp) * es, 2 * m * cout * cin * s * s, peak)


OPS = {"packed_conv": _conv}
