"""Kernel E, the int8 packed conv (``csrc/packed_conv_int8.cu``): it reads the
int8 input and kernel once and writes a bfloat16 output, the form of its
main-path call (ga1, no requantization); the operations are 2 M Cout Cin S^2
at the int8 peak (phase 7)."""

from portbench.counts import numel

KERNEL_NAMES = ("Int8Epilogue",)


def _conv(shapes, dtypes):
    xp, kp = shapes[0], shapes[1]
    cout, cin, s, _ = kp
    m = numel(xp) // xp[-1]
    return numel(xp) + m * cout * 2 + numel(kp), 2 * m * cout * cin * s * s, "int8_ops"


OPS = {"packed_conv_int8": _conv}
