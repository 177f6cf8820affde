"""Device ms a NIMA train step spends in the norm kernels (names holding
``norm_act_nhwc``: the 53 BNs' forward and backward statistics and apply
kernels, counts/nima.py), summed over the traced window's steps."""
from portbench.counts import nima
from portbench.harness import readers


def read(t, ctx):
    spent = sum(k.end - k.start for k in t.kernels
                if any(n in k.name for n in nima.KERNEL_NAMES))
    return readers.per_unit_ms(spent, ctx, "steps") if spent > 0 else None
