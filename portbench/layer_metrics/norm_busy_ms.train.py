"""Device ms a train step spends in the norm layers' kernels (names holding
``norm_act_nhwc``: the forward's and the backward's statistics and apply
kernels, counts/norm_layers.py), summed over the traced window's steps."""
from portbench.counts import norm_layers
from portbench.harness import readers


def read(t, ctx):
    spent = sum(k.end - k.start for k in t.kernels
                if any(n in k.name for n in norm_layers.KERNEL_NAMES))
    return readers.per_unit_ms(spent, ctx, "steps") if spent > 0 else None
