"""Device time of the kernels (the union of their intervals) per enhance call."""
from portbench.harness import readers


def read(t, ctx):
    return readers.per_unit_ms(t.busy_s(("kernels",)), ctx, "calls")
