"""Device busy time (the union of every device record) per train step."""
from portbench.harness import readers


def read(t, ctx):
    return readers.per_unit_ms(t.busy_s(), ctx, "steps")
