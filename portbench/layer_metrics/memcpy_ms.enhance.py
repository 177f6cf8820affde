"""Device time of the host-device copies and sets per enhance call."""
from portbench.harness import readers


def read(t, ctx):
    return readers.per_unit_ms(sum(c.end - c.start for c in t.copies), ctx, "calls")
