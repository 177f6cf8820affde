"""Model FLOPs of a NIMA train step an example at the cell's size (counted
on the reference, counts/nima.py) x examples trained in the window outside
its traced part / those seconds / bf16 peak."""
from portbench.counts import nima
from portbench.harness import readers


def read(t, ctx):
    return readers.mfu(t, ctx, nima.train_flops_per_pair(ctx["traffic"]["image_hw"]), "pairs")
