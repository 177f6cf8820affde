"""Model FLOPs of a train step at the cell's shape (counted on the reference)
x pairs trained in the window outside its
traced part / those seconds / bf16 peak."""
from portbench.counts import flops
from portbench.harness import readers


def read(t, ctx):
    cfg, tr = ctx["config"], ctx["traffic"]
    per = flops.train_per_pair(cfg["g_conv_dim"], cfg["d_conv_dim"], cfg["g_use_sn"],
                               tr["image_hw"], tr["batch"])
    return readers.mfu(t, ctx, per, "pairs")
