"""Model FLOPs of the canonical G at the cell's shape (counted on the
reference) x images enhanced in the window outside its
traced part / those seconds / bf16 peak."""
from portbench.counts import flops
from portbench.harness import readers


def read(t, ctx):
    cfg, tr = ctx["config"], ctx["traffic"]
    per = flops.enhance_per_image(cfg["g_conv_dim"], cfg["g_use_sn"], tr["image_hw"])
    return readers.mfu(t, ctx, per, "images")
