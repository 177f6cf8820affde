"""% of the bound: the least time the norm layers' calls of the traced
window's steps allow at the card's memory bandwidth (the bytes each call
must move once at the configuration's shapes, counts/norm_layers.py: 43
forward and 38 backward calls a step) over the device time of the kernels
whose names hold ``norm_act_nhwc``."""
from portbench.counts import norm_layers
from portbench.harness.peaks import PEAKS


def read(t, ctx):
    peaks = PEAKS.get(ctx["kind"])
    steps = ctx["units"].get("steps", 0)
    spent = sum(k.end - k.start for k in t.kernels
                if any(n in k.name for n in norm_layers.KERNEL_NAMES))
    if not peaks or not steps or spent <= 0:
        return None
    nbytes = norm_layers.step_bytes(ctx["config"], ctx["traffic"]) * steps
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / spent
