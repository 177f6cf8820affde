"""% of the bound: the least time the 53 BNs' forward and backward norm
calls of the traced window's steps allow at the card's memory bandwidth
(the bytes each must move once at the cell's shapes, counts/nima.py: 9.06
GB a step at B=128, 224 px, bf16) over the device time of the kernels whose
names hold ``norm_act_nhwc``."""
from portbench.counts import nima
from portbench.harness.peaks import PEAKS


def read(t, ctx):
    peaks = PEAKS.get(ctx["kind"])
    steps = ctx["units"].get("steps", 0)
    spent = sum(k.end - k.start for k in t.kernels
                if any(n in k.name for n in nima.KERNEL_NAMES))
    if not peaks or not steps or spent <= 0:
        return None
    nbytes = nima.norm_step_bytes(ctx["config"], ctx["traffic"]) * steps
    return 100.0 * nbytes / peaks["hbm_bytes_per_s"] / spent
