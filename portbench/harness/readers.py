"""The arithmetic the per-layer readers (``layer_metrics/<metric>.py``) share.
Each takes the traced window (harness/trace.py:Trace) and the run's context
(``units``: work done inside the traced window; ``config``; ``traffic``;
``kind``: the card's name) and returns a number, or None where it finds
nothing to read."""

from __future__ import annotations

from typing import Optional

from portbench import counts
from portbench.harness.peaks import PEAKS


def idle_share(t, ctx) -> Optional[float]:
    """% of the card's time that a call leaves idle at the run's own pace:
    1 - device busy a call in the traced window / host seconds a call in the
    window outside the traced part (the tracer's cost on the host left out)."""
    calls, seconds = t.outside
    if not t.calls or not calls or seconds <= 0:
        return None
    return 100.0 * (1.0 - (t.busy_s() / t.calls) / (seconds / calls))


def per_unit_ms(seconds: float, ctx, unit: str) -> Optional[float]:
    n = ctx["units"].get(unit, 0)
    return 1e3 * seconds / n if n else None


def mfu(t, ctx, flops_per_unit: float, unit: str) -> Optional[float]:
    """% of the card's bf16 peak: model FLOPs of the work done in the run's
    window outside its traced part, over that part's host seconds (the
    tracer's own cost left out)."""
    peak = PEAKS.get(ctx["kind"], {}).get("bf16_flops")
    n = ctx["units"].get(unit, 0)
    calls, seconds = t.outside
    if not peak or not n or not t.calls or not calls or seconds <= 0:
        return None
    return 100.0 * flops_per_unit * (n / t.calls) * calls / seconds / peak


def roofline(t, ctx) -> Optional[float]:
    """% of the bound: over the hand-written kernels found in the window, the
    least time their launches' bytes or operations allow on the card (from
    ``counts/kernel_*.py`` at the shapes of the call recorded after the
    window, times the calls in the window) over their measured device
    time."""
    peaks = PEAKS.get(ctx["kind"])
    if not peaks or not t.calls:
        return None
    bound = spent = 0.0
    for mod in counts.kernels().values():
        time_s = sum(k.end - k.start for k in t.kernels
                     if any(n in k.name for n in mod.KERNEL_NAMES))
        b = 0.0
        for op in t.call_ops:
            fn = mod.OPS.get(op.name.split("::", 1)[-1]) if op.name.startswith("uegan_torch::") \
                else None
            if fn is not None:
                nbytes, nops, peak_key = fn(op.shapes, op.dtypes)
                b += max(nbytes / peaks["hbm_bytes_per_s"],
                         nops / peaks[peak_key] if nops else 0.0)
        if time_s > 0 and b > 0:
            bound += b * t.calls
            spent += time_s
    return 100.0 * bound / spent if spent else None
