"""The traced window: ``torch.profiler`` over part of a run, reduced to what
the per-layer readers and the result's ``breakdown`` need.

The window records the device's activity alone (on a machine without a
card, the host's ops): no host op is recorded inside it, so a step that the
host's launches hold runs at its untraced pace, and the idle share, busy
time and rates read from the window are the run's own.  Device time is read
from the profiler's device records: the kernels by name, the copies and sets
(``Memcpy ...``, ``Memset ...``) apart.  ``busy_s`` is the union of every
device interval inside the window, and the window runs from the profiler's
start to its stop, each after a synchronize, on the host's wall clock that
the profiler's records use, so a stall before the first kernel or after the
last one counts as idle.  The drivers' spans (``span``) around each call
into a layer are kept by the tracer itself on that clock; an idle gap is
labelled with the innermost one open at its middle.

The shapes of the program's ops, which a kernel's bound needs, and the
number of kernels a call launches come from one more call after the window
closes, profiled with the host's ops and their shapes (``record_call``):
every call of a cell has the same shapes and launches.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# (bucket, substrings of the kernel name), the first match wins: the buckets
# of the port's profile (chip_smoke.py:BUCKETS)
BUCKETS = [
    ("packed_conv_int8 kernel (E)", ("Int8Epilogue",)),
    ("packed_conv kernel (F)", ("FloatEpilogue", "conv_f32")),
    ("gam_stats kernel (A)", ("gam_stats_kernel",)),
    ("gam_stats_bwd kernel (A')", ("gam_stats_bwd_kernel",)),
    ("upsample2x_bwd kernel (B')", ("upsample2x_bwd_kernel",)),
    ("upsample2x kernel (B)", ("upsample2x_ac",)),
    ("s2d_convert kernel (C)", ("s2d_convert_kernel",)),
    ("residual_tail_d2s kernel (D)", ("residual_tail_d2s_kernel",)),
    ("reflect pad", ("reflection_pad",)),
    ("concat", ("CatArrayBatchedCopy", "cat_")),
    ("row gathers (index_select)", ("indexSelect", "index_select")),
    ("optimizer (Adam)", ("multi_tensor_apply", "Adam", "adam")),
    ("conv backward (cuDNN dgrad, wgrad)", ("dgrad", "wgrad")),
    ("convolutions (cuDNN)", ("fprop", "conv", "implicit", "cudnn", "winograd")),
    ("max pool", ("max_pool",)),
    ("matmuls (einsum, int8 _int_mm)", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "imma")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "nchwToNhwc", "nhwcToNchw")),
    ("other elementwise", ("elementwise", "vectorized", "Elementwise")),
]


def bucket_of(name: str) -> str:
    for bucket, keys in BUCKETS:
        if any(k in name for k in keys):
            return bucket
    return "other"


@dataclass
class Interval:
    name: str
    start: float  # seconds on the trace's clock
    end: float


@dataclass
class Op:
    """A host-side op record: name, and its inputs' shapes and dtypes."""
    name: str
    shapes: list
    dtypes: list


@dataclass
class Trace:
    """One traced window, on the trace's clock (seconds)."""
    start: float
    end: float
    kernels: List[Interval] = field(default_factory=list)
    copies: List[Interval] = field(default_factory=list)  # Memcpy and Memset records
    spans: List[Interval] = field(default_factory=list)
    calls: int = 0  # the driver's calls started inside the window
    # the run's window outside the traced part: (calls, host seconds)
    outside: Tuple[int, float] = (0, 0.0)
    call_ops: List[Op] = field(default_factory=list)  # one more call's host ops, with shapes
    call_kernels: int = 0  # that call's kernels on the device

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def busy_s(self, kinds: Tuple[str, ...] = ("kernels", "copies")) -> float:
        """Seconds of the window in which some device record of ``kinds`` ran."""
        recs = sorted((max(r.start, self.start), min(r.end, self.end))
                      for kind in kinds for r in getattr(self, kind))
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in recs:
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """(start, end) of each stretch of the window with no device record."""
        recs = sorted((r.start, r.end) for r in self.kernels + self.copies)
        gaps, at = [], self.start
        for s, e in recs:
            if s > at:
                gaps.append((at, min(s, self.end)))
            at = max(at, e)
            if at >= self.end:
                break
        if at < self.end:
            gaps.append((at, self.end))
        return [(s, e) for s, e in gaps if e > s]

    def label(self, t: float) -> str:
        """The innermost benchmark span open at ``t``."""
        open_spans = [s for s in self.spans if s.start <= t <= s.end]
        if open_spans:
            return min(open_spans, key=lambda s: s.end - s.start).name
        return "window: no span"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        by_bucket: Dict[str, float] = {}
        for r in self.kernels + self.copies:
            b = bucket_of(r.name)
            by_bucket[b] = by_bucket.get(b, 0.0) + (r.end - r.start)
        ops = sorted(by_bucket.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[self.label((s + e) / 2), e - s] for s, e in gaps]}


class Tracer:
    """Starts and stops ``torch.profiler`` around part of a run; with
    ``enabled`` false every method does nothing and ``span`` is free."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._t0 = 0
        self._spans: List[Interval] = []
        self.trace: Optional[Trace] = None

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        if self._prof is None:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self._spans.append(Interval(name, t0 * 1e-9, time.time_ns() * 1e-9))

    def warm(self) -> None:
        """Start and stop the profiler once on a trivial op, as the window and
        ``record_call`` run it: its first start (the device tracer's set-up)
        takes seconds, which belong in set-up, not in the traced window."""
        if not self.enabled:
            return
        from torch.profiler import profile

        dev = "cuda" if torch.cuda.is_available() else "cpu"
        for acts in (_window_activities(), _call_activities()):
            with profile(activities=acts, record_shapes=True):
                torch.ones(1, device=dev).add_(1)
                _sync()

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        if not self.enabled or self._prof is not None or self.trace is not None:
            return
        from torch.profiler import profile

        _sync()
        self._prof = profile(activities=_window_activities())
        self._prof.__enter__()
        _sync()
        self._t0 = time.time_ns()  # the profiler's records are on this clock

    def stop(self, calls: int = 0) -> None:
        """Close the window; ``calls``: the driver's calls started inside it."""
        if self._prof is None:
            return
        _sync()
        t1 = time.time_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        t = reduce(prof.profiler.kineto_results.events(), self._t0 * 1e-9, t1 * 1e-9)
        t.spans = [s for s in self._spans if s.end > t.start and s.start < t.end]
        t.calls = calls
        self._spans = []
        self.trace = t

    def record_call(self, call) -> None:
        """Run ``call()`` once under the profiler with the host's ops and their
        shapes, after the window has closed, and keep its ops and the number
        of its kernels in the trace."""
        if not self.enabled or self.trace is None:
            return
        from torch.profiler import profile

        _sync()
        with profile(activities=_call_activities(), record_shapes=True) as prof:
            call()
            _sync()
        events = prof.profiler.kineto_results.events()
        self.trace.call_ops = [Op(e.name(), e.shapes(), e.dtypes())
                               for e in events if str(e.device_type()).endswith("CPU")]
        self.trace.call_kernels = sum(
            1 for e in events if str(e.device_type()).endswith("CUDA")
            and not e.is_user_annotation() and not e.name().startswith(("Memcpy", "Memset")))


def _window_activities() -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]


def _call_activities() -> list:
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def reduce(events, start: float, end: float) -> Trace:
    """Kineto records -> the Trace of the window [start, end] (seconds on the
    host's wall clock, which the profiler's records use): the device's
    records, and no host op."""
    kernels, copies = [], []
    for e in events:
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        if t <= start or s >= end:
            continue
        name = e.name()
        if not str(e.device_type()).endswith("CUDA") or e.is_user_annotation():
            continue
        (copies if name.startswith(("Memcpy", "Memset")) else kernels).append(
            Interval(name, s, t))
    return Trace(start, end, kernels, copies)
