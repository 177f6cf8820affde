"""The program's own spans (``uegan_tpu_torch/utils/spans.py``) inside a
traced window, for the per-layer readers that read them.

The program records its spans while any torch profiler runs, the traced
window's included, on the clock of the profiler's records and of the
window (``time.time_ns()``).  A reader runs in the run's process after the
cell's run returns, so the program's ring still holds the window's spans; it
takes those that lie wholly inside ``[t.start, t.end]``.  A per-call or
per-step value divides by the root spans of the call or step (``tester.run``,
``train.step``) inside the window.  An idle gap goes to the innermost
program span open at its middle (``Trace.label``'s rule).  Each function
returns None where the program keeps no spans (a tree without
``utils/spans.py``) or none of the root's lies in the window.
"""

from __future__ import annotations

from typing import Callable, Collection, Dict, List, Optional


def in_window(t) -> Optional[list]:
    """The program's spans inside the window, in order of start; None
    where the program has no recorder."""
    try:
        from uegan_tpu_torch.utils import spans
    except ImportError:
        return None
    return [s for s in spans.recorded() if s.start_ns * 1e-9 >= t.start
            and s.end_ns * 1e-9 <= t.end]


def _roots(sp: list, root: str) -> int:
    return sum(1 for s in sp if s.name == root and s.parent is None)


def host_ms(t, root: str, names: Collection[str]) -> Optional[float]:
    """Host ms a ``root`` span (a call, a step) spends in the spans ``names``."""
    sp = in_window(t)
    n = _roots(sp, root) if sp else 0
    if not n:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in sp if s.name in names) / n


def idle_ms(t, root: str, counts: Callable[[object, Dict[int, object]], bool]) -> Optional[float]:
    """Device idle ms a ``root`` span in the window's idle gaps whose middle
    falls in a span that ``counts(innermost span, spans by id)`` takes."""
    sp = in_window(t)
    n = _roots(sp, root) if sp else 0
    if not n:
        return None
    by_id = {s.id: s for s in sp}
    todo: List = list(sp)  # in order of start; the gaps come in order too
    i, open_spans, idle = 0, [], 0.0
    for a, b in t.idle_gaps():
        mid = (a + b) / 2
        while i < len(todo) and todo[i].start_ns * 1e-9 <= mid:
            open_spans.append(todo[i])
            i += 1
        open_spans = [s for s in open_spans if s.end_ns * 1e-9 >= mid]
        if open_spans and counts(min(open_spans, key=lambda s: s.end_ns - s.start_ns), by_id):
            idle += b - a
    return 1e3 * idle / n
