"""Spans: named intervals of the host's work, on the clock of the records
``torch.profiler`` keeps (``time.time_ns()``), held in memory for the
readers of a trace.

    with span("train.step"):
        with span("train.g_forward"):
            ...

A span records its name, its start and end (ns), its own id, the id of
the span open on the same thread when it began (its parent; None for a
root), the id of its root (every span of one step or call shares it) and
its thread.  It records only while the recorder is on (:func:`enable`) or
while a torch profiler runs (``torch.autograd.profiler._is_profiler_enabled``,
set while any profiler runs, the benchmark's traced window included);
otherwise entering and leaving one is a flag check each.  Finished spans go
to a ring of ``CAPACITY`` (the oldest drop out) and nothing is written out:
:func:`recorded` returns those inside an interval.

Readers: ``train/trainer.py:step_timing`` (the ``=== step timing`` line
that ends a train run) and the benchmark's per-layer metrics
(``portbench/harness/program_spans.py``).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

CAPACITY = 65_536


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int
    thread: int


_ring: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)  # append is atomic
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans, innermost last
_on = False


def enable(on: bool = True) -> None:
    """Record spans whether or not a profiler runs (``on``), or only while one does."""
    global _on
    _on = on


def enabled() -> bool:
    return _on


def recorded(start_ns: Optional[int] = None, end_ns: Optional[int] = None) -> List[Span]:
    """The finished spans that the ring holds and that lie within
    [start_ns, end_ns] (either end open when None), in order of start."""
    lo = start_ns if start_ns is not None else -1
    hi = end_ns if end_ns is not None else float("inf")
    return sorted((s for s in list(_ring) if s.start_ns >= lo and s.end_ns <= hi),
                  key=lambda s: s.start_ns)


class span:
    """A context manager recording one span named ``name``; see the module."""

    __slots__ = ("name", "_stack", "_id", "_parent", "_root", "_thread", "_start")

    def __init__(self, name: str):
        self.name = name
        self._stack = None

    def __enter__(self) -> "span":
        if not (_on or _profiler._is_profiler_enabled):
            return self
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self._id = next(_ids)
        if stack:
            self._parent, self._root = stack[-1]._id, stack[-1]._root
        else:
            self._parent, self._root = None, self._id
        self._thread = threading.get_ident()
        self._stack = stack
        stack.append(self)
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        stack = self._stack
        if stack is None:  # entered with the recorder off
            return False
        end = time.time_ns()
        self._stack = None
        stack.pop()
        _ring.append(Span(self.name, self._start, end, self._id, self._parent, self._root,
                          self._thread))
        return False
