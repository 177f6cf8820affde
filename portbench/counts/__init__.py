"""The benchmark's own counts of work, made from shapes: the model FLOPs of
each path (``flops.py``, counted on the reference) and, one file a kernel,
the bytes and operations each kernel call must move or do
(``kernel_<letter>.py``).  ``kernels()`` finds the kernel files by name, so
a kernel added later needs only its own file here."""

from __future__ import annotations

import importlib
import pkgutil
from typing import Dict

ITEMSIZE = {"float": 4, "c10::BFloat16": 2, "c10::Half": 2, "signed char": 1,
            "unsigned char": 1, "double": 8}


def itemsize(dtype: str) -> int:
    if dtype not in ITEMSIZE:
        raise KeyError(f"no item size for the profiler's dtype {dtype!r}")
    return ITEMSIZE[dtype]


def numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def kernels() -> Dict[str, object]:
    """{module name: module} of every ``kernel_*.py`` here.  Each module has
    ``KERNEL_NAMES`` (substrings of its device kernels' names) and ``OPS``
    ({custom op name: fn(shapes, dtypes) -> (bytes, operations, peak key)})."""
    out = {}
    for info in pkgutil.iter_modules(__path__):
        if info.name.startswith("kernel_"):
            out[info.name] = importlib.import_module(f"{__name__}.{info.name}")
    return out
