"""A cache of per-shape tensor constants that no trace can fill.

The packed and strip forwards make small constant tensors once per shape
(index rows, channel masks, resize matrices) and keep them in module-level
caches.  Under ``torch.export`` (tools/export_model.py) or ``torch.compile``
the forward runs on fake tensors, and a constant made there is a fake
tensor: kept in the cache, it would reach every later eager call in the
process, which would then compute on a tensor with no data.  So while a
trace runs, :func:`tensor_cache` hands out what an eager call cached (a
real tensor on the device, which the trace records as a constant of the
program) but keeps nothing it makes: a constant first made under the trace
is made anew at each call and recorded there.
"""

from __future__ import annotations

import collections
import functools
import threading

import torch


def tracing() -> bool:
    """Whether a compiler or exporter is tracing: dynamo runs, or a fake
    tensor mode is active (``torch.export`` traces under one)."""
    if torch.compiler.is_compiling():
        return True
    from torch._guards import detect_fake_mode

    return detect_fake_mode() is not None


def tensor_cache(maxsize: int):
    """A least-recently-used cache of ``maxsize`` entries (None: unbounded)
    for a function of hashable arguments whose result holds tensors; read
    but never filled while :func:`tracing`.  Thread-safe, as
    ``functools.lru_cache`` is (the server calls forwards from threads)."""
    def deco(fn):
        store: collections.OrderedDict = collections.OrderedDict()
        lock = threading.Lock()

        @functools.wraps(fn)
        def wrapper(*args):
            with lock:
                if args in store:
                    store.move_to_end(args)
                    return store[args]
            value = fn(*args)
            if not tracing():
                with lock:
                    store[args] = value
                    while maxsize is not None and len(store) > maxsize:
                        store.popitem(last=False)
            return value

        def cache_clear() -> None:
            with lock:
                store.clear()

        wrapper.cache_clear = cache_clear
        return wrapper

    return deco
