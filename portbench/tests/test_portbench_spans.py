"""The per-layer readers of the program's spans
(``harness/program_spans.py``, ``layer_metrics/*``): each on a hand-built
traced window with hand-placed program spans gives the value worked out by
hand, and None with no spans or no recorder (a tree without it); on the
CPU at a tiny size the traced runs of both kinds of cell carry them."""

import json
import sys

import pytest

from portbench.harness import core
from portbench.harness.trace import Interval, Trace
from portbench.tests.test_portbench_faults import TINY_TRAIN
from portbench.tests.test_portbench_harness import TINY_ENHANCE, tiny_run
from uegan_tpu_torch.utils import spans

ENHANCE = ("h2d_host_ms.enhance", "fwd_issue_ms.enhance", "idle_io_ms.enhance")
TRAIN = ("host_step_ms.train", "host_backward_ms.train", "host_optim_ms.train",
         "idle_fwd_ms.train")


def tree(node, shift=0.0, parent=None, root=None, out=None, ids=None):
    """(name, start s, end s, [children]) -> spans.Span records, ``shift`` s later."""
    out = [] if out is None else out
    ids = ids if ids is not None else iter(range(len(out) + 1, 10_000))
    name, a, b, kids = node
    sid = next(ids)
    out.append(spans.Span(name, round((a + shift) * 1e9), round((b + shift) * 1e9), sid,
                          parent, root or sid, 7))
    for kid in kids:
        tree(kid, shift, sid, root or sid, out, ids)
    return out


def records(*roots):
    out, ids = [], iter(range(1, 10_000))
    for node, shift in roots:
        tree(node, shift, out=out, ids=ids)
    return sorted(out, key=lambda s: s.start_ns)


def window(start, end, kernels=(), copies=()):
    return Trace(start, end, kernels=[Interval("k", a, b) for a, b in kernels],
                 copies=[Interval("Memcpy HtoD", a, b) for a, b in copies])


def enhance_case():
    """Two calls; device idle in h2d 30 ms (call 1), d2h 20 + 10 ms, and
    in the forward and outside any call (not counted)."""
    def call(h2d, fwd, d2h):
        return ("tester.run", h2d[0], d2h[1], [("tester.h2d", *h2d, []),
                                               ("tester.forward", *fwd, []),
                                               ("tester.d2h", *d2h, [])])
    sp = records((call((10.10, 10.15), (10.15, 10.20), (10.20, 10.40)), 0.0),
                 (call((10.50, 10.56), (10.56, 10.60), (10.60, 10.80)), 0.0),
                 (call((9.0, 9.1), (9.1, 9.2), (9.2, 9.5)), 0.0))  # before the window
    t = window(10.0, 11.0, kernels=[(10.16, 10.30), (10.52, 10.57), (10.59, 10.65),
                                    (10.66, 10.70)],
               copies=[(10.11, 10.13), (10.32, 10.33)])
    return t, sp, {"h2d_host_ms.enhance": 55.0, "fwd_issue_ms.enhance": 45.0,
                   "idle_io_ms.enhance": 30.0}


def train_case():
    """Two steps 1 s apart; a step's device idle falls in train.step itself
    (20 ms), train.g_forward (50), train.g_losses (30): counted; and in
    train.d_backward and train.g_optim: not counted."""
    step = ("train.step", 100.05, 100.90, [
        ("train.g_forward", 100.10, 100.30, []),
        ("train.d_update", 100.30, 100.60, [
            ("train.d_forward", 100.30, 100.40, []), ("train.d_optim", 100.40, 100.41, []),
            ("train.d_backward", 100.41, 100.55, []), ("train.d_optim", 100.55, 100.60, [])]),
        ("train.g_update", 100.60, 100.90, [
            ("train.g_losses", 100.60, 100.70, []), ("train.g_optim", 100.70, 100.71, []),
            ("train.g_backward", 100.71, 100.85, []), ("train.g_optim", 100.85, 100.90, [])])])
    ks = [(100.0, 100.06), (100.08, 100.15), (100.2, 100.45), (100.5, 100.65),
          (100.68, 100.86), (100.88, 100.95)]
    t = window(100.0, 102.0, kernels=ks + [(a + 1.0, b + 1.0) for a, b in ks])
    return t, records((step, 0.0), (step, 1.0)), {
        "host_step_ms.train": 850.0, "host_backward_ms.train": 280.0,
        "host_optim_ms.train": 120.0, "idle_fwd_ms.train": 100.0}


@pytest.mark.parametrize("case", [enhance_case, train_case], ids=["enhance", "train"])
def test_readers_by_hand(monkeypatch, case):
    t, sp, want = case()
    monkeypatch.setattr(spans, "recorded", lambda *a, **k: list(sp))
    for metric, value in want.items():
        assert core.layer_reader(metric)(t, {}) == pytest.approx(value, abs=1e-6), metric


@pytest.mark.parametrize("case", [enhance_case, train_case], ids=["enhance", "train"])
def test_readers_without_spans(monkeypatch, case):
    t, sp, want = case()
    monkeypatch.setattr(spans, "recorded", lambda *a, **k: [])
    assert all(core.layer_reader(m)(t, {}) is None for m in want)
    outside = window(t.start + 50, t.end + 50, kernels=[(t.start + 50, t.start + 50.1)])
    monkeypatch.setattr(spans, "recorded", lambda *a, **k: list(sp))
    assert all(core.layer_reader(m)(outside, {}) is None for m in want)
    import uegan_tpu_torch.utils

    monkeypatch.delattr(uegan_tpu_torch.utils, "spans")  # a tree without the recorder
    monkeypatch.setitem(sys.modules, "uegan_tpu_torch.utils.spans", None)
    assert all(core.layer_reader(m)(t, {}) is None for m in want)


@pytest.mark.parametrize("workload,traffic,config,metrics", [
    ("g32_enhance512_b16", TINY_ENHANCE, {"g_conv_dim": 8}, ENHANCE),
    ("g32_train256", TINY_TRAIN, {"g_conv_dim": 8, "d_conv_dim": 8,
                                  "compute_dtype": "float32"}, TRAIN)], ids=["enhance", "train"])
def test_traced_tiny_run_reads_the_spans(workload, traffic, config, metrics):
    # the traced part opens at the first call: a CPU step on a loaded host
    # can outlast the whole window
    rc, line, _ = tiny_run(workload, True, dict(traffic, trace_start_s=0.0), config)
    res = json.loads(line)
    assert rc == 0 and res["correct"] is True and "breakdown" in res
    host = [m for m in metrics if not m.startswith("idle_")]
    assert all(res["metrics"][m]["value"] > 0 for m in host)
