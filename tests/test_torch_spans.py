"""PyTorch port: the span recorder (uegan_tpu_torch/utils/spans.py) and its
call sites on the CPU at tiny sizes.  Spans record only while the recorder
is on or a torch profiler runs, nest per thread, share the profiler's
clock, and never change what the train step or the Tester computes."""

import copy
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from uegan_tpu_torch.config import Config
from uegan_tpu_torch.train.state import create_train_state
from uegan_tpu_torch.train.step import make_train_step
from uegan_tpu_torch.train import tester as tester_mod
from uegan_tpu_torch.train.trainer import step_timing
from uegan_tpu_torch.utils import spans

FLAGS = dict(g_conv_dim=8, d_conv_dim=8, image_size=48, resize_size=32, train_batch_size=2,
             pool_size=4, compute_dtype="float32", packed_train=False, g_ema_decay=0.999)


@pytest.fixture(autouse=True)
def recorder_off():
    """Each test starts with the recorder off and leaves it as it found it;
    one torch thread (the suite runs several workers on a few cores)."""
    was, n = spans.enabled(), torch.get_num_threads()
    spans.enable(False)
    torch.set_num_threads(1)
    yield
    spans.enable(was)
    torch.set_num_threads(n)


def _nest(names):
    with spans.span(names[0]):
        if names[1:]:
            _nest(names[1:])


def _since(t0):
    return spans.recorded(t0, time.time_ns())


def test_off_records_nothing():
    t0 = time.time_ns()
    _nest(["a", "b", "c"])
    assert _since(t0) == []


@pytest.mark.parametrize("how", ["enable", "profiler"])
def test_ids_nest_per_thread(how):
    """Two threads each hold an outer span open while the other opens its
    own: each inner span's parent and root are its own thread's outer."""
    both_open = threading.Barrier(2, timeout=10)

    def work(tag):
        with spans.span(f"{tag}.outer"):
            both_open.wait()
            _nest([f"{tag}.inner", f"{tag}.leaf"])

    t0 = time.time_ns()
    prof = profile(activities=[ProfilerActivity.CPU]) if how == "profiler" else None
    if prof is not None:
        prof.__enter__()
    else:
        spans.enable()
    try:
        threads = [threading.Thread(target=work, args=(tag,)) for tag in ("x", "y")]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert not any(th.is_alive() for th in threads)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        spans.enable(False)
    got = {s.name: s for s in _since(t0)}
    assert len(got) == 6
    for tag in ("x", "y"):
        outer, inner, leaf = (got[f"{tag}.{n}"] for n in ("outer", "inner", "leaf"))
        assert outer.parent is None and outer.root == outer.id
        assert inner.parent == outer.id and leaf.parent == inner.id
        assert inner.root == leaf.root == outer.id
        assert outer.thread == inner.thread == leaf.thread
        assert outer.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns \
            <= inner.end_ns <= outer.end_ns
    assert got["x.outer"].thread != got["y.outer"].thread


def test_many_threads_lose_no_span():
    """More threads than cores, switching often: every span lands in the
    ring once, with its own thread's parent."""
    import sys

    n_threads, n_each = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()
    t0 = time.time_ns()
    try:
        def work():
            for _ in range(n_each):
                _nest(["outer", "inner"])

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    finally:
        spans.enable(False)
        sys.setswitchinterval(old)
    got = _since(t0)
    assert len(got) == 2 * n_threads * n_each
    by_id = {s.id: s for s in got}
    assert len(by_id) == len(got)
    for s in got:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer" and by_id[s.parent].thread == s.thread


def test_ring_is_bounded():
    spans.enable()
    t0 = time.time_ns()
    try:
        for _ in range(spans.CAPACITY + 5):
            with spans.span("s"):
                pass
        with spans.span("newest"):
            pass
    finally:
        spans.enable(False)
    got = _since(t0)
    assert len(got) == spans.CAPACITY and got[-1].name == "newest"


def test_one_clock_with_the_profiler():
    """A span around a CPU op contains that op's profiler record."""
    a = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with spans.span("mm"):
            a.mm(a)
    s, = [s for s in _since(t0) if s.name == "mm"]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert s.start_ns <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= s.end_ns


# (span, parent) of one step, in order of start
FUSED_TREE = [("train.step", None), ("train.g_forward", "train.step"),
              ("train.pool", "train.step"), ("train.d_update", "train.step"),
              ("train.d_forward", "train.d_update"), ("train.d_optim", "train.d_update"),
              ("train.d_backward", "train.d_update"), ("train.d_optim", "train.d_update"),
              ("train.g_update", "train.step"), ("train.g_losses", "train.g_update"),
              ("train.g_optim", "train.g_update"), ("train.g_backward", "train.g_update"),
              ("train.g_optim", "train.g_update"), ("train.ema", "train.step")]
SN_TREE = FUSED_TREE[:9] + [("train.g_forward_exp", "train.g_update")] + FUSED_TREE[9:]


def _tree(records):
    by_id = {s.id: s for s in records}
    assert len({s.root for s in records}) == 1
    return [(s.name, by_id[s.parent].name if s.parent else None) for s in records]


@pytest.mark.parametrize("g_use_sn,tree", [(False, FUSED_TREE), (True, SN_TREE)],
                         ids=["fused", "sn"])
def test_train_step_spans_and_bit_equal(g_use_sn, tree):
    first = create_train_state(Config(**FLAGS, g_use_sn=g_use_sn), "cpu", (32, 32), 2)
    states = {False: first, True: copy.deepcopy(first)}
    gen = torch.Generator().manual_seed(5)
    raw, exp = (torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1 for _ in range(2))
    out = {}
    for on, state in states.items():
        step = make_train_step(state)
        spans.enable(on)
        t0 = time.time_ns()
        try:
            metrics, _ = step(raw, exp)
        finally:
            spans.enable(False)
        out[on] = ({k: v.clone() for k, v in metrics.items()},
                   {f"{net}:{k}": v.detach().clone()
                    for net, m in (("G", state.g), ("D", state.d))
                    for k, v in m.state_dict().items()},
                   _since(t0))
    assert out[False][2] == []
    assert _tree(out[True][2]) == tree
    for k, v in out[False][0].items():
        assert torch.equal(v, out[True][0][k]), k
    for k, v in out[False][1].items():
        assert torch.equal(v, out[True][1][k]), k


def test_tester_spans_and_bit_equal(tmp_path):
    args = Config(mode="test", g_conv_dim=8, test_img_size=32, val_batch_size=2,
                  compute_dtype="float32", is_test_nima=False, is_print_network=False,
                  save_root_dir=str(tmp_path)).validate()
    tester = tester_mod.Tester({}, args, torch.device("cpu"))
    x = np.random.default_rng(2).integers(0, 256, (1, 32, 32, 3), dtype=np.uint8)  # padded to 2
    off = tester.enhance_u8(x)
    spans.enable()
    t0 = time.time_ns()
    try:
        on = tester.enhance_u8(x)
    finally:
        spans.enable(False)
    assert off.shape == (1, 32, 32, 3) and np.array_equal(off, on)
    assert _tree(_since(t0)) == [("tester.run", None), ("tester.h2d", "tester.run"),
                                 ("tester.forward", "tester.run"), ("tester.d2h", "tester.run")]


def test_step_timing_skips_two_steps_and_sums_per_step():
    """JAX's keys over ``train.step`` without the first two steps, and each
    other span's p50 a step, its spans within a step summed."""
    recs, t, ids = [], 0, iter(range(1, 1000))
    for k, ms in enumerate([90, 80, 10, 20, 30]):
        fetch, root = next(ids), next(ids)  # the fetch is a root of its own
        recs.append(spans.Span("trainer.fetch", t, t + 1_000_000, fetch, None, fetch, 1))
        recs.append(spans.Span("train.step", t, t + ms * 1_000_000, root, None, root, 1))
        for _ in range(2):  # two optimizer spans a step, (k + 1) ms each
            recs.append(spans.Span("train.g_optim", t, t + (k + 1) * 1_000_000, next(ids), root,
                                   root, 1))
        t += 100_000_000
    got = step_timing(recs)
    assert got["mean_s"] == pytest.approx(0.02) and got["p50_s"] == pytest.approx(0.02)
    assert got["p90_s"] == pytest.approx(0.028) and got["steps_per_s"] == pytest.approx(50.0)
    assert got["train.g_optim_p50_ms"] == pytest.approx(8.0)  # 2 x 4 ms, steps 3-5
    assert got["trainer.fetch_p50_ms"] == pytest.approx(1.0)
    assert step_timing([]) == {}
