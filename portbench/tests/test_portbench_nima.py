"""The cell ``nima_train224_b128`` (NIMA's train step, 53 train-mode
BatchNorms): its counts (``counts/nima.py``: 9.06 GB of norm traffic and
1.874 GFLOP an example at B=128, 224 px), its eight readers on a hand-built
traced window (and None where the window holds no norm kernel or span, as
on a parent tree), and its driver on the CPU at a tiny size (64 px, batch
4) under its own limits (``portbench/limits/nima_train224_b128.json``): the
program in float32 comes out correct, and each control the limits were set
against, the reference itself in the program's place with it planted,
reads over a limit (fp8, the float8 conv operands; half_batch, the step
seeing half its rows; stats_left, the running statistics left in place;
no_dropout, the dropout skipped), and so does the program with those
faults planted or with Adam taking no step."""

import json
import time

import pytest
import torch

from portbench.counts import nima
from portbench.harness import core
from portbench.harness.trace import Interval, Trace, Tracer
from portbench.tests.test_portbench_harness import tiny_run
from portbench.tests.test_portbench_spans import records
from uegan_tpu_torch.utils import spans

WORKLOAD = "nima_train224_b128"
H100 = "NVIDIA H100 80GB HBM3"
TINY = dict(batch=4, image_hw=64, examples=8, trace_start_s=0.1, trace_seconds=0.3)
READERS = ("mfu.nima", "step_busy_ms.nima", "idle_share.nima", "host_step_ms.nima",
           "norm_busy_ms.nima", "norm_roofline.nima", "h2d_host_ms.nima", "launches.nima")


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def cell_ctx(steps: int) -> dict:
    bench = core.benchmark()
    c = core.cell(bench, WORKLOAD)
    return {"units": {"steps": steps, "pairs": 128 * steps},
            "config": core.config_file(bench, c["config"]),
            "traffic": core.traffic_file(c["traffic"]), "kind": H100}


def test_counts():
    """53 BN maps (7,079,520 elements an image), 9.06 GB a step for their
    forward and backward norm calls in bf16, and 1.874 GFLOP an example
    (0.3124 G multiply-adds forward, x 2, x 3)."""
    ctx = cell_ctx(1)
    maps = nima.bn_maps(224, 128)
    assert len(maps) == 53 and maps[0] == (128, 32, 112, 112) and maps[-1] == (128, 1280, 7, 7)
    assert sum(c * h * w for _, c, h, w in maps) == 7_079_520
    assert nima.norm_step_bytes(ctx["config"], ctx["traffic"]) == pytest.approx(9.06e9, rel=1e-3)
    assert nima.train_flops_per_pair(224) == pytest.approx(1.874e9, rel=1e-3)


def test_cell_lists_its_readers():
    bench = core.benchmark()
    names = {m["name"] for m in core.cell_metrics(bench, WORKLOAD, "per_layer")}
    assert names == set(READERS)
    assert {m["name"] for m in core.cell_metrics(bench, WORKLOAD, "end_to_end")} \
        == {"train_pairs_per_s", "setup_s"}


def test_readers_on_a_hand_built_window(monkeypatch):
    """Two steps in a 1 s window: 4 ms of norm kernels and 40 ms busy in
    all; outside the traced part 10 calls in 0.5 s; 412 kernels in the step
    recorded after the window."""
    read = {m: core.layer_reader(m) for m in READERS}
    ctx = cell_ctx(2)
    t = Trace(10.0, 11.0, kernels=[
        Interval("void norm_act_nhwc_stats_kernel<bf16, 8>", 10.1, 10.1015),
        Interval("void norm_act_nhwc_bwd_apply_kernel<bf16, 8>", 10.2, 10.2025),
        Interval("cudnn conv", 10.3, 10.336)], calls=2, outside=(10, 0.5), call_kernels=412)
    assert read["norm_busy_ms.nima"](t, ctx) == pytest.approx(2.0)
    assert read["launches.nima"](t, ctx) == 412.0
    assert read["step_busy_ms.nima"](t, ctx) == pytest.approx(20.0)
    bound = nima.norm_step_bytes(ctx["config"], ctx["traffic"]) * 2 / 3.35e12
    assert read["norm_roofline.nima"](t, ctx) == pytest.approx(100 * bound / 0.004)
    assert read["idle_share.nima"](t, ctx) == pytest.approx(100 * (1 - 0.020 / 0.050))
    assert read["mfu.nima"](t, ctx) == pytest.approx(
        100 * nima.train_flops_per_pair(224) * 128 * 10 / 0.5 / 989e12)
    none = Trace(10.0, 11.0, kernels=[Interval("cudnn conv", 10.3, 10.4)], calls=2,
                 outside=(10, 0.5))
    assert read["norm_busy_ms.nima"](none, ctx) is None
    assert read["norm_roofline.nima"](none, ctx) is None
    assert read["launches.nima"](none, ctx) is None

    sp = records((("nima.to_device", 10.09, 10.1, []), 0.0),
                 (("nima.step", 10.1, 10.13, [("nima.forward", 10.1, 10.11, [])]), 0.0),
                 (("nima.to_device", 10.485, 10.5, []), 0.0),
                 (("nima.step", 10.5, 10.52, [("nima.replay", 10.5, 10.51, [])]), 0.0),
                 (("nima.loss_read", 10.6, 10.7, []), 0.0))
    monkeypatch.setattr(spans, "recorded", lambda *a: sp)
    assert read["host_step_ms.nima"](t, ctx) == pytest.approx((30 + 20) / 2)
    assert read["h2d_host_ms.nima"](t, ctx) == pytest.approx((10 + 15) / 2)
    monkeypatch.setattr(spans, "recorded", lambda *a: [])
    assert read["host_step_ms.nima"](t, ctx) is None
    assert read["h2d_host_ms.nima"](t, ctx) is None


def control_checks(control: str) -> dict:
    bench = core.benchmark()
    c = core.cell(bench, WORKLOAD)
    cfg = core.config_file(bench, c["config"])
    tr = dict(core.traffic_file(c["traffic"]), **TINY)
    r = core.Run(WORKLOAD, cfg, tr, {}, 2_345_678_901_234, 0.5, Tracer(False),
                 time.perf_counter(), torch.device("cpu"), control)
    return core.driver(tr["driver"]).run(r).checks


@pytest.mark.parametrize("control", ["fp8", "half_batch", "stats_left", "no_dropout"])
def test_each_control_reads_over_a_limit(control):
    limits = core.limits_file(WORKLOAD)
    judged = core.judge(control_checks(control), limits)
    assert {j["name"] for j in judged} == set(limits)
    assert not all(j["ok"] for j in judged), judged


@pytest.mark.parametrize("fault", [None, "stats_left", "unchanged", "half_batch"])
def test_program(monkeypatch, fault):
    """The float32 program comes out correct, and not correct with its BNs'
    running statistics left in place, with Adam taking no step, or with its
    step seeing half its rows."""
    import uegan_tpu_torch.models.nima as nima_mod
    import uegan_tpu_torch.nima_train.train as train_mod

    if fault == "stats_left":
        real = nima_mod.norm_act
        monkeypatch.setattr(nima_mod, "norm_act",
                            lambda x, w, b, rm, rv, *a, **k: real(x, w, b, None, None, *a, **k))
    elif fault == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":
        real_body = train_mod.train_batch
        monkeypatch.setattr(train_mod, "train_batch", lambda step, x, t, dev: real_body(
            step, x[:x.shape[0] // 2], t[:t.shape[0] // 2], dev))
    rc, line, err = tiny_run(WORKLOAD, False, TINY, {"compute_dtype": "float32"}, seconds=0.6)
    assert rc == 0
    res = json.loads(line)
    assert res["correct"] is (fault is None), res["limits"]
    assert set(res["metrics"]) == {"train_pairs_per_s", "setup_s"}
