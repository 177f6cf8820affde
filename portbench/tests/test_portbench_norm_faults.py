"""The cell ``g32inbn_train256`` (instance norm in G, batch norm in D) on the
CPU at a tiny size (cd 8, 32 px, batch 4) under its own limits
(``portbench/limits/g32inbn_train256.json``): the program in float32 comes
out correct; each control the limits were set against, the reference
itself in the program's place with it planted, reads over a limit (fp8,
the float8 conv operands; half_batch, the step seeing half its rows;
fused_d, the D update's three inputs through each norm as one batch of 3B;
stats_once, the running statistics moved once a step with the biased
variance); and the program comes out not correct with its norm layers'
running statistics left in place (which only ``stats_leaf`` can see), with
its optimizers taking no step, and with its step seeing half its rows."""

import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.trace import Tracer
from portbench.tests.test_portbench_faults import TINY_TRAIN, correct

WORKLOAD = "g32inbn_train256"
TINY = {"g_conv_dim": 8, "d_conv_dim": 8}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def control_checks(control: str) -> dict:
    bench = core.benchmark()
    c = core.cell(bench, WORKLOAD)
    cfg = dict(core.config_file(bench, c["config"]), **TINY)
    tr = dict(core.traffic_file(c["traffic"]), **TINY_TRAIN)
    r = core.Run(WORKLOAD, cfg, tr, {}, 2_345_678_901_234, 0.5, Tracer(False),
                 time.perf_counter(), torch.device("cpu"), control)
    return core.driver(tr["driver"]).run(r).checks


@pytest.mark.parametrize("control", ["fp8", "half_batch", "fused_d", "stats_once"])
def test_each_control_reads_over_a_limit(control):
    judged = core.judge(control_checks(control), core.limits_file(WORKLOAD))
    assert {j["name"] for j in judged} == {"loss1_rel", "grad_leaf", "change_med", "stats_leaf"}
    assert not all(j["ok"] for j in judged), judged


@pytest.mark.parametrize("fault", [None, "stats_left", "unchanged", "half_batch"])
def test_program(monkeypatch, fault):
    import uegan_tpu_torch.train.step as step_mod

    if fault == "stats_left":  # the norm layers normalize but move no running statistic
        from uegan_tpu_torch.models import blocks

        real = blocks.norm_act
        monkeypatch.setattr(blocks, "norm_act",
                            lambda x, w, b, rm, rv, *a, **k: real(x, w, b, None, None, *a, **k))
    elif fault == "unchanged":  # the optimizers take no step
        monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    elif fault == "half_batch":  # the step sees only the first half of its rows
        real_make = step_mod.make_train_step

        def make(state):
            step = real_make(state)
            return lambda raw, exp: step(raw[:raw.shape[0] // 2], exp[:exp.shape[0] // 2])
        monkeypatch.setattr(step_mod, "make_train_step", make)
    ok = correct(WORKLOAD, TINY_TRAIN, dict(TINY, compute_dtype="float32"))
    assert ok is (fault is None)
