"""Each cell's control comes out not correct under the cell's own limits, at
a size a CPU test can hold, beside the program at the same size, which
comes out correct: the program's int8_pallas route for the forward cell
(cd 32, 64 px), the reference with float8 conv operands in the program's
place for the train cells (cd 8, 32 px).  On the card, at the cells' own
sizes, ``portbench/readings.py --control ...`` takes the readings the limits
were set from (PERF.md, section 2)."""

import time

import pytest
import torch

from portbench.harness import core
from portbench.harness.trace import Tracer
from portbench.tests.test_portbench_faults import TINY_TRAIN


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def judged(workload, traffic_kw, config_kw, control, seconds=0.5):
    bench = core.benchmark()
    c = core.cell(bench, workload)
    cfg = dict(core.config_file(bench, c["config"]), **config_kw)
    tr = dict(core.traffic_file(c["traffic"]), **traffic_kw)
    r = core.Run(workload, cfg, tr, {}, 1_234_567_891_234, seconds, Tracer(False),
                 time.perf_counter(), torch.device("cpu"), control)
    checks = core.driver(tr["driver"]).run(r).checks
    return all(j["ok"] for j in core.judge(checks, core.limits_file(workload)))


ENHANCE = dict(batch=2, image_hw=64, distinct_images=4, sample=3, warmup_calls=1)


@pytest.mark.parametrize("control", ["", "int8_pallas"])
def test_enhance(control):
    assert judged("g32_enhance512_b16", ENHANCE, {}, control) is (control == "")


@pytest.mark.parametrize("workload", ["g32_train256", "g32sn_train256"])
def test_train_float8(workload):
    tiny = {"g_conv_dim": 8, "d_conv_dim": 8}
    assert judged(workload, TINY_TRAIN, dict(tiny, compute_dtype="float32"), "") is True
    assert judged(workload, TINY_TRAIN, tiny, "fp8") is False
