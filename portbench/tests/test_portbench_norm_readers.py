"""The norm layers' count and readers (``counts/norm_layers.py``,
``layer_metrics/norm_*.train.py``, ``host_norm_ms.train``): the bytes a
step of the cell ``g32inbn_train256`` must move (about 2.05 GB), and each
reader on a hand-built traced window against the value worked out by hand,
and None where the window holds no norm kernel or span (a parent tree)."""

import pytest

from portbench.counts import norm_layers
from portbench.harness import core
from portbench.harness.trace import Interval, Trace
from portbench.tests.test_portbench_spans import records
from uegan_tpu_torch.utils import spans

H100 = "NVIDIA H100 80GB HBM3"


def cell_ctx(steps: int) -> dict:
    bench = core.benchmark()
    c = core.cell(bench, "g32inbn_train256")
    return {"units": {"steps": steps, "pairs": 10 * steps},
            "config": core.config_file(bench, c["config"]),
            "traffic": core.traffic_file(c["traffic"]), "kind": H100}


def test_step_bytes_and_launches():
    ctx = cell_ctx(1)
    assert norm_layers.step_bytes(ctx["config"], ctx["traffic"]) == pytest.approx(2.05e9,
                                                                                  rel=0.01)
    fwd, bwd = norm_layers.launches(32, 32, 256, 10)
    assert (len(fwd), len(bwd)) == (43, 38)
    g, _ = norm_layers.maps(32, 32, 256, 10)
    assert sum(n * c * h * w for n, c, h, w in g) == 10 * 7_995_392


def test_readers_on_a_hand_built_window(monkeypatch):
    busy = core.layer_reader("norm_busy_ms.train")
    roof = core.layer_reader("norm_roofline.train")
    host = core.layer_reader("host_norm_ms.train")
    ctx = cell_ctx(2)
    t = Trace(10.0, 11.0, kernels=[Interval("void norm_act_nhwc_stats_kernel<bf16, 8>", 10.1,
                                            10.1015),
                                   Interval("void norm_act_nhwc_bwd_apply_kernel<bf16, 8>", 10.2,
                                            10.2025),
                                   Interval("cudnn conv", 10.3, 10.4)])
    assert busy(t, ctx) == pytest.approx(2.0)  # 4 ms of norm kernels over 2 steps
    bound = norm_layers.step_bytes(ctx["config"], ctx["traffic"]) * 2 / 3.35e12
    assert roof(t, ctx) == pytest.approx(100 * bound / 0.004)
    none = Trace(10.0, 11.0, kernels=[Interval("cudnn conv", 10.3, 10.4)])
    assert busy(none, ctx) is None and roof(none, ctx) is None

    sp = records((("train.step", 10.1, 10.4, [("norm.forward", 10.15, 10.16, [])]), 0.0),
                 (("train.step", 10.5, 10.8, [("norm.forward", 10.55, 10.58, [])]), 0.0),
                 (("norm.backward", 10.6, 10.61, []), 0.0))
    monkeypatch.setattr(spans, "recorded", lambda *a: sp)
    assert host(t, ctx) == pytest.approx((10 + 30 + 10) / 2)
    monkeypatch.setattr(spans, "recorded", lambda *a: [])
    assert host(t, ctx) is None
