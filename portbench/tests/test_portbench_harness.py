"""The harness on the CPU at a tiny size: its result line, its files found
by name, the traced window and the call recorded after it, and its refusal
to run without a card."""

import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from portbench import run as run_mod
from portbench.harness import core

REPO = core.REPO
TINY_ENHANCE = dict(batch=2, image_hw=32, distinct_images=4, sample=3, warmup_calls=1,
                    trace_start_s=0.1, trace_seconds=0.3)


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_run(workload: str, trace: bool, traffic_kw: dict, config_kw: dict, seconds=0.8,
             root=None, bench=None, seed=3_000_000_019):
    bench = bench or core.benchmark()
    c = core.cell(bench, workload)
    root = root or core.ROOT
    config = dict(core.config_file(bench, c["config"], os.path.dirname(root)), **config_kw)
    traffic = dict(core.traffic_file(c["traffic"], root), **traffic_kw)
    out, err = io.StringIO(), io.StringIO()
    rc = run_mod.run_cell(workload, seed, seconds, trace, torch.device("cpu"),
                          time.perf_counter(), bench=bench, config=config, traffic=traffic,
                          root=root, out=out, err=err)
    return rc, out.getvalue().strip().splitlines()[-1], err.getvalue()


def numbers(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from numbers(v)
    elif isinstance(obj, list):
        for v in obj:
            yield from numbers(v)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield obj


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(trace):
    rc, line, err = tiny_run("g32_enhance512_b16", trace, TINY_ENHANCE, {"g_conv_dim": 8})
    assert rc == 0
    res = json.loads(line)
    assert list(res)[-1] == "limits"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert all(math.isfinite(x) for x in numbers(res))
    want = {"fwd_busy_ms.enhance", "memcpy_ms.enhance", "idle_share.enhance"} if trace else \
        {"enhance_img_per_s", "setup_s"}
    assert want <= set(res["metrics"])  # mfu and the roofline have no CPU peak: left out
    assert ("breakdown" in res) == trace and ("busy_s" in res["device"]) == trace
    assert "worst_image_mse" in err.strip().splitlines()[-1]  # the compared numbers last


def test_new_files_found_by_name(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell's limits
    added as new files (and entries) run with no existing file edited."""
    root = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "layer_metrics"):
        shutil.copytree(os.path.join(core.ROOT, d), root / d)
    cfg = dict(core.load_json(os.path.join(core.ROOT, "configs", "uegan_g32.json")),
               name="uegan_g8", g_conv_dim=8)
    (root / "configs" / "uegan_g8.json").write_text(json.dumps(cfg))
    traffic = dict(core.traffic_file("enhance"), **TINY_ENHANCE)
    (root / "traffic" / "enhance_tiny.json").write_text(json.dumps(traffic))
    (root / "limits" / "g8_enhance_tiny.json").write_text(
        json.dumps({"worst_image_mse": {"limit": 1e6}}))
    (root / "layer_metrics" / "calls_seen.enhance.py").write_text(
        "def read(t, ctx):\n    return float(ctx['units']['calls'])\n")
    bench = core.benchmark()
    bench["configs"].append({"name": "uegan_g8", "source": "x", "reduced": ["g_conv_dim"],
                             "file": "portbench/configs/uegan_g8.json", "why": "test"})
    bench["workloads"].append({"name": "g8_enhance_tiny", "config": "uegan_g8",
                               "traffic": "enhance_tiny", "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("g8_enhance_tiny")
    bench["per_layer"].append({"name": "calls_seen.enhance", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "test",
                               "moves": "enhance_img_per_s", "workloads": ["g8_enhance_tiny"]})
    rc, line, _ = tiny_run("g8_enhance_tiny", True, {}, {}, root=str(root), bench=bench)
    res = json.loads(line)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["calls_seen.enhance"]["value"] >= 1


def test_trace_window_and_the_recorded_call():
    """The window keeps the drivers' spans and the calls started in it; the
    program's ops and shapes come from one call after it."""
    from portbench.harness.trace import Tracer

    tr = Tracer(True)
    run = core.Run("w", {}, {"trace_start_s": 0.05, "trace_seconds": 0.1}, {}, 1, 0.3, tr,
                   time.perf_counter(), torch.device("cpu"))
    seen = []

    def step(k):
        seen.append(k)
        with tr.span("work"):
            torch.ones((64, 64)).matmul(torch.ones((64, 64)))
            time.sleep(0.01)

    calls, window_s, traced = core.closed_loop(run, step, lambda: None)
    t = tr.trace
    assert 0 < traced == t.calls < calls and window_s >= 0.3
    assert seen[-1] == calls  # the recorded call comes after the window's calls
    assert t.outside[0] == calls - traced and 0 < t.outside[1] < window_s
    assert t.spans and all(s.name == "work" for s in t.spans)
    assert t.label(t.spans[0].start + 1e-4) == "work"
    mm = [op for op in t.call_ops if op.name == "aten::mm"]
    assert mm and list(mm[0].shapes[0]) == [64, 64]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, os.path.join(REPO, "portbench", "run.py"),
                        "--workload", "g32_enhance512_b16", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr
