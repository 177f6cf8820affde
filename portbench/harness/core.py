"""What every cell's run shares: the cell's files found by name, the run's
context handed to a driver, the comparison against limits, and the result
line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``)
and a traffic mix (``traffic/<traffic>.json``).  The traffic file names its
``driver`` (``drivers/<driver>.py``), the general code that runs that kind
of traffic from the file's parameters.  Each per-layer metric is read by
``layer_metrics/<metric>.py``, and each cell's correctness limits are in
``limits/<workload>.json``.  A later cell, configuration, mix or metric is
new files and new entries, with no file here edited.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # portbench/
REPO = os.path.dirname(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "uegan_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(repo: str = REPO) -> dict:
    return load_json(os.path.join(repo, "BENCHMARK.json"))


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, repo: str = REPO) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(repo, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "traffic", f"{name}.json"))


def limits_file(workload: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "limits", f"{workload}.json"))


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def layer_reader(metric: str, root: str = ROOT) -> Callable:
    """``read`` of ``layer_metrics/<metric>.py`` (a metric's name may hold dots)."""
    path = os.path.join(root, "layer_metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics: those that list the
    cell, and those without a list that every cell reports (end to end) or
    whose moved metric the cell reports (per layer)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", (workload,))]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell's files, the command's arguments, the
    tracer, and the process's start on the host clock."""
    workload: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    tracer: object
    t_process: float
    device: object = None
    control: str = ""  # readings only: the lower-precision path in the program's place

    def mark(self, what: str) -> None:
        """Log a set-up phase's end, in seconds from the process's start, to stderr."""
        import time

        print(f"portbench set-up: {what} at {time.perf_counter() - self.t_process:.3f} s",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""
    setup_s: float
    values: Dict[str, float]  # end-to-end metrics the driver measured, by name
    attempted: int
    failed: int
    checks: Dict[str, float]  # number compared, by its limit's name
    units: Dict[str, float]  # work done inside the traced window (or the window)
    memory_peak_bytes: int


def judge(checks: Dict[str, float], limits: dict) -> List[dict]:
    """Each compared number beside its limit; a number with no limit, or a
    NaN, fails."""
    out = []
    for name, value in checks.items():
        limit = limits.get(name, {}).get("limit")
        ok = limit is not None and value == value and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result_line(correct: bool, outcome: Outcome, metrics: Dict[str, dict], device: dict,
                judged: List[dict], breakdown: Optional[dict] = None) -> str:
    line = {"correct": correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["limits"] = {j["name"]: {"value": j["value"], "limit": j["limit"]} for j in judged}
    return json.dumps(line)


def closed_loop(run: Run, step: Callable[[int], object], sync: Callable[[], None]):
    """Call ``step(k)`` for k = 0, 1, ... back to back until ``run.seconds`` have
    passed, then ``sync()``.  Under tracing, the profiler covers the calls
    started from ``trace_start_s`` into the window for ``trace_seconds``
    (traffic parameters), the trace keeps the calls and host seconds of the
    window outside that part, and after the window one more call records the
    program's ops and shapes.  Returns (calls, window seconds including the
    final sync, calls inside the traced part)."""
    import time

    tr = run.tracer
    ts = run.traffic.get("trace_start_s", 1.0)
    tlen = run.traffic.get("trace_seconds", 2.0)
    t0 = time.perf_counter()
    end = t0 + run.seconds
    k = k_trace = 0
    t_before = t_trace = None
    traced_s = 0.0  # host seconds from before the profiler's start to after its stop

    def stop():
        tr.stop(k - k_trace)
        return time.perf_counter() - t_before

    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if tr.enabled and tr.trace is None and not tr.active and now - t0 >= ts:
            t_before = now
            tr.start()
            k_trace, t_trace = k, time.perf_counter()
        elif tr.active and now - t_trace >= tlen:
            traced_s = stop()
        step(k)
        k += 1
    if tr.active:
        traced_s = stop()
    sync()
    window_s = time.perf_counter() - t0
    if tr.trace is not None:
        tr.trace.outside = (k - tr.trace.calls, window_s - traced_s)
        tr.record_call(lambda: step(k))
        sync()
    return k, window_s, tr.trace.calls if tr.trace is not None else 0
