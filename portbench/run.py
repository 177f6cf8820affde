"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names its configuration and traffic files; the
traffic file names the driver that sets the program up from the seed, warms
the cell's shapes, measures for ``--seconds`` and checks what the timed path
produced against the plain reference (``portbench/reference``).  With
``--trace 1`` part of the window runs under ``torch.profiler`` and the
result carries the cell's per-layer metrics instead of its end-to-end ones.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, and with ``--trace 1``
``breakdown``; ``limits`` last: each compared number beside its limit); the
last lines of standard error repeat the compared numbers.  Without a CUDA
card, or with a module of JAX or of the JAX package loaded, it prints no
result and exits non-zero.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
# a program cache at a fixed path inside the checkout, so later runs hit it
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(REPO, ".portbench_cache", "triton"))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_process: float, bench=None, config=None, traffic=None, limits=None,
             root=None, out=None, err=None) -> int:
    """Run the cell and print its result.  The benchmark's files are found
    under ``root`` (``portbench/`` of this checkout by default), and any of
    them may be given instead (the harness's tests pass small ones).
    Returns the exit code."""
    import torch

    from portbench.harness import core
    from portbench.harness.trace import Tracer

    out, err = out or sys.stdout, err or sys.stderr
    root = root or core.ROOT
    bench = bench or core.benchmark(os.path.dirname(root))
    c = core.cell(bench, workload)
    config = config or core.config_file(bench, c["config"], os.path.dirname(root))
    traffic = traffic or core.traffic_file(c["traffic"], root)
    limits = limits if limits is not None else core.limits_file(workload, root)
    tracer = Tracer(trace)
    tracer.warm()
    run = core.Run(workload, config, traffic, limits, seed, seconds, tracer, t_process, device)
    outcome = core.driver(traffic["driver"]).run(run)
    judged = core.judge(outcome.checks, limits)
    correct = outcome.failed == 0 and all(j["ok"] for j in judged)

    metrics = {}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    breakdown = None
    if not trace:
        for m in core.cell_metrics(bench, workload, "end_to_end"):
            value = outcome.setup_s if m["name"] == "setup_s" else outcome.values.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif tracer.trace is not None:
        t = tracer.trace
        ctx = {"units": outcome.units, "config": config, "traffic": traffic, "kind": dev["kind"]}
        for m in core.cell_metrics(bench, workload, "per_layer"):
            value = core.layer_reader(m["name"], root)(t, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = t.busy_s(), t.window_s
        breakdown = t.breakdown()

    bad = core.forbidden_modules()
    if bad:
        print(f"portbench: modules loaded that the benchmark may not load: {bad}", file=err)
        return 3
    print(f"portbench: {outcome.attempted} attempted, {outcome.failed} failed", file=err)
    for j in judged:  # the compared numbers, last
        print(f"portbench check {j['name']}: {j['value']!r} (limit {j['limit']!r}) "
              f"{'ok' if j['ok'] else 'FAILED'}", file=err)
    print(core.result_line(correct, outcome, metrics, dev, judged, breakdown), file=out)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    from portbench.harness import core

    c = core.cell(core.benchmark(), a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < c["chips"]:
        print(f"portbench: {a.workload} needs {c['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace), torch.device("cuda", 0),
                    T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())
