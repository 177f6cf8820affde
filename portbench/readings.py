"""Readings for a cell's correctness limits: the numbers a cell compares, for
many seeds in one process, from the program or from a control in its place.

    python3 portbench/readings.py --workload <name> --seeds 11,12,13 --seconds 2
        [--control int8_pallas | fp8 | half_batch]

Without ``--control`` each seed runs the cell's own driver (set-up, a window
of ``--seconds``, the check) and prints the numbers it compared.  With it,
the lower-precision path stands in for the program: the program's own
``int8_pallas`` route for the enhancement cell, the reference in
float8 (``fp8``) for the train cells, or, for the train cells, the
reference with a planted fault (``half_batch``: the step sees half its
rows).  One JSON line a seed; the benchmark's runs never call this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", default="")
    a = p.parse_args(argv)

    import torch

    from portbench.harness import core
    from portbench.harness.trace import Tracer

    bench = core.benchmark()
    c = core.cell(bench, a.workload)
    config = core.config_file(bench, c["config"])
    traffic = core.traffic_file(c["traffic"])
    drv = core.driver(traffic["driver"])
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        r = core.Run(a.workload, config, traffic, {}, seed, a.seconds, Tracer(False), t,
                     torch.device("cuda", 0), a.control)
        o = drv.run(r)
        print(json.dumps({"workload": a.workload, "seed": seed, "control": a.control,
                          "checks": o.checks, "values": o.values, "attempted": o.attempted,
                          "failed": o.failed, "units": o.units, "setup_s": o.setup_s,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
