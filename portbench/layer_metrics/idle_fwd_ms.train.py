"""Device idle ms a train step in the gaps whose middle falls inside the
program's ``train.step`` but outside its backward and optimizer spans: what
the Python-launched forwards, losses, pool and EMA leave idle
(harness/program_spans.py)."""
from portbench.harness import program_spans

OUTSIDE = ("train.d_backward", "train.g_backward", "train.d_optim", "train.g_optim")


def counts(s, by_id):
    root = by_id.get(s.root)
    return root is not None and root.name == "train.step" and s.name not in OUTSIDE


def read(t, ctx):
    return program_spans.idle_ms(t, "train.step", counts)
