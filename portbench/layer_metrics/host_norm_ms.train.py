"""Host ms a train step spends in the program's ``norm.forward`` and
``norm.backward`` spans: the norm layers' calls, forward (their launches
and allocations) and backward (inside the autograd engine's backward)
(harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "train.step", {"norm.forward", "norm.backward"})
