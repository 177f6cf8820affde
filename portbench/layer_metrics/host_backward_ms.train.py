"""Host ms a train step spends in the program's ``train.d_backward`` and
``train.g_backward`` spans: the two ``backward`` calls
(harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "train.step", {"train.d_backward", "train.g_backward"})
