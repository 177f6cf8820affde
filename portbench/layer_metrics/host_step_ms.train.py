"""Host ms a train step spends in the program's ``train.step`` span: the
host's cost to launch a step (the device's is ``step_busy_ms.train``;
harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "train.step", {"train.step"})
