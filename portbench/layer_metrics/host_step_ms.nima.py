"""Host ms a NIMA train step spends in the program's ``nima.step`` span (the
forward, the backward and Adam issued; the loop's upload and loss read are
spans of their own) (harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "nima.step", {"nima.step"})
