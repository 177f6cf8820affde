"""Host ms an enhance call spends in the program's ``tester.forward`` span:
the host's cost to launch the packed forward and the quantize (the device's
is ``fwd_busy_ms.enhance``; harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "tester.run", {"tester.forward"})
