"""Host ms a NIMA train step spends in the program's ``nima.to_device`` span:
the batch's pageable copies of images and rating histograms to the card,
which the host waits for (harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "nima.step", {"nima.to_device"})
