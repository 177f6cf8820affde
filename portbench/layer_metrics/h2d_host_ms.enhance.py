"""Host ms an enhance call spends in the program's ``tester.h2d`` span: the
batch's pad, its pageable copy to the card and ``normalize_u8``
(harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "tester.run", {"tester.h2d"})
