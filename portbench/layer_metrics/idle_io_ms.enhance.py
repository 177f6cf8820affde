"""Device idle ms an enhance call in the gaps whose middle falls in the
program's ``tester.h2d`` or ``tester.d2h`` span (harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.idle_ms(t, "tester.run",
                                 lambda s, by_id: s.name in ("tester.h2d", "tester.d2h"))
