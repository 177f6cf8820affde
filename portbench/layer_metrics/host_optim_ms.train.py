"""Host ms a train step spends in the program's ``train.d_optim`` and
``train.g_optim`` spans: each optimizer's ``zero_grad`` and ``step``
(harness/program_spans.py)."""
from portbench.harness import program_spans


def read(t, ctx):
    return program_spans.host_ms(t, "train.step", {"train.d_optim", "train.g_optim"})
