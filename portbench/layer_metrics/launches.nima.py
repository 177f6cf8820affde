"""Device kernels a NIMA train step launches: a count of the kernel records
of the step recorded after the window (harness/trace.py:Tracer.record_call),
which runs eagerly there, since that profiler records host ops with their
shapes."""


def read(t, ctx):
    return float(t.call_kernels) if t.call_kernels else None
