"""Device kernels a train step launches: a count of the kernel records of the
step recorded after the window (harness/trace.py:Tracer.record_call)."""


def read(t, ctx):
    return float(t.call_kernels) if t.call_kernels else None
