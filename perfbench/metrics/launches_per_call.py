"""Kernel events in the profiled sub-window over the calls in it: what the
fused plan launches for one call."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.calls:
        return None
    return len(t.kernels) / t.calls
