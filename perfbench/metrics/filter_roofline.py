"""The whole call's share of its roofline, in %: the least time the card
could take for the profiled calls' work (``workcount.call_work``, counted
from the configuration's inputs) over the device time of every kernel they
launched."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    profiled = [s for s in run.spans if s.profiled]
    bound_ms = sum(run.bound_ms(s.snapshots) for s in profiled)
    kernel_ms = 1e-3 * sum(dur for _, _, dur in t.kernels)
    return 100.0 * bound_ms / kernel_ms
