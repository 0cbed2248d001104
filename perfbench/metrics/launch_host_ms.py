"""Mean host time a profiled call spends in the port's pass wrappers: the
summed ``gft.launch`` spans under each public call (argument checks and the
ctypes launch of every pass the fused plan runs)."""
from perfbench.metrics import _spans


def read(run):
    calls = _spans.calls(run)
    if not any(launches for _, launches in calls):
        return None
    return 1e-6 * sum(sum(_spans.ns(s) for s in launches) for _, launches in calls) / len(calls)
