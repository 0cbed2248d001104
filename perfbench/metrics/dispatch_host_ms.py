"""Mean host time of a profiled call inside the program, less its kernel
launches: the port's span around the public call (``gft.apply``, ...)
minus the ``gft.launch`` spans directly under it. API and dispatch's own
time: coercion, checks, operand and plan look-ups, buffers."""
from perfbench.metrics import _spans


def read(run):
    calls = _spans.calls(run)
    if not calls:
        return None
    return 1e-6 * sum(_spans.ns(root) - sum(_spans.ns(s) for s in launches)
                      for root, launches in calls) / len(calls)
