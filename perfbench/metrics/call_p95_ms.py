"""95th percentile of a call's time from its entry to the return of the
synchronize after it, over the calls outside the profiled sub-window
(nearest rank). Host clock: each call is far shorter than the clock's
resolution for an end-to-end metric, so it is a per-layer reading."""
import math


def read(run):
    times = sorted(s.done - s.start for s in run.unprofiled())
    if not times:
        return None
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
