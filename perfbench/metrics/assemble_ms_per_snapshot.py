"""Host time of the streamed loop's ``gft.stream.assemble`` spans in the
profiled calls, ms per snapshot: allocating the numpy result and copying
each chunk's results into it."""
from perfbench.metrics import _spans


def read(run):
    return _spans.stage_ms_per_snapshot(run, "gft.stream.assemble")
