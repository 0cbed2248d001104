"""Host time of the streamed loop's ``gft.stream.download`` spans in the
profiled calls, ms per snapshot: each chunk's device-to-host copy of its
results, with the wait for its kernels."""
from perfbench.metrics import _spans


def read(run):
    return _spans.stage_ms_per_snapshot(run, "gft.stream.download")
