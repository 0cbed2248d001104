"""Host time of the streamed loop's ``gft.stream.upload`` spans in the
profiled calls, ms per snapshot: each chunk's host-to-device copy from
pageable memory (``Filter._coerce``)."""
from perfbench.metrics import _spans


def read(run):
    return _spans.stage_ms_per_snapshot(run, "gft.stream.upload")
