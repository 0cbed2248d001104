"""Host time of the streamed loop's ``gft.stream.upload`` spans in the
profiled calls, ms per snapshot: each chunk's cast into page-locked staging
and its host-to-device copy enqueued from there (``Filter._streamed_pinned``)."""
from perfbench.metrics import _spans


def read(run):
    return _spans.stage_ms_per_snapshot(run, "gft.stream.upload")
