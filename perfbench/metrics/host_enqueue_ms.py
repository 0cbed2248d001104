"""Mean host time of a call from its entry to its return, before the
synchronize: the API and dispatch layers' work. From the benchmark's own
spans outside the profiled sub-window."""


def read(run):
    spans = run.unprofiled()
    if not spans:
        return None
    return 1e3 * sum(s.enqueued - s.start for s in spans) / len(spans)
