"""Host-to-device and device-to-host copies in the profiled sub-window, ms
of device time per snapshot streamed."""


def read(run):
    t = run.trace
    snapshots = sum(s.snapshots for s in run.spans if s.profiled)
    if t is None or not t.memcpys or not snapshots:
        return None
    return 1e-3 * sum(dur for _, _, dur in t.memcpys) / snapshots
