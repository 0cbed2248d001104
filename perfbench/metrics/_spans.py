"""The program's own spans (``gcm_filters_tpu_torch.utils.telemetry``), as
the readers of the metrics that time the port's layers from inside take
them. Imported after the window; a program that records no spans gives
none, and each of those readers then returns None."""

ROOTS = ("gft.apply", "gft.apply_to_vector", "gft.apply_streamed", "gft.apply_to_vector_streamed")


def recorded() -> list:
    """Every span the program holds (set-up and hot path), in order of their
    start; [] where the program records none."""
    try:
        from gcm_filters_tpu_torch.utils import telemetry
    except ImportError:
        return []
    read = getattr(telemetry, "spans", None)
    return list(read()) if read is not None else []


def ns(s) -> int:
    return s.end_ns - s.start_ns


def profiled(run) -> list:
    """The program's spans inside the profiled calls: from the first one's
    start to the last one's end (both clocks are ``time.perf_counter``)."""
    calls = [s for s in run.spans if s.profiled]
    if not calls:
        return []
    a, b = calls[0].start * 1e9, calls[-1].done * 1e9
    return [s for s in recorded() if a <= s.start_ns and s.end_ns <= b]


def calls(run) -> list:
    """``(root, launches)`` of each public call profiled: its outermost span
    and the ``gft.launch`` spans directly under it."""
    found = profiled(run)
    roots = {s.id: (s, []) for s in found if s.name in ROOTS and s.parent is None}
    for s in found:
        if s.name == "gft.launch" and s.parent in roots:
            roots[s.parent][1].append(s)
    return list(roots.values())


def stage_ms_per_snapshot(run, name: str):
    """The summed time of the spans ``name`` in the profiled calls, ms per
    snapshot profiled; None where there is none."""
    found = [s for s in profiled(run) if s.name == name]
    snapshots = sum(s.snapshots for s in run.spans if s.profiled)
    if not found or not snapshots:
        return None
    return 1e-6 * sum(ns(s) for s in found) / snapshots
