"""Seconds the run's ``Filter`` spent composing the C-grid operator's 18 tap
planes on the host: the program's ``gft.setup.ctaps`` spans before the
window, from the last filter polynomial computed before it (the run's
``Filter``) on, as ``operator_build_s`` picks its spans. They lie inside
``gft.setup.operands``, so ``operator_build_s`` holds this time too. None
where the program records no such span (another grid type, or a program
without it)."""
from perfbench.metrics import _spans


def read(run):
    if not run.spans:
        return None
    t0 = run.spans[0].start * 1e9
    setup = [s for s in _spans.recorded() if s.end_ns <= t0]
    specs = [s.start_ns for s in setup if s.name == "gft.setup.spec"]
    if not specs:
        return None
    taps = [s for s in setup if s.name == "gft.setup.ctaps" and s.start_ns >= specs[-1]]
    if not taps:
        return None
    return 1e-9 * sum(_spans.ns(s) for s in taps)
