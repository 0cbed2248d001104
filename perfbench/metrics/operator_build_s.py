"""Seconds the run's ``Filter`` spent on its host set-up: the program's
``gft.setup.spec``, ``gft.setup.operator`` and ``gft.setup.operands`` spans
before the window, from the last filter polynomial computed before it (the
run's ``Filter``) on. Not ``gft.setup.kernels``: nvcc runs only in a
checkout's first run."""
from perfbench.metrics import _spans

SETUP = ("gft.setup.spec", "gft.setup.operator", "gft.setup.operands")


def read(run):
    if not run.spans:
        return None
    t0 = run.spans[0].start * 1e9
    setup = [s for s in _spans.recorded() if s.name in SETUP and s.end_ns <= t0]
    specs = [s.start_ns for s in setup if s.name == "gft.setup.spec"]
    if not specs:
        return None
    return 1e-9 * sum(_spans.ns(s) for s in setup if s.start_ns >= specs[-1])
