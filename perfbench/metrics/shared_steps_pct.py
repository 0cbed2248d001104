"""Share of the profiled calls' scalar-tile steps that ran on the
shared-memory steps: the ``steps=`` of the ``gft.launch`` spans with
``path="shared"`` over the ``steps=`` of every span that carries both
``path=`` and ``steps=`` (the scalar tile's launches on the card), in %.
It moves only where a plan changes the path of a pass."""
from perfbench.metrics import _spans


def read(run):
    launches = [s.counts for s in _spans.profiled(run) if s.name == "gft.launch"
                and "path" in s.counts and "steps" in s.counts]
    total = sum(c["steps"] for c in launches)
    if not total:
        return None
    return 100.0 * sum(c["steps"] for c in launches if c["path"] == "shared") / total
