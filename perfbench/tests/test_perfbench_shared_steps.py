"""``metrics/shared_steps_pct.py`` on spans built by hand: the share of the
profiled calls' scalar-tile steps that ran on the shared-memory steps, from
the ``path=`` and ``steps=`` of their ``gft.launch`` spans; None where no
span carries both (the CPU's launches carry no ``path=``, an older
program's no ``steps=``)."""
import types

import pytest

from perfbench import harness
from perfbench.metrics import _spans

READER = harness.load_module(harness.reader_path("shared_steps_pct"))
CALL = (1.0, 1.001)  # a profiled call's start and end, seconds


def launch(start, **counts):
    return types.SimpleNamespace(name="gft.launch", counts=counts, start_ns=int(start * 1e9),
                                 end_ns=int(start * 1e9) + 1000, parent=1, id=2, call=1)


def reading(monkeypatch, spans):
    monkeypatch.setattr(_spans, "recorded", lambda: spans)
    calls = [harness.Span(CALL[0], CALL[0], CALL[1], 1, True),
             harness.Span(2.0, 2.0, 2.001, 1, False)]
    return READER.read(harness.RunRecord({}, calls, None))


t = CALL[0] + 1e-4


@pytest.mark.parametrize("spans, want", [
    ([launch(t, path="shared", steps=11)], 100.0),
    ([launch(t, path="shared", steps=10)] * 3 + [launch(t, path="shared", steps=9)], 100.0),
    ([launch(t, path="registers", steps=11)], 0.0),
    ([launch(t, path="registers", steps=10)] * 3 + [launch(t, path="shared", steps=9)],
     100.0 * 9 / 39),
    # a vector pass carries path= alone; a span outside the profiled calls
    # is not read
    ([launch(t, path="shared", steps=11), launch(t, path="registers"),
      launch(2.0 + 1e-4, path="registers", steps=11)], 100.0),
], ids=["one_shared_pass", "four_shared_passes", "registers", "mixed", "others_ignored"])
def test_the_share_of_shared_steps(monkeypatch, spans, want):
    assert reading(monkeypatch, spans) == pytest.approx(want)


@pytest.mark.parametrize("spans", [
    [],
    [launch(t, steps=11)],  # the CPU: steps= without path=
    [launch(t, path="shared")],  # an older program: path= without steps=
    [launch(2.0 + 1e-4, path="shared", steps=11)],  # outside the profiled calls
], ids=["no_spans", "cpu", "no_steps", "unprofiled"])
def test_nothing_to_read_gives_none(monkeypatch, spans):
    assert reading(monkeypatch, spans) is None
