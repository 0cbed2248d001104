"""Tests of the benchmark itself: ``python -m pytest perfbench/tests -q``
from the root of the repository. Tests marked ``card`` need a CUDA card and
skip without one; each decides inside the test."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on the chip")


@pytest.fixture
def traced_from_the_start(monkeypatch):
    """Cells whose profiled calls start with the window (``trace_start`` 0),
    so that a traced run on the CPU holds them however long a call takes
    there: on a busy CPU one slow call could otherwise end a short window
    before the profiled part starts."""
    from perfbench import harness

    load = harness.load_cell

    def load_cell(*args, **kwargs):
        cell = load(*args, **kwargs)
        cell.traffic = {**cell.traffic, "trace_start": 0.0}
        return cell

    monkeypatch.setattr(harness, "load_cell", load_cell)
