"""Tests of the benchmark itself: ``python -m pytest perfbench/tests -q``
from the root of the repository. Tests marked ``card`` need a CUDA card and
skip without one; each decides inside the test."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; run on the chip")
