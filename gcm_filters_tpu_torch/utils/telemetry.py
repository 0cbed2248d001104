"""Fallback telemetry: make silent performance degradation visible.

PyTorch-port counterpart of ``gcm_filters_tpu/utils/telemetry.py``, with the
same API. In the port nothing on the kernel path falls back: for a CUDA
tensor the dispatcher launches the hand-written kernel or raises. The
counters stay so that a run can show it: ``chip_smoke.py`` asserts that
:func:`fallback_counts` is empty after driving the main path.
"""
from __future__ import annotations

import collections
import threading
import warnings

__all__ = [
    "PerformanceWarning",
    "record_fallback",
    "fallback_counts",
    "reset_fallback_counts",
]


class PerformanceWarning(UserWarning):
    """The computation stays correct but runs on a slower path."""


_lock = threading.Lock()
_counters: collections.Counter = collections.Counter()


def record_fallback(kind: str, detail: str) -> None:
    """Count a fallback event and warn the user about it.

    ``kind`` is a stable counter key; ``detail`` names the shape/dtype/path
    so the warning is actionable.
    """
    with _lock:
        _counters[kind] += 1
    warnings.warn(
        f"{kind}: {detail}. Results are unaffected, but this configuration "
        f"now runs on a slower execution path. "
        f"(gcm_filters_tpu_torch.utils.telemetry.fallback_counts() tracks these.)",
        PerformanceWarning,
        stacklevel=3,
    )


def fallback_counts() -> dict:
    """A snapshot of all fallback counters (empty dict = no fallbacks)."""
    with _lock:
        return dict(_counters)


def reset_fallback_counts() -> None:
    with _lock:
        _counters.clear()
