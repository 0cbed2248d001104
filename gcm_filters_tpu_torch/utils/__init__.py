"""Small shared utilities."""

from .profiling import benchmark_fn
from .telemetry import PerformanceWarning, fallback_counts, reset_fallback_counts

__all__ = ["PerformanceWarning", "benchmark_fn", "fallback_counts", "reset_fallback_counts"]
