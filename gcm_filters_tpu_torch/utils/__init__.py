"""Small shared utilities."""

from .telemetry import PerformanceWarning, fallback_counts, reset_fallback_counts

__all__ = ["PerformanceWarning", "fallback_counts", "reset_fallback_counts"]
