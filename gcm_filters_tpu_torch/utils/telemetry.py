"""Telemetry: fallback counters, and the port's spans.

PyTorch-port counterpart of ``gcm_filters_tpu/utils/telemetry.py``, with the
same API. In the port nothing on the kernel path falls back: for a CUDA
tensor the dispatcher launches the hand-written kernel or raises. The
counters stay so that a run can show it: ``chip_smoke.py`` asserts that
:func:`fallback_counts` is empty after driving the main path. The one
counter the port records is ``stream_pageable_result``: a streamed result
the host could not page-lock, so it came down through pageable memory.

Spans time the port's own layers from inside. ``with span(name, **counts)``
records the block's name, its start and end (``time.perf_counter_ns``), the
span around it in the same thread (``parent``), the id of the outermost one
(``call``: every span of one public call shares it) and ``counts``, numbers
measured at the same boundary (``bytes=`` a copy moves) or, on a scalar
tile's launch, ``path=``. The port's spans
are named ``gft.*``:

- ``gft.apply``, ``gft.apply_to_vector``, ``gft.apply_streamed``,
  ``gft.apply_to_vector_streamed``: a public call of ``Filter``, from the
  top of the method (input coercion included);
- ``gft.launch``: one call of a pass wrapper (``ops/cuda/*_pass.py``), a
  kernel launch on the card or the plain version on the CPU, opened by
  ``ops/cuda/launch.py::route``; a launch of the scalar tile on the card
  carries ``path=``, the steps it ran (``"registers"`` or ``"shared"``).
  The launches themselves are counted apart, in the one table of
  ``ops/cuda/launch.py::launch_counts``;
- ``gft.stream.read``, ``.upload``, ``.download``, ``.assemble``: the
  stages of one chunk of the streamed methods (read from the array-like, the
  host-to-device copy, the device-to-host copy, the copy into the result),
  the copies with ``bytes=``; on one card also ``pinned=``, the bytes moved
  through page-locked memory (``Filter._streamed_pinned``);
- ``gft.setup.spec``, ``.operator``, ``.operands``, ``.kernels``: the
  filter's polynomial, its grid operator, an operand-cache miss of the
  applies (host planes cast and uploaded) and the loading of a kernel
  library, with ``builds=`` the nvcc processes it started;
- ``gft.setup.ctaps``: the composition of the C-grid operator's tap planes
  on the host (``ops/ctaps.py::cgrid_tap_arrays``, once a filter), inside
  the first ``gft.setup.operands`` of a C-grid filter, with ``planes=`` (18)
  and ``bytes=`` (their float64 bytes).

Hot-path spans record only while recording is on: while a ``torch.profiler``
runs, or inside :func:`recording`. Off, :func:`span` returns one shared null
context (no allocation, no clock read). While a profiler runs, each span
also enters ``torch.profiler.record_function(name)``, so it stands in the
profiler's trace (``utils/profiling.trace``) beside the device's kernels and
copies, on the trace's clock. Set-up spans (:func:`setup_span`) always
record: they run once per filter, per (dtype, device) or per library.

Both kinds go into bounded buffers that drop the oldest first;
:func:`spans` reads them and :func:`reset_spans` clears them.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
import warnings
from typing import List

import torch

__all__ = [
    "PerformanceWarning",
    "record_fallback",
    "fallback_counts",
    "reset_fallback_counts",
    "Span",
    "span",
    "setup_span",
    "recording",
    "spans",
    "reset_spans",
]

SPAN_BUFFER = 65536  # hot-path spans kept, the oldest dropped first
SETUP_BUFFER = 1024  # set-up spans kept, likewise


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


# -- spans --------------------------------------------------------------------


class Span:
    """One recorded span. ``parent`` is the ``id`` of the span around it in
    the same thread (None at the outermost), ``call`` the ``id`` of the
    outermost one; times are ``time.perf_counter_ns``."""

    __slots__ = ("name", "counts", "id", "parent", "call", "start_ns", "end_ns")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, call={self.call}, "
                f"ns={self.ns}, counts={self.counts})")


_hot: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_setup: collections.deque = collections.deque(maxlen=SETUP_BUFFER)
_current: contextvars.ContextVar = contextvars.ContextVar("gft_span", default=None)
_ids = itertools.count(1)
_recorders = 0  # open recording() blocks, in every thread
_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Open:
    """The context of one span that records."""

    __slots__ = ("rec", "buf", "token", "annotation")

    def __init__(self, name: str, counts: dict, buf: collections.deque):
        self.rec, self.buf = Span(name, counts), buf

    def __enter__(self) -> Span:
        rec = self.rec
        parent = _current.get()
        rec.id = next(_ids)
        rec.parent = None if parent is None else parent.id
        rec.call = rec.id if parent is None else parent.call
        self.annotation = None
        if _profiler_enabled():
            self.annotation = torch.profiler.record_function(rec.name)
            self.annotation.__enter__()
        self.token = _current.set(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        _current.reset(self.token)
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        with _lock:
            self.buf.append(rec)
        return False


def span(name: str, **counts):
    """A hot-path span: records while a profiler runs or inside
    :func:`recording`, else is one shared null context. ``with span(...) as
    s`` binds the :class:`Span` being recorded, or None."""
    if _recorders or _profiler_enabled():
        return _Open(name, counts, _hot)
    return _OFF


def setup_span(name: str, **counts):
    """A set-up span: records always, into a buffer of its own. ``with
    setup_span(...) as s`` binds the :class:`Span`; ``s.counts`` may take
    numbers known only at the block's end."""
    return _Open(name, counts, _setup)


@contextlib.contextmanager
def recording():
    """Record hot-path spans inside the block without a profiler (in every
    thread, while the block is open)."""
    global _recorders
    with _lock:
        _recorders += 1
    try:
        yield
    finally:
        with _lock:
            _recorders -= 1


def spans() -> List[Span]:
    """The recorded spans of both buffers (set-up and hot path), in order of
    their start."""
    with _lock:
        found = list(_setup) + list(_hot)
    return sorted(found, key=lambda s: s.start_ns)


def reset_spans() -> None:
    with _lock:
        _hot.clear()
        _setup.clear()
