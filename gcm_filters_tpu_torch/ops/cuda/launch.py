"""The host side of a kernel launch, shared by every pass wrapper.

A wrapper (``cheb_pass.py``, ``local_pass.py``, ``vec_pass.py``,
``vec_local_pass.py``, ``ring_pass.py``) keeps what is its own: the buffers
a step kind or a pass needs, its kernel's particular checks and the order of
its C arguments. What every launch does is here:

- :class:`Kernel` binds one entry of a library, ``<entry>_f32`` and
  ``<entry>_f64`` of ``csrc/<source>.cu``, to its ``argtypes`` once, with
  the library's ``<source>_error_string`` (``build.load`` loads the
  library), and makes the call: on the current stream of the device, inside
  ``torch.cuda.device``, a non-zero code raised as a ``RuntimeError``, the
  launch counted;
- :func:`pointer` checks a buffer (device, dtype, shape, contiguity) and
  gives its address, :func:`placed` its device and dtype alone, and
  :func:`check_grid` the limits of the launch grid;
- :func:`route` is the ``gft.launch`` span of one wrapper call, which says
  where the call goes: a CUDA device to the kernel, the CPU to the plain
  version; any other device raises;
- :func:`launch_counts` reads, and resets, the one table of launches. It is
  keyed by ``(entry, detail)``: the detail is the contraction of a vector
  entry (``vec_pass.BGRID`` or ``CTAP``), the steps of a scalar tile's
  launch (``"registers"`` or ``"shared"``, :func:`~.cheb_pass.fused_path`),
  both for the periodic fused vector entry (``(vec_pass.BGRID,
  "registers")``, ...: the steps its plan gave the pass,
  :func:`~.vec_pass.plan_vec_fused_passes`) and None for the other
  entries. The plain versions count nothing.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from ...utils.telemetry import _OFF, span

GRID_LIMIT = 65535  # gridDim.y and gridDim.z of a launch at most
STEP_ROWS = 8       # rows of a one-step kernel's block (csrc: dim3 block(32, 8))

_counts: collections.Counter = collections.Counter()


class Kernel:
    """The entries ``<entry>_f32`` and ``<entry>_f64`` of
    ``csrc/<source>.cu``: C functions of ``argtypes`` (the stream last) that
    return a cudaError code. Bound at their first call."""

    __slots__ = ("source", "entry", "argtypes", "fns")

    def __init__(self, source: str, entry: str, argtypes) -> None:
        self.source, self.entry, self.argtypes = source, entry, list(argtypes)
        self.fns = None  # (f32, f64, error_string) once bound

    def bind(self, lib=None):
        """Bind the entries and the error string of ``lib``: by default the
        library built from the source, else another build of it (a copy
        with parts cut, a stand-in in a test), which then replaces it.
        Returns ``(f32, f64, error_string)``."""
        if lib is None:
            from .build import load

            lib = load(self.source)
        f32, f64 = getattr(lib, self.entry + "_f32"), getattr(lib, self.entry + "_f64")
        for fn in (f32, f64):
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
        error = getattr(lib, self.source + "_error_string")
        error.argtypes = [ctypes.c_int]
        error.restype = ctypes.c_char_p
        self.fns = (f32, f64, error)
        return self.fns

    def __call__(self, device, dtype, *args, detail=None) -> None:
        """Launch the entry of ``dtype`` with ``args`` on the current stream
        of ``device``, without synchronizing, and count it under ``(entry,
        detail)``; raises on another dtype and on a failed launch."""
        f32, f64, error = self.fns or self.bind()
        if dtype == torch.float32:
            fn = f32
        elif dtype == torch.float64:
            fn = f64
        else:
            raise TypeError(f"{self.entry} kernel takes float32 or float64, got {dtype}")
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.entry} kernel launch failed: {error(err).decode()} "
                               f"(cudaError {err})")
        _counts[self.entry, detail] += 1


def placed(name: str, x: torch.Tensor, device, dtype) -> None:
    """Raise unless ``x`` is of ``dtype`` on ``device``."""
    if x.device != device or x.dtype != dtype:
        raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} on {device}")


def pointer(name: str, x: Optional[torch.Tensor], shape, device, dtype) -> Optional[int]:
    """The address of a buffer that a kernel reads or writes, after checking
    that it is a contiguous ``shape`` of ``dtype`` on ``device``; None (a
    null pointer) for None."""
    if x is None:
        return None
    if x.device != device or x.dtype != dtype:
        placed(name, x, device, dtype)
    if x.shape != shape:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return x.data_ptr()


def check_grid(batch: int, rows: int, block_rows: int, label: str, shape) -> None:
    """Raise unless a launch over ``batch`` entries (``gridDim.z``) and
    ``rows`` rows in blocks of ``block_rows`` (``gridDim.y``) fits the
    launch grid; the message names the ``label`` and ``shape`` launched."""
    if batch > GRID_LIMIT or -(-rows // block_rows) > GRID_LIMIT:
        raise ValueError(f"{label} {tuple(shape)} exceeds the kernel's launch grid")


class _Route:
    """A span entered as a call's route: ``with`` gives ``card``."""

    __slots__ = ("card", "span")

    def __init__(self, card: bool, inner) -> None:
        self.card, self.span = card, inner

    def __enter__(self) -> bool:
        self.span.__enter__()
        return self.card

    def __exit__(self, *exc) -> bool:
        return self.span.__exit__(*exc)


_CARD, _CPU = _Route(True, _OFF), _Route(False, _OFF)  # the routes while spans are off


def route(name: str, device: torch.device, path: Optional[str] = None) -> _Route:
    """The ``gft.launch`` span of one call of the wrapper ``name`` on
    ``device``; ``with route(...) as card`` opens it and gives True where
    the call launches the kernel (a CUDA device) and False where it runs
    the plain version (the CPU). Any other device raises here. On the card
    the span carries ``path=`` where the caller gives one (the steps of a
    scalar tile's or a periodic fused vector pass's launch)."""
    kind = device.type
    if kind == "cuda":
        card = True
    elif kind == "cpu":
        card, path = False, None
    else:
        raise RuntimeError(f"{name} has no kernel for device {device}")
    inner = span("gft.launch", path=path) if path else span("gft.launch")
    if inner is _OFF:
        return _CARD if card else _CPU
    return _Route(card, inner)


def launch_counts(reset: bool = False) -> dict:
    """The kernel launches counted since the table was last reset, ``{(entry,
    detail): n}`` (the module docstring names the keys); with ``reset`` the
    table is cleared after it is read."""
    counts = dict(_counts)
    if reset:
        _counts.clear()
    return counts
