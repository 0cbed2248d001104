"""One coupled vector Chebyshev step: the CUDA kernel's wrapper and its plain version.

PyTorch-port counterpart of the pass semantics of
``gcm_filters_tpu/ops/pallas/vec_pass.py`` (``_build_coupled_pass`` with the
B-grid body ``_bgrid_lap`` or the C-grid tap body ``_ctap_lap``). The kernels
are in ``gcm_filters_tpu_torch/csrc/vec_pass.cu``; its head comment states
what one launch computes for each :data:`FIRST`, :data:`MIDDLE` and
:data:`LAST` step. :func:`vec_pass_reference` computes the same step with
torch ops.

The state is the stacked pair, ``(batch, 2, ny, nx)`` with u at index 0 and v
at index 1 of the second axis. Coefficients are one contiguous
``(n_coef, ny, nx)`` tensor, pre-scaled by ``-2*lap_scale``, in
``BGRID_FIELDS`` order (B-grid, 10 planes: diffusion then mixing) or
``CTAPS`` order (C-grid taps, 18 planes).

:func:`vec_pass` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; for a CUDA tensor it launches or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..ctaps import CTAP_NAMES, apply_taps
from ..stencil import BGRID_FIELDS, BGridVectorStencil
from .cheb_pass import FIRST, LAST, MIDDLE

Tensor = torch.Tensor

BGRID, CTAP = 0, 1  # the contraction a launch runs (the kernel's `op`)
N_COEF = {BGRID: len(BGRID_FIELDS), CTAP: len(CTAP_NAMES)}


@dataclasses.dataclass(frozen=True)
class VecPassOperands:
    """What every step of one vector filter reads besides the carries.

    ``coef`` is the ``(n_coef, ny, nx)`` coefficient tensor on one device in
    one dtype, pre-scaled by ``-2*lap_scale``; ``op`` is :data:`BGRID` or
    :data:`CTAP`; ``zap`` scrubs NaNs from the contraction's input.
    """

    op: int
    coef: Tensor
    zap: bool


def _lap(ops: VecPassOperands, t: Tensor) -> Tensor:
    """lap'(t) on the stacked state, periodic in x and y, with the
    contraction order of the JAX kernel bodies."""
    if ops.op == CTAP:
        g = torch.nan_to_num(t) if ops.zap else t
        lu, lv = apply_taps(dict(zip(CTAP_NAMES, ops.coef)), g[:, 0], g[:, 1])
    elif ops.op == BGRID:
        lu, lv = BGridVectorStencil(*ops.coef, zap_nans=ops.zap).laplacian(t[:, 0], t[:, 1])
    else:
        raise ValueError(f"unknown vector contraction {ops.op}")
    return torch.stack([lu, lv], dim=1)


def vec_pass_reference(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    Writes its outputs into the given buffers, as the kernel does: FIRST
    reads ``w`` and writes ``t_next`` (T1) and ``acc``; MIDDLE writes
    ``t_next`` (which may be ``t_prev``) and ``acc``; LAST writes the result
    into ``acc``.
    """
    if kind == FIRST:
        t1 = -w + 0.5 * _lap(ops, w)
        a = p_a * w + p_b * t1
        t_next.copy_(t1)
        acc.copy_(a)
        return
    if kind not in (MIDDLE, LAST):
        raise ValueError(f"unknown step kind {kind}")
    nxt = -2.0 * t + _lap(ops, t) - t_prev
    a = acc + p_a * nxt
    if kind == MIDDLE:
        t_next.copy_(nxt)
    acc.copy_(a)


_ARGTYPES = (
    [ctypes.c_int] * 5            # op, kind, batch, ny, nx
    + [ctypes.c_void_p] * 6       # w, t, t_prev, t_next, acc, coef
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("vec_pass")
        for fn in (lib.vec_pass_f32, lib.vec_pass_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.vec_pass_error_string.argtypes = [ctypes.c_int]
        lib.vec_pass_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_REQUIRED = {
    FIRST: ("w", "t_next", "acc"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    if ops.op not in N_COEF:
        raise ValueError(f"unknown vector contraction {ops.op}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vec_pass kernel takes float32 or float64, got {dtype}")
    if acc.dim() != 4 or acc.shape[1] != 2:
        raise ValueError(f"vec_pass kernel takes (batch, 2, ny, nx) carries, got {tuple(acc.shape)}")
    batch, _, ny, nx = acc.shape
    if batch > 65535 or ny > 8 * 65535:
        raise ValueError(f"shape {tuple(acc.shape)} exceeds the kernel's launch grid")

    def check(name, x, shape):
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return x.data_ptr()

    ptr = {}
    for name in ("w", "t", "t_prev", "t_next", "acc"):
        if name not in _REQUIRED[kind]:
            ptr[name] = None
        elif bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
        else:
            ptr[name] = check(name, bufs[name], (batch, 2, ny, nx))
    coef = check("coef", ops.coef, (N_COEF[ops.op], ny, nx))

    lib = _library()
    fn = lib.vec_pass_f32 if dtype == torch.float32 else lib.vec_pass_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(ops.op, kind, batch, ny, nx,
                 ptr["w"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], coef,
                 float(p_a), float(p_b), int(ops.zap), stream)
    if err != 0:
        msg = lib.vec_pass_error_string(err).decode()
        raise RuntimeError(f"vec_pass kernel launch failed: {msg} (cudaError {err})")
    vec_pass.launches[ops.op] += 1


def vec_pass(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """One coupled Chebyshev step, as :func:`vec_pass_reference` documents it.

    CUDA tensors launch the kernel (counted per contraction in
    ``vec_pass.launches[BGRID]`` and ``vec_pass.launches[CTAP]``) on the
    current stream, without synchronizing; CPU tensors run the plain
    version. Anything else raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_next=t_next, acc=acc)
    if acc.is_cuda:
        _launch(ops, kind, p_a, p_b, bufs)
    elif acc.device.type == "cpu":
        vec_pass_reference(ops, kind, p_a, p_b, **bufs)
    else:
        raise RuntimeError(f"vec_pass has no kernel for device {acc.device}")


vec_pass.launches = {BGRID: 0, CTAP: 0}  # kernel launches; the plain version does not count
