"""One Chebyshev step: the CUDA kernel's wrapper and its plain PyTorch version.

PyTorch-port counterpart of the pass semantics of
``gcm_filters_tpu/ops/pallas/cheb_pass.py`` (the fused, end-fused scalar
pass). The kernel is ``gcm_filters_tpu_torch/csrc/cheb_pass.cu``; its head
comment states what one launch computes for each :data:`FIRST`,
:data:`MIDDLE` and :data:`LAST` step. :func:`cheb_pass_reference` computes
the same step with torch ops.

:func:`cheb_pass` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; for a CUDA tensor it launches or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..stencil import COEF_FIELDS, ScalarStencil5

FIRST, MIDDLE, LAST = 0, 1, 2

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class PassOperands:
    """What every step of one filter reads besides the carries.

    ``stencil`` is the hot stencil on one device in one dtype, with ``c, n,
    s, e, w`` pre-scaled by ``-2*lap_scale`` (``pre``, ``post`` and ``area``
    are not scaled). ``drop_pre`` turns on the h-space mask elimination,
    with ``post`` as the 0/1 wet mask and ``land_gain = chebval(-1, p)``
    (see dispatch.py).
    """

    stencil: ScalarStencil5
    drop_pre: bool
    land_gain: float


def cheb_pass_reference(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    Writes its outputs into the given buffers, as the kernel does: FIRST
    writes ``h``, ``t_next`` and ``acc``; MIDDLE writes ``t_next`` (which
    may be ``t_prev``) and ``acc``; LAST writes the result into ``acc``.
    """
    st = ops.stencil
    if kind == FIRST:
        fbar = st.prepare(field)
        h0 = st.post * torch.nan_to_num(fbar) if ops.drop_pre else fbar
        t1 = -h0 + 0.5 * st.laplacian(h0)
        a = p_a * h0 + p_b * t1
        h.copy_(h0)
        t_next.copy_(t1)
        acc.copy_(a)
        return
    nxt = -2.0 * t + st.laplacian(t) - t_prev
    a = acc + p_a * nxt
    if kind == MIDDLE:
        t_next.copy_(nxt)
        acc.copy_(a)
        return
    if kind != LAST:
        raise ValueError(f"unknown step kind {kind}")
    fbar = st.prepare(field)
    if ops.drop_pre:
        # 0*fbar poisons a wet-cell NaN back into the result
        a = torch.where(st.post == 0, ops.land_gain * fbar, a + fbar * 0.0)
    acc.copy_(st.finalize(a))


_ARGTYPES = (
    [ctypes.c_int] * 4            # kind, batch, ny, nx
    + [ctypes.c_void_p] * 11      # field, t, t_prev, t_next, acc, h, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 3          # zap, fold, drop_pre
    + [ctypes.c_void_p]           # stream
)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("cheb_pass")
        for fn in (lib.cheb_pass_f32, lib.cheb_pass_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.cheb_pass_error_string.argtypes = [ctypes.c_int]
        lib.cheb_pass_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


_REQUIRED = {
    FIRST: ("field", "t_next", "acc", "h"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("field", "t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"cheb_pass kernel takes float32 or float64, got {dtype}")
    if acc.dim() != 3:
        raise ValueError(f"cheb_pass kernel takes (batch, ny, nx) carries, got {tuple(acc.shape)}")
    batch, ny, nx = acc.shape
    if batch > 65535 or ny > 8 * 65535:
        raise ValueError(f"shape {tuple(acc.shape)} exceeds the kernel's launch grid")

    def check(name, x, shape):
        if x is None:
            return None
        if x.device != device or x.dtype != dtype:
            raise ValueError(f"{name}: {x.dtype} on {x.device}, expected {dtype} on {device}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        return x.data_ptr()

    for name in _REQUIRED[kind]:
        if bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
    ptr = {k: check(k, bufs[k], (batch, ny, nx)) if k in _REQUIRED[kind] else None
           for k in ("field", "t", "t_prev", "t_next", "acc", "h")}
    st = ops.stencil
    coef_ptr, coef_val = [], []
    for k in COEF_FIELDS:
        v = getattr(st, k)
        if isinstance(v, Tensor):
            coef_ptr.append(check(k, v, (ny, nx)))
            coef_val.append(0.0)
        else:
            coef_ptr.append(None)
            coef_val.append(float(v))
    masks = [check(k, getattr(st, k), (ny, nx)) for k in ("pre", "post", "area")]
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")

    lib = _library()
    fn = lib.cheb_pass_f32 if dtype == torch.float32 else lib.cheb_pass_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(kind, batch, ny, nx,
                 ptr["field"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], ptr["h"],
                 *coef_ptr, *coef_val, *masks,
                 float(p_a), float(p_b), float(ops.land_gain),
                 int(st.zap_nans), int(st.fold_north), int(ops.drop_pre), stream)
    if err != 0:
        msg = lib.cheb_pass_error_string(err).decode()
        raise RuntimeError(f"cheb_pass kernel launch failed: {msg} (cudaError {err})")
    cheb_pass.launches += 1


def cheb_pass(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """One Chebyshev step, as :func:`cheb_pass_reference` documents it.

    CUDA tensors launch the kernel (counted in ``cheb_pass.launches``) on the
    current stream, without synchronizing; CPU tensors run the plain version.
    Anything else raises.
    """
    bufs = dict(field=field, t=t, t_prev=t_prev, t_next=t_next, acc=acc, h=h)
    if acc.is_cuda:
        _launch(ops, kind, p_a, p_b, bufs)
    elif acc.device.type == "cpu":
        cheb_pass_reference(ops, kind, p_a, p_b, **bufs)
    else:
        raise RuntimeError(f"cheb_pass has no kernel for device {acc.device}")


cheb_pass.launches = 0  # kernel launches; the plain version does not count
