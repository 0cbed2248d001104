"""One coupled vector Chebyshev step on a halo-extended local block: the CUDA
kernel's wrapper and its plain PyTorch version.

PyTorch-port counterpart of the per-shard use of the coupled passes
``gcm_filters_tpu/ops/pallas/vec_pass.py::build_vec_pass`` (B-grid) and
``build_ctap_pass`` (C-grid taps), as
``gcm_filters_tpu/parallel/sharded.py::make_sharded_vector_apply`` drives them
on a shard. A rank of the sharded engine (parallel/sharded.py) holds an
``(ly, lx)`` core block of u and v; one halo exchange extends the stacked
carries by ``cells`` cells on each side, and the steps of one round then run
on the extended ``(batch, 2, ly+2*cells, lx+2*cells)`` block with no wrap:
the halos carry the periodic wrap (vector grids have no fold). Step ``j`` of
a round (``j = 1..n_ops``, ``n_ops <= cells``) computes the *window* of the
block shrunk by ``shrink = j`` cells on each side and reads one cell further
out, the diagonal taps included, never outside the block; after the round the
core is exact. ``acc`` and the result are core-shaped ``(batch, 2, ly, lx)``.

The kernels are the windowed local entries of
``gcm_filters_tpu_torch/csrc/vec_pass.cu``; its head comment states what one
launch computes for each :data:`FIRST`, :data:`MIDDLE` and :data:`LAST` step.
:func:`vec_local_pass_reference` computes the same step with torch slices, in
the kernel's order of summation. :func:`vec_local_pass` launches the kernel
for CUDA tensors and runs the plain version for CPU tensors; for a CUDA
tensor it launches or raises.

The operands are a :class:`~.vec_pass.VecPassOperands` whose ``coef`` holds
the *extended* ``(n_coef, ly+2*cells, lx+2*cells)`` coefficient planes,
pre-scaled by ``-2*lap_scale``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..ctaps import CTAPS
from ..stencil import BGRID_DIFF
from .cheb_pass import FIRST, LAST, MIDDLE
from .local_pass import _window
from .vec_pass import BGRID, CTAP, N_COEF, VecPassOperands, _library as _vec_library

Tensor = torch.Tensor


def _lap(ops: VecPassOperands, t: Tensor, shrink: int) -> Tensor:
    """lap'(t) of the stacked state on the window shrunk by ``shrink``,
    reading one cell further, summed in the order of the kernel's functors
    (``BGridLap``, ``CTapLap``: the JAX ``_bgrid_lap`` and ``_ctap_lap``)."""
    g = _window(t, shrink - 1)
    if ops.zap:
        g = torch.nan_to_num(g)
    inner = lambda dy, dx: _window(g, 1, dy, dx)  # noqa: E731
    coef = _window(ops.coef, shrink)
    if ops.op == BGRID:
        def s5(first):
            c, n, s, e, w = (coef[first + m] for m in range(5))
            return (c * inner(0, 0) + n * inner(1, 0) + s * inner(-1, 0)
                    + e * inner(0, 1) + w * inner(0, -1))

        diff, mix = s5(0), s5(len(BGRID_DIFF))
        # u picks up the mixing term of v, and v that of u
        return torch.stack([diff[:, 0] + mix[:, 1], diff[:, 1] + mix[:, 0]], dim=1)
    if ops.op == CTAP:
        outs = [0.0, 0.0]
        for m, (_, oc, ic, dy, dx) in enumerate(CTAPS):
            outs[oc] = outs[oc] + coef[m] * inner(dy, dx)[:, ic]
        return torch.stack(outs, dim=1)
    raise ValueError(f"unknown vector contraction {ops.op}")


def vec_local_pass_reference(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    ``w``, ``t``, ``t_prev`` and ``t_next`` are extended ``(batch, 2,
    ly+2*cells, lx+2*cells)`` buffers, ``acc`` is core-shaped ``(batch, 2, ly,
    lx)``, and outputs are written into the given buffers, as the kernel
    does; nothing outside a step's window is written:

    - FIRST (``shrink`` 1): ``w`` is the extended input, which is ``T_0``
      itself. Writes ``t_next = T_1`` on the window and ``acc = p_a*T_0 +
      p_b*T_1`` on the core.
    - MIDDLE: writes ``t_next`` (which may be ``t_prev``) on the window
      shrunk by ``shrink`` and adds ``p_a*t_next`` to ``acc`` on the core.
    - LAST: the window is the core. Adds the last term and leaves the
      result in ``acc``.
    """
    core = lambda x, s=0: _window(x, cells - s)  # noqa: E731  core of a plane shrunk by s
    if kind == FIRST:
        t1 = -_window(w, 1) + 0.5 * _lap(ops, w, 1)
        a = p_a * core(w) + p_b * core(t1, 1)
        _window(t_next, 1).copy_(t1)
        acc.copy_(a)
        return
    if kind == LAST:
        shrink = cells
    elif kind != MIDDLE:
        raise ValueError(f"unknown step kind {kind}")
    nxt = -2.0 * _window(t, shrink) + _lap(ops, t, shrink) - _window(t_prev, shrink)
    a = acc + p_a * core(nxt, shrink)
    if kind == MIDDLE:
        _window(t_next, shrink).copy_(nxt)
    acc.copy_(a)


_ARGTYPES = (
    [ctypes.c_int] * 7            # op, kind, batch, ey, ex, cells, shrink
    + [ctypes.c_void_p] * 6       # w, t, t_prev, t_next, acc, coef
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
)
_lib = None


def _library():
    """The library of ``csrc/vec_pass.cu`` (shared with the periodic
    entries), with the local entries' signatures set."""
    global _lib
    if _lib is None:
        lib = _vec_library()
        for fn in (lib.vec_local_pass_f32, lib.vec_local_pass_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


# buffers each step kind needs; all but acc are extended
_REQUIRED = {
    FIRST: ("w", "t_next", "acc"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, cells, shrink, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    if ops.op not in N_COEF:
        raise ValueError(f"unknown vector contraction {ops.op}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vec_local_pass kernel takes float32 or float64, got {dtype}")
    if acc.dim() != 4 or acc.shape[1] != 2:
        raise ValueError(
            f"vec_local_pass kernel takes a (batch, 2, ly, lx) acc, got {tuple(acc.shape)}")
    batch, _, ly, lx = acc.shape
    ey, ex = ly + 2 * cells, lx + 2 * cells
    if kind == FIRST:
        shrink = 1
    elif kind == LAST:
        shrink = cells
    if cells < 1 or shrink is None or not 1 <= shrink <= cells:
        raise ValueError(f"need 1 <= shrink <= cells, got shrink {shrink}, cells {cells}")
    if batch > 65535 or ey > 8 * 65535:
        raise ValueError(f"block {(batch, 2, ey, ex)} exceeds the kernel's launch grid")

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
            ptr[name] = check(name, bufs[name],
                              (batch, 2, ly, lx) if name == "acc" else (batch, 2, ey, ex))
    coef = check("coef", ops.coef, (N_COEF[ops.op], ey, ex))

    lib = _library()
    fn = lib.vec_local_pass_f32 if dtype == torch.float32 else lib.vec_local_pass_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(ops.op, kind, batch, ey, ex, cells, shrink,
                 ptr["w"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], coef,
                 float(p_a), float(p_b), int(ops.zap), stream)
    if err != 0:
        msg = lib.vec_pass_error_string(err).decode()
        raise RuntimeError(f"vec_local_pass kernel launch failed: {msg} (cudaError {err})")
    vec_local_pass.launches[ops.op] += 1


def vec_local_pass(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """One coupled step on the extended block, as
    :func:`vec_local_pass_reference` documents it.

    CUDA tensors launch the kernel (counted per contraction in
    ``vec_local_pass.launches[BGRID]`` and ``vec_local_pass.launches[CTAP]``)
    on the current stream, without synchronizing; CPU tensors run the plain
    version. Anything else raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_next=t_next, acc=acc)
    if acc.is_cuda:
        _launch(ops, kind, p_a, p_b, cells, shrink, bufs)
    elif acc.device.type == "cpu":
        vec_local_pass_reference(ops, kind, p_a, p_b, cells=cells, shrink=shrink, **bufs)
    else:
        raise RuntimeError(f"vec_local_pass has no kernel for device {acc.device}")


# kernel launches per contraction; the plain version does not count
vec_local_pass.launches = {BGRID: 0, CTAP: 0}
