"""One Chebyshev step on a halo-extended local block: the CUDA kernel's
wrapper and its plain PyTorch version.

PyTorch-port counterpart of the per-shard local pass
``gcm_filters_tpu/ops/pallas/cheb_pass.py::build_local_pass``. A rank of the
sharded engine (parallel/sharded.py) holds an ``(ly, lx)`` core block; one
halo exchange extends the carries by ``cells`` cells on each side, and the
steps of one round then run on the extended ``(ly+2*cells, lx+2*cells)``
block with no wrap and no fold: the halos carry the periodic wrap and the
tripolar seam. Step ``j`` of a round (``j = 1..n_ops``, ``n_ops <= cells``)
computes the *window* of the block shrunk by ``shrink = j`` cells on each
side and reads one cell further out, never outside the block; after the
round the core is exact. ``acc`` and the result are core-shaped.

The kernel is ``gcm_filters_tpu_torch/csrc/local_pass.cu``; its head comment
states what one launch computes for each :data:`FIRST`, :data:`MIDDLE` and
:data:`LAST` step. :func:`local_pass_reference` computes the same step with
torch slices. :func:`local_pass` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors; for a CUDA tensor it launches or
raises.

The operands are a :class:`~.cheb_pass.PassOperands` whose stencil holds the
*extended* coefficient planes (``c, n, s, e, w`` pre-scaled by
``-2*lap_scale``; ``pre``, ``post``, ``area`` unscaled) with ``fold_north``
cleared.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..stencil import COEF_FIELDS
from .cheb_pass import FIRST, LAST, MIDDLE, PassOperands

Tensor = torch.Tensor


def _window(x, shrink: int, dy: int = 0, dx: int = 0):
    """The window of an extended plane shrunk by ``shrink`` cells, moved by
    (dy, dx). Floats (constant coefficients) pass through."""
    if not isinstance(x, Tensor):
        return x
    ey, ex = x.shape[-2:]
    return x[..., shrink + dy: ey - shrink + dy, shrink + dx: ex - shrink + dx]


def _lap(ops: PassOperands, t: Tensor, shrink: int) -> Tensor:
    """lap'(t) on the window shrunk by ``shrink``, reading one cell further."""
    st = ops.stencil
    g = _window(t, shrink - 1)
    if st.zap_nans:
        g = torch.nan_to_num(g)
    if st.pre is not None:
        g = _window(st.pre, shrink - 1) * g
    inner = lambda dy, dx: _window(g, 1, dy, dx)  # noqa: E731
    c, n, s, e, w = (_window(getattr(st, k), shrink) for k in COEF_FIELDS)
    out = c * inner(0, 0) + n * inner(1, 0) + s * inner(-1, 0)
    out = out + e * inner(0, 1) + w * inner(0, -1)
    if st.post is not None:
        out = _window(st.post, shrink) * out
    return out


def local_pass_reference(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """The plain PyTorch version of one kernel launch, on any device.

    ``t``, ``t_prev``, ``t_next`` and ``h`` are extended ``(batch, ly+2*cells,
    lx+2*cells)`` buffers, ``acc`` is core-shaped ``(batch, ly, lx)``, and
    outputs are written into the given buffers, as the kernel does:

    - FIRST (``shrink`` 1): ``field`` is the raw extended field. Writes
      ``h = T_0`` on the whole block, ``t_next = T_1`` on the window, and
      ``acc = p_a*T_0 + p_b*T_1`` on the core.
    - MIDDLE: writes ``t_next`` (which may be ``t_prev``) on the window
      shrunk by ``shrink`` and adds ``p_a*t_next`` to ``acc`` on the core.
    - LAST: the window is the core. Adds the last term, reconstructs land
      from the caller's own core-shaped ``field`` under ``drop_pre``,
      divides by the area, and leaves the result in ``acc``.
    """
    st = ops.stencil
    core = lambda x, s=0: _window(x, cells - s)  # noqa: E731  core of a plane shrunk by s
    if kind == FIRST:
        fbar = field * st.area if st.area is not None else field
        h0 = st.post * torch.nan_to_num(fbar) if ops.drop_pre else fbar
        t1 = -_window(h0, 1) + 0.5 * _lap(ops, h0, 1)
        a = p_a * core(h0) + p_b * core(t1, 1)
        h.copy_(h0)
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
        return
    if ops.drop_pre:
        fbar = field * core(st.area) if st.area is not None else field
        # 0*fbar poisons a wet-cell NaN back into the result
        a = torch.where(core(st.post) == 0, ops.land_gain * fbar, a + fbar * 0.0)
    if st.area is not None:
        a = a / core(st.area)
    acc.copy_(a)


_ARGTYPES = (
    [ctypes.c_int] * 6            # kind, batch, ey, ex, cells, shrink
    + [ctypes.c_void_p] * 11      # field, t, t_prev, t_next, acc, h, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 2          # zap, drop_pre
    + [ctypes.c_void_p]           # stream
)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from .build import load

        lib = load("local_pass")
        for fn in (lib.local_pass_f32, lib.local_pass_f64):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.local_pass_error_string.argtypes = [ctypes.c_int]
        lib.local_pass_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# buffers each step kind needs, and whether each is extended or core-shaped
_EXTENDED = ("t", "t_prev", "t_next", "h")
_REQUIRED = {
    FIRST: ("field", "t_next", "acc", "h"),
    MIDDLE: ("t", "t_prev", "t_next", "acc"),
    LAST: ("t", "t_prev", "acc"),
}


def _launch(ops, kind, p_a, p_b, cells, shrink, bufs) -> None:
    if kind not in _REQUIRED:
        raise ValueError(f"unknown step kind {kind}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"local_pass kernel takes float32 or float64, got {dtype}")
    if acc.dim() != 3:
        raise ValueError(f"local_pass kernel takes a (batch, ly, lx) acc, got {tuple(acc.shape)}")
    batch, ly, lx = acc.shape
    ey, ex = ly + 2 * cells, lx + 2 * cells
    if kind == FIRST:
        shrink = 1
    elif kind == LAST:
        shrink = cells
    if cells < 1 or shrink is None or not 1 <= shrink <= cells:
        raise ValueError(f"need 1 <= shrink <= cells, got shrink {shrink}, cells {cells}")
    if batch > 65535 or ey > 8 * 65535:
        raise ValueError(f"block {(batch, ey, ex)} exceeds the kernel's launch grid")

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

    needed = _REQUIRED[kind] + (("field",) if kind == LAST and ops.drop_pre else ())
    ptr = {}
    for name in ("field", "t", "t_prev", "t_next", "acc", "h"):
        if name not in needed:
            ptr[name] = None
            continue
        if bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
        extended = name in _EXTENDED or (name == "field" and kind == FIRST)
        ptr[name] = check(name, bufs[name], (batch, ey, ex) if extended else (batch, ly, lx))
    st = ops.stencil
    if st.fold_north:
        raise ValueError("local_pass has no fold: the halos carry the seam")
    coef_ptr, coef_val = [], []
    for k in COEF_FIELDS:
        v = getattr(st, k)
        if isinstance(v, Tensor):
            coef_ptr.append(check(k, v, (ey, ex)))
            coef_val.append(0.0)
        else:
            coef_ptr.append(None)
            coef_val.append(float(v))
    masks = [check(k, getattr(st, k), (ey, ex)) for k in ("pre", "post", "area")]
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")

    lib = _library()
    fn = lib.local_pass_f32 if dtype == torch.float32 else lib.local_pass_f64
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(kind, batch, ey, ex, cells, shrink,
                 ptr["field"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], ptr["h"],
                 *coef_ptr, *coef_val, *masks,
                 float(p_a), float(p_b), float(ops.land_gain),
                 int(st.zap_nans), int(ops.drop_pre), stream)
    if err != 0:
        msg = lib.local_pass_error_string(err).decode()
        raise RuntimeError(f"local_pass kernel launch failed: {msg} (cudaError {err})")
    local_pass.launches += 1


def local_pass(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """One step on the extended block, as :func:`local_pass_reference`
    documents it.

    CUDA tensors launch the kernel (counted in ``local_pass.launches``) on
    the current stream, without synchronizing; CPU tensors run the plain
    version. Anything else raises.
    """
    bufs = dict(field=field, t=t, t_prev=t_prev, t_next=t_next, acc=acc, h=h)
    if acc.is_cuda:
        _launch(ops, kind, p_a, p_b, cells, shrink, bufs)
    elif acc.device.type == "cpu":
        local_pass_reference(ops, kind, p_a, p_b, cells=cells, shrink=shrink, **bufs)
    else:
        raise RuntimeError(f"local_pass has no kernel for device {acc.device}")


local_pass.launches = 0  # kernel launches; the plain version does not count
