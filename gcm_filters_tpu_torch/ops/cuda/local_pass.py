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

:func:`local_strip_pass` runs a whole round of the sharded engine (up to
``cells`` steps) in one launch on shared-memory tiles of the core (entries
``local_strip_pass_f32/f64`` of the same source, built on
``csrc/cheb_tile.cuh``), with no extended block of the state. It reads the
core planes in place (the caller's field on the first round, the previous
round's core-shaped carries later) and their four halo strips
(``parallel/halo.py::exchange_strips``), each window cell where
:func:`strip_index` finds it, and writes core-shaped carries.
:func:`local_fused_pass_reference` is the round on the extended block as a
chain of :func:`local_pass_reference`, and
:func:`local_fused_pass_tiled_reference` runs the kernel's tile
decomposition of it in torch (the windows of ``BlockGeo``);
:func:`local_strip_pass_reference` assembles the extended blocks from the
strips and runs :func:`local_fused_pass_reference`, so the round and the
step chain give the same bits, and
:func:`local_strip_pass_tiled_reference` cuts each window by the index map.

The operands are a :class:`~.cheb_pass.PassOperands` whose stencil holds the
*extended* coefficient planes (``c, n, s, e, w`` pre-scaled by
``-2*lap_scale``; ``pre``, ``post``, ``area`` unscaled) with ``fold_north``
cleared.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...parallel.halo import Strips
from ..stencil import COEF_FIELDS
from .cheb_pass import (
    FIRST, LAST, MAX_FUSE, MIDDLE, PassOperands, _kinds, _pass_args, check_shared,
    coefficient_args, fused_planes, fused_shared_bytes, tiled_pass,
)
from .launch import STEP_ROWS, Kernel, check_grid, placed, pointer, route

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


_KERNEL = Kernel("local_pass", "local_pass", (
    [ctypes.c_int] * 6            # kind, batch, ey, ex, cells, shrink
    + [ctypes.c_void_p] * 11      # field, t, t_prev, t_next, acc, h, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double] * 3       # p_a, p_b, land_gain
    + [ctypes.c_int] * 2          # zap, drop_pre
    + [ctypes.c_void_p]           # stream
))

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
    check_grid(batch, ey, STEP_ROWS, "block", (batch, ey, ex))

    needed = _REQUIRED[kind] + (("field",) if kind == LAST and ops.drop_pre else ())
    ptr = {}
    for name in ("field", "t", "t_prev", "t_next", "acc", "h"):
        if name not in needed:
            ptr[name] = None
            continue
        if bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
        extended = name in _EXTENDED or (name == "field" and kind == FIRST)
        ptr[name] = pointer(name, bufs[name], (batch, ey, ex) if extended else (batch, ly, lx),
                            device, dtype)
    st = ops.stencil
    if st.fold_north:
        raise ValueError("local_pass has no fold: the halos carry the seam")
    coef_ptr, coef_val, masks = coefficient_args(st, (ey, ex), device, dtype)
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")
    _KERNEL(device, dtype, kind, batch, ey, ex, cells, shrink,
            ptr["field"], ptr["t"], ptr["t_prev"], ptr["t_next"], ptr["acc"], ptr["h"],
            *coef_ptr, *coef_val, *masks, float(p_a), float(p_b), float(ops.land_gain),
            int(st.zap_nans), int(ops.drop_pre))


def local_pass(
    ops: PassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    field: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor, h: Optional[Tensor] = None,
) -> None:
    """One step on the extended block, as :func:`local_pass_reference`
    documents it.

    CUDA tensors launch the kernel (counted under ``("local_pass", None)``
    in :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; CPU tensors run the plain version. Anything else raises.
    """
    bufs = dict(field=field, t=t, t_prev=t_prev, t_next=t_next, acc=acc, h=h)
    with route("local_pass", acc.device) as card:
        if card:
            _launch(ops, kind, p_a, p_b, cells, shrink, bufs)
        else:
            local_pass_reference(ops, kind, p_a, p_b, cells=cells, shrink=shrink, **bufs)


# -- a whole round on the extended block, in torch: the strip round's oracle --

def local_fused_pass_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, cells: int, tile=None,
    field: Optional[Tensor] = None, field_own: Optional[Tensor] = None,
    t: Optional[Tensor] = None, t_prev: Optional[Tensor] = None,
    t_out: Optional[Tensor] = None, t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """The plain PyTorch version of one fused round, on any device: steps
    ``start+1 .. start+n_ops`` of the filter (``n_ops <= cells``) as a chain
    of :func:`local_pass_reference`, step j of the round on the window shrunk
    by j (``tile`` is not used).

    A first round (``start == 0``) reads the raw extended ``field``; any other
    reads the extended ``t``, ``t_prev`` and the core-shaped ``acc``. A round
    that ends the filter reconstructs land from the caller's core-shaped
    ``field_own`` and leaves the result in ``acc``; any other writes the core
    of the extended ``t_out`` and ``t_prev_out`` and ``acc``. ``t`` and
    ``t_prev`` are not written.
    """
    first, last = _kinds(p, start, n_ops)
    if n_ops > cells:
        raise ValueError(f"a round runs at most cells = {cells} steps, got {n_ops}")
    if first:
        prev, cur = torch.empty_like(field), torch.empty_like(field)
        local_pass_reference(ops, FIRST, p[0], p[1], cells=cells, shrink=1, field=field,
                             t_next=cur, acc=acc, h=prev)
        j0 = 2
    else:
        cur, prev = t.clone(), t_prev.clone()
        j0 = 1
    for j in range(j0, n_ops + 1):
        k = start + j
        if k == len(p) - 1:
            local_pass_reference(ops, LAST, p[k], cells=cells, field=field_own, t=cur,
                                 t_prev=prev, acc=acc)
        else:
            local_pass_reference(ops, MIDDLE, p[k], cells=cells, shrink=j, t=cur, t_prev=prev,
                                 t_next=prev, acc=acc)
            cur, prev = prev, cur
    if not last:
        _window(t_out, cells).copy_(_window(cur, cells))
        _window(t_prev_out, cells).copy_(_window(prev, cells))


def local_fused_pass_tiled_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, cells: int, tile,
    field: Optional[Tensor] = None, field_own: Optional[Tensor] = None,
    t: Optional[Tensor] = None, t_prev: Optional[Tensor] = None,
    t_out: Optional[Tensor] = None, t_prev_out: Optional[Tensor] = None, acc: Tensor,
) -> None:
    """One fused round computed as the kernel decomposes it, in torch: for
    each ``tile = (by, bx)`` of core cells, a window of ``(by+2H) x
    (bx+2H)`` cells (``H = n_ops``) cut from the extended block as
    ``BlockGeo`` of csrc/cheb_tile.cuh cuts it (no wrap, no fold, rows and
    columns past the block clamped into it: such cells lie more than H cells
    from every core cell), the steps on the window shrunk by j at step j, and
    the core cells kept (:func:`~.cheb_pass.tiled_pass`). Same arguments and
    outputs as :func:`local_fused_pass_reference`, and the same torch
    arithmetic per cell, so the two are equal bit for bit wherever the
    decomposition is right."""
    _, last = _kinds(p, start, n_ops)
    if n_ops > cells:
        raise ValueError(f"a round runs at most cells = {cells} steps, got {n_ops}")
    ly, lx = acc.shape[-2:]
    ey, ex = ly + 2 * cells, lx + 2 * cells

    def rows(r):
        return (r + cells).clamp(0, ey - 1), torch.zeros_like(r, dtype=torch.bool)

    outs = tiled_pass(ops, p, start, n_ops, tile, rows, field=field, field_own=field_own,
                      t=t, t_prev=t_prev, acc=acc, cols=lambda q: (q + cells).clamp(0, ex - 1),
                      width=ex)
    acc.copy_(outs["acc"])
    if not last:
        _window(t_out, cells).copy_(outs["t"])
        _window(t_prev_out, cells).copy_(outs["t_prev"])


# -- the engine's round: the core in place and four halo strips ----------------

# sources of a window cell's state on strips (block_strip_cell of
# csrc/cheb_tile.cuh, strip_cell of csrc/vec_tile.cuh)
OWN, SOUTH, NORTH, WEST, EAST = range(5)


def strip_index(r: Tensor, c: Tensor, cells: int, ly: int, lx: int):
    """``(source, row, column)`` of cell ``(r, c)`` of the extended block
    ``(ly+2*cells, lx+2*cells)`` (integer tensors, broadcast), as the strip
    kernels map it: rows below the core come from the south strip and rows
    above it from the north strip (``(cells, lx+2*cells)`` each, corners
    included), the other rows' columns left of the core from the west strip
    and right of it from the east strip (``(ly, cells)`` each), the core from
    the own planes."""
    k = cells
    south, north = r < k, r >= k + ly
    mid = ~(south | north)
    west, east = mid & (c < k), mid & (c >= k + lx)
    src = torch.where(south, SOUTH, torch.where(north, NORTH, torch.where(
        west, WEST, torch.where(east, EAST, OWN))))
    row = torch.where(south, r, torch.where(north, r - k - ly, r - k))
    col = torch.where(south | north | west, c, torch.where(east, c - k - lx, c - k))
    return src, row, col


def around(own: Tensor, s: Strips) -> Tensor:
    """The extended block the strips ``s`` make around the core ``own``."""
    return torch.cat([s.south, torch.cat([s.west, own, s.east], -1), s.north], -2)


def strip_planes(first: bool, cells: int, field, t, t_prev, strips: Strips):
    """The state of a round on strips as ``{name: (own, strips)}``: the raw
    ``field`` of a first round with the strips of its ``(batch, ...)``
    leading dims, or a later round's core-shaped ``t`` and ``t_prev`` with
    strips of ``(2, batch, ...)`` leading dims, ``t``'s at index 0 and
    ``t_prev``'s at 1 (what :func:`~..parallel.halo.exchange_strips` returns
    for ``(t, t_prev)``). Raises on anything else."""
    if not isinstance(strips, Strips):
        raise TypeError(f"strips must be halo.Strips, got {type(strips).__name__}")
    if first:
        if field is None or t is not None or t_prev is not None:
            raise ValueError("a first round on strips takes the field only")
        planes = {"field": (field, strips)}
    else:
        if t is None or t_prev is None or field is not None:
            raise ValueError("a later round on strips takes t and t_prev only")
        planes = {k: (x, Strips(*(a[i] for a in strips))) for i, (k, x) in
                  enumerate((("t", t), ("t_prev", t_prev)))}
    for own, s in planes.values():
        batch, ly, lx = own.shape
        want = ((batch, cells, lx + 2 * cells),) * 2 + ((batch, ly, cells),) * 2
        if any(tuple(x.shape) != sh for x, sh in zip(s, want)):
            raise ValueError(f"strips {[tuple(x.shape) for x in s]} do not fit a core of "
                             f"{tuple(own.shape)} with a halo of {cells}")
    return planes


def local_strip_pass_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, cells: int, tile=None,
    field: Optional[Tensor] = None, field_own: Optional[Tensor] = None,
    t: Optional[Tensor] = None, t_prev: Optional[Tensor] = None,
    t_out: Optional[Tensor] = None, t_prev_out: Optional[Tensor] = None, acc: Tensor,
    strips: Strips,
) -> None:
    """The plain PyTorch version of one round on strips, on any device.

    ``field`` (a first round), ``t`` and ``t_prev`` (a later one) are
    core-shaped ``(batch, ly, lx)``, ``strips`` their halo strips
    (:func:`strip_planes`); this version assembles the extended blocks from
    them and runs :func:`local_fused_pass_reference`. A round that ends the
    filter leaves the result in ``acc``; any other writes the core-shaped
    ``t_out`` and ``t_prev_out`` and ``acc``."""
    first, last = _kinds(p, start, n_ops)
    ext = {k: around(*v) for k, v in strip_planes(first, cells, field, t, t_prev,
                                                   strips).items()}
    outs = {} if last else {k: acc.new_empty(ext["field" if first else "t"].shape)
                            for k in ("t_out", "t_prev_out")}
    local_fused_pass_reference(ops, p, start, n_ops, cells=cells, field_own=field_own,
                               acc=acc, **ext, **outs)
    if not last:
        t_out.copy_(_window(outs["t_out"], cells))
        t_prev_out.copy_(_window(outs["t_prev_out"], cells))


def local_strip_pass_tiled_reference(
    ops: PassOperands, p, start: int, n_ops: int, *, cells: int, tile,
    field: Optional[Tensor] = None, field_own: Optional[Tensor] = None,
    t: Optional[Tensor] = None, t_prev: Optional[Tensor] = None,
    t_out: Optional[Tensor] = None, t_prev_out: Optional[Tensor] = None, acc: Tensor,
    strips: Strips,
) -> None:
    """One round on strips computed as the kernel decomposes it, in torch:
    :func:`local_fused_pass_tiled_reference`'s windows (``BlockGeo``'s
    clamps), each window cell's state cut from the core planes or a strip by
    :func:`strip_index`, never from an extended block. Same arguments and
    outputs as :func:`local_strip_pass_reference`."""
    first, last = _kinds(p, start, n_ops)
    if n_ops > cells:
        raise ValueError(f"a round runs at most cells = {cells} steps, got {n_ops}")
    ly, lx = acc.shape[-2:]
    ey, ex = ly + 2 * cells, lx + 2 * cells

    def cut(own, s):
        def take(idx):
            src, row, col = strip_index(idx // ex, idx % ex, cells, ly, lx)

            def at(x):
                return x[..., row.clamp(0, x.shape[-2] - 1), col.clamp(0, x.shape[-1] - 1)]

            out = at(own)
            for k, x in ((SOUTH, s.south), (NORTH, s.north), (WEST, s.west), (EAST, s.east)):
                out = torch.where(src == k, at(x), out)
            return out
        return take

    state = {k: cut(*v) for k, v in strip_planes(first, cells, field, t, t_prev,
                                                  strips).items()}

    def rows(r):
        return (r + cells).clamp(0, ey - 1), torch.zeros_like(r, dtype=torch.bool)

    outs = tiled_pass(ops, p, start, n_ops, tile, rows, field_own=field_own, acc=acc,
                      cols=lambda q: (q + cells).clamp(0, ex - 1), width=ex,
                      **{k: state.get(k) for k in ("field", "t", "t_prev")})
    acc.copy_(outs["acc"])
    if not last:
        t_out.copy_(outs["t"])
        t_prev_out.copy_(outs["t_prev"])


_STRIP_KERNEL = Kernel("local_pass", "local_strip_pass", (
    [ctypes.c_int] * 9            # batch, ly, lx, cells, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 2       # own planes: the field or T_k, T_{k-1}
    + [ctypes.c_longlong] * 2     # their batch stride and row pitch
    + [ctypes.c_void_p] * 4       # strips: south, north, west, east
    + [ctypes.c_void_p] * 10      # field_own, acc_in, t_out, t_prev_out, acc_out, c, n, s, e, w
    + [ctypes.c_double] * 5       # immediate c, n, s, e, w
    + [ctypes.c_void_p] * 3       # pre, post, area
    + [ctypes.c_double]           # land_gain
    + [ctypes.c_int] * 2          # zap, drop_pre
    + [ctypes.c_void_p]           # stream
))


def _strip_launch(ops, p, start, n_ops, cells, tile, bufs, strips) -> None:
    first, last = _kinds(p, start, n_ops)
    if not 1 <= n_ops <= min(cells, MAX_FUSE):
        raise ValueError(f"a fused round runs 1..min(cells, {MAX_FUSE}) steps, got {n_ops}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 3:
        raise ValueError(f"local_strip_pass takes a (batch, ly, lx) acc, got {tuple(acc.shape)}")
    batch, ly, lx = acc.shape
    ey, ex = ly + 2 * cells, lx + 2 * cells
    by, bx = tile
    check_grid(batch, ly, by, "block", (batch, ey, ex))
    if cells > min(ly, lx):
        raise ValueError(f"strips of {cells} cells need a core at least as wide, got {(ly, lx)}")
    st = ops.stencil
    if st.fold_north:
        raise ValueError("local_strip_pass has no fold: the strips carry the seam")
    check_shared(fused_shared_bytes(tile, n_ops, fused_planes(ops), acc.element_size()), tile,
                 n_ops)
    outs = () if last else ("t_out", "t_prev_out")
    pa, p_b = _pass_args(p, start, n_ops, first, bufs, ("acc",) + (
        ("field_own",) if last and ops.drop_pre else ()) + outs)
    planes = strip_planes(first, cells, bufs["field"], bufs["t"], bufs["t_prev"], strips)
    reads = [x for own, s in planes.values() for x in (own,) + tuple(s)]
    if any(bufs[o].untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
           for o in outs for x in reads):
        raise ValueError("t_out and t_prev_out must not alias the state the launch reads")
    own = [v[0] for v in planes.values()]
    for x in own:
        placed("own plane", x, device, dtype)
        if x.shape != acc.shape or x.stride(-1) != 1 or x.stride(-2) != own[0].stride(-2) or (
                batch > 1 and x.stride(0) != own[0].stride(0)):
            raise ValueError(f"own planes need acc's shape {tuple(acc.shape)}, a unit column "
                             f"stride and one row pitch and batch stride, got "
                             f"{[(tuple(y.shape), y.stride()) for y in own]}")
    for name, *xs in zip(("south", "north", "west", "east"), *(s for _, s in planes.values())):
        for x in xs:
            pointer(name, x, x.shape, device, dtype)
    if not first and any(b.data_ptr() != a.data_ptr() + a.nbytes
                         for a, b in zip(planes["t"][1], planes["t_prev"][1])):
        raise ValueError("the carries' strips must follow each other in one tensor")
    ptr = {k: pointer(k, bufs[k], acc.shape, device, dtype)
           for k in ("field_own", "t_out", "t_prev_out", "acc")}
    coef_ptr, coef_val, masks = coefficient_args(st, (ey, ex), device, dtype)
    if ops.drop_pre and masks[1] is None:
        raise ValueError("drop_pre needs the wet mask as post")
    head = planes["field" if first else "t"]
    _STRIP_KERNEL(device, dtype, batch, ly, lx, cells, by, bx, n_ops, int(first), int(last),
                  pa, p_b, head[0].data_ptr(),
                  None if first else planes["t_prev"][0].data_ptr(),
                  head[0].stride(0), head[0].stride(1), *(x.data_ptr() for x in head[1]),
                  ptr["field_own"] if last else None, ptr["acc"], ptr["t_out"],
                  ptr["t_prev_out"], ptr["acc"], *coef_ptr, *coef_val, *masks,
                  float(ops.land_gain), int(st.zap_nans), int(ops.drop_pre), detail="shared")


def local_strip_pass(
    ops: PassOperands, p, start: int, n_ops: int, *, cells: int, tile,
    field: Optional[Tensor] = None, field_own: Optional[Tensor] = None,
    t: Optional[Tensor] = None, t_prev: Optional[Tensor] = None,
    t_out: Optional[Tensor] = None, t_prev_out: Optional[Tensor] = None, acc: Tensor,
    strips: Strips,
) -> None:
    """One whole round on the core and its halo strips in one launch, on
    tiles of ``tile = (by, bx)`` core cells, as
    :func:`local_strip_pass_reference` documents it: the sharded engine's
    round.

    CUDA tensors launch the kernel on the current stream, without
    synchronizing, counted under ``("local_strip_pass", "shared")`` in
    :func:`~.launch.launch_counts` and with ``path="shared"`` on the span, as
    :func:`~.cheb_pass.cheb_fused_pass` counts its launches: the strip round
    always steps in shared memory, since its register steps would spill. CPU
    tensors run the plain version. Anything else raises.
    """
    bufs = dict(field=field, field_own=field_own, t=t, t_prev=t_prev, t_out=t_out,
                t_prev_out=t_prev_out, acc=acc)
    with route("local_strip_pass", acc.device, "shared") as card:
        if card:
            _strip_launch(ops, p, start, n_ops, cells, tuple(tile), bufs, strips)
        else:
            local_strip_pass_reference(ops, p, start, n_ops, cells=cells, strips=strips, **bufs)
