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

:func:`vec_local_fused_pass` runs a whole round, or a part of one, in one
launch on the shared-memory tiles of ``csrc/vec_tile.cuh`` (entries
``vec_local_fused_pass_f32/f64`` of ``csrc/vec_pass.cu``): the counterpart of
the JAX sharded engine's one coupled Pallas call per round. A round's first
launch takes its state as the core planes and their four halo strips
(:func:`strip_state`, ``halo.exchange_strips``) and runs the strip entry
``vec_local_strip_pass_f32/f64``, which reads each window cell where it lies
(:func:`strip_index`), so the engine builds no extended block of the state;
the round's later launches read the extended carries the launch before
wrote. :func:`vec_local_fused_pass_reference` is its plain version (the same
steps as a chain of :func:`vec_local_pass_reference`, so the two routes give
the same bits), :func:`vec_local_fused_pass_tiled_reference` the kernel's
tile decomposition in torch, and :func:`plan_vec_local_rounds` the planner:
the tile and the split of each round into launches, and the static
predicate.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ...parallel.halo import Strips
from ..ctaps import CTAPS
from ..stencil import BGRID_DIFF
from .cheb_pass import (
    FIRST, LAST, MAX_FUSE, MIDDLE, SHARED_BYTES, FusedPlan, _kinds, _pass_args, check_shared,
    search_plan,
)
from .launch import STEP_ROWS, Kernel, check_grid, placed, pointer, route
from .local_pass import EAST, NORTH, SOUTH, WEST, _window, around, strip_index
from .vec_pass import (
    BGRID, CTAP, N_COEF, VecPassOperands, _vec_pass_cost, vec_fused_shared_bytes, vec_tiles,
)

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


_KERNEL = Kernel("vec_pass", "vec_local_pass", (
    [ctypes.c_int] * 7            # op, kind, batch, ey, ex, cells, shrink
    + [ctypes.c_void_p] * 6       # w, t, t_prev, t_next, acc, coef
    + [ctypes.c_double] * 2       # p_a, p_b
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))

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
    check_grid(batch, ey, STEP_ROWS, "block", (batch, 2, ey, ex))
    ptr = {}
    for name in ("w", "t", "t_prev", "t_next", "acc"):
        if name not in _REQUIRED[kind]:
            ptr[name] = None
        elif bufs[name] is None:
            raise ValueError(f"step kind {kind} needs {name}")
        else:
            ptr[name] = pointer(name, bufs[name],
                                acc.shape if name == "acc" else (batch, 2, ey, ex), device, dtype)
    coef = pointer("coef", ops.coef, (N_COEF[ops.op], ey, ex), device, dtype)
    _KERNEL(device, dtype, ops.op, kind, batch, ey, ex, cells, shrink, ptr["w"], ptr["t"],
            ptr["t_prev"], ptr["t_next"], ptr["acc"], coef, float(p_a), float(p_b),
            int(ops.zap), detail=ops.op)


def vec_local_pass(
    ops: VecPassOperands, kind: int, p_a: float, p_b: float = 0.0, *,
    cells: int, shrink: Optional[int] = None,
    w: Optional[Tensor] = None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_next: Optional[Tensor] = None,
    acc: Tensor,
) -> None:
    """One coupled step on the extended block, as
    :func:`vec_local_pass_reference` documents it.

    CUDA tensors launch the kernel (counted per contraction under
    ``("vec_local_pass", BGRID)`` and ``("vec_local_pass", CTAP)`` in
    :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; CPU tensors run the plain version. Anything else raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_next=t_next, acc=acc)
    with route("vec_local_pass", acc.device) as card:
        if card:
            _launch(ops, kind, p_a, p_b, cells, shrink, bufs)
        else:
            vec_local_pass_reference(ops, kind, p_a, p_b, cells=cells, shrink=shrink, **bufs)


# -- the fused round: a whole round, or part of one, per launch ---------------

@functools.lru_cache(maxsize=None)
def _round_plan(n_steps: int, ly: int, lx: int, itemsize: int, op: int) -> FusedPlan:
    def fits(tile, halo):
        by, bx = tile
        return (ly >= by + 2 * halo and lx >= bx + 2 * halo
                and vec_fused_shared_bytes(tile, halo, N_COEF[op], itemsize) <= SHARED_BYTES)

    return search_plan(n_steps, ly, lx, MAX_FUSE, vec_tiles(op, itemsize), fits,
                       lambda tile, steps: _vec_pass_cost(op, tile, steps, itemsize))


def plan_vec_local_rounds(rounds, ly: int, lx: int, dtype: torch.dtype,
                          op: int) -> Tuple[FusedPlan, ...]:
    """One fused plan per round of the sharded vector engine on an ``(ly,
    lx)`` core: the counterpart of the JAX ``_plan_local_coupled``.

    A round of ``n`` steps is planned as the unsharded planner plans a vector
    filter of ``n`` steps (``search_plan`` over ``vec_tiles`` with the cost
    model ``_vec_pass_cost``, fitted to the tile sweeps of ``chip_smoke.py``):
    one launch of ``n`` steps (split (a)) or a balanced split into several
    launches with no exchange between them (split (b)), on the tile the
    model scores cheapest among those whose window, a tile plus its halo in
    each dimension, fits in the core, since the shards of a real mesh are
    small. On the 2400x3600 headline the plans are the unsharded ones.
    ``plan.fused`` is the static predicate: False where no tile plus its halo
    fits in the core, and the step chain then runs.
    """
    itemsize = torch.empty((), dtype=dtype).element_size()
    if op not in N_COEF:
        raise ValueError(f"unknown vector contraction {op}")
    return tuple(_round_plan(int(n), int(ly), int(lx), itemsize, int(op)) for n in rounds)


# -- a round's first launch on the core and its four halo strips --------------

def _strip_cut(own, s: Strips, ridx: Tensor, cidx: Tensor, cells: int) -> Tensor:
    """The ``(batch, 2, len(ridx), len(cidx))`` state of extended rows
    ``ridx`` and columns ``cidx``, cut from the own planes ``own = (u, v)``
    and the strips ``s`` of one carry by :func:`strip_index`."""
    ly, lx = own[0].shape[-2:]
    src, row, col = strip_index(ridx[:, None], cidx[None, :], cells, ly, lx)

    def take(x):
        return x[..., row.clamp(0, x.shape[-2] - 1), col.clamp(0, x.shape[-1] - 1)]

    out = torch.stack([take(x) for x in own], 1)
    for k, x in ((SOUTH, s.south), (NORTH, s.north), (WEST, s.west), (EAST, s.east)):
        out = torch.where(src == k, take(x), out)
    return out


def strip_state(first: bool, cells: int, w, t, t_prev, strips: Strips):
    """The state of a round's first launch as ``((own, strips), ...)``, one
    pair a carry: ``own`` the carry's (u, v) core planes, ``(batch, ly, lx)``
    each, ``strips`` its :class:`~..parallel.halo.Strips`.

    The filter's first launch reads ``w = (u, v)``, the caller's planes, and
    strips of ``(batch, 2)`` leading dims; a later round's first launch reads
    ``t`` and ``t_prev``, core-shaped ``(batch, 2, ly, lx)`` (the cores of
    the previous round's carries, views of them in place), and strips of
    ``(2, batch, 2)`` leading dims, ``t``'s at index 0 and ``t_prev``'s at 1:
    what :func:`~..parallel.halo.exchange_strips` returns for ``(u, v)``
    stacked along dim 1 and for ``(t, t_prev)`` stacked along dim 0."""
    if not isinstance(strips, Strips):
        raise TypeError(f"strips must be halo.Strips, got {type(strips).__name__}")
    if first:
        if w is None or len(w) != 2 or t is not None or t_prev is not None:
            raise ValueError("the filter's first launch on strips takes w = (u, v) only")
        pairs = ((tuple(w), strips),)
    else:
        if t is None or t_prev is None or w is not None:
            raise ValueError("a later round's first launch on strips takes t and t_prev only")
        pairs = tuple((x.unbind(1), Strips(*(a[i] for a in strips)))
                      for i, x in enumerate((t, t_prev)))
    for own, s in pairs:
        batch, ly, lx = own[0].shape
        want = ((batch, 2, cells, lx + 2 * cells),) * 2 + ((batch, 2, ly, cells),) * 2
        if any(x.shape != (batch, ly, lx) for x in own) or any(
                tuple(x.shape) != sh for x, sh in zip(s, want)):
            raise ValueError(f"strips {[tuple(x.shape) for x in s]} do not fit planes "
                             f"{[tuple(x.shape) for x in own]} with a halo of {cells}")
    return pairs


def vec_local_fused_pass_reference(
    ops: VecPassOperands, p, start: int, n_ops: int, *, cells: int,
    shrink: Optional[int] = None, tile=None,
    w=None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor, strips: Optional[Strips] = None,
) -> None:
    """The plain PyTorch version of one fused launch, on any device: steps
    ``start+1 .. start+n_ops`` of the filter as a chain of
    :func:`vec_local_pass_reference`, ending on the block shrunk by
    ``shrink`` (default ``cells``: the core), so that step i of the launch
    runs on the block shrunk by ``shrink - n_ops + i`` (``tile`` is not
    used).

    ``w``, ``t``, ``t_prev``, ``t_out`` and ``t_prev_out`` are extended
    ``(batch, 2, ly+2*cells, lx+2*cells)`` buffers and ``acc`` is core-shaped
    ``(batch, 2, ly, lx)``. A first launch (``start == 0``) reads the
    extended input ``w``; any other reads ``t`` and ``t_prev``, exact on the
    block shrunk by ``shrink - n_ops``, and ``acc``. A launch that ends the
    filter leaves the result in ``acc``; any other writes ``acc`` and the
    carries on the block shrunk by ``shrink`` into ``t_out`` and
    ``t_prev_out`` (nothing outside it). The inputs are not written.

    With ``strips`` (a round's first launch, :func:`strip_state`), the state
    is the core and its halo strips: this version assembles the extended
    blocks from them and runs as above.
    """
    first, last = _kinds(p, start, n_ops)
    if strips is not None:
        pairs = strip_state(first, cells, w, t, t_prev, strips)
        ext = [around(torch.stack(own, 1), s) for own, s in pairs]
        w, t, t_prev = (ext[0], None, None) if first else (None, ext[0], ext[1])
    shrink = cells if shrink is None else shrink
    if not 1 <= n_ops <= shrink <= cells:
        raise ValueError(f"need 1 <= n_ops <= shrink <= cells, got n_ops {n_ops}, "
                         f"shrink {shrink}, cells {cells}")
    s0 = shrink - n_ops  # the carries read are exact on the block shrunk by s0
    if first:
        cur, prev = torch.empty_like(w), w.clone()
        vec_local_pass_reference(ops, FIRST, p[0], p[1], cells=cells, shrink=1, w=w,
                                 t_next=cur, acc=acc)
        done = 1
    else:
        cur, prev = t.clone(), t_prev.clone()
        done = 0
    for i in range(done, n_ops):
        k = start + i + 1
        if k == len(p) - 1:
            vec_local_pass_reference(ops, LAST, p[k], cells=cells, t=cur, t_prev=prev, acc=acc)
        else:
            vec_local_pass_reference(ops, MIDDLE, p[k], cells=cells, shrink=s0 + i + 1, t=cur,
                                     t_prev=prev, t_next=prev, acc=acc)
            cur, prev = prev, cur
    if not last:
        _window(t_out, shrink).copy_(_window(cur, shrink))
        _window(t_prev_out, shrink).copy_(_window(prev, shrink))


def vec_local_fused_pass_tiled_reference(
    ops: VecPassOperands, p, start: int, n_ops: int, *, cells: int, tile,
    shrink: Optional[int] = None,
    w=None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor, strips: Optional[Strips] = None,
) -> None:
    """One fused launch computed as the kernel decomposes it, in torch.

    The own region is the extended block shrunk by ``shrink``. For each
    ``tile = (by, bx)`` of it: cut a window of ``(by+2H) x (bx+2H)`` cells
    (``H = n_ops``) from the extended block, with its corners (rows and
    columns past the block clamped, as the kernel's loads are), of the state
    of both components and of every coefficient plane; run the steps on the
    window shrunk by j at step j, with the contraction of the local step's
    plain version (each cell in its order of summation); keep the own cells
    of the carries, and acc of the own cells that lie in the core only. Same
    arguments and outputs as :func:`vec_local_fused_pass_reference`, so the
    two are equal bit for bit wherever the decomposition is right. With
    ``strips`` each window's state is cut from the own planes and the strips
    by the kernel's index map (:func:`strip_index`), never from an extended
    block.
    """
    first, last = _kinds(p, start, n_ops)
    pairs = None if strips is None else strip_state(first, cells, w, t, t_prev, strips)
    shrink = cells if shrink is None else shrink
    by, bx = tile
    H = n_ops
    margin = cells - shrink
    batch, _, ly, lx = acc.shape
    ey, ex = ly + 2 * cells, lx + 2 * cells
    rows, cols = ly + 2 * margin, lx + 2 * margin  # the own region
    dev = acc.device
    outs = {"acc": acc.clone()}
    if not last:
        outs["t"], outs["t_prev"] = t_out.clone(), t_prev_out.clone()

    for y0 in range(0, rows, by):
        ridx = (torch.arange(y0 - H, y0 + by + H, device=dev) + shrink).clamp(0, ey - 1)
        oy = min(by, rows - y0)  # own rows inside the region
        cy = (max(y0, margin), min(y0 + oy, margin + ly))  # own rows in the core
        for x0 in range(0, cols, bx):
            cidx = (torch.arange(x0 - H, x0 + bx + H, device=dev) + shrink).clamp(0, ex - 1)
            cut = lambda x: x[..., ridx[:, None], cidx[None, :]]  # noqa: E731
            wops = VecPassOperands(ops.op, cut(ops.coef), ops.zap)
            if pairs is not None:
                state = [_strip_cut(*pair, ridx, cidx, cells) for pair in pairs]
            else:
                state = [cut(w)] if first else [cut(t), cut(t_prev)]
            cur = state[0]
            prev = torch.empty_like(cur) if first else state[1]
            wy, wx = cur.shape[-2:]
            ox = min(bx, cols - x0)
            cx = (max(x0, margin), min(x0 + ox, margin + lx))
            sums = cy[0] < cy[1] and cx[0] < cx[1]  # the tile holds core cells
            core = (Ellipsis, slice(cy[0] - margin, cy[1] - margin),
                    slice(cx[0] - margin, cx[1] - margin))
            a = None if first or not sums else acc[core]
            for i in range(H):
                j = i + 1
                kind = FIRST if first and i == 0 else LAST if last and i == H - 1 else MIDDLE
                sl = (Ellipsis, slice(j, wy - j), slice(j, wx - j))
                lap = _lap(wops, cur, j)
                # the tile's core cells inside this step's window
                o = (Ellipsis, slice(cy[0] - y0 + H - j, cy[1] - y0 + H - j),
                     slice(cx[0] - x0 + H - j, cx[1] - x0 + H - j))
                if kind == FIRST:
                    h0 = cur[sl]
                    t1 = -h0 + 0.5 * lap
                    prev[sl] = t1
                    if sums:
                        a = p[0] * h0[o] + p[1] * t1[o]
                    cur, prev = prev, cur
                    continue
                nxt = -2.0 * cur[sl] + lap - prev[sl]
                if sums:
                    a = a + p[start + i + 1] * nxt[o]
                if kind == MIDDLE:
                    prev[sl] = nxt
                    cur, prev = prev, cur
            if sums:
                outs["acc"][core] = a
            if not last:
                own = (Ellipsis, slice(H, H + oy), slice(H, H + ox))
                dst = (Ellipsis, slice(y0 + shrink, y0 + shrink + oy),
                       slice(x0 + shrink, x0 + shrink + ox))
                outs["t"][dst] = cur[own]
                outs["t_prev"][dst] = prev[own]
    acc.copy_(outs["acc"])
    if not last:
        t_out.copy_(outs["t"])
        t_prev_out.copy_(outs["t_prev"])


_FUSED_KERNEL = Kernel("vec_pass", "vec_local_fused_pass", (
    [ctypes.c_int] * 11           # op, batch, ly, lx, cells, shrink, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 8       # w, t, t_prev, acc_in, t_out, t_prev_out, acc_out, coef
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))
_STRIP_KERNEL = Kernel("vec_pass", "vec_local_strip_pass", (
    [ctypes.c_int] * 11           # op, batch, ly, lx, cells, shrink, by, bx, n_ops, first, last
    + [ctypes.c_void_p, ctypes.c_double]  # pa (host doubles), p_b
    + [ctypes.c_void_p] * 4       # own planes: u, v of T_k (w), then of T_{k-1}
    + [ctypes.c_longlong] * 2     # their batch stride and row pitch
    + [ctypes.c_void_p] * 4       # strips: south, north, west, east
    + [ctypes.c_void_p] * 5       # acc_in, t_out, t_prev_out, acc_out, coef
    + [ctypes.c_int]              # zap
    + [ctypes.c_void_p]           # stream
))


def _own_args(pairs, device, dtype):
    """The own planes' pointers (four; a first launch's T_{k-1} null), batch
    stride and row pitch, after checking them: unit column stride, one
    batch stride and one pitch for all of them."""
    planes = [x for own, _ in pairs for x in own]
    batch = planes[0].shape[0]
    for x in planes:
        placed("own plane", x, device, dtype)
        if x.stride(-1) != 1 or x.stride(-2) != planes[0].stride(-2) or (
                batch > 1 and x.stride(0) != planes[0].stride(0)):
            raise ValueError(f"own planes need a unit column stride and one row pitch and "
                             f"batch stride, got strides {[y.stride() for y in planes]}")
    ptrs = [x.data_ptr() for x in planes] + [None] * (4 - len(planes))
    return ptrs, planes[0].stride(0), planes[0].stride(-2)


def _strip_args(pairs, device, dtype):
    """The pointers of the four strips of T_k (the kernel finds T_{k-1}'s
    right after them), after checking them: contiguous, and on a later
    round's launch both carries' strips in one tensor each."""
    for name, *xs in zip(("south", "north", "west", "east"), *(s for _, s in pairs)):
        for x in xs:
            pointer(name, x, x.shape, device, dtype)
        if len(xs) == 2 and xs[1].data_ptr() != xs[0].data_ptr() + xs[0].nbytes:
            raise ValueError(f"{name}: the carries' strips must follow each other in one tensor")
    return [x.data_ptr() for x in pairs[0][1]]


def _fused_launch(ops, p, start, n_ops, cells, shrink, tile, bufs, strips) -> None:
    first, last = _kinds(p, start, n_ops)
    if not 1 <= n_ops <= min(shrink, MAX_FUSE) or shrink > cells:
        raise ValueError(f"a fused launch runs 1..min(shrink, {MAX_FUSE}) steps with "
                         f"shrink <= cells, got n_ops {n_ops}, shrink {shrink}, cells {cells}")
    if ops.op not in N_COEF:
        raise ValueError(f"unknown vector contraction {ops.op}")
    acc = bufs["acc"]
    dtype, device = acc.dtype, acc.device
    if acc.dim() != 4 or acc.shape[1] != 2:
        raise ValueError(
            f"vec_local_fused_pass takes a (batch, 2, ly, lx) acc, got {tuple(acc.shape)}")
    batch, _, ly, lx = acc.shape
    ey, ex = ly + 2 * cells, lx + 2 * cells
    by, bx = tile
    check_grid(batch, ly + 2 * (cells - shrink), by, "block", (batch, 2, ey, ex))
    check_shared(vec_fused_shared_bytes(tile, n_ops, N_COEF[ops.op], acc.element_size()), tile,
                 n_ops)
    outs = () if last else ("t_out", "t_prev_out")
    state = () if strips is not None else ("w",) if first else ("t", "t_prev")
    pa, p_b = _pass_args(p, start, n_ops, first, bufs, ("acc",) + state + outs)
    if strips is not None:
        pairs = strip_state(first, cells, bufs["w"], bufs["t"], bufs["t_prev"], strips)
        if pairs[0][0][0].shape[0] != batch:
            raise ValueError(f"own planes of batch {pairs[0][0][0].shape[0]}, acc of {batch}")
        reads = [x for own, s in pairs for x in own + tuple(s)]
    else:
        reads = [bufs[k] for k in state]
    if any(bufs[o].untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
           for o in outs for x in reads):
        raise ValueError("t_out and t_prev_out must not alias the state the launch reads")
    ptr = {k: pointer(k, bufs[k], acc.shape if k == "acc" else (batch, 2, ey, ex), device, dtype)
           if k in ("acc",) + state + outs else None
           for k in ("w", "t", "t_prev", "t_out", "t_prev_out", "acc")}
    coef = pointer("coef", ops.coef, (N_COEF[ops.op], ey, ex), device, dtype)
    head = (ops.op, batch, ly, lx, cells, shrink, by, bx, n_ops, int(first), int(last), pa, p_b)
    if strips is None:
        _FUSED_KERNEL(device, dtype, *head, ptr["w"], ptr["t"], ptr["t_prev"], ptr["acc"],
                      ptr["t_out"], ptr["t_prev_out"], ptr["acc"], coef, int(ops.zap),
                      detail=ops.op)
    else:
        own, own_batch, own_pitch = _own_args(pairs, device, dtype)
        _STRIP_KERNEL(device, dtype, *head, *own, own_batch, own_pitch,
                      *_strip_args(pairs, device, dtype), ptr["acc"], ptr["t_out"],
                      ptr["t_prev_out"], ptr["acc"], coef, int(ops.zap), detail=ops.op)


def vec_local_fused_pass(
    ops: VecPassOperands, p, start: int, n_ops: int, *, cells: int, tile,
    shrink: Optional[int] = None,
    w=None, t: Optional[Tensor] = None,
    t_prev: Optional[Tensor] = None, t_out: Optional[Tensor] = None,
    t_prev_out: Optional[Tensor] = None, acc: Tensor, strips: Optional[Strips] = None,
) -> None:
    """Steps ``start+1 .. start+n_ops`` of the vector filter on the extended
    block in one launch, on tiles of ``tile = (by, bx)`` cells of the block
    shrunk by ``shrink`` (default ``cells``: the core), as
    :func:`vec_local_fused_pass_reference` documents them.

    Which entry runs is static, given by the arguments: with ``strips`` (a
    round's first launch) the strip entry ``vec_local_strip_pass_f32/f64``,
    which reads the state in place from the core planes and the strips
    (:func:`strip_state`), else the extended-block entry
    ``vec_local_fused_pass_f32/f64``. CUDA tensors launch the kernel
    (counted per contraction under ``("vec_local_fused_pass", op)`` for the
    extended-block entry and ``("vec_local_strip_pass", op)`` for the strip
    entry in :func:`~.launch.launch_counts`) on the current stream, without
    synchronizing; CPU tensors run the plain version. Anything else raises.
    """
    bufs = dict(w=w, t=t, t_prev=t_prev, t_out=t_out, t_prev_out=t_prev_out, acc=acc)
    shrink = cells if shrink is None else shrink
    with route("vec_local_fused_pass", acc.device) as card:
        if card:
            _fused_launch(ops, p, start, n_ops, cells, shrink, tuple(tile), bufs, strips)
        else:
            vec_local_fused_pass_reference(ops, p, start, n_ops, cells=cells, shrink=shrink,
                                           strips=strips, **bufs)
