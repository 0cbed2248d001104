"""Halo exchange primitives for a field sharded over a 2-D (y, x) mesh.

PyTorch-port counterpart of ``gcm_filters_tpu/parallel/halo.py``. Each rank
holds one ``(..., ly, lx)`` block of the global field; a radius-1 stencil
neighbour access across a block edge becomes a point-to-point message over
``torch.distributed``:

  - periodic wrap in x and y falls out of the ring of ranks,
  - the tripolar north fold pairs top-row rank (y=Y-1, x=i) with
    (y=Y-1, x=X-1-i) and reverses the exchanged rows in x.

An *axis* is ``(group, size)``: the process group of one mesh dimension (its
ranks ordered by their index along that dimension) and its size. ``group``
``None`` or ``size`` 1 means the axis is not sharded: it wraps locally, with
no message and no initialised process group. Where JAX posts one
``lax.ppermute`` per phase, a rank here posts all its sends and receives of
the phase in one ``torch.distributed.batch_isend_irecv`` and waits on them
all, on NCCL (CUDA tensors) and gloo (CPU tensors) alike. A rank whose
partner is itself copies locally and posts nothing.

``exchange_strips`` returns a block's four k-cell halo strips and builds no
extended block; ``exchange_2d`` is the strips concatenated around the
block. Both post the same messages, so the pattern lives in one place.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axis = Tuple[Optional[object], Optional[int]]
Fields = Union[Tensor, Sequence[Tensor]]  # a field, or fields that ride as one stack


def _sharded(axis: Axis) -> bool:
    group, size = axis
    return group is not None and size is not None and size > 1


def _group_index(group) -> int:
    """This rank's index along the mesh dimension of ``group``."""
    return dist.get_rank(group)


def _exchange(group, sends: Sequence[Tuple[Tensor, int, int]], tag0: int = 0) -> List[Tensor]:
    """One phase: for every ``(tensor, dst, src)`` send ``tensor`` to group
    index ``dst`` and receive a tensor of the same shape from group index
    ``src``. Returns the received tensors in order. Message ``m`` of the
    phase carries tag ``tag0 + m``, so two messages between one pair cannot
    swap (gloo matches by tag; NCCL by the order within the batch)."""
    ops, received = [], []
    for tag, (x, dst, src) in enumerate(sends, tag0):
        x = x.contiguous()
        r = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group, tag))
        ops.append(dist.P2POp(dist.irecv, r, dist.get_global_rank(group, src), group, tag))
        received.append(r)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return received


def _ring(f_to_next: Tensor, f_to_prev: Tensor, axis: Axis) -> Tuple[Tensor, Tensor]:
    """Send one slice up the ring (d -> d+1) and one down (d -> d-1); return
    (what the previous rank sent up, what the next rank sent down)."""
    group, size = axis
    d = _group_index(group)
    nxt, prv = (d + 1) % size, (d - 1) % size
    from_prev, from_next = _exchange(group, [(f_to_next, nxt, prv), (f_to_prev, prv, nxt)])
    return from_prev, from_next


def _take(f: Tensor, sl: slice, dim: int) -> Tensor:
    idx = [slice(None)] * f.dim()
    idx[dim] = sl
    return f[tuple(idx)]


def shifted(f: Tensor, shift: int, dim: int, axis: Axis) -> Tensor:
    """Global ``torch.roll(f, shift, dim)`` on a sharded block.

    shift=+1 brings each cell its west/south neighbour's value; shift=-1 its
    east/north neighbour's. An unsharded axis reduces to a local roll.
    """
    if shift not in (+1, -1):
        raise ValueError(f"shift must be +1 or -1, got {shift}")
    if not _sharded(axis):
        return torch.roll(f, shift, dim)
    last, first = _take(f, slice(-1, None), dim), _take(f, slice(None, 1), dim)
    from_prev, from_next = _ring(last, first, axis)
    if shift == +1:
        return torch.cat([from_prev, _take(f, slice(None, -1), dim)], dim=dim)
    return torch.cat([_take(f, slice(1, None), dim), from_next], dim=dim)


def _fold_partner(chunk: Tensor, x_axis: Axis) -> Tensor:
    """The seam partner's ``chunk``: rank i of the x axis pairs with X-1-i
    (itself when x is unsharded or i is the middle of an odd X)."""
    if not _sharded(x_axis):
        return chunk
    group, size = x_axis
    i = _group_index(group)
    partner = size - 1 - i
    if partner == i:
        return chunk
    return _exchange(group, [(chunk, partner, partner)], tag0=2)[0]


def fold_row(g: Tensor, x_axis: Axis) -> Tensor:
    """The tripolar fold partner of the local top row, reversed in x.

    Rank (y_top, i) pairs with (y_top, X-1-i); with x unsharded the row is
    reversed locally. Returns shape (..., 1, lx). Only the ranks of the top
    mesh row call it (the x group holds ranks of one mesh row).
    """
    return _fold_partner(g[..., -1:, :], x_axis).flip(-1)


def extend_x(f: Tensor, k: int, x_axis: Axis) -> Tensor:
    """Extend the last dim by k-cell periodic halos: (..., lx) -> (..., lx+2k).

    West halo = the west neighbour's last k columns, east halo = the east
    neighbour's first k columns. Unsharded x wraps locally.
    """
    lo, hi = f[..., -k:], f[..., :k]
    if _sharded(x_axis):
        lo, hi = _ring(lo, hi, x_axis)
    return torch.cat([lo, f, hi], dim=-1)


class Strips(NamedTuple):
    """The four k-cell halo strips of a ``(..., ly, lx)`` block: ``south``
    and ``north`` ``(..., k, lx+2k)``, corners included, ``west`` and
    ``east`` ``(..., ly, k)``; contiguous. Around the block they make the
    extended block of :func:`exchange_2d`."""

    south: Tensor
    north: Tensor
    west: Tensor
    east: Tensor


def _edge(f: Fields, sl: slice, dim: int, stack_dim: int) -> Tensor:
    """The slice ``sl`` of ``f`` along ``dim``, or of each of a sequence of
    fields, stacked along ``stack_dim``."""
    if isinstance(f, Tensor):
        return _take(f, sl, dim)
    return torch.stack([_take(x, sl, dim) for x in f], dim=stack_dim)


def _x_rows(f: Fields, west: Tensor, east: Tensor, rows: slice, stack_dim: int) -> Tensor:
    """Rows ``rows`` of the x-extended block ``cat([west, f, east], -1)``,
    without building it."""
    return torch.cat([west[..., rows, :], _edge(f, rows, -2, stack_dim), east[..., rows, :]],
                     dim=-1)


def exchange_strips(
    f: Fields,
    k: int,
    y_axis: Axis,
    x_axis: Axis,
    fold_north: bool = False,
    fold_src: Optional[Fields] = None,
    stack_dim: int = 0,
) -> Strips:
    """The k-cell halos of (..., ly, lx) on both spatial dims as four
    :class:`Strips`, without building the extended block.

    Two phases: x first, then y over the x-extended edge rows so corner data
    rides along (k steps of a radius-1 stencil reach the diagonal
    neighbours' corners). With ``fold_north``, the north halo of the top mesh
    row is the tripolar seam partner's top k rows, reversed in x and flipped
    in y (extended row ly-1+m = real row ly-m reversed). ``fold_src``
    supplies another source for that chunk: the seam reflection swaps the
    n<->s and e<->w stencil coefficients, so coefficient planes fold from
    their swapped partner. Leading dims ride along in the same messages.

    ``f`` (and ``fold_src``) may be a sequence of fields of one shape, which
    ride as one stacked along ``stack_dim``: only their edges are stacked,
    and the messages are those of the stacked field. Whatever ``f`` is, the
    messages are :func:`exchange_2d`'s: the same phases, partners, tags and
    bytes.
    """
    west, east = _edge(f, slice(-k, None), -1, stack_dim), _edge(f, slice(None, k), -1, stack_dim)
    if _sharded(x_axis):
        west, east = _ring(west, east, x_axis)
    south = _x_rows(f, west, east, slice(-k, None), stack_dim)
    north = _x_rows(f, west, east, slice(None, k), stack_dim)
    on_top = True
    if _sharded(y_axis):
        south, north = _ring(south, north, y_axis)
        on_top = _group_index(y_axis[0]) == y_axis[1] - 1
    if fold_north and on_top:
        if fold_src is None:
            top = _x_rows(f, west, east, slice(-k, None), stack_dim)
        else:
            fw = _edge(fold_src, slice(-k, None), -1, stack_dim)
            fe = _edge(fold_src, slice(None, k), -1, stack_dim)
            if _sharded(x_axis):
                fw, fe = _ring(fw, fe, x_axis)
            top = _x_rows(fold_src, fw, fe, slice(-k, None), stack_dim)
        north = _fold_partner(top.flip(-2, -1), x_axis)
    return Strips(*(s.contiguous() for s in (south, north, west, east)))


def exchange_2d(
    f: Tensor,
    k: int,
    y_axis: Axis,
    x_axis: Axis,
    fold_north: bool = False,
    fold_src: Optional[Tensor] = None,
) -> Tensor:
    """Extend (..., ly, lx) by k-cell halos on both spatial dims: the
    :func:`exchange_strips` of ``f`` around it, (..., ly+2k, lx+2k)."""
    s = exchange_strips(f, k, y_axis, x_axis, fold_north, fold_src)
    return torch.cat([s.south, torch.cat([s.west, f, s.east], dim=-1), s.north], dim=-2)


def north_neighbor_sharded(g: Tensor, fold_north: bool, y_axis: Axis, x_axis: Axis) -> Tensor:
    """Sharded counterpart of ops.stencil.north_neighbor."""
    gn = shifted(g, -1, -2, y_axis)
    if not fold_north:
        return gn
    if _sharded(y_axis) and _group_index(y_axis[0]) != y_axis[1] - 1:
        return gn
    # the top mesh row replaces its wrap halo with the fold row
    return torch.cat([g[..., 1:, :], fold_row(g, x_axis)], dim=-2)
