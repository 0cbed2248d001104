"""Sharded filter execution: 2-D spatial domain decomposition over a mesh.

PyTorch-port counterpart of ``gcm_filters_tpu/parallel/sharded.py``, scalar
and vector engines. The (y, x) field is sharded over a
``torch.distributed.device_mesh.DeviceMesh`` with named dims; every rank runs
the same program on its ``(ly, lx)`` block.

Communication is *round-based* (wide halos): each round exchanges a
``cells``-wide halo once (two message phases, corners riding the second,
halo.py) and then advances the recurrence up to ``cells`` steps purely
locally on the halo-extended block (ops/cuda/local_pass.py for scalars: one
launch of the fused round where its static predicate holds;
ops/cuda/vec_local_pass.py for (u, v) pairs: the planned fused launches of
each round, one or a few; else one step launch per step; kernels on CUDA
tensors, their plain versions on CPU tensors). The
tripolar fold is a reversed pairing among the ranks of the top mesh row, and the stencil
coefficients are halo-extended once per (local shape, dtype) with the seam's
n<->s / e<->w coefficient swap in their fold chunks. Vector grids have no
fold; the C-grid operator runs in its tap-expanded form (ops/ctaps.py), whose
reach is 1 cell per step where the staged form's is 2, with the taps computed
from the global operator on the host and sharded like the field.

The per-cell arithmetic inside a round is the unsharded step kernel's, so
sharded results match unsharded ones to roundoff.

Leading batch dims stay local to each rank unless ``batch_axis`` names a mesh
dim to shard them over (dim 0 of ``(batch, y, x)`` fields only).

The ring engine hook sits where the JAX module has it, at the top of both
applies (``_ring_hook``): a 1-D y-sharded mesh whose shards the ring step
kernel can reach by pointer goes through parallel/ring.py instead of the
rounds. The hook is a static predicate, never a ``try`` around a launch. It
declines every ``DeviceMesh`` for now: between ranks the kernel's halo
pointers would have to come from peer access, which is not set up, so the
rounds below run (the JAX package's own default on real hardware). Shards
held by one process on one card run the ring through
``Filter(mesh=ResidentMesh(...))``, which does not come through this module.

What the JAX module has and this one leaves out, as TPU layout: the VMEM /
sublane / lane-padding planners of the scalar and coupled passes, the packed
coefficient blocks, and a second (XLA) local compute with its compile
fallback (the port has no fallback tier).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..engine import _compute_dtype, _laplacian_scale
from ..filter_spec import FilterSpec
from ..ops.cuda.cheb_pass import (
    FIRST, LAST, MIDDLE, PassOperands, fused_planes, plan_fused_passes,
)
from ..ops.ctaps import CTAP_NAMES, cgrid_tap_arrays
from ..ops.cuda.local_pass import local_fused_pass, local_pass
from ..ops.cuda.vec_local_pass import (
    plan_vec_local_rounds, vec_local_fused_pass, vec_local_pass,
)
from ..ops.cuda.vec_pass import BGRID, CTAP, VecPassOperands
from ..ops.stencil import (
    ARRAY_FIELDS,
    BGRID_FIELDS,
    COEF_FIELDS,
    BGridVectorStencil,
    CGridVectorOperator,
    ScalarStencil5,
    hspace_drop_pre,
)
from . import halo

Tensor = torch.Tensor

# The tripolar seam reflection swaps the meaning of the stencil neighbours.
_FOLD_SWAP = {"c": "c", "n": "s", "s": "n", "e": "w", "w": "e"}

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _mesh_axis(mesh: DeviceMesh, name: Optional[str]) -> halo.Axis:
    """The halo axis ``(group, size)`` of one named mesh dim. A dim of size
    1 (or no dim) needs no group: it wraps locally."""
    if name is None:
        return (None, 1)
    size = mesh.size(mesh.mesh_dim_names.index(name))
    return (mesh.get_group(name), size) if size > 1 else (None, 1)


def _normalize(field: Tensor):
    """Flatten leading dims to one batch dim; return (arr3d, restore_fn)."""
    if field.dim() == 2:
        return field[None], lambda out: out[0]
    if field.dim() == 3:
        return field, lambda out: out
    lead = field.shape[:-2]
    flat = field.reshape((-1,) + tuple(field.shape[-2:]))
    return flat, lambda out: out.reshape(tuple(lead) + tuple(out.shape[-2:]))


def _ring_hook(make, batch_axis):
    """``ring() -> apply or None``: the ring apply for this mesh, built at
    first use by ``make(ring_module)``; None where the ring engine declines
    the mesh (every ``DeviceMesh`` today, see the module docstring), is
    switched off, or a batch axis is sharded."""
    built = []

    def ring():
        if not built:
            from . import ring as ring_mod

            built.append(make(ring_mod) if batch_axis is None and ring_mod.ring_enabled()
                         else None)
        return built[0]

    return ring


def _balanced(n_steps: int, k: int) -> Tuple[int, ...]:
    n_pass = -(-n_steps // k)
    base, extra = divmod(n_steps, n_pass)
    return tuple(base + (1 if i < extra else 0) for i in range(n_pass))


def plan_rounds(n_steps: int, ly: int, lx: int,
                halo_steps: Optional[int]) -> Tuple[int, Tuple[int, ...]]:
    """``(cells, rounds)``: the halo width exchanged and the steps per round.

    At most ``halo_steps`` (default 16) steps per round, balanced over the
    rounds, and clamped so the halo never reaches past the neighbouring
    block (``cells <= min(ly, lx)``).
    """
    k = min(halo_steps or 16, n_steps, max(1, min(ly, lx) // 2))
    rounds = _balanced(n_steps, max(1, k))
    return max(rounds), rounds


def _extend_scalar_stencil(st: ScalarStencil5, cells: int, y_axis: halo.Axis,
                           x_axis: halo.Axis) -> ScalarStencil5:
    """Halo-extend every coefficient plane of a local scalar stencil.

    On fold grids the north halo rows of the coefficients come from the seam
    partner's *swapped* coefficient (reflection maps n<->s, e<->w), which
    keeps the steps inside a round exact across the seam. The returned
    stencil is purely local: ``fold_north`` is cleared (the halos carry the
    seam). ``area`` is extended too (its seam mirror is itself): the first
    and last step apply it inside the block. A collective: every rank of the
    mesh calls it with planes of the same local shape.
    """
    fold = st.fold_north

    def ext(v, swap_v):
        if not isinstance(v, Tensor):
            if fold and isinstance(swap_v, Tensor):
                raise ValueError(
                    "a constant stencil coefficient whose seam partner is an "
                    "array cannot be halo-extended across the tripolar fold")
            return v
        src = None
        if fold and swap_v is not v:
            if not isinstance(swap_v, Tensor):
                raise ValueError(
                    "an array stencil coefficient whose seam partner is a "
                    "constant cannot be halo-extended across the tripolar fold")
            src = swap_v
        return halo.exchange_2d(v, cells, y_axis, x_axis, fold, src).contiguous()

    coefs = {k: ext(getattr(st, k), getattr(st, _FOLD_SWAP[k])) for k in COEF_FIELDS}
    post = ext(st.post, st.post)
    # pre and post are one tensor on the masked grids: extend it once
    pre = post if st.pre is st.post else ext(st.pre, st.pre)
    return dataclasses.replace(st, **coefs, pre=pre, post=post,
                               area=ext(st.area, st.area), fold_north=False)


def local_scalar_operands(st: ScalarStencil5, cells: int, y_axis: halo.Axis,
                          x_axis: halo.Axis, dtype: torch.dtype, neg2s: float,
                          drop_pre: bool, land_gain: float) -> PassOperands:
    """The operands of the local pass on one rank, from its block ``st`` of
    the hot stencil (cast to the compute dtype ``dtype``, on the rank's
    device).

    Counterpart of the JAX ``local_scalar_coef_exts``: every plane is
    halo-extended by ``cells`` (a collective, see
    :func:`_extend_scalar_stencil`), then the coefficients are pre-scaled by
    ``neg2s = -2*lap_scale`` in the compute dtype (constants are scaled in
    float64 and rounded once), as the unsharded dispatch does. They depend on
    the stencil, the local shape and the dtype only, not on the field.
    """
    npdt = _NP_DTYPES[dtype]
    ext = _extend_scalar_stencil(st, cells, y_axis, x_axis)
    scaled = {}
    for k in COEF_FIELDS:
        v = getattr(ext, k)
        scaled[k] = (v * float(npdt(neg2s)) if isinstance(v, Tensor)
                     else float(npdt(neg2s * v)))
    return PassOperands(dataclasses.replace(ext, **scaled), drop_pre, float(npdt(land_gain)))


def local_rounds_scalar(ops: PassOperands, field: Tensor, p, cells: int, rounds,
                        y_axis: halo.Axis, x_axis: halo.Axis, fold: bool,
                        pass_fn=local_pass, fused_fn=local_fused_pass) -> Tensor:
    """Wide-halo rounds on one rank: ``(batch, ly, lx) -> (batch, ly, lx)``.

    Counterpart of the JAX ``local_pallas_rounds_scalar``. Per round one halo
    exchange extends the carries by ``cells`` (messages on sharded axes, a
    local periodic wrap -- the tripolar fold included -- on unsharded ones),
    then the round's steps run on the extended block: one ``fused_fn`` call
    for the whole round where the fused plan's static predicate holds (a core
    of at least a tile plus its halo, ``cells <= 16``), else one ``pass_fn``
    call per step (``fused_fn=None`` forces that). The first step consumes the
    raw extended field (prepare and masking fused), the last one reconstructs
    land and divides by the area on the core, reading the caller's own block.
    ``ops`` holds the extended, pre-scaled coefficient planes;
    ``sum(rounds)`` is the filter's n_steps.
    """
    n_steps = sum(rounds)
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    ly, lx = field.shape[-2:]
    plan = plan_fused_passes(cells, ly, lx, field.dtype, fused_planes(ops), one_pass=True)
    if fused_fn is not None and plan.fused:
        return _fused_rounds(fused_fn, ops, field, p, cells, rounds, y_axis, x_axis, fold,
                             plan.tile)
    acc = torch.empty_like(field)
    t = t_prev = None
    step = 0
    for n_ops in rounds:
        if step == 0:
            ext_raw = halo.exchange_2d(field, cells, y_axis, x_axis, fold)
            t_prev, t = torch.empty_like(ext_raw), torch.empty_like(ext_raw)
            pass_fn(ops, FIRST, p[0], p[1], cells=cells, shrink=1,
                    field=ext_raw, t_next=t, acc=acc, h=t_prev)
            first_j = 2
        else:
            # one message per phase carries both carries and the whole batch
            ext = halo.exchange_2d(torch.stack([core(t), core(t_prev)]),
                                   cells, y_axis, x_axis, fold)
            t, t_prev = ext[0], ext[1]
            first_j = 1
        step += first_j - 1
        for j in range(first_j, n_ops + 1):
            step += 1
            if step == n_steps:
                pass_fn(ops, LAST, p[step], cells=cells, field=field,
                        t=t, t_prev=t_prev, acc=acc)
            else:
                # t_next overwrites t_prev in place; acc is updated in place
                pass_fn(ops, MIDDLE, p[step], cells=cells, shrink=j,
                        t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
                t, t_prev = t_prev, t
    return acc


def _fused_rounds(fused_fn, ops: PassOperands, field: Tensor, p, cells: int, rounds,
                  y_axis: halo.Axis, x_axis: halo.Axis, fold: bool, tile) -> Tensor:
    """The rounds of :func:`local_rounds_scalar`, one fused launch each. A
    round writes its carries into the core of two fresh extended buffers,
    which the next round's exchange reads (a tile reads its neighbours'
    cells, so a round cannot update the carries it reads)."""
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    acc = torch.empty_like(field)
    t = t_prev = None
    start = 0
    for i, n_ops in enumerate(rounds):
        last = i == len(rounds) - 1
        ext_raw = None
        if i == 0:
            ext_raw = halo.exchange_2d(field, cells, y_axis, x_axis, fold)
        else:
            # one message per phase carries both carries and the whole batch
            ext = halo.exchange_2d(torch.stack([core(t), core(t_prev)]),
                                   cells, y_axis, x_axis, fold)
            t, t_prev = ext[0], ext[1]
        shape = (ext_raw if ext_raw is not None else t).shape
        t_out = t_prev_out = None
        if not last:
            t_out = torch.empty(shape, dtype=field.dtype, device=field.device)
            t_prev_out = torch.empty_like(t_out)
        fused_fn(ops, p, start, n_ops, cells=cells, tile=tile, field=ext_raw,
                 field_own=field if last else None, t=t, t_prev=t_prev, t_out=t_out,
                 t_prev_out=t_prev_out, acc=acc)
        t, t_prev = t_out, t_prev_out
        start += n_ops
    return acc


def _placements(mesh: DeviceMesh, ndim: int, spatial_axes, batch_axis):
    """DTensor placements of an ``ndim``-dim field: spatial dims over
    ``spatial_axes``, dim 0 over ``batch_axis``, replicated elsewhere."""
    where = {spatial_axes[0]: ndim - 2, spatial_axes[1]: ndim - 1}
    if batch_axis is not None:
        where[batch_axis] = 0
    where.pop(None, None)
    return tuple(Shard(where[n]) if n in where else Replicate() for n in mesh.mesh_dim_names)


class _Layout:
    """How fields lie on the mesh, shared by the scalar and the vector apply:
    the halo axes of the two spatial mesh dims, this rank's block of a global
    tensor, and the checks and placements of an input field."""

    def __init__(self, mesh: DeviceMesh, spatial_axes, batch_axis: Optional[str]):
        yax, xax = spatial_axes
        names = mesh.mesh_dim_names or ()
        for name in (yax, xax, batch_axis):
            if name is not None and name not in names:
                raise ValueError(f"mesh has no dim named {name!r} (its dims: {names})")
        used = [n for n in (yax, xax, batch_axis) if n is not None]
        if len(set(used)) != len(used):
            raise ValueError(f"spatial_axes {spatial_axes} and batch_axis {batch_axis!r} "
                             "must name distinct mesh dims")
        self.mesh, self.spatial_axes, self.batch_axis = mesh, (yax, xax), batch_axis
        self.y_axis, self.x_axis = _mesh_axis(mesh, yax), _mesh_axis(mesh, xax)
        self.sizes = {n: mesh.size(names.index(n)) for n in used}
        self.index = {n: mesh.get_local_rank(n) for n in used}
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if mesh.device_type == "cuda" else torch.device(mesh.device_type))

    def block(self, x: Tensor, batch_dim: Optional[int] = None) -> Tensor:
        """This rank's block of a global ``(..., ny, nx)`` tensor."""
        yax, xax = self.spatial_axes
        for name, dim in ((yax, -2), (xax, -1), (self.batch_axis, batch_dim)):
            if name is not None and dim is not None:
                n = x.shape[dim] // self.sizes[name]
                x = x.narrow(dim, self.index[name] * n, n)
        return x

    def local(self, field, grid_shape):
        """``(this rank's block, placements)`` of one input: a global array or
        tensor (identical on every rank; sliced here) or a ``DTensor`` sharded
        like the result. Raises on a shape the mesh cannot take."""
        if not isinstance(field, DTensor):
            field = torch.as_tensor(field)
        gshape, ndim = tuple(field.shape), field.dim()
        yax, xax = self.spatial_axes
        if ndim < 2:
            raise ValueError(f"fields need two spatial dims (..., y, x); got shape {gshape}")
        if self.batch_axis is not None and ndim != 3:
            raise ValueError(
                f"batch_axis shards dim 0 of a (batch, y, x) field; got shape {gshape}")
        if grid_shape is not None and gshape[-2:] != grid_shape:
            raise ValueError(
                f"field's spatial shape {gshape[-2:]} does not match the grid's {grid_shape}")
        for name, dim in ((yax, ndim - 2), (xax, ndim - 1), (self.batch_axis, 0)):
            if name is not None and gshape[dim] % self.sizes[name]:
                raise ValueError(
                    f"dim {dim} of the field (size {gshape[dim]}) does not divide "
                    f"over mesh dim {name!r} of size {self.sizes[name]}")
        placements = _placements(self.mesh, ndim, self.spatial_axes, self.batch_axis)
        if isinstance(field, DTensor):
            if field.device_mesh != self.mesh or tuple(field.placements) != placements:
                raise ValueError(
                    f"a DTensor field must live on the filter's mesh with placements "
                    f"{placements}; got {tuple(field.placements)} on {field.device_mesh}")
            return field.to_local(), placements
        return self.block(field, 0 if self.batch_axis is not None else None), placements


def make_sharded_scalar_apply(
    stencil: ScalarStencil5,
    spec: FilterSpec,
    mesh: DeviceMesh,
    spatial_axes: Tuple[Optional[str], Optional[str]],
    batch_axis: Optional[str] = None,
    halo_steps: Optional[int] = None,
    exact_nan: bool = False,
    pass_fn=local_pass,
    fused_fn=local_fused_pass,
):
    """``field -> filtered`` with the domain sharded over ``mesh``.

    ``stencil`` is the *global* host stencil, the same on every rank; each
    rank moves only its block of every coefficient plane to its device and
    halo-extends it there, once per (local shape, dtype). ``field`` is the
    global field (array or tensor, identical on every rank; the rank slices
    its block) or a ``DTensor`` sharded like the result. Returns a
    ``DTensor`` on ``mesh`` with the spatial dims sharded over
    ``spatial_axes`` (and dim 0 over ``batch_axis``); ``.full_tensor()``
    gathers it. Every rank of the mesh must call the function together.

    ``fused_fn`` runs one fused round and ``pass_fn`` one local step; they
    are :func:`local_fused_pass` and :func:`local_pass` (kernels for CUDA
    tensors, plain versions for CPU tensors) unless a caller passes the plain
    versions to compare them on one device; ``fused_fn=None`` runs the step
    chain on purpose (:func:`local_rounds_scalar`).
    """
    if spec.n_steps < 2:
        raise ValueError(f"the step kernels need n_steps >= 2, got {spec.n_steps}")
    lay = _Layout(mesh, spatial_axes, batch_axis)
    y_axis, x_axis, device = lay.y_axis, lay.x_axis, lay.device

    p_host = np.asarray(spec.p, dtype=np.float64)
    drop_pre = hspace_drop_pre(stencil) and not exact_nan
    land_gain = float(np.polynomial.chebyshev.chebval(-1.0, p_host))
    hot_host = (
        dataclasses.replace(stencil, pre=None, zap_nans=False) if drop_pre else stencil
    )
    neg2s = -2.0 * _laplacian_scale(spec, stencil.is_dimensional)
    grid_shape = next((tuple(v.shape) for v in (getattr(hot_host, k) for k in ARRAY_FIELDS)
                       if isinstance(v, Tensor)), None)
    cache = {}
    ring = _ring_hook(lambda m: m.make_ring_scalar_apply(
        stencil, spec, mesh, spatial_axes, exact_nan, halo_steps=halo_steps), batch_axis)

    def operands(ly: int, lx: int, dtype):
        """The extended, pre-scaled local operands, the halo width, the
        rounds and p for one (local shape, dtype). A collective on a cache
        miss: the key is the same on every rank, so all miss together."""
        key = (ly, lx, dtype)
        if key not in cache:
            cells, rounds = plan_rounds(spec.n_steps, ly, lx, halo_steps)
            planes = {}
            for k in ARRAY_FIELDS:
                v = getattr(hot_host, k)
                if isinstance(v, Tensor):
                    # cast to the compute dtype, then move only this rank's block
                    v = lay.block(v).to(dtype).to(device)
                planes[k] = v
            if hot_host.pre is hot_host.post:
                planes["pre"] = planes["post"]
            ops = local_scalar_operands(dataclasses.replace(hot_host, **planes), cells,
                                        y_axis, x_axis, dtype, neg2s, drop_pre, land_gain)
            cache[key] = (ops, cells, rounds,
                          [float(v) for v in p_host.astype(_NP_DTYPES[dtype])])
        return cache[key]

    def apply_fn(field):
        if ring() is not None:
            return ring()(field)
        local, placements = lay.local(field, grid_shape)
        # the local compute runs in the compute dtype, so integer inputs are
        # promoted here (same values whether before or after slicing)
        dtype = _compute_dtype(local.dtype)
        x, restore = _normalize(local.to(device=device, dtype=dtype).contiguous())
        if x.numel() == 0:
            out = torch.empty_like(x)
        else:
            ly, lx = x.shape[-2:]
            ops, cells, rounds, p = operands(ly, lx, dtype)
            out = local_rounds_scalar(ops, x, p, cells, rounds, y_axis, x_axis,
                                      stencil.fold_north, pass_fn, fused_fn)
        return DTensor.from_local(restore(out), mesh, placements, run_check=False)

    apply_fn.operands = operands  # (ly, lx, dtype) -> (PassOperands, cells, rounds, p)
    apply_fn.ring = ring  # the ring apply, or None where the ring declines this mesh
    return apply_fn


# -- vector engine ----------------------------------------------------------

def _extend_vector_operator(planes: Dict[str, Tensor], cells: int, y_axis: halo.Axis,
                            x_axis: halo.Axis) -> Dict[str, Tensor]:
    """Halo-extend every coefficient plane of a local vector operator by
    ``cells`` with the plain periodic exchange: vector grids have no fold, so
    no seam chunk and no coefficient swap. A collective: every rank of the
    mesh calls it with planes of the same local shape, in the same order."""
    return {k: halo.exchange_2d(v, cells, y_axis, x_axis) for k, v in planes.items()}


def local_vector_operands(op: int, planes: Dict[str, Tensor], zap: bool, cells: int,
                          y_axis: halo.Axis, x_axis: halo.Axis, dtype: torch.dtype,
                          neg2s: float) -> VecPassOperands:
    """The operands of the coupled local pass on one rank, from its blocks
    ``planes`` of the coefficient planes in the kernel's order (``BGRID_FIELDS``
    or the 18 C-grid taps in ``CTAPS`` order), cast to the compute dtype
    ``dtype``, on the rank's device.

    Counterpart of the JAX ``_local_coef_exts``: every plane is halo-extended
    by ``cells`` (a collective, see :func:`_extend_vector_operator`), then
    pre-scaled by ``neg2s = -2*lap_scale`` rounded to the compute dtype, as
    the unsharded dispatch does, into one contiguous ``(n_coef, ly+2*cells,
    lx+2*cells)`` tensor. They depend on the operator, the local shape and the
    dtype only, not on the fields.
    """
    ext = _extend_vector_operator(planes, cells, y_axis, x_axis)
    scale = float(_NP_DTYPES[dtype](neg2s))
    first = next(iter(ext.values()))
    coef = torch.empty((len(ext),) + tuple(first.shape), dtype=dtype, device=first.device)
    for k, v in enumerate(ext.values()):
        torch.mul(v, scale, out=coef[k])
    return VecPassOperands(op, coef, zap)


def local_rounds_vector(ops: VecPassOperands, w: Tensor, p, cells: int, rounds,
                        y_axis: halo.Axis, x_axis: halo.Axis,
                        pass_fn=vec_local_pass, fused_fn=vec_local_fused_pass) -> Tensor:
    """Wide-halo rounds of the coupled recurrence on one rank:
    ``(batch, 2, ly, lx) -> (batch, 2, ly, lx)`` on the stacked (u, v) pair.

    Counterpart of the JAX ``_local_pallas_2d``. Round 0 exchanges the stacked
    input by ``cells`` (the extension is T_0 itself: vector grids have no
    mask, area or prepare); every later round exchanges one stack of both
    carries' cores, so one message per phase carries both carries, both
    components and the whole batch. The diagonal C-grid taps read the halo's
    corner cells, which ride the exchange's second phase. Where every round's
    fused plan (:func:`plan_vec_local_rounds`) holds its static predicate,
    each round runs as its plan's ``fused_fn`` launches
    (:func:`_fused_vector_rounds`); otherwise, or with
    ``fused_fn=None``, step ``j`` of a round runs on the window shrunk by
    ``j``, one ``pass_fn`` call per step, the first on the window shrunk by 1.
    ``acc`` is core-shaped. ``ops`` holds the extended, pre-scaled
    coefficient planes; ``sum(rounds)`` is the filter's n_steps. The caller's
    ``w`` is only read: the carries that the steps overwrite are the
    exchanges' fresh tensors.
    """
    if fused_fn is not None:
        plans = plan_vec_local_rounds(rounds, *w.shape[-2:], w.dtype, ops.op)
        if all(pl.fused for pl in plans):
            return _fused_vector_rounds(fused_fn, ops, w, p, cells, rounds, y_axis, x_axis,
                                        plans)
    n_steps = sum(rounds)
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    acc = torch.empty_like(w)
    t = t_prev = None
    step = 0
    for n_ops in rounds:
        if step == 0:
            t_prev = halo.exchange_2d(w, cells, y_axis, x_axis)
            t = torch.empty_like(t_prev)
            pass_fn(ops, FIRST, p[0], p[1], cells=cells, shrink=1,
                    w=t_prev, t_next=t, acc=acc)
            first_j = 2
        else:
            ext = halo.exchange_2d(torch.stack([core(t), core(t_prev)]),
                                   cells, y_axis, x_axis)
            t, t_prev = ext[0], ext[1]
            first_j = 1
        step += first_j - 1
        for j in range(first_j, n_ops + 1):
            step += 1
            if step == n_steps:
                pass_fn(ops, LAST, p[step], cells=cells, t=t, t_prev=t_prev, acc=acc)
            else:
                # t_next overwrites t_prev in place; acc is updated in place
                pass_fn(ops, MIDDLE, p[step], cells=cells, shrink=j,
                        t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
                t, t_prev = t_prev, t
    return acc


def _fused_vector_rounds(fused_fn, ops: VecPassOperands, w: Tensor, p, cells: int, rounds,
                         y_axis: halo.Axis, x_axis: halo.Axis, plans) -> Tensor:
    """The rounds of :func:`local_rounds_vector` as fused launches, ``plans``
    one per round: each round one launch per entry of its plan's ``steps``
    on its plan's tile, with no exchange between them. A launch ends on the
    block shrunk by ``cells`` less the round's steps still to run after it
    (the round's last launch ends on the core), and writes its carries there
    into two fresh extended buffers, which the next launch, or the next
    round's exchange, reads (a tile reads its neighbours' cells, so a launch
    cannot update the carries it reads)."""
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    n_steps = sum(rounds)
    acc = torch.empty_like(w)
    w_ext = t = t_prev = None
    start = 0
    for i, (n_round, plan) in enumerate(zip(rounds, plans)):
        if i == 0:
            w_ext = halo.exchange_2d(w, cells, y_axis, x_axis)
        else:
            # one message per phase carries both carries and the whole batch
            ext = halo.exchange_2d(torch.stack([core(t), core(t_prev)]),
                                   cells, y_axis, x_axis)
            t, t_prev = ext[0], ext[1]
        left = n_round
        for n_ops in plan.steps:
            left -= n_ops
            t_out = t_prev_out = None
            if start + n_ops < n_steps:
                t_out, t_prev_out = torch.empty_like(w_ext), torch.empty_like(w_ext)
            fused_fn(ops, p, start, n_ops, cells=cells, shrink=cells - left, tile=plan.tile,
                     w=w_ext if start == 0 else None, t=t, t_prev=t_prev, t_out=t_out,
                     t_prev_out=t_prev_out, acc=acc)
            t, t_prev = t_out, t_prev_out
            start += n_ops
    return acc


def make_sharded_vector_apply(
    operator,
    spec: FilterSpec,
    mesh: DeviceMesh,
    spatial_axes: Tuple[Optional[str], Optional[str]],
    batch_axis: Optional[str] = None,
    halo_steps: Optional[int] = None,
    pass_fn=vec_local_pass,
    fused_fn=vec_local_fused_pass,
):
    """``(u, v) -> (filtered_u, filtered_v)`` with the domain sharded over
    ``mesh``.

    ``operator`` is the *global* host operator (``BGridVectorStencil`` or
    ``CGridVectorOperator``), the same on every rank. The C-grid operator
    runs in its tap-expanded form: the 18 tap planes are computed once, at
    first apply, from the global operator in numpy float64 on the host
    (computed from a rank's own block they would use the wrong neighbours at
    the block's edges), and each rank keeps only its block of each. ``u`` and
    ``v`` are global fields of equal shape (arrays or tensors, identical on
    every rank) or ``DTensor``s sharded like the results; mixed and integer
    dtypes are promoted to the common compute dtype. Returns a pair of
    ``DTensor``s on ``mesh``, as :func:`make_sharded_scalar_apply` does.
    Every rank of the mesh must call the function together.

    ``fused_fn`` runs one fused launch of a round and ``pass_fn`` one local
    step; they are :func:`vec_local_fused_pass` and :func:`vec_local_pass`
    (kernels for CUDA tensors, plain versions for CPU tensors) unless a
    caller passes the plain versions to compare them on one device;
    ``fused_fn=None`` runs the step chain on purpose
    (:func:`local_rounds_vector`).
    """
    if isinstance(operator, CGridVectorOperator):
        op, names = CTAP, CTAP_NAMES
        grid_shape = tuple(operator.r_dyCu.shape)
    elif isinstance(operator, BGridVectorStencil):
        op, names = BGRID, BGRID_FIELDS
        grid_shape = tuple(operator.cc.shape)
    else:
        raise ValueError(
            f"Operator type {type(operator).__name__} is not supported "
            "with mesh=: only framework stencil types can be sharded "
            "(Filter rejects protocol operators at construction)."
        )
    if spec.n_steps < 2:
        raise ValueError(f"the step kernels need n_steps >= 2, got {spec.n_steps}")
    lay = _Layout(mesh, spatial_axes, batch_axis)
    y_axis, x_axis, device = lay.y_axis, lay.x_axis, lay.device
    p_host = np.asarray(spec.p, dtype=np.float64)
    neg2s = -2.0 * _laplacian_scale(spec, operator.is_dimensional)
    host = {}  # the global coefficient planes, made at first use
    cache = {}
    ring = _ring_hook(lambda m: m.make_ring_vector_apply(
        operator, spec, mesh, spatial_axes, halo_steps=halo_steps), batch_axis)

    def host_planes() -> Dict[str, Tensor]:
        """The global coefficient planes in the kernel's order, float64 on
        the host (the C-grid taps: 18 planes, ~1.2 GB at 2400x3600)."""
        if not host:
            src = (cgrid_tap_arrays(operator) if op == CTAP
                   else {k: getattr(operator, k) for k in names})
            host.update({k: torch.as_tensor(src[k]) for k in names})
        return host

    def operands(ly: int, lx: int, dtype):
        """The extended, pre-scaled local operands, the halo width, the
        rounds and p for one (local shape, dtype). A collective on a cache
        miss: the key is the same on every rank, so all miss together."""
        key = (ly, lx, dtype)
        if key not in cache:
            cells, rounds = plan_rounds(spec.n_steps, ly, lx, halo_steps)
            # cast to the compute dtype, then move only this rank's block
            planes = {k: lay.block(v).to(dtype).to(device) for k, v in host_planes().items()}
            ops = local_vector_operands(op, planes, bool(operator.zap_nans), cells,
                                        y_axis, x_axis, dtype, neg2s)
            cache[key] = (ops, cells, rounds,
                          [float(v) for v in p_host.astype(_NP_DTYPES[dtype])])
        return cache[key]

    def apply_fn(u, v):
        if ring() is not None:
            return ring()(u, v)
        if np.shape(u) != np.shape(v):
            raise ValueError(
                f"u and v must have the same shape; got {np.shape(u)} and {np.shape(v)}")
        lu, placements = lay.local(u, grid_shape)
        lv, _ = lay.local(v, grid_shape)
        # both components run in one floating compute dtype: mixed and
        # integer inputs must not truncate coefficients or compute in ints
        dtype = _compute_dtype(lu.dtype, lv.dtype)
        xu, restore = _normalize(lu.to(device=device, dtype=dtype))
        xv, _ = _normalize(lv.to(device=device, dtype=dtype))
        # a fresh stacked state (batch, 2, ly, lx), owned here
        w = torch.stack([xu, xv], dim=1)
        if w.numel() == 0:
            out = torch.empty_like(w)
        else:
            ly, lx = w.shape[-2:]
            ops, cells, rounds, p = operands(ly, lx, dtype)
            out = local_rounds_vector(ops, w, p, cells, rounds, y_axis, x_axis, pass_fn,
                                      fused_fn)
        return tuple(DTensor.from_local(restore(out[:, m]), mesh, placements, run_check=False)
                     for m in (0, 1))

    def plan(ly: int, lx: int, dtype):
        """The fused plans of the rounds for one (local shape, dtype), one per
        round (:func:`plan_vec_local_rounds`); the rounds run fused where
        every plan's ``fused`` holds and ``fused_fn`` is given."""
        return plan_vec_local_rounds(plan_rounds(spec.n_steps, ly, lx, halo_steps)[1], ly, lx,
                                     dtype, op)

    apply_fn.operands = operands  # (ly, lx, dtype) -> (VecPassOperands, cells, rounds, p)
    apply_fn.plan = plan  # (ly, lx, dtype) -> one FusedPlan per round
    apply_fn.ring = ring  # the ring apply, or None where the ring declines this mesh
    return apply_fn
