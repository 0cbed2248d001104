"""Sharded filter execution: 2-D spatial domain decomposition over a mesh.

PyTorch-port counterpart of the scalar part of
``gcm_filters_tpu/parallel/sharded.py``. The (y, x) field is sharded over a
``torch.distributed.device_mesh.DeviceMesh`` with named dims; every rank runs
the same program on its ``(ly, lx)`` block.

Communication is *round-based* (wide halos): each round exchanges a
``cells``-wide halo once (two message phases, corners riding the second,
halo.py) and then advances the recurrence up to ``cells`` steps purely
locally on the halo-extended block (ops/cuda/local_pass.py: the step kernel
on CUDA tensors, its plain version on CPU tensors). The tripolar fold is a
reversed pairing among the ranks of the top mesh row, and the stencil
coefficients are halo-extended once per (local shape, dtype) with the seam's
n<->s / e<->w coefficient swap in their fold chunks.

The per-cell arithmetic inside a round is the unsharded step kernel's, so
sharded results match unsharded ones to roundoff.

Leading batch dims stay local to each rank unless ``batch_axis`` names a mesh
dim to shard them over.

What the JAX module has and this one leaves out, as TPU layout or as other
work: the VMEM / sublane / lane-padding planner, the packed coefficient
blocks, a second (XLA) local compute with its compile fallback, the ring
engine hook, and the vector engine (see ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..engine import _compute_dtype, _laplacian_scale
from ..filter_spec import FilterSpec
from ..ops.cuda.cheb_pass import FIRST, LAST, MIDDLE, PassOperands
from ..ops.cuda.local_pass import local_pass
from ..ops.stencil import ARRAY_FIELDS, COEF_FIELDS, ScalarStencil5, hspace_drop_pre
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
                        pass_fn=local_pass) -> Tensor:
    """Wide-halo rounds on one rank: ``(batch, ly, lx) -> (batch, ly, lx)``.

    Counterpart of the JAX ``local_pallas_rounds_scalar``. Per round one halo
    exchange extends the carries by ``cells`` (messages on sharded axes, a
    local periodic wrap -- the tripolar fold included -- on unsharded ones),
    then ``pass_fn`` runs the round's steps on the extended block, one call
    per step. The first step consumes the raw extended field (prepare and
    masking fused), the last one reconstructs land and divides by the area
    on the core, reading the caller's own block. ``ops`` holds the extended,
    pre-scaled coefficient planes; ``sum(rounds)`` is the filter's n_steps.
    """
    n_steps = sum(rounds)
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
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


def _placements(mesh: DeviceMesh, ndim: int, spatial_axes, batch_axis):
    """DTensor placements of an ``ndim``-dim field: spatial dims over
    ``spatial_axes``, dim 0 over ``batch_axis``, replicated elsewhere."""
    where = {spatial_axes[0]: ndim - 2, spatial_axes[1]: ndim - 1}
    if batch_axis is not None:
        where[batch_axis] = 0
    where.pop(None, None)
    return tuple(Shard(where[n]) if n in where else Replicate() for n in mesh.mesh_dim_names)


def make_sharded_scalar_apply(
    stencil: ScalarStencil5,
    spec: FilterSpec,
    mesh: DeviceMesh,
    spatial_axes: Tuple[Optional[str], Optional[str]],
    batch_axis: Optional[str] = None,
    halo_steps: Optional[int] = None,
    exact_nan: bool = False,
    pass_fn=local_pass,
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

    ``pass_fn`` runs one local step; it is :func:`local_pass` (kernel for
    CUDA tensors, plain version for CPU tensors) unless a caller passes the
    plain version to compare the two on one device.
    """
    if spec.n_steps < 2:
        raise ValueError(f"the step kernels need n_steps >= 2, got {spec.n_steps}")
    yax, xax = spatial_axes
    names = mesh.mesh_dim_names or ()
    for name in (yax, xax, batch_axis):
        if name is not None and name not in names:
            raise ValueError(f"mesh has no dim named {name!r} (its dims: {names})")
    used = [n for n in (yax, xax, batch_axis) if n is not None]
    if len(set(used)) != len(used):
        raise ValueError(f"spatial_axes {spatial_axes} and batch_axis {batch_axis!r} "
                         "must name distinct mesh dims")
    y_axis, x_axis = _mesh_axis(mesh, yax), _mesh_axis(mesh, xax)
    sizes = {n: mesh.size(names.index(n)) for n in used}
    index = {n: mesh.get_local_rank(n) for n in used}
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))

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

    def block(x: Tensor, batch_dim: Optional[int] = None) -> Tensor:
        """This rank's block of a global ``(..., ny, nx)`` tensor."""
        for name, dim in ((yax, -2), (xax, -1), (batch_axis, batch_dim)):
            if name is not None and dim is not None:
                n = x.shape[dim] // sizes[name]
                x = x.narrow(dim, index[name] * n, n)
        return x

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
                    v = block(v).to(dtype).to(device)
                planes[k] = v
            if hot_host.pre is hot_host.post:
                planes["pre"] = planes["post"]
            ops = local_scalar_operands(dataclasses.replace(hot_host, **planes), cells,
                                        y_axis, x_axis, dtype, neg2s, drop_pre, land_gain)
            cache[key] = (ops, cells, rounds,
                          [float(v) for v in p_host.astype(_NP_DTYPES[dtype])])
        return cache[key]

    def apply_fn(field):
        if not isinstance(field, DTensor):
            field = torch.as_tensor(field)
        gshape, ndim = tuple(field.shape), field.dim()
        if ndim < 2:
            raise ValueError(f"fields need two spatial dims (..., y, x); got shape {gshape}")
        if batch_axis is not None and ndim != 3:
            raise ValueError(
                f"batch_axis shards dim 0 of a (batch, y, x) field; got shape {gshape}")
        if grid_shape is not None and gshape[-2:] != grid_shape:
            raise ValueError(
                f"field's spatial shape {gshape[-2:]} does not match the grid's {grid_shape}")
        for name, dim in ((yax, ndim - 2), (xax, ndim - 1), (batch_axis, 0)):
            if name is not None and gshape[dim] % sizes[name]:
                raise ValueError(
                    f"dim {dim} of the field (size {gshape[dim]}) does not divide "
                    f"over mesh dim {name!r} of size {sizes[name]}")
        placements = _placements(mesh, ndim, spatial_axes, batch_axis)
        if isinstance(field, DTensor):
            if field.device_mesh != mesh or tuple(field.placements) != placements:
                raise ValueError(
                    f"a DTensor field must live on the filter's mesh with placements "
                    f"{placements}; got {tuple(field.placements)} on {field.device_mesh}")
            local = field.to_local()
        else:
            local = block(field, 0 if batch_axis is not None else None)
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
                                      stencil.fold_north, pass_fn)
        return DTensor.from_local(restore(out), mesh, placements, run_check=False)

    apply_fn.operands = operands  # (ly, lx, dtype) -> (PassOperands, cells, rounds, p)
    return apply_fn
