"""The ring engine: y-shards whose step kernels do their own halo exchange.

PyTorch-port counterpart of ``gcm_filters_tpu/parallel/ring.py``. The
round-based sharded engine (sharded.py) alternates halo exchanges made of
messages with local compute. This engine instead cuts the field into ``p_y``
shards along y (x is not cut, so the x wrap and the tripolar seam stay local)
and runs the filter as the fused passes that the shard's plan gives
(:func:`_shard_plan`, :func:`_pass_chain`), each ONE launch of a fused ring
kernel (ops/cuda/ring_pass.py ``ring_fused_pass`` for a scalar,
``vec_ring_fused_pass`` for the stacked (u, v) pair; ``csrc/ring_pass.cu``)
over all shards: S <= 16 steps per launch, the kernel storing the S rows
nearest each shard edge into its neighbours' halo rows through plain
pointers once per pass, raising a flag with release order, computing the
interior tiles meanwhile and the shard-edge tiles last, waiting for the flag
only there. Where the plan is not fused (a window wider than the field, a
one-step pass such as one-row shards give, more than ``MAX_RING_SHARDS``
shards) the filter runs one step per launch of the ring step kernel
(``ring_pass``, ``vec_ring_pass``), by a static test. No copy, message or
collective outside the kernels carries a halo row.

Exactness: every cell sees exactly the values the unsharded kernels'
periodic or folded neighbourhood holds, and the per-cell arithmetic is the
unsharded kernels' own (shared device functions; the fused ring passes run
the fused unsharded kernels' tiles), so the result equals the unsharded
kernel path bit for bit, fused or not.

Where the shards live: between the cards of a multi-rank
``torch.distributed`` mesh the halo pointers would have to come from peer
access, which this module does not set up yet; there :func:`_ring_mesh_for`
declines and parallel/sharded.py carries on with its rounds (the JAX
package's own default on real hardware: off until validated on a pod).
:class:`ResidentMesh` is the stand-in that a JAX ``Mesh`` of virtual devices
is in the JAX package's tests: ``p_y`` shards held by this process on one
device, every shard a set of allocations of its own. ``Filter(mesh=
ResidentMesh(4, "cuda"), spatial_axes=("y", None))`` runs the ring engine;
``apply`` takes a global field, cuts it into the shards' own buffers and
returns one global tensor on the device.

Eligibility: a strict 1-D y decomposition with ``p_y >= 2``, ``ny``
divisible by ``p_y`` (any ``ly = ny/p_y >= 1``, any ``nx``), an unbatched
2-D field and 4-byte elements. The JAX module's further gates (``nx`` a
multiple of 128, 8-row halos, block heights that divide ``ly``) are TPU
layout and have no counterpart. Behind a :class:`ResidentMesh` there is no
round-based engine to give way to, so an ineligible input raises a
``ValueError`` that names the gate; nothing falls back to the unsharded
kernel. ``halo_steps`` bounds the steps fused per ring pass
(:func:`_max_fuse`) as in the JAX module: it changes the launches, not the
result.

One apply runs on the current stream; applies of one ``Filter`` on two
streams at once are not supported (the shards' buffers are reused).
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from ..engine import _compute_dtype
from ..filter_spec import FilterSpec
from ..ops.cuda.cheb_pass import (
    FIRST, LAST, MIDDLE, FusedPlan, PassOperands, fused_planes, plan_fused_passes,
)
from ..ops.cuda.dispatch import (
    _NP_DTYPES, scalar_operands, scalar_setup, vector_operands, vector_setup,
)
from ..ops.cuda.ring_pass import (
    MAX_RING_SHARDS, MIN_ROWS, RingFusedOperands, RingFusedState, RingOperands, RingState,
    VecRingFusedOperands, VecRingFusedState, VecRingOperands, ring_fused_pass, ring_pass,
    vec_ring_fused_pass, vec_ring_pass,
)
from ..ops.cuda.vec_pass import plan_vec_fused_passes
from ..ops.stencil import ARRAY_FIELDS, BGridVectorStencil, CGridVectorOperator, ScalarStencil5

# Tri-state switch: None = auto (on; a multi-rank mesh is declined by
# _ring_mesh_for, not here), True/False = forced. GCM_FILTERS_TPU_RING=1/0
# overrides from the environment.
_RING: Optional[bool] = {"1": True, "0": False}.get(
    os.environ.get("GCM_FILTERS_TPU_RING", ""))


def ring_enabled() -> bool:
    return True if _RING is None else _RING


class ResidentMesh:
    """``p_y`` y-shards held by this process on one device.

    The smallest stand-in for a mesh that can hold several shards in one
    process (a ``DeviceMesh`` has one rank per process). It has one named
    dim, ``name``, of size ``p_y``, and lives on ``device``.
    """

    def __init__(self, p_y: int, device="cuda", name: str = "y") -> None:
        if int(p_y) < 2:
            raise ValueError(f"a ResidentMesh needs at least 2 shards, got {p_y}")
        self.p_y = int(p_y)
        self.device = torch.device(device)
        self.name = name

    @property
    def device_type(self) -> str:
        return self.device.type

    def __repr__(self) -> str:
        return f"ResidentMesh({self.p_y}, {str(self.device)!r}, name={self.name!r})"


def _ring_mesh_for(mesh, spatial_axes):
    """``(mesh, yax, p_y)`` for a strict 1-D y decomposition over resident
    shards, else None.

    A multi-rank ``DeviceMesh`` is declined: its shards live on other cards
    (or in other processes), and the kernel's halo pointers would have to
    come from peer access, which is not set up. A static predicate: nothing
    is tried and caught.
    """
    if not isinstance(mesh, ResidentMesh):
        return None
    yax, xax = spatial_axes
    if yax != mesh.name or xax is not None or mesh.p_y < 2:
        return None
    return mesh, yax, mesh.p_y


def _max_fuse(halo_steps: Optional[int]) -> int:
    """Steps fused per ring pass at most, honoring the user's ``halo_steps``
    knob as the JAX module does (the planner's cap, with the shard's rows:
    :func:`make_ring_scalar_apply`, :func:`make_ring_vector_apply`)."""
    return min(16, halo_steps) if halo_steps else 16


def _shard_plan(plan: FusedPlan, p_y: int, ny: int, dtype) -> Optional[int]:
    """Validate a shard's fused plan against the shard grid: 4-byte
    elements, ``ny % p_y == 0``, at most ``MAX_RING_SHARDS`` shards (the
    kernel's parameter table), shards of ``ly = ny/p_y >= halo`` rows (a
    halo comes from one neighbour, never from two shards away), windows that
    fit in x (``plan.fused``) and passes of at least two steps (a pass of one
    step is the step ring's work, which sends a gathered row instead of the
    raw ones). Returns ly, or None where the step ring runs. The JAX gates on
    block heights and 8-row halos are TPU layout and have no counterpart."""
    if torch.empty((), dtype=dtype).element_size() != 4 or ny % p_y or p_y > MAX_RING_SHARDS:
        return None
    ly = ny // p_y
    if plan is None or not plan.fused or plan.halo < 2 or ly < plan.halo:
        return None
    return ly


def _pass_chain(plan: FusedPlan, build_one):
    """``[(fn, p_offset, n_p, first, last)]`` over the plan's passes, or None
    the moment ``build_one(n_ops, first, last)`` declines: the JAX module's
    chain. A pass gets ``p[p_offset : p_offset + n_p]`` (the first pass's
    first step takes ``p[0]`` and ``p[1]``), so it runs steps ``start+1 ..
    start+n_ops`` with ``start = 0`` on a first pass and ``p_offset - 1``
    otherwise."""
    pass_fns = []
    off = 0
    for m, n_ops in enumerate(plan.steps):
        first = m == 0
        last = m == len(plan.steps) - 1
        fn = build_one(n_ops, first, last)
        if fn is None:
            return None
        n_p = n_ops + 1 if first else n_ops
        pass_fns.append((fn, off, n_p, first, last))
        off += n_p
    return pass_fns


class RingEntry(NamedTuple):
    """What a ring apply keeps per (ny, nx, dtype): the state, ``p`` in the
    compute dtype, the shard's fused plan, and the pass chain (None where the
    step ring runs)."""

    state: object
    p: list
    plan: Optional[FusedPlan]
    chain: Optional[list]


def _gate(p_y: int, shape, dtype, grid_shape) -> Optional[str]:
    """Why the ring cannot take a field of this shape and dtype, or None."""
    if len(shape) != 2:
        return (f"the ring engine takes one unbatched 2-D (y, x) field per apply, got shape "
                f"{tuple(shape)}; filter batch entries one by one")
    ny, nx = shape
    if grid_shape is not None and (ny, nx) != grid_shape:
        return f"field's spatial shape {(ny, nx)} does not match the grid's {grid_shape}"
    if dtype.itemsize != 4:
        return (f"the ring engine computes in 4-byte elements (float32), got {dtype}; "
                f"cast the input or pass dtype=torch.float32")
    if ny % p_y or ny // p_y < MIN_ROWS or nx < 1:
        return (f"the field's {ny} rows do not divide into {p_y} y-shards of at least "
                f"{MIN_ROWS} row")
    return None


def _passes(chain, state, p) -> None:
    """The fused launches of one apply on a state whose input is set: pass
    m writes carry pair m % 2 and reads the other one."""
    for m, (fn, off, _, first, _) in enumerate(chain):
        fn(state, p, 0 if first else off - 1, out=m % 2)


def _steps(pass_fn, state: RingState, p, n_steps: int) -> None:
    """The ``n_steps`` step launches of one apply on a state whose input is set."""
    pass_fn(state, FIRST, p[0], p[1])
    swap = 0
    for k in range(2, n_steps):
        pass_fn(state, MIDDLE, p[k], swap=swap)  # T_{k+1} over t_prev, acc in place
        swap ^= 1
    pass_fn(state, LAST, p[n_steps], swap=swap)


def make_ring_scalar_apply(
    stencil: ScalarStencil5,
    spec: FilterSpec,
    mesh,
    spatial_axes: Tuple[Optional[str], Optional[str]],
    exact_nan: bool = False,
    halo_steps: Optional[int] = None,
    pass_fn=ring_pass,
    fused_fn=ring_fused_pass,
):
    """``field -> filtered`` through the fused ring kernel, or None.

    None means the mesh is not one the ring runs on (see
    :func:`_ring_mesh_for`). The returned ``apply_fn`` takes a global 2-D
    field (array or tensor, any device), cuts it into the shards' own buffers
    on the mesh's device and returns one global tensor there; it raises
    ``ValueError`` for an input the ring cannot take. A shard of ``ly`` rows
    is planned by ``plan_fused_passes`` with the cap ``min(_max_fuse(
    halo_steps), ly)``; where :func:`_shard_plan` takes the plan, one apply
    is one launch of ``fused_fn`` per pass, else ``n_steps`` launches of
    ``pass_fn``. They are :func:`ring_fused_pass` and :func:`ring_pass`
    (kernels on a CUDA device, plain versions on the CPU) unless a caller
    passes the plain versions to compare them on one device;
    ``fused_fn=None`` runs the step ring on purpose.
    ``apply_fn.shape_cache`` maps ``(ny, nx, dtype)`` to its
    :class:`RingEntry`.
    """
    meshed = _ring_mesh_for(mesh, spatial_axes)
    if meshed is None:
        return None
    mesh, _, p_y = meshed
    hot_host, drop_pre, land_gain, neg2s, p_host = scalar_setup(stencil, spec, exact_nan)
    grid_shape = next((tuple(v.shape) for v in (getattr(hot_host, k) for k in ARRAY_FIELDS)
                       if isinstance(v, torch.Tensor)), None)
    n_planes = fused_planes(PassOperands(hot_host, drop_pre, land_gain))
    device = mesh.device
    cache = {}

    def build(ny, nx, dtype):
        ly = ny // p_y
        plan = plan_fused_passes(spec.n_steps, ly, nx, dtype, n_planes,
                                 max_fuse=min(_max_fuse(halo_steps), ly), ring=True,
                                 registers=False)
        chain = None
        if fused_fn is not None and _shard_plan(plan, p_y, ny, dtype) is not None:
            chain = _pass_chain(plan, lambda n_ops, first, last: functools.partial(
                fused_fn, n_ops=n_ops, tile=plan.tile))
        # the unsharded step's operands (same cast, same rounding), cut into
        # shards that own their planes; the global planes are dropped
        ops = scalar_operands(hot_host, neg2s, drop_pre, land_gain, dtype, device)
        if chain is None:
            state = RingState(RingOperands.cut(ops, p_y), ly, nx, dtype, device)
        else:
            state = RingFusedState(RingFusedOperands.cut(ops, p_y, plan.halo), ly, nx, dtype,
                                   device)
        return RingEntry(state, [float(v) for v in p_host.astype(_NP_DTYPES[dtype])], plan,
                         chain)

    def apply_fn(field):
        field = torch.as_tensor(field)
        dtype = _compute_dtype(field.dtype)
        why = _gate(p_y, field.shape, dtype, grid_shape)
        if why is not None:
            raise ValueError(why)
        ny, nx = field.shape
        key = (ny, nx, str(dtype))
        if key not in cache:
            cache[key] = build(ny, nx, dtype)
        state, p, _, chain = cache[key]
        ly = ny // p_y
        for r, x in enumerate(state.input):
            x.copy_(field[r * ly:(r + 1) * ly])
        if chain is None:
            _steps(pass_fn, state, p, spec.n_steps)
        else:
            _passes(chain, state, p)
        return torch.cat(state.acc)  # a fresh tensor: the shards' buffers are reused

    apply_fn.shape_cache = cache  # (ny, nx, dtype) -> RingEntry, for checks
    return apply_fn


def make_ring_vector_apply(
    operator,
    spec: FilterSpec,
    mesh,
    spatial_axes: Tuple[Optional[str], Optional[str]],
    halo_steps: Optional[int] = None,
    pass_fn=vec_ring_pass,
    fused_fn=vec_ring_fused_pass,
):
    """``(u, v) -> (fu, fv)`` through the fused vector ring kernel, or None.

    Vector analogue of :func:`make_ring_scalar_apply`: the B-grid and the
    tap-expanded C-grid passes on the stacked pair, whose halo rows carry both
    components. A shard is planned by ``plan_vec_fused_passes(..., ring=True)``
    with the cap ``min(_max_fuse(halo_steps), ly)``; where :func:`_shard_plan`
    takes the plan, one apply is one launch of ``fused_fn``
    (:func:`vec_ring_fused_pass`) per pass, else ``n_steps`` launches of
    ``pass_fn`` (:func:`vec_ring_pass`); ``fused_fn=None`` runs the step ring
    on purpose. The C-grid taps are computed at first apply. Same gates;
    ``apply_fn.shape_cache`` maps ``(ny, nx, dtype)`` to its
    :class:`RingEntry`.
    """
    meshed = _ring_mesh_for(mesh, spatial_axes)
    if meshed is None:
        return None
    if not isinstance(operator, (BGridVectorStencil, CGridVectorOperator)):
        return None
    mesh, _, p_y = meshed
    op, grid_shape, neg2s, p_host, host_planes = vector_setup(operator, spec)
    device = mesh.device
    cache = {}

    def build(ny, nx, dtype):
        ly = ny // p_y
        plan = plan_vec_fused_passes(spec.n_steps, ly, nx, dtype, op,
                                     max_fuse=min(_max_fuse(halo_steps), ly), ring=True)
        chain = None
        if fused_fn is not None and _shard_plan(plan, p_y, ny, dtype) is not None:
            chain = _pass_chain(plan, lambda n_ops, first, last: functools.partial(
                fused_fn, n_ops=n_ops, tile=plan.tile))
        ops = vector_operands(op, host_planes(), neg2s, bool(operator.zap_nans), dtype, device)
        if chain is None:
            state = RingState(VecRingOperands.cut(ops, p_y), ly, nx, dtype, device)
        else:
            state = VecRingFusedState(VecRingFusedOperands.cut(ops, p_y, plan.halo), ly, nx,
                                      dtype, device)
        return RingEntry(state, [float(v) for v in p_host.astype(_NP_DTYPES[dtype])], plan,
                         chain)

    def apply_fn(u, v):
        u, v = torch.as_tensor(u), torch.as_tensor(v)
        if u.shape != v.shape:
            raise ValueError(
                f"u and v must have the same shape; got {tuple(u.shape)} and {tuple(v.shape)}")
        dtype = _compute_dtype(u.dtype, v.dtype)
        why = _gate(p_y, u.shape, dtype, grid_shape)
        if why is not None:
            raise ValueError(why)
        ny, nx = u.shape
        key = (ny, nx, str(dtype))
        if key not in cache:
            cache[key] = build(ny, nx, dtype)
        state, p, _, chain = cache[key]
        ly = ny // p_y
        for r, w in enumerate(state.input):
            w[0].copy_(u[r * ly:(r + 1) * ly])
            w[1].copy_(v[r * ly:(r + 1) * ly])
        if chain is None:
            _steps(pass_fn, state, p, spec.n_steps)
        else:
            _passes(chain, state, p)
        acc = torch.cat(state.acc, dim=1)  # fresh: the shards' buffers are reused
        return acc[0], acc[1]

    apply_fn.shape_cache = cache  # (ny, nx, dtype) -> RingEntry, for checks
    return apply_fn
