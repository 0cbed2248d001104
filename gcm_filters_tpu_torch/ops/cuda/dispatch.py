"""Dispatch: the filter applies built on the Chebyshev step kernels.

PyTorch-port counterpart of ``gcm_filters_tpu/ops/pallas/dispatch.py``:
:func:`make_cuda_scalar_apply` on the scalar step kernel (ops/cuda/cheb_pass.py)
and :func:`make_cuda_vector_apply` on the coupled vector step kernels
(ops/cuda/vec_pass.py). The JAX dispatcher's block planner, constant
embedding, replan retry and XLA fallback are TPU machinery and have no
counterpart here.

Mask elimination ("h-space" recurrence): grids whose stencil both pre- and
post-multiplies by the same 0/1 wet mask admit an exact transformation that
removes the pre-mask from the hot loop. With h_k = wet * nan_to_num(t_k):

    h_k = -2 h_{k-1} - 2c * wet * S(h_{k-1}) - h_{k-2}        (wet^2 = wet)

is closed in h, and on land the shifted operator is exactly -identity, so
t_k = (-1)^k fbar and the filtered land value is chebval(-1, p) * fbar,
reconstructed in the last step. NaN semantics: land NaNs stay NaN, and a NaN
at a WET cell stays NaN too (poisoned back via 0*fbar), but its neighbourhood
sees it as zero initial data rather than a persistent zero source.
``exact_nan=True`` keeps the per-step pre-mask instead, reproducing the eager
engine's semantics exactly.

A scalar filter runs as the fused passes that ``plan_fused_passes`` plans
(ops/cuda/cheb_pass.py): one launch of the fused kernel per pass, S <= 16
steps each on shared-memory tiles. The first pass takes the raw field
(prepare and masking fused), a middle pass carries t, t_prev and acc, the
last one reads the raw field again for land reconstruction and finalize.
Where the plan's static predicate fails (a field smaller than a tile plus
its halo) the filter runs as ``n_steps`` launches of the one-step kernel:
FIRST, MIDDLE, ..., LAST, with the carries in three buffers allocated per
call, t_next written over t_prev and acc updated in place. Both routes give
the same bits.

Vector grids run their own recurrence on the stacked pair (batch, 2, ny, nx):
B-grid with its ten diffusion and mixing planes, C-grid with the 18 tap planes
of its composed form (ops/ctaps.py), both without masks or area. They run as
the fused passes that ``plan_vec_fused_passes`` plans (ops/cuda/vec_pass.py):
the first pass takes the stacked input, a middle pass carries t, t_prev and
acc, the last one leaves the result in acc. Below the plan's predicate they
run as ``n_steps`` launches of the one-step kernel, t_next over t_prev. Both
routes give the same bits.

CUDA tensors go through the kernel and CPU tensors through its plain version;
there is no other route and no fallback.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ...engine import _compute_dtype, _laplacian_scale
from ...filter_spec import FilterSpec
from ...utils.telemetry import setup_span
from ..ctaps import CTAP_NAMES, cgrid_tap_arrays
from ..stencil import (
    ARRAY_FIELDS,
    BGRID_FIELDS,
    COEF_FIELDS,
    BGridVectorStencil,
    CGridVectorOperator,
    ScalarStencil5,
    hspace_drop_pre,
)
from .cheb_pass import (
    FIRST, LAST, MIDDLE, PassOperands, cheb_fused_pass, cheb_pass, fused_planes,
    plan_fused_passes,
)
from .vec_pass import (
    BGRID, CTAP, VecPassOperands, plan_vec_fused_passes, vec_fused_pass, vec_pass,
)

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def scalar_setup(stencil: ScalarStencil5, spec: FilterSpec, exact_nan: bool):
    """``(hot_host, drop_pre, land_gain, neg2s, p_host)``: what the scalar
    applies derive from the host stencil and the filter spec before any
    device is known. ``hot_host`` is the stencil of the hot loop (without its
    pre-mask under the h-space elimination), ``neg2s = -2*lap_scale``."""
    if spec.n_steps < 2:
        raise ValueError(f"the step kernels need n_steps >= 2, got {spec.n_steps}")
    p_host = np.asarray(spec.p, dtype=np.float64)
    drop_pre = hspace_drop_pre(stencil) and not exact_nan
    land_gain = float(np.polynomial.chebyshev.chebval(-1.0, p_host))
    hot_host = (
        dataclasses.replace(stencil, pre=None, zap_nans=False) if drop_pre else stencil
    )
    neg2s = -2.0 * _laplacian_scale(spec, stencil.is_dimensional)
    return hot_host, drop_pre, land_gain, neg2s, p_host


def scalar_operands(hot_host: ScalarStencil5, neg2s: float, drop_pre: bool,
                    land_gain: float, dtype, device) -> PassOperands:
    """The hot stencil for one (dtype, device): coefficients cast, then
    pre-scaled by -2*lap_scale in the compute dtype (constants are scaled in
    float64 and rounded once), as the JAX kernel's host side does."""
    npdt = _NP_DTYPES[dtype]
    st = hot_host.to(dtype, device)
    scaled = {}
    for k in COEF_FIELDS:
        v = getattr(st, k)
        if isinstance(v, torch.Tensor):
            scaled[k] = (v * float(npdt(neg2s))).contiguous()
        else:
            scaled[k] = float(npdt(neg2s * v))
    masks = {k: getattr(st, k).contiguous() for k in ("pre", "post", "area")
             if getattr(st, k) is not None}
    st = dataclasses.replace(st, **scaled, **masks)
    return PassOperands(st, drop_pre, float(npdt(land_gain)))


def make_cuda_scalar_apply(
    stencil: ScalarStencil5, spec: FilterSpec, exact_nan: bool = False,
    pass_fn=cheb_pass, fused_fn=cheb_fused_pass,
):
    """``field -> filtered`` on the field's device: one launch per planned
    fused pass, or ``n_steps`` step launches below the plan's predicate.

    ``field`` has the spatial dims last; leading dims are batched. The
    result has the compute dtype (:func:`engine._compute_dtype`).
    ``fused_fn`` runs one fused pass and ``pass_fn`` one step; they are
    :func:`cheb_fused_pass` and :func:`cheb_pass` (kernels for CUDA tensors,
    plain versions for CPU tensors) unless a caller passes the plain versions
    to compare them on one device. ``fused_fn=None`` runs the step chain on
    purpose.
    """
    hot_host, drop_pre, land_gain, neg2s, p_host = scalar_setup(stencil, spec, exact_nan)
    shapes = {tuple(v.shape) for v in (getattr(hot_host, k) for k in ARRAY_FIELDS)
              if isinstance(v, torch.Tensor)}
    cache = {}
    n_planes = fused_planes(PassOperands(hot_host, drop_pre, land_gain))

    def plan(ny: int, nx: int, dtype):
        """The fused plan of this filter for one field shape and dtype."""
        return plan_fused_passes(spec.n_steps, ny, nx, dtype, n_planes)

    def operands(dtype, device):
        """Hot stencil and p for one (dtype, device), see :func:`scalar_operands`."""
        key = (dtype, device)
        if key not in cache:
            with setup_span("gft.setup.operands"):
                ops = scalar_operands(hot_host, neg2s, drop_pre, land_gain, dtype, device)
                cache[key] = (ops, [float(v) for v in p_host.astype(_NP_DTYPES[dtype])])
        return cache[key]

    def apply_fn(field):
        field = torch.as_tensor(field)
        if field.dim() < 2:
            raise ValueError(
                f"fields need two spatial dims (..., y, x); got shape {tuple(field.shape)}")
        dtype = _compute_dtype(field.dtype)
        ny, nx = field.shape[-2:]
        if shapes and shapes != {(ny, nx)}:
            raise ValueError(
                f"field's spatial shape {(ny, nx)} does not match the grid's {next(iter(shapes))}")
        lead = field.shape[:-2]
        x = field.to(dtype).contiguous().reshape(-1, ny, nx)
        if x.numel() == 0:
            return torch.empty(field.shape, dtype=dtype, device=field.device)
        ops, p = operands(dtype, x.device)
        pl = plan(ny, nx, dtype)
        if fused_fn is not None and pl.fused:
            acc = _fused_chain(fused_fn, ops, p, pl, x)
        else:
            acc = _step_chain(pass_fn, ops, p, spec.n_steps, x)
        return acc.reshape(lead + (ny, nx))

    apply_fn.operands = operands  # (dtype, device) -> (PassOperands, p), for checks
    apply_fn.plan = plan  # (ny, nx, dtype) -> FusedPlan
    return apply_fn


def _step_chain(pass_fn, ops: PassOperands, p, n: int, x):
    """``n`` one-step launches on ``(batch, ny, nx)`` ``x``: the result."""
    h, t, acc = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    pass_fn(ops, FIRST, p[0], p[1], field=x, t_next=t, acc=acc, h=h)
    t_prev = h
    for k in range(2, n):
        # t_next overwrites t_prev in place; acc is updated in place
        pass_fn(ops, MIDDLE, p[k], t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
        t, t_prev = t_prev, t
    pass_fn(ops, LAST, p[n], field=x, t=t, t_prev=t_prev, acc=acc)
    return acc


def _fused_chain(fused_fn, ops, p, pl, x, name="field"):
    """One fused launch per pass of the plan ``pl`` on the state ``x``
    (``(batch, ny, nx)``, or the stacked ``(batch, 2, ny, nx)`` of a vector
    filter): the result. ``x`` goes to the first and the last pass as the
    argument ``name`` (the scalar field, which the last pass reads again; the
    vector ``w``, which only a first pass reads). A pass reads its carries
    from one pair of buffers and writes the next pass's into the other (a
    tile reads its neighbours' cells, so a pass cannot update its carries in
    place); acc is updated in place."""
    acc = torch.empty_like(x)
    pairs = [(torch.empty_like(x), torch.empty_like(x)) for _ in range(min(2, len(pl.steps) - 1))]
    t = t_prev = None
    start = 0
    for i, n_ops in enumerate(pl.steps):
        if i == len(pl.steps) - 1:
            fused_fn(ops, p, start, n_ops, tile=pl.tile, t=t, t_prev=t_prev, acc=acc, **{name: x})
        else:
            t_out, t_prev_out = pairs[i % 2]
            fused_fn(ops, p, start, n_ops, tile=pl.tile, t=t, t_prev=t_prev, t_out=t_out,
                     t_prev_out=t_prev_out, acc=acc, **{name: x if i == 0 else None})
            t, t_prev = t_out, t_prev_out
        start += n_ops
    return acc


def vector_setup(operator, spec: FilterSpec):
    """``(op, grid_shape, neg2s, p_host, host_planes)`` of a vector operator:
    the kernel's contraction, the grid's shape, ``-2*lap_scale``, the
    polynomial in float64 and a function that returns the coefficient planes
    in the kernel's order, float64 on the host (the C-grid taps are computed
    once, at first use, in a ``gft.setup.ctaps`` span: ~1.2 GB of float64 at
    2400x3600)."""
    if isinstance(operator, BGridVectorStencil):
        op = BGRID
    elif isinstance(operator, CGridVectorOperator):
        op = CTAP
    else:
        raise TypeError(f"no vector kernel for operator {type(operator).__name__}")
    if spec.n_steps < 2:
        raise ValueError(f"the step kernels need n_steps >= 2, got {spec.n_steps}")
    p_host = np.asarray(spec.p, dtype=np.float64)
    neg2s = -2.0 * _laplacian_scale(spec, operator.is_dimensional)
    grid_shape = tuple(operator.r_dyCu.shape if op == CTAP else operator.cc.shape)
    taps = []

    def host_planes():
        if op == BGRID:
            return [getattr(operator, k).numpy() for k in BGRID_FIELDS]
        if not taps:
            n = len(CTAP_NAMES)
            with setup_span("gft.setup.ctaps", planes=n, bytes=n * 8 * math.prod(grid_shape)):
                taps.append(cgrid_tap_arrays(operator))
        return [taps[0][k] for k in CTAP_NAMES]

    return op, grid_shape, neg2s, p_host, host_planes


def vector_operands(op: int, planes, neg2s: float, zap: bool, dtype, device) -> VecPassOperands:
    """The coefficients for one (dtype, device): each host plane cast to the
    compute dtype, then scaled by -2*lap_scale rounded to that dtype, as the
    JAX kernel's host side does (vec_pass.host_*_ext_inputs)."""
    npdt = _NP_DTYPES[dtype]
    coef = torch.empty((len(planes),) + tuple(np.shape(planes[0])), dtype=dtype, device=device)
    for k, a in enumerate(planes):
        coef[k].copy_(torch.from_numpy(np.asarray(a, dtype=npdt) * npdt(neg2s)))
    return VecPassOperands(op, coef, zap)


def make_cuda_vector_apply(operator, spec: FilterSpec, pass_fn=vec_pass,
                           fused_fn=vec_fused_pass):
    """``(u, v) -> (fu, fv)`` on the fields' device: one launch per planned
    fused pass, or ``n_steps`` step launches below the plan's predicate.

    ``u`` and ``v`` have equal shapes with the spatial dims last; leading
    dims are batched. Both are promoted to ``_compute_dtype(u.dtype,
    v.dtype)`` (mixed float32/float64 computes in float64), which is the
    results' dtype. ``fused_fn`` runs one fused pass and ``pass_fn`` one
    step; they are :func:`vec_fused_pass` and :func:`vec_pass` (kernels for
    CUDA tensors, plain versions for CPU tensors) unless a caller passes the
    plain versions to compare them on one device. ``fused_fn=None`` runs the
    step chain on purpose.
    """
    op, grid_shape, neg2s, p_host, host_planes = vector_setup(operator, spec)
    cache = {}

    def plan(ny: int, nx: int, dtype):
        """The fused plan of this filter for one field shape and dtype."""
        return plan_vec_fused_passes(spec.n_steps, ny, nx, dtype, op)

    def operands(dtype, device):
        """Coefficients and p for one (dtype, device), see :func:`vector_operands`."""
        key = (dtype, device)
        if key not in cache:
            with setup_span("gft.setup.operands"):
                ops = vector_operands(op, host_planes(), neg2s, bool(operator.zap_nans),
                                      dtype, device)
                cache[key] = (ops, [float(v) for v in p_host.astype(_NP_DTYPES[dtype])])
        return cache[key]

    def apply_fn(u, v):
        u, v = torch.as_tensor(u), torch.as_tensor(v)
        if u.shape != v.shape:
            raise ValueError(
                f"u and v must have the same shape; got {tuple(u.shape)} and {tuple(v.shape)}")
        if u.device != v.device:
            raise ValueError(f"u is on {u.device} but v is on {v.device}")
        if u.dim() < 2:
            raise ValueError(
                f"fields need two spatial dims (..., y, x); got shape {tuple(u.shape)}")
        dtype = _compute_dtype(u.dtype, v.dtype)
        ny, nx = u.shape[-2:]
        if (ny, nx) != grid_shape:
            raise ValueError(
                f"field's spatial shape {(ny, nx)} does not match the grid's {grid_shape}")
        lead = u.shape[:-2]
        if u.numel() == 0:
            return (torch.empty(u.shape, dtype=dtype, device=u.device),
                    torch.empty(u.shape, dtype=dtype, device=u.device))
        # a fresh stacked state, owned here: the step chain overwrites it as t_prev
        w = torch.stack([u.to(dtype), v.to(dtype)], dim=-3).reshape(-1, 2, ny, nx)
        ops, p = operands(dtype, w.device)
        pl = plan(ny, nx, dtype)
        if fused_fn is not None and pl.fused:
            acc = _fused_chain(fused_fn, ops, p, pl, w, name="w")
        else:
            acc = _vec_step_chain(pass_fn, ops, p, spec.n_steps, w)
        return acc[:, 0].reshape(lead + (ny, nx)), acc[:, 1].reshape(lead + (ny, nx))

    apply_fn.operands = operands  # (dtype, device) -> (VecPassOperands, p), for checks
    apply_fn.plan = plan  # (ny, nx, dtype) -> FusedPlan
    return apply_fn


def _vec_step_chain(pass_fn, ops: VecPassOperands, p, n: int, w):
    """``n`` one-step launches on the stacked ``(batch, 2, ny, nx)`` ``w``,
    which the chain overwrites: the result."""
    t, acc = torch.empty_like(w), torch.empty_like(w)
    pass_fn(ops, FIRST, p[0], p[1], w=w, t_next=t, acc=acc)
    t_prev = w
    for k in range(2, n):
        # t_next overwrites t_prev in place; acc is updated in place
        pass_fn(ops, MIDDLE, p[k], t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
        t, t_prev = t_prev, t
    pass_fn(ops, LAST, p[n], t=t, t_prev=t_prev, acc=acc)
    return acc
