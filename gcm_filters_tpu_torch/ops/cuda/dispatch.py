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

Each filter is ``n_steps`` launches of one step kernel (ops/cuda/cheb_pass.py):
FIRST (prepare and masking fused), MIDDLE, ..., LAST (land reconstruction and
finalize fused). The carries live in three buffers allocated per call; the
kernel overwrites t_prev with t_next and updates acc in place.

Vector grids run their own recurrence on the stacked pair (batch, 2, ny, nx):
B-grid with its ten diffusion and mixing planes, C-grid with the 18 tap planes
of its composed form (ops/ctaps.py), both without masks or area.

CUDA tensors go through the kernel and CPU tensors through its plain version;
there is no other route and no fallback.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...engine import _compute_dtype, _laplacian_scale
from ...filter_spec import FilterSpec
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
from .cheb_pass import FIRST, LAST, MIDDLE, PassOperands, cheb_pass
from .vec_pass import BGRID, CTAP, VecPassOperands, vec_pass

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
    pass_fn=cheb_pass,
):
    """``field -> filtered`` on the field's device, ``n_steps`` launches per call.

    ``field`` has the spatial dims last; leading dims are batched. The
    result has the compute dtype (:func:`engine._compute_dtype`). ``pass_fn``
    runs one step; it is :func:`cheb_pass` (kernel for CUDA tensors, plain
    version for CPU tensors) unless a caller passes the plain version to
    compare the two on one device.
    """
    hot_host, drop_pre, land_gain, neg2s, p_host = scalar_setup(stencil, spec, exact_nan)
    shapes = {tuple(v.shape) for v in (getattr(hot_host, k) for k in ARRAY_FIELDS)
              if isinstance(v, torch.Tensor)}
    cache = {}

    def operands(dtype, device):
        """Hot stencil and p for one (dtype, device), see :func:`scalar_operands`."""
        key = (dtype, device)
        if key not in cache:
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
        n = spec.n_steps
        h, t, acc = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
        pass_fn(ops, FIRST, p[0], p[1], field=x, t_next=t, acc=acc, h=h)
        t_prev = h
        for k in range(2, n):
            # t_next overwrites t_prev in place; acc is updated in place
            pass_fn(ops, MIDDLE, p[k], t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
            t, t_prev = t_prev, t
        pass_fn(ops, LAST, p[n], field=x, t=t, t_prev=t_prev, acc=acc)
        return acc.reshape(lead + (ny, nx))

    apply_fn.operands = operands  # (dtype, device) -> (PassOperands, p), for checks
    return apply_fn


def vector_setup(operator, spec: FilterSpec):
    """``(op, grid_shape, neg2s, p_host, host_planes)`` of a vector operator:
    the kernel's contraction, the grid's shape, ``-2*lap_scale``, the
    polynomial in float64 and a function that returns the coefficient planes
    in the kernel's order, float64 on the host (the C-grid taps are computed
    once, at first use: ~1.2 GB of float64 at 2400x3600)."""
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


def make_cuda_vector_apply(operator, spec: FilterSpec, pass_fn=vec_pass):
    """``(u, v) -> (fu, fv)`` on the fields' device, ``n_steps`` launches per call.

    ``u`` and ``v`` have equal shapes with the spatial dims last; leading
    dims are batched. Both are promoted to ``_compute_dtype(u.dtype,
    v.dtype)`` (mixed float32/float64 computes in float64), which is the
    results' dtype. ``pass_fn`` runs one step; it is :func:`vec_pass` (kernel
    for CUDA tensors, plain version for CPU tensors) unless a caller passes
    the plain version to compare the two on one device.
    """
    op, grid_shape, neg2s, p_host, host_planes = vector_setup(operator, spec)
    cache = {}

    def operands(dtype, device):
        """Coefficients and p for one (dtype, device), see :func:`vector_operands`."""
        key = (dtype, device)
        if key not in cache:
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
        # a fresh stacked state, owned here: MIDDLE overwrites it as t_prev
        w = torch.stack([u.to(dtype), v.to(dtype)], dim=-3).reshape(-1, 2, ny, nx)
        ops, p = operands(dtype, w.device)
        n = spec.n_steps
        t, acc = torch.empty_like(w), torch.empty_like(w)
        pass_fn(ops, FIRST, p[0], p[1], w=w, t_next=t, acc=acc)
        t_prev = w
        for k in range(2, n):
            # t_next overwrites t_prev in place; acc is updated in place
            pass_fn(ops, MIDDLE, p[k], t=t, t_prev=t_prev, t_next=t_prev, acc=acc)
            t, t_prev = t_prev, t
        pass_fn(ops, LAST, p[n], t=t, t_prev=t_prev, acc=acc)
        return acc[:, 0].reshape(lead + (ny, nx)), acc[:, 1].reshape(lead + (ny, nx))

    apply_fn.operands = operands  # (dtype, device) -> (VecPassOperands, p), for checks
    return apply_fn
