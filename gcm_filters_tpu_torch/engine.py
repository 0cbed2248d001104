"""The eager Chebyshev filter engine: the plain PyTorch version of the whole filter.

PyTorch-port counterpart of the eager engine of ``gcm_filters_tpu/engine.py``.
The filter is a degree-``n_steps`` Chebyshev polynomial of the shifted
operator A = -I - (2/s_max) * Laplacian (nondimensionalized by dx_min^2 for
nondimensional Laplacians), evaluated by the three-term recurrence

    T_0 = f,  T_1 = A f,  T_k = 2 A T_{k-1} - T_{k-2},
    filtered = sum_k p_k T_k

``Filter`` does not run this engine: it goes through the kernel dispatch
(ops/cuda/dispatch.py). :func:`scalar_filter_apply` and
:func:`vector_filter_apply` are the oracles for the whole filter, in the
tests and in ``chip_smoke.py``.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .filter_spec import FilterSpec
from .ops.stencil import BGridVectorStencil, CGridVectorOperator, ScalarStencil5


def _laplacian_scale(spec: FilterSpec, is_dimensional: bool) -> float:
    """The constant multiplying the Laplacian inside the shifted operator."""
    if is_dimensional:
        return 2.0 / spec.s_max
    return 2.0 / (spec.s_max * spec.dx_min_sq)


def _compute_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """The floating dtype the filter computes in.

    JAX's rule ``jnp.result_type(*dtypes, float32)`` with 64-bit mode on, not
    PyTorch's or numpy's: float64 stays float64, and every other real type
    (integers, bool, float16, bfloat16) computes in float32. Operator
    coefficients are cast to THIS dtype, never to a raw input dtype, which
    would truncate floating coefficients to integers.
    """
    if any(d.is_complex for d in dtypes):
        raise TypeError(f"complex fields are not supported (got {dtypes})")
    return torch.float64 if torch.float64 in dtypes else torch.float32


def scalar_filter_apply(stencil: ScalarStencil5, spec: FilterSpec, field) -> torch.Tensor:
    """Filter ``field`` (spatial dims last two, leading dims batched).

    Runs on the field's device. Non-floating inputs are promoted (see
    :func:`_compute_dtype`).
    """
    field = torch.as_tensor(field)
    dtype = _compute_dtype(field.dtype)
    field = field.to(dtype)
    stencil = stencil.to(dtype, field.device)
    lap_scale = _laplacian_scale(spec, stencil.is_dimensional)
    p = torch.as_tensor(np.asarray(spec.p), dtype=dtype, device=field.device)

    def shifted(f: torch.Tensor) -> torch.Tensor:
        return -f - lap_scale * stencil.laplacian(f)

    fbar = stencil.prepare(field)
    t_prev2 = fbar
    t_prev1 = shifted(fbar)
    acc = p[0] * t_prev2 + p[1] * t_prev1
    for p_i in p[2:]:
        t0 = 2.0 * shifted(t_prev1) - t_prev2
        acc = acc + p_i * t0
        t_prev2, t_prev1 = t_prev1, t0
    return stencil.finalize(acc)


def vector_filter_apply(
    operator: Union[BGridVectorStencil, CGridVectorOperator],
    spec: FilterSpec,
    ufield,
    vfield,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Filter a vector field (u, v) in lockstep with a vector Laplacian.

    Both inputs are promoted to one compute dtype
    (``_compute_dtype(u.dtype, v.dtype)``) and run on ``ufield``'s device.
    """
    ufield = torch.as_tensor(ufield)
    vfield = torch.as_tensor(vfield, device=ufield.device)
    dtype = _compute_dtype(ufield.dtype, vfield.dtype)
    ufield = ufield.to(dtype)
    vfield = vfield.to(dtype)
    operator = operator.to(dtype, ufield.device)
    lap_scale = _laplacian_scale(spec, operator.is_dimensional)
    p = torch.as_tensor(np.asarray(spec.p), dtype=dtype, device=ufield.device)

    def shifted(u, v):
        lu, lv = operator.laplacian(u, v)
        return -u - lap_scale * lu, -v - lap_scale * lv

    u0, v0 = operator.prepare(ufield, vfield)
    ut2, vt2 = u0, v0
    ut1, vt1 = shifted(u0, v0)
    uacc = p[0] * ut2 + p[1] * ut1
    vacc = p[0] * vt2 + p[1] * vt1
    for p_i in p[2:]:
        su, sv = shifted(ut1, vt1)
        ut0 = 2.0 * su - ut2
        vt0 = 2.0 * sv - vt2
        uacc = uacc + p_i * ut0
        vacc = vacc + p_i * vt0
        ut2, vt2, ut1, vt1 = ut1, vt1, ut0, vt0
    return operator.finalize(uacc, vacc)
