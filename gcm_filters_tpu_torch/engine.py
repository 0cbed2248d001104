"""The eager Chebyshev filter engine: the plain PyTorch version of the whole filter.

PyTorch-port counterpart of the scalar part of ``gcm_filters_tpu/engine.py``.
The filter is a degree-``n_steps`` Chebyshev polynomial of the shifted
operator A = -I - (2/s_max) * Laplacian (nondimensionalized by dx_min^2 for
nondimensional Laplacians), evaluated by the three-term recurrence

    T_0 = f,  T_1 = A f,  T_k = 2 A T_{k-1} - T_{k-2},
    filtered = sum_k p_k T_k

``Filter`` does not run this engine: it goes through the kernel dispatch
(ops/cuda/dispatch.py). This is the oracle for the whole filter, in the tests
and in ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from .filter_spec import FilterSpec
from .ops.stencil import ScalarStencil5


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
