"""The filter itself, written out plainly: the target responses of both of
GCM-Filters' shapes, their default step counts, the Chebyshev fit of a
target and the three-term recurrence that applies it.

This is the yardstick's own copy of the math of Grooms et al. (2021, JAMES)
as GCM-Filters states it (``gcm_filters/filter.py``); it imports nothing of
the program. The fit is a Galerkin projection of the target response F(t)
onto T_0..T_n, in the basis phi_i = T_i - T_{i+2} plus a linear lift that
pins F at both ends. The filter is then

    A = -I - scale * L,   T_0 = f,  T_1 = A f,  T_k = 2 A T_{k-1} - T_{k-2},
    filtered = sum_k p_k T_k,

with ``scale = 2 / s_max`` for a dimensional Laplacian L and
``2 / (s_max * dx_min**2)`` for one on the unit-spacing grid.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

# Default step counts, GCM-Filters' table per shape and dimension:
# ceil((offset + factor * (pi / transition_width) ** exponent)
#      * filter_scale / dx_min), at least 3.
STEP_RULE = {
    "GAUSSIAN": {1: (0.8, 0.0, 1.0), 2: (1.1, 0.0, 1.0)},
    "TAPER": {1: (2.2, 0.6, 2.5), 2: (3.2, 0.7, 2.7)},
}
# GCM-Filters' default transition width of the Taper (the Gaussian has none).
TRANSITION_WIDTH = math.pi


def n_steps_default(shape: str, filter_scale: float, dx_min: float,
                    transition_width: float = TRANSITION_WIDTH, ndim: int = 2) -> int:
    offset, factor, exponent = STEP_RULE[shape][ndim]
    per_scale = offset + factor * (math.pi / transition_width) ** exponent
    return max(3, math.ceil(per_scale * filter_scale / dx_min))


def gaussian_target(filter_scale: float, s_max: float) -> Callable:
    """exp(-s L^2 / 24) at s = s_max (t + 1) / 2."""

    def target(t):
        return np.exp(-(s_max * (t + 1.0) / 2.0) * filter_scale ** 2 / 24.0)

    return target


def taper_target(filter_scale: float, s_max: float, transition_width: float) -> Callable:
    """1 below k = 2 pi / (t_w L), 0 above 2 pi / L, and between them the
    monotone cubic (PCHIP) through the knots k = 0, 2 pi / (t_w L),
    2 pi / L, 8 sqrt(s_max) with the values 1, 1, 0, 0; k = sqrt(s) at
    s = s_max (t + 1) / 2."""
    from scipy.interpolate import PchipInterpolator

    knots = np.array([0.0, 2.0 * np.pi / (transition_width * filter_scale),
                      2.0 * np.pi / filter_scale, 8.0 * np.sqrt(s_max)])
    pchip = PchipInterpolator(knots, np.array([1.0, 1.0, 0.0, 0.0]))

    def target(t):
        return pchip(np.sqrt(s_max * (np.asarray(t, dtype=np.float64) + 1.0) / 2.0))

    return target


def fit(target: Callable, n_steps: int) -> np.ndarray:
    """The Chebyshev coefficients p_0..p_n of ``target`` on [-1, 1]: the
    Galerkin projection under the Chebyshev weight, exact at both ends."""
    n = n_steps
    m = n - 1
    # <phi_i, phi_j> under the Chebyshev weight
    mass = math.pi * np.eye(m)
    mass[0, 0] = 1.5 * math.pi
    for i in range(m - 2):
        mass[i, i + 2] = mass[i + 2, i] = -0.5 * math.pi
    nodes, weights = np.polynomial.chebyshev.chebgauss(n + 1)
    f1 = float(target(1.0))
    lift = (1.0 - nodes) / 2.0 + f1 * (1.0 + nodes) / 2.0
    vander = np.polynomial.chebyshev.chebvander(nodes, n)
    phi = vander[:, :m] - vander[:, 2:m + 2]
    c_hat = np.linalg.solve(mass, phi.T @ (weights * (target(nodes) - lift)))
    p = np.zeros(n + 1)
    p[:m] += c_hat
    p[2:m + 2] -= c_hat
    p[0] += (1.0 + f1) / 2.0
    p[1] -= (1.0 - f1) / 2.0
    return p


def filter_coefficients(shape: str, filter_scale: float, dx_min: float, n_steps: int,
                        transition_width: float = TRANSITION_WIDTH,
                        ndim: int = 2) -> Tuple[np.ndarray, float]:
    """``(p, s_max)``: the Chebyshev coefficients of the ``shape``
    ("GAUSSIAN" or "TAPER") filter's response, and s_max."""
    s_max = ndim * (2.0 / dx_min) ** 2
    if shape == "GAUSSIAN":
        target = gaussian_target(filter_scale, s_max)
    elif shape == "TAPER":
        target = taper_target(filter_scale, s_max, transition_width)
    else:
        raise ValueError(f"the reference fits GAUSSIAN and TAPER, not {shape}")
    return fit(target, n_steps), s_max


def chebyshev_filter(laplacian: Callable[..., Tuple[torch.Tensor, ...]],
                     fields: Sequence[torch.Tensor], p: Sequence[float],
                     scale: float) -> Tuple[torch.Tensor, ...]:
    """Apply sum_k p_k T_k(A) to ``fields`` (one scalar field, or u and v),
    in the fields' dtype. ``laplacian`` maps the tuple of fields to the tuple
    of their Laplacians."""
    dtype = fields[0].dtype

    def shifted(ts):
        return tuple(-t - scale * lt for t, lt in zip(ts, laplacian(*ts)))

    coef = [torch.tensor(float(c), dtype=dtype, device=fields[0].device) for c in p]
    t_prev = tuple(fields)
    t_cur = shifted(t_prev)
    acc = tuple(coef[0] * a + coef[1] * b for a, b in zip(t_prev, t_cur))
    for c in coef[2:]:
        t_next = tuple(2 * s - q for s, q in zip(shifted(t_cur), t_prev))
        acc = tuple(a + c * t for a, t in zip(acc, t_next))
        t_prev, t_cur = t_cur, t_next
    return acc
