"""Host-side filter-target math: shapes, step-count heuristic, Chebyshev fit.

PyTorch-port counterpart of ``gcm_filters_tpu/filter_spec.py``: a copy of
that pure-numpy module, so that the port never imports the JAX package. It
runs once, on the host, in numpy float64, when a ``Filter`` is built; its
output -- a :class:`FilterSpec` of Chebyshev coefficients -- drives the
recurrence on the device. ``tests/test_torch_host_math.py`` holds it bit for
bit against the JAX package.

The math follows Grooms et al. (2021, JAMES): a low-pass filter with target
frequency response F(k) is approximated by a degree-``n_steps`` Chebyshev
polynomial in the (rescaled) Laplacian eigenvalue s = k², fitted by a Galerkin
projection in the Shen (SISC 1995) basis phi_i = T_i - T_{i+2} with the
endpoint values pinned by a linear boundary lift so that the approximation is
exact at s = 0 (mean preserved) and s = s_max.
"""
from __future__ import annotations

import enum
from typing import Callable, NamedTuple, Sequence

import numpy as np


class FilterShape(enum.Enum):
    """Shape of the target filter's frequency response."""

    GAUSSIAN = 1
    TAPER = 2


# Tuning constants for the default step count, tabulated per shape and
# dimensionality (upstream gcm-filters, filter.py:28-37). n_steps_default =
# ceil((offset + factor * (pi / transition_width) ** exponent)
#      * filter_scale / dx_min), floored at 3.
filter_params = {
    FilterShape.GAUSSIAN: {
        1: {"offset": 0.8, "factor": 0.0, "exponent": 1},
        2: {"offset": 1.1, "factor": 0.0, "exponent": 1},
    },
    FilterShape.TAPER: {
        1: {"offset": 2.2, "factor": 0.6, "exponent": 2.5},
        2: {"offset": 3.2, "factor": 0.7, "exponent": 2.7},
    },
}


def compute_n_steps_default(
    ndim: int,
    filter_shape: FilterShape,
    filter_scale: float,
    dx_min: float,
    transition_width: float,
) -> int:
    """Default Chebyshev step count for 1-D/2-D filters (upstream gcm-filters, filter.py:74-89)."""
    params = filter_params[filter_shape][ndim]
    n_steps_factor = params["offset"] + params["factor"] * (
        (np.pi / transition_width) ** params["exponent"]
    )
    n = int(np.ceil(n_steps_factor * filter_scale / dx_min))
    return max(n, 3)


class TargetSpec(NamedTuple):
    s_max: float
    filter_scale: float
    transition_width: float


def _k_of_t(t: np.ndarray, s_max: float) -> np.ndarray:
    """Map Chebyshev variable t in [-1, 1] to wavenumber k = sqrt(s),
    s = s_max * (t + 1) / 2."""
    return np.sqrt(s_max * (t + 1.0) / 2.0)


def gaussian_target(spec: TargetSpec) -> Callable[[np.ndarray], np.ndarray]:
    """Gaussian response exp(-k^2 L^2 / 24) as a function of t in [-1, 1]
    (upstream gcm-filters, filter.py:47-50)."""

    def F(t):
        s = spec.s_max * (np.asarray(t, dtype=np.float64) + 1.0) / 2.0
        return np.exp(-s * spec.filter_scale**2 / 24.0)

    return F


def taper_target(spec: TargetSpec) -> Callable[[np.ndarray], np.ndarray]:
    """Taper response: 1 below the transition band, 0 above the cutoff
    2*pi/filter_scale, PCHIP-smooth in between (upstream gcm-filters, filter.py:53-65)."""
    from scipy import interpolate  # host-only dependency

    knots_k = np.array(
        [
            0.0,
            2.0 * np.pi / (spec.transition_width * spec.filter_scale),
            2.0 * np.pi / spec.filter_scale,
            8.0 * np.sqrt(spec.s_max),
        ]
    )
    knots_v = np.array([1.0, 1.0, 0.0, 0.0])
    pchip = interpolate.PchipInterpolator(knots_k, knots_v)

    def F(t):
        return pchip(_k_of_t(np.asarray(t, dtype=np.float64), spec.s_max))

    return F


_TARGET_BUILDERS = {
    FilterShape.GAUSSIAN: gaussian_target,
    FilterShape.TAPER: taper_target,
}


def target_function(
    filter_shape: FilterShape, spec: TargetSpec
) -> Callable[[np.ndarray], np.ndarray]:
    """The target frequency response F(t) for the given shape."""
    return _TARGET_BUILDERS[filter_shape](spec)


class FilterSpec(NamedTuple):
    """Static output of the target fit, fed into the compiled iteration.

    Attributes
    ----------
    n_steps : number of Chebyshev iterations
    s_max : upper bound of the Laplacian spectrum, ndim * (2 / dx_min)**2
    p : Chebyshev coefficients p[0..n_steps] of the fitted response
    dx_min_sq : dx_min**2, used to nondimensionalize dimensional Laplacians
    """

    n_steps: int
    s_max: float
    p: Sequence[float]
    dx_min_sq: float


def compute_filter_spec(
    filter_scale: float,
    dx_min: float,
    filter_shape: FilterShape,
    transition_width: float = np.pi,
    ndim: int = 2,
    n_steps: int = 0,
) -> FilterSpec:
    """Fit Chebyshev coefficients to the target response.

    Galerkin projection in the Shen basis phi_i(t) = T_i(t) - T_{i+2}(t),
    i = 0..n-2, which vanishes at t = ±1 so the endpoint behavior is carried
    by the linear lift G(t) = (1 - t)/2 + F(1) (1 + t)/2. Matches the
    upstream gcm-filters solver (filter.py:99-151) to roundoff.
    """
    n = int(n_steps)
    if n < 3:
        raise ValueError("n_steps must be >= 3 to fit a filter spec")

    # The 2nd-order discrete Laplacians resolve eigenvalues up to
    # s_max = ndim * (2 / dx_min)^2; rescale s to t in [-1, 1].
    s_max = ndim * (2.0 / dx_min) ** 2
    F = target_function(filter_shape, TargetSpec(s_max, filter_scale, transition_width))

    # Mass matrix of the Shen basis under the Chebyshev weight:
    # <phi_i, phi_j> = pi (i == j > 0), 3pi/2 (i == j == 0), -pi/2 (|i-j| == 2).
    m = n - 1  # number of basis functions
    M = np.pi * np.eye(m)
    M[0, 0] = 3.0 * np.pi / 2.0
    off = -np.pi / 2.0 * np.ones(m - 2)
    M += np.diag(off, 2) + np.diag(off, -2)

    # Chebyshev-Gauss quadrature nodes/weights for the weighted inner products.
    nodes, weights = np.polynomial.chebyshev.chebgauss(n + 1)
    F1 = float(np.asarray(F(1.0)))
    lift = (1.0 - nodes) / 2.0 + F1 * (nodes + 1.0) / 2.0
    residual = F(nodes) - lift  # what the Shen expansion must capture

    # phi_i evaluated at all nodes, for all i at once: T_i - T_{i+2}.
    # chebvander gives T_0..T_{n} at each node.
    V = np.polynomial.chebyshev.chebvander(nodes, n)  # (n+1 nodes, n+1 degrees)
    phi = V[:, :m] - V[:, 2 : m + 2]  # (nodes, m)
    b = phi.T @ (weights * residual)

    c_hat = np.linalg.solve(M, b)

    # Assemble Chebyshev-basis coefficients of lift + sum_i c_hat_i phi_i:
    # lift = (1 + F1)/2 * T_0 - (1 - F1)/2 * T_1;
    # phi_i contributes +c_hat_i at degree i and -c_hat_i at degree i+2.
    p = np.zeros(n + 1)
    p[:m] += c_hat
    p[2 : m + 2] -= c_hat
    p[0] += (1.0 + F1) / 2.0
    p[1] -= (1.0 - F1) / 2.0

    return FilterSpec(n_steps=n, s_max=float(s_max), p=p, dx_min_sq=float(dx_min) ** 2)
