"""Tap expansion of the C-grid viscosity operator.

PyTorch-port counterpart of ``gcm_filters_tpu/ops/ctaps.py``, kept as a copy
so that the port never imports the JAX package. The Griffies & Hallberg
operator (:class:`~.stencil.CGridVectorOperator`) is a two-stage stencil:
strains at T/q points, then a divergence back to the u/v points. Composed, it
is a *single-stage* coupled stencil with a fixed sparsity pattern:

    u_out <- u at the 5-point cross            (CU_c/w/e/s/n)
    u_out <- v at {(0,0),(-1,0),(0,+1),(-1,+1)}  (DU_c/s/e/se)
    v_out <- v at the 5-point cross            (CV_c/w/e/s/n)
    v_out <- u at {(0,0),(0,-1),(+1,0),(+1,-1)}  (DV_c/w/n/nw)

whose 18 per-cell coefficient arrays are pure metric combinations, computed
once on the host in numpy float64. The composed form agrees with the staged
form to roundoff (a different floating-point evaluation order).

Offset convention: (dy, dx) means the tap reads input[j+dy, i+dx] with
periodic wrap. Tap order below is the CUDA kernel's coefficient order
(``csrc/vec_pass.cu``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .stencil import CGridVectorOperator

# (name, out_component, in_component, dy, dx) — fixed kernel order.
CTAPS: List[Tuple[str, int, int, int, int]] = [
    ("CU_c", 0, 0, 0, 0),
    ("CU_w", 0, 0, 0, -1),
    ("CU_e", 0, 0, 0, +1),
    ("CU_s", 0, 0, -1, 0),
    ("CU_n", 0, 0, +1, 0),
    ("DU_c", 0, 1, 0, 0),
    ("DU_s", 0, 1, -1, 0),
    ("DU_e", 0, 1, 0, +1),
    ("DU_se", 0, 1, -1, +1),
    ("CV_c", 1, 1, 0, 0),
    ("CV_w", 1, 1, 0, -1),
    ("CV_e", 1, 1, 0, +1),
    ("CV_s", 1, 1, -1, 0),
    ("CV_n", 1, 1, +1, 0),
    ("DV_c", 1, 0, 0, 0),
    ("DV_w", 1, 0, 0, -1),
    ("DV_n", 1, 0, +1, 0),
    ("DV_nw", 1, 0, +1, -1),
]
CTAP_NAMES = tuple(name for name, *_ in CTAPS)


def _E(a):  # value at [j, i+1]
    return np.roll(a, -1, -1)


def _W(a):  # value at [j, i-1]
    return np.roll(a, 1, -1)


def _N(a):  # value at [j+1, i]
    return np.roll(a, -1, -2)


def _S(a):  # value at [j-1, i]
    return np.roll(a, 1, -2)


def cgrid_tap_arrays(op: CGridVectorOperator) -> Dict[str, np.ndarray]:
    """The 18 coefficient arrays of the composed C-grid operator, in numpy
    float64 (the strain definitions substituted into the divergence, each
    metric product evaluated where the staged form evaluates it)."""
    f64 = lambda x: np.asarray(x, dtype=np.float64)  # noqa: E731
    A1 = f64(op.kappa_tension) * f64(op.dy_dxT)
    A2 = f64(op.kappa_tension) * f64(op.dx_dyT)
    B1 = f64(op.kappa_iso) * f64(op.dy_dxBu)
    B2 = f64(op.kappa_iso) * f64(op.dx_dyBu)
    rU, rXU = f64(op.r_dyCu), f64(op.r_dxCu)
    rV, rXV = f64(op.r_dyCv), f64(op.r_dxCv)
    dy2h, dx2h = f64(op.dy2h), f64(op.dx2h)
    dy2q, dx2q = f64(op.dy2q), f64(op.dx2q)
    F = f64(op.recip_area_u) * rU
    G = f64(op.recip_area_u) * rXU
    P = f64(op.recip_area_v) * rV
    Q = f64(op.recip_area_v) * rXV

    t: Dict[str, np.ndarray] = {}
    # ---- u_out <- u ----------------------------------------------------
    t["CU_c"] = (
        -F * dy2h * A1 * rU
        - F * _E(dy2h * A1) * rU
        - G * _S(dx2q * B2) * rXU
        - G * dx2q * B2 * rXU
    )
    t["CU_w"] = F * dy2h * A1 * _W(rU)
    t["CU_e"] = F * _E(dy2h * A1 * rU)
    t["CU_s"] = G * _S(dx2q * B2 * rXU)
    t["CU_n"] = G * dx2q * B2 * _N(rXU)
    # ---- u_out <- v ----------------------------------------------------
    t["DU_c"] = F * dy2h * A2 * rXV - G * dx2q * B1 * rV
    t["DU_s"] = -F * dy2h * A2 * _S(rXV) + G * _S(dx2q * B1 * rV)
    t["DU_e"] = -F * _E(dy2h * A2 * rXV) + G * dx2q * B1 * _E(rV)
    t["DU_se"] = F * _E(dy2h * A2) * _S(_E(rXV)) - G * _S(dx2q * B1 * _E(rV))
    # ---- v_out <- v ----------------------------------------------------
    t["CV_c"] = (
        -P * _W(dy2q * B1) * rV
        - P * dy2q * B1 * rV
        - Q * dx2h * A2 * rXV
        - Q * _N(dx2h * A2) * rXV
    )
    t["CV_w"] = P * _W(dy2q * B1 * rV)
    t["CV_e"] = P * dy2q * B1 * _E(rV)
    t["CV_s"] = Q * dx2h * A2 * _S(rXV)
    t["CV_n"] = Q * _N(dx2h * A2 * rXV)
    # ---- v_out <- u ----------------------------------------------------
    t["DV_c"] = -P * dy2q * B2 * rXU + Q * dx2h * A1 * rU
    t["DV_w"] = P * _W(dy2q * B2 * rXU) - Q * dx2h * A1 * _W(rU)
    t["DV_n"] = P * dy2q * B2 * _N(rXU) - Q * _N(dx2h * A1 * rU)
    t["DV_nw"] = -P * _W(dy2q * B2 * _N(rXU)) + Q * _N(dx2h * A1 * _W(rU))
    return t


def apply_taps(taps, u: torch.Tensor, v: torch.Tensor):
    """The tap contraction with torch rolls, in :data:`CTAPS` order: the
    oracle for the tap form. ``taps`` maps each tap name to a tensor (or
    array) broadcastable against ``u`` and ``v``."""

    def sh(a, dy, dx):
        if dy:
            a = torch.roll(a, -dy, -2)
        if dx:
            a = torch.roll(a, -dx, -1)
        return a

    comps = (u, v)
    outs = [0.0, 0.0]
    for name, oc, ic, dy, dx in CTAPS:
        outs[oc] = outs[oc] + torch.as_tensor(taps[name]) * sh(comps[ic], dy, dx)
    return outs[0], outs[1]
