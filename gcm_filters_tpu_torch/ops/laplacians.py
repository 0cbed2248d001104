"""Builders: grid variables -> stencil operators, with host-side validation.

PyTorch-port counterpart of ``gcm_filters_tpu/ops/laplacians.py``. Each
builder folds the grid-specific discretization into precomputed per-cell
coefficients, once, in numpy float64 on the host, with the same arithmetic,
roll axes, validation order and messages as the JAX package; only the last
step differs: the arrays go to the port as float64 CPU tensors
(:func:`_stencil` for scalar grids, :func:`_vector` for vector grids).
``tests/test_torch_stencil.py`` and ``tests/test_torch_vector.py`` hold the
coefficients bit for bit against the JAX builders.

The flux-form operators (divergence of masked metric-weighted gradients)
expand algebraically into 5-point form::

    div(a * grad f)[j,i] = E*(f_E - f) - W_(f - f_W) + N*(f_N - f) - S*(f - f_S)

with E = a_east-edge/area etc., so center = -(E + W + N + S) and conservation
(sum(area * lap(f)) == 0) holds identically.

Tripolar grids: coefficients are computed on the mirror-extended geometry (a
reversed copy of the top row appended) and trimmed back, so the fold masking
is baked into the top-row coefficients; at apply time only the folded
*field* row needs exchanging (ops.stencil.north_neighbor).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np

from ..interop import stencil_from_numpy, vector_operator_from_numpy
from ..models.grids import GridType, GRID_VAR_NAMES, is_vector_grid
from .stencil import BGridVectorStencil, CGridVectorOperator, ScalarStencil5


def _stencil(*, fold_north=False, zap_nans=False, is_dimensional=False, **fields):
    """The built host arrays as a float64 CPU :class:`ScalarStencil5`."""
    return stencil_from_numpy(
        fields, fold_north=fold_north, zap_nans=zap_nans,
        is_dimensional=is_dimensional, device="cpu", dtype=None,
    )


def _np2(v) -> np.ndarray:
    """Grid variable as a float64 numpy array (host-side precompute)."""
    arr = np.asarray(v, dtype=np.float64)
    return arr


def _roll(a, shift, axis):
    return np.roll(a, shift, axis=axis)


def _mirror_extend(a: np.ndarray) -> np.ndarray:
    """Append the top row reversed in x: (ny, nx) -> (ny+1, nx).

    The tripolar seam exchange (reference kernels.py:33-40): the two halves of
    the northern boundary row face each other across the fold.
    """
    return np.concatenate([a, a[..., -1:, :][..., ::-1]], axis=-2)


def _check_antarctica(wet_mask: np.ndarray) -> None:
    if wet_mask[..., 0, :].any():
        raise AssertionError("Wet mask requires zeros in southernmost row")


def _validate_grid_vars(grid_type: GridType, grid_vars: Dict) -> Dict[str, np.ndarray]:
    expected = GRID_VAR_NAMES[grid_type]
    if set(grid_vars) != set(expected):
        raise ValueError(
            f"Provided `grid_vars` {list(grid_vars)} do not match expected {expected}"
        )
    return {k: _np2(grid_vars[k]) for k in expected}


# ---------------------------------------------------------------------------
# Scalar grids
# ---------------------------------------------------------------------------


def _regular(gv, area=None) -> ScalarStencil5:
    # 5-point unit-coefficient Laplacian, doubly periodic (kernels.py:107-124).
    # NaNs propagate (the reference does not scrub them for this grid).
    return _stencil(
        c=-4.0, n=1.0, s=1.0, e=1.0, w=1.0, area=area, zap_nans=False
    )


def _regular_with_land(gv, area=None) -> ScalarStencil5:
    # Masked 5-point with no-flux boundaries: center coefficient equals the
    # number of wet neighbors, and the field is masked before and after the
    # stencil (kernels.py:150-190).
    wet = gv["wet_mask"]
    wet_fac = (
        _roll(wet, -1, -1) + _roll(wet, 1, -1) + _roll(wet, -1, -2) + _roll(wet, 1, -2)
    )
    return _stencil(
        c=-wet_fac, n=1.0, s=1.0, e=1.0, w=1.0,
        pre=wet, post=wet, area=area, zap_nans=True,
    )


def _irregular_with_land(gv) -> ScalarStencil5:
    # Flux-form div(kappa grad) on a locally orthogonal grid
    # (kernels.py:222-318). Validation contract mirrors the reference.
    kappa_w, kappa_s = gv["kappa_w"], gv["kappa_s"]
    if np.any(kappa_w > 1.0):
        raise ValueError(
            "There are kappa_w values > 1 and this can cause the filter to blow up."
            "Please make sure all kappa_w are <=1."
        )
    if np.any(kappa_s > 1.0):
        raise ValueError(
            "There are kappa_s values > 1 and this can cause the filter to blow up."
            "Please make sure all kappa_s are <=1."
        )
    if not (
        np.any(np.isclose(kappa_w, 1.0, rtol=0, atol=1e-05))
        or np.any(np.isclose(kappa_s, 1.0, rtol=0, atol=1e-05))
    ):
        raise ValueError(
            "At least one place in the domain must have either kappa_w = 1 or kappa_s = 1. "
            "Otherwise the filter's scale will not be equal to filter_scale anywhere in the domain."
        )

    wet = gv["wet_mask"]
    # Edge transmissivities: western edge a_w = wet(i)*wet(i-1)*kappa_w*dyw/dxw,
    # southern edge a_s analogous. Fluxes through land edges vanish.
    a_w = wet * _roll(wet, 1, -1) * kappa_w * gv["dyw"] / gv["dxw"]
    a_s = wet * _roll(wet, 1, -2) * kappa_s * gv["dxs"] / gv["dys"]
    area = gv["area"]
    e = _roll(a_w, -1, -1) / area  # my eastern edge is my east neighbor's western
    w = a_w / area
    n = _roll(a_s, -1, -2) / area
    s = a_s / area
    return _stencil(c=-(e + w + n + s), n=n, s=s, e=e, w=w,
                          zap_nans=True, is_dimensional=True)


def _mom5u(gv) -> ScalarStencil5:
    # MOM5 B-grid velocity-point Laplacian (kernels.py:321-375). The gradient
    # prefactors 2/(dxt_N + dxt_NE) and the edge-averaged metric weights are
    # folded into N/S/E/W coefficients. (The reference's x_wet_mask pairing
    # with the y-difference is preserved verbatim for parity.)
    wet, dxt, dyt, dxu, dyu, area = (
        gv["wet_mask"], gv["dxt"], gv["dyt"], gv["dxu"], gv["dyu"], gv["area_u"]
    )
    x_wet = wet * _roll(wet, -1, -1)
    y_wet = wet * _roll(wet, -1, -2)
    # fx = cfx * (f_N - f): reference divides by dxt(j+1,i) + dxt(j+1,i+1)
    cfx = 2.0 * x_wet / (_roll(dxt, -1, -2) + _roll(_roll(dxt, -1, -2), -1, -1))
    # fy = cfy * (f_E - f): divides by dyt(j,i+1) + dyt(j+1,i+1)
    cfy = 2.0 * y_wet / (_roll(dyt, -1, -1) + _roll(_roll(dyt, -1, -1), -1, -2))
    n = 0.5 * cfx * (dyu + _roll(dyu, -1, -2)) / area
    s = 0.5 * _roll(cfx, 1, -2) * (dyu + _roll(dyu, 1, -2)) / area
    e = 0.5 * cfy * (dxu + _roll(dxu, -1, -1)) / area
    w = 0.5 * _roll(cfy, 1, -1) * (dxu + _roll(dxu, 1, -1)) / area
    return _stencil(c=-(n + s + e + w), n=n, s=s, e=e, w=w,
                          zap_nans=True, is_dimensional=True)


def _mom5t(gv) -> ScalarStencil5:
    # MOM5 B-grid tracer-point Laplacian (kernels.py:378-432).
    wet, dxt, dyt, dxu, dyu, area = (
        gv["wet_mask"], gv["dxt"], gv["dyt"], gv["dxu"], gv["dyu"], gv["area_t"]
    )
    x_wet = wet * _roll(wet, -1, -1)
    y_wet = wet * _roll(wet, -1, -2)
    cfx = 2.0 * x_wet / (dxu + _roll(dxu, 1, -1))
    cfy = 2.0 * y_wet / (dyu + _roll(dyu, 1, -2))
    n = 0.5 * cfx * (dyt + _roll(dyt, -1, -2)) / area
    s = 0.5 * _roll(cfx, 1, -2) * (dyt + _roll(dyt, 1, -2)) / area
    e = 0.5 * cfy * (dxt + _roll(dxt, -1, -1)) / area
    w = 0.5 * _roll(cfy, 1, -1) * (dxt + _roll(dxt, 1, -1)) / area
    return _stencil(c=-(n + s + e + w), n=n, s=s, e=e, w=w,
                          zap_nans=True, is_dimensional=True)


def _tripolar_regular(gv) -> ScalarStencil5:
    # Area-weighted masked 5-point with a tripolar north fold
    # (kernels.py:435-492). The center coefficient (wet-neighbor count) is
    # computed on the mirror-extended mask and trimmed, so the top row counts
    # its fold partner; the apply-time fold is handled by north_neighbor().
    wet = gv["wet_mask"]
    _check_antarctica(wet)
    wet_ext = _mirror_extend(wet)
    wet_fac = (
        _roll(wet_ext, -1, -1)
        + _roll(wet_ext, 1, -1)
        + _roll(wet_ext, -1, -2)
        + _roll(wet_ext, 1, -2)
    )[..., :-1, :]
    return _stencil(
        c=-wet_fac, n=1.0, s=1.0, e=1.0, w=1.0,
        pre=wet, post=wet, area=gv["area"], zap_nans=True, fold_north=True,
    )


def _tripolar_pop(gv) -> ScalarStencil5:
    # POP flux-form tripolar T-point Laplacian (kernels.py:495-588).
    wet = gv["wet_mask"]
    _check_antarctica(wet)

    wet_ext = _mirror_extend(wet)
    dxe, dye = _mirror_extend(gv["dxe"]), _mirror_extend(gv["dye"])
    dxn, dyn = _mirror_extend(gv["dxn"]), _mirror_extend(gv["dyn"])

    e_wet = wet_ext * _roll(wet_ext, -1, -1)
    n_wet = wet_ext * _roll(wet_ext, -1, -2)

    # Fold-consistency contract: the wet northern edge metrics must map onto
    # themselves under the seam reversal (checked on the real top row, which
    # is row -2 of the extended arrays).
    nx = dxn.shape[-1]
    half = nx // 2
    masked_dxn = np.where(n_wet == 1, dxn, 0)[..., -2, :]
    if not np.all(masked_dxn[..., :half][..., ::-1] == masked_dxn[..., half:]):
        raise AssertionError(
            "Northernmost row of dxn does not fold onto itself. This is a "
            "requirement for using a tripole boundary condition."
        )
    masked_dyn = np.where(n_wet == 1, dyn, 0)[..., -2, :]
    if not np.allclose(masked_dyn[..., :half][..., ::-1], masked_dyn[..., half:]):
        raise AssertionError(
            "Northernmost row of dyn does not fold onto itself. This is a "
            "requirement for using a tripole boundary condition."
        )

    # Edge transmissivities on the extended grid, then trim. The southern
    # coefficient of the real bottom row picks up the extended wrap row, which
    # is land (Antarctica) — it vanishes, giving the correct no-flux floor.
    a_e = e_wet / dxe * dye
    a_n = n_wet / dyn * dxn
    tarea = gv["tarea"]
    e = a_e[..., :-1, :] / tarea
    w = _roll(a_e, 1, -1)[..., :-1, :] / tarea
    n = a_n[..., :-1, :] / tarea
    s = _roll(a_n, 1, -2)[..., :-1, :] / tarea
    return _stencil(c=-(e + w + n + s), n=n, s=s, e=e, w=w,
                          zap_nans=True, fold_north=True, is_dimensional=True)


# ---------------------------------------------------------------------------
# Vector grids
# ---------------------------------------------------------------------------


def _vector(**fields):
    """The built host arrays as a float64 CPU vector operator."""
    return vector_operator_from_numpy(fields)


def _safe_recip(a) -> np.ndarray:
    """1/a with zeros mapped to 0 (zero-area cells contribute no flux).
    np.errstate silences the divide-by-zero warning that np.where would
    still emit for the unselected branch."""
    a = np.asarray(a)
    with np.errstate(divide="ignore"):
        return np.where(a > 0, 1.0 / np.where(a > 0, a, 1.0), 0.0)


def _vector_c_grid(gv) -> CGridVectorOperator:
    # Griffies & Hallberg (2000) viscosity operator (kernels.py:591-699),
    # with every metric combination and reciprocal hoisted to build time.
    wet_t, wet_q = gv["wet_mask_t"], gv["wet_mask_q"]
    dxT, dyT = gv["dxT"], gv["dyT"]
    dxCu, dyCu = gv["dxCu"], gv["dyCu"]
    dxCv, dyCv = gv["dxCv"], gv["dyCv"]
    dxBu, dyBu = gv["dxBu"], gv["dyBu"]
    return _vector(
        dy_dxT=dyT / dxT * wet_t,
        dx_dyT=dxT / dyT * wet_t,
        dy_dxBu=dyBu / dxBu * wet_q,
        dx_dyBu=dxBu / dyBu * wet_q,
        dx2h=dxT * dxT,
        dy2h=dyT * dyT,
        dx2q=dxBu * dxBu,
        dy2q=dyBu * dyBu,
        r_dxCu=1.0 / dxCu,
        r_dyCu=1.0 / dyCu,
        r_dxCv=1.0 / dxCv,
        r_dyCv=1.0 / dyCv,
        recip_area_u=_safe_recip(gv["area_u"]),
        recip_area_v=_safe_recip(gv["area_v"]),
        kappa_tension=gv["kappa_iso"] + 0.5 * gv["kappa_aniso"],
        kappa_iso=gv["kappa_iso"],
    )


def _vector_b_grid(gv) -> BGridVectorStencil:
    # POP B-grid friction operator (kernels.py:702-840), every stencil
    # coefficient built once. The roll axes below replicate the reference's
    # exact coefficient construction.
    DXU, DYU = gv["DXU"], gv["DYU"]
    HUS, HUW = gv["HUS"], gv["HUW"]
    HTE, HTN = gv["HTE"], gv["HTN"]
    uarea_r = 1.0 / gv["UAREA"]
    tarea_r = 1.0 / gv["TAREA"]
    dxur, dyur = 1.0 / DXU, 1.0 / DYU

    work = HUS / HTE
    dus = work * uarea_r
    dun = _roll(work, 1, -1) * uarea_r
    work = HUW / HTN
    duw = work * uarea_r
    due = _roll(work, 1, -2) * uarea_r

    kxu = (_roll(HUW, 1, -2) - HUW) * uarea_r
    kyu = (_roll(HUS, 1, -1) - HUS) * uarea_r

    kxt = (HTE - _roll(HTE, -1, -2)) * tarea_r
    work2 = 0.5 * (kxt + _roll(kxt, 1, -1))
    dxkx = (_roll(work2, 1, -2) - work2) * dxur
    work2 = 0.5 * (kxt + _roll(kxt, 1, -2))
    dykx = (_roll(work2, 1, -1) - work2) * dyur

    kyt = (HTN - _roll(HTN, -1, -1)) * tarea_r
    work2 = 0.5 * (kyt + _roll(kyt, 1, -2))
    dyky = (_roll(work2, 1, -1) - work2) * dyur
    work2 = 0.5 * (kyt + _roll(kyt, 1, -1))
    dxky = (_roll(work2, 1, -2) - work2) * dxur

    dum = -(dxkx + dyky + 2.0 * (kxu * kxu + kyu * kyu))
    dmc = dxky - dykx
    dme = 2.0 * kyu / (HTN + _roll(HTN, 1, -2))
    dmn = -2.0 * kxu / (HTE + _roll(HTE, 1, -1))
    duc = -(dun + dus + due + duw)

    return _vector(
        cc=duc + dum,
        dun=dun, dus=dus, due=due, duw=duw,
        dmc=dmc, dmn=dmn, dms=-dmn, dme=dme, dmw=-dme,
    )


_SCALAR_BUILDERS = {
    GridType.REGULAR: lambda gv: _regular(gv),
    GridType.REGULAR_AREA_WEIGHTED: lambda gv: _regular(gv, area=gv["area"]),
    GridType.REGULAR_WITH_LAND: lambda gv: _regular_with_land(gv),
    GridType.REGULAR_WITH_LAND_AREA_WEIGHTED: lambda gv: _regular_with_land(
        gv, area=gv["area"]
    ),
    GridType.IRREGULAR_WITH_LAND: _irregular_with_land,
    GridType.MOM5U: _mom5u,
    GridType.MOM5T: _mom5t,
    GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED: _tripolar_regular,
    GridType.TRIPOLAR_POP_WITH_LAND: _tripolar_pop,
}


def build_scalar_stencil(grid_type: GridType, grid_vars: Dict) -> ScalarStencil5:
    """Build the scalar 5-point stencil for ``grid_type`` from its grid vars."""
    if grid_type not in _SCALAR_BUILDERS:
        raise ValueError(f"{grid_type} is not a scalar grid type")
    gv = _validate_grid_vars(grid_type, grid_vars)
    return _SCALAR_BUILDERS[grid_type](gv)


_VECTOR_BUILDERS = {
    GridType.VECTOR_C_GRID: _vector_c_grid,
    GridType.VECTOR_B_GRID: _vector_b_grid,
}

Operator = Union[ScalarStencil5, BGridVectorStencil, CGridVectorOperator]


def build_vector_operator(grid_type: GridType, grid_vars: Dict) -> Operator:
    """Build the vector (viscosity) operator for ``grid_type``."""
    if grid_type not in _VECTOR_BUILDERS:
        raise ValueError(f"{grid_type} is not a vector grid type")
    gv = _validate_grid_vars(grid_type, grid_vars)
    return _VECTOR_BUILDERS[grid_type](gv)


def build_operator(grid_type: GridType, grid_vars: Dict) -> Operator:
    """Build the Laplacian operator (scalar or vector) for ``grid_type``."""
    if is_vector_grid(grid_type):
        return build_vector_operator(grid_type, grid_vars)
    return build_scalar_stencil(grid_type, grid_vars)
