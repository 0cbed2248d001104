"""Physics and property tests of the port's stencil operators.

The counterpart of tests/test_kernels_properties.py, case for case (the same
fixtures, seeds and parametrisations), against the port's
``ops.build_operator``: conservation, required-vars introspection,
dimensionality flags, kappa validation, directional flux isotropy via
delta-function probes with outlier metrics, tripolar seam symmetry,
Antarctica and fold validation, solid-body-rotation invariance, zero-area
robustness, NaN on land and the C-grid tap expansion. These hold the port to
the physics directly, whatever the JAX package computes. The fixtures give
the JAX package's grid types; the port's are looked up by name.
"""
import copy

import numpy as np
import pytest
import torch

from gcm_filters_tpu_torch import GridType, required_grid_vars
from gcm_filters_tpu_torch.models.grids import is_area_weighted, is_dimensional
from gcm_filters_tpu_torch.ops import build_operator

from conftest import make_scalar_grid_data


def _port(grid_type) -> GridType:
    return GridType[grid_type.name]


def _jax_grid(name):
    from gcm_filters_tpu import GridType as JaxGridType

    return JaxGridType[name]


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def test_conservation(scalar_grid_data_with_mom5):
    """Scalar Laplacians preserve the area integral."""
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    grid_type = _port(grid_type)
    op = build_operator(grid_type, grid_vars)
    if is_area_weighted(grid_type):
        area = 1  # acts on the transformed unit-spacing grid
    else:
        area = grid_vars.get("area", grid_vars.get("tarea", grid_vars.get(
            "area_u", grid_vars.get("area_t", 1))))
    res = op.laplacian(_t(data)).numpy()
    np.testing.assert_allclose((area * res).sum(), 0.0, atol=1e-10)


def test_required_grid_vars(scalar_grid_data_with_mom5):
    grid_type, _, grid_vars = scalar_grid_data_with_mom5
    assert set(required_grid_vars(_port(grid_type))) == set(grid_vars)


def test_dimensionality_scalar(scalar_grid_data_with_mom5):
    grid_type, _, grid_vars = scalar_grid_data_with_mom5
    grid_type = _port(grid_type)
    op = build_operator(grid_type, grid_vars)
    expected = {
        GridType.REGULAR: False,
        GridType.REGULAR_AREA_WEIGHTED: False,
        GridType.REGULAR_WITH_LAND: False,
        GridType.REGULAR_WITH_LAND_AREA_WEIGHTED: False,
        GridType.IRREGULAR_WITH_LAND: True,
        GridType.MOM5U: True,
        GridType.MOM5T: True,
        GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED: False,
        GridType.TRIPOLAR_POP_WITH_LAND: True,
    }[grid_type]
    assert op.is_dimensional == expected
    assert is_dimensional(grid_type) == expected


def test_for_large_kappas():
    _, _, grid_vars = make_scalar_grid_data(_jax_grid("IRREGULAR_WITH_LAND"))
    bad = copy.deepcopy(grid_vars)
    bad["kappa_w"][99, 225] = 2.0
    with pytest.raises(ValueError, match=r"There are kappa_.*"):
        build_operator(GridType.IRREGULAR_WITH_LAND, bad)
    bad["kappa_w"][99, 225] = 1.0
    bad["kappa_s"][99, 225] = 2.0
    with pytest.raises(ValueError, match=r"There are kappa_.*"):
        build_operator(GridType.IRREGULAR_WITH_LAND, bad)


def test_for_kappas_not_equal_to_one():
    _, _, grid_vars = make_scalar_grid_data(_jax_grid("IRREGULAR_WITH_LAND"))
    bad = copy.deepcopy(grid_vars)
    bad["kappa_w"][:, :] = 0.5
    bad["kappa_s"][:, :] = 0.5
    with pytest.raises(ValueError, match=r"At least one place*"):
        build_operator(GridType.IRREGULAR_WITH_LAND, bad)


@pytest.mark.parametrize("direction", ["X", "Y"])
def test_flux(irregular_scalar_grid_data, direction):
    """Delta-function probe with outlier metrics: catches roll-direction sign
    errors (diffusion must stay isotropic when the outliers sit just out of
    reach of a correctly-oriented stencil)."""
    grid_type, data, grid_vars = irregular_scalar_grid_data
    grid_type = _port(grid_type)

    delta = np.zeros_like(data)
    yloc, xloc = 99, 225
    delta[yloc, xloc] = 1

    test_vars = {name: (v if name == "wet_mask" else np.ones_like(data))
                 for name, v in grid_vars.items()}
    replace_data = {
        GridType.IRREGULAR_WITH_LAND: {
            "Y": ("dxs", (yloc - 1, slice(None)), (yloc + 2, slice(None))),
            "X": ("dyw", (slice(None), xloc - 1), (slice(None), xloc + 2)),
        },
        GridType.TRIPOLAR_POP_WITH_LAND: {
            "Y": ("dxn", (yloc - 2, slice(None)), (yloc + 1, slice(None))),
            "X": ("dye", (slice(None), xloc - 2), (slice(None), xloc + 1)),
        },
    }
    var_to_modify, left, right = replace_data[grid_type][direction]
    outlier = np.ones_like(data)
    outlier[left] = 1000
    outlier[right] = 2000
    test_vars[var_to_modify] = outlier

    diffused = build_operator(grid_type, test_vars).laplacian(_t(delta)).numpy()
    np.testing.assert_allclose(diffused[yloc - 1, xloc], diffused[yloc + 1, xloc], atol=1e-12)
    np.testing.assert_allclose(diffused[yloc, xloc - 1], diffused[yloc, xloc + 1], atol=1e-12)


def test_for_antarctica(tripolar_grid_data):
    grid_type, _, grid_vars = tripolar_grid_data
    bad = copy.deepcopy(grid_vars)
    bad["wet_mask"][0, 10] = 1
    with pytest.raises(AssertionError, match=r"Wet mask requires .*"):
        build_operator(_port(grid_type), bad)


def test_folding_of_northern_gridedge_data(tripolar_grid_data):
    grid_type, _, grid_vars = tripolar_grid_data
    grid_type = _port(grid_type)
    if grid_type != GridType.TRIPOLAR_POP_WITH_LAND:
        pytest.skip("fold metric validation is POP-specific")
    bad = copy.deepcopy(grid_vars)
    bad["dxn"][-1, 3] = 10
    with pytest.raises(AssertionError, match=r"Northernmost row of dxn .*"):
        build_operator(grid_type, bad)
    bad["dxn"][-1, 3] = 1
    bad["dyn"][-1, 3] = 10
    with pytest.raises(AssertionError, match=r"Northernmost row of dyn .*"):
        build_operator(grid_type, bad)


def test_tripolar_exchanges(tripolar_grid_data):
    """A spike on the northern row must diffuse symmetrically across the fold."""
    grid_type, data, grid_vars = tripolar_grid_data
    op = build_operator(_port(grid_type), grid_vars)
    delta = np.zeros_like(data)
    nx = delta.shape[1]
    loc = 10
    delta[-1, loc] = 1
    diffused = op.laplacian(_t(delta)).numpy()
    np.testing.assert_allclose(diffused[-2, loc], diffused[-1, nx - loc - 1], atol=1e-12)


def test_conservation_under_solid_body_rotation(vector_grid_data, spherical_geometry):
    """u = cos(lat), v = 0 (solid-body rotation) lies in the vector
    Laplacians' null space."""
    grid_type, _, grid_vars = vector_grid_data
    _, geolat_u, _, _ = spherical_geometry
    data_u = np.cos(geolat_u / 360 * 2 * np.pi)
    data_v = np.zeros_like(data_u)
    op = build_operator(_port(grid_type), grid_vars)
    res_u, res_v = (a.numpy() for a in op.laplacian(_t(data_u), _t(data_v)))
    np.testing.assert_allclose(res_u, 0.0, atol=1e-12)
    np.testing.assert_allclose(res_v, 0.0, atol=1e-12)


def test_zero_area(vector_grid_data):
    grid_type, (data_u, data_v), grid_vars = vector_grid_data
    grid_type = _port(grid_type)
    op = build_operator(grid_type, grid_vars)
    res_u, res_v = (a.numpy() for a in op.laplacian(_t(data_u), _t(data_v)))
    for res in (res_u, res_v):
        assert not np.any(np.isinf(res))
        assert not np.any(np.isnan(res))

    # the C-grid guards division by zero cell areas explicitly; feed actual
    # zeros to exercise it
    if grid_type == GridType.VECTOR_C_GRID:
        gv = {k: np.array(v, dtype=float) for k, v in grid_vars.items()}
        gv["area_u"][10:12, 20:22] = 0.0
        gv["area_v"][30:32, 40:42] = 0.0
        op0 = build_operator(grid_type, gv)
        res_u, res_v = (a.numpy() for a in op0.laplacian(_t(data_u), _t(data_v)))
        for res in (res_u, res_v):
            assert not np.any(np.isinf(res))
            assert not np.any(np.isnan(res))


def test_required_vector_grid_vars(vector_grid_data):
    grid_type, _, grid_vars = vector_grid_data
    assert set(required_grid_vars(_port(grid_type))) == set(grid_vars)


def test_dimensionality_vector(vector_grid_data):
    grid_type, _, grid_vars = vector_grid_data
    op = build_operator(_port(grid_type), grid_vars)
    assert op.is_dimensional is True


def test_nan_propagation_on_land(scalar_grid_data):
    """Masked operators scrub NaNs on land; wet outputs stay finite."""
    grid_type, data, grid_vars = scalar_grid_data
    wet = grid_vars.get("wet_mask")
    if wet is None:
        pytest.skip("no land mask on this grid")
    op = build_operator(_port(grid_type), grid_vars)
    data_nan = data.copy()
    data_nan[wet == 0] = np.nan
    out = op.laplacian(_t(data_nan)).numpy()
    assert np.isfinite(out[wet == 1]).all()


def test_cgrid_tap_expansion_exact(vector_grid_data):
    """The tap expansion of the C-grid operator (ops/ctaps.py) must equal the
    staged strain/divergence form to roundoff, including on random metrics."""
    from gcm_filters_tpu_torch.ops.ctaps import apply_taps, cgrid_tap_arrays

    grid_type, (u, v), grid_vars = vector_grid_data
    grid_type = _port(grid_type)
    if grid_type != GridType.VECTOR_C_GRID:
        pytest.skip("tap expansion is C-grid specific")
    op = build_operator(grid_type, grid_vars)
    lu, lv = op.laplacian(_t(u), _t(v))
    tu, tv = apply_taps(cgrid_tap_arrays(op), _t(u), _t(v))
    scale = max(float(lu.abs().max()), float(lv.abs().max()))
    assert float((tu - lu).abs().max()) / scale < 1e-13
    assert float((tv - lv).abs().max()) / scale < 1e-13
