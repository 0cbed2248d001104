"""The port's host math against the JAX package: bit for bit.

FilterSpec (n_steps, s_max, p, dx_min_sq), the step-count heuristic, the
tuning table and the grid registry of ``gcm_filters_tpu_torch`` must equal
those of ``gcm_filters_tpu`` exactly: both are numpy float64 on the host.
"""
import numpy as np
import pytest

import gcm_filters_tpu.filter_spec as jspec
import gcm_filters_tpu.models.grids as jgrids
import gcm_filters_tpu_torch.filter_spec as tspec
import gcm_filters_tpu_torch.models.grids as tgrids


@pytest.mark.parametrize("shape", ["GAUSSIAN", "TAPER"])
@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("filter_scale, dx_min", [(2.0, 1.0), (5.5, 1.0), (10.0, 1.0), (17.0, 2.5)])
def test_filter_spec_bitwise(shape, ndim, filter_scale, dx_min):
    tw = np.pi if shape == "GAUSSIAN" else 2.3
    nj = jspec.compute_n_steps_default(ndim, jspec.FilterShape[shape], filter_scale, dx_min, tw)
    nt = tspec.compute_n_steps_default(ndim, tspec.FilterShape[shape], filter_scale, dx_min, tw)
    assert nj == nt
    want = jspec.compute_filter_spec(filter_scale, dx_min, jspec.FilterShape[shape], tw, ndim, nj)
    got = tspec.compute_filter_spec(filter_scale, dx_min, tspec.FilterShape[shape], tw, ndim, nt)
    assert got.n_steps == want.n_steps
    assert got.s_max == want.s_max
    assert got.dx_min_sq == want.dx_min_sq
    assert np.asarray(got.p).dtype == np.asarray(want.p).dtype
    assert np.array_equal(np.asarray(got.p), np.asarray(want.p))


def test_filter_spec_rejects_few_steps():
    for mod in (jspec, tspec):
        with pytest.raises(ValueError, match="n_steps must be >= 3"):
            mod.compute_filter_spec(4.0, 1.0, mod.FilterShape.GAUSSIAN, np.pi, 2, 2)


def test_filter_params_and_shapes_equal():
    assert [s.name for s in tspec.FilterShape] == [s.name for s in jspec.FilterShape]
    assert [s.value for s in tspec.FilterShape] == [s.value for s in jspec.FilterShape]
    assert {k.name: v for k, v in tspec.filter_params.items()} == {
        k.name: v for k, v in jspec.filter_params.items()
    }


def test_grid_registry_equal():
    assert [g.name for g in tgrids.GridType] == [g.name for g in jgrids.GridType]
    assert {g.name: v for g, v in tgrids.GRID_VAR_NAMES.items()} == {
        g.name: v for g, v in jgrids.GRID_VAR_NAMES.items()
    }
    assert {g.name for g in tgrids.TRIPOLAR_GRIDS} == {g.name for g in jgrids.TRIPOLAR_GRIDS}
    for g in tgrids.GridType:
        jg = jgrids.GridType[g.name]
        assert tgrids.required_grid_vars(g) == jgrids.required_grid_vars(jg)
        assert tgrids.is_vector_grid(g) == jgrids.is_vector_grid(jg)
        assert tgrids.is_dimensional(g) == jgrids.is_dimensional(jg)
        assert tgrids.is_area_weighted(g) == jgrids.is_area_weighted(jg)
