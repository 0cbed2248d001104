"""The port's stencil builders against the JAX package's.

Coefficients of all 9 scalar grids must equal the JAX builders' bit for bit
in float64; every validation error must have the same type and message; the
port's Laplacian must reproduce the ``laplacian_*.npz`` goldens. The vector
grids validate like the JAX package's and build (their coefficients are held
against the JAX builders in test_torch_vector.py).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
from gcm_filters_tpu.ops.laplacians import build_operator as jbuild
from gcm_filters_tpu.ops.stencil import hspace_drop_pre as j_drop_pre
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.laplacians import build_operator as tbuild
from gcm_filters_tpu_torch.ops.stencil import hspace_drop_pre as t_drop_pre

from conftest import make_mask_data, make_scalar_grid_data

DATA_DIR = pathlib.Path(__file__).parent / "test_data_golden"
FIELDS = ("c", "n", "s", "e", "w", "pre", "post", "area")
FLAGS = ("fold_north", "zap_nans", "is_dimensional")


def _tgrid(grid_type):
    return gt.GridType[grid_type.name]


def test_coefficients_bitwise(scalar_grid_data_with_mom5):
    grid_type, _, grid_vars = scalar_grid_data_with_mom5
    js = jbuild(grid_type, grid_vars)
    ts = tbuild(_tgrid(grid_type), grid_vars)
    for k in FLAGS:
        assert getattr(ts, k) == getattr(js, k), k
    for k in FIELDS:
        a, b = getattr(js, k), getattr(ts, k)
        if a is None or isinstance(a, float):
            assert b == a, k
            continue
        assert isinstance(b, torch.Tensor) and b.dtype == torch.float64, k
        assert np.array_equal(np.asarray(a), b.numpy()), k
    assert t_drop_pre(ts) == j_drop_pre(js)
    if js.pre is not None and js.pre is js.post:
        assert ts.pre is ts.post  # one mask tensor, cast and moved once


def test_laplacian_matches_jax(scalar_grid_data_with_mom5):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    want = np.asarray(jbuild(grid_type, grid_vars).laplacian(jnp.asarray(data)))
    got = tbuild(_tgrid(grid_type), grid_vars).laplacian(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_golden_laplacian(scalar_grid_data_with_mom5):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    path = DATA_DIR / f"laplacian_{grid_type.name}.npz"
    if not path.exists():
        pytest.skip(f"golden snapshot {path.name} is missing")
    out = tbuild(_tgrid(grid_type), grid_vars).laplacian(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(np.float32(out), np.load(path)["lap"], rtol=1e-5, atol=1e-6)


def _same_error(grid_type, grid_vars):
    with pytest.raises(Exception) as jerr:
        jbuild(grid_type, grid_vars)
    with pytest.raises(Exception) as terr:
        tbuild(_tgrid(grid_type), grid_vars)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)
    return terr.value


def _irregular():
    grid_type, _, gv = make_scalar_grid_data(gj.GridType.IRREGULAR_WITH_LAND, shape=(16, 32))
    return grid_type, gv


def test_error_grid_vars_mismatch(scalar_grid_data_with_mom5):
    grid_type, _, grid_vars = scalar_grid_data_with_mom5
    for name in list(grid_vars):
        missing = {k: v for k, v in grid_vars.items() if k != name}
        assert isinstance(_same_error(grid_type, missing), ValueError)
    extra = dict(grid_vars, bogus=np.ones((2, 2)))
    assert isinstance(_same_error(grid_type, extra), ValueError)


@pytest.mark.parametrize("which", ["kappa_w", "kappa_s"])
def test_error_kappa_above_one(which):
    grid_type, gv = _irregular()
    gv[which] = gv[which].copy()
    gv[which][3, 4] = 1.5
    err = _same_error(grid_type, gv)
    assert isinstance(err, ValueError) and which in str(err)


def test_error_no_kappa_equal_one():
    grid_type, gv = _irregular()
    gv["kappa_w"] = 0.5 * np.ones_like(gv["kappa_w"])
    gv["kappa_s"] = 0.5 * np.ones_like(gv["kappa_s"])
    assert isinstance(_same_error(grid_type, gv), ValueError)


def test_error_wet_antarctica(tripolar_grid_data):
    grid_type, _, grid_vars = tripolar_grid_data
    gv = dict(grid_vars)
    gv["wet_mask"] = gv["wet_mask"].copy()
    gv["wet_mask"][0, 3] = 1
    assert isinstance(_same_error(grid_type, gv), AssertionError)


@pytest.mark.parametrize("which", ["dxn", "dyn"])
def test_error_fold_does_not_close(which):
    grid_type, _, gv = make_scalar_grid_data(gj.GridType.TRIPOLAR_POP_WITH_LAND, shape=(16, 32))
    gv[which] = gv[which].copy()
    gv[which][-1, 1] *= 1.5
    err = _same_error(grid_type, gv)
    assert isinstance(err, AssertionError) and which in str(err)


def test_vector_grid_validated_then_built(vector_grid_data):
    grid_type, _, grid_vars = vector_grid_data
    missing = dict(list(grid_vars.items())[1:])
    assert isinstance(_same_error(grid_type, missing), ValueError)
    op = tbuild(_tgrid(grid_type), grid_vars)
    assert type(op).__name__ == type(jbuild(grid_type, grid_vars)).__name__
    assert op.is_dimensional and op.zap_nans and not op.fold_north


def test_hspace_drop_pre_compares_values():
    wet = make_mask_data((8, 16))
    st = tbuild(gt.GridType.REGULAR_WITH_LAND, {"wet_mask": wet})
    assert t_drop_pre(st)
    copy = dataclasses.replace(st, pre=st.pre.clone())
    assert copy.pre is not copy.post and t_drop_pre(copy)
    other = copy.pre.clone()
    other[3, 3] = 1 - other[3, 3]
    assert not t_drop_pre(dataclasses.replace(st, pre=other))
    assert not t_drop_pre(dataclasses.replace(st, zap_nans=False))
    half = dataclasses.replace(st, pre=0.5 * st.pre, post=0.5 * st.post)
    assert not t_drop_pre(half)


def test_stencil_to_keeps_shared_masks():
    wet = make_mask_data((8, 16))
    st = tbuild(gt.GridType.REGULAR_WITH_LAND_AREA_WEIGHTED,
                {"wet_mask": wet, "area": np.ones((8, 16))})
    st32 = st.to(torch.float32, "cpu")
    assert st32.pre is st32.post and st32.pre.dtype == torch.float32
    assert st32.area.dtype == torch.float32 and st32.n == 1.0
    assert st.pre.dtype == torch.float64  # the original is left as it was
