"""The port's kernel dispatch on the CPU against the JAX Pallas path.

On the CPU, ``make_cuda_scalar_apply`` chains ``cheb_pass_reference``, the
plain PyTorch version of the CUDA step kernel. It must match
``gcm_filters_tpu.ops.pallas.make_pallas_scalar_apply``, which runs its
Pallas kernel in interpret mode on the CPU (as tests/test_pallas.py runs it),
at the test_pallas tolerances: f64 rtol 1e-11 / atol 1e-13, f32 rtol 2e-5 /
atol 2e-6. Both use the h-space mask elimination, so NaN semantics must agree
too. The CUDA kernel itself is checked against the same plain version on the
card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcm_filters_tpu import Filter as JFilter, GridType
from gcm_filters_tpu.engine import scalar_filter_apply as jengine
from gcm_filters_tpu.ops.pallas import make_pallas_scalar_apply
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import scalar_filter_apply as tengine
from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply

TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}


def _pair(grid_type, grid_vars, exact_nan=False, **kw):
    jf = JFilter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", exact_nan=exact_nan, **kw)
    return jf, tf


def _run_both(jf, tf, x, exact_nan=False):
    want = np.asarray(make_pallas_scalar_apply(jf.operator, jf.filter_spec,
                                               exact_nan=exact_nan)(jnp.asarray(x)))
    got = make_cuda_scalar_apply(tf.operator, tf.filter_spec, exact_nan=exact_nan)(
        torch.as_tensor(x)).numpy()
    return got, want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dispatch_matches_pallas(scalar_grid_data_with_mom5, dtype):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    jf, tf = _pair(grid_type, grid_vars, filter_scale=6.0, dx_min=1.0)
    got, want = _run_both(jf, tf, data.astype(dtype))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_tripolar_seam_spike():
    ny, nx = 64, 128
    wet = np.ones((ny, nx)); wet[0] = 0
    jf, tf = _pair(GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                   {"area": np.ones((ny, nx)), "wet_mask": wet},
                   filter_scale=4.0, dx_min=1.0)
    delta = np.zeros((ny, nx)); delta[-1, 10] = 1.0
    got, want = _run_both(jf, tf, delta)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(got[-2, 10], got[-1, nx - 10 - 1], atol=1e-12)


def test_wet_cell_nan_semantics():
    """h-space semantics: a wet NaN stays NaN, land NaNs stay NaN, and the
    port agrees with the Pallas path everywhere else, including the NaN
    cell's neighbourhood where both differ from the eager engine."""
    ny, nx = 32, 128
    wet = np.ones((ny, nx)); wet[0] = 0
    jf, tf = _pair(GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                   {"area": np.ones((ny, nx)), "wet_mask": wet},
                   filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(9).random((ny, nx))
    data[10, 20] = np.nan  # wet
    data[0, 3] = np.nan    # land
    got, want = _run_both(jf, tf, data)
    assert (np.isnan(got) == np.isnan(want)).all()
    assert np.isnan(got[10, 20]) and np.isnan(got[0, 3])
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-11, atol=1e-13)


def test_nan_propagation_irregular():
    ny, nx = 32, 128
    m = np.ones((ny, nx))
    gv = dict(wet_mask=m.copy(), dxw=m, dyw=m, dxs=m, dys=m, area=m, kappa_w=m, kappa_s=m)
    gv["wet_mask"][:2] = 0
    jf, tf = _pair(GridType.IRREGULAR_WITH_LAND, gv, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(5).random((ny, nx))
    data[10, 20] = np.nan
    got, want = _run_both(jf, tf, data)
    assert (np.isnan(got) == np.isnan(want)).all() and np.isnan(got[10, 20])
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("grid_name", ["TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED",
                                       "REGULAR_WITH_LAND"])
def test_exact_nan(grid_name):
    """exact_nan keeps the per-step scrub: equal to the Pallas exact_nan path
    and to the eager engines, wet NaN included."""
    ny, nx = 32, 128
    wet = np.ones((ny, nx)); wet[0] = 0; wet[5:9, 30:40] = 0
    gv = {"wet_mask": wet}
    if "AREA" in grid_name:
        gv["area"] = 0.9 + 0.2 * np.random.default_rng(1).random((ny, nx))
    jf, tf = _pair(GridType[grid_name], gv, exact_nan=True, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(7).random((ny, nx))
    data[12, 50] = np.nan  # wet
    data[6, 33] = np.nan   # land
    got, want = _run_both(jf, tf, data, exact_nan=True)
    eager = tengine(tf.operator, tf.filter_spec, torch.as_tensor(data)).numpy()
    jeager = np.asarray(jengine(jf.operator, jf.filter_spec, jnp.asarray(data)))
    for ref in (want, eager, jeager):
        assert (np.isnan(got) == np.isnan(ref)).all()
        ok = ~np.isnan(ref)
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-11, atol=1e-13)


def test_batched_and_odd_shape_fold():
    ny, nx = 37, 50
    wet = np.ones((ny, nx)); wet[0] = 0
    area = 0.9 + 0.2 * np.random.default_rng(4).random((ny, nx))
    jf, tf = _pair(GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                   {"area": area, "wet_mask": wet}, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(3).random((2, 3, ny, nx))
    want = np.asarray(jengine(jf.operator, jf.filter_spec, jnp.asarray(data)))
    got = make_cuda_scalar_apply(tf.operator, tf.filter_spec)(torch.as_tensor(data)).numpy()
    assert got.shape == data.shape
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)


def test_launch_sequence_and_counter():
    """n_steps steps per apply: FIRST, MIDDLE..., LAST. The CPU route runs
    the plain version and does not count kernel launches."""
    wet = np.ones((16, 32)); wet[0] = 0
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType.REGULAR_WITH_LAND,
                   grid_vars={"wet_mask": wet}, device="cpu")
    kinds = []

    def spy(ops, kind, *a, **k):
        kinds.append(kind)
        return cp.cheb_pass(ops, kind, *a, **k)

    before = cp.cheb_pass.launches
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec, pass_fn=spy)
    out = fn(torch.as_tensor(np.random.default_rng(0).random((16, 32))))
    assert kinds == [cp.FIRST] + [cp.MIDDLE] * (tf.n_steps - 2) + [cp.LAST]
    assert cp.cheb_pass.launches == before
    ops, p = fn.operands(torch.float64, torch.device("cpu"))
    assert ops.drop_pre and ops.stencil.pre is None and not ops.stencil.zap_nans
    assert len(p) == tf.n_steps + 1 and out.shape == (16, 32)


def test_operands_prescaled():
    """Coefficients arrive pre-scaled by -2*lap_scale in the compute dtype:
    arrays cast first then scaled, constants scaled in float64 then rounded,
    as the JAX kernel's host side does (cheb_pass.host_ext_inputs)."""
    wet = np.ones((16, 32)); wet[0] = 0
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType.REGULAR_WITH_LAND,
                   grid_vars={"wet_mask": wet}, device="cpu")
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec)
    neg2s = -2.0 * 2.0 / (tf.filter_spec.s_max * tf.filter_spec.dx_min_sq)
    ops, _ = fn.operands(torch.float32, torch.device("cpu"))
    st = ops.stencil
    want_c = np.asarray(tf.operator.c.numpy(), np.float32) * np.float32(neg2s)
    assert np.array_equal(st.c.numpy(), want_c)
    assert st.n == float(np.float32(neg2s * 1.0))
    assert st.post.dtype == torch.float32 and np.array_equal(st.post.numpy(), wet)
    assert ops.land_gain == float(np.float32(np.polynomial.chebyshev.chebval(-1.0, tf.filter_spec.p)))


def test_wrapper_refuses_other_devices():
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    ops, p = make_cuda_scalar_apply(tf.operator, tf.filter_spec).operands(
        torch.float32, torch.device("cpu"))
    meta = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        cp.cheb_pass(ops, cp.MIDDLE, p[2], t=meta, t_prev=meta, t_next=meta, acc=meta)


def test_dispatch_rejects_bad_inputs():
    wet = np.ones((16, 32)); wet[0] = 0
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.REGULAR_WITH_LAND,
                   grid_vars={"wet_mask": wet}, device="cpu")
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec)
    with pytest.raises(ValueError, match="spatial shape"):
        fn(torch.zeros(16, 30))
    with pytest.raises(ValueError, match="two spatial dims"):
        fn(torch.zeros(32))
    empty = fn(torch.zeros((0, 16, 32), dtype=torch.int32))
    assert empty.shape == (0, 16, 32) and empty.dtype == torch.float32
    spec = tf.filter_spec._replace(n_steps=1, p=tf.filter_spec.p[:2])
    with pytest.raises(ValueError, match="n_steps >= 2"):
        make_cuda_scalar_apply(tf.operator, spec)
