"""The port's vector dispatch and step on the CPU against the JAX Pallas path.

On the CPU, ``make_cuda_vector_apply`` chains ``vec_pass_reference``, the
plain PyTorch version of the CUDA step kernels in ``csrc/vec_pass.cu`` (the
B-grid pair and the C-grid taps). It must match
``gcm_filters_tpu.ops.pallas.make_pallas_vector_apply``, which runs the
coupled Pallas kernels in interpret mode on the CPU, at the tolerances of
tests/test_pallas.py: f64 rtol 1e-11 / atol 1e-13, f32 rtol 2e-5 / atol 2e-6.
Inputs use unit-scale metrics (0.9 + 0.2 * uniform), where float32 is a real
test: the spherical fixtures' Laplacian term is ~1e-13 of the field. The CUDA
kernels themselves are checked against the same plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
from gcm_filters_tpu.engine import vector_filter_apply as jengine
from gcm_filters_tpu.ops.pallas import make_pallas_vector_apply
from gcm_filters_tpu.utils.telemetry import fallback_counts, reset_fallback_counts
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.ctaps import CTAP_NAMES, cgrid_tap_arrays
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, LAST, MIDDLE
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_vector_apply
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.stencil import BGRID_FIELDS

TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}
B, C = gj.GridType.VECTOR_B_GRID, gj.GridType.VECTOR_C_GRID


def unit_grid_vars(grid_type, shape, kappa_aniso=1.0, seed=42):
    """Unit-scale metrics, m = 0.9 + 0.2 * uniform from one numpy seed, as
    benchmarks/bench_suite.py builds the vector grids; ``kappa_aniso`` scales
    the C-grid's anisotropic viscosity (1 amplifies: kappa_tension = 1.5
    lifts the operator's spectrum above s_max)."""
    rng = np.random.default_rng(seed)
    m = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid_type.name == "VECTOR_B_GRID":
        return dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=m, dyT=m, dxCu=m, dyCu=m,
                dxCv=m, dyCv=m, dxBu=m, dyBu=m, area_u=m * m, area_v=m * m,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


def fields(shape, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random(shape), rng.random(shape)


def _pair(grid_type, grid_vars, **kw):
    jf = gj.Filter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", **kw)
    return jf, tf


def _run_both(jf, tf, u, v):
    """The port's dispatch and the JAX Pallas path on the same inputs; fails
    unless the Pallas kernels really ran (no silent drop to the XLA engine)."""
    reset_fallback_counts()
    pallas = make_pallas_vector_apply(jf.operator, jf.filter_spec)
    ju, jv = pallas(jnp.asarray(u), jnp.asarray(v))
    built = pallas.shape_cache.get(u.shape[-2:] + (str(ju.dtype),))
    assert built is not None and built != "xla", "the JAX side did not run its Pallas kernels"
    assert fallback_counts() == {}
    tu, tv = make_cuda_vector_apply(tf.operator, tf.filter_spec)(
        torch.as_tensor(u), torch.as_tensor(v))
    return (tu.numpy(), tv.numpy()), (np.asarray(ju), np.asarray(jv))


@pytest.mark.parametrize("grid_type, dtype, kappa_aniso", [
    (B, np.float64, 1.0),
    (B, np.float32, 1.0),
    (C, np.float64, 1.0),
    (C, np.float64, 0.0),
    (C, np.float32, 0.0),
])
def test_dispatch_matches_pallas(grid_type, dtype, kappa_aniso):
    shape = (64, 128)
    jf, tf = _pair(grid_type, unit_grid_vars(grid_type, shape, kappa_aniso),
                   filter_scale=6.0, dx_min=1.0)
    u, v = (a.astype(dtype) for a in fields(shape))
    got, want = _run_both(jf, tf, u, v)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        np.testing.assert_allclose(g, w, **TOL[dtype])
    err = max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want))
    scale = max(float(np.abs(w).max()) for w in want)
    print(f"{grid_type.name} {np.dtype(dtype).name} kappa_aniso={kappa_aniso:g}: "
          f"max abs {err:.2e} on values up to {scale:.3g}")


@pytest.mark.parametrize("grid_type", [B, C])
def test_nan_parity(grid_type):
    """NaNs scrub only the contraction's input: a NaN cell stays NaN, its
    neighbours see zero, and the port agrees with the Pallas path and the
    JAX engine everywhere else."""
    shape = (64, 128)
    jf, tf = _pair(grid_type, unit_grid_vars(grid_type, shape, kappa_aniso=0.0),
                   filter_scale=6.0, dx_min=1.0)
    u, v = fields(shape, seed=3)
    u[10, 20] = np.nan
    v[50, 7] = np.nan
    got, want = _run_both(jf, tf, u, v)
    eager = [np.asarray(a) for a in jengine(jf.operator, jf.filter_spec, jnp.asarray(u),
                                             jnp.asarray(v))]
    assert np.isnan(got[0][10, 20]) and np.isnan(got[1][50, 7])
    for g, w, e in zip(got, want, eager):
        for ref in (w, e):
            assert (np.isnan(g) == np.isnan(ref)).all()
            ok = ~np.isnan(ref)
            np.testing.assert_allclose(g[ok], ref[ok], rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("grid_type", [B, C])
def test_first_step_is_shifted_operator(grid_type):
    """The plain FIRST step's T1 equals -w - lap_scale * L(w), with L the
    operator's own (staged, for the C-grid) Laplacian: checks the pre-scaling,
    the mixing swap and the diagonal taps of the kernel's coefficient order."""
    shape = (24, 40)
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape), device="cpu")
    u, v = (torch.as_tensor(a) for a in fields(shape, seed=11))
    ops, p = make_cuda_vector_apply(tf.operator, tf.filter_spec).operands(
        torch.float64, torch.device("cpu"))
    w = torch.stack([u, v]).unsqueeze(0)
    t1, acc = torch.empty_like(w), torch.empty_like(w)
    vp.vec_pass_reference(ops, FIRST, p[0], p[1], w=w, t_next=t1, acc=acc)
    s = _laplacian_scale(tf.filter_spec, True)
    lu, lv = tf.operator.laplacian(u, v)
    want = torch.stack([-u - s * lu, -v - s * lv])
    torch.testing.assert_close(t1[0], want, rtol=1e-12, atol=1e-14)
    torch.testing.assert_close(acc[0], p[0] * w[0] + p[1] * want, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("grid_type", [B, C])
def test_middle_step_in_place(grid_type):
    """MIDDLE may write t_next over t_prev: same result as a separate buffer."""
    shape = (16, 24)
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape), device="cpu")
    ops, p = make_cuda_vector_apply(tf.operator, tf.filter_spec).operands(
        torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(5)
    t, t_prev, acc = (torch.as_tensor(rng.random((2, 2) + shape)) for _ in range(3))
    out, acc2 = torch.empty_like(t), acc.clone()
    vp.vec_pass_reference(ops, MIDDLE, p[2], t=t, t_prev=t_prev, t_next=out, acc=acc2)
    alias, acc3 = t_prev.clone(), acc.clone()
    vp.vec_pass_reference(ops, MIDDLE, p[2], t=t, t_prev=alias, t_next=alias, acc=acc3)
    assert torch.equal(alias, out) and torch.equal(acc2, acc3)
    acc4 = acc.clone()
    vp.vec_pass_reference(ops, LAST, p[2], t=t, t_prev=t_prev, acc=acc4)
    assert torch.equal(acc4, acc2)


@pytest.mark.parametrize("grid_type", [B, C])
def test_launch_sequence_and_counter(grid_type):
    """n_steps steps per apply: FIRST, MIDDLE..., LAST. The CPU route runs
    the plain version and counts no kernel launch; the caller's arrays are
    never written."""
    shape = (16, 32)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape), device="cpu")
    kinds = []

    def spy(ops, kind, *a, **k):
        kinds.append(kind)
        return vp.vec_pass(ops, kind, *a, **k)

    before = launch_counts()
    u, v = (torch.as_tensor(a) for a in fields(shape))
    u0, v0 = u.clone(), v.clone()
    fu, fv = make_cuda_vector_apply(tf.operator, tf.filter_spec, pass_fn=spy)(u, v)
    assert kinds == [FIRST] + [MIDDLE] * (tf.n_steps - 2) + [LAST]
    assert launch_counts() == before
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert fu.shape == fv.shape == shape


@pytest.mark.parametrize("grid_type", [B, C])
def test_operands_prescaled(grid_type):
    """Coefficient planes in the kernel's order, each cast to the compute
    dtype and then scaled by -2*lap_scale rounded to that dtype, as the JAX
    kernel's host side does (vec_pass.host_vec_ext_inputs /
    host_ctap_ext_inputs); cached per (dtype, device)."""
    shape = (16, 32)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape), device="cpu")
    fn = make_cuda_vector_apply(tf.operator, tf.filter_spec)
    ops, p = fn.operands(torch.float32, torch.device("cpu"))
    assert fn.operands(torch.float32, torch.device("cpu"))[0] is ops
    neg2s = np.float32(-2.0 * 2.0 / tf.filter_spec.s_max)
    if grid_type == B:
        assert ops.op == vp.BGRID
        planes = [getattr(tf.operator, k).numpy() for k in BGRID_FIELDS]
    else:
        assert ops.op == vp.CTAP
        taps = cgrid_tap_arrays(tf.operator)
        planes = [taps[k] for k in CTAP_NAMES]
    want = np.stack([np.asarray(a, np.float32) * neg2s for a in planes])
    assert ops.coef.dtype == torch.float32 and ops.coef.is_contiguous()
    assert np.array_equal(ops.coef.numpy(), want)
    assert ops.zap and p == [float(x) for x in np.asarray(tf.filter_spec.p, np.float32)]


def test_dispatch_rejects_bad_inputs():
    shape = (16, 32)
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_C_GRID,
                   grid_vars=unit_grid_vars(C, shape), device="cpu")
    fn = make_cuda_vector_apply(tf.operator, tf.filter_spec)
    z = torch.zeros(shape)
    with pytest.raises(ValueError, match="same shape"):
        fn(z, torch.zeros((2,) + shape))
    with pytest.raises(ValueError, match="spatial shape"):
        fn(torch.zeros(16, 30), torch.zeros(16, 30))
    with pytest.raises(ValueError, match="two spatial dims"):
        fn(torch.zeros(32), torch.zeros(32))
    eu, ev = fn(torch.zeros((0,) + shape, dtype=torch.int32), torch.zeros((0,) + shape))
    assert eu.shape == ev.shape == (0,) + shape and eu.dtype == torch.float32
    spec = tf.filter_spec._replace(n_steps=1, p=tf.filter_spec.p[:2])
    with pytest.raises(ValueError, match="n_steps >= 2"):
        make_cuda_vector_apply(tf.operator, spec)
    scalar = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    with pytest.raises(TypeError, match="no vector kernel"):
        make_cuda_vector_apply(scalar.operator, scalar.filter_spec)


def test_mixed_dtypes_compute_in_float64():
    """u float32 with v float64 computes in float64, as the JAX engine does
    (its Pallas dispatcher sends mixed dtypes to the XLA engine)."""
    shape = (32, 64)
    jf, tf = _pair(B, unit_grid_vars(B, shape), filter_scale=5.0, dx_min=1.0)
    u, v = fields(shape)
    u = u.astype(np.float32)
    tu, tv = tf.apply_to_vector(u, v)
    ju, jv = jengine(jf.operator, jf.filter_spec, jnp.asarray(u), jnp.asarray(v))
    assert tu.dtype == tv.dtype == torch.float64
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[np.float64])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL[np.float64])
