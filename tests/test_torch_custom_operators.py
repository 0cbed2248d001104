"""The port's custom-operator protocol against the JAX package's.

The cases of tests/test_custom_operators.py, run through the port's
``Filter(custom_operator=..., device="cpu")``: each operator is written twice,
with ``jnp`` for the JAX package and with ``torch`` for the port, and both
filters get the same numpy inputs. Protocol operators run through the eager
engines of both packages, the same arithmetic in the same order, so the
results agree at f64 rtol 1e-11 / atol 1e-13 (the bar of the JAX tests).
Framework stencil types passed as ``custom_operator`` go through the step
kernels' plain versions. Also here: the ``mesh=`` rejection of protocol
operators, and scalar and vector filters on a one-rank mesh.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.custom import as_protocol_adapter, operator_is_vector

TOL = dict(rtol=1e-11, atol=1e-13)


def _lap5(xp, f):
    return (xp.roll(f, -1, -2) + xp.roll(f, 1, -2) + xp.roll(f, -1, -1)
            + xp.roll(f, 1, -1) - 4.0 * f)


def _nine_point(xp, f):
    n, s = xp.roll(f, -1, -2), xp.roll(f, 1, -2)
    e, w = xp.roll(f, -1, -1), xp.roll(f, 1, -1)
    ne, nw = xp.roll(n, -1, -1), xp.roll(n, 1, -1)
    se, sw = xp.roll(s, -1, -1), xp.roll(s, 1, -1)
    return 0.5 * (n + s + e + w) + 0.25 * (ne + nw + se + sw) - 3.0 * f


def _scalar_pair(fn, **attrs):
    """The same scalar operator for both packages: (jax op, torch op)."""
    j = type("JOp", (gj.BaseScalarOperator,), dict(attrs, __call__=lambda self, f: fn(jnp, f)))
    t = type("TOp", (gt.BaseScalarOperator,), dict(attrs, __call__=lambda self, f: fn(torch, f)))
    return j(), t()


def _both(jop, top, data, **kw):
    jf = gj.Filter(custom_operator=jop, **kw)
    tf = gt.Filter(custom_operator=top, device="cpu", **kw)
    assert jf._is_vector == tf._is_vector and tf._operator_name() == "custom_operator"
    return np.asarray(jf.apply(data)), tf.apply(data).numpy(), tf


def test_nine_point_scalar_protocol_operator():
    jop, top = _scalar_pair(_nine_point)
    rng = np.random.default_rng(11)
    data = rng.random((48, 64))
    want, got, tf = _both(jop, top, data, filter_scale=6.0, dx_min=1.0)
    assert not tf._is_vector
    np.testing.assert_allclose(got, want, **TOL)
    # conservation: the 9-point stencil has zero column sums
    np.testing.assert_allclose(got.sum(), data.sum(), rtol=1e-10)
    # batched leading dims work through the protocol path too
    batch = rng.random((3, 48, 64))
    wantb, gotb, _ = _both(jop, top, batch, filter_scale=6.0, dx_min=1.0)
    np.testing.assert_allclose(gotb, wantb, **TOL)
    np.testing.assert_allclose(gotb[1], tf.apply(batch[1]).numpy(), **TOL)


def test_scalar_protocol_prepare_finalize_hooks():
    """An area-weighted protocol operator must match the built-in
    REGULAR_AREA_WEIGHTED grid of both packages."""
    rng = np.random.default_rng(5)
    area = 0.8 + 0.4 * rng.random((32, 48))
    area_t = torch.as_tensor(area)
    jop, _ = _scalar_pair(_lap5, prepare=lambda self, f: f * area,
                          finalize=lambda self, f: f / area)
    _, top = _scalar_pair(_lap5, prepare=lambda self, f: f * area_t,
                          finalize=lambda self, f: f / area_t)
    data = rng.random((32, 48))
    want, got, _ = _both(jop, top, data, filter_scale=4.0, dx_min=1.0)
    np.testing.assert_allclose(got, want, **TOL)
    ref = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu",
                    grid_type=gt.GridType.REGULAR_AREA_WEIGHTED, grid_vars={"area": area})
    np.testing.assert_allclose(got, ref.apply(data).numpy(), **TOL)


def test_custom_vector_protocol_operator():
    """A decoupled vector Laplacian through BaseVectorOperator must equal
    the JAX one and the scalar REGULAR filter applied to each component."""

    class JVec(gj.BaseVectorOperator):
        def __call__(self, u, v):
            return _lap5(jnp, u), _lap5(jnp, v)

    class TVec(gt.BaseVectorOperator):
        def __call__(self, u, v):
            return _lap5(torch, u), _lap5(torch, v)

    jf = gj.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=JVec())
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=TVec(), device="cpu")
    assert tf._is_vector and jf._is_vector
    sf = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    rng = np.random.default_rng(21)
    u, v = rng.random((32, 32)), rng.random((32, 32))
    want = [np.asarray(a) for a in jf.apply_to_vector(u, v)]
    got = [a.numpy() for a in tf.apply_to_vector(u, v)]
    for g, w, comp in zip(got, want, (u, v)):
        np.testing.assert_allclose(g, w, **TOL)
        np.testing.assert_allclose(g, sf.apply(comp).numpy(), **TOL)
    # vector ops reject .apply with the JAX package's message
    with pytest.raises(ValueError, match="custom_operator is a vector Laplacian"):
        tf.apply(u)
    with pytest.raises(ValueError, match="custom_operator is a scalar Laplacian"):
        gt.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=_scalar_pair(_lap5)[1],
                  device="cpu").apply_to_vector(u, v)


def test_duck_typed_operator_without_base_class():
    """Any object with __call__(field) works -- no subclassing required
    (arity classification), and prepare/finalize default to identity."""

    class JBare:
        def __call__(self, f):
            return _lap5(jnp, f)

    class TBare:
        def __call__(self, f):
            return _lap5(torch, f)

    data = np.random.default_rng(2).random((32, 32))
    want, got, tf = _both(JBare(), TBare(), data, filter_scale=4.0, dx_min=1.0)
    assert not tf._is_vector
    np.testing.assert_allclose(got, want, **TOL)
    ref = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    np.testing.assert_allclose(got, ref.apply(data).numpy(), **TOL)
    adapter = as_protocol_adapter(TBare())
    x = torch.as_tensor(data)
    assert adapter.prepare(x) is x and adapter.finalize(x) is x
    assert adapter.to(torch.float32, "cpu") is adapter and not adapter.is_dimensional


def test_unclassifiable_operator_raises():
    class ThreeArg:
        def __call__(self, a, b, c):
            return a

    with pytest.raises(ValueError, match="classify") as ej:
        gj.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=ThreeArg())
    with pytest.raises(ValueError, match="classify") as et:
        gt.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=ThreeArg(), device="cpu")
    assert str(et.value) == str(ej.value)

    class Flagged:  # the attribute wins over the arity
        is_vector = True

        def __call__(self, f):
            return f

    assert operator_is_vector(Flagged())


def test_dimensional_protocol_operator_scaling():
    """is_dimensional=True selects the dimensional shifted-operator scale
    (2/s_max): on a unit grid it must match the nondimensional one."""
    jop, top = _scalar_pair(_lap5, is_dimensional=True)
    data = np.random.default_rng(3).random((32, 32))
    want, got, _ = _both(jop, top, data, filter_scale=4.0, dx_min=1.0)
    np.testing.assert_allclose(got, want, **TOL)
    ref = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    np.testing.assert_allclose(got, ref.apply(data).numpy(), **TOL)


def test_three_dimensional_filter_via_protocol_operator():
    """ndim=3 spec + a 3-D protocol Laplacian with manual n_steps."""

    def lap3(xp, f):
        out = -6.0 * f
        for ax in (-3, -2, -1):
            out = out + xp.roll(f, 1, ax) + xp.roll(f, -1, ax)
        return out

    jop, top = _scalar_pair(lap3)
    data = np.random.default_rng(8).random((16, 24, 32))
    want, got, tf = _both(jop, top, data, filter_scale=4.0, dx_min=1.0, ndim=3, n_steps=10)
    assert tf.filter_spec.s_max == 12.0  # ndim * (2/dx_min)^2
    assert got.shape == data.shape
    np.testing.assert_allclose(got.sum(), data.sum(), rtol=1e-10)
    assert got.var() < 0.25 * data.var()
    np.testing.assert_allclose(got, want, **TOL)


def test_custom_operator_skips_grid_validations():
    """grid_type/grid_vars are ignored with a custom operator: an
    area-weighted grid type with dx_min != 1 does not raise, as in JAX."""
    jop, top = _scalar_pair(_lap5)
    kw = dict(filter_scale=8.0, dx_min=2.0, grid_type=gj.GridType.REGULAR_AREA_WEIGHTED)
    jf = gj.Filter(custom_operator=jop, **kw)
    tf = gt.Filter(custom_operator=top, device="cpu", filter_scale=8.0, dx_min=2.0,
                   grid_type=gt.GridType.REGULAR_AREA_WEIGHTED)
    data = np.random.default_rng(6).random((24, 24))
    np.testing.assert_allclose(tf.apply(data).numpy(), np.asarray(jf.apply(data)), **TOL)
    with pytest.raises(ValueError, match="dx_min must be set to 1"):
        gt.Filter(filter_scale=8.0, dx_min=2.0, device="cpu",
                  grid_type=gt.GridType.REGULAR_AREA_WEIGHTED, grid_vars={"area": data})


@pytest.mark.parametrize("grid_name", ["REGULAR_WITH_LAND", "IRREGULAR_WITH_LAND"])
def test_framework_stencil_as_custom_operator(grid_name):
    """A ScalarStencil5 passed as custom_operator takes the step-kernel path
    (its plain version here) and equals the registry grid's filter in both
    packages."""
    from conftest import make_scalar_grid_data

    grid_type, data, grid_vars = make_scalar_grid_data(gj.GridType[grid_name], (64, 96))
    base_t = gt.Filter(filter_scale=6.0, dx_min=1.0, device="cpu",
                       grid_type=gt.GridType[grid_name], grid_vars=grid_vars)
    base_j = gj.Filter(filter_scale=6.0, dx_min=1.0, use_pallas=False,
                       grid_type=grid_type, grid_vars=grid_vars)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, device="cpu", custom_operator=base_t.operator)
    jf = gj.Filter(filter_scale=6.0, dx_min=1.0, use_pallas=False,
                   custom_operator=base_j.operator)
    got = tf.apply(data).numpy()
    assert np.array_equal(got, base_t.apply(data).numpy())
    np.testing.assert_allclose(got, np.asarray(jf.apply(data)), **TOL)


def _one_rank_mesh(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))


def test_mesh_rejections_and_one_rank_mesh(tmp_path):
    """Protocol operators cannot be sharded (the JAX message); vector filters
    with a mesh, registry grids and framework stencils as custom_operator
    alike, return DTensors equal to the unsharded filter's results, streamed
    too; a mesh of another device type than the filter's raises; and a
    framework scalar stencil as custom_operator runs on a 1x1 mesh and
    equals the unsharded filter."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    mesh = _one_rank_mesh(tmp_path)
    try:
        jop, top = _scalar_pair(_nine_point)
        with pytest.raises(ValueError, match="protocol") as et:
            gt.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=top, device="cpu",
                      mesh=mesh, spatial_axes=("y", "x"))
        import jax
        from jax.sharding import Mesh

        jmesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("y", "x"))
        with pytest.raises(ValueError, match="protocol") as ej:
            gj.Filter(filter_scale=4.0, dx_min=1.0, custom_operator=jop,
                      mesh=jmesh, spatial_axes=("y", "x"))
        assert str(et.value) == str(ej.value)

        rng = np.random.default_rng(4)
        m = 0.9 + 0.2 * rng.random((16, 32))
        one = np.ones((16, 32))
        gv = dict(wet_mask_t=one, wet_mask_q=one, dxT=m, dyT=m, dxCu=m, dyCu=m, dxCv=m, dyCv=m,
                  dxBu=m, dyBu=m, area_u=m * m, area_v=m * m, kappa_iso=one, kappa_aniso=0 * one)
        vkw = dict(filter_scale=4.0, dx_min=1.0, device="cpu")
        vbase = gt.Filter(grid_type=gt.GridType.VECTOR_C_GRID, grid_vars=gv, **vkw)
        u, v = rng.random((3, 16, 32)), rng.random((3, 16, 32))
        want = [a.numpy() for a in vbase.apply_to_vector(u, v)]
        for vf in (gt.Filter(grid_type=gt.GridType.VECTOR_C_GRID, grid_vars=gv, mesh=mesh,
                             spatial_axes=("y", "x"), halo_steps=2, **vkw),
                   gt.Filter(custom_operator=vbase.operator, mesh=mesh,
                             spatial_axes=("y", "x"), **vkw)):
            got = vf.apply_to_vector(u, v)
            assert all(isinstance(g, DTensor) for g in got)
            streamed = vf.apply_to_vector_streamed(u, v, chunk=2)
            for g, s, w in zip(got, streamed, want):
                np.testing.assert_allclose(g.full_tensor().numpy(), w, rtol=1e-12, atol=1e-14)
                np.testing.assert_allclose(s, w, rtol=1e-12, atol=1e-14)
        with pytest.raises(ValueError, match="is a vector Laplacian"):
            vf.apply(one)

        with pytest.raises(ValueError, match="'cpu' mesh but the filter's device is 'cuda'"):
            gt.Filter(filter_scale=4.0, dx_min=1.0, mesh=mesh, spatial_axes=("y", "x"))
        with pytest.raises(ValueError, match="no dim named 'z'"):
            gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", mesh=mesh,
                      spatial_axes=("y", "z")).apply(m)

        wet = np.ones((16, 32)); wet[0] = 0
        base = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu",
                         grid_type=gt.GridType.REGULAR_WITH_LAND, grid_vars={"wet_mask": wet})
        sharded = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu",
                            custom_operator=base.operator, mesh=mesh, spatial_axes=("y", "x"))
        data = np.random.default_rng(1).random((2, 16, 32))
        out = sharded.apply(data)
        assert isinstance(out, DTensor)
        np.testing.assert_allclose(out.full_tensor().numpy(), base.apply(data).numpy(),
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(sharded.apply_streamed(data, chunk=1),
                                   base.apply(data).numpy(), rtol=1e-12, atol=1e-14)
    finally:
        dist.destroy_process_group()
