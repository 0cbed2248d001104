"""The port's vector path against the JAX package's.

Builders: every coefficient tensor of the B-grid and C-grid operators must
equal the JAX builders' bit for bit in float64, and the C-grid tap arrays the
JAX ``cgrid_tap_arrays``. Laplacians and the eager engine must match the JAX
ones (f64 rtol 1e-11 / atol 1e-13, f32 rtol 2e-5 / atol 2e-6) and the
``*_VECTOR_*.npz`` goldens (rtol 1e-5 / atol 1e-6). ``Filter.apply_to_vector``
and the streamed methods must give the JAX ``Filter``'s results and raise its
errors.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
from gcm_filters_tpu.engine import vector_filter_apply as jengine
from gcm_filters_tpu.ops.ctaps import cgrid_tap_arrays as jtaps
from gcm_filters_tpu.ops.laplacians import build_operator as jbuild
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import vector_filter_apply as tengine
from gcm_filters_tpu_torch.interop import vector_operator_from_numpy
from gcm_filters_tpu_torch.ops.ctaps import CTAPS, apply_taps, cgrid_tap_arrays as ttaps
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_vector_apply
from gcm_filters_tpu_torch.ops.laplacians import build_operator as tbuild

from conftest import make_vector_grid_data
from test_torch_vec_pass import fields, unit_grid_vars

DATA_DIR = pathlib.Path(__file__).parent / "test_data_golden"
TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}
B, C = gj.GridType.VECTOR_B_GRID, gj.GridType.VECTOR_C_GRID


def _tgrid(grid_type):
    return gt.GridType[grid_type.name]


def _pair(grid_type, grid_vars, **kw):
    jf = gj.Filter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=_tgrid(grid_type), grid_vars=grid_vars, device="cpu", **kw)
    return jf, tf


def _grid(kind, grid_type, shape=(64, 128)):
    """Grid variables: the spherical fixture construction or unit-scale metrics."""
    if kind == "spherical":
        return make_vector_grid_data(grid_type, shape)[2]
    return unit_grid_vars(grid_type, shape, kappa_aniso=1.0 if kind == "unit" else 0.0)


@pytest.mark.parametrize("kind", ["spherical", "unit"])
@pytest.mark.parametrize("grid_type", [B, C])
def test_coefficients_bitwise(grid_type, kind):
    gv = _grid(kind, grid_type)
    jo, to = jbuild(grid_type, gv), tbuild(_tgrid(grid_type), gv)
    assert type(to).__name__ == type(jo).__name__
    for f in dataclasses.fields(to):
        a, b = getattr(jo, f.name), getattr(to, f.name)
        if isinstance(b, torch.Tensor):
            assert b.dtype == torch.float64, f.name
            assert np.array_equal(np.asarray(a), b.numpy()), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("kind", ["spherical", "unit", "unit_iso"])
def test_cgrid_taps_equal_jax(kind):
    gv = _grid(kind, C)
    want = jtaps(jbuild(C, gv))
    got = ttaps(tbuild(_tgrid(C), gv))
    assert list(got) == [name for name, *_ in CTAPS] == list(want)
    for k in want:
        assert got[k].dtype == np.float64 and np.array_equal(got[k], np.asarray(want[k])), k


@pytest.mark.parametrize("kind", ["spherical", "unit", "unit_iso"])
def test_apply_taps_equals_staged_laplacian(kind):
    """The tap form equals the staged strain/divergence form to roundoff
    (tests/test_kernels_properties.py pins the same for the JAX package)."""
    gv = _grid(kind, C)
    op = tbuild(_tgrid(C), gv)
    u, v = (torch.as_tensor(a) for a in fields((64, 128), seed=4))
    lu, lv = op.laplacian(u, v)
    tu, tv = apply_taps(ttaps(op), u, v)
    scale = max(float(lu.abs().max()), float(lv.abs().max()))
    assert float((tu - lu).abs().max()) / scale < 1e-13
    assert float((tv - lv).abs().max()) / scale < 1e-13


def test_laplacian_matches_jax(vector_grid_data):
    grid_type, (u, v), grid_vars = vector_grid_data
    ju, jv = jbuild(grid_type, grid_vars).laplacian(jnp.asarray(u), jnp.asarray(v))
    tu, tv = tbuild(_tgrid(grid_type), grid_vars).laplacian(torch.as_tensor(u), torch.as_tensor(v))
    for got, want in ((tu, ju), (tv, jv)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                                   atol=1e-13 * float(np.abs(want).max()))


def test_golden_laplacian(vector_grid_data):
    grid_type, (u, v), grid_vars = vector_grid_data
    saved = np.load(DATA_DIR / f"laplacian_{grid_type.name}.npz")
    lu, lv = tbuild(_tgrid(grid_type), grid_vars).laplacian(torch.as_tensor(u), torch.as_tensor(v))
    np.testing.assert_allclose(np.float32(lu.numpy()), saved["lap_u"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.float32(lv.numpy()), saved["lap_v"], rtol=1e-5, atol=1e-6)


def test_golden_filter(vector_grid_data):
    grid_type, (u, v), grid_vars = vector_grid_data
    saved = np.load(DATA_DIR / f"filter_{grid_type.name}.npz")
    tf = gt.Filter(filter_scale=8.0, dx_min=1.0, grid_type=_tgrid(grid_type),
                   grid_vars=grid_vars, device="cpu")
    eager = tengine(tf.operator, tf.filter_spec, torch.as_tensor(u), torch.as_tensor(v))
    # the Filter's own path: the step kernels' plain version on the CPU
    for fu, fv in (eager, tf.apply_to_vector(u, v)):
        np.testing.assert_allclose(np.float32(fu.numpy()), saved["filtered_u"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.float32(fv.numpy()), saved["filtered_v"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind, dtype", [
    ("spherical", np.float64), ("unit", np.float64), ("unit_iso", np.float64),
    ("unit_iso", np.float32),
])
@pytest.mark.parametrize("grid_type", [B, C])
def test_engine_matches_jax(grid_type, kind, dtype):
    jf, tf = _pair(grid_type, _grid(kind, grid_type), filter_scale=6.0, dx_min=1.0)
    u, v = (a.astype(dtype) for a in fields((64, 128)))
    want = jengine(jf.operator, jf.filter_spec, jnp.asarray(u), jnp.asarray(v))
    got = tengine(tf.operator, tf.filter_spec, torch.as_tensor(u), torch.as_tensor(v))
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(u).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL[dtype])


@pytest.mark.parametrize("grid_type", [B, C])
def test_odd_shape_and_batch_match_jax_engine(grid_type):
    shape = (97, 300)
    jf, tf = _pair(grid_type, unit_grid_vars(grid_type, shape, kappa_aniso=0.0),
                   filter_scale=5.0, dx_min=1.0)
    u, v = fields(shape, seed=8)
    ub = np.stack([np.stack([u, 2.0 * u]), np.stack([v[::-1].copy(), u])])  # (2, 2, ny, nx)
    vb = np.stack([np.stack([v, u]), np.stack([0.5 * v, v[:, ::-1].copy()])])
    for uu, vv in ((u, v), (ub, vb)):
        ju, jv = jengine(jf.operator, jf.filter_spec, jnp.asarray(uu), jnp.asarray(vv))
        tu, tv = tf.apply_to_vector(uu, vv)
        assert tu.shape == tv.shape == uu.shape
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[np.float64])
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL[np.float64])


def test_apply_to_vector_matches_jax_filter(vector_grid_data):
    grid_type, (u, v), grid_vars = vector_grid_data
    jf, tf = _pair(grid_type, grid_vars, filter_scale=6.0, dx_min=1.0)
    ju, jv = jf.apply_to_vector(u, v)
    tu, tv = tf.apply_to_vector(torch.as_tensor(u), v, dims=("y", "x"))
    assert tu.device.type == "cpu" and tu.dtype == torch.float64
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[np.float64])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL[np.float64])


def test_dtype_option_float32():
    shape = (32, 64)
    gv = unit_grid_vars(C, shape, kappa_aniso=0.0)
    jf, tf = (m.Filter(filter_scale=4.0, dx_min=1.0, grid_type=m.GridType.VECTOR_C_GRID,
                       grid_vars=gv, dtype=dt, **kw)
              for m, dt, kw in ((gj, jnp.float32, {"use_pallas": False}),
                                (gt, torch.float32, {"device": "cpu"})))
    u, v = fields(shape)
    ju, jv = jf.apply_to_vector(u, v)
    tu, tv = tf.apply_to_vector(u, v)
    assert tu.dtype == tv.dtype == torch.float32
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL[np.float32])
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL[np.float32])


def _same_error(make, kind=Exception):
    with pytest.raises(kind) as jerr:
        make(gj)
    with pytest.raises(kind) as terr:
        make(gt)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def _filter(mod, grid_name="REGULAR", grid_vars=None):
    kw = {"use_pallas": False} if mod is gj else {"device": "cpu"}
    return mod.Filter(filter_scale=3.0, dx_min=1.0, grid_type=mod.GridType[grid_name],
                      grid_vars=grid_vars or {}, **kw)


@pytest.mark.parametrize("case", [
    "apply_on_vector", "apply_dict_on_vector", "apply_streamed_on_vector",
    "vector_on_scalar", "vector_streamed_on_scalar", "streamed_shapes_differ",
])
def test_surface_errors_match(case):
    shape = (8, 16)
    gv = unit_grid_vars(B, shape)
    a = np.ones(shape)
    makers = {
        "apply_on_vector": lambda m: _filter(m, "VECTOR_B_GRID", gv).apply(a),
        "apply_dict_on_vector": lambda m: _filter(m, "VECTOR_B_GRID", gv).apply({"a": a}),
        "apply_streamed_on_vector": lambda m: _filter(m, "VECTOR_B_GRID", gv).apply_streamed(
            np.ones((2,) + shape)),
        "vector_on_scalar": lambda m: _filter(m).apply_to_vector(a, a),
        "vector_streamed_on_scalar": lambda m: _filter(m).apply_to_vector_streamed(a, a),
        "streamed_shapes_differ": lambda m: _filter(m, "VECTOR_B_GRID", gv)
        .apply_to_vector_streamed(np.ones((2,) + shape), np.ones((3,) + shape)),
    }
    _same_error(makers[case], ValueError)


@pytest.mark.parametrize("grid_type", [B, C])
def test_builder_errors_match(grid_type):
    gv = unit_grid_vars(grid_type, (8, 16))
    for name in list(gv):
        _same_error(lambda m: m.Filter(
            filter_scale=3.0, dx_min=1.0, grid_type=m.GridType[grid_type.name],
            grid_vars={k: x for k, x in gv.items() if k != name}), ValueError)
    _same_error(lambda m: m.Filter(
        filter_scale=3.0, dx_min=1.0, grid_type=m.GridType[grid_type.name],
        grid_vars=dict(gv, bogus=np.ones((8, 16)))), ValueError)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_apply_to_vector_streamed_matches_jax(lead):
    shape = (16, 32)
    jf, tf = _pair(C, unit_grid_vars(C, shape, kappa_aniso=0.0), filter_scale=4.0, dx_min=1.0)
    rng = np.random.default_rng(6)
    u, v = rng.random(lead + shape), rng.random(lead + shape)
    ju, jv = jf.apply_to_vector_streamed(u, v, chunk=2)
    tu, tv = tf.apply_to_vector_streamed(u, v, chunk=2)
    assert isinstance(tu, np.ndarray) and tu.shape == u.shape
    np.testing.assert_allclose(tu, ju, **TOL[np.float64])
    np.testing.assert_allclose(tv, jv, **TOL[np.float64])
    fu, fv = tf.apply_to_vector_streamed(u[0], v[0])  # no leading dim: one apply
    np.testing.assert_allclose(fu, tu[0], **TOL[np.float64])


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_apply_streamed_matches_jax(lead):
    shape = (16, 32)
    wet = np.ones(shape); wet[0] = 0
    jf, tf = _pair(gj.GridType.REGULAR_WITH_LAND, {"wet_mask": wet}, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(2).random(lead + shape)
    want = jf.apply_streamed(data, chunk=4)
    got = tf.apply_streamed(data, chunk=4)
    assert isinstance(got, np.ndarray) and got.shape == data.shape
    np.testing.assert_allclose(got, want, **TOL[np.float64])
    np.testing.assert_allclose(tf.apply_streamed(data[(0,) * len(lead)]),
                               want[(0,) * len(lead)], **TOL[np.float64])


@pytest.mark.parametrize("in_dtype", [np.float32, np.float64, np.int32])
def test_streamed_empty_batch_dtypes_match(in_dtype):
    shape = (8, 16)
    gv = unit_grid_vars(B, shape)
    e = np.zeros((0, 2) + shape, dtype=in_dtype)
    jf, tf = _pair(B, gv, filter_scale=3.0, dx_min=1.0)
    for got, want in zip(tf.apply_to_vector_streamed(e, e), jf.apply_to_vector_streamed(e, e)):
        assert got.shape == want.shape and got.dtype == want.dtype
    js, ts = _filter(gj), _filter(gt)
    got, want = ts.apply_streamed(e), js.apply_streamed(e)
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("grid_type", [B, C])
def test_vector_operator_from_numpy_carries_jax_operator(grid_type):
    shape = (32, 64)
    jf, tf = _pair(grid_type, unit_grid_vars(grid_type, shape), filter_scale=4.0, dx_min=1.0)
    flds = {k: (x if isinstance(x, bool) else np.asarray(x))
            for k, x in dataclasses.asdict(jf.operator).items()}
    op = vector_operator_from_numpy(flds)
    assert type(op) is type(tf.operator)
    for f in dataclasses.fields(op):
        a, b = getattr(op, f.name), getattr(tf.operator, f.name)
        if not isinstance(a, bool):
            assert a.dtype == torch.float64 and a.device.type == "cpu", f.name
        assert (a == b) if isinstance(a, bool) else torch.equal(a, b), f.name
    u, v = (torch.as_tensor(a) for a in fields(shape))
    got = make_cuda_vector_apply(op, tf.filter_spec)(u, v)
    for g, w in zip(got, tf.apply_to_vector(u, v)):
        assert torch.equal(g, w)


def test_vector_operator_from_numpy_rejects_unknown_fields():
    gv = unit_grid_vars(B, (4, 4))
    flds = dataclasses.asdict(tbuild(gt.GridType.VECTOR_B_GRID, gv))
    flds.pop("dmw")
    with pytest.raises(ValueError, match="neither a B-grid"):
        vector_operator_from_numpy(flds)


def test_apply_to_vector_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gv = unit_grid_vars(B, (8, 16))
    tf = gt.Filter(filter_scale=3.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_B_GRID,
                   grid_vars=gv)
    assert tf.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.apply_to_vector(np.ones((8, 16)), np.ones((8, 16)))
