"""The port's eager engine against the JAX engine and the goldens.

``gcm_filters_tpu_torch.engine.scalar_filter_apply`` is the plain PyTorch
version of the whole filter and the oracle for the kernel path. It must match
``gcm_filters_tpu.engine.scalar_filter_apply`` on the same stencil and input
(f64 rtol 1e-11 / atol 1e-13; f32 rtol 2e-5 / atol 2e-6, the tolerances of
tests/test_pallas.py), reproduce the ``filter_*.npz`` goldens, and promote
dtypes by JAX's rule.
"""
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcm_filters_tpu import Filter as JFilter, GridType
from gcm_filters_tpu.engine import scalar_filter_apply as jengine
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _compute_dtype, scalar_filter_apply as tengine

DATA_DIR = pathlib.Path(__file__).parent / "test_data_golden"
TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}


def _pair(grid_type, grid_vars, **kw):
    jf = JFilter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", **kw)
    return jf, tf


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_engine_matches_jax(scalar_grid_data_with_mom5, dtype):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    jf, tf = _pair(grid_type, grid_vars, filter_scale=6.0, dx_min=1.0)
    x = data.astype(dtype)
    want = np.asarray(jengine(jf.operator, jf.filter_spec, jnp.asarray(x)))
    got = tengine(tf.operator, tf.filter_spec, torch.as_tensor(x))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


def test_engine_batched_matches_jax(scalar_grid_data):
    grid_type, data, grid_vars = scalar_grid_data
    jf, tf = _pair(grid_type, grid_vars, filter_scale=4.0, dx_min=1.0)
    batch = np.stack([data, data[::-1].copy(), 2.0 * data])
    want = np.asarray(jengine(jf.operator, jf.filter_spec, jnp.asarray(batch)))
    got = tengine(tf.operator, tf.filter_spec, torch.as_tensor(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-13)


def test_golden_filter(scalar_grid_data):
    grid_type, data, grid_vars = scalar_grid_data
    path = DATA_DIR / f"filter_{grid_type.name}.npz"
    if not path.exists():
        pytest.skip(f"golden snapshot {path.name} is missing")
    tf = gt.Filter(filter_scale=8.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=grid_vars, device="cpu")
    saved = np.load(path)["filtered"]
    eager = tengine(tf.operator, tf.filter_spec, torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(np.float32(eager), saved, rtol=1e-5, atol=1e-6)
    # the Filter's own path (the step kernel's plain version on the CPU)
    np.testing.assert_allclose(np.float32(tf.apply(data).numpy()), saved, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype, want", [
    (torch.int32, torch.float32),
    (torch.int64, torch.float32),
    (torch.uint8, torch.float32),
    (torch.bool, torch.float32),
    (torch.float16, torch.float32),
    (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32),
    (torch.float64, torch.float64),
])
def test_compute_dtype_follows_jax(dtype, want):
    assert _compute_dtype(dtype) == want
    np_dtypes = {torch.int32: np.int32, torch.int64: np.int64, torch.uint8: np.uint8,
                 torch.bool: np.bool_, torch.float16: np.float16,
                 torch.float32: np.float32, torch.float64: np.float64}
    if dtype in np_dtypes:
        jdt = jnp.result_type(np_dtypes[dtype], jnp.float32)
        assert str(jdt) == str(want).replace("torch.", "")


def test_compute_dtype_rejects_complex():
    with pytest.raises(TypeError, match="complex"):
        _compute_dtype(torch.complex64)


def test_integer_field_computes_in_float32():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 50, size=(32, 64)).astype(np.int64)
    wet = np.ones((32, 64)); wet[:4, :8] = 0
    jf, tf = _pair(GridType.REGULAR_WITH_LAND, {"wet_mask": wet}, filter_scale=4.0, dx_min=1.0)
    want = np.asarray(jf.apply(data))
    eager = tengine(tf.operator, tf.filter_spec, torch.as_tensor(data))
    got = tf.apply(data)
    assert want.dtype == np.float32
    assert eager.dtype == torch.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(eager.numpy(), want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)
