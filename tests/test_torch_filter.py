"""The port's ``Filter`` against the JAX package's, and the port's isolation.

``gcm_filters_tpu_torch.Filter(..., device="cpu")`` must give the JAX
``Filter``'s results on arrays, batches and dicts (f64 rtol 1e-11 / atol
1e-13), raise the same errors and warnings (scalar and vector surfaces), refuse to run on the CPU unless
asked, carry a JAX stencil across through ``stencil_from_numpy``, and never
import JAX or the JAX package.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.interop import stencil_from_numpy
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply

REPO = pathlib.Path(__file__).resolve().parents[1]


def _pair(grid_type=gj.GridType.REGULAR, grid_vars=None, **kw):
    grid_vars = {} if grid_vars is None else grid_vars
    jf = gj.Filter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", **kw)
    return jf, tf


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_apply_arrays_batches_tensors(scalar_grid_data):
    grid_type, data, grid_vars = scalar_grid_data
    jf, tf = _pair(grid_type, grid_vars, filter_scale=5.0, dx_min=1.0)
    want = np.asarray(jf.apply(data))
    got = tf.apply(data)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(tf.apply(torch.as_tensor(data)).numpy(), want,
                               rtol=1e-11, atol=1e-13)
    batch = np.stack([data, 0.5 * data])
    np.testing.assert_allclose(tf.apply(batch).numpy(), np.asarray(jf.apply(batch)),
                               rtol=1e-11, atol=1e-13)


def test_apply_list_keeps_float64():
    """A bare Python list computes in numpy's float64, as the JAX package's
    Filter does under x64, not in torch's default float32."""
    wet = np.ones((32, 48))
    wet[0] = 0
    wet[10:14, 20:30] = 0
    data = np.random.default_rng(2).random((32, 48))
    jf, tf = _pair(gj.GridType.REGULAR_WITH_LAND, {"wet_mask": wet}, filter_scale=4.0, dx_min=1.0)
    want = np.asarray(jf.apply(data.tolist()))
    got = tf.apply(data.tolist())
    assert want.dtype == np.float64 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-13)
    np.testing.assert_array_equal(got.numpy(), tf.apply(data).numpy())


def test_dtype_option():
    data = np.random.default_rng(1).random((32, 64))
    jf = gj.Filter(filter_scale=4.0, dx_min=1.0, dtype=jnp.float32, use_pallas=False)
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, dtype=torch.float32, device="cpu")
    got = tf.apply(data)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.apply(data)), rtol=2e-5, atol=2e-6)


def test_apply_dict(scalar_grid_data):
    grid_type, data, grid_vars = scalar_grid_data
    jf, tf = _pair(grid_type, grid_vars, filter_scale=3.0, dx_min=1.0)
    ds = {"sst": data, "time": np.arange(4.0), "batched": np.stack([data, data])}
    want, got = jf.apply(ds), tf.apply(ds)
    assert got["time"] is ds["time"]
    for k in ("sst", "batched"):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-11, atol=1e-13)


def test_apply_dict_named_dims():
    data = np.random.default_rng(2).random((16, 32))
    jf, tf = _pair(filter_scale=3.0, dx_min=1.0)
    ds = {"a": (data, ("y", "x")), "b": (np.arange(3.0), ("t",))}
    want, got = jf.apply(ds, dims=("y", "x")), tf.apply(ds, dims=("y", "x"))
    assert got["a"][1] == ("y", "x") and got["b"][0] is ds["b"][0]
    np.testing.assert_allclose(got["a"][0].numpy(), np.asarray(want["a"][0]),
                               rtol=1e-11, atol=1e-13)


def _same_error(make, kind=Exception):
    with pytest.raises(kind) as jerr:
        make(gj)
    with pytest.raises(kind) as terr:
        make(gt)
    assert type(terr.value) is type(jerr.value)
    assert str(terr.value) == str(jerr.value)


def _grid(mod, name):
    return mod.GridType[name]


@pytest.mark.parametrize("case", [
    "unknown_grid", "area_dx_min", "transition_width", "ndim3", "grid_vars", "dims_len",
])
def test_constructor_and_apply_errors_match(case):
    wet = np.ones((8, 16)); wet[0] = 0
    makers = {
        "unknown_grid": lambda m: m.Filter(filter_scale=3.0, dx_min=1.0, grid_type="REGULAR"),
        "area_dx_min": lambda m: m.Filter(
            filter_scale=3.0, dx_min=2.0,
            grid_type=_grid(m, "REGULAR_WITH_LAND_AREA_WEIGHTED"),
            grid_vars={"area": np.ones((8, 16)), "wet_mask": wet}),
        "transition_width": lambda m: m.Filter(filter_scale=3.0, dx_min=1.0,
                                               transition_width=0.9),
        "ndim3": lambda m: m.Filter(filter_scale=3.0, dx_min=1.0, ndim=3),
        "grid_vars": lambda m: m.Filter(filter_scale=3.0, dx_min=1.0,
                                        grid_type=_grid(m, "REGULAR_WITH_LAND"), grid_vars={}),
        "dims_len": lambda m: m.Filter(filter_scale=3.0, dx_min=1.0).apply(
            {"a": (np.ones((8, 16)), ("y", "x"))}, dims=("y",)),
    }
    _same_error(makers[case])


@pytest.mark.parametrize("case", ["ambiguous", "named_needs_dims", "trailing_two"])
def test_dict_selection_errors_match(case):
    a, b = np.ones((8, 16)), np.ones((4, 4))
    makers = {
        "ambiguous": lambda m: _filter(m).apply({"a": a, "b": b}),
        "named_needs_dims": lambda m: _filter(m).apply({"a": (a, ("y", "x"))}),
        "trailing_two": lambda m: _filter(m).apply({"a": (a.T, ("x", "y"))}, dims=("y", "x")),
    }
    _same_error(makers[case], ValueError)


def _filter(mod, grid_name="REGULAR", grid_vars=None):
    kw = {"use_pallas": False} if mod is gj else {"device": "cpu"}
    return mod.Filter(filter_scale=3.0, dx_min=1.0, grid_type=mod.GridType[grid_name],
                      grid_vars={} if grid_vars is None else grid_vars, **kw)


@pytest.mark.parametrize("case", ["n_steps_low", "nothing_filtered", "coincidental_shape"])
def test_warnings_match(case):
    a = np.random.default_rng(0).random((8, 16))

    def run(mod):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if case == "n_steps_low":
                mod.Filter(filter_scale=10.0, dx_min=1.0, n_steps=3)
            elif case == "nothing_filtered":
                _filter(mod).apply({"time": np.arange(4.0)})
            else:
                _filter(mod).apply({"a": (a, ("y", "x")), "b": a}, dims=("y", "x"))
        return [(w.category, str(w.message)) for w in rec]

    got, want = run(gt), run(gj)
    assert got == want and len(got) == 1


def test_n_steps_and_spec_match():
    jf, tf = _pair(filter_scale=7.0, dx_min=1.0, ndim=3, n_steps=5)
    assert tf.n_steps == jf.n_steps == 5
    assert np.array_equal(np.asarray(tf.filter_spec.p), np.asarray(jf.filter_spec.p))
    assert "Filter" in repr(tf)


def test_vector_grid_builds_and_refuses_scalar_apply(vector_grid_data):
    """A vector grid builds; ``apply`` on it raises the JAX package's error,
    and so does ``apply_to_vector`` on a scalar grid."""
    grid_type, (u, v), grid_vars = vector_grid_data
    name = grid_type.name
    tf = gt.Filter(filter_scale=3.0, dx_min=1.0, grid_type=gt.GridType[name],
                   grid_vars=grid_vars, device="cpu")
    assert type(tf.operator).__name__ in ("BGridVectorStencil", "CGridVectorOperator")
    _same_error(lambda m: _filter(m, name, grid_vars).apply(u), ValueError)
    _same_error(lambda m: _filter(m).apply_to_vector(u, v), ValueError)


def test_default_device_is_the_card_and_refuses_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tf = gt.Filter(filter_scale=3.0, dx_min=1.0)
    assert tf.device == torch.device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.apply(np.ones((8, 16)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tf.apply({"a": np.ones((8, 16))})


def test_stencil_from_numpy_carries_jax_stencil(scalar_grid_data_with_mom5):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    jf, tf = _pair(grid_type, grid_vars, filter_scale=4.0, dx_min=1.0)
    fields = dataclasses.asdict(jf.operator)
    flags = {k: fields.pop(k) for k in ("fold_north", "zap_nans", "is_dimensional")}
    fields = {k: v if v is None or isinstance(v, float) else np.asarray(v)
              for k, v in fields.items()}
    st = stencil_from_numpy(fields, **flags, device="cpu", dtype=torch.float64)
    for k in ("c", "n", "s", "e", "w", "pre", "post", "area"):
        a, b = getattr(st, k), getattr(tf.operator, k)
        assert (a is None and b is None) or (isinstance(a, float) and a == b) or torch.equal(a, b)
    got = make_cuda_scalar_apply(st, tf.filter_spec)(torch.as_tensor(data)).numpy()
    np.testing.assert_allclose(got, tf.apply(data).numpy(), rtol=0, atol=0)


def test_stencil_from_numpy_rejects_unknown_fields():
    with pytest.raises(ValueError, match="Unknown stencil fields"):
        stencil_from_numpy({"c": -4.0, "n": 1.0, "s": 1.0, "e": 1.0, "w": 1.0, "q": 1.0},
                           fold_north=False, zap_nans=False, is_dimensional=False)
    with pytest.raises(ValueError, match="'w' is missing"):
        stencil_from_numpy({"c": -4.0, "n": 1.0, "s": 1.0, "e": 1.0},
                           fold_north=False, zap_nans=False, is_dimensional=False)


def test_import_leaves_jax_out():
    code = (
        "import sys, gcm_filters_tpu_torch, gcm_filters_tpu_torch.ops.cuda.build, "
        "gcm_filters_tpu_torch.interop, gcm_filters_tpu_torch.utils.telemetry\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'gcm_filters_tpu' or m.startswith('gcm_filters_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_package_source_never_imports_jax():
    roots = {"jax", "jaxlib", "gcm_filters_tpu"}
    files = sorted((REPO / "gcm_filters_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in roots, f"{path.name} imports {name}"
