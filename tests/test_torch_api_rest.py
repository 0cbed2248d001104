"""The rest of the port's ``Filter`` API and ``utils/profiling.py`` against the
JAX package: ``grid_ds``, ``plot_shape``, the guarded xarray adapter of
``apply`` / ``apply_to_vector``, ``benchmark_fn`` and the roofline helpers.

xarray is not installed where these tests run, so the adapter is driven
through a small stand-in module (``DataArray``, ``Dataset``, ``apply_ufunc``)
planted in ``sys.modules`` for both packages alike: the same calls must reach
``apply_ufunc`` with the same arguments, and the same values must come back
(f64 rtol 1e-11 / atol 1e-13, the eager-engine bar of tests/test_torch_filter.py).
"""
import sys
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
from gcm_filters_tpu.utils import profiling as jprof
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch import filter as tfilter
from gcm_filters_tpu_torch.utils import profiling as tprof

from test_torch_vec_pass import fields, unit_grid_vars

TOL = dict(rtol=1e-11, atol=1e-13)


def _pair(**kw):
    jkw = dict(kw)
    if "grid_type" in kw:
        kw = dict(kw, grid_type=gt.GridType[kw["grid_type"].name])
    return gj.Filter(use_pallas=False, **jkw), gt.Filter(device="cpu", **kw)


# -- a stand-in for xarray ---------------------------------------------------

class _DataArray:
    def __init__(self, values, dims):
        self.values = np.asarray(values)
        self.dims = tuple(dims)
        self.dtype = self.values.dtype

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)


class _Dataset:
    def __init__(self, data):
        self.variables = {k: v if isinstance(v, _DataArray) else _DataArray(v[1], v[0])
                          for k, v in data.items()}

    def copy(self, deep=True):
        return _Dataset({k: _DataArray(v.values.copy(), v.dims)
                         for k, v in self.variables.items()})

    def __getitem__(self, key):
        return self.variables[key]

    def __setitem__(self, key, value):
        self.variables[key] = value


@pytest.fixture
def fake_xarray(monkeypatch):
    """An ``xarray`` module with just what the adapter touches; records every
    ``apply_ufunc`` call's keyword arguments."""
    calls = []

    def apply_ufunc(fn, *arrays, input_core_dims, output_core_dims, output_dtypes, dask):
        calls.append(dict(input_core_dims=[tuple(d) for d in input_core_dims],
                          output_core_dims=[tuple(d) for d in output_core_dims],
                          output_dtypes=[np.dtype(d) for d in output_dtypes], dask=dask))
        out = fn(*[a.values for a in arrays])
        if isinstance(out, tuple):
            return tuple(_DataArray(o, arrays[0].dims) for o in out)
        return _DataArray(out, arrays[0].dims)

    mod = types.ModuleType("xarray")
    mod.DataArray, mod.Dataset, mod.apply_ufunc = _DataArray, _Dataset, apply_ufunc
    mod.calls = calls
    monkeypatch.setitem(sys.modules, "xarray", mod)
    return mod


def _land_filters():
    wet = np.ones((16, 32))
    wet[0] = 0
    wet[5:8, 10:20] = 0
    return _pair(filter_scale=4.0, dx_min=1.0, grid_type=gj.GridType.REGULAR_WITH_LAND,
                 grid_vars={"wet_mask": wet})


# -- grid_ds -------------------------------------------------------------------

def test_grid_ds_is_a_dict_copy_without_xarray(monkeypatch):
    monkeypatch.setitem(sys.modules, "xarray", None)  # import xarray -> ImportError
    jf, tf = _land_filters()
    assert tfilter._maybe_xarray() is None
    got, want = tf.grid_ds, jf.grid_ds
    assert isinstance(got, dict) and isinstance(want, dict) and list(got) == list(want)
    assert got is not tf.grid_vars
    np.testing.assert_array_equal(np.asarray(got["wet_mask"]), np.asarray(want["wet_mask"]))


def test_grid_ds_is_a_dataset_with_xarray(fake_xarray):
    gv = unit_grid_vars(gj.GridType.VECTOR_B_GRID, (8, 16))
    gv["DXU"] = _DataArray(gv["DXU"], ("lat", "lon"))  # a user's own dim names are kept
    jf, tf = _pair(filter_scale=3.0, dx_min=1.0, grid_type=gj.GridType.VECTOR_B_GRID,
                   grid_vars=gv)
    got, want = tf.grid_ds, jf.grid_ds
    assert isinstance(got, _Dataset) and isinstance(want, _Dataset)
    assert list(got.variables) == list(want.variables) == list(gv)
    for k in gv:
        assert got[k].dims == want[k].dims == (("lat", "lon") if k == "DXU" else ("y", "x"))
        np.testing.assert_array_equal(got[k].values, want[k].values)


def test_maybe_xarray_rejects_a_bare_stub(monkeypatch):
    """A module named xarray without ``apply_ufunc`` (a harness's stub for
    isinstance checks) does not switch the adapter on, as in the JAX package."""
    from gcm_filters_tpu.filter import _maybe_xarray as j_maybe

    stub = types.ModuleType("xarray")
    stub.Dataset, stub.DataArray = _Dataset, _DataArray
    monkeypatch.setitem(sys.modules, "xarray", stub)
    assert tfilter._maybe_xarray() is None and j_maybe() is None
    jf, tf = _land_filters()
    assert isinstance(tf.grid_ds, dict) and isinstance(jf.grid_ds, dict)


def test_apply_never_attempts_an_xarray_import(monkeypatch):
    """``apply`` and ``apply_to_vector`` only look at an already loaded
    xarray: an import attempt on every call (it fails where xarray is
    missing) cost the host more than enqueueing the whole filter."""
    monkeypatch.delitem(sys.modules, "xarray", raising=False)
    monkeypatch.setattr(tfilter, "_maybe_xarray",
                        lambda: pytest.fail("apply tried to import xarray"))
    assert tfilter._loaded_xarray() is None
    _, tf = _land_filters()
    assert tf.apply(np.ones((16, 32))).shape == (16, 32)
    gv = unit_grid_vars(gj.GridType.VECTOR_B_GRID, (8, 16))
    vf = gt.Filter(filter_scale=3.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_B_GRID,
                   grid_vars=gv, device="cpu")
    assert vf.apply_to_vector(np.ones((8, 16)), np.ones((8, 16)))[0].shape == (8, 16)


# -- plot_shape ----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(filter_scale=10.0, dx_min=1.0),
    dict(filter_scale=40.0, dx_min=1.0),  # zooms to the transition band
    dict(filter_scale=8.0, dx_min=1.0, filter_shape="TAPER", transition_width=2.0),
], ids=["gaussian", "gaussian_zoom", "taper"])
def test_plot_shape_matches_jax(kw):
    """The same lines (data, labels, colours, styles), axis labels and limits
    as the JAX ``Filter``'s axes."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    jkw, tkw = dict(kw), dict(kw)
    if "filter_shape" in kw:
        jkw["filter_shape"] = gj.FilterShape[kw["filter_shape"]]
        tkw["filter_shape"] = gt.FilterShape[kw["filter_shape"]]
    jf, tf = gj.Filter(use_pallas=False, **jkw), gt.Filter(device="cpu", **tkw)
    _, own = plt.subplots()
    tax, jax_ = tf.plot_shape(ax=own), jf.plot_shape()
    try:
        assert tax is own
        assert len(tax.lines) == len(jax_.lines) == 3  # target, approximation, cutoff
        for got, want in zip(tax.lines, jax_.lines):
            assert got.get_label() == want.get_label()
            assert got.get_color() == want.get_color()
            assert got.get_linestyle() == want.get_linestyle()
            assert got.get_linewidth() == want.get_linewidth()
            np.testing.assert_allclose(np.asarray(got.get_xdata(), dtype=float),
                                       np.asarray(want.get_xdata(), dtype=float), rtol=1e-13)
            np.testing.assert_allclose(np.asarray(got.get_ydata(), dtype=float),
                                       np.asarray(want.get_ydata(), dtype=float),
                                       rtol=1e-12, atol=1e-14)
        assert f"n_steps={tf.n_steps}" in tax.lines[1].get_label()
        assert tax.get_xlim() == jax_.get_xlim() and tax.get_ylim() == jax_.get_ylim()
        assert tax.get_xlabel() == jax_.get_xlabel() == "wavenumber k"
        assert tax.get_ylabel() == jax_.get_ylabel() == "filter response"
        assert [t.get_text() for t in tax.get_legend().get_texts()] == \
            [t.get_text() for t in jax_.get_legend().get_texts()]
    finally:
        plt.close("all")


# -- the xarray adapter ----------------------------------------------------------

def test_xarray_dataarray_and_dataset_apply(fake_xarray):
    jf, tf = _land_filters()
    rng = np.random.default_rng(3)
    data = rng.random((3, 16, 32))
    da = _DataArray(data, ("time", "lat", "lon"))
    got, want = tf.apply(da, dims=("lat", "lon")), jf.apply(da, dims=("lat", "lon"))
    assert isinstance(got, _DataArray) and isinstance(got.values, np.ndarray)
    np.testing.assert_allclose(got.values, want.values, **TOL)
    np.testing.assert_allclose(got.values, tf.apply(data).numpy(), **TOL)

    ds = _Dataset({"sst": da, "depth": _DataArray(np.arange(3.0), ("time",)),
                   "mask": _DataArray(rng.random((16, 32)), ("lat", "lon"))})
    gds, wds = tf.apply(ds, dims=("lat", "lon")), jf.apply(ds, dims=("lat", "lon"))
    assert list(gds.variables) == list(wds.variables) == ["sst", "depth", "mask"]
    for k in ("sst", "mask"):
        np.testing.assert_allclose(gds[k].values, wds[k].values, **TOL)
    np.testing.assert_array_equal(gds["depth"].values, np.arange(3.0))
    assert not np.array_equal(ds["sst"].values, gds["sst"].values)  # a deep copy was filtered
    # both packages made the same apply_ufunc calls, in the same order
    calls = fake_xarray.calls
    assert len(calls) == 6 and calls[0] == calls[1] and calls[2:4] == calls[4:6]
    assert all(c["dask"] == "parallelized" and c["input_core_dims"] == [("lat", "lon")]
               for c in calls)


def test_xarray_errors_and_warnings_match(fake_xarray):
    jf, tf = _land_filters()
    da = _DataArray(np.ones((16, 32)), ("lat", "lon"))
    for f in (jf, tf):
        with pytest.raises(ValueError, match="xarray inputs require the `dims` argument"):
            f.apply(da)
        with pytest.raises(ValueError, match="exactly two spatial dimensions"):
            f.apply(da, dims=("lat",))
        with pytest.warns(UserWarning, match=r"dimensions \(\('y', 'x'\)\), so nothing"):
            out = f.apply(_Dataset({"a": da}), dims=("y", "x"))
        np.testing.assert_array_equal(out["a"].values, da.values)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_xarray_output_dtype(fake_xarray, dtype):
    """``output_dtypes`` is the filter's ``dtype`` option as a numpy dtype,
    else the DataArray's own."""
    wet = np.ones((8, 16))
    wet[0] = 0
    kw = dict(filter_scale=3.0, dx_min=1.0, grid_vars={"wet_mask": wet})
    jf = gj.Filter(use_pallas=False, grid_type=gj.GridType.REGULAR_WITH_LAND,
                   dtype=None if dtype is None else jnp.float32, **kw)
    tf = gt.Filter(device="cpu", grid_type=gt.GridType.REGULAR_WITH_LAND,
                   dtype=None if dtype is None else torch.float32, **kw)
    da = _DataArray(np.random.default_rng(0).random((8, 16)), ("y", "x"))
    got, want = tf.apply(da, dims=("y", "x")), jf.apply(da, dims=("y", "x"))
    jcall, tcall = fake_xarray.calls[-1], fake_xarray.calls[-2]
    assert tcall == jcall
    assert tcall["output_dtypes"] == [np.dtype(dtype or "float64")]
    assert got.values.dtype == want.values.dtype == np.dtype(dtype or "float64")


def test_xarray_apply_to_vector(fake_xarray):
    shape = (16, 32)
    jf, tf = _pair(filter_scale=4.0, dx_min=1.0, grid_type=gj.GridType.VECTOR_C_GRID,
                   grid_vars=unit_grid_vars(gj.GridType.VECTOR_C_GRID, shape, kappa_aniso=0.0))
    u, v = fields((2,) + shape, seed=5)
    du, dv = _DataArray(u, ("t", "y", "x")), _DataArray(v, ("t", "y", "x"))
    for f in (jf, tf):
        with pytest.raises(ValueError, match="xarray inputs require the `dims` argument"):
            f.apply_to_vector(du, dv)
    got = tf.apply_to_vector(du, dv, dims=("y", "x"))
    want = jf.apply_to_vector(du, dv, dims=("y", "x"))
    assert fake_xarray.calls[-2] == fake_xarray.calls[-1]
    assert fake_xarray.calls[-1]["input_core_dims"] == [("y", "x")] * 2
    plain = tf.apply_to_vector(u, v)
    for g, w, p in zip(got, want, plain):
        assert isinstance(g, _DataArray) and g.dims == ("t", "y", "x")
        np.testing.assert_allclose(g.values, w.values, **TOL)
        np.testing.assert_array_equal(g.values, p.numpy())


# -- utils/profiling -------------------------------------------------------------

def test_benchmark_fn_on_the_cpu():
    """The JAX function's contract: warm-up calls untimed, ``iters`` timed
    calls, the last result returned; CPU tensors are timed on the host clock."""
    calls = {"t": 0, "j": 0}
    x = np.random.default_rng(1).random((32, 32))

    def t_fn(a):
        calls["t"] += 1
        return (a @ a).sum()

    def j_fn(a):
        calls["j"] += 1
        return (a @ a).sum()

    dt, res = tprof.benchmark_fn(t_fn, torch.as_tensor(x), warmup=1, iters=4)
    jdt, jres = jprof.benchmark_fn(j_fn, jnp.asarray(x), warmup=1, iters=4)
    assert calls == {"t": 5, "j": 5}
    assert isinstance(dt, float) and dt > 0 and jdt > 0
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-12)
    # the package exports it as the JAX package does
    from gcm_filters_tpu_torch.utils import benchmark_fn

    assert benchmark_fn is tprof.benchmark_fn


def test_benchmark_fn_sees_where_the_work_lies():
    cpu = torch.ones(2)
    assert not tprof._on_cuda((cpu, {"a": [cpu, 3]}))
    meta = types.SimpleNamespace()
    assert not tprof._on_cuda(meta)

    class OnCard(torch.Tensor):  # is_cuda without a card
        is_cuda = True

    fake = cpu.as_subclass(OnCard)
    assert tprof._on_cuda([1, {"x": (fake,)}])


def test_roofline_and_bound():
    # the JAX helper with the same bandwidth gives the same share
    assert tprof.roofline(1e-3, 10**9, hbm_gbps=819.0) == jprof.roofline(1e-3, 10**9, 819.0)
    assert tprof.roofline(1e-3, 3.35e9) == pytest.approx(1.0)
    ms, by = tprof.bound_ms(3.35e9, 1e6, "float32")
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = tprof.bound_ms(1e3, 34e9, "float64")
    assert ms == pytest.approx(1.0) and by == "operations"
    with pytest.raises(KeyError):
        tprof.bound_ms(1.0, 1.0, "bfloat16")


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as where:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == str(tmp_path / "tr")
    text = (tmp_path / "tr" / "trace.json").read_text()
    assert "traceEvents" in text
