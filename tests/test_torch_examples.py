"""The port's examples (``examples/torch_*.py``) run on the CPU and agree
with the JAX package.

Each example is loaded with ``runpy.run_path`` and its ``main`` called with
``device="cpu"`` (a smaller ``shape`` where the example's own size would
take the plain PyTorch path too long). The test asserts the checks the
example prints and holds at least one of its outputs against
``gcm_filters_tpu.Filter`` on the same inputs, which ``main`` returns:
float64 results at rtol 1e-7 (the parity bar), float32 results at rtol 1e-5
/ atol 1e-6 (the goldens' bar). Run as a script without ``--device``, every
example asks for the card and raises where torch finds none.
"""
import ast
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj

EX_DIR = os.path.join(os.path.dirname(__file__), "..", "examples")
EXAMPLES = ["torch_filter_types.py", "torch_tripole_grid.py",
            "torch_satellite_observations.py", "torch_viscosity_filter.py",
            "torch_sharded_filtering.py", "torch_gpu_filtering.py"]
F64 = dict(rtol=1e-7, atol=1e-14)
F32 = dict(rtol=1e-5, atol=1e-6)


def _main(name):
    return runpy.run_path(os.path.join(EX_DIR, name))["main"]


def _jax(field, **kw):
    """``field`` filtered by the JAX package's filter of ``kw``, whose enums
    may be the port's (matched by name)."""
    for key, enum in (("grid_type", gj.GridType), ("filter_shape", gj.FilterShape)):
        if key in kw:
            kw[key] = enum[kw[key].name]
    return np.asarray(gj.Filter(**kw).apply(field))


def test_filter_types():
    mod = runpy.run_path(os.path.join(EX_DIR, "torch_filter_types.py"))
    res = mod["main"](device="cpu")
    kwargs = mod["filter_kwargs"](res["wet"], mod["make_inputs"]((256, 512))[2])
    for name, r in res["results"].items():
        assert r["var_out"] < 0.05 * r["var_in"], name
        want = _jax(res["data"], **kwargs[name])
        assert r["out"].dtype == want.dtype == np.float64
        np.testing.assert_allclose(r["out"], want, err_msg=name, **F64)


def test_tripole_grid():
    res = _main("torch_tripole_grid.py")(device="cpu")
    gv = {"area": res["tarea"], "wet_mask": res["wet"]}
    kw = dict(filter_scale=8.0, dx_min=1.0,
              grid_type=gj.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED, grid_vars=gv)
    for name in ("simple", "pop"):
        assert res[name]["across"] > 0 and res[name]["mass_err"] < 1e-12, name
    np.testing.assert_allclose(res["simple"]["out"], _jax(res["spike"], **kw), **F64)
    sh = res["sharded"]
    assert sh["data"].dtype == sh["sharded"].dtype == np.float32
    np.testing.assert_allclose(sh["sharded"], sh["single"], **F32)
    np.testing.assert_allclose(sh["sharded"], _jax(sh["data"], **kw), **F32)


def test_satellite_observations():
    res = _main("torch_satellite_observations.py")(device="cpu", shape=(120, 360), nt=3)
    m = res["means"]
    assert m["eke"] > 0 and m["mke"] < m["ke"]
    np.testing.assert_allclose(m["mke"] + m["eke"], res["ke_bar"][:, res["wet"] == 1].mean(),
                               rtol=1e-12)
    dx, dy = res["dx"], res["dy"]
    gv = {"wet_mask": res["wet"], "dxw": dx, "dyw": dy, "dxs": dx, "dys": dy,
          "area": res["area"], "kappa_w": np.ones_like(dx), "kappa_s": np.ones_like(dx)}
    want = _jax(np.nan_to_num(res["u"]) * res["wet"], filter_scale=600e3,
                dx_min=float(dx.min()), grid_type=gj.GridType.IRREGULAR_WITH_LAND, grid_vars=gv)
    assert res["u_bar"].shape == want.shape == res["u"].shape
    np.testing.assert_allclose(res["u_bar"], want, **F64)


def test_viscosity_filter():
    res = _main("torch_viscosity_filter.py")(device="cpu")
    assert max(res["solid_body_dev"]) < 1e-12
    for comp in ("u", "v"):
        before, after = res["var"][comp]
        assert after < 0.6 * before, comp
    filt = gj.Filter(filter_scale=4 * res["dx_min"], dx_min=res["dx_min"],
                     grid_type=gj.GridType.VECTOR_C_GRID, grid_vars=res["grid_vars"])
    want_u, want_v = (np.asarray(a) for a in filt.apply_to_vector(res["u"], res["v"]))
    np.testing.assert_allclose(res["fu"], want_u, **F64)
    np.testing.assert_allclose(res["fv"], want_v, **F64)


def test_sharded_filtering():
    res = _main("torch_sharded_filtering.py")(device="cpu")
    mesh, ring = res["mesh"], res["ring"]
    # a 1x1 mesh sums the fold's seam row in another order: within roundoff
    assert mesh["max_err"] < 1e-12
    # the ring takes the same steps as the unsharded path, bit for bit
    assert ring["max_err"] == 0.0
    np.testing.assert_array_equal(ring["sharded"], ring["single"])
    kw = dict(filter_scale=10.0, dx_min=1.0,
              grid_type=gj.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED)
    np.testing.assert_allclose(mesh["sharded"], _jax(mesh["data"], grid_vars=mesh["grid_vars"],
                                                     **kw), **F64)
    assert ring["sharded"].dtype == np.float32
    np.testing.assert_allclose(ring["sharded"], _jax(ring["data"], grid_vars=ring["grid_vars"],
                                                     **kw), **F32)


def test_gpu_filtering():
    res = _main("torch_gpu_filtering.py")(device="cpu", shape=(240, 360), iters=1)
    assert res["land_nan"] and res["ocean_finite"] and res["ms"] > 0
    want = _jax(res["sst"], filter_scale=10.0, dx_min=1.0,
                grid_type=gj.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                grid_vars={"area": res["area"], "wet_mask": res["wet"]}, dtype=jnp.float32)
    assert res["out"].dtype == want.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(res["out"]), np.isnan(want))
    np.testing.assert_allclose(res["out"], want, equal_nan=True, **F32)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_only_the_port(name):
    """An example imports the port, torch, numpy and the standard library:
    never JAX nor the JAX package."""
    with open(os.path.join(EX_DIR, name)) as f:
        tree = ast.parse(f.read())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            imported.add(node.module.split(".")[0])
    assert "gcm_filters_tpu_torch" in imported
    assert not imported & {"jax", "jaxlib", "gcm_filters_tpu"}, imported
    assert imported <= {"gcm_filters_tpu_torch", "torch", "numpy"} | sys.stdlib_module_names


@pytest.mark.parametrize("name", EXAMPLES)
def test_script_asks_for_the_card(name, monkeypatch):
    """Run as a script with no arguments, an example filters on the card;
    without one it raises the port's error rather than falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the script would run on it")
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_path(os.path.join(EX_DIR, name), run_name="__main__")
