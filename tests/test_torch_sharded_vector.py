"""The port's sharded vector engine on 4 gloo ranks against the JAX package.

``Filter(grid_type=VECTOR_B_GRID | VECTOR_C_GRID, mesh=...,
spatial_axes=...).apply_to_vector`` of the port runs on a 4-rank CPU
``DeviceMesh`` (gloo) of each shape, one spawn per mesh shape serving every
case, as tests/test_torch_sharded.py does for scalars (its ``spawn_ranks``
starts this very file as the rank script; run that way it imports the port
only, never JAX). Inputs are made here from numpy seeds and travel as
``.npz``; the parent computes the JAX answers on the same inputs: the
unsharded ``Filter(use_pallas=False)`` and the sharded ``Filter(use_pallas=True,
mesh=...)``, whose per-shard coupled Pallas pass runs in interpret mode on the
CPU as tests/test_sharded.py runs it (and must really have run: its jitted
function was built and no fallback was recorded).

The fields are random and not symmetric under transposition, so a wrong halo
corner shows: the C-grid taps ``DU_se`` and ``DV_nw`` read the corner cells
from the first step of a round on (with ``halo_steps=1``, every step).

Tolerances: float64 rtol 1e-10 / atol 1e-12 (the bar of tests/test_sharded.py:
the same arithmetic, cells summed in another order, taps against the staged
C-grid form), float32 rtol 2e-5 / atol 2e-6 (tests/test_pallas.py).
"""
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from test_torch_sharded import MESHES, TOL, spawn_ranks

GRIDS = ("VECTOR_B_GRID", "VECTOR_C_GRID")
SHAPE = (64, 128)


def _cases(mesh_key):
    """name -> case. ``data``: 'spherical' (the fixture construction of
    conftest.make_vector_grid_data) or 'unit' (unit-scale metrics, where
    float32 is a real test); ``nan`` plants a NaN in u and one in v; ``ref``
    names the JAX answers the result is held to."""
    both = ["unsharded", "sharded_pallas"]
    unit = dict(data="unit", kappa_aniso=0.0)
    if mesh_key == "2x1x2":
        return {f"batch_axis-{g}": dict(grid=g, scale=4.0, batch=4, batch_axis="b",
                                        ref=both, **unit) for g in GRIDS}
    cases = {}
    for g in GRIDS:
        cases[f"spherical-{g}"] = dict(grid=g, data="spherical", scale=6.0, ref=both)
        for hs in (1, 3, None):
            cases[f"unit-{g}-halo{hs}"] = dict(grid=g, scale=6.0, halo_steps=hs, ref=both, **unit)
        cases[f"float32-{g}"] = dict(grid=g, scale=6.0, cast=["float32", "float32"],
                                     ref=both, **unit)
        cases[f"batch-{g}"] = dict(grid=g, scale=4.0, batch=3, halo_steps=3, ref=both, **unit)
        cases[f"nan-{g}"] = dict(grid=g, scale=6.0, nan=True, halo_steps=3, ref=both, **unit)
    cases["mixed_dtypes"] = dict(grid=GRIDS[0], scale=5.0, cast=["float32", "float64"],
                                 ref=both, **unit)
    cases["integer"] = dict(grid=GRIDS[1], scale=4.0, cast=["int32", "int32"], ref=both, **unit)
    cases["dtensor_input"] = dict(grid=GRIDS[1], scale=6.0, as_dtensor=True, ref=both, **unit)
    cases["streamed"] = dict(grid=GRIDS[1], scale=4.0, batch=3, streamed=True, halo_steps=2,
                             ref=["unsharded"], **unit)
    # a C-grid operator that does not scrub NaNs: the NaN must spread through
    # the sharded rounds exactly as through the unsharded engine
    cases["zap_nans_false"] = dict(grid=GRIDS[1], data="spherical", scale=6.0, nan=True,
                                   zap_nans=False, ref=["unsharded_engine"])
    return cases


# --------------------------------------------------------------------------
# the rank process: imports the port only
# --------------------------------------------------------------------------

def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    import gcm_filters_tpu_torch as gt
    from gcm_filters_tpu_torch.parallel.sharded import _placements

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    shape, names = MESHES[mesh_key]
    sizes = dict(zip(names, shape))
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    arrays = np.load(os.path.join(workdir, "inputs.npz"))
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    out, report = {}, {}

    for name, case in cases.items():
        gv = {k[len(name) + 4:]: arrays[k] for k in arrays.files if k.startswith(name + "/gv/")}
        u, v = arrays[name + "/u"], arrays[name + "/v"]
        kw = dict(filter_scale=case["scale"], dx_min=1.0, device="cpu", mesh=mesh,
                  spatial_axes=("y", "x"), batch_axis=case.get("batch_axis"),
                  halo_steps=case.get("halo_steps"))
        filt = gt.Filter(grid_type=gt.GridType[case["grid"]], grid_vars=gv, **kw)
        if case.get("zap_nans") is False:
            filt = gt.Filter(custom_operator=dataclasses.replace(filt.operator, zap_nans=False),
                             **kw)
        if case.get("streamed"):
            out[name + "/u"], out[name + "/v"] = filt.apply_to_vector_streamed(u, v, chunk=2)
            continue
        if case.get("as_dtensor"):
            u, v = (distribute_tensor(torch.as_tensor(a), mesh,
                                      _placements(mesh, a.ndim, ("y", "x"), None)) for a in (u, v))
        res = filt.apply_to_vector(u, v)
        want_local = list(arrays[name + "/u"].shape)
        want_local[-2] //= sizes["y"]
        want_local[-1] //= sizes["x"]
        if case.get("batch_axis"):
            want_local[0] //= sizes[case["batch_axis"]]
        for comp, r in zip("uv", res):
            assert isinstance(r, DTensor) and tuple(r.shape) == tuple(arrays[name + "/u"].shape)
            assert list(r.to_local().shape) == want_local, (r.to_local().shape, want_local)
            out[f"{name}/{comp}"] = r.full_tensor().numpy()

    if len(shape) == 2:
        # shapes the mesh cannot take raise on every rank, before any message
        g = GRIDS[0]
        gv = {k[len(f"unit-{g}-haloNone") + 4:]: arrays[k] for k in arrays.files
              if k.startswith(f"unit-{g}-haloNone/gv/")}
        filt = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[g], grid_vars=gv,
                         device="cpu", mesh=mesh, spatial_axes=("y", "x"))
        for label, args, match in (
            ("shape_mismatch", (np.zeros(SHAPE), np.zeros((2,) + SHAPE)), "same shape"),
            ("wrong_grid_shape", (np.zeros((32, 32)), np.zeros((32, 32))), "does not match the grid"),
        ):
            try:
                filt.apply_to_vector(*args)
                report[label] = False
            except ValueError as e:
                report[label] = match in str(e)
        odd = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[g],
                        grid_vars={k: a[:63, :127] for k, a in gv.items()},
                        device="cpu", mesh=mesh, spatial_axes=("y", "x"))
        try:
            odd.apply_to_vector(np.zeros((63, 127)), np.zeros((63, 127)))
            report["indivisible"] = False
        except ValueError as e:
            report["indivisible"] = "does not divide" in str(e)

    np.savez(os.path.join(workdir, f"report{rank}.npz"),
             **{k: np.asarray(v) for k, v in report.items()})
    if rank == 0:
        np.savez(os.path.join(workdir, "outputs.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# the parent: pytest, with JAX for the answers
# --------------------------------------------------------------------------

import pytest  # noqa: E402


def _inputs(case):
    from conftest import make_vector_grid_data
    from gcm_filters_tpu import GridType
    from test_torch_vec_pass import fields, unit_grid_vars

    grid = GridType[case["grid"]]
    if case["data"] == "spherical":
        _, (u, v), gv = make_vector_grid_data(grid, SHAPE)
        u, v = np.array(u), np.array(v)
    else:
        gv = unit_grid_vars(grid, SHAPE, kappa_aniso=case["kappa_aniso"])
        u, v = fields(SHAPE, seed=13)
    if case.get("nan"):
        u[10, 20] = np.nan
        v[50, 7] = np.nan
    if case.get("batch"):
        u = np.stack([u * (0.5 + i) + i for i in range(case["batch"])])
        v = np.stack([v * (1.5 - 0.25 * i) - i for i in range(case["batch"])])
    if case.get("cast"):
        cu, cv = case["cast"]
        if cu == "int32":
            u, v = u * 100, v * 100
        u, v = u.astype(cu), v.astype(cv)
    return u, v, gv


_JAX = {}


def _jax_answer(ref, name, case, u, v, gv):
    """One JAX answer on the case's inputs, computed once and held against
    the port's result on every mesh shape. The sharded one runs on a 2x2 JAX
    mesh (2x1x2 with a batch axis) of the 8 virtual CPU devices, with the
    coupled Pallas pass in interpret mode as its local compute."""
    if (ref, name) in _JAX:
        return _JAX[ref, name]
    import jax
    from jax.sharding import Mesh

    from gcm_filters_tpu import Filter, GridType
    from gcm_filters_tpu.engine import vector_filter_apply
    from gcm_filters_tpu.utils.telemetry import fallback_counts, reset_fallback_counts

    kw = dict(filter_scale=case["scale"], dx_min=1.0, grid_type=GridType[case["grid"]],
              grid_vars=gv)
    if ref == "unsharded_engine":
        base = Filter(use_pallas=False, **kw)
        op = dataclasses.replace(base.operator, zap_nans=case.get("zap_nans", True))
        got = vector_filter_apply(op, base.filter_spec, u, v)
    elif ref == "sharded_pallas":
        shape, names = MESHES["2x1x2" if case.get("batch_axis") else "2x2"]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names)
        filt = Filter(use_pallas=True, mesh=mesh, spatial_axes=("y", "x"),
                      batch_axis=case.get("batch_axis"),
                      halo_steps=case.get("halo_steps"), **kw)
        reset_fallback_counts()
        got = filt.apply_to_vector(u, v)
        fn = filt._vector_fn()
        assert fn._pl_jit and not fn._fb and not fn._pinned, \
            "the JAX side did not run its Pallas local compute"
        assert fallback_counts() == {}
    else:
        got = Filter(use_pallas=False, **kw).apply_to_vector(u, v)
    _JAX[ref, name] = tuple(np.asarray(a) for a in got)
    return _JAX[ref, name]


_SPAWNED = {}


def _spawn(mesh_key, tmp_path_factory):
    """Run every case of one mesh shape on 4 gloo ranks, once per test run."""
    if mesh_key not in _SPAWNED:
        workdir = str(tmp_path_factory.mktemp(f"sharded_vector_{mesh_key}"))
        cases = _cases(mesh_key)
        arrays, inputs = {}, {}
        for name, case in cases.items():
            u, v, gv = _inputs(case)
            inputs[name] = (u, v, gv)
            arrays[name + "/u"], arrays[name + "/v"] = u, v
            for k, a in gv.items():
                arrays[f"{name}/gv/{k}"] = a
        np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
        with open(os.path.join(workdir, "cases.json"), "w") as f:
            json.dump(cases, f)
        outputs, reports = spawn_ranks(os.path.abspath(__file__), workdir, mesh_key)
        _SPAWNED[mesh_key] = (cases, inputs, outputs, reports)
    return _SPAWNED[mesh_key]


@pytest.mark.parametrize("mesh_key,name",
                         [(key, name) for key in MESHES for name in _cases(key)])
def test_sharded_vector_matches_jax(tmp_path_factory, mesh_key, name):
    cases, inputs, outputs, _ = _spawn(mesh_key, tmp_path_factory)
    case = cases[name]
    u, v, gv = inputs[name]
    got = outputs[name + "/u"], outputs[name + "/v"]
    for ref in case["ref"]:
        want = _jax_answer(ref, name, case, u, v, gv)
        for comp, g, w in zip("uv", got, want):
            tag = f"{ref} {comp}"
            assert g.shape == w.shape and g.dtype == w.dtype, (tag, g.dtype, w.dtype)
            assert np.array_equal(np.isnan(g), np.isnan(w)), tag
            np.testing.assert_allclose(g, w, equal_nan=True, err_msg=tag, **TOL[str(w.dtype)])
            ok = ~np.isnan(w)
            print(f"{mesh_key} {name} {tag}: max abs {np.abs(g[ok] - w[ok]).max():.2e} "
                  f"on values up to {np.abs(w[ok]).max():.3g}")
    if case.get("nan"):
        assert np.isnan(got[0][10, 20]) and np.isnan(got[1][50, 7])
        n_nan = int(np.isnan(got[0]).sum())
        # scrubbed, the NaN stays one cell; unscrubbed, it really spreads
        assert n_nan > 1 if case.get("zap_nans") is False else n_nan == 1


@pytest.mark.parametrize("check", ["shape_mismatch", "wrong_grid_shape", "indivisible"])
@pytest.mark.parametrize("mesh_key", [k for k, (shape, _) in MESHES.items() if len(shape) == 2])
def test_rank_checks(tmp_path_factory, mesh_key, check):
    """Errors each rank raises on its own, before any message is posted."""
    reports = _spawn(mesh_key, tmp_path_factory)[3]
    assert [bool(r[check]) for r in reports] == [True] * 4
