"""The port's sharded scalar engine on 4 gloo ranks against the JAX package.

``Filter(mesh=..., spatial_axes=...)`` of the port runs on a 4-rank CPU
``DeviceMesh`` (gloo) of each shape, one spawn per mesh shape serving every
case. The ranks are processes started from this very file (``python
tests/test_torch_sharded.py <rank> ...``); run that way it imports the port
only, never JAX. Inputs are made here from numpy seeds and travel as ``.npz``;
the parent computes the JAX answers on the same inputs: the unsharded
``Filter(use_pallas=False)`` and the sharded ``Filter(use_pallas=True,
mesh=...)``, whose per-shard Pallas kernel runs in interpret mode on the CPU
as tests/test_sharded.py runs it.

Tolerances: float64 rtol 1e-10 / atol 1e-12 (the bar of tests/test_sharded.py:
the same arithmetic, cells summed in another order across block edges),
float32 rtol 2e-5 / atol 2e-6 (tests/test_pallas.py).
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

MESHES = {"2x2": ((2, 2), ("y", "x")), "1x4": ((1, 4), ("y", "x")),
          "4x1": ((4, 1), ("y", "x")), "2x1x2": ((2, 1, 2), ("b", "y", "x"))}
SPAWN_TIMEOUT_S = 240
TOL = {"float64": dict(rtol=1e-10, atol=1e-12), "float32": dict(rtol=2e-5, atol=2e-6)}
TRI = "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED"
SCALAR_GRIDS = ["REGULAR", "REGULAR_AREA_WEIGHTED", "REGULAR_WITH_LAND",
                "REGULAR_WITH_LAND_AREA_WEIGHTED", "IRREGULAR_WITH_LAND", TRI,
                "TRIPOLAR_POP_WITH_LAND"]


def _cases(mesh_key):
    """name -> case. ``data``: 'grid' (the scalar_grid_data construction) or
    'seam' (tripolar_grid_data: uniform metrics, seed 30); ``nan`` plants a
    land and a wet NaN; ``ref`` names the JAX answers the result is held to."""
    both = ["unsharded", "sharded_pallas"]
    if mesh_key == "2x1x2":
        return {f"batch_axis-{g}": dict(grid=g, data="seam", scale=4.0, batch=4,
                                        batch_axis="b", ref=both)
                for g in (TRI, "TRIPOLAR_POP_WITH_LAND")}
    cases = {f"grid-{g}": dict(grid=g, data="grid", scale=6.0, ref=both) for g in SCALAR_GRIDS}
    for g in (TRI, "TRIPOLAR_POP_WITH_LAND"):
        for hs in (1, 3, 16, None):
            cases[f"seam-{g}-halo{hs}"] = dict(grid=g, data="seam", scale=6.0,
                                               halo_steps=hs, ref=both)
    cases["batch"] = dict(grid=TRI, data="seam", scale=4.0, batch=3, halo_steps=3, ref=both)
    cases["dtensor_input"] = dict(grid=TRI, data="grid", scale=6.0, as_dtensor=True, ref=both)
    cases["float32"] = dict(grid="IRREGULAR_WITH_LAND", data="grid", scale=4.0,
                            cast="float32", ref=both)
    cases["integer"] = dict(grid=TRI, data="grid", scale=4.0, cast="int32", ref=both)
    for g in (TRI, "REGULAR_WITH_LAND"):
        cases[f"exact_nan-{g}"] = dict(grid=g, data="grid", scale=6.0, exact_nan=True,
                                       nan=True, halo_steps=3, ref=both)
    # h-space NaN semantics differ from the eager engine's around a wet NaN,
    # so only the Pallas answers apply
    cases["nan_hspace"] = dict(grid=TRI, data="grid", scale=6.0, nan=True,
                               ref=["unsharded_pallas", "sharded_pallas"])
    return cases


# --------------------------------------------------------------------------
# the rank process: imports the port only
# --------------------------------------------------------------------------

def _halo_model(g, s, k):
    """The (ny+2k, nx+2k) halo extension of a global folded array in numpy:
    periodic in x and south, the top k rows of ``s`` flipped in y and x north."""
    gx = np.concatenate([g[:, -k:], g, g[:, :k]], axis=1)
    sx = np.concatenate([s[:, -k:], s, s[:, :k]], axis=1)
    return np.concatenate([gx[-k:], gx, sx[-k:][::-1, ::-1]], axis=0)


def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    import gcm_filters_tpu_torch as gt
    from gcm_filters_tpu_torch.parallel import halo
    from gcm_filters_tpu_torch.parallel.sharded import _mesh_axis, _placements

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    shape, names = MESHES[mesh_key]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    arrays = np.load(os.path.join(workdir, "inputs.npz"))
    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    out, report = {}, {}

    for name, case in cases.items():
        gv = {k[len(name) + 4:]: arrays[k] for k in arrays.files if k.startswith(name + "/gv/")}
        x = arrays[name + "/x"]
        filt = gt.Filter(filter_scale=case["scale"], dx_min=1.0,
                         grid_type=gt.GridType[case["grid"]], grid_vars=gv, device="cpu",
                         mesh=mesh, spatial_axes=("y", "x"),
                         batch_axis=case.get("batch_axis"),
                         halo_steps=case.get("halo_steps"),
                         exact_nan=case.get("exact_nan", False))
        if case.get("as_dtensor"):
            x = distribute_tensor(torch.as_tensor(x), mesh,
                                  _placements(mesh, x.ndim, ("y", "x"), None))
        res = filt.apply(x)
        assert isinstance(res, DTensor) and tuple(res.shape) == tuple(arrays[name + "/x"].shape)
        sizes = dict(zip(names, shape))
        want_local = list(res.shape)
        want_local[-2] //= sizes["y"]
        want_local[-1] //= sizes["x"]
        if case.get("batch_axis"):
            want_local[0] //= sizes[case["batch_axis"]]
        assert list(res.to_local().shape) == want_local, (res.to_local().shape, want_local)
        out[name] = res.full_tensor().numpy()

    if len(shape) == 2:
        # exchange_2d across real ranks against the numpy model, fold and
        # fold_src included, leading dims riding along
        y_axis, x_axis = _mesh_axis(mesh, "y"), _mesh_axis(mesh, "x")
        iy, ix = mesh.get_local_rank("y"), mesh.get_local_rank("x")
        g, s, k = arrays["halo/g"], arrays["halo/s"], 3
        ly, lx = g.shape[-2] // shape[0], g.shape[-1] // shape[1]
        blk = lambda a: torch.as_tensor(  # noqa: E731
            a[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx].copy())
        for label, fold, src in (("periodic", False, None), ("fold", True, None),
                                 ("fold_src", True, s)):
            got = halo.exchange_2d(blk(g), k, y_axis, x_axis, fold,
                                   None if src is None else blk(src)).numpy()
            model = np.stack([_halo_model(gi, gi if src is None else si, k)
                              for gi, si in zip(g, s)])
            if not fold:
                model[:, -k:] = model[:, k:2 * k]  # periodic north: the first real rows
            want = model[:, iy * ly:iy * ly + ly + 2 * k, ix * lx:ix * lx + lx + 2 * k]
            report[f"halo-{label}"] = bool(np.array_equal(got, want))
        # the one-row primitives against global rolls
        g0 = g[0]
        north = np.roll(g0, -1, 0)
        north[-1] = g0[-1, ::-1]
        for label, got, want in (
            ("shifted-south", halo.shifted(blk(g0), +1, -2, y_axis), np.roll(g0, 1, 0)),
            ("shifted-east", halo.shifted(blk(g0), -1, -1, x_axis), np.roll(g0, -1, 1)),
            ("north-fold", halo.north_neighbor_sharded(blk(g0), True, y_axis, x_axis), north),
        ):
            report[f"halo-{label}"] = bool(np.array_equal(got.numpy(), blk(want).numpy()))

        # a spatial size that does not divide over the mesh raises on every rank
        bad = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", mesh=mesh,
                        spatial_axes=("y", "x"))
        try:
            bad.apply(np.zeros((31, 31)))
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
    from conftest import make_mask_data, make_random_data, make_scalar_grid_data
    from gcm_filters_tpu import GridType
    from gcm_filters_tpu.models.grids import GRID_VAR_NAMES

    grid = GridType[case["grid"]]
    if case["data"] == "grid":
        _, x, gv = make_scalar_grid_data(grid)
    else:
        shape = (128, 256)
        x = make_random_data(shape, 30)
        gv = {n: make_mask_data(shape) if n == "wet_mask" else np.ones(shape)
              for n in GRID_VAR_NAMES[grid]}
    x = x.copy()
    if case.get("nan"):
        x[0, 7] = np.nan      # land (the Antarctica row)
        x[100, 200] = np.nan  # wet
    if case.get("batch"):
        x = np.stack([x * (0.5 + i) + i for i in range(case["batch"])])
    if case.get("cast") == "int32":
        x = (x * 100).astype(np.int32)
    elif case.get("cast"):
        x = x.astype(case["cast"])
    return x, gv


_JAX = {}


def _jax_answer(ref, name, case, x, gv):
    """One JAX answer on the case's inputs, computed once and held against
    the port's result on every mesh shape. The sharded one runs on a 2x2 JAX
    mesh (2x1x2 with a batch axis) of the 8 virtual CPU devices."""
    if (ref, name) in _JAX:
        return _JAX[ref, name]
    import jax
    from jax.sharding import Mesh

    from gcm_filters_tpu import Filter, GridType

    kw = dict(filter_scale=case["scale"], dx_min=1.0, grid_type=GridType[case["grid"]],
              grid_vars=gv, exact_nan=case.get("exact_nan", False))
    if ref == "sharded_pallas":
        shape, names = MESHES["2x1x2" if case.get("batch_axis") else "2x2"]
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), names)
        filt = Filter(use_pallas=True, mesh=mesh, spatial_axes=("y", "x"),
                      batch_axis=case.get("batch_axis"),
                      halo_steps=case.get("halo_steps"), **kw)
    else:
        filt = Filter(use_pallas=ref == "unsharded_pallas", **kw)
    _JAX[ref, name] = np.asarray(filt.apply(x))
    return _JAX[ref, name]


_SPAWNED = {}


def _spawn(mesh_key, tmp_path_factory):
    """Run every case of one mesh shape on 4 gloo ranks, once per test run."""
    if mesh_key not in _SPAWNED:
        _SPAWNED[mesh_key] = _run_ranks(mesh_key, tmp_path_factory)
    return _SPAWNED[mesh_key]


def spawn_ranks(script, workdir, mesh_key):
    """Run ``python <script> <rank> 4 <workdir> <mesh_key>`` for the 4 ranks
    under a hard timeout; return rank 0's outputs and every rank's report."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, script, str(r), "4",
                               workdir, mesh_key], stdout=logs[r], stderr=subprocess.STDOUT,
                              env=env, cwd=workdir)
             for r in range(4)]
    try:
        # a hard limit: a deadlocked exchange fails the tests instead of hanging
        codes = [p.wait(timeout=SPAWN_TIMEOUT_S) for p in procs]
    except subprocess.TimeoutExpired:
        codes = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    tails = "\n".join(open(os.path.join(workdir, f"rank{r}.log")).read()[-2000:]
                      for r in range(4))
    assert codes is not None, f"ranks did not finish in {SPAWN_TIMEOUT_S} s:\n{tails}"
    assert codes == [0] * 4, f"rank exit codes {codes}:\n{tails}"
    outputs = dict(np.load(os.path.join(workdir, "outputs.npz")))
    reports = [dict(np.load(os.path.join(workdir, f"report{r}.npz"))) for r in range(4)]
    return outputs, reports


def _run_ranks(mesh_key, tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp(f"sharded_{mesh_key}"))
    cases = _cases(mesh_key)
    arrays, inputs = {}, {}
    for name, case in cases.items():
        x, gv = _inputs(case)
        inputs[name] = (x, gv)
        arrays[name + "/x"] = x
        for k, v in gv.items():
            arrays[f"{name}/gv/{k}"] = v
    rng = np.random.default_rng(17)
    arrays["halo/g"] = rng.random((2, 16, 24))
    arrays["halo/s"] = rng.random((2, 16, 24))
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    with open(os.path.join(workdir, "cases.json"), "w") as f:
        json.dump(cases, f)

    outputs, reports = spawn_ranks(os.path.abspath(__file__), workdir, mesh_key)
    return mesh_key, cases, inputs, outputs, reports


@pytest.mark.parametrize("mesh_key,name",
                         [(key, name) for key in MESHES for name in _cases(key)])
def test_sharded_matches_jax(tmp_path_factory, mesh_key, name):
    _, cases, inputs, outputs, _ = _spawn(mesh_key, tmp_path_factory)
    case = cases[name]
    x, gv = inputs[name]
    got = outputs[name]
    for ref in case["ref"]:
        want = _jax_answer(ref, name, case, x, gv)
        assert got.shape == want.shape and got.dtype == want.dtype, (ref, got.dtype, want.dtype)
        assert np.array_equal(np.isnan(got), np.isnan(want)), ref
        if case.get("nan"):
            assert np.isnan(got[0, 7]) and np.isnan(got[100, 200])
        np.testing.assert_allclose(got, want, equal_nan=True, err_msg=ref,
                                   **TOL[str(want.dtype)])


@pytest.mark.parametrize("check", ["halo-periodic", "halo-fold", "halo-fold_src",
                                   "halo-shifted-south", "halo-shifted-east",
                                   "halo-north-fold", "indivisible"])
@pytest.mark.parametrize("mesh_key", [k for k, (shape, _) in MESHES.items() if len(shape) == 2])
def test_rank_checks(tmp_path_factory, mesh_key, check):
    """Checks each rank makes on its own block: the exchanges against the
    numpy model of the decomposition, and the indivisible-shape error."""
    reports = _spawn(mesh_key, tmp_path_factory)[4]
    assert [bool(r[check]) for r in reports] == [True] * 4
