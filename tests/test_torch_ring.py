"""The port's ring engine (parallel/ring.py) on the CPU, through the plain
versions of its step kernels.

Three bars, all float32 (the ring computes in 4-byte elements):

- against the port's own unsharded plain path (``make_cuda_scalar_apply`` /
  ``make_cuda_vector_apply`` on CPU tensors): ``assert_array_equal``. Every
  cell sees the values the whole field's periodic or folded neighbourhood
  holds and the same torch ops run on them, so not one bit may differ;
- against the JAX ring on the virtual CPU mesh (interpret mode, built as
  tests/test_ring.py builds it) and against the JAX unsharded Pallas-interpret
  apply, at shapes the JAX ring takes (``nx`` a multiple of 128): rtol 2e-5 /
  atol 2e-6, the float32 tolerance of tests/test_pallas.py (the same
  recurrence summed in another order, with other FMA contraction). The C-grid
  at ``kappa_aniso=1`` amplifies on unit metrics to O(10) values: atol 2e-5,
  as tests/test_ring.py:272-274;
- ``Filter(mesh=ResidentMesh(...), device="cpu")`` end to end, its gates with
  their messages, ``ring_enabled()`` and its override, and a 4-rank gloo
  ``DeviceMesh`` declining the ring and running its rounds.

Run as ``python tests/test_torch_ring.py <rank> 4 <workdir> 4x1`` this file is
one rank of that mesh and imports the port only.
"""
import os
import subprocess
import sys

import numpy as np
import torch

NY, NX = 48, 40
TOL = dict(rtol=2e-5, atol=2e-6)


def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    import gcm_filters_tpu_torch as gt
    from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
    from gcm_filters_tpu_torch.parallel import ring

    assert mesh_key == "4x1"
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("y", "x"))
    rng = np.random.default_rng(21)
    x = rng.random((NY, NX)).astype(np.float32)
    u = rng.random((NY, NX)).astype(np.float32)
    m = 0.9 + 0.2 * rng.random((NY, NX))
    bgrid = dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    report = {}
    # a strict 1-D y decomposition over ranks: the ring declines, the rounds run
    report["predicate"] = (ring._ring_mesh_for(mesh, ("y", None)) is None
                           and ring._ring_mesh_for(mesh, ("y", "x")) is None)
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", mesh=mesh,
                     spatial_axes=("y", "x"))
    res = filt.apply(x)
    report["scalar_hook_declines"] = filt._scalar_fn().ring() is None
    report["scalar_is_dtensor"] = isinstance(res, DTensor)
    vfilt = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", mesh=mesh,
                      spatial_axes=("y", None), grid_type=gt.GridType.VECTOR_B_GRID,
                      grid_vars=bgrid)
    fu, fv = vfilt.apply_to_vector(u, x)
    report["vector_hook_declines"] = vfilt._vector_fn().ring() is None
    report["vector_is_dtensor"] = isinstance(fu, DTensor) and isinstance(fv, DTensor)
    report["no_ring_launch"] = rp.ring_pass.launches == 0
    np.savez(os.path.join(workdir, f"report{rank}.npz"),
             **{k: np.asarray(v) for k, v in report.items()})
    if rank == 0:
        np.savez(os.path.join(workdir, "outputs.npz"), scalar=res.full_tensor().numpy(),
                 u=fu.full_tensor().numpy(), v=fv.full_tensor().numpy(), x=x, uin=u,
                 **{"gv_" + k: v for k, v in bgrid.items()})
    else:
        res.full_tensor(), fu.full_tensor(), fv.full_tensor()  # collectives: all ranks
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# pytest, with JAX for the answers
# --------------------------------------------------------------------------

import pytest  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import gcm_filters_tpu as gj  # noqa: E402
import gcm_filters_tpu.parallel.ring as jring  # noqa: E402
from gcm_filters_tpu.ops.pallas import (  # noqa: E402
    make_pallas_scalar_apply, make_pallas_vector_apply,
)
import gcm_filters_tpu_torch as gt  # noqa: E402
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp  # noqa: E402
from gcm_filters_tpu_torch.ops.cuda.dispatch import (  # noqa: E402
    make_cuda_scalar_apply, make_cuda_vector_apply,
)
from gcm_filters_tpu_torch.parallel import ring  # noqa: E402

from test_torch_sharded import spawn_ranks  # noqa: E402

P_YS = [2, 4, 8]
AXES = ("y", None)


def _wet(shape, rows=2):
    wet = np.ones(shape)
    wet[:rows] = 0
    return wet


def _scalar_vars(grid, shape, rng):
    ny, nx = shape
    m = np.ones(shape)
    if grid == "REGULAR":
        return {}
    if grid == "REGULAR_WITH_LAND":
        return {"wet_mask": _wet(shape)}
    if grid == "IRREGULAR_WITH_LAND":
        return dict(wet_mask=_wet(shape), dxw=m, dyw=m, dxs=m, dys=m, area=m, kappa_w=m,
                    kappa_s=m)
    if grid == "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED":
        return {"area": 0.9 + 0.2 * rng.random(shape), "wet_mask": _wet(shape, 1)}
    if grid == "TRIPOLAR_POP_WITH_LAND":
        irr = lambda: 0.9 + 0.2 * rng.random(shape)  # noqa: E731
        gv = dict(wet_mask=_wet(shape, 1), dxe=irr(), dye=irr(), dxn=irr(), dyn=irr(),
                  tarea=irr())
        for k in ("dxn", "dyn"):
            gv[k][-1, nx // 2:] = gv[k][-1, : nx // 2][::-1]
        return gv
    raise KeyError(grid)


def _vector_vars(grid, shape, rng, kappa_aniso=1.0):
    dxy = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid == "VECTOR_B_GRID":
        return dict(DXU=dxy, DYU=dxy, HUS=dxy, HUW=dxy, HTE=dxy, HTN=dxy,
                    UAREA=dxy * dxy, TAREA=dxy * dxy)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=dxy, dyT=dxy, dxCu=dxy, dyCu=dxy,
                dxCv=dxy, dyCv=dxy, dxBu=dxy, dyBu=dxy, area_u=dxy * dxy, area_v=dxy * dxy,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


# name -> (grid, shape or None for (NY, NX), filter kwargs, vector kappa_aniso, wet NaN)
CASES = {
    "regular": ("REGULAR", None, {}, None, False),
    "regular_37_steps": ("REGULAR", None, {"n_steps": 37}, None, False),
    "irregular_land": ("IRREGULAR_WITH_LAND", None, {}, None, True),
    "tripolar_area": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", None, {}, None, True),
    "tripolar_pop": ("TRIPOLAR_POP_WITH_LAND", None, {}, None, True),
    "exact_nan": ("REGULAR_WITH_LAND", None, {"exact_nan": True}, None, True),
    "nx_250": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", (24, 250), {}, None, False),
    "one_row_shards": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", "ly1", {}, None, False),
    "bgrid": ("VECTOR_B_GRID", None, {}, 0.0, True),
    "cgrid_aniso0": ("VECTOR_C_GRID", None, {}, 0.0, True),
    "cgrid_aniso1": ("VECTOR_C_GRID", None, {}, 1.0, True),
    "cgrid_37_steps": ("VECTOR_C_GRID", None, {"n_steps": 37}, 0.0, False),
}


def _case(name, p_y, scale=4.0):
    grid, shape, kw, ka, nan = CASES[name]
    shape = (p_y, 70) if shape == "ly1" else shape or (NY, NX)
    rng = np.random.default_rng(11)
    vector = grid.startswith("VECTOR")
    gv = _vector_vars(grid, shape, rng, ka) if vector else _scalar_vars(grid, shape, rng)
    fields = [rng.random(shape).astype(np.float32) for _ in range(2 if vector else 1)]
    if nan:
        fields[0][shape[0] // 2, 3] = np.nan  # a wet cell, on a shard edge at p_y 2, 4, 8
    kw = dict(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType[grid], grid_vars=gv,
              device="cpu", **kw)
    return vector, kw, fields


@pytest.mark.parametrize("p_y", P_YS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring_equals_the_unsharded_plain_path_bit_for_bit(name, p_y):
    vector, kw, fields = _case(name, p_y)
    base = gt.Filter(**kw)
    mesh = ring.ResidentMesh(p_y, "cpu")
    if vector:
        rf = ring.make_ring_vector_apply(base.operator, base.filter_spec, mesh, AXES)
        want = make_cuda_vector_apply(base.operator, base.filter_spec)(
            *(torch.as_tensor(f) for f in fields))
        got = rf(*fields)
    else:
        rf = ring.make_ring_scalar_apply(base.operator, base.filter_spec, mesh, AXES,
                                         exact_nan=base.exact_nan)
        want = (make_cuda_scalar_apply(base.operator, base.filter_spec,
                                       exact_nan=base.exact_nan)(torch.as_tensor(fields[0])),)
        got = (rf(fields[0]),)
    assert rf is not None and len(rf.shape_cache) == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=f"{name} p_y={p_y}")
    if CASES[name][4]:
        ny = fields[0].shape[0]
        assert bool(torch.isnan(got[0][ny // 2, 3])) and int(torch.isnan(got[0]).sum()) >= 1


# ---- against the JAX package -------------------------------------------------

def _ymesh(p):
    return Mesh(np.array(jax.devices()[:p]).reshape(p, 1), ("y", "x"))


# name -> (grid, shape, p_y, scale, filter kwargs, atol)
JAX_CASES = {
    "two_blocks_per_shard": ("REGULAR", (128, 128), 8, 4.0, {}, 2e-6),
    "regular": ("REGULAR", (768, 256), 8, 6.0, {}, 2e-6),
    "regular_37_steps": ("REGULAR", (768, 256), 4, 6.0, {"n_steps": 37}, 2e-6),
    "irregular_land": ("IRREGULAR_WITH_LAND", (768, 256), 8, 6.0, {}, 2e-6),
    "tripolar_area": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", (768, 256), 4, 6.0, {}, 2e-6),
    "exact_nan": ("REGULAR_WITH_LAND", (768, 256), 8, 6.0, {"exact_nan": True}, 2e-6),
    "bgrid": ("VECTOR_B_GRID", (768, 256), 8, 6.0, {}, 2e-6),
    # kappa_aniso=1 on unit metrics amplifies to O(10) values: absolute at that scale
    "cgrid": ("VECTOR_C_GRID", (768, 256), 8, 6.0, {}, 2e-5),
    # 37 steps of the amplifying operator reach O(1e4): that case runs at kappa_aniso=0
    "cgrid_37_steps": ("VECTOR_C_GRID", (768, 256), 8, 6.0, {"n_steps": 37}, 2e-6),
}
KAPPA_ANISO = {"cgrid_37_steps": 0.0}
_JAX = {}


def _jax_case(name):
    """Inputs, the port's ring result and both JAX answers, computed once."""
    if name in _JAX:
        return _JAX[name]
    grid, shape, p_y, scale, kw, atol = JAX_CASES[name]
    rng = np.random.default_rng(5)
    vector = grid.startswith("VECTOR")
    gv = (_vector_vars(grid, shape, rng, KAPPA_ANISO.get(name, 1.0)) if vector
          else _scalar_vars(grid, shape, rng))
    fields = [rng.random(shape).astype(np.float32) for _ in range(2 if vector else 1)]
    exact_nan = kw.get("exact_nan", False)
    if exact_nan:
        fields[0][10, 20] = np.nan  # a wet cell
    jf = gj.Filter(filter_scale=scale, dx_min=1.0, grid_type=gj.GridType[grid], grid_vars=gv,
                   use_pallas=False, **kw)
    pf = gt.Filter(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType[grid], grid_vars=gv,
                   device="cpu", mesh=ring.ResidentMesh(p_y, "cpu"), spatial_axes=AXES, **kw)
    data = [jnp.asarray(f) for f in fields]
    if vector:
        got = pf.apply_to_vector(*fields)
        fused = pf._vector_fn().shape_cache[shape + ("torch.float32",)].chain is not None
        jr = jring.make_ring_vector_apply(jf.operator, jf.filter_spec, _ymesh(p_y), ("y", "x"))
        ring_out = jr(*data)
        whole = make_pallas_vector_apply(jf.operator, jf.filter_spec)(*data)
    else:
        got = (pf.apply(fields[0]),)
        fused = None
        jr = jring.make_ring_scalar_apply(jf.operator, jf.filter_spec, _ymesh(p_y),
                                          ("y", "x"), exact_nan=exact_nan)
        ring_out = jr(*data)
        whole = make_pallas_scalar_apply(jf.operator, jf.filter_spec,
                                         exact_nan=exact_nan)(*data)
        ring_out = None if ring_out is None else (ring_out,)
        whole = (whole,)
    assert ring_out is not None, f"the JAX ring declined {name}"
    _JAX[name] = dict(got=[g.numpy() for g in got], atol=atol, fused=fused,
                      jax_ring=[np.asarray(a) for a in ring_out],
                      jax_whole=[np.asarray(a) for a in whole])
    return _JAX[name]


@pytest.mark.parametrize("ref", ["jax_ring", "jax_whole"])
@pytest.mark.parametrize("name", list(JAX_CASES))
def test_ring_matches_the_jax_package(name, ref):
    case = _jax_case(name)
    for got, want in zip(case["got"], case[ref]):
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=case["atol"], equal_nan=True,
                                   err_msg=f"{name} vs {ref}")
    if name == "exact_nan":
        assert np.isnan(case["got"][0][10, 20]) and np.isnan(case["got"][0]).sum() == 1
    if case["fused"] is not None:  # a vector case: the fused vector ring ran
        assert case["fused"], f"{name}: the vector ring ran the step ring"


# ---- Filter, gates, switch ---------------------------------------------------

def _tripolar_filter(p_y, shape=(NY, NX), **kw):
    rng = np.random.default_rng(2)
    gv = _scalar_vars("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", shape, rng)
    args = dict(filter_scale=4.0, dx_min=1.0,
                grid_type=gt.GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED, grid_vars=gv,
                device="cpu")
    args.update(kw)
    if p_y:
        args.setdefault("mesh", gt.ResidentMesh(p_y, "cpu"))
        args.setdefault("spatial_axes", AXES)
    return gt.Filter(**args)


@pytest.mark.parametrize("p_y", P_YS)
def test_filter_on_a_resident_mesh_runs_the_ring_end_to_end(p_y):
    x = np.random.default_rng(3).random((NY, NX)).astype(np.float32)
    filt = _tripolar_filter(p_y)
    got = filt.apply(x)
    assert isinstance(got, torch.Tensor) and type(got) is torch.Tensor  # one global tensor
    assert got.shape == (NY, NX) and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _tripolar_filter(0).apply(x).numpy())
    entry = filt._scalar_fn().shape_cache[NY, NX, "torch.float32"]
    state, p = entry.state, entry.p
    # the fused ring: one pass per entry of the shard's plan
    assert isinstance(state, rp.RingFusedState) and entry.chain is not None
    assert len(entry.chain) == len(entry.plan.steps) and sum(entry.plan.steps) == filt.n_steps
    assert state.ops.p_y == p_y and state.ly == NY // p_y and state.pad == entry.plan.halo
    assert len(p) == filt.n_steps + 1
    # the result is no buffer of the engine: a second apply leaves it alone
    kept = got.clone()
    again = filt.apply(2 * x + 1)
    assert not torch.equal(again, kept)
    np.testing.assert_array_equal(got.numpy(), kept.numpy())
    assert got.data_ptr() not in {a.data_ptr() for a in state.acc}
    assert filt._scalar_fn().shape_cache[NY, NX, "torch.float32"][0] is state  # reused
    # integers are promoted to float32 and pass the gate; a dict goes entry by entry
    ints = (x * 100).astype(np.int32)
    np.testing.assert_array_equal(filt.apply(ints).numpy(), _tripolar_filter(0).apply(ints).numpy())
    out = filt.apply({"sst": x, "scalar": 3.0})
    np.testing.assert_array_equal(out["sst"].numpy(), kept.numpy())


def test_filter_apply_to_vector_on_a_resident_mesh():
    rng = np.random.default_rng(6)
    gv = _vector_vars("VECTOR_C_GRID", (NY, NX), rng, 0.0)
    u, v = (rng.random((NY, NX)).astype(np.float32) for _ in range(2))
    kw = dict(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType.VECTOR_C_GRID, grid_vars=gv,
              device="cpu")
    filt = gt.Filter(mesh=gt.ResidentMesh(4, "cpu"), spatial_axes=AXES, halo_steps=3, **kw)
    fu, fv = filt.apply_to_vector(u, v)
    wu, wv = gt.Filter(**kw).apply_to_vector(u, v)
    np.testing.assert_array_equal(fu.numpy(), wu.numpy())
    np.testing.assert_array_equal(fv.numpy(), wv.numpy())
    assert type(fu) is torch.Tensor and fu.dtype == torch.float32
    with pytest.raises(ValueError, match="vector Laplacian"):
        filt.apply(u)
    with pytest.raises(ValueError, match="same shape"):
        filt.apply_to_vector(u, v[:-1])


GATES = {
    "batch": (dict(), lambda x: np.stack([x, x]), "one unbatched 2-D"),
    "one_dim": (dict(), lambda x: x[0], "one unbatched 2-D"),
    "float64": (dict(), lambda x: x.astype(np.float64), "4-byte elements"),
    "float64_by_dtype": (dict(dtype=torch.float64), lambda x: x, "4-byte elements"),
    "indivisible": (dict(mesh=gt.ResidentMesh(5, "cpu")), lambda x: x,
                    "48 rows do not divide into 5 y-shards"),
    "grid_shape": (dict(), lambda x: x[:, :-8], "does not match the grid's"),
    "two_axes": (dict(spatial_axes=("y", "x")), lambda x: x, "strict 1-D y decomposition"),
    "x_axis": (dict(spatial_axes=(None, "y")), lambda x: x, "strict 1-D y decomposition"),
    "batch_axis": (dict(batch_axis="b"), lambda x: x, "batch_axis cannot be sharded"),
}


@pytest.mark.parametrize("gate", list(GATES))
def test_an_ineligible_input_on_a_resident_mesh_raises_and_names_the_gate(gate):
    kw, change, message = GATES[gate]
    x = np.random.default_rng(3).random((NY, NX)).astype(np.float32)
    before = rp.ring_pass.launches
    with pytest.raises(ValueError, match=message):
        _tripolar_filter(4, **kw).apply(change(x))
    assert rp.ring_pass.launches == before


def test_more_gates_of_the_mesh_and_of_make_ring_apply():
    with pytest.raises(ValueError, match="at least 2 shards"):
        gt.ResidentMesh(1, "cpu")
    with pytest.raises(ValueError, match="'cuda' mesh but the filter's device is 'cpu'"):
        _tripolar_filter(0, mesh=gt.ResidentMesh(4, "cuda"), spatial_axes=AXES)
    mesh = gt.ResidentMesh(4, "cpu", name="lat")
    assert mesh.device_type == "cpu" and mesh.name == "lat" and mesh.p_y == 4
    assert "ResidentMesh(4, 'cpu'" in repr(mesh)
    base = _tripolar_filter(0)
    build = lambda m, axes: ring.make_ring_scalar_apply(  # noqa: E731
        base.operator, base.filter_spec, m, axes)
    assert build(mesh, ("lat", None)) is not None
    assert build(mesh, ("y", None)) is None       # not the mesh's dim
    assert build(mesh, ("lat", "lat")) is None    # x sharded too
    assert build(object(), ("y", None)) is None   # no resident mesh: no pointers to reach
    assert ring._ring_mesh_for(mesh, ("lat", None)) == (mesh, "lat", 4)
    vbase = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu",
                      grid_type=gt.GridType.VECTOR_B_GRID,
                      grid_vars=_vector_vars("VECTOR_B_GRID", (NY, NX), np.random.default_rng(1)))
    assert ring.make_ring_vector_apply(vbase.operator, vbase.filter_spec, mesh,
                                       ("lat", None)) is not None
    assert ring.make_ring_vector_apply(vbase.operator, vbase.filter_spec, mesh,
                                       ("lat", "x")) is None
    assert ring.make_ring_vector_apply(object(), vbase.filter_spec, mesh, ("lat", None)) is None
    # a free-form operator cannot be sharded, on a resident mesh as on any other
    with pytest.raises(ValueError, match="cannot be sharded"):
        gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu", mesh=mesh,
                  spatial_axes=("lat", None), custom_operator=gt.BaseScalarOperator())


def test_halo_steps_is_accepted_and_changes_no_result():
    assert [ring._max_fuse(h) for h in (None, 0, 1, 3, 16, 40)] == [16, 16, 1, 3, 16, 16]
    x = np.random.default_rng(3).random((NY, NX)).astype(np.float32)
    want = _tripolar_filter(4).apply(x).numpy()
    for hs in (1, 3):
        np.testing.assert_array_equal(_tripolar_filter(4, halo_steps=hs).apply(x).numpy(), want)
    # halo_steps caps the steps of a pass: the plan's passes follow it (on a
    # field wide enough for a 5-step window); one-step passes run the step ring
    wide = (NY, 120)
    xw = np.random.default_rng(4).random(wide).astype(np.float32)
    want = _tripolar_filter(4, shape=wide).apply(xw).numpy()
    passes = {}
    for hs in (None, 1, 2, 3):
        filt = _tripolar_filter(4, shape=wide, halo_steps=hs)
        np.testing.assert_array_equal(filt.apply(xw).numpy(), want)
        entry = filt._scalar_fn().shape_cache[wide + ("torch.float32",)]
        passes[hs] = (entry.plan.steps, entry.chain is not None)
    assert passes == {None: ((5,), True), 1: ((1,) * 5, False), 2: ((2, 2, 1), True),
                      3: ((3, 2), True)}


def test_ring_enabled_and_its_override(monkeypatch):
    x = np.random.default_rng(3).random((NY, NX)).astype(np.float32)
    monkeypatch.setattr(ring, "_RING", None)
    assert ring.ring_enabled() is True          # auto: on
    monkeypatch.setattr(ring, "_RING", True)
    assert ring.ring_enabled() is True
    monkeypatch.setattr(ring, "_RING", False)
    assert ring.ring_enabled() is False
    with pytest.raises(ValueError, match="switched off .* no other engine"):
        _tripolar_filter(4).apply(x)
    # the environment sets the switch where the module is first imported
    code = ("from gcm_filters_tpu_torch.parallel.ring import ring_enabled, _RING; "
            "print(_RING, ring_enabled())")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for value, want in (("0", "False False"), ("1", "True True"), ("", "None True")):
        env = dict(os.environ, GCM_FILTERS_TPU_RING=value, PYTHONPATH=root)
        out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120, check=True).stdout.strip()
        assert out == want, (value, out)


# ---- a mesh of ranks declines the ring ---------------------------------------

_RANKS = {}

RANK_CHECKS = ["predicate", "scalar_hook_declines", "scalar_is_dtensor",
               "vector_hook_declines", "vector_is_dtensor", "no_ring_launch"]


def _ranks(tmp_path_factory):
    if not _RANKS:
        workdir = str(tmp_path_factory.mktemp("ring_declines"))
        _RANKS["out"] = spawn_ranks(os.path.abspath(__file__), workdir, "4x1")
    return _RANKS["out"]


@pytest.mark.parametrize("check", RANK_CHECKS)
def test_a_mesh_of_ranks_declines_the_ring(tmp_path_factory, check):
    """4 gloo ranks, y-sharded 4x1: no pointer reaches another process, so the
    hook in parallel/sharded.py finds no ring and the rounds run."""
    _, reports = _ranks(tmp_path_factory)
    assert [bool(r[check]) for r in reports] == [True] * 4


def test_the_rounds_behind_the_declined_ring_give_the_unsharded_answer(tmp_path_factory):
    out, _ = _ranks(tmp_path_factory)
    want = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu").apply(out["x"]).numpy()
    np.testing.assert_allclose(out["scalar"], want, **TOL)
    gv = {k[3:]: v for k, v in out.items() if k.startswith("gv_")}
    wu, wv = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu",
                       grid_type=gt.GridType.VECTOR_B_GRID,
                       grid_vars=gv).apply_to_vector(out["uin"], out["x"])
    np.testing.assert_allclose(out["u"], wu.numpy(), **TOL)
    np.testing.assert_allclose(out["v"], wv.numpy(), **TOL)
