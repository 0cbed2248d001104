"""The fused vector ring pass of the port on the CPU.

``vec_ring_fused_pass_reference`` and ``vec_ring_fused_pass_tiled_reference``
are the plain versions of the CUDA kernel ``vec_ring_fused_pass_*``
(csrc/ring_pass.cu on the tile of csrc/vec_tile.cuh): a pass sends the S rows
nearest each edge of both components of every live field into the
neighbours' halo rows, then runs S coupled (u, v) steps on each shard's block
extended by those rows. The plain version runs the unsharded plain steps on
the extended block; the tiled one cuts the kernel's windows tile by tile
(halo rows, x periodic with the corners that the C-grid's diagonal taps
read, clamped rows), which is where a window, corner or halo-depth fault
shows without a card. Both must equal the vector step ring chain
(``vec_ring_pass_reference``, one step per call) and the unsharded plain
path bit for bit: the same torch ops on the same values, cell by cell.

The kernel itself is held to these plain versions, to the fused K3 / K4 and
to the step ring, bit for bit, by chip_smoke.py on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FusedPlan
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_vector_apply
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.cuda.vec_pass import BGRID, CTAP, plan_vec_fused_passes
from gcm_filters_tpu_torch.parallel import ring

NY, NX = 48, 70  # 70 columns: no tile width divides them
P_YS = [2, 4, 8]
VERSIONS = {"plain": rp.vec_ring_fused_pass_reference,
            "tiled": rp.vec_ring_fused_pass_tiled_reference}
TILE = (8, 32)  # a shard of 6 rows is one partial tile row, of 12 rows two
F32 = "torch.float32"


def _grid_vars(grid, shape, rng, kappa_aniso):
    dxy = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid == "VECTOR_B_GRID":
        return dict(DXU=dxy, DYU=dxy, HUS=dxy, HUW=dxy, HTE=dxy, HTN=dxy,
                    UAREA=dxy * dxy, TAREA=dxy * dxy)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=dxy, dyT=dxy, dxCu=dxy, dyCu=dxy,
                dxCv=dxy, dyCv=dxy, dxBu=dxy, dyBu=dxy, area_u=dxy * dxy, area_v=dxy * dxy,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


# name -> (grid, kappa_aniso, zap_nans): both contractions, the amplifying
# C-grid at kappa_aniso 1, and NaNs that travel raw
CASES = {
    "bgrid": ("VECTOR_B_GRID", 0.0, True),
    "bgrid_no_zap": ("VECTOR_B_GRID", 0.0, False),
    "cgrid_aniso0": ("VECTOR_C_GRID", 0.0, True),
    "cgrid_aniso1": ("VECTOR_C_GRID", 1.0, True),
    "cgrid_no_zap": ("VECTOR_C_GRID", 0.0, False),
}


def _setup(case, dtype=torch.float32, shape=(NY, NX), **kw):
    """The operator, the filter, the unsharded operands, p and (u, v) with a
    NaN on a shard edge and at a tile corner and spikes at shard-edge tile
    corners (rows 24 and 12: edges at p_y 2, 4 and 8; columns 31 and 32: the
    seam of 32-wide tiles)."""
    grid, kappa_aniso, zap = CASES[case]
    rng = np.random.default_rng(7)
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid],
                     grid_vars=_grid_vars(grid, shape, rng, kappa_aniso), device="cpu", **kw)
    operator = filt.operator if zap else dataclasses.replace(filt.operator, zap_nans=False)
    ops, p = make_cuda_vector_apply(operator, filt.filter_spec).operands(dtype,
                                                                          torch.device("cpu"))
    u, v = rng.random(shape), rng.random(shape)
    ny = shape[0]
    u[ny // 2, 40] = np.nan      # on a shard edge
    v[8 % ny, 32] = np.nan       # at a tile corner
    v[ny // 2 - 1, 31] = 50.0    # the last row of a shard, at a tile corner
    u[ny // 4, 32] = -40.0       # the first row of a shard, at a tile corner
    return operator, filt, ops, p, torch.as_tensor(u, dtype=dtype), torch.as_tensor(v, dtype=dtype)


def _plan(filt, ops, ly, nx, dtype, cap=None):
    """The ring's plan of a shard, as make_ring_vector_apply makes it."""
    return plan_vec_fused_passes(filt.n_steps, ly, nx, dtype, ops.op,
                                 max_fuse=min(ring._max_fuse(cap), ly), ring=True)


def _load(state, u, v):
    ly = state.ly
    for r, w in enumerate(state.input):
        w[0].copy_(u[r * ly:(r + 1) * ly])
        w[1].copy_(v[r * ly:(r + 1) * ly])


def _fused_ring(fn, ops, p, u, v, p_y, steps, tile=TILE):
    """The whole filter as fused vector ring passes of ``steps``: the stacked
    result and the state."""
    ny, nx = u.shape
    state = rp.VecRingFusedState(rp.VecRingFusedOperands.cut(ops, p_y, max(steps)), ny // p_y,
                                 nx, u.dtype, "cpu")
    _load(state, u, v)
    start = 0
    for m, n in enumerate(steps):
        fn(state, p, start, n, tile=tile, out=m % 2)
        start += n
    return torch.cat(state.acc, dim=1), state


def _step_ring(ops, p, u, v, p_y):
    """The whole filter as the chain of plain vector ring steps."""
    ny, nx = u.shape
    state = rp.RingState(rp.VecRingOperands.cut(ops, p_y), ny // p_y, nx, u.dtype, "cpu")
    _load(state, u, v)
    ring._steps(rp.vec_ring_pass_reference, state, p, len(p) - 1)
    return torch.cat(state.acc, dim=1)


def _unsharded(operator, filt, u, v):
    return torch.stack(make_cuda_vector_apply(operator, filt.filter_spec)(u, v))


def _assert_equal(got, want, msg):
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=msg)


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("p_y", P_YS)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_vector_ring_equals_the_step_ring_bit_for_bit(case, p_y, version):
    operator, filt, ops, p, u, v = _setup(case)
    counted = launch_counts()
    plan = _plan(filt, ops, NY // p_y, NX, torch.float32)
    assert plan.fused and ring._shard_plan(plan, p_y, NY, torch.float32) == NY // p_y
    got, _ = _fused_ring(VERSIONS[version], ops, p, u, v, p_y, plan.steps)
    _assert_equal(got, _step_ring(ops, p, u, v, p_y), f"{case} p_y={p_y} {version} {plan.steps}")
    _assert_equal(got, _unsharded(operator, filt, u, v), "vs the unsharded plain path")
    assert bool(torch.isnan(got[0, NY // 2, 40]))  # the NaN stays NaN
    assert launch_counts() == counted  # plain versions do not count


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("steps", [(3, 2), (2, 2, 1), (1, 4)], ids=str)
@pytest.mark.parametrize("case", ["bgrid", "cgrid_aniso1"])
def test_several_passes_carry_both_components_and_both_pairs(case, steps, version):
    _, _, ops, p, u, v = _setup(case)
    got, state = _fused_ring(VERSIONS[version], ops, p, u, v, 4, steps)
    _assert_equal(got, _step_ring(ops, p, u, v, 4), f"{case} {steps} {version}")
    assert state.pad == max(steps)


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("case", ["bgrid", "cgrid_aniso0"])
@pytest.mark.parametrize("filter_kw", [{"n_steps": 37}, {"filter_shape": gt.FilterShape.TAPER}],
                         ids=["37_steps", "taper"])
def test_long_filters_run_several_passes(filter_kw, case, version):
    operator, filt, ops, p, u, v = _setup(case, **filter_kw)
    plan = _plan(filt, ops, NY // 4, NX, torch.float32)
    assert len(plan.steps) > 1 and sum(plan.steps) == filt.n_steps and plan.halo <= NY // 4
    got, _ = _fused_ring(VERSIONS[version], ops, p, u, v, 4, plan.steps, plan.tile)
    _assert_equal(got, _step_ring(ops, p, u, v, 4), f"{filter_kw} {case} {version} {plan.steps}")
    _assert_equal(got, _unsharded(operator, filt, u, v), "vs the unsharded plain path")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("p_y, n_int, tiles_y", [(2, 2, 6), (4, 0, 3)])
@pytest.mark.parametrize("case", ["bgrid", "cgrid_aniso1"])
def test_tiles_shorter_than_the_halo_have_two_edge_rows_a_side(case, p_y, n_int, tiles_y,
                                                                version):
    # 4-row tiles under a 5-step pass: the kernel's edge tiles are the two
    # tile rows at each shard edge (in a 12-row shard the middle row reaches
    # both), drawn by ticket, and the rows between take their items from
    # blockIdx
    _, _, ops, p, u, v = _setup(case)
    items = rp.RingItems(p_y, NY // p_y, NX, (4, 16), 5)
    assert (items.int_lo, items.n_int, items.tiles_y) == (2, n_int, tiles_y)
    got, _ = _fused_ring(VERSIONS[version], ops, p, u, v, p_y, (5,), tile=(4, 16))
    _assert_equal(got, _step_ring(ops, p, u, v, p_y), f"{case} p_y={p_y} (4, 16) {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", ["bgrid", "cgrid_aniso0"])
def test_fused_vector_ring_in_both_dtypes(case, dtype, version):
    operator, filt, ops, p, u, v = _setup(case, dtype)
    plan = _plan(filt, ops, NY // 4, NX, dtype)
    got, _ = _fused_ring(VERSIONS[version], ops, p, u, v, 4, plan.steps)
    assert got.dtype == dtype
    _assert_equal(got, _step_ring(ops, p, u, v, 4), f"{case} {dtype} {version}")
    _assert_equal(got, _unsharded(operator, filt, u, v), "vs the unsharded plain path")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("halo_steps", [1, 3, None])
def test_halo_steps_caps_the_vector_passes(halo_steps, version):
    operator, filt, ops, p, u, v = _setup("cgrid_aniso1")
    plan = _plan(filt, ops, NY // 4, NX, torch.float32, halo_steps)
    assert plan.halo <= (halo_steps or 16)
    assert len(plan.steps) == {1: 5, 3: 2, None: 1}[halo_steps]
    fn = ring.make_ring_vector_apply(operator, filt.filter_spec, ring.ResidentMesh(4, "cpu"),
                                     ("y", None), halo_steps=halo_steps, fused_fn=VERSIONS[version])
    got = torch.stack(fn(u, v))
    entry = fn.shape_cache[NY, NX, F32]
    assert entry.plan == plan
    # one-step passes are the step ring's work
    assert (entry.chain is None) == (halo_steps == 1)
    _assert_equal(got, _unsharded(operator, filt, u, v), f"halo_steps={halo_steps} {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
def test_shards_shorter_than_the_unsharded_halo_take_the_capped_plan(version):
    # 37 steps: the unsharded plan takes halos of 7 rows; shards of 6 rows
    # cap the ring's at 6, so no halo row comes from two shards away
    shape = (NY, 120)
    operator, filt, ops, p, u, v = _setup("cgrid_aniso0", shape=shape, n_steps=37)
    whole = plan_vec_fused_passes(37, NY, 120, torch.float32, CTAP)
    plan = _plan(filt, ops, NY // 8, 120, torch.float32)
    assert whole.halo > NY // 8 and plan.halo == NY // 8 and plan.fused
    assert ring._shard_plan(plan, 8, NY, torch.float32) == NY // 8
    got, _ = _fused_ring(VERSIONS[version], ops, p, u, v, 8, plan.steps, plan.tile)
    _assert_equal(got, _step_ring(ops, p, u, v, 8), f"ly=6 {plan.steps} {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
def test_one_row_shards_take_the_step_ring_and_one_step_passes_agree(version):
    shape = (8, NX)
    operator, filt, ops, p, u, v = _setup("bgrid", shape=shape)
    plan = _plan(filt, ops, 1, NX, torch.float32)
    assert plan.steps == (1,) * filt.n_steps and ring._shard_plan(plan, 8, 8, torch.float32) is None
    fn = ring.make_ring_vector_apply(operator, filt.filter_spec, ring.ResidentMesh(8, "cpu"),
                                     ("y", None))
    got = torch.stack(fn(u, v))
    entry = fn.shape_cache[8, NX, F32]
    assert entry.chain is None and isinstance(entry.state, rp.RingState)
    _assert_equal(got, _unsharded(operator, filt, u, v), "one-row shards, step ring")
    # the fused pass itself takes one-row shards with one-step passes
    fused, _ = _fused_ring(VERSIONS[version], ops, p, u, v, 8, plan.steps)
    _assert_equal(fused, got, f"one-row shards, one-step fused passes, {version}")


@pytest.mark.parametrize("case", ["bgrid", "cgrid_aniso0"])
def test_the_engine_runs_the_fused_chain_and_fused_fn_none_the_step_ring(case):
    operator, filt, _, _, u, v = _setup(case)
    mesh = ring.ResidentMesh(4, "cpu")
    make = lambda **kw: ring.make_ring_vector_apply(  # noqa: E731
        operator, filt.filter_spec, mesh, ("y", None), **kw)
    calls = []
    fused, steps = make(), make(fused_fn=None)
    counted = make(fused_fn=lambda *a, **k: calls.append((a[2], k["n_ops"], k["out"]))
                   or rp.vec_ring_fused_pass(*a, **k), halo_steps=2)
    got, want = torch.stack(fused(u, v)), torch.stack(steps(u, v))
    _assert_equal(got, want, "fused ring vs step ring")
    _assert_equal(torch.stack(counted(u, v)), want, "counted")
    entry = fused.shape_cache[NY, NX, F32]
    assert isinstance(entry.state, rp.VecRingFusedState) and entry.chain is not None
    assert len(entry.chain) == len(entry.plan.steps) and sum(entry.plan.steps) == filt.n_steps
    plan2 = counted.shape_cache[NY, NX, F32].plan
    assert plan2.steps == (2, 2, 1) and [c[1] for c in calls] == list(plan2.steps)
    assert [c[0] for c in calls] == [0, 2, 4] and [c[2] for c in calls] == [0, 1, 0]
    step_entry = steps.shape_cache[NY, NX, F32]
    assert step_entry.chain is None and isinstance(step_entry.state, rp.RingState)
    assert step_entry.plan == entry.plan and entry.state.pad == entry.plan.halo


# ---- planner ------------------------------------------------------------------

@pytest.mark.parametrize("op", [BGRID, CTAP], ids=["bgrid", "ctap"])
def test_the_ring_planner_and_shard_plan_on_vector_plans(op):
    # at the 2400x3600 headline a shard of 600 rows gets the unsharded plan's
    # tile and split, on the shared-memory steps (the ring's kernel has no
    # register steps; the unsharded passes take them)
    whole = plan_vec_fused_passes(11, 2400, 3600, torch.float32, op)
    shard = plan_vec_fused_passes(11, 600, 3600, torch.float32, op, max_fuse=16, ring=True)
    assert (shard.tile, shard.halo, shard.steps) == (whole.tile, whole.halo, whole.steps)
    assert shard.steps == (6, 5) and shard.fused and whole.fused
    assert shard.paths == ("shared", "shared") and whole.paths == ("registers", "registers")
    assert shard.tile == {BGRID: (32, 64), CTAP: (16, 64)}[op]
    assert ring._shard_plan(shard, 4, 2400, torch.float32) == 600
    # without ring the plan of a short field is not fused; with it, its rows come
    # from the neighbours
    assert not plan_vec_fused_passes(5, 6, 200, torch.float32, op).fused
    pl = plan_vec_fused_passes(5, 6, 200, torch.float32, op, max_fuse=6, ring=True)
    assert pl.fused and pl.tile[0] > 6 and pl.tile[1] + 2 * pl.halo <= 200
    # the x extent: no tile's window fits in 30 columns
    assert not plan_vec_fused_passes(5, 12, 30, torch.float32, op, ring=True).fused
    assert ring._shard_plan(plan_vec_fused_passes(5, 12, 30, torch.float32, op, ring=True), 4,
                            48, torch.float32) is None
    assert ring._shard_plan(FusedPlan((16, 64), 3, (3, 2), True), 4, 48, torch.float64) is None
    assert ring._shard_plan(FusedPlan((16, 64), 3, (3, 2), True), 17, 68, torch.float32) is None


# ---- the protocol's buffers -----------------------------------------------------

@pytest.mark.parametrize("version", list(VERSIONS))
def test_poisoned_halos_never_reach_a_result_unless_the_sends_are_dropped(monkeypatch, version):
    # no zap: a NaN read by the contraction stays NaN; no NaN but the poison
    _, _, ops, p, u, v = _setup("cgrid_no_zap")
    u, v = torch.nan_to_num(u), torch.nan_to_num(v)
    fn, n = VERSIONS[version], 3
    ly = NY // 4
    state = rp.VecRingFusedState(rp.VecRingFusedOperands.cut(ops, 4, 4), ly, NX, torch.float32,
                                 "cpu")
    for buf in state.w + state.t[0] + state.t[1] + state.t_prev[0] + state.t_prev[1]:
        assert torch.isnan(buf[:, :4]).all() and torch.isnan(buf[:, 4 + ly:]).all()  # poisoned
    _load(state, u, v)
    fn(state, p, 0, n, tile=TILE, out=0)
    for bufs in (state.t[0], state.t_prev[0]):
        assert not any(bool(torch.isnan(b[:, 4:4 + ly]).any()) for b in bufs)
    assert not any(bool(torch.isnan(a).any()) for a in state.acc)
    # the sends filled exactly the n halo rows nearest the own rows, of both components
    uv = torch.stack([u, v])
    for r in range(4):
        south = torch.arange(r * ly - n, r * ly) % NY
        north = torch.arange((r + 1) * ly, (r + 1) * ly + n) % NY
        _assert_equal(state.w[r][:, 4 - n:4], uv[:, south], f"south halo of shard {r}")
        _assert_equal(state.w[r][:, 4 + ly:4 + ly + n], uv[:, north], f"north halo of shard {r}")
        assert torch.isnan(state.w[r][:, :4 - n]).all()

    # without the sends, the n rows nearest every shard edge read the poison
    monkeypatch.setattr(rp, "_send_rows", lambda *a: None)
    state = rp.VecRingFusedState(state.ops, ly, NX, torch.float32, "cpu")
    _load(state, u, v)
    fn(state, p, 0, n, tile=TILE, out=0)
    for comp in range(2):
        t = torch.cat([b[comp, 4:4 + ly] for b in state.t[0]])
        rows = torch.isnan(t).any(-1).nonzero().flatten().tolist()
        assert rows == sorted({r * ly + k for r in range(4)
                               for k in (*range(n), *range(ly - n, ly))}), comp


def test_states_are_allocations_of_their_own():
    _, _, ops, _, _, _ = _setup("cgrid_aniso1")
    rops = rp.VecRingFusedOperands.cut(ops, 4, 3)
    state = rp.VecRingFusedState(rops, NY // 4, NX, torch.float32, "cpu")
    assert state.w is state.field and state.lead == (2,)
    tensors = state.w + state.acc + [b for pair in state.t + state.t_prev for b in pair]
    tensors += list(rops.coefs)
    for t in tensors:
        assert t._base is None and t.is_contiguous()
    storages = [t.untyped_storage().data_ptr() for t in tensors]
    assert len(set(storages)) == len(storages)
    assert all(w.shape == (2, NY // 4 + 6, NX) for w in state.w)
    assert all(a.shape == (2, NY // 4, NX) for a in state.acc)
    # extended planes: global rows r*ly - 3 .. (r+1)*ly + 3, y wrapping
    rows = (np.arange(-3, NY // 4 + 3) + 3 * (NY // 4)) % NY
    _assert_equal(rops.coefs[3], ops.coef[:, torch.as_tensor(rows)], "extended coefficients")
    assert rops.coefs[0].shape == (18, NY // 4 + 6, NX) and rops.op == CTAP and rops.zap
    assert state.input[1].data_ptr() == state.w[1][0, 3].data_ptr()
    assert len(state.planes(0)) == 8 * 4 and len(state.planes(1)) == 8 * 4


def test_state_and_wrapper_refuse_what_the_kernel_does_not_take():
    _, _, ops, p, _, _ = _setup("bgrid")
    counted = launch_counts()
    rops = rp.VecRingFusedOperands.cut(ops, 4, 3)
    with pytest.raises(ValueError, match="halo of at least 1 row"):
        rp.VecRingFusedOperands.cut(ops, 4, 0)
    with pytest.raises(TypeError, match="VecRingFusedState takes VecRingFusedOperands"):
        rp.VecRingFusedState(rp.VecRingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        rp.VecRingFusedState(rops, NY // 4, NX, torch.float16, "cpu")
    with pytest.raises(ValueError, match="shape"):
        rp.VecRingFusedState(rops, NY // 2, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="at least 2 shards"):
        rp.VecRingFusedState(rp.VecRingFusedOperands.cut(ops, 1, 3), NY, NX, torch.float32,
                             "cpu")
    with pytest.raises(ValueError, match="unknown vector contraction"):
        rp.VecRingFusedState(dataclasses.replace(rops, op=7), NY // 4, NX, torch.float32, "cpu")
    state = rp.VecRingFusedState(rops, NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="a halo of 3 rows"):
        rp.vec_ring_fused_pass(state, p, 0, 4, tile=TILE, out=0)
    with pytest.raises(ValueError, match="carry pair 0 or 1"):
        rp.vec_ring_fused_pass(state, p, 0, 2, tile=TILE, out=2)
    with pytest.raises(ValueError, match="steps 5..6 of a 5-step filter"):
        rp.vec_ring_fused_pass(state, p, 4, 2, tile=TILE, out=0)
    # each wrapper takes its own kind of state
    with pytest.raises(TypeError, match="takes a VecRingFusedState"):
        rp.vec_ring_fused_pass_reference(rp.RingState(rp.VecRingOperands.cut(ops, 4), NY // 4,
                                                      NX, torch.float32, "cpu"), p, 0, 2, out=0)
    with pytest.raises(TypeError, match="takes a RingFusedState"):
        rp.ring_fused_pass_reference(state, p, 0, 2, out=0)
    with pytest.raises(TypeError, match="takes a VecRingFusedState"):
        rp.vec_ring_fused_pass_tiled_reference(
            rp.RingFusedState.__new__(rp.RingFusedState), p, 0, 2, tile=TILE, out=0)
    assert launch_counts() == counted
