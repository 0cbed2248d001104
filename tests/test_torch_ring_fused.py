"""The fused scalar ring pass of the port on the CPU.

``ring_fused_pass_reference`` and ``ring_fused_pass_tiled_reference`` are the
plain versions of the CUDA kernel ``ring_fused_pass_*`` (csrc/ring_pass.cu on
the tile of csrc/cheb_tile.cuh): a pass sends the S rows nearest each edge
of every live field into the neighbours' halo rows, then runs S steps on
each shard's block extended by those rows. The plain version runs the
unsharded plain steps on the extended block; the tiled one cuts the kernel's
windows tile by tile (halo rows, mirror cells of the top shard's own rows at
the fold, clamped rows), which is where a window, corner or halo-depth fault
shows without a card. Both must equal the step ring chain
(``ring_pass_reference``, one step per call) and the unsharded plain path
bit for bit: the same torch ops on the same values, cell by cell.

The planner side (``parallel/ring.py::_shard_plan`` and ``_pass_chain``) is
held against the JAX module's ``_pass_chain``. The kernel itself is held to
these plain versions and to the fused K1, bit for bit, by chip_smoke.py on
the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gcm_filters_tpu.parallel.ring as jring
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FusedPlan, fused_planes, plan_fused_passes
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply
from gcm_filters_tpu_torch.parallel import ring

NY, NX = 48, 70  # 70 columns: no tile width divides them
P_YS = [2, 4, 8]
VERSIONS = {"plain": rp.ring_fused_pass_reference, "tiled": rp.ring_fused_pass_tiled_reference}
TILE = (8, 32)  # a shard of 6 rows is one partial tile row, of 12 rows two


def _grid_vars(grid, shape, rng):
    ny, nx = shape
    ones = np.ones(shape)
    wet = ones.copy()
    wet[0] = 0                        # the Antarctica row of the tripolar grids
    wet[:9, :7] = 0                   # land across the first shard edge at p_y = 8
    wet[20:27, nx - 10:] = 0          # land across the x wrap and more shard edges
    irr = lambda: 0.9 + 0.2 * rng.random(shape)  # noqa: E731
    if grid == "REGULAR":
        return {}
    if grid == "REGULAR_WITH_LAND":
        return {"wet_mask": wet}
    if grid == "IRREGULAR_WITH_LAND":
        return dict(wet_mask=wet, dxw=irr(), dyw=irr(), dxs=irr(), dys=irr(), area=irr(),
                    kappa_w=ones, kappa_s=ones)
    if grid == "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED":
        return {"area": irr(), "wet_mask": wet}
    if grid == "TRIPOLAR_POP_WITH_LAND":
        gv = dict(wet_mask=wet, dxe=irr(), dye=irr(), dxn=irr(), dyn=irr(), tarea=irr())
        for k in ("dxn", "dyn"):  # the seam's two halves face each other
            gv[k][-1, nx // 2:] = gv[k][-1, : nx // 2][::-1]
        return gv
    raise KeyError(grid)


# name -> (grid, exact_nan): the h-space masks, five flux planes, both folds
CASES = {
    "regular": ("REGULAR", False),
    "land_hspace": ("REGULAR_WITH_LAND", False),
    "irregular_flux": ("IRREGULAR_WITH_LAND", False),
    "tripolar_area": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", False),
    "tripolar_pop": ("TRIPOLAR_POP_WITH_LAND", False),
    "exact_nan": ("REGULAR_WITH_LAND", True),
}


def _setup(case, dtype=torch.float32, shape=(NY, NX), **kw):
    """The unsharded operands, p, the filter and a field with a land NaN and
    a wet NaN on a shard edge (row 24: an edge at p_y 2, 4 and 8)."""
    grid, exact_nan = CASES[case]
    rng = np.random.default_rng(7)
    filt = gt.Filter(filter_scale=4.0, dx_min=1.0, grid_type=gt.GridType[grid],
                     grid_vars=_grid_vars(grid, shape, rng), device="cpu", exact_nan=exact_nan,
                     **kw)
    ops, p = make_cuda_scalar_apply(filt.operator, filt.filter_spec,
                                    exact_nan=exact_nan).operands(dtype, torch.device("cpu"))
    x = rng.random(shape)
    if grid != "REGULAR":
        x[3, 2] = np.nan                 # land
        x[shape[0] // 2, 40] = np.nan    # wet, on a shard edge
    return filt, ops, p, torch.as_tensor(x, dtype=dtype)


def _plan(filt, ops, ly, nx, dtype, cap=None):
    """The ring's plan of a shard, as make_ring_scalar_apply makes it."""
    return plan_fused_passes(filt.n_steps, ly, nx, dtype, fused_planes(ops),
                             max_fuse=min(ring._max_fuse(cap), ly), ring=True)


def _fused_ring(fn, ops, p, x, p_y, steps, tile=TILE):
    """The whole filter as fused ring passes of ``steps``: the result and
    the state."""
    ny, nx = x.shape
    ly = ny // p_y
    state = rp.RingFusedState(rp.RingFusedOperands.cut(ops, p_y, max(steps)), ly, nx, x.dtype,
                              "cpu")
    for r, own in enumerate(state.input):
        own.copy_(x[r * ly:(r + 1) * ly])
    start = 0
    for m, n in enumerate(steps):
        fn(state, p, start, n, tile=tile, out=m % 2)
        start += n
    return torch.cat(state.acc), state


def _step_ring(ops, p, x, p_y):
    """The whole filter as the chain of plain ring steps."""
    ny, nx = x.shape
    ly = ny // p_y
    state = rp.RingState(rp.RingOperands.cut(ops, p_y), ly, nx, x.dtype, "cpu")
    for r, f in enumerate(state.field):
        f.copy_(x[r * ly:(r + 1) * ly])
    ring._steps(rp.ring_pass_reference, state, p, len(p) - 1)
    return torch.cat(state.acc)


def _unsharded(filt, x):
    return make_cuda_scalar_apply(filt.operator, filt.filter_spec, exact_nan=filt.exact_nan)(x)


def _assert_equal(got, want, msg):
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=msg)


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("p_y", P_YS)
@pytest.mark.parametrize("case", list(CASES))
def test_fused_ring_equals_the_step_ring_bit_for_bit(case, p_y, version):
    filt, ops, p, x = _setup(case)
    plan = _plan(filt, ops, NY // p_y, NX, torch.float32)
    assert plan.fused
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, p_y, plan.steps)
    want = _step_ring(ops, p, x, p_y)
    _assert_equal(got, want, f"{case} p_y={p_y} {version} {plan.steps}")
    _assert_equal(got, _unsharded(filt, x), "vs the unsharded plain path")
    if case != "regular":
        assert bool(torch.isnan(got[NY // 2, 40]))  # the wet NaN stays NaN
    assert rp.ring_fused_pass.launches == 0  # the plain versions do not count


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("steps", [(3, 2), (2, 2, 1), (1, 4)], ids=str)
@pytest.mark.parametrize("case", ["tripolar_pop", "irregular_flux"])
def test_several_passes_carry_their_halos_and_pairs(case, steps, version):
    filt, ops, p, x = _setup(case)
    got, state = _fused_ring(VERSIONS[version], ops, p, x, 4, steps)
    _assert_equal(got, _step_ring(ops, p, x, 4), f"{case} {steps} {version}")
    assert state.pad == max(steps)


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=str)
@pytest.mark.parametrize("case", ["tripolar_area", "exact_nan"])
def test_fused_ring_in_both_dtypes(case, dtype, version):
    filt, ops, p, x = _setup(case, dtype)
    plan = _plan(filt, ops, NY // 4, NX, dtype)
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, 4, plan.steps)
    assert got.dtype == dtype
    _assert_equal(got, _step_ring(ops, p, x, 4), f"{case} {dtype} {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("p_y", [2, 8])
def test_a_taper_filter_runs_several_passes(p_y, version):
    filt, ops, p, x = _setup("tripolar_area", filter_shape=gt.FilterShape.TAPER)
    plan = _plan(filt, ops, NY // p_y, NX, torch.float32)
    assert len(plan.steps) > 1 and sum(plan.steps) == filt.n_steps == 16
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, p_y, plan.steps)
    _assert_equal(got, _step_ring(ops, p, x, p_y), f"taper p_y={p_y} {version} {plan.steps}")


@pytest.mark.parametrize("version", list(VERSIONS))
@pytest.mark.parametrize("halo_steps", [1, 3, None])
def test_halo_steps_caps_the_passes(halo_steps, version):
    filt, ops, p, x = _setup("tripolar_pop")
    plan = _plan(filt, ops, NY // 4, NX, torch.float32, halo_steps)
    assert plan.halo <= (halo_steps or 16)
    assert len(plan.steps) == {1: 5, 3: 2, None: 1}[halo_steps]
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, 4, plan.steps, plan.tile)
    _assert_equal(got, _step_ring(ops, p, x, 4), f"halo_steps={halo_steps} {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
def test_shards_shorter_than_the_unsharded_halo_take_the_capped_plan(version):
    # 37 steps: the unsharded plan takes halos of 10 rows; shards of 6 rows
    # cap the ring's at 6, so no halo row comes from two shards away
    shape = (NY, 120)
    filt, ops, p, x = _setup("tripolar_area", shape=shape, n_steps=37)
    whole = plan_fused_passes(37, NY, 120, torch.float32, fused_planes(ops))
    plan = _plan(filt, ops, NY // 8, 120, torch.float32)
    assert whole.halo > NY // 8 and plan.halo == NY // 8 and plan.fused
    assert ring._shard_plan(plan, 8, NY, torch.float32) == NY // 8
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, 8, plan.steps, plan.tile)
    _assert_equal(got, _step_ring(ops, p, x, 8), f"ly=6 {plan.steps} {version}")


@pytest.mark.parametrize("version", list(VERSIONS))
def test_one_row_shards_take_the_step_ring_and_one_step_passes_agree(version):
    shape = (8, NX)
    filt, ops, p, x = _setup("tripolar_area", shape=shape)
    plan = _plan(filt, ops, 1, NX, torch.float32)
    # the engine: a one-row shard caps the passes at one step, the step ring's work
    assert plan.steps == (1,) * filt.n_steps and ring._shard_plan(plan, 8, 8, torch.float32) is None
    fn = ring.make_ring_scalar_apply(filt.operator, filt.filter_spec, ring.ResidentMesh(8, "cpu"),
                                     ("y", None), exact_nan=filt.exact_nan)
    got = fn(x)
    entry = fn.shape_cache[8, NX, "torch.float32"]
    assert entry.chain is None and isinstance(entry.state, rp.RingState)
    _assert_equal(got, _unsharded(filt, x), "one-row shards, step ring")
    # the fused pass itself takes one-row shards with one-step passes
    fused, _ = _fused_ring(VERSIONS[version], ops, p, x, 8, plan.steps)
    _assert_equal(fused, got, f"one-row shards, one-step fused passes, {version}")


def test_the_engine_runs_the_fused_chain_and_fused_fn_none_the_step_ring():
    filt, ops, p, x = _setup("tripolar_pop")
    mesh = ring.ResidentMesh(4, "cpu")
    fused = ring.make_ring_scalar_apply(filt.operator, filt.filter_spec, mesh, ("y", None))
    steps = ring.make_ring_scalar_apply(filt.operator, filt.filter_spec, mesh, ("y", None),
                                        fused_fn=None)
    calls = []
    counted = ring.make_ring_scalar_apply(
        filt.operator, filt.filter_spec, mesh, ("y", None),
        fused_fn=lambda *a, **k: calls.append((a[2], k["n_ops"], k["out"]))
        or rp.ring_fused_pass(*a, **k))
    got, want = fused(x), steps(x)
    _assert_equal(got, want, "fused ring vs step ring")
    _assert_equal(counted(x), want, "counted")
    entry = fused.shape_cache[NY, NX, "torch.float32"]
    assert isinstance(entry.state, rp.RingFusedState) and entry.chain is not None
    assert [c[1] for c in calls] == list(entry.plan.steps)
    assert [c[0] for c in calls] == [sum(entry.plan.steps[:m]) for m in range(len(calls))]
    assert [c[2] for c in calls] == [m % 2 for m in range(len(calls))]
    step_entry = steps.shape_cache[NY, NX, "torch.float32"]
    assert step_entry.chain is None and isinstance(step_entry.state, rp.RingState)
    assert step_entry.plan == entry.plan


# ---- planner: _shard_plan and _pass_chain against the JAX module -------------

@pytest.mark.parametrize("steps", [(11,), (10, 10, 10, 9), (3, 2), (1, 1, 1), (6, 6, 5, 5)],
                         ids=str)
def test_pass_chain_gives_the_jax_offsets(steps):
    plan = FusedPlan((32, 96), max(steps), steps, True)
    build = lambda n_ops, first, last: ("pass", n_ops, first, last)  # noqa: E731
    mine = ring._pass_chain(plan, build)
    theirs = jring._pass_chain(plan, build)
    assert [c[1:] for c in mine] == [c[1:] for c in theirs]
    assert [c[0] for c in mine] == [c[0] for c in theirs]
    assert sum(c[2] for c in mine) == sum(steps) + 1  # p has n_steps + 1 entries
    decline = lambda n_ops, first, last: None if last else "fn"  # noqa: E731
    assert ring._pass_chain(plan, decline) is None and jring._pass_chain(plan, decline) is None


def test_shard_plan_gates():
    good = FusedPlan((32, 96), 5, (5, 5), True)
    assert ring._shard_plan(good, 4, 48, torch.float32) == 12
    assert ring._shard_plan(good, 4, 48, torch.float64) is None      # 4-byte elements
    assert ring._shard_plan(good, 5, 48, torch.float32) is None      # ny % p_y
    assert ring._shard_plan(good, 12, 48, torch.float32) is None     # ly = 4 < halo
    assert ring._shard_plan(FusedPlan((32, 96), 2, (2,) * 5, True), 24, 48,
                            torch.float32) is None                    # more shards than the table
    assert ring._shard_plan(dataclasses.replace(good, fused=False), 4, 48, torch.float32) is None
    assert ring._shard_plan(FusedPlan((32, 96), 1, (1,) * 10, True), 4, 48,
                            torch.float32) is None                    # one-step passes
    assert ring._shard_plan(None, 4, 48, torch.float32) is None
    # the x extent: no tile's window fits in 30 columns, so the plan is not fused
    assert not plan_fused_passes(5, 12, 30, torch.float32, 4, ring=True).fused
    assert plan_fused_passes(5, 12, 40, torch.float32, 4, ring=True).fused
    # the rows come from the neighbours: a shard shorter than a tile is fused
    pl = plan_fused_passes(5, 3, 200, torch.float32, 4, max_fuse=3, ring=True)
    assert pl.fused and pl.halo == 3 and pl.tile[0] > 3


# ---- the protocol's buffers ---------------------------------------------------

@pytest.mark.parametrize("version", list(VERSIONS))
def test_poisoned_halos_never_reach_a_result_unless_the_sends_are_dropped(monkeypatch, version):
    filt, ops, p, x = _setup("regular")
    fn, n = VERSIONS[version], 3
    ly = NY // 4
    state = rp.RingFusedState(rp.RingFusedOperands.cut(ops, 4, 4), ly, NX, torch.float32, "cpu")
    for buf in state.field + state.t[0] + state.t[1] + state.t_prev[0] + state.t_prev[1]:
        assert torch.isnan(buf[:4]).all() and torch.isnan(buf[4 + ly:]).all()  # poisoned
    for r, own in enumerate(state.input):
        own.copy_(x[r * ly:(r + 1) * ly])
    fn(state, p, 0, n, tile=TILE, out=0)
    for bufs in (state.t[0], state.t_prev[0]):
        assert not any(bool(torch.isnan(b[4:4 + ly]).any()) for b in bufs)
    assert not any(bool(torch.isnan(a).any()) for a in state.acc)
    # the sends filled exactly the n halo rows nearest the own rows
    for r in range(4):
        _assert_equal(state.field[r][4 - n:4], x[(r * ly - n) % NY:][:n] if r else x[-n:],
                      f"south halo of shard {r}")
        _assert_equal(state.field[r][4 + ly:4 + ly + n], x[((r + 1) * ly) % NY:][:n],
                      f"north halo of shard {r}")
        assert torch.isnan(state.field[r][:4 - n]).all()

    # without the sends, the n rows nearest every shard edge read the poison
    monkeypatch.setattr(rp, "_send_rows", lambda *a: None)
    state = rp.RingFusedState(state.ops, ly, NX, torch.float32, "cpu")
    for r, own in enumerate(state.input):
        own.copy_(x[r * ly:(r + 1) * ly])
    fn(state, p, 0, n, tile=TILE, out=0)
    t = torch.cat([b[4:4 + ly] for b in state.t[0]])
    rows = torch.isnan(t).any(-1).nonzero().flatten().tolist()
    assert rows == sorted({r * ly + k for r in range(4) for k in (*range(n), *range(ly - n, ly))})


@pytest.mark.parametrize("version", list(VERSIONS))
def test_the_fold_keeps_the_top_shards_north_halo_out_of_the_result(monkeypatch, version):
    filt, ops, p, x = _setup("tripolar_area")
    rops = rp.RingFusedOperands.cut(ops, 4, 3)
    assert [st.fold_north for st in rops.shards] == [False, False, False, True]
    send = rp._send_rows

    def send_then_poison(state, n, first, out):
        # the wrap fills the top shard's north halo with shard 0's bottom
        # rows; the seam reads the shard's own top rows instead
        send(state, n, first, out)
        live = [state.field] if first else [state.t[1 - out], state.t_prev[1 - out]]
        top = slice(state.pad + state.ly, None)
        for bufs in live:
            _assert_equal(bufs[-1][top][:n], bufs[0][state.pad:state.pad + n], "the wrap's rows")
            bufs[-1][top] = float("nan")

    monkeypatch.setattr(rp, "_send_rows", send_then_poison)
    got, _ = _fused_ring(VERSIONS[version], ops, p, x, 4, (3, 2))
    _assert_equal(got, _unsharded(filt, x), "fused ring with a poisoned north halo on top")


def test_states_are_allocations_of_their_own():
    _, ops, _, _ = _setup("exact_nan")
    rops = rp.RingFusedOperands.cut(ops, 4, 3)
    state = rp.RingFusedState(rops, NY // 4, NX, torch.float32, "cpu")
    tensors = state.field + state.acc + [b for pair in state.t + state.t_prev for b in pair]
    tensors += [st.c for st in rops.shards] + [st.post for st in rops.shards]
    for t in tensors:
        assert t._base is None and t.is_contiguous()
    storages = [t.untyped_storage().data_ptr() for t in tensors]
    assert len(set(storages)) == len(storages)
    # pre and post were one tensor before the cut and are one per shard after
    assert ops.stencil.pre is ops.stencil.post
    assert all(st.pre is st.post for st in rops.shards)
    # extended planes: global rows r*ly - 3 .. (r+1)*ly + 3, y wrapping
    rows = (np.arange(-3, NY // 4 + 3) + 3 * (NY // 4)) % NY
    _assert_equal(rops.shards[3].c, ops.stencil.c[torch.as_tensor(rows)], "extended c")
    assert state.input[1].data_ptr() == state.field[1][3].data_ptr()


def test_state_and_wrapper_refuse_what_the_kernel_does_not_take():
    _, ops, p, _ = _setup("tripolar_area")
    rops = rp.RingFusedOperands.cut(ops, 4, 3)
    with pytest.raises(ValueError, match="halo of at least 1 row"):
        rp.RingFusedOperands.cut(ops, 4, 0)
    with pytest.raises(TypeError, match="takes RingFusedOperands"):
        rp.RingFusedState(rp.RingOperands.cut(ops, 4), NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        rp.RingFusedState(rops, NY // 4, NX, torch.float16, "cpu")
    with pytest.raises(ValueError, match="shape"):
        rp.RingFusedState(rops, NY // 2, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="at least 2 shards"):
        rp.RingFusedState(rp.RingFusedOperands.cut(ops, 1, 3), NY, NX, torch.float32, "cpu")
    state = rp.RingFusedState(rops, NY // 4, NX, torch.float32, "cpu")
    with pytest.raises(ValueError, match="a halo of 3 rows"):
        rp.ring_fused_pass(state, p, 0, 4, tile=TILE, out=0)
    with pytest.raises(ValueError, match="carry pair 0 or 1"):
        rp.ring_fused_pass(state, p, 0, 2, tile=TILE, out=2)
    with pytest.raises(ValueError, match="steps 5..6 of a 5-step filter"):
        rp.ring_fused_pass(state, p, 4, 2, tile=TILE, out=0)
    with pytest.raises(TypeError, match="takes a RingFusedState"):
        rp.ring_fused_pass_reference(rp.RingState(rp.RingOperands.cut(ops, 4), NY // 4, NX,
                                                  torch.float32, "cpu"), p, 0, 2, out=0)
    state.device = torch.device("meta")
    with pytest.raises(RuntimeError, match="no kernel for device"):
        rp.ring_fused_pass(state, p, 0, 2, tile=TILE, out=0)
    assert rp.ring_fused_pass.launches == 0
