"""The fused local vector round of the port on the CPU.

``local_rounds_vector`` runs each round of the sharded vector engine as the
fused launches that ``plan_vec_local_rounds`` plans: on the CPU each launch
is ``vec_local_fused_pass_reference``, the plain version of the CUDA kernel
``csrc/vec_tile.cuh`` on the geometry ``RoundGeo`` (entries
``vec_local_fused_pass_f32/f64`` in ``csrc/vec_pass.cu``). The fused route
must match the JAX sharded vector apply with its coupled Pallas local pass in
interpret mode (the tolerances of tests/test_torch_vec_local_pass.py), and
equal the plain local step chain exactly, under one launch per round (split
(a)) and several (split (b)): a fused launch is the same steps, so any
difference is a bookkeeping fault (the p offsets, which carries a launch
reads and writes, the shrink each launch ends on).
``vec_local_fused_pass_tiled_reference`` runs the kernel's decomposition
(windows cut from the extended block with their corners, shrinking steps,
acc on the core only) and must equal the plain local step chain bit for bit
too. The kernels themselves are held to the local step kernels, bit for bit,
by chip_smoke.py on the card.
"""
import numpy as np
import pytest
import torch

import gcm_filters_tpu as gj
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import vec_local_pass as vlp
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import (
    LAST, MAX_FUSE, MIDDLE, SHARED_BYTES, FusedPlan, _balanced,
)
from gcm_filters_tpu_torch.parallel import halo
from gcm_filters_tpu_torch.parallel.sharded import (
    _fused_vector_rounds, local_rounds_vector, make_sharded_vector_apply, plan_rounds,
)

from test_torch_vec_local_pass import TOL, TORCH_DT, _jax_sharded_pallas, _local_operands
from test_torch_vec_pass import fields, unit_grid_vars

LOCAL = (None, 1)
B, C = gj.GridType.VECTOR_B_GRID, gj.GridType.VECTOR_C_GRID
OPS = {B: vp.BGRID, C: vp.CTAP}


class _Spy:
    """A fused_fn that records (start, n_ops, shrink, tile) and runs ``fn``."""

    def __init__(self, fn=vlp.vec_local_fused_pass):
        self.fn, self.calls = fn, []

    def __call__(self, ops, p, start, n_ops, **kw):
        self.calls.append((start, n_ops, kw["shrink"], tuple(kw["tile"])))
        return self.fn(ops, p, start, n_ops, **kw)


def _setup(grid_type, shape, dtype=torch.float64, n_steps=None, halo_steps=None,
           kappa_aniso=0.0, zap=True, scale=6.0):
    """``(ops, p, cells, rounds)`` of the local round on an unsharded block."""
    kw = {"n_steps": n_steps} if n_steps else {}
    tf = gt.Filter(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape, kappa_aniso), device="cpu", **kw)
    cells, rounds = plan_rounds(tf.n_steps, *shape, halo_steps)
    ops = _local_operands(tf, cells, dtype, zap=zap)
    npdt = np.float32 if dtype == torch.float32 else np.float64
    p = [float(x) for x in np.asarray(tf.filter_spec.p).astype(npdt)]
    return ops, p, cells, rounds


def _state(shape, dtype, batch=2, seed=0, marks=(), nans=()):
    """A stacked (batch, 2, ny, nx) input with spikes at the cells ``marks``
    and NaNs at the cells ``nans`` ((entry, component, y, x) each)."""
    w = torch.as_tensor(np.random.default_rng(seed).random((batch, 2) + shape), dtype=dtype)
    for k, (b, c, y, x) in enumerate(marks):
        w[b, c, y, x] = 40.0 if k % 2 == 0 else -30.0
    for b, c, y, x in nans:
        w[b, c, y, x] = float("nan")
    return w


def _plans(rounds, tile, cap):
    """One plan per round: ``tile``, each round split into balanced launches
    of at most ``cap`` steps."""
    out = []
    for n in rounds:
        steps = _balanced(n, min(cap, n))
        out.append(FusedPlan(tile, max(steps), steps, True))
    return tuple(out)


# -- the fused route against the JAX sharded Pallas path -----------------------

@pytest.mark.parametrize("grid_type, dtype, halo_steps", [
    (B, np.float64, None), (B, np.float64, 3), (B, np.float32, 1),
    (C, np.float64, None), (C, np.float32, 3), (C, np.float64, 1),
])
def test_fused_rounds_match_jax_sharded_pallas(grid_type, dtype, halo_steps):
    shape = (48, 144)
    gv = unit_grid_vars(grid_type, shape, kappa_aniso=0.0)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=gv, device="cpu")
    u, v = (a.astype(dtype) for a in fields((2,) + shape, seed=9))
    cells, rounds = plan_rounds(tf.n_steps, *shape, halo_steps)
    ops = _local_operands(tf, cells, TORCH_DT[dtype])
    p = [float(x) for x in np.asarray(tf.filter_spec.p).astype(dtype)]
    w = torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1)
    w0 = w.clone()
    plans = vlp.plan_vec_local_rounds(rounds, *shape, TORCH_DT[dtype], OPS[grid_type])
    assert all(pl.fused for pl in plans)
    spy = _Spy()
    out = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=spy)
    assert len(spy.calls) == sum(len(pl.steps) for pl in plans)
    assert torch.equal(w, w0), "the rounds must not write into the caller's state"
    want = _jax_sharded_pallas(grid_type, gv, u, v, halo_steps, 6.0)
    steps = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
    for m in (0, 1):
        got = out[:, m].numpy()
        assert got.dtype == want[m].dtype == dtype
        np.testing.assert_allclose(got, want[m], **TOL[dtype])
        np.testing.assert_array_equal(got, steps[:, m].numpy())


@pytest.mark.parametrize("grid_type", [B, C])
def test_fused_rounds_batch_and_nan_match_jax_sharded_pallas(grid_type):
    """A batch of two pairs with NaNs, one at a core corner: a NaN cell stays
    NaN, its neighbours see zero, as in the JAX package's Pallas local pass."""
    shape = (48, 144)
    gv = unit_grid_vars(grid_type, shape, kappa_aniso=0.0)
    tf = gt.Filter(filter_scale=5.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=gv, device="cpu")
    u, v = (np.stack([a, a[::-1] * 0.5]) for a in fields(shape, seed=3))
    u[0, 0, 0] = np.nan  # a core corner: its halo corner sits on the opposite one
    v[1, 31, 64] = np.nan
    cells, rounds = plan_rounds(tf.n_steps, *shape, None)
    ops = _local_operands(tf, cells)
    p = [float(x) for x in tf.filter_spec.p]
    w = torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1)
    spy = _Spy()
    out = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=spy)
    assert spy.calls
    want = _jax_sharded_pallas(grid_type, gv, u, v, None, 5.0)
    for m in (0, 1):
        got = out[:, m].numpy()
        assert (np.isnan(got) == np.isnan(want[m])).all()
        ok = ~np.isnan(want[m])
        np.testing.assert_allclose(got[ok], want[m][ok], **TOL[np.float64])
    assert bool(torch.isnan(out[0, 0, 0, 0])) and bool(torch.isnan(out[1, 1, 31, 64]))


@pytest.mark.parametrize("grid_type", [B, C])
def test_filter_on_1x1_gloo_mesh_matches_jax_sharded_pallas(grid_type, tmp_path):
    """``Filter(mesh=...).apply_to_vector`` on a one-rank gloo ``DeviceMesh``
    runs the fused rounds (every round's plan holds the predicate) and
    matches the JAX sharded Pallas path and the local step chain."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (48, 144)
    gv = unit_grid_vars(grid_type, shape, kappa_aniso=0.0)
    u, v = fields((2,) + shape, seed=11)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
        tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                       grid_vars=gv, device="cpu", mesh=mesh, spatial_axes=("y", "x"),
                       halo_steps=3)
        fn = tf._vector_fn()
        assert all(pl.fused for pl in fn.plan(*shape, torch.float64))
        got = [g.full_tensor().numpy() for g in tf.apply_to_vector(u, v)]
        steps = make_sharded_vector_apply(tf.operator, tf.filter_spec, mesh, ("y", "x"),
                                          halo_steps=3, fused_fn=None)(u, v)
    finally:
        dist.destroy_process_group()
    want = _jax_sharded_pallas(grid_type, gv, u, v, 3, 6.0)
    for m in (0, 1):
        np.testing.assert_allclose(got[m], want[m], **TOL[np.float64])
        np.testing.assert_array_equal(got[m], steps[m].full_tensor().numpy())


# -- the launch bookkeeping: fused rounds == local step chain, exactly --------

@pytest.mark.parametrize("cap", [MAX_FUSE, 3, 2, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["B", "C", "C kappa_aniso=1", "C zap_nans=False"])
def test_plain_fused_rounds_equal_step_chain(case, dtype, cap):
    """``cap`` 16 runs each round in one launch (split (a)), a smaller one in
    launches of at most ``cap`` steps with no exchange between them (split
    (b)); both on 12 steps in rounds of 6 and in rounds of 4 (one more
    exchange each)."""
    shape = (40, 72)
    grid_type = B if case == "B" else C
    for halo_steps in (6, 4):
        ops, p, cells, rounds = _setup(grid_type, shape, dtype, n_steps=12,
                                       halo_steps=halo_steps,
                                       kappa_aniso=1.0 if "kappa" in case else 0.0,
                                       zap="zap" not in case)
        w = _state(shape, dtype, nans=[(0, 0, 20, 36), (1, 1, 0, 71)])
        want = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
        spy = _Spy(vlp.vec_local_fused_pass_reference)
        plans = _plans(rounds, (16, 32), cap)
        got = _fused_vector_rounds(spy, ops, w, p, cells, rounds, LOCAL, LOCAL, plans)
        assert len(spy.calls) == sum(len(pl.steps) for pl in plans)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid_type", [B, C])
def test_launch_sequence(grid_type):
    """Each launch starts where the last one stopped, and ends on the block
    shrunk by cells less the round's steps still to run: the last launch of
    a round on the core. The CPU route counts no kernel launch."""
    shape = (40, 72)
    ops, p, cells, rounds = _setup(grid_type, shape, n_steps=11, halo_steps=4)
    assert (cells, rounds) == (4, (4, 4, 3))
    plans = (_plans(rounds[:1], (8, 32), 2)[0], _plans(rounds[1:2], (16, 16), 4)[0],
             _plans(rounds[2:], (8, 32), 2)[0])
    spy = _Spy()
    before = dict(vlp.vec_local_fused_pass.launches)
    step_before = dict(vlp.vec_local_pass.launches)
    _fused_vector_rounds(spy, ops, _state(shape, torch.float64), p, cells, rounds, LOCAL, LOCAL,
                         plans)
    assert spy.calls == [(0, 2, 2, (8, 32)), (2, 2, 4, (8, 32)), (4, 4, 4, (16, 16)),
                         (8, 2, 3, (8, 32)), (10, 1, 4, (8, 32))]
    assert vlp.vec_local_fused_pass.launches == before
    assert vlp.vec_local_pass.launches == step_before


# -- the tiled plain version: the kernel's decomposition, bit for bit ----------

@pytest.mark.parametrize("tile", [(8, 32), (16, 16), (16, 48), (24, 32), (16, 32)])
@pytest.mark.parametrize("rounds_cap", [(6, 16), (6, 3), (6, 2), (4, 3)])
@pytest.mark.parametrize("case", ["B", "C", "C zap_nans=False"])
def test_tiled_reference_equals_step_chain(case, rounds_cap, tile):
    """Windows cut from the extended block with their corners, spikes and
    NaNs at core corners and at tile seams (the diagonal taps read a halo
    corner from the first step on), launches that end on a margin around the
    core (split (b)): float64, equal to the plain local step chain bit for
    bit. The core holds more than two tiles each way."""
    halo_steps, cap = rounds_cap
    by, bx = tile
    shape = (max(40, 2 * by + 8), max(80, 2 * bx + 16))
    grid_type = B if case == "B" else C
    ops, p, cells, rounds = _setup(grid_type, shape, n_steps=12, halo_steps=halo_steps,
                                   zap="zap" not in case)
    ny, nx = shape
    marks = [(1, 0, 0, 0), (1, 1, ny - 1, nx - 1), (1, 0, ny - 1, 0), (1, 1, 0, nx - 1),
             (1, 0, by, bx), (1, 1, by - 1, bx - 1), (1, 1, by, bx - 1), (1, 0, by - 1, bx)]
    nans = [(0, 0, 0, nx - 1), (0, 1, 2 * by, 2 * bx - 1), (0, 0, ny // 2, nx // 2)]
    w = _state(shape, torch.float64, marks=marks, nans=nans)
    want = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
    got = _fused_vector_rounds(vlp.vec_local_fused_pass_tiled_reference, ops, w, p, cells,
                               rounds, LOCAL, LOCAL, _plans(rounds, tile, cap))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid_type", [B, C])
@pytest.mark.parametrize("shape", [(37, 45), (23, 70), (16, 16)])
def test_tiled_reference_odd_and_small_shapes(grid_type, shape):
    """Cores that are not multiples of the tile (partial tiles at the north
    and east edges of the own region, whose windows reach past the extended
    block and are clamped), and a core smaller than one tile."""
    ops, p, cells, rounds = _setup(grid_type, shape, n_steps=10, halo_steps=5)
    w = _state(shape, torch.float64, marks=[(1, 1, 8, 15), (1, 0, 7, 0), (1, 0, 0, 0)],
               nans=[(0, 1, shape[0] - 1, shape[1] - 1)])
    want = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
    for cap in (5, 2):
        got = _fused_vector_rounds(vlp.vec_local_fused_pass_tiled_reference, ops, w, p, cells,
                                   rounds, LOCAL, LOCAL, _plans(rounds, (8, 32), cap))
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_tiled_reference_single_launch_outputs():
    """One middle launch that ends on a margin: the carries are written on
    the block shrunk by ``shrink`` and nowhere else, acc on the core, equal
    to the plain version's, and the inputs are left as they were."""
    shape = (24, 40)
    ops, p, cells, _ = _setup(C, shape, n_steps=9, halo_steps=6)
    e = (2, 2, shape[0] + 2 * cells, shape[1] + 2 * cells)
    g = np.random.default_rng(4)
    t, t_prev = (torch.as_tensor(g.random(e)) for _ in range(2))
    acc = torch.as_tensor(g.random((2, 2) + shape))
    outs = {}
    for name, fn in (("plain", vlp.vec_local_fused_pass_reference),
                     ("tiled", vlp.vec_local_fused_pass_tiled_reference)):
        t0, tp0 = t.clone(), t_prev.clone()
        o, op_, a = torch.full(e, 7.0), torch.full(e, 7.0), acc.clone()
        fn(ops, p, 2, 3, cells=cells, shrink=4, tile=(8, 32), t=t0, t_prev=tp0,
           t_out=o, t_prev_out=op_, acc=a)
        assert torch.equal(t0, t) and torch.equal(tp0, t_prev)
        outside = torch.ones(e[-2:], dtype=torch.bool)
        outside[4:-4, 4:-4] = False
        assert bool((o[..., outside] == 7.0).all()) and bool((op_[..., outside] == 7.0).all())
        outs[name] = (o, op_, a)
    for x, y in zip(outs["plain"], outs["tiled"]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# -- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_steps, halo_steps", [(11, None), (11, 3), (39, None), (44, 6),
                                                 (7, 1), (16, None)])
def test_plan_splits_rounds_and_fits(n_steps, halo_steps, dtype, op):
    """Each round's launches sum to the round, are balanced, and fit in a
    block's shared memory with a halo no wider than the exchanged one."""
    cells, rounds = plan_rounds(n_steps, 2400, 3600, halo_steps)
    plans = vlp.plan_vec_local_rounds(rounds, 2400, 3600, dtype, op)
    item = torch.empty((), dtype=dtype).element_size()
    assert len(plans) == len(rounds)
    for n, pl in zip(rounds, plans):
        assert sum(pl.steps) == n and pl.halo == max(pl.steps) <= cells
        assert max(pl.steps) - min(pl.steps) <= 1 and pl.fused
        assert vp.vec_fused_shared_bytes(pl.tile, pl.halo, vp.N_COEF[op], item) <= SHARED_BYTES
        assert pl.tile in vp.VEC_TILES[op]


@pytest.mark.parametrize("op, dtype, want", [
    (vp.BGRID, torch.float32, ((32, 64), (6, 5))),
    (vp.CTAP, torch.float32, ((16, 64), (6, 5))),
    (vp.BGRID, torch.float64, ((16, 64), (4, 4, 3))),
    (vp.CTAP, torch.float64, ((16, 32), (6, 5))),
])
def test_plan_headline_round(op, dtype, want):
    """The 11-step round of the 2400x3600 headline on a 1x1 mesh (cells 11):
    split (b), the plans that the round sweep of chip_smoke.py measured
    fastest in float32 (B-grid 32x64 6+5, C-grid 16x64 6+5)."""
    cells, rounds = plan_rounds(11, 2400, 3600, None)
    assert (cells, rounds) == (11, (11,))
    (plan,) = vlp.plan_vec_local_rounds(rounds, 2400, 3600, dtype, op)
    assert (plan.tile, plan.steps) == want


@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_predicate_edges(op, dtype):
    """A round takes the cheapest tile whose window (the tile plus its halo
    in each dimension) fits in the core: at the edge of the headline plan's
    window that plan, one cell less another tile or split that fits; a core
    that no tile of the table fits with a halo of one cell runs the step
    chain."""
    plan_of = lambda n, ly, lx: vlp.plan_vec_local_rounds((n,), ly, lx, dtype, op)[0]  # noqa: E731
    plan = plan_of(7, 2400, 3600)
    (by, bx), h = plan.tile, plan.halo
    edge = (by + 2 * h, bx + 2 * h)
    at_edge = plan_of(7, *edge)
    assert at_edge.fused and (at_edge.tile, at_edge.steps) == (plan.tile, plan.steps)
    for ly, lx in ((edge[0] - 1, edge[1]), (edge[0], edge[1] - 1)):
        pl = plan_of(7, ly, lx)
        assert (pl.tile, pl.steps) != (plan.tile, plan.steps) and sum(pl.steps) == 7
        assert not pl.fused or (ly >= pl.tile[0] + 2 * pl.halo and lx >= pl.tile[1] + 2 * pl.halo)
    min_by = min(t[0] for t in vp.VEC_TILES[op])
    min_bx = min(t[1] for t in vp.VEC_TILES[op])
    for n in (7, 1):
        assert plan_of(n, min_by + 2, 4000).fused and plan_of(n, 4000, min_bx + 2).fused
        assert not plan_of(n, min_by + 1, 4000).fused
        assert not plan_of(n, 4000, min_bx + 1).fused
    with pytest.raises(ValueError, match="unknown vector contraction"):
        vlp.plan_vec_local_rounds((7,), 64, 64, dtype, 7)


@pytest.mark.parametrize("grid_type", [B, C])
def test_rounds_route_by_the_predicate(grid_type):
    """Below the predicate the local step chain runs (the fused launch is not
    called), at it the fused launches run, and ``fused_fn=None`` forces the
    steps; all three give the same bits."""
    min_by = min(t[0] for t in vp.VEC_TILES[OPS[grid_type]])
    for shape, fused in (((min_by + 1, 72), False), ((min_by + 2, 72), True)):
        ops, p, cells, rounds = _setup(grid_type, shape)
        plans = vlp.plan_vec_local_rounds(rounds, *shape, torch.float64, OPS[grid_type])
        assert all(pl.fused == fused for pl in plans)
        w = _state(shape, torch.float64, batch=1)
        results = []
        for fused_fn in (None, "spy"):
            spy, kinds = _Spy(), []

            def step(ops_, kind, *a, **k):
                kinds.append(kind)
                return vlp.vec_local_pass(ops_, kind, *a, **k)

            results.append(local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL,
                                               pass_fn=step,
                                               fused_fn=spy if fused_fn else None))
            want_fused = fused and fused_fn is not None
            assert bool(spy.calls) == want_fused and bool(kinds) == (not want_fused)
        np.testing.assert_array_equal(results[0].numpy(), results[1].numpy())


# -- the wrapper ---------------------------------------------------------------

def test_fused_wrapper_routes_and_refuses():
    """CPU tensors run the plain version and count no launch; other devices
    raise, and so do a shrink outside n_ops..cells and too many steps."""
    shape = (24, 40)
    ops, p, cells, _ = _setup(B, shape, n_steps=9, halo_steps=5)
    e = (1, 2, shape[0] + 2 * cells, shape[1] + 2 * cells)
    we = halo.exchange_2d(_state(shape, torch.float64, batch=1), cells, LOCAL, LOCAL)
    before = dict(vlp.vec_local_fused_pass.launches)
    zeros = lambda: torch.zeros(e, dtype=torch.float64)  # noqa: E731
    t, t_prev, acc = zeros(), zeros(), torch.empty((1, 2) + shape, dtype=torch.float64)
    vlp.vec_local_fused_pass(ops, p, 0, 3, cells=cells, shrink=4, tile=(8, 32), w=we,
                             t_out=t, t_prev_out=t_prev, acc=acc)
    assert vlp.vec_local_fused_pass.launches == before
    t2, tp2, acc2 = zeros(), zeros(), torch.empty_like(acc)
    vlp.vec_local_fused_pass_reference(ops, p, 0, 3, cells=cells, shrink=4, w=we,
                                       t_out=t2, t_prev_out=tp2, acc=acc2)
    assert torch.equal(t, t2) and torch.equal(t_prev, tp2) and torch.equal(acc, acc2)
    meta = torch.empty(e, device="meta")
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        vlp.vec_local_fused_pass(ops, p, 3, 2, cells=cells, tile=(8, 32), t=meta,
                                 t_prev=meta, t_out=meta, t_prev_out=meta,
                                 acc=torch.empty((1, 2) + shape, device="meta"))
    for n_ops, shrink in ((3, 2), (2, cells + 1)):
        with pytest.raises(ValueError, match="shrink"):
            vlp.vec_local_fused_pass_reference(ops, p, 0, n_ops, cells=cells, shrink=shrink,
                                               w=we, t_out=t, t_prev_out=t_prev, acc=acc)
    with pytest.raises(ValueError, match="steps"):
        vlp.vec_local_fused_pass_reference(ops, p, len(p) - 2, 3, cells=cells, t=we,
                                           t_prev=we, acc=acc)


def test_last_launch_leaves_the_result_in_acc():
    """A launch that ends the filter writes only acc, and that acc is the
    filter's result (the plain step chain's LAST)."""
    shape = (24, 40)
    ops, p, cells, rounds = _setup(C, shape, n_steps=8, halo_steps=4)
    assert rounds == (4, 4)
    w = _state(shape, torch.float64)
    want = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
    kinds = []

    def spy_steps(ops_, kind, *a, **k):
        kinds.append(kind)
        return vlp.vec_local_pass_reference(ops_, kind, *a, **k)

    local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, pass_fn=spy_steps,
                        fused_fn=None)
    assert kinds[-1] == LAST and kinds.count(MIDDLE) == 6
    spy = _Spy(vlp.vec_local_fused_pass_reference)
    got = _fused_vector_rounds(spy, ops, w, p, cells, rounds, LOCAL, LOCAL,
                               _plans(rounds, (8, 32), 4))
    assert [c[:3] for c in spy.calls] == [(0, 4, 4), (4, 4, 4)]
    np.testing.assert_array_equal(got.numpy(), want.numpy())
