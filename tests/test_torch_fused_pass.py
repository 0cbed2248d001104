"""The fused scalar pass of the port on the CPU.

``make_cuda_scalar_apply`` now runs a filter as the fused passes that
``plan_fused_passes`` plans: on the CPU each pass is
``cheb_fused_pass_reference``, the plain version of the CUDA kernel
``csrc/cheb_tile.cuh`` (entries in ``csrc/cheb_pass.cu``). The fused route
must match the JAX package's Pallas path in interpret mode at the tolerances
of tests/test_torch_cheb_pass.py (f64 rtol 1e-11 / atol 1e-13, f32 rtol 2e-5
/ atol 2e-6), and equal the plain step chain exactly: a fused pass is the
same steps, so any difference is a bookkeeping fault (the p offsets, the
carries between passes). ``cheb_fused_pass_tiled_reference`` runs the
kernel's tile decomposition (windows, shrinking steps, mirror cells at the
fold) and must equal the step chain bit for bit too; that is where a wrong
mirror index shows without a card. The fused local round of the sharded
engine (``local_strip_pass``, on halo strips) must equal the local step
chain exactly. The
kernels themselves are held to the step kernels, bit for bit, by
chip_smoke.py on the card.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gcm_filters_tpu import Filter as JFilter, FilterShape, GridType
from gcm_filters_tpu.engine import scalar_filter_apply as jengine
from gcm_filters_tpu.ops.pallas import make_pallas_scalar_apply
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda import local_pass as lp
from gcm_filters_tpu_torch.ops.cuda.dispatch import _fused_chain, _step_chain, make_cuda_scalar_apply
from gcm_filters_tpu_torch.ops.stencil import hspace_drop_pre
from gcm_filters_tpu_torch.parallel.sharded import (
    local_rounds_scalar, local_scalar_operands, plan_rounds,
)

TOL = {np.float32: dict(rtol=2e-5, atol=2e-6), np.float64: dict(rtol=1e-11, atol=1e-13)}
TRI = "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED"
POP = "TRIPOLAR_POP_WITH_LAND"
LOCAL = (None, 1)


def _grid_vars(grid_name, shape, seed=0):
    """Grid variables from a numpy seed: a land mask with an Antarctica row
    and an island, metrics in [0.9, 1.1), the POP seam rows folded onto
    themselves."""
    ny, nx = shape
    rng = np.random.default_rng(seed)
    wet = np.ones(shape)
    wet[0] = 0
    wet[: ny // 2, : nx // 3] = 0
    gv = {}
    for k in gt.required_grid_vars(gt.GridType[grid_name]):
        gv[k] = (wet if k == "wet_mask" else np.ones(shape) if "kappa" in k
                 else 0.9 + 0.2 * rng.random(shape))
    if grid_name == POP:
        for k in ("dxn", "dyn"):
            gv[k][-1, nx // 2:] = gv[k][-1, : nx // 2][::-1]
    return gv


def _pair(grid_type, grid_vars, exact_nan=False, **kw):
    jf = JFilter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", exact_nan=exact_nan, **kw)
    return jf, tf


class _Spy:
    """A fused_fn that counts its calls and runs the plain fused pass."""

    def __init__(self, fn=cp.cheb_fused_pass):
        self.fn, self.calls = fn, []

    def __call__(self, ops, p, start, n_ops, **kw):
        self.calls.append((start, n_ops))
        return self.fn(ops, p, start, n_ops, **kw)


def _port(tf, x, exact_nan=False, **kw):
    spy = _Spy()
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec, exact_nan=exact_nan,
                                fused_fn=spy, **kw)
    return fn(torch.as_tensor(x)).numpy(), spy, fn


# -- the fused route against the JAX Pallas path -------------------------------

@pytest.mark.parametrize("shape", ["GAUSSIAN", "TAPER"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_dispatch_matches_pallas(scalar_grid_data_with_mom5, dtype, shape):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    kw = dict(filter_scale=6.0, dx_min=1.0)
    if shape == "TAPER":
        jf = JFilter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False,
                     filter_shape=FilterShape.TAPER, **kw)
        tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                       device="cpu", filter_shape=gt.FilterShape.TAPER, **kw)
    else:
        jf, tf = _pair(grid_type, grid_vars, **kw)
    x = data.astype(dtype)
    want = np.asarray(make_pallas_scalar_apply(jf.operator, jf.filter_spec)(jnp.asarray(x)))
    got, spy, fn = _port(tf, x)
    plan = fn.plan(*x.shape, torch.float32 if dtype == np.float32 else torch.float64)
    assert plan.fused and [n for _, n in spy.calls] == list(plan.steps)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("grid_name", [TRI, "REGULAR_WITH_LAND"])
def test_fused_exact_nan(grid_name):
    """exact_nan keeps the pre mask in the window: equal to the Pallas
    exact_nan path, wet and land NaNs included."""
    ny, nx = 70, 128
    gv = _grid_vars(grid_name, (ny, nx), seed=1)
    gv["wet_mask"][5:9, 80:90] = 0
    jf, tf = _pair(GridType[grid_name], gv, exact_nan=True, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(7).random((ny, nx))
    data[40, 100] = np.nan  # wet
    data[6, 83] = np.nan    # land
    want = np.asarray(make_pallas_scalar_apply(jf.operator, jf.filter_spec, exact_nan=True)(
        jnp.asarray(data)))
    got, spy, _ = _port(tf, data, exact_nan=True)
    assert spy.calls and (np.isnan(got) == np.isnan(want)).all() and np.isnan(got[40, 100])
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], **TOL[np.float64])


def test_fused_batch_and_odd_fold_shape():
    ny, nx = 67, 131
    gv = _grid_vars(TRI, (ny, nx), seed=4)
    jf, tf = _pair(GridType[TRI], gv, filter_scale=4.0, dx_min=1.0)
    data = np.random.default_rng(3).random((2, 3, ny, nx))
    want = np.asarray(jengine(jf.operator, jf.filter_spec, jnp.asarray(data)))
    got, spy, fn = _port(tf, data)
    plan = fn.plan(ny, nx, torch.float64)
    assert got.shape == data.shape and plan.fused and len(spy.calls) == len(plan.steps)
    np.testing.assert_allclose(got, want, **TOL[np.float64])


# -- the pass bookkeeping: fused chain == step chain, exactly ------------------

def _operands(grid_name, shape, dtype, exact_nan=False, **kw):
    tf = gt.Filter(grid_type=gt.GridType[grid_name], grid_vars=_grid_vars(grid_name, shape),
                   device="cpu", exact_nan=exact_nan, dtype=dtype, filter_scale=6.0,
                   dx_min=1.0, **kw)
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec, exact_nan=exact_nan)
    ops, p = fn.operands(dtype, torch.device("cpu"))
    return tf, ops, p


def _field(shape, dtype, batch=2, seed=0):
    ny, nx = shape
    x = np.random.default_rng(seed).random((batch,) + shape)
    x[0, -1, 3] = 40.0          # a spike on the fold row
    x[-1, -1, nx - 4] = -25.0   # and its mirror side
    x[0, ny // 2, nx // 2] = np.nan
    return torch.as_tensor(x, dtype=dtype)


@pytest.mark.parametrize("steps", [(11,), (6, 5), (4, 4, 3), (3, 3, 3, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid_name", [TRI, "IRREGULAR_WITH_LAND", "REGULAR"])
def test_fused_chain_equals_step_chain(grid_name, dtype, steps):
    shape = (40, 72)
    tf, ops, p = _operands(grid_name, shape, dtype, n_steps=11)
    x = _field(shape, dtype)
    want = _step_chain(cp.cheb_pass_reference, ops, p, 11, x)
    plan = cp.FusedPlan((16, 32), max(steps), steps, True)
    got = _fused_chain(cp.cheb_fused_pass_reference, ops, p, plan, x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_fused_route_equals_step_route_end_to_end():
    """The default route (fused, several passes) against ``fused_fn=None``."""
    shape = (80, 140)
    tf = gt.Filter(grid_type=gt.GridType[POP], grid_vars=_grid_vars(POP, shape), device="cpu",
                   filter_scale=8.0, dx_min=1.0, filter_shape=gt.FilterShape.TAPER)
    x = _field(shape, torch.float64)
    steps_fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec, fused_fn=None)
    got, spy, fn = _port(tf, x.numpy())
    plan = fn.plan(*shape, torch.float64)
    assert plan.fused and len(plan.steps) > 1 and len(spy.calls) == len(plan.steps)
    assert [s for s, _ in spy.calls] == list(np.cumsum((0,) + plan.steps[:-1]))
    np.testing.assert_array_equal(got, steps_fn(x).numpy())


# -- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("n_planes", [2, 4, 5, 7, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_steps", [2, 5, 11, 16, 17, 39, 100])
def test_plan_fused_passes_is_balanced_and_fits(n_steps, dtype, n_planes):
    plan = cp.plan_fused_passes(n_steps, 2400, 3600, dtype, n_planes)
    assert sum(plan.steps) == n_steps and plan.halo == max(plan.steps) <= cp.MAX_FUSE
    assert max(plan.steps) - min(plan.steps) <= 1
    assert len(plan.steps) == -(-n_steps // plan.halo)
    item = torch.empty((), dtype=dtype).element_size()
    assert cp.fused_shared_bytes(plan.tile, plan.halo, n_planes, item) <= cp.SHARED_BYTES
    assert plan.tile in cp.TILES and plan.fused
    if n_steps <= plan.halo:
        assert plan.steps == (n_steps,)


@pytest.mark.parametrize("n_steps, dtype, n_planes, want", [
    (11, torch.float32, 4, ((40, 80), (11,))),           # the headline: one pass
    (39, torch.float32, 4, ((40, 80), (10, 10, 10, 9))),  # Taper: two blocks an SM
    (11, torch.float32, 7, ((40, 80), (11,))),           # five coefficient planes
    (11, torch.float64, 4, ((40, 80), (11,))),
])
def test_plan_fused_passes_headline_choices(n_steps, dtype, n_planes, want):
    """The plans that the tile sweeps of chip_smoke.py measured fastest, or
    within 1% of it, on the 2400x3600 headlines: the 40x80 tile and the
    fewest passes, except where a pass's window would leave one block an SM
    (the Taper at 13 steps a pass ran 34% slower than at 10)."""
    plan = cp.plan_fused_passes(n_steps, 2400, 3600, dtype, n_planes)
    assert (plan.tile, plan.steps) == want


@pytest.mark.parametrize("n_steps, cap, want", [
    (39, 16, (13, 13, 13)), (39, 13, (13, 13, 13)), (11, 6, (6, 5)), (17, 16, (9, 8)),
    (11, 16, (11,)), (12, 4, (4, 4, 4)), (39, 8, (8, 8, 8, 8, 7)),
])
def test_balanced_split(n_steps, cap, want):
    """The balanced split of plan_passes:426-430: ceil(n/cap) near-equal
    passes, never a short trailing pass."""
    assert cp._balanced(n_steps, cap) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_predicate_edges(dtype):
    """The fused route needs a field at least a tile plus its halo on both
    sides, in each dimension; the predicate reads the shape and dtype only."""
    plan = cp.plan_fused_passes(11, 2400, 3600, dtype, 4)
    (by, bx), h = plan.tile, plan.halo
    edge = (by + 2 * h, bx + 2 * h)
    assert cp.plan_fused_passes(11, *edge, dtype, 4).fused
    assert not cp.plan_fused_passes(11, edge[0] - 1, edge[1], dtype, 4).fused
    assert not cp.plan_fused_passes(11, edge[0], edge[1] - 1, dtype, 4).fused
    assert cp.plan_fused_passes(11, *edge, dtype, 4).steps == plan.steps
    # one pass of more than MAX_FUSE steps (a sharded round) plans no fused route
    assert not cp.plan_fused_passes(20, 2400, 3600, dtype, 4, one_pass=True).fused
    assert cp.plan_fused_passes(12, 2400, 3600, dtype, 4, one_pass=True).steps == (12,)


def test_dispatch_routes_by_the_predicate():
    """Below the predicate the step chain runs (the fused pass is not called);
    at and above it the fused passes run; ``fused_fn=None`` forces the steps."""
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, device="cpu")  # REGULAR, any shape
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec)
    (by, bx), h = fn.plan(2400, 3600, torch.float64).tile, fn.plan(2400, 3600, torch.float64).halo
    small = (by + 2 * h - 1, bx + 2 * h)
    for shape, fused in ((small, False), ((by + 2 * h, bx + 2 * h), True)):
        x = torch.as_tensor(np.random.default_rng(1).random(shape))
        for fused_fn, want_calls in ((None, False), ("spy", fused)):
            spy, kinds = _Spy(), []

            def step(ops, kind, *a, **k):
                kinds.append(kind)
                return cp.cheb_pass(ops, kind, *a, **k)

            got = make_cuda_scalar_apply(tf.operator, tf.filter_spec, pass_fn=step,
                                         fused_fn=spy if fused_fn else None)(x)
            assert bool(spy.calls) == want_calls and bool(kinds) == (not want_calls)
            assert got.shape == shape


# -- the tiled plain version: the kernel's decomposition, bit for bit ----------

@pytest.mark.parametrize("tile", [(16, 32), (8, 32), (16, 64)])
@pytest.mark.parametrize("steps", [(16,), (11,), (5, 5, 5)])
@pytest.mark.parametrize("grid_name", [TRI, POP, "REGULAR"])
def test_tiled_reference_equals_step_chain(grid_name, steps, tile):
    """Windows with a halo on all four sides, mirror cells above the fold
    stepped as their real cells, spikes at the tile seams and on the fold
    row: float64, equal to the plain step chain bit for bit."""
    n = sum(steps)
    shape = (48, 96)
    tf, ops, p = _operands(grid_name, shape, torch.float64, n_steps=n)
    x = _field(shape, torch.float64)
    x[1, -1, tile[1] - 1] = 50.0   # the fold row at a tile seam
    x[1, tile[0], tile[1]] = -30.0  # a tile corner
    want = _step_chain(cp.cheb_pass_reference, ops, p, n, x)
    plan = cp.FusedPlan(tile, max(steps), steps, True)
    tiled = functools.partial(cp.cheb_fused_pass_tiled_reference)
    got = _fused_chain(tiled, ops, p, plan, x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("exact_nan", [False, True])
@pytest.mark.parametrize("shape", [(45, 83), (37, 70)])
def test_tiled_reference_odd_shapes(shape, exact_nan):
    """Shapes that are not multiples of the tile: partial tiles at the top
    (whose windows reach past the fold) and at the east edge."""
    tf, ops, p = _operands(TRI, shape, torch.float64, exact_nan=exact_nan, n_steps=12)
    x = _field(shape, torch.float64)
    want = _step_chain(cp.cheb_pass_reference, ops, p, 12, x)
    got = _fused_chain(cp.cheb_fused_pass_tiled_reference, ops, p,
                       cp.FusedPlan((16, 32), 6, (6, 6), True), x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- the fused local round of the sharded engine --------------------------------

def _local_operands(tf, x, halo_steps, exact_nan=False):
    op, spec = tf.operator, tf.filter_spec
    dtype = x.dtype
    drop_pre = hspace_drop_pre(op) and not exact_nan
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if drop_pre else op
    cells, rounds = plan_rounds(spec.n_steps, *x.shape[-2:], halo_steps)
    p_host = np.asarray(spec.p, dtype=np.float64)
    ops = local_scalar_operands(
        hot.to(dtype, "cpu"), cells, LOCAL, LOCAL, dtype,
        -2.0 * _laplacian_scale(spec, op.is_dimensional), drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, p_host)))
    npdt = np.float32 if dtype == torch.float32 else np.float64
    return ops, [float(v) for v in p_host.astype(npdt)], cells, rounds, op.fold_north


@pytest.mark.parametrize("halo_steps", [None, 4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid_name", [TRI, POP, "IRREGULAR_WITH_LAND", "REGULAR_WITH_LAND"])
def test_local_fused_round_equals_step_chain(grid_name, dtype, halo_steps):
    shape = (72, 136)
    tf = gt.Filter(grid_type=gt.GridType[grid_name], grid_vars=_grid_vars(grid_name, shape),
                   device="cpu", dtype=dtype, filter_scale=6.0, dx_min=1.0)
    x = _field(shape, dtype)
    ops, p, cells, rounds, fold = _local_operands(tf, x, halo_steps)
    want = local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold, fused_fn=None)
    spy = _Spy(lp.local_strip_pass)
    got = local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold, fused_fn=spy)
    assert [n for _, n in spy.calls] == list(rounds)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_local_fused_round_below_predicate_runs_steps():
    shape = (20, 30)
    tf = gt.Filter(grid_type=gt.GridType[TRI], grid_vars=_grid_vars(TRI, shape), device="cpu",
                   filter_scale=6.0, dx_min=1.0)
    x = _field(shape, torch.float64)
    ops, p, cells, rounds, fold = _local_operands(tf, x, None)
    spy = _Spy(lp.local_strip_pass)
    got = local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold, fused_fn=spy)
    want = local_rounds_scalar(ops, x, p, cells, rounds, LOCAL, LOCAL, fold, fused_fn=None)
    assert not spy.calls
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- the wrappers --------------------------------------------------------------

def test_fused_wrappers_refuse_other_devices():
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    ops, p = make_cuda_scalar_apply(tf.operator, tf.filter_spec).operands(
        torch.float32, torch.device("cpu"))
    meta = torch.empty((1, 4, 4), device="meta")
    with pytest.raises(ValueError, match="steps"):
        cp.cheb_fused_pass_reference(ops, p, len(p) - 2, 3, field=meta, acc=meta)
