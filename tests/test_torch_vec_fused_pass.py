"""The fused vector pass of the port on the CPU.

``make_cuda_vector_apply`` runs a vector filter as the fused passes that
``plan_vec_fused_passes`` plans: on the CPU each pass is
``vec_fused_pass_reference``, the plain version of the CUDA kernel
``csrc/vec_tile.cuh`` (entries ``vec_fused_pass_f32/f64`` in
``csrc/vec_pass.cu``). The fused route must match the JAX package's coupled
Pallas kernels in interpret mode at the tolerances of
tests/test_torch_vec_pass.py (f64 rtol 1e-11 / atol 1e-13, f32 rtol 2e-5 /
atol 2e-6), and equal the plain step chain exactly: a fused pass is the same
steps, so any difference is a bookkeeping fault (the p offsets, which pair of
carries a pass reads and writes). ``vec_fused_pass_tiled_reference`` runs the
kernel's tile decomposition (periodic windows with their corners, shrinking
steps) and must equal the step chain bit for bit too; that is where a missing
corner or a wrong wrap shows without a card. The kernels themselves are held
to the step kernels, bit for bit, by chip_smoke.py on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import gcm_filters_tpu as gj
from gcm_filters_tpu.ops.pallas import make_pallas_vector_apply
from gcm_filters_tpu.utils.telemetry import fallback_counts, reset_fallback_counts
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import MAX_FUSE, SHARED_BYTES, FusedPlan
from gcm_filters_tpu_torch.ops.cuda.dispatch import (
    _fused_chain, _vec_step_chain, make_cuda_vector_apply,
)
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts

TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}
B, C = gj.GridType.VECTOR_B_GRID, gj.GridType.VECTOR_C_GRID
OPS = {B: vp.BGRID, C: vp.CTAP}


def unit_grid_vars(grid_type, shape, kappa_aniso=0.0, seed=42):
    """Unit-scale metrics, m = 0.9 + 0.2 * uniform from one numpy seed, as
    benchmarks/bench_suite.py builds the vector grids (kappa_aniso 1 makes
    the C-grid filter amplify on unit metrics)."""
    rng = np.random.default_rng(seed)
    m = 0.9 + 0.2 * rng.random(shape)
    ones = np.ones(shape)
    if grid_type.name == "VECTOR_B_GRID":
        return dict(DXU=m, DYU=m, HUS=m, HUW=m, HTE=m, HTN=m, UAREA=m * m, TAREA=m * m)
    return dict(wet_mask_t=ones, wet_mask_q=ones, dxT=m, dyT=m, dxCu=m, dyCu=m,
                dxCv=m, dyCv=m, dxBu=m, dyBu=m, area_u=m * m, area_v=m * m,
                kappa_iso=ones, kappa_aniso=kappa_aniso * ones)


def fields(shape, seed=7):
    rng = np.random.default_rng(seed)
    return rng.random(shape), rng.random(shape)


class _Spy:
    """A fused_fn that records its calls and runs the plain fused pass."""

    def __init__(self, fn=vp.vec_fused_pass):
        self.fn, self.calls = fn, []

    def __call__(self, ops, p, start, n_ops, **kw):
        self.calls.append((start, n_ops))
        return self.fn(ops, p, start, n_ops, **kw)


def _jax_pallas(jf, u, v):
    """The JAX coupled Pallas path; fails unless its kernels really ran."""
    reset_fallback_counts()
    pallas = make_pallas_vector_apply(jf.operator, jf.filter_spec)
    ju, jv = pallas(jnp.asarray(u), jnp.asarray(v))
    built = pallas.shape_cache.get(u.shape[-2:] + (str(ju.dtype),))
    assert built is not None and built != "xla", "the JAX side did not run its Pallas kernels"
    assert fallback_counts() == {}
    return np.asarray(ju), np.asarray(jv)


def _filters(grid_type, shape, kappa_aniso=0.0, **kw):
    gv = unit_grid_vars(grid_type, shape, kappa_aniso)
    jf = gj.Filter(grid_type=grid_type, grid_vars=gv, use_pallas=False, **kw)
    jkw = {k: (gt.FilterShape[v.name] if k == "filter_shape" else v) for k, v in kw.items()}
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=gv, device="cpu", **jkw)
    return jf, tf


def _assert_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        assert (np.isnan(g) == np.isnan(w)).all()
        ok = ~np.isnan(w)
        np.testing.assert_allclose(g[ok], w[ok], **TOL[dtype])


# -- the fused route against the JAX Pallas path -------------------------------

@pytest.mark.parametrize("filter_shape, dtype, kappa_aniso", [
    ("GAUSSIAN", np.float32, 0.0),
    ("GAUSSIAN", np.float64, 0.0),
    ("GAUSSIAN", np.float64, 1.0),
    ("TAPER", np.float32, 0.0),
    ("TAPER", np.float64, 0.0),
])
@pytest.mark.parametrize("grid_type", [B, C])
def test_fused_dispatch_matches_pallas(grid_type, filter_shape, dtype, kappa_aniso):
    """The Taper with dx_min = 0.9, the metrics' least spacing: with 1 the
    operator's spectrum runs past s_max, where the Taper amplifies rounding
    noise in both packages."""
    shape = (64, 128)
    jf, tf = _filters(grid_type, shape, kappa_aniso, filter_scale=6.0,
                      dx_min=0.9 if filter_shape == "TAPER" else 1.0,
                      filter_shape=gj.FilterShape[filter_shape])
    u, v = (a.astype(dtype) for a in fields(shape))
    want = _jax_pallas(jf, u, v)
    spy = _Spy()
    fn = make_cuda_vector_apply(tf.operator, tf.filter_spec, fused_fn=spy)
    got = [a.numpy() for a in fn(torch.as_tensor(u), torch.as_tensor(v))]
    plan = fn.plan(*shape, torch.float32 if dtype == np.float32 else torch.float64)
    assert plan.fused and [n for _, n in spy.calls] == list(plan.steps)
    assert [s for s, _ in spy.calls] == list(np.cumsum((0,) + plan.steps[:-1]))
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("grid_type", [B, C])
def test_fused_nan_and_batch_match_pallas(grid_type, dtype):
    """NaNs scrub only the contraction's input (a NaN cell stays NaN); a
    batch of two pairs runs as one batch of the kernel."""
    shape = (48, 96)
    jf, tf = _filters(grid_type, shape, filter_scale=5.0, dx_min=1.0)
    u, v = (np.stack([a, a[::-1] * 0.5]).astype(dtype) for a in fields(shape, seed=3))
    u[0, 10, 20] = np.nan
    v[1, 32, 31] = np.nan  # a tile corner of the 16- and 32-row tiles
    want = _jax_pallas(jf, u, v)
    spy = _Spy()
    got = [a.numpy() for a in make_cuda_vector_apply(tf.operator, tf.filter_spec, fused_fn=spy)(
        torch.as_tensor(u), torch.as_tensor(v))]
    assert spy.calls and np.isnan(got[0][0, 10, 20]) and np.isnan(got[1][1, 32, 31])
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("grid_type", [B, C])
def test_three_or_more_passes_match_pallas(grid_type):
    """``max_fuse`` 3 splits the filter into four passes or more: three
    middle passes carry t, t_prev and acc between the two pairs of buffers."""
    shape = (40, 96)
    jf, tf = _filters(grid_type, shape, filter_scale=6.0, dx_min=1.0)
    u, v = fields(shape, seed=5)
    want = _jax_pallas(jf, u, v)
    fn = make_cuda_vector_apply(tf.operator, tf.filter_spec)
    ops, p = fn.operands(torch.float64, torch.device("cpu"))
    plan = vp.plan_vec_fused_passes(tf.n_steps, *shape, torch.float64, OPS[grid_type],
                                    max_fuse=3)
    assert plan.fused and len(plan.steps) >= 3 and plan.halo <= 3
    spy = _Spy()
    acc = _fused_chain(spy, ops, p, plan, torch.as_tensor(np.stack([u, v])[None]), name="w")
    assert [n for _, n in spy.calls] == list(plan.steps)
    _assert_close([acc[0, 0].numpy(), acc[0, 1].numpy()], want, np.float64)


# -- the pass bookkeeping: fused chain == step chain, exactly ------------------

def _operands(grid_type, shape, dtype, n_steps=11, kappa_aniso=0.0, zap=True):
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name],
                   grid_vars=unit_grid_vars(grid_type, shape, kappa_aniso), device="cpu",
                   filter_scale=6.0, dx_min=1.0, n_steps=n_steps)
    op = tf.operator if zap else dataclasses.replace(tf.operator, zap_nans=False)
    ops, p = make_cuda_vector_apply(op, tf.filter_spec).operands(dtype, torch.device("cpu"))
    return ops, p


def _state(shape, dtype, batch=2, seed=0, marks=()):
    """A stacked (batch, 2, ny, nx) input with a NaN, and spikes at the
    cells ``marks`` (component, y, x) of the last entry."""
    ny, nx = shape
    w = torch.as_tensor(np.random.default_rng(seed).random((batch, 2) + shape), dtype=dtype)
    w[0, 0, ny // 2, nx // 2] = float("nan")
    for k, (c, y, x) in enumerate(marks):
        w[-1, c, y, x] = 40.0 if k % 2 == 0 else -30.0
    return w


@pytest.mark.parametrize("steps", [(11,), (6, 5), (4, 4, 3), (3, 3, 3, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["B", "C", "C kappa_aniso=1", "C zap_nans=False"])
def test_fused_chain_equals_step_chain(case, dtype, steps):
    shape = (40, 72)
    grid_type = B if case == "B" else C
    ops, p = _operands(grid_type, shape, dtype, kappa_aniso=1.0 if "kappa" in case else 0.0,
                       zap="zap" not in case)
    w = _state(shape, dtype)
    want = _vec_step_chain(vp.vec_pass_reference, ops, p, 11, w.clone())
    got = _fused_chain(vp.vec_fused_pass_reference, ops, p,
                       FusedPlan((16, 32), max(steps), steps, True), w, name="w")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid_type", [B, C])
def test_fused_route_equals_step_route_end_to_end(grid_type):
    """The default route (fused, several passes: Taper) against
    ``fused_fn=None``; the caller's arrays are not written."""
    shape = (56, 100)
    _, tf = _filters(grid_type, shape, filter_scale=8.0, dx_min=0.9,
                     filter_shape=gj.FilterShape.TAPER)
    u, v = (torch.as_tensor(a) for a in fields(shape, seed=2))
    u0, v0 = u.clone(), v.clone()
    spy = _Spy()
    fn = make_cuda_vector_apply(tf.operator, tf.filter_spec, fused_fn=spy)
    got = fn(u, v)
    want = make_cuda_vector_apply(tf.operator, tf.filter_spec, fused_fn=None)(u, v)
    plan = fn.plan(*shape, torch.float64)
    assert plan.fused and len(plan.steps) > 1 and len(spy.calls) == len(plan.steps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert torch.equal(u, u0) and torch.equal(v, v0)


# -- the planner ---------------------------------------------------------------

@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_steps", [2, 5, 11, 16, 17, 39, 100])
def test_plan_is_balanced_and_fits(n_steps, dtype, op):
    plan = vp.plan_vec_fused_passes(n_steps, 2400, 3600, dtype, op)
    assert sum(plan.steps) == n_steps and plan.halo == max(plan.steps) <= MAX_FUSE
    assert max(plan.steps) - min(plan.steps) <= 1
    assert len(plan.steps) == -(-n_steps // plan.halo)
    item = torch.empty((), dtype=dtype).element_size()
    assert vp.vec_fused_shared_bytes(plan.tile, plan.halo, vp.N_COEF[op], item) <= SHARED_BYTES
    assert plan.tile in vp.VEC_TILES[op] and plan.fused
    if n_steps <= plan.halo:
        assert plan.steps == (n_steps,)


@pytest.mark.parametrize("op, dtype, want", [
    (vp.BGRID, torch.float32, ((32, 64), (6, 5))),
    (vp.CTAP, torch.float32, ((16, 64), (6, 5))),
    (vp.BGRID, torch.float64, ((16, 64), (4, 4, 3))),
    (vp.CTAP, torch.float64, ((16, 32), (6, 5))),
])
def test_plan_headline_choices(op, dtype, want):
    """The plans that the tile sweep of chip_smoke.py measured fastest on the
    11-step 2400x3600 headlines: one 11-step pass fits no tile that wins
    (the window's planes leave one block an SM), two or three passes do."""
    plan = vp.plan_vec_fused_passes(11, 2400, 3600, dtype, op)
    assert (plan.tile, plan.steps) == want


@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("max_fuse, want", [(16, None), (6, (6, 5)), (4, (4, 4, 3)), (3, None)])
def test_plan_max_fuse(op, max_fuse, want):
    """``max_fuse`` caps the steps a pass takes; the split stays balanced."""
    plan = vp.plan_vec_fused_passes(11, 2400, 3600, torch.float32, op, max_fuse=max_fuse)
    assert plan.halo <= max_fuse and sum(plan.steps) == 11
    if want is not None and plan.halo == max_fuse:
        assert plan.steps == want


def test_plan_one_pass_when_it_fits():
    """A filter no longer than the halo the best tile can hold is one pass."""
    for op in (vp.BGRID, vp.CTAP):
        plan = vp.plan_vec_fused_passes(2, 2400, 3600, torch.float32, op)
        assert plan.steps == (2,) and plan.halo == 2


@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plan_predicate_edges(op, dtype):
    """The fused route needs a field at least a tile plus its halo on both
    sides, in each dimension; the predicate reads shape, dtype and op only."""
    plan = vp.plan_vec_fused_passes(11, 2400, 3600, dtype, op)
    (by, bx), h = plan.tile, plan.halo
    edge = (by + 2 * h, bx + 2 * h)
    at_edge = vp.plan_vec_fused_passes(11, *edge, dtype, op)
    assert at_edge.fused and (at_edge.tile, at_edge.steps) == (plan.tile, plan.steps)
    assert not vp.plan_vec_fused_passes(11, edge[0] - 1, edge[1], dtype, op).fused
    assert not vp.plan_vec_fused_passes(11, edge[0], edge[1] - 1, dtype, op).fused
    with pytest.raises(ValueError, match="unknown vector contraction"):
        vp.plan_vec_fused_passes(11, 64, 64, dtype, 7)


@pytest.mark.parametrize("grid_type", [B, C])
def test_dispatch_routes_by_the_predicate(grid_type):
    """Below the predicate the step chain runs (the fused pass is not called);
    at it the fused passes run; ``fused_fn=None`` forces the steps."""
    n_steps = _filters(grid_type, (8, 8), filter_scale=6.0, dx_min=1.0)[1].n_steps
    plan = vp.plan_vec_fused_passes(n_steps, 2400, 3600, torch.float64, OPS[grid_type])
    (by, bx), h = plan.tile, plan.halo
    for shape, fused in (((by + 2 * h - 1, bx + 2 * h), False), ((by + 2 * h, bx + 2 * h), True)):
        _, tf = _filters(grid_type, shape, filter_scale=6.0, dx_min=1.0)
        u, v = (torch.as_tensor(a) for a in fields(shape))
        for fused_fn, want_calls in ((None, False), ("spy", fused)):
            spy, kinds = _Spy(), []

            def step(ops, kind, *a, **k):
                kinds.append(kind)
                return vp.vec_pass(ops, kind, *a, **k)

            fn = make_cuda_vector_apply(tf.operator, tf.filter_spec, pass_fn=step,
                                        fused_fn=spy if fused_fn else None)
            assert fn.plan(*shape, torch.float64).fused == fused
            got = fn(u, v)
            assert bool(spy.calls) == want_calls and bool(kinds) == (not want_calls)
            assert got[0].shape == shape


# -- the tiled plain version: the kernel's decomposition, bit for bit ----------

@pytest.mark.parametrize("tile", [(8, 32), (16, 16), (16, 48), (24, 32), (16, 32)])
@pytest.mark.parametrize("steps", [(6,), (4, 4), (3, 3, 2), (1, 2)])
@pytest.mark.parametrize("case", ["B", "C", "C zap_nans=False"])
def test_tiled_reference_equals_step_chain(case, steps, tile):
    """Windows periodic in both axes with their corners, spikes and a NaN at
    tile corners and seams (the diagonal taps reach a corner cell of the
    window from the first step on): float64, equal to the plain step chain
    bit for bit. The field holds more than two tiles each way."""
    by, bx = tile
    shape = (max(40, 2 * by + 8), max(80, 2 * bx + 16))
    n = sum(steps)
    grid_type = B if case == "B" else C
    ops, p = _operands(grid_type, shape, torch.float64, n_steps=n, zap="zap" not in case)
    marks = [(0, by, bx), (1, by - 1, bx - 1), (1, by, bx - 1), (0, by - 1, bx),
             (0, 0, 0), (1, shape[0] - 1, shape[1] - 1)]
    w = _state(shape, torch.float64, marks=marks)
    w[1, 1, 2 * by - 1, 2 * bx] = float("nan")  # a NaN at a tile corner
    want = _vec_step_chain(vp.vec_pass_reference, ops, p, n, w.clone())
    got = _fused_chain(vp.vec_fused_pass_tiled_reference, ops, p,
                       FusedPlan(tile, max(steps), steps, True), w, name="w")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("grid_type", [B, C])
@pytest.mark.parametrize("shape", [(37, 45), (45, 83), (20, 40)])
def test_tiled_reference_odd_and_small_shapes(grid_type, shape):
    """Shapes that are not multiples of the tile (partial tiles at the north
    and east edges), and fields narrower than two tiles, where a window wraps
    onto itself (20x40 on 16x32 tiles with a halo of 6: a 44-cell-wide
    window on 40 columns)."""
    ops, p = _operands(grid_type, shape, torch.float64, n_steps=12)
    w = _state(shape, torch.float64, marks=[(1, 16, 32 % shape[1]), (0, 15, 31)])
    want = _vec_step_chain(vp.vec_pass_reference, ops, p, 12, w.clone())
    got = _fused_chain(vp.vec_fused_pass_tiled_reference, ops, p,
                       FusedPlan((16, 32), 6, (6, 6), True), w, name="w")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# -- the wrappers --------------------------------------------------------------

def test_fused_wrapper_refuses_other_devices():
    ops, p = _operands(B, (8, 16), torch.float32, n_steps=4)
    meta = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="steps"):
        vp.vec_fused_pass_reference(ops, p, len(p) - 2, 3, t=meta, t_prev=meta, acc=meta)


@pytest.mark.parametrize("grid_type", [B, C])
def test_plain_fused_pass_counts_no_launch(grid_type):
    """The CPU route runs the plain version: no kernel launch is counted, and
    a middle pass leaves its inputs as they were."""
    shape = (24, 40)
    ops, p = _operands(grid_type, shape, torch.float64, n_steps=9)
    before = launch_counts()
    w = _state(shape, torch.float64, batch=1)
    t, t_prev, acc = (torch.empty_like(w) for _ in range(3))
    vp.vec_fused_pass(ops, p, 0, 3, tile=(8, 32), w=w, t_out=t, t_prev_out=t_prev, acc=acc)
    t0, tp0, a0 = t.clone(), t_prev.clone(), acc.clone()
    t2, tp2 = torch.empty_like(w), torch.empty_like(w)
    vp.vec_fused_pass(ops, p, 3, 3, tile=(8, 32), t=t, t_prev=t_prev, t_out=t2,
                      t_prev_out=tp2, acc=acc)
    vp.vec_fused_pass(ops, p, 6, 3, tile=(8, 32), t=t2, t_prev=tp2, acc=acc)
    assert launch_counts() == before
    np.testing.assert_array_equal(t.numpy(), t0.numpy())
    np.testing.assert_array_equal(t_prev.numpy(), tp0.numpy())
    assert not np.array_equal(acc.numpy(), a0.numpy(), equal_nan=True)
    want = _vec_step_chain(vp.vec_pass_reference, ops, p, 9, w.clone())
    np.testing.assert_array_equal(acc.numpy(), want.numpy())
