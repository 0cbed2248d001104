"""The port's local pass on the CPU against the JAX per-shard Pallas pass.

``local_rounds_scalar`` on unsharded axes chains ``local_pass_reference``,
the plain PyTorch version of the CUDA kernel ``csrc/local_pass.cu``. It must
match ``gcm_filters_tpu.parallel.sharded.local_pallas_rounds_scalar``, which
runs ``build_local_pass`` in interpret mode on the CPU, for the same stencil
and field at f64 rtol 1e-11 / atol 1e-13 (tests/test_sharded.py's bar for the
Pallas local compute) and f32 rtol 2e-5 / atol 2e-6. Each step kind of
``local_pass_reference`` is also held against the port's unsharded step
``cheb_pass_reference`` on the core of a periodic or folded field. The CUDA
kernel itself is checked against the same plain version on the card by
chip_smoke.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gcm_filters_tpu import Filter as JFilter, GridType
from gcm_filters_tpu.engine import _cast_operator, _laplacian_scale as j_lap_scale
from gcm_filters_tpu.ops.stencil import hspace_drop_pre as j_drop_pre
from gcm_filters_tpu.parallel.sharded import local_pallas_rounds_scalar
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.cuda import local_pass as lp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, LAST, MIDDLE, cheb_pass_reference
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_scalar_apply
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.stencil import hspace_drop_pre
from gcm_filters_tpu_torch.parallel import halo
from gcm_filters_tpu_torch.parallel.sharded import (
    _balanced, local_rounds_scalar, local_scalar_operands, plan_rounds,
)

LOCAL = (None, 1)
TOL = {np.float64: dict(rtol=1e-11, atol=1e-13), np.float32: dict(rtol=2e-5, atol=2e-6)}
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}


def _jax_local_rounds(jf, x, halo_steps, exact_nan=False):
    op = jf.operator
    spec = jf.filter_spec
    names = tuple(k for k in ("c", "n", "s", "e", "w")
                  if not isinstance(getattr(op, k), (int, float)))
    consts = {k: float(getattr(op, k)) for k in ("c", "n", "s", "e", "w") if k not in names}
    drop_pre = j_drop_pre(op) and not exact_nan
    p_host = np.asarray(spec.p)
    land_gain = float(np.polynomial.chebyshev.chebval(-1.0, p_host))
    st = _cast_operator(op, x.dtype)
    fn = jax.jit(lambda f: local_pallas_rounds_scalar(
        st, f, p_host, spec.n_steps, j_lap_scale(spec, op.is_dimensional), drop_pre,
        land_gain, names, consts, LOCAL, LOCAL, halo_steps))
    return np.asarray(fn(jnp.asarray(x)))


def _port_local_rounds(tf, x, halo_steps, exact_nan=False):
    """The port's rounds on unsharded axes: no mesh, no process group."""
    op, spec = tf.operator, tf.filter_spec
    dtype = TORCH_DT[x.dtype.type]
    drop_pre = hspace_drop_pre(op) and not exact_nan
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if drop_pre else op
    cells, rounds = plan_rounds(spec.n_steps, *x.shape[-2:], halo_steps)
    p_host = np.asarray(spec.p, dtype=np.float64)
    ops = local_scalar_operands(
        hot.to(dtype, "cpu"), cells, LOCAL, LOCAL, dtype,
        -2.0 * _laplacian_scale(spec, op.is_dimensional), drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, p_host)))
    p = [float(v) for v in p_host.astype(x.dtype)]
    out = local_rounds_scalar(ops, torch.as_tensor(x)[None], p, cells, rounds,
                              LOCAL, LOCAL, op.fold_north)
    return out[0].numpy(), cells, rounds


def _pair(grid_type, grid_vars, **kw):
    jf = JFilter(grid_type=grid_type, grid_vars=grid_vars, use_pallas=False, **kw)
    tf = gt.Filter(grid_type=gt.GridType[grid_type.name], grid_vars=grid_vars,
                   device="cpu", **kw)
    return jf, tf


@pytest.mark.parametrize("halo_steps", [None, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_local_rounds_match_pallas(scalar_grid_data_with_mom5, dtype, halo_steps):
    grid_type, data, grid_vars = scalar_grid_data_with_mom5
    jf, tf = _pair(grid_type, grid_vars, filter_scale=6.0, dx_min=1.0)
    x = data.astype(dtype)
    got, _, rounds = _port_local_rounds(tf, x, halo_steps)
    want = _jax_local_rounds(jf, x, halo_steps)
    assert sum(rounds) == tf.n_steps and got.dtype == want.dtype == dtype
    np.testing.assert_allclose(got, want, **TOL[dtype])


@pytest.mark.parametrize("exact_nan", [False, True])
def test_local_rounds_nan_semantics(exact_nan):
    """A wet and a land NaN, odd shape, fold: NaN cells stay NaN and the rest
    agrees with the Pallas local pass in both NaN modes."""
    ny, nx = 37, 50
    wet = np.ones((ny, nx)); wet[0] = 0; wet[5:9, 30:40] = 0
    area = 0.9 + 0.2 * np.random.default_rng(4).random((ny, nx))
    jf, tf = _pair(GridType.TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED,
                   {"area": area, "wet_mask": wet}, filter_scale=4.0, dx_min=1.0)
    x = np.random.default_rng(3).random((ny, nx))
    x[12, 20] = np.nan  # wet
    x[6, 33] = np.nan   # land
    got, _, _ = _port_local_rounds(tf, x, 3, exact_nan)
    want = _jax_local_rounds(jf, x, 3, exact_nan)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[12, 20]) and np.isnan(got[6, 33])
    np.testing.assert_allclose(got, want, equal_nan=True, rtol=1e-11, atol=1e-13)


@pytest.mark.parametrize("n_steps,halo_steps,ly,lx,want", [
    (11, None, 2400, 3600, (11, (11,))),
    (11, 4, 128, 256, (4, (4, 4, 3))),
    (7, 1, 64, 64, (1, (1,) * 7)),
    (20, 16, 128, 256, (10, (10, 10))),
    (11, 16, 6, 40, (3, (3, 3, 3, 2))),   # a tiny shard clamps the halo
    (5, None, 1, 8, (1, (1,) * 5)),
])
def test_plan_rounds(n_steps, halo_steps, ly, lx, want):
    cells, rounds = plan_rounds(n_steps, ly, lx, halo_steps)
    assert (cells, rounds) == want
    assert sum(rounds) == n_steps and cells <= min(ly, lx)
    assert _balanced(n_steps, cells) == rounds


def _step_setup(grid_name, exact_nan, cells=3):
    """Unsharded step operands, their halo-extended twins, and a field."""
    ny, nx = 24, 40
    rng = np.random.default_rng(8)
    wet = np.ones((ny, nx)); wet[0] = 0; wet[4:9, 10:20] = 0
    gv = {"wet_mask": wet}
    if "AREA" in grid_name:
        gv["area"] = 0.9 + 0.2 * rng.random((ny, nx))
    if grid_name == "IRREGULAR_WITH_LAND":
        gv.update({k: 0.9 + 0.2 * rng.random((ny, nx)) for k in ("dxw", "dyw", "dxs", "dys", "area")})
        gv.update(kappa_w=np.ones((ny, nx)), kappa_s=np.ones((ny, nx)))
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_name],
                   grid_vars=gv, device="cpu", exact_nan=exact_nan)
    fn = make_cuda_scalar_apply(tf.operator, tf.filter_spec, exact_nan=exact_nan)
    ops, p = fn.operands(torch.float64, torch.device("cpu"))
    op = tf.operator
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if ops.drop_pre else op
    ext_ops = local_scalar_operands(
        hot.to(torch.float64, "cpu"), cells, LOCAL, LOCAL, torch.float64,
        -2.0 * _laplacian_scale(tf.filter_spec, op.is_dimensional), ops.drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, tf.filter_spec.p)))
    x = rng.random((2, ny, nx))
    x[0, 15, 30] = np.nan  # wet
    x[1, 0, 3] = np.nan    # land
    return tf, ops, ext_ops, p, torch.as_tensor(x)


@pytest.mark.parametrize("exact_nan", [False, True])
@pytest.mark.parametrize("grid_name", ["TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED",
                                       "IRREGULAR_WITH_LAND", "REGULAR_WITH_LAND"])
def test_step_kinds_match_unsharded_step(grid_name, exact_nan):
    """FIRST, MIDDLE (shrink 2 and 3) and LAST of the plain local step on a
    halo-extended block equal the unsharded plain step on the core."""
    cells = 3
    tf, ops, ext_ops, p, x = _step_setup(grid_name, exact_nan, cells)
    fold = tf.operator.fold_north
    core = lambda a: a[..., cells:-cells, cells:-cells]  # noqa: E731
    same = lambda a, b: torch.testing.assert_close(  # noqa: E731
        a, b, rtol=1e-13, atol=1e-15, equal_nan=True)
    ext = lambda a: halo.exchange_2d(a, cells, LOCAL, LOCAL, fold)  # noqa: E731

    # unsharded carries
    h, t, acc = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    cheb_pass_reference(ops, FIRST, p[0], p[1], field=x, t_next=t, acc=acc, h=h)
    # local: FIRST on the raw extended field
    xe = ext(x)
    he, te, acc_l = torch.empty_like(xe), torch.full_like(xe, 7.0), torch.empty_like(x)
    lp.local_pass_reference(ext_ops, FIRST, p[0], p[1], cells=cells, shrink=1,
                            field=xe, t_next=te, acc=acc_l, h=he)
    # On a folded grid the south halo is the periodic wrap of the top rows,
    # whose own north neighbour there is row 0 and not the seam: past T_0 it
    # holds other values than the top rows do. Only row 0 reads it, and row 0
    # is land on every folded grid, so the comparison leaves those rows out.
    rows = lambda shrink: slice(cells if fold else shrink, -shrink)  # noqa: E731
    same(he, ext(h))                          # T_0 on the whole block
    same(te[..., rows(1), 1:-1], ext(t)[..., rows(1), 1:-1])  # T_1 on the window
    assert bool((te[..., 0, :] == 7.0).all()) and bool((te[..., :, -1] == 7.0).all())
    same(acc_l, acc)

    # two MIDDLE steps, in place over t_prev, windows shrunk by 2 and 3
    t_prev, t_cur, te_prev, te_cur = h, t, he, te
    for k, shrink in ((2, 2), (3, 3)):
        cheb_pass_reference(ops, MIDDLE, p[k], t=t_cur, t_prev=t_prev, t_next=t_prev, acc=acc)
        lp.local_pass_reference(ext_ops, MIDDLE, p[k], cells=cells, shrink=shrink,
                                t=te_cur, t_prev=te_prev, t_next=te_prev, acc=acc_l)
        t_cur, t_prev, te_cur, te_prev = t_prev, t_cur, te_prev, te_cur
        same(te_cur[..., rows(shrink), shrink:-shrink],
             ext(t_cur)[..., rows(shrink), shrink:-shrink])
        same(acc_l, acc)
    same(core(te_cur), t_cur)

    # a fresh exchange (a new round), then LAST on the core
    te_cur, te_prev = ext(t_cur), ext(t_prev)
    cheb_pass_reference(ops, LAST, p[4], field=x, t=t_cur, t_prev=t_prev, acc=acc)
    lp.local_pass_reference(ext_ops, LAST, p[4], cells=cells, field=x,
                            t=te_cur, t_prev=te_prev, acc=acc_l)
    same(acc_l, acc)
    assert bool(torch.isnan(acc_l[0, 15, 30])) and bool(torch.isnan(acc_l[1, 0, 3]))


def test_wrapper_routes_and_refuses():
    """CPU tensors run the plain version and count no launch; an unknown step
    kind raises."""
    tf, ops, ext_ops, p, x = _step_setup("REGULAR_WITH_LAND", False, 2)
    xe = halo.exchange_2d(x, 2, LOCAL, LOCAL)
    he, te, acc = torch.empty_like(xe), torch.empty_like(xe), torch.empty_like(x)
    before = launch_counts()
    lp.local_pass(ext_ops, FIRST, p[0], p[1], cells=2, shrink=1,
                  field=xe, t_next=te, acc=acc, h=he)
    want = torch.empty_like(acc)
    lp.local_pass_reference(ext_ops, FIRST, p[0], p[1], cells=2, shrink=1, field=xe,
                            t_next=torch.empty_like(xe), acc=want, h=torch.empty_like(xe))
    assert launch_counts() == before
    torch.testing.assert_close(acc, want, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="unknown step kind"):
        lp.local_pass_reference(ext_ops, 9, p[2], cells=2, shrink=1,
                                t=te, t_prev=he, t_next=he, acc=acc)


def test_fold_extension_rejects_mixed_coefficients():
    """A constant coefficient whose seam partner is an array (or the other
    way round) cannot be extended across the fold: raise, do not compute a
    wrong seam."""
    from gcm_filters_tpu_torch.ops.stencil import ScalarStencil5

    plane = torch.ones(8, 12, dtype=torch.float64)
    st = ScalarStencil5(c=-4.0, n=plane, s=1.0, e=1.0, w=1.0, fold_north=True)
    with pytest.raises(ValueError, match="seam partner"):
        local_scalar_operands(st, 2, LOCAL, LOCAL, torch.float64, -0.5, False, 1.0)
    ok = local_scalar_operands(dataclasses.replace(st, fold_north=False), 2, LOCAL, LOCAL,
                               torch.float64, -0.5, False, 1.0)
    assert ok.stencil.n.shape == (12, 16) and ok.stencil.s == -0.5
    assert not ok.stencil.fold_north
