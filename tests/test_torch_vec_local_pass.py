"""The port's coupled local pass on the CPU: the plain version of the windowed
local entries of ``csrc/vec_pass.cu`` against the periodic step, the JAX
package's extended operands and its sharded Pallas local compute.

``vec_local_pass_reference`` is held, step kind by step kind, against the
port's periodic plain step ``vec_pass_reference`` on a block whose halo was
filled by a periodic wrap (f64 rtol 1e-11 / atol 1e-13: the same arithmetic
in the same order on slices instead of rolls). The extended, pre-scaled
coefficient planes must equal ``_extend_vector_operator`` of the JAX package
on the cast operator, scaled the same way, bit for bit. ``local_rounds_vector``
on unsharded axes (no process group) must match the JAX sharded vector apply
with its Pallas local compute in interpret mode on a 1x1 mesh, at the
tolerances of tests/test_torch_sharded.py. The CUDA kernels themselves are
checked against the same plain version on the card by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import gcm_filters_tpu as gj
from gcm_filters_tpu.engine import _cast_operator
from gcm_filters_tpu.ops.ctaps import cgrid_tap_arrays as jtaps
from gcm_filters_tpu.parallel.sharded import _extend_vector_operator as j_extend
from gcm_filters_tpu.utils.telemetry import fallback_counts, reset_fallback_counts
import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.ctaps import CTAP_NAMES, cgrid_tap_arrays
from gcm_filters_tpu_torch.ops.cuda import vec_local_pass as vlp
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import FIRST, LAST, MIDDLE
from gcm_filters_tpu_torch.ops.cuda.dispatch import make_cuda_vector_apply
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.stencil import BGRID_FIELDS, CGridVectorOperator
from gcm_filters_tpu_torch.parallel import halo
from gcm_filters_tpu_torch.parallel.sharded import (
    local_rounds_vector, local_vector_operands, plan_rounds,
)

from test_torch_vec_pass import fields, unit_grid_vars

LOCAL = (None, 1)
TOL = {np.float64: dict(rtol=1e-10, atol=1e-12), np.float32: dict(rtol=2e-5, atol=2e-6)}
TORCH_DT = {np.float64: torch.float64, np.float32: torch.float32}
B, C = gj.GridType.VECTOR_B_GRID, gj.GridType.VECTOR_C_GRID


def _port_filter(grid_type, shape, kappa_aniso=0.0, scale=6.0):
    return gt.Filter(filter_scale=scale, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                     grid_vars=unit_grid_vars(grid_type, shape, kappa_aniso), device="cpu")


def _host_planes(op):
    """The global coefficient planes in the kernel's order, as float64 tensors."""
    if isinstance(op, CGridVectorOperator):
        taps = cgrid_tap_arrays(op)
        return vp.CTAP, {k: torch.as_tensor(taps[k]) for k in CTAP_NAMES}
    return vp.BGRID, {k: getattr(op, k) for k in BGRID_FIELDS}


def _local_operands(tf, cells, dtype=torch.float64, zap=True):
    op, planes = _host_planes(tf.operator)
    planes = {k: v.to(dtype) for k, v in planes.items()}
    return local_vector_operands(op, planes, zap, cells, LOCAL, LOCAL, dtype,
                                 -2.0 * _laplacian_scale(tf.filter_spec, True))


@pytest.mark.parametrize("zap", [True, False])
@pytest.mark.parametrize("grid_type", [B, C])
def test_step_kinds_match_periodic_step(grid_type, zap):
    """FIRST, MIDDLE (shrink 2 and 3) and LAST of the plain local step on a
    periodically extended block equal the periodic plain step on the window,
    NaNs included (scrubbed or spreading), and write nothing outside it."""
    cells, shape = 3, (24, 40)
    tf = _port_filter(grid_type, shape, kappa_aniso=1.0)
    ops, p = make_cuda_vector_apply(tf.operator, tf.filter_spec).operands(
        torch.float64, torch.device("cpu"))
    ops = vp.VecPassOperands(ops.op, ops.coef, zap)
    ext_ops = _local_operands(tf, cells, zap=zap)
    assert ext_ops.coef.shape == (vp.N_COEF[ops.op], 24 + 2 * cells, 40 + 2 * cells)
    u, v = fields((2,) + shape, seed=21)
    u[0, 15, 30] = np.nan
    v[1, 3, 0] = np.nan  # on the block's edge: its neighbours lie across the wrap
    w = torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1)
    same = lambda a, b: torch.testing.assert_close(  # noqa: E731
        a, b, rtol=1e-11, atol=1e-13, equal_nan=True)
    ext = lambda a: halo.exchange_2d(a, cells, LOCAL, LOCAL)  # noqa: E731
    win = lambda a, s: a[..., s:-s, s:-s]  # noqa: E731

    t, acc = torch.empty_like(w), torch.empty_like(w)
    vp.vec_pass_reference(ops, FIRST, p[0], p[1], w=w.clone(), t_next=t, acc=acc)
    we = ext(w)
    te, acc_l = torch.full_like(we, 7.0), torch.empty_like(w)
    vlp.vec_local_pass_reference(ext_ops, FIRST, p[0], p[1], cells=cells, shrink=1,
                                 w=we, t_next=te, acc=acc_l)
    same(win(te, 1), win(ext(t), 1))
    assert bool((te[..., 0, :] == 7.0).all()) and bool((te[..., :, -1] == 7.0).all())
    same(acc_l, acc)

    # two MIDDLE steps, in place over t_prev, windows shrunk by 2 and 3
    t_prev, t_cur, te_prev, te_cur = w.clone(), t, we, te
    for k, shrink in ((2, 2), (3, 3)):
        vp.vec_pass_reference(ops, MIDDLE, p[k], t=t_cur, t_prev=t_prev, t_next=t_prev, acc=acc)
        before = te_prev.clone()
        vlp.vec_local_pass_reference(ext_ops, MIDDLE, p[k], cells=cells, shrink=shrink,
                                     t=te_cur, t_prev=te_prev, t_next=te_prev, acc=acc_l)
        edge = torch.ones(te_prev.shape[-2:], dtype=torch.bool)
        edge[shrink:-shrink, shrink:-shrink] = False
        assert torch.equal(torch.nan_to_num(te_prev[..., edge]),
                           torch.nan_to_num(before[..., edge]))
        t_cur, t_prev, te_cur, te_prev = t_prev, t_cur, te_prev, te_cur
        same(win(te_cur, shrink), win(ext(t_cur), shrink))
        same(acc_l, acc)
    same(win(te_cur, cells), t_cur)

    # a fresh exchange (a new round), then LAST on the core
    te_cur, te_prev = ext(t_cur), ext(t_prev)
    vp.vec_pass_reference(ops, LAST, p[4], t=t_cur, t_prev=t_prev, acc=acc)
    vlp.vec_local_pass_reference(ext_ops, LAST, p[4], cells=cells,
                                 t=te_cur, t_prev=te_prev, acc=acc_l)
    same(acc_l, acc)
    n_nan = int(torch.isnan(acc_l).sum())
    assert bool(torch.isnan(acc_l[0, 0, 15, 30])) and bool(torch.isnan(acc_l[1, 1, 3, 0]))
    assert n_nan == 2 if zap else n_nan > 2


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("grid_type", [B, C])
def test_extended_operands_equal_jax(grid_type, dtype):
    """Every extended coefficient plane, cast, extended and pre-scaled, equals
    the JAX package's ``_extend_vector_operator`` of the cast operand scaled
    by -2*lap_scale in the compute dtype, bit for bit."""
    cells, shape = 4, (32, 48)
    gv = unit_grid_vars(grid_type, shape, kappa_aniso=1.0)
    jf = gj.Filter(filter_scale=6.0, dx_min=1.0, grid_type=grid_type, grid_vars=gv,
                   use_pallas=False)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=gv, device="cpu")
    ext_ops = _local_operands(tf, cells, TORCH_DT[dtype])
    operand = jtaps(jf.operator) if grid_type == C else jf.operator
    jext = j_extend(_cast_operator(operand, dtype), cells, LOCAL, LOCAL)
    names = CTAP_NAMES if grid_type == C else BGRID_FIELDS
    neg2s = dtype(-2.0 * 2.0 / jf.filter_spec.s_max)
    assert ext_ops.coef.dtype == TORCH_DT[dtype] and ext_ops.coef.is_contiguous()
    assert ext_ops.coef.shape == (len(names), 32 + 2 * cells, 48 + 2 * cells)
    for m, k in enumerate(names):
        plane = jext[k] if grid_type == C else getattr(jext, k)
        want = np.asarray(plane.astype(dtype) * neg2s)
        assert want.dtype == dtype and np.array_equal(ext_ops.coef[m].numpy(), want), k


def _jax_sharded_pallas(grid_type, gv, u, v, halo_steps, scale):
    """The JAX sharded vector apply on a 1x1 mesh with the coupled Pallas
    pass (interpret mode) as its local compute; fails unless it really ran."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("y", "x"))
    jf = gj.Filter(filter_scale=scale, dx_min=1.0, grid_type=grid_type, grid_vars=gv,
                   use_pallas=True, mesh=mesh, spatial_axes=("y", "x"), halo_steps=halo_steps)
    reset_fallback_counts()
    ju, jv = jf.apply_to_vector(jnp.asarray(u), jnp.asarray(v))
    fn = jf._vector_fn()
    assert fn._pl_jit and not fn._fb and not fn._pinned, \
        "the JAX side did not run its Pallas local compute"
    assert fallback_counts() == {}
    return np.asarray(ju), np.asarray(jv)


@pytest.mark.parametrize("grid_type, dtype, halo_steps", [
    (B, np.float64, None), (B, np.float64, 2), (B, np.float32, 3),
    (C, np.float64, None), (C, np.float64, 2), (C, np.float32, 3),
])
def test_local_rounds_match_jax_sharded_pallas(grid_type, dtype, halo_steps):
    shape = (48, 64)
    gv = unit_grid_vars(grid_type, shape, kappa_aniso=0.0)
    tf = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid_type.name],
                   grid_vars=gv, device="cpu")
    u, v = (a.astype(dtype) for a in fields((2,) + shape, seed=9))
    cells, rounds = plan_rounds(tf.n_steps, *shape, halo_steps)
    ops = _local_operands(tf, cells, TORCH_DT[dtype])
    p = [float(x) for x in np.asarray(tf.filter_spec.p).astype(dtype)]
    w = torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1)
    w0 = w.clone()
    out = local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL)
    assert torch.equal(w, w0), "the rounds must not write into the caller's state"
    assert sum(rounds) == tf.n_steps and out.shape == w.shape
    want = _jax_sharded_pallas(grid_type, gv, u, v, halo_steps, 6.0)
    unsharded = tf.apply_to_vector(u, v)
    for m in (0, 1):
        got = out[:, m].numpy()
        assert got.dtype == want[m].dtype == dtype
        np.testing.assert_allclose(got, want[m], **TOL[dtype])
        # the same arithmetic in the same order as the unsharded plain steps
        assert np.array_equal(got, unsharded[m].numpy())


@pytest.mark.parametrize("grid_type", [B, C])
def test_round_sequence_and_counter(grid_type):
    """n_steps calls per apply with the kinds and shrinks of the rounds; the
    CPU route runs the plain version and counts no launch."""
    shape = (16, 32)
    tf = _port_filter(grid_type, shape)
    cells, rounds = plan_rounds(tf.n_steps, *shape, 3)
    ops = _local_operands(tf, cells)
    p = [float(x) for x in tf.filter_spec.p]
    calls = []

    def spy(ops_, kind, *a, **k):
        calls.append((kind, k.get("shrink")))
        return vlp.vec_local_pass(ops_, kind, *a, **k)

    before = launch_counts()
    u, v = fields((1,) + shape)
    w = torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1)
    local_rounds_vector(ops, w, p, cells, rounds, LOCAL, LOCAL, pass_fn=spy)
    want = [(FIRST, 1)]
    for r, n_ops in enumerate(rounds):
        want += [(MIDDLE, j) for j in range(2 if r == 0 else 1, n_ops + 1)]
    want[-1] = (LAST, None)
    assert calls == want and len(calls) == tf.n_steps
    assert launch_counts() == before


def test_wrapper_routes_and_refuses():
    """CPU tensors run the plain version; unknown kinds and contractions
    raise."""
    shape = (8, 16)
    tf = _port_filter(B, shape)
    ops = _local_operands(tf, 2)
    p = [float(x) for x in tf.filter_spec.p]
    u, v = fields((1,) + shape)
    we = halo.exchange_2d(torch.stack([torch.as_tensor(u), torch.as_tensor(v)], dim=1),
                          2, LOCAL, LOCAL)
    t, acc = torch.zeros_like(we), torch.empty((1, 2) + shape, dtype=torch.float64)
    vlp.vec_local_pass(ops, FIRST, p[0], p[1], cells=2, w=we, t_next=t, acc=acc)
    t2, acc2 = torch.zeros_like(we), torch.empty_like(acc)
    vlp.vec_local_pass_reference(ops, FIRST, p[0], p[1], cells=2, shrink=1,
                                 w=we, t_next=t2, acc=acc2)
    assert torch.equal(t, t2) and torch.equal(acc, acc2)
    with pytest.raises(ValueError, match="unknown step kind"):
        vlp.vec_local_pass_reference(ops, 9, p[2], cells=2, shrink=1,
                                     t=we, t_prev=t, t_next=t, acc=acc)
    bad = vp.VecPassOperands(7, ops.coef, True)
    with pytest.raises(ValueError, match="unknown vector contraction"):
        vlp.vec_local_pass_reference(bad, MIDDLE, p[2], cells=2, shrink=1,
                                     t=we, t_prev=t, t_next=t, acc=acc)


def test_unsupported_operator_message_matches_jax(tmp_path):
    """An operator that is no framework vector stencil, handed to the sharded
    vector apply, raises the JAX package's message (the port also refuses a
    scalar stencil there, which the JAX package only trips over later)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from gcm_filters_tpu.parallel.sharded import make_sharded_vector_apply as j_make
    from gcm_filters_tpu_torch.parallel.sharded import make_sharded_vector_apply as t_make

    jf = gj.Filter(filter_scale=4.0, dx_min=1.0, use_pallas=False)
    tf = gt.Filter(filter_scale=4.0, dx_min=1.0, device="cpu")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("y", "x"))
    class Odd:
        is_dimensional = False

    with pytest.raises(ValueError, match="not supported") as ej:
        j_make(Odd(), jf.filter_spec, jmesh, ("y", "x"))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("y", "x"))
        with pytest.raises(ValueError, match="not supported") as et:
            t_make(Odd(), tf.filter_spec, mesh, ("y", "x"))
        assert str(et.value) == str(ej.value)
        with pytest.raises(ValueError, match="ScalarStencil5 is not supported"):
            t_make(tf.operator, tf.filter_spec, mesh, ("y", "x"))
    finally:
        dist.destroy_process_group()
