"""The scalar tile on the card: each pass on its steps, bit for bit.

The fused scalar pass (``csrc/cheb_tile.cuh``) runs each pass either in
registers (``reg_steps``: a thread's run of window rows held through the
pass, a kernel of its own) or in shared memory (``step_window``), as
``ops/cuda/cheb_pass.py::fused_path`` picks, and counts its launches by path
(``ops/cuda/launch.py::launch_counts``, ``path=`` on the ``gft.launch``
span). These cases hold every path to the chain of one-step launches bit
for bit (NaNs in the same cells): K1 on a fold grid with land in float32, a
batch of 8, the Taper's four passes, float64, the flux form and an
exact-NaN (GENERIC) stencil; the K2 rounds on halo strips against the local
step chain; the scalar ring against the unsharded apply. Each also checks
which steps ran: the float32 h-space passes of K1 in registers, the other
modes, float64, the strip round and the ring in shared memory. They need a CUDA card and skip without one; run them there
with ``python -m pytest --noconftest -m card tests/test_torch_fused_pass_card.py``
(no JAX needed). Nothing in this file imports JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda.dispatch import _fused_chain, _step_chain
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.stencil import hspace_drop_pre
from gcm_filters_tpu_torch.parallel.sharded import (
    local_rounds_scalar, local_scalar_operands, plan_rounds,
)
from gcm_filters_tpu_torch.utils.telemetry import recording, reset_spans, spans

pytestmark = pytest.mark.card

SHAPE = (240, 400)  # several 40x80 tiles, ragged in x; the fold row mid-tile
TRI = "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED"
IRREGULAR = "IRREGULAR_WITH_LAND"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused scalar kernels run only there")
    return torch.device("cuda")


def _grid_vars(grid, shape, seed=3):
    ny, nx = shape
    rng = np.random.default_rng(seed)
    wet = np.ones(shape)
    wet[0] = 0  # Antarctica
    wet[: ny // 3, : nx // 4] = 0
    if grid == IRREGULAR:
        m = lambda: 0.9 + 0.2 * rng.random(shape)  # noqa: E731
        return dict(wet_mask=wet, dxw=m(), dyw=m(), dxs=m(), dys=m(), area=m(),
                    kappa_w=np.ones(shape), kappa_s=np.ones(shape))
    return {"area": 0.9 + 0.2 * rng.random(shape), "wet_mask": wet}


def _filter(dev, grid=TRI, dtype=torch.float32, shape=SHAPE, **kw):
    return gt.Filter(filter_scale=kw.pop("filter_scale", 10.0), dx_min=1.0,
                     grid_type=gt.GridType[grid], grid_vars=_grid_vars(grid, shape),
                     dtype=dtype, device=dev, **kw)


def _field(dev, lead=(), shape=SHAPE, dtype=torch.float32, seed=4):
    ny, nx = shape
    x = np.random.default_rng(seed).random(lead + shape)
    x[..., ny - 1, nx // 3] = 50.0  # a spike on the fold row
    x[..., ny // 2, nx // 2] = np.nan  # a wet NaN
    return torch.as_tensor(x, dtype=dtype, device=dev)


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want)), "NaNs in other cells"
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)), "the bits differ"


def _by_path(entry, fn, *args, **kw):
    """``fn(*args, **kw)`` and the launches of the entry ``entry`` it made,
    by path."""
    before = launch_counts()
    got = fn(*args, **kw)
    after = launch_counts()
    return got, {k: after.get((entry, k), 0) - before.get((entry, k), 0)
                 for k in ("registers", "shared")}


def _k1(filt, x):
    """K1's planned passes and the step chain on ``(batch, ny, nx)`` x, with
    the launches each pass made by path."""
    fn = filt._scalar_fn()
    ops, p = fn.operands(x.dtype, x.device)
    plan = fn.plan(*x.shape[-2:], x.dtype)
    assert plan.fused
    got, paths = _by_path("cheb_fused_pass", _fused_chain, cp.cheb_fused_pass, ops, p, plan, x)
    want = _step_chain(cp.cheb_pass, ops, p, len(p) - 1, x)
    return got, want, plan, paths


@pytest.mark.parametrize("batch", [1, 8])
def test_k1_in_registers_equals_the_step_chain(dev, batch):
    """The h-space float32 fold grid with land: every pass in registers."""
    got, want, plan, paths = _k1(_filter(dev), _field(dev, (batch,)))
    _same(got, want)
    assert paths == {"registers": len(plan.steps), "shared": 0}


def test_taper_passes_in_registers_equal_the_step_chain(dev):
    """The Taper of factor 10 (39 steps): the planner's four passes."""
    filt = _filter(dev, filter_shape=gt.FilterShape.TAPER)
    got, want, plan, paths = _k1(filt, _field(dev, (1,)))
    assert plan.steps == (10, 10, 10, 9)
    _same(got, want)
    assert paths == {"registers": 4, "shared": 0}


@pytest.mark.parametrize("case", ["float64", "flux", "generic"])
def test_the_modes_that_keep_shared_memory(dev, case):
    """float64, the flux form (IRREGULAR_WITH_LAND) and an exact-NaN
    (GENERIC) stencil step in shared memory, bitwise as before."""
    if case == "float64":
        filt, dtype = _filter(dev, dtype=torch.float64), torch.float64
    elif case == "flux":
        filt, dtype = _filter(dev, grid=IRREGULAR), torch.float32
    else:
        filt, dtype = _filter(dev, exact_nan=True), torch.float32
    got, want, plan, paths = _k1(filt, _field(dev, (2,), dtype=dtype))
    _same(got, want)
    assert paths == {"registers": 0, "shared": len(plan.steps)}


def test_the_span_records_the_path(dev):
    filt = _filter(dev)
    x = _field(dev)
    filt.apply(x)  # operands cached
    reset_spans()
    with recording():
        filt.apply(x)
    launches = [s for s in spans() if s.name == "gft.launch"]
    assert launches and all(s.counts["path"] == "registers" for s in launches)
    assert sum(s.counts["steps"] for s in launches) == filt.n_steps


def test_the_float64_span_records_shared_steps(dev):
    filt = _filter(dev, dtype=torch.float64)
    x = _field(dev, dtype=torch.float64)
    filt.apply(x)  # operands cached
    reset_spans()
    with recording():
        filt.apply(x)
    launches = [s for s in spans() if s.name == "gft.launch"]
    assert launches and all(s.counts["path"] == "shared" for s in launches)
    assert sum(s.counts["steps"] for s in launches) == filt.n_steps


def _local_operands(filt, x, halo_steps):
    op, spec = filt.operator, filt.filter_spec
    drop_pre = hspace_drop_pre(op)
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if drop_pre else op
    cells, rounds = plan_rounds(spec.n_steps, *x.shape[-2:], halo_steps)
    p_host = np.asarray(spec.p, dtype=np.float64)
    ops = local_scalar_operands(
        hot.to(x.dtype, x.device), cells, (None, 1), (None, 1), x.dtype,
        -2.0 * _laplacian_scale(spec, op.is_dimensional), drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, p_host)))
    p = [float(v) for v in p_host.astype(np.float32)]
    return ops, p, cells, rounds, op.fold_north


@pytest.mark.parametrize("halo_steps", [None, 6], ids=["one-round", "rounds-6-5"])
def test_k2_rounds_equal_the_local_step_chain(dev, halo_steps):
    """The sharded engine's rounds (a 1x1 mesh's block) on halo strips
    against the chain of local step launches, in shared memory (their runs
    would spill in registers)."""
    filt = _filter(dev)
    x = _field(dev, (2,))
    ops, p, cells, rounds, fold = _local_operands(filt, x, halo_steps)
    want = local_rounds_scalar(ops, x, p, cells, rounds, (None, 1), (None, 1), fold,
                               fused_fn=None)
    got, paths = _by_path("local_strip_pass", local_rounds_scalar, ops, x, p, cells, rounds,
                          (None, 1), (None, 1), fold)
    _same(got, want)
    assert paths == {"registers": 0, "shared": len(rounds)}


@pytest.mark.parametrize("p_y", [2, 4])
def test_scalar_ring_equals_the_unsharded_apply(dev, p_y):
    """The fused scalar ring over resident shards (shared memory: its runs
    would spill in registers), bitwise equal to K1 (in registers)."""
    filt = _filter(dev)
    ring = gt.Filter(filter_scale=10.0, dx_min=1.0, grid_type=gt.GridType[TRI],
                     grid_vars=_grid_vars(TRI, SHAPE), dtype=torch.float32,
                     mesh=gt.ResidentMesh(p_y, "cuda"), spatial_axes=("y", None))
    x = _field(dev)
    want = filt.apply(x)
    got, paths = _by_path("ring_fused_pass", ring.apply, x)
    _same(got, want)
    assert paths["registers"] == 0 and paths["shared"] > 0
