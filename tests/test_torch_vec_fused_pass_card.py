"""The vector tile on the card: each pass on its steps, bit for bit.

The fused vector pass (``csrc/vec_tile.cuh``) runs a float32 pass of the
periodic field either in registers (``vec_reg_steps``: a thread's run of
window rows held through the pass, the kernel ``vec_reg_kernel``) or in
shared memory (``vec_step_window``), as the plan says
(``ops/cuda/vec_pass.py::plan_vec_fused_passes``, its ``paths``), and counts
its launches by contraction and path (``ops/cuda/launch.py::launch_counts``,
``path=`` on the ``gft.launch`` span). These cases hold every path to the
chain of one-step launches bit for bit (NaNs in the same cells): K3 (B-grid)
and K4 (C-grid) in float32 with batches of 1 and 3 on ragged shapes (partial
tiles in both axes), NaN land and +-inf cells, the C-grid at kappa_aniso 1
and without zap, the 6+5 headline split and the Taper's passes; float64, the
sharded rounds and the vector ring keep the shared-memory steps. They need a
CUDA card and skip without one; run them there with
``python -m pytest --noconftest -m card tests/test_torch_vec_fused_pass_card.py``
(no JAX needed). Nothing in this file imports JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.ctaps import CTAP_NAMES, cgrid_tap_arrays
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.dispatch import _fused_chain, _vec_step_chain
from gcm_filters_tpu_torch.ops.cuda.launch import launch_counts
from gcm_filters_tpu_torch.ops.stencil import BGRID_FIELDS, CGridVectorOperator
from gcm_filters_tpu_torch.parallel.sharded import (
    local_rounds_vector, local_vector_operands, plan_rounds,
)
from gcm_filters_tpu_torch.utils.ring_split import unit_vector_grid_vars
from gcm_filters_tpu_torch.utils.telemetry import recording, reset_spans, spans

pytestmark = pytest.mark.card

SHAPE = (197, 301)  # ragged in both axes for the 32x64 and 16x64 tiles
B, C = "VECTOR_B_GRID", "VECTOR_C_GRID"
LOCAL = (None, 1)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused vector kernels run only there")
    return torch.device("cuda")


def _filter(dev, grid, dtype=torch.float32, shape=SHAPE, kappa_aniso=0.0, **kw):
    gv = unit_vector_grid_vars(grid, shape, np.random.default_rng(3), kappa_aniso)
    return gt.Filter(filter_scale=10.0, dx_min=kw.pop("dx_min", 1.0), grid_type=gt.GridType[grid],
                     grid_vars=gv, dtype=dtype, device=dev, **kw)


def _state(dev, batch, shape=SHAPE, dtype=torch.float32, seed=4):
    """A stacked (batch, 2, ny, nx) input with a NaN land patch, NaN and
    +-inf cells at tile seams and at the periodic edges."""
    ny, nx = shape
    w = np.random.default_rng(seed).uniform(-1.0, 1.0, (batch, 2) + shape)
    w[0, :, ny // 3:ny // 3 + 5, nx // 2:nx // 2 + 9] = np.nan  # land
    w[-1, 0, 32, 64] = np.nan  # a tile corner
    w[-1, 1, 5, nx - 1] = np.inf
    w[0, 0, ny - 1, 0] = -np.inf
    w[-1, 1, 0, 63] = 40.0
    return torch.as_tensor(w, dtype=dtype, device=dev)


def _same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(torch.isnan(got), torch.isnan(want)), "NaNs in other cells"
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0)), "the bits differ"


def _by_path(op, fn, *args, **kw):
    """``fn(*args, **kw)`` and the launches of the fused periodic vector
    entry of contraction ``op`` it made, by path."""
    before = launch_counts()
    got = fn(*args, **kw)
    after = launch_counts()
    return got, {k: after.get(("vec_fused_pass", (op, k)), 0)
                 - before.get(("vec_fused_pass", (op, k)), 0) for k in ("registers", "shared")}


def _passes(filt, w, zap=None, plan=None):
    """The filter's planned passes (or ``plan``) and the step chain on the
    stacked ``w``, with the launches each pass made by path, and the plan."""
    fn = filt._vector_fn()
    ops, p = fn.operands(w.dtype, w.device)
    if zap is not None:
        ops = dataclasses.replace(ops, zap=zap)
    plan = plan or fn.plan(*w.shape[-2:], w.dtype)
    assert plan.fused
    got, paths = _by_path(ops.op, _fused_chain, vp.vec_fused_pass, ops, p, plan, w, name="w")
    want = _vec_step_chain(vp.vec_pass, ops, p, len(p) - 1, w.clone())
    return got, want, plan, paths


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("grid", [B, C])
def test_k3_k4_in_registers_equal_the_step_chain(dev, grid, batch):
    """The planned passes of the 11-step Gaussian: every pass in registers."""
    got, want, plan, paths = _passes(_filter(dev, grid), _state(dev, batch))
    _same(got, want)
    assert plan.paths == ("registers",) * len(plan.steps)
    assert paths == {"registers": len(plan.steps), "shared": 0}


@pytest.mark.parametrize("case", ["kappa_aniso=1", "zap_nans=False"])
def test_the_c_grid_variants_in_registers(dev, case):
    """The C-grid at kappa_aniso 1 (every tap an array) and without zap (the
    register kernel compiled without the scrub: the NaNs spread)."""
    filt = _filter(dev, C, kappa_aniso=1.0 if "kappa" in case else 0.0)
    got, want, plan, paths = _passes(filt, _state(dev, 2), zap=False if "zap" in case else None)
    _same(got, want)
    assert paths == {"registers": len(plan.steps), "shared": 0}


@pytest.mark.parametrize("grid", [B, C])
def test_the_headline_split_in_registers(dev, grid):
    """The 6+5 split of the headlines on their tiles (32x64 B, 16x64 C), on
    a field of several tiles, ragged in both axes."""
    plan = vp.plan_vec_fused_passes(11, 2400, 3600, torch.float32,
                                    vp.BGRID if grid == B else vp.CTAP)
    assert plan.steps == (6, 5) and plan.paths == ("registers", "registers")
    got, want, _, paths = _passes(_filter(dev, grid), _state(dev, 1), plan=plan)
    _same(got, want)
    assert paths == {"registers": 2, "shared": 0}


@pytest.mark.parametrize("grid", [B, C])
def test_taper_passes_in_registers_equal_the_step_chain(dev, grid):
    """The Taper (dx_min 0.9, 44 steps): the planner's passes, all in
    registers."""
    filt = _filter(dev, grid, filter_shape=gt.FilterShape.TAPER, dx_min=0.9)
    got, want, plan, paths = _passes(filt, _state(dev, 1))
    assert len(plan.steps) >= 4
    _same(got, want)
    assert paths == {"registers": len(plan.steps), "shared": 0}


@pytest.mark.parametrize("grid", [B, C])
def test_float64_keeps_shared_memory(dev, grid):
    """A float64 pass steps in shared memory, bitwise as before."""
    filt = _filter(dev, grid, dtype=torch.float64)
    got, want, plan, paths = _passes(filt, _state(dev, 2, dtype=torch.float64))
    _same(got, want)
    assert plan.paths == ("shared",) * len(plan.steps)
    assert paths == {"registers": 0, "shared": len(plan.steps)}


@pytest.mark.parametrize("grid", [B, C])
def test_the_span_and_the_table_record_the_path(dev, grid):
    filt = _filter(dev, grid)
    w = _state(dev, 1)
    u, v = w[:, 0], w[:, 1]
    filt.apply_to_vector(u, v)  # operands cached
    reset_spans()
    with recording():
        _, paths = _by_path(vp.BGRID if grid == B else vp.CTAP, filt.apply_to_vector, u, v)
    launches = [s for s in spans() if s.name == "gft.launch"]
    assert launches and all(s.counts == {"path": "registers"} for s in launches)
    assert paths == {"registers": len(launches), "shared": 0}


def _host_planes(operator):
    if isinstance(operator, CGridVectorOperator):
        taps = cgrid_tap_arrays(operator)
        return vp.CTAP, {k: torch.as_tensor(taps[k]) for k in CTAP_NAMES}
    return vp.BGRID, {k: getattr(operator, k) for k in BGRID_FIELDS}


@pytest.mark.parametrize("halo_steps", [None, 6], ids=["one-round", "rounds-6-5"])
@pytest.mark.parametrize("grid", [B, C])
def test_the_sharded_rounds_keep_shared_memory(dev, grid, halo_steps):
    """The sharded engine's rounds (a 1x1 mesh's block) on halo strips
    against the chain of local step launches; no launch of the periodic
    entry."""
    filt = _filter(dev, grid)
    w = _state(dev, 2)
    op, planes = _host_planes(filt.operator)
    cells, rounds = plan_rounds(filt.n_steps, *SHAPE, halo_steps)
    ops = local_vector_operands(
        op, {k: x.to(torch.float32).to(dev) for k, x in planes.items()},
        bool(filt.operator.zap_nans), cells, LOCAL, LOCAL, torch.float32,
        -2.0 * _laplacian_scale(filt.filter_spec, True))
    p = [float(x) for x in np.asarray(filt.filter_spec.p).astype(np.float32)]
    want = local_rounds_vector(ops, w.clone(), p, cells, rounds, LOCAL, LOCAL, fused_fn=None)
    before = launch_counts()
    got = local_rounds_vector(ops, w.clone(), p, cells, rounds, LOCAL, LOCAL)
    after = launch_counts()
    _same(got, want)
    made = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert made.get(("vec_local_strip_pass", op), 0) == len(rounds)
    assert not any(k[0] == "vec_fused_pass" for k in made)


@pytest.mark.parametrize("p_y", [2, 4])
@pytest.mark.parametrize("grid", [B, C])
def test_vector_ring_equals_the_unsharded_apply(dev, grid, p_y):
    """The fused vector ring over resident shards (shared memory), bitwise
    equal to K3 / K4 (in registers)."""
    shape = (200, 301)
    filt = _filter(dev, grid, shape=shape)
    gv = unit_vector_grid_vars(grid, shape, np.random.default_rng(3), 0.0)
    ring = gt.Filter(filter_scale=10.0, dx_min=1.0, grid_type=gt.GridType[grid], grid_vars=gv,
                     dtype=torch.float32, mesh=gt.ResidentMesh(p_y, "cuda"),
                     spatial_axes=("y", None))
    w = _state(dev, 1, shape=shape)
    u, v = w[0, 0], w[0, 1]
    op = vp.BGRID if grid == B else vp.CTAP
    want, unsharded = _by_path(op, filt.apply_to_vector, u, v)
    before = launch_counts()
    got = ring.apply_to_vector(u, v)
    after = launch_counts()
    for g, x in zip(got, want):
        _same(g, x)
    assert unsharded["registers"] > 0
    assert after.get(("vec_ring_fused_pass", op), 0) > before.get(("vec_ring_fused_pass", op), 0)
    assert not any(k[0] == "vec_fused_pass" and n != before.get(k, 0) for k, n in after.items())
