"""The scalar tile's window, work items and headline plans of the port on the CPU.

``csrc/cheb_tile.cuh`` runs a fused scalar pass with one window a block in
shared memory, loaded by cp.async in one burst (a first pass copies the raw
field and area and computes T_0 in place), and steps it with (strip,
column) work items, one per thread, mapped by a multiply-high quotient
(``Quot``). The kernels run only on the card (chip_smoke.py holds them to
the step chains bit for bit). Here:

- the header's shared-memory formula is held to its Python mirror, and the
  blocks per SM of every headline plan are pinned;
- a Python model of the work items (the ``Quot`` formula, the strip and
  column of each item, the clamps of a cut strip) must cover each cell of
  every step's shrunk window exactly once, and ``Quot`` must equal ``//``
  over the whole range the kernel uses;
- the refitted planner's headline plans are pinned with their launches per
  apply;
- the tiled plain versions (unsharded, the sharded round's and the ring's)
  at the tiles the refit added must equal the step chains bit for bit.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import gcm_filters_tpu_torch as gt
from gcm_filters_tpu_torch.ops.cuda import cheb_pass as cp
from gcm_filters_tpu_torch.ops.cuda import local_pass as lp
from gcm_filters_tpu_torch.ops.cuda import ring_pass as rp
from gcm_filters_tpu_torch.ops.cuda.dispatch import _fused_chain, _step_chain, make_cuda_scalar_apply
from gcm_filters_tpu_torch.parallel import ring
from gcm_filters_tpu_torch.parallel.sharded import (
    local_rounds_scalar, local_scalar_operands, plan_rounds,
)
from gcm_filters_tpu_torch.engine import _laplacian_scale
from gcm_filters_tpu_torch.ops.stencil import hspace_drop_pre

CSRC = Path(cp.__file__).resolve().parents[2] / "csrc"
F32, F64 = torch.float32, torch.float64
NY, NX = 2400, 3600


# -- the window's bytes --------------------------------------------------------

def _cuh_shared_bytes(by, bx, H, planes, itemsize):
    """``fused_shared_bytes`` as cheb_tile.cuh states it, evaluated for a
    window of ``planes`` planes (the two carries and the array planes)."""
    text = (CSRC / "cheb_tile.cuh").read_text()
    m = re.search(r"fused_shared_bytes\(const FusedArgs<T>& a\) \{(.*?)\n\}", text, re.S)
    assert m, "fused_shared_bytes not found in cheb_tile.cuh"
    body = m.group(1)
    base = int(re.search(r"int planes = (\d+);", body).group(1))
    assert "planes += a.coef[m] != nullptr;" in body
    assert "planes += (a.post != nullptr) + (a.pre != nullptr);" in body
    assert base == 2  # the two carries, then one plane per array
    dims = re.search(r"const size_t wy = (.*?), wx = (.*?);", body)
    ret = re.search(r"return (.*?);", body).group(1)
    env = {"by": by, "bx": bx, "n_ops": H, "planes": planes}
    py = lambda e: e.replace("a.", "").replace("(size_t)", "").replace(  # noqa: E731
        "sizeof(T)", str(itemsize))
    env["wy"], env["wx"] = eval(py(dims.group(1)), {}, env), eval(py(dims.group(2)), {}, env)
    return eval(py(ret), {}, env)


@pytest.mark.parametrize("halo", [1, 5, 10, 11, 13, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("planes", [2, 4, 7, 9])
def test_shared_bytes_mirror_the_header(planes, itemsize, halo):
    for tile in cp.TILES:
        want = _cuh_shared_bytes(*tile, halo, planes, itemsize)
        assert cp.fused_shared_bytes(tile, halo, planes, itemsize) == want
        by, bx = tile
        assert want == (planes * (by + 2 * halo) * (bx + 2 * halo) + by * bx) * itemsize


def _blocks_per_sm(tile, halo, planes, itemsize):
    """Blocks of FUSED_THREADS an SM holds by shared memory (1 KB reserved
    a block) and by threads; registers are the card's (chip_smoke.py)."""
    b = cp.fused_shared_bytes(tile, halo, planes, itemsize)
    return min(cp.SM_SHARED_BYTES // (b + 1024), 2048 // cp.FUSED_THREADS)


# -- the headline plans ----------------------------------------------------------

def _ring_plan(n_steps, p_y, dtype=F32, planes=4):
    ly = NY // p_y
    return cp.plan_fused_passes(n_steps, ly, NX, dtype, planes,
                                max_fuse=min(ring._max_fuse(None), ly), ring=True)


# name -> (the plan, tile, steps, blocks per SM of each pass by shared memory)
def _plans():
    return {
        "K1": cp.plan_fused_passes(11, NY, NX, F32, 4),
        "K1 Taper": cp.plan_fused_passes(39, NY, NX, F32, 4),
        "K1 IRREGULAR_WITH_LAND": cp.plan_fused_passes(11, NY, NX, F32, 7),
        "K1 float64": cp.plan_fused_passes(11, NY, NX, F64, 4),
        "K2 round": cp.plan_fused_passes(11, NY, NX, F32, 4, one_pass=True),
        "ring p_y 2": _ring_plan(11, 2),
        "ring p_y 4": _ring_plan(11, 4),
        "ring p_y 8": _ring_plan(11, 8),
        "ring Taper": _ring_plan(39, 4),
        "ring IRREGULAR_WITH_LAND": _ring_plan(11, 4, planes=7),
    }


PLANES = {"K1 IRREGULAR_WITH_LAND": 7, "ring IRREGULAR_WITH_LAND": 7}
ITEMSIZE = {"K1 float64": 8}

# the plans that the tile sweep of chip_smoke.py measured fastest on one H100
# (PERF.md §6), with the blocks an SM holds by shared memory
HEADLINE = {
    "K1": ((40, 80), (11,), 2),
    "K1 Taper": ((40, 80), (10, 10, 10, 9), 2),
    "K1 IRREGULAR_WITH_LAND": ((40, 80), (11,), 1),
    "K1 float64": ((40, 80), (11,), 1),
    "K2 round": ((40, 80), (11,), 2),
    "ring p_y 2": ((40, 80), (11,), 2),
    "ring p_y 4": ((40, 80), (11,), 2),
    "ring p_y 8": ((40, 80), (11,), 2),
    "ring Taper": ((40, 80), (10, 10, 10, 9), 2),
    "ring IRREGULAR_WITH_LAND": ((40, 80), (11,), 1),
}


@pytest.mark.parametrize("name", sorted(HEADLINE))
def test_headline_plans(name):
    """The refitted planner's plans of the headlines: tile, split, launches
    per apply (one per pass) and blocks an SM."""
    plan = _plans()[name]
    tile, steps, blocks = HEADLINE[name]
    assert (plan.tile, plan.steps, plan.fused) == (tile, steps, True)
    assert plan.halo == max(steps) and len(plan.steps) == len(steps)  # launches per apply
    got = {_blocks_per_sm(plan.tile, s, PLANES.get(name, 4), ITEMSIZE.get(name, 4))
           for s in plan.steps}
    assert got == {blocks}


def test_ring_plans_are_the_unsharded_plans():
    """A ring shard plans what the unsharded field plans (its windows fit in
    x), so the ring runs the fused K1's tile and split and stays bitwise
    equal to it; the sharded round on a 1x1 mesh plans K1's one pass too."""
    plans = _plans()
    for p_y in (2, 4, 8):
        shard = plans[f"ring p_y {p_y}"]
        assert (shard.tile, shard.steps) == (plans["K1"].tile, plans["K1"].steps)
        assert ring._shard_plan(shard, p_y, NY, F32) == NY // p_y
    assert plans["ring Taper"].steps == plans["K1 Taper"].steps
    cells, rounds = plan_rounds(11, NY, NX, None)
    assert (cells, rounds) == (11, (11,))


# -- the work items --------------------------------------------------------------

def quot(n, d):
    """``Quot(d)(n)`` of cheb_tile.cuh: a multiply-high by the rounded-up
    reciprocal ``m = 0xFFFFFFFF // d + 1``, on numpy int64."""
    m = 0xFFFFFFFF // d + 1
    return (np.asarray(n, dtype=np.int64) * m) >> 32


def step_items(wy, wx, j, strip=cp.STRIP):
    """The (strip, column) items of step j, as step_window maps them: for
    each item ``idx``, its column ``q`` and rows ``[r0, r1)``."""
    rows, cols = wy - 2 * j, wx - 2 * j
    pairs = -(-rows // strip) * cols
    idx = np.arange(pairs, dtype=np.int64)
    s_i = quot(idx, cols)
    assert np.array_equal(s_i, idx // cols)
    q = j + idx - s_i * cols
    r0 = j + s_i * strip
    r1 = np.minimum(r0 + strip, wy - j)
    return idx, q, r0, r1


def _check_step(wy, wx, H, j, by, bx):
    """Every cell of the window shrunk by j is stepped exactly once; every
    value an item loads lies in the window that the step before wrote (or
    the loaded window); own cells are those of the tile."""
    idx, q, r0, r1 = step_items(wy, wx, j)
    count = np.zeros((wy, wx), dtype=np.int64)
    for s in range(cp.STRIP):
        r = r0 + s
        live = r < r1
        np.add.at(count, (r[live], q[live]), 1)
    want = np.zeros((wy, wx), dtype=np.int64)
    want[j:wy - j, j:wx - j] = 1
    assert np.array_equal(count, want), (wy, wx, j)
    # the centre column on rows r0-1 .. r0+STRIP, clamped to r1; the rest on
    # the strip, clamped to r1-1: all inside the window shrunk by j-1
    for s in range(cp.STRIP + 2):
        rc = np.minimum(r0 - 1 + s, r1)
        assert rc.min() >= j - 1 and rc.max() <= wy - j
    for s in range(cp.STRIP):
        rs = np.minimum(r0 + s, r1 - 1)
        assert rs.min() >= j and rs.max() < wy - j
    assert q.min() - 1 >= j - 1 and q.max() + 1 <= wx - j
    # the own cells: those whose (r - H, q - H) lies in the tile, all of them
    own = np.zeros((wy, wx), dtype=bool)
    for s in range(cp.STRIP):
        r = r0 + s
        live = r < r1
        oy, ox = r[live] - H, q[live] - H
        ok = (oy >= 0) & (oy < by) & (ox >= 0) & (ox < bx)
        own[r[live][ok], q[live][ok]] = True
    assert own.sum() == by * bx  # the tile lies inside every shrunk window


@pytest.mark.parametrize("name", sorted(HEADLINE))
def test_items_cover_every_step_of_the_headline_plans(name):
    plan = _plans()[name]
    by, bx = plan.tile
    for H in sorted(set(plan.steps)):
        wy, wx = by + 2 * H, bx + 2 * H
        for j in range(1, H + 1):
            _check_step(wy, wx, H, j, by, bx)


@pytest.mark.parametrize("tile", sorted(cp.TILES))
def test_quot_is_exact_wherever_the_kernel_uses_it(tile):
    """n < 2^32 / d, and Quot(d)(n) == n // d, for the items of every step
    (d = the step's columns), the window's cells (d = its width) and the own
    cells of acc (d = bx), at every halo a pass may take."""
    by, bx = tile
    for H in range(1, cp.MAX_FUSE + 1):
        wy, wx = by + 2 * H, bx + 2 * H
        uses = [(wy * wx, wx), (by * bx, bx)]
        uses += [(-(-(wy - 2 * j) // cp.STRIP) * (wx - 2 * j), wx - 2 * j)
                 for j in range(1, H + 1)]
        for n, d in uses:
            assert n * d < 2 ** 32
            k = np.arange(n, dtype=np.int64)
            assert np.array_equal(quot(k, d), k // d), (tile, H, d)


@pytest.mark.parametrize("tile", sorted(cp.TILES))
def test_items_cover_every_step_of_every_tile(tile):
    """The same cover at H 1, 6, 11 and 16 on every tile of the planner."""
    by, bx = tile
    for H in (1, 6, 11, 16):
        wy, wx = by + 2 * H, bx + 2 * H
        for j in range(1, H + 1):
            _check_step(wy, wx, H, j, by, bx)


def test_step_slots_count_whole_rounds_of_items():
    """The planner's lane slots are the items of a step in whole rounds of
    the block's threads, STRIP rows each."""
    for (by, bx), H in (((32, 96), 11), ((40, 80), 11), ((16, 32), 3)):
        wy, wx = by + 2 * H, bx + 2 * H
        for j in range(1, H + 1):
            idx = step_items(wy, wx, j)[0]
            rounds = -(-len(idx) // cp.FUSED_THREADS)
            assert cp.step_slots(wy, wx, j) == rounds * cp.FUSED_THREADS * cp.STRIP


# -- the tiled plain versions at the refit's tiles, bitwise -------------------------

# the tiles that the refit added to the planner's (the first design's excluded)
NEW_TILES = [tl for tl in cp.TILES if tl not in {
    (32, 96), (16, 128), (48, 64), (32, 64), (16, 64), (32, 32), (16, 32)}]
# name -> (grid, exact_nan): the three compiled modes of the tile
MODES = {
    "hspace": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", False),
    "flux": ("IRREGULAR_WITH_LAND", False),
    "generic": ("TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", True),
}
SHAPE = (64, 122)  # no tile divides it; the fold row lands mid-tile


def _grid_vars(grid, shape, rng):
    ny, nx = shape
    wet = np.ones(shape)
    wet[0] = 0
    wet[: ny // 2, : nx // 3] = 0
    irr = lambda: 0.9 + 0.2 * rng.random(shape)  # noqa: E731
    if grid == "IRREGULAR_WITH_LAND":
        return dict(wet_mask=wet, dxw=irr(), dyw=irr(), dxs=irr(), dys=irr(), area=irr(),
                    kappa_w=np.ones(shape), kappa_s=np.ones(shape))
    return {"area": irr(), "wet_mask": wet}


def _setup(mode, dtype, shape=SHAPE, batch=None):
    grid, exact_nan = MODES[mode]
    rng = np.random.default_rng(5)
    filt = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid],
                     grid_vars=_grid_vars(grid, shape, rng), device="cpu", dtype=dtype,
                     exact_nan=exact_nan)
    fn = make_cuda_scalar_apply(filt.operator, filt.filter_spec, exact_nan=exact_nan)
    ops, p = fn.operands(dtype, torch.device("cpu"))
    x = rng.random(((batch,) if batch else ()) + shape)
    x[..., shape[0] - 1, shape[1] // 3] = 50.0  # a spike on the fold row
    return filt, ops, p, torch.as_tensor(x, dtype=dtype)


def test_the_modes_are_the_kernels():
    """hspace, flux and generic are what fused_mode of cheb_tile.cuh picks."""
    for mode, (planes, has_post, has_pre) in {"hspace": (4, True, False),
                                              "flux": (7, False, False),
                                              "generic": (5, True, True)}.items():
        _, ops, _, _ = _setup(mode, F64)
        st = ops.stencil
        assert cp.fused_planes(ops) == planes
        assert isinstance(st.post, torch.Tensor) == has_post
        assert isinstance(st.pre, torch.Tensor) == has_pre


@pytest.mark.parametrize("steps", [(7,), (3, 2, 2)], ids=["first-and-last", "first-middle-last"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile", NEW_TILES)
def test_tiled_reference_equals_step_chain_at_the_new_tiles(tile, mode, dtype, steps):
    """K1's tiled plain version, batch of 2, a ragged fold grid."""
    filt, ops, p, x = _setup(mode, dtype, batch=2)
    n = filt.n_steps
    assert n == sum(steps)
    want = _step_chain(cp.cheb_pass_reference, ops, p, n, x)
    got = _fused_chain(cp.cheb_fused_pass_tiled_reference, ops, p,
                       cp.FusedPlan(tile, max(steps), steps, True), x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _local_operands(filt, x, halo_steps, exact_nan):
    op, spec = filt.operator, filt.filter_spec
    drop_pre = hspace_drop_pre(op) and not exact_nan
    hot = dataclasses.replace(op, pre=None, zap_nans=False) if drop_pre else op
    cells, rounds = plan_rounds(spec.n_steps, *x.shape[-2:], halo_steps)
    p_host = np.asarray(spec.p, dtype=np.float64)
    local = (None, 1)
    ops = local_scalar_operands(
        hot.to(x.dtype, "cpu"), cells, local, local, x.dtype,
        -2.0 * _laplacian_scale(spec, op.is_dimensional), drop_pre,
        float(np.polynomial.chebyshev.chebval(-1.0, p_host)))
    npdt = np.float32 if x.dtype == F32 else np.float64
    return ops, [float(v) for v in p_host.astype(npdt)], cells, rounds, op.fold_north


@pytest.mark.parametrize("halo_steps", [None, 3], ids=["one-round", "rounds-3-3-1"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile", NEW_TILES)
def test_local_tiled_reference_equals_step_chain_at_the_new_tiles(tile, mode, dtype, halo_steps):
    """The sharded round's tiled plain version (BlockGeo: no wrap, clamped)
    against the local step chain, batch of 2, on a 1x1 mesh's block."""
    filt, _, _, x = _setup(mode, dtype, batch=2)
    ops, p, cells, rounds, fold = _local_operands(filt, x, halo_steps, MODES[mode][1])
    want = local_rounds_scalar(ops, x, p, cells, rounds, (None, 1), (None, 1), fold,
                               fused_fn=None)

    fixed = tile

    def tiled(o, pp, start, n, *, tile, **kw):
        return lp.local_fused_pass_tiled_reference(o, pp, start, n, tile=fixed, **kw)

    got = local_rounds_scalar(ops, x, p, cells, rounds, (None, 1), (None, 1), fold,
                              fused_fn=tiled)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("steps", [(7,), (3, 2, 2)], ids=["first-and-last", "first-middle-last"])
@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("tile", NEW_TILES)
def test_ring_tiled_reference_equals_step_chain_at_the_new_tiles(tile, mode, dtype, steps):
    """The ring's tiled plain version (RingGeo: halo rows, the top shard's
    mirror rows) at p_y 4 against the unsharded step chain."""
    filt, ops, p, x = _setup(mode, dtype)
    ny, nx = x.shape
    p_y = 4
    ly = ny // p_y
    state = rp.RingFusedState(rp.RingFusedOperands.cut(ops, p_y, max(steps)), ly, nx, dtype,
                              "cpu")
    for r, own in enumerate(state.input):
        own.copy_(x[r * ly:(r + 1) * ly])
    start = 0
    for m, n in enumerate(steps):
        rp.ring_fused_pass_tiled_reference(state, p, start, n, tile=tile, out=m % 2)
        start += n
    want = _step_chain(cp.cheb_pass_reference, ops, p, filt.n_steps, x[None])[0]
    np.testing.assert_array_equal(torch.cat(state.acc).numpy(), want.numpy())
