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
  at the tiles the refit added must equal the step chains bit for bit;
- the register steps (``reg_steps``): a Python model of their runs (thread t
  owns rows ``[R (t // wx), R (t // wx) + R)`` of column ``t % wx``) and of
  their two exchange planes must give every cell of every step's shrunk
  window to exactly one (thread, slot), find each neighbour a cell reads in
  its own run's registers or at the plane address where its owner published
  it the step before, and keep every read and write inside the planes; a
  window that reaches the fold steps in shared memory, so no run holds a
  mirror cell (the header's ``lap_value`` call takes the own roles); the
  header's run length, pitch and fit are held to their Python mirrors, and
  the headline passes' steps (registers or shared memory) are pinned.
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
                                max_fuse=min(ring._max_fuse(None), ly), ring=True,
                                registers=False)


# name -> (the plan, tile, steps, blocks per SM of each pass by shared memory)
def _plans():
    return {
        "K1": cp.plan_fused_passes(11, NY, NX, F32, 4),
        "K1 Taper": cp.plan_fused_passes(39, NY, NX, F32, 4),
        "K1 IRREGULAR_WITH_LAND": cp.plan_fused_passes(11, NY, NX, F32, 7),
        "K1 float64": cp.plan_fused_passes(11, NY, NX, F64, 4),
        "K2 round": cp.plan_fused_passes(11, NY, NX, F32, 4, one_pass=True, registers=False),
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
    """The sharded round's tiled plain version (BlockGeo's clamps, the state
    cut from the core and its halo strips) against the local step chain,
    batch of 2, on a 1x1 mesh's block."""
    filt, _, _, x = _setup(mode, dtype, batch=2)
    ops, p, cells, rounds, fold = _local_operands(filt, x, halo_steps, MODES[mode][1])
    want = local_rounds_scalar(ops, x, p, cells, rounds, (None, 1), (None, 1), fold,
                               fused_fn=None)

    fixed = tile

    def tiled(o, pp, start, n, *, tile, **kw):
        return lp.local_strip_pass_tiled_reference(o, pp, start, n, tile=fixed, **kw)

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


# -- the register steps ------------------------------------------------------------

HSPACE_F32 = (cp.HSPACE, 4)
REG_R = cp.REG_ROWS[HSPACE_F32]


def _header():
    return (CSRC / "cheb_tile.cuh").read_text()


def test_register_steps_mirror_the_header():
    """The run length, the exchange planes' pitch and the fit of reg_path
    are those of cheb_tile.cuh."""
    text = _header()
    rows = re.search(r"struct RegRows<float, HSPACE> \{ static constexpr int value = (\d+); \}",
                     text)
    assert rows and int(rows.group(1)) == REG_R
    assert "struct RegRows { static constexpr int value = 0; }" in text  # no other mode
    assert cp.REG_ROWS == {HSPACE_F32: REG_R}
    pitch = re.search(r"int reg_pitch\(int wy, int r\) \{ return (.*?); \}", text).group(1)
    for wy in range(3, 100):
        assert eval(pitch.replace("/", "//"), {}, {"wy": wy, "r": REG_R}) == cp.reg_pitch(wy, REG_R)
        assert cp.reg_pitch(wy, REG_R) % 2 == 1 and cp.reg_pitch(wy, REG_R) >= wy
    fit = re.search(r"return R > 0 && a\.regs && (.*?);\n", text, re.S).group(1)
    assert "(wy + R - 1) / R * wx <= FUSED_THREADS" in fit
    assert "3 * (wx + 2) * reg_pitch(wy, R) * sizeof(T) <= fused_shared_bytes(a)" in fit


def _reg_runs(wy, wx, rows=REG_R):
    """The runs of reg_steps: ``(q, r0)`` of each thread that holds one."""
    t = np.arange(-(-wy // rows) * wx)
    return t % wx, t // wx * rows


def _check_register_steps(by, bx, H):
    """The runs and exchange planes of one pass of H steps on a by x bx tile."""
    wy, wx = by + 2 * H, bx + 2 * H
    P = cp.reg_pitch(wy, REG_R)
    q, r0 = _reg_runs(wy, wx)
    assert len(q) <= cp.FUSED_THREADS
    # the exchange planes and the post plane fit in the window's shared
    # memory, whose planes are dead
    assert 3 * (wx + 2) * P * 4 <= cp.fused_shared_bytes((by, bx), H, 4, 4)
    # every window cell belongs to exactly one (thread, slot)
    owner = np.full((wy, wx), -1)
    for t in range(len(q)):
        for s in range(REG_R):
            if r0[t] + s < wy:
                assert owner[r0[t] + s, q[t]] == -1
                owner[r0[t] + s, q[t]] = t * REG_R + s
    assert (owner >= 0).all()
    # where a cell's owner publishes its gathered T: e0 + s = (q + 1) P + r
    addr = lambda r, c: (c + 1) * P + r  # noqa: E731
    e0 = (q + 1) * P + r0
    # every slot's reads (east, west, the rows just below and above the run)
    # and writes lie inside a plane, on every step (slots outside the shrunk
    # window are stepped too)
    for s in range(REG_R):
        for a in (e0 + s + P, e0 + s - P, e0 + s):
            assert a.min() >= 0 and a.max() < (wx + 2) * P
    assert (e0 - 1).min() >= 0 and (e0 + REG_R).max() < (wx + 2) * P
    for j in range(1, H + 1):
        rows, cols = slice(j, wy - j), slice(j, wx - j)
        stepped = np.zeros((wy, wx), dtype=bool)
        stepped[rows, cols] = True
        prev = np.zeros((wy, wx), dtype=bool)  # loaded, or stepped at step j - 1
        prev[j - 1:wy - j + 1, j - 1:wx - j + 1] = True
        for t in range(len(q)):
            c = q[t]
            if not j <= c < wx - j:
                continue
            for s in range(REG_R):
                r = r0[t] + s
                if not j <= r < wy - j:
                    continue
                # north and south: the run's own registers, or the plane at the
                # run's ends
                for dr, a_end, slot in ((1, e0[t] + REG_R, s + 1), (-1, e0[t] - 1, s - 1)):
                    assert prev[r + dr, c]
                    if not 0 <= slot < REG_R:
                        assert a_end == addr(r + dr, c)
                # east and west: the plane, where their owners published them
                assert e0[t] + s + P == addr(r, c + 1) and prev[r, c + 1]
                assert e0[t] + s - P == addr(r, c - 1) and prev[r, c - 1]
        assert stepped.sum() == (wy - 2 * j) * (wx - 2 * j)


@pytest.mark.parametrize("tile", sorted(cp.TILES))
def test_register_steps_cover_every_step_of_every_halo(tile):
    """Every H from 1 to 16 on every tile of the planner: where the pass can
    take the register steps, their runs and planes are checked; elsewhere the
    pass steps in shared memory (the items of test_items_cover_*)."""
    by, bx = tile
    taken = 0
    for H in range(1, cp.MAX_FUSE + 1):
        fits = cp.reg_fits(cp.HSPACE, 4, tile, H, 4)
        wy, wx = by + 2 * H, bx + 2 * H
        assert fits == (-(-wy // REG_R) * wx <= cp.FUSED_THREADS
                        and 3 * (wx + 2) * cp.reg_pitch(wy, REG_R) * 4
                        <= cp.fused_shared_bytes(tile, H, 4, 4))
        if fits:
            _check_register_steps(by, bx, H)
            taken += 1
        else:
            for j in range(1, H + 1):
                _check_step(wy, wx, H, j, by, bx)
    assert taken > 0
    assert not cp.reg_fits(cp.HSPACE, 8, tile, 1, 4)  # float64 keeps shared memory
    assert not any(cp.reg_fits(m, 4, tile, 1, 7) for m in (cp.FLUX, cp.GENERIC))


def test_mirror_rows_step_in_shared_memory():
    """No run holds a mirror cell: the register steps hand lap_value the
    window's own roles (c, n, s, e, w: the slot, the row above, the row
    below, east, west), and the register kernel steps a window that reaches
    the fold in shared memory (step_window, whose mirror cells take the
    swapped roles), the top tile row of a fold grid (cheb_tile.cuh's text,
    evaluated)."""
    text = _header()
    call = re.search(r"const T lap = lap_value\(tl\.coef_array\(0\).*?\);", text, re.S).group(0)
    args = [a.strip() for a in re.sub(r"\s+", " ", call[call.index("(") + 1:-2]).split(",")]
    assert args[5:10] == ["g[s + 1]", "g[s + 2]", "g[s]", "ge[s]", "gw[s]"]
    body = text[text.index("void fused_tile("):]
    fold = re.search(r"if constexpr \(REG\) \{\n\s*if \(!geo\.mirror\((.*?)\)\) \{\n\s*reg_steps\(",
                     body)
    assert fold and fold.group(1) == "y0 - H + wy - 1"  # the window's top row
    for ny in (64, 2400):
        for by, bx in cp.TILES:
            for H in range(1, cp.MAX_FUSE + 1):
                wy = by + 2 * H
                for y0 in range(0, ny, by):
                    rows = y0 - H + np.arange(wy)
                    # a mirror row anywhere in the window: its top row is one
                    assert (rows >= ny).any() == (y0 - H + wy - 1 >= ny)


# the steps each headline pass of K1 takes (fused_path on the h-space float32
# stencil: the model weighs both, PERF.md §6); the K2 round on strips and
# the ring have no register steps (their runs would spill) and plan without
# them
HEADLINE_PATHS = {
    "K1": ["registers"],
    "K1 Taper": ["registers"] * 4,
}


@pytest.mark.parametrize("name", sorted(HEADLINE_PATHS))
def test_headline_passes_take_their_pinned_steps(name):
    plan = _plans()[name]
    got = []
    for s in plan.steps:
        shared, regs = cp.pass_costs(plan.tile, s, 4, 4, cp.HSPACE)
        got.append("registers" if regs is not None and regs < shared else "shared")
    assert got == HEADLINE_PATHS[name]


def test_fused_path_follows_the_mode_and_the_dtype():
    """The path the wrappers launch: registers only for the h-space float32
    stencil where its model wins."""
    for mode, dtype, want in (("hspace", F32, "registers"), ("hspace", F64, "shared"),
                              ("flux", F32, "shared"), ("generic", F32, "shared")):
        _, ops, _, _ = _setup(mode, dtype)
        assert cp.fused_path(ops.stencil, (40, 80), 11, 4 if dtype == F32 else 8) == want
    _, ops, _, _ = _setup("hspace", F32)
    assert cp.fused_mode(ops.stencil) == cp.HSPACE
    assert cp.fused_path(ops.stencil, (40, 80), 3, 4) == "shared"  # a short pass
    assert cp.fused_path(ops.stencil, (48, 64), 11, 4) == "shared"  # 6 run rows: no fit
