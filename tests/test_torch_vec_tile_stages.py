"""The vector tile's window and the headline plans of the port on the CPU.

``csrc/vec_tile.cuh`` runs a fused vector pass with one window a block in
shared memory, loaded by cp.async all at once. A second window, the next
tile's loads in flight while the current one steps, ran slower on the card at
the tiles the planner picks and is not built (PERF.md §6). The kernels run
only on the card (chip_smoke.py holds them to the step chain bit for bit);
here the header's shared-memory formula is held to its Python mirror, and
the planners' headline plans are pinned with their launches per apply. A
float32 pass of the periodic field runs its steps in registers where its
plan says so (``vec_reg_kernel``): its run lengths and shared memory are
held to the header's, its headline plans pinned with their paths, and its
runs' cover of each shrunk window checked cell by cell. The
tiled plain versions at the smaller tiles are held to the step chains in
``test_torch_vec_fused_pass.py`` and ``test_torch_vec_local_fused.py``.
"""
import re
from pathlib import Path

import pytest
import torch

from gcm_filters_tpu_torch.ops.cuda import vec_local_pass as vlp
from gcm_filters_tpu_torch.ops.cuda import vec_pass as vp
from gcm_filters_tpu_torch.ops.cuda.cheb_pass import SHARED_BYTES, SM_SHARED_BYTES
from gcm_filters_tpu_torch.parallel import ring
from gcm_filters_tpu_torch.parallel.sharded import plan_rounds

CSRC = Path(vp.__file__).resolve().parents[2] / "csrc"
F32, F64 = torch.float32, torch.float64


def _cuh_shared_bytes(by, bx, H, n_coef, itemsize):
    """``vec_fused_shared_bytes`` as the header states it, evaluated."""
    text = (CSRC / "vec_tile.cuh").read_text()
    m = re.search(r"vec_fused_shared_bytes\(int by, int bx, int H, int n_coef\) \{(.*?)\n\}",
                  text, re.S)
    assert m, "vec_fused_shared_bytes not found in vec_tile.cuh"
    body = m.group(1)
    dims = re.search(r"const size_t wy = (.*?), wx = (.*?);", body)
    ret = re.search(r"return (.*?);", body).group(1)
    env = dict(by=by, bx=bx, H=H, n_coef=n_coef)
    env["wy"], env["wx"] = eval(dims.group(1), {}, env), eval(dims.group(2), {}, env)
    expr = ret.replace("(size_t)", "").replace("sizeof(T)", str(itemsize))
    return eval(expr, {}, env)


@pytest.mark.parametrize("halo", [1, 5, 6, 11, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
def test_shared_bytes_mirror_the_header(op, itemsize, halo):
    for tile in vp.vec_tiles(op, itemsize):
        want = _cuh_shared_bytes(*tile, halo, vp.N_COEF[op], itemsize)
        assert vp.vec_fused_shared_bytes(tile, halo, vp.N_COEF[op], itemsize) == want
        by, bx = tile
        assert want == ((4 + vp.N_COEF[op]) * (by + 2 * halo) * (bx + 2 * halo)
                        + 2 * by * bx) * itemsize


@pytest.mark.parametrize("op, tile, halo, want", [
    (vp.BGRID, (32, 64), 6, 203648), (vp.CTAP, (16, 64), 6, 195456),
    (vp.BGRID, (16, 48), 6, 100224), (vp.CTAP, (16, 32), 6, 112512),
])
def test_window_bytes_of_the_headline_and_smaller_tiles(op, tile, halo, want):
    """The headline windows (float32, H 6) take more than half an SM's shared
    memory, one block an SM; two windows of the smaller tiles would fit in
    one block."""
    got = vp.vec_fused_shared_bytes(tile, halo, vp.N_COEF[op], 4)
    assert got == want <= SHARED_BYTES
    assert (2 * (got + 1024) > SM_SHARED_BYTES) == (tile in ((32, 64), (16, 64)))
    assert (2 * got <= SHARED_BYTES) == (tile not in ((32, 64), (16, 64)))


# (op, dtype) -> (tile, steps) of the 11-step 2400x3600 headlines: the
# plans that the tile sweep of chip_smoke.py measured fastest in float32,
# one launch per pass; float64 keeps the plans of the tile's first design
HEADLINE = {
    (vp.BGRID, F32): ((32, 64), (6, 5)),
    (vp.CTAP, F32): ((16, 64), (6, 5)),
    (vp.BGRID, F64): ((16, 64), (4, 4, 3)),
    (vp.CTAP, F64): ((16, 32), (6, 5)),
}


@pytest.mark.parametrize("dtype", [F32, F64], ids=str)
@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
def test_headline_plans(op, dtype):
    """K3 / K4, the sharded round on a 1x1 mesh and the rings at p_y 2, 4
    and 8 (float32 only: the ring takes no float64 field) plan the same
    tile, split and launches per apply."""
    tile, steps = HEADLINE[(op, dtype)]
    plan = vp.plan_vec_fused_passes(11, 2400, 3600, dtype, op)
    assert (plan.tile, plan.steps, plan.fused) == (tile, steps, True)
    assert len(plan.steps) == {(6, 5): 2, (4, 4, 3): 3}[steps]  # launches per apply
    cells, rounds = plan_rounds(11, 2400, 3600, None)
    (rplan,) = vlp.plan_vec_local_rounds(rounds, 2400, 3600, dtype, op)
    assert (cells, rounds, rplan.tile, rplan.steps, rplan.fused) == (11, (11,), tile, steps, True)
    if dtype != F32:
        return
    for p_y in (2, 4, 8):
        ly = 2400 // p_y
        shard = vp.plan_vec_fused_passes(11, ly, 3600, dtype, op,
                                         max_fuse=min(ring._max_fuse(None), ly), ring=True)
        assert (shard.tile, shard.steps, shard.fused) == (tile, steps, True)
        assert ring._shard_plan(shard, p_y, 2400, dtype) == ly


@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
@pytest.mark.parametrize("shape", [(2400, 3600), (128, 256)], ids=["2400x3600", "128x256"])
def test_float64_plans_at_both_sizes(op, shape):
    """An 11-step float64 filter takes the same plan at 128x256 as at the
    headline: on the C-grid two launches, which beat three at 128x256 on the
    card, where the host's time per launch sets the pace (PERF.md §6)."""
    plan = vp.plan_vec_fused_passes(11, *shape, F64, op)
    assert (plan.tile, plan.steps) == HEADLINE[(op, F64)]


# -- the register steps (vec_reg_kernel) --------------------------------------

def _cuh_reg_shared_bytes(by, bx, H, n_coef, itemsize, r):
    """``vec_reg_shared_bytes`` (with ``vec_reg_pitch``) as the header states
    them, evaluated."""
    text = (CSRC / "vec_tile.cuh").read_text()
    pitch = re.search(r"constexpr int vec_reg_pitch\(int wy, int r\) \{ return (.*?); \}", text)
    m = re.search(r"vec_reg_shared_bytes\(int by, int bx, int H, int n_coef, int r\) \{(.*?)\n\}",
                  text, re.S)
    assert pitch and m, "vec_reg_pitch or vec_reg_shared_bytes not found in vec_tile.cuh"
    py = lambda e: (re.sub(r"\((\w+) > (\w+) \? (\w+) : (\w+)\)", r"(\3 if \1 > \2 else \4)",  # noqa: E731
                           e.replace("(size_t)", "").replace("(int)", ""))
                    .replace("sizeof(T)", str(itemsize)).replace("/", "//"))
    env = dict(by=by, bx=bx, H=H, n_coef=n_coef, r=r,
               vec_reg_pitch=lambda wy, r: eval(py(pitch.group(1)), {}, dict(wy=wy, r=r)))
    for line in re.findall(r"const size_t (.*?);", m.group(1)):
        for part in re.split(r", (?=\w+ = )", line):
            name, expr = part.split(" = ", 1)
            env[name] = eval(py(expr), {}, env)
    return eval(py(re.search(r"return (.*?);", m.group(1)).group(1)), {}, env)


def _cuh_reg_rows():
    """``VecRegRows`` of the header: {(contraction, itemsize): rows}."""
    text = (CSRC / "vec_tile.cuh").read_text()
    found = re.findall(r"struct VecRegRows<(\w+), (\w+)> \{ static constexpr int value = (\d+); \}",
                       text)
    assert found, "VecRegRows not found in vec_tile.cuh"
    ops = {"BGridLap": vp.BGRID, "CTapLap": vp.CTAP}
    return {(ops[o], {"float": 4, "double": 8}[t]): int(r) for o, t, r in found}


def test_run_lengths_mirror_the_header():
    """The run lengths the planner assumes are the kernel's: float32 only."""
    assert _cuh_reg_rows() == vp.VEC_REG_ROWS == {(vp.BGRID, 4): 8, (vp.CTAP, 4): 6}


@pytest.mark.parametrize("halo", [1, 5, 6, 8, 11, 16])
@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
def test_reg_shared_bytes_mirror_the_header(op, halo):
    rows = vp.VEC_REG_ROWS[op, 4]
    for tile in vp.vec_tiles(op, 4):
        want = _cuh_reg_shared_bytes(*tile, halo, vp.N_COEF[op], 4, rows)
        assert vp.vec_reg_shared_bytes(tile, halo, vp.N_COEF[op], 4, rows) == want
        # never less than the shared-memory kernel's window
        assert want >= vp.vec_fused_shared_bytes(tile, halo, vp.N_COEF[op], 4)
        wy = tile[0] + 2 * halo
        assert vp.vec_reg_pitch(wy, rows) % 2 == 1 and vp.vec_reg_pitch(wy, rows) >= wy


HEADLINE_REG = {
    # (op, shape) -> (tile, steps): every pass in registers
    (vp.BGRID, (2400, 3600)): ((32, 64), (6, 5)),
    (vp.CTAP, (2400, 3600)): ((16, 64), (6, 5)),
    (vp.BGRID, (1080, 1440)): ((32, 64), (6, 5)),
    (vp.CTAP, (1080, 1440)): ((16, 64), (6, 5)),
}


@pytest.mark.parametrize("op, shape", list(HEADLINE_REG), ids=lambda x: str(x))
def test_headline_plans_take_the_register_steps(op, shape):
    """K3 and K4 at the POP and OM4_025 shapes: the parent's tile and split
    (two launches a call), every pass on the register steps."""
    tile, steps = HEADLINE_REG[op, shape]
    plan = vp.plan_vec_fused_passes(11, *shape, F32, op)
    assert (plan.tile, plan.steps, plan.fused) == (tile, steps, True)
    assert plan.paths == ("registers",) * len(steps)
    for s in steps:
        assert vp.vec_reg_fits(op, 4, tile, s)
        shared, regs = vp.vec_pass_costs(op, tile, s, 4)
        assert regs < shared


@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
def test_float64_and_ring_plans_keep_shared_memory(op):
    """float64 has no register steps; the ring's and the sharded rounds'
    kernels have none either: their plans are the parent's, in shared memory."""
    for shape in ((2400, 3600), (1080, 1440), (128, 256)):
        plan = vp.plan_vec_fused_passes(11, *shape, F64, op)
        assert plan.paths == ("shared",) * len(plan.steps)
        assert not any(vp.vec_reg_fits(op, 8, plan.tile, s) for s in plan.steps)
    for p_y in (2, 4, 8):
        ly = 2400 // p_y
        shard = vp.plan_vec_fused_passes(11, ly, 3600, F32, op,
                                         max_fuse=min(ring._max_fuse(None), ly), ring=True)
        assert shard.paths == ("shared",) * len(shard.steps)
        assert (shard.tile, shard.steps) == HEADLINE[(op, F32)]
    cells, rounds = plan_rounds(11, 2400, 3600, None)
    (rplan,) = vlp.plan_vec_local_rounds(rounds, 2400, 3600, F32, op)
    assert rplan.paths == ()


@pytest.mark.parametrize("halo", [1, 3, 5, 6, 8, 11])
@pytest.mark.parametrize("op", [vp.BGRID, vp.CTAP])
def test_runs_step_each_live_cell_once(op, halo):
    """The runs (``vec_reg_runs``, thread t's column and first row) cover
    each window cell once and no lane beyond a whole warp's share idles; the
    live slots of step j (``vec_reg_live``) are the window shrunk by j in
    rows, each cell stepped once, no cell outside it in rows; the exchange
    planes' reads stay inside them."""
    rows = vp.VEC_REG_ROWS[op, 4]
    for tile in vp.vec_tiles(op, 4):
        if not vp.vec_reg_fits(op, 4, tile, halo):
            continue
        by, bx = tile
        wy, wx = by + 2 * halo, bx + 2 * halo
        runs = vp.vec_reg_runs(tile, halo, rows)
        assert len(runs) <= 512 and len(runs) == -(-wy // rows) * wx
        cover = {}
        for q, r0 in runs:
            for s in range(rows):
                if r0 + s < wy:
                    cover[r0 + s, q] = cover.get((r0 + s, q), 0) + 1
        assert cover == {(r, q): 1 for r in range(wy) for q in range(wx)}
        pitch = vp.vec_reg_pitch(wy, rows)
        plane = (wx + 2) * pitch
        for j in range(1, halo + 1):
            stepped = {}
            for q, r0 in runs:
                for s in vp.vec_reg_live(r0, rows, wy, j):
                    stepped[r0 + s, q] = stepped.get((r0 + s, q), 0) + 1
                e0 = (q + 1) * pitch + r0
                # east rows -1 .. R-1, west 0 .. R, own -1 .. R: inside the plane
                assert 0 <= e0 - pitch and e0 + pitch + rows - 1 < plane
                assert 0 <= e0 - 1 and e0 + rows < plane
            want = {(r, q): 1 for r in range(j, wy - j) for q in range(wx)}
            assert stepped == want
        # the slots issued: whole warps, at least a slot a live cell, at most
        # every slot of every warp that holds a run
        slots = vp.vec_reg_slots(tile, halo, rows)
        live = sum((wy - 2 * j) * wx for j in range(1, halo + 1))
        assert slots % 32 == 0 and live <= slots <= halo * rows * 32 * -(-len(runs) // 32)


@pytest.mark.parametrize("case", ["float64", "too wide", "unknown"])
def test_the_wrapper_refuses_register_steps_a_pass_cannot_take(case):
    """A launch on the register steps that the kernel would refuse raises
    before it reaches a library: float64 (no run length), a window whose
    runs the block's threads do not cover, an unknown path."""
    dtype = F64 if case == "float64" else F32
    tile, path = {"float64": ((16, 32), "registers"), "too wide": ((8, 160), "registers"),
                  "unknown": ((16, 32), "sideways")}[case]
    ops = vp.VecPassOperands(vp.BGRID, torch.zeros((vp.N_COEF[vp.BGRID], 64, 256), dtype=dtype),
                             True)
    s = torch.zeros((1, 2, 64, 256), dtype=dtype)
    bufs = dict(w=s, t=None, t_prev=None, t_out=s.clone(), t_prev_out=s.clone(), acc=s.clone())
    p = [1.0] * 12
    message = "unknown steps" if case == "unknown" else "cannot take the register steps"
    with pytest.raises(ValueError, match=message):
        vp._fused_launch(ops, p, 0, 6, tile, bufs, path)
    assert not vp.vec_reg_fits(vp.BGRID, dtype.itemsize, tile, 6) or case == "unknown"
