"""The vector tile's window and the headline plans of the port on the CPU.

``csrc/vec_tile.cuh`` runs a fused vector pass with one window a block in
shared memory, loaded by cp.async all at once. A second window, the next
tile's loads in flight while the current one steps, ran slower on the card at
the tiles the planner picks and is not built (PERF.md §6). The kernels run
only on the card (chip_smoke.py holds them to the step chain bit for bit);
here the header's shared-memory formula is held to its Python mirror, and
the planners' headline plans are pinned with their launches per apply. The
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
