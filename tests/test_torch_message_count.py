"""The steady-state message count of the port's sharded round engine.

Counterpart of ``tests/test_sharded.py::
test_distributed_prepared_exts_remove_coefficient_collectives``: the port
halo-extends the coefficient planes once per (local shape, dtype) and caches
them (``parallel/sharded.py``, ``operands``), so after the first apply an
apply sends only the halo rows of the field and of the carries.

On 4 gloo ranks (started as tests/test_torch_sharded.py starts them: this
file, run as ``python tests/test_torch_message_count.py <rank> 4 <workdir>
<mesh>``, is one rank and imports the port only) each rank wraps
``torch.distributed.batch_isend_irecv``, through which every message of
``parallel/halo.py`` goes, and counts the sends and their bytes of a first
and a second apply. For the 2x2 and 4x1 meshes, on the tripolar scalar grid
(the fold pairs the top mesh row's ranks) and the C-grid (18 tap planes),
the test pins each rank's messages of both applies, and requires the second
apply's bytes to be exactly the halo rows of the field and the carries that
its rounds exchange: no coefficient plane.
"""
import os
import sys

import numpy as np
import torch

from test_torch_sharded import MESHES, spawn_ranks

SHAPE = (96, 192)
HALO_STEPS = 3  # several rounds, so the carries travel too
GRIDS = {"tripolar": "TRIPOLAR_REGULAR_WITH_LAND_AREA_WEIGHTED", "cgrid": "VECTOR_C_GRID"}


def _grid_vars(name):
    rng = np.random.default_rng(5)
    one = np.ones(SHAPE)
    if name == "tripolar":
        wet = one.copy()
        wet[0] = 0
        return {"area": 0.9 + 0.2 * rng.random(SHAPE), "wet_mask": wet}
    m = 0.9 + 0.2 * rng.random(SHAPE)
    return dict(wet_mask_t=one, wet_mask_q=one, dxT=m, dyT=m, dxCu=m, dyCu=m, dxCv=m, dyCv=m,
                dxBu=m, dyBu=m, area_u=m * m, area_v=m * m, kappa_iso=one, kappa_aniso=0 * one)


# --------------------------------------------------------------------------
# the rank process: imports the port only
# --------------------------------------------------------------------------

def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import gcm_filters_tpu_torch as gt

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    shape, names = MESHES[mesh_key]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    sent = []  # per batch_isend_irecv call: the bytes of each send
    batch_isend_irecv = dist.batch_isend_irecv

    def counting(ops):
        sent.append([o.tensor.numel() * o.tensor.element_size() for o in ops
                     if o.op is dist.isend])
        return batch_isend_irecv(ops)

    dist.batch_isend_irecv = counting
    report = {}
    rng = np.random.default_rng(8)
    batch = 2
    for name, grid in GRIDS.items():
        filt = gt.Filter(filter_scale=6.0, dx_min=1.0, grid_type=gt.GridType[grid],
                         grid_vars=_grid_vars(name), device="cpu", mesh=mesh,
                         spatial_axes=("y", "x"), halo_steps=HALO_STEPS)
        fields = [rng.random((batch,) + SHAPE) for _ in range(4)]
        for apply_no in (1, 2):
            del sent[:]
            if name == "cgrid":
                filt.apply_to_vector(fields[2 * apply_no - 2], fields[2 * apply_no - 1])
            else:
                filt.apply(fields[apply_no])
            report[f"{name}/{apply_no}/messages"] = sum(len(s) for s in sent)
            report[f"{name}/{apply_no}/bytes"] = sum(sum(s) for s in sent)
        fn = filt._vector_fn() if name == "cgrid" else filt._scalar_fn()
        ly, lx = SHAPE[0] // shape[0], SHAPE[1] // shape[1]
        _, cells, rounds, _ = fn.operands(ly, lx, torch.float64)
        report[f"{name}/cells"] = cells
        report[f"{name}/rounds"] = list(rounds)
        report[f"{name}/batch"] = batch
    dist.batch_isend_irecv = batch_isend_irecv
    report["coords"] = [mesh.get_local_rank("y"), mesh.get_local_rank("x")]

    np.savez(os.path.join(workdir, f"report{rank}.npz"),
             **{k: np.asarray(v) for k, v in report.items()})
    if rank == 0:
        np.savez(os.path.join(workdir, "outputs.npz"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# the parent: pytest
# --------------------------------------------------------------------------

import pytest  # noqa: E402

_SPAWNED = {}


def _reports(mesh_key, tmp_path_factory):
    """Every rank's counts on one mesh shape, from one spawn per test run."""
    if mesh_key not in _SPAWNED:
        workdir = str(tmp_path_factory.mktemp(f"messages_{mesh_key}"))
        _SPAWNED[mesh_key] = spawn_ranks(os.path.abspath(__file__), workdir, mesh_key)[1]
    return _SPAWNED[mesh_key]


def _exchange_bytes(lead, k, ly, lx, y_sharded, x_sharded, fold_partner):
    """Bytes one rank sends in ``halo.exchange_2d`` of a float64 tensor of
    ``lead`` values a cell: two x phases of k columns, two y phases of k rows
    of the x-extended block, and at the fold the k top rows to the seam
    partner."""
    row = lead * k * (lx + 2 * k)
    return 8 * ((2 * lead * ly * k if x_sharded else 0) + (2 * row if y_sharded else 0)
                + (row if fold_partner else 0))


# Each rank's (messages of the first apply, messages of the second), ranks in
# mesh order (the 2x2 mesh's top row, which holds the fold, last). A second
# apply runs 3 rounds (3, 2, 2 steps), each one exchange: 2 messages a
# sharded dim, and on a top-row rank of a mesh sharded in x 1 more to its
# seam partner. A first apply adds the same exchange for every coefficient
# plane: 3 on the tripolar grid (c, post, area: its h-space stencil has
# constant n, s, e, w), the 18 taps on the C-grid.
PINNED = {
    ("2x2", "tripolar"): [(12 + 12, 12), (12 + 12, 12), (15 + 15, 15), (15 + 15, 15)],
    ("2x2", "cgrid"): [(72 + 12, 12)] * 4,
    ("4x1", "tripolar"): [(6 + 6, 6)] * 4,
    ("4x1", "cgrid"): [(36 + 6, 6)] * 4,
}


@pytest.mark.parametrize("mesh_key,grid", sorted(PINNED))
def test_message_count(tmp_path_factory, mesh_key, grid):
    reports = _reports(mesh_key, tmp_path_factory)
    got = [(int(r[f"{grid}/1/messages"]), int(r[f"{grid}/2/messages"])) for r in reports]
    assert got == PINNED[mesh_key, grid]


@pytest.mark.parametrize("mesh_key,grid", sorted(PINNED))
def test_second_apply_sends_only_carries(tmp_path_factory, mesh_key, grid):
    """The second apply's bytes are the halo rows of the field (the first
    round) and of both carries (every later round), nothing else; the first
    apply sends more, the coefficient planes' halos."""
    (py, px), _ = MESHES[mesh_key]
    ly, lx = SHAPE[0] // py, SHAPE[1] // px
    for r in _reports(mesh_key, tmp_path_factory):
        iy, ix = (int(c) for c in r["coords"])
        cells, batch = int(r[f"{grid}/cells"]), int(r[f"{grid}/batch"])
        rounds = r[f"{grid}/rounds"]
        comps = 2 if grid == "cgrid" else 1
        fold_partner = grid == "tripolar" and iy == py - 1 and px > 1 and ix != px - 1 - ix
        one = lambda lead: _exchange_bytes(lead, cells, ly, lx, py > 1, px > 1,  # noqa: E731
                                           fold_partner)
        want = one(batch * comps) + (len(rounds) - 1) * one(2 * batch * comps)
        assert r[f"{grid}/2/bytes"] == want, (r["coords"], r[f"{grid}/2/bytes"], want)
        assert r[f"{grid}/1/bytes"] > want

