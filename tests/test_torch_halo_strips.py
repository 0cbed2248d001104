"""``halo.exchange_strips``: the four halo strips of a block, without the
extended block, with exactly the messages of ``halo.exchange_2d``.

``exchange_2d`` is now the ``torch.cat`` of the strips around the field, so
its bits must not move: every case is held against ``_parent_exchange_2d``,
the implementation it had before (``extend_x``, then the y phase over the
x-extended block), and against the strips assembled around the block. A
sequence of fields rides as one stack (``stack_dim``), as the fused vector
rounds send u and v, or both carries, without stacking the fields: the
strips must equal those of the stacked field. In one process the axes wrap
locally; on 4 gloo ranks (2x2 and 4x1 meshes; this file, run as ``python
tests/test_torch_halo_strips.py <rank> 4 <workdir> <mesh>``, is one rank and
imports the port only, started by ``spawn_ranks`` of
tests/test_torch_sharded.py) every rank also records the messages of both
functions, wrapping ``torch.distributed.batch_isend_irecv``: the same
batches, peers, tags and bytes.
"""
import os
import sys

import numpy as np
import torch

from test_torch_sharded import MESHES, spawn_ranks

LOCAL = (None, 1)
K = 3
SHAPE = (16, 24)  # global (y, x); every mesh's blocks are at least K wide
CASES = {  # name -> (fold_north, with fold_src)
    "plain": (False, False),
    "fold": (True, False),
    "fold_src": (True, True),
}


def _parent_exchange_2d(halo, f, k, y_axis, x_axis, fold_north=False, fold_src=None):
    """``exchange_2d`` as it was before ``exchange_strips``: the x-extended
    block first, then its edge rows around it in y."""
    fx = halo.extend_x(f, k, x_axis)
    south, north = fx[..., -k:, :], fx[..., :k, :]
    on_top = True
    if halo._sharded(y_axis):
        south, north = halo._ring(south, north, y_axis)
        on_top = halo._group_index(y_axis[0]) == y_axis[1] - 1
    if fold_north and on_top:
        src_x = fx if fold_src is None else halo.extend_x(fold_src, k, x_axis)
        north = halo._fold_partner(src_x[..., -k:, :].flip(-2, -1), x_axis)
    return torch.cat([south, fx, north], dim=-2)


def _same(a, b):
    """Equal bit for bit, NaNs in the same cells."""
    return (a.shape == b.shape and torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(7.5), b.nan_to_num(7.5)))


def _assemble(s, f):
    return torch.cat([s.south, torch.cat([s.west, f, s.east], dim=-1), s.north], dim=-2)


def _check_block(halo, f, src, y_axis, x_axis, fold):
    """Every comparison on one block: ``{label: equal}``. ``f`` and ``src``
    are (batch, 2, ly, lx)."""
    out = {}
    parent = _parent_exchange_2d(halo, f, K, y_axis, x_axis, fold, src)
    new = halo.exchange_2d(f, K, y_axis, x_axis, fold, src)
    s = halo.exchange_strips(f, K, y_axis, x_axis, fold, src)
    out["exchange_2d == parent"] = _same(new, parent)
    out["strips around f == parent"] = _same(_assemble(s, f), parent)
    ly, lx = f.shape[-2:]
    out["strip shapes"] = (tuple(s.south.shape[-2:]) == tuple(s.north.shape[-2:]) == (K, lx + 2 * K)
                           and tuple(s.west.shape[-2:]) == tuple(s.east.shape[-2:]) == (ly, K)
                           and all(x.is_contiguous() for x in s))
    # (u, v) as two fields stacked along dim 1, and two carries along dim 0
    pair = tuple(f.unbind(1))
    sp = halo.exchange_strips(pair, K, y_axis, x_axis, fold,
                              None if src is None else tuple(src.unbind(1)), stack_dim=1)
    out["pair along dim 1 == stacked"] = all(_same(a, b) for a, b in zip(sp, s))
    two = (f, f.flip(-1) * 0.5)
    st = halo.exchange_strips(two, K, y_axis, x_axis, fold, None if src is None else (src, src))
    stacked = halo.exchange_2d(torch.stack(two), K, y_axis, x_axis, fold,
                               None if src is None else torch.stack((src, src)))
    out["carries along dim 0 == stacked"] = _same(_assemble(st, torch.stack(two)), stacked)
    return out


def _globals():
    rng = np.random.default_rng(23)
    g, s = rng.random((2, 2) + SHAPE), rng.random((2, 2) + SHAPE)
    g[0, 1, 0, 0] = np.nan  # a corner NaN rides along bit for bit
    return g, s


# --------------------------------------------------------------------------
# the rank process: imports the port only
# --------------------------------------------------------------------------

def _rank_main(rank, world, workdir, mesh_key):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from gcm_filters_tpu_torch.parallel import halo

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            world_size=world, rank=rank)
    shape, names = MESHES[mesh_key]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
    iy, ix = (int(c) for c in mesh.get_coordinate())
    py, px = shape
    axis = lambda d: (mesh.get_group(d), mesh.size(names.index(d))) if mesh.size(  # noqa: E731
        names.index(d)) > 1 else (None, 1)
    y_axis, x_axis = axis("y"), axis("x")
    ly, lx = SHAPE[0] // py, SHAPE[1] // px
    g, s = _globals()
    blk = lambda a: torch.as_tensor(  # noqa: E731
        a[..., iy * ly:(iy + 1) * ly, ix * lx:(ix + 1) * lx].copy())
    sent = []
    batch_isend_irecv = dist.batch_isend_irecv

    def recording(ops):
        sent.append(sorted((o.op is dist.isend, o.peer, o.tag, o.tensor.numel()
                            * o.tensor.element_size()) for o in ops))
        return batch_isend_irecv(ops)

    dist.batch_isend_irecv = recording
    report = {}
    for name, (fold, with_src) in CASES.items():
        f, src = blk(g), blk(s) if with_src else None
        for label, ok in _check_block(halo, f, src, y_axis, x_axis, fold).items():
            report[f"{name}/{label}"] = ok
        del sent[:]
        halo.exchange_strips(f, K, y_axis, x_axis, fold, src)
        mine = list(sent)
        del sent[:]
        _parent_exchange_2d(halo, f, K, y_axis, x_axis, fold, src)
        report[f"{name}/same messages"] = mine == sent
        report[f"{name}/messages"] = sum(len(b) for b in sent)
    np.savez(os.path.join(workdir, f"report{rank}.npz"), **report)
    if rank == 0:
        np.savez(os.path.join(workdir, "outputs.npz"), done=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# the parent: pytest
# --------------------------------------------------------------------------

import pytest  # noqa: E402

from gcm_filters_tpu_torch.parallel import halo  # noqa: E402

LABELS = ("exchange_2d == parent", "strips around f == parent", "strip shapes",
          "pair along dim 1 == stacked", "carries along dim 0 == stacked", "same messages")
_SPAWNED = {}


def _reports(mesh_key, tmp_path_factory):
    if mesh_key not in _SPAWNED:
        workdir = str(tmp_path_factory.mktemp(f"strips_{mesh_key}"))
        _SPAWNED[mesh_key] = spawn_ranks(os.path.abspath(__file__), workdir, mesh_key)[1]
    return _SPAWNED[mesh_key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_strips_single_process(case):
    """One process, both axes wrapping locally: every comparison holds, and
    no message is posted."""
    fold, with_src = CASES[case]
    g, s = (torch.as_tensor(a) for a in _globals())
    sent = []
    real = halo._exchange
    halo._exchange = lambda *a, **k: sent.append(a) or real(*a, **k)
    try:
        checks = _check_block(halo, g, s if with_src else None, LOCAL, LOCAL, fold)
    finally:
        halo._exchange = real
    assert all(checks.values()), checks
    assert sent == []


@pytest.mark.parametrize("label", LABELS)
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mesh_key", ["2x2", "4x1"])
def test_strips_on_gloo_ranks(tmp_path_factory, mesh_key, case, label):
    """Every rank of the mesh: the strips assembled around the block equal
    ``exchange_2d`` and the parent's ``exchange_2d`` bit for bit, for a field,
    a pair along dim 1 and two carries along dim 0, and ``exchange_strips``
    posts the parent's messages (batches, peers, tags, bytes)."""
    reports = _reports(mesh_key, tmp_path_factory)
    bad = [r for r, rep in enumerate(reports) if not bool(rep[f"{case}/{label}"])]
    assert not bad, f"ranks {bad} fail {label!r}"
    if label == "same messages":
        (py, px), _ = MESHES[mesh_key]
        assert sum(int(rep[f"{case}/messages"]) for rep in reports) > 0 or (py, px) == (1, 1)


def test_strips_batch_and_values():
    """The strips hold what the extended block holds: south the block's last
    K rows wrapped under it with the corners, north its first K rows, west
    its last K columns, east its first K; for a (batch, 2) lead."""
    g = torch.as_tensor(np.random.default_rng(4).random((3, 2, 9, 11)))
    s = halo.exchange_strips(g, 2, LOCAL, LOCAL)
    gx = torch.cat([g[..., -2:], g, g[..., :2]], dim=-1)
    assert torch.equal(s.south, gx[..., -2:, :]) and torch.equal(s.north, gx[..., :2, :])
    assert torch.equal(s.west, g[..., -2:]) and torch.equal(s.east, g[..., :2])
    assert s.south.shape == (3, 2, 2, 15) and s.west.shape == (3, 2, 9, 2)
